"""tpudct_torch.utils.serialize against tpudct.utils.serialize, on the CPU.

Same seeded coefficient maps into both packages.  Tolerance: none — every
writer gives the reference's bytes, every reader the reference's arrays and
dicts, and each package reads the other's files.  The codecs that run the
host C library (huffman, rans, auto) are byte-identical because both
packages build it from the same source with the same compiler and flags.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import tpudct.constants as RCONST
import tpudct.utils.serialize as RS
import tpudct_torch.constants as CONST
import tpudct_torch.utils.serialize as S
from tpudct_torch.models import color as mcolor
from tpudct_torch.models import dispatch

CODECS = ("raw", "spectral", "huffman", "rans", "xz", "banded", "banded:3:rans", "auto", "auto-exact")
TRANSFORMS = ("haweel", "rdct", "wht", "bas", "dct")
# a custom table: both packages derive the same content name for it
_CUSTOM = (np.arange(64, dtype=np.float32).reshape(8, 8) % 23 + 2.0) * 1.5


def _custom_name() -> str:
    name = CONST.register_q_table(_CUSTOM)
    assert RCONST.register_q_table(_CUSTOM) == name and name.startswith("q:")
    return name


def _coeffs(shape, seed: int, retain_k=None, scale: float = 3.0) -> np.ndarray:
    """A coefficient-like int16 map: Laplacian AC shrinking along the
    anti-diagonals, DC a smooth field (what a photo's blocks give)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    u = np.arange(h)[:, None] % 8
    v = np.arange(w)[None, :] % 8
    c = np.round(rng.laplace(0.0, scale, shape) / (1.0 + 0.6 * (u + v)))
    by, bx = np.mgrid[0 : h // 8, 0 : w // 8]
    dc = np.round(60 * np.sin(by / 3.0) * np.cos(bx / 5.0) + rng.normal(0, 4, by.shape))
    c[::8, ::8] = dc
    if retain_k is not None:
        c = c * ((u + v) < retain_k)
    return c.astype(np.int16)


def _case(i: int):
    """Axis i of the covering design: table, retain_k and the image shape
    cycle over the transforms, so every value of each axis meets every
    codec."""
    tables = ("luma", "chroma", _custom_name())
    retain = (None, 6)
    shapes = (((64, 128), None), ((56, 120), (53, 117)))  # (map, orig_shape): on / off the 8-grid
    (shape, orig) = shapes[(i // 2) % 2]
    return tables[i % 3], retain[i % 2], shape, orig


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("codec", CODECS)
def test_plane_bytes_are_the_reference(codec, transform):
    i = TRANSFORMS.index(transform)
    q_table, retain_k, shape, orig = _case(i)
    c = _coeffs(shape, seed=11 * i + CODECS.index(codec), retain_k=retain_k)
    kw = dict(q_scale=1.25, retain_k=retain_k, orig_shape=orig, transform=transform,
              q_table=q_table, codec=codec)
    mine, ref = S.coefficients_to_bytes(c, **kw), RS.coefficients_to_bytes(c, **kw)
    assert mine == ref
    flags = dict(with_orig_shape=True, with_transform=True, with_q_table=True)
    got, want = S.bytes_to_coefficients(ref, **flags), RS.bytes_to_coefficients(mine, **flags)
    np.testing.assert_array_equal(got[0], c)
    np.testing.assert_array_equal(want[0], c)
    assert got[0].dtype == want[0].dtype
    assert got[1:] == want[1:] == (np.float32(1.25), retain_k, orig or shape, transform, q_table)


def test_sampled_auto_above_the_exact_limit_picks_the_reference_s_codec():
    """2056x2048 = 4,210,688 coefficients, just above _AUTO_EXACT_MAX: the
    sampled estimator runs in both packages and picks the same stage."""
    c = _coeffs((2056, 2048), seed=5)
    assert c.size > S._AUTO_EXACT_MAX == RS._AUTO_EXACT_MAX
    mine, ref = S.coefficients_to_bytes(c), RS.coefficients_to_bytes(c)
    assert mine == ref
    assert S.inspect_stream(mine)["codec"] == RS.inspect_stream(ref)["codec"]


def test_legacy_v2_v3_streams_load_like_reference():
    c = _coeffs((16, 24), seed=3)
    raw = zlib.compress(c.tobytes())
    v3 = struct.pack(RS._HEADER3, b"TDC3", 16, 24, 15, 22, 1.5, 6, b"wht", len(raw)) + raw
    v2 = struct.pack(RS._HEADER2, b"TDC2", 16, 24, 0, 0, 2.0, -1, len(raw)) + raw
    for blob in (v2, v3):
        flags = dict(with_orig_shape=True, with_transform=True, with_q_table=True)
        got, want = S.bytes_to_coefficients(blob, **flags), RS.bytes_to_coefficients(blob, **flags)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        assert S.inspect_stream(blob) == RS.inspect_stream(blob)


@pytest.mark.parametrize("codec", ["spectral", "rans", "banded:2:xz"])
@pytest.mark.parametrize("mode", ["420", "422", "444"])
def test_color_containers_are_the_reference(mode, codec):
    sub = False if mode == "444" else mode
    h, w = 50, 70
    ch, cw = {"420": (25, 35), "422": (50, 35), "444": (50, 70)}[mode]
    y8, c8 = (56, 72), (-(-ch // 8) * 8, -(-cw // 8) * 8)
    planes = {"y": _coeffs(y8, 1), "cb": _coeffs(c8, 2, scale=1.5), "cr": _coeffs(c8, 3, scale=1.5)}
    meta = {"orig_shape": (h, w), "chroma_shape": (ch, cw), "subsample": sub}
    mine = S.color_to_bytes(planes, meta, 1.0, None, "haweel", codec=codec)
    ref = RS.color_to_bytes(planes, meta, 1.0, None, "haweel", codec=codec)
    assert mine == ref
    for (pl, m), (rpl, rm) in ((S.bytes_to_color(ref), RS.bytes_to_color(mine)),
                               (S.partial_color_coefficients(ref, 6), RS.partial_color_coefficients(mine, 6))):
        assert m == rm
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(pl[k], rpl[k])
    full, _ = S.bytes_to_color(mine)
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(full[k], planes[k])
    assert S.inspect_stream(mine) == RS.inspect_stream(ref)
    np.testing.assert_array_equal(S.preview_color_from_bytes(mine), RS.preview_color_from_bytes(ref))


def test_color_preview_keeps_the_reference_s_float64_rounding():
    """DC means at (y, cb, cr) triples where an f32 inverse (the port's
    utils.color form) rounds a pixel the other way: the float64 numpy form
    gives the reference's pixels.  Luma table on every plane at q_scale 0.5,
    so a block mean is DC + 128."""
    from tpudct_torch.utils.color import rgb_from_ycbcr_planes

    y = np.arange(64, dtype=np.int16).reshape(8, 8)
    cb = np.where(np.arange(64).reshape(8, 8) % 2, 178, 78).astype(np.int16)
    cr = 256 - cb
    planes = {}
    for k, v in (("y", y), ("cb", cb), ("cr", cr)):
        planes[k] = np.zeros((64, 64), np.int16)
        planes[k][::8, ::8] = v - 128
    meta = {"orig_shape": (64, 64), "chroma_shape": (64, 64), "subsample": False,
            "y_q_table": "luma", "c_q_table": "luma"}
    blob = S.color_to_bytes(planes, meta, 0.5, codec="raw")
    mine = S.preview_color_from_bytes(blob)
    np.testing.assert_array_equal(mine, RS.preview_color_from_bytes(blob))
    f32 = torch.stack(rgb_from_ycbcr_planes(*(torch.as_tensor(v, dtype=torch.float32) for v in (y, cb, cr))), -1)
    assert (f32.round().clamp(0, 255).numpy() != mine).any()


@pytest.mark.parametrize("codec", ["spectral", "xz", "rans", "huffman", "raw", "banded", "banded:3:spectral"])
def test_partial_reads_are_the_reference(codec):
    c = _coeffs((64, 96), seed=4)
    blob = S.coefficients_to_bytes(c, 1.0, None, orig_shape=(60, 90), codec=codec)
    assert S.inspect_stream(blob) == RS.inspect_stream(blob)
    for n in (1, 6, 64):
        got, want = S.partial_coefficients(blob, n), RS.partial_coefficients(blob, n)
        np.testing.assert_array_equal(got.pop("coeffs"), want.pop("coeffs"))
        assert got == want
    np.testing.assert_array_equal(S.preview_from_bytes(blob), RS.preview_from_bytes(blob))


@pytest.mark.parametrize("inner", ["rans", "xz", "auto"])
def test_restaging_is_the_reference(inner):
    c = _coeffs((64, 96), seed=6)
    blob = S.coefficients_to_bytes(c, 1.0, None, codec="banded:4:spectral", q_table=_custom_name())
    assert S.restage_banded_plane(blob, inner) == RS.restage_banded_plane(blob, inner)
    planes = {"y": _coeffs((64, 96), 1), "cb": _coeffs((32, 48), 2), "cr": _coeffs((32, 48), 3)}
    meta = {"orig_shape": (64, 96), "chroma_shape": (32, 48), "subsample": "420"}
    cblob = S.color_to_bytes(planes, meta, codec="banded:2:raw")
    assert S.restage_banded_color(cblob, inner) == RS.restage_banded_color(cblob, inner)


def test_banded_segments_walk_like_reference():
    c = _coeffs((80, 64), seed=7)
    blob = S.coefficients_to_bytes(c, codec="banded:3:rans")
    raw = blob[S._parse_header_v4(blob)[10]:]
    for kw in ({}, {"n_planes": 3}, {"row_range": (20, 41)}):
        got = list(S.iter_banded_segments(raw, 80, 64, **kw))
        want = list(RS.iter_banded_segments(raw, 80, 64, **kw))
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[2], w[2])
    assert S.banded_rows(80, 3) == RS.banded_rows(80, 3)
    segs = [(16, (S._CODEC_RAW, b"ab")), (8, (S._CODEC_RANS, b"xyz"))]
    assert S.assemble_banded_segments(segs) == RS.assemble_banded_segments(segs)


def test_save_and_load_are_the_reference(tmp_path):
    c = _coeffs((32, 40), seed=9)
    n = S.save_coefficients(str(tmp_path / "a.tdc"), c, 0.8, 6, orig_shape=(30, 33), codec="rans")
    RS.save_coefficients(str(tmp_path / "b.tdc"), c, 0.8, 6, orig_shape=(30, 33), codec="rans")
    assert n == len((tmp_path / "a.tdc").read_bytes())
    assert (tmp_path / "a.tdc").read_bytes() == (tmp_path / "b.tdc").read_bytes()
    got = S.load_coefficients(str(tmp_path / "b.tdc"), True, True, True)
    want = RS.load_coefficients(str(tmp_path / "a.tdc"), True, True, True)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    planes = {"y": _coeffs((32, 40), 1), "cb": _coeffs((16, 24), 2), "cr": _coeffs((16, 24), 3)}
    meta = {"orig_shape": (32, 40), "chroma_shape": (16, 20), "subsample": "420"}
    S.save_color(str(tmp_path / "a.tdcc"), planes, meta, codec="huffman")
    RS.save_color(str(tmp_path / "b.tdcc"), planes, meta, codec="huffman")
    assert (tmp_path / "a.tdcc").read_bytes() == (tmp_path / "b.tdcc").read_bytes()
    (pl, m), (rpl, rm) = S.load_color(str(tmp_path / "b.tdcc")), RS.load_color(str(tmp_path / "a.tdcc"))
    assert m == rm and all(np.array_equal(pl[k], rpl[k]) for k in pl)


@pytest.mark.parametrize("bad", [
    b"", b"TDC4", b"XXXX" + b"\0" * 60,
    np.zeros((3, 3)),  # not a stream: refused by the map check
])
def test_refusals_are_the_reference(bad):
    if isinstance(bad, np.ndarray):
        fn, rfn = S.coefficients_to_bytes, RS.coefficients_to_bytes
    else:
        fn, rfn = S.bytes_to_coefficients, RS.bytes_to_coefficients
    with pytest.raises(ValueError) as want:
        rfn(bad)
    with pytest.raises(ValueError, match=str(want.value).replace("(", r"\(").replace(")", r"\)")):
        fn(bad)


def test_int16_overflow_refused_like_reference():
    c = np.zeros((8, 8), np.float32)
    c[0, 0] = 40000.0
    with pytest.raises(ValueError, match="exceeds the .tdc int16 range"):
        RS.coefficients_to_bytes(c)
    with pytest.raises(ValueError, match="exceeds the .tdc int16 range"):
        S.coefficients_to_bytes(c)


def test_abs_bound_is_one_function_for_arrays_and_tensors():
    """One copy, shared by models.dispatch and models.color (through
    dispatch's ``_bound``), equal to the reference's on numpy input (the
    int16 minimum, empty, NaN) and reading tensors in place."""
    assert dispatch._abs_bound is S._abs_bound and mcolor._bound is dispatch._bound
    for a in (np.array([-32768, 7], np.int16), np.zeros((0, 8), np.int8),
              np.array([1.5, -2.25], np.float32), np.array([3, -127], np.int8)):
        assert S._abs_bound(a) == RS._abs_bound(a)
        assert S._abs_bound(torch.as_tensor(a)) == RS._abs_bound(a)
    assert np.isnan(S._abs_bound(np.array([np.nan, 1.0])))
