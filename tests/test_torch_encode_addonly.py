"""The u8 encodes on B1's add-only forward: B2 (k_encode_u8<core>, B1's
encode half) and the fused 4:2:0 encode B19 (k_color_encode_420<core>),
tpudct_torch/csrc/hp_codec.cu and study.cu, on the CPU.

The CUDA kernels cannot run here, so these tests emulate B19's chain in
numpy float32, step for step as the kernel writes it, and hold the
emulation against the unchanged twin (kernels.study.encode_420_plain):
- bytes -> f32 by bit patterns (biased_byte - 2^23), over all 256 bytes;
- the compare-form round _to_u8 without FRND or F2I: clip, a round-down
  add of 0.5, a round-down add of 2^23 (the byte in the low mantissa
  bits), proved on every f32 within 4 ulps of each k + 0.5, of 0 and of
  255, and on values below 0 and above 255; the luma byte over every
  (r, g, b) triple;
- the chroma window sums in f32 (exact) against the twin's integer pool;
- the whole encode: the luma and chroma bytes packed from the round's
  bits, read back by load_u8_level, then B1's forward (fwd_core) and
  quantizer, on every compiled core (tests/test_torch_hp_addonly.py's
  emulation of them).
B2's chain is B1's encode half, one device function, so the emulation of
B1 there covers its coefficients.  The source, launcher and wrapper tests
check that both kernels run that chain on a compiled core id.  The card
runs both kernels against their twins (chip_smoke.py phase 4).

Tolerance: bit-identical everywhere.
"""

import re

import numpy as np
import pytest
import torch

from tests.test_torch_hp_addonly import (
    _CSRC,
    _add_rd_2p23,
    _biased_byte,
    _from_blocks,
    _function_body,
    _fwd_core,
    _i8_bits,
    _minus_128,
    _near,
    _quantize,
    _to_blocks,
)
from tpudct_torch.constants import get_transform
from tpudct_torch.kernels import _build
from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import cores
from tpudct_torch.kernels import hp
from tpudct_torch.kernels import study
from tpudct_torch.utils.color import F32 as KC
from tpudct_torch.utils.color import ycbcr_from_rgb_planes

F32 = np.float32
TWO23 = 2.0**23
_TRANSFORMS = cores.CORES + ("cb2011",)

# ---------------------------------------------------------------------------
# B19's scalar forms, in numpy
# ---------------------------------------------------------------------------


def _byte_f32(b) -> np.ndarray:
    """byte_f32: biased_byte - 2^23, one rounded f32 subtract."""
    return _biased_byte(b) - F32(TWO23)


def _f32_rd(v: np.ndarray) -> np.ndarray:
    """An f64 value rounded down to f32."""
    f = v.astype(F32)
    return np.where(f.astype(np.float64) > v, np.nextafter(f, F32(-np.inf)), f).astype(F32)


def _round_u8_2p23(z: np.ndarray) -> np.ndarray:
    """round_u8_2p23: __fadd_rd(__fadd_rd(clip(z, 0, 255), 0.5), 2^23); the
    f32 sum zp + 0.5 is exact in f64, then rounded down."""
    zp = np.minimum(np.maximum(z.astype(F32), F32(0)), F32(255))
    return _add_rd_2p23(_f32_rd(zp.astype(np.float64) + 0.5))


def _low_byte(v: np.ndarray) -> np.ndarray:
    return (v.view(np.uint32) & 0xFF).astype(np.uint8)


def _luma_f32(r, g, b) -> np.ndarray:
    """luma_f32: (KR r + KG g) + KB b, every product and sum rounded."""
    return ((r * F32(KC["kr"])).astype(F32) + (g * F32(KC["kg"])).astype(F32)).astype(F32) + (
        b * F32(KC["kb"])).astype(F32)


def _luma_u8(r, g, b) -> np.ndarray:
    """The luma byte B19 stages: the low byte of round_u8_2p23(luma_f32)."""
    return _low_byte(_round_u8_2p23(_luma_f32(r, g, b)))


def _split_chroma_420(sr, sg, sb):
    """split_chroma_420: the window sums * 0.25, the pooled luma, then cb and
    cr through the round's bits -> (cb, cr) u8."""
    pr, pg, pb = ((s * F32(0.25)).astype(F32) for s in (sr, sg, sb))
    yp = _luma_f32(pr, pg, pb)
    zb = ((pb - yp).astype(F32) * F32(KC["kcb"])).astype(F32) + F32(128)
    zr = ((pr - yp).astype(F32) * F32(KC["kcr"])).astype(F32) + F32(128)
    return _low_byte(_round_u8_2p23(zb.astype(F32))), _low_byte(_round_u8_2p23(zr.astype(F32)))


def _encode_blocks(x: np.ndarray, ts: np.ndarray, fq: np.ndarray) -> np.ndarray:
    """encode_rows on (n, 8, 8) level-shifted samples: fwd_core, the
    quantizer, the int8 bytes."""
    return _i8_bits(_quantize(_fwd_core(x, ts), fq))


def emulate_encode_420(rgb: np.ndarray, transform, q_scale, retain_k, y_q_table="luma", c_q_table="chroma"):
    """k_color_encode_420<core> on (3, H, W) u8 RGB: (y, cb, cr) int8."""
    _, h, w = rgb.shape
    ts = cores.source_tables()[get_transform(transform).name]
    core, packed = study.encode_args(transform, q_scale, retain_k, y_q_table, c_q_table)
    assert cores.CORES[core] == get_transform(transform).name
    fl, fc = packed[:64].reshape(8, 8), packed[64:128].reshape(8, 8)
    r, g, b = (_byte_f32(rgb[c]) for c in range(3))
    yu = _luma_u8(r, g, b)
    # each 2 x 2 window summed in the kernel's order: row 0's two pixels,
    # then row 1's
    sums = []
    for c in (r, g, b):
        acc = c[0::2, 0::2]
        for part in (c[0::2, 1::2], c[1::2, 0::2], c[1::2, 1::2]):
            acc = (acc + part).astype(F32)
        sums.append(acc)
    cb, cr = _split_chroma_420(*sums)
    # the staged bytes read back by load_u8_level, then encode_rows
    y_i8 = _from_blocks(_encode_blocks(_minus_128(_to_blocks(yu)), ts, fl), h, w)
    cb_i8, cr_i8 = (_from_blocks(_encode_blocks(_minus_128(_to_blocks(p)), ts, fc), h // 2, w // 2)
                    for p in (cb, cr))
    return y_i8, cb_i8, cr_i8


def _rgb(seed: int, h: int = 64, w: int = 256) -> np.ndarray:
    """Planar u8 RGB noise with saturated 16x16 patches: all 0, all 255, the
    pure primaries and their complements."""
    rgb = np.random.default_rng(seed).integers(0, 256, size=(3, h, w), dtype=np.uint8)
    colors = [(0, 0, 0), (255, 255, 255), (255, 0, 0), (0, 255, 0), (0, 0, 255), (0, 255, 255),
              (255, 0, 255), (255, 255, 0)]
    for j, col in enumerate(colors):
        rgb[:, :16, 16 * j:16 * j + 16] = np.array(col, np.uint8)[:, None, None]
    return rgb


# ---------------------------------------------------------------------------
# Exhaustive scalar proofs
# ---------------------------------------------------------------------------


def test_bytes_to_f32_over_all_bytes():
    """byte_f32 is the byte, exactly, for all 256 bytes (the luma inputs)."""
    b = np.arange(256, dtype=np.uint32)
    assert np.array_equal(_byte_f32(b), b.astype(F32))


def test_round_without_conversions_near_every_tie():
    """round_u8_2p23's low byte, and its value minus 2^23, against the
    compare form _to_u8 (kernels.color._round_u8) on every f32 within 4
    ulps of each k + 0.5 (k = 0..254), of 0 and of 255, and below 0 and
    above 255."""
    k = np.arange(0, 255, dtype=np.float64)
    z = np.concatenate([
        _near(k + 0.5), _near(np.array([0.0, 255.0])),
        np.array([-0.0, -1e-30, -0.25, -0.5, -0.75, -1.0, -300.0, -1e9, -3e38,
                  255.25, 255.5, 255.75, 256.0, 300.0, 1e9, 3e38], F32),
    ])
    bits = _round_u8_2p23(z)
    want = ck._round_u8(torch.as_tensor(z)).numpy()
    assert np.array_equal(_low_byte(bits), want)
    assert np.array_equal(bits - F32(TWO23), want.astype(F32))


def test_luma_over_every_rgb_triple():
    """B19's luma byte (luma_f32, then the conversion-free round) equals the
    twin's round of the f32 BT.601 luma on all 256^3 (r, g, b) triples."""
    g, b = (a.ravel() for a in np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    gf, bf = g.astype(F32), b.astype(F32)
    for r in range(256):
        rf = np.full_like(gf, F32(r))
        mine = _luma_u8(rf, gf, bf)
        y, _cb, _cr = ycbcr_from_rgb_planes(*(torch.as_tensor(c) for c in (rf, gf, bf)))
        assert np.array_equal(mine, ck._round_u8(y).numpy()), r


def test_chroma_sums_in_f32_are_the_integer_sums():
    """The 2 x 2 window sums of the byte floats, summed in f32 in the
    kernel's order, times 0.25, equal the twin's pool (kernels.color._pool:
    the integer sum of (c - 128) * 0.25 + 128) for every sum a window can
    have (0..1020), and on random windows."""
    s = np.arange(0, 1021)
    parts = np.stack([np.clip(s - 255 * i, 0, 255) for i in range(4)])  # 4 bytes summing to s
    rng = np.random.default_rng(0)
    parts = np.concatenate([parts, rng.integers(0, 256, size=(4, 50000))], axis=1).astype(np.uint32)
    acc = _byte_f32(parts[0])
    for part in parts[1:]:
        acc = (acc + _byte_f32(part)).astype(F32)
    assert np.array_equal(acc, parts.sum(axis=0).astype(F32))
    n = parts.shape[1]
    window = np.empty((2, 2 * n), np.int32)  # window j: columns 2 j, 2 j + 1
    window[0, 0::2], window[0, 1::2], window[1, 0::2], window[1, 1::2] = parts
    want = ck._pool(torch.as_tensor(window), 2, 2).numpy()[0]
    assert np.array_equal((acc * F32(0.25)).astype(F32), want)


# ---------------------------------------------------------------------------
# The whole encode against the twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tables", [("luma", "chroma"), ("chroma", "luma")])
@pytest.mark.parametrize("retain_k", [None, 6])
@pytest.mark.parametrize("q_scale", [1.0, 2.5])
@pytest.mark.parametrize("transform", _TRANSFORMS)
def test_fused_encode_chain_equals_the_twin(transform, q_scale, retain_k, tables):
    rgb = _rgb(seed=len(transform) + int(4 * q_scale) + (retain_k or 0))
    mine = emulate_encode_420(rgb, transform, q_scale, retain_k, *tables)
    want = study.encode_420_plain(torch.as_tensor(rgb), q_scale, retain_k, transform, *tables)
    for plane, a, b in zip(("y", "cb", "cr"), mine, want):
        assert np.array_equal(a, b.numpy()), plane


# ---------------------------------------------------------------------------
# The wrappers, the C interface, the sources
# ---------------------------------------------------------------------------


def test_wrappers_pass_the_compiled_core():
    """B2 takes B1's forward core; B19 the core of both of its forward
    tables, and the luma and chroma scales and color constants packed as
    EncodeConsts."""
    for name in _TRANSFORMS:
        cid = cores.CORES.index(get_transform(name).name)
        for q_scale, retain_k in ((1.0, None), (2.5, 6)):
            assert hp._core_of(name, "chroma", q_scale, retain_k, "butterfly", True)[0] == cid
            core, packed = study.encode_args(name, q_scale, retain_k)
            kl = hp._args(name, "luma", q_scale, retain_k, "butterfly", True)
            kc = hp._args(name, "chroma", q_scale, retain_k, "butterfly", True)
            assert core == cid
            assert np.array_equal(packed, np.concatenate([kl.fq.ravel(), kc.fq.ravel(), ck._consts()]))
    for call in (lambda: study.encode_args("dct", 1.0, None),
                 lambda: hp.hp_encode_u8(torch.zeros((32, 128), dtype=torch.uint8), transform="dct")):
        with pytest.raises(ValueError, match="int core requested but 'dct' has none"):
            call()


@pytest.fixture
def wrong_table(monkeypatch):
    """kernels.cores reading a header whose haweel table differs from
    haweel's Ts in one entry."""
    tables = {name: t.copy() for name, t in cores.source_tables().items()}
    tables["haweel"][2, 3] = 0
    monkeypatch.setattr(cores, "source_tables", lambda: tables)
    hp._core_of.cache_clear()
    study.encode_args.cache_clear()
    yield
    hp._core_of.cache_clear()
    study.encode_args.cache_clear()


def test_wrappers_raise_when_the_compiled_table_differs(wrong_table):
    img = torch.zeros((64, 256), dtype=torch.uint8)
    rgb = torch.as_tensor(_rgb(seed=1))
    for call in (lambda: hp.hp_encode_u8(img), lambda: hp.hp_encode_u8(img, q_table="chroma", retain_k=6),
                 lambda: study.color_encode_420_u8(rgb), lambda: study.color_encode_420_u8(rgb, q_scale=2.5)):
        with pytest.raises(ValueError, match="no compiled inverse for 'haweel'"):
            call()
    hp.hp_encode_u8(img, transform="wht")  # the other cores' tables still match
    study.color_encode_420_u8(rgb, transform="bas")


def test_launchers_take_a_core():
    """hp_encode_u8_launch and color_encode_420_launch take the core's id
    after h, w, and name one instance per compiled core."""
    sig = _build._SIGNATURES
    assert sig["hp_encode_u8_launch"][4] is _build._I
    assert sig["color_encode_420_launch"][6] is _build._I
    assert sig["color_encode_420_launch"] == sig["color_decode_420_launch"]
    for src, name, n in (("hp_codec.cu", "k_encode_u8", 4), ("study.cu", "k_color_encode_420", 4)):
        text = (_CSRC / src).read_text()
        launcher = {"k_encode_u8": "hp_encode_u8_launch", "k_color_encode_420": "color_encode_420_launch"}[name]
        decl = " ".join(re.search(launcher + r"\(([^)]*)\)", text).group(1).split())
        assert "int h, int w, int core, const void* consts" in decl
        assert len(set(re.findall(name + r"<([0-3])>", text))) == n
        assert "core < 0 || core >= kCores" in _function_body(text, launcher)


# Conversions between int and float, and the converting helpers.
_BANNED = ("truncf", "floorf", "__float2int", "static_cast<int", "static_cast<float", "(int)", "roundf", "rintf",
           "round_away(", "round_u8(", "split_chroma(", "fwd_block(", "load_u8_shifted(", "store_i8(")


def test_the_encodes_run_the_add_only_chain():
    """k_encode_u8 and k_color_encode_420 reach fwd_core<kCore> and
    quantize_store_i8 (B2 through B1's encode_block_u8), with no
    conversion in their bodies or in B19's pixel forms, and the converting
    row helpers are gone from hp_block.cuh."""
    codec, fused = (_CSRC / "hp_codec.cu").read_text(), (_CSRC / "study.cu").read_text()
    block = _function_body(codec, "encode_block_u8")
    assert all(f in block for f in ("load_u8_level(", "fwd_core<kCore>(", "quantize_store_i8("))
    for kernel in ("k_encode_u8", "k_rt_u8"):
        assert "encode_block_u8<kCore>(" in _function_body(codec, kernel)
    rows = _function_body(fused, "encode_rows")
    assert "fwd_core<kCore>(" in rows and "quantize_store_i8(" in rows
    kernel = _function_body(fused, "k_color_encode_420")
    assert all(f in kernel for f in ("encode_rows<kCore>(", "load_u8_level(", "byte_f32(", "round_u8_2p23(",
                                     "split_chroma_420(", "pack4("))
    for body in (block, _function_body(codec, "k_encode_u8"), kernel, rows,
                 *(_function_body(fused, f) for f in ("byte_f32", "round_u8_2p23", "split_chroma_420"))):
        for banned in _BANNED:
            assert not re.search(r"(?<!\w)" + re.escape(banned), body), banned
    header = (_CSRC / "hp_block.cuh").read_text()
    assert not re.search(r"\b(load_u8_shifted|store_i8)\(", header)
