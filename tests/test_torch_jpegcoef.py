"""``tpudct_torch.utils.jpegcoef`` (the JPEG coefficient reader and writer,
``import_jpeg``, ``export_jpeg``, the TDCM metadata chunk) against
``tpudct.utils.jpegcoef`` on the CPU.

Both packages call the same ``csrc/jpeg_codec.c`` (each its own build of
it) on the same files, so everything must be equal: the coefficient maps,
tables and sampling factors read; the ``.tdc``/``.tdcc`` bytes of an import
under every entropy stage (the serializers are copies); the ``.jpg`` bytes
of an export under every flag combination; and the refusals, with the same
exception type.  The JPEGs are small (43x61 to 64x64): gray and 4:2:0
written by the reference's pixel encoder, 4:2:2, 4:4:4 and 4:1:1 crafted
with the reference's coefficient writer.

Every test that registers a quantization table (an import registers the
file's) runs under :func:`registries`, which the other port tests import.
"""

import numpy as np
import pytest

from tpudct.utils import imageio as RIO
from tpudct.utils import jpegcoef as RJ
from tpudct.utils import serialize as RS
from tpudct_torch.utils import jpegcoef as J
from tpudct_torch.utils import serialize as S

pytestmark = pytest.mark.skipif(
    not (J.coef_io_available() and RJ.coef_io_available()),
    reason="native coefficient I/O unavailable (no libjpeg headers)",
)

CODECS = ("auto", "auto-exact", "spectral", "huffman", "rans", "xz", "raw", "banded", "banded:2:rans")


def _clear_table_caches() -> None:
    from tpudct.kernels import hp_pallas
    from tpudct_torch.kernels import hp, strip420, study
    from tpudct_torch.models import color

    for fn in (hp_pallas._max_coeff, hp_pallas._consts_int, hp_pallas._consts_bf, hp_pallas._consts_f32,
               hp._max_coeff, hp.kernel_constants, hp._args, hp._core_of, study.encode_args,
               strip420.strip_args, color._u8_plan):
        fn.cache_clear()


@pytest.fixture
def registries():
    """Both packages' ``Q_TABLES`` reset to their built-in entries (luma,
    chroma) for the test and restored after it, with the caches keyed by
    table names cleared at both ends (a reset bypasses
    ``register_q_table``'s redefinition guard, so a stale entry under a
    reused name would serve the wrong table).  A test's registrations
    neither see nor leave behind another test's."""
    import tpudct.constants as RC
    import tpudct_torch.constants as PC

    snaps = [(C.Q_TABLES, dict(C.Q_TABLES)) for C in (RC, PC)]
    for tables, snap in snaps:
        tables.clear()
        tables.update({k: snap[k] for k in ("luma", "chroma")})
    _clear_table_caches()
    yield
    for tables, snap in snaps:
        tables.clear()
        tables.update(snap)
    _clear_table_caches()


def _craft(path, comps_samp, maps_from):
    """A 3-component JPEG with the given luma sampling and (1, 1) chroma,
    written by the reference's coefficient writer from the gray file
    `maps_from`'s luma map and table (chroma planes of small noise)."""
    r = RJ.read_jpeg_coefficients(maps_from)
    ymap, qt = r["comps"][0]["map"], r["comps"][0]["qtab"]
    h, w = 64, 64
    yh, yv = comps_samp
    rng = np.random.default_rng(yh * 10 + yv)
    cshape = (max(8, h // yv), max(8, w // yh))
    comps = [{"map": ymap, "qtab": qt, "samp": (yh, yv)}]
    for _ in range(2):
        comps.append({"map": rng.integers(-20, 21, cshape).astype(np.int16), "qtab": qt * 0 + 3, "samp": (1, 1)})
    RJ.write_jpeg_coefficients(path, comps, (h, w))
    return path


@pytest.fixture
def jpegs(tmp_path):
    """name -> path: gray (43x61, quality 77; edge blocks), 420 (38x54 RGB,
    quality 85), 422, 444 and 411 (64x64, crafted)."""
    rng = np.random.default_rng(11)
    out = {}
    RIO.save_jpeg(tmp_path / "gray.jpg", rng.normal(128, 40, (43, 61)).clip(0, 255).astype(np.uint8), quality=77)
    out["gray"] = tmp_path / "gray.jpg"
    RIO.save_jpeg(tmp_path / "c420.jpg", rng.integers(0, 256, (38, 54, 3)).astype(np.uint8), quality=85)
    out["420"] = tmp_path / "c420.jpg"
    RIO.save_jpeg(tmp_path / "base.jpg", rng.integers(0, 256, (64, 64)).astype(np.uint8), quality=90)
    for name, samp in (("422", (2, 1)), ("444", (1, 1)), ("411", (4, 1))):
        out[name] = _craft(tmp_path / f"c{name}.jpg", samp, tmp_path / "base.jpg")
    return out


def _same_read(a: dict, b: dict) -> None:
    assert a["shape"] == b["shape"] and len(a["comps"]) == len(b["comps"])
    for x, y in zip(a["comps"], b["comps"]):
        assert x["samp"] == y["samp"]
        assert x["map"].dtype == y["map"].dtype and x["qtab"].dtype == y["qtab"].dtype
        np.testing.assert_array_equal(x["map"], y["map"])
        np.testing.assert_array_equal(x["qtab"], y["qtab"])


def test_registries_reset_the_colour_plans(registries):
    """The fixture clears the u8 colour path's plans with the caches keyed
    by table names: a plan holds the tables it launches with."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.models import color

    assert not color._PLANS
    color._u8_plan(get_pipeline("hp"), 64, 256, "interleaved", "420", CodecConfig()).encoder()
    assert color._PLANS
    _clear_table_caches()
    assert not color._PLANS


@pytest.mark.parametrize("name,samps", [
    ("gray", [(1, 1)]), ("420", [(2, 2), (1, 1), (1, 1)]), ("422", [(2, 1), (1, 1), (1, 1)]),
    ("444", [(1, 1)] * 3), ("411", [(4, 1), (1, 1), (1, 1)]),
])
def test_read_is_the_reference(jpegs, name, samps):
    got = J.read_jpeg_coefficients(jpegs[name])
    _same_read(got, RJ.read_jpeg_coefficients(jpegs[name]))
    assert [c["samp"] for c in got["comps"]] == samps


@pytest.mark.parametrize("name", ["gray", "420", "422", "444"])
def test_write_is_the_reference(jpegs, tmp_path, name):
    """The writer's bytes equal the reference's, and a write then read
    gives back the maps (the jpegtran property)."""
    r = RJ.read_jpeg_coefficients(jpegs[name])
    J.write_jpeg_coefficients(tmp_path / "m.jpg", r["comps"], r["shape"])
    RJ.write_jpeg_coefficients(tmp_path / "r.jpg", r["comps"], r["shape"])
    assert (tmp_path / "m.jpg").read_bytes() == (tmp_path / "r.jpg").read_bytes()
    _same_read(J.read_jpeg_coefficients(tmp_path / "m.jpg"), r)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", ["gray", "420", "422", "444"])
def test_import_is_the_reference(jpegs, registries, name, codec):
    got, want = J.import_jpeg(jpegs[name], codec=codec), RJ.import_jpeg(jpegs[name], codec=codec)
    assert got == want
    rep = S.inspect_stream(got)
    assert rep == RS.inspect_stream(want) and (rep.get("planes") or [rep])[0]["transform"] == "dct"


def test_import_carries_the_markers(tmp_path, registries):
    """APPn and COM segments ride a trailing TDCM chunk, verbatim, and are
    spliced back on export (the same bytes as the reference's)."""
    from PIL import Image

    rng = np.random.default_rng(3)
    src = tmp_path / "meta.jpg"
    Image.fromarray(rng.normal(128, 40, (40, 48)).clip(0, 255).astype(np.uint8), "L").save(
        src, "JPEG", quality=85, exif=b"Exif\x00\x00" + bytes(rng.integers(0, 256, 64, dtype=np.uint8)),
        icc_profile=bytes(rng.integers(0, 256, 128, dtype=np.uint8)), comment=b"tpudct_torch metadata test")
    markers = J._jpeg_markers(src.read_bytes())
    assert markers and markers == RJ._jpeg_markers(src.read_bytes())
    data = J.import_jpeg(src)
    assert data == RJ.import_jpeg(src) and J._extract_metadata(data) == markers
    assert S.inspect_stream(data)["jpeg_metadata_bytes"] == len(markers)
    J.export_jpeg(data, tmp_path / "m.jpg")
    RJ.export_jpeg(data, tmp_path / "r.jpg")
    assert (tmp_path / "m.jpg").read_bytes() == (tmp_path / "r.jpg").read_bytes()
    assert J._jpeg_markers((tmp_path / "m.jpg").read_bytes()) == markers
    spliced = J._splice_markers((tmp_path / "m.jpg").read_bytes(), b"")
    assert spliced == RJ._splice_markers((tmp_path / "m.jpg").read_bytes(), b"")
    assert J._extract_metadata(S.coefficients_to_bytes(np.zeros((8, 8), np.float32), transform="dct")) == b""


@pytest.mark.parametrize("flags", [
    {}, {"optimize": True}, {"progressive": True}, {"arithmetic": True},
    {"optimize": True, "progressive": True}, {"progressive": True, "arithmetic": True},
])
@pytest.mark.parametrize("name", ["gray", "420", "422", "444"])
def test_export_is_the_reference(jpegs, tmp_path, registries, name, flags):
    """jpg -> .tdc[c] -> jpg: the same bytes as the reference's export and
    the file's own coefficients back, bit for bit."""
    data = J.import_jpeg(jpegs[name], codec="raw")
    J.export_jpeg(data, tmp_path / "m.jpg", **flags)
    RJ.export_jpeg(data, tmp_path / "r.jpg", **flags)
    assert (tmp_path / "m.jpg").read_bytes() == (tmp_path / "r.jpg").read_bytes()
    back = J.read_jpeg_coefficients(tmp_path / "m.jpg")
    orig = J.read_jpeg_coefficients(jpegs[name])
    for a, b in zip(back["comps"], orig["comps"]):
        np.testing.assert_array_equal(a["qtab"], b["qtab"])
        np.testing.assert_array_equal(a["map"][: b["map"].shape[0], : b["map"].shape[1]], b["map"])


def _refusals(tmp_path, jpegs):
    """(label, port call, reference call) for every refusal."""
    big_dc = np.zeros((16, 16), np.float32)
    big_dc[0, 0] = 30000.0
    big_ac = np.zeros((16, 16), np.float32)
    big_ac[0, 5] = 2000.0
    rng = np.random.default_rng(5)
    ycc = {"y": np.zeros((16, 16), np.float32), "cb": np.zeros((8, 8), np.float32),
           "cr": np.zeros((8, 8), np.float32)}
    meta = {"orig_shape": (16, 16), "chroma_shape": (8, 8), "subsample": "420"}
    diff_tables = tmp_path / "cbcr.jpg"
    r = RJ.read_jpeg_coefficients(jpegs["444"])
    r["comps"][2]["qtab"] = r["comps"][2]["qtab"] + 1
    RJ.write_jpeg_coefficients(diff_tables, r["comps"], r["shape"])
    return {
        "4:1:1": lambda m: m.import_jpeg(jpegs["411"]),
        "Cb and Cr tables differ": lambda m: m.import_jpeg(diff_tables),
        "haweel transform": lambda m: m.export_jpeg(
            S.coefficients_to_bytes(rng.integers(-5, 5, (16, 16)).astype(np.float32)), tmp_path / "x.jpg"),
        "haweel color": lambda m: m.export_jpeg(S.color_to_bytes(ycc, meta), tmp_path / "x.jpg"),
        "q_scale 0.37": lambda m: m.export_jpeg(
            S.coefficients_to_bytes(np.zeros((8, 8), np.float32), q_scale=0.37, transform="dct"),
            tmp_path / "x.jpg"),
        "DC step": lambda m: m.export_jpeg(S.coefficients_to_bytes(big_dc, transform="dct"), tmp_path / "x.jpg"),
        "AC range": lambda m: m.export_jpeg(S.coefficients_to_bytes(big_ac, transform="dct"), tmp_path / "x.jpg"),
        "tables out of range": lambda m: m.write_jpeg_coefficients(
            tmp_path / "x.jpg", [{"map": np.zeros((8, 8), np.int16), "qtab": np.zeros((8, 8)), "samp": (1, 1)}],
            (8, 8)),
        "two components": lambda m: m.write_jpeg_coefficients(
            tmp_path / "x.jpg", [{"map": np.zeros((8, 8), np.int16), "qtab": np.ones((8, 8)), "samp": (1, 1)}] * 2,
            (8, 8)),
        "map not 8-aligned": lambda m: m.write_jpeg_coefficients(
            tmp_path / "x.jpg", [{"map": np.zeros((8, 9), np.int16), "qtab": np.ones((8, 8)), "samp": (1, 1)}],
            (8, 9)),
        "missing file": lambda m: m.read_jpeg_coefficients(tmp_path / "missing.jpg"),
    }


@pytest.mark.parametrize("label", [
    "4:1:1", "Cb and Cr tables differ", "haweel transform", "haweel color", "q_scale 0.37", "DC step",
    "AC range", "tables out of range", "two components", "map not 8-aligned", "missing file",
])
def test_refusals_are_the_reference(jpegs, tmp_path, registries, label):
    call = _refusals(tmp_path, jpegs)[label]
    with pytest.raises(Exception) as want:
        call(RJ)
    with pytest.raises(Exception) as got:
        call(J)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    assert not (tmp_path / "x.jpg").exists()  # a refused export leaves no file


def test_without_the_library_the_io_raises(monkeypatch, tmp_path, jpegs):
    """No pure-Python fallback: the reference's RuntimeError, and
    coef_io_available() False, where TPUDCT_NO_NATIVE_JPEG is set."""
    monkeypatch.setenv("TPUDCT_NO_NATIVE_JPEG", "1")
    assert not J.coef_io_available()
    with pytest.raises(RuntimeError, match="no pure-Python fallback"):
        J.read_jpeg_coefficients(jpegs["gray"])
    with pytest.raises(RuntimeError, match="no pure-Python fallback"):
        J.write_jpeg_coefficients(tmp_path / "x.jpg", [], (8, 8))


def test_import_decodes_within_one_of_libjpeg(jpegs, registries):
    """The imported gray stream decoded by the port's hp pipeline (its
    f32-literal dct core: the quality-77 table's coefficients exceed int8)
    within 1 of libjpeg's pixels, as the reference's jpg_import gate asks."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.models.dispatch import decode_gray_auto

    data = J.import_jpeg(jpegs["gray"], codec="raw")
    coeffs, q_scale, _k, shape, transform, q_table = S.bytes_to_coefficients(
        data, with_orig_shape=True, with_transform=True, with_q_table=True)
    cfg = CodecConfig(q_scale=q_scale, transform=transform, q_table=q_table)
    dec = np.asarray(decode_gray_auto(get_pipeline("hp"), coeffs, cfg, shape, device="cpu"))
    ref = RIO.load_jpeg(jpegs["gray"])
    assert dec.shape == ref.shape and np.abs(dec.astype(int) - ref.astype(int)).max() <= 1
