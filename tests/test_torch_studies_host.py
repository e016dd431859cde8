"""Six study drivers of the port (tpudct_torch/studies/
partial_at_scale, timing_xval, bulk_ab, deadzone_study, rans_interleave_ab;
onchip_recheck runs on the card only, in chip_smoke.py) against the
reference's drivers in benchmarks/ and the reference's functions they call,
on the CPU (``device="cpu"``: the kernels' plain twins), on the same seeded
numpy inputs at small sizes.

The reference drivers are loaded from benchmarks/ with importlib, never
edited, with bytecode writing off; their size globals are patched where a
test needs a small size.

Tolerances: none, but where a color result of the port meets the
reference's: bytes, coefficient maps, u8 pixels and the float64 golden
model's PSNR are equal.  The port's .tdcc may differ from the reference's
where the reference's split contracts chroma into FMAs: then the planes are
held to that counted class (Y exact, chroma +-1 on <= 0.5% of entries) and
the color pixels to +-1 on <= 1e-4 (ROADMAP §C, as test_torch_streaming.py
holds them).
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import numpy as np
import pytest

import tpudct.models.dispatch as RD
import tpudct.utils.serialize as RS
import tpudct.utils.streaming as RST
from tpudct import CodecConfig as RCfg
from tpudct import get_pipeline as rget
from tpudct_torch.studies import bulk_ab, deadzone_study, partial_at_scale, rans_interleave_ab, timing_xval

_ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
SIZE, BAND = 512, 128


def _load(name: str):
    """benchmarks/<name>.py as a module, without writing its bytecode (the
    repo root on the path: deadzone_study imports tests.golden)."""
    if str(_ROOT) not in sys.path:
        sys.path.insert(0, str(_ROOT))
    spec = importlib.util.spec_from_file_location(f"_reference_{name}", _ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    old = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.dont_write_bytecode = old
    return mod


@pytest.fixture(scope="module", autouse=True)
def _native_loaded():
    """Both packages' host C libraries loaded before any streamed encode
    (the reference's loader races at its first use from two threads)."""
    from tpudct.utils import entropy as RE
    from tpudct_torch.utils import entropy as E

    assert RE.native_entropy_available() and E.native_entropy_available()


# ---- partial_at_scale ----------------------------------------------------------------


@pytest.fixture(scope="module")
def pas_ref():
    mod = _load("partial_at_scale")
    mod.SIZE, mod.BAND, mod.SIZE_C = SIZE, BAND, SIZE
    return mod


@pytest.fixture(scope="module")
def archive(tmp_path_factory, pas_ref):
    """Every phase of the port's driver at SIZE / BAND on the CPU, in
    order, in one directory: {phase: (record, output)}."""
    d = tmp_path_factory.mktemp("pas")
    ar = partial_at_scale.Archive(str(d), SIZE, BAND, SIZE, device=CPU)
    return ar, {ph: partial_at_scale.run_phase(ph, ar) for ph in partial_at_scale.PHASES}


def _run_reference(mod, phase: str, monkeypatch) -> dict:
    """The reference driver's phase in process; its JSON line."""
    monkeypatch.setattr(sys, "argv", ["partial_at_scale.py", phase])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return json.loads(buf.getvalue())


def test_band_content_is_the_reference(pas_ref):
    for b in (0, SIZE // BAND - 1):
        assert np.array_equal(partial_at_scale.band_pixels(b, SIZE, BAND), pas_ref.band_pixels(b))
        assert np.array_equal(partial_at_scale.band_rgb(b, SIZE, BAND), pas_ref.band_rgb(b))
    # the defaults are the reference's sizes and the rows its ROIs read
    assert (partial_at_scale.SIZE, partial_at_scale.BAND, partial_at_scale.SIZE_C) == (65536, 2048, 32768)
    assert partial_at_scale.roi_rows(65536, 2048) == (32000, 32100)
    assert partial_at_scale.roi_rows(32768, 2048) == (16000, 16100)
    assert partial_at_scale.scale_band(partial_at_scale.Archive(".", 65536, 2048)) == 15


def test_gray_archive_is_the_reference(archive, pas_ref, tmp_path, monkeypatch):
    ar, out = archive
    for key, name in (("PIX", "pix.u8"), ("TDC", "big.tdc")):
        monkeypatch.setattr(pas_ref, key, str(tmp_path / name))
    monkeypatch.setattr(pas_ref, "TDCC", ar.tdcc)  # its gray phases past enc read the color archive too
    _run_reference(pas_ref, "gen", monkeypatch)
    assert np.array_equal(np.load(ar.pix), np.load(pas_ref.PIX))
    ref_enc = _run_reference(pas_ref, "enc", monkeypatch)
    data = out["enc"][1]
    assert data == pathlib.Path(ar.tdc).read_bytes() == pathlib.Path(pas_ref.TDC).read_bytes()
    assert out["enc"][0]["bytes"] == ref_enc["bytes"] and out["enc"][0]["factor"] == ref_enc["factor"]
    ref_pv = _run_reference(pas_ref, "preview", monkeypatch)
    rec, pv = out["preview"]
    assert np.array_equal(pv, RS.preview_from_bytes(data))
    assert (rec["shape"], rec["mean"]) == (ref_pv["shape"], ref_pv["mean"])
    rp = rget("hp")
    rec, rows = out["roi"]
    a, b = rec["rows"]
    assert rec["bit_identical_vs_in_memory_band"] and rec["of"] == SIZE // BAND
    assert np.array_equal(rows, RST.decode_gray_streamed(rp, data, band_rows=BAND, row_range=(a, b)))
    rec, scaled = out["scale"]
    assert rec["band_bit_identical"] and rec["shape"] == [SIZE // 8, SIZE // 8]
    assert np.array_equal(scaled, RST.decode_gray_streamed(rp, data, band_rows=BAND, scale_m=1))


def test_color_archive_is_the_reference(archive, pas_ref, tmp_path, monkeypatch):
    ar, out = archive
    for key, name in (("RGB", "rgb.u8"), ("TDCC", "big.tdcc")):
        monkeypatch.setattr(pas_ref, key, str(tmp_path / name))
    _run_reference(pas_ref, "genc", monkeypatch)
    rgb = np.load(ar.rgb)
    assert np.array_equal(rgb, np.load(pas_ref.RGB))
    _run_reference(pas_ref, "encc", monkeypatch)
    data = out["encc"][1]
    ref = pathlib.Path(pas_ref.TDCC).read_bytes()
    assert data == pathlib.Path(ar.tdcc).read_bytes()
    if data != ref:  # the reference's FMA-contracted chroma: the counted class
        pl, meta = RS.bytes_to_color(data)
        rpl, rmeta = RS.bytes_to_color(ref)
        assert meta == rmeta
        for k in ("y", "cb", "cr"):
            d = np.abs(pl[k].astype(np.int32) - rpl[k])
            assert d.max() <= 1 and (d > 0).mean() <= 0.005 and (k != "y" or not d.any()), k
    rec, pv = out["previewc"]
    assert np.array_equal(pv, RS.preview_color_from_bytes(data)) and rec["shape"] == [SIZE // 8, SIZE // 8, 3]
    rec, rows = out["roic"]
    a, b = rec["rows"]
    assert rec["bit_identical_vs_in_memory_band"]
    want = RST.decode_color_streamed(rget("hp"), data, band_rows=BAND, row_range=(a, b))
    d = np.abs(rows.astype(np.int16) - want)
    assert rows.shape == want.shape == (b - a, SIZE, 3) and d.max() <= 1 and (d > 0).mean() <= 1e-4


def test_every_record_has_the_reference_keys(archive):
    _ar, out = archive
    for phase, (rec, _) in out.items():
        assert rec["phase"] == phase and rec["s"] >= 0 and 0 < rec["start_maxrss_mb"] <= rec["maxrss_mb"]
    assert set(out["enc"][0]) >= {"bytes", "factor", "split"}
    assert out["enc"][0]["split"]["entropy"] > 0
    for phase in ("roi", "scale", "roic"):
        assert out[phase][0]["decode_maxrss_mb"] <= out[phase][0]["maxrss_mb"]


def test_gen_checks_free_space(tmp_path, monkeypatch):
    import shutil

    usage = shutil.disk_usage(tmp_path)
    monkeypatch.setattr(shutil, "disk_usage", lambda _p: usage._replace(free=SIZE * SIZE))
    ar = partial_at_scale.Archive(str(tmp_path), SIZE, BAND, SIZE, device=CPU)
    with pytest.raises(RuntimeError, match=f"{SIZE * SIZE} bytes free.*need {SIZE * SIZE * 9 // 8}"):
        partial_at_scale.run_phase("gen", ar)
    assert not (tmp_path / partial_at_scale.PIX).exists()


def test_archive_refuses_a_band_off_the_sizes(tmp_path):
    with pytest.raises(ValueError, match="multiples of band"):
        partial_at_scale.Archive(str(tmp_path), 500, BAND, SIZE)
    with pytest.raises(ValueError, match="unknown phase"):
        partial_at_scale.run_phase("decode", partial_at_scale.Archive(str(tmp_path), SIZE, BAND, SIZE))


# ---- timing_xval ----------------------------------------------------------------------


@pytest.mark.parametrize("slope,intercept", [(0.0834e-3, 0.012), (2.5e-3, 0.0)])
def test_timing_fit_recovers_the_line(slope, intercept):
    ks = timing_xval.KS
    a, b, r2 = timing_xval._fit(ks, [slope * k + intercept for k in ks])
    assert a == pytest.approx(slope, rel=1e-9) and b == pytest.approx(intercept, abs=1e-12) and r2 == 1.0
    noise = np.random.default_rng(0).normal(0.0, 1e-5, len(ks))
    a, b, r2 = timing_xval._fit(ks, [slope * k + intercept + e for k, e in zip(ks, noise)])
    assert a == pytest.approx(slope, rel=0.05) and abs(b - intercept) < 1e-4 and 0.99 < r2 <= 1.0


def test_timing_xval_reads_three_ways(monkeypatch, capsys):
    monkeypatch.setattr(timing_xval, "K_BIG", 16)
    monkeypatch.setattr(timing_xval, "KS", (2, 4, 8, 16, 32))
    out = timing_xval.main(64, device=CPU)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [next(iter(r)) for r in lines] == ["protocol", "protocol", "protocol", "agreement"]
    assert all("host clock" in r["card"] for r in lines)
    assert len(out["walls_s"]) == 5 and all(v > 0 for v in out["walls_s"])
    assert out["fit_over_timer"] == out["fit_ms"] / out["device_time_ms"]


# ---- bulk_ab --------------------------------------------------------------------------


def test_bulk_ab_stacked_is_per_image_and_the_reference():
    n, side = 4, 64
    out = bulk_ab.main(n, side, device=CPU)
    rng = np.random.default_rng(42)
    imgs = [rng.integers(0, 256, (side, side), dtype=np.uint8) for _ in range(n)]
    rp, rcfg = rget("hp"), RCfg()
    ref = RD.encode_gray_batch_auto(rp, imgs, rcfg)
    assert len(out["coeffs"]) == n
    for im, c, (rc, hw), dec in zip(imgs, out["coeffs"], ref, out["decoded"]):
        assert np.array_equal(c, np.asarray(rc)) and hw == (side, side)
        assert np.array_equal(c, np.asarray(RD.encode_gray_auto(rp, im, rcfg)[0]))
        assert np.array_equal(dec, np.asarray(RD.decode_gray_auto(rp, rc, rcfg, hw)))
    assert min(out[k] for k in ("encode_per_image_s", "encode_stacked_s", "decode_per_image_s",
                                "decode_stacked_s")) > 0


# ---- deadzone_study -------------------------------------------------------------------


def test_deadzone_curves_are_the_reference():
    ref = _load("deadzone_study")
    from tpudct.benchmark import photographic_image

    img = np.asarray(photographic_image(128), np.float64)
    qualities = (30, 80)
    for theta in (0.5, 0.4):
        mine = deadzone_study.curve(img, "haweel", lambda i, t, q8: deadzone_study.quantize_deadzone(i, t, q8, theta),
                                    qualities)
        want = ref.curve(img, "haweel", lambda i, t, q8: ref.quantize_deadzone(i, t, q8, theta), qualities)
        assert mine == want
    from tpudct.constants import Q, get_transform
    from tpudct.ops.quant import q_scale_for_quality

    t = get_transform("haweel").t.astype(np.float64)
    q8 = Q.astype(np.float64) * q_scale_for_quality(80)
    c, n = deadzone_study.quantize_tiebreak_to_zero(img, t, q8)
    rc, rn = ref.quantize_tiebreak_to_zero(img, t, q8)
    assert np.array_equal(c, rc) and n == rn
    assert np.array_equal(deadzone_study.decode(c, t, q8), ref.decode(rc, t, q8))


def test_deadzone_main_prints_every_variant(capsys):
    lines = deadzone_study.main((30, 50, 70, 90), size=64)
    assert len(lines) == 2 * (len(deadzone_study.THETAS) + 1)
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] == lines


# ---- rans_interleave_ab ----------------------------------------------------------------


def test_rans_streams_are_the_reference(capsys):
    ref = _load("rans_interleave_ab")
    from tpudct.utils import entropy as RE

    c = rans_interleave_ab.dct_statistics_map(256)
    assert np.array_equal(c, ref.dct_statistics_map(256))
    out = rans_interleave_ab.main((256,))[256]
    for name, il in rans_interleave_ab.VARIANTS:
        assert out[name]["data"] == RE.rans_encode(c, 1, interleave=il)
    assert out["serial"]["data"][0] != out["interleaved-4"]["data"][0] == 4
    assert "host clock" in capsys.readouterr().out
