"""tpudct_torch measurement path (benchmark.py, utils/timing.py,
utils/profiling.py, utils/metrics.py) against the reference, on the CPU.

Tolerances and their reasons:
- Image generators and the host numpy DCT: bit-identical (the same numpy
  calls on the same seeds).
- BD-rate / BD-PSNR: within 1e-9 (the same float64 numpy fits).
- mse, psnr, peen: the port sums in float64, the reference in f32, so
  within a relative 1e-5 (f32 summation of 1e5 terms).
- ssim: window means in float64 against the reference's f32 convolution,
  whose variances (E[x^2] - E[x]^2 at 255-scale pixels) cancel down to
  ~1e-3 absolute: within 1e-4 absolute of an SSIM in [-1, 1].
- The benches on device="cpu": the reference's keys; their times are host
  times of the plain twins, which the benches label backend "cpu".
"""

import json

import numpy as np
import pytest
import torch

import tpudct.benchmark as RB
import tpudct.utils.metrics as RM
import tpudct_torch.benchmark as B
from tpudct_torch import CodecConfig
from tpudct_torch.utils import metrics as M
from tpudct_torch.utils import profiling
from tpudct_torch.utils.timing import PhaseTimer, device_time_ms


@pytest.mark.parametrize("size, seed", [(8, 42), (64, 1), (256, 42), (100, 3)])
def test_synthetic_image_bit_identical(size, seed):
    a, b = B.synthetic_image(size, seed), RB.synthetic_image(size, seed)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("size, seed", [(16, 7), (64, 7), (83, 2), (84, 7), (128, 3), (512, 7)])
def test_structured_image_bit_identical(size, seed):
    """Including below 84 px, where the packages are skipped."""
    a, b = B.structured_image(size, seed), RB.structured_image(size, seed)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("size, seed", [(32, 5), (96, 9), (256, 5)])
def test_photographic_image_bit_identical(size, seed):
    a, b = B.photographic_image(size, seed), RB.photographic_image(size, seed)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_reference_tables_match():
    assert B.REFERENCE_HP_DCT_MS == RB.REFERENCE_HP_DCT_MS
    assert B.REFERENCE_FAST_DCT_MS == RB.REFERENCE_FAST_DCT_MS
    assert B.REFERENCE_CPU_DCT_MS == RB.REFERENCE_CPU_DCT_MS


@pytest.mark.parametrize("kw", [{}, {"q_scale": 2.5}, {"transform": "rdct", "q_table": "chroma"}])
def test_host_dct_quant_bit_identical(kw):
    import tpudct

    img = B.photographic_image(64, seed=2)
    a = B._host_dct_quant(img, CodecConfig(**kw))
    b = RB._host_dct_quant(img, tpudct.CodecConfig(**kw))
    assert a.dtype == b.dtype and np.array_equal(a, b)
    out = B.bench_cpu_numpy(64, reps=1)
    assert set(out) == {"pipeline", "size", "dct_ms"} and out["dct_ms"] > 0


_TDC = [(1000, 28.0), (1800, 31.5), (3000, 34.2), (5200, 37.9), (9000, 41.0)]
_JPG = [(1200, 27.5), (2100, 31.0), (3600, 34.0), (6100, 37.2), (10500, 40.1)]


@pytest.mark.parametrize("anchor, test", [(_JPG, _TDC), (_TDC, _JPG), (_JPG, _JPG[::-1])])
def test_bd_metrics_match_reference(anchor, test):
    assert abs(B.bd_rate_pct(anchor, test) - RB.bd_rate_pct(anchor, test)) <= 1e-9
    assert abs(B.bd_psnr_db(anchor, test) - RB.bd_psnr_db(anchor, test)) <= 1e-9
    rows = [{"tdc_bytes": t[0], "tdc_psnr_db": t[1], "jpeg_bytes": j[0], "jpeg_psnr_db": j[1]}
            for t, j in zip(test, anchor)]
    assert B.bd_summary(rows) == RB.bd_summary(rows)


@pytest.mark.parametrize("fn", ["bd_rate_pct", "bd_psnr_db"])
@pytest.mark.parametrize("bad", [
    (_JPG[:3], _TDC),                                       # too few points
    ([(1, 30.0), (2, 30.0), (3, 31.0), (4, 32.0)], _TDC),   # PSNR not increasing
    ([(1, 28.0), (1, 29.0), (3, 31.0), (4, 32.0)], _TDC),   # rate not increasing
    ([(1, 1.0), (2, 2.0), (3, 3.0), (4, 4.0)], [(10**6, 50.0), (2 * 10**6, 51.0), (3 * 10**6, 52.0), (4 * 10**6, 53.0)]),
])
def test_bd_metrics_refuse_like_reference(fn, bad):
    """The same ValueError where the reference raises one (BD-rate takes a
    repeated rate, BD-PSNR a repeated PSNR: each fits against the other)."""
    try:
        want = getattr(RB, fn)(*bad)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            getattr(B, fn)(*bad)
    else:
        assert fn == "bd_rate_pct" and bad[0][1][0] == bad[0][0][0]
        assert abs(getattr(B, fn)(*bad) - want) <= 1e-9


def _pair_images(shape, seed, noise=12.0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, noise, shape), 0, 255).round().astype(np.float32)
    return x, y


@pytest.mark.parametrize("shape", [(64, 96), (5, 6), (33, 8)])
def test_metrics_match_reference(shape):
    x, y = _pair_images(shape, seed=shape[0])
    for name in ("mse", "psnr", "peen"):
        mine = float(getattr(M, name)(x, y, device="cpu"))
        ref = float(getattr(RM, name)(x, y))
        assert abs(mine - ref) <= 1e-5 * abs(ref), name
    assert abs(float(M.ssim(x, y, device="cpu")) - float(RM.ssim(x, y))) <= 1e-4
    t = M.mse(torch.as_tensor(x), torch.as_tensor(y))  # tensors stay where they are
    assert t.dtype == torch.float64 and t.device.type == "cpu" and t.dim() == 0


def test_metrics_guard_the_degenerate_cases_like_reference():
    x = np.full((16, 16), 100.0, np.float32)
    z = np.zeros((16, 16), np.float32)
    assert float(M.psnr(x, x, device="cpu")) == pytest.approx(float(RM.psnr(x, x)), rel=1e-6)
    assert float(M.peen(z, x, device="cpu")) == pytest.approx(float(RM.peen(z, x)), rel=1e-5)
    assert np.isfinite([float(M.psnr(x, x, device="cpu")), float(M.peen(z, x, device="cpu"))]).all()
    assert float(M.ssim(x, x, device="cpu")) == pytest.approx(1.0)


def test_metrics_of_host_arrays_follow_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.mse(np.zeros((8, 8)), np.zeros((8, 8)))


def test_device_time_ms_on_the_cpu():
    calls = []
    x = torch.ones(4)
    ms = device_time_ms(lambda v: calls.append(v.sum()), x, k_pair=(8, 72), reps=3)
    assert len(calls) == 4 and ms >= 0.0  # one warm-up, then the timed calls
    with pytest.raises(TypeError, match="torch.Tensor"):
        device_time_ms(lambda v: v, np.ones(4))
    with pytest.raises(ValueError, match="reps"):
        device_time_ms(lambda v: v, x, reps=0)


def test_phase_timer_records_and_measures():
    t = PhaseTimer()
    t.record("dct", 1.5)
    ms = t.measure("sum", lambda v: v.sum(), torch.ones(16), reps=2)
    rep = t.report()
    assert rep == {"dct": 1.5, "sum": ms} and ms >= 0.0
    rep["dct"] = 0.0
    assert t.report()["dct"] == 1.5


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr") as prof:
        with profiling.span("tpudct-step"):
            torch.ones(64).cumsum(0)
    names = {e.key for e in prof.key_averages()}
    assert "tpudct_torch.tpudct-step" in names
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") == "tpudct_torch.tpudct-step" for e in trace["traceEvents"])
    with profiling.trace() as prof2:
        torch.ones(4).sum()
    assert len(prof2.key_averages()) > 0


_PIPELINE_KEYS = {"pipeline", "size", "dct_ms", "idct_ms", "pair_ms", "mpix_per_s_pair", "backend",
                  "ref_hp_dct_ms", "speedup_dct_vs_ref_hp", "speedup_pair_vs_ref_hp"}


@pytest.mark.parametrize("name", ["hp", "batched", "fast"])
def test_bench_pipeline_keys_match_reference(name):
    import tpudct

    ref = RB.bench_pipeline("batched", 256, tpudct.CodecConfig(), k_pair=(1, 2), reps=1)
    out = B.bench_pipeline(name, 256, reps=1, device="cpu")
    assert set(out) == set(ref) == _PIPELINE_KEYS
    assert out["pipeline"] == name and out["backend"] == "cpu" and out["pair_ms"] > 0


def test_bench_pipeline_cublas_inside_its_cap():
    out = B.bench_pipeline("cublas", 64, reps=1, device="cpu")
    assert set(out) == _PIPELINE_KEYS - {"ref_hp_dct_ms", "speedup_dct_vs_ref_hp", "speedup_pair_vs_ref_hp"}


@pytest.mark.parametrize("bench, kw, keys", [
    ("bench_fused_roundtrip", {"size": 256},
     {"pipeline", "transform", "size", "roundtrip_ms", "mpix_per_s", "backend"}),
    ("bench_serving_throughput", {"size": 256, "batch": 2},
     {"pipeline", "path", "transform", "size", "batch", "batch_ms", "images_per_s", "mpix_per_s", "backend"}),
    ("bench_color", {"size": 256},
     {"pipeline", "path", "size", "subsample", "rgb_ms", "mpix_per_s", "backend"}),
    ("bench_color_serving", {"size": 256, "batch": 2},
     {"pipeline", "size", "batch", "batch_ms", "images_per_s", "mpix_per_s", "backend"}),
])
def test_device_benches_return_the_reference_keys(bench, kw, keys):
    out = getattr(B, bench)(reps=1, device="cpu", **kw)
    assert set(out) == keys and out["backend"] == "cpu"
    assert all(v > 0 for k, v in out.items() if k.endswith("_ms"))


@pytest.mark.parametrize("kw, path", [({}, "u8-fused"), ({"q_scale": 0.5}, "f32-fallback")])
def test_serving_bench_takes_the_references_path(kw, path):
    out = B.bench_serving_throughput(256, 2, CodecConfig(**kw), reps=1, device="cpu")
    assert out["path"] == path


@pytest.mark.parametrize("kw, path", [({"pipeline": "hp"}, "u8-planar"), ({"pipeline": "batched"}, "f32"),
                                      ({"pipeline": "hp", "subsample": False}, "u8-planar")])
def test_color_bench_takes_the_references_path(kw, path):
    out = B.bench_color(256, reps=1, device="cpu", **kw)
    assert out["path"] == path and out["subsample"] == ("444" if kw.get("subsample") is False else "420")


def test_color_serving_bench_refuses_off_grid():
    with pytest.raises(ValueError, match="color serving path needs"):
        B.bench_color_serving(200, 2, reps=1, device="cpu")


def test_sweep_runs_every_pipeline_at_every_size():
    rows = B.sweep((64, 128), reps=1, device="cpu")
    assert [(r["pipeline"], r["size"]) for r in rows] == [
        (n, s) for s in (64, 128) for n in ("batched", "fast", "hp")
    ]


def test_benches_follow_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.bench_pipeline("hp", 64, reps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.bench_color(256, reps=1)
