"""Whole runs of every cell on the CPU at a small size, past the look for a
card: the system's plain twins on the timed path, the window, the traced
stretch and the comparison.  Sound runs come out correct; runs with the
timed path broken underneath come out not correct."""

import time

import numpy as np
import pytest
import torch

from perfbench import harness

SMALL = {"gray8192": [256, 256], "camera420": [128, 512]}
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def run_small(name, seconds=0.3, trace=False, seed=2**31 + 99):
    bench = harness.benchmark()
    cell = harness.read_json("cells", name)
    config = harness.read_json("configs", harness.workload(bench, name)["config"])
    config["shape"] = SMALL[config["name"]]
    cell["warmup_calls"] = 2
    cell["trace"] = dict(cell["trace"], lead_s=0.0, max_s=0.05, min_calls=1)
    return harness.run_cell(name, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                            bench=bench, cell=cell, config=config)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = run_small(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(harness.read_json("cells", name)["limits"])
    want = {m["name"] for m in harness.metrics_of(harness.benchmark(), name, False)}
    assert set(r["metrics"]) == want


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_stretch(name):
    r = run_small(name, trace=True)
    assert r["correct"], r["checks"]
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0.0  # no device on the CPU
    assert r["breakdown"]["idle_gaps"]
    if name == "camera420.tdcc":
        assert r["metrics"]["entropy_ms_per_call"]["value"] > 0


# The function of the system whose result each cell's answer reads, and
# where in that result the decoded pixels and the coefficients are.
TARGETS = {
    "gray8192.device": ("tpudct_torch.models.dispatch", "roundtrip_gray", 1, 0),
    "gray8192.host": ("tpudct_torch.models.dispatch", "decode_gray_auto", None, None),
    "camera420.device": ("tpudct_torch.models.color", "roundtrip_color_auto", 2, 0),
    "camera420.tdcc": ("tpudct_torch.models.color", "decode_color_auto", None, None),
}


def _flip_rows(x):
    x = x.clone() if isinstance(x, torch.Tensor) else x.copy()
    x[:8] = 255 - x[:8]
    return x


def _drop_half(x):
    x = x.clone() if isinstance(x, torch.Tensor) else x.copy()
    x[x.shape[0] // 2:] = 0
    return x


def _zero_half_coeffs(c):
    if isinstance(c, dict):
        return {k: _drop_half(v) for k, v in c.items()}
    return _drop_half(c)


def _broken(fn, fault, pix, coef):
    last = []

    def wrapper(*a, **k):
        out = fn(*a, **k)
        parts = list(out) if pix is not None else [out]
        i = 0 if pix is None else pix
        if fault == "altered":
            parts[i] = _flip_rows(parts[i])
        elif fault == "half_left_out":
            parts[i] = _drop_half(parts[i])
        elif fault == "coefficients_half_left_out":
            parts[coef] = _zero_half_coeffs(parts[coef])
        elif fault == "stale":  # returns the state of the call before
            prev = last[0] if last else parts
            last[:] = [parts]
            parts = prev
        return tuple(parts) if pix is not None else parts[0]

    return wrapper


FAULTS = [(n, f) for n in CELLS for f in ("altered", "half_left_out", "stale")
          ] + [(n, "coefficients_half_left_out") for n in CELLS if TARGETS[n][3] is not None]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    import importlib

    mod_name, attr, pix, coef = TARGETS[name]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, _broken(getattr(mod, attr), fault, pix, coef))
    r = run_small(name, seconds=0.2)
    assert not r["correct"], (fault, r["checks"])


def test_a_call_that_raises_counts_as_failed(monkeypatch):
    from tpudct_torch.models import dispatch

    def boom(*a, **k):
        raise RuntimeError("planted")

    r0 = run_small("gray8192.device", seconds=0.1)
    assert r0["correct"]
    calls = {"n": 0}
    real = dispatch.roundtrip_gray

    def sometimes(*a, **k):
        calls["n"] += 1
        return real(*a, **k) if calls["n"] <= 2 else boom()

    monkeypatch.setattr(dispatch, "roundtrip_gray", sometimes)
    r = run_small("gray8192.device", seconds=0.1)
    assert r["failed"] == 1 and not r["correct"]


def test_inputs_depend_on_the_seed_alone():
    gen = harness.load("inputs", "photo_rgb")
    a = gen.make(2**31 + 5, 2, (64, 96), torch.device("cpu"))
    b = gen.make(2**31 + 5, 2, (64, 96), torch.device("cpu"))
    c = gen.make(2**31 + 6, 2, (64, 96), torch.device("cpu"))
    assert a.shape == (2, 64, 96, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    # photo-like: neighbouring pixels close (uniform noise differs by 85 on average)
    p = gen.make(1, 1, (256, 256), torch.device("cpu"))
    d = (p[..., 1:, :].to(torch.int16) - p[..., :-1, :].to(torch.int16)).abs().float().mean()
    assert float(d) < 10
    g = harness.load("inputs", "uniform_noise").make(3, 2, (64, 64), torch.device("cpu"))
    assert g.dtype == torch.uint8 and abs(float(g.float().mean()) - 127.5) < 4
    assert np.array_equal(g.numpy(), harness.load("inputs", "uniform_noise").make(3, 2, (64, 64), "cpu").numpy())
