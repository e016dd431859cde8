"""Whole runs of every cell on the CPU at its ``test_shape``, past the look
for a card: the system's plain twins on the timed path, the window, the
traced stretch, the port's registry and the comparison.  Sound runs come
out correct; runs with the timed path broken underneath come out not
correct.  What a test needs to know of a cell's calls, its traffic
driver's module says."""

import time

import numpy as np
import pytest
import torch

from perfbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
WARMUP = 2  # warm-up calls of a small run


def traffic_of(name):
    """The module of the cell's traffic driver."""
    return harness.load("traffic", harness.read_json("cells", name)["driver"])


@pytest.fixture(autouse=True)
def _short_registry_read(monkeypatch):
    """A small traced run reads the registry over its one call."""
    monkeypatch.setattr(harness, "REGISTRY_S", 0.0)


def run_small(name, seconds=0.3, trace=False, seed=2**31 + 99):
    bench = harness.benchmark()
    cell = harness.read_json("cells", name)
    config = harness.read_json("configs", harness.workload(bench, name)["config"])
    config["shape"] = cell["test_shape"]
    cell["warmup_calls"] = WARMUP
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
    if "entropy" in traffic_of(name).STAGES:
        assert r["metrics"]["entropy_ms_per_call"]["value"] > 0
    # without a card the device's readers find nothing; every other one reads
    readable = {m["name"] for m in harness.metrics_of(harness.benchmark(), name, True)
                if m["source"] != "device_trace"}
    assert readable <= set(r["metrics"]), readable - set(r["metrics"])


def _capture_runs(monkeypatch) -> list:
    """Every ``harness.Run`` that the metrics are read from, kept."""
    runs = []

    class Kept(harness.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    return runs


def _registry_states(monkeypatch, name) -> list:
    """Whether the port's registry was on, at each call of the port's
    function that the cell's answer reads."""
    import importlib

    from tpudct_torch.utils import profiling

    mod_name, attr = traffic_of(name).ANSWER_FROM[:2]
    mod = importlib.import_module(mod_name)
    real, seen = getattr(mod, attr), []

    def spy(*a, **k):
        seen.append(profiling._on)
        return real(*a, **k)

    monkeypatch.setattr(mod, attr, spy)
    return seen


def test_an_untraced_run_leaves_the_registry_off(monkeypatch):
    runs, seen = _capture_runs(monkeypatch), _registry_states(monkeypatch, "gray8192.device")
    r = run_small("gray8192.device", seconds=0.2)
    assert r["correct"] and seen and not any(seen)
    (run,) = runs
    assert run.registry is None and run.registry_calls == 0


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_hands_the_run_the_registry(name, monkeypatch):
    from tpudct_torch.utils import profiling

    runs, seen = _capture_runs(monkeypatch), _registry_states(monkeypatch, name)
    r = run_small(name, trace=True)
    assert r["correct"], r["checks"]
    (run,) = runs
    read, profiled = run.registry_calls, run.trace.calls
    assert read >= 1 and profiled >= 1 and not profiling._on
    # off over the warm-up, on over the registry's calls, off from the
    # profiler's warm-up call on, through the window and its profiled stretch
    assert seen == [False] * WARMUP + [True] * read + [False] * (len(seen) - WARMUP - read)
    spans = run.registry["spans"]
    for entry in traffic_of(name).ENTRIES:
        assert spans[profiling.PREFIX + "entry." + entry]["count"] == run.registry_calls, entry


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
          ] + [(n, "coefficients_half_left_out") for n in CELLS if traffic_of(n).ANSWER_FROM[3] is not None]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    import importlib

    mod_name, attr, pix, coef = traffic_of(name).ANSWER_FROM
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
