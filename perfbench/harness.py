"""One run of one cell: set-up, the measured window, the traced stretch,
the metrics, and the comparison that decides ``correct``.

Everything that belongs to one cell, configuration, traffic driver, input
generator, comparison or metric sits in a file of its own, found by name:

- ``BENCHMARK.json`` (the checkout's root): the cells, their metrics;
- ``cells/<cell>.json``: the traffic mix (driver, generator, pool, warm-up,
  sample, traced stretch, the limits of the comparison, and the shape the
  CPU tests run it at);
- ``configs/<config>.json``: the deployment (shape, codec, floor bytes);
- ``traffic/<driver>.py``: ``setup(ctx)`` returning the driver, and what
  the harness and its tests read of its calls (``ANSWER_FROM``,
  ``ENTRIES``, ``STAGES``, ``pageable_bytes(config)``);
- ``inputs/<generator>.py``: ``make(seed, count, shape, device)``;
- ``compare/<comparison>.py``: ``numbers(answers, source, codec, device)``;
- ``metrics/<metric>.py``: ``read(run)``, a number or None.

A driver has ``pixels`` (input pixels per call), ``call(slot)`` returning
(answer, stats), ``source(slot)`` (the slot's input on the device, for the
reference) and ``release()`` (drops the system's state).  A call returns
when its result is where its caller wants it: host arrays or bytes, or
device tensors after a synchronize.

A traced run reads the port's registry of spans and counters
(``tpudct_torch.utils.profiling``) over ``REGISTRY_S`` of the cell's
calls, and its trace's ``min_calls`` at least, at the end of set-up,
before any profiler has run in the process (a profiler's per-operation
costs, and on the card what its session leaves behind, would count in the
host times of the port's spans).  The registry is off again before the
window, traced or not, so its costs stay out of every reading of the
window.  An untraced run never turns it on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import random
import sys
import time
import traceback

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
CALL = "call"  # the span around each whole call
EVENT_RING = 1024  # CUDA event pairs reused in turn
REGISTRY_S = 5.0  # seconds of calls a traced run reads the port's registry over
# Top-level modules no run may load: the reference package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpudct")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def read_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the harness, loaded by path."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}.{name}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the reference's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Spans:
    """Host seconds per span name over the window; while the profiler runs,
    each span is also a named range on its timeline."""

    def __init__(self):
        self.seconds: dict = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


@dataclasses.dataclass
class Context:
    """What a driver's ``setup`` gets."""

    device: torch.device
    config: dict
    inputs: torch.Tensor  # the pool, (count, ...) uint8 on the device
    spans: Spans

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Run:
    """What a metric's ``read`` gets."""

    config: dict
    setup_s: float
    window_s: float
    calls: int
    pixels: int  # input pixels of all calls of the window
    call_ms: list
    stats: dict  # the drivers' per-call stats, summed
    spans: dict  # host seconds per span over the window
    trace: object  # trace.Trace of the traced stretch, or None
    peaks: dict  # the card's row of peaks.json, or None
    stages: dict = dataclasses.field(default_factory=dict)  # the driver's STAGES
    registry: dict | None = None  # the port's registry before a traced run's window
    registry_calls: int = 0  # the calls it covers


class CallTimer:
    """Each call's time on the device's clock: CUDA events recorded before
    and after it, a ring of pairs read back as they come round (each call
    has returned, so its events have completed).  On the CPU, which only
    the tests use, the host's clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.ms: list = []
        if self.cuda:
            self.ring = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                         for _ in range(EVENT_RING)]
        self.n = 0

    def start(self) -> None:
        if self.cuda:
            if self.n >= EVENT_RING:
                a, b = self.ring[self.n % EVENT_RING]
                self.ms.append(a.elapsed_time(b))
            self.ring[self.n % EVENT_RING][0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.ring[self.n % EVENT_RING][1].record()
        else:
            self.ms.append((time.perf_counter() - self.t0) * 1e3)
        self.n += 1

    def finish(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            for k in range(max(0, self.n - EVENT_RING), self.n):
                a, b = self.ring[k % EVENT_RING]
                self.ms.append(a.elapsed_time(b))
        return self.ms


class Reservoir:
    """A uniform sample of ``k`` answers of the window, drawn from the seed
    (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, bench: dict | None = None, cell: dict | None = None,
             config: dict | None = None) -> dict:
    """One run of the cell ``name``; returns the result line as a dict.

    ``bench``, ``cell`` and ``config`` default to the files; the tests pass
    smaller ones.  ``t_start`` is the process's start on the host clock."""
    from perfbench import trace as tracing

    bench = benchmark() if bench is None else bench
    wl = workload(bench, name)
    cell = read_json("cells", name) if cell is None else cell
    config = read_json("configs", wl["config"]) if config is None else config
    if cell["config"] != wl["config"]:
        raise ValueError(f"cells/{name}.json names {cell['config']!r}, BENCHMARK.json {wl['config']!r}")
    readers = [(m, load("metrics", m["name"])) for m in metrics_of(bench, name, trace)]
    compare = load("compare", cell["compare"])
    traffic = load("traffic", cell["driver"])
    spans = Spans()

    driver, registry = _set_up(traffic, cell, config, seed, trace, device, spans)
    setup_s = time.perf_counter() - t_start
    w = _window(driver, cell, seconds, trace, seed, device, spans)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # -- metrics ------------------------------------------------------------
    tr = tracing.from_profiler(w.prof, set(spans.seconds), CALL) if w.prof is not None else None
    if tr is not None:
        print(f"traced stretch: {tr.calls} of {w.profiled} profiled calls, {tr.window_s:.6f} s, "
              f"{len(tr.device)} device intervals, {len(tr.spans)} spans", file=sys.stderr)
    if w.calls:
        per_call = ", ".join(f"{k} {v * 1e3 / w.calls:.3f}" for k, v in spans.seconds.items())
        print(f"host ms per call over {w.calls} calls: {per_call}", file=sys.stderr)
    peaks = json.loads((HERE / "peaks.json").read_text()).get(
        torch.cuda.get_device_name(device) if device.type == "cuda" else "", None)
    if registry is not None:
        print(f"port registry over {registry[1]} calls before the window: {len(registry[0]['spans'])} span names",
              file=sys.stderr)
    run = Run(config, setup_s, w.seconds, w.calls, w.calls * driver.pixels, w.call_ms,
              w.stats, dict(spans.seconds), tr, peaks, traffic.STAGES, *(registry or (None, 0)))
    metrics = {}
    for m, reader in readers:
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # -- correctness: the sample against the plain reference ----------------
    driver.release()
    source = driver.source
    del driver, run, registry
    w.prof = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = _judge(compare, w.sample, source, config, cell, device)
    correct = w.failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"]
                                    for c in checks.values())

    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded by the end of the run: {', '.join(found)}")
    result = {
        "correct": correct,
        "attempted": w.calls + w.failed,
        "failed": w.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        if tr.calls:
            result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = checks
    return result


def _set_up(traffic, cell, config, seed, trace, device, spans):
    """Inputs from the seed, the driver, the warm-up of every shape the
    cell uses (and, for a traced run, the port's registry over the cell's
    calls, then the profiler's warm-up); returns the driver, with the
    card's peak memory reset, and for a traced run the registry's snapshot
    and its calls."""
    inputs = load("inputs", cell["inputs"]).make(seed, cell["pool"], tuple(config["shape"]), device)
    ctx = Context(device, config, inputs, spans)
    driver = traffic.setup(ctx)
    ctx.inputs = inputs = None  # a driver keeps what it uses
    kept = []  # as many answers held as the window holds
    for i in range(cell["warmup_calls"]):
        kept = (kept + [driver.call(i % cell["pool"])])[-cell["sample"]:]
    registry = None
    if trace:
        registry = _read_registry(driver, cell, spans)
        warm = _profiler()  # the profiler's first start (CUPTI's set-up) takes seconds
        warm.start()
        kept.append(driver.call(0))
        warm.stop()
        del warm
    del kept
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded after set-up: {', '.join(found)}")
    spans.seconds.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    return driver, registry


def _read_registry(driver, cell, spans) -> tuple:
    """The port's registry over the cell's calls for its trace's
    ``REGISTRY_S`` and its trace's ``min_calls`` at least, each in the
    span ``CALL`` as ``perfbench/spans.py`` makes them: (snapshot, calls)."""
    from tpudct_torch.utils import profiling as registry

    registry.reset()
    registry.enable()
    n, t0 = 0, time.perf_counter()
    try:
        while n < max(1, cell["trace"]["min_calls"]) or time.perf_counter() - t0 < REGISTRY_S:
            with spans(CALL):
                driver.call(n % cell["pool"])
            n += 1
    finally:
        registry.disable()
    snap = registry.snapshot()
    registry.reset()
    return snap, n


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    calls: int = 0  # completed
    failed: int = 0
    call_ms: list = dataclasses.field(default_factory=list)
    stats: dict = dataclasses.field(default_factory=dict)
    sample: list = dataclasses.field(default_factory=list)  # [(slot, answer)]
    prof: object = None
    profiled: int = 0


def _window(driver, cell, seconds, trace, seed, device, spans) -> Window:
    """Calls in a closed loop until ``seconds`` have passed, the last one
    finished; a traced run profiles a stretch of it (cells' ``trace``)."""
    w, pool, tr_cfg = Window(), cell["pool"], cell["trace"]
    timer = CallTimer(device)
    sample = Reservoir(cell["sample"], seed)
    state, first, t_prof = "off", 0, 0.0
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if trace and state == "off" and time.perf_counter() - t0 >= tr_cfg["lead_s"]:
            t = time.perf_counter()
            w.prof = _profiler()
            w.prof.start()
            spans.profiling, state, first = True, "on", i
            t_prof = time.perf_counter()
            deadline += t_prof - t  # the traced run's window is not timed
        timer.start()
        try:
            with spans(CALL):
                answer, st = driver.call(i % pool)
        except Exception:
            traceback.print_exc()
            w.failed = 1
            timer.stop()
            break
        timer.stop()
        sample.offer((i % pool, answer))
        del answer
        for k, v in st.items():
            w.stats[k] = w.stats.get(k, 0) + v
        i += 1
        now = time.perf_counter()
        if state == "on":
            n = i - first
            if n >= tr_cfg["max_calls"] or (now - t_prof >= tr_cfg["max_s"] and n >= tr_cfg["min_calls"]):
                w.prof.stop()
                spans.profiling, state, w.profiled = False, "done", n
                deadline += time.perf_counter() - now
        if now >= deadline:
            break
    w.seconds = time.perf_counter() - t0
    if state == "on":
        w.prof.stop()
        spans.profiling, w.profiled = False, i - first
    w.calls, w.call_ms, w.sample = i, timer.finish(), sample.items
    return w


def _judge(compare, answers, source, config, cell, device) -> dict:
    """Each number the cell limits, beside its limit; a number that could
    not be read (no answer, or an answer of the wrong shape) is null."""
    limits = cell["limits"]
    numbers = compare.numbers(answers, source, config["codec"], device) if answers else {}
    missing = set(limits) - set(numbers)
    if answers and missing:
        raise ValueError(f"the comparison {cell['compare']!r} reads no {sorted(missing)}")
    out = {}
    for k, limit in limits.items():
        v = numbers.get(k)
        out[k] = {"value": v if v is not None and math.isfinite(v) else None, "limit": limit}
    return out
