#!/usr/bin/env python3
"""The port's spans and counters over a cell's own traffic: the readings
that the registry of ``tpudct_torch/utils/profiling.py`` gives over a
loop of calls, beside a traced run's (whose metrics on the registry read
through ``readings`` here, so that the two cannot drift apart).

    python3 perfbench/spans.py --workload <cell> --seed <n> --calls <N> [--profile <M>]

Makes the cell's inputs and driver as a run does and warms up every shape;
then N calls with the registry on and no profiler, and prints one JSON
line: per call, the dispatch layer's self ms (the self time of the
``entry.*`` spans), the pageable MiB and the staging ms of the port's own
host copies, the share of the entropy trials' and encodes' seconds that
went into the stream, the harness's span around each entry, and each span
name's count, total, self and kept ms.  With ``--profile``, M more calls
under ``torch.profiler``: the layout ms per call (the union of the device
intervals that are not copies inside the device-side ranges of the port's
``pad`` and ``layout`` spans) and the device's idle time by the innermost
harness or port span.  Needs a CUDA card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

CALL = "call"


def _per_call(snap: dict, calls: int, names, key: str = "total_s"):
    got = [v[key] for k, v in snap["spans"].items() if k in names]
    return sum(got) * 1e3 / calls if got else None


def readings(snap: dict, calls: int, prefix: str = "tpudct_torch.") -> dict:
    """The per-call readings of a registry snapshot over ``calls`` calls;
    each None where the snapshot holds nothing it reads."""
    spans = snap["spans"]
    entries = [k for k in spans if k.startswith(prefix + "entry.")]
    coded = [k for k in spans if k.startswith((prefix + "entropy.trial.", prefix + "entropy.encode."))]
    coded_s = sum(spans[k]["total_s"] for k in coded)
    pageable = snap["counters"].get(prefix + "bytes.pageable")
    return {
        # a nested entry's self time lies outside its parent's
        "dispatch_self_ms_per_call": _per_call(snap, calls, entries, "self_s"),
        "pageable_mib_per_call": None if pageable is None else pageable / calls / 2**20,
        "staging_ms_per_call": _per_call(snap, calls, {prefix + "to_device", prefix + "to_host"}),
        "entropy_useful_pct": (100 * sum(spans[k]["kept_s"] for k in coded) / coded_s) if coded_s else None,
    }


def layout_ms_per_call(annotations, device, calls: int, prefix: str = "tpudct_torch."):
    """Union of the kernel and memset intervals inside the device-side
    ranges of the ``pad`` and ``layout`` spans, in ms per call; None
    without such a range.  ``annotations`` and ``device`` are
    (name, start us, end us)."""
    from perfbench import trace as tracing

    ranges = [(s, e) for n, s, e in annotations if n in (prefix + "pad", prefix + "layout")]
    if not ranges or not calls:
        return None
    kernels = [(s, e) for n, s, e in device if tracing.kind(n) in ("kernel", "memset")]
    inside = [(max(s, a), min(e, b)) for a, b in ranges for s, e in kernels if e > a and s < b]
    return tracing.union(inside) / 1e3 / calls


def measure(name: str, seed: int, calls: int, profile: int, device, cell=None, config=None) -> dict:
    """The readings over ``calls`` calls of the cell ``name`` (and, with
    ``profile``, over that many profiled calls); ``cell`` and ``config``
    default to the files (the tests pass smaller ones)."""
    import torch

    from perfbench import harness
    from perfbench import trace as tracing
    from tpudct_torch.utils import profiling

    bench = harness.benchmark()
    wl = harness.workload(bench, name)
    cell = harness.read_json("cells", name) if cell is None else cell
    config = harness.read_json("configs", wl["config"]) if config is None else config
    inputs = harness.load("inputs", cell["inputs"]).make(seed, cell["pool"], tuple(config["shape"]), device)
    spans = harness.Spans()
    ctx = harness.Context(device, config, inputs, spans)
    driver = harness.load("traffic", cell["driver"]).setup(ctx)
    ctx.inputs = inputs = None
    for i in range(cell["warmup_calls"]):
        driver.call(i % cell["pool"])
    ctx.sync()

    def loop(n):
        for i in range(n):
            with spans(CALL):
                driver.call(i % cell["pool"])
        ctx.sync()

    spans.seconds.clear()
    profiling.reset()
    profiling.enable()
    t0 = time.perf_counter()
    try:
        loop(calls)
    finally:
        profiling.disable()
    wall = time.perf_counter() - t0
    snap = profiling.snapshot()
    pre = profiling.PREFIX
    out = {"workload": name, "seed": seed, "calls": calls, "wall_ms_per_call": wall * 1e3 / calls,
           **readings(snap, calls, pre),
           "harness_ms_per_call": {k: v * 1e3 / calls for k, v in spans.seconds.items()},
           "spans_ms_per_call": {k[len(pre):]: {"count": v["count"] / calls, "total": v["total_s"] * 1e3 / calls,
                                                "self": v["self_s"] * 1e3 / calls,
                                                "kept": v["kept_s"] * 1e3 / calls}
                                 for k, v in sorted(snap["spans"].items())},
           "counters_per_call": {k[len(pre):]: v / calls for k, v in snap["counters"].items()}}
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        warm = torch.profiler.profile(activities=acts)  # CUPTI's set-up outside the stretch
        warm.start()
        driver.call(0)
        warm.stop()
        spans.seconds.clear()
        profiling.reset()
        profiling.enable()
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        spans.profiling = True
        try:
            loop(profile)
        finally:
            spans.profiling = False
            prof.stop()
            profiling.disable()
        names = set(spans.seconds) | {e.name for e in prof.events() if e.name.startswith(pre)}
        tr = tracing.from_profiler(prof, names, CALL)
        out.update({"profiled_calls": tr.calls,
                    "layout_ms_per_call": layout_ms_per_call(tr.annotations, tr.device, tr.calls, pre),
                    "busy_s": tr.busy_s(), "window_s": tr.window_s,
                    "breakdown": tracing.breakdown(tr) if tr.calls else None})
    driver.release()
    profiling.reset()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--profile", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = measure(args.workload, args.seed, args.calls, args.profile, torch.device("cuda", 0))
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
