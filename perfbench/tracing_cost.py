#!/usr/bin/env python3
"""What the port's tracing costs a ``gray8192.device`` call
(``models.dispatch.roundtrip_gray`` on a resident 8192² uint8 image, then a
synchronize: the most sensitive call, ~0.15 ms), in one process on one card.

    python3 perfbench/tracing_cost.py --parent <checkout> --seed <n> [--blocks 40] [--calls 250]

Three comparisons, each in alternating blocks of ``calls`` calls (a b, b a,
...; a pair is two neighbouring blocks), host microseconds per call:
``off``, the parent checkout's ``tpudct_torch/models/dispatch.py`` loaded as
a module of its own beside this checkout's, both on the same kernels and
images (on the aligned resident path the rest of the port runs the same
code), the registry off; ``decorator``, this checkout's entry against its
undecorated body; ``on``, the registry enabled against off, without the
profiler.  Prints one JSON line with each side's median and quartiles, the
pairs' differences and how many pairs the second side lost.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def quartiles(v: list) -> dict:
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2], "n": len(v)}


def alternate(blocks: int, first, second) -> dict:
    """``first()`` and ``second()`` (each a block's us per call) in turns,
    the order flipped every pair."""
    a, b = [], []
    for k in range(blocks):
        for side in ((0, 1) if k % 2 == 0 else (1, 0)):
            (a if side == 0 else b).append((first if side == 0 else second)())
    d = [y - x for x, y in zip(a, b)]
    return {"first": quartiles(a), "second": quartiles(b), "second_minus_first": quartiles(d),
            "second_slower": sum(x > 0 for x in d)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=40)
    ap.add_argument("--calls", type=int, default=250)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from perfbench import harness
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.models import dispatch
    from tpudct_torch.utils import profiling

    spec = importlib.util.spec_from_file_location(
        "parent_dispatch", pathlib.Path(args.parent) / "tpudct_torch" / "models" / "dispatch.py")
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)

    dev = torch.device("cuda", 0)
    config = harness.read_json("configs", "gray8192")
    pool = harness.load("inputs", "uniform_noise").make(args.seed, 4, tuple(config["shape"]), dev)
    p, cfg = get_pipeline(config["pipeline"]), CodecConfig(**config["codec"])

    def block(fn):
        t0 = time.perf_counter()
        for i in range(args.calls):
            fn(p, pool[i % 4], cfg)
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / args.calls * 1e6

    def traced():
        profiling.reset()
        profiling.enable()
        try:
            return block(dispatch.roundtrip_gray)
        finally:
            profiling.disable()

    for fn in (parent.roundtrip_gray, dispatch.roundtrip_gray):
        for _ in range(3):
            block(fn)
    mine = dispatch.roundtrip_gray
    out = {
        "card": torch.cuda.get_device_name(0), "blocks": args.blocks, "calls": args.calls,
        "off": alternate(args.blocks, lambda: block(parent.roundtrip_gray), lambda: block(mine)),
        "decorator": alternate(args.blocks, lambda: block(getattr(mine, "__wrapped__", mine)),
                               lambda: block(mine)),
        "on": alternate(args.blocks, lambda: block(mine), traced),
    }
    profiling.reset()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
