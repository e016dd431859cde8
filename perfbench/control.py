#!/usr/bin/env python3
"""The control of a cell's comparison, and the readings its limits are set
from.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--program]

For each seed: the cell's inputs at the cell's size, and in the system's
place the plain reference computed in bfloat16 (the precision below the
float32 that the configurations state), one answer per input slot up to
the cell's sample, judged by the cell's comparison in float64.
With ``--program`` the same seed's inputs also go once each through the
cell's own driver (the timed entry), judged the same way: the lower
readings beside the control's.  One JSON line per seed and side; a control
that stays within every limit is named on standard error and the exit
code is 1.  The benchmark's own runs never run this.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness

    device = torch.device("cuda", 0)
    wl = harness.workload(harness.benchmark(), args.workload)
    cell = harness.read_json("cells", args.workload)
    config = harness.read_json("configs", wl["config"])
    compare = harness.load("compare", cell["compare"])
    gen = harness.load("inputs", cell["inputs"])
    limits = cell["limits"]
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        x = gen.make(seed, cell["pool"], tuple(config["shape"]), device)
        slots = list(range(min(cell["pool"], cell["sample"])))
        sides = {"control": lambda k: compare.reference_answer(x[k], config["codec"], torch.bfloat16)}
        if args.program:
            ctx = harness.Context(device, config, x, harness.Spans())
            driver = harness.load("traffic", cell["driver"]).setup(ctx)
            sides["program"] = lambda k: driver.call(k)[0]
        for side, answer in sides.items():
            answers = [(k, answer(k)) for k in slots]
            nums = compare.numbers(answers, lambda k: x[k], config["codec"], device)
            within = {k: nums[k] <= limit for k, limit in limits.items()}
            if side == "control" and all(within.values()):
                passed.append(seed)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "numbers": nums, "within_limits": within}), flush=True)
            del answers
    if passed:
        print(f"the control stayed within every limit on seeds {passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
