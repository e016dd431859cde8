#!/usr/bin/env python3
"""The benchmark of tpudct_torch: one run of one cell on the first CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's inputs from the seed on the card, sets the system up and
warms up every shape the cell uses (``setup_s``, from the process's start
to the window), drives calls in a closed loop for ``--seconds``, then judges
a sample of the window's answers against the plain reference in
``perfbench/reference/``.  ``--trace 1`` profiles a bounded stretch of the
window and reports the cell's per-layer metrics instead of its end-to-end
ones.  The last line of standard output is the result as one JSON object;
the numbers compared, each with its limit, are the last lines of standard
error and the result's last key.

Without a CUDA card, with fewer cards than the cell asks for, or where
``jax``, ``jaxlib``, ``flax`` or ``tpudct`` (the reference package) is
loaded, it exits with a code other than 0 and prints no result.  Build and
kernel caches stay at fixed paths inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / ".cache"


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip() or f"unread (exit {out.returncode})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the kernels build into the checkout's build/ (fixed in the port); any
    # torch extension or Triton cache goes to fixed places inside it too
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness

    chips = harness.workload(harness.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s), found {n}: no result", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    card = power_limit()  # after the run: nvidia-smi's start-up is no part of set-up
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    print(f"card: {card}", file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
