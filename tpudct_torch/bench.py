"""Headline benchmark of the port: the counterpart of the reference's ``bench.py``.

    python3 -m tpudct_torch.bench

On the first CUDA card: the golden-model correctness gate and every kernel
family's gate (``selftest.correctness_gate``, ``selftest.family_gates``; one
JSON report per line on stderr), and only then the timed headline, the fused
8192^2 u8 codec pass (``get_pipeline("hp").roundtrip_u8``: one
``hp_roundtrip_u8`` launch); then one stderr line with the device, the
card's name and power limit, and the seconds of the gates and of the whole
run.  Stdout gets exactly ONE JSON line:

    {"metric": "8192x8192 DCT+quant+IDCT ms/image per chip", "value": <ms>,
     "unit": "ms", "vs_baseline": <speedup>}

or, where a gate fails or the card is missing, ``{"error": ...}`` and exit
code 1.  There is no CPU fallback: without a card the run fails.

Baseline: the original HpApprDCT on a Tesla T4 times the DCT phase at 14.70
ms at 8192^2 and the IDCT phase the same, so the full pass is 29.4 ms;
``vs_baseline`` is 29.4 / value (> 1 is faster than the original).

Timing: ``utils.timing.device_time_ms`` -- CUDA events around each call, the
L2 flushed outside them, one warm-up call, the median of 5 -- the device-time
protocol of the original's cudaEvent pairs (main_newAppr.cu:266-287).

Environment: ``TPUDCT_GATE=basic`` runs the golden gate only, without the
family gates; ``TPUDCT_BENCH_TIMEOUT`` (seconds, default 2400; 0 or less
disarms it) bounds the whole run: a hung launch or synchronize, or a wedged
kernel build, prints one ``{"error": ...}`` line and exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np
import torch

from tpudct_torch import selftest
from tpudct_torch.config import CodecConfig
from tpudct_torch.kernels import hp
from tpudct_torch.models import get_pipeline
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.utils.timing import card, device_time_ms

#: The original's DCT + IDCT phases on a Tesla T4 at 8192^2 (2 x 14.70 ms).
BASELINE_PAIR_MS = 2 * 14.70


def _arm_watchdog() -> threading.Event:
    """Fail loudly where the run hangs: a wedged launch blocks the first
    synchronize forever, and the run would record nothing.  A daemon thread
    (a signal handler never runs while the main thread is blocked in a
    native call) waits ``TPUDCT_BENCH_TIMEOUT`` seconds (default 2400),
    then prints one JSON error line and hard-exits 1.  Setting the returned
    event cancels it."""
    done = threading.Event()
    timeout = int(os.environ.get("TPUDCT_BENCH_TIMEOUT", "2400"))
    if timeout <= 0:
        return done

    def _abort():
        if done.wait(timeout):
            return
        print(json.dumps({
            "error": f"bench timed out after {timeout}s (a kernel launch or synchronize hung, "
                     "or a kernel build wedged)"
        }))
        sys.stdout.flush()
        os._exit(1)

    threading.Thread(target=_abort, daemon=True).start()
    return done


def main(size: int = 8192, device=None) -> int:
    """Gate, then time the size x size headline pass; print its one JSON
    line and return 0, or one error line and return 1.  ``size`` and
    ``device`` exist for tests (``device="cpu"`` times the f32 pair on the
    plain twins); the command line takes no arguments."""
    done = _arm_watchdog()
    t0 = time.perf_counter()
    try:
        cfg, p = CodecConfig(), get_pipeline("hp")
        # Correctness first: a wrong kernel fails the run and is never timed.
        # The reports go to stderr, so stdout stays the one JSON line.
        # A gate's set-up (the card, a file, a launch) can raise as well as its
        # checks: either way the output is one JSON line, never a traceback,
        # and nothing is retried (a wrong kernel is wrong every time).
        try:
            dev = default_device(device)
            gate = selftest.correctness_gate(p, cfg, device=dev)
            fams = [] if os.environ.get("TPUDCT_GATE") == "basic" else selftest.family_gates(p, cfg, device=dev)
            label = card() if dev.type == "cuda" else None
            gates_s = time.perf_counter() - t0
        except (AssertionError, ValueError, OSError, RuntimeError) as e:
            print(json.dumps({"error": f"correctness gate failed: {e}"}))
            return 1
        for rep in (gate, *fams):
            print(json.dumps(rep), file=sys.stderr)

        img = selftest.synthetic_image(size)
        # The headline: the fused u8 pass (u8 image -> int8 coefficients and
        # u8 reconstruction, one kernel) where the card runs it; else the f32
        # pair of separate phases, as the reference times off the TPU.
        if dev.type == "cuda" and hp.supports_u8(size, size, cfg.q_scale, cfg.transform, cfg.q_table):
            x = torch.as_tensor(img.astype(np.uint8), device=dev)
            ms = device_time_ms(lambda v: p.roundtrip_u8(v, cfg)[1], x, reps=5)
        else:
            x = torch.as_tensor(img, device=dev)
            ms = device_time_ms(lambda v: p.idct(p.dct(v, cfg), cfg), x, reps=5)
        # the seconds from main's start: the gates (on a fresh checkout also
        # the kernels' build, at their first launch) and the whole run
        print(json.dumps({"device": str(dev), "card": label, "gates_s": round(gates_s, 3),
                          "main_s": round(time.perf_counter() - t0, 3)}), file=sys.stderr)
        # vs_baseline from the printed value, so the line holds by itself
        value = round(ms, 4)
        print(json.dumps({
            "metric": f"{size}x{size} DCT+quant+IDCT ms/image per chip",
            "value": value,
            "unit": "ms",
            "vs_baseline": round(BASELINE_PAIR_MS / value, 2) if value > 0 else None,
        }))
        return 0
    finally:
        done.set()


if __name__ == "__main__":
    sys.exit(main())
