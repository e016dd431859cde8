"""Cross-check of the package's timer on the card: the port of
``benchmarks/timing_xval.py``.

    python -m tpudct_torch.studies.timing_xval [size]

Every device time of the port comes from ``utils.timing.device_time_ms``
(CUDA events around each call, the L2 flushed before it, the median).  This
study reads the headline pass, B1 (``get_pipeline("hp").roundtrip_u8``) on
the size x size ``benchmark.synthetic_image`` (default 8192²), three ways,
one JSON line each:

  1. ``device_time_ms`` (``REPS`` calls after a warm-up);
  2. the amortized host wall of one chain of K = 1024 launches: enqueue
     them, synchronize once, divide the wall by K (best of 3).  No L2 flush
     and no subtraction; it includes the enqueue and the synchronize, about
     their latency / K;
  3. a least-squares line wall = a·K + b through the best-of-3 walls of
     chains at K in {8, 24, 72, 216, 648}: the slope a from five points,
     the intercept b the launch and synchronize latency of one chain, R²
     near 1 where the cost per launch stays constant.

The chains run back to back on one input, without the timer's L2 flush;
the 8192² pass moves 192 MB, above the card's 50 MB L2, so the slope should
land near the flushed reading.  Walls are the host clock around work that
ends in a synchronize.  A last line gives the slope and the amortized wall
over ``device_time_ms``.  Every line carries the card's name and power
limit (or says it is the host clock).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tpudct_torch import CodecConfig, get_pipeline
from tpudct_torch.benchmark import synthetic_image
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.studies import device_label
from tpudct_torch.utils.timing import device_time_ms

#: Timed calls of device_time_ms (each after one warm-up call).
REPS = 5
K_BIG = 1024
KS = (8, 24, 72, 216, 648)
#: Walls per chain; the best is kept.
WALL_REPS = 3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _chain(op, x: torch.Tensor, k: int) -> float:
    """Host seconds for k launches of op(x) and one synchronize."""
    _sync(x.device)
    t0 = time.perf_counter()
    for _ in range(k):
        op(x)
    _sync(x.device)
    return time.perf_counter() - t0


def _best_wall(op, x: torch.Tensor, k: int, reps: int = WALL_REPS) -> float:
    return min(_chain(op, x, k) for _ in range(reps))


def _fit(ks, walls) -> tuple:
    """(slope, intercept, R²) of the least-squares line walls = slope·k +
    intercept."""
    a_mat = np.vstack([np.asarray(ks, np.float64), np.ones(len(ks))]).T
    y = np.asarray(walls, np.float64)
    (a, b), *_ = np.linalg.lstsq(a_mat, y, rcond=None)
    ss_res = float(((y - a_mat @ np.array([a, b])) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return float(a), float(b), 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0


def main(size: int = 8192, device=None) -> dict:
    """Print the three readings and their agreement, one JSON line each;
    return {"size", "card", "device_time_ms", "amortized_ms", "fit_ms",
    "intercept_ms", "r2", "walls_s", "fit_over_timer", "amortized_over_timer"}."""
    dev = default_device(device)
    label = device_label(dev)
    p, cfg = get_pipeline("hp"), CodecConfig()
    x = torch.as_tensor(synthetic_image(size).astype(np.uint8), device=dev)

    def op(v):
        return p.roundtrip_u8(v, cfg)[1]

    out = {"size": size, "card": label}

    def emit(row: dict) -> None:
        print(json.dumps({**row, "card": label}), flush=True)

    out["device_time_ms"] = t = device_time_ms(op, x, reps=REPS)
    emit({"protocol": f"device_time_ms(reps={REPS})", "ms": t})
    wall = _best_wall(op, x, K_BIG)
    out["amortized_ms"] = wall / K_BIG * 1e3
    emit({"protocol": f"amortized(K={K_BIG})", "ms": out["amortized_ms"], "wall_s": wall,
          "note": "includes one enqueue and synchronize / K"})
    walls = [_best_wall(op, x, k) for k in KS]
    a, b, r2 = _fit(KS, walls)
    out.update(fit_ms=a * 1e3, intercept_ms=b * 1e3, r2=r2, walls_s=walls)
    emit({"protocol": f"linear-fit(K={list(KS)})", "ms": a * 1e3, "intercept_ms": b * 1e3, "r2": r2,
          "walls_s": walls})
    out["fit_over_timer"] = out["fit_ms"] / t
    out["amortized_over_timer"] = out["amortized_ms"] / t
    emit({"agreement": {"fit_over_device_time": out["fit_over_timer"],
                        "amortized_over_device_time": out["amortized_over_timer"]}})
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8192)
