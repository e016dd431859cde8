"""Fused scaled decode against the composed one on the card: the port of
``benchmarks/scaled_ab.py``.

    python -m tpudct_torch.studies.scaled_ab [size]

hp_scaled_decode_u8 (B7: the decode and the f x f box average in one pass)
against box_pool_u8 of the full decode (``get_pipeline("hp").decode_u8``,
B3, then the window sums in torch), at f = 2 and f = 8, on the coefficients
of uniform u8 noise (seed 7, default 8192^2) coded by the pipeline's
``encode_u8``: the outputs compared (differing entries counted; 0 expected,
both are the exact box average of the same truncated decode), then each arm
timed with ``utils.timing.device_time_ms`` (CUDA events, L2 flushed, the
median of ``REPS`` calls after a warm-up).  The reference's chained-slope
protocol and its XOR feedback pass exist to time through its TPU's remote
dispatch and are left out.  Every line carries the card's name and power
limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpudct_torch import CodecConfig, get_pipeline
from tpudct_torch.kernels import hp
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.ops.scaled import box_pool_u8
from tpudct_torch.studies import device_label
from tpudct_torch.utils.timing import device_time_ms

#: Timed calls per measurement (each after one warm-up call).
REPS = 5
FACTORS = (2, 8)


def main(size: int = 8192, device=None) -> dict:
    """Print one line per factor; return {"size", "card", "f<f>_differ",
    "f<f>_fused_ms", "f<f>_composed_ms"} for each factor."""
    dev = default_device(device)
    label = device_label(dev)
    rng = np.random.default_rng(7)
    img = torch.as_tensor(rng.integers(0, 256, (size, size), dtype=np.uint8), device=dev)
    p, cfg = get_pipeline("hp"), CodecConfig()
    c = p.encode_u8(img, cfg)
    out = {"size": size, "card": label}
    print(f"coeffs {tuple(c.shape)} {c.dtype} [{label}]", flush=True)
    for f in FACTORS:
        if not hp.supports_scaled_u8(size, size, f, f):
            raise ValueError(f"hp_scaled_decode_u8 does not take {size}x{size} at f={f}")

        def fused(v, f=f):
            return hp.hp_scaled_decode_u8(v, f, f)

        def composed(v, f=f):
            return box_pool_u8(p.decode_u8(v, cfg), f, f)

        a, b = fused(c), composed(c)
        out[f"f{f}_differ"] = n = int((a != b).sum())
        out[f"f{f}_fused_ms"] = t_f = device_time_ms(fused, c, reps=REPS)
        out[f"f{f}_composed_ms"] = t_c = device_time_ms(composed, c, reps=REPS)
        print(f"f={f}: fused {t_f:.4f} ms  composed {t_c:.4f} ms  ({t_f / t_c:.3f}x)  differing {n} of "
              f"{a.numel()} [{label}]", flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8192)
