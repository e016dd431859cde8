"""Fused against split u8 codec pass on the card: the port of
``benchmarks/rt_split_ab.py``.

    python -m tpudct_torch.studies.rt_split_ab [size] [trials]

The fused pass (hp_roundtrip_u8, B1: 3 B/px) against the split
composition (hp_decode_u8 of hp_encode_u8, B2 then B3: 4 B/px, the int8
map written and read back) on the u8 ``synthetic_image(size)`` (default
8192^2): first the two reconstructions on x[:512, :4096] (0 differing
pixels expected; counted), then ``trials`` (default 3) alternating pairs
timed with ``utils.timing.device_time_ms`` (CUDA events, L2 flushed, the
median of ``REPS`` calls after a warm-up).  Every line carries the card's
name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpudct_torch.benchmark import synthetic_image
from tpudct_torch.kernels import hp
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.studies import device_label, differ
from tpudct_torch.utils.timing import device_time_ms

#: Timed calls per measurement (each after one warm-up call).
REPS = 5


def fused(v: torch.Tensor) -> torch.Tensor:
    return hp.hp_roundtrip_u8(v)[1]


def split(v: torch.Tensor) -> torch.Tensor:
    return hp.hp_decode_u8(hp.hp_encode_u8(v))


def main(size: int = 8192, trials: int = 3, device=None) -> dict:
    """Print the check and one line per trial; return {"size", "card",
    "recon_differ", "fused_ms", "split_ms": [ms per trial]}."""
    dev = default_device(device)
    label = device_label(dev)
    x = torch.as_tensor(synthetic_image(size).astype(np.uint8), device=dev)
    small = x[:512, :4096].contiguous()
    out = {"size": size, "card": label, "recon_differ": differ(fused(small), split(small))[0],
           "fused_ms": [], "split_ms": []}
    print(f"split against fused reconstruction on {tuple(small.shape)}: {out['recon_differ']} pixels differ",
          flush=True)
    for t in range(trials):
        ms_f = device_time_ms(fused, x, reps=REPS)
        ms_s = device_time_ms(split, x, reps=REPS)
        out["fused_ms"].append(ms_f)
        out["split_ms"].append(ms_s)
        print(f"trial {t}: fused {ms_f:7.4f} ms | split {ms_s:7.4f} ms [{label}]", flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8192, int(sys.argv[2]) if len(sys.argv) > 2 else 3)
