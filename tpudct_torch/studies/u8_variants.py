"""The u8 roundtrip variants on the card: the port of ``benchmarks/u8_variants.py``.

    python -m tpudct_torch.studies.u8_variants [size] [which]

The TPU study weighed three ways to lay B1's fused u8 roundtrip onto its
matrix unit (``kernels.variants``: ``rt_u8_vint`` B27 interleaves the
forward and inverse per 128-lane chunk, ``rt_u8_vbf`` B28 contracts the
lanes on bf16 digits, ``rt_u8_vcs`` B29 stores per chunk).  Each computes
B1's values, and on the H100 each launches B1's kernel under its own
counter, so these lines measure B1 again under other names.  ``which``
(default "int"):

  int   B27 against hp_roundtrip_u8 (B1) on x[:1024, :2048] (0 differing
        coefficients and reconstructions expected; counted), then B27 timed
  bf    the same for B28, timed at band_rows 256 and 128 (inert here)
  abbf  B1 ("shipped") and B28 ("bf16digit") in turns, 4 trials
  cs    B29 checked as "int", then B1 and B29 ("chunkstore") in turns

on the u8 ``synthetic_image(size)`` (default 8192^2; H % 32 == 0 and
W % 128 == 0), each time with ``utils.timing.device_time_ms`` (CUDA events,
L2 flushed, the median of ``REPS`` calls after a warm-up): the reference's
chain-slope A/B (``_chain``/``_best_wall``) becomes that timer in turns,
each trial's times printed and then each arm's min and median.  Every line
carries the card's name and power limit.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from tpudct_torch.benchmark import synthetic_image
from tpudct_torch.kernels import hp
from tpudct_torch.kernels.variants import rt_u8_vbf, rt_u8_vcs, rt_u8_vint
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.studies import device_label, differ
from tpudct_torch.utils.timing import device_time_ms

__all__ = ["main", "rt_u8_vbf", "rt_u8_vcs", "rt_u8_vint"]

#: Timed calls per measurement (each after one warm-up call).
REPS = 5
#: Trials of each in-turns A/B.
TRIALS = 4
MODES = ("int", "bf", "abbf", "cs")


def check(x: torch.Tensor, variant) -> dict:
    """{"coeffs_differ", "recon_differ"}: ``variant`` against hp_roundtrip_u8
    on x[:1024, :2048]."""
    s = x[:1024, :2048].contiguous()
    (c0, r0), (c1, r1) = hp.hp_roundtrip_u8(s), variant(s)
    return {"coeffs_differ": differ(c0, c1)[0], "recon_differ": differ(r0, r1)[0]}


def in_turns(arms: dict, x: torch.Tensor, label: str) -> dict:
    """name -> [ms per trial]: the arms timed in turns, TRIALS times."""
    res = {name: [] for name in arms}
    for trial in range(TRIALS):
        for name, fn in arms.items():
            ms = device_time_ms(fn, x, reps=REPS)
            res[name].append(ms)
            print(f"trial {trial} {name}: {ms:7.4f} ms [{label}]", flush=True)
    for name, v in res.items():
        print(f"{name}: min {min(v):.4f} med {statistics.median(v):.4f} [{label}]", flush=True)
    return res


def main(size: int = 8192, which: str = "int", device=None) -> dict:
    """Print one line per check and measurement; return {"size", "card",
    "which", the check's counts where the mode checks, "<name>_ms" or, for
    the A/B modes, "trials": name -> [ms per trial]}."""
    if which not in MODES:
        raise ValueError(f"which must be one of {MODES}, got {which!r}")
    dev = default_device(device)
    label = device_label(dev)
    x = torch.as_tensor(synthetic_image(size).astype(np.uint8), device=dev)
    out = {"size": size, "card": label, "which": which}
    variant = {"int": rt_u8_vint, "bf": rt_u8_vbf, "cs": rt_u8_vcs}.get(which)
    if variant is not None:
        out.update(check(x, variant))
        print(f"{variant.__name__} against hp_roundtrip_u8 on x[:1024, :2048]: {out['coeffs_differ']} coefficients, "
              f"{out['recon_differ']} reconstructions differ", flush=True)
    if which == "int":
        out["rt_u8_vint_ms"] = ms = device_time_ms(lambda v: rt_u8_vint(v)[1], x, reps=REPS)
        print(f"{size}^2 V-INT (B27, B1's kernel): {ms:7.4f} ms [{label}]", flush=True)
    elif which == "bf":
        for br in (256, 128):
            out[f"rt_u8_vbf_{br}_ms"] = ms = device_time_ms(lambda v, br=br: rt_u8_vbf(v, band_rows=br)[1], x,
                                                            reps=REPS)
            print(f"{size}^2 V-BF (B28, B1's kernel) band_rows={br} (inert): {ms:7.4f} ms [{label}]", flush=True)
    else:
        other = {"abbf": ("bf16digit", rt_u8_vbf), "cs": ("chunkstore", rt_u8_vcs)}[which]
        out["trials"] = in_turns({"shipped": lambda v: hp.hp_roundtrip_u8(v)[1],
                                  other[0]: lambda v: other[1](v)[1]}, x, label)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8192, sys.argv[2] if len(sys.argv) > 2 else "int")
