"""Color split/merge variants on the card, round 1: the port of
``benchmarks/color_variants.py``.

    python -m tpudct_torch.studies.color_variants [size]

The 4:2:0 pair (``color_split_420_u8`` B8, then ``color_merge_420_u8`` B9;
(3, H, W) u8 -> (3, H, W) u8) against one variant per hypothesis
(``kernels.variants``):

  V1   the merge with the compare-form round (the TPU kernel shifted the
       chroma at half resolution; here the shift is per pixel either way):
       B9's values on every input
  V12  V1 with the direct-form inverse g = (y - c1 cbc) - c2 crc: +-1
       against B9 where the two g chains round apart
  V3   the split with the fixed-point luma: the production split, B8

It first counts, on a (3, 256, 512) image, how V1's and V12's merges differ
from B9's and V3's planes from B8's (the reference asserts some of these;
here they are reported), then times each pair at size x size RGB noise
(seed 42, default 8192^2) with ``utils.timing.device_time_ms`` (the median
of ``REPS`` calls after a warm-up), the shipped pair again last to bracket
drift.  The reference's sweep over its Pallas tile geometry is left out:
``band_rows``/``tile_cols`` are inert in the port, as ``K_PAIR`` is.  Every
line carries the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import variants as V
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.studies import device_label, differ
from tpudct_torch.utils.timing import device_time_ms

SIZE = 8192
#: The reference's chain lengths for its slope timer; inert here.
K_PAIR = (8, 72)
#: Timed calls per measurement (each after one warm-up call).
REPS = 5


def build_variants() -> dict:
    """``make_merge``, ``make_split`` and the three kernel functions, under
    the reference's keys."""
    return {
        "make_merge": V.make_merge, "make_split": V.make_split,
        "_k_merge_v1": V._k_merge_v1, "_k_merge_v12": V._k_merge_v12, "_k_split_v3": V._k_split_v3,
    }


def pair(split_fn, merge_fn):
    """split then merge: (3, H, W) u8 -> (3, H, W) u8."""
    def op(x):
        return merge_fn(*split_fn(x))
    return op


def time_pairs(variants: dict, rgb: torch.Tensor, size: int, label: str, out: dict) -> None:
    """Time each pair of ``variants`` (key -> (text, op)), then the shipped
    pair again; one line and one "<key>_ms" each ("shipped_repeat_ms")."""
    shipped_text, shipped_op = variants["shipped"]
    for key, (text, op) in [*variants.items(), ("shipped_repeat", (f"{shipped_text} (repeat)", shipped_op))]:
        ms = device_time_ms(op, rgb, reps=REPS)
        out[f"{key}_ms"] = ms
        print(f"{size}^2 {text:<32}: pair {ms:8.4f} ms [{label}]", flush=True)


def main(size: int = SIZE, device=None) -> dict:
    """Print one line per check and per measurement; return the agreement
    counts ("v1_differ"/"v1_max", "v12_differ"/"v12_max" against the shipped merge,
    "v3_<plane>_differ"/"v3_<plane>_max" against the shipped split,
    "entries" of the merge, the luma and a chroma plane) and the pair times
    "<pair>_ms"."""
    dev = default_device(device)
    label = device_label(dev)
    v = build_variants()
    rng = np.random.default_rng(42)
    rgb = torch.as_tensor(rng.integers(0, 256, (3, size, size), dtype=np.uint8), device=dev)
    small = torch.as_tensor(rng.integers(0, 256, (3, 256, 512), dtype=np.uint8), device=dev)
    merge_v1, merge_v12 = v["make_merge"](v["_k_merge_v1"]), v["make_merge"](v["_k_merge_v12"])
    split_v3 = v["make_split"](v["_k_split_v3"])

    planes = ck.color_split_420_u8(small)
    base = ck.color_merge_420_u8(*planes)
    out = {"size": size, "card": label,
           "entries": {"merge": base.numel(), "y": planes[0].numel(), "chroma": planes[1].numel()}}
    out["v1_differ"], out["v1_max"] = differ(merge_v1(*planes), base)
    out["v12_differ"], out["v12_max"] = differ(merge_v12(*planes), base)
    for k, a, b in zip(("y", "cb", "cr"), split_v3(small), planes):
        out[f"v3_{k}_differ"], out[f"v3_{k}_max"] = differ(a, b)
    n = out["entries"]["merge"]
    print(f"(3, 256, 512) against the shipped pair: V1 merge {out['v1_differ']} of {n} outputs differ; V12 "
          f"merge {out['v12_differ']} (max {out['v12_max']}); V3 split y {out['v3_y_differ']}, cb "
          f"{out['v3_cb_differ']}, cr {out['v3_cr_differ']} entries [{label}]", flush=True)

    split_s, merge_s = ck.color_split_420_u8, ck.color_merge_420_u8
    variants = {
        "shipped": ("S  shipped", pair(split_s, merge_s)),
        "v1": ("V1 merge compare-form round", pair(split_s, merge_v1)),
        "v12": ("V12 + direct-form inverse", pair(split_s, merge_v12)),
        "v3": ("V3 split fixed-point luma", pair(split_v3, merge_s)),
        "v123": ("V123 all", pair(split_v3, merge_v12)),
    }
    time_pairs(variants, rgb, size, label, out)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else SIZE)
