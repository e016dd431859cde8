"""Color split/merge variants on the card, round 2: the port of
``benchmarks/color_variants2.py``.

    python -m tpudct_torch.studies.color_variants2 [size]

Round 2 of the color variant study (``studies/color_variants.py``) targets
the merge's rounding (``kernels.variants``):

  V4  the merge with the chroma shifted at full resolution and the add-form
      round trunc(clip(z) + 0.5): B9's values (the shift gives the same
      exact integers at either resolution, and B9 rounds so)
  V5  the fixed-point-luma split with its chroma rounded by the add form too:
      +-1 against B8 where the f32 add of 0.5 crosses an integer
  V6  V4 with the shift at half resolution: the production merge, B9

The reference defines these kernels inside its ``main()``; here they sit
at module level in ``kernels.variants``.  It first counts, on a
(3, 256, 512) image, how V4's and V6's merges differ from B9's and V5's
planes from B8's, then times the pairs at size x size RGB noise (seed 42,
default 8192^2), the shipped pair again last, as ``color_variants`` does.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import variants as V
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.studies import device_label, differ
from tpudct_torch.studies.color_variants import SIZE, pair, time_pairs


def main(size: int = SIZE, device=None) -> dict:
    """Print one line per check and per measurement; return the agreement
    counts ("v4_differ"/"v4_max", "v6_differ"/"v6_max" against the shipped
    merge, "v5_<plane>_differ"/"v5_<plane>_max" against the shipped split,
    "entries") and the pair times "<pair>_ms"."""
    dev = default_device(device)
    label = device_label(dev)
    rng = np.random.default_rng(42)
    rgb = torch.as_tensor(rng.integers(0, 256, (3, size, size), dtype=np.uint8), device=dev)
    small = torch.as_tensor(rng.integers(0, 256, (3, 256, 512), dtype=np.uint8), device=dev)
    merge_v4, merge_v6 = V.make_merge(V._k_merge_v4), V.make_merge(V._k_merge_v6)
    split_v5 = V.make_split(V._k_split_v5)

    planes = ck.color_split_420_u8(small)
    base = ck.color_merge_420_u8(*planes)
    out = {"size": size, "card": label,
           "entries": {"merge": base.numel(), "y": planes[0].numel(), "chroma": planes[1].numel()}}
    for key, merge in (("v4", merge_v4), ("v6", merge_v6)):
        out[f"{key}_differ"], out[f"{key}_max"] = differ(merge(*planes), base)
    for k, a, b in zip(("y", "cb", "cr"), split_v5(small), planes):
        out[f"v5_{k}_differ"], out[f"v5_{k}_max"] = differ(a, b)
    print(f"(3, 256, 512) against the shipped pair: V4 merge {out['v4_differ']}, V6 merge {out['v6_differ']} "
          f"of {base.numel()} outputs differ; V5 split y {out['v5_y_differ']}, cb {out['v5_cb_differ']} "
          f"(max {out['v5_cb_max']}), cr {out['v5_cr_differ']} (max {out['v5_cr_max']}) of "
          f"{out['entries']['chroma']} entries [{label}]", flush=True)

    split_s, merge_s = ck.color_split_420_u8, ck.color_merge_420_u8
    variants = {
        "shipped": ("S  shipped", pair(split_s, merge_s)),
        "v4": ("V4 trunc-round merge", pair(split_s, merge_v4)),
        "v5": ("V5 fxp-luma split + V4 merge", pair(split_v5, merge_v4)),
        "v6": ("V6 V5 + half-res shift merge", pair(split_v5, merge_v6)),
    }
    time_pairs(variants, rgb, size, label, out)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else SIZE)
