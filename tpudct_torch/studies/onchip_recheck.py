"""Three checks on the card, one JSON line each: the port of
``benchmarks/onchip_recheck.py``.

    python -m tpudct_torch.studies.onchip_recheck

1. ``selftest.correctness_gate`` of the hp pipeline at 512² (the u8 pass
   against the float64 golden model, its standalone encode and decode
   against the fused roundtrip).
2. ``parallel.ring.ring_decode_gather`` on a one-rank band mesh against
   ``hp_decode_u8``: the replicated coefficients equal the input and the
   reconstruction equals ``hp_decode_u8`` of it (B14 places the band, B15
   decodes it), at 512² (uniform noise, seed 3, coded by ``hp_encode_u8``)
   and at 8192² (seed 4).  The reference expects its TPU ring to refuse
   the 8192² band (the band outgrows the TPU core's local memory); the
   port's ring has no such limit and decodes it, and the check holds the
   result to ``hp_decode_u8`` as at 512².
3. The f32 color roundtrip (``models.color.roundtrip_color``: the split,
   the f32 codec on each plane, two ``upsample_420``) at ``COLOR_SIDE``²
   (8192²) RGB noise (seed 5), and the ``downsample_420``/``upsample_420``
   pair on such a plane (seed 6), each timed with
   ``utils.timing.device_time_ms``.

Any failed check exits non-zero.  Every line carries the card's name and power
limit.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from tpudct_torch import CodecConfig, get_pipeline
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.studies import device_label

#: Timed calls per measurement (each after one warm-up call).
REPS = 3
RING_SIDES = ((512, 3), (8192, 4))  # (side, seed)
COLOR_SIDE = 8192


def _ring_check(side: int, seed: int, dev: torch.device) -> tuple:
    """(coefficients equal, reconstruction equal) of the one-rank decode
    ring on side² coefficients."""
    from tpudct_torch.kernels.hp import hp_decode_u8, hp_encode_u8
    from tpudct_torch.parallel.mesh import band_mesh
    from tpudct_torch.parallel.ring import ring_decode_gather
    from tpudct_torch.parallel.sharding import shard_image

    img = torch.as_tensor(np.random.default_rng(seed).integers(0, 256, (side, side), dtype=np.uint8), device=dev)
    coeffs = hp_encode_u8(img)
    mesh = band_mesh(devices=[dev])
    crep, rec = ring_decode_gather(shard_image(coeffs, mesh), mesh)
    ref = hp_decode_u8(coeffs)
    return bool(torch.equal(crep.shards[0], coeffs)), bool(torch.equal(rec.shards[0], ref))


def main(device=None) -> int:
    """Run the three checks, printing one JSON line each; return 0, or 1
    where a check's flag is False (the gate raises where it fails)."""
    from tpudct_torch.models.color import roundtrip_color
    from tpudct_torch.selftest import correctness_gate
    from tpudct_torch.utils.color import downsample_420, upsample_420
    from tpudct_torch.utils.timing import device_time_ms

    dev = default_device(device)
    label = device_label(dev)
    checks = []

    def record(name, **kw):
        row = {"check": name, **kw, "card": label}
        checks.append(row)
        print(json.dumps(row), flush=True)

    p, cfg = get_pipeline("hp"), CodecConfig()
    # ---- 1. the correctness gate on the kernels ------------------------------
    record("correctness_gate", **correctness_gate(p, cfg, size=512, device=dev))

    # ---- 2. the decode ring on a one-rank mesh --------------------------------
    for side, seed in RING_SIDES:
        ok_c, ok_r = _ring_check(side, seed, dev)
        record(f"ring_decode_n1_{side}", coeffs_equal=ok_c, recon_equal=ok_r)

    # ---- 3. the f32 color path at 8192² ---------------------------------------
    n = COLOR_SIDE
    rgb = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (n, n, 3)).astype(np.float32), device=dev)
    ms = device_time_ms(lambda v: roundtrip_color(p, v, cfg)[2], rgb, reps=REPS)
    record(f"f32_color_roundtrip_{n}", ms=ms, note="encode and decode; holds two upsample_420")
    plane = torch.as_tensor(np.random.default_rng(6).integers(0, 256, (n, n)).astype(np.float32), device=dev)
    ms_pair = device_time_ms(lambda v: upsample_420(downsample_420(v), n, n), plane, reps=REPS)
    record(f"resample_420_pair_{n}", ms=ms_pair, note="down and up pair on one plane")
    return int(any(v is False for row in checks for v in row.values()))


if __name__ == "__main__":
    sys.exit(main())
