"""Bulk dispatch A/B on the card: per-image launches against the stacked
taller-image path (``models.dispatch`` ``encode/decode_gray_batch_auto``);
the port of ``benchmarks/bulk_ab.py``.

    python -m tpudct_torch.studies.bulk_ab [n] [side]

The metric is the host wall of the whole job (what a bulk CLI user waits
for), not device time: the stacked path exists to remove the per-image
launch and transfer overhead.  ``B`` = 64 frames of ``S``² u8 noise (seed
42).  Both arms materialize coefficients on the host (``batch``
entropy-codes them there, so the transfer is part of the job either way);
the per-image decode takes the host coefficients as ``batch``'s decode
does.  One warm-up call of each shape first, then the best of 3 walls per
arm (host clock around work that ends on the host).  It ends with the
reference's equality spot-check on the card: the stacked encode of the
first four frames against ``encode_gray_auto`` of each.  Every line carries
the card's name and power limit.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from tpudct_torch import CodecConfig, get_pipeline
from tpudct_torch.models.dispatch import (
    decode_gray_auto,
    decode_gray_batch_auto,
    default_device,
    encode_gray_auto,
    encode_gray_batch_auto,
)
from tpudct_torch.studies import device_label

B, S = 64, 512
#: Walls per arm; the best is kept.
REPS = 3
#: Frames of the closing equality spot-check.
CHECKED = 4


def wall(fn, reps: int = REPS) -> float:
    """Best host seconds of fn() over `reps` calls."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main(n: int = B, side: int = S, device=None) -> dict:
    """Print the encode and decode A/B and the spot-check; return {"n",
    "side", "card", "encode_per_image_s", "encode_stacked_s",
    "decode_per_image_s", "decode_stacked_s", "coeffs": the stacked
    encode's maps, "decoded": the stacked decode's planes (both of the
    warm-up)}."""
    dev = default_device(device)
    label = device_label(dev)
    rng = np.random.default_rng(42)
    imgs = [rng.integers(0, 256, (side, side), dtype=np.uint8) for _ in range(n)]
    p, cfg = get_pipeline("hp"), CodecConfig()

    # warm-up: both shapes (one frame, the stacked chunk)
    encode_gray_auto(p, imgs[0], cfg, device=dev)
    enc = encode_gray_batch_auto(p, imgs, cfg, device=dev)
    items = [(c, cfg, hw) for c, hw in enc]
    decode_gray_auto(p, *items[0], device=dev)
    dec = decode_gray_batch_auto(p, items, device=dev)

    t_per = wall(lambda: [encode_gray_auto(p, im, cfg, device=dev)[0].cpu().numpy() for im in imgs])
    t_stk = wall(lambda: encode_gray_batch_auto(p, imgs, cfg, device=dev))
    print(f"encode  {n}x{side}^2: per-image {t_per:.4f} s ({n / t_per:.0f} img/s)  stacked {t_stk:.4f} s "
          f"({n / t_stk:.0f} img/s)  x{t_per / t_stk:.2f} [{label}]", flush=True)
    d_per = wall(lambda: [decode_gray_auto(p, *it, device=dev) for it in items])
    d_stk = wall(lambda: decode_gray_batch_auto(p, items, device=dev))
    print(f"decode  {n}x{side}^2: per-image {d_per:.4f} s ({n / d_per:.0f} img/s)  stacked {d_stk:.4f} s "
          f"({n / d_stk:.0f} img/s)  x{d_per / d_stk:.2f} [{label}]", flush=True)

    # equality spot-check on the card
    got = encode_gray_batch_auto(p, imgs[:CHECKED], cfg, device=dev)
    for im, (c, _hw) in zip(imgs[:CHECKED], got):
        c1 = encode_gray_auto(p, im, cfg, device=dev)[0].cpu().numpy()
        if not np.array_equal(c1, c):
            raise AssertionError("the stacked encode differs from the per-image encode")
    print(f"stacked == per-image on the first {CHECKED} frames: OK [{label}]", flush=True)
    return {"n": n, "side": side, "card": label, "encode_per_image_s": t_per, "encode_stacked_s": t_stk,
            "decode_per_image_s": d_per, "decode_stacked_s": d_stk, "coeffs": [c for c, _ in enc],
            "decoded": dec}


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
