"""Where the u8 codec pass's time goes: the port of ``benchmarks/u8_perf.py``.

    python -m tpudct_torch.studies.u8_perf [size]

Times, at size x size (default 8192^2) on the first CUDA card:

  u8_copy (B17)          the u8 map copied onto itself: the HBM floor of a
                         u8 pass, 2 B/px
  u8_copy2 (B18)         the same plus an int8 write: hp_roundtrip_u8's
                         3 B/px with no arithmetic, the floor B1's time is
                         read against
  hp_encode_u8 (B2)      the forward alone
  hp_decode_u8 (B3)      the inverse alone
  hp_roundtrip_u8 (B1)   the headline pass

each with ``utils.timing.device_time_ms`` (CUDA events, L2 flushed, the
median of ``REPS`` calls after a warm-up) and the bytes it moves per second.  The
reference's sweep over its Pallas tile geometry (``band_rows`` x
``tile_cols``) is left out: those knobs are inert in the port.  Every line
carries the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpudct_torch.benchmark import synthetic_image
from tpudct_torch.kernels import hp, study
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.studies import device_label
from tpudct_torch.utils.timing import device_time_ms

#: Timed calls per measurement (each after one warm-up call).
REPS = 5


def main(size: int = 8192, device=None) -> dict:
    """Print one line per measurement; return {"size", "card", "<name>_ms"
    for each kernel, "roundtrip_over_floor": B1's time over B18's}."""
    dev = default_device(device)
    label = device_label(dev)
    x = torch.as_tensor(synthetic_image(size).astype(np.uint8), device=dev)
    c8 = hp.hp_encode_u8(x)
    gb = size * size / 1e9
    rows = (
        ("u8_copy", "u8 aliased copy (B17)", 2, study.u8_copy, x),
        ("u8_copy2", "u8 copy + i8 write (B18)", 3, study.u8_copy2, x),
        ("hp_encode_u8", "hp_encode_u8 (B2)", 2, hp.hp_encode_u8, x),
        ("hp_decode_u8", "hp_decode_u8 butterfly (B3)", 2, hp.hp_decode_u8, c8),
        ("hp_roundtrip_u8", "hp_roundtrip_u8 (B1), the headline", 3, hp.hp_roundtrip_u8, x),
    )
    out = {"size": size, "card": label}
    for key, text, bpp, fn, arg in rows:
        ms = device_time_ms(fn, arg, reps=REPS)
        out[f"{key}_ms"] = ms
        print(f"{size}^2 {text:<36}: {ms:8.4f} ms ({bpp * gb / ms * 1e3:7.1f} GB/s) [{label}]",
              flush=True)
    out["roundtrip_over_floor"] = out["hp_roundtrip_u8_ms"] / out["u8_copy2_ms"]
    print(f"{size}^2 hp_roundtrip_u8 over its byte floor (B18): {out['roundtrip_over_floor']:.3f}x "
          f"[{label}]", flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8192)
