"""The u8 encode variants on the card: the port of ``benchmarks/enc_variants.py``.

    python -m tpudct_torch.studies.enc_variants [which] [size]

The TPU study took its u8 encode apart (``kernels.variants._mk`` runs each
kernel; haweel, luma table, q_scale 1).  Two kernels compute other values
and have kernels of their own (csrc/study.cu): E2 (B30) keeps the lane
half (12 (X - 128) Ts^T, scaled, rounded, saturated to int8), E3 (B31) the
sublane half (Ts (X - 128)).  The rest compute B2's values, and on the H100
each launches B2's kernel under its own counter: E4 (B32, the xor level
shift), E6 (B33, the nibble split), E7 (B34, the truncless round), E8
(B35, E6 + E7), E9 (B36, one K = 256 lane dot).  ``which`` (default "a"):

  a  E2 timed, tiles (256, 2048)
  b  E3 timed; E4 against hp_encode_u8 (B2) on x[:512, :2048] (0 differing
     entries expected; counted), then timed
  d  E7, E6, E8 each against B2 on x[:512, :4096] and timed, tiles
     (128, 4096); then B2 timed in the same run
  e  E9 the same; then B2

on the u8 ``synthetic_image(size)`` (default 8192^2), each with
``utils.timing.device_time_ms`` (CUDA events, L2 flushed, the median of
``REPS`` calls after a warm-up) on the int8 call: the reference times
``f(v).astype(uint8)``, a cast that exists only to feed its TPU timing
chain.  A tile larger than the image is cut to the image (``size`` below
the tile); a size the tiles do not divide raises, as ``_mk`` does.  Mode
"c", the reference's tile-geometry sweep, is left out: the tiles are inert
here.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpudct_torch.benchmark import synthetic_image
from tpudct_torch.kernels import hp
from tpudct_torch.kernels import variants as V
from tpudct_torch.kernels.variants import _mk
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.studies import device_label, differ
from tpudct_torch.utils.timing import device_time_ms

__all__ = ["_mk", "main"]

#: Timed calls per measurement (each after one warm-up call).
REPS = 5
MODES = ("a", "b", "d", "e")


def _time(out: dict, key: str, text: str, fn, x, size: int, label: str) -> None:
    out[f"{key}_ms"] = ms = device_time_ms(fn, x, reps=REPS)
    print(f"{size}^2 {text:<30}: {ms:7.4f} ms [{label}]", flush=True)


def _check(out: dict, key: str, text: str, f, small: torch.Tensor) -> None:
    out[f"{key}_differ"] = n = differ(f(small), hp.hp_encode_u8(small))[0]
    print(f"{text} against hp_encode_u8 on {tuple(small.shape)}: {n} entries differ", flush=True)


def main(which: str = "a", size: int = 8192, device=None) -> dict:
    """Print one line per check and measurement; return {"size", "card",
    "which", "<kernel>_differ" per check, "<kernel>_ms" per timing}."""
    if which not in MODES:
        raise ValueError(f"which must be one of {MODES} (the tile sweep 'c' is left out), got {which!r}")
    dev = default_device(device)
    label = device_label(dev)
    x = torch.as_tensor(synthetic_image(size).astype(np.uint8), device=dev)
    out = {"size": size, "card": label, "which": which}
    if which == "a":
        _time(out, "enc_nosub", "E2 no-sublane (lane only)", _mk(V._k_enc_nosub, min(256, size), min(2048, size)),
              x, size, label)
    elif which == "b":
        tiles = min(256, size), min(2048, size)
        _time(out, "enc_nolane", "E3 sublane only", _mk(V._k_enc_nolane, *tiles), x, size, label)
        f = _mk(V._k_enc_xor, *tiles)
        _check(out, "enc_xor", "E4 xor-shift", f, x[:512, :2048].contiguous())
        _time(out, "enc_xor", "E4 encode xor-shift", f, x, size, label)
    else:
        br, tc = min(128, size), min(4096, size)
        small = x[:512, :4096].contiguous()
        kernels = (("E7 truncless round", V._k_enc_truncless, False), ("E6 nibble-split", V._k_enc_nibble, True),
                   ("E8 nibble+truncless", V._k_enc_nibble_truncless, True)) if which == "d" else (
                  ("E9 K=256 single lane dot", V._k_enc_k256, False),)
        for text, kern, wb in kernels:
            f = _mk(kern, br, tc, with_bias=wb)
            _check(out, kern.name, text, f, small)
            _time(out, kern.name, text, f, x, size, label)
        _time(out, "hp_encode_u8", "E4 shipped (same session)", hp.hp_encode_u8, x, size, label)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "a", int(sys.argv[2]) if len(sys.argv) > 2 else 8192)
