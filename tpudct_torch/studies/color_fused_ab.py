"""Does fusing the 4:2:0 color codec into one pass each way pay on the card?
The port of ``benchmarks/color_fused_ab.py``.

    python -m tpudct_torch.studies.color_fused_ab [size]

The composed u8 color pass (``models.color.encode_color_u8`` /
``decode_color_u8``: the split kernel, two ``hp_encode_u8``, two
``hp_decode_u8``, the merge kernel) keeps the YCbCr planes in HBM between
its kernels: 15 B/px for a roundtrip.  The fused pair
(``kernels.study.color_encode_420_u8`` / ``color_decode_420_u8``, B19/B20)
moves 9.  The TPU measured the fused pass slower (its vector unit was the
limit); this study times both on the card at size x size RGB noise (seed 5,
default 8192^2): the roundtrip, the encode and the decode, each with
``utils.timing.device_time_ms`` (the median of ``REPS`` calls after a
warm-up).

It also counts how the two agree, and does not assert it: on the same
coefficients the fused decode should equal the composed decode everywhere;
the fused encode's Cb and Cr equal the composed path's, its Y differs by +-1
where the study's f32 luma rounds otherwise than the production split's
fixed-point luma.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpudct_torch import CodecConfig, get_pipeline
from tpudct_torch.kernels import study
from tpudct_torch.models.color import decode_color_u8, encode_color_u8
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.studies import device_label, differ
from tpudct_torch.utils.timing import device_time_ms

PLANES = ("y", "cb", "cr")
#: Timed calls per measurement (each after one warm-up call).
REPS = 5


def main(size: int = 8192, device=None) -> dict:
    """Print one line per measurement; return the times ("<side>_<stage>_ms"
    for side in composed, fused and stage in roundtrip, encode, decode) and
    the agreement counts ("<plane>_differ", "<plane>_max_diff" of the fused
    encode against the composed one, "decode_differ" of the fused decode
    against the composed one on the composed coefficients, "entries")."""
    dev = default_device(device)
    label = device_label(dev)
    p, cfg = get_pipeline("hp"), CodecConfig()
    rgb = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (3, size, size), dtype=np.uint8),
                          device=dev)

    def composed_encode(x):
        planes, _meta = encode_color_u8(p, x, cfg)
        return tuple(planes[k] for k in PLANES)

    meta = {"orig_shape": (size, size), "chroma_shape": (size // 2, size // 2), "subsample": "420"}

    def composed_decode(planes):
        return decode_color_u8(p, dict(zip(PLANES, planes)), meta, cfg).movedim(-1, 0)

    def fused_decode(planes):
        return study.color_decode_420_u8(*planes)

    fused = study.color_encode_420_u8(rgb)
    composed = composed_encode(rgb)
    out = {"size": size, "card": label, "entries": {k: c.numel() for k, c in zip(PLANES, composed)}}
    for k, f, c in zip(PLANES, fused, composed):
        out[f"{k}_differ"], out[f"{k}_max_diff"] = differ(f, c)
    out["decode_differ"] = differ(fused_decode(composed), composed_decode(composed))[0]
    print(f"{size}^2 fused vs composed: coefficients differing y {out['y_differ']} of "
          f"{out['entries']['y']} (max {out['y_max_diff']}), cb {out['cb_differ']}, cr {out['cr_differ']} "
          f"of {out['entries']['cb']}; decode on the same coefficients: {out['decode_differ']} of "
          f"{3 * size * size} outputs differ", flush=True)
    stages = {
        "composed_roundtrip": (lambda v: composed_decode(composed_encode(v)), rgb),
        "fused_roundtrip": (lambda v: fused_decode(study.color_encode_420_u8(v)), rgb),
        "composed_encode": (composed_encode, rgb),
        "fused_encode": (study.color_encode_420_u8, rgb),
        "composed_decode": (lambda _: composed_decode(composed), composed[0]),
        "fused_decode": (lambda _: fused_decode(composed), composed[0]),
    }
    for name, (fn, arg) in stages.items():
        ms = device_time_ms(fn, arg, reps=REPS)
        out[f"{name}_ms"] = ms
        print(f"{size}^2 {name.replace('_', ' '):<20}: {ms:8.4f} ms [{label}]", flush=True)
    print(f"{size}^2 fused / composed roundtrip: {out['fused_roundtrip_ms'] / out['composed_roundtrip_ms']:.3f} "
          f"[{label}]", flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8192)
