"""Judge 4:2:0 colour roundtrip answers: coefficient planes and RGB.

Each answer is ``{"planes": {"y", "cb", "cr"} quantized maps at their
8-aligned shapes, "rgb": (H, W, 3) uint8}`` (tensors on any device, or
numpy arrays) for one (H, W, 3) input of the pool.

- The planes against the reference's encode of the input (T.871 split,
  4:2:0 pooling, luma and chroma tables): ``coef_diff_share`` over the
  three planes and ``coef_max_diff``.  Besides float32's rounding at
  quantizer edges, the system's luma is libjpeg's 16-bit fixed point,
  which rounds a value within 0.003 of a half the other way.
- The RGB against the reference's decode and merge of the system's own
  planes (the encode is judged above): ``recon_diff_share`` and
  ``recon_max_diff``.
"""

from __future__ import annotations

import torch

from perfbench.compare.tally import Tally, on
from perfbench.reference import codec as ref

PLANES = ("y", "cb", "cr")


def reference_answer(rgb_u8: torch.Tensor, codec: dict, dtype) -> dict:
    """The reference put in the system's place, computed in ``dtype``."""
    qs = codec["q_scale"]
    planes = ref.encode_color_420(rgb_u8, qs, dtype)
    return {"planes": planes, "rgb": ref.decode_color_420(planes, rgb_u8.shape[:2], qs, dtype)}


def numbers(answers, source, codec: dict, device) -> dict:
    """``answers``: [(slot, answer)]; ``source(slot)``: the (H, W, 3) uint8
    input on ``device``.  Returns the four numbers over all answers."""
    ref.check_codec(codec)
    qs = codec["q_scale"]
    coef, recon = Tally(), Tally()
    for slot, a in answers:
        x = source(slot)
        h, w = x.shape[:2]
        want = ref.encode_color_420(x, qs)
        planes = {k: on(a["planes"][k], device) for k in PLANES}
        for k in PLANES:
            coef.add(planes[k], want[k])
        if any(planes[k].shape != want[k].shape for k in PLANES):
            recon.miss(h * w * 3)
            continue
        del want
        recon.add(on(a["rgb"], device), ref.decode_color_420(planes, (h, w), qs))
    return {
        "coef_diff_share": coef.share(),
        "coef_max_diff": coef.max,
        "recon_diff_share": recon.share(),
        "recon_max_diff": recon.max,
    }
