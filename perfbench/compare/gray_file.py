"""Judge gray ``.tdc`` roundtrip answers: the coefficients read back from
the bytes and the reconstruction, and the container's losslessness.

Each answer is ``{"coeffs": the quantized map that went into the bytes,
"coeffs_back": the map read back, "header": {"orig_shape", "q_scale",
"transform", "q_table"} read back, "recon": (H, W) uint8}`` (arrays or
tensors) for one input of the pool.

- ``coef_diff_share``, ``coef_max_diff``, ``recon_diff_share`` and
  ``recon_max_diff``: ``gray_roundtrip``'s four numbers for the map read
  back and the reconstruction.
- ``stream_diff_count``: the coefficients where the map read back differs
  from the map that went in, plus one for each header field that read
  back other than it was written (the original shape, ``q_scale`` as the
  header's float32 holds it, the transform, the table).  The entropy stage
  is lossless, the deployment's guarantee: its limit is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.compare import gray_roundtrip
from perfbench.compare.tally import on


def header(shape, codec: dict) -> dict:
    """The header a stream of an (H, W) image under ``codec`` holds."""
    return {"orig_shape": tuple(shape), "q_scale": float(np.float32(codec["q_scale"])),
            "transform": codec["transform"], "q_table": codec["q_table"]}


def reference_answer(x_u8: torch.Tensor, codec: dict, dtype) -> dict:
    """The reference put in the system's place, computed in ``dtype``; its
    container is lossless."""
    a = gray_roundtrip.reference_answer(x_u8, codec, dtype)
    return {"coeffs": a["coeffs"], "coeffs_back": a["coeffs"], "header": header(x_u8.shape, codec),
            "recon": a["recon"]}


def numbers(answers, source, codec: dict, device) -> dict:
    """``answers``: [(slot, answer)]; ``source(slot)``: the (H, W) uint8
    input on ``device``.  Returns the five numbers over all answers."""
    out = gray_roundtrip.numbers([(slot, {"coeffs": a["coeffs_back"], "recon": a["recon"]})
                                  for slot, a in answers], source, codec, device)
    diff = 0
    for slot, a in answers:
        sent, back = on(a["coeffs"], device), on(a["coeffs_back"], device)
        if sent.shape != back.shape:
            diff += max(sent.numel(), back.numel())
        else:
            diff += int((sent.to(torch.float64) != back.to(torch.float64)).sum())
        want = header(source(slot).shape, codec)
        diff += sum(a["header"].get(k) != v for k, v in want.items())
    out["stream_diff_count"] = float(diff)
    return out
