"""Judge gray roundtrip answers: coefficients and reconstruction.

Each answer is ``{"coeffs": (H8, W8) quantized map, "recon": (H, W) uint8}``
(tensors on any device, or numpy arrays) for one input of the pool.

- The coefficients against the reference's encode of the input:
  ``coef_diff_share`` (the share of coefficients that differ) and
  ``coef_max_diff``.  The system runs float32; at a value within float32's
  rounding of a quantizer edge it may round the other way, by one.
- The reconstruction against the reference's decode of the system's own
  coefficients (the encode stage is judged by itself above, so a tie that
  flipped there is not counted twice): ``recon_diff_share`` and
  ``recon_max_diff``.  At a value within rounding of an integer the
  truncation may differ by one.
"""

from __future__ import annotations

import torch

from perfbench.compare.tally import Tally, on
from perfbench.reference import codec as ref


def reference_answer(x_u8: torch.Tensor, codec: dict, dtype) -> dict:
    """The reference put in the system's place, computed in ``dtype``."""
    h, w = x_u8.shape
    c = ref.encode_plane(x_u8, codec["q_table"], codec["q_scale"], dtype)
    return {"coeffs": c, "recon": ref.decode_plane(c, codec["q_table"], codec["q_scale"], dtype)[:h, :w]}


def numbers(answers, source, codec: dict, device) -> dict:
    """``answers``: [(slot, answer)]; ``source(slot)``: the (H, W) uint8
    input on ``device``.  Returns the four numbers over all answers."""
    ref.check_codec(codec)
    table, qs = codec["q_table"], codec["q_scale"]
    coef, recon = Tally(), Tally()
    for slot, a in answers:
        x = source(slot)
        h, w = x.shape
        c = on(a["coeffs"], device)
        want = ref.encode_plane(x, table, qs)
        coef.add(c, want)
        if c.shape != want.shape:
            recon.miss(h * w)
            continue
        del want
        recon.add(on(a["recon"], device), ref.decode_plane(c, table, qs)[:h, :w])
    return {
        "coef_diff_share": coef.share(),
        "coef_max_diff": coef.max,
        "recon_diff_share": recon.share(),
        "recon_max_diff": recon.max,
    }
