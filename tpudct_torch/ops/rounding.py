"""Rounding with CUDA ``round()`` semantics (half away from zero).

``torch.round`` rounds half to even, which diverges on every exact .5
quotient, so the codec has its own primitive.
"""

from __future__ import annotations

import torch


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest integer, ties away from zero.

    Compare form, NOT floor(|x| + 0.5): that rounds f32 values just below
    .5 up whenever |x| + 0.5 lands on the next representable float
    (0.49999997 -> 1.0 where CUDA round() gives 0).
    """
    a = x.abs()
    f = a.floor()
    return torch.sign(x) * (f + (a - f >= 0.5).to(a.dtype))
