"""Blockwise 2-D transform and level shift (plain torch).

  forward:  Y_b = T @ (X_b - 128) @ T.T
  inverse:  X_b = T.T @ Y_b @ T + 128
  output:   C-truncate, clamp to [0, 255], cast to uint8

One contraction over the in-block axes of the (H/8, 8, W/8, 8) view,
carried out in float64 and rounded once to the input's dtype
(:func:`einsum64`).  An f32 einsum is a matmul whose precision follows
process-wide settings (TF32 on CUDA; bf16 on the CPU under
``torch.set_float32_matmul_precision("medium")``), which would cost the
coefficients about three decimal digits; a float64 one follows none.
"""

from __future__ import annotations

import torch

from tpudct_torch.constants import LEVEL_SHIFT, get_transform
from tpudct_torch.ops.blocks import as_block_grid, from_block_grid


def level_shift(x: torch.Tensor) -> torch.Tensor:
    """x - 128.  Integer inputs are coerced to f32 first: a uint8 pixel 5
    would otherwise wrap to 133."""
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    return x - LEVEL_SHIFT


def level_unshift(x: torch.Tensor) -> torch.Tensor:
    """x + 128."""
    return x + LEVEL_SHIFT


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """C truncation, clamp to [0, 255], cast."""
    return x.trunc().clamp(0.0, 255.0).to(torch.uint8)


def einsum64(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` carried out in float64 and rounded once to the
    first operand's dtype, whatever the process's matmul precision."""
    out = torch.einsum(equation, *(o.to(torch.float64) for o in operands))
    return out.to(operands[0].dtype)


def _t_for(t, transform: str, like: torch.Tensor) -> torch.Tensor:
    t = get_transform(transform).t if t is None else t
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def dct2_blocks(x: torch.Tensor, t=None, transform: str = "haweel") -> torch.Tensor:
    """Forward blockwise transform on an (H, W) image (no shift, no quant).

    Y[bi, i, bj, l] = sum_{j,k} T[i,j] X[bi, j, bj, k] T[l,k]; `transform`
    selects a registry entry, an explicit `t` array overrides it.
    """
    t = _t_for(t, transform, x)
    return from_block_grid(einsum64("ij,ajbk,lk->aibl", t, as_block_grid(x), t))


def idct2_blocks(y: torch.Tensor, t=None, transform: str = "haweel") -> torch.Tensor:
    """Inverse blockwise transform: X_b = T.T @ Y_b @ T."""
    t = _t_for(t, transform, y)
    return from_block_grid(einsum64("ji,ajbk,kl->aibl", t, as_block_grid(y), t))
