"""Blockwise 2-D transform and level shift (plain torch).

  forward:  Y_b = T @ (X_b - 128) @ T.T
  inverse:  X_b = T.T @ Y_b @ T + 128
  output:   C-truncate, clamp to [0, 255], cast to uint8

On f32 inputs the two contractions follow the reference's f32 value chain,
so the port's coefficients and reconstructions equal its bit for bit
(tests/test_torch_ops.py).  The reference (``tpudct/ops/transform.py``)
takes one of two forms, and XLA on the CPU evaluates each in a fixed order:

  128-tiled (H % 128 == 0, W % 128 == 0, the registry's T): the lane
      direction first (X times blockdiag(T)^T, a K = 128 product), then the
      rows (blockdiag(T) per 128-row band).  Each output is one f32
      fused multiply-add chain over the block's 8 terms in index order
      (the other 120 terms of the K = 128 row are zeros, which leave an FMA
      chain unchanged).  The inverse swaps the operands (blockdiag(T)^T on
      the rows, blockdiag(T) on the lanes).
  otherwise (or an explicit ``t``): one three-operand einsum, which XLA
      lowers to two K = 8 products, the rows first, then the lanes.  Each
      output of a K = 8 product is four FMA chains over the terms k = s and
      s + 4 (s = 0..3), added (p0 + p1) + (p2 + p3).

Every step is elementwise tensor arithmetic (:func:`fma32`), not a matmul,
so no process-wide setting (TF32 on CUDA; bf16 on the CPU under
``torch.set_float32_matmul_precision("medium")``) reaches it.  Other float
dtypes contract in float64 and round once (:func:`einsum64`), as the M/8
scaled decode and the ``fast`` pipeline do.
"""

from __future__ import annotations

import torch

from tpudct_torch.constants import LEVEL_SHIFT, get_transform
from tpudct_torch.ops.blocks import as_block_grid, from_block_grid

_LANE = 128


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
    return round_free(x).clamp(0.0, 255.0).to(torch.uint8)


def round_free(x: torch.Tensor) -> torch.Tensor:
    """C truncation toward zero, as the original's ``(unsigned char)value``
    cast after the clamp (utils.cu:22): no rounding."""
    return x.trunc()


def einsum64(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` carried out in float64 and rounded once to the
    first operand's dtype, whatever the process's matmul precision."""
    out = torch.einsum(equation, *(o.to(torch.float64) for o in operands))
    return out.to(operands[0].dtype)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once (an f32 fused multiply-add), elementwise
    on f32 tensors (broadcasting).

    Exact: the product of two f32 values is exact in float64 (48 significant
    bits), so s = fl64(p + c) is the only rounding before the one to f32,
    and TwoSum gives its error e = (p + c) - s exactly.  Rounding s to f32
    gives RN32(p + c) unless s is exactly halfway between two f32 values
    and e is not 0 (|e| is at most half a float64 ulp of s, far below half
    an f32 ulp, so elsewhere s and p + c round alike); there s moves one
    float64 ulp towards p + c, off the tie, before the rounding.  Holds for
    results in f32's normal range (tests/test_torch_ops.py checks it against
    exact rational arithmetic, ties included)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    tie = ((bits & 0x1FFFFFFF) == 0x10000000) & (e != 0)
    toward = torch.where((e > 0) == (s > 0), 1, -1)
    return torch.where(tie, bits + toward, bits).view(torch.float64).to(torch.float32)


def _chain(terms) -> torch.Tensor:
    """sum of x * w over the 8 (x, w) terms, one FMA chain in order."""
    acc = torch.zeros((), dtype=torch.float32, device=terms[0][0].device)
    for x, w in terms:
        acc = fma32(x, w, acc)
    return acc


def _dot8(terms) -> torch.Tensor:
    """sum of x * w over the 8 (x, w) terms as XLA's CPU K = 8 product:
    FMA chains over k = s, s + 4, added (p0 + p1) + (p2 + p3)."""
    p = [_chain(terms[s::4]) for s in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def _rows(g: torch.Tensor, w: torch.Tensor, sum8) -> torch.Tensor:
    """out[:, i, :, l] = sum_j w[i, j] g[:, j, :, l] on the block grid."""
    col = w.reshape(1, 8, 1, 1, 8)
    return sum8([(g[:, j : j + 1], col[..., j]) for j in range(8)])


def _lanes(g: torch.Tensor, w: torch.Tensor, sum8) -> torch.Tensor:
    """out[..., l] = sum_k w[l, k] g[..., k] on the block grid."""
    return sum8([(g[..., k : k + 1], w[:, k]) for k in range(8)])


def _transform(x: torch.Tensor, t, transform: str, inverse: bool) -> torch.Tensor:
    h, w = x.shape
    tiled = t is None and h % _LANE == 0 and w % _LANE == 0
    t = get_transform(transform).t if t is None else t
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    if x.dtype != torch.float32:
        eq = "ji,ajbk,kl->aibl" if inverse else "ij,ajbk,lk->aibl"
        return from_block_grid(einsum64(eq, t, as_block_grid(x), t))
    m = t.T.contiguous() if inverse else t  # out[o] = sum_k m[o, k] in[k], both directions
    g = as_block_grid(x)
    if tiled:
        return from_block_grid(_rows(_lanes(g, m, _chain), m, _chain))
    return from_block_grid(_lanes(_rows(g, m, _dot8), m, _dot8))


def dct2_blocks(x: torch.Tensor, t=None, transform: str = "haweel") -> torch.Tensor:
    """Forward blockwise transform on an (H, W) image (no shift, no quant).

    Y[bi, i, bj, l] = sum_{j,k} T[i,j] X[bi, j, bj, k] T[l,k]; `transform`
    selects a registry entry, an explicit `t` array overrides it (and takes
    the einsum's order, as in the reference).
    """
    return _transform(x, t, transform, inverse=False)


def idct2_blocks(y: torch.Tensor, t=None, transform: str = "haweel") -> torch.Tensor:
    """Inverse blockwise transform: X_b = T.T @ Y_b @ T."""
    return _transform(y, t, transform, inverse=True)
