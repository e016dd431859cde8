"""Quantization, dequantization and zonal coefficient retention.

  quantize:   C = round_half_away(A / Q[ty, tx])  per in-block position
  dequantize: C = A * Q[ty, tx]
  retention:  keep (u, v) iff u + v < k (zonal, anti-diagonal mask)
"""

from __future__ import annotations

import numpy as np
import torch

from tpudct_torch.constants import BLOCK_SIZE, get_q_table
from tpudct_torch.ops.blocks import as_block_grid, from_block_grid
from tpudct_torch.ops.rounding import round_half_away


def _grid_tile(tile8x8: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """An (8, 8) table shaped (1, 8, 1, 8) to broadcast over a block grid."""
    return torch.as_tensor(tile8x8, dtype=like.dtype, device=like.device).reshape(
        1, BLOCK_SIZE, 1, BLOCK_SIZE
    )


def _q_for(q_scale: float, q_table: str) -> np.ndarray:
    return get_q_table(q_table) * np.float32(q_scale)


def quantize(y: torch.Tensor, q_scale: float = 1.0, q_table: str = "luma",
             deadzone: float = 0.5) -> torch.Tensor:
    """round_half_away(Y / Q) with Q broadcast per 8x8 block position.

    deadzone < 0.5 switches the AC positions to sign(y)·floor(|y|/Q +
    deadzone); DC keeps round-half-away.  Dequantization is unchanged."""
    g = as_block_grid(y)
    q = _grid_tile(_q_for(q_scale, q_table), y)
    if deadzone == 0.5:
        return from_block_grid(round_half_away(g / q))
    if not 0.0 < deadzone < 0.5:
        raise ValueError(f"deadzone must be in (0, 0.5], got {deadzone}")
    dc = np.zeros((BLOCK_SIZE, BLOCK_SIZE), bool)
    dc[0, 0] = True
    dcg = torch.as_tensor(dc, device=y.device).reshape(1, BLOCK_SIZE, 1, BLOCK_SIZE)
    z = g / q
    a = z.abs()
    f = a.floor()
    rha = f + (a - f >= 0.5).to(a.dtype)  # compare form, see rounding.py
    dz = (a + deadzone).floor()
    return from_block_grid(torch.sign(z) * torch.where(dcg, rha, dz))


def dequantize(c: torch.Tensor, q_scale: float = 1.0, q_table: str = "luma") -> torch.Tensor:
    """C * Q, the exact inverse scaling of :func:`quantize`'s division."""
    return from_block_grid(as_block_grid(c) * _grid_tile(_q_for(q_scale, q_table), c))


def q_scale_for_quality(quality: int) -> float:
    """IJG libjpeg quality (1..100) -> quantization-table scale factor: the
    jcparam.c mapping (jpeg_quality_scaling), scale = 5000/q for q < 50
    else 200 - 2q, divided by 100 (quality 50 is the unscaled table).
    libjpeg clamps each scaled table entry to >= 1; with a scalar scale the
    floor 0.01 keeps quality 100 from a zero table."""
    q = min(100, max(1, int(quality)))
    return max((5000.0 / q if q < 50 else 200.0 - 2.0 * q) / 100.0, 0.01)


def retention_mask(k: int | None, bs: int = BLOCK_SIZE) -> np.ndarray:
    """Zonal mask: keep coefficient (u, v) iff u + v < k.  k=None keeps all."""
    if k is None:
        return np.ones((bs, bs), dtype=np.float32)
    u = np.arange(bs)[:, None]
    v = np.arange(bs)[None, :]
    return ((u + v) < k).astype(np.float32)


def apply_retention(c: torch.Tensor, k: int | None) -> torch.Tensor:
    """Zero out truncated coefficients in an (H, W) quantized-coefficient map."""
    if k is None:
        return c
    return from_block_grid(as_block_grid(c) * _grid_tile(retention_mask(k), c))
