"""Fractional-scale decode: quantized coefficients -> (H/f, W/f) image.

Counterpart of ``tpudct/ops/scaled.py`` (djpeg's ``-scale M/8``, M =
1..16), with its one contract:

    scaled decode at m/8  ==  full inverse transform, then an exact
                              area-average resample to m outputs per
                              8 source pixels (integer m/8: the f x f
                              box-filter average)

Per 8x8 block, with P the (m, 8) area matrix (rows sum to 1),
``P (T^T Yd T + 128) P^T = (P T^T) Yd (P T^T)^T + 128``, so the scaled
decode is the blockwise bilinear form with the rectangular basis
``B = P T^T``, valid for every registry transform.  The contraction is plain
torch (the reference's is XLA, not Pallas), carried out in float64 and
rounded once to f32 (``ops.transform.einsum64``), so no TF32 or bf16
matmul setting of the process reaches it.

``scaled_decode_u8`` is the fast form for int8 maps: the box average of the
clamped, truncated full decode.  It launches the fused kernel
(``kernels.hp.hp_scaled_decode_u8``, B7) where the effective decode tier is
butterfly and the reference's gate holds, and otherwise composes
``decode_u8`` with :func:`box_pool_u8`, bit-identically.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudct_torch.constants import get_transform
from tpudct_torch.ops.blocks import as_block_grid
from tpudct_torch.ops.quant import dequantize
from tpudct_torch.ops.transform import einsum64, level_unshift, to_uint8

_BS = 8

#: scale factors with an exact block-aligned pooling (8 % f == 0)
FACTORS = (1, 2, 4, 8)

#: djpeg-parity numerators for --scale M/8 (M > 8 = block-local upscale)
M_RANGE = tuple(range(1, 17))


def pool_matrix(f: int) -> np.ndarray:
    """(8/f, 8) box-average matrix: row i averages entries i*f .. i*f+f-1."""
    if f not in FACTORS:
        raise ValueError(f"scale factor must be one of {FACTORS}, got {f}")
    m = _BS // f
    p = np.zeros((m, _BS), np.float32)
    for i in range(m):
        p[i, i * f : (i + 1) * f] = 1.0 / f
    return p


def area_matrix(m: int) -> np.ndarray:
    """(m, 8) exact area-average matrix for an 8 -> m resample (M/8 scale).

    Output pixel i covers the source interval [i*8/m, (i+1)*8/m); source
    pixel j weighs its overlap length times m/8, so every row sums to 1.
    For m | 8 this is pool_matrix(8/m)."""
    if m not in M_RANGE:
        raise ValueError(f"scale numerator must be in 1..16, got {m}")
    if _BS % m == 0:
        return pool_matrix(_BS // m)
    p = np.zeros((m, _BS), np.float64)
    for i in range(m):
        lo = i * _BS / m
        hi = (i + 1) * _BS / m
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), _BS)):
            p[i, j] = max(0.0, min(hi, j + 1) - max(lo, j))
    return (p * (m / _BS)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def scaled_basis_m(m: int, transform: str = "haweel") -> np.ndarray:
    """B = P @ T^T, the (m, 8) per-block synthesis basis (m=8: plain T^T)."""
    t = get_transform(transform).t.astype(np.float64)
    return (area_matrix(m).astype(np.float64) @ t.T).astype(np.float32)


def scaled_basis(f: int, transform: str = "haweel") -> np.ndarray:
    """Factor-f box form of :func:`scaled_basis_m` (f=1: plain T^T)."""
    if f not in FACTORS:
        raise ValueError(f"scale factor must be one of {FACTORS}, got {f}")
    return scaled_basis_m(_BS // f, transform)


def scaled_idct2_blocks_m(y: torch.Tensor, m_rows: int, m_cols: int,
                          transform: str = "haweel") -> torch.Tensor:
    """Blockwise ``B_r @ Y_b @ B_c^T`` on an (H, W) dequantized map.
    Returns the (H m_r/8, W m_c/8) level-shifted reconstruction (no +128)."""
    h, w = y.shape
    if h % _BS or w % _BS:
        raise ValueError(f"coefficient map {h}x{w} not divisible into 8x8 blocks")
    bc = torch.as_tensor(scaled_basis_m(m_cols, transform), dtype=y.dtype, device=y.device)
    br = torch.as_tensor(scaled_basis_m(m_rows, transform), dtype=y.dtype, device=y.device)
    out = einsum64("ij,ajbk,lk->aibl", br, as_block_grid(y), bc)
    return out.reshape((h // _BS) * m_rows, (w // _BS) * m_cols)


def scaled_decode_m8(coeffs, cfg, m_rows: int, m_cols: int | None = None) -> torch.Tensor:
    """Quantized (H, W) coefficient map -> (H*m/8, W*m/8) f32 reconstruction:
    the exact area resample of the full decode, computed in the transform
    domain.  ``m_cols`` overrides the column numerator."""
    mc = m_rows if m_cols is None else m_cols
    yd = dequantize(torch.as_tensor(coeffs).to(torch.float32), cfg.q_scale, cfg.q_table)
    return level_unshift(scaled_idct2_blocks_m(yd, m_rows, mc, cfg.transform))


def scaled_decode(coeffs, cfg, factor: int, f_cols: int | None = None) -> torch.Tensor:
    """Quantized (H, W) coefficient map -> (H/f, W/fc) f32 reconstruction:
    the box average of the full (unclamped) decode, up to f32 summation
    order."""
    fc = factor if f_cols is None else f_cols
    if factor not in FACTORS or fc not in FACTORS:
        raise ValueError(f"scale factors must be in {FACTORS}, got "
                         f"({factor}, {fc}); use scaled_decode_m8 for M/8")
    return scaled_decode_m8(coeffs, cfg, _BS // factor, _BS // fc)


def scaled_shape(orig: int, f: int) -> int:
    """Output length of a 1/f-scaled axis of pre-padding length ``orig``:
    ceil(orig / f)."""
    return -(-orig // f)


def scaled_shape_m8(orig: int, m: int) -> int:
    """Output length of an M/8-scaled axis: ceil(orig * m / 8)."""
    return -(-orig * m // _BS)


def box_pool_u8(x_u8, f_rows: int, f_cols: int | None = None) -> torch.Tensor:
    """Exact f x f box average of a uint8 raster -> float32: int32 window
    sums, then the power-of-two multiply 1/(f_r f_c), both exact."""
    fc = f_rows if f_cols is None else f_cols
    x = torch.as_tensor(x_u8)
    h, w = x.shape
    if h % f_rows or w % fc:
        raise ValueError(
            f"box_pool_u8 needs dims divisible by the factors, got "
            f"{h}x{w} at ({f_rows}, {fc})"
        )
    s = x.to(torch.int32).reshape(h // f_rows, f_rows, w // fc, fc).sum(dim=(1, 3))
    return s.to(torch.float32) * (1.0 / (f_rows * fc))


def scaled_decode_u8(pipeline, coeffs_i8, cfg, factor: int, f_cols: int | None = None,
                     out_u8: bool = False) -> torch.Tensor:
    """int8 (H, W) map -> (H/f, W/fc) box average of the clamped, truncated
    full decode: f32, or uint8 (truncated) with ``out_u8``.

    The fused kernel runs the butterfly inverse only, so any other
    effective tier (``models.hp_appr._decode_prec``) composes
    ``decode_u8`` (which honours it) with :func:`box_pool_u8`, as the
    reference does: the two forms are bit-identical under every config."""
    from tpudct_torch.kernels import hp

    fc = factor if f_cols is None else f_cols
    c = torch.as_tensor(coeffs_i8).to(torch.int8)
    h, w = c.shape
    eff_butterfly = (
        cfg.decode_precision == "butterfly"
        and get_transform(cfg.transform).has_integer_core
    )
    if eff_butterfly and hp.supports_scaled_u8(
        h, w, factor, fc, cfg.q_scale, cfg.transform, cfg.q_table
    ):
        return hp.hp_scaled_decode_u8(
            c.contiguous(), factor, fc, q_scale=cfg.q_scale, q_table=cfg.q_table,
            transform=cfg.transform, out_u8=out_u8,
        )
    pooled = box_pool_u8(pipeline.decode_u8(c, cfg), factor, fc)
    return to_uint8(pooled) if out_u8 else pooled
