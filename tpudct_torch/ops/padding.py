"""Padding to block and kernel-grid multiples, and cropping back.

Images are edge-replicate padded (the standard JPEG approach: least
artificial high-frequency energy at the border); coefficient maps are zero
padded, since an all-zero block decodes to the constant level shift.  The
transform is block-local, so padding whole blocks changes nothing inside
the original region.
"""

from __future__ import annotations

import torch

from tpudct_torch.constants import BLOCK_SIZE
from tpudct_torch.utils import profiling


def padded_shape(h: int, w: int, bs: int = BLOCK_SIZE):
    return ((h + bs - 1) // bs * bs, (w + bs - 1) // bs * bs)


def edge_pad_plain(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-replicate pad the last two dims (..., H, W) -> (..., ph, pw) for
    any dtype (F.pad's replicate mode takes floating tensors only): row
    min(i, H - 1), column min(j, W - 1)."""
    h, w = x.shape[-2:]
    rows = torch.arange(ph, device=x.device).clamp_(max=h - 1)
    cols = torch.arange(pw, device=x.device).clamp_(max=w - 1)
    return x[..., rows[:, None], cols[None, :]]


def _edge_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """:func:`edge_pad_plain` as a pass of the program (a ``pad`` span)."""
    with profiling.span("pad"):
        return edge_pad_plain(x, ph, pw)


def pad_to_blocks(x: torch.Tensor, bs: int = BLOCK_SIZE):
    """Edge-replicate pad an (H, W) image up to block multiples.

    Returns (padded, (h, w)) with the original size for later cropping.
    """
    h, w = x.shape
    ph, pw = padded_shape(h, w, bs)
    if (ph, pw) == (h, w):
        return x, (h, w)
    return _edge_pad(x, ph, pw), (h, w)


def kernel_padded_shape(h: int, w: int, row_align: int, lane: int = 128):
    """Shape after padding to the dispatch grid (rows by `row_align`,
    columns by `lane`) — the reference's fused-kernel grid, kept so that
    both packages pick the same path and the same padding."""
    return (
        max(row_align, (h + row_align - 1) // row_align * row_align),
        max(lane, (w + lane - 1) // lane * lane),
    )


def pad_to_kernel(x: torch.Tensor, row_align: int, lane: int = 128):
    """Edge-replicate pad an (H, W) image, or the planes of a (C, H, W)
    one, up to the dispatch grid.  Returns (padded, (h, w))."""
    h, w = x.shape[-2:]
    ph, pw = kernel_padded_shape(h, w, row_align, lane)
    if (ph, pw) == (h, w):
        return x, (h, w)
    return _edge_pad(x, ph, pw), (h, w)


def pad_coeffs_to_kernel(c: torch.Tensor, row_align: int, lane: int = 128):
    """Zero-pad a quantized-coefficient map up to the dispatch grid.
    Returns (padded, (h, w))."""
    h, w = c.shape
    ph, pw = kernel_padded_shape(h, w, row_align, lane)
    if (ph, pw) == (h, w):
        return c, (h, w)
    with profiling.span("pad"):
        out = torch.zeros((ph, pw), dtype=c.dtype, device=c.device)
        out[:h, :w] = c
    return out, (h, w)


def crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Crop back to the pre-padding size."""
    return x[:h, :w]
