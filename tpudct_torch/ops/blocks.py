"""Image <-> 8x8-block layout transforms (views and reshapes)."""

from __future__ import annotations

import torch

from tpudct_torch.constants import BLOCK_SIZE


def num_blocks(h: int, w: int, bs: int = BLOCK_SIZE) -> int:
    return (h // bs) * (w // bs)


def blockify(x: torch.Tensor, bs: int = BLOCK_SIZE) -> torch.Tensor:
    """(H, W) -> (H//bs * W//bs, bs, bs), row-major over the block grid."""
    h, w = x.shape
    return (
        x.reshape(h // bs, bs, w // bs, bs)
        .permute(0, 2, 1, 3)
        .reshape(num_blocks(h, w, bs), bs, bs)
    )


def deblockify(blocks: torch.Tensor, h: int, w: int, bs: int = BLOCK_SIZE) -> torch.Tensor:
    """(nb, bs, bs) -> (H, W).  Exact inverse of :func:`blockify`."""
    return (
        blocks.reshape(h // bs, w // bs, bs, bs)
        .permute(0, 2, 1, 3)
        .reshape(h, w)
    )


def as_block_grid(x: torch.Tensor, bs: int = BLOCK_SIZE) -> torch.Tensor:
    """(H, W) -> (H//bs, bs, W//bs, bs) view: the in-block axes are 1 and 3."""
    h, w = x.shape
    if h % bs or w % bs:
        raise ValueError(
            f"image {h}x{w} not divisible into {bs}x{bs} blocks; "
            "pad first (ops.padding.pad_to_blocks)"
        )
    return x.reshape(h // bs, bs, w // bs, bs)


def from_block_grid(g: torch.Tensor) -> torch.Tensor:
    """(H//bs, bs, W//bs, bs) -> (H, W)."""
    nbh, bs, nbw, _ = g.shape
    return g.reshape(nbh * bs, nbw * bs)
