"""Uniform 8-bit noise, the reference CUDA codec's benchmark image
(``srand(42); rand() % 256``) with the seed taken from ``--seed``.

Every pixel is independent, so every coefficient is live and the content
has no statistics a seed could change: only the values differ.
"""

from __future__ import annotations

import torch


def make(seed: int, count: int, shape, device) -> torch.Tensor:
    """(count, H, W) uint8 on ``device``, one call of the device's generator."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (count, *shape), generator=g, device=device, dtype=torch.uint8)
