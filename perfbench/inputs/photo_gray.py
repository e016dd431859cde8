"""Photo-like gray frames: the full-range BT.601 luma (ITU-T T.871) of
``photo_rgb.py``'s scenes, with mild sensor noise.

As there, the coded size depends on the content, so the seed must not
change how much work a frame is: every seed gets the same scenes (frame
k's fields, objects and lines come from a fixed stream of its own), in an
order and with sensor noise (sigma 2) drawn from the seed.
"""

from __future__ import annotations

import torch

from perfbench.inputs import photo_rgb

LUMA = (0.299, 0.587, 0.114)


def scene(k: int, h: int, w: int, device) -> torch.Tensor:
    """Frame k's noiseless gray scene, (h, w) float32, the same for every seed."""
    rgb = photo_rgb._scene(k, h, w, device)
    return LUMA[0] * rgb[..., 0] + LUMA[1] * rgb[..., 1] + LUMA[2] * rgb[..., 2]


def make(seed: int, count: int, shape, device) -> torch.Tensor:
    """(count, H, W) uint8 on ``device``: the scenes 0..count-1 in an order
    drawn from the seed, each with its own sensor noise drawn from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    h, w = shape
    order = torch.randperm(count, generator=g, device=device).tolist()
    out = torch.empty((count, h, w), dtype=torch.uint8, device=device)
    for slot, k in enumerate(order):
        y = scene(k, h, w, device)
        y += 2.0 * torch.randn((h, w), generator=g, device=device)
        out[slot] = y.round().clamp(0, 255).to(torch.uint8)
    return out
