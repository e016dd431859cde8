"""Photo-like RGB frames: smooth luminance with a 1/f spectrum, smoother
colour, illumination gradients, objects with sharp edges, thin lines and
mild sensor noise (after ``tpudct_torch.benchmark.photographic_image``,
rewritten for the device and for colour).

Uniform noise would make every coefficient nonzero and give the entropy
stage no real statistics.  The coded size depends on the content, so the
seed must not change how much work a frame is: every seed gets the same
scenes (frame k's fields, objects and lines come from a fixed stream of
its own), in an order and with sensor noise drawn from the seed.
"""

from __future__ import annotations

import math

import torch

N_OBJECTS = 8
N_LINES = 24
SCENES = 20_251_018  # the scenes' own seeds start here


def _fields(g, n: int, h: int, w: int, expo: float, device) -> torch.Tensor:
    """n unit-variance fields with amplitude spectrum f^-expo, random phase."""
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0 / max(h, w)
    amp = f ** -expo
    amp[0, 0] = 0.0
    phase = torch.rand((n, h, w // 2 + 1), generator=g, device=device) * (2 * math.pi)
    b = torch.fft.irfft2(torch.polar(amp.expand(n, -1, -1).contiguous(), phase), s=(h, w))
    b = b - b.mean(dim=(1, 2), keepdim=True)
    return b / b.std(dim=(1, 2), keepdim=True)


def _scene(k: int, h: int, w: int, device) -> torch.Tensor:
    """Frame k's noiseless scene, (h, w, 3) float32, the same for every seed."""
    g = torch.Generator(device=device)
    g.manual_seed(SCENES + k)
    lum = _fields(g, 2, h, w, 1.6, device)
    fine = _fields(g, 1, h, w, 1.0, device)[0]
    col = _fields(g, 2, h, w, 2.0, device)
    yy = torch.linspace(-0.5, 0.5, h, device=device)[:, None]
    xx = torch.linspace(-0.5, 0.5, w, device=device)[None, :]
    base = 128.0 + 40.0 * lum[0] + 8.0 * fine + 25.0 * xx + 18.0 * yy
    rgb = torch.stack([base + 14.0 * col[0], base - 5.0 * col[0] + 4.0 * col[1],
                       base - 12.0 * col[1]], dim=-1)
    # objects: discs with a one-pixel sigmoid edge, amplitude 40 of random
    # sign, a tint of random direction
    p = torch.rand((N_OBJECTS, 7), generator=g, device=device).tolist()
    rows = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    cols = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    for cy, cx, rr, sign, t0, t1, t2 in p:
        cy, cx = (0.15 + 0.7 * cy) * h, (0.15 + 0.7 * cx) * w
        r = (0.05 + 0.1 * rr) * min(h, w)
        d = torch.sqrt((rows - cy) ** 2 + (cols - cx) ** 2)
        mask = torch.sigmoid(r - d)
        tint = torch.tensor([0.7 + 0.6 * t0, 0.7 + 0.6 * t1, 0.7 + 0.6 * t2], device=device)
        rgb += (40.0 if sign < 0.5 else -40.0) * mask[..., None] * tint
    # thin lines, one or two pixels wide, amplitude 50 of random sign
    q = torch.rand((N_LINES, 5), generator=g, device=device).tolist()
    for horiz, pos, start, length, sign in q:
        amp = 50.0 if sign < 0.5 else -50.0
        t = 1 + int(length * 2)
        if horiz < 0.5:
            y = int(pos * (h - 2))
            x0 = int(start * w / 2)
            rgb[y:y + t, x0:x0 + w // 4 + int(length * w / 4)] += amp
        else:
            x = int(pos * (w - 2))
            y0 = int(start * h / 2)
            rgb[y0:y0 + h // 4 + int(length * h / 4), x:x + t] += amp
    return rgb


def make(seed: int, count: int, shape, device) -> torch.Tensor:
    """(count, H, W, 3) uint8 interleaved RGB on ``device``: the scenes
    0..count-1 in an order drawn from the seed, each with its own sensor
    noise (sigma 2) drawn from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    h, w = shape
    order = torch.randperm(count, generator=g, device=device).tolist()
    out = torch.empty((count, h, w, 3), dtype=torch.uint8, device=device)
    for slot, k in enumerate(order):
        rgb = _scene(k, h, w, device)
        rgb += 2.0 * torch.randn((h, w, 3), generator=g, device=device)
        out[slot] = rgb.round().clamp(0, 255).to(torch.uint8)
    return out
