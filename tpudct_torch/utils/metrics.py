"""Accuracy metrics: the counterpart of ``tpudct/utils/metrics.py`` (MSE,
PSNR, PEEN, SSIM).

Definitions (the reference's; the original codec publishes PEEN and MSE
without code):
  MSE   = mean((x - y)^2)
  PSNR  = 10 log10(255^2 / MSE), MSE floored at 1e-30 (a perfect
          reconstruction stays finite, valid JSON)
  PEEN  = 100 * sum((x - y)^2) / sum(x^2), the denominator floored at 1e-30
  SSIM  mean structural similarity (Wang et al. 2004) over uniform 8x8
        windows, K1 = 0.01, K2 = 0.03

Each takes numpy arrays or tensors.  Tensors stay on their device; numpy
arrays go to ``models.dispatch.default_device(device)`` (the first card, or
``device``).  Every sum and window mean is taken in float64, so the results
do not depend on the summation order (the reference accumulates in f32);
each returns a 0-d float64 tensor.  The compression factors and
``quality_report`` need the serialize layer and wait for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpudct_torch.models.dispatch import _tensor


def _f64(a, device) -> torch.Tensor:
    return _tensor(a, device).to(torch.float64)


def mse(x, y, device=None) -> torch.Tensor:
    d = _f64(x, device) - _f64(y, device)
    return (d * d).mean()


def psnr(x, y, device=None) -> torch.Tensor:
    return 10.0 * torch.log10(255.0**2 / mse(x, y, device).clamp_min(1e-30))


def peen(x, y, device=None) -> torch.Tensor:
    """Percentage error energy: 100 * ||x - y||^2 / ||x||^2."""
    xf = _f64(x, device)
    d = xf - _f64(y, device)
    return 100.0 * (d * d).sum() / (xf * xf).sum().clamp_min(1e-30)


def ssim(x, y, data_range: float = 255.0, win: int = 8, device=None) -> torch.Tensor:
    """Mean SSIM of two (H, W) images over every win x win window (valid
    positions only); images smaller than the window use the largest square
    window that fits, as the reference does."""
    xf, yf = _f64(x, device), _f64(y, device)
    win = max(1, min(win, xf.shape[0], xf.shape[1]))

    def blur(a):
        return F.avg_pool2d(a[None, None], win, stride=1)[0, 0]

    mx, my = blur(xf), blur(yf)
    mxx, myy, mxy = blur(xf * xf), blur(yf * yf), blur(xf * yf)
    vx, vy, cxy = mxx - mx * mx, myy - my * my, mxy - mx * my
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    num = (2 * mx * my + c1) * (2 * cxy + c2)
    den = (mx * mx + my * my + c1) * (vx + vy + c2)
    return (num / den).mean()
