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
each returns a 0-d float64 tensor.

Compression factors (the reference's definitions): ``compression_factor``
is the zlib size of the raw image over the size of the coefficient map's
``auto`` .tdc payload (:mod:`tpudct_torch.utils.serialize`), what a user
gets on disk; ``jpeg_compression_factor`` is the reference codec's storage
model, the image's and the reconstruction's libjpeg sizes at quality 100.
Both run on the host and take numpy arrays or tensors.
"""

from __future__ import annotations

import zlib

import numpy as np
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


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _zlib_size(data: bytes, level: int = 6) -> int:
    return len(zlib.compress(data, level))


def compression_factor(image_u8, coeffs, level: int = 6) -> float:
    """zlib size of the raw image over the size of the coefficients' ``auto``
    .tdc payload (the smallest entropy stage, what ``encode`` stores); maps
    off the 8x8 grid compare zlib sizes of the raw int16 map instead."""
    from tpudct_torch.utils.serialize import _encode_payload

    img = np.ascontiguousarray(_host(image_u8), dtype=np.uint8)
    c = np.ascontiguousarray(_host(coeffs), dtype=np.int16)
    if c.ndim == 2 and c.shape[0] % 8 == 0 and c.shape[1] % 8 == 0:
        _code, payload = _encode_payload(c, "auto", level)
        return _zlib_size(img.tobytes(), level) / len(payload)
    return _zlib_size(img.tobytes(), level) / _zlib_size(c.tobytes(), level)


def jpeg_compression_factor(image_u8, recon_u8, quality: int = 100) -> float:
    """libjpeg size of the image over that of the reconstruction, both at
    ``quality`` (the reference codec's storage model re-encodes its
    reconstruction at quality 100)."""
    from tpudct_torch.utils.imageio import encode_jpeg_bytes

    return len(encode_jpeg_bytes(_host(image_u8), quality)) / len(
        encode_jpeg_bytes(_host(recon_u8), quality)
    )


def quality_report(image_u8, recon_u8, coeffs, device=None) -> dict:
    """The reference's report for one image: MSE, PSNR, PEEN, SSIM and the
    compression factor, plus ``jpeg_factor`` for gray images.  The accuracy
    metrics run where :func:`mse` runs them (``device``)."""
    img, rec = _host(image_u8), _host(recon_u8)
    rep = {
        "mse": float(mse(img, rec, device)),
        "psnr_db": float(psnr(img, rec, device)),
        "peen_pct": float(peen(img, rec, device)),
        "ssim": float(ssim(img, rec, device=device)),
        "compression_factor": compression_factor(img, _host(coeffs)),
    }
    if img.ndim == 2 and rec.ndim == 2:  # the reference's model is gray-only
        rep["jpeg_factor"] = jpeg_compression_factor(img, rec)
    return rep
