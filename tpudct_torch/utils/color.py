"""Color-space conversion and chroma resampling (plain torch).

Counterpart of ``tpudct/utils/color.py``: full-range BT.601 RGB <-> YCbCr
(ITU-T T.871) and the JPEG chroma resamplings, 4:2:0 (2x2) and 4:2:2 (1x2),
so a color image codes as one luma plane at full resolution and two chroma
planes against the chroma quantization table.

Everything stays f32, as in the reference.  Its constants are Python floats
that jnp rounds to f32 where they meet an f32 plane (weak typing), and the
derived ones (``0.5 / (1 - KB)``, ``2 - 2 KR``, ...) are computed in f64 and
rounded once; the ``F32`` table below holds exactly those f32 values, so
every product here is the reference's product.  Each product and sum is a
separate, rounded torch op (eager torch does not contract into FMAs).
"""

from __future__ import annotations

import numpy as np
import torch

from tpudct_torch.ops.rounding import round_half_away

# ITU-T T.871 (JPEG full-range) BT.601 luma coefficients.
_KR, _KG, _KB = 0.299, 0.587, 0.114


def _f32(v: float) -> float:
    return float(np.float32(v))


#: The transforms' constants as the f32 values the reference multiplies by.
F32 = {
    "kr": _f32(_KR), "kg": _f32(_KG), "kb": _f32(_KB),
    "kcb": _f32(0.5 / (1.0 - _KB)), "kcr": _f32(0.5 / (1.0 - _KR)),
    "kr2": _f32(2.0 - 2.0 * _KR), "kb2": _f32(2.0 - 2.0 * _KB),
    # the direct-form inverse's g weights (the color variant study's V12)
    "c1": _f32(_KB * (2.0 - 2.0 * _KB) / _KG), "c2": _f32(_KR * (2.0 - 2.0 * _KR) / _KG),
}


def ycbcr_from_rgb_planes(r, g, b):
    """Plane-wise BT.601 forward transform (f32 in, f32 out, unclamped):
    ``y = (KR r + KG g) + KB b``, ``cb = 128 + (b - y) kcb``,
    ``cr = 128 + (r - y) kcr``."""
    k = F32
    y = (r * k["kr"] + g * k["kg"]) + b * k["kb"]
    cb = (b - y) * k["kcb"] + 128.0
    cr = (r - y) * k["kcr"] + 128.0
    return y, cb, cr


def rgb_from_ycbcr_planes(y, cb, cr):
    """Plane-wise BT.601 inverse transform (f32 in, f32 out, unclamped):
    ``r = y + kr2 (cr - 128)``, ``b = y + kb2 (cb - 128)``,
    ``g = ((y - KR r) - KB b) / KG`` (a true division)."""
    k = F32
    cbc, crc = cb - 128.0, cr - 128.0
    r = y + crc * k["kr2"]
    b = y + cbc * k["kb2"]
    num = (y - r * k["kr"]) - b * k["kb"]
    # a tensor divisor: PyTorch's CUDA division by a scalar multiplies by
    # its reciprocal, which rounds differently
    g = torch.div(num, torch.full_like(num, k["kg"]))
    return r, g, b


def rgb_to_ycbcr(rgb: torch.Tensor):
    """(H, W, 3) RGB (any dtype, 0..255) -> (y, cb, cr) f32 planes."""
    x = torch.as_tensor(rgb).to(torch.float32)
    return ycbcr_from_rgb_planes(x[..., 0], x[..., 1], x[..., 2])


def ycbcr_to_rgb(y, cb, cr) -> torch.Tensor:
    """Inverse of :func:`rgb_to_ycbcr`; returns (H, W, 3) f32, unclamped."""
    r, g, b = rgb_from_ycbcr_planes(
        *(torch.as_tensor(v).to(torch.float32) for v in (y, cb, cr))
    )
    return torch.stack([r, g, b], dim=-1)


def _edge_even(x: torch.Tensor, rows: bool, cols: bool) -> torch.Tensor:
    """Edge-replicate an odd trailing row / column so the 2-windows are full."""
    if rows and x.shape[0] % 2:
        x = torch.cat([x, x[-1:, :]], dim=0)
    if cols and x.shape[1] % 2:
        x = torch.cat([x, x[:, -1:]], dim=1)
    return x


def downsample_420(plane) -> torch.Tensor:
    """(H, W) -> (ceil(H/2), ceil(W/2)) by 2x2 mean pooling (JPEG 4:2:0);
    an odd trailing row/column is edge-replicated first."""
    x = _edge_even(torch.as_tensor(plane).to(torch.float32), True, True)
    x = (x[0::2] + x[1::2]) * 0.5
    return (x[:, 0::2] + x[:, 1::2]) * 0.5


def upsample_420(plane, h: int, w: int) -> torch.Tensor:
    """(h2, w2) -> (h, w) by 2x2 nearest replication, cropped."""
    x = torch.as_tensor(plane).to(torch.float32)
    return x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:h, :w]


def downsample_422(plane) -> torch.Tensor:
    """(H, W) -> (H, ceil(W/2)) by horizontal 2x mean pooling (JPEG 4:2:2)."""
    x = _edge_even(torch.as_tensor(plane).to(torch.float32), False, True)
    return (x[:, 0::2] + x[:, 1::2]) * 0.5


def upsample_422(plane, h: int, w: int) -> torch.Tensor:
    """(h, w2) -> (h, w) by horizontal nearest replication, cropped."""
    x = torch.as_tensor(plane).to(torch.float32)
    return x.repeat_interleave(2, dim=1)[:h, :w]


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    return round_half_away(v).clamp(0.0, 255.0).to(torch.uint8)


def ycbcr_split_420_u8(rgb_planar_u8: torch.Tensor, subsample: bool = True):
    """(3, H, W) uint8 RGB -> (y_u8 (H, W), cb_u8, cr_u8 (H/2, W/2)):
    transform in f32, pool the chroma in f32, then one rounding."""
    y, cb, cr = ycbcr_from_rgb_planes(*(rgb_planar_u8[i].to(torch.float32) for i in range(3)))
    if subsample:
        cb, cr = downsample_420(cb), downsample_420(cr)
    return _to_u8(y), _to_u8(cb), _to_u8(cr)


def ycbcr_merge_420_u8(y_u8, cb_u8, cr_u8, h: int, w: int, subsample: bool = True):
    """(y, cb, cr) uint8 planes -> (3, H, W) uint8 RGB (inverse of
    :func:`ycbcr_split_420_u8`, nearest-neighbour chroma upsampling)."""
    y = torch.as_tensor(y_u8)[:h, :w].to(torch.float32)
    cb = torch.as_tensor(cb_u8).to(torch.float32)
    cr = torch.as_tensor(cr_u8).to(torch.float32)
    if subsample:
        cb, cr = upsample_420(cb, h, w), upsample_420(cr, h, w)
    else:
        cb, cr = cb[:h, :w], cr[:h, :w]
    return _to_u8(torch.stack(rgb_from_ycbcr_planes(y, cb, cr), dim=0))
