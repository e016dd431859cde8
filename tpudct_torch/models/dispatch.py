"""Gray-plane dispatch: one gate for the u8 kernels, the f32 kernel and the
einsum path (the gray subset of ``tpudct/models/dispatch.py``).

The gate and the padding are the reference's, so both packages send a
shape down the same path:

- encode: edge-replicate pad to the dispatch grid (the transform is
  block-local, so pixels in the original region are unaffected), run the
  fastest eligible path, and crop the coefficient map back to the 8-aligned
  shape.
- decode: zero-pad the coefficient map to the grid (all-zero blocks decode
  to the constant level shift), decode, crop.

Inputs may be numpy arrays or tensors.  A tensor stays on its device (a
CUDA tensor runs the CUDA kernels); a numpy array is taken on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.models.base import Pipeline
from tpudct_torch.ops.padding import (
    crop,
    kernel_padded_shape,
    pad_coeffs_to_kernel,
    pad_to_blocks,
    pad_to_kernel,
    padded_shape,
)
from tpudct_torch.ops.transform import to_uint8

# Row alignment per kernel family (kernels.hp.supports/supports_u8).
_U8_ROWS = 32
_F32_ROWS = 8
_LANE = 128


def _abs_bound(a) -> float:
    """max(|a|) as a float through a min/max pair (no full-size temporary);
    takes a numpy array or a tensor on any device."""
    empty = a.numel() == 0 if isinstance(a, torch.Tensor) else np.size(a) == 0
    if empty:
        return 0.0
    return max(-float(a.min()), float(a.max()))


def choose_gray_path(p: Pipeline, h: int, w: int, cfg: CodecConfig) -> str:
    """Pure decision on shape and config: ``"u8"`` (fused int8 kernels),
    ``"f32"`` (the pipeline's f32 kernel path) or ``"general"`` (the
    pipeline's default path; also every non-hp pipeline)."""
    from tpudct_torch.kernels import hp

    if cfg.deadzone != 0.5:
        # encode-side deadzone rides the einsum quantizer only
        return "general"
    if hasattr(p, "roundtrip_u8"):
        if hp.supports_u8(
            *kernel_padded_shape(h, w, _U8_ROWS, _LANE),
            cfg.q_scale, cfg.transform, cfg.q_table,
        ):
            return "u8"
        if hp.supports(*kernel_padded_shape(h, w, _F32_ROWS, _LANE)):
            return "f32"
    return "general"


def _is_u8(img) -> bool:
    if isinstance(img, torch.Tensor):
        return img.dtype == torch.uint8
    return np.asarray(img).dtype == np.uint8


def _resolve_path(p: Pipeline, img, cfg: CodecConfig) -> str:
    """choose_gray_path, with float inputs demoted from "u8" to "f32" (a
    float may sit outside [0, 255], where a cast would wrap)."""
    h, w = tuple(img.shape)
    path = choose_gray_path(p, h, w, cfg)
    if path == "u8" and not _is_u8(img):
        return "f32"
    return path


def _pad_for(path: str, img):
    if path == "u8":
        return pad_to_kernel(torch.as_tensor(img, dtype=torch.uint8), _U8_ROWS, _LANE)
    if path == "f32":
        return pad_to_kernel(torch.as_tensor(img, dtype=torch.float32), _F32_ROWS, _LANE)
    x = torch.as_tensor(img)
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    return pad_to_blocks(x)


def _crop8(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Crop a grid-padded coefficient map back to the 8-aligned shape."""
    return crop(c, *padded_shape(h, w))


def encode_gray_auto(p: Pipeline, img, cfg: CodecConfig):
    """Gray encode through the fastest eligible path.  Returns (coeffs,
    (h, w)) with `coeffs` at the 8-aligned padded shape (int8 when the u8
    kernels ran, f32 otherwise)."""
    h, w = tuple(img.shape)
    path = _resolve_path(p, img, cfg)
    x, _ = _pad_for(path, img)
    c = p.encode_u8(x, cfg) if path == "u8" else p.encode(x, cfg)
    return _crop8(c, h, w), (h, w)


def decode_gray_auto(p: Pipeline, coeffs, cfg: CodecConfig, orig_shape) -> np.ndarray:
    """Decode a quantized-coefficient map to a cropped uint8 numpy plane,
    on the int8 kernel whenever the values fit int8 and the zero-padded
    map meets the grid."""
    from tpudct_torch.kernels import hp

    h, w = orig_shape
    hc, wc = tuple(coeffs.shape)
    if (
        hasattr(p, "decode_u8")
        and hp.supports_u8(
            *kernel_padded_shape(hc, wc, _U8_ROWS, _LANE),
            cfg.q_scale, cfg.transform, cfg.q_table,
        )
        and _abs_bound(coeffs) <= 127
    ):
        cpad, _ = pad_coeffs_to_kernel(
            torch.as_tensor(coeffs, dtype=torch.int8), _U8_ROWS, _LANE
        )
        r = p.decode_u8(cpad, cfg)
    elif hasattr(p, "decode_u8") and hp.supports(
        *kernel_padded_shape(hc, wc, _F32_ROWS, _LANE)
    ):
        cpad, _ = pad_coeffs_to_kernel(
            torch.as_tensor(coeffs, dtype=torch.float32), _F32_ROWS, _LANE
        )
        r = to_uint8(p.idct(cpad, cfg))
    else:
        r = to_uint8(p.idct(torch.as_tensor(coeffs), cfg))
    return r[:h, :w].cpu().numpy()


def roundtrip_gray(p: Pipeline, img, cfg: CodecConfig):
    """Core of :func:`roundtrip_gray_auto`: returns tensors (coeffs at the
    8-aligned shape, uint8 reconstruction cropped to (h, w))."""
    h, w = tuple(img.shape)
    path = _resolve_path(p, img, cfg)
    x, _ = _pad_for(path, img)
    c, r = p.roundtrip_u8(x, cfg) if path == "u8" else p.roundtrip(x, cfg)
    return _crop8(c, h, w), r[:h, :w]


def roundtrip_gray_auto(p: Pipeline, img, cfg: CodecConfig):
    """Gray roundtrip through the fastest eligible path.  Returns (coeffs
    tensor at the 8-aligned shape, uint8 reconstruction cropped to (h, w)
    as a numpy array)."""
    c, r = roundtrip_gray(p, img, cfg)
    return c, r.cpu().numpy()
