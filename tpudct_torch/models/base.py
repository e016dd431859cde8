"""Pipeline interface and registry.

Every pipeline maps an (H, W) float image to an (H, W) quantized-coefficient
map (blocks in place) and back.  Pipelines are stateless; tensors stay on
the device they arrive on.
"""

from __future__ import annotations

import abc
from typing import Dict

import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.ops.quant import apply_retention
from tpudct_torch.ops.transform import to_uint8

_REGISTRY: Dict[str, "Pipeline"] = {}


class Pipeline(abc.ABC):
    """A codec compute strategy."""

    name: str = "?"

    @abc.abstractmethod
    def dct(self, image: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
        """(H, W) float image -> (H, W) quantized coefficients: level shift
        (-128), blockwise T X T^T and quantization."""

    @abc.abstractmethod
    def idct(self, coeffs: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
        """(H, W) quantized coefficients -> (H, W) float reconstruction:
        dequantization, blockwise T^T Y T and level unshift (+128)."""

    # ---- shared entry points -------------------------------------------

    def encode(self, image: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
        """dct + optional zonal retention.  Integer images are coerced to
        f32 (uint8 would wrap at the level shift)."""
        if not image.dtype.is_floating_point:
            image = image.to(torch.float32)
        return apply_retention(self.dct(image, cfg), cfg.retain_k)

    def roundtrip(self, image: torch.Tensor, cfg: CodecConfig):
        """image -> (coefficients, uint8 reconstruction)."""
        c = self.encode(image, cfg)
        return c, to_uint8(self.idct(c, cfg))

    def roundtrip_batch(self, images: torch.Tensor, cfg: CodecConfig):
        """(B, H, W) batch pass: 8x8 blocks are independent, so the batch
        folds to one (B*H, W) image — one kernel launch for all of it."""
        b, h, w = images.shape
        c, r = self.roundtrip(images.reshape(b * h, w), cfg)
        return c.reshape(b, h, w), r.reshape(b, h, w)

    def roundtrip_channels(self, image_hwc: torch.Tensor, cfg: CodecConfig):
        """(H, W, C) pass, channels coded independently as batch planes.
        Returns ((C, H, W) coefficients, (H, W, C) uint8 recon)."""
        planes = torch.movedim(image_hwc, -1, 0).contiguous()  # (C, H, W)
        c, r = self.roundtrip_batch(planes, cfg)
        return c, torch.movedim(r, 0, -1)

    def roundtrip_padded(self, image, cfg: CodecConfig):
        """Arbitrary-size pass: pad to the dispatch grid, run the fastest
        eligible path, crop.  Returns (coeffs at the 8-aligned padded shape,
        cropped uint8 recon), both tensors."""
        from tpudct_torch.models.dispatch import roundtrip_gray

        return roundtrip_gray(self, image, cfg)


def register(p: Pipeline, *aliases: str) -> Pipeline:
    for n in (p.name, *aliases):
        _REGISTRY[n] = p
    return p


def get_pipeline(name: str) -> Pipeline:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown pipeline {name!r}; have {sorted(set(_REGISTRY))}") from None


def available_pipelines():
    return sorted({p.name for p in _REGISTRY.values()})
