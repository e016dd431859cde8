"""`hp`: the flagship pipeline, backed by the hand-written CUDA kernels.

Counterpart of ``tpudct/models/hp_appr.py`` with the same gates, the same
demotions, the same fallbacks to the `batched` einsum path and the same
refusals.  On a CPU tensor each kernel wrapper runs its plain torch twin; on
a CUDA tensor it launches the kernel (``tpudct_torch/kernels/hp.py``).
"""

from __future__ import annotations

import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.constants import get_transform
from tpudct_torch.kernels import hp
from tpudct_torch.models.base import Pipeline, register
from tpudct_torch.models.batched import BatchedPipeline
from tpudct_torch.ops.transform import to_uint8

_batched = BatchedPipeline()


def _int_core(cfg: CodecConfig) -> bool:
    """exact_int_core, demoted when the transform has no integer core
    (e.g. the exact 'dct': the f32-literal core only)."""
    return cfg.exact_int_core and get_transform(cfg.transform).has_integer_core


def _decode_prec(cfg: CodecConfig) -> str:
    """butterfly needs the integer core's Ts; transforms without one decode
    at 'highest' (the f32 tier on the literal T)."""
    if cfg.decode_precision == "butterfly" and not get_transform(cfg.transform).has_integer_core:
        return "highest"
    return cfg.decode_precision


class HpApprPipeline(Pipeline):
    name = "hp"

    def dct(self, image, cfg: CodecConfig):
        if not image.dtype.is_floating_point:
            image = image.to(torch.float32)
        h, w = image.shape
        if not hp.supports(h, w) or cfg.deadzone != 0.5:
            # deadzone quantization rides the einsum quantizer, as in the
            # reference; the fused kernels bake the 0.5 rule
            return _batched.dct(image, cfg)
        return hp.hp_dct(
            image.to(torch.float32).contiguous(),
            q_scale=cfg.q_scale,
            q_table=cfg.q_table,
            transform=cfg.transform,
            int_core=_int_core(cfg),
        )

    def idct(self, coeffs, cfg: CodecConfig):
        h, w = coeffs.shape
        if not hp.supports(h, w):
            return _batched.idct(coeffs, cfg)
        return hp.hp_idct(
            coeffs.to(torch.float32).contiguous(),
            q_scale=cfg.q_scale,
            q_table=cfg.q_table,
            decode_precision=_decode_prec(cfg),
            transform=cfg.transform,
        )

    def roundtrip(self, image, cfg: CodecConfig):
        """One fused kernel (B4, or B4' on the f32-literal core) where the
        reference's gate allows."""
        if not image.dtype.is_floating_point:
            image = image.to(torch.float32)
        h, w = image.shape
        if not hp.supports(h, w) or cfg.deadzone != 0.5:
            return super().roundtrip(image, cfg)  # deadzone: einsum path
        c, r = hp.hp_roundtrip(
            image.to(torch.float32).contiguous(),
            q_scale=cfg.q_scale,
            q_table=cfg.q_table,
            retain_k=cfg.retain_k,
            decode_precision=_decode_prec(cfg),
            transform=cfg.transform,
            int_core=_int_core(cfg),
        )
        return c, to_uint8(r)

    # ---- u8-native path ------------------------------------------------

    def encode_u8(self, image_u8, cfg: CodecConfig):
        """uint8 image -> int8 coefficient map."""
        h, w = image_u8.shape
        if not hp.supports_u8(h, w, cfg.q_scale, cfg.transform, cfg.q_table):
            bound = hp._max_coeff(cfg.transform, cfg.q_table)
            why = (
                f"transform {cfg.transform!r} has no integer core"
                if bound == float("inf")
                else f"q_scale>={bound / 127.0:.2f} for int8 coefficients"
            )
            raise ValueError(
                f"u8 path needs h%32==0, w%128==0 and {why} "
                f"(got {h}x{w}, q_scale={cfg.q_scale}, transform={cfg.transform})"
            )
        return self._encode_u8_plane(image_u8, cfg)

    def _encode_u8_plane(self, image_u8, cfg: CodecConfig):
        """``encode_u8`` without its shape gate: any 8-aligned plane (the
        u8 colour path, whose gate is on the colour kernel grid)."""
        return hp.hp_encode_u8(
            image_u8.contiguous(), q_scale=cfg.q_scale, q_table=cfg.q_table,
            retain_k=cfg.retain_k, transform=cfg.transform,
        )

    def decode_u8(self, coeffs_i8, cfg: CodecConfig):
        """int8 coefficient map -> uint8 reconstruction."""
        h, w = coeffs_i8.shape
        if h % 32 or w % 128:
            raise ValueError(
                f"u8 decode path needs h%32==0 and w%128==0, got {h}x{w}; "
                "use idct() + to_uint8 for other shapes"
            )
        return self._decode_u8_plane(coeffs_i8, cfg)

    def _decode_u8_plane(self, coeffs_i8, cfg: CodecConfig):
        """``decode_u8`` without its shape gate: any 8-aligned plane."""
        return hp.hp_decode_u8(
            coeffs_i8.contiguous(), q_scale=cfg.q_scale, q_table=cfg.q_table,
            decode_precision=_decode_prec(cfg), transform=cfg.transform,
        )

    def roundtrip_u8(self, image_u8, cfg: CodecConfig):
        """Fully fused u8-native pass: uint8 -> (int8 coeffs, uint8 recon)."""
        h, w = image_u8.shape
        bound = hp._max_coeff(cfg.transform, cfg.q_table)
        if bound / cfg.q_scale > 127.0:
            # int8 coefficients would wrap around (or the transform has no
            # integer core) — refuse rather than silently corrupt.
            raise ValueError(
                f"transform={cfg.transform} has no integer core; use roundtrip()"
                if bound == float("inf")
                else f"q_scale={cfg.q_scale} with transform={cfg.transform} "
                "does not fit int8 coefficients; use roundtrip()"
            )
        if not hp.supports_u8(h, w, cfg.q_scale, cfg.transform, cfg.q_table):
            c, r = self.roundtrip(image_u8.to(torch.float32), cfg)
            return c.to(torch.int8), r
        return hp.hp_roundtrip_u8(
            image_u8.contiguous(), q_scale=cfg.q_scale, q_table=cfg.q_table,
            retain_k=cfg.retain_k, decode_precision=_decode_prec(cfg),
            transform=cfg.transform,
        )


register(HpApprPipeline())
