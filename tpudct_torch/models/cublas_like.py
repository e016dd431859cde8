"""`cublas`: the per-block, two-GEMM strategy (the slow baseline).

Counterpart of ``tpudct/models/cublas_like.py``, the strategy analog of the
original main_cublass.cu, which loops on the host over every 8x8 block and
issues two cublasSgemm calls each (2,097,152 GEMM launches at 8192^2).  Here
the loop is a Python loop over the blocks with two ``torch.matmul`` calls
each, in float64 (so no TF32 setting reaches them), rounded once to f32
before the quantizer, as the reference's ``lax.scan`` runs one compiled step
per block in sequence.  It exists so that the benchmark sweep can compare
against this schedule; use ``batched``, ``fast`` or ``hp`` for real work.
Hence a cap: at most ``MAX_PIXELS`` (512^2) pixels per call, where its
launches already number in the thousands.
"""

from __future__ import annotations

import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.constants import get_transform
from tpudct_torch.models.base import Pipeline, register
from tpudct_torch.ops.blocks import blockify, deblockify
from tpudct_torch.ops.quant import _q_for
from tpudct_torch.ops.rounding import round_half_away
from tpudct_torch.ops.transform import level_shift, level_unshift

#: The largest image (pixels) the per-block loop takes.
MAX_PIXELS = 512 * 512


def _blocks(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    if h * w > MAX_PIXELS:
        raise ValueError(
            f"the cublas pipeline loops over blocks for comparison only and takes at most "
            f"{MAX_PIXELS} pixels, got {h}x{w}; use 'batched', 'fast' or 'hp'"
        )
    return blockify(x)


def _tables(cfg: CodecConfig, like: torch.Tensor):
    """(T in float64, Q q_scale in f32) on ``like``'s device."""
    t = torch.as_tensor(get_transform(cfg.transform).t, dtype=torch.float64, device=like.device)
    return t, torch.as_tensor(_q_for(cfg.q_scale, cfg.q_table), dtype=torch.float32, device=like.device)


class CublasLikePipeline(Pipeline):
    name = "cublas"

    def dct(self, image, cfg: CodecConfig):
        if cfg.deadzone != 0.5:
            raise ValueError(
                "deadzone quantization rides the hp/batched quantizer; "
                f"pipeline {self.name!r} implements the reference's "
                "round-half-away rule only"
            )
        h, w = image.shape
        xb = _blocks(level_shift(image).to(torch.float32))
        t, q = _tables(cfg, xb)
        out = torch.empty_like(xb)
        for i in range(xb.shape[0]):
            # two chained 8x8 GEMMs per block (main_cublass.cu:234-241)
            y = torch.matmul(torch.matmul(t, xb[i].to(torch.float64)), t.T).to(torch.float32)
            out[i] = round_half_away(y / q)
        return deblockify(out, h, w)

    def idct(self, coeffs, cfg: CodecConfig):
        h, w = coeffs.shape
        cb = _blocks(coeffs.to(torch.float32))
        t, q = _tables(cfg, cb)
        out = torch.empty_like(cb)
        for i in range(cb.shape[0]):
            # mirror of main_cublass.cu:302-309 (transpose order swapped)
            out[i] = torch.matmul(torch.matmul(t.T, (cb[i] * q).to(torch.float64)), t).to(torch.float32)
        return level_unshift(deblockify(out, h, w))


register(CublasLikePipeline())
