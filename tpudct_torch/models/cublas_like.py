"""`cublas`: the per-block, two-GEMM strategy (the slow baseline).

Counterpart of ``tpudct/models/cublas_like.py``, the strategy analog of the
original main_cublass.cu, which loops on the host over every 8x8 block and
issues two cublasSgemm calls each (2,097,152 GEMM launches at 8192^2).  Up
to ``MAX_PIXELS`` (512^2) pixels the loop is a Python loop over the blocks
with two ``torch.matmul`` calls each, as the reference's ``lax.scan`` runs
one compiled step per block in sequence: the schedule the benchmark sweep
compares against.  Above it the same two float64 products run batched over
all (N, 8, 8) blocks at once (``t @ xb @ t.T``), since a Python loop over
millions of blocks takes minutes.  Either way the products are float64 (so
no TF32 setting reaches them), rounded once to f32 before the quantizer.
Use ``batched``, ``fast`` or ``hp`` for real work.
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

#: The largest image (pixels) that runs the per-block loop; larger ones run
#: the same products batched over the blocks.
MAX_PIXELS = 512 * 512


def _per_block(fn, xb: torch.Tensor) -> torch.Tensor:
    """fn (float64 (..., 8, 8) -> f32) over the (N, 8, 8) blocks: one block
    at a time up to MAX_PIXELS pixels, else all at once."""
    if xb.shape[0] * 64 > MAX_PIXELS:
        return fn(xb.to(torch.float64))
    out = torch.empty_like(xb)
    for i in range(xb.shape[0]):
        out[i] = fn(xb[i].to(torch.float64))
    return out


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
        xb = blockify(level_shift(image).to(torch.float32))
        t, q = _tables(cfg, xb)

        def step(b):  # two chained 8x8 GEMMs per block (main_cublass.cu:234-241)
            return round_half_away(torch.matmul(torch.matmul(t, b), t.T).to(torch.float32) / q)

        return deblockify(_per_block(step, xb), h, w)

    def idct(self, coeffs, cfg: CodecConfig):
        h, w = coeffs.shape
        cb = blockify(coeffs.to(torch.float32))
        t, q = _tables(cfg, cb)

        def step(b):  # mirror of main_cublass.cu:302-309 (transpose order swapped)
            return torch.matmul(torch.matmul(t.T, b), t).to(torch.float32)

        return level_unshift(deblockify(_per_block(step, cb * q), h, w))


register(CublasLikePipeline())
