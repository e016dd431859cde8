"""`fast`: the Haweel integer core as exact integer products (plain torch).

Counterpart of ``tpudct/models/fast_appr.py``, the analog of the original
main_fastAppr.cu.  T factors as ``T = diag(d) Ts`` with ``Ts`` in
{0, +-1, +-2}, so the forward core ``Ts Xb Ts^T`` on level-shifted integer
pixels is an exact integer (|core| <= 12 * 12 * 128 = 18432), and the row
norms fold into one f32 scale ``outer(d, d) / Q`` fused with quantization.
Here the core is contracted in float64, where it is exact and where no TF32
or ``torch.set_float32_matmul_precision`` setting reaches, then scaled and
rounded in f32 as the reference does.  The inverse ``Ts^T (C * outer(d, d)
* Q) Ts + 128`` contracts in float64 and rounds once to f32
(``ops.transform.einsum64``).

The reference's lane-128 block-diagonal branches shape the contraction for
the TPU's matrix unit and give the same values as the per-block form used
here.  No hand-written kernel: the reference runs this pipeline through XLA.
Transforms without an integer core (the exact "dct") and a deadzone other
than 0.5 are refused, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.constants import get_transform
from tpudct_torch.models.base import Pipeline, register
from tpudct_torch.ops.blocks import as_block_grid, from_block_grid
from tpudct_torch.ops.quant import _grid_tile, _q_for
from tpudct_torch.ops.rounding import round_half_away
from tpudct_torch.ops.transform import einsum64, level_unshift


def _core(cfg: CodecConfig):
    """(Ts, d) of the configured transform; refuses one without an integer
    core."""
    tr = get_transform(cfg.transform)
    if not tr.has_integer_core:
        raise ValueError(
            f"transform {tr.name!r} has no integer core; the fast pipeline "
            "requires one (use 'batched' or 'hp')"
        )
    return tr.ts, tr.d


class FastApprPipeline(Pipeline):
    name = "fast"

    def dct(self, image, cfg: CodecConfig):
        if cfg.deadzone != 0.5:
            raise ValueError(
                "deadzone quantization rides the hp/batched quantizer; "
                f"pipeline {self.name!r} implements the reference's "
                "round-half-away rule only"
            )
        ts, d = _core(cfg)
        # the scale math in f32 whatever the input dtype (an integer dtype
        # would zero the fractional row norms)
        x = image.to(torch.float32)
        scale8 = np.outer(d, d) / _q_for(cfg.q_scale, cfg.q_table)
        # level shift and narrow: rint, not trunc (non-integral f32 pixels,
        # such as YCbCr planes, would otherwise bias the pipeline)
        g = torch.round(as_block_grid(x) - 128.0).to(torch.int8)
        tst = torch.as_tensor(ts, dtype=torch.float64, device=x.device)
        core = einsum64("ij,ajbk,lk->aibl", tst, g, tst)  # exact integers
        return from_block_grid(round_half_away(core.to(torch.float32) * _grid_tile(scale8, x)))

    def idct(self, coeffs, cfg: CodecConfig):
        ts, d = _core(cfg)
        c = coeffs.to(torch.float32)  # integer coefficient maps: exact
        scale8 = np.outer(d, d) * _q_for(cfg.q_scale, cfg.q_table)
        g = as_block_grid(c) * _grid_tile(scale8, c)
        tst = torch.as_tensor(ts, dtype=torch.float32, device=c.device)
        return level_unshift(from_block_grid(einsum64("ji,ajbk,kl->aibl", tst, g, tst)))


register(FastApprPipeline())
