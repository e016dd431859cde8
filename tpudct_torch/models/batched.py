"""`batched` (alias `cublas2`): one whole-image contraction per transform.

Plain torch: level shift, the (H/8, 8, W/8, 8) einsum with the 8x8 T, and
the quantizer, with no hand-written kernel — the reference runs this
pipeline through XLA.  It is also the fallback the hp pipeline takes where
its kernels do not apply, exactly as in the reference.
"""

from __future__ import annotations

from tpudct_torch.config import CodecConfig
from tpudct_torch.models.base import Pipeline, register
from tpudct_torch.ops.quant import dequantize, quantize
from tpudct_torch.ops.transform import dct2_blocks, idct2_blocks, level_shift, level_unshift


class BatchedPipeline(Pipeline):
    name = "batched"

    def dct(self, image, cfg: CodecConfig):
        return quantize(
            dct2_blocks(level_shift(image), transform=cfg.transform),
            cfg.q_scale, cfg.q_table, deadzone=cfg.deadzone,
        )

    def idct(self, coeffs, cfg: CodecConfig):
        return level_unshift(
            idct2_blocks(
                dequantize(coeffs, cfg.q_scale, cfg.q_table), transform=cfg.transform
            )
        )


register(BatchedPipeline(), "cublas2")
