"""Core functional ops on tensors: blocking, transforms, quantization, rounding."""

from tpudct_torch.ops.rounding import round_half_away
from tpudct_torch.ops.blocks import blockify, deblockify, num_blocks
from tpudct_torch.ops.transform import level_shift, level_unshift, dct2_blocks, idct2_blocks, to_uint8
from tpudct_torch.ops.quant import quantize, dequantize, retention_mask, apply_retention

__all__ = [
    "round_half_away",
    "blockify",
    "deblockify",
    "num_blocks",
    "level_shift",
    "level_unshift",
    "dct2_blocks",
    "idct2_blocks",
    "to_uint8",
    "quantize",
    "dequantize",
    "retention_mask",
    "apply_retention",
]
