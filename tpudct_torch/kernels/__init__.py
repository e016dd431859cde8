"""Hand-written CUDA kernels for Hopper, each with a plain torch twin."""

from tpudct_torch.kernels.hp import (
    hp_dct,
    hp_decode_u8,
    hp_encode_u8,
    hp_idct,
    hp_roundtrip,
    hp_roundtrip_u8,
    hp_scaled_decode_u8,
    supports,
    supports_scaled_u8,
    supports_u8,
)

__all__ = [
    "hp_roundtrip",
    "hp_dct",
    "hp_idct",
    "hp_encode_u8",
    "hp_decode_u8",
    "hp_roundtrip_u8",
    "hp_scaled_decode_u8",
    "supports",
    "supports_u8",
    "supports_scaled_u8",
]
