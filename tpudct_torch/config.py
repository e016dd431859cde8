"""Runtime configuration: the same frozen dataclass as ``tpudct.config``.

Every field and default is the reference's, so a config built for one
package means the same codec in the other.  Four fields only steer the
Pallas TPU kernels and are inert here: ``interpret``, ``band_rows`` and
``tile_cols`` (a TPU grid geometry; the CUDA kernels map one thread to
one 8x8 block and need no tiling) are accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Configuration for one codec run.

    Attributes:
      transform: 8x8 transform (constants.TRANSFORMS): "haweel" (default),
        "rdct"/"cb2011", "wht", "bas" or "dct" (no integer core: the hp
        kernels run it on the f32-literal core and decode it at "highest").
      q_scale: multiplier applied to the quantization table.
      q_table: "luma" (default), "chroma" or a name from register_q_table.
      retain_k: zonal retention: keep coefficient (u, v) iff u + v < k;
        None keeps all 64.
      deadzone: AC quantizer rounding offset; 0.5 = round-half-away.
        Other values ride the plain einsum quantizer (the fused kernels bake
        the 0.5 rule), exactly as in the reference.
      interpret: inert (Pallas interpreter mode in the reference).
      exact_int_core: the hp forward runs the exact integer Ts X Ts^T core.
        False selects the f32-literal core (T X T^T in f32, true division).
      decode_precision: "butterfly" (default; f32 inverse on the integer
        core with the row norms folded into the dequantization), "highest"
        (f32 inverse on the literal T) or "high" (the reference's bf16x3
        tier; here the "highest" body).
      band_rows, tile_cols: inert (Pallas tile geometry in the reference).
        Not the streamed band height: that is the ``band_rows`` argument
        of ``utils/streaming.py``'s functions and the CLI's
        ``--band-rows``, which are live.
    """

    transform: str = "haweel"
    q_scale: float = 1.0
    q_table: str = "luma"
    retain_k: Optional[int] = None
    deadzone: float = 0.5
    interpret: bool = False
    exact_int_core: bool = True
    decode_precision: str = "butterfly"
    band_rows: Optional[int] = None
    tile_cols: Optional[int] = None
