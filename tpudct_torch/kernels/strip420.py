"""The host side of the 4:2:0 strip body (``csrc/strip420.cuh``) that B16
(``ring.ring_forward_decode_color``) and B20 (``study.color_decode_420_u8``)
run: which compiled integer core decodes a transform, and the constants the
kernels read.

The strip's inverse is add-only: each integer core's Ts is compiled into
the kernel (``core_ts`` in ``csrc/hp_block.cuh``), one instance per core,
so the wrappers hand the launcher a core id instead of the matrix.
:func:`strip_args` checks once per configuration, on the host, that the
packed inverse ``a`` of ``kernels.hp`` equals the table compiled for that
id (``kernels.cores``), and raises where it does not.
"""

from __future__ import annotations

import functools

import numpy as np

from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import cores
from tpudct_torch.kernels import hp


@functools.lru_cache(maxsize=64)
def strip_args(transform: str, q_scale: float, y_q_table: str = "luma", c_q_table: str = "chroma"):
    """(core id, the 137 packed f32 the kernels read as StripConsts: the luma
    and chroma dequantization multipliers, then the color constants).

    Raises as ``kernels.hp`` does for a transform without an integer core
    (the butterfly decode needs one), and where the packed inverse is not
    the table compiled for the transform's core."""
    kl = hp._args(transform, y_q_table, q_scale, None, "butterfly", False)
    kc = hp._args(transform, c_q_table, q_scale, None, "butterfly", False)
    core = cores.core_id(transform, kl.a, kc.a, kernel="the 4:2:0 strip")
    packed = np.concatenate([kl.s.ravel(), kc.s.ravel(), ck._consts()]).astype(np.float32)
    packed.setflags(write=False)
    return core, packed
