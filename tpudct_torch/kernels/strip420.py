"""The host side of the 4:2:0 strip body (``csrc/strip420.cuh``) that B16
(``ring.ring_forward_decode_color``) and B20 (``study.color_decode_420_u8``)
run: which compiled integer core decodes a transform, and the constants the
kernels read.

The strip's inverse is add-only: each integer core's Ts is compiled into
the kernel (``core_ts``), one instance per core, so the wrappers hand the
launcher a core id instead of the matrix.  :func:`strip_args` checks once
per configuration, on the host, that the packed inverse ``a`` of
``kernels.hp`` equals the table compiled for that id, and raises where it
does not.
"""

from __future__ import annotations

import functools
import pathlib
import re
import types

import numpy as np

from tpudct_torch.constants import get_transform
from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import hp

#: The integer cores csrc/strip420.cuh is compiled for; a core's id is its
#: index here (the launchers' ``core`` argument).  Aliases (cb2011) resolve
#: through ``get_transform`` to the core they name.
CORES = ("haweel", "rdct", "wht", "bas")

HEADER = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "strip420.cuh"


@functools.cache
def source_tables() -> dict:
    """name -> the 8x8 Ts compiled into the strip, read from ``core_ts`` in
    csrc/strip420.cuh (each table is a ``// name`` line, then its 64
    entries in braces)."""
    text = HEADER.read_text()
    body = text[text.index("constexpr int core_ts("):]
    body = body[: body.index("return ts[core][e];")]
    tables = {}
    for name, entries in re.findall(r"//\s*(\w+)\s*\n\s*\{([^}]*)\}", body):
        table = np.array([int(v) for v in entries.split(",") if v.strip()], np.int64).reshape(8, 8)
        table.setflags(write=False)
        tables[name] = table
    return types.MappingProxyType(tables)


@functools.lru_cache(maxsize=64)
def strip_args(transform: str, q_scale: float, y_q_table: str = "luma", c_q_table: str = "chroma"):
    """(core id, the 137 packed f32 the kernels read as StripConsts: the luma
    and chroma dequantization multipliers, then the color constants).

    Raises as ``kernels.hp`` does for a transform without an integer core
    (the butterfly decode needs one), and where the packed inverse is not
    the table the strip compiled for the transform's core."""
    kl = hp._args(transform, y_q_table, q_scale, None, "butterfly", False)
    kc = hp._args(transform, c_q_table, q_scale, None, "butterfly", False)
    core = get_transform(transform).name
    compiled = source_tables().get(core)
    if core not in CORES or compiled is None or not (np.array_equal(kl.a, compiled) and np.array_equal(kc.a, compiled)):
        raise ValueError(f"the 4:2:0 strip has no compiled inverse for {transform!r}: its Ts is not the table "
                         f"csrc/strip420.cuh compiles for {core!r}")
    packed = np.concatenate([kl.s.ravel(), kc.s.ravel(), ck._consts()]).astype(np.float32)
    packed.setflags(write=False)
    return CORES.index(core), packed
