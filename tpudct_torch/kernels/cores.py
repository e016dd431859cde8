"""The integer cores compiled into the add-only kernels: B1, B2, B3 and B15
(``csrc/hp_codec.cu``), B7 and, haweel's alone, B22 (``csrc/hp_inverse.cu``),
B19 (``csrc/study.cu``) and the 4:2:0 strip of B16 and B20
(``csrc/strip420.cuh``), all from ``csrc/hp_block.cuh``'s ``core_ts``.

Each integer core's Ts is compiled into those kernels, one instance per
core, so the wrappers hand the launchers a core id instead of the matrix.
:func:`core_id` checks, on the host, that the tables a launch would read
equal the table compiled for that id, and raises where they do not.
"""

from __future__ import annotations

import functools
import pathlib
import re
import types

import numpy as np

from tpudct_torch.constants import get_transform

#: The integer cores csrc/hp_block.cuh is compiled for; a core's id is its
#: index here (the launchers' ``core`` argument).  Aliases (cb2011) resolve
#: through ``get_transform`` to the core they name.
CORES = ("haweel", "rdct", "wht", "bas")

#: The launchers' ``core`` for the dense f32 inverse (hp_block.cuh's kDense).
DENSE = -1

HEADER = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "hp_block.cuh"


@functools.cache
def source_tables() -> dict:
    """name -> the 8x8 Ts compiled into the kernels, read from ``core_ts``
    in csrc/hp_block.cuh (each table is a ``// name`` line, then its 64
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


def core_id(transform: str, *tables: np.ndarray, kernel: str) -> int:
    """The id of the core compiled for ``transform``, once every table in
    ``tables`` (the packed Ts a launch reads) equals it; raises naming
    ``kernel`` where the transform has no compiled core or a table differs."""
    core = get_transform(transform).name
    compiled = source_tables().get(core)
    if core not in CORES or compiled is None or not all(np.array_equal(t, compiled) for t in tables):
        raise ValueError(f"{kernel} has no compiled inverse for {transform!r}: its Ts is not the table "
                         f"csrc/hp_block.cuh compiles for {core!r}")
    return CORES.index(core)
