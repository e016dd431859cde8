"""Meshes of devices: the counterpart of ``tpudct/parallel/mesh.py``.

The reference is single-controller: one process drives every local device
through ``shard_map``.  So is the port: a :class:`Mesh` is a tuple of
``torch.device``s, each one a rank, driven by the calling process.  A device
may repeat, so ``band_mesh(devices=["cuda:0"] * 8)`` gives 8 virtual ranks on
one card and ``["cpu"] * 8`` mirrors the reference's 8-device CPU test mesh;
on a box with several cards the ranks are the cards.  Every rank runs on a
CUDA stream of its own (:func:`rank_streams`).

Left out: ``distributed_init`` (multi-host bring-up; the port's multi-process
form waits for ``torch.distributed``) and ``band_spec``/``grid_spec`` (JAX
partition specs; a ``Sharded`` value names its layout itself).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch

BAND_AXIS = "band"
COL_AXIS = "col"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks over ``shape``: ``(n,)`` for a band mesh (axis BAND_AXIS),
    ``(nb, nc)`` for a grid mesh (BAND_AXIS, COL_AXIS), row-major: rank
    ``b * nc + c`` holds band ``b``, column tile ``c``."""

    devices: tuple
    shape: tuple

    @property
    def axis_names(self) -> tuple:
        return (BAND_AXIS, COL_AXIS)[: len(self.shape)]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"


def _devices(devices: Optional[Sequence]) -> list:
    """The ranks' devices: every CUDA card for None (raises without one);
    else the devices given, all CPU or all CUDA ("cuda" means "cuda:0")."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device: a mesh spans the cards unless devices= names others "
                "(devices=['cpu'] * n runs the plain twins on the CPU)"
            )
        return [torch.device("cuda", i) for i in range(n)]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    kinds = sorted({d.type for d in out})
    if kinds not in (["cpu"], ["cuda"]):
        raise ValueError(f"a mesh's devices are all cpu or all cuda, got {kinds}")
    return out


def band_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the row-band axis (zero halo: 8x8 blocks are
    independent, so bands of whole blocks need no exchange)."""
    devs = _devices(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(tuple(devs), (len(devs),))


def grid_mesh(shape: Optional[Sequence[int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """2-D (band, col) mesh: rows shard over 'band', columns over 'col'.
    Default shape: the most-square factorization of the device count
    (8 -> (4, 2))."""
    devs = _devices(devices)
    if shape is None:
        n = len(devs)
        a = int(n**0.5)
        while n % a:
            a -= 1
        shape = (n // a, a)
    nb, nc = int(shape[0]), int(shape[1])
    if nb * nc > len(devs):
        raise ValueError(f"mesh {nb}x{nc} needs {nb * nc} devices, have {len(devs)}")
    return Mesh(tuple(devs[: nb * nc]), (nb, nc))


@functools.lru_cache(maxsize=16)
def _streams(devices: tuple) -> tuple:
    return tuple(torch.cuda.Stream(device=d) for d in devices)


def rank_streams(mesh: Mesh) -> tuple:
    """One CUDA stream per rank (created at first use, then kept), so
    virtual ranks on one card run as concurrent streams."""
    if not mesh.is_cuda:
        raise ValueError("a CPU mesh has no streams")
    return _streams(mesh.devices)
