"""Meshes of devices and multi-process bring-up: the counterpart of
``tpudct/parallel/mesh.py``.

A :class:`Mesh` is a tuple of ``torch.device``s, each one a rank.  A device
may repeat, so ``band_mesh(devices=["cuda:0"] * 8)`` gives 8 virtual ranks on
one card and ``["cpu"] * 8`` mirrors the reference's 8-device CPU test mesh;
on a box with several cards the ranks are the cards.  Every rank runs on a
CUDA stream of its own (:func:`rank_streams`).

In one process (the default) the calling process drives every rank, as the
reference's single controller drives every local device.  After
:func:`distributed_init`, as after the reference's
``jax.distributed.initialize``, a mesh spans the ranks of every process:
each process names its own devices (its cards, or the ``devices=`` it
passes), building a mesh becomes a collective (every process builds the
same meshes in the same order), the ranks follow the process order, and
``Mesh.processes`` says which process owns each rank.  A process drives
only its own ranks (``Mesh.local_ranks``).

Left out: ``band_spec``/``grid_spec`` (JAX partition specs; a ``Sharded``
value names its layout itself).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
from typing import Optional, Sequence

import torch

BAND_AXIS = "band"
COL_AXIS = "col"

# this process's place in the cluster once distributed_init has run:
# {"process_id", "num_processes", "local_device_ids"}; empty in one process
_CLUSTER: dict = {}
_INIT_KEYS = frozenset({"num_processes", "process_id", "local_device_ids", "timeout"})


def distributed_init(coordinator: Optional[str] = None, **kw) -> None:
    """Multi-process bring-up over ``torch.distributed`` (the reference's
    ``jax.distributed.initialize`` contract).

    ``coordinator`` is the ``host:port`` of a TCP rendezvous that process 0
    serves; ``num_processes`` and ``process_id`` place this process;
    ``local_device_ids`` are the cards it drives (default: every visible
    card); ``timeout`` bounds the rendezvous and every collective, in
    seconds (default 300).  The process group is gloo's over host tensors:
    every value that crosses processes here is host data (the metrics'
    partial sums, :func:`~tpudct_torch.parallel.sharding.gather`'s host
    slabs, the sharded saves' compressed segments), so one backend serves
    the CPU and the card alike, and several processes may share one card
    (NCCL refuses two ranks on one device).

    A second call is a no-op.  A bare call reads a launcher's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) and is a
    no-op on a single process.  An explicit cluster request that fails
    raises: a silent single-process fallback would run N divergent jobs.
    """
    import torch.distributed as dist

    if _CLUSTER or dist.is_initialized():
        return  # double init: harmless
    unknown = set(kw) - _INIT_KEYS
    if unknown:
        raise TypeError(f"distributed_init got unexpected keywords {sorted(unknown)}")
    timeout = datetime.timedelta(seconds=float(kw.get("timeout", 300)))
    ids = kw.get("local_device_ids")
    if coordinator is None and not (set(kw) & {"num_processes", "process_id"}):
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return  # a bare call on a single process
        n, pid, method = world, int(os.environ.get("RANK", "0")), "env://"
    else:
        if coordinator is None or "num_processes" not in kw or "process_id" not in kw:
            raise ValueError("distributed_init needs coordinator='host:port', num_processes and process_id")
        n, pid = int(kw["num_processes"]), int(kw["process_id"])
        if not 0 <= pid < n:
            raise ValueError(f"process_id {pid} is outside 0..{n - 1}")
        method = f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=method, world_size=n, rank=pid, timeout=timeout)
    _CLUSTER.update(process_id=pid, num_processes=n,
                    local_device_ids=None if ids is None else tuple(int(i) for i in ids))


def process_index() -> int:
    """This process's index in the cluster (0 without one)."""
    return _CLUSTER.get("process_id", 0)


def process_count() -> int:
    """The cluster's process count (1 without one)."""
    return _CLUSTER.get("num_processes", 1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks over ``shape``: ``(n,)`` for a band mesh (axis BAND_AXIS),
    ``(nb, nc)`` for a grid mesh (BAND_AXIS, COL_AXIS), row-major: rank
    ``b * nc + c`` holds band ``b``, column tile ``c``.  ``processes`` is
    each rank's owning process after :func:`distributed_init` (empty where
    one process owns every rank)."""

    devices: tuple
    shape: tuple
    processes: tuple = ()

    @property
    def axis_names(self) -> tuple:
        return (BAND_AXIS, COL_AXIS)[: len(self.shape)]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    @property
    def local_ranks(self) -> tuple:
        """The ranks this process drives, in rank order."""
        if not self.processes:
            return tuple(range(self.size))
        me = process_index()
        return tuple(r for r, p in enumerate(self.processes) if p == me)

    @property
    def is_fully_addressable(self) -> bool:
        """This process drives every rank."""
        return len(self.local_ranks) == self.size

    @property
    def local_devices(self) -> tuple:
        return tuple(self.devices[r] for r in self.local_ranks)


def _devices(devices: Optional[Sequence]) -> list:
    """This process's devices: for None its cards (``distributed_init``'s
    ``local_device_ids``, else every CUDA card; raises without one); else
    the devices given, all CPU or all CUDA ("cuda" means "cuda:0")."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device: a mesh spans the cards unless devices= names others "
                "(devices=['cpu'] * n runs the plain twins on the CPU)"
            )
        ids = _CLUSTER.get("local_device_ids")
        return [torch.device("cuda", i) for i in (range(n) if ids is None else ids)]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    _one_kind(out)
    return out


def _one_kind(devs) -> None:
    kinds = sorted({d.type for d in devs})
    if kinds not in (["cpu"], ["cuda"]):
        raise ValueError(f"a mesh's devices are all cpu or all cuda, got {kinds}")


def _cluster_devices(devices: Optional[Sequence]) -> tuple:
    """(devices, owning processes) of every rank: this process's devices
    alone in one process; after distributed_init every process's, in
    process order (a collective: each process sends its device names)."""
    devs = _devices(devices)
    if not _CLUSTER:
        return devs, ()
    import torch.distributed as dist

    names = [None] * process_count()
    dist.all_gather_object(names, [str(d) for d in devs])
    devs = [torch.device(d) for ds in names for d in ds]
    _one_kind(devs)
    return devs, tuple(p for p, ds in enumerate(names) for _ in ds)


def _mesh(devs: list, owners: tuple, shape: tuple) -> Mesh:
    n = len(devs)
    owners = owners[:n]
    if owners and process_index() not in owners:
        raise ValueError(f"a {n}-rank mesh leaves process {process_index()} without a rank")
    return Mesh(tuple(devs[:n]), shape, owners)


def band_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the row-band axis (zero halo: 8x8 blocks are
    independent, so bands of whole blocks need no exchange)."""
    devs, owners = _cluster_devices(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    return _mesh(devs, owners, (len(devs),))


def grid_mesh(shape: Optional[Sequence[int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """2-D (band, col) mesh: rows shard over 'band', columns over 'col'.
    Default shape: the most-square factorization of the device count
    (8 -> (4, 2)).  The ranks are band-major, so a process owning whole
    bands holds a contiguous block of rows."""
    devs, owners = _cluster_devices(devices)
    if shape is None:
        n = len(devs)
        a = int(n**0.5)
        while n % a:
            a -= 1
        shape = (n // a, a)
    nb, nc = int(shape[0]), int(shape[1])
    if nb * nc > len(devs):
        raise ValueError(f"mesh {nb}x{nc} needs {nb * nc} devices, have {len(devs)}")
    return _mesh(devs[: nb * nc], owners, (nb, nc))


@functools.lru_cache(maxsize=16)
def _streams(devices: tuple) -> tuple:
    return tuple(torch.cuda.Stream(device=d) for d in devices)


def rank_streams(mesh: Mesh) -> tuple:
    """One CUDA stream per rank this process drives (created at first use,
    then kept), so virtual ranks on one card run as concurrent streams.
    Ranks that share a device still get streams of their own."""
    if not mesh.is_cuda:
        raise ValueError("a CPU mesh has no streams")
    return _streams(mesh.local_devices)
