"""Ring all-gathers with the decode of each band riding its hop: the
counterpart of ``tpudct/parallel/ring.py``.

A band-sharded value becomes a full copy on every rank in n - 1 hops of a
uni-directional ring.  Per rank r (``n`` ranks, slot d = rows of band d):

  * place: copy its own band into slot r of its replica;
  * hop i = 0 .. n-2: forward slot (r - i) mod n to slot (r - i) mod n of
    rank r + 1's replica (the decode rings also decode that slot into the
    rank's reconstruction in the same launch);
  * the decode rings end by decoding slot (r + 1) mod n, received last.

Each hop is one launch of ``kernels/ring.py`` (B14, B15 or B16).  On a card
every rank runs on its own stream (``mesh.rank_streams``); rank r's hop i
waits on a CUDA event recorded after rank r - 1's hop i - 1 (its placement
for i = 0), which wrote the slot it forwards.  The outputs are allocated on
the callers' streams before the first hop and recorded on the two rank
streams that write each (its own rank's and the left neighbour's); every
rank stream starts after the callers' streams of both cards it writes to,
and each card's caller stream ends after every rank that wrote to it.
Ranks on two cards write through peer pointers, enabled once per pair
(``ring_enable_peer``); where ``torch.cuda.can_device_access_peer`` says
no, the ring raises: it never stages a hop through the host.  On a CPU mesh
the same schedule runs in order on the plain twins.  A ring runs within
one process: on a mesh across processes (``distributed_init``) it raises.

Gates: the reference's interpret-mode gates (gray bands of 8-row multiples
and w % 128; color bands of 16-row multiples and w % 256).  Its VMEM budget,
32-row int8 sublane minimum and column tiles are TPU-only and dropped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudct_torch.kernels import ring as rk
from tpudct_torch.parallel.mesh import Mesh, rank_streams
from tpudct_torch.parallel.sharding import Sharded, _expect, _require_local


@functools.lru_cache(maxsize=None)
def _enable_peer(device: int, peer: int) -> None:
    from tpudct_torch.kernels._build import library

    lib = library()
    err = lib.ring_enable_peer(device, peer)
    if err:
        raise RuntimeError(f"ring: enabling cuda:{device} -> cuda:{peer} access failed: "
                           f"{lib.hp_error_string(err).decode()}")


def enable_peers(mesh: Mesh) -> None:
    """Let every rank's card write to its right neighbour's card; raises
    where the hardware cannot."""
    n = mesh.size
    for r in range(n):
        a, b = mesh.devices[r].index, mesh.devices[(r + 1) % n].index
        if a == b:
            continue
        if not torch.cuda.can_device_access_peer(a, b):
            raise RuntimeError(
                f"ring: cuda:{a} cannot access cuda:{b} (no peer access); the ring "
                "forwards card to card and never stages through the host"
            )
        _enable_peer(a, b)


def _schedule(mesh: Mesh, place, hop, last=None) -> None:
    """Run ``place(r)``, then ``hop(r, slot)`` for hops 0 .. n-2, then
    ``last(r, slot)`` if given, for every rank r, ordered as the module
    docstring says."""
    n = mesh.size
    steps = [lambda r, i=i: hop(r, (r - i) % n) for i in range(n - 1)]
    if last is not None:
        steps.append(lambda r: last(r, (r + 1) % n))
    if not mesh.is_cuda:
        for r in range(n):
            place(r)
        for step in steps:
            for r in range(n):
                step(r)
        return
    enable_peers(mesh)
    streams = rank_streams(mesh)
    # Rank r writes the replicas on its card and on rank r + 1's card, which
    # their cards' caller streams allocated and will read: rank r starts
    # after both callers, and both callers end after rank r.
    cards = [tuple(dict.fromkeys((mesh.devices[r], mesh.devices[(r + 1) % n]))) for r in range(n)]
    callers = {d: torch.cuda.current_stream(d) for d in mesh.devices}
    events = []
    for r, (dev, s) in enumerate(zip(mesh.devices, streams)):
        for d in cards[r]:
            s.wait_stream(callers[d])
        with torch.cuda.device(dev), torch.cuda.stream(s):
            place(r)
            events.append(s.record_event())
    for step in steps:
        done = []
        for r, (dev, s) in enumerate(zip(mesh.devices, streams)):
            s.wait_event(events[(r - 1) % n])
            with torch.cuda.device(dev), torch.cuda.stream(s):
                step(r)
                done.append(s.record_event())
        events = done
    for r, s in enumerate(streams):
        for d in cards[r]:
            callers[d].wait_stream(s)


def _alloc(mesh: Mesh, shape: tuple, dtype: torch.dtype) -> list:
    """One output per rank, on the caller's stream, recorded on the rank
    streams that write it (its own and its left neighbour's)."""
    outs = [torch.empty(shape, dtype=dtype, device=d) for d in mesh.devices]
    if mesh.is_cuda:
        streams = rank_streams(mesh)
        for r, t in enumerate(outs):
            t.record_stream(streams[r])
            t.record_stream(streams[r - 1])
    return outs


def _record_inputs(x: Sharded) -> None:
    if x.mesh.is_cuda:
        for t, s in zip(x.shards, rank_streams(x.mesh)):
            t.record_stream(s)


def _band_rows(x: Sharded, mesh: Mesh) -> int:
    _expect(x, mesh, "band")
    _require_local(mesh, "a ring")
    rows = {s.shape[0] for s in x.shards}
    if len(rows) != 1:
        raise ValueError(f"ring needs equal bands, got band heights {sorted(rows)}")
    return rows.pop()


def _slot(rows: int, t: torch.Tensor, d: int) -> torch.Tensor:
    """Slot d of a replica: its rows [d rows, (d + 1) rows), of every plane
    of a (3, H, W) one."""
    return t[..., d * rows : (d + 1) * rows, :]


def _replicated(mesh: Mesh, outs: list) -> Sharded:
    return Sharded(mesh, "replicated", tuple(outs))


def ring_all_gather(x_sharded: Sharded, mesh: Mesh) -> Sharded:
    """Band-sharded (H, W) value of any dtype -> the whole (H, W) on every
    rank, in n - 1 hops (B14)."""
    br = _band_rows(x_sharded, mesh)
    outs = _alloc(mesh, x_sharded.shape, x_sharded.dtype)
    _record_inputs(x_sharded)
    n = mesh.size
    _schedule(
        mesh,
        place=lambda r: rk.ring_forward(x_sharded.shards[r], _slot(br, outs[r], r)),
        hop=lambda r, d: rk.ring_forward(_slot(br, outs[r], d), _slot(br, outs[(r + 1) % n], d)),
    )
    return _replicated(mesh, outs)


def ring_decode_gather(coeffs_sharded: Sharded, mesh: Mesh, q_scale: float = 1.0,
                       transform: str = "haweel", q_table: str = "luma"):
    """Band-sharded (H, W) int8 coefficients -> (replicated int8
    coefficients, replicated u8 reconstruction), each rank decoding every
    band in the launch that forwards it (B14 placements, then B15).  The
    butterfly tier runs whatever the config's decode_precision, as in the
    reference, so every rank's reconstruction is bit-identical to
    ``hp_decode_u8`` of the gathered map."""
    br = _band_rows(coeffs_sharded, mesh)
    h, w = coeffs_sharded.shape
    n = mesh.size
    if br * n != h or br % 8 or w % 128:
        raise ValueError(
            f"ring decode needs h split into {n} 8-row-multiple bands and w % 128 == 0, got {h}x{w}"
        )
    rk._packed(transform, q_table, float(q_scale))  # a transform without an integer core raises
    crep = _alloc(mesh, (h, w), torch.int8)
    rec = _alloc(mesh, (h, w), torch.uint8)
    _record_inputs(coeffs_sharded)

    def decode(r, d, forward: bool):
        fwd = _slot(br, crep[(r + 1) % n], d) if forward else None
        rk.ring_forward_decode(_slot(br, crep[r], d), fwd, _slot(br, rec[r], d), float(q_scale),
                               q_table, transform)

    _schedule(
        mesh,
        place=lambda r: rk.ring_forward(coeffs_sharded.shards[r], _slot(br, crep[r], r)),
        hop=lambda r, d: decode(r, d, True),
        last=lambda r, d: decode(r, d, False),
    )
    return _replicated(mesh, crep), _replicated(mesh, rec)


def chroma_band_pack(cb, cr, n_bands: int):
    """(H/2, W/2) cb + cr planes -> the (H, W/2) per-band stacked pack the
    color ring shards: rows [d br, d br + br/2) = cb band d, the next br/2
    rows = cr band d (br = luma band rows = 2 chroma band rows).  Arrays
    give an array, tensors a tensor."""
    ch = cb.shape[0]
    if tuple(cb.shape) != tuple(cr.shape) or ch % n_bands:
        raise ValueError(f"chroma planes {tuple(cb.shape)}/{tuple(cr.shape)} don't split into {n_bands} bands")
    half = ch // n_bands
    cat = torch.cat if isinstance(cb, torch.Tensor) else np.concatenate
    return cat([cat([cb[d * half : (d + 1) * half], cr[d * half : (d + 1) * half]], 0)
                for d in range(n_bands)], 0)


def ring_decode_color_gather(y_sharded: Sharded, cpack_sharded: Sharded, mesh: Mesh,
                             q_scale: float = 1.0, transform: str = "haweel"):
    """Band-sharded int8 luma (H, W) + chroma pack (H, W/2) coefficients ->
    (replicated luma, replicated chroma pack, replicated (3, H, W) u8 RGB),
    each rank decoding and merging (4:2:0) every band in the launch that
    forwards it (B14 placements of both planes, then B16).  Build the pack
    with :func:`chroma_band_pack`.  Bit-identical to ``decode_color_u8`` of
    the gathered planes."""
    br = _band_rows(y_sharded, mesh)
    h, w = y_sharded.shape
    if tuple(cpack_sharded.shape) != (h, w // 2):
        raise ValueError(
            f"chroma pack must be ({h}, {w // 2}) for a ({h}, {w}) luma map, got {tuple(cpack_sharded.shape)}"
        )
    _band_rows(cpack_sharded, mesh)
    n = mesh.size
    if br * n != h or br % 16 or w % 256:
        raise ValueError(
            f"color ring decode needs h split into {n} 16-row-multiple bands and w % 256 == 0, got {h}x{w}"
        )
    rk._packed(transform, "luma", float(q_scale))  # a transform without an integer core raises
    yrep = _alloc(mesh, (h, w), torch.int8)
    crep = _alloc(mesh, (h, w // 2), torch.int8)
    rgb = _alloc(mesh, (3, h, w), torch.uint8)
    _record_inputs(y_sharded)
    _record_inputs(cpack_sharded)

    def place(r):
        rk.ring_forward(y_sharded.shards[r], _slot(br, yrep[r], r))
        rk.ring_forward(cpack_sharded.shards[r], _slot(br, crep[r], r))

    def decode(r, d, forward: bool):
        nxt = (r + 1) % n
        fy, fc = (_slot(br, yrep[nxt], d), _slot(br, crep[nxt], d)) if forward else (None, None)
        rk.ring_forward_decode_color(_slot(br, yrep[r], d), _slot(br, crep[r], d), fy, fc,
                                     _slot(br, rgb[r], d), float(q_scale), transform)

    _schedule(mesh, place, hop=lambda r, d: decode(r, d, True), last=lambda r, d: decode(r, d, False))
    return _replicated(mesh, yrep), _replicated(mesh, crep), _replicated(mesh, rgb)
