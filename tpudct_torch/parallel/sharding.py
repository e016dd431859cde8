"""Sharded codec execution: the counterpart of ``tpudct/parallel/sharding.py``.

Each rank of a :class:`~tpudct_torch.parallel.mesh.Mesh` owns a contiguous
band of image rows (a multiple of 8, so whole blocks: zero halo), or a tile
of a (band, col) grid, or a slab of a batch.  A :class:`Sharded` value holds
one tensor per rank, on that rank's device.  Per rank, a step runs the
port's own single-device pipeline on that rank's device and CUDA stream (the
hp kernels where the reference's gates allow, the batched fallback where a
band or tile is narrower than 128), as the reference's ``shard_map`` runs
its band functions; the only collectives are

  * metrics: per-rank f32 partial sums, added on the first rank's device
    (the image is never gathered to compute quality);
  * reassembly: :func:`gather` to the host, or ``gather_recon``'s ring
    all-gather (``tpudct_torch.parallel.ring``) to every rank.

Each step factory returns a plain function of ``Sharded`` values.
:func:`save_sharded` and :func:`save_color_sharded` serialize band-sharded
coefficient maps without gathering them: each rank's slab entropy-codes into
its own banded segment.

After :func:`~tpudct_torch.parallel.mesh.distributed_init` a mesh may span
several processes.  Then, as in the reference's multi-host branches, each
process passes its own slab of the global input to the ``shard_*``
functions (a contiguous block of rows: its ranks' bands), a ``Sharded``
holds that process's shards alone (``is_fully_addressable`` is False), and
three things cross processes, all host data over the gloo group: the
metrics' per-rank partial sums (all-gathered, then added in rank order on
every process, so the sums are the single process's), :func:`gather`'s host
slabs, and the sharded saves' compressed segments (every process assembles
the file, process 0 writes it).  The rings stay within one process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.models.base import Pipeline
from tpudct_torch.parallel.mesh import Mesh, process_count, process_index, rank_streams
from tpudct_torch.utils import color as _color

#: layout -> (row axis, column axis or None) of the global array
_AXES = {
    "band": (0, None),      # (H, W) row bands
    "grid": (0, 1),         # (H, W) tiles of a (band, col) mesh
    "rgb-band": (1, None),  # (3, H, W) planar RGB row bands
    "rgb-grid": (1, 2),     # (3, H, W) planar RGB tiles
    "batch": (0, None),     # (B, H, W) slabs of B / n images
}


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A global array as one tensor per rank this process drives
    (``shards[i]`` on ``mesh.devices[mesh.local_ranks[i]]``; every rank in
    one process), laid out by ``spec``: a key of ``_AXES``, or "replicated"
    (every rank holds the whole array)."""

    mesh: Mesh
    spec: str
    shards: tuple

    @property
    def is_fully_addressable(self) -> bool:
        """This process holds every shard."""
        return self.mesh.is_fully_addressable

    @property
    def shape(self) -> tuple:
        """The global shape (across processes: every rank's shard has the
        shape of this process's first)."""
        if self.spec == "replicated":
            return tuple(self.shards[0].shape)
        row_ax, col_ax = _AXES[self.spec]
        nb, nc = _mesh_shape(self.mesh, self.spec)
        shape = list(self.shards[0].shape)
        if not self.is_fully_addressable:
            shape[row_ax] *= nb
            if col_ax is not None:
                shape[col_ax] *= nc
            return tuple(shape)
        shape[row_ax] = sum(s.shape[row_ax] for s in self.shards[::nc])
        if col_ax is not None:
            shape[col_ax] = sum(s.shape[col_ax] for s in self.shards[:nc])
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


def _mesh_shape(mesh: Mesh, spec: str) -> tuple:
    """(bands, column tiles) of ``mesh`` for the layout ``spec``; raises
    where the mesh has the other rank (a band layout on a grid mesh)."""
    grid = _AXES[spec][1] is not None
    if len(mesh.shape) != (2 if grid else 1):
        raise ValueError(f"{spec} sharding needs a {2 if grid else 1}-D mesh, got shape {mesh.shape}")
    return mesh.shape[0], (mesh.shape[1] if grid else 1)


def _local_bands(mesh: Mesh, spec: str) -> tuple:
    """(first band, band count) of this process's ranks under ``spec``;
    raises unless they are whole bands in a row."""
    nb, nc = _mesh_shape(mesh, spec)
    local = mesh.local_ranks
    b0, n = local[0] // nc, len(local) // nc
    if local[0] % nc or len(local) % nc or local != tuple(range(b0 * nc, (b0 + n) * nc)):
        raise ValueError(f"process {process_index()}'s ranks {local} are not whole bands of the "
                         f"{nb}x{nc} mesh")
    return b0, n


def _global_shape(x, mesh: Mesh, spec: str) -> tuple:
    """The global shape of which ``x`` is this process's slab (``x`` itself
    where this process drives every rank)."""
    shape = list(x.shape)
    if not mesh.is_fully_addressable:
        row_ax = _AXES[spec][0]
        _b0, n = _local_bands(mesh, spec)
        if shape[row_ax] % n:
            raise ValueError(f"a process slab of {shape[row_ax]} rows does not split into its {n} bands")
        shape[row_ax] = shape[row_ax] // n * _mesh_shape(mesh, spec)[0]
    return tuple(shape)


def _place(x, mesh: Mesh, spec: str) -> Sharded:
    """Cut ``x`` (a tensor or an array: the global array, or this process's
    slab of it on a mesh across processes) by ``spec`` and put each piece
    on its rank's device (a view where it is there already)."""
    row_ax, col_ax = _AXES[spec]
    nb, nc = _mesh_shape(mesh, spec)
    b0, n_bands = _local_bands(mesh, spec)
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.require(x, requirements="W"))
    rows = t.shape[row_ax] // n_bands
    shards = []
    for r in mesh.local_ranks:
        b, c = divmod(r, nc)
        piece = t.narrow(row_ax, (b - b0) * rows, rows)
        if col_ax is not None:
            cols = t.shape[col_ax] // nc
            piece = piece.narrow(col_ax, c * cols, cols)
        shards.append(piece.to(mesh.devices[r]).contiguous())
    return Sharded(mesh, spec, tuple(shards))


def shard_image(x, mesh: Mesh) -> Sharded:
    """Place an (H, W) image as row bands across the mesh.  On a mesh across
    processes ``x`` is this process's slab, and the global height is
    checked."""
    n, h = _mesh_shape(mesh, "band")[0], _global_shape(x, mesh, "band")[0]
    if (h // n) % 8 or h % n:
        raise ValueError(f"height {h} must split into {n} bands of 8-row multiples")
    return _place(x, mesh, "band")


def shard_image_grid(x, mesh: Mesh) -> Sharded:
    """Place an (H, W) image as a 2-D tile grid across a (band, col) mesh
    (across processes: this process's block of rows, as
    :func:`shard_image`)."""
    nb, nc = _mesh_shape(mesh, "grid")
    h, w = _global_shape(x, mesh, "grid")
    if h % nb or (h // nb) % 8:
        raise ValueError(f"height {h} must split into {nb} bands of 8-row multiples")
    if w % nc or (w // nc) % 8:
        raise ValueError(f"width {w} must split into {nc} tiles of 8-col multiples")
    return _place(x, mesh, "grid")


def shard_rgb(x, mesh: Mesh) -> Sharded:
    """Place a (3, H, W) planar u8 RGB image as row bands (across
    processes: this process's slab, as :func:`shard_image`).  Per-band
    heights must be multiples of 16 so the 4:2:0 chroma planes land on
    whole 8-row blocks (band-local pooling halves the rows)."""
    n = _mesh_shape(mesh, "rgb-band")[0]
    _c, h, w = _global_shape(x, mesh, "rgb-band")
    if h % n or (h // n) % 16:
        raise ValueError(
            f"height {h} must split into {n} bands of 16-row multiples "
            "(4:2:0 chroma needs whole 8-row blocks per band)"
        )
    if w % 16:
        raise ValueError(f"width {w} must be a multiple of 16 (chroma blocks)")
    return _place(x, mesh, "rgb-band")


def shard_rgb_grid(x, mesh: Mesh) -> Sharded:
    """Place a (3, H, W) planar u8 RGB image as a 2-D tile grid: 4:2:0
    pooling is 2x2-local, so tiles need 16-row AND 16-col alignment (across
    processes: this process's block of rows)."""
    nb, nc = _mesh_shape(mesh, "rgb-grid")
    _c, h, w = _global_shape(x, mesh, "rgb-grid")
    if h % nb or (h // nb) % 16:
        raise ValueError(f"height {h} must split into {nb} bands of 16-row multiples")
    if w % nc or (w // nc) % 16:
        raise ValueError(f"width {w} must split into {nc} tiles of 16-col multiples")
    return _place(x, mesh, "rgb-grid")


def shard_batch(x, mesh: Mesh) -> Sharded:
    """Place a (B, H, W) batch with B/n images per rank (across processes:
    this process's slab of the batch; the global batch is checked)."""
    n, b = _mesh_shape(mesh, "batch")[0], _global_shape(x, mesh, "batch")[0]
    if b % n:
        raise ValueError(f"batch of {b} images must split across {n} devices")
    return _place(x, mesh, "batch")


def gather(x: Sharded) -> np.ndarray:
    """Reassemble a sharded value on the host (output path only); a
    replicated one is its first rank's copy.  Across processes every
    process's host slab is all-gathered (a collective: every process calls
    it) and every process returns the whole array."""
    if x.spec == "replicated":
        return x.shards[0].cpu().numpy()
    row_ax, col_ax = _AXES[x.spec]
    host = [s.cpu() for s in x.shards]
    if col_ax is not None:
        nc = x.mesh.shape[1]
        host = [torch.cat(host[b * nc : (b + 1) * nc], col_ax) for b in range(len(host) // nc)]
    local = torch.cat(host, row_ax).numpy()
    if x.is_fully_addressable:
        return local
    nc = _mesh_shape(x.mesh, x.spec)[1]
    band_rows = x.shards[0].shape[row_ax]
    slabs = []
    for p, blob in enumerate(_allgather_bytes(np.ascontiguousarray(local).tobytes())):
        shape = list(local.shape)
        shape[row_ax] = x.mesh.processes.count(p) // nc * band_rows
        slabs.append(np.frombuffer(blob, local.dtype).reshape(shape))
    return np.concatenate(slabs, row_ax)


def _allgather_bytes(local: bytes) -> list:
    """Every process's ``local`` bytes, in process order, over the gloo
    group: the lengths first, then the buffers padded to the longest (the
    reference's two ``process_allgather`` calls).  A collective."""
    import torch.distributed as dist

    n = process_count()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(local)], dtype=torch.int64))
    lens = [int(t) for t in lens]
    buf = torch.zeros(max(lens), dtype=torch.uint8)
    buf[: len(local)] = torch.frombuffer(bytearray(local), dtype=torch.uint8) if local else buf[:0]
    bufs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(bufs, buf)
    return [b[:k].numpy().tobytes() for b, k in zip(bufs, lens)]


def _require_local(mesh: Mesh, what: str) -> None:
    if not mesh.is_fully_addressable:
        raise ValueError(f"{what} runs within one process; this mesh spans "
                         f"{len(set(mesh.processes))} processes")


# ---- running a function on every rank -----------------------------------------


def _tensors(res):
    for v in res:
        yield from (v.values() if isinstance(v, dict) else (v,))


def _run(mesh: Mesh, fn, *inputs: Sharded) -> list:
    """``fn(*rank_shards)`` for every rank this process drives, on its
    device and, on a card, its own stream: each rank stream first waits for
    the caller's stream, and the caller's stream then waits for every rank
    stream, so the results are ready where the caller reads them.  Tensors
    that cross streams are recorded on the stream that reads them (the
    caching allocator reuses their memory only after it).  Returns fn's
    results (tuples of tensors and dicts of tensors), one per rank."""
    args = [tuple(x.shards[i] for x in inputs) for i in range(len(mesh.local_ranks))]
    if not mesh.is_cuda:
        return [fn(*a) for a in args]
    out = []
    for dev, s, a in zip(mesh.local_devices, rank_streams(mesh), args):
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(s):
            for t in a:
                t.record_stream(s)
            out.append(fn(*a))
    for dev, s, res in zip(mesh.local_devices, rank_streams(mesh), out):
        caller = torch.cuda.current_stream(dev)
        caller.wait_stream(s)
        for t in _tensors(res):
            t.record_stream(caller)
    return out


def _collect(mesh: Mesh, spec: str, out: list, i: int) -> Sharded:
    return Sharded(mesh, spec, tuple(res[i] for res in out))


def _expect(xs, mesh: Mesh, spec: str) -> None:
    if not isinstance(xs, Sharded) or xs.spec != spec or xs.mesh != mesh:
        got = f"{xs.spec!r} on {xs.mesh}" if isinstance(xs, Sharded) else type(xs).__name__
        raise ValueError(f"expects a {spec!r}-sharded value on {mesh}, got {got}")


# ---- distributed metrics --------------------------------------------------------


def _partials(xf, rf, coeffs=None, images=None) -> dict:
    """One rank's f32 partial sums for :func:`_psum_metrics`."""
    d = xf - rf
    p = {"err": (d * d).sum(), "count": torch.full((), float(xf.numel()), device=xf.device)}
    if coeffs is not None:
        p["energy"] = (xf * xf).sum()
        p["nonzero"] = (coeffs != 0).sum().to(torch.float32)
    if images is not None:
        p["images"] = torch.full((), float(images), device=xf.device)
    return p


def _psum_metrics(parts: list, mesh: Mesh) -> dict:
    """Distributed quality metrics from the ranks' partial sums, added in
    rank order on this process's first device: mse and psnr_db; peen_pct
    and nonzero_frac where the partials hold coefficients; images where
    they hold a batch.  Across processes the partials are all-gathered
    first, so every process adds the same values in the same order as one
    process would."""
    device = mesh.local_devices[0]
    if not mesh.is_fully_addressable:
        parts = _allgather_partials(parts, mesh)
    tot = {k: parts[0][k].to(device) for k in parts[0]}
    for p in parts[1:]:
        for k in tot:
            tot[k] = tot[k] + p[k].to(device)
    mse = tot["err"] / tot["count"]
    # clamp the MEAN (not the sum): the perfect-reconstruction cap then agrees
    # with the single-device psnr regardless of image size
    m = {"mse": mse, "psnr_db": 10.0 * torch.log10(255.0**2 / torch.clamp(mse, min=1e-30))}
    if "energy" in tot:
        m["peen_pct"] = 100.0 * tot["err"] / tot["energy"]
        m["nonzero_frac"] = tot["nonzero"] / tot["count"]
    if "images" in tot:
        m["images"] = tot["images"]
    return m


def _allgather_partials(parts: list, mesh: Mesh) -> list:
    """Every rank's partials, in rank order, on the host: each process sends
    its ranks' f32 values as one (ranks, keys) tensor, padded to the most
    ranks any process holds."""
    import torch.distributed as dist

    keys = list(parts[0])
    local = torch.stack([torch.stack([p[k].to(torch.float32).reshape(()).cpu() for k in keys]) for p in parts])
    most = max(mesh.processes.count(p) for p in set(mesh.processes))
    pad = torch.zeros(most, len(keys), dtype=torch.float32)
    pad[: len(parts)] = local
    bufs = [torch.empty_like(pad) for _ in range(process_count())]
    dist.all_gather(bufs, pad)
    out = []
    for p, buf in enumerate(bufs):
        out.extend(dict(zip(keys, row)) for row in buf[: mesh.processes.count(p)])
    return out


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# ---- gray steps ---------------------------------------------------------------------


def sharded_roundtrip(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh):
    """Band-parallel codec pass: band-sharded image -> (coefficients,
    reconstruction), both left band-sharded (no gather inside)."""

    def fn(xs: Sharded):
        _expect(xs, mesh, "band")
        out = _run(mesh, lambda x: pipeline.roundtrip(x, cfg), xs)
        return _collect(mesh, "band", out, 0), _collect(mesh, "band", out, 1)

    return fn


def _codec_step(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh, spec: str):
    def rank(x):
        c, r = pipeline.roundtrip(x, cfg)
        return c, r, _partials(_f32(x), _f32(r), coeffs=c)

    def fn(xs: Sharded):
        _expect(xs, mesh, spec)
        out = _run(mesh, rank, xs)
        metrics = _psum_metrics([res[2] for res in out], mesh)
        return (_collect(mesh, spec, out, 0), _collect(mesh, spec, out, 1)), metrics

    return fn


def sharded_codec_step(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh):
    """The full distributed step (``dryrun_multichip``'s): band-local encode
    + decode and distributed quality metrics.  Returns ((coeffs, recon)
    band-sharded, metrics on the first rank's device)."""
    return _codec_step(pipeline, cfg, mesh, "band")


def sharded_codec_step_grid(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh):
    """Grid-mesh variant of :func:`sharded_codec_step`: tile-local encode +
    decode, metrics over every tile.  Tiles narrower than 128 take the hp
    pipeline's batched fallback."""
    return _codec_step(pipeline, cfg, mesh, "grid")


def gather_recon(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh):
    """:func:`sharded_roundtrip` whose reconstruction is all-gathered to
    every rank by the ring (``ring_all_gather``).  Returns (coeffs
    band-sharded, recon replicated)."""
    from tpudct_torch.parallel.ring import ring_all_gather

    step = sharded_roundtrip(pipeline, cfg, mesh)

    def fn(xs: Sharded):
        c, r = step(xs)
        return c, ring_all_gather(r, mesh)

    return fn


def sharded_idct(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh):
    """Band-parallel inverse transform alone: band-sharded coefficients ->
    band-sharded float reconstruction (the decode half that progressive
    decode composes with: zeroed planes are just coefficients)."""

    def fn(cs: Sharded):
        _expect(cs, mesh, "band")
        return _collect(mesh, "band", _run(mesh, lambda c: (pipeline.idct(c, cfg),), cs), 0)

    return fn


def sharded_scaled_decode(cfg: CodecConfig, mesh: Mesh, factor: int, f_cols: "int | None" = None):
    """Band-parallel fractional-scale decode (``ops/scaled.py``'s plain
    basis): band-sharded (H, W) coefficients -> band-sharded (H/f, W/fc)
    float raster.  The basis is block-local, so bands scale with zero
    halo; every band height divides by 8 (``shard_image``'s contract)."""
    from tpudct_torch.ops.scaled import scaled_decode

    def fn(cs: Sharded):
        _expect(cs, mesh, "band")
        out = _run(mesh, lambda c: (scaled_decode(c, cfg, factor, f_cols),), cs)
        return _collect(mesh, "band", out, 0)

    return fn


# ---- color steps --------------------------------------------------------------------


def _color_tables(cfg: CodecConfig) -> tuple:
    return dataclasses.replace(cfg, q_table="luma"), dataclasses.replace(cfg, q_table="chroma")


def _color_step(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh, spec: str):
    lcfg, ccfg = _color_tables(cfg)

    def rank(x):  # (3, hb, wb) u8
        y, cb, cr = _color.ycbcr_split_420_u8(x)
        _cy, ry = pipeline.roundtrip(_f32(y), lcfg)
        _cc, rc = pipeline.roundtrip(_f32(torch.cat([cb, cr], dim=0)), ccfg)
        ph = cb.shape[0]
        hb, wb = y.shape
        rgb = _color.ycbcr_merge_420_u8(ry, rc[:ph], rc[ph:], hb, wb)
        return rgb, _partials(_f32(x), _f32(rgb))

    def fn(xs: Sharded):
        _expect(xs, mesh, spec)
        out = _run(mesh, rank, xs)
        return _collect(mesh, spec, out, 0), _psum_metrics([res[1] for res in out], mesh)

    return fn


def sharded_color_step(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh):
    """Distributed color codec pass.  Per band: YCbCr split + 4:2:0 (the
    plain ``utils/color`` functions; 2x2 pooling is band-local), luma
    against Q and the stacked chroma against QC through the same per-band
    pipeline, merge back to planar RGB.  Returns ((3, H, W) u8 recon
    band-sharded, RGB metrics)."""
    return _color_step(pipeline, cfg, mesh, "rgb-band")


def sharded_color_step_grid(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh):
    """Grid-mesh variant of :func:`sharded_color_step` (zero halo in both
    dimensions: blocks and 2x2 chroma pools are local to 16-aligned tiles)."""
    return _color_step(pipeline, cfg, mesh, "rgb-grid")


def sharded_color_encode(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh):
    """Distributed color encode: band-sharded (3, H, W) u8 RGB -> (y, cb, cr)
    coefficient planes, each band-sharded.  Returns (fn, meta_fn), where
    ``meta_fn(h, w)`` builds the color meta of the global shape."""
    lcfg, ccfg = _color_tables(cfg)

    def rank(x):  # (3, hb, w) u8
        y, cb, cr = _color.ycbcr_split_420_u8(x)
        cy = pipeline.encode(_f32(y), lcfg)
        cc = pipeline.encode(_f32(torch.cat([cb, cr], dim=0)), ccfg)
        ph = cb.shape[0]
        return cy, cc[:ph], cc[ph:]

    def fn(xs: Sharded):
        _expect(xs, mesh, "rgb-band")
        out = _run(mesh, rank, xs)
        return tuple(_collect(mesh, "band", out, i) for i in range(3))

    def meta_fn(h: int, w: int) -> dict:
        return {"orig_shape": (h, w), "chroma_shape": (h // 2, w // 2), "subsample": "420"}

    return fn, meta_fn


# ---- serving ----------------------------------------------------------------------


def sharded_serving_step(pipeline: Pipeline, cfg: CodecConfig, mesh: Mesh):
    """Serving-tier data parallelism: a (B, H, W) u8 batch sharded over the
    mesh, each rank running its images through one fused u8 launch (the
    slab folded into one tall image), with batch-wide metrics.  Returns
    ((coeffs, recon) batch-sharded, metrics)."""
    if not hasattr(pipeline, "roundtrip_u8"):
        raise ValueError(f"serving step needs a u8-native pipeline (hp), got {pipeline.name!r}")

    def rank(xb):  # (B/n, H, W) u8
        b, h, w = xb.shape
        tall = xb.reshape(b * h, w)
        c, r = pipeline.roundtrip_u8(tall, cfg)
        return c.reshape(b, h, w), r.reshape(b, h, w), _partials(_f32(tall), _f32(r), images=b)

    def fn(xs: Sharded):
        _expect(xs, mesh, "batch")
        out = _run(mesh, rank, xs)
        metrics = _psum_metrics([res[2] for res in out], mesh)
        return (_collect(mesh, "batch", out, 0), _collect(mesh, "batch", out, 1)), metrics

    return fn


# ---- distributed serialization (the codec's distributed checkpoint) --------------


def _banded_payload_sharded(coeffs, inner: str, level: int) -> bytes:
    """Entropy-code a band-sharded coefficient map into the ``banded``
    payload (leading segment count + per-segment directory) without
    gathering the map: the one copy shared by the gray (.tdc) and color
    (.tdcc) distributed writers.

    Each rank's slab comes to the host on its own and entropy-codes into
    one segment on a thread pool (``deterministic=True``,
    ``sampled_auto=True``: the single-host banded writer's segment branch,
    so the bytes are its bytes); the segments are reassembled in row order,
    with the gap, coverage and 1..255 checks.  A replicated value (or a
    plain array) is one slab.  Across processes each process codes its own
    ranks' slabs, and only the compressed segments cross processes (two
    all-gathers: lengths, then padded bytes); every process assembles the
    same payload."""
    import os
    import struct
    from concurrent.futures import ThreadPoolExecutor

    from tpudct_torch.utils.serialize import _encode_payload, _validate_map

    h, _w = coeffs.shape
    if isinstance(coeffs, Sharded):
        if coeffs.spec == "grid":
            # a (band, col) tile is not a full-width row band; encoding its
            # first column tile as the band would write a corrupt file
            raise ValueError(
                "save_sharded requires band (row-only) sharding; this array "
                f"is also column-sharded ({coeffs.mesh.shape[1]} column tiles); "
                "reshard with shard_image first"
            )
        if coeffs.spec not in ("band", "replicated"):
            raise ValueError(f"save_sharded takes a band-sharded (H, W) map, got {coeffs.spec!r}")
        shards = coeffs.shards[:1] if coeffs.spec == "replicated" else coeffs.shards
    else:
        shards = (coeffs,)
    slabs = {}  # row_start -> validated int16 slab
    across = isinstance(coeffs, Sharded) and not coeffs.is_fully_addressable
    r0 = 0
    for i, shard in enumerate(shards):
        host = shard.cpu().numpy() if isinstance(shard, torch.Tensor) else np.asarray(shard)
        if across:  # equal bands: rank r's starts at r * rows
            r0 = coeffs.mesh.local_ranks[i] * host.shape[0]
        slabs[r0] = _validate_map(host)
        r0 += host.shape[0]
    keys = sorted(slabs)
    with ThreadPoolExecutor(max_workers=min(max(1, len(keys)), os.cpu_count() or 4)) as ex:
        encoded = list(ex.map(
            lambda r: _encode_payload(slabs[r], inner, level, deterministic=True, sampled_auto=True),
            keys,
        ))
    segs = {r: (slabs[r].shape[0], code, payload) for r, (code, payload) in zip(keys, encoded)}
    if across:
        local = b"".join(struct.pack("<IIBI", r, rows, code, len(payload)) + payload
                         for r, (rows, code, payload) in sorted(segs.items()))
        segs = {}
        for blob in _allgather_bytes(local):
            off = 0
            while off < len(blob):
                r, rows, code, plen = struct.unpack("<IIBI", blob[off : off + 13])
                segs[r] = (rows, code, blob[off + 13 : off + 13 + plen])
                off += 13 + plen
    if not 1 <= len(segs) <= 255:
        raise ValueError(
            f"sharded save: {len(segs)} bands cannot serialize "
            f"(the banded container holds 1..255 segments)"
        )
    parts = [bytes([len(segs)])]
    expect = 0
    for r in sorted(segs):
        rows, code, payload = segs[r]
        if r != expect:
            raise ValueError(f"sharded save: bands do not tile the map (gap at row {expect})")
        parts.append(struct.pack("<IBI", rows, code, len(payload)))
        parts.append(payload)
        expect = r + rows
    if expect != h:
        raise ValueError(
            f"sharded save: {len(segs)} bands covering {expect} rows "
            f"cannot serialize an {h}-row map"
        )
    return b"".join(parts)


def save_sharded(
    path, coeffs, q_scale: float = 1.0, retain_k=None, orig_shape=None,
    transform: str = "haweel", q_table: str = "luma", inner: str = "auto",
    level: int = 6,
) -> int:
    """Serialize a band-sharded coefficient map to a .tdc without gathering
    it: one banded segment per rank (:func:`_banded_payload_sharded`).  The
    file is byte-identical to the single-host ``save_coefficients(...,
    codec=f"banded:{n_ranks}:{inner}")`` of the gathered map, so every
    ordinary loader decodes it bit for bit.  Across processes it is a
    collective: every process assembles the same bytes, process 0 writes
    the file, and every process returns the byte count."""
    from tpudct_torch.utils.serialize import _CODEC_BANDED, _wrap_v4

    h, w = coeffs.shape
    payload = _banded_payload_sharded(coeffs, inner, level)
    data = _wrap_v4(h, w, _CODEC_BANDED, payload, q_scale, retain_k, orig_shape, transform, q_table)
    _write_on_process_0(path, data)
    return len(data)


def _write_on_process_0(path, data: bytes) -> None:
    if process_index() == 0:
        with open(path, "wb") as f:
            f.write(data)


def save_color_sharded(
    path, planes: dict, meta: dict, q_scale: float = 1.0, retain_k=None,
    transform: str = "haweel", inner: str = "auto", level: int = 6,
) -> int:
    """Distributed .tdcc: serialize three band-sharded coefficient planes
    (y / cb / cr, e.g. from :func:`sharded_color_encode`) without a gather.
    Per plane this is :func:`save_sharded`'s flow; the three plane streams
    wrap in ``serialize.color_container_from_blobs``'s framing, so the
    file is byte-identical to the single-host ``save_color(...,
    codec=f"banded:{n}:{inner}")`` of the gathered planes.  `meta` is the
    color encoders' meta (orig_shape, chroma_shape, subsample, optional
    per-plane q tables).  Returns the byte count; across processes only
    process 0 writes, as in :func:`save_sharded`."""
    from tpudct_torch.utils.serialize import _CODEC_BANDED, _wrap_v4, color_container_from_blobs

    def plane_blob(name, q_table, oshape):
        plane = planes[name]
        ph, pw = plane.shape
        payload = _banded_payload_sharded(plane, inner, level)
        return _wrap_v4(ph, pw, _CODEC_BANDED, payload, q_scale, retain_k, oshape, transform, q_table)

    data = color_container_from_blobs(meta, plane_blob)
    _write_on_process_0(path, data)
    return len(data)
