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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.models.base import Pipeline
from tpudct_torch.parallel.mesh import Mesh, rank_streams
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
    """A global array as one tensor per rank (``shards[r]`` on
    ``mesh.devices[r]``), laid out by ``spec``: a key of ``_AXES``, or
    "replicated" (every rank holds the whole array)."""

    mesh: Mesh
    spec: str
    shards: tuple

    @property
    def shape(self) -> tuple:
        if self.spec == "replicated":
            return tuple(self.shards[0].shape)
        row_ax, col_ax = _AXES[self.spec]
        nc = 1 if col_ax is None else self.mesh.shape[1]
        shape = list(self.shards[0].shape)
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


def _place(x, mesh: Mesh, spec: str) -> Sharded:
    """Cut ``x`` (a tensor or an array) by ``spec`` and put each piece on its
    rank's device (a view where it is there already)."""
    row_ax, col_ax = _AXES[spec]
    nb, nc = _mesh_shape(mesh, spec)
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.require(x, requirements="W"))
    rows = t.shape[row_ax] // nb
    shards = []
    for r, dev in enumerate(mesh.devices):
        b, c = divmod(r, nc)
        piece = t.narrow(row_ax, b * rows, rows)
        if col_ax is not None:
            cols = t.shape[col_ax] // nc
            piece = piece.narrow(col_ax, c * cols, cols)
        shards.append(piece.to(dev).contiguous())
    return Sharded(mesh, spec, tuple(shards))


def shard_image(x, mesh: Mesh) -> Sharded:
    """Place an (H, W) image as row bands across the mesh."""
    n, h = _mesh_shape(mesh, "band")[0], x.shape[0]
    if (h // n) % 8 or h % n:
        raise ValueError(f"height {h} must split into {n} bands of 8-row multiples")
    return _place(x, mesh, "band")


def shard_image_grid(x, mesh: Mesh) -> Sharded:
    """Place an (H, W) image as a 2-D tile grid across a (band, col) mesh."""
    nb, nc = _mesh_shape(mesh, "grid")
    h, w = x.shape
    if h % nb or (h // nb) % 8:
        raise ValueError(f"height {h} must split into {nb} bands of 8-row multiples")
    if w % nc or (w // nc) % 8:
        raise ValueError(f"width {w} must split into {nc} tiles of 8-col multiples")
    return _place(x, mesh, "grid")


def shard_rgb(x, mesh: Mesh) -> Sharded:
    """Place a (3, H, W) planar u8 RGB image as row bands.  Per-band heights
    must be multiples of 16 so the 4:2:0 chroma planes land on whole 8-row
    blocks (band-local pooling halves the rows)."""
    n = _mesh_shape(mesh, "rgb-band")[0]
    _c, h, w = x.shape
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
    pooling is 2x2-local, so tiles need 16-row AND 16-col alignment."""
    nb, nc = _mesh_shape(mesh, "rgb-grid")
    _c, h, w = x.shape
    if h % nb or (h // nb) % 16:
        raise ValueError(f"height {h} must split into {nb} bands of 16-row multiples")
    if w % nc or (w // nc) % 16:
        raise ValueError(f"width {w} must split into {nc} tiles of 16-col multiples")
    return _place(x, mesh, "rgb-grid")


def shard_batch(x, mesh: Mesh) -> Sharded:
    """Place a (B, H, W) batch with B/n images per rank."""
    n, b = _mesh_shape(mesh, "batch")[0], x.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} images must split across {n} devices")
    return _place(x, mesh, "batch")


def gather(x: Sharded) -> np.ndarray:
    """Reassemble a sharded value on the host (output path only); a
    replicated one is its first rank's copy."""
    if x.spec == "replicated":
        return x.shards[0].cpu().numpy()
    row_ax, col_ax = _AXES[x.spec]
    host = [s.cpu() for s in x.shards]
    if col_ax is not None:
        nc = x.mesh.shape[1]
        host = [torch.cat(host[b * nc : (b + 1) * nc], col_ax) for b in range(x.mesh.shape[0])]
    return torch.cat(host, row_ax).numpy()


# ---- running a function on every rank -----------------------------------------


def _tensors(res):
    for v in res:
        yield from (v.values() if isinstance(v, dict) else (v,))


def _run(mesh: Mesh, fn, *inputs: Sharded) -> list:
    """``fn(*rank_shards)`` for every rank, on its device and, on a card,
    its own stream: each rank stream first waits for the caller's stream,
    and the caller's stream then waits for every rank stream, so the
    results are ready where the caller reads them.  Tensors that cross
    streams are recorded on the stream that reads them (the caching
    allocator reuses their memory only after it).  Returns fn's results
    (tuples of tensors and dicts of tensors), one per rank."""
    args = [tuple(x.shards[r] for x in inputs) for r in range(mesh.size)]
    if not mesh.is_cuda:
        return [fn(*a) for a in args]
    out = []
    for dev, s, a in zip(mesh.devices, rank_streams(mesh), args):
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(s):
            for t in a:
                t.record_stream(s)
            out.append(fn(*a))
    for dev, s, res in zip(mesh.devices, rank_streams(mesh), out):
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


def _psum_metrics(parts: list, device) -> dict:
    """Distributed quality metrics from the ranks' partial sums, added on
    ``device`` (the first rank's): mse and psnr_db; peen_pct and
    nonzero_frac where the partials hold coefficients; images where they
    hold a batch."""
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
        metrics = _psum_metrics([res[2] for res in out], mesh.devices[0])
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
        return _collect(mesh, spec, out, 0), _psum_metrics([res[1] for res in out], mesh.devices[0])

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
        metrics = _psum_metrics([res[2] for res in out], mesh.devices[0])
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
    plain array) is one slab.  The port's ranks live in one process, so
    every slab is addressable here; the reference's multi-process leg
    (``process_allgather`` of the compressed segments) waits for the port's
    ``distributed_init`` (ROADMAP A.10)."""
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
    r0 = 0
    for shard in shards:
        host = shard.cpu().numpy() if isinstance(shard, torch.Tensor) else np.asarray(shard)
        slabs[r0] = _validate_map(host)
        r0 += host.shape[0]
    keys = sorted(slabs)
    with ThreadPoolExecutor(max_workers=min(max(1, len(keys)), os.cpu_count() or 4)) as ex:
        encoded = list(ex.map(
            lambda r: _encode_payload(slabs[r], inner, level, deterministic=True, sampled_auto=True),
            keys,
        ))
    segs = {r: (slabs[r].shape[0], code, payload) for r, (code, payload) in zip(keys, encoded)}
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
    ordinary loader decodes it bit for bit.  Returns the byte count.

    The ranks of the port's mesh live in one process, which writes the
    file; the reference's multi-process form (every process assembles the
    bytes, process 0 writes) waits for ``distributed_init`` (ROADMAP
    A.10)."""
    from tpudct_torch.utils.serialize import _CODEC_BANDED, _wrap_v4

    h, w = coeffs.shape
    payload = _banded_payload_sharded(coeffs, inner, level)
    data = _wrap_v4(h, w, _CODEC_BANDED, payload, q_scale, retain_k, orig_shape, transform, q_table)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


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
    per-plane q tables).  Returns the byte count; the multi-process form
    waits as :func:`save_sharded`'s does."""
    from tpudct_torch.utils.serialize import _CODEC_BANDED, _wrap_v4, color_container_from_blobs

    def plane_blob(name, q_table, oshape):
        plane = planes[name]
        ph, pw = plane.shape
        payload = _banded_payload_sharded(plane, inner, level)
        return _wrap_v4(ph, pw, _CODEC_BANDED, payload, q_scale, retain_k, oshape, transform, q_table)

    data = color_container_from_blobs(meta, plane_blob)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
