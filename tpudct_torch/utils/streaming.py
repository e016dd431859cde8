"""Host-staged streaming codec for images larger than device memory: the
counterpart of ``tpudct/utils/streaming.py``.

The kernels are row-band independent (8x8 blocks, zero halo: the property
the band mesh exploits too), so an image of any height streams through the
card band by band: host slice -> device -> u8 kernels -> host assembly.
Peak device memory is one band's working set whatever the image size;
outputs may be preallocated (numpy memmaps), so the host footprint can stay
bounded too.  Every result is bit-identical to the in-memory path: the same
``.tdc``/``.tdcc`` bytes (as the in-memory banded writer's, where its row
split is the band split) and the same pixels.

Host <-> device traffic goes through :class:`_Staging`.  On a card it holds
pinned host buffers, two of each (the input band, and each output), a
host-to-device and a device-to-host copy stream and CUDA events that order
them, so that band k+1's host-to-device copy, band k's kernels and band
k-1's device-to-host copy can overlap.  The kernels run on the caller's
current stream.  With ``device="cpu"`` the same band loop runs the kernels'
plain twins on plain host arrays (no pinned memory, no streams), and only
where the caller names the CPU: every entry point takes ``device=None`` and
resolves it through ``models.dispatch.default_device`` (the first card).

While the registry of ``utils.profiling`` is on, the streamed calls record
where they spend their time under ``streaming.<part>``: spans ``stage``, the
host copies of bands into the staging buffers (with their edge or zero
padding); ``wait``, the host waiting for a band's results; ``finish``, the
host taking them out of the staging buffers (into the output raster, or the
int16 slab an encoder hands to its entropy threads, with the encoders' wait
on those threads); ``entropy``, entropy coding and decoding on the host (on
the coding threads); and counters of seconds from CUDA events, on a card,
``h2d``, ``kernels`` and ``d2h``, each stream's span per band (the copies'
spans start once their buffers exist; the kernels' span also holds the gaps
in which the compute stream waits for the host to launch), and
``device_busy``, the union of those spans.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.utils import profiling

def seconds(snap: dict) -> dict:
    """Seconds per part of the streamed calls (the module docstring's
    parts, without their prefix) in a ``profiling.snapshot()``."""
    pre = profiling.PREFIX + "streaming."
    out = {n[len(pre):]: v["total_s"] for n, v in snap["spans"].items() if n.startswith(pre)}
    out.update({n[len(pre):]: v for n, v in snap["counters"].items() if n.startswith(pre)})
    return out


def _pinned_bytes(n: int) -> torch.Tensor:
    """n bytes of page-locked host memory (raises where it cannot pin)."""
    return torch.empty(n, dtype=torch.uint8, pin_memory=True)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Staging:
    """The host <-> device traffic of one streamed call, band by band.

    :meth:`band` takes a band's inputs as ``(shape, dtype, fill)``:
    ``fill(host_array)`` writes the band into a host array of that shape
    and dtype.  On a card:

    1. the host fills this band's pinned input buffers (one of two slots,
       after the host-to-device copies that read the slot two bands ago
       have finished);
    2. the h2d stream copies them into fresh device tensors
       (``non_blocking``), each recorded on the compute stream so that the
       caching allocator reuses its memory only after the kernels read it;
    3. the compute stream (the caller's current stream, made current while
       ``fn`` launches) waits for that copy and runs ``fn``, which returns
       contiguous device tensors;
    4. the d2h stream waits for the kernels and copies each output into
       this slot's pinned output buffers (the outputs recorded on it);
    5. then the previous band finishes: the host waits for its d2h event
       and hands its pinned outputs to its ``finish``, which must copy what
       it keeps (the next band but one overwrites them).

    So band k's copies and kernels are in flight while the host finishes
    band k-1 and fills band k+1.  Pinned buffers are allocated at first use
    of a slot, at the size of that band (the first bands are the largest).
    On the CPU, :meth:`band` runs fill, fn and finish in turn on plain
    tensors.  Use as a context manager: leaving finishes the last band; an
    error synchronizes the streams (nothing stays in flight on the
    buffers) and propagates."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._slot = 0
        self._pending = None  # (d2h event, host outputs, finish) of the last band
        if self.cuda:
            self._init_streams()

    def _init_streams(self) -> None:
        self._host: dict = {}  # (direction, slot, index) -> pinned byte buffer
        self._read = [None, None]  # per slot: end of the h2d copies that read it
        self._spans: list = []  # (kind, start event, end event)
        self.compute = torch.cuda.current_stream(self.device)
        self.h2d = torch.cuda.Stream(self.device)
        self.d2h = torch.cuda.Stream(self.device)
        self._t0 = self._event(self.compute)

    def __enter__(self) -> "_Staging":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            if self.cuda:
                torch.cuda.synchronize(self.device)
            return
        self._finish_pending()
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self._account()

    @staticmethod
    def _event(stream) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _pinned(self, key, shape, dtype) -> torch.Tensor:
        """A pinned host tensor of `shape`/`dtype` over the buffer `key`."""
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        buf = self._host.get(key)
        if buf is None or buf.numel() < n:
            buf = _pinned_bytes(max(n, 1))
            self._host[key] = buf
        return buf[:n].view(dtype).view(shape)

    def band(self, inputs, fn, finish) -> None:
        if not self.cuda:
            hosts = []
            with profiling.span("streaming.stage"):
                for shape, dtype, fill in inputs:
                    a = torch.empty(shape, dtype=_torch_dtype(dtype))
                    fill(a.numpy())
                    hosts.append(a)
            outs = fn(*hosts)
            with profiling.span("streaming.finish"):
                finish(*[o.numpy() for o in outs])
            return
        slot, self._slot = self._slot, self._slot ^ 1
        if self._read[slot] is not None:
            # band k-2's h2d copies read this slot (band k-2's finish, which
            # waited for its kernels and so for them, implies it; the wait
            # keeps the refill safe on its own)
            self._read[slot].synchronize()
        staged = []
        with profiling.span("streaming.stage"):
            for i, (shape, dtype, fill) in enumerate(inputs):
                v = self._pinned(("in", slot, i), tuple(shape), _torch_dtype(dtype))
                fill(v.numpy())
                staged.append(v)
        with torch.cuda.stream(self.h2d):
            dev_in = [torch.empty(v.shape, dtype=v.dtype, device=self.device) for v in staged]
            h0 = self._event(self.h2d)
            for d, v in zip(dev_in, staged):
                d.copy_(v, non_blocking=True)
                d.record_stream(self.compute)
        h1 = self._event(self.h2d)
        self._read[slot] = h1
        self.compute.wait_event(h1)
        with torch.cuda.stream(self.compute):
            k0 = self._event(self.compute)
            outs = fn(*dev_in)
            k1 = self._event(self.compute)
        del dev_in
        if not all(o.is_contiguous() for o in outs):
            raise ValueError("a band's device outputs must be contiguous")
        host_out = [self._pinned(("out", slot, i), tuple(o.shape), o.dtype) for i, o in enumerate(outs)]
        self.d2h.wait_event(k1)
        d0 = self._event(self.d2h)
        with torch.cuda.stream(self.d2h):
            for o, hv in zip(outs, host_out):
                o.record_stream(self.d2h)
                hv.copy_(o, non_blocking=True)
        d1 = self._event(self.d2h)
        del outs
        self._spans += [("h2d", h0, h1), ("kernels", k0, k1), ("d2h", d0, d1)]
        self._finish_pending()
        self._pending = (d1, host_out, finish)

    def _finish_pending(self) -> None:
        if self._pending is None:
            return
        ev, host_out, finish = self._pending
        self._pending = None
        if self.cuda:
            with profiling.span("streaming.wait"):
                ev.synchronize()
        with profiling.span("streaming.finish"):
            finish(*[h.numpy() for h in host_out])

    def _account(self) -> None:
        """Count each stream's device seconds and their union."""
        ivs = []
        for kind, a, b in self._spans:
            s, e = self._t0.elapsed_time(a), self._t0.elapsed_time(b)
            profiling.count("streaming." + kind, (e - s) / 1e3)
            ivs.append((s, e))
        busy, end = 0.0, -math.inf
        for s, e in sorted(ivs):
            if e > end:
                busy += e - max(s, end)
                end = e
        profiling.count("streaming.device_busy", busy / 1e3)


def _fill_edge(dst: np.ndarray, src: np.ndarray) -> None:
    """Write ``src`` into the top-left of ``dst`` and edge-replicate its
    last column and then its last row over the rest: rows and columns are
    the first two axes (an interleaved band's; a planar band goes plane by
    plane)."""
    r, c = src.shape[:2]
    dst[:r, :c] = src
    if dst.shape[1] > c:
        dst[:r, c:] = src[:, c - 1 : c]
    if dst.shape[0] > r:
        dst[r:] = dst[r - 1 : r]


def _fill_zero(dst: np.ndarray, src: np.ndarray) -> None:
    """Write ``src`` into the top-left of ``dst`` in ``dst``'s dtype (exact:
    the caller checked the values fit) and zero the rest."""
    r, c = src.shape
    np.copyto(dst[:r, :c], src, casting="unsafe")
    dst[:r, c:] = 0
    dst[r:] = 0


def _as_is(src: np.ndarray) -> tuple:
    """A band input that goes to the device as it is."""
    return (src.shape, src.dtype, lambda v: np.copyto(v, src))


def roundtrip_u8_streamed(
    pipeline,
    image_u8: np.ndarray,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 8192,
    out_coeffs: Optional[np.ndarray] = None,
    out_recon: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W) uint8 image -> (int8 coefficients, uint8 reconstruction),
    processed in row bands of `band_rows` through the fused u8 kernel (B1).

    Bitwise identical to the whole-image `roundtrip_u8` (bands align to
    32-row multiples, and blockwise math never crosses band edges).
    `out_coeffs`/`out_recon` accept preallocated arrays (memmap-friendly).
    Requires the u8 path's geometry (H % 32 == 0, W % 128 == 0) and an
    int8-safe config — same gate as the in-memory kernel."""
    from tpudct_torch.kernels import hp
    from tpudct_torch.models.dispatch import default_device

    cfg = cfg or CodecConfig()
    img = np.asarray(image_u8)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected a (H, W) uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape
    if not hp.supports_u8(h, w, cfg.q_scale, cfg.transform, cfg.q_table):
        raise ValueError(
            f"u8 streaming needs H % 32 == 0, W % 128 == 0 and an int8-safe "
            f"config; got {h}x{w}, q_scale={cfg.q_scale}, "
            f"transform={cfg.transform}"
        )
    band_rows = max(32, band_rows - band_rows % 32)
    if not hasattr(pipeline, "roundtrip_u8"):
        raise ValueError(
            f"streaming needs a u8-native pipeline (hp), got {pipeline.name!r}"
        )
    out_coeffs, out_recon = _outputs(out_coeffs, out_recon, h, w)

    def finish_at(a, b):
        def finish(c, r):
            out_coeffs[a:b] = c
            out_recon[a:b] = r
        return finish

    with _Staging(default_device(device)) as st:
        for a in range(0, h, band_rows):
            b = min(a + band_rows, h)
            # tail bands below 32 rows merge into the previous slice by
            # construction (h and band_rows are 32-multiples)
            st.band([_as_is(img[a:b])], lambda x: pipeline.roundtrip_u8(x, cfg), finish_at(a, b))
    return out_coeffs, out_recon


def _outputs(out_coeffs, out_recon, h: int, w: int) -> tuple:
    """The (H, W) int8 coefficient and uint8 reconstruction outputs: the
    caller's, checked, or new arrays."""
    if out_coeffs is None:
        out_coeffs = np.empty((h, w), np.int8)
    if out_recon is None:
        out_recon = np.empty((h, w), np.uint8)
    if out_coeffs.shape != (h, w) or out_recon.shape != (h, w):
        raise ValueError("preallocated outputs must match the image shape")
    if out_coeffs.dtype != np.int8 or out_recon.dtype != np.uint8:
        # a u8 coefficient buffer would silently WRAP negative int8
        # coefficients on assignment (-5 -> 251): refuse, don't corrupt
        raise ValueError(
            f"preallocated outputs must be int8 coefficients / uint8 recon, "
            f"got {out_coeffs.dtype} / {out_recon.dtype}"
        )
    return out_coeffs, out_recon


def roundtrip_color_u8_streamed(
    pipeline,
    rgb_planar_u8: np.ndarray,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 4096,
    device=None,
) -> Tuple[dict, dict, np.ndarray]:
    """(3, H, W) planar uint8 RGB -> (coefficient planes, meta, (H, W, 3)
    uint8 reconstruction), streamed in row bands through the u8 color
    path (``models.color.roundtrip_color_u8``: the direct 4:2:0 split, two
    B2, two B3 and the direct merge per band, at the planes' own shapes).

    Bands align to 64 rows so YCbCr conversion (pixel-local), 4:2:0
    pooling (2x2-local) and blockwise coding never cross band edges —
    results are identical to the whole-image pass.  Device memory is
    bounded by one band's planes."""
    from tpudct_torch.models.color import roundtrip_color_u8, supports_color_u8
    from tpudct_torch.models.dispatch import default_device

    cfg = cfg or CodecConfig()
    rgb = np.asarray(rgb_planar_u8)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[0] != 3:
        raise ValueError(
            f"expected a (3, H, W) uint8 planar image, got {rgb.dtype} {rgb.shape}"
        )
    _c, h, w = rgb.shape
    band_rows = max(64, band_rows - band_rows % 64)
    if h == 0 or h % 64 or not supports_color_u8(pipeline, cfg, h, w):
        raise ValueError(
            f"u8 color streaming needs H % 64 == 0, W % 256 == 0 and an "
            f"int8-safe config; got {h}x{w}"
        )
    parts: dict = {"y": [], "cb": [], "cr": [], "rec": []}

    def fn(x):
        planes, _meta, rec = roundtrip_color_u8(pipeline, x, cfg)
        return tuple(t.contiguous() for t in (planes["y"], planes["cb"], planes["cr"], rec))

    def finish(y, cb, cr, rec):
        for k, v in zip(("y", "cb", "cr", "rec"), (y, cb, cr, rec)):
            parts[k].append(v.copy())

    with _Staging(default_device(device)) as st:
        for a in range(0, h, band_rows):
            b = min(a + band_rows, h)
            st.band([_as_is(rgb[:, a:b])], fn, finish)
    out_planes = {k: np.concatenate(parts[k], axis=0) for k in ("y", "cb", "cr")}
    meta = {"orig_shape": (h, w), "chroma_shape": (h // 2, w // 2), "subsample": "420"}
    return out_planes, meta, np.concatenate(parts["rec"], axis=0)


def roundtrip_u8_streamed_sharded(
    pipeline,
    image_u8: np.ndarray,
    mesh,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 8192,
    out_coeffs: Optional[np.ndarray] = None,
    out_recon: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Streaming composed with the band mesh: each host row band is itself
    band-sharded over `mesh` (``parallel.sharding.shard_image``), each rank
    runs the fused u8 kernel (B1) on its slab on its own device and stream,
    and the band comes back with ``gather``, so the per-rank working set is
    band_rows/n — together the two axes code images bounded by neither one
    card's memory nor the host band size.  The mesh names the devices.

    Bitwise identical to the in-memory ``pipeline.roundtrip_u8`` of the
    whole image: bands align to 32-row multiples per rank and the blockwise
    math never crosses band edges — the same zero-halo property both
    streaming and the mesh exploit."""
    from tpudct_torch.kernels import hp
    from tpudct_torch.parallel.sharding import _collect, _mesh_shape, _require_local, _run, gather, shard_image

    _require_local(mesh, "roundtrip_u8_streamed_sharded")

    cfg = cfg or CodecConfig()
    img = np.asarray(image_u8)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected a (H, W) uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape
    n = _mesh_shape(mesh, "band")[0]
    unit = 32 * n  # each rank's band must stay a 32-row multiple
    if h % unit or not hp.supports_u8(h, w, cfg.q_scale, cfg.transform, cfg.q_table):
        raise ValueError(
            f"sharded u8 streaming needs H % {unit} == 0 (32-row multiple "
            f"per device band), W % 128 == 0 and an int8-safe config; got "
            f"{h}x{w} on a {n}-device mesh"
        )
    band_rows = max(unit, band_rows - band_rows % unit)
    if not hasattr(pipeline, "roundtrip_u8"):
        raise ValueError(
            f"streaming needs a u8-native pipeline (hp), got {pipeline.name!r}"
        )
    out_coeffs, out_recon = _outputs(out_coeffs, out_recon, h, w)
    # plain band_rows slicing: h and band_rows are both `unit` multiples, so
    # the tail band is valid and no band ever exceeds band_rows (the memory
    # bound this function exists to provide)
    for a in range(0, h, band_rows):
        b = min(a + band_rows, h)
        out = _run(mesh, lambda x: pipeline.roundtrip_u8(x, cfg), shard_image(img[a:b], mesh))
        out_coeffs[a:b] = gather(_collect(mesh, "band", out, 0))
        out_recon[a:b] = gather(_collect(mesh, "band", out, 1))
    return out_coeffs, out_recon


# ---- streamed serialization: banded container <-> band-by-band device work ---
#
# The banded .tdc codec (independent row-band segments) is the natural
# on-disk shape for a streamed encode: each host band leaving the card
# entropy-codes at once into its own segment, so the full coefficient map
# never materializes on the host either: total residency is the input pixels
# plus the compressed segments.  Decode mirrors it: each segment
# entropy-decodes, rides the card in bounded bands, and lands in the output
# raster.

#: Images and streams above this many pixels take the streamed paths in the
#: CLI (the reference's in-memory device path reaches 65536^2 = 2^32
#: pixels); ``--band-rows`` streams explicitly.
STREAM_PIXELS = 1 << 32


def _coded(slab: np.ndarray, inner: str, level: int) -> tuple:
    """One banded segment's payload: ``serialize._encode_payload`` with
    deterministic output and the sampled auto estimator (the in-memory
    banded writer's segment branch), in a span ``streaming.entropy``."""
    from tpudct_torch.utils.serialize import _encode_payload

    with profiling.span("streaming.entropy"):
        return _encode_payload(slab, inner, level, True, True)


def _refuse_banded_inner(inner: str) -> None:
    if inner.startswith("banded"):
        # each host band already becomes ONE banded segment; a banded inner
        # would nest containers, which every decoder rejects: refusing at
        # write time prevents a saved but permanently undecodable archive
        raise ValueError(
            "streamed encode writes banded segments itself; pass a "
            "non-banded inner stage (auto/rans/huffman/xz/spectral/raw)"
        )


def encode_gray_streamed_bytes(
    pipeline,
    image_u8: np.ndarray,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 8192,
    inner: str = "auto",
    level: int = 6,
    device=None,
) -> Tuple[bytes, Tuple[int, int]]:
    """(H, W) uint8 image of any size -> (.tdc stream bytes, (h, w)).

    Bands of `band_rows` rows ride the u8 encode kernel (B2) one at a time
    (device memory bounded by one band) and each band's int16 slab
    entropy-codes into one banded segment on a host thread that overlaps
    the next band's device work — the coefficient map never exists whole
    anywhere.  The bytes are the in-memory ``encode_gray_auto`` + banded
    save's where that save's row split (``serialize.banded_rows``) is the
    band split; every loader reads both.

    Edge-pads each band to the u8 kernel grid exactly like
    ``models/dispatch.py`` (block-local transform: pixels in the original
    region unaffected) and crops the slabs to the 8-aligned container
    shape.  Requires a u8-eligible config (integer-core transform,
    int8-safe q_scale, the default deadzone)."""
    from concurrent.futures import ThreadPoolExecutor

    from tpudct_torch.kernels import hp
    from tpudct_torch.models.dispatch import default_device
    from tpudct_torch.ops.padding import kernel_padded_shape, padded_shape
    from tpudct_torch.utils.serialize import _CODEC_BANDED, _wrap_v4, assemble_banded_segments

    _refuse_banded_inner(inner)
    cfg = cfg or CodecConfig()
    img = np.asarray(image_u8)
    if img.ndim != 2:
        raise ValueError(f"expected a (H, W) image, got shape {img.shape}")
    if img.dtype != np.uint8:
        raise ValueError(
            f"streamed encode takes uint8 pixels, got {img.dtype} "
            "(float inputs use the in-memory path)"
        )
    h, w = img.shape
    hk, wk = kernel_padded_shape(h, w, 32, 128)
    if cfg.deadzone != 0.5 or not hp.supports_u8(
        hk, wk, cfg.q_scale, cfg.transform, cfg.q_table
    ):
        raise ValueError(
            f"streamed encode needs an int8-safe config (integer-core "
            f"transform, q_scale >= ~0.77, default deadzone); got "
            f"transform={cfg.transform}, q_scale={cfg.q_scale}, "
            f"deadzone={cfg.deadzone}"
        )
    band_rows = max(32, band_rows - band_rows % 32)
    h8, w8 = padded_shape(h, w)
    n_bands = -(-h8 // band_rows)
    if n_bands > 255:
        raise ValueError(
            f"{n_bands} bands exceed the banded container's 255-segment "
            f"limit; raise --band-rows to at least {-(-h8 // 255 // 32) * 32}"
        )
    splits = []  # container rows per segment (8-aligned, sum = h8)
    futs: list = []
    with ThreadPoolExecutor(max_workers=2) as ex:

        def finish_keep(keep):
            def finish(c):
                # int16 like the in-memory path's _validate_map (the raw
                # inner's decoder parses int16 elements), and a copy: the
                # staging buffer it came in is reused two bands on
                slab = np.ascontiguousarray(c[:keep, :w8], np.int16)
                if len(futs) >= 2:
                    # backpressure: the entropy stage is far slower than
                    # the device band, so unbounded submits would queue
                    # every slab and approach full-map residency
                    futs[-2].result()
                futs.append(ex.submit(_coded, slab, inner, level))
            return finish

        with _Staging(default_device(device)) as st:
            for a in range(0, h8, band_rows):
                keep = min(band_rows, h8 - a)
                # the device band meets the 32-row kernel alignment; rows
                # beyond the image are edge pad, cropped from the slab
                dev_rows = -(-keep // 32) * 32
                band = img[a : min(a + dev_rows, h)]
                st.band(
                    [((dev_rows, wk), np.uint8, lambda v, band=band: _fill_edge(v, band))],
                    lambda x: (pipeline.encode_u8(x, cfg),),
                    finish_keep(keep),
                )
                splits.append(keep)
        encoded = [f.result() for f in futs]
    data = _wrap_v4(
        h8, w8, _CODEC_BANDED,
        assemble_banded_segments(list(zip(splits, encoded))),
        cfg.q_scale, cfg.retain_k, (h, w), cfg.transform, cfg.q_table,
    )
    return data, (h, w)


class _PlaneRows:
    """Incremental reader of one v4 plane stream's coefficient rows.

    The one streaming-side parser for a plane blob, shared by the gray and
    color streamed decoders and all their partial modes.  For banded
    payloads (the archival layout) host residency is bounded by one decoded
    segment plus the pull buffer: segments entropy-decode lazily through
    ``serialize.iter_banded_segments``, which also honours `n_planes`
    (spectral-prefix or decode+mask truncation) and `row_range` (segments
    outside the container-row range are never entropy-decoded).
    Non-banded codecs decode the whole map on first pull: those formats are
    not segmentable, and the constraint streaming lifts is device memory."""

    def __init__(self, blob, n_planes=None, row_range=None):
        from tpudct_torch.utils import serialize as ser

        ser._tune_malloc_for_slabs()  # slab allocations recycle warm pages
        (h, w, oh, ow, q_scale, retain_k, transform, q_table, code, psize,
         hsize, custom_q, _version) = ser._parse_plane_header(blob)
        self.h, self.w = h, w
        self.oh, self.ow = (oh or h), (ow or w)
        if self.oh > h or self.ow > w:
            # the whole-map parser's check: without it a corrupt header
            # makes a preallocated np.empty output ship rows of
            # uninitialized heap memory to the caller
            raise ValueError(
                f"corrupt .tdc header: orig_shape ({self.oh}, {self.ow}) "
                f"exceeds the coefficient map ({h}, {w})"
            )
        if custom_q is not None:
            # registration is content-named (q:<hash>), so registering
            # before the payload decodes cannot poison the registry
            from tpudct_torch.constants import register_q_table

            q_table = register_q_table(custom_q)
        self.q_scale = float(q_scale)
        self.retain_k = None if retain_k < 0 else retain_k
        self.transform, self.q_table = transform, q_table
        self.code = code
        if row_range is not None:
            c0, c1 = row_range
            if c0 % 8 or c1 % 8 or not 0 <= c0 < c1 <= h:
                raise ValueError(
                    f"row_range {row_range} must be 8-aligned within (0, {h})"
                )
        self.row_range = row_range
        self._cursor = row_range[0] if row_range else 0
        self._end = row_range[1] if row_range else h
        self._buf: list = []
        self._buf_rows = 0
        if code == ser._CODEC_BANDED:
            self._gen = ser.iter_banded_segments(
                blob[hsize : hsize + psize], h, w,
                n_planes=n_planes, row_range=row_range,
            )
        else:
            # non-banded: entropy-decode the whole map once
            if (n_planes is not None
                    and code in (ser._CODEC_SPECTRAL, ser._CODEC_XZ)):
                # spectral-ordered: only the needed prefix decompresses
                cmap = ser._partial_spectral_map(
                    blob[hsize : hsize + psize], code, h, w, n_planes
                )
            else:
                raw = blob[hsize : hsize + psize]
                if code not in (ser._CODEC_HUFF, ser._CODEC_RANS, ser._CODEC_XZ):
                    import zlib

                    try:
                        raw = zlib.decompress(raw)
                    except zlib.error as e:
                        raise ValueError(f"corrupt .tdc payload: {e}") from None
                cmap = ser._decode_payload(raw, code, h, w)
                if n_planes is not None:
                    cmap = ser._zero_high_planes(
                        np.ascontiguousarray(cmap), n_planes
                    )
            self._gen = iter(
                [(self._cursor, self._end - self._cursor,
                  cmap[self._cursor : self._end])]
            )

    def drain(self) -> None:
        """Exhaust the segment walk so its end-of-payload validation
        (trailing bytes, row coverage) runs even when the band loop's pulls
        consumed exactly the declared rows: without it, a corrupt banded
        payload whose valid prefix covers the requested rows would decode
        silently."""
        while self._gen is not None:
            try:
                next(self._gen)
            except StopIteration:
                self._gen = None

    def pull(self, nrows: int) -> np.ndarray:
        """Next min(nrows, remaining) container coefficient rows as one
        (r, w) int16 array; empty (0, w) at exhaustion.  `nrows` must be
        8-aligned so pulls always land on segment-compatible rows.  Its
        time is a span ``streaming.entropy``."""
        with profiling.span("streaming.entropy"):
            while self._buf_rows < nrows and self._gen is not None:
                try:
                    r0, rows, cmap = next(self._gen)
                except StopIteration:
                    self._gen = None
                    break
                if self.row_range is not None:
                    # segments overlapping the range edge: keep the in-range part
                    s0 = max(r0, self.row_range[0])
                    s1 = min(r0 + rows, self.row_range[1])
                    cmap = cmap[s0 - r0 : s1 - r0]
                self._buf.append(cmap)
                self._buf_rows += cmap.shape[0]
            take = min(nrows, self._buf_rows)
            if take == 0:
                return np.empty((0, self.w), np.int16)
            parts, got = [], 0
            while got < take:
                head = self._buf[0]
                need = take - got
                if head.shape[0] <= need:
                    parts.append(head)
                    got += head.shape[0]
                    self._buf.pop(0)
                else:
                    parts.append(head[:need])
                    self._buf[0] = head[need:]
                    got += need
            self._buf_rows -= take
            self._cursor += take
            out = parts[0] if len(parts) == 1 else np.vstack(parts)
            return out


def _out_raster(out, out_npy, out_shape) -> np.ndarray:
    """The caller's output (checked), a .npy memmap at `out_npy` (host
    residency stays one band even when the output exceeds RAM), or a new
    array."""
    if out is None:
        out = (np.lib.format.open_memmap(out_npy, mode="w+", dtype=np.uint8, shape=out_shape)
               if out_npy else np.empty(out_shape, np.uint8))
    if out.shape != out_shape or out.dtype != np.uint8:
        raise ValueError(
            f"preallocated output must be {out_shape} uint8, got "
            f"{out.dtype} {out.shape}"
        )
    return out


def _gray_band(st: _Staging, p, piece: np.ndarray, cfg: CodecConfig, finish) -> None:
    """``dispatch.decode_gray_auto`` of one band through the staging: the
    path is decided on the host piece; the u8 path stages the map as int8,
    zero-padded to the kernel grid on the host (B3 on the card), the others
    stage it as it is (padded on the card).  `finish` takes the uncropped
    uint8 decode."""
    from tpudct_torch.models.dispatch import (
        _LANE, _U8_ROWS, _decode_padded, _decode_path, _pad_coeffs_for,
    )
    from tpudct_torch.ops.padding import kernel_padded_shape

    path = _decode_path(p, piece, cfg)
    if path == "u8":
        shape = kernel_padded_shape(*piece.shape, _U8_ROWS, _LANE)
        st.band([(shape, np.int8, lambda v: _fill_zero(v, piece))],
                lambda x: (_decode_padded(p, "u8", x, cfg),), finish)
    else:
        st.band([_as_is(piece)],
                lambda x: (_decode_padded(p, path, _pad_coeffs_for(path, x), cfg).contiguous(),),
                finish)


def _gray_band_scaled(st: _Staging, p, piece: np.ndarray, cfg: CodecConfig, m: int, finish) -> None:
    """``dispatch.decode_gray_scaled_auto`` of one band (B7 where the u8
    plan holds: the map staged as int8, zero-padded to its alignment)."""
    from tpudct_torch.models.dispatch import _decode_scaled, _scaled_plan
    from tpudct_torch.ops.padding import kernel_padded_shape

    plan = _scaled_plan(p, piece, cfg, m)
    if plan[0] == "u8":
        inp = (kernel_padded_shape(*piece.shape, *plan[1]), np.int8, lambda v: _fill_zero(v, piece))
    else:
        inp = _as_is(piece)
    st.band([inp], lambda x: (_decode_scaled(p, plan, x, cfg, m).contiguous(),), finish)


def decode_gray_streamed(
    pipeline,
    data: bytes,
    band_rows: int = 8192,
    out: Optional[np.ndarray] = None,
    *,
    n_planes: Optional[int] = None,
    scale_m: Optional[int] = None,
    row_range: Optional[Tuple[int, int]] = None,
    out_npy: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """.tdc stream bytes -> uint8 raster, device memory bounded by
    ~band_rows rows at a time, host memory by one segment + one band.

    Banded streams (the archival layout) decode segment by segment through
    :class:`_PlaneRows`: neither the decoded coefficient map nor the device
    working set ever exceeds one chunk.  Non-banded codecs entropy-decode
    the whole map on the host first (they are not segmentable), then the
    card still runs in bounded bands.  Bit-identical to the in-memory
    decode (blocks are row-band local).  `out` accepts a preallocated uint8
    array (memmap-friendly).

    Partial modes (all compose with banded streams and keep the same
    memory bounds):

    - ``n_planes=N``: progressive: only the first N zig-zag spectral
      positions decode (spectral-prefix per segment for spectral/xz inners;
      decode+mask otherwise).  Output shape unchanged.
    - ``scale_m=M``: M/8 fractional-scale decode, per band as
      ``models.dispatch.decode_gray_scaled_auto`` decodes (the fused scaled
      kernel B7 where eligible).  Output is (ceil(oh*M/8), ceil(ow*M/8));
      exact because the scaled decode is 8-row-block local, so band seams
      are invisible.
    - ``row_range=(a, b)``: ROI: only segments overlapping original pixel
      rows [a, b) entropy-decode at all; output is (b-a, ow).  Does not
      combine with scale_m (the CLI forbids it too).
    """
    from tpudct_torch.models.dispatch import default_device
    from tpudct_torch.ops.scaled import scaled_shape_m8
    from tpudct_torch.utils import serialize as ser

    if scale_m is not None and row_range is not None:
        raise ValueError("scale_m does not combine with row_range")
    m = None if scale_m in (None, 8) else int(scale_m)

    band_rows = max(32, band_rows - band_rows % 32)
    crange = None
    if row_range is not None:
        hh, _ww, hoh, _how = ser._parse_plane_header(data)[:4]
        hoh = hoh or hh
        a, b = int(row_range[0]), int(row_range[1])
        a, b = max(0, a), min(hoh, b)
        if b <= a:
            raise ValueError(f"row_range {row_range}: empty for height {hoh}")
        crange = (a - a % 8, min(hh, -(-b // 8) * 8))
    reader = _PlaneRows(data, n_planes=n_planes, row_range=crange)
    oh, ow = reader.oh, reader.ow
    cfg = CodecConfig(q_scale=reader.q_scale, transform=reader.transform, q_table=reader.q_table)
    if row_range is not None:
        out_shape = (b - a, ow)
    elif m is not None:
        out_shape = (scaled_shape_m8(oh, m), scaled_shape_m8(ow, m))
    else:
        out_shape = (oh, ow)
    out = _out_raster(out, out_npy, out_shape)

    def to_roi(cr, w0, w1):
        def finish(rec):
            out[w0 - a : w1 - a] = rec[w0 - cr : w1 - cr, :ow]
        return finish

    def to_scaled(r0, keep):
        hs, ws = scaled_shape_m8(keep, m), scaled_shape_m8(ow, m)

        def finish(rec):
            out[r0 : r0 + hs] = rec[:hs, :ws]
        return finish

    def to_rows(cr, keep):
        def finish(rec):
            out[cr : cr + keep] = rec[:keep, :ow]
        return finish

    cr = crange[0] if crange else 0  # container row of the next pull
    with _Staging(default_device(device)) as st:
        while True:
            piece = reader.pull(band_rows)
            if piece.shape[0] == 0:
                break
            pix = piece.shape[0]
            if row_range is not None:
                # wanted original rows within this piece
                w0, w1 = max(a, cr), min(b, cr + pix)
                if w1 > w0:
                    _gray_band(st, pipeline, piece, cfg, to_roi(cr, w0, w1))
            else:
                keep = min(pix, oh - cr)
                if keep > 0:
                    if m is not None:
                        # cr is 8-aligned, so the scaled offset is exact
                        _gray_band_scaled(st, pipeline, piece, cfg, m, to_scaled(cr * m // 8, keep))
                    else:
                        _gray_band(st, pipeline, piece, cfg, to_rows(cr, keep))
            cr += pix
            piece = None  # release the slab before the next pull decodes
    return out


# ---------------------------------------------------------------------------
# Color streaming: beyond-memory RGB encode/decode
# ---------------------------------------------------------------------------
#
# The color kernels are as band-local as the gray ones: block transforms are
# 8-row local and the 4:2:0 pooling/replication is 2-row local, so a
# 64-row-aligned band boundary slices the whole-image computation exactly
# (64 = the color kernels' row alignment).  Each RGB band splits to YCbCr on
# the card, each plane's coefficient slab entropy-codes into banded
# segments, and the three banded plane streams wrap in the same .tdcc
# container framing as the in-memory writer: every ordinary loader reads
# the result.


def encode_color_streamed_bytes(
    pipeline,
    rgb_u8: np.ndarray,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 8192,
    inner: str = "auto",
    level: int = 6,
    subsample="420",
    device=None,
) -> Tuple[bytes, Tuple[int, int]]:
    """RGB uint8 image of any size, (H, W, 3) or (3, H, W) -> (.tdcc stream
    bytes, (h, w)).

    The color twin of :func:`encode_gray_streamed_bytes`: per band one split
    kernel (B8, B10 or B12) and two B2 launches (the luma and the stacked
    chroma); device memory is bounded by one band's working set, host
    memory by one band's coefficient slabs plus the compressed segments
    (entropy jobs are backpressured like the gray path).  The bytes are the
    in-memory ``encode_color_u8`` + banded save's where that save's row
    split is the band split.  An interleaved band goes to the card as it is
    and is made planar there."""
    from concurrent.futures import ThreadPoolExecutor

    from tpudct_torch.models.color import (
        _chroma_cfg,
        _chroma_plane_shape,
        _luma_cfg,
        _u8_kernels,
        color_kernel_shape,
        normalize_subsample,
        supports_color_u8,
    )
    from tpudct_torch.models.dispatch import default_device
    from tpudct_torch.ops.padding import padded_shape
    from tpudct_torch.utils.serialize import (
        _CODEC_BANDED,
        _wrap_v4,
        assemble_banded_segments,
        color_container_from_blobs,
    )

    _refuse_banded_inner(inner)
    cfg = cfg or CodecConfig()
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8:
        raise ValueError(
            f"streamed color encode takes uint8 pixels, got {img.dtype}"
        )
    if img.ndim != 3 or (img.shape[0] != 3 and img.shape[-1] != 3):
        raise ValueError(f"expected an RGB image, got shape {img.shape}")
    planar = img.shape[0] == 3 and img.shape[-1] != 3
    h, w = (img.shape[1:] if img.shape[0] == 3 else img.shape[:2])
    mode = normalize_subsample(subsample)
    hk, wk = color_kernel_shape(h, w)
    if not supports_color_u8(pipeline, cfg, hk, wk, mode):
        raise ValueError(
            f"streamed color encode needs the u8 color path (hp pipeline, "
            f"int8-safe q_scale); got transform={cfg.transform}, "
            f"q_scale={cfg.q_scale}"
        )
    band_rows = max(64, band_rows - band_rows % 64)
    ch, cw = _chroma_plane_shape(mode, h, w)
    y8 = padded_shape(h, w)
    c8 = padded_shape(ch, cw)
    fy = 2 if mode == "420" else 1  # luma rows per chroma row
    n_bands = -(-hk // band_rows)
    if n_bands > 255:
        raise ValueError(
            f"{n_bands} bands exceed the banded container's 255-segment "
            f"limit; raise --band-rows to at least {-(-hk // 255 // 64) * 64}"
        )
    split, _merge = _u8_kernels(mode)
    lcfg, ccfg = _luma_cfg(cfg), _chroma_cfg(cfg)

    def fn(x):
        y, cb, cr = split(x if planar else x.movedim(-1, 0).contiguous())
        return pipeline.encode_u8(y, lcfg), pipeline.encode_u8(torch.cat([cb, cr], dim=0), ccfg)

    segs: dict = {"y": [], "cb": [], "cr": []}  # (rows, future) per plane
    pending: list = []
    with ThreadPoolExecutor(max_workers=2) as ex:

        def finish_at(a, dev_rows):
            keep_y = min(dev_rows, y8[0] - a)
            keep_c = min(dev_rows // fy, c8[0] - a // fy)

            def finish(cy, cc):
                half = cc.shape[0] // 2
                slabs = {"y": cy[:keep_y, : y8[1]], "cb": cc[:half][:keep_c, : c8[1]],
                         "cr": cc[half:][:keep_c, : c8[1]]}
                for name, slab in slabs.items():
                    if slab.shape[0] <= 0:
                        continue
                    if len(pending) >= 6:
                        pending[-6].result()  # backpressure: <= 2 bands in flight
                    # int16 and a copy (the staging buffer is reused)
                    fut = ex.submit(_coded, np.ascontiguousarray(slab, np.int16), inner, level)
                    pending.append(fut)
                    segs[name].append((slab.shape[0], fut))
            return finish

        def fill_at(a, dev_rows):
            b = min(a + dev_rows, h)
            if planar:
                def fill(v):
                    for c in range(3):
                        _fill_edge(v[c], img[c, a:b])
                return ((3, dev_rows, wk), np.uint8, fill)
            return ((dev_rows, wk, 3), np.uint8, lambda v: _fill_edge(v, img[a:b]))

        with _Staging(default_device(device)) as st:
            for a in range(0, hk, band_rows):
                dev_rows = min(band_rows, hk - a)
                st.band([fill_at(a, dev_rows)], fn, finish_at(a, dev_rows))
        for fut in pending:
            fut.result()

    plane_dims = {"y": (y8, (h, w)), "cb": (c8, (ch, cw)), "cr": (c8, (ch, cw))}
    blobs = {}
    for name, seg_list in segs.items():
        payload = assemble_banded_segments(
            [(rows, fut.result()) for rows, fut in seg_list]
        )
        (p8, oshape) = plane_dims[name]
        q_table = lcfg.q_table if name == "y" else ccfg.q_table
        blobs[name] = _wrap_v4(
            p8[0], p8[1], _CODEC_BANDED, payload, cfg.q_scale,
            cfg.retain_k, oshape, cfg.transform, q_table,
        )
    meta = {"orig_shape": (h, w), "chroma_shape": (ch, cw), "subsample": mode}
    data = color_container_from_blobs(meta, lambda name, _q, _o: blobs[name])
    return data, (h, w)


def decode_color_streamed(
    pipeline,
    data: bytes,
    band_rows: int = 8192,
    out: Optional[np.ndarray] = None,
    *,
    n_planes: Optional[int] = None,
    scale_m: Optional[int] = None,
    row_range: Optional[Tuple[int, int]] = None,
    out_npy: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """.tdcc stream bytes -> uint8 RGB, device memory bounded by
    ~band_rows luma rows at a time, host memory by one segment per plane
    plus one band's slabs.

    Each plane reads through its own :class:`_PlaneRows`: banded plane
    streams (what the streamed encoder and ``save_color_sharded`` write)
    entropy-decode segment by segment in lockstep with the 64-row-aligned
    luma band loop, so the coefficient planes never materialize whole;
    non-banded plane streams decode whole on the host (not segmentable).
    The per-band device pass (two B3 launches and one merge, B9, B11 or
    B13, on the u8 path) slices the whole-image computation exactly (merge
    replication is 2-row local).  Bit-identical to the in-memory
    ``decode_color_auto``.  ``out`` accepts a preallocated uint8 array
    (memmap-friendly).

    Partial modes (same memory bounds): ``n_planes=N`` progressive
    (decodes like the in-memory ``partial_color_coefficients`` +
    ``decode_color`` path), ``scale_m=M`` fractional M/8 scale via
    ``decode_color_scaled`` per band, ``row_range=(a, b)`` ROI (only
    covering segments entropy-decode; matches the in-memory ``decode
    --rows`` slicing).

    The u8-vs-f32 path decision is made from the stream headers (q tables,
    geometry, the int8-safety proof in ``supports_color_u8``): every stream
    the u8 encoders can produce provably fits int8, so the whole-plane
    value check reduces to a per-band check; a violating value means a
    foreign or corrupt stream and raises instead of silently wrapping in
    the int8 cast."""
    from tpudct_torch.models.color import (
        _chroma_plane_shape,
        _decode_u8_padded,
        _fits_i8,
        color_kernel_shape,
        decode_color,
        decode_color_scaled,
        normalize_subsample,
        supports_color_u8,
    )
    from tpudct_torch.models.dispatch import default_device
    from tpudct_torch.ops.padding import padded_shape
    from tpudct_torch.ops.scaled import scaled_shape_m8
    from tpudct_torch.utils import serialize as ser

    if scale_m is not None and row_range is not None:
        raise ValueError("scale_m does not combine with row_range")
    m = None if scale_m in (None, 8) else int(scale_m)
    subsample, slices, _end = ser._color_plane_slices(data)
    mode = normalize_subsample(
        {0: False, 1: "420", 2: "422"}.get(subsample, False)
    )
    fy = 2 if mode == "420" else 1
    band_rows = max(64, band_rows - band_rows % 64)

    # geometry from the Y header (cheap), then the container row ranges
    yh_c, _yw, yoh, yow = ser._parse_plane_header(slices[0])[:4]
    h, w = (yoh or yh_c), (yow or _yw)
    ch, cw = _chroma_plane_shape(mode, h, w)
    ch_c = padded_shape(ch, cw)[0]  # chroma plane container height
    crange_y = crange_c = None
    start, stop = 0, yh_c
    if row_range is not None:
        a, b = max(0, int(row_range[0])), min(h, int(row_range[1]))
        if b <= a:
            raise ValueError(f"row_range {row_range}: empty for height {h}")
        align = 16 if mode == "420" else 8
        a0 = a - a % align
        y_end = min(yh_c, -(-b // align) * align)
        # tail slices of images whose padded luma height is only 8-aligned
        # (h % 16 == 8) leave y_end // 2 off the chroma block grid: take the
        # whole remaining chroma plane there (the in-memory `decode --rows`
        # rule in cli.py)
        c_end = ch_c if y_end >= yh_c else y_end // fy
        crange_y, crange_c = (a0, y_end), (a0 // fy, c_end)
        start, stop = a0, y_end
    ry = _PlaneRows(slices[0], n_planes=n_planes, row_range=crange_y)
    rcb = _PlaneRows(slices[1], n_planes=n_planes, row_range=crange_c)
    rcr = _PlaneRows(slices[2], n_planes=n_planes, row_range=crange_c)
    # cross-plane consistency: the whole of serialize._assemble_color's
    # checks, so a foreign .tdcc the in-memory parser rejects never reaches
    # the kernels
    if not (ry.transform == rcb.transform == rcr.transform
            and ry.q_scale == rcb.q_scale == rcr.q_scale
            and ry.retain_k == rcb.retain_k == rcr.retain_k
            and (rcb.oh, rcb.ow) == (rcr.oh, rcr.ow)
            and rcb.q_table == rcr.q_table):
        raise ValueError("inconsistent .tdcc plane headers")
    if (rcb.oh, rcb.ow) != _chroma_plane_shape(mode, h, w):
        raise ValueError(
            f".tdcc chroma planes declare {(rcb.oh, rcb.ow)} but the "
            f"subsample mode implies {_chroma_plane_shape(mode, h, w)}"
        )
    cfg = CodecConfig(q_scale=ry.q_scale, transform=ry.transform)
    meta = {
        "y_q_table": ry.q_table,
        "c_q_table": rcb.q_table,
        "orig_shape": (h, w),
        "chroma_shape": (ch, cw),
        "subsample": mode,
        "q_scale": ry.q_scale,
        "transform": ry.transform,
    }
    if row_range is not None:
        out_shape = (b - a, w, 3)
    elif m is not None:
        out_shape = (scaled_shape_m8(h, m), scaled_shape_m8(w, m), 3)
    else:
        out_shape = (h, w, 3)
    out = _out_raster(out, out_npy, out_shape)
    # path decision from headers only (see docstring); partial modes take
    # the paths their in-memory CLI twins take (decode_color /
    # decode_color_scaled)
    use_u8 = (
        m is None and n_planes is None and row_range is None
        and ry.q_table == "luma" and rcb.q_table == "chroma"
        and supports_color_u8(pipeline, cfg, *color_kernel_shape(h, w), mode)
        and (ry.h, ry.w) == padded_shape(h, w)
        and (rcb.h, rcb.w) == padded_shape(ch, cw)
    )

    def finish_at(pos, keep):
        def finish(rec):
            if row_range is not None:
                w0, w1 = max(a, pos), min(b, pos + keep)
                if w1 > w0:
                    out[w0 - a : w1 - a] = rec[w0 - pos : w1 - pos]
            elif m is not None:
                out[pos * m // 8 : pos * m // 8 + rec.shape[0]] = rec
            else:
                out[pos : pos + keep] = rec
        return finish

    def u8_band(yb, cbb, crb, keep, finish):
        hk, wk = color_kernel_shape(keep, w)
        chk, cwk = _chroma_plane_shape(mode, hk, wk)

        def fill_cc(v):
            _fill_zero(v[:chk], cbb)
            _fill_zero(v[chk:], crb)

        st.band(
            [((hk, wk), np.int8, lambda v: _fill_zero(v, yb)), ((2 * chk, cwk), np.int8, fill_cc)],
            lambda y, cc: (_decode_u8_padded(pipeline, y, cc, cfg, mode).movedim(0, -1)[:keep, :w]
                           .contiguous(),),
            finish,
        )

    def other_band(band_planes, band_meta, finish):
        def fn(y, cb, cr):
            pl = {"y": y, "cb": cb, "cr": cr}
            if m is not None:
                fac = 8 // m if 8 % m == 0 else None
                rec = decode_color_scaled(pipeline, pl, band_meta, cfg, fac, m=None if fac else m)
            else:
                rec = decode_color(pipeline, pl, band_meta, cfg)
            return (rec.contiguous(),)

        st.band([_as_is(band_planes[k]) for k in ("y", "cb", "cr")], fn, finish)

    pos, cpos = start, start // fy
    with _Staging(default_device(device)) as st:
        while pos < stop:
            keep_c = min(band_rows, stop - pos)  # container luma rows this band
            c_take = ((crange_c[1] if crange_c else ch_c) - cpos
                      if pos + keep_c >= stop else keep_c // fy)
            keep = min(keep_c, h - pos)  # original pixel rows this band
            yb = ry.pull(keep_c)
            cbb, crb = rcb.pull(c_take), rcr.pull(c_take)
            if keep <= 0:
                pos += keep_c
                cpos += c_take
                continue
            ckeep = min(-(-keep // fy), ch - pos // fy)
            band_meta = {**meta, "orig_shape": (keep, w), "chroma_shape": (ckeep, cw)}
            band_planes = {"y": yb, "cb": cbb, "cr": crb}
            if use_u8:
                if not all(_fits_i8(v) for v in band_planes.values()):
                    raise ValueError(
                        "stream values exceed int8 despite an int8-safe "
                        "header (foreign or corrupt stream); use the "
                        "in-memory decode"
                    )
                u8_band(yb, cbb, crb, keep, finish_at(pos, keep))
            else:
                other_band(band_planes, band_meta, finish_at(pos, keep))
            pos += keep_c
            cpos += c_take
            yb = cbb = crb = band_planes = None  # release slabs (arena reuse)
    for rd in (ry, rcb, rcr):
        rd.drain()  # run each plane's end-of-payload framing validation
    return out
