"""Lossless coefficient-domain geometric edits on .tdc / .tdcc streams:
the counterpart of ``tpudct/utils/coefops.py`` (the same ops, refusals
and bytes).

The reference's only persisted artifact is a lossy quality-100 pixel
re-encode (utils.cu:98-147) — any geometric edit there costs a full
decode → edit → re-quantize generation.  This module gives the native
containers the `jpegtran` capability set instead: flip / rotate /
transpose / block-aligned crop applied directly to the stored quantized
coefficients, with zero generation loss.

Math.  A stored block is ``Y = round(T·X·Tᵀ / Q)``.  Let ``F`` be the
8-point index-reversal permutation.  Every transform in the registry has
basis rows that are symmetric or antisymmetric under reversal, i.e.
``T·F = D·T`` for a diagonal sign matrix ``D`` (derived numerically per
transform in :func:`flip_sign_diag`, exact for the integer cores).  Then

  column flip  ``X' = X·F``  ⇒  ``T·X'·Tᵀ = (T·X·Tᵀ)·Dᵀ = Y_raw·D``
  row flip     ``X' = F·X``  ⇒  ``T·X'·Tᵀ = D·Y_raw``
  transpose    ``X' = Xᵀ``   ⇒  ``T·X'·Tᵀ = Y_rawᵀ``

Sign flips commute with the elementwise quantizer exactly (|y| is
unchanged; round-half-away-from-zero is an odd function, ops/rounding.py),
so flips act on the stored integers as pure sign patterns plus a block
permutation.  Transposition swaps the quantizer denominators ``Q[i,j] ↔
Q[j,i]``; since the JPEG tables are not symmetric, the q-table is
transposed *with* the data (the jpegtran approach) and rides the stream
as an embedded custom table (constants.register_q_table) when the result
is not a registered builtin.

Partial edge blocks: coefficient maps are stored padded to 8-multiples
with the true size in ``orig_shape``.  An edit that would move padding
away from the trailing (bottom/right) edge cannot be represented, so —
like ``jpegtran -perfect`` — such edits REFUSE with a clear error instead
of silently emitting the garbage strip jpegtran produces by default.
Alignment rules (the refusing dimension must be a multiple of):
  gray:   hflip → width % 8, vflip → height % 8; transpose/rot180 etc.
          compose these; transpose alone is always representable.
  color:  4:4:4 like gray; 4:2:0 needs % 16 on the flipped axis;
          4:2:2 needs width % 16 for hflip, height % 8 for vflip, and
          refuses transposing ops outright (a transposed 4:2:2 stream
          would be 4:4:0, which no decoder here implements).

Everything runs on the host in numpy, as in the reference: an edit
permutes stored integers of host files, far below the entropy stage's own
cost, so a round trip through the card would be pure overhead.  The
decode of an edited stream is where the card comes in.
"""

from __future__ import annotations

import numpy as np

from tpudct_torch.constants import get_q_table, get_transform, register_q_table

_BS = 8

# Ops, normalized.  rot90 is CLOCKWISE (jpegtran convention):
# rot90 = transpose then hflip; rot270 = transpose then vflip.
OPS = ("hflip", "vflip", "rot90", "rot180", "rot270", "transpose")
_TRANSPOSING = {"rot90", "rot270", "transpose"}


def flip_sign_diag(transform: str) -> np.ndarray:
    """The diagonal of D with ``T·F = D·T`` for this transform's basis.

    For every shipped transform the rows alternate even/odd reversal
    parity exactly like the true DCT-II basis (row k has parity (−1)^k),
    but the result is *derived* from the actual matrix, not assumed: a
    future registered transform without pure row parity gets a clear
    refusal instead of a corrupted stream.
    """
    t = np.asarray(get_transform(transform).t, np.float64)
    rev = t[:, ::-1]
    sign = np.empty(_BS, np.float32)
    for i in range(_BS):
        if np.array_equal(rev[i], t[i]):
            sign[i] = 1.0
        elif np.array_equal(rev[i], -t[i]):
            sign[i] = -1.0
        # The exact-DCT table is computed by cosine evaluation, so mirror
        # entries can differ in the last ulp; accept approximate parity
        # (the stored integers still flip exactly — only the implicit
        # basis association is ulp-approximate, inside the documented
        # ±1-quantizer-tie class).
        elif np.allclose(rev[i], t[i], atol=1e-6):
            sign[i] = 1.0
        elif np.allclose(rev[i], -t[i], atol=1e-6):
            sign[i] = -1.0
        else:
            raise ValueError(
                f"transform {transform!r} row {i} has no reversal parity; "
                "coefficient-domain flips are not defined for it"
            )
    return sign


def _blocks(c: np.ndarray) -> np.ndarray:
    h, w = c.shape
    return c.reshape(h // _BS, _BS, w // _BS, _BS)


def _unblocks(b: np.ndarray) -> np.ndarray:
    h8, _, w8, _ = b.shape
    return b.reshape(h8 * _BS, w8 * _BS)


def hflip_map(c: np.ndarray, transform: str) -> np.ndarray:
    """Horizontal (left-right) flip of a coefficient map: reverse the
    block columns, then scale each block's columns by the sign diagonal."""
    d = flip_sign_diag(transform)
    b = _blocks(np.asarray(c))[:, :, ::-1, :]
    return _unblocks(b * d[None, None, None, :]).astype(c.dtype)


def vflip_map(c: np.ndarray, transform: str) -> np.ndarray:
    """Vertical (top-bottom) flip: reverse block rows, scale block rows."""
    d = flip_sign_diag(transform)
    b = _blocks(np.asarray(c))[::-1, :, :, :]
    return _unblocks(b * d[None, :, None, None]).astype(c.dtype)


def transpose_map(c: np.ndarray) -> np.ndarray:
    """Transpose: swap the block grid AND each block (Y' = Yᵀ per block)."""
    return _unblocks(_blocks(np.asarray(c)).transpose(2, 3, 0, 1))


def transpose_q_table(name: str) -> str:
    """Registered name of the transposed q-table (jpegtran transposes the
    quant tables with the data).  Symmetric tables map to themselves;
    anything else becomes a content-derived custom name the serializer
    embeds into the stream."""
    q = get_q_table(name)
    qt = np.ascontiguousarray(q.T)
    if np.array_equal(q, qt):
        return name
    # canonicalize: a transpose that lands back on a builtin keeps the
    # builtin name (so transpose∘transpose restores "luma", not an
    # embedded custom copy of the same values)
    for builtin in ("luma", "chroma"):
        if np.array_equal(qt, get_q_table(builtin)):
            return builtin
    return register_q_table(qt)


def crop_map(c: np.ndarray, orig: tuple, y0: int, x0: int, h: int, w: int):
    """Block-aligned lossless crop: returns (cropped map, new orig_shape).

    ``y0``/``x0`` must be multiples of 8 (blocks cannot be re-phased
    without re-transforming); ``h``/``w`` may be arbitrary — the map keeps
    whole blocks (ceil to 8) and the new orig_shape records the true size,
    exactly like a fresh encode of a non-multiple-of-8 image."""
    oh, ow = orig
    if y0 % _BS or x0 % _BS:
        raise ValueError(
            f"crop origin ({y0},{x0}) must be 8-aligned (coefficient "
            "blocks cannot be re-phased losslessly)"
        )
    if h <= 0 or w <= 0 or y0 < 0 or x0 < 0 or y0 + h > oh or x0 + w > ow:
        raise ValueError(
            f"crop {h}x{w}+{y0}+{x0} outside the {oh}x{ow} image"
        )
    bh = (h + _BS - 1) // _BS * _BS
    bw = (w + _BS - 1) // _BS * _BS
    return np.ascontiguousarray(c[y0 : y0 + bh, x0 : x0 + bw]), (h, w)


def _trim(c: np.ndarray, orig: tuple) -> np.ndarray:
    """Drop trailing pad blocks beyond ceil-to-8 of the true size.

    In-framework maps are exactly ceil8(orig) (ops/padding.py), but
    imported JPEG streams can carry MCU padding (16-aligned luma for
    4:2:0, utils/jpegcoef.py) — whole extra pad blocks that a flip would
    otherwise move to the leading edge.  Trimming them is lossless: they
    encode replicated edge pixels the decoder crops away regardless."""
    bh = (orig[0] + _BS - 1) // _BS * _BS
    bw = (orig[1] + _BS - 1) // _BS * _BS
    if c.shape == (bh, bw):
        return c
    return np.ascontiguousarray(c[:bh, :bw])


def _require_aligned(n: int, mult: int, what: str, op: str) -> None:
    if n % mult:
        raise ValueError(
            f"{op}: {what} {n} is not a multiple of {mult}; the trailing "
            "partial block would move off the padded edge (jpegtran "
            "-perfect semantics) — crop to alignment or re-encode in the "
            "pixel domain"
        )


def apply_op_map(c, orig, op: str, transform: str):
    """One geometric op on a (map, orig_shape) pair -> (map', orig')."""
    oh, ow = orig
    if op == "hflip":
        _require_aligned(ow, _BS, "width", op)
        return hflip_map(c, transform), (oh, ow)
    if op == "vflip":
        _require_aligned(oh, _BS, "height", op)
        return vflip_map(c, transform), (oh, ow)
    if op == "transpose":
        return transpose_map(c), (ow, oh)
    if op == "rot180":
        _require_aligned(ow, _BS, "width", op)
        _require_aligned(oh, _BS, "height", op)
        return vflip_map(hflip_map(c, transform), transform), (oh, ow)
    if op == "rot90":  # clockwise: transpose then hflip (new width = oh)
        _require_aligned(oh, _BS, "height", op)
        return hflip_map(transpose_map(c), transform), (ow, oh)
    if op == "rot270":
        _require_aligned(ow, _BS, "width", op)
        return vflip_map(transpose_map(c), transform), (ow, oh)
    raise ValueError(f"unknown op {op!r}; available: {OPS}")


# ---- stream-level API --------------------------------------------------------


def edit_gray(data: bytes, ops, crop=None, codec: str = "auto") -> bytes:
    """Apply crop (first) then each op left-to-right to a .tdc stream."""
    from tpudct_torch.utils.serialize import _parse_plane, coefficients_to_bytes

    plane, _used = _parse_plane(data)
    orig = plane["orig_shape"]
    c = _trim(plane["coeffs"], orig)
    tname = plane["transform"]
    qname = plane["q_table"]
    if crop is not None:
        c, orig = crop_map(c, orig, *crop)
    for op in ops:
        c, orig = apply_op_map(c, orig, op, tname)
        if op in _TRANSPOSING:
            qname = transpose_q_table(qname)
    return coefficients_to_bytes(
        c, plane["q_scale"], plane["retain_k"], orig_shape=orig,
        transform=tname, q_table=qname, codec=codec,
    )


_CHROMA_ALIGN = {  # (hflip width-mult, vflip height-mult) on the LUMA dims
    False: (_BS, _BS),
    "420": (2 * _BS, 2 * _BS),
    "422": (2 * _BS, _BS),
}


def edit_color(data: bytes, ops, crop=None, codec: str = "auto") -> bytes:
    """Apply crop (first) then each op left-to-right to a .tdcc stream."""
    from tpudct_torch.utils.serialize import bytes_to_color, color_to_bytes

    planes, meta = bytes_to_color(data)
    mode = meta["subsample"]
    sy = 2 if mode in ("420",) else 1  # chroma vertical factor
    sx = 2 if mode in ("420", "422") else 1  # chroma horizontal factor
    walign, halign = _CHROMA_ALIGN[mode]
    tname = meta["transform"]
    orig, corig = meta["orig_shape"], meta["chroma_shape"]
    y = _trim(planes["y"], orig)
    cb = _trim(planes["cb"], corig)
    cr = _trim(planes["cr"], corig)

    if crop is not None:
        y0, x0, h, w = crop
        if y0 % (sy * _BS) or x0 % (sx * _BS):
            raise ValueError(
                f"color crop origin ({y0},{x0}) must be aligned to "
                f"({sy * _BS},{sx * _BS}) for {mode or '4:4:4'} chroma"
            )
        y, orig = crop_map(y, orig, y0, x0, h, w)
        ch = (h + sy - 1) // sy
        cw = (w + sx - 1) // sx
        cb, ccorig = crop_map(cb, corig, y0 // sy, x0 // sx, ch, cw)
        cr, _ = crop_map(cr, corig, y0 // sy, x0 // sx, ch, cw)
        corig = ccorig

    for op in ops:
        if op in _TRANSPOSING:
            if mode == "422":
                raise ValueError(
                    f"{op}: a transposed 4:2:2 stream would be 4:4:0, "
                    "which this framework does not decode — convert with "
                    "a pixel-domain re-encode or use 4:2:0/4:4:4"
                )
            meta = {**meta, "y_q_table": transpose_q_table(meta["y_q_table"]),
                    "c_q_table": transpose_q_table(meta["c_q_table"])}
        if op == "hflip":
            _require_aligned(orig[1], walign, "width", op)
        elif op == "vflip":
            _require_aligned(orig[0], halign, "height", op)
        elif op == "rot180":
            _require_aligned(orig[1], walign, "width", op)
            _require_aligned(orig[0], halign, "height", op)
        elif op == "rot90":
            _require_aligned(orig[0], walign, "height", op)
        elif op == "rot270":
            _require_aligned(orig[1], walign, "width", op)
        y, orig = apply_op_map(y, orig, op, tname)
        cb, corig2 = apply_op_map(cb, corig, op, tname)
        cr, _ = apply_op_map(cr, corig, op, tname)
        corig = corig2

    meta = {**meta, "orig_shape": orig, "chroma_shape": corig}
    return color_to_bytes(
        {"y": y, "cb": cb, "cr": cr}, meta, meta["q_scale"],
        meta["retain_k"], meta["transform"], codec=codec,
    )


def to_grayscale(data: bytes, codec: str = "auto") -> bytes:
    """.tdcc → .tdc keeping only the luma plane — `jpegtran -grayscale`.

    Lossless for the retained channel: the Y coefficients, their q-table
    and every header field carry over verbatim; the chroma planes are
    dropped.  A .tdc input passes through unchanged."""
    from tpudct_torch.utils.serialize import (
        _color_plane_slices,
        _parse_plane,
        coefficients_to_bytes,
        is_color_stream,
    )

    if not is_color_stream(data):
        return data
    _sub, slices, _end = _color_plane_slices(data)
    y, _used = _parse_plane(slices[0])
    return coefficients_to_bytes(
        y["coeffs"], y["q_scale"], y["retain_k"],
        orig_shape=y["orig_shape"], transform=y["transform"],
        q_table=y["q_table"], codec=codec,
    )


def edit_stream(
    data: bytes, ops, crop=None, codec: str = "auto", grayscale: bool = False
) -> bytes:
    """Edit a .tdc or .tdcc stream; preserves the trailing TDCM metadata
    chunk (EXIF/ICC — kept verbatim like jpegtran: orientation tags are
    NOT rewritten, matching its default behavior).  `grayscale` drops the
    chroma planes first (jpegtran -grayscale), so subsequent ops run
    under the laxer gray alignment rules."""
    from tpudct_torch.utils import jpegcoef
    from tpudct_torch.utils.serialize import is_color_stream

    ops = [o.strip() for o in ops if o.strip()]
    for o in ops:
        if o not in OPS:
            raise ValueError(f"unknown op {o!r}; available: {OPS}")
    blob = jpegcoef._extract_metadata(data)
    if blob:
        # strip the TDCM tail up front: passthrough branches (gray input +
        # grayscale-only edit) would otherwise return it embedded AND have
        # it re-attached below — a duplicate chunk growing per edit
        data = data[: _stream_end(data)]
    if grayscale:
        data = to_grayscale(data, codec=codec)
    if is_color_stream(data):
        out = edit_color(data, ops, crop=crop, codec=codec)
    elif ops or crop is not None:
        out = edit_gray(data, ops, crop=crop, codec=codec)
    else:
        out = data  # grayscale-only edit: already re-serialized above
    return jpegcoef._attach_metadata(out, blob) if blob else out


def _stream_end(data: bytes) -> int:
    """Byte length of the container proper (header walk only, no payload
    decode) — everything past it is the trailing TDCM metadata chunk."""
    from tpudct_torch.utils.serialize import (
        _color_plane_slices,
        _parse_plane_header,
        is_color_stream,
    )

    if is_color_stream(data):
        return _color_plane_slices(data)[2]
    (*_fields, psize, hsize, _custom_q, _version) = _parse_plane_header(data)
    return hsize + psize
