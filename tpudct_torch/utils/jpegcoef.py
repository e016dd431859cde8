"""Coefficient-domain JPEG interop: the counterpart of
``tpudct/utils/jpegcoef.py`` (the same functions, messages and bytes).

- :func:`import_jpeg` reads a JPEG's quantized DCT coefficients without any
  IDCT and wraps them in a ``.tdc`` (gray) or ``.tdcc`` (YCbCr) stream:
  ``transform="dct"``, ``q_scale=1``, the file's own quantization tables
  embedded as custom q-tables, and its APPn/COM segments in a trailing
  TDCM chunk.  The orthonormal 2-D DCT is the ITU-T T.81 DCT, so decoding
  the stream through the port's pipelines reproduces libjpeg's decode
  within its integer-IDCT +-1 class.
- :func:`export_jpeg` entropy-encodes a ``transform="dct"`` stream straight
  into a ``.jpg`` (no FDCT, no requantization; export then import returns
  the identical maps), with the TDCM chunk's segments spliced back.

The coefficient access is the host JPEG library's
(``tpudct_jpeg_read_coefs`` and ``tpudct_jpeg_write_coefs_ex`` of
``csrc/jpeg_codec.c``, built by :mod:`tpudct_torch.utils.native`).  There
is no pure-Python fallback: without the library (no libjpeg headers, or
``TPUDCT_NO_NATIVE_JPEG`` set) :func:`coef_io_available` is False and the
reader and writer raise.  Everything here is host work on host arrays.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

_MAXC = 4  # TPUDCT_MAX_COMPS in csrc/jpeg_codec.c
NATIVE_HINT = ("the native JPEG library (csrc/jpeg_codec.c, built against the "
               "libjpeg headers by tpudct_torch.utils.native)")
_NO_LIBRARY = f"coefficient-domain JPEG I/O needs {NATIVE_HINT}; no pure-Python fallback exists"


def _get_lib():
    """The host JPEG library (its coefficient entry points bound in
    ``native._SIGNATURES``), or None where it is off or does not build."""
    from tpudct_torch.utils.native import jpeg_library

    return jpeg_library()


def coef_io_available() -> bool:
    """The JPEG library built and ``TPUDCT_NO_NATIVE_JPEG`` is unset."""
    return _get_lib() is not None


_READ_ERRORS = {
    1: "cannot open file",
    2: "libjpeg failed to parse the stream",
    3: "out of memory",
    4: "unsupported colorspace or component count (grayscale/YCbCr only)",
    5: "stream carries no quantization table",
}


def read_jpeg_coefficients(path: str) -> dict:
    """Read a JPEG's quantized DCT coefficients without decoding pixels.

    Returns {"comps": [per-component dicts], "shape": (h, w) pixel dims}.
    Each component dict: "map" int16 (Hb*8, Wb*8) coefficient map in the
    .tdc block-raster layout, "qtab" float32 (8, 8) quantization table
    (natural order), "samp" (h_samp, v_samp) sampling factors."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(_NO_LIBRARY)
    i16p = ctypes.POINTER(ctypes.c_short)
    bufs = (i16p * _MAXC)()
    cw = (ctypes.c_int * _MAXC)()
    ch = (ctypes.c_int * _MAXC)()
    qt = (ctypes.c_ushort * (_MAXC * 64))()
    hs = (ctypes.c_int * _MAXC)()
    vs = (ctypes.c_int * _MAXC)()
    nc, iw, ih = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.tpudct_jpeg_read_coefs(
        str(path).encode(), bufs, cw, ch, qt, hs, vs,
        ctypes.byref(nc), ctypes.byref(iw), ctypes.byref(ih),
    )
    if rc != 0:
        raise IOError(
            f"coefficient read failed for {path}: "
            f"{_READ_ERRORS.get(rc, f'rc={rc}')}"
        )
    comps = []
    for c in range(nc.value):
        try:
            m = np.ctypeslib.as_array(
                bufs[c], shape=(ch[c] * cw[c],)
            ).reshape(ch[c], cw[c]).copy()
        finally:
            lib.tpudct_free(ctypes.cast(bufs[c], ctypes.POINTER(ctypes.c_ubyte)))
        comps.append({
            "map": m,
            "qtab": np.ctypeslib.as_array(qt)[c * 64 : (c + 1) * 64]
            .reshape(8, 8).astype(np.float32),
            "samp": (hs[c], vs[c]),
        })
    return {"comps": comps, "shape": (ih.value, iw.value)}


def write_jpeg_coefficients(path: str, comps: list, shape: tuple,
                            optimize: bool = False,
                            progressive: bool = False,
                            arithmetic: bool = False) -> None:
    """Entropy-encode coefficient maps into a .jpg (inverse of
    `read_jpeg_coefficients`; same comps/shape structure).  Maps must be
    int16-valued with per-block magnitudes inside the T.81 Huffman
    category range (|AC| <= 1023, |DC step| <= 2047) — libjpeg rejects
    the stream otherwise.

    `optimize` computes two-pass optimal Huffman tables (jpegtran
    -optimize); `progressive` emits libjpeg's standard progressive scan
    script (jpegtran -progressive; implies optimize — the standard
    defines no canned progressive tables); `arithmetic` switches to
    T.81 arithmetic entropy coding (jpegtran -arithmetic; supersedes
    Huffman optimization, combines with progressive; smaller but less
    widely decodable).  All re-code the SAME coefficients, so every
    path through this writer stays bit-lossless."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(_NO_LIBRARY)
    n = len(comps)
    if n not in (1, 3):
        raise ValueError(f"expected 1 or 3 components, got {n}")
    i16p = ctypes.POINTER(ctypes.c_short)
    maps = [np.ascontiguousarray(c["map"], np.int16) for c in comps]
    for m in maps:
        if m.ndim != 2 or m.shape[0] % 8 or m.shape[1] % 8:
            raise ValueError(f"coefficient map shape {m.shape} not 8-aligned")
        # T.81 baseline Huffman categories cap AC at 10 bits and DC DIFFs
        # at 11 — and this libjpeg build does NOT reject violations, it
        # silently emits a corrupt scan (measured: DC 30000 reads back as
        # 41).  Validate here; max|diff| <= max-min (order-independent
        # bound covering any MCU scan order, plus the first diff from 0).
        dc = m[::8, ::8].astype(np.int32)
        ac = m.reshape(m.shape[0] // 8, 8, m.shape[1] // 8, 8).copy()
        ac[:, 0, :, 0] = 0
        if np.abs(ac).max() > 1023:
            raise ValueError(
                "AC coefficient outside JPEG's Huffman range (|AC| <= 1023)"
                " — very low q_scale streams are not expressible as .jpg"
            )
        if abs(int(dc[0, 0])) > 2047 or int(dc.max()) - int(dc.min()) > 2047:
            raise ValueError(
                "DC coefficient steps outside JPEG's Huffman range "
                "(|diff| <= 2047) — not expressible as .jpg"
            )
    qcat = np.concatenate([
        np.rint(np.asarray(c["qtab"], np.float64)).astype(np.int64).ravel()
        for c in comps
    ])
    if (qcat < 1).any() or (qcat > 32767).any():
        raise ValueError("quantization table values must lie in [1, 32767]")
    bufs = (i16p * n)(*[m.ctypes.data_as(i16p) for m in maps])
    cw = (ctypes.c_int * n)(*[m.shape[1] for m in maps])
    ch = (ctypes.c_int * n)(*[m.shape[0] for m in maps])
    qt = (ctypes.c_ushort * (n * 64))(*qcat.tolist())
    hs = (ctypes.c_int * n)(*[int(c["samp"][0]) for c in comps])
    vs = (ctypes.c_int * n)(*[int(c["samp"][1]) for c in comps])
    h, w = shape
    flags = ((1 if optimize else 0) | (2 if progressive else 0)
             | (4 if arithmetic else 0))
    rc = lib.tpudct_jpeg_write_coefs_ex(
        str(path).encode(), bufs, cw, ch, qt, hs, vs, n, int(w), int(h),
        flags,
    )
    if rc == 6:
        raise ValueError(
            f"coefficient map dims {[m.shape for m in maps]} do not match "
            f"pixel shape {shape} with sampling "
            f"{[c['samp'] for c in comps]}"
        )
    if rc == 1:
        raise IOError(f"cannot open {path} for writing")
    if rc != 0:
        # rc=2 is libjpeg's setjmp error path — stream- or build-intrinsic
        # (not transient I/O), so raise ValueError: coefficient magnitudes
        # outside the entropy coder's range (the Python-side pre-validation
        # above covers baseline Huffman, but custom callers may bypass it)
        # or a requested coding this libjpeg build does not support
        # (e.g. arithmetic without C_ARITH_CODING_SUPPORTED).
        raise ValueError(
            f"libjpeg rejected the coefficient write for {path} (rc={rc}): "
            "coefficients outside the entropy coder's range (Huffman caps "
            "|AC| <= 1023, |DC step| <= 2047) or the requested entropy "
            "coding (arithmetic/progressive) is unsupported by this "
            "libjpeg build"
        )


# JPEG sampling-factor patterns <-> tpudct subsample modes.  The luma
# factor pair keys the mode; chroma must be (1, 1) in all three.
_SAMP_TO_MODE = {(2, 2): "420", (2, 1): "422", (1, 1): False}
_MODE_TO_SAMP = {v: k for k, v in _SAMP_TO_MODE.items()}

# ---- JPEG metadata (EXIF / ICC / comments) ---------------------------------
#
# Coefficient arrays carry no APPn/COM segments, so "lossless transcode"
# must shuttle them separately: import captures every APPn/COM segment
# verbatim and appends them to the container as a trailing TDCM chunk
# (magic + uint32 length + raw segments — every .tdc/.tdcc parser reads
# its own framing and ignores trailing bytes, so old readers are
# unaffected); export splices them back, replacing whatever header
# markers libjpeg emitted.  Without this, an EXIF Orientation tag or ICC
# profile would silently vanish through jpg -> tdc -> jpg.

_META_MAGIC = b"TDCM"
_MARKER_SET = frozenset(range(0xE0, 0xF0)) | {0xFE}  # APP0-APP15, COM


def _walk_segments(jpg: bytes):
    """Yield (marker_byte, start, end) for each marker segment after SOI,
    stopping at SOS (the entropy stream follows, no more header markers)."""
    if jpg[:2] != b"\xff\xd8":
        return
    pos = 2
    n = len(jpg)
    while pos + 4 <= n:
        if jpg[pos] != 0xFF:
            return  # not a marker boundary: bail, keep what we have
        marker = jpg[pos + 1]
        if marker == 0xDA:  # SOS
            return
        if 0xD0 <= marker <= 0xD9 or marker == 0x01:
            pos += 2  # standalone marker, no length field
            continue
        seg_len = int.from_bytes(jpg[pos + 2 : pos + 4], "big")
        if seg_len < 2 or pos + 2 + seg_len > n:
            return
        yield marker, pos, pos + 2 + seg_len
        pos += 2 + seg_len


def _jpeg_markers(jpg: bytes) -> bytes:
    """Every APPn/COM segment of a JPEG header, verbatim and in order."""
    return b"".join(
        jpg[a:b] for m, a, b in _walk_segments(jpg) if m in _MARKER_SET
    )


def _splice_markers(jpg: bytes, blob: bytes) -> bytes:
    """Replace a JPEG's header APPn/COM segments with `blob` (placed right
    after SOI, so an EXIF-first or JFIF-first source layout is restored
    exactly).  Header segments are contiguous from SOI to SOS, so the
    output is SOI + blob + (non-APP/COM header segments) + SOS onward."""
    segs = list(_walk_segments(jpg))
    if not segs:
        return jpg
    kept = b"".join(jpg[a:b] for m, a, b in segs if m not in _MARKER_SET)
    tail_start = segs[-1][2]  # SOS marker + entropy-coded stream
    return jpg[:2] + blob + kept + jpg[tail_start:]


def _attach_metadata(container: bytes, blob: bytes) -> bytes:
    if not blob:
        return container
    return container + _META_MAGIC + struct.pack("<I", len(blob)) + blob


def _extract_metadata(container: bytes) -> bytes:
    """The TDCM chunk's payload, or b'' (absent/malformed tails are not an
    error — the coefficient payload already parsed)."""
    from tpudct_torch.utils.serialize import inspect_stream

    try:
        end = inspect_stream(container)["total_bytes"]
    except ValueError:
        return b""
    tail = container[end:]
    if len(tail) < 8 or tail[:4] != _META_MAGIC:
        return b""
    (n,) = struct.unpack("<I", tail[4:8])
    if len(tail) < 8 + n:
        return b""
    return tail[8 : 8 + n]


def _chroma_shape(shape: tuple, mode) -> tuple:
    h, w = shape
    if mode == "420":
        return ((h + 1) // 2, (w + 1) // 2)
    if mode == "422":
        return (h, (w + 1) // 2)
    return (h, w)


def import_jpeg(path: str, codec: str = "auto") -> bytes:
    """JPEG -> .tdc/.tdcc without touching pixels: the file's quantized
    coefficients and quantization tables become a `transform="dct"`
    stream (tables embedded as custom q-tables, q_scale=1).  Grayscale
    files yield .tdc bytes; 3-component YCbCr files yield .tdcc bytes
    (the per-plane headers carry the file's own luma/chroma tables via
    meta["y_q_table"]/["c_q_table"]).  Supported chroma layouts: 4:4:4,
    4:2:0, 4:2:2 — anything else (e.g. 4:1:1) has no .tdcc subsample
    mode and is refused."""
    from tpudct_torch.constants import register_q_table
    from tpudct_torch.utils.serialize import coefficients_to_bytes, color_to_bytes

    r = read_jpeg_coefficients(path)
    with open(path, "rb") as f:
        markers = _jpeg_markers(f.read())
    comps = r["comps"]
    if len(comps) == 1:
        name = register_q_table(comps[0]["qtab"])
        return _attach_metadata(coefficients_to_bytes(
            comps[0]["map"].astype(np.float32), q_scale=1.0,
            orig_shape=r["shape"], transform="dct", q_table=name, codec=codec,
        ), markers)
    if len(comps) != 3:
        raise ValueError(
            f"{path} has {len(comps)} components; coefficient-level import "
            "supports grayscale and 3-component YCbCr JPEGs"
        )
    y, cb, cr = comps
    # Sampling is a RATIO: (2,2)/(1,1) and (2,2)x3 both mean the luma:
    # chroma ratio their dims encode — key the mode on y/cb, not on the
    # absolute factors (some hardware encoders emit non-normalized ones).
    mode = None
    if cb["samp"] == cr["samp"]:
        (yh, yv), (ch_, cv) = y["samp"], cb["samp"]
        if yh % ch_ == 0 and yv % cv == 0:
            # .get default None; a (1,1) ratio maps to False (4:4:4),
            # which is a VALID mode — test `is None`, not truthiness
            mode = _SAMP_TO_MODE.get((yh // ch_, yv // cv), None)
    if mode is None:
        raise ValueError(
            f"unsupported chroma layout {[c['samp'] for c in comps]}; "
            ".tdcc carries 4:4:4 / 4:2:0 / 4:2:2 (use pixel-domain "
            "`encode --color` for this file)"
        )
    if not np.array_equal(cb["qtab"], cr["qtab"]):
        raise ValueError(
            f"{path}: Cb and Cr use different quantization tables; .tdcc "
            "chroma planes share one (use pixel-domain `encode --color`)"
        )
    meta = {
        "orig_shape": r["shape"],
        "chroma_shape": _chroma_shape(r["shape"], mode),
        "subsample": mode,
        "y_q_table": register_q_table(y["qtab"]),
        "c_q_table": register_q_table(cb["qtab"]),
    }
    planes = {k: c["map"].astype(np.float32)
              for k, c in zip(("y", "cb", "cr"), comps)}
    return _attach_metadata(
        color_to_bytes(planes, meta, q_scale=1.0, transform="dct",
                       codec=codec),
        markers,
    )


def _integer_qtab(q_table: str, q_scale: float) -> np.ndarray:
    from tpudct_torch.constants import get_q_table

    q = np.asarray(get_q_table(q_table), np.float64) * float(q_scale)
    qi = np.rint(q)
    if not np.allclose(q, qi, atol=1e-3) or (qi < 1).any() or (qi > 32767).any():
        raise ValueError(
            f"Q table {q_table!r} x q_scale={q_scale} is not integer-valued "
            "in [1, 32767]; JPEG files cannot carry this quantizer"
        )
    return qi.astype(np.float32)


def _require_dct(transform: str) -> None:
    if transform != "dct":
        raise ValueError(
            f"coefficient-level export needs transform='dct' (this stream "
            f"uses {transform!r} — its coefficients are not JPEG DCT "
            "coefficients); `decode` to pixels and re-encode instead"
        )


def export_jpeg(data: bytes, path: str, optimize: bool = False,
                progressive: bool = False,
                arithmetic: bool = False) -> None:
    """`transform="dct"` .tdc/.tdcc -> .jpg at the coefficient level
    (bit-exact; no IDCT/FDCT runs).  The stream's Q·q_scale must round to
    integers in [1, 32767] — exactly the tables JPEG files can carry.
    Metadata captured at import (TDCM chunk: EXIF/ICC/APPn/COM segments)
    is spliced back into the output header verbatim.  `optimize` /
    `progressive` select jpegtran's -optimize / -progressive entropy
    coding for the output scan — same coefficients, smaller file."""
    from tpudct_torch.utils.serialize import (
        bytes_to_coefficients, bytes_to_color, is_color_stream,
    )

    if is_color_stream(data):
        planes, meta = bytes_to_color(data)
        _require_dct(meta["transform"])
        yq = _integer_qtab(meta["y_q_table"], meta["q_scale"])
        cq = _integer_qtab(meta["c_q_table"], meta["q_scale"])
        lsamp = _MODE_TO_SAMP[meta["subsample"]]
        write_jpeg_coefficients(
            path,
            [{"map": planes["y"].astype(np.int16), "qtab": yq, "samp": lsamp},
             {"map": planes["cb"].astype(np.int16), "qtab": cq, "samp": (1, 1)},
             {"map": planes["cr"].astype(np.int16), "qtab": cq, "samp": (1, 1)}],
            meta["orig_shape"], optimize=optimize, progressive=progressive,
            arithmetic=arithmetic,
        )
    else:
        coeffs, q_scale, _rk, orig_shape, transform, q_table = (
            bytes_to_coefficients(
                data, with_orig_shape=True, with_transform=True,
                with_q_table=True,
            )
        )
        _require_dct(transform)
        write_jpeg_coefficients(
            path,
            [{"map": coeffs.astype(np.int16),
              "qtab": _integer_qtab(q_table, q_scale), "samp": (1, 1)}],
            orig_shape, optimize=optimize, progressive=progressive,
            arithmetic=arithmetic,
        )
    markers = _extract_metadata(data)
    if markers:
        with open(path, "rb") as f:
            jpg = f.read()
        with open(path, "wb") as f:
            f.write(_splice_markers(jpg, markers))
