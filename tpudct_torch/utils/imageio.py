"""Image I/O: JPEG (grayscale and interleaved RGB), the lossless formats and
``.npy`` rasters; the counterpart of ``tpudct/utils/imageio.py``.

JPEG rides the native C codec (``csrc/jpeg_codec.c`` on libjpeg, built and
loaded by :mod:`tpudct_torch.utils.native`); where that library is off
(``TPUDCT_NO_NATIVE_JPEG``) or does not build (no libjpeg), JPEG goes
through PIL, as in the reference.  The lossless formats other than
``.npy`` need PIL; ``.npy`` needs neither.  PIL is imported only inside the
branches that use it.
"""

from __future__ import annotations

import ctypes
import io
import os
import pathlib

import numpy as np

from tpudct_torch.utils import native


def native_backend_available() -> bool:
    return native.jpeg_library() is not None


def load_jpeg(path: str, force_gray: bool = True) -> np.ndarray:
    """Decode a JPEG to a (H, W) uint8 array (grayscale).

    Unlike the reference loader — which returns native channels and whose
    main programs then treat RGB data as single-channel (utils.cu:70-72 with
    main_cublass.cu:50-57) — RGB inputs are converted to luminance
    in-codec.
    """
    lib = native.jpeg_library()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_ubyte)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        ch = ctypes.c_int()
        rc = lib.tpudct_jpeg_decode(
            str(path).encode(), ctypes.byref(out), ctypes.byref(w),
            ctypes.byref(h), ctypes.byref(ch), 1 if force_gray else 0,
        )
        if rc != 0:
            raise IOError(f"native JPEG decode failed (rc={rc}) for {path}")
        try:
            n = h.value * w.value * ch.value
            arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
        finally:
            lib.tpudct_free(out)
        if ch.value == 1:
            return arr.reshape(h.value, w.value)
        return arr.reshape(h.value, w.value, ch.value)
    from PIL import Image

    img = Image.open(path)
    if force_gray:
        img = img.convert("L")
    return np.asarray(img)


def load_jpeg_batch(
    paths, n_threads: int = 0, force_gray: bool = True, errors: str = "raise"
) -> list:
    """Decode many JPEGs in parallel via the C pthread pool.

    The data-loader path: device time is ~0.1 ms/image, so host decode
    dominates bulk encoding — the native pool decodes with true parallelism
    (one libjpeg context per thread, no GIL).  Returns a list of (H, W)
    uint8 arrays in input order.  n_threads=0 = one per CPU (capped at 16).
    errors="raise" (default) raises on the first failed file;
    errors="none" returns None at failed positions — the bulk-encoder mode,
    where one corrupt file must not abort a million-image job.  Falls back
    to sequential load_jpeg when the native codec is unavailable.
    """
    if errors not in ("raise", "none"):
        raise ValueError(f"errors must be 'raise' or 'none', got {errors!r}")
    paths = [str(p) for p in paths]
    lib = native.jpeg_library()
    if lib is None or not paths:
        out = []
        for p_ in paths:
            try:
                out.append(load_jpeg(p_, force_gray))
            except Exception:
                if errors == "raise":
                    raise
                out.append(None)
        return out
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 4, 16)

    n = len(paths)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (u8p * n)()
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    chs = (ctypes.c_int * n)()
    rcs = (ctypes.c_int * n)()
    lib.tpudct_jpeg_decode_batch(
        names, n, n_threads, outs, ws, hs, chs, rcs, 1 if force_gray else 0
    )
    images = [None] * n
    err = None
    try:
        for i in range(n):
            if rcs[i] != 0:
                err = err or IOError(
                    f"native JPEG decode failed (rc={rcs[i]}) for {paths[i]}"
                )
                continue
            cnt = hs[i] * ws[i] * chs[i]
            arr = np.ctypeslib.as_array(outs[i], shape=(cnt,)).copy()
            shape = (hs[i], ws[i]) if chs[i] == 1 else (hs[i], ws[i], chs[i])
            images[i] = arr.reshape(shape)
    finally:
        for i in range(n):
            if outs[i]:
                lib.tpudct_free(outs[i])
    if err is not None and errors == "raise":
        raise err
    return images


def save_jpeg(path: str, image: np.ndarray, quality: int = 100) -> None:
    """Encode a (H, W) grayscale or (H, W, 3) RGB uint8 array to a JPEG file.

    quality=100 matches the original main programs' output setting
    (main_cublass.cu:152).  The RGB form serves the color extension — the
    reference has no color output path at all (utils.cu:70-72 forces
    grayscale at load).
    """
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        ch = 1
    elif image.ndim == 3 and image.shape[2] == 3:
        ch = 3
    else:
        raise ValueError(f"expected (H, W) grayscale or (H, W, 3) RGB, got {image.shape}")
    lib = native.jpeg_library()
    if lib is not None:
        h, w = image.shape[:2]
        rc = lib.tpudct_jpeg_encode_ch(
            str(path).encode(),
            image.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h, ch,
            quality,
        )
        if rc != 0:
            raise IOError(f"native JPEG encode failed (rc={rc}) for {path}")
        return
    from PIL import Image

    Image.fromarray(image, mode="L" if ch == 1 else "RGB").save(
        path, format="JPEG", quality=quality
    )


def encode_jpeg_bytes(image: np.ndarray, quality: int = 100) -> bytes:
    """Encode to an in-memory JPEG (for compressed-size measurement).

    Accepts (H, W) grayscale or (H, W, 3) interleaved RGB — the RGB form
    rides libjpeg's standard color path (YCbCr + 4:2:0 by default), the
    anchor the color BD-rate comparison measures against."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        ch = 1
    elif image.ndim == 3 and image.shape[2] == 3:
        ch = 3
    else:
        raise ValueError(
            f"expected (H, W) grayscale or (H, W, 3) RGB, got {image.shape}"
        )
    lib = native.jpeg_library()
    if lib is not None:
        h, w = image.shape[:2]
        out = ctypes.POINTER(ctypes.c_ubyte)()
        size = ctypes.c_ulong()
        rc = lib.tpudct_jpeg_encode_mem(
            image.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h, ch,
            quality, ctypes.byref(out), ctypes.byref(size),
        )
        if rc != 0:
            raise IOError(f"native in-memory JPEG encode failed (rc={rc})")
        try:
            return bytes(np.ctypeslib.as_array(out, shape=(size.value,)))
        finally:
            lib.tpudct_free(out)
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image, mode="L" if ch == 1 else "RGB").save(
        buf, format="JPEG", quality=quality
    )
    return buf.getvalue()


# ---- extension-dispatched I/O ----------------------------------------------

JPEG_EXTS = frozenset({".jpg", ".jpeg", ".jpe", ".jfif"})
# .npy: raw uint8 raster as a NumPy array file — lossless, memmap-friendly
# (the streamed CLI decode open_memmap's it so beyond-RAM rasters write to
# disk band by band without ever residing in host memory)
LOSSLESS_EXTS = frozenset({".png", ".bmp", ".tif", ".tiff", ".npy"})
SUPPORTED_EXTS = JPEG_EXTS | LOSSLESS_EXTS


def load_image(path: str, force_gray: bool = True) -> np.ndarray:
    """Load any common image format: JPEGs ride the native libjpeg path
    (`load_jpeg`), everything else (.png, .bmp, .tiff, ...) decodes via PIL;
    .npy rasters memory-map read-only (mmap_mode="r", so a
    larger-than-RAM raster written by the streamed decode loads lazily).

    Beyond-parity: the reference reads JPEG only (utils.cu:38-95).  Note
    the PIL branch's gray conversion uses the same BT.601 weights as
    `load_jpeg`'s in-codec path but a different rounding rule (PIL
    truncates where libjpeg rounds), so identical pixel content stored as
    PNG vs JPEG can convert with ±1 per-pixel differences."""
    ext = pathlib.Path(path).suffix.lower()
    if ext in JPEG_EXTS:
        return load_jpeg(path, force_gray=force_gray)
    if ext == ".npy":
        arr = np.load(path, mmap_mode="r")
        if force_gray and arr.ndim == 3:
            # BT.601 with libjpeg-style rounding, matching load_jpeg —
            # converted in ROW BANDS so a larger-than-RAM raster written
            # by the streamed decoders never materializes f64 temporaries
            # whole (a one-shot astype would defeat the memmap's
            # beyond-RAM purpose)
            out = np.empty(arr.shape[:2], np.uint8)
            # ~64 MB of f64 temporaries per band: 3 channels x 8 bytes
            step = max(1, (64 << 20) // max(1, arr.shape[1] * 24))
            for r0 in range(0, arr.shape[0], step):
                a = arr[r0 : r0 + step].astype(np.float64)
                out[r0 : r0 + step] = np.clip(np.floor(
                    0.299 * a[..., 0] + 0.587 * a[..., 1]
                    + 0.114 * a[..., 2] + 0.5
                ), 0, 255).astype(np.uint8)
            return out
        return arr
    from PIL import Image

    img = Image.open(path)
    if force_gray:
        img = img.convert("L")
    elif img.mode not in ("L", "RGB"):
        img = img.convert("RGB")
    return np.asarray(img)


def probe_image_size(path: str):
    """(height, width) from the file header only — no pixel decode.

    Used by the bulk commands to bound per-wave host residency before
    loading anything.  Returns None when the header can't be read (the
    caller treats the file as size-unknown; the actual load surfaces the
    error with the per-file recovery contract).  A ``.npy`` raster is
    size-unknown here too, as it is to PIL, without importing PIL."""
    if pathlib.Path(path).suffix.lower() == ".npy":
        return None
    from PIL import Image

    try:
        with Image.open(path) as img:
            w, h = img.size
        return h, w
    except (OSError, ValueError):
        return None


def save_image(path: str, image: np.ndarray, quality: int = 100) -> None:
    """Save dispatched on extension: .jpg/.jpeg goes through `save_jpeg`
    (native libjpeg, `quality` honored — the reference's output path);
    the LOSSLESS_EXTS formats (.png/.bmp/.tiff) save losslessly via PIL,
    so `decode out.png` yields the EXACT reconstruction with no second
    JPEG generation loss (JPEG quality-100 is near-lossless, not
    lossless).  Other extensions are refused rather than silently routed
    through a lossy PIL default (e.g. .webp saves quality-80)."""
    ext = pathlib.Path(path).suffix.lower()
    if ext in JPEG_EXTS:
        return save_jpeg(path, image, quality=quality)
    if ext == ".npy":
        # raw raster container (lossless; the streamed decoders write it
        # incrementally via open_memmap — this whole-array path is for the
        # in-memory decodes' parity with them)
        return np.save(path, np.ascontiguousarray(image, dtype=np.uint8))
    if ext not in LOSSLESS_EXTS:
        # extensionless paths are refused too — silently writing a LOSSY
        # jpeg to a bare name would contradict the policy above
        raise ValueError(
            f"unsupported output extension {ext!r}: use one of "
            f"{sorted(JPEG_EXTS)} (lossy, quality honored) or "
            f"{sorted(LOSSLESS_EXTS)} (lossless)"
        )
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        mode = "L"
    elif image.ndim == 3 and image.shape[2] == 3:
        mode = "RGB"
    else:
        raise ValueError(
            f"expected (H, W) grayscale or (H, W, 3) RGB, got {image.shape}"
        )
    from PIL import Image

    Image.fromarray(image, mode=mode).save(path)
