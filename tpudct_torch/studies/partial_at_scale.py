"""Partial decode of a multi-gigapixel banded archive on the card, with each
phase's peak host residency: the port of ``benchmarks/partial_at_scale.py``.

    python -m tpudct_torch.studies.partial_at_scale <phase> [--dir DIR]
        [--size N] [--band N] [--size-c N] [--device DEVICE]

with <phase> one of ``gen enc preview roi scale`` (gray) or ``genc encc
previewc roic`` (the RGB twin).  A ``--size``² gray image (default 65536² =
2^32 pixels: a 4.3 GB raster, an 8.6 GB int16 coefficient map that never
exists whole anywhere) is written band by band to a ``.npy`` raster in
``--dir`` (``gen``), then streamed through the card in ``--band``-row bands
into a banded ``.tdc`` (``enc``: ``utils.streaming.encode_gray_streamed_bytes``,
one B2 per band), and the archive is

  preview   thumbnailed: DC terms only, one segment resident at a time
            (``serialize.preview_from_bytes``, host arithmetic only);
  roi       ROI-decoded: 100 rows at 125/256 of the height (the reference's
            32000:32100), inside one band; only that band's segment
            entropy-decodes (``decode_gray_streamed(row_range=...)``, B3);
  scale     decoded at 1/8 scale into a (size/8)² raster
            (``decode_gray_streamed(scale_m=1)``, B7 per band).

The color twin (default 32768² RGB, 3.2 GB of pixels): ``genc``, ``encc``
(``encode_color_streamed_bytes``: B8 and two B2 per band), ``previewc``
(``preview_color_from_bytes``) and ``roic`` (rows 125/256 of the height, the
reference's 16000:16100: ``decode_color_streamed(row_range=...)``, the f32
``decode_color`` per band as the CLI's ``--rows`` decodes, B6).

Each phase is meant to run in a process of its own, so that ``maxrss_mb``
(``ru_maxrss``) is that phase's peak host residency; each prints one JSON
line with its wall seconds ``s`` (host clock), its kernel launches by
counter (``launches``) and, for the streamed calls, ``split``:
``utils.streaming.seconds`` of the registry of ``utils.profiling``, on for
the phase (the host wall by part, the CUDA-event spans and the device's
busy seconds); ``start_maxrss_mb`` is the peak before the
phase, once torch is imported (what the process costs before any work);
``roi``, ``scale`` and ``roic`` also give ``decode_maxrss_mb``, the peak
just after the timed decode, before the check's in-memory band.  The validations are the
reference's: the gray ROI equals the covering band encoded and decoded in
memory (``encode_gray_auto`` / ``decode_gray_auto`` on the card) and that
band's segment equals the in-memory coefficients; the 1/8-scale rows of
band 15 of 32 (the same share of the bands at other sizes) equal
``decode_gray_scaled_auto`` of that band; the color ROI equals
``encode_color_u8`` + ``decode_color`` of its covering band.  Bands are
independent, so each holds bit for bit; a failed check raises.

``gen`` and ``genc`` first check the free space in ``--dir`` for the raster
and its archive (counted at an eighth of the raster) and raise with the
numbers where it is short.  They make the bands on a few threads (numpy
releases the interpreter lock in its random and elementwise kernels): the
pixels are the reference's, band for band.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SIZE = 65536
BAND = 2048
SIZE_C = 32768  # the color twin: 1 Gpix RGB = 3.2 GB of pixels
# the files in --dir
PIX = "pas_pixels.u8"
TDC = "pas_big.tdc"
RGB = "pas_rgb.u8"
TDCC = "pas_big.tdcc"
PHASES = ("gen", "enc", "preview", "roi", "scale", "genc", "encc", "previewc", "roic")
#: ROI rows: this many, starting at 125/256 of the height (the reference's
#: 32000 of 65536 and 16000 of 32768), moved up where they would leave the band.
ROI_ROWS = 100


def band_pixels(b: int, size: int = SIZE, band: int = BAND) -> np.ndarray:
    """Deterministic compressible content for gray band b: low-frequency
    structure and mild noise (so the archive is a realistic size, not an
    incompressible noise dump); the reference's values."""
    rng = np.random.default_rng(1000 + b)
    r = (np.arange(b * band, (b + 1) * band, dtype=np.float32) / 97.0)[:, None]
    c = (np.arange(size, dtype=np.float32) / 113.0)[None, :]
    base = 96.0 + 52.0 * np.sin(r) * np.cos(c) + 28.0 * np.sin(0.31 * r + 0.17 * c)
    return np.clip(
        base + rng.normal(0.0, 6.0, (band, size)).astype(np.float32), 0, 255
    ).astype(np.uint8)


def band_rgb(b: int, size_c: int = SIZE_C, band: int = BAND) -> np.ndarray:
    """Deterministic RGB content for color band b: channel-shifted variants
    of the gray generator; the reference's values."""
    rng = np.random.default_rng(5000 + b)
    r = (np.arange(b * band, (b + 1) * band, dtype=np.float32) / 89.0)[:, None]
    c = (np.arange(size_c, dtype=np.float32) / 101.0)[None, :]
    g = 96.0 + 50.0 * np.sin(r) * np.cos(c)
    out = np.empty((band, size_c, 3), np.uint8)
    for ch, phase_ in enumerate((0.0, 0.7, 1.9)):
        out[..., ch] = np.clip(
            g + 24.0 * np.sin(0.29 * r + 0.13 * c + phase_)
            + rng.normal(0.0, 5.0, (band, size_c)).astype(np.float32),
            0, 255,
        ).astype(np.uint8)
    return out


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def roi_rows(size: int, band: int) -> tuple:
    """(a, b): ROI_ROWS rows from 125/256 of `size`, inside one band."""
    a = size * 125 // 256
    start = a - a % band
    b = min(a + ROI_ROWS, start + band)
    return max(start, b - ROI_ROWS), b


def _check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _workers() -> int:
    return max(1, min(8, len(os.sched_getaffinity(0))))


def _free_space(directory: str, raster: int, phase: str, *replaced: str) -> None:
    """Raise unless `directory` holds the raster and its archive (an eighth
    of the raster), counting the files the phase replaces as free."""
    need = raster + raster // 8
    free = shutil.disk_usage(directory).free + sum(
        os.path.getsize(p) for p in replaced if os.path.exists(p))
    if free < need:
        raise RuntimeError(
            f"{phase}: {directory} has {free} bytes free; the {raster}-byte raster and its archive "
            f"need {need}")


def _write_raster(path: str, shape: tuple, band: int, make) -> None:
    """The .npy raster at `path`, band b = make(b), bands made on threads."""
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8, shape=shape)

    def one(b: int) -> None:
        mm[b * band : (b + 1) * band] = make(b)

    with ThreadPoolExecutor(max_workers=_workers()) as ex:
        for fut in [ex.submit(one, b) for b in range(shape[0] // band)]:
            fut.result()
    mm.flush()
    del mm


def _split() -> dict:
    from tpudct_torch.utils import profiling, streaming

    return {k: round(v, 3) for k, v in sorted(streaming.seconds(profiling.snapshot()).items())}


class Archive:
    """One run's sizes, files and device."""

    def __init__(self, directory: str, size: int = SIZE, band: int = BAND, size_c: int = SIZE_C,
                 device=None):
        if size % band or size_c % band or band % 64:
            raise ValueError(f"size {size} and size_c {size_c} must be multiples of band {band}, "
                             "a multiple of 64")
        self.dir, self.size, self.band, self.size_c = directory, size, band, size_c
        self.device = device
        self.pix, self.tdc, self.rgb, self.tdcc = (os.path.join(directory, f) for f in (PIX, TDC, RGB, TDCC))

    def codec(self) -> tuple:
        from tpudct_torch import CodecConfig, get_pipeline
        from tpudct_torch.models.dispatch import default_device

        return get_pipeline("hp"), CodecConfig(), default_device(self.device)


def _gen(ar: Archive) -> tuple:
    _free_space(ar.dir, ar.size * ar.size, "gen", ar.pix, ar.tdc)
    _write_raster(ar.pix, (ar.size, ar.size), ar.band, lambda b: band_pixels(b, ar.size, ar.band))
    return {}, None


def _enc(ar: Archive) -> tuple:
    from tpudct_torch.utils.streaming import encode_gray_streamed_bytes

    p, cfg, dev = ar.codec()
    img = np.load(ar.pix, mmap_mode="r")
    data, _ = encode_gray_streamed_bytes(p, img, cfg, band_rows=ar.band, device=dev)
    with open(ar.tdc, "wb") as f:
        f.write(data)
    return {"bytes": len(data), "factor": round(ar.size * ar.size / len(data), 2), "split": _split()}, data


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _preview(ar: Archive) -> tuple:
    from tpudct_torch.utils.serialize import preview_from_bytes

    pv = preview_from_bytes(_read(ar.tdc))
    return {"shape": list(pv.shape), "mean": round(float(pv.mean()), 2)}, pv


def _roi(ar: Archive) -> tuple:
    from tpudct_torch.models.dispatch import decode_gray_auto, encode_gray_auto
    from tpudct_torch.utils import serialize as ser
    from tpudct_torch.utils.streaming import decode_gray_streamed

    p, cfg, dev = ar.codec()
    data = _read(ar.tdc)
    size, band = ar.size, ar.band
    a, b = roi_rows(size, band)
    t0 = time.perf_counter()
    rec = decode_gray_streamed(p, data, band_rows=band, row_range=(a, b), device=dev)
    t_roi = time.perf_counter() - t0
    split, decode_rss = _split(), round(rss_mb())
    # independent truth: the covering band's pixels encoded in memory
    # (bands are independent), the same rows decoded
    bb = a // band
    c_mem = encode_gray_auto(p, band_pixels(bb, size, band), cfg, device=dev)[0].cpu().numpy()
    a8 = a % band - (a % band) % 8
    b8 = -(-(b - bb * band) // 8) * 8
    ref = decode_gray_auto(p, c_mem[a8:b8], cfg, (b8 - a8, size), device=dev)[a % band - a8 : b - bb * band - a8]
    _check(np.array_equal(rec, ref), "ROI mismatch vs in-memory band")
    # the segment slab itself equals the in-memory encode
    hdr = ser._parse_plane_header(data)
    raw = data[hdr[10] : hdr[10] + hdr[9]]
    segs = list(ser.iter_banded_segments(raw, size, size, row_range=(bb * band, (bb + 1) * band)))
    _check(len(segs) == 1 and np.array_equal(segs[0][2], c_mem.astype(np.int16)),
           "the covering segment differs from the in-memory coefficients")
    return {"s": t_roi, "rows": [a, b], "segments_decoded": 1, "of": size // band,
            "bit_identical_vs_in_memory_band": True, "split": split, "decode_maxrss_mb": decode_rss}, rec


def scale_band(ar: Archive) -> int:
    """The band whose 1/8-scale rows are checked: 15 of 32, in share."""
    return (ar.size // ar.band) * 15 // 32


def _scale(ar: Archive) -> tuple:
    from tpudct_torch.models.dispatch import decode_gray_scaled_auto, encode_gray_auto
    from tpudct_torch.utils.streaming import decode_gray_streamed

    p, cfg, dev = ar.codec()
    m = 1  # 1/8 scale
    t0 = time.perf_counter()
    rec = decode_gray_streamed(p, _read(ar.tdc), band_rows=ar.band, scale_m=m, device=dev)
    t_sc = time.perf_counter() - t0
    split, decode_rss = _split(), round(rss_mb())
    # one band's scaled rows against the in-memory scaled decode of that
    # band's coefficients (the offsets the streamed path must get right)
    bb = scale_band(ar)
    c_mem, _ = encode_gray_auto(p, band_pixels(bb, ar.size, ar.band), cfg, device=dev)
    ref = decode_gray_scaled_auto(p, c_mem, cfg, (ar.band, ar.size), m)
    got = rec[bb * ar.band * m // 8 : (bb + 1) * ar.band * m // 8]
    _check(np.array_equal(got, ref), "scaled band mismatch vs in-memory")
    return {"s": t_sc, "shape": list(rec.shape), "band": bb, "band_bit_identical": True, "split": split,
            "decode_maxrss_mb": decode_rss}, rec


def _genc(ar: Archive) -> tuple:
    _free_space(ar.dir, 3 * ar.size_c * ar.size_c, "genc", ar.rgb, ar.tdcc)
    _write_raster(ar.rgb, (ar.size_c, ar.size_c, 3), ar.band, lambda b: band_rgb(b, ar.size_c, ar.band))
    return {}, None


def _encc(ar: Archive) -> tuple:
    from tpudct_torch.utils.streaming import encode_color_streamed_bytes

    p, cfg, dev = ar.codec()
    img = np.load(ar.rgb, mmap_mode="r")
    data, _ = encode_color_streamed_bytes(p, img, cfg, band_rows=ar.band, device=dev)
    with open(ar.tdcc, "wb") as f:
        f.write(data)
    return {"bytes": len(data), "factor": round(3 * ar.size_c * ar.size_c / len(data), 2),
            "split": _split()}, data


def _previewc(ar: Archive) -> tuple:
    from tpudct_torch.utils.serialize import preview_color_from_bytes

    pv = preview_color_from_bytes(_read(ar.tdcc))
    return {"shape": list(pv.shape)}, pv


def _roic(ar: Archive) -> tuple:
    from tpudct_torch.models.color import decode_color, encode_color_u8
    from tpudct_torch.utils.streaming import decode_color_streamed

    p, cfg, dev = ar.codec()
    data = _read(ar.tdcc)
    a, b = roi_rows(ar.size_c, ar.band)
    t0 = time.perf_counter()
    rec = decode_color_streamed(p, data, band_rows=ar.band, row_range=(a, b), device=dev)
    t_roi = time.perf_counter() - t0
    split, decode_rss = _split(), round(rss_mb())
    # truth: the covering band encoded in memory and decoded on the f32
    # path (the streamed ROI decodes with decode_color, as the CLI's
    # in-memory --rows does; the int8 decode sits in a +-1 tie class);
    # bands are independent, so the rows agree exactly
    bb = a // ar.band
    planes, meta = encode_color_u8(p, band_rgb(bb, ar.size_c, ar.band), cfg, device=dev)
    ref = decode_color(p, planes, meta, cfg).cpu().numpy()
    _check(np.array_equal(rec, ref[a - bb * ar.band : b - bb * ar.band]), "color ROI mismatch")
    return {"s": t_roi, "rows": [a, b], "bit_identical_vs_in_memory_band": True, "split": split,
            "decode_maxrss_mb": decode_rss}, rec


_RUN = {"gen": _gen, "enc": _enc, "preview": _preview, "roi": _roi, "scale": _scale,
        "genc": _genc, "encc": _encc, "previewc": _previewc, "roic": _roic}


def _launches() -> dict:
    from tpudct_torch.kernels import color, hp

    return {**hp.LAUNCHES, **color.LAUNCHES}


def run_phase(phase: str, ar: Archive) -> tuple:
    """(record, output) of one phase: the record is the JSON line ("phase",
    "s", the phase's own keys, "launches": the kernel launches it made by
    counter, "start_maxrss_mb": the process's peak before the phase, its
    imports done, "maxrss_mb"); the output its bytes or pixels (None for
    gen and genc); the registry of ``utils.profiling`` is on for the phase."""
    from tpudct_torch.utils import profiling

    if phase not in _RUN:
        raise ValueError(f"unknown phase {phase!r}; phases: {' '.join(PHASES)}")
    profiling.reset()
    profiling.enable()
    before, start_rss = _launches(), round(rss_mb())
    t0 = time.perf_counter()
    try:
        rec, out = _RUN[phase](ar)
    finally:
        profiling.disable()
    s = rec.pop("s", time.perf_counter() - t0)
    moved = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    rec = {"phase": phase, "s": round(s, 3), **rec, "launches": moved, "start_maxrss_mb": start_rss,
           "maxrss_mb": round(rss_mb())}
    return rec, out


def main(phase: str, directory: str = ".", size: int = SIZE, band: int = BAND, size_c: int = SIZE_C,
         device=None) -> dict:
    """Run one phase and print its JSON line; return the record."""
    rec, _ = run_phase(phase, Archive(directory, size, band, size_c, device))
    print(json.dumps(rec), flush=True)
    return rec


def _args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m tpudct_torch.studies.partial_at_scale",
                                 description="one phase of the archive-scale partial decode study")
    ap.add_argument("phase", choices=PHASES)
    ap.add_argument("--dir", default=".", help="where the rasters and archives are written")
    ap.add_argument("--size", type=int, default=SIZE, help="side of the gray image")
    ap.add_argument("--band", type=int, default=BAND, help="rows per streamed band")
    ap.add_argument("--size-c", type=int, default=SIZE_C, help="side of the RGB image")
    ap.add_argument("--device", default=None, help="default: the first CUDA card")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = _args(sys.argv[1:])
    main(a.phase, a.dir, a.size, a.band, a.size_c, a.device)
