"""Command-line interface of the port: the verbs of ``tpudct/cli.py``.

  python -m tpudct_torch run    --pipeline hp input.jpg output.jpg [--coeffs x.tdc]
  python -m tpudct_torch encode --pipeline hp input.npy coeffs.tdc
  python -m tpudct_torch decode coeffs.tdc output.npy
  python -m tpudct_torch inspect coeffs.tdc [more.tdcc ...]
  python -m tpudct_torch batch  in/ out/              # bulk encode (resumable)
  python -m tpudct_torch unbatch out/ pix/ --ext .npy # bulk decode (resumable)
  python -m tpudct_torch bench  --size 1024 --pipelines hp,fast
  python -m tpudct_torch sweep | table | curve | scale | profile
  python -m tpudct_torch selftest | compare a b | info

The files are the reference's: a ``.tdc``/``.tdcc`` written here has the
bytes the reference writes for the same coefficients, and each package
decodes the other's files.  Color via ``--color`` on run/encode/batch;
decode reads gray and color streams, in full or as ``--grayscale``,
``--scale M/8``, ``--planes N``, ``--preview`` and ``--rows A:B``.  The
flags, defaults, JSON records and exit codes are the reference's.

``--device`` (which the reference lacks) names where the codec runs: the
first CUDA card by default (``models.dispatch.default_device``); ``--device
cpu`` runs the kernels' plain twins on the CPU.  Without a card and without
``--device``, a verb that needs the device raises; nothing falls back to
the CPU unasked.

``--band-rows N`` on encode and decode is the streamed band height: the
image rides the card N rows at a time through pinned, double-buffered
staging (``utils/streaming.py``), each band entropy-coding into its own
segment of a banded stream, and every decode mode streams too.  Images and
streams above ``streaming.STREAM_PIXELS`` (2^32 pixels) stream without the
flag, in ``batch`` and ``unbatch`` too.  (``CodecConfig.band_rows`` is
another thing: an inert field kept for the reference's config surface.)

Not ported yet (each raises a ValueError that says so): the JPEG
coefficient import and export of ROADMAP A.4a(ii), that is ``.jpg`` decode
inputs, the verbs ``transcode`` and ``edit``, and ``--transcode`` on
``batch``/``unbatch``.  ``selftest --families`` runs the reference's
families less jpg_import, which waits for the same slice.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

def _np(x) -> np.ndarray:
    """A tensor's values on the host; a numpy array as it is."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _cfg_from(args):
    from tpudct_torch.config import CodecConfig

    q_scale = args.q_scale
    if getattr(args, "jpeg_quality", None) is not None:
        from tpudct_torch.ops.quant import q_scale_for_quality

        q_scale = q_scale_for_quality(args.jpeg_quality)
    q_table = "luma"
    if getattr(args, "q_table_file", None):
        if getattr(args, "color", False):
            raise SystemExit(
                "error: --q-table-file applies to the grayscale codec; the "
                "color path quantizes with the standard luma/chroma pair "
                "(models/color.py normalizes per plane)"
            )
        q_table = _register_q_table_file(args.q_table_file)
    return CodecConfig(
        q_scale=q_scale,
        retain_k=args.k,
        transform=getattr(args, "transform", "haweel"),
        q_table=q_table,
        deadzone=getattr(args, "deadzone", 0.5),
    )


def _register_q_table_file(path: str) -> str:
    """Load a custom 8x8 quantization table (64 whitespace/comma-separated
    numbers, '#' comments allowed — the format jpegtran/cjpeg -qtables
    uses) and register it; returns the content-derived table name."""
    from tpudct_torch.constants import register_q_table

    vals = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].replace(",", " ")
            for tok in line.split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    raise SystemExit(
                        f"error: q-table file {path!r}: non-numeric token {tok!r}"
                    ) from None
    if len(vals) != 64:
        raise SystemExit(
            f"error: q-table file {path!r} holds {len(vals)} values, need 64"
        )
    try:
        return register_q_table(np.array(vals, np.float32).reshape(8, 8))
    except ValueError as e:
        raise SystemExit(f"error: q-table file {path!r}: {e}") from None


_ENTROPY_STAGES = ("auto", "auto-exact", "spectral", "huffman", "rans",
                   "xz", "raw", "banded")


def _entropy_spec(v: str) -> str:
    """--entropy value: a stage name, or the banded spec grammar
    banded[:N[:inner]]."""
    if v in _ENTROPY_STAGES:
        return v
    if v.startswith("banded:"):
        from tpudct_torch.utils.serialize import _parse_banded_spec

        try:
            n, inner = _parse_banded_spec(v)
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e)) from None
        if inner not in tuple(c for c in _ENTROPY_STAGES if c != "banded"):
            raise argparse.ArgumentTypeError(
                f"unknown banded inner stage {inner!r}"
            )
        if n and not 1 <= n <= 255:
            raise argparse.ArgumentTypeError("banded segment count must be 1..255")
        return v
    raise argparse.ArgumentTypeError(
        f"unknown entropy stage {v!r}; use one of {_ENTROPY_STAGES} or "
        "banded[:N[:inner]]"
    )


def _stream_inner(entropy: str) -> str:
    """The per-segment inner stage for the streamed writers: banded specs
    reduce to their inner (the writers band by themselves; a full banded
    spec would nest).  An explicit :N is ignored here: the band split comes
    from --band-rows or the auto threshold."""
    if entropy == "banded" or entropy.startswith("banded:"):
        from tpudct_torch.utils.serialize import _parse_banded_spec

        return _parse_banded_spec(entropy)[1]
    return entropy


def _add_device_flag(sp):
    sp.add_argument("--device", default=None,
                    help="where the codec runs: a torch device (default: the first CUDA card; "
                         "'cpu' runs the kernels' plain twins)")


def _add_codec_flags(sp):
    sp.add_argument("--pipeline", default="hp", help="cublas|batched|cublas2|fast|hp")
    sp.add_argument("--q-scale", type=float, default=1.0, dest="q_scale")
    sp.add_argument("--jpeg-quality", type=int, default=None, dest="jpeg_quality",
                    help="IJG quality 1-100 -> table scale (overrides --q-scale; 50 = standard table)")
    sp.add_argument("--k", type=int, default=None, help="zonal retention: keep u+v < k")
    sp.add_argument("--transform", default="haweel",
                    help="8x8 transform: haweel (reference) | rdct (rounded-DCT = Cintra-Bayer 2011; alias cb2011) | wht (Walsh-Hadamard) | bas (sparsified-rdct, cheapest core) | dct (exact DCT-II)")
    sp.add_argument("--deadzone", type=float, default=0.5, dest="deadzone",
                    help="AC quantizer rounding offset: 0.5 (default) = round-half-away; <0.5 = deadzone quantization.  Encode-side only: streams decode unchanged; rides the einsum quantizer")
    sp.add_argument("--q-table-file", default=None, dest="q_table_file",
                    help="custom 8x8 luma quantization table: 64 numbers, whitespace/comma separated, '#' comments (cjpeg -qtables format); stored in .tdc so decode is self-contained")
    sp.add_argument("--entropy", default="auto", dest="entropy",
                    type=_entropy_spec,
                    help=".tdc/.tdcc entropy stage: auto (default; smallest of rans/huffman/xz/spectral per file — above 4M coefficients the winner is picked by sampled rate estimation and only it runs) | auto-exact (trial-encode everything, keep the smallest) | spectral (+zlib) | huffman (JPEG-grade) | rans (positional-context rANS) | xz (spectral+lzma) | raw (+zlib) | banded[:N[:inner]] (independent row-band segments); rans/huffman encode needs the native library")
    _add_device_flag(sp)


def _add_color_flags(sp):
    sp.add_argument("--color", action="store_true",
                    help="code in color (YCbCr, chroma table QC)")
    sp.add_argument("--no-subsample", action="store_true",
                    help="with --color: keep chroma at full resolution (4:4:4 instead of 4:2:0)")
    sp.add_argument("--chroma", choices=("420", "422", "444"), default=None,
                    help="with --color: chroma subsampling mode (default 420; overrides --no-subsample)")


def _chroma_mode(args):
    """CLI chroma mode: --chroma wins, then --no-subsample, else 4:2:0."""
    if getattr(args, "chroma", None):
        return False if args.chroma == "444" else args.chroma
    return not getattr(args, "no_subsample", False)


def _load_gray(path) -> np.ndarray:
    """An image as an (H, W) uint8 array held in memory (a .npy raster is
    read from its memory map, so no tensor shares a read-only buffer)."""
    from tpudct_torch.utils import imageio

    return np.array(imageio.load_image(path), np.uint8)


def _load_rgb(path) -> np.ndarray:
    """Load an image as (H, W, 3) uint8, promoting grayscale to 3 channels."""
    from tpudct_torch.utils import imageio

    rgb = np.array(imageio.load_image(path, force_gray=False), np.uint8)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    return rgb


def _print_corner(label: str, a, n: int = 8):
    """Stage-corner printing, the reference's manual verification aid
    (main_cublass.cu:63-70, 121-128, ...)."""
    print(f"{label} (top-left {n}x{n}):")
    corner = _np(a)[:n, :n]
    for row in corner:
        print("  " + " ".join(f"{v:8.2f}" for v in np.asarray(row, np.float64)))


def cmd_run(args) -> int:
    import torch

    from tpudct_torch.models import get_pipeline
    from tpudct_torch.models.dispatch import default_device
    from tpudct_torch.ops.padding import crop, pad_to_blocks
    from tpudct_torch.utils import imageio, metrics, serialize

    cfg = _cfg_from(args)
    p = get_pipeline(args.pipeline)
    dev = default_device(args.device)
    if args.color:
        from tpudct_torch.models.color import roundtrip_color_auto

        if args.corners:
            raise ValueError(
                "--corners reproduces the reference's grayscale stage dumps "
                "(main_cublass.cu:63-167); it does not apply to --color"
            )
        rgb = _load_rgb(args.input)
        planes, meta, rec = roundtrip_color_auto(
            p, rgb, cfg, subsample=_chroma_mode(args), device=dev
        )
        rec_u8 = _np(rec)
        imageio.save_image(args.output, rec_u8, quality=args.quality)
        if args.coeffs:
            n = serialize.save_color(
                args.coeffs, {k: _np(v) for k, v in planes.items()}, meta,
                cfg.q_scale, cfg.retain_k, cfg.transform,
                codec=args.entropy,
            )
            print(f"coefficients -> {args.coeffs} ({n} bytes)")
        mse = float(((rec_u8.astype(np.float64) - rgb) ** 2).mean())
        print(json.dumps({
            "pipeline": p.name, "shape": list(rgb.shape), "color": True,
            "subsample": meta["subsample"], "mse": mse,
            # perfect-reconstruction cap: inf is not valid JSON
            "psnr_db": 10 * np.log10(255.0 ** 2 / max(mse, 1e-30)),
        }))
        return 0
    img = _load_gray(args.input)
    h, w = img.shape
    if args.corners:
        # The original codec's staged output: corners after load, after
        # DCT+quant, after IDCT (f32) and after the u8 conversion, with each
        # phase's wall time (main_cublass.cu:63-167, main_newAppr.cu:283-287).
        from tpudct_torch.ops.transform import to_uint8

        _print_corner("input", img)
        x, _ = pad_to_blocks(torch.as_tensor(img, device=dev).to(torch.float32))
        t0 = time.perf_counter()
        c = _np(p.dct(x, cfg))
        print(f"DCT ({w},{h}): {(time.perf_counter() - t0) * 1e3:.3f} ms")
        _print_corner("DCT+quant", c)
        t0 = time.perf_counter()
        rec_f = p.idct(torch.as_tensor(c, device=dev), cfg)
        rec_f_np = _np(rec_f)
        print(f"IDCT ({w},{h}): {(time.perf_counter() - t0) * 1e3:.3f} ms")
        _print_corner("IDCT", rec_f_np[:h, :w])
        rec_u8 = _np(crop(to_uint8(rec_f), h, w))
        _print_corner("u8", rec_u8)
    else:
        from tpudct_torch.models.dispatch import roundtrip_gray_auto

        c, rec_u8 = roundtrip_gray_auto(p, img, cfg, device=dev)
        c = _np(c)
    imageio.save_image(args.output, rec_u8, quality=args.quality)
    if args.coeffs:
        n = serialize.save_coefficients(
            args.coeffs, c, cfg.q_scale, cfg.retain_k,
            orig_shape=(h, w), transform=cfg.transform, codec=args.entropy,
            q_table=cfg.q_table,
        )
        print(f"coefficients -> {args.coeffs} ({n} bytes)")
    rep = metrics.quality_report(img, rec_u8, c, device=dev)
    print(json.dumps({"pipeline": p.name, "shape": [h, w], **rep}))
    return 0


def _ms(t0: float, t1: float) -> float:
    return round((t1 - t0) * 1e3, 1)


def cmd_encode(args) -> int:
    """Every record carries an end-to-end "ms" phase decomposition (load /
    device_fetch / entropy / write): pixels to bytes, not the device stage
    alone.  device_fetch is the codec's device work and the copy of the
    coefficients to the host."""
    from tpudct_torch.models import get_pipeline
    from tpudct_torch.models.dispatch import default_device
    from tpudct_torch.utils import serialize, streaming

    cfg = _cfg_from(args)
    dev = default_device(args.device)
    if args.color:
        from tpudct_torch.models.color import encode_color_auto

        t0 = time.perf_counter()
        rgb = _load_rgb(args.input)
        if args.band_rows is not None:
            stream_color = True  # explicit ask: unsupported configs error clearly
        elif rgb.size > streaming.STREAM_PIXELS:
            # auto threshold: only where the u8 streamed encoder supports
            # this config; another (f32 transform, loose q_scale) takes the
            # in-memory f32 path instead of turning into an error
            from tpudct_torch.models.color import color_kernel_shape, supports_color_u8

            stream_color = supports_color_u8(
                get_pipeline(args.pipeline), cfg,
                *color_kernel_shape(*rgb.shape[:2]), _chroma_mode(args),
            )
        else:
            stream_color = False
        if stream_color:
            # RGB bands ride the card one at a time, each plane's slab
            # entropy-coding into banded segments
            t1 = time.perf_counter()
            data, _hw = streaming.encode_color_streamed_bytes(
                get_pipeline(args.pipeline), rgb, cfg,
                band_rows=args.band_rows or 8192, inner=_stream_inner(args.entropy),
                subsample=_chroma_mode(args), device=dev,
            )
            t2 = time.perf_counter()
            with open(args.output, "wb") as f:
                f.write(data)
            t3 = time.perf_counter()
            print(json.dumps({
                "bytes": len(data), "raw_bytes": int(rgb.size),
                "factor_vs_raw": rgb.size / len(data), "color": True,
                "streamed": True,
                "ms": {"load": _ms(t0, t1), "stream_device_entropy": _ms(t1, t2),
                       "write": _ms(t2, t3)},
            }))
            return 0
        t1 = time.perf_counter()
        planes, meta = encode_color_auto(
            get_pipeline(args.pipeline), rgb, cfg,
            subsample=_chroma_mode(args), device=dev,
        )
        planes = {k: _np(v) for k, v in planes.items()}
        t2 = time.perf_counter()
        data = serialize.color_to_bytes(
            planes, meta, cfg.q_scale, cfg.retain_k, cfg.transform,
            codec=args.entropy,
        )
        t3 = time.perf_counter()
        with open(args.output, "wb") as f:
            f.write(data)
        t4 = time.perf_counter()
        print(json.dumps({
            "bytes": len(data), "raw_bytes": int(rgb.size),
            "factor_vs_raw": rgb.size / len(data), "color": True,
            "ms": {"load": _ms(t0, t1), "device_fetch": _ms(t1, t2),
                   "entropy": _ms(t2, t3), "write": _ms(t3, t4)},
        }))
        return 0
    t0 = time.perf_counter()
    img = _load_gray(args.input)
    t1 = time.perf_counter()
    if args.band_rows is not None or img.size > streaming.STREAM_PIXELS:
        # the image rides the card band by band, each band entropy-coded
        # into a banded segment; device and entropy phases overlap, so the
        # record reports the fused stream phase
        data, _hw = streaming.encode_gray_streamed_bytes(
            get_pipeline(args.pipeline), img, cfg,
            band_rows=args.band_rows or 8192, inner=_stream_inner(args.entropy), device=dev,
        )
        t2 = time.perf_counter()
        with open(args.output, "wb") as f:
            f.write(data)
        t3 = time.perf_counter()
        print(json.dumps({
            "bytes": len(data), "raw_bytes": img.size,
            "factor_vs_raw": img.size / len(data), "streamed": True,
            "ms": {"load": _ms(t0, t1), "stream_device_entropy": _ms(t1, t2),
                   "write": _ms(t2, t3)},
        }))
        return 0
    from tpudct_torch.models.dispatch import encode_gray_auto

    c, (h, w) = encode_gray_auto(get_pipeline(args.pipeline), img, cfg, device=dev)
    c_np = _np(c)
    t2 = time.perf_counter()
    data = serialize.coefficients_to_bytes(
        c_np, cfg.q_scale, cfg.retain_k, orig_shape=(h, w),
        transform=cfg.transform, codec=args.entropy, q_table=cfg.q_table,
    )
    t3 = time.perf_counter()
    with open(args.output, "wb") as f:
        f.write(data)
    t4 = time.perf_counter()
    print(json.dumps({
        "bytes": len(data), "raw_bytes": img.size,
        "factor_vs_raw": img.size / len(data),
        "ms": {"load": _ms(t0, t1), "device_fetch": _ms(t1, t2),
               "entropy": _ms(t2, t3), "write": _ms(t3, t4)},
    }))
    return 0


def _parse_rows(spec: str, shown: str = "--rows"):
    """'A:B' -> (a, b) ints; the one copy of the ROI grammar."""
    try:
        a, b = (int(v) for v in spec.split(":"))
    except Exception:
        raise ValueError(f"{shown} expects A:B, got {spec!r}") from None
    return a, b


def _luma_blob(data: bytes) -> bytes:
    """The Y plane's v4 stream from a .tdcc container (a valid gray .tdc
    blob)."""
    from tpudct_torch.utils import serialize

    return bytes(serialize._color_plane_slices(data)[1][0])


def _parse_scale(s: str) -> int:
    """``--scale`` string -> numerator M of an M/8 scale (djpeg grammar).

    Accepts "M/8" for M = 1..16 plus the reduced aliases djpeg prints
    ("1/2" = 4/8, "1/4" = 2/8, "3/4" = 6/8, ...).  Returns M."""
    alias = {"1/1": 8, "1/2": 4, "1/4": 2, "1/8": 1, "3/4": 6,
             "5/4": 10, "3/2": 12, "7/4": 14, "2/1": 16}
    if s in alias:
        return alias[s]
    num, _, den = s.partition("/")
    try:
        if den == "8" and 1 <= int(num) <= 16:
            return int(num)
    except ValueError:
        pass
    raise ValueError(
        f"--scale must be M/8 with M in 1..16 (or a reduced alias like "
        f"1/2, 3/4, 2/1), got {s!r}"
    )


def cmd_decode(args) -> int:
    if args.input.lower().endswith((".jpg", ".jpeg")):
        raise ValueError(
            f"{args.input}: decoding .jpg inputs (the lossless coefficient "
            "import) is not in tpudct_torch yet (ROADMAP A.4a(ii)); decode a "
            ".tdc/.tdcc stream"
        )
    return _decode_stream(args, args.input)


def _decode_stream(args, path: str) -> int:
    """Decode the .tdc/.tdcc stream at `path`.  A non-stream file fails
    with a format hint instead of a parser traceback.

    Every decode mode streams (``utils/streaming.py``) where asked
    (``--band-rows``) or where the container exceeds
    ``streaming.STREAM_PIXELS``; a ``.npy`` output is then written band by
    band through a memmap, bounding the host's output residency too."""
    from tpudct_torch.config import CodecConfig
    from tpudct_torch.models import get_pipeline
    from tpudct_torch.utils import imageio, serialize, streaming

    with open(path, "rb") as f:
        data = f.read()
    head = data[:4]
    color = serialize.is_color_stream(head)
    if not (color or serialize.is_tdc_stream(head)):
        raise ValueError(
            f"{path}: not a .tdc/.tdcc stream (magic {head!r}); "
            "JPEG inputs must be named .jpg/.jpeg"
        )
    if color:
        _sub0, slices0, _end0 = serialize._color_plane_slices(data)
        hdr0 = serialize._parse_plane_header(slices0[0])
        n_px = ((hdr0[2] or hdr0[0]) * (hdr0[3] or hdr0[1])) * 3
    else:
        hdr0 = serialize._parse_plane_header(data)
        n_px = hdr0[0] * hdr0[1]
    stream = args.band_rows is not None or n_px > streaming.STREAM_PIXELS
    s_band = args.band_rows or 8192
    out_npy = args.output if args.output.lower().endswith(".npy") else None

    def save(rec) -> None:
        """Write the decoded raster: a memmap output is on disk already
        (flushed), anything else goes through the image writer."""
        if isinstance(rec, np.memmap):
            rec.flush()
        else:
            imageio.save_image(args.output, _np(rec), quality=args.quality)

    def pipe():
        return get_pipeline(args.pipeline)

    def dev():
        from tpudct_torch.models.dispatch import default_device

        return default_device(args.device)

    if args.scale is not None:
        # Fractional-scale decode (djpeg -scale M/8): straight to
        # ceil(H*M/8) x ceil(W*M/8), the exact area-resample of the full
        # decode (ops/scaled.py; integer 8/M rides the fused u8 kernel).
        if args.planes is not None or args.rows is not None or args.preview:
            raise ValueError("--scale does not combine with --planes/--rows/--preview")
        m = _parse_scale(args.scale)
        fac = 8 // m if 8 % m == 0 else None
        if stream:
            # the fused scaled kernel rides band by band into the
            # (ceil(H*M/8), ...) raster
            if color and not args.grayscale:
                rec = streaming.decode_color_streamed(
                    pipe(), data, band_rows=s_band, scale_m=m, out_npy=out_npy, device=dev(),
                )
            else:
                rec = streaming.decode_gray_streamed(
                    pipe(), _luma_blob(data) if color else data, band_rows=s_band,
                    scale_m=m, out_npy=out_npy, device=dev(),
                )
            save(rec)
            print(f"decoded {path} at {m}/8 scale (streamed) -> {args.output}")
            return 0
        if color:
            from tpudct_torch.models.color import _luma_cfg, decode_color_scaled

            planes, meta = serialize.load_color(path)
            cfg = CodecConfig(q_scale=meta["q_scale"], transform=meta["transform"])
            if args.grayscale:
                # djpeg -grayscale -scale: luma-only, chroma never decodes
                from tpudct_torch.models.dispatch import decode_gray_scaled_auto

                rec = decode_gray_scaled_auto(
                    pipe(), planes["y"],
                    _luma_cfg(cfg, meta.get("y_q_table", "luma")),
                    meta["orig_shape"], m, device=dev(),
                )
            else:
                rec = decode_color_scaled(
                    pipe(), planes, meta, cfg, fac,
                    m=None if fac else m, device=dev(),
                )
            save(rec)
        else:
            from tpudct_torch.models.dispatch import decode_gray_scaled_auto

            coeffs, q_scale, _k, (h, w), transform, q_table = serialize.load_coefficients(
                path, with_orig_shape=True, with_transform=True, with_q_table=True,
            )
            cfg = CodecConfig(q_scale=q_scale, transform=transform, q_table=q_table)
            save(decode_gray_scaled_auto(pipe(), coeffs, cfg, (h, w), m, device=dev()))
        print(f"decoded {path} at {m}/8 scale -> {args.output}")
        return 0
    if args.preview:
        # 1/8-scale DC-only thumbnail on the host (.tdcc in full color; with
        # --grayscale only the luma plane's DC terms are read).
        if color and args.grayscale:
            pv = serialize.preview_from_bytes(_luma_blob(data))
        elif color:
            pv = serialize.preview_color_from_bytes(data)
        else:
            pv = serialize.preview_from_bytes(data)
        save(pv)
        print(f"preview (1/8 scale, DC-only) {path} -> {args.output}")
        return 0
    if args.planes is not None:
        from tpudct_torch.models.dispatch import decode_gray_auto

        if stream:
            # only the first N zig-zag planes decode per banded segment
            # (spectral prefix where the inner stage allows, decode+mask
            # otherwise), device work in bounded bands
            if color and not args.grayscale:
                rec = streaming.decode_color_streamed(
                    pipe(), data, band_rows=s_band, n_planes=args.planes, out_npy=out_npy,
                    device=dev(),
                )
            else:
                rec = streaming.decode_gray_streamed(
                    pipe(), _luma_blob(data) if color else data, band_rows=s_band,
                    n_planes=args.planes, out_npy=out_npy, device=dev(),
                )
            save(rec)
            print(f"decoded {path} ({args.planes} spectral planes, streamed) -> {args.output}")
            return 0
        if color and not args.grayscale:
            # Progressive color decode: the first N spectral planes of each
            # plane stream (the f32 path; partial maps are f32).
            from tpudct_torch.models.color import decode_color

            planes, meta = serialize.partial_color_coefficients(
                data, n_planes=args.planes
            )
            save(decode_color(
                pipe(), planes, meta,
                CodecConfig(q_scale=meta["q_scale"], transform=meta["transform"]),
                device=dev(),
            ))
            print(f"decoded {path} ({args.planes} spectral planes, "
                  f"color) -> {args.output}")
            return 0
        # gray, or the luma plane alone of a color stream (chroma never
        # decodes); a spectrally truncated map is still integer-valued, so
        # it rides the int8 kernels where eligible
        p = serialize.partial_coefficients(
            _luma_blob(data) if color else data, n_planes=args.planes
        )
        cfg = CodecConfig(q_scale=p["q_scale"], transform=p["transform"],
                          q_table=p["q_table"])
        save(decode_gray_auto(pipe(), p["coeffs"], cfg, p["orig_shape"], device=dev()))
        which = ", luma only" if color else ""
        print(f"decoded {path} ({args.planes} spectral planes{which}) -> {args.output}")
        return 0
    if stream:
        return _decode_streamed(args, path, data, color, s_band, out_npy, pipe, dev, save)
    if color:
        return _decode_color_full(args, path, data, pipe, dev, save)
    t0 = time.perf_counter()
    coeffs, q_scale, _k, (h, w), transform, q_table = (
        serialize.bytes_to_coefficients(
            data, with_orig_shape=True, with_transform=True, with_q_table=True,
        )
    )
    t_entropy = time.perf_counter() - t0
    # the header names the table the plane was coded against
    cfg = CodecConfig(q_scale=q_scale, transform=transform, q_table=q_table)
    from tpudct_torch.models.dispatch import decode_gray_auto

    if args.rows is not None:
        # Region decode: 8x8 blocks are independent, so only the covering
        # block rows decode (the slice equals the same rows of a full decode).
        a, bnd = _parse_rows(args.rows)
        a, bnd = max(0, a), min(h, bnd)
        if bnd <= a:
            raise ValueError(f"--rows {args.rows}: empty range for height {h}")
        a8 = a - a % 8
        b8 = min(coeffs.shape[0], -(-bnd // 8) * 8)
        save(decode_gray_auto(pipe(), coeffs[a8:b8], cfg, (b8 - a8, w), device=dev())[a - a8 : bnd - a8])
        print(f"decoded rows {a}:{bnd} of {path} -> {args.output}")
        return 0
    t1 = time.perf_counter()
    rec_u8 = decode_gray_auto(pipe(), coeffs, cfg, (h, w), device=dev())
    t2 = time.perf_counter()
    save(rec_u8)
    t3 = time.perf_counter()
    print(f"decoded {path} -> {args.output}")
    # bytes-to-pixels phase decomposition, mirroring `encode`'s record
    print(json.dumps({"ms": {
        "entropy": round(t_entropy * 1e3, 1),
        "device_fetch": _ms(t1, t2),
        "save": _ms(t2, t3),
    }}))
    return 0


def _decode_streamed(args, path, data, color, s_band, out_npy, pipe, dev, save) -> int:
    """The streamed full decode, whole or as rows (``--rows``), of a .tdc,
    a .tdcc or its luma plane alone (``--grayscale``): only the segments
    covering the rows entropy-decode, and neither the coefficient map nor
    the device working set holds the whole image."""
    from tpudct_torch.utils import streaming

    t0 = time.perf_counter()
    rows = _parse_rows(args.rows) if args.rows is not None else None
    if color and not args.grayscale:
        rec = streaming.decode_color_streamed(
            pipe(), data, band_rows=s_band, row_range=rows, out_npy=out_npy, device=dev(),
        )
    else:
        rec = streaming.decode_gray_streamed(
            pipe(), _luma_blob(data) if color else data, band_rows=s_band,
            row_range=rows, out_npy=out_npy, device=dev(),
        )
    t1 = time.perf_counter()
    save(rec)
    t2 = time.perf_counter()
    if rows is not None:
        print(f"decoded rows {rows[0]}:{rows[1]} of {path} (streamed) -> {args.output}")
    elif color and args.grayscale:
        print(f"decoded {path} (luma only, streamed) -> {args.output}")
    elif color:
        print(f"decoded {path} (color, streamed) -> {args.output}")
        print(json.dumps({"ms": {"entropy_device": _ms(t0, t1), "save": _ms(t1, t2)}}))
    else:
        print(f"decoded {path} (streamed) -> {args.output}")
    return 0


def _decode_color_full(args, path, data, pipe, dev, save) -> int:
    """A .tdcc decoded whole, as rows of it, or its luma plane alone."""
    from tpudct_torch.config import CodecConfig
    from tpudct_torch.models.color import _luma_cfg, decode_color, decode_color_auto
    from tpudct_torch.models.dispatch import decode_gray_auto
    from tpudct_torch.utils import serialize

    t0 = time.perf_counter()
    planes, meta = serialize.bytes_to_color(data)
    t_entropy = time.perf_counter() - t0
    cfg = CodecConfig(q_scale=meta["q_scale"], transform=meta["transform"])
    luma_cfg = _luma_cfg(cfg, meta.get("y_q_table", "luma"))
    if args.rows is not None:
        # Color region decode: luma block rows plus the covering chroma
        # block rows.  4:2:0 needs 16-luma-row alignment so the chroma slice
        # stays 8-row-block aligned; replication upsampling is local, so the
        # slice decode equals the same rows of a full decode.
        h, w = meta["orig_shape"]
        a, bnd = _parse_rows(args.rows)
        a, bnd = max(0, a), min(h, bnd)
        if bnd <= a:
            raise ValueError(f"--rows {args.rows}: empty range for height {h}")
        if args.grayscale:
            # only the covering 8-row luma block rows decode
            a0 = a - a % 8
            y1 = min(planes["y"].shape[0], -(-bnd // 8) * 8)
            save(decode_gray_auto(
                pipe(), planes["y"][a0:y1], luma_cfg, (min(h, y1) - a0, w), device=dev(),
            )[a - a0 : bnd - a0])
            print(f"decoded rows {a}:{bnd} of {path} (luma only) -> {args.output}")
            return 0
        mode = meta["subsample"]
        align = 16 if mode == "420" else 8
        a0 = a - a % align
        y1 = min(planes["y"].shape[0], -(-bnd // align) * align)
        if mode == "420":
            # a tail slice of an image whose padded luma height is only
            # 8-aligned takes the whole remaining chroma plane, so both
            # chroma slices stay 8-row block multiples
            c0 = a0 // 2
            c1 = planes["cb"].shape[0] if y1 >= planes["y"].shape[0] else y1 // 2
        else:
            c0, c1 = a0, min(y1, planes["cb"].shape[0])
        sl = {"y": planes["y"][a0:y1], "cb": planes["cb"][c0:c1], "cr": planes["cr"][c0:c1]}
        smeta = {
            **meta,
            "orig_shape": (min(h, y1) - a0, w),
            "chroma_shape": (min(meta["chroma_shape"][0], c1) - c0, meta["chroma_shape"][1]),
        }
        save(_np(decode_color(pipe(), sl, smeta, cfg, device=dev()))[a - a0 : bnd - a0])
        print(f"decoded rows {a}:{bnd} of {path} (color) -> {args.output}")
        return 0
    if args.grayscale:
        # djpeg -grayscale: only the luma plane decodes, on the gray path
        save(decode_gray_auto(pipe(), planes["y"], luma_cfg, meta["orig_shape"], device=dev()))
        print(f"decoded {path} (luma only) -> {args.output}")
        return 0
    t1 = time.perf_counter()
    rec = _np(decode_color_auto(pipe(), planes, meta, cfg, device=dev()))
    t2 = time.perf_counter()
    save(rec)
    t3 = time.perf_counter()
    print(f"decoded {path} (color) -> {args.output}")
    print(json.dumps({"ms": {
        "entropy": round(t_entropy * 1e3, 1),
        "device_fetch": _ms(t1, t2),
        "save": _ms(t2, t3),
    }}))
    return 0


def cmd_inspect(args) -> int:
    """Header-only introspection of .tdc/.tdcc files (no payload decode):
    container/version, geometry, codec config, entropy stage and payload
    sizes."""
    from tpudct_torch.utils import serialize

    rc = 0
    for path in args.files:
        try:
            with open(path, "rb") as f:
                data = f.read()
            rep = serialize.inspect_stream(data)
        except (OSError, ValueError) as e:
            print(json.dumps({"file": path, "error": str(e)}))
            rc = 1
            continue
        print(json.dumps({"file": path, **rep}))
    return rc


_WAITS_FOR_COEF_IO = (
    "is not in tpudct_torch yet: it needs the JPEG coefficient import and "
    "export (ROADMAP A.4a(ii))"
)


def _dev(args):
    from tpudct_torch.models.dispatch import default_device

    return default_device(args.device)


def cmd_bench(args) -> int:
    from tpudct_torch import benchmark as B

    if args.host_entropy:
        # the host serializer alone: no device work at all
        for row in B.bench_host_entropy(args.size, _cfg_from(args), reps=args.reps, image=args.image):
            print(json.dumps(row))
        return 0
    dev = _dev(args)
    if args.e2e:
        # pixels to bytes on disk, by phase, then the bulk batch flow
        print(json.dumps(B.bench_e2e_encode(
            args.size, _cfg_from(args), image=args.image, entropy=args.entropy, device=dev,
        )))
        if args.batch:
            print(json.dumps(B.bench_e2e_batch(
                args.batch, min(args.size, 1024), _cfg_from(args), entropy=args.entropy, device=dev,
            )))
        return 0
    for name in args.pipelines.split(","):
        print(json.dumps(B.bench_pipeline(name.strip(), args.size, _cfg_from(args), reps=args.reps,
                                          device=dev)))
    if args.fused:
        print(json.dumps(B.bench_fused_roundtrip(args.size, _cfg_from(args), reps=args.reps, device=dev)))
    if args.batch:
        print(json.dumps(B.bench_serving_throughput(args.size, args.batch, _cfg_from(args), reps=args.reps,
                                                    device=dev)))
    if args.cpu:
        print(json.dumps(B.bench_cpu_numpy(args.size, _cfg_from(args), reps=args.reps)))
    if args.color:
        print(json.dumps(B.bench_color(
            args.size, args.pipelines.split(",")[0].strip(), _cfg_from(args),
            subsample=_chroma_mode(args), reps=args.reps, device=dev,
        )))
        if args.batch:
            print(json.dumps(B.bench_color_serving(args.size, args.batch, _cfg_from(args), reps=args.reps,
                                                   device=dev)))
    return 0


def cmd_sweep(args) -> int:
    from tpudct_torch.benchmark import sweep

    sizes = [int(s) for s in args.sizes.split(",")]
    for row in sweep(sizes, [p.strip() for p in args.pipelines.split(",")], _cfg_from(args), reps=args.reps,
                     device=_dev(args)):
        print(json.dumps(row))
    return 0


def _default_rgb(gray: np.ndarray) -> np.ndarray:
    """The built-in generator's image as RGB: the gray image and two rolls."""
    return np.stack([gray, np.roll(gray, 2, 0), np.roll(gray, 4, 1)], -1)


def cmd_table(args) -> int:
    from tpudct_torch.benchmark import (
        accuracy_table,
        accuracy_table_color,
        photographic_image,
        structured_image,
    )

    # 'circuit' stands in for the original codec's Circuit image (its
    # content), 'photo' for photographic statistics
    gen = photographic_image if args.image == "photo" else structured_image
    if args.color:
        img = _default_rgb(gen()) if args.input is None else _load_rgb(args.input)
        rows = accuracy_table_color(img, args.pipeline, cfg_base=_cfg_from(args),
                                    subsample=_chroma_mode(args), device=_dev(args))
    else:
        if args.input is None:
            img = gen()
        else:
            from tpudct_torch.utils import imageio

            img = imageio.load_image(args.input)
        rows = accuracy_table(img, args.pipeline, cfg_base=_cfg_from(args), device=_dev(args))
    for row in rows:
        print(json.dumps(row))
    return 0


def cmd_curve(args) -> int:
    """Rate against distortion: .tdc/.tdcc bytes and PSNR beside libjpeg's
    per IJG quality (gray by default; --color against libjpeg's color path
    at equal RGB PSNR); with >= 4 points, the Bjontegaard summary."""
    from tpudct_torch.benchmark import (
        photographic_image,
        rate_distortion_curve,
        rate_distortion_curve_color,
        structured_image,
    )

    qs = [int(q) for q in args.qualities.split(",")]
    gen = photographic_image if args.image == "photo" else structured_image
    if args.color:
        img = _default_rgb(gen()) if args.input is None else _load_rgb(args.input)
        rows = rate_distortion_curve_color(img, args.pipeline, qualities=qs, cfg_base=_cfg_from(args),
                                           codec=args.entropy, subsample=_chroma_mode(args),
                                           device=_dev(args))
    else:
        if args.input is None:
            img = gen()
        else:
            from tpudct_torch.utils import imageio

            img = imageio.load_image(args.input)
        rows = rate_distortion_curve(img, args.pipeline, qualities=qs, cfg_base=_cfg_from(args),
                                     codec=args.entropy, device=_dev(args))
    for row in rows:
        print(json.dumps(row))
    if len(rows) >= 4:
        # BD-rate/BD-PSNR against libjpeg over the whole curve (negative
        # bd_rate: smaller files at the same PSNR)
        from tpudct_torch.benchmark import bd_summary

        summary = {"transform": getattr(args, "transform", "haweel")}
        try:
            summary.update(bd_summary(rows))
        except ValueError as e:  # non-monotone or non-overlapping curves
            summary["bd_error"] = str(e)
        print(json.dumps(summary))
    return 0


def _err_kind(e: Exception) -> str:
    """A manifest error's kind: "io" retries on resume, "stream" (the
    file's own fault) stays done."""
    return "io" if isinstance(e, OSError) else "stream"


def cmd_unbatch(args) -> int:
    """Bulk decode of a directory of .tdc/.tdcc files back to images,
    resumable (the inverse of `batch`: the same manifest and corrupt-file
    recovery).  --ext is the output format: .jpg (quality honored) or a
    lossless one (.png, .npy) for exact pixels.

    Full-size gray streams stack as one device launch per same-width,
    same-config group (``decode_gray_batch_auto``; ``--scale`` on the
    stacked scaled decode), color streams likewise
    (``decode_color_batch_auto``); a group the stacked launch rejects with
    a ValueError or OSError (a corrupt but parseable stream) decodes again
    one stream at a time, so only the bad file fails.  Any other error
    (a kernel that does not build or launch) ends the run.  Streams above
    ``streaming.STREAM_PIXELS`` decode streamed, one at a time.  Every
    device call runs on the calling thread; the thread pools read, parse
    and save on the host."""
    import os
    import pathlib
    import threading
    from concurrent.futures import ThreadPoolExecutor, as_completed

    from tpudct_torch.config import CodecConfig
    from tpudct_torch.models import get_pipeline
    from tpudct_torch.models.dispatch import _chunk
    from tpudct_torch.utils import imageio, serialize, streaming

    ext = args.ext if args.ext.startswith(".") else "." + args.ext
    ext = ext.lower()
    if ext not in imageio.SUPPORTED_EXTS:
        raise SystemExit(
            f"error: --ext {args.ext!r} not supported; use one of "
            f"{sorted(imageio.SUPPORTED_EXTS)}"
        )
    m_scale = _parse_scale(args.scale) if args.scale is not None else None
    src = pathlib.Path(args.input_dir)
    dst = pathlib.Path(args.output_dir)
    dst.mkdir(parents=True, exist_ok=True)
    manifest = dst / "manifest.jsonl"
    done = set()
    if manifest.exists():
        for line in manifest.read_text().splitlines():
            try:
                rec = json.loads(line)
                # resume is per output format and per scale; a stream's own
                # fault stays done, an I/O failure retries
                out_name = rec.get("out", rec.get("jpg", ""))  # "jpg": the older key
                if "error" in rec:
                    if rec.get("error_kind", "stream") != "io":
                        done.add(rec["file"])
                elif out_name.lower().endswith(ext) and rec.get("scale") == m_scale:
                    done.add(rec["file"])
            except (json.JSONDecodeError, KeyError):
                continue

    if args.transcode and ext not in imageio.JPEG_EXTS:
        raise SystemExit("error: --transcode restores .jpg files; use --ext .jpg")
    if (args.optimize or args.progressive or args.arithmetic) and not args.transcode:
        raise SystemExit(
            "error: --optimize/--progressive/--arithmetic re-code the "
            "output JPEG's entropy stage losslessly; they need --transcode "
            "(the plain decode path re-encodes pixels, where only "
            "--quality applies)"
        )
    if m_scale is not None and args.transcode:
        raise SystemExit(
            "error: --scale decodes pixels; it does not combine with the "
            "lossless --transcode export"
        )
    if args.transcode:
        raise ValueError(f"unbatch --transcode {_WAITS_FOR_COEF_IO}")
    files = sorted(q.name for q in src.iterdir() if q.suffix.lower() in (".tdc", ".tdcc"))
    todo = [name for name in files if name not in done]
    decoded = failed = 0

    p = get_pipeline(args.pipeline)
    dev = _dev(args)
    n_threads = min(os.cpu_count() or 4, 16)
    chunk = n_threads * 4
    lock = threading.Lock()

    def _read(name):
        try:
            return (src / name).read_bytes()
        except OSError as e:
            return ("err", "io", str(e))

    def _mf_error(mf, name, kind, msg):
        """The one copy of the manifest's error record (resume reads
        error_kind)."""
        mf.write(json.dumps({"file": name, "error": msg, "error_kind": kind}) + "\n")
        mf.flush()

    def _mf_done(mf, name, out_name, shape, streamed=False):
        rec = {"file": name, "out": out_name, "shape": list(shape)}
        if streamed:
            rec["streamed"] = True
        if m_scale is not None:
            rec["scale"] = m_scale
        mf.write(json.dumps(rec) + "\n")
        mf.flush()

    def _parse(data):
        """Entropy-decode one stream's bytes on a host thread."""
        if isinstance(data, tuple):  # a read error, already tagged
            return data
        try:
            if serialize.is_color_stream(data[:4]):
                return ("color", *serialize.bytes_to_color(data))
            coeffs, q_scale, _k, (h, w), transform, q_table = serialize.bytes_to_coefficients(
                data, with_orig_shape=True, with_transform=True, with_q_table=True,
            )
            return ("gray", coeffs, CodecConfig(q_scale=q_scale, transform=transform, q_table=q_table), (h, w))
        except (ValueError, OSError) as e:
            return ("err", _err_kind(e), str(e))

    def _map_elems(data) -> int:
        """Decoded-map elements of a stream, from its header alone (sizes
        the waves; a parse error surfaces later in `_parse`)."""
        if isinstance(data, tuple):
            return 0
        try:
            rep = serialize.inspect_stream(data)
        except ValueError:
            return 0
        if "planes" in rep:
            return sum(int(np.prod(pl["shape"])) for pl in rep["planes"])
        return int(np.prod(rep["shape"]))

    # decoded maps held at once: about 1 GiB, while still stacking and
    # threading within each wave
    wave_elems = 1 << 28

    def _group_decode(stacked_fn, single_fn, items):
        """The stacked decode, or, where it rejects the group with a
        ValueError or OSError, each item alone, so only the bad stream
        fails.  Other errors propagate."""
        try:
            return stacked_fn(items)
        except (ValueError, OSError):
            recs = []
            for it in items:
                try:
                    recs.append(single_fn(it))
                except (ValueError, OSError) as e:
                    recs.append(("err", _err_kind(e), str(e)))
            return recs

    def _process_wave(names, parsed, mf):
        nonlocal decoded, failed
        from tpudct_torch.models import color as mc
        from tpudct_torch.models import dispatch as dp

        outputs: list = [None] * len(names)
        gray_idx = [j for j, res in enumerate(parsed) if res[0] == "gray"]
        if gray_idx:
            items = [(parsed[j][1], parsed[j][2], parsed[j][3]) for j in gray_idx]
            if m_scale is None:
                recs = _group_decode(
                    lambda its: dp.decode_gray_batch_auto(p, its, device=dev),
                    lambda it: _np(dp.decode_gray_auto(p, *it, device=dev)),
                    items,
                )
            else:
                recs = _group_decode(
                    lambda its: dp.decode_gray_scaled_batch_auto(p, its, m_scale, device=dev),
                    lambda it: _np(dp.decode_gray_scaled_auto(p, *it, m_scale, device=dev)),
                    items,
                )
            for j, r in zip(gray_idx, recs):
                outputs[j] = r
        color_idx = [j for j, res in enumerate(parsed) if res[0] == "color"]
        if m_scale is None and color_idx:
            recs = _group_decode(
                lambda its: mc.decode_color_batch_auto(p, its, device=dev),
                lambda it: _np(mc.decode_color_auto(p, *it, device=dev)),
                [(parsed[j][1], parsed[j][2],
                  CodecConfig(q_scale=parsed[j][2]["q_scale"], transform=parsed[j][2]["transform"]))
                 for j in color_idx],
            )
            for j, r in zip(color_idx, recs):
                outputs[j] = r
        for j, res in enumerate(parsed):
            if outputs[j] is not None or res[0] != "color":
                continue
            # color at a fractional scale, one stream at a time
            _tag, planes, meta = res
            ccfg = CodecConfig(q_scale=meta["q_scale"], transform=meta["transform"])
            fac = 8 // m_scale if 8 % m_scale == 0 else None
            try:
                outputs[j] = _np(mc.decode_color_scaled(p, planes, meta, ccfg, fac,
                                                        m=None if fac else m_scale, device=dev))
            except (ValueError, OSError) as e:
                outputs[j] = ("err", _err_kind(e), str(e))

        def _save(j):
            res = outputs[j] if outputs[j] is not None else parsed[j]
            if isinstance(res, tuple) and res and res[0] == "err":
                return res
            out = dst / (names[j] + ext)
            try:
                imageio.save_image(out, res, quality=args.quality)
            except (ValueError, OSError) as e:
                return ("err", _err_kind(e), str(e))
            return ("ok", out.name, list(res.shape))

        with ThreadPoolExecutor(n_threads) as ex:
            futs = {ex.submit(_save, j): j for j in range(len(names))}
            for fut in as_completed(futs):
                j = futs[fut]
                res = fut.result()
                with lock:
                    if res[0] == "err":
                        _mf_error(mf, names[j], res[1], res[2])
                        failed += 1
                    else:
                        _mf_done(mf, names[j], res[1], res[2])
                        decoded += 1

    with open(manifest, "a") as mf:
        for ci in range(0, len(todo), chunk):
            cnames = todo[ci : ci + chunk]
            with ThreadPoolExecutor(n_threads) as ex:
                datas = list(ex.map(_read, cnames))
            # streams above the threshold decode streamed, one at a time
            # (a .npy output through a disk memmap), never as whole maps
            bigset = set()
            for j, d in enumerate(datas):
                if isinstance(d, tuple) or _map_elems(d) <= streaming.STREAM_PIXELS:
                    continue
                bigset.add(j)
                name = cnames[j]
                out = dst / (name + ext)
                try:
                    kw = {"out_npy": str(out)} if ext == ".npy" else {}
                    decode = (streaming.decode_color_streamed if serialize.is_color_stream(d[:4])
                              else streaming.decode_gray_streamed)
                    rec = decode(p, d, scale_m=m_scale, device=dev, **kw)
                    if isinstance(rec, np.memmap):
                        rec.flush()
                    else:
                        imageio.save_image(out, np.asarray(rec), quality=args.quality)
                    _mf_done(mf, name, out.name, rec.shape, streamed=True)
                    decoded += 1
                except (ValueError, OSError) as e:
                    _mf_error(mf, name, _err_kind(e), str(e))
                    failed += 1
            rest = [j for j in range(len(datas)) if j not in bigset]
            for wave in _chunk(rest, [_map_elems(d) for d in datas], wave_elems):
                with ThreadPoolExecutor(n_threads) as ex:
                    parsed = list(ex.map(_parse, (datas[j] for j in wave)))
                _process_wave([cnames[j] for j in wave], parsed, mf)

    print(json.dumps({
        "decoded": decoded, "skipped": len(files) - len(todo),
        "failed": failed, "total": len(files), "manifest": str(manifest),
    }))
    return 0


def cmd_batch(args) -> int:
    """Bulk encode of a directory of images to .tdc/.tdcc files, resumably:
    a manifest (JSONL, one record per finished file) makes a rerun skip
    what is done under the same configuration.

    Loads run on host threads (JPEGs on the native decoder's pool), then
    each wave's same-width images ride one stacked device launch
    (``encode_gray_batch_auto``, ``encode_color_batch_auto``; bit-identical
    to each image alone) on the calling thread, and the entropy stage and
    the writes run on a thread pool.  A file that does not load is
    recorded and skipped; a kernel that does not build or launch ends the
    run.  Gray images above ``streaming.STREAM_PIXELS`` stream band by
    band into banded files.  The summary's "ms" splits the wall into the
    host loads and the device encode with the entropy stage and writes."""
    import os
    import pathlib
    import threading
    from concurrent.futures import ThreadPoolExecutor, as_completed

    from tpudct_torch.models import get_pipeline
    from tpudct_torch.models.dispatch import _chunk as _split_waves
    from tpudct_torch.models.dispatch import encode_gray_batch_auto
    from tpudct_torch.utils import imageio, serialize, streaming

    src = pathlib.Path(args.input_dir)
    dst = pathlib.Path(args.output_dir)
    dst.mkdir(parents=True, exist_ok=True)
    manifest = dst / "manifest.jsonl"
    # resume is per configuration: a success record carries the signature
    # of what changes the output; a stream's own fault stays done, an I/O
    # failure retries; records without these fields stay done
    cfg = _cfg_from(args)
    sig = (f"t={cfg.transform};q={cfg.q_scale};k={cfg.retain_k};"
           f"qt={cfg.q_table};e={args.entropy};"
           f"c={int(bool(getattr(args, 'color', False)))};"
           f"s={_chroma_mode(args)};"
           f"x={int(bool(getattr(args, 'transcode', False)))}")
    done = set()
    if manifest.exists():
        for line in manifest.read_text().splitlines():
            try:
                rec = json.loads(line)
                name = rec["file"]
            except (json.JSONDecodeError, KeyError):
                continue
            if "error" in rec:
                if rec.get("error_kind", "stream") != "io":
                    done.add(name)
            elif rec.get("cfg", sig) == sig:
                done.add(name)
    if args.transcode:
        raise ValueError(f"batch --transcode {_WAITS_FOR_COEF_IO}")

    p = get_pipeline(args.pipeline)
    dev = _dev(args)
    files = sorted(q.name for q in src.iterdir() if q.suffix.lower() in imageio.SUPPORTED_EXTS)
    todo = [name for name in files if name not in done]
    skipped = len(files) - len(todo)
    coded = failed = 0
    n_threads = args.decode_threads if args.decode_threads > 0 else min(os.cpu_count() or 4, 16)
    chunk = n_threads * 4
    lock = threading.Lock()
    # a wave's images, padded stacks and maps stay within ~3x this many
    # elements; the sizes come from the headers alone
    wave_elems = 1 << 28

    def _probe_elems(name) -> int:
        hw = imageio.probe_image_size(str(src / name))
        if hw is None:
            return 0
        return hw[0] * hw[1] * (3 if args.color else 1)

    def _record(mf, rec: dict) -> None:
        with lock:
            mf.write(json.dumps(rec) + "\n")
            mf.flush()

    t_wall0 = time.perf_counter()
    load_s = enc_ser_s = 0.0
    with open(manifest, "a") as mf:
        file_waves = [
            [todo[i + j] for j in wave]
            for i in range(0, len(todo), chunk)
            for wave in _split_waves(
                range(len(todo[i : i + chunk])),
                [_probe_elems(n) for n in todo[i : i + chunk]],
                wave_elems,
            )
        ]
        for names in file_waves:
            t_w0 = time.perf_counter()
            # JPEGs decode on the native pool, other formats one by one; a
            # file that does not load is None
            jpgs = [n for n in names if pathlib.Path(n).suffix.lower() in imageio.JPEG_EXTS]
            pooled = dict(zip(jpgs, imageio.load_jpeg_batch(
                [src / n for n in jpgs], n_threads=n_threads, errors="none", force_gray=not args.color,
            ))) if jpgs else {}
            images = []
            for n in names:
                if n in pooled:
                    images.append(pooled[n])
                else:
                    try:
                        im = imageio.load_image(str(src / n), force_gray=not args.color)
                        # a .npy raster is a read-only memory map: read it
                        # here, so no tensor shares a read-only buffer
                        images.append(np.array(im) if isinstance(im, np.memmap) else im)
                    except (OSError, ValueError):
                        images.append(None)
            pairs = []
            for name, img in zip(names, images):
                if img is None:
                    # recorded (a rerun skips it too), and the job goes on
                    _record(mf, {"file": name, "error": "decode_failed"})
                    failed += 1
                    continue
                pairs.append((name, img))
            load_s += time.perf_counter() - t_w0
            t_w1 = time.perf_counter()
            if not pairs:
                continue
            if args.color:
                from tpudct_torch.models.color import encode_color_batch_auto

                rgbs = [np.stack([im] * 3, axis=-1) if im.ndim == 2 else im for _, im in pairs]
                encc = encode_color_batch_auto(p, rgbs, cfg, subsample=_chroma_mode(args), device=dev)

                def _save_color(j):
                    name = pairs[j][0]
                    planes, meta = encc[j]
                    out = dst / (name + ".tdcc")
                    n = serialize.save_color(out, planes, meta, cfg.q_scale, cfg.retain_k, cfg.transform,
                                             codec=args.entropy)
                    return name, out.name, n, meta["orig_shape"]

                with ThreadPoolExecutor(n_threads) as ex:
                    for fut in as_completed(ex.submit(_save_color, j) for j in range(len(pairs))):
                        name, out_name, n, (h, w) = fut.result()
                        _record(mf, {"file": name, "tdc": out_name, "bytes": n, "shape": [h, w, 3], "cfg": sig})
                        coded += 1
                enc_ser_s += time.perf_counter() - t_w1
                continue
            # frames above the threshold stream band by band into banded
            # files (the path of `encode --band-rows`)
            big = [(nm, im) for nm, im in pairs if im.size > streaming.STREAM_PIXELS]
            if big:
                pairs = [(nm, im) for nm, im in pairs if im.size <= streaming.STREAM_PIXELS]
                for name, im in big:
                    out = dst / (name + ".tdc")
                    try:
                        data, (h, w) = streaming.encode_gray_streamed_bytes(
                            p, np.asarray(im, np.uint8), cfg, inner=_stream_inner(args.entropy), device=dev,
                        )
                        out.write_bytes(data)
                    except (ValueError, OSError) as e:
                        _record(mf, {"file": name, "error": str(e), "error_kind": _err_kind(e)})
                        failed += 1
                        continue
                    _record(mf, {"file": name, "tdc": out.name, "bytes": len(data), "shape": [h, w],
                                 "cfg": sig, "streamed": True})
                    coded += 1
                if not pairs:
                    enc_ser_s += time.perf_counter() - t_w1
                    continue
            # same-width images ride one stacked launch (host arrays back
            # after one copy per chunk); the entropy stage and writes thread
            enc = encode_gray_batch_auto(p, [im for _, im in pairs], cfg, device=dev)

            def _save(j):
                name = pairs[j][0]
                c, (h, w) = enc[j]
                # the full input name: a.jpg and a.jpeg cannot collide
                out = dst / (name + ".tdc")
                n = serialize.save_coefficients(
                    out, c, cfg.q_scale, cfg.retain_k, orig_shape=(h, w), transform=cfg.transform,
                    codec=args.entropy, q_table=cfg.q_table,
                )
                return name, out.name, n, (h, w)

            with ThreadPoolExecutor(n_threads) as ex:
                for fut in as_completed(ex.submit(_save, j) for j in range(len(pairs))):
                    name, out_name, n, (h, w) = fut.result()
                    _record(mf, {"file": name, "tdc": out_name, "bytes": n, "shape": [h, w], "cfg": sig})
                    coded += 1
            enc_ser_s += time.perf_counter() - t_w1
    print(json.dumps({
        "encoded": coded, "skipped": skipped, "failed": failed,
        "total": len(files), "manifest": str(manifest),
        "ms": {"load": round(load_s * 1e3, 1),
               "encode_serialize": round(enc_ser_s * 1e3, 1),
               "wall": round((time.perf_counter() - t_wall0) * 1e3, 1)},
    }))
    return 0


def cmd_scale(args) -> int:
    from tpudct_torch.parallel.scaling import scaling_table

    counts = None
    if args.devices:
        counts = [int(x) for x in args.devices.split(",")]
    k_pair = None
    if args.k_pair:
        k_pair = tuple(int(x) for x in args.k_pair.split(","))
        if len(k_pair) != 2:
            raise ValueError(f"--k-pair expects A,B, got {args.k_pair!r}")
    for row in scaling_table(args.size, args.pipeline, counts, _cfg_from(args), reps=args.reps, k_pair=k_pair,
                             device=args.device):
        print(json.dumps(row))
    return 0


def cmd_profile(args) -> int:
    """A device trace of `reps` codec passes (``p.roundtrip`` of the seeded
    noise image), after one warm-up pass outside the window, as a Chrome
    trace (``trace.json`` in --out; Perfetto and chrome://tracing open it)."""
    import torch

    from tpudct_torch.benchmark import synthetic_image
    from tpudct_torch.models import get_pipeline
    from tpudct_torch.utils import profiling

    cfg = _cfg_from(args)
    p = get_pipeline(args.pipeline)
    dev = _dev(args)
    x = torch.as_tensor(synthetic_image(args.size), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    p.roundtrip(x, cfg)  # builds the kernels outside the window
    sync()
    with profiling.trace(args.out):
        with profiling.annotate(f"{p.name}-roundtrip-{args.size}"):
            for _ in range(args.reps):
                p.roundtrip(x, cfg)
            sync()
    print(json.dumps({"trace_dir": args.out, "pipeline": p.name, "size": args.size, "reps": args.reps}))
    return 0


def cmd_selftest(args) -> int:
    """The correctness gate as a user command: one seed-42 image through the
    kernels on the device, held against the float64 golden model
    (``selftest.correctness_gate``); with --families one small case per
    kernel family (``selftest.family_gates``).  The golden model covers the
    reference configuration, so the gate checks exactly that."""
    from tpudct_torch.config import CodecConfig
    from tpudct_torch.models import get_pipeline
    from tpudct_torch.selftest import correctness_gate, family_gates

    p = get_pipeline(args.pipeline)
    dev = _dev(args)
    try:
        rep = correctness_gate(p, CodecConfig(), size=args.size, device=dev)
        fams = family_gates(p, CodecConfig(), device=dev) if args.families else []
    except (AssertionError, ValueError, OSError, RuntimeError) as e:
        print(json.dumps({"gate": "FAIL", "reason": str(e)}))
        return 1
    print(json.dumps(rep))
    for f in fams:
        print(json.dumps(f))
    return 0


def cmd_transcode(args) -> int:
    raise ValueError(f"transcode {_WAITS_FOR_COEF_IO}")


def cmd_edit(args) -> int:
    raise ValueError(f"edit {_WAITS_FOR_COEF_IO}")


def cmd_compare(args) -> int:
    """Tolerance comparison of two images with the metric suite: exit code
    0 where max|a - b| <= --tol, 1 where not, 2 where the shapes differ.
    Color images compare in their channels (SSIM on BT.601 luma).  Two
    .tdc/.tdcc inputs compare at the coefficient level instead: the count
    of differing entries, the largest difference, and whether the
    difference fits the +-1 on <= 0.5% tie class."""
    from tpudct_torch.utils import imageio, metrics

    def _is_tdc(path):
        return str(path).lower().endswith((".tdc", ".tdcc"))

    if _is_tdc(args.a) and _is_tdc(args.b):
        from tpudct_torch.utils import serialize

        def _planes(path):
            with open(path, "rb") as f:
                data = f.read()
            if serialize.is_color_stream(data):
                pl, _meta = serialize.bytes_to_color(data)
                return {k: np.asarray(v, np.float64) for k, v in pl.items()}
            c, _qs, _k = serialize.bytes_to_coefficients(data)
            return {"y": np.asarray(c, np.float64)}

        pa, pb = _planes(args.a), _planes(args.b)
        if sorted(pa) != sorted(pb) or any(pa[k].shape != pb[k].shape for k in pa):
            print(json.dumps({
                "error": "shape_mismatch",
                "a": {k: list(v.shape) for k, v in pa.items()},
                "b": {k: list(v.shape) for k, v in pb.items()},
            }))
            return 2
        total = sum(v.size for v in pa.values())
        diff = {k: np.abs(pa[k] - pb[k]) for k in pa}
        ndiff = int(sum((d > 0).sum() for d in diff.values()))
        maxd = float(max(d.max() for d in diff.values()))
        print(json.dumps({
            "coefficients": True,
            "planes": sorted(pa),
            "total": total,
            "differing": ndiff,
            "differing_pct": round(100.0 * ndiff / total, 4),
            "max_abs_diff": maxd,
            "tol": args.tol,
            "within_tie_class": bool(maxd <= 1.0 and ndiff <= total * 0.005),
        }))
        return 0 if maxd <= args.tol else 1

    a = imageio.load_image(args.a, force_gray=False).astype(np.float64)
    b = imageio.load_image(args.b, force_gray=False).astype(np.float64)
    if a.shape != b.shape:
        print(json.dumps({"error": "shape_mismatch", "shape_a": list(a.shape), "shape_b": list(b.shape)}))
        return 2

    def _luma(x):
        if x.ndim == 2:
            return x
        return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]

    dev = _dev(args)
    maxdiff = float(np.abs(a - b).max())
    rep = {
        "mse": float(metrics.mse(a, b, dev)),
        "psnr_db": float(metrics.psnr(a, b, dev)),
        "peen_pct": float(metrics.peen(a, b, dev)),
        "ssim": float(metrics.ssim(_luma(a), _luma(b), device=dev)),
    }
    close = maxdiff <= args.tol
    print(json.dumps({"shape": list(a.shape), "max_abs_diff": maxdiff, "tol": args.tol, "close": close, **rep}))
    return 0 if close else 1


def cmd_info(_args) -> int:
    """The environment: the package, the torch backend ("cuda" where a card
    is visible, else "cpu") and its devices (a card with its name), the
    host libraries, pipelines, transforms and tables."""
    import torch

    import tpudct_torch
    from tpudct_torch.constants import Q_TABLES, TRANSFORM_ALIASES, TRANSFORMS
    from tpudct_torch.utils.entropy import native_entropy_available, rans_available
    from tpudct_torch.utils.imageio import native_backend_available

    cuda = torch.cuda.is_available()
    devices = ([f"cuda:{i} ({torch.cuda.get_device_name(i)})" for i in range(torch.cuda.device_count())]
               if cuda else ["cpu"])
    print(json.dumps({
        "version": tpudct_torch.__version__,
        "backend": "cuda" if cuda else "cpu",
        "devices": devices,
        "native_jpeg": native_backend_available(),
        "native_entropy": native_entropy_available(),
        "native_rans": rans_available(),
        "pipelines": tpudct_torch.available_pipelines(),
        "transforms": sorted(TRANSFORMS),
        "transform_aliases": dict(TRANSFORM_ALIASES),
        "q_tables": sorted(Q_TABLES),
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpudct_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("run", help="encode+decode one image (the original codec's main-program flow)")
    _add_codec_flags(sp)
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--quality", type=int, default=100, help="output JPEG quality (ref: 100)")
    sp.add_argument("--coeffs", default=None, help="also write the .tdc coefficient file")
    sp.add_argument("--corners", action="store_true",
                    help="the original main programs' verbosity: 4 stage corners + per-phase ms (staged, not fused)")
    _add_color_flags(sp)
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("encode", help="image -> .tdc (gray) / .tdcc (color) coefficient file")
    _add_codec_flags(sp)
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--band-rows", type=int, default=None, dest="band_rows",
                    help="stream the encode in host bands of N rows (bounded device memory; writes a banded stream); images above 2^32 pixels stream without it")
    _add_color_flags(sp)
    sp.set_defaults(fn=cmd_encode)

    sp = sub.add_parser("decode", help=".tdc/.tdcc coefficient file -> image")
    sp.add_argument("--pipeline", default="hp")
    sp.add_argument("--quality", type=int, default=100)
    sp.add_argument("--planes", type=int, default=None,
                    help="progressive decode: use only the first N zig-zag spectral planes (1-64; gray and color)")
    sp.add_argument("--preview", action="store_true",
                    help="1/8-scale DC-only thumbnail (no transform, no device; works on truncated downloads)")
    sp.add_argument("--rows", default=None,
                    help="region decode: only image rows A:B (blocks are independent, so only covering block rows transform)")
    sp.add_argument("--scale", default=None, metavar="M/8",
                    help="fractional-scale decode (djpeg -scale): reconstruct straight to ceil(H*M/8) x ceil(W*M/8) for M in 1..16 (aliases 1/2, 1/4, 1/8, 3/4, 3/2, 2/1 accepted)")
    sp.add_argument("--grayscale", action="store_true",
                    help="decode a color stream luma-only (djpeg -grayscale): the chroma planes never decode; composes with --scale, --rows, --planes and --preview")
    sp.add_argument("--band-rows", type=int, default=None, dest="band_rows",
                    help="stream the decode in device bands of N rows (bounded device memory; every mode; a .npy output is written band by band); streams above 2^32 pixels stream without it")
    _add_device_flag(sp)
    sp.add_argument("input")
    sp.add_argument("output")
    sp.set_defaults(fn=cmd_decode)

    sp = sub.add_parser("bench", help="one-size benchmark (the original benchmark programs' flow)")
    _add_codec_flags(sp)
    sp.add_argument("--size", type=int, default=1024)
    sp.add_argument("--reps", type=int, default=5)
    sp.add_argument("--pipelines", default="hp")
    sp.add_argument("--fused", action="store_true", help="also time the single-kernel roundtrip")
    sp.add_argument("--batch", type=int, default=0, help="also time serving throughput for a batch of N images")
    sp.add_argument("--cpu", action="store_true", help="also time the host-CPU numpy baseline (the original CPU column's analog)")
    sp.add_argument("--color", action="store_true", help="also time the full RGB color codec pass")
    sp.add_argument("--chroma", choices=("420", "422", "444"), default=None,
                    help="with --color: chroma mode for the color bench (default 420)")
    sp.add_argument("--host-entropy", action="store_true", dest="host_entropy",
                    help="benchmark the host entropy stage instead (every .tdc codec's encode/decode on this size; no device work)")
    sp.add_argument("--e2e", action="store_true",
                    help="end-to-end wall-time decomposition instead: load -> device -> entropy -> write for one --size image (+ the bulk batch flow when --batch N is given); needs a JPEG encoder (libjpeg or PIL)")
    sp.add_argument("--image", default="photo", choices=("photo", "circuit", "noise"),
                    help="test-image statistics for --host-entropy and --e2e (default photo)")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("sweep", help="size x pipeline benchmark table (the original README's table)")
    _add_codec_flags(sp)
    sp.add_argument("--sizes", default="256,512,1024,2048,4096,8192")
    sp.add_argument("--pipelines", default="batched,fast,hp")
    sp.add_argument("--reps", type=int, default=5)
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("table", help="PEEN/MSE/compression k-sweep (the original README's accuracy table)")
    _add_codec_flags(sp)
    sp.add_argument("input", nargs="?", default=None,
                    help="image input; default: built-in generated image (see --image)")
    sp.add_argument("--image", choices=("circuit", "photo"), default="circuit",
                    help="built-in generator when no input is given: circuit-board content analog | photographic-statistics analog")
    _add_color_flags(sp)
    sp.set_defaults(fn=cmd_table)

    sp = sub.add_parser("batch", help="bulk encode a directory to .tdc/.tdcc, resumable via manifest")
    _add_codec_flags(sp)
    _add_color_flags(sp)
    sp.add_argument("input_dir")
    sp.add_argument("output_dir")
    sp.add_argument("--decode-threads", type=int, default=8,
                    help="JPEG decode and entropy thread pool size (0 = one per CPU)")
    sp.add_argument("--transcode", action="store_true",
                    help="lossless archival mode (the JPEG coefficient import): not ported yet, ROADMAP A.4a(ii)")
    sp.set_defaults(fn=cmd_batch)

    sp = sub.add_parser("curve", help="rate-distortion sweep: .tdc vs libjpeg bytes+PSNR per quality (needs libjpeg or PIL)")
    _add_codec_flags(sp)
    sp.add_argument("input", nargs="?", default=None,
                    help="image input; default: built-in generated image (see --image)")
    sp.add_argument("--image", choices=("circuit", "photo"), default="photo")
    sp.add_argument("--qualities", default="10,20,30,40,50,60,70,80,90,95")
    _add_color_flags(sp)
    sp.set_defaults(fn=cmd_curve)

    sp = sub.add_parser("unbatch", help="bulk decode a directory of .tdc/.tdcc back to images, resumable")
    sp.add_argument("--pipeline", default="hp")
    sp.add_argument("--quality", type=int, default=100)
    sp.add_argument("--ext", default=".jpg",
                    help="output extension: .jpg (default, quality applies) or a lossless format like .png or .npy")
    sp.add_argument("--scale", default=None, metavar="M/8",
                    help="bulk thumbnailer: decode every stream at M/8 scale (M in 1..16; integer 8/M rides the fused scaled kernel — see decode --scale)")
    sp.add_argument("--transcode", action="store_true",
                    help="lossless export back to .jpg (the JPEG coefficient export): not ported yet, ROADMAP A.4a(ii)")
    sp.add_argument("--optimize", action="store_true", help="with --transcode: two-pass optimal Huffman tables")
    sp.add_argument("--progressive", action="store_true", help="with --transcode: progressive scan script")
    sp.add_argument("--arithmetic", action="store_true", help="with --transcode: T.81 arithmetic entropy coding")
    _add_device_flag(sp)
    sp.add_argument("input_dir")
    sp.add_argument("output_dir")
    sp.set_defaults(fn=cmd_unbatch)

    sp = sub.add_parser("scale", help="scaling-efficiency table across rank counts (virtual ranks on one card measure stream overlap, not scaling)")
    _add_codec_flags(sp)
    sp.add_argument("--size", type=int, default=2048)
    sp.add_argument("--devices", default=None,
                    help="comma list of rank counts, default powers of 2 up to the cards (or --device); counts above the cards put virtual ranks on them")
    sp.add_argument("--reps", type=int, default=3)
    sp.add_argument("--k-pair", default=None, dest="k_pair",
                    help="the reference's chain-length pin, A,B: accepted and inert (CUDA events time each call)")
    sp.set_defaults(fn=cmd_scale)

    sp = sub.add_parser("profile", help="capture a per-kernel device trace (Chrome trace: Perfetto, chrome://tracing)")
    _add_codec_flags(sp)
    sp.add_argument("--size", type=int, default=2048)
    sp.add_argument("--reps", type=int, default=3)
    sp.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "tpudct_torch-trace"),
                    help="trace output directory (trace.json)")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser("selftest", help="on-device correctness gate vs the f64 golden (the reference configuration)")
    sp.add_argument("--pipeline", default="hp")
    sp.add_argument("--size", type=int, default=512)
    sp.add_argument("--families", action="store_true",
                    help="also sweep one small case per kernel family (color 4:2:0 u8, f32, scaled decode, "
                         "streamed gray and color; the reference's jpg import waits for ROADMAP A.4a(ii))")
    _add_device_flag(sp)
    sp.set_defaults(fn=cmd_selftest)

    sp = sub.add_parser("inspect", help="header-only report on .tdc/.tdcc files (codec, geometry, entropy stage, payload bytes; no decode)")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("transcode", help="lossless coefficient-domain jpg <-> .tdc/.tdcc: not ported yet (ROADMAP A.4a(ii))")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.add_argument("--entropy", default="auto", type=_entropy_spec)
    sp.add_argument("--optimize", action="store_true")
    sp.add_argument("--progressive", action="store_true")
    sp.add_argument("--arithmetic", action="store_true")
    sp.set_defaults(fn=cmd_transcode)

    sp = sub.add_parser("edit", help="lossless coefficient-domain flip/rotate/crop/grayscale: not ported yet (ROADMAP A.4a(ii))")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.add_argument("--op", action="append",
                    choices=("hflip", "vflip", "rot90", "rot180", "rot270", "transpose"))
    sp.add_argument("--crop", nargs=4, type=int, metavar=("Y0", "X0", "H", "W"))
    sp.add_argument("--grayscale", action="store_true")
    sp.add_argument("--entropy", default="auto",
                    choices=("auto", "auto-exact", "spectral", "huffman", "rans", "xz", "raw", "banded"))
    sp.add_argument("--optimize", action="store_true")
    sp.add_argument("--progressive", action="store_true")
    sp.add_argument("--arithmetic", action="store_true")
    sp.set_defaults(fn=cmd_edit)

    sp = sub.add_parser("compare", help="tolerance-compare two images + metric suite; two .tdc/.tdcc inputs diff at the coefficient level")
    sp.add_argument("a")
    sp.add_argument("b")
    sp.add_argument("--tol", type=float, default=0.0, help="max |a-b| accepted as close (default 0: bit-exact)")
    _add_device_flag(sp)
    sp.set_defaults(fn=cmd_compare)

    sp = sub.add_parser("info", help="environment / backend report")
    sp.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (KeyError, ValueError, OSError) as e:
        # a clean CLI error: the message without the traceback
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
