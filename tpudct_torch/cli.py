"""Command-line interface of the port: the file workflow of ``tpudct/cli.py``.

  python -m tpudct_torch run    --pipeline hp input.jpg output.jpg [--coeffs x.tdc]
  python -m tpudct_torch encode --pipeline hp input.npy coeffs.tdc
  python -m tpudct_torch decode coeffs.tdc output.npy
  python -m tpudct_torch inspect coeffs.tdc [more.tdcc ...]

The files are the reference's: a ``.tdc``/``.tdcc`` written here has the
bytes the reference writes for the same coefficients, and each package
decodes the other's files.  Color via ``--color`` on run/encode; decode
reads gray and color streams, in full or as ``--grayscale``, ``--scale
M/8``, ``--planes N``, ``--preview`` and ``--rows A:B``.

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
flag.  (``CodecConfig.band_rows`` is another thing: an inert field kept for
the reference's config surface.)

Not ported yet (each raises a ValueError that says so): ``.jpg`` decode
inputs (the lossless coefficient import; ROADMAP A.4a(ii)), and the
reference's other verbs.
"""

from __future__ import annotations

import argparse
import json
import sys
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

    sp = sub.add_parser("inspect", help="header-only report on .tdc/.tdcc files (codec, geometry, entropy stage, payload bytes; no decode)")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_inspect)
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
