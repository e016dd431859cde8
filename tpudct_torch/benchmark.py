"""Benchmark harness: the counterpart of ``tpudct/benchmark.py``.

The original codec's protocol: seeded synthetic images (srand(42);
rand()%256, benchmark_newAppr.cu:46-51), sizes 256..8192, the DCT and IDCT
phases timed apart and the fused roundtrip, device time only.  Here every
bench times with ``utils.timing.device_time_ms`` (CUDA events, L2 flushed)
on ``models.dispatch.default_device(device)``: the first CUDA card, or the
device named (``device="cpu"`` times the plain twins with the host clock;
``backend`` then says "cpu", and no such number is a device time).  The
benches return the reference's keys; ``backend`` names the device the work
ran on (the card's name on CUDA).  ``k_pair`` is the reference's chain
length, inert here (see ``utils.timing``).

The accuracy tables and the rate-distortion curves run the codec on the
same device and report quality and on-disk bytes, not times.  The host
benches time host clocks: ``bench_host_entropy`` the serializer alone (no
device), ``bench_e2e_encode`` one image from a JPEG file to ``.tdc`` bytes
on disk (the device phase a host wall that includes the copy back), and
``bench_e2e_batch`` the CLI's ``batch`` verb over a directory of JPEGs.
Whatever writes or reads a JPEG needs libjpeg (``utils/native.py``) or
PIL, as in the reference.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.models import get_pipeline
from tpudct_torch.models.dispatch import default_device
from tpudct_torch.utils.timing import device_time_ms

# Published per-op (DCT) times in ms for the proposed HpApprDCT kernel on a
# Tesla T4 (README.md:50-55) — the numbers to beat.
REFERENCE_HP_DCT_MS = {256: 0.07, 512: 0.12, 1024: 0.30, 2048: 1.04, 4096: 4.00, 8192: 14.70}
REFERENCE_FAST_DCT_MS = {256: 0.28, 512: 0.33, 1024: 0.61, 2048: 1.65, 4096: 5.80, 8192: 20.00}
REFERENCE_CPU_DCT_MS = {256: 4.7, 512: 17.9, 1024: 72.8, 2048: 291.7, 4096: 1255.1, 8192: 5005.1}


def synthetic_image(size: int, seed: int = 42) -> np.ndarray:
    """Deterministic uint8-valued float image (the srand(42) analog)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(size, size)).astype(np.float32)


def structured_image(size: int = 512, seed: int = 7) -> np.ndarray:
    """Deterministic circuit-board-like test image: traces, pads, packages
    (a reproducible stand-in for the 'Circuit' image of the original
    codec's accuracy table, which is not in its repository)."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size), 40.0, np.float32)  # dark substrate
    # horizontal/vertical traces
    for _ in range(size // 16):
        y = int(rng.integers(0, size))
        t = int(rng.integers(1, 4))
        img[y : y + t, int(rng.integers(0, size // 2)) :] = 180.0
        x = int(rng.integers(0, size))
        img[int(rng.integers(0, size // 2)) :, x : x + t] = 170.0
    # IC packages (dark rectangles with bright pads); skipped below the
    # smallest size the geometry fits
    for _ in range(size // 64 if size > 83 else 0):
        y, x = rng.integers(3, size - 80, size=2)
        h, w = rng.integers(30, 80, size=2)
        img[y : y + h, x : x + w] = 15.0
        for px in range(int(x) + 4, int(x + w) - 4, 8):
            img[y - 3 : y, px : px + 4] = 230.0
            img[y + h : y + h + 3, px : px + 4] = 230.0
    # solder pads (bright disks), each drawn in its own (2r+1)^2 window
    for _ in range(size // 32):
        cy, cx = rng.integers(0, size, size=2)
        r = int(rng.integers(3, 9))
        y0, y1 = max(0, int(cy) - r), min(size, int(cy) + r + 1)
        x0, x1 = max(0, int(cx) - r), min(size, int(cx) + r + 1)
        wy = np.arange(y0, y1)[:, None]
        wx = np.arange(x0, x1)[None, :]
        img[y0:y1, x0:x1][(wy - cy) ** 2 + (wx - cx) ** 2 <= r * r] = 255.0
    # mild sensor noise
    img = img + rng.normal(0.0, 2.0, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.float32)


def photographic_image(size: int = 512, seed: int = 5) -> np.ndarray:
    """Deterministic natural-statistics test image (photograph analog):
    two-band spectral synthesis (1/f^1.6 and 1/f envelopes), illumination
    gradients, objects with sharp sigmoid boundaries, thin linear
    structures and mild sensor noise."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0 / size

    def field(expo):
        spec = rng.normal(size=(size, size)) + 1j * rng.normal(size=(size, size))
        b = np.real(np.fft.ifft2(spec / f**expo))
        return (b - b.mean()) / (b.std() + 1e-9)

    yy, xx = np.mgrid[0:size, 0:size] / size
    img = (
        128.0 + 45.0 * field(1.6) + 8.0 * field(1.0)
        + 25.0 * (xx - 0.5) + 18.0 * (yy - 0.5)
    )
    # objects with sharp (1-px sigmoid) boundaries
    for _ in range(6):
        cy, cx = rng.uniform(0.15, 0.85, 2) * size
        r = rng.uniform(0.05, 0.18) * size
        amp = rng.uniform(-45.0, 45.0)
        d = np.sqrt(
            (np.mgrid[0:size][:, None] - cy) ** 2
            + (np.arange(size)[None, :] - cx) ** 2
        )
        # the argument clipped: exp overflows far from the boundary
        img = img + amp / (1.0 + np.exp(np.minimum(d - r, 80.0)))
    # thin linear structures
    for _ in range(max(size // 24, 4)):
        amp = rng.uniform(-60.0, 60.0)
        t = int(rng.integers(1, 3))
        if rng.random() < 0.5:
            y = int(rng.integers(0, size))
            x0 = int(rng.integers(0, size // 2))
            img[y : y + t, x0 : int(rng.integers(x0 + size // 4, size))] += amp
        else:
            x = int(rng.integers(0, size))
            y0 = int(rng.integers(0, size // 2))
            img[y0 : int(rng.integers(y0 + size // 4, size)), x : x + t] += amp
    img = img + rng.normal(0.0, 1.5, img.shape)  # mild sensor noise
    return np.clip(np.round(img), 0, 255).astype(np.float32)


def _backend(dev: torch.device) -> str:
    """The device a bench ran on: the card's name, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def bench_pipeline(name: str, size: int, cfg: Optional[CodecConfig] = None, k_pair=None,
                   reps: int = 5, device=None) -> dict:
    """Per-phase times for one pipeline at one size: dct_ms, idct_ms (pair
    minus dct), pair_ms, throughput, and the comparison with the original
    codec's published T4 numbers where they exist."""
    cfg = cfg or CodecConfig()
    p = get_pipeline(name)
    dev = default_device(device)
    x = torch.as_tensor(synthetic_image(size), device=dev)
    dct_ms = device_time_ms(lambda v: p.dct(v, cfg), x, k_pair=k_pair, reps=reps)
    pair_ms = device_time_ms(lambda v: p.idct(p.dct(v, cfg), cfg), x, k_pair=k_pair, reps=reps)
    out = {
        "pipeline": name,
        "size": size,
        "dct_ms": dct_ms,
        "idct_ms": max(pair_ms - dct_ms, 0.0),
        "pair_ms": pair_ms,
        "mpix_per_s_pair": size * size / pair_ms / 1e3 if pair_ms > 0 else None,
        "backend": _backend(dev),
    }
    ref = REFERENCE_HP_DCT_MS.get(size)
    if ref is not None:
        out["ref_hp_dct_ms"] = ref
        out["speedup_dct_vs_ref_hp"] = ref / dct_ms if dct_ms > 0 else None
        out["speedup_pair_vs_ref_hp"] = (2 * ref) / pair_ms if pair_ms > 0 else None
    return out


def bench_fused_roundtrip(size: int, cfg: Optional[CodecConfig] = None, k_pair=None, reps: int = 5,
                          device=None) -> dict:
    """The single-kernel roundtrip (``hp_roundtrip``, B4 or B4'): image ->
    coefficients + reconstruction in one pass, with the hp pipeline's
    int-core and decode-tier demotions for the configured transform."""
    from tpudct_torch.kernels import hp
    from tpudct_torch.models.hp_appr import _decode_prec, _int_core

    cfg = cfg or CodecConfig()
    dev = default_device(device)
    x = torch.as_tensor(synthetic_image(size), device=dev)

    def rt(v):
        return hp.hp_roundtrip(
            v, q_scale=cfg.q_scale, q_table=cfg.q_table, retain_k=cfg.retain_k,
            decode_precision=_decode_prec(cfg), transform=cfg.transform, int_core=_int_core(cfg),
        )[1]

    ms = device_time_ms(rt, x, k_pair=k_pair, reps=reps)
    return {
        "pipeline": "hp-fused",
        "transform": cfg.transform,
        "size": size,
        "roundtrip_ms": ms,
        "mpix_per_s": size * size / ms / 1e3 if ms > 0 else None,
        "backend": _backend(dev),
    }


def bench_serving_throughput(size: int = 1024, batch: int = 16, cfg: Optional[CodecConfig] = None,
                             k_pair=None, reps: int = 5, device=None) -> dict:
    """Serving tier: a batch of B images per pass, folded into one (B*S, S)
    image (8x8 blocks are independent), through the u8 roundtrip (one
    ``hp_roundtrip_u8`` launch), or the f32 roundtrip where int8
    coefficients do not hold."""
    from tpudct_torch.kernels import hp

    cfg = cfg or CodecConfig()
    dev = default_device(device)
    rng = np.random.default_rng(42)
    tall = rng.integers(0, 256, size=(batch * size, size), dtype=np.uint8)
    p = get_pipeline("hp")
    if hp.supports_u8(batch * size, size, cfg.q_scale, cfg.transform, cfg.q_table):
        x = torch.as_tensor(tall, device=dev)
        fn = lambda v: p.roundtrip_u8(v, cfg)[1]  # noqa: E731
        path = "u8-fused"
    else:
        x = torch.as_tensor(tall, device=dev).to(torch.float32)
        fn = lambda v: p.roundtrip(v, cfg)[1]  # noqa: E731
        path = "f32-fallback"
    ms = device_time_ms(fn, x, k_pair=k_pair, reps=reps)
    return {
        "pipeline": "hp-serving",
        "path": path,
        "transform": cfg.transform,
        "size": size,
        "batch": batch,
        "batch_ms": ms,
        "images_per_s": batch / ms * 1e3 if ms > 0 else None,
        "mpix_per_s": batch * size * size / ms / 1e3 if ms > 0 else None,
        "backend": _backend(dev),
    }


def bench_color(size: int = 2048, pipeline: str = "hp", cfg: Optional[CodecConfig] = None,
                subsample=True, k_pair=None, reps: int = 5, device=None) -> dict:
    """The full color codec pass (RGB -> YCbCr -> three planes -> RGB u8):
    the u8 planar path (split, two encodes, two decodes, merge) where the
    pipeline and the geometry allow it, else the f32 path."""
    from tpudct_torch.models.color import (
        decode_color_u8,
        encode_color_u8,
        normalize_subsample,
        roundtrip_color,
        supports_color_u8,
    )

    cfg = cfg or CodecConfig()
    p = get_pipeline(pipeline)
    dev = default_device(device)
    mode = normalize_subsample(subsample)
    if supports_color_u8(p, cfg, size, size, mode):
        rgb8 = torch.as_tensor(
            np.stack([synthetic_image(size, seed=s) for s in (1, 2, 3)], axis=0).astype(np.uint8),
            device=dev,
        )

        def fn(v):
            planes, meta = encode_color_u8(p, v, cfg, subsample=mode)
            return decode_color_u8(p, planes, meta, cfg)

        path, x = "u8-planar", rgb8
    else:
        x = torch.as_tensor(np.stack([synthetic_image(size, seed=s) for s in (1, 2, 3)], axis=-1),
                            device=dev)

        def fn(v):
            return roundtrip_color(p, v, cfg, subsample=subsample)[2]

        path = "f32"
    ms = device_time_ms(fn, x, k_pair=k_pair, reps=reps)
    return {
        "pipeline": f"{pipeline}-color",
        "path": path,
        "size": size,
        "subsample": mode if mode else "444",
        "rgb_ms": ms,
        "mpix_per_s": size * size / ms / 1e3 if ms > 0 else None,
        "backend": _backend(dev),
    }


def bench_color_serving(size: int = 1024, batch: int = 8, cfg: Optional[CodecConfig] = None,
                        k_pair=None, reps: int = 5, device=None) -> dict:
    """Color serving tier: B RGB frames per pass, stacked as taller planes
    (3, B*S, S) through the u8 4:2:0 path (4:2:0 pooling is 2-row local)."""
    from tpudct_torch.models.color import decode_color_u8, encode_color_u8, supports_color_u8

    cfg = cfg or CodecConfig()
    p = get_pipeline("hp")
    h = batch * size
    if not supports_color_u8(p, cfg, h, size):
        raise ValueError(
            f"color serving path needs (B*S) % 64 == 0, S % 256 == 0 and an "
            f"int8-safe q_scale; got B={batch}, S={size}"
        )
    dev = default_device(device)
    rgb8 = torch.as_tensor(np.concatenate(
        [np.stack([synthetic_image(size, seed=3 * b + c) for c in range(3)], axis=0) for b in range(batch)],
        axis=1,
    ).astype(np.uint8), device=dev)

    def fn(v):
        planes, meta = encode_color_u8(p, v, cfg)
        return decode_color_u8(p, planes, meta, cfg)

    ms = device_time_ms(fn, rgb8, k_pair=k_pair, reps=reps)
    return {
        "pipeline": "hp-color-serving",
        "size": size,
        "batch": batch,
        "batch_ms": ms,
        "images_per_s": batch / ms * 1e3 if ms > 0 else None,
        "mpix_per_s": batch * size * size / ms / 1e3 if ms > 0 else None,
        "backend": _backend(dev),
    }


def _host_dct_quant(img: np.ndarray, cfg: CodecConfig) -> np.ndarray:
    """Vectorized host numpy blockwise DCT + quantize honoring the config
    (transform, q_table, q_scale) -> (nbY, nbX, 8, 8) f32 quantized blocks."""
    from tpudct_torch.constants import get_q_table, get_transform

    t = get_transform(cfg.transform).t.astype(np.float32)
    q = (get_q_table(cfg.q_table) * np.float32(cfg.q_scale)).astype(np.float32)
    bs = 8
    h, w = img.shape
    xb = img.reshape(h // bs, bs, w // bs, bs).transpose(0, 2, 1, 3) - np.float32(128.0)
    z = np.einsum("ij,abjk,lk->abil", t, xb, t) / q
    return np.sign(z) * np.floor(np.abs(z) + np.float32(0.5))


def bench_cpu_numpy(size: int, cfg: Optional[CodecConfig] = None, reps: int = 3) -> dict:
    """Host CPU baseline: the codec's DCT + quantize as vectorized numpy f32
    on this host, best of ``reps`` (the original codec's CPU column timed a
    sequential C loop on a 2.0 GHz Xeon)."""
    cfg = cfg or CodecConfig()
    img = synthetic_image(size)
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        _host_dct_quant(img, cfg)
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    out = {"pipeline": "cpu-numpy", "size": size, "dct_ms": best}
    ref = REFERENCE_CPU_DCT_MS.get(size)
    if ref is not None:
        out["ref_cpu_dct_ms"] = ref
    return out


def _test_image(image: str, size: int) -> np.ndarray:
    gen = {"photo": photographic_image, "circuit": structured_image, "noise": synthetic_image}
    try:
        return gen[image](size)
    except KeyError:
        raise ValueError(f"unknown image {image!r}; available: {sorted(gen)}") from None


def bench_host_entropy(size: int, cfg: Optional[CodecConfig] = None, reps: int = 3,
                       image: str = "photo") -> list:
    """Every .tdc codec's encode and decode, best of ``reps`` on the host
    clock, over the quantized coefficient map of a deterministic test image
    computed on the host (``_host_dct_quant``): the serializer alone, no
    device.  Each decode is held bit-exact before its times are reported."""
    from tpudct_torch.utils import serialize
    from tpudct_torch.utils.entropy import native_entropy_available, rans_available

    cfg = cfg or CodecConfig()
    if size % 8:
        raise ValueError(f"--size must be a multiple of 8, got {size}")
    img = _test_image(image, size)
    c = np.ascontiguousarray(
        _host_dct_quant(img, cfg).transpose(0, 2, 1, 3).reshape(size, size)
    ).astype(np.int16)
    codecs = ["spectral", "raw", "auto", "auto-exact", "banded"]
    if serialize.lzma is not None:  # a Python without liblzma: no xz
        codecs.insert(1, "xz")
    if native_entropy_available():
        codecs.insert(0, "huffman")
    if rans_available():
        codecs.insert(0, "rans")
    rows = []
    for codec in codecs:
        enc = dec = None
        blob = None
        for _ in range(reps):
            t0 = time.perf_counter()
            blob = serialize.coefficients_to_bytes(
                c, cfg.q_scale, cfg.retain_k, codec=codec, transform=cfg.transform, q_table=cfg.q_table,
            )
            dt = (time.perf_counter() - t0) * 1e3
            enc = dt if enc is None else min(enc, dt)
        for _ in range(reps):
            t0 = time.perf_counter()
            back = serialize.bytes_to_coefficients(blob)[0]
            dt = (time.perf_counter() - t0) * 1e3
            dec = dt if dec is None else min(dec, dt)
        if not np.array_equal(np.asarray(back, np.int16), c):
            raise AssertionError(f"codec {codec} round-trip not bit-exact")
        mb = c.nbytes / 1e6
        rows.append({
            "codec": codec, "size": size, "image": image,
            "bytes": len(blob), "factor": round(c.nbytes / len(blob), 2),
            "encode_ms": round(enc, 2), "decode_ms": round(dec, 2),
            "encode_MBps": round(mb / (enc / 1e3), 1),
            "decode_MBps": round(mb / (dec / 1e3), 1),
        })
    return rows


def bench_e2e_encode(size: int = 8192, cfg: Optional[CodecConfig] = None, image: str = "photo",
                     entropy: str = "auto", quality: int = 95, device=None) -> dict:
    """One image from a JPEG file to ``.tdc`` bytes on disk, each phase on
    the host clock: JPEG load, the device encode (a host wall: the upload,
    the kernel and the copy of the coefficients back), the host entropy
    stage, the file write (fsynced).  The input JPEG is made from the named
    generator at ``quality`` first (not timed)."""
    import os
    import tempfile

    from tpudct_torch.models.dispatch import encode_gray_auto
    from tpudct_torch.utils import imageio, serialize

    cfg = cfg or CodecConfig()
    dev = default_device(device)
    arr = _test_image(image, size).astype(np.uint8)
    p = get_pipeline("hp")
    fd, jpath = tempfile.mkstemp(suffix=".jpg")
    os.close(fd)
    fd, tpath = tempfile.mkstemp(suffix=".tdc")
    os.close(fd)
    try:
        imageio.save_image(jpath, arr, quality=quality)
        t0 = time.perf_counter()
        img = imageio.load_image(jpath)
        t_load = time.perf_counter() - t0

        t0 = time.perf_counter()
        c, (h, w) = encode_gray_auto(p, img, cfg, device=dev)
        c = c.cpu().numpy()  # the copy back is part of the phase
        t_dev = time.perf_counter() - t0

        t0 = time.perf_counter()
        blob = serialize.coefficients_to_bytes(
            c, cfg.q_scale, cfg.retain_k, orig_shape=(h, w), transform=cfg.transform,
            codec=entropy, q_table=cfg.q_table,
        )
        t_ent = time.perf_counter() - t0

        t0 = time.perf_counter()
        with open(tpath, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        t_write = time.perf_counter() - t0
        chosen = serialize.inspect_stream(blob)["codec"]
    finally:
        os.remove(jpath)
        os.remove(tpath)
    total = t_load + t_dev + t_ent + t_write
    return {
        "bench": "e2e-encode", "size": size, "image": image,
        "entropy": entropy, "chosen_codec": chosen, "bytes": len(blob),
        "load_s": round(t_load, 3), "device_wall_s": round(t_dev, 3),
        "entropy_s": round(t_ent, 3), "write_s": round(t_write, 3),
        "total_s": round(total, 3),
        "backend": _backend(dev),
    }


def bench_e2e_batch(n_images: int = 32, size: int = 1024, cfg: Optional[CodecConfig] = None,
                    entropy: str = "auto", quality: int = 95, device=None) -> dict:
    """Bulk encode as a user runs it: ``n_images`` JPEGs through the port's
    own ``batch`` verb (stacked device launches, threaded host entropy),
    its host wall, and the histogram of the entropy stages ``auto`` chose
    in the files it wrote.  The input JPEGs are made first (not timed)."""
    import collections
    import os
    import tempfile

    from tpudct_torch.cli import main as cli_main
    from tpudct_torch.utils import imageio, serialize

    cfg = cfg or CodecConfig()
    dev = default_device(device)
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in")
        dst = os.path.join(td, "out")
        os.mkdir(src)
        for i in range(n_images):
            imageio.save_image(
                os.path.join(src, f"im{i:04d}.jpg"),
                photographic_image(size, seed=i).astype(np.uint8), quality=quality,
            )
        args = ["batch", src, dst, "--entropy", entropy, "--device", str(dev)]
        if cfg.q_scale != 1.0:
            args += ["--q-scale", str(cfg.q_scale)]
        t0 = time.perf_counter()
        rc = cli_main(args)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"batch exited {rc}")
        hist: collections.Counter = collections.Counter()
        total_bytes = 0
        for name in os.listdir(dst):
            if not name.endswith(".tdc"):
                continue
            with open(os.path.join(dst, name), "rb") as f:
                data = f.read()
            hist[serialize.inspect_stream(data)["codec"]] += 1
            total_bytes += len(data)
    return {
        "bench": "e2e-batch", "images": n_images, "size": size,
        "entropy": entropy, "wall_s": round(wall, 3),
        "images_per_s": round(n_images / wall, 2),
        "bytes_total": total_bytes, "codec_histogram": dict(hist),
        "backend": _backend(dev),
    }


def sweep(sizes: Iterable[int] = (256, 512, 1024, 2048, 4096, 8192),
          pipelines: Iterable[str] = ("batched", "fast", "hp"), cfg: Optional[CodecConfig] = None,
          **kw) -> list:
    """The original codec's benchmark table (README.md:45-60): every
    pipeline at every size."""
    return [bench_pipeline(n, s, cfg, **kw) for s in sizes for n in pipelines]


def accuracy_table(image: np.ndarray, pipeline: str = "hp", ks=(6, 7, 8, 9, 10, None),
                   cfg_base: Optional[CodecConfig] = None, device=None) -> list:
    """The original codec's accuracy table (README.md:62-69): PEEN, MSE and
    the compression factors of ``utils.metrics.quality_report`` over the
    retained-coefficient sweep (``retain_k`` over ``cfg_base``), each row
    one ``p.roundtrip`` of the edge-padded f32 image on the device."""
    import dataclasses

    from tpudct_torch.ops.padding import crop, pad_to_blocks
    from tpudct_torch.utils.metrics import quality_report

    cfg_base = cfg_base or CodecConfig()
    p = get_pipeline(pipeline)
    dev = default_device(device)
    x, (h, w) = pad_to_blocks(torch.as_tensor(np.asarray(image, np.float32), device=dev))
    rows = []
    for k in ks:
        cfg = dataclasses.replace(cfg_base, retain_k=k)
        c, rec = p.roundtrip(x, cfg)
        rep = quality_report(np.asarray(image).astype(np.uint8), crop(rec, h, w).cpu().numpy(),
                             c.cpu().numpy(), device=dev)
        rep["k"] = "std" if k is None else k
        rows.append(rep)
    return rows


def accuracy_table_color(rgb: np.ndarray, pipeline: str = "hp", ks=(6, 7, 8, 9, 10, None),
                         cfg_base: Optional[CodecConfig] = None, subsample=True, device=None) -> list:
    """The color accuracy table: RGB MSE and PSNR and the ``.tdcc``
    compression factor (zlib of the raw RGB over the file's bytes) over the
    retained-coefficient sweep, on the f32 color path
    (``encode_color``/``decode_color``), as in the reference."""
    import dataclasses
    import zlib

    from tpudct_torch.models.color import decode_color, encode_color
    from tpudct_torch.utils.serialize import color_to_bytes

    cfg_base = cfg_base or CodecConfig()
    p = get_pipeline(pipeline)
    dev = default_device(device)
    x = torch.as_tensor(np.asarray(rgb, np.float32), device=dev)
    raw = len(zlib.compress(np.ascontiguousarray(rgb, np.uint8).tobytes(), 6))
    rows = []
    for k in ks:
        cfg = dataclasses.replace(cfg_base, retain_k=k)
        planes, meta = encode_color(p, x, cfg, subsample=subsample)
        rec = decode_color(p, planes, meta, cfg).cpu().numpy()
        mse = float(((rec.astype(np.float64) - np.asarray(rgb, np.float64)) ** 2).mean())
        blob = color_to_bytes(
            {n: v.cpu().numpy() for n, v in planes.items()}, meta,
            cfg.q_scale, cfg.retain_k, cfg.transform,
        )
        rows.append({
            "mse": mse,
            # the perfect-reconstruction cap: inf is not valid JSON
            "psnr_db": 10 * np.log10(255.0**2 / max(mse, 1e-30)),
            "compression_factor": raw / len(blob),
            "k": "std" if k is None else k,
        })
    return rows


def rate_distortion_curve(image: np.ndarray, pipeline: str = "hp",
                          qualities=(10, 20, 30, 40, 50, 60, 70, 80, 90, 95),
                          cfg_base: Optional[CodecConfig] = None, codec: str = "auto",
                          device=None) -> list:
    """Rate against distortion per IJG quality: the ``.tdc`` file's bytes
    and PSNR (``p.roundtrip`` at ``q_scale_for_quality(q)``) beside
    libjpeg's file and PSNR at the same quality setting."""
    import dataclasses

    from tpudct_torch.ops.padding import crop, pad_to_blocks
    from tpudct_torch.ops.quant import q_scale_for_quality
    from tpudct_torch.utils.imageio import encode_jpeg_bytes
    from tpudct_torch.utils.serialize import coefficients_to_bytes

    cfg_base = cfg_base or CodecConfig()
    p = get_pipeline(pipeline)
    dev = default_device(device)
    img8 = np.array(image, np.uint8)  # writable: a .npy input is a read-only memory map
    x, (h, w) = pad_to_blocks(torch.as_tensor(img8, device=dev).to(torch.float32))
    rows = []
    for q in qualities:
        cfg = dataclasses.replace(cfg_base, q_scale=q_scale_for_quality(q))
        c, rec = p.roundtrip(x, cfg)
        rec8 = crop(rec, h, w).cpu().numpy().astype(np.float64)
        mse = float(((rec8 - img8) ** 2).mean())
        blob = coefficients_to_bytes(
            c.cpu().numpy(), cfg.q_scale, cfg.retain_k, orig_shape=(h, w),
            transform=cfg.transform, codec=codec, q_table=cfg.q_table,
        )
        jpg = encode_jpeg_bytes(img8, quality=int(q))
        jmse = float(((_pil_decode(jpg).astype(np.float64) - img8) ** 2).mean())
        rows.append({
            "quality": int(q),
            "tdc_bytes": len(blob),
            "tdc_psnr_db": 10 * np.log10(255.0**2 / max(mse, 1e-9)),
            "jpeg_bytes": len(jpg),
            "jpeg_psnr_db": 10 * np.log10(255.0**2 / max(jmse, 1e-9)),
        })
    return rows


def rate_distortion_curve_color(rgb: np.ndarray, pipeline: str = "hp",
                                qualities=(10, 20, 30, 40, 50, 60, 70, 80, 90, 95),
                                cfg_base: Optional[CodecConfig] = None, codec: str = "auto",
                                subsample="420", device=None) -> list:
    """The color rate-distortion curve: the ``.tdcc`` file's bytes and RGB
    PSNR per IJG quality (``roundtrip_color_auto``: the u8 path where the
    quality's q_scale is int8-safe, the f32 path below) beside libjpeg's
    color file (YCbCr, 4:2:0) at the same quality setting."""
    import dataclasses

    from tpudct_torch.models.color import roundtrip_color_auto
    from tpudct_torch.ops.quant import q_scale_for_quality
    from tpudct_torch.utils.imageio import encode_jpeg_bytes
    from tpudct_torch.utils.serialize import color_to_bytes

    cfg_base = cfg_base or CodecConfig()
    p = get_pipeline(pipeline)
    dev = default_device(device)
    img8 = np.array(rgb, np.uint8)
    if img8.ndim != 3 or img8.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) RGB image, got {img8.shape}")
    rows = []
    for q in qualities:
        cfg = dataclasses.replace(cfg_base, q_scale=q_scale_for_quality(q))
        planes, meta, rec = roundtrip_color_auto(p, img8, cfg, subsample=subsample, device=dev)
        mse = float(((rec.cpu().numpy().astype(np.float64) - img8) ** 2).mean())
        blob = color_to_bytes(
            {k: v.cpu().numpy() for k, v in planes.items()}, meta,
            cfg.q_scale, cfg.retain_k, cfg.transform, codec=codec,
        )
        jpg = encode_jpeg_bytes(img8, quality=int(q))
        jmse = float(((_pil_decode_rgb(jpg).astype(np.float64) - img8) ** 2).mean())
        rows.append({
            "quality": int(q),
            "tdc_bytes": len(blob),
            "tdc_psnr_db": 10 * np.log10(255.0**2 / max(mse, 1e-9)),
            "jpeg_bytes": len(jpg),
            "jpeg_psnr_db": 10 * np.log10(255.0**2 / max(jmse, 1e-9)),
            "color": True,
        })
    return rows


def _pil_decode(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("L"))


def _pil_decode_rgb(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def bd_rate_pct(anchor, test) -> float:
    """Bjøntegaard delta rate (VCEG-M33): the average rate difference of
    ``test`` against ``anchor`` at equal quality over their overlapping PSNR
    range (a cubic fit of log-rate against PSNR); negative = ``test`` needs
    fewer bytes.  Each curve: >= 4 (bytes, psnr_db) points."""
    a = np.asarray(sorted(anchor, key=lambda p: p[1]), np.float64)
    t = np.asarray(sorted(test, key=lambda p: p[1]), np.float64)
    if len(a) < 4 or len(t) < 4:
        raise ValueError("BD-rate needs >= 4 rate-distortion points per curve")
    if (np.diff(a[:, 1]) <= 0).any() or (np.diff(t[:, 1]) <= 0).any():
        raise ValueError("BD-rate needs strictly increasing PSNR per curve")
    pa = np.polyfit(a[:, 1], np.log10(a[:, 0]), 3)
    pt = np.polyfit(t[:, 1], np.log10(t[:, 0]), 3)
    lo = max(a[0, 1], t[0, 1])
    hi = min(a[-1, 1], t[-1, 1])
    if hi <= lo:
        raise ValueError("curves share no PSNR overlap")
    ia, it = np.polyint(pa), np.polyint(pt)
    mean_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    mean_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float((10.0 ** (mean_t - mean_a) - 1.0) * 100.0)


def bd_psnr_db(anchor, test) -> float:
    """Bjøntegaard delta PSNR: the average PSNR gain of ``test`` over
    ``anchor`` at equal rate (a cubic fit of PSNR against log-rate over the
    overlapping range); positive = ``test`` is better at the same bytes."""
    a = np.asarray(sorted(anchor, key=lambda p: p[0]), np.float64)
    t = np.asarray(sorted(test, key=lambda p: p[0]), np.float64)
    if len(a) < 4 or len(t) < 4:
        raise ValueError("BD-PSNR needs >= 4 rate-distortion points per curve")
    la, lt = np.log10(a[:, 0]), np.log10(t[:, 0])
    if (np.diff(la) <= 0).any() or (np.diff(lt) <= 0).any():
        raise ValueError("BD-PSNR needs strictly increasing rate per curve")
    pa = np.polyfit(la, a[:, 1], 3)
    pt = np.polyfit(lt, t[:, 1], 3)
    lo, hi = max(la[0], lt[0]), min(la[-1], lt[-1])
    if hi <= lo:
        raise ValueError("curves share no rate overlap")
    ia, it = np.polyint(pa), np.polyint(pt)
    mean_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    mean_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float(mean_t - mean_a)


def bd_summary(rows) -> dict:
    """BD-rate and BD-PSNR of the .tdc curve against the libjpeg curve of
    rate-distortion rows (``tdc_bytes``, ``tdc_psnr_db``, ``jpeg_bytes``,
    ``jpeg_psnr_db``)."""
    tdc = [(r["tdc_bytes"], r["tdc_psnr_db"]) for r in rows]
    jpg = [(r["jpeg_bytes"], r["jpeg_psnr_db"]) for r in rows]
    return {
        "bd_rate_pct_vs_libjpeg": round(bd_rate_pct(jpg, tdc), 2),
        "bd_psnr_db_vs_libjpeg": round(bd_psnr_db(jpg, tdc), 3),
        "points": len(rows),
    }
