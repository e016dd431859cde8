#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpudct_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hp CUDA kernels from ``tpudct_torch/csrc`` and, in order:

  1. prints the card (name, power limit), the torch version and nvcc's;
  2. builds the kernels and prints nvcc's register/stack/spill lines;
  3. turns TF32 off and prints both flags;
  4. holds each kernel against its plain torch twin at 512^2 and 8192^2,
     q_scale 1 and 2.5, retain_k None and 6, at the padded 4000x3072
     frame, the 32768x1024 batch and an off-grid 40x136 (coefficients bit-identical;
     reconstructions within +-1 on at most 1e-4 of pixels, the count printed);
  5. runs the float64 golden-model correctness gate at 512^2 (u8 path with
     the encode/decode/roundtrip bit-identity check, and the f32 path);
  6. drives the main path through the library's entry points with the
     default CodecConfig — 8192^2 and a 4000x2992 frame through
     roundtrip_gray_auto, 8192^2 through encode_gray_auto/decode_gray_auto,
     a 32 x 1024^2 batch as one tall image through roundtrip_u8, and an f32
     8192^2 image through get_pipeline("hp").roundtrip — and checks that each
     step launched its kernel and that its output agrees with the golden
     model on a band of whole blocks;
  7. times each kernel against its twin with CUDA events (L2 flushed before
     every repetition; order plain, kernel, kernel, plain).

Any failure ends the run with a non-zero exit.  The second-to-last line is
a JSON summary of the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script raises before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# kernel -> (CUDA source, the TPU kernel it replaces, bytes moved per pixel)
KERNELS = {
    "hp_roundtrip_u8": ("tpudct_torch/csrc/hp_codec.cu", "tpudct/kernels/hp_pallas.py:678", 3),
    "hp_encode_u8": ("tpudct_torch/csrc/hp_codec.cu", "tpudct/kernels/hp_pallas.py:627", 2),
    "hp_decode_u8": ("tpudct_torch/csrc/hp_codec.cu", "tpudct/kernels/hp_pallas.py:651", 2),
    "hp_roundtrip": ("tpudct_torch/csrc/hp_codec.cu", "tpudct/kernels/hp_pallas.py:576", 12),
}
HBM_PEAK_BPS = 3.35e12  # H100 SXM data sheet
RECON_DIFF_SHARE = 1e-4  # kernel vs twin: +-1 on at most this share of pixels
# Main-path shapes: the largest square image, a camera frame, a serving
# batch (images x side) folded into one tall image.
SQUARE, FRAME, BATCH = 8192, (4000, 2992), (32, 1024)
COMPARE_SIZES = (512, SQUARE)


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _phase(n: int, title: str) -> None:
    print(f"== phase {n}: {title}", flush=True)


def phase_card() -> str:
    from tpudct_torch.kernels._build import nvcc_path

    _phase(1, "card")
    card = _card()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    return card


def phase_build() -> None:
    from tpudct_torch.kernels import _build

    _phase(2, "build")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"library {lib.name} ready in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill", "stack frame")):
            print("  ptxas:", line.strip().removeprefix("ptxas info    :").strip())


def phase_tf32() -> None:
    _phase(3, "TF32 off")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("matmul.allow_tf32 =", torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32 =", torch.backends.cudnn.allow_tf32)


def _noise(h: int, w: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 256, size=(h, w), dtype=np.uint8), device=dev)


def _camera_frame(h: int, w: int, seed: int) -> np.ndarray:
    """A photo-like u8 frame: smooth gradients and waves, edges, sensor noise."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = 90 + 80 * x * y + 40 * np.sin(9 * x + 4 * y) * np.cos(7 * y)
    img = img + 50 * ((x - 0.6) ** 2 + (y - 0.4) ** 2 < 0.04)
    img = img + rng.normal(0.0, 4.0, size=(h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cmp(name, kernel_out, plain_out, recon: bool) -> tuple:
    """(max abs error, differing count) of a kernel output against its twin;
    coefficients must be bit-identical, reconstructions within +-1 on at
    most RECON_DIFF_SHARE of pixels."""
    diff = (kernel_out.to(torch.float64) - plain_out.to(torch.float64)).abs()
    err, n = float(diff.max()), int((diff > 0).sum())
    if not recon and n:
        _fail(f"{name}: {n} coefficients differ from the plain twin (max {err})")
    if recon and (err > 1.0 or n > RECON_DIFF_SHARE * diff.numel()):
        _fail(f"{name}: reconstruction differs from the plain twin on {n} pixels (max {err})")
    return err, n


def phase_compare(dev) -> dict:
    from tpudct_torch.kernels import hp

    _phase(4, "kernels against their plain twins")
    errs = {k: 0.0 for k in KERNELS}
    # the sweep, then the other shapes the main path hands the kernels (the
    # camera frame padded to the dispatch grid, the folded batch), and one
    # 8-aligned shape off that grid, which the kernels take as well
    shapes = [(s, s) for s in COMPARE_SIZES]
    cases = [(hw, qs, rk, "butterfly") for hw in shapes for qs in (1.0, 2.5) for rk in (None, 6)]
    cases += [(shapes[0], qs, None, "highest") for qs in (1.0, 2.5)]
    frame = (FRAME[0] + (-FRAME[0]) % 32, FRAME[1] + (-FRAME[1]) % 128)
    cases += [(hw, 1.0, None, "butterfly") for hw in (frame, (BATCH[0] * BATCH[1], BATCH[1]), (40, 136))]
    for (h, w), qs, rk, prec in cases:
        x = _noise(h, w, seed=h + w + int(10 * qs), dev=dev)
        kw = dict(q_scale=qs, retain_k=rk, decode_precision=prec)
        tag = f"{h}x{w} q_scale={qs} retain_k={rk} {prec}"
        c, r = hp.hp_roundtrip_u8(x, **kw)
        pc, pr = hp.roundtrip_u8_plain(x, **kw)
        e1, _ = _cmp("hp_roundtrip_u8 coeffs", c, pc, recon=False)
        e2, n_rt = _cmp("hp_roundtrip_u8 recon", r, pr, recon=True)
        ce = hp.hp_encode_u8(x, q_scale=qs, retain_k=rk)
        e3, _ = _cmp("hp_encode_u8", ce, hp.encode_u8_plain(x, q_scale=qs, retain_k=rk), recon=False)
        rd = hp.hp_decode_u8(ce, q_scale=qs, decode_precision=prec)
        e4, n_dec = _cmp("hp_decode_u8", rd, hp.decode_u8_plain(ce, q_scale=qs, decode_precision=prec),
                         recon=True)
        xf = x.to(torch.float32)
        cf, rf = hp.hp_roundtrip(xf, **kw)
        pcf, prf = hp.roundtrip_plain(xf, **kw)
        e5, _ = _cmp("hp_roundtrip coeffs", cf, pcf, recon=False)
        e6, n_f32 = _cmp("hp_roundtrip recon", rf.trunc(), prf.trunc(), recon=True)
        e6 = max(e6, float((rf - prf).abs().max()))
        errs["hp_roundtrip_u8"] = max(errs["hp_roundtrip_u8"], e1, e2)
        errs["hp_encode_u8"] = max(errs["hp_encode_u8"], e3)
        errs["hp_decode_u8"] = max(errs["hp_decode_u8"], e4)
        errs["hp_roundtrip"] = max(errs["hp_roundtrip"], e5, e6)
        print(f"  {tag}: coeffs bit-identical; recon pixels differing: roundtrip_u8 {n_rt}, "
              f"decode_u8 {n_dec}, roundtrip f32 (truncated) {n_f32}")
    torch.cuda.synchronize()
    return errs


def phase_gate(dev) -> None:
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.selftest import correctness_gate

    _phase(5, "golden-model correctness gate at 512^2")
    p = get_pipeline("hp")
    print("  u8 :", json.dumps(correctness_gate(p, CodecConfig(), 512, device=dev)))
    print("  f32:", json.dumps(correctness_gate(p, CodecConfig(), 512, force_f32=True, device=dev)))


def _mse(r, img: np.ndarray) -> float:
    r = r.cpu().numpy() if isinstance(r, torch.Tensor) else r
    return float(((r.astype(np.float64) - img) ** 2).mean())


def _band_check(label: str, img: np.ndarray, c, r, rows: int = 256) -> None:
    """Golden-model check on the first `rows` rows (whole blocks, so the
    band's codec is independent of the rest), and the full image's MSE."""
    from tpudct_torch import CodecConfig
    from tpudct_torch.selftest import check_against_golden

    c_np = c.cpu().numpy() if isinstance(c, torch.Tensor) else c
    r_np = r.cpu().numpy() if isinstance(r, torch.Tensor) else r
    rows, cols = min(rows, img.shape[0] // 8 * 8), img.shape[1] // 8 * 8
    if not np.isfinite(c_np.astype(np.float32)).all():
        _fail(f"{label}: non-finite coefficients")
    rep = check_against_golden(img[:rows, :cols].astype(np.float32), c_np[:rows, :cols],
                               r_np[:rows, :cols], CodecConfig())
    print(f"  {label}: shape {tuple(r_np.shape)} {r_np.dtype}, MSE {_mse(r_np, img):.4f}; "
          f"golden band of {rows} rows: {rep['coeff_ties']} ties, MSE {rep['mse']:.4f} "
          f"vs golden {rep['golden_mse']:.4f}")


def phase_main_path(dev) -> dict:
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.kernels import hp
    from tpudct_torch.models.dispatch import decode_gray_auto, encode_gray_auto, roundtrip_gray_auto

    _phase(6, "main path")
    cfg, p = CodecConfig(), get_pipeline("hp")

    def step(label, kernel, fn):
        before = dict(hp.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved = hp.LAUNCHES[kernel] - before[kernel]
        if moved < 1:
            _fail(f"{label}: kernel {kernel} was not launched")
        print(f"  {label}: {kernel} launched {moved}x, {dt * 1e3:.1f} ms host wall (first call)")
        return out

    sq, (n_img, side) = f"{SQUARE}^2", BATCH
    img = np.random.default_rng(42).integers(0, 256, size=(SQUARE, SQUARE), dtype=np.uint8)
    frame = _camera_frame(*FRAME, seed=7)
    batch = np.random.default_rng(43).integers(0, 256, size=(n_img * side, side), dtype=np.uint8)
    x8k = torch.as_tensor(img, device=dev)
    xcam = torch.as_tensor(frame, device=dev)
    xbat = torch.as_tensor(batch, device=dev)
    xf32 = x8k.to(torch.float32)
    torch.cuda.synchronize()

    hp.reset_launches()
    c, r = step(f"{sq} roundtrip_gray_auto", "hp_roundtrip_u8", lambda: roundtrip_gray_auto(p, x8k, cfg))
    _band_check(f"{sq} roundtrip_gray_auto", img, c, r)
    fr = "x".join(map(str, FRAME))
    cc, rc = step(f"{fr} roundtrip_gray_auto", "hp_roundtrip_u8", lambda: roundtrip_gray_auto(p, xcam, cfg))
    _band_check(f"{fr} roundtrip_gray_auto", frame, cc, rc)
    ce, shape = step(f"{sq} encode_gray_auto", "hp_encode_u8", lambda: encode_gray_auto(p, x8k, cfg))
    rd = step(f"{sq} decode_gray_auto", "hp_decode_u8", lambda: decode_gray_auto(p, ce, cfg, shape))
    if not torch.equal(ce, c) or not np.array_equal(rd, r):
        _fail(f"{sq} encode_gray_auto/decode_gray_auto disagree with roundtrip_gray_auto")
    print(f"  {sq} encode + decode bit-identical to the fused roundtrip; decode MSE {_mse(rd, img):.4f}")
    bt = f"{n_img}x{side}^2 batch roundtrip_u8"
    cb, rb = step(bt, "hp_roundtrip_u8", lambda: p.roundtrip_u8(xbat, cfg))
    _band_check(bt, batch, cb, rb, rows=side)
    cf, rf = step(f"{sq} f32 hp.roundtrip", "hp_roundtrip", lambda: p.roundtrip(xf32, cfg))
    if not torch.equal(cf.to(torch.int8), c) or not np.array_equal(rf.cpu().numpy(), r):
        _fail(f"{sq} f32 roundtrip disagrees with the u8 roundtrip")
    print(f"  {sq} f32 roundtrip bit-identical to the u8 roundtrip; MSE {_mse(rf, img):.4f}")
    launches = dict(hp.LAUNCHES)
    for name in KERNELS:
        if launches[name] < 1:
            _fail(f"main path never launched {name}")
    print("  launches:", json.dumps(launches))
    return launches


def _time(fn, flush: torch.Tensor, reps: int) -> float:
    """Mean device ms per call; L2 flushed (and the flush left out of the
    timed span) before every call."""
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_timing(dev, card: str) -> dict:
    from tpudct_torch.kernels import hp

    _phase(7, f"timing ({card})")
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device=dev)
    times = {}
    (n_img, side) = BATCH
    for label, (h, w) in ((f"{SQUARE}^2", (SQUARE, SQUARE)), (f"{n_img}x{side}^2", (n_img * side, side))):
        x = _noise(h, w, seed=5, dev=dev)
        xf = x.to(torch.float32)
        ci8 = hp.hp_encode_u8(x)
        fns = {
            "hp_roundtrip_u8": (lambda: hp.hp_roundtrip_u8(x), lambda: hp.roundtrip_u8_plain(x)),
            "hp_encode_u8": (lambda: hp.hp_encode_u8(x), lambda: hp.encode_u8_plain(x)),
            "hp_decode_u8": (lambda: hp.hp_decode_u8(ci8), lambda: hp.decode_u8_plain(ci8)),
            "hp_roundtrip": (lambda: hp.hp_roundtrip(xf), lambda: hp.roundtrip_plain(xf)),
        }
        for name, (kern, plain) in fns.items():
            kern(), plain()  # warm up
            p1 = _time(plain, flush, 3)
            k1 = _time(kern, flush, 20)
            k2 = _time(kern, flush, 20)
            p2 = _time(plain, flush, 3)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            gbps = KERNELS[name][2] * h * w / (ms * 1e-3) / 1e9
            times[(name, label)] = (ms, plain_ms)
            print(f"  {label} {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; "
                  f"kernel {gbps:.1f} GB/s = {gbps * 1e9 / HBM_PEAK_BPS:.1%} of 3.35 TB/s "
                  f"[{card}]")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    import tpudct_torch  # noqa: F401  (fails here outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    phase_tf32()
    errs = phase_compare(dev)
    phase_gate(dev)
    launches = phase_main_path(dev)
    times = phase_timing(dev, card)
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": times[(name, f"{SQUARE}^2")][0], "plain_ms": times[(name, f"{SQUARE}^2")][1],
        }
        for name, (src, replaces, _) in KERNELS.items()
    ]
    print(_card())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
