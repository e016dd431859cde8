#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpudct_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hp CUDA kernels (B1-B7) from ``tpudct_torch/csrc`` and, in order:

  1. prints the card (name, power limit), the torch version and nvcc's;
  2. builds the kernels and prints nvcc's register/stack/spill lines;
  3. turns TF32 off and prints both flags;
  4. holds each kernel against its plain torch twin at 512^2 and 8192^2,
     q_scale 1 and 2.5, retain_k None and 6 (where the kernel takes it),
     every decode tier, both forward cores and the scaled decode at
     fr = fc in {2, 4, 8} and (2, 4), both output types; the u8 kernels also
     at the padded 4000x3072 frame, the 32768x1024 batch and an off-grid
     40x136, the f32-literal roundtrip ("dct", highest) at the frame and
     the scaled decode at the batch, as the main path runs them
     (coefficients and f32 outputs bit-identical; u8 reconstructions within
     +-1 on at most 1e-4 of pixels, the count printed; the scaled decode
     also equal to box_pool_u8(hp_decode_u8)); and checks that TF32 does
     not reach the plain contractions;
  5. runs the float64 golden-model correctness gate at 512^2 (u8 path with
     the encode/decode/roundtrip bit-identity check, the f32 path, and the
     f32-literal core under transform "dct") and the f32 and scaled family
     gates at 256^2;
  6. drives the main path through the library's entry points — with the
     default CodecConfig 8192^2 and a 4000x2992 frame through
     roundtrip_gray_auto, 8192^2 through encode_gray_auto/decode_gray_auto,
     a 32 x 1024^2 batch as one tall image through roundtrip_u8, an f32
     8192^2 image through get_pipeline("hp").roundtrip; then 8192^2
     encode/decode at q_scale 0.5 (hp_dct, hp_idct), the frame under
     transform "dct" and 8192^2 with exact_int_core=False (the f32-literal
     roundtrip), the "high" decode, the scaled decode at m = 4, 2, 1 and 6,
     the stacked scaled decode of the batch, and entry() — and checks that
     each step launched its kernel and that its output agrees with the
     golden model (under the step's config) on a band of whole blocks;
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

_SRC, _REF = "tpudct_torch/csrc/hp_codec.cu", "tpudct/kernels/hp_pallas.py"
# kernel -> (CUDA source, the TPU kernel it replaces, bytes moved per pixel)
KERNELS = {
    "hp_roundtrip_u8": (_SRC, f"{_REF}:678", 3),
    "hp_encode_u8": (_SRC, f"{_REF}:627", 2),
    "hp_decode_u8": (_SRC, f"{_REF}:651", 2),
    "hp_roundtrip": (_SRC, f"{_REF}:576", 12),
    "hp_roundtrip_f32core": (_SRC, f"{_REF}:445", 12),  # hp_roundtrip's _k_rt_f32_bf
    "hp_dct": (_SRC, f"{_REF}:519", 8),
    "hp_idct": (_SRC, f"{_REF}:550", 8),
    "hp_scaled_decode_u8": (_SRC, f"{_REF}:824", 1 + 1 / 4),  # timed at fr = fc = 2, out_u8
}
SCALED_FACTORS = ((2, 2), (4, 4), (8, 8), (2, 4))
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
    # the "high" tier runs the "highest" body
    x = _noise(*shapes[0], seed=3, dev=dev)
    ch, rh = hp.hp_roundtrip_u8(x, decode_precision="high")
    if not torch.equal(rh, hp.hp_roundtrip_u8(x, decode_precision="highest")[1]) or not torch.equal(
            hp.hp_decode_u8(ch, decode_precision="high"), rh):
        _fail("the high tier differs from the highest tier")
    print(f"  {shapes[0][0]}^2 high: roundtrip_u8 and decode_u8 equal the highest tier")
    for (h, w) in shapes:
        for qs in (1.0, 2.5):
            _compare_f32_kernels(hp, h, w, qs, dev, errs)
    _compare_main_shapes(hp, dev, errs)
    _check_pinned_precision(dev)
    torch.cuda.synchronize()
    return errs


def _same(name: str, kernel_out, plain_out) -> float:
    """Bit-identity (== on values, so -0.0 equals 0.0) of a kernel output
    with its twin's; returns the max abs error (0.0 once it holds)."""
    if kernel_out.shape != plain_out.shape or kernel_out.dtype != plain_out.dtype:
        _fail(f"{name}: {kernel_out.dtype}{tuple(kernel_out.shape)} vs twin "
              f"{plain_out.dtype}{tuple(plain_out.shape)}")
    if not torch.equal(kernel_out, plain_out):
        n = int((kernel_out != plain_out).sum())
        _fail(f"{name}: {n} values differ from the plain twin")
    return float((kernel_out.to(torch.float64) - plain_out.to(torch.float64)).abs().max())


def _compare_f32_kernels(hp, h: int, w: int, qs: float, dev, errs: dict) -> None:
    """B4', B5, B6 and B7 against their twins: bit-identical (each max abs
    error goes into `errs`)."""
    from tpudct_torch.ops.scaled import box_pool_u8
    from tpudct_torch.ops.transform import to_uint8

    x = _noise(h, w, seed=h + int(10 * qs) + 1, dev=dev)
    xf = x.to(torch.float32)
    # the literal core takes any f32 values: add a fractional part
    xl = xf + torch.as_tensor(np.random.default_rng(h).normal(0, 3, (h, w)).astype(np.float32), device=dev)
    for int_core, xin in ((True, xf), (False, xl)):
        e = _same(f"hp_dct int_core={int_core}", hp.hp_dct(xin, q_scale=qs, int_core=int_core),
                  hp.dct_plain(xin, q_scale=qs, int_core=int_core))
        errs["hp_dct"] = max(errs["hp_dct"], e)
    c = hp.hp_dct(xf, q_scale=qs)
    for tier in ("butterfly", "highest", "high"):
        e = _same(f"hp_idct {tier}", hp.hp_idct(c, q_scale=qs, decode_precision=tier),
                  hp.idct_plain(c, q_scale=qs, decode_precision=tier))
        errs["hp_idct"] = max(errs["hp_idct"], e)
    for transform, tier in (("haweel", "butterfly"), ("haweel", "highest"), ("dct", "highest")):
        for rk in (None, 6):
            kw = dict(q_scale=qs, retain_k=rk, decode_precision=tier, transform=transform, int_core=False)
            out, plain = hp.hp_roundtrip(xl, **kw), hp.roundtrip_plain(xl, **kw)
            for name, a, b in zip(("coeffs", "recon"), out, plain):
                e = _same(f"hp_roundtrip f32core {transform} {tier} retain_k={rk} {name}", a, b)
                errs["hp_roundtrip_f32core"] = max(errs["hp_roundtrip_f32core"], e)
    c8 = hp.hp_encode_u8(x, q_scale=qs)
    dec = hp.hp_decode_u8(c8, q_scale=qs)
    for fr, fc in SCALED_FACTORS:
        for out_u8 in (False, True):
            s = hp.hp_scaled_decode_u8(c8, fr, fc, q_scale=qs, out_u8=out_u8)
            e = _same(f"hp_scaled_decode_u8 ({fr}, {fc}) out_u8={out_u8}", s,
                      hp.scaled_decode_u8_plain(c8, fr, fc, q_scale=qs, out_u8=out_u8))
            errs["hp_scaled_decode_u8"] = max(errs["hp_scaled_decode_u8"], e)
            pooled = box_pool_u8(dec, fr, fc)
            _same(f"hp_scaled_decode_u8 ({fr}, {fc}) out_u8={out_u8} vs box_pool_u8(hp_decode_u8)",
                  s, to_uint8(pooled) if out_u8 else pooled)
    print(f"  {h}x{w} q_scale={qs}: hp_dct (both cores), hp_idct (3 tiers), f32-literal roundtrip "
          f"(haweel butterfly/highest, dct highest; retain_k None, 6) and hp_scaled_decode_u8 at "
          f"{list(SCALED_FACTORS)} (f32, u8) bit-identical to their twins; scaled decode equals "
          "box_pool_u8(hp_decode_u8)")


def _compare_main_shapes(hp, dev, errs: dict) -> None:
    """The new kernels at the other shapes the main path hands them: the
    f32-literal roundtrip (transform "dct", highest inverse) on the camera
    frame padded to the f32 grid, and the scaled decode on the folded batch."""
    from tpudct_torch.ops.padding import pad_to_kernel
    from tpudct_torch.ops.scaled import box_pool_u8
    from tpudct_torch.ops.transform import to_uint8

    cam = torch.as_tensor(_camera_frame(*FRAME, seed=7), device=dev).to(torch.float32)
    xcam, _ = pad_to_kernel(cam, 8)
    fh, fw = xcam.shape
    xl = _noise(fh, fw, seed=11, dev=dev).to(torch.float32)
    xl = xl + torch.as_tensor(np.random.default_rng(11).normal(0, 3, (fh, fw)).astype(np.float32), device=dev)
    kw = dict(transform="dct", int_core=False, decode_precision="highest")
    for label, x in (("camera frame", xcam), ("noise", xl)):
        for name, a, b in zip(("coeffs", "recon"), hp.hp_roundtrip(x, **kw), hp.roundtrip_plain(x, **kw)):
            e = _same(f"hp_roundtrip f32core {fh}x{fw} {label} dct highest {name}", a, b)
            errs["hp_roundtrip_f32core"] = max(errs["hp_roundtrip_f32core"], e)
    n_img, side = BATCH
    batch = np.random.default_rng(43).integers(0, 256, size=(n_img * side, side), dtype=np.uint8)
    c8 = hp.hp_encode_u8(torch.as_tensor(batch, device=dev))
    for out_u8 in (False, True):
        s = hp.hp_scaled_decode_u8(c8, 2, 2, out_u8=out_u8)
        e = _same(f"hp_scaled_decode_u8 {n_img * side}x{side} (2, 2) out_u8={out_u8}", s,
                  hp.scaled_decode_u8_plain(c8, 2, 2, out_u8=out_u8))
        errs["hp_scaled_decode_u8"] = max(errs["hp_scaled_decode_u8"], e)
        pooled = box_pool_u8(hp.hp_decode_u8(c8), 2, 2)
        _same(f"hp_scaled_decode_u8 {n_img * side}x{side} (2, 2) out_u8={out_u8} vs box_pool_u8(hp_decode_u8)",
              s, to_uint8(pooled) if out_u8 else pooled)
    print(f"  {fh}x{fw} (camera frame and noise) f32-literal roundtrip, dct highest, and "
          f"{n_img * side}x{side} hp_scaled_decode_u8 (2, 2) (f32, u8) bit-identical to their twins; "
          "scaled decode equals box_pool_u8(hp_decode_u8)")


def _check_pinned_precision(dev) -> None:
    """The plain contractions (the M/8 scaled decode, the blockwise
    transforms) give the same values with TF32 on as with it off."""
    from tpudct_torch import CodecConfig
    from tpudct_torch.kernels import hp
    from tpudct_torch.ops.scaled import scaled_decode_m8
    from tpudct_torch.ops.transform import dct2_blocks

    x = _noise(512, 512, seed=13, dev=dev).to(torch.float32)
    c = hp.dct_plain(x, q_scale=0.5)
    fns = {"scaled_decode_m8 m=6": lambda: scaled_decode_m8(c, CodecConfig(q_scale=0.5), 6),
           "dct2_blocks": lambda: dct2_blocks(x - 128.0)}
    off = {k: f() for k, f in fns.items()}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = {k: f() for k, f in fns.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for k in fns:
        if not torch.equal(on[k], off[k]):
            _fail(f"{k}: TF32 changes the result by {float((on[k] - off[k]).abs().max())}")
    print("  scaled_decode_m8 and dct2_blocks at 512^2: equal with TF32 on and off")


def phase_gate(dev) -> None:
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.selftest import correctness_gate, family_gates

    _phase(5, "golden-model correctness gates")
    p = get_pipeline("hp")
    print("  u8 :", json.dumps(correctness_gate(p, CodecConfig(), 512, device=dev)))
    print("  f32:", json.dumps(correctness_gate(p, CodecConfig(), 512, force_f32=True, device=dev)))
    print("  f32 dct:", json.dumps(correctness_gate(p, CodecConfig(transform="dct"), 512, device=dev)))
    for rep in family_gates(p, CodecConfig(), device=dev):
        print(f"  family {rep['family']}:", json.dumps(rep))


def _mse(r, img: np.ndarray) -> float:
    r = r.cpu().numpy() if isinstance(r, torch.Tensor) else r
    return float(((r.astype(np.float64) - img) ** 2).mean())


def _band_check(label: str, img: np.ndarray, c, r, rows: int = 256, cfg=None) -> None:
    """Golden-model check under `cfg` (default: the default config) on the
    first `rows` rows (whole blocks, so the band's codec is independent of
    the rest), and the full image's MSE."""
    from tpudct_torch import CodecConfig
    from tpudct_torch.selftest import check_against_golden

    c_np = c.cpu().numpy() if isinstance(c, torch.Tensor) else c
    r_np = r.cpu().numpy() if isinstance(r, torch.Tensor) else r
    rows, cols = min(rows, img.shape[0] // 8 * 8), img.shape[1] // 8 * 8
    if not np.isfinite(c_np.astype(np.float32)).all():
        _fail(f"{label}: non-finite coefficients")
    rep = check_against_golden(img[:rows, :cols].astype(np.float32), c_np[:rows, :cols],
                               r_np[:rows, :cols], cfg or CodecConfig())
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
    _main_path_f32_and_scaled(p, step, img, frame, batch, x8k, xcam, xf32, ce, shape, rd, rb, dev)
    launches = dict(hp.LAUNCHES)
    for name in KERNELS:
        if launches[name] < 1:
            _fail(f"main path never launched {name}")
    print("  launches:", json.dumps(launches))
    return launches


def _pool_u8_np(r: np.ndarray, f: int) -> np.ndarray:
    """Host box average of a u8 plane, truncated: the scaled decode's
    contract computed independently of the port."""
    h, w = r.shape
    s = r.reshape(h // f, f, w // f, f).astype(np.int64).sum(axis=(1, 3))
    return (s // (f * f)).astype(np.uint8)


def _main_path_f32_and_scaled(p, step, img, frame, batch, x8k, xcam, xf32, ce, shape, rd, rb, dev):
    """The f32 kernels (hp_dct, hp_idct, the f32-literal roundtrip), the
    "high" decode, the scaled decode (single and stacked) and entry()."""
    from tpudct_torch import CodecConfig
    from tpudct_torch.entry import entry
    from tpudct_torch.kernels import hp
    from tpudct_torch.models.dispatch import (
        decode_gray_auto, decode_gray_scaled_auto, decode_gray_scaled_batch_auto, encode_gray_auto,
        roundtrip_gray_auto,
    )

    sq, fr = f"{SQUARE}^2", "x".join(map(str, FRAME))
    cfg = CodecConfig()
    # q_scale 0.5 fails the int8 bound: Pipeline.encode (hp_dct) and the f32 decode (hp_idct)
    cfg_q = CodecConfig(q_scale=0.5)
    cq, shape_q = step(f"{sq} encode_gray_auto q_scale=0.5", "hp_dct",
                       lambda: encode_gray_auto(p, x8k, cfg_q))
    rq = step(f"{sq} decode_gray_auto q_scale=0.5", "hp_idct", lambda: decode_gray_auto(p, cq, cfg_q, shape_q))
    _band_check(f"{sq} q_scale=0.5 encode + decode", img, cq, rq, cfg=cfg_q)
    # "dct" has no integer core: the f32-literal roundtrip with the highest inverse
    cfg_dct = CodecConfig(transform="dct")
    cd, rdc = step(f"{fr} roundtrip_gray_auto transform=dct", "hp_roundtrip_f32core",
                   lambda: roundtrip_gray_auto(p, xcam, cfg_dct))
    _band_check(f"{fr} roundtrip_gray_auto transform=dct", frame, cd, rdc, cfg=cfg_dct)
    # exact_int_core=False: the f32-literal roundtrip with the butterfly inverse
    cfg_lit = CodecConfig(exact_int_core=False)
    cl, rl = step(f"{sq} f32 hp.roundtrip exact_int_core=False", "hp_roundtrip_f32core",
                  lambda: p.roundtrip(xf32, cfg_lit))
    _band_check(f"{sq} f32 hp.roundtrip exact_int_core=False", img, cl, rl, cfg=cfg_lit)
    # "high" runs the "highest" body of hp_decode_u8
    rh = step(f"{sq} decode_gray_auto decode_precision=high", "hp_decode_u8",
              lambda: decode_gray_auto(p, ce, CodecConfig(decode_precision="high"), shape))
    # (checks use the plain twins, so that the counts hold the main path's launches only)
    if not np.array_equal(rh, hp.decode_u8_plain(ce, decode_precision="highest").cpu().numpy()):
        _fail(f"{sq} high decode differs from the highest decode")
    _band_check(f"{sq} decode_gray_auto decode_precision=high", img, ce, rh)
    # scaled decode: m = 4, 2, 1 ride hp_scaled_decode_u8 (out_u8), m = 6 the plain M/8 einsum
    for m in (4, 2, 1):
        f = 8 // m
        rs = step(f"{sq} decode_gray_scaled_auto m={m}", "hp_scaled_decode_u8",
                  lambda: decode_gray_scaled_auto(p, ce, cfg, shape, m))
        if rs.shape != (SQUARE // f, SQUARE // f) or not np.array_equal(rs, _pool_u8_np(rd, f)):
            _fail(f"{sq} scaled decode m={m} differs from the box average of the full decode")
        print(f"    equals the truncated {f}x{f} box average of the full u8 decode")
    before = dict(hp.LAUNCHES)
    r6 = decode_gray_scaled_auto(p, ce, cfg, shape, 6)
    if hp.LAUNCHES != before:
        _fail(f"{sq} m=6 launched a kernel; it is the plain M/8 path")
    full = hp.idct_plain(ce[:64, :256].to(torch.float32)).cpu().numpy().astype(np.float64)
    area = np.repeat(np.repeat(full, 6, axis=0), 6, axis=1).reshape(48, 8, 192, 8).mean(axis=(1, 3))
    d6 = np.abs(r6[:48, :192].astype(np.int64) - np.clip(np.trunc(area), 0, 255))
    if r6.shape != (SQUARE * 6 // 8,) * 2 or d6.max() > 1:
        _fail(f"{sq} m=6: shape {r6.shape}, max deviation {d6.max()} from the area resample")
    print(f"  {sq} decode_gray_scaled_auto m=6 (plain einsum): shape {r6.shape}, within "
          f"{int(d6.max())} of the f64 area resample of the full decode on a 64x256 corner")
    # the serving batch, stacked into one map: one launch of hp_scaled_decode_u8
    n_img, side = BATCH
    cb = p.encode_u8(torch.as_tensor(batch, device=dev), cfg).cpu().numpy()
    items = [(cb[i * side : (i + 1) * side], cfg, (side, side)) for i in range(n_img)]
    before = hp.LAUNCHES["hp_scaled_decode_u8"]
    rsb = step(f"{n_img}x{side}^2 decode_gray_scaled_batch_auto m=4", "hp_scaled_decode_u8",
               lambda: decode_gray_scaled_batch_auto(p, items, 4))
    if hp.LAUNCHES["hp_scaled_decode_u8"] - before != 1:
        _fail("the stacked batch took more than one launch")
    pooled = _pool_u8_np(rb.cpu().numpy(), 2)
    for i, r in enumerate(rsb):
        if r.shape != (side // 2, side // 2) or not np.array_equal(r, pooled[i * side // 2 : (i + 1) * side // 2]):
            _fail(f"stacked scaled decode of image {i} differs from its pooled decode")
    print(f"    {n_img} planes equal the pooled decodes of the batch roundtrip")
    # the flagship forward step (entry()), on the card
    fn, (ex,) = entry(dev)
    c_e, r_e = step("entry() 512^2", "hp_roundtrip", lambda: fn(ex))
    _band_check("entry() 512^2", ex.cpu().numpy(), c_e, r_e, rows=512)


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
        cf = hp.hp_dct(xf)
        lit = dict(int_core=False)
        fns = {
            "hp_roundtrip_u8": (lambda: hp.hp_roundtrip_u8(x), lambda: hp.roundtrip_u8_plain(x)),
            "hp_encode_u8": (lambda: hp.hp_encode_u8(x), lambda: hp.encode_u8_plain(x)),
            "hp_decode_u8": (lambda: hp.hp_decode_u8(ci8), lambda: hp.decode_u8_plain(ci8)),
            "hp_roundtrip": (lambda: hp.hp_roundtrip(xf), lambda: hp.roundtrip_plain(xf)),
            "hp_roundtrip_f32core": (lambda: hp.hp_roundtrip(xf, **lit),
                                     lambda: hp.roundtrip_plain(xf, **lit)),
            "hp_dct": (lambda: hp.hp_dct(xf), lambda: hp.dct_plain(xf)),
            "hp_idct": (lambda: hp.hp_idct(cf), lambda: hp.idct_plain(cf)),
            "hp_scaled_decode_u8": (lambda: hp.hp_scaled_decode_u8(ci8, 2, 2, out_u8=True),
                                    lambda: hp.scaled_decode_u8_plain(ci8, 2, 2, out_u8=True)),
        }
        # variants off the main path's default (bytes per pixel, kernel, twin),
        # timed and printed beside it
        hi = dict(decode_precision="highest")
        variants = {
            "hp_dct[literal]": (8, lambda: hp.hp_dct(xf, **lit), lambda: hp.dct_plain(xf, **lit)),
            "hp_idct[highest]": (8, lambda: hp.hp_idct(cf, **hi), lambda: hp.idct_plain(cf, **hi)),
            "hp_roundtrip_f32core[highest]": (12, lambda: hp.hp_roundtrip(xf, **lit, **hi),
                                              lambda: hp.roundtrip_plain(xf, **lit, **hi)),
            "hp_scaled_decode_u8[8x8]": (1 + 1 / 64, lambda: hp.hp_scaled_decode_u8(ci8, 8, 8, out_u8=True),
                                         lambda: hp.scaled_decode_u8_plain(ci8, 8, 8, out_u8=True)),
        }
        rows = [(name, KERNELS[name][2], kern, plain) for name, (kern, plain) in fns.items()]
        rows += [(name, *v) for name, v in variants.items()]
        for name, bpp, kern, plain in rows:
            kern(), plain()  # warm up
            p1 = _time(plain, flush, 3)
            k1 = _time(kern, flush, 20)
            k2 = _time(kern, flush, 20)
            p2 = _time(plain, flush, 3)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            gbps = bpp * h * w / (ms * 1e-3) / 1e9
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
