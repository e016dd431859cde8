#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpudct_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (the hp codec B1-B7, the YCbCr split and
merge B8-B13, the ring hops B14-B16 and the study kernels B17-B26: the u8
copy floors, the fused 4:2:0 color encode and decode, the color split/merge
variants and the inverse formulations) from ``tpudct_torch/csrc`` and, in
order:

  1. prints the card (name, power limit), the torch version and nvcc's;
  2. builds the kernels (one nvcc per source, in parallel) and prints
     nvcc's register/stack/spill lines;
  3. turns TF32 off and prints both flags;
  4. holds each kernel against its plain torch twin at 512^2 and 8192^2,
     q_scale 1 and 2.5, retain_k None and 6 (where the kernel takes it),
     every decode tier, both forward cores and the scaled decode at
     fr = fc in {1, 2, 4, 8} and (2, 4), both output types; the u8 kernels also
     at the padded 4000x3072 frame, the 32768x1024 batch and an off-grid
     40x136, the f32-literal roundtrip ("dct", highest) at the frame and
     the scaled decode at the batch, as the main path runs them
     (coefficients and f32 outputs bit-identical; u8 reconstructions within
     +-1 on at most 1e-4 of pixels, the count printed; the scaled decode
     also equal to box_pool_u8(hp_decode_u8)); and checks that TF32 does
     not reach the plain contractions; then each of the six color kernels
     (split and merge at 4:2:0, 4:2:2, 4:4:4) bit for bit against its twin
     at 512^2, 8192^2, the padded 4032x3072 camera frame and the 32768x1024
     serving stack; at each of those shapes hp_encode_u8 and hp_decode_u8
     on the split's luma plane and on its stacked chroma (chroma table),
     and at 8192^2 4:2:0 the scaled decode of that stack at (1, 1) and
     (2, 2), as the color path runs them; and the 4:4:4 merge over all
     256^3 (y, cb, cr) triples against the compare-form round (0
     mismatches); then the three ring kernels at 512^2 (n = 8) and 8192^2
     (n = 1, 2, 4, 8 virtual ranks on the card): one slot of each against
     its twin, and every rank's outputs of ring_all_gather,
     ring_decode_gather and ring_decode_color_gather bit-identical to the
     gathered truth (the coefficients; hp_decode_u8 and its twin on the
     whole map; decode_color_u8 and the twins' decode and merge), which
     also holds B3 and B9 against their twins after their chains moved
     into the shared headers; then the study kernels at 512^2 and 8192^2
     bit for bit against their twins: u8_copy and u8_copy2 (and both on a
     ragged 3x1001 map, whose bytes end off the 16-byte vectors), the
     fused encode and decode at the default config and at q_scale 2.5 with
     retain_k 6; then the study variants at 512^2 and 8192^2 bit for bit
     against their twins (kernels.variants: the merges V1, V12, V4, V6 on
     B8's planes, the splits V3, V5, idct_x "b" and "c" on hp_dct's
     coefficients), V1, V4, V6 also equal to B9's output and V3 to B8's, V12
     and V5 within +-1 on at most 0.5% of them (counts printed), idct_x "b"
     equal to hp_idct, and idct_x leaving its input as it was;
  5. runs the float64 golden-model correctness gate at 512^2 (u8 path with
     the encode/decode/roundtrip bit-identity check, the f32 path, and the
     f32-literal core under transform "dct") and the color420_u8, f32 and
     scaled family gates at 256^2;
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
     then the color main path, its counters set to 0 just before it:
     8192^2 RGB through roundtrip_color_auto at 4:2:0, 4:2:2 and 4:4:4, a
     4032x3024 camera frame, 32 x 1024^2 frames through the bulk helpers,
     the f32 path at q_scale 0.5 and decode_color_scaled at m = 4, 2, 6 --
     each step moving exactly its own counters, its output held against the
     same step on the CPU twins on its first 256 rows; then the
     multi-device main path, its counters set to 0 just before it:
     band_mesh() (the card alone, n = 1) and 8 virtual ranks on the card
     through sharded_codec_step at 8192^2, gather_recon, both decode rings,
     the color step and encode on 8192^2 RGB, the serving step on 32 x
     1024^2 frames, the grid codec and color steps on a (2, 2) grid,
     sharded_idct, sharded_scaled_decode at factor 2 and
     dryrun_multichip(8) -- each step moving exactly its counters (n B4 per
     codec step, n + n(n-1) B14 per all-gather, n B14 + n^2 B15 per decode
     ring, 2n B14 + n^2 B16 per color ring), its output held against the
     same step on a CPU mesh of the twins on its first 256 rows; then the
     study path, its counters set to 0 just before it: the five study
     drivers (tpudct_torch.studies.u8_perf, color_fused_ab, color_variants,
     color_variants2 and inv_formulations) at 8192^2, each moving exactly
     its counters, the fused decode bit-identical to the composed
     decode_color_u8 on the same coefficients, the fused encode's Cb/Cr
     equal to the composed path's and its Y +-1 on at most 0.5% of entries
     (count printed), the variant studies' checks (V1, V3, V4, V6 0
     differences from the shipped pair, V12 and V5 +-1 on at most 0.5%,
     idct_x "b" and "c" within 1e-4 of the f64 golden); then the
     measurement path, its counters set to 0 just before it:
     tpudct_torch.benchmark's bench_pipeline for hp, batched, fast
     (1024^2) and cublas (256^2, its per-block loop, and 1024^2, above the
     loop's cap: the products batched), bench_fused_roundtrip,
     bench_serving_throughput, bench_color, bench_color_serving and sweep
     over 256..1024, each moving exactly its counters, every returned dict
     printed with the card;
  7. times each kernel against its twin with
     tpudct_torch.utils.timing.device_time_ms (CUDA events, the median of
     each batch of calls, L2 flushed before every call; order plain,
     kernel, kernel, plain); B17 beside Tensor.copy_ into a distinct
     tensor, B18 beside B1 as B1's byte floor, V1 beside B9 (the compare-
     form round against the add form); the ring kernels once over a
     whole 8192^2 slot with its forward (B14 beside Tensor.copy_), then per
     launch and per whole ring at n = 1, 2, 4, 8.

Each phase prints its seconds.  Any failure ends the run with a non-zero
exit.  The second-to-last line is a JSON summary of the kernels (launches
on the main paths, max abs error against the twin, kernel and twin ms at
8192^2, the bound from the bytes and operations of that call, what bounds
it, Tensor.copy_'s ms beside B14 and B17); the last line is
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
_CSRC, _CREF = "tpudct_torch/csrc/color_codec.cu", "tpudct/kernels/color_pallas.py"
_RSRC, _RREF = "tpudct_torch/csrc/ring.cu", "tpudct/parallel/ring.py"
_SSRC = "tpudct_torch/csrc/study.cu"
_CV, _CV2, _INV = (f"benchmarks/{n}.py" for n in ("color_variants", "color_variants2", "inv_formulations"))
# kernel -> (CUDA source, the TPU kernel it replaces, bytes moved per pixel
# (each input read once, each output written once), operations per pixel).
# Operations: the value chain's arithmetic per pixel, a multiply-add counted
# as 2; the integer core's products by Ts in {0, +-1, +-2} are adds and
# shifts (one operation per term); the 8x8 literal core (dense f32 T) is 8
# multiplies and 7 adds per output and pass; the color split counts its
# integer luma and window sums per pixel and its chroma transform and
# rounding per chroma sample; a ring launch is counted over a whole slot with
# its forward, per luma pixel (B16: the luma decode, two quarter-size chroma
# decodes and the merge); the fused color encode counts B8's chain with the
# f32 luma (24) plus B2's forward on the luma and half as much on the
# chroma (25.5), the fused decode B16's chain; the color variants count as B8
# and B9, idct_x "b" as B6 and "c" as the inverse's dequantization and shift
# (2) plus, per direction, three digits' products (24) and sums (2) and the
# digit splits (5): 64.  Every kernel here is bound by its bytes at these
# counts (see _bound).
KERNELS = {
    "hp_roundtrip_u8": (_SRC, f"{_REF}:678", 3, 36),
    "hp_encode_u8": (_SRC, f"{_REF}:627", 2, 17),
    "hp_decode_u8": (_SRC, f"{_REF}:651", 2, 19),
    "hp_roundtrip": (_SRC, f"{_REF}:576", 12, 36),
    "hp_roundtrip_f32core": (_SRC, f"{_REF}:445", 12, 68),  # hp_roundtrip's _k_rt_f32_bf
    "hp_dct": (_SRC, f"{_REF}:519", 8, 17),
    "hp_idct": (_SRC, f"{_REF}:550", 8, 17),
    "hp_scaled_decode_u8": (_SRC, f"{_REF}:824", 1 + 1 / 4, 20),  # timed at fr = fc = 2, out_u8
    "color_split_420_u8": (_CSRC, f"{_CREF}:234", 4.5, 19),
    "color_merge_420_u8": (_CSRC, f"{_CREF}:270", 4.5, 19),
    "color_split_422_u8": (_CSRC, f"{_CREF}:381", 5, 26),
    "color_merge_422_u8": (_CSRC, f"{_CREF}:417", 5, 19),
    "color_split_444_u8": (_CSRC, f"{_CREF}:453", 6, 38),
    "color_merge_444_u8": (_CSRC, f"{_CREF}:477", 6, 19),
    "ring_forward": (_RSRC, f"{_RREF}:124", 2, 0),
    "ring_forward_decode": (_SRC, f"{_RREF}:303", 3, 19),  # B3's k_decode_u8 with a forward pointer
    "ring_forward_decode_color": (_RSRC, f"{_RREF}:568", 6, 48),
    "u8_copy": (_SSRC, "benchmarks/u8_perf.py:35", 2, 0),
    "u8_copy2": (_SSRC, "benchmarks/u8_perf.py:53", 3, 0),
    "color_encode_420_u8": (_SSRC, "benchmarks/color_fused_ab.py:170", 4.5, 49.5),
    "color_decode_420_u8": (_SSRC, "benchmarks/color_fused_ab.py:221", 4.5, 48),
    # the study variants (kernels.variants): V3, V4 and V6 launch B8's and B9's kernels
    "color_merge_v1": (_CSRC, f"{_CV}:57", 4.5, 19),
    "color_merge_v12": (_CSRC, f"{_CV}:80", 4.5, 19),
    "color_split_v3": (_CSRC, f"{_CV}:103", 4.5, 19),
    "color_merge_v4": (_CSRC, f"{_CV2}:49", 4.5, 19),
    "color_merge_v6": (_CSRC, f"{_CV2}:65", 4.5, 19),
    "color_split_v5": (_CSRC, f"{_CV2}:85", 4.5, 19),
    "idct_x_b": (_SRC, f"{_INV}:77", 8, 17),  # B6's k_idct
    "idct_x_c": (_SRC, f"{_INV}:81", 8, 64),
}
# repetitions of each timed call in the measurement path (after one warm-up
# call: device_time_ms)
BENCH_REPS = 3
COLOR_MODES = ("420", "422", "444")
FP32_PEAK_OPS = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
SCALED_FACTORS = ((1, 1), (2, 2), (4, 4), (8, 8), (2, 4))
HBM_PEAK_BPS = 3.35e12  # H100 SXM data sheet
RECON_DIFF_SHARE = 1e-4  # kernel vs twin: +-1 on at most this share of pixels
# Main-path shapes: the largest square image, a camera frame, a serving
# batch (images x side) folded into one tall image.
SQUARE, FRAME, BATCH = 8192, (4000, 2992), (32, 1024)
COMPARE_SIZES = (512, SQUARE)
# the color path's camera frame (H x W, a 12-Mpix sensor on its side)
COLOR_FRAME = (4032, 3024)
# the rings: (side, virtual rank counts on the card)
RING_CASES = ((512, (8,)), (SQUARE, (1, 2, 4, 8)))


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def _phase(n: int, title: str) -> None:
    print(f"== phase {n}: {title}", flush=True)


def phase_card() -> str:
    from tpudct_torch.kernels._build import nvcc_path
    from tpudct_torch.utils.timing import card

    _phase(1, "card")
    name = card()
    print("card:", name)
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    return name


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
    _compare_color(dev, errs)
    _compare_ring(dev, errs)
    _compare_study(dev, errs)
    _compare_variants(dev, errs)
    torch.cuda.synchronize()
    return errs


def _tie_class(label: str, n: int, mx: int, total: int) -> None:
    """n of total entries differ, by at most mx: +-1 on at most 0.5%."""
    if mx > 1 or n > 0.005 * total:
        _fail(f"{label}: {n} of {total} entries differ (max {mx})")


def _compare_variants(dev, errs: dict) -> None:
    """The study variants (B21-B26) against their twins, bit for bit, at
    512^2 and 8192^2; V1, V4 and V6 against B9's output and V3 against B8's
    (0 differences), V12 and V5 against them within +-1 on at most 0.5%
    (counted); idct_x "b" against hp_idct bit for bit; idct_x leaves its
    input as it was."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import variants as V
    from tpudct_torch.studies import differ

    for s in COMPARE_SIZES:
        rgb = _rgb_noise(s, s, seed=s + 13, dev=dev)
        planes = ck.color_split_420_u8(rgb)
        base = ck.color_merge_420_u8(*planes)
        counts = []
        for kern in (V._k_merge_v1, V._k_merge_v12, V._k_merge_v4, V._k_merge_v6):
            out = V.make_merge(kern)(*planes)
            errs[kern.name] = max(errs[kern.name], _same(f"{kern.name} {s}^2", out, kern.plain(*planes)))
            n, mx = differ(out, base)
            (_tie_class if kern is V._k_merge_v12 else _zero)(f"{kern.name} {s}^2 vs B9", n, mx, base.numel())
            counts.append(f"{kern.name} {n}")
        for kern in (V._k_split_v3, V._k_split_v5):
            out = V.make_split(kern)(rgb)
            for plane, a, b, c in zip(("y", "cb", "cr"), out, kern.plain(rgb), planes):
                errs[kern.name] = max(errs[kern.name], _same(f"{kern.name} {s}^2 {plane}", a, b))
                n, mx = differ(a, c)
                check = _tie_class if kern is V._k_split_v5 and plane != "y" else _zero
                check(f"{kern.name} {s}^2 {plane} vs B8", n, mx, c.numel())
                counts.append(f"{kern.name} {plane} {n}")
        x = _noise(s, s, seed=s + 14, dev=dev).to(torch.float32)
        c = hp.hp_dct(x)
        keep = c.clone()
        rb, rc = V.idct_x(c, "b"), V.idct_x(c, "c")
        errs["idct_x_b"] = max(errs["idct_x_b"], _same(f"idct_x b {s}^2", rb, hp.idct_plain(c)))
        errs["idct_x_c"] = max(errs["idct_x_c"], _same(f"idct_x c {s}^2", rc, V.idct_c_plain(c)))
        _equal(f"idct_x b {s}^2 vs hp_idct", rb, hp.hp_idct(c))
        _equal(f"idct_x {s}^2 input after the calls", c, keep)
        print(f"  {s}^2: the six color variants and idct_x b, c bit-identical to their twins; against B8/B9 "
              f"differing: {', '.join(counts)}; idct_x b equals hp_idct, c within "
              f"{float((rc - rb).abs().max()):.2e} of it")


def _zero(label: str, n: int, mx: int, total: int) -> None:
    if n:
        _fail(f"{label}: {n} of {total} entries differ (max {mx})")


def _compare_study(dev, errs: dict) -> None:
    """The study kernels (B17-B20) against their twins, bit for bit: the
    copies at 512^2, 8192^2 and on a ragged 3x1001 map (a byte tail past the
    16-byte vectors), the fused encode and decode at 512^2 and 8192^2 at the
    default config and at q_scale 2.5 with retain_k 6."""
    from tpudct_torch.kernels import study

    maps = [(f"{s}^2", _noise(s, s, seed=s + 3, dev=dev)) for s in COMPARE_SIZES]
    maps.append(("3x1001", _noise(3, 1001, seed=4, dev=dev)))
    for label, x in maps:
        out = study.u8_copy(x.clone())
        errs["u8_copy"] = max(errs["u8_copy"], _same(f"u8_copy {label}", out, study.copy_plain(x.clone())))
        _equal(f"u8_copy {label} values", out, x)
        for part, a, b in zip(("u8", "int8"), study.u8_copy2(x.clone()), study.copy2_plain(x.clone())):
            errs["u8_copy2"] = max(errs["u8_copy2"], _same(f"u8_copy2 {label} {part}", a, b))
    for s in COMPARE_SIZES:
        rgb = _rgb_noise(s, s, seed=s + 5, dev=dev)
        for kw in ({}, {"q_scale": 2.5, "retain_k": 6}):
            tag = f"{s}^2 {kw or 'default'}"
            planes = study.color_encode_420_u8(rgb, **kw)
            for plane, a, b in zip(("y", "cb", "cr"), planes, study.encode_420_plain(rgb, **kw)):
                errs["color_encode_420_u8"] = max(errs["color_encode_420_u8"],
                                                  _same(f"color_encode_420_u8 {tag} {plane}", a, b))
            qs = kw.get("q_scale", 1.0)
            e = _same(f"color_decode_420_u8 {tag}", study.color_decode_420_u8(*planes, q_scale=qs),
                      study.decode_420_plain(*planes, q_scale=qs))
            errs["color_decode_420_u8"] = max(errs["color_decode_420_u8"], e)
    print(f"  u8_copy and u8_copy2 at {', '.join(label for label, _ in maps)}, color_encode_420_u8 and "
          f"color_decode_420_u8 at {', '.join(f'{s}^2' for s in COMPARE_SIZES)} (default; q_scale 2.5, "
          "retain_k 6) bit-identical to their twins")


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


def _rgb_noise(h: int, w: int, seed: int, dev) -> torch.Tensor:
    """(3, h, w) planar u8 noise."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 256, size=(3, h, w), dtype=np.uint8), device=dev)


def _camera_rgb(h: int, w: int) -> np.ndarray:
    """A photo-like (h, w, 3) u8 RGB frame: three camera-like channels."""
    return np.stack([_camera_frame(h, w, seed=s) for s in (7, 8, 9)], axis=-1)


def _compare_color(dev, errs: dict) -> None:
    """The six color kernels against their twins, bit for bit, at the
    shapes the main path hands them (512^2, 8192^2, the padded camera
    frame, the 32-frame serving stack), and the 4:4:4 merge over all 256^3
    (y, cb, cr) triples."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.ops.padding import pad_to_kernel

    cam = torch.as_tensor(_camera_rgb(*COLOR_FRAME), device=dev).movedim(-1, 0).contiguous()
    cam, _ = pad_to_kernel(cam, 64, 256)
    n_img, side = BATCH
    inputs = [(f"{s}^2", _rgb_noise(s, s, seed=s + 1, dev=dev)) for s in COMPARE_SIZES]
    inputs += [(f"{cam.shape[1]}x{cam.shape[2]} camera frame", cam),
               (f"{n_img * side}x{side} serving stack", _rgb_noise(n_img * side, side, seed=45, dev=dev))]
    for label, rgb in inputs:
        for mode in COLOR_MODES:
            split, merge = (f"color_{d}_{mode}_u8" for d in ("split", "merge"))
            planes = getattr(ck, split)(rgb)
            for plane, a, b in zip(("y", "cb", "cr"), planes, ck.split_plain(rgb, mode)):
                errs[split] = max(errs[split], _same(f"{split} {label} {plane}", a, b))
            out = getattr(ck, merge)(*planes)
            errs[merge] = max(errs[merge], _same(f"{merge} {label}", out, ck.merge_plain(*planes, mode)))
            _compare_color_codec(label, mode, planes, errs, scaled=(label == f"{SQUARE}^2" and mode == "420"))
        print(f"  {label}: color split and merge at 4:2:0, 4:2:2 and 4:4:4 bit-identical to their twins")
    _merge_sweep(ck, dev, errs)


def _compare_color_codec(label: str, mode: str, planes, errs: dict, scaled: bool) -> None:
    """hp_encode_u8 and hp_decode_u8 on the planes the color path hands
    them: the luma plane (luma table, once per input) and the stacked chroma
    ``cat([cb, cr])`` (chroma table); with `scaled`, hp_scaled_decode_u8 on
    the stacked chroma at the factors decode_color_scaled gives it at
    m = 4 and 2 on 4:2:0, (1, 1) and (2, 2)."""
    from tpudct_torch.kernels import hp

    y, cb, cr = planes
    stacks = [("chroma stack", torch.cat([cb, cr]), "chroma")]
    if mode == COLOR_MODES[0]:
        stacks.insert(0, ("luma", y, "luma"))
    counts = []
    for plane, x, table in stacks:
        tag = f"{label} {mode} {plane} {tuple(x.shape)}"
        c = hp.hp_encode_u8(x, q_table=table)
        e, _ = _cmp(f"hp_encode_u8 {tag}", c, hp.encode_u8_plain(x, q_table=table), recon=False)
        errs["hp_encode_u8"] = max(errs["hp_encode_u8"], e)
        e, n = _cmp(f"hp_decode_u8 {tag}", hp.hp_decode_u8(c, q_table=table),
                    hp.decode_u8_plain(c, q_table=table), recon=True)
        errs["hp_decode_u8"] = max(errs["hp_decode_u8"], e)
        counts.append(f"{plane} {tuple(x.shape)} {n}")
        if scaled and table == "chroma":
            for fr in (1, 2):
                for out_u8 in (False, True):
                    s = hp.hp_scaled_decode_u8(c, fr, fr, q_table=table, out_u8=out_u8)
                    e = _same(f"hp_scaled_decode_u8 {tag} ({fr}, {fr}) out_u8={out_u8}", s,
                              hp.scaled_decode_u8_plain(c, fr, fr, q_table=table, out_u8=out_u8))
                    errs["hp_scaled_decode_u8"] = max(errs["hp_scaled_decode_u8"], e)
            counts.append("hp_scaled_decode_u8 (1, 1), (2, 2) (f32, u8) bit-identical")
    print(f"    {mode}: hp_encode_u8 bit-identical, hp_decode_u8 pixels differing: {'; '.join(counts)}")


def _merge_sweep(ck, dev, errs: dict) -> None:
    """The merge's add-form round trunc(clip(z) + 0.5) against the compare
    form clip(round_half_away(z)) over every (y, cb, cr) triple: one
    4096x4096 4:4:4 merge whose planes enumerate them, on the card's own
    arithmetic."""
    from tpudct_torch.ops.rounding import round_half_away
    from tpudct_torch.utils.color import rgb_from_ycbcr_planes

    n = torch.arange(1 << 24, dtype=torch.int32, device=dev).reshape(4096, 4096)
    y, cb, cr = (((n >> sh) & 255).to(torch.uint8).contiguous() for sh in (16, 8, 0))
    out = ck.color_merge_444_u8(y, cb, cr)
    e = _same("color_merge_444_u8 256^3 sweep", out, ck.merge_plain(y, cb, cr, "444"))
    errs["color_merge_444_u8"] = max(errs["color_merge_444_u8"], e)
    rgb = rgb_from_ycbcr_planes(*(c.to(torch.float32) for c in (y, cb, cr)))
    ref = torch.stack([round_half_away(v).clamp(0.0, 255.0).to(torch.uint8) for v in rgb])
    mismatches = int((out != ref).sum())
    if mismatches:
        _fail(f"color merge: {mismatches} of 3 x 256^3 outputs differ from the compare-form round")
    print("  color_merge_444_u8 over all 256^3 (y, cb, cr) triples: 0 mismatches against the "
          "compare-form round, bit-identical to its twin")


def _color_planes(rgb):
    """int8 4:2:0 coefficient planes (y, cb, cr) of a planar RGB image, coded
    by the u8 kernels as the color path codes them."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp

    y, cb, cr = ck.color_split_420_u8(rgb)
    cc = hp.hp_encode_u8(torch.cat([cb, cr]), q_table="chroma")
    return hp.hp_encode_u8(y), cc[: cb.shape[0]], cc[cb.shape[0] :]


def _ring_slots(side: int, n: int, dev) -> tuple:
    """Inputs of one slot (rows of rank 0's band at n ranks) of each ring
    kernel at `side`^2: (u8 image slot, int8 luma slot, int8 chroma pack
    slot)."""
    from tpudct_torch.parallel import chroma_band_pack

    br = side // n
    x = _noise(side, side, seed=side + n, dev=dev)[:br]
    cy, ccb, ccr = _color_planes(_rgb_noise(br, side, seed=side + n, dev=dev))
    return x, cy, chroma_band_pack(ccb, ccr, 1)


def _compare_ring_slot(side: int, n: int, dev, errs: dict) -> None:
    """Each ring kernel on one slot against its twin on the same inputs:
    forwards and decodes bit-identical."""
    from tpudct_torch.kernels import ring as rk

    x, y, pack = _ring_slots(side, n, dev)
    e = torch.empty_like
    d_k, d_p = e(x), e(x)
    rk.ring_forward(x, d_k)
    rk.forward_plain(x, d_p)
    errs["ring_forward"] = max(errs["ring_forward"], _same(f"ring_forward {tuple(x.shape)}", d_k, d_p))
    outs = [(e(y), torch.empty(y.shape, dtype=torch.uint8, device=dev)) for _ in range(2)]
    rk.ring_forward_decode(y, *outs[0])
    rk.forward_decode_plain(y, *outs[1])
    for k, p in zip(*outs):
        errs["ring_forward_decode"] = max(errs["ring_forward_decode"],
                                          _same(f"ring_forward_decode {tuple(y.shape)}", k, p))
    outs = [(e(y), e(pack), torch.empty((3, *y.shape), dtype=torch.uint8, device=dev)) for _ in range(2)]
    rk.ring_forward_decode_color(y, pack, *outs[0])
    rk.forward_decode_color_plain(y, pack, *outs[1])
    for k, p in zip(*outs):
        errs["ring_forward_decode_color"] = max(errs["ring_forward_decode_color"],
                                                _same(f"ring_forward_decode_color {tuple(y.shape)}", k, p))


def _equal(label: str, got, want) -> None:
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        n = int((got != want).sum()) if got.shape == want.shape else -1
        _fail(f"{label}: {got.dtype}{tuple(got.shape)} differs from the truth on {n} values")


def _compare_ring(dev, errs: dict) -> None:
    """The three ring kernels (B14-B16): one slot of each against its twin,
    and whole rings on virtual ranks of the card against the gathered
    truth, every rank."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.models.color import decode_color_u8
    from tpudct_torch.parallel import (
        band_mesh, chroma_band_pack, ring_all_gather, ring_decode_color_gather, ring_decode_gather,
        shard_image,
    )

    for side, ns in RING_CASES:
        x = _noise(side, side, seed=side + 7, dev=dev)
        c = hp.hp_encode_u8(x)
        gray = hp.hp_decode_u8(c)
        _equal(f"hp_decode_u8 {side}^2 vs its twin", gray, hp.decode_u8_plain(c))
        cy, ccb, ccr = _color_planes(_rgb_noise(side, side, seed=side + 8, dev=dev))
        meta = {"orig_shape": (side, side), "chroma_shape": (side // 2, side // 2), "subsample": "420"}
        rgb = decode_color_u8(get_pipeline("hp"), {"y": cy, "cb": ccb, "cr": ccr}, meta, CodecConfig())
        rgb = rgb.movedim(-1, 0)
        cu = hp.decode_u8_plain(torch.cat([ccb, ccr]), q_table="chroma")
        _equal(f"decode_color_u8 {side}^2 vs the twins' decode and merge", rgb,
               ck.merge_plain(hp.decode_u8_plain(cy), cu[: side // 2], cu[side // 2 :]))
        for n in ns:
            _compare_ring_slot(side, n, dev, errs)
            mesh = band_mesh(devices=[dev] * n)
            full = ring_all_gather(shard_image(x, mesh), mesh)
            crep, rec = ring_decode_gather(shard_image(c, mesh), mesh)
            pack = chroma_band_pack(ccb, ccr, n)
            yrep, prep, out = ring_decode_color_gather(shard_image(cy, mesh), shard_image(pack, mesh), mesh)
            for r in range(n):
                tag = f"{side}^2 n={n} rank {r}"
                _equal(f"ring_all_gather {tag}", full.shards[r], x)
                _equal(f"ring_decode_gather coefficients {tag}", crep.shards[r], c)
                _equal(f"ring_decode_gather reconstruction {tag}", rec.shards[r], gray)
                _equal(f"ring_decode_color_gather luma {tag}", yrep.shards[r], cy)
                _equal(f"ring_decode_color_gather chroma pack {tag}", prep.shards[r], pack)
                _equal(f"ring_decode_color_gather RGB {tag}", out.shards[r], rgb)
            del full, crep, rec, yrep, prep, out
            print(f"  {side}^2 n={n}: ring kernels bit-identical to their twins on a {side // n}x{side} "
                  "slot; every rank's ring_all_gather, ring_decode_gather (coefficients, hp_decode_u8 of "
                  "the map) and ring_decode_color_gather (planes, decode_color_u8) equal the truth")
    torch.cuda.synchronize()


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

    from tpudct_torch.kernels import color as ck

    _phase(6, "main path (gray)")
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
    ck.reset_launches()
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
    for name in hp.LAUNCHES:
        if name in KERNELS and launches[name] < 1:
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


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _color_band_check(label: str, rgb: np.ndarray, planes: dict, rec, sub, cfg, rows: int = 256) -> None:
    """The step's planes and RGB reconstruction on the first `rows` rows
    (whole blocks and chroma windows, so the band codes on its own) against
    the same step run on the CPU twins: the color420_u8 gate's class
    (planes +-1 on <= 0.5%, MSE within 2%, mean abs diff <= 0.5); kernel and
    twin agree bit for bit, so 0 differences are expected."""
    from tpudct_torch import get_pipeline
    from tpudct_torch.models.color import roundtrip_color_auto

    band = np.ascontiguousarray(rgb[:rows])
    pt, _mt, rt = roundtrip_color_auto(get_pipeline("hp"), band, cfg, subsample=sub, device="cpu")
    n_planes = []
    for k in ("y", "cb", "cr"):
        ref = pt[k].numpy()
        mine = _host(planes[k])[: ref.shape[0], : ref.shape[1]].astype(np.float64)
        d = np.abs(mine - ref)
        if d.max() > 1 or (d > 0).mean() > 0.005:
            _fail(f"{label}: plane {k} differs from the twins' (max {d.max()}, {int((d > 0).sum())} entries)")
        n_planes.append(int((d > 0).sum()))
    rec_np, rt = _host(rec), rt.numpy()
    if not np.isfinite(rec_np).all() or rec_np.dtype != np.uint8:
        _fail(f"{label}: reconstruction is not finite uint8")
    mine, rt, band = (a.astype(np.float64) for a in (rec_np[:rows], rt, band))
    m, m_t = float(((mine - band) ** 2).mean()), float(((rt - band) ** 2).mean())
    dr = np.abs(mine - rt)
    if abs(m - m_t) > 0.02 * m_t + 1e-9 or dr.mean() > 0.5:
        _fail(f"{label}: reconstruction band MSE {m} vs twins {m_t}, mean diff {dr.mean()}")
    print(f"    {tuple(rec_np.shape)} {rec_np.dtype}; band of {rows} rows vs the twins: plane entries "
          f"differing {n_planes}, recon pixels differing {int((dr > 0).sum())}, MSE {m:.4f} vs {m_t:.4f}")


def _stepper(*launch_counts: dict):
    """(counts, step) over the wrappers' LAUNCHES dicts: counts() merges
    them; step(label, expected, fn) runs fn, synchronizes, prints its host
    wall and fails unless exactly the counters in `expected` moved, by
    exactly those amounts."""

    def counts() -> dict:
        return {k: v for c in launch_counts for k, v in c.items()}

    def step(label, expected: dict, fn):
        before = counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        if moved != expected:
            _fail(f"{label}: launched {moved}, expected {expected}")
        print(f"  {label}: launched {json.dumps(moved)}, {dt * 1e3:.1f} ms host wall")
        return out

    return counts, step


def phase_color_main_path(dev) -> dict:
    """The color main path at full width, its counters set to 0 just
    before it and read just after; each step moves exactly its own."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.models import color as mc
    from tpudct_torch.ops.padding import padded_shape

    _phase(6, "main path (color)")
    cfg, p = CodecConfig(), get_pipeline("hp")

    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES)

    def codec(mode):
        return {f"color_split_{mode}_u8": 1, "hp_encode_u8": 2, "hp_decode_u8": 2, f"color_merge_{mode}_u8": 1}

    sq, (n_img, side) = f"{SQUARE}^2", BATCH
    rng = np.random.default_rng(44)
    rgb_np = rng.integers(0, 256, size=(SQUARE, SQUARE, 3), dtype=np.uint8)
    cam_np = _camera_rgb(*COLOR_FRAME)
    frames = [rng.integers(0, 256, size=(side, side, 3), dtype=np.uint8) for _ in range(n_img)]
    rgb, cam = torch.as_tensor(rgb_np, device=dev), torch.as_tensor(cam_np, device=dev)
    torch.cuda.synchronize()

    hp.reset_launches()
    ck.reset_launches()
    planes420 = meta420 = None
    for mode in COLOR_MODES:
        sub = False if mode == "444" else mode
        label = f"{sq} interleaved roundtrip_color_auto {mode}"
        planes, meta, rec = step(label, codec(mode), lambda: mc.roundtrip_color_auto(p, rgb, cfg, subsample=sub))
        _color_band_check(label, rgb_np, planes, rec, sub, cfg)
        if mode == "420":
            planes420, meta420 = planes, meta
    label = "x".join(map(str, COLOR_FRAME)) + " camera frame roundtrip_color_auto 420"
    planes, meta, rec = step(label, codec("420"), lambda: mc.roundtrip_color_auto(p, cam, cfg))
    if tuple(rec.shape) != (*COLOR_FRAME, 3) or tuple(planes["y"].shape) != padded_shape(*COLOR_FRAME):
        _fail(f"{label}: shapes {tuple(planes['y'].shape)}, {tuple(rec.shape)}")
    _color_band_check(label, cam_np, planes, rec, "420", cfg)
    label = f"{n_img}x{side}^2 encode_color_batch_auto"
    enc = step(label, {"color_split_420_u8": 1, "hp_encode_u8": 2},
               lambda: mc.encode_color_batch_auto(p, frames, cfg))
    label = f"{n_img}x{side}^2 decode_color_batch_auto"
    dec = step(label, {"hp_decode_u8": 2, "color_merge_420_u8": 1},
               lambda: mc.decode_color_batch_auto(p, [(pl, m, cfg) for pl, m in enc]))
    if len(dec) != n_img or any(r.shape != (side, side, 3) for r in dec):
        _fail(f"{label}: {len(dec)} frames of shapes {sorted({r.shape for r in dec})}")
    _color_band_check(f"{n_img}x{side}^2 bulk frame 0", frames[0], enc[0][0], dec[0], "420", cfg)
    cfg_q = CodecConfig(q_scale=0.5)
    label = f"{sq} roundtrip_color_auto q_scale=0.5 (f32 path)"
    planes, meta, rec = step(label, {"hp_dct": 2, "hp_idct": 2},
                             lambda: mc.roundtrip_color_auto(p, rgb, cfg_q))
    _color_band_check(label, rgb_np, planes, rec, "420", cfg_q)
    del planes, rec
    # scaled decode of the 4:2:0 planes: m = 4 (luma (2, 2), chroma native
    # (1, 1)) and m = 2 (luma (4, 4), chroma (2, 2)) on hp_scaled_decode_u8;
    # m = 6 the plain M/8 einsum
    band = {"y": planes420["y"][:256].cpu(), "cb": planes420["cb"][:128].cpu(), "cr": planes420["cr"][:128].cpu()}
    band_meta = {"orig_shape": (256, SQUARE), "chroma_shape": (128, SQUARE // 2), "subsample": "420"}
    for m, expected in ((4, {"hp_scaled_decode_u8": 2}), (2, {"hp_scaled_decode_u8": 2}), (6, {})):
        label = f"{sq} decode_color_scaled m={m}"
        out = step(label, expected, lambda: mc.decode_color_scaled(p, planes420, meta420, cfg, m=m))
        ref = mc.decode_color_scaled(p, band, band_meta, cfg, m=m, device="cpu").numpy()
        side_s = SQUARE * m // 8
        mine = _host(out)
        if mine.shape != (side_s, side_s, 3):
            _fail(f"{label}: shape {mine.shape}")
        d = np.abs(mine[: ref.shape[0]].astype(np.int64) - ref)
        if d.max() > 1 or (d > 0).sum() > 1e-4 * d.size:
            _fail(f"{label}: band differs from the twins' on {int((d > 0).sum())} outputs (max {d.max()})")
        print(f"    {mine.shape}; band of {ref.shape[0]} rows vs the twins: {int((d > 0).sum())} outputs differ")
    launches = counts()
    for name in ck.LAUNCHES:
        if launches[name] < 1:
            _fail(f"color main path never launched {name}")
    print("  launches:", json.dumps(launches))
    return launches


# what dryrun_multichip(8) launches on 8 virtual ranks of the card: B4 per
# rank in the codec step, the color step's luma and the grid color step's
# luma tiles (chroma and the grid codec tiles are narrower than 128: the
# batched fallback); B1 per rank in the serving step; the coefficients of the
# decode ring (B2) and the color roundtrip feeding the color ring (B8, 2 B2,
# 2 B3, B9); both rings; B6 per rank in sharded_idct
DRYRUN_LAUNCHES = {
    "hp_roundtrip": 24, "hp_roundtrip_u8": 8, "hp_encode_u8": 3, "hp_decode_u8": 2, "hp_idct": 8,
    "color_split_420_u8": 1, "color_merge_420_u8": 1,
    "ring_forward": 24, "ring_forward_decode": 64, "ring_forward_decode_color": 64,
}


def _head(t, spec: str, rows: int):
    """The first `rows` rows (of each plane of planar RGB; of the first
    image of a batch)."""
    if spec == "batch":
        t = t[0]
    return t[:, :rows] if t.ndim == 3 else t[:rows]


def _vs_cpu(label: str, mine, twin, rows: int = 256, exact: bool = True) -> None:
    """A step's output on the card against the same step on a CPU mesh of
    the twins, over its first `rows` rows (on the card, read from the
    ranks that hold them): bit-identical, or (`exact` False, the plain f32
    color transforms) +-1 on at most 0.5%, the count printed."""
    from tpudct_torch.parallel import gather

    nc = mine.mesh.shape[1] if mine.spec in ("grid", "rgb-grid") else 1
    first = torch.cat(mine.shards[:nc], dim=-1) if nc > 1 else mine.shards[0]
    a = _head(first, mine.spec, rows).cpu().numpy().astype(np.float64)
    rows = a.shape[-2] if a.ndim == 3 else a.shape[0]  # fewer where the first band is shorter
    b = _head(gather(twin), twin.spec, rows).astype(np.float64)
    if a.shape != b.shape:
        _fail(f"{label}: shapes {a.shape} vs the CPU twins' {b.shape}")
    d = np.abs(a - b)
    n = int((d > 0).sum())
    if (exact and n) or d.max() > 1 or n > 0.005 * d.size:
        _fail(f"{label}: {n} of {d.size} values differ from the CPU twins' (max {d.max()})")
    print(f"    first {rows} rows vs the CPU twins: {n} of {d.size} values differ")


def phase_multi_main_path(dev) -> dict:
    """The multi-device main path: band_mesh() (every card) and 8 virtual
    ranks on the card, its counters set to 0 just before it and read just
    after; each step moves exactly its own, and its output is held against
    the same step on a CPU mesh of the twins."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.entry import dryrun_multichip
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import ring as rk
    from tpudct_torch import parallel as P

    _phase(6, "main path (multi-device)")
    cfg, p = CodecConfig(), get_pipeline("hp")

    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES, rk.LAUNCHES)

    def cpu(n, grid=False):
        return P.grid_mesh((2, 2), ["cpu"] * 4) if grid else P.band_mesh(devices=["cpu"] * n)

    sq, (n_img, side) = f"{SQUARE}^2", BATCH
    rng = np.random.default_rng(46)
    img = rng.integers(0, 256, size=(SQUARE, SQUARE), dtype=np.uint8)
    rgb_np = rng.integers(0, 256, size=(3, SQUARE, SQUARE), dtype=np.uint8)
    batch = rng.integers(0, 256, size=(n_img, side, side), dtype=np.uint8)
    xf = torch.as_tensor(img, device=dev).to(torch.float32)
    rgb = torch.as_tensor(rgb_np, device=dev)
    c8 = hp.hp_encode_u8(xf.to(torch.uint8))
    cy, ccb, ccr = _color_planes(rgb)
    xf_cpu, c8_cpu = xf[:256].cpu(), c8[:256].cpu()
    torch.cuda.synchronize()

    hp.reset_launches()
    ck.reset_launches()
    rk.reset_launches()
    m8 = P.band_mesh(devices=[dev] * 8)
    for mesh in (P.band_mesh(), m8):
        n = mesh.size
        label = f"{sq} sharded_codec_step n={n}"
        (c, r), m = step(label, {"hp_roundtrip": n},
                         lambda: P.sharded_codec_step(p, cfg, mesh)(P.shard_image(xf, mesh)))
        (tc, tr), _tm = P.sharded_codec_step(p, cfg, cpu(n))(P.shard_image(xf_cpu, cpu(n)))
        _vs_cpu(label + " coefficients", c, tc)
        _vs_cpu(label + " reconstruction", r, tr)
        mse = float(((torch.cat(r.shards).double() - xf.double()) ** 2).mean())
        if abs(float(m["mse"]) - mse) > 1e-4 * mse:
            _fail(f"{label}: metrics mse {float(m['mse'])} vs {mse} recomputed")
        print(f"    metrics {json.dumps({k: round(float(v), 6) for k, v in m.items()})}; mse recomputed in f64 {mse:.6f}")
        label = f"{sq} ring_decode_gather n={n}"
        crep, rec = step(label, {"ring_forward": n, "ring_forward_decode": n * n},
                         lambda: P.ring_decode_gather(P.shard_image(c8, mesh), mesh))
        tcrep, trec = P.ring_decode_gather(P.shard_image(c8_cpu, cpu(n)), cpu(n))
        truth = hp.decode_u8_plain(c8)
        for k in range(n):
            _equal(f"{label} rank {k} coefficients", crep.shards[k], c8)
            _equal(f"{label} rank {k} reconstruction", rec.shards[k], truth)
        _vs_cpu(label + " reconstruction", rec, trec)
        del c, r, crep, rec, truth
    label = f"{sq} gather_recon n=8"
    _c, full = step(label, {"hp_roundtrip": 8, "ring_forward": 64},
                    lambda: P.gather_recon(p, cfg, m8)(P.shard_image(xf, m8)))
    _tc, tfull = P.gather_recon(p, cfg, cpu(8))(P.shard_image(xf_cpu, cpu(8)))
    for k in range(1, 8):
        _equal(f"{label} rank {k}", full.shards[k], full.shards[0])
    _vs_cpu(label, full, tfull)
    del _c, full
    label = f"{sq} ring_decode_color_gather n=8"
    pack = P.chroma_band_pack(ccb, ccr, 8)
    yrep, prep, out = step(label, {"ring_forward": 16, "ring_forward_decode_color": 64},
                           lambda: P.ring_decode_color_gather(P.shard_image(cy, m8), P.shard_image(pack, m8), m8))
    tpack = P.chroma_band_pack(ccb[:128].cpu(), ccr[:128].cpu(), 8)
    _ty, _tp, tout = P.ring_decode_color_gather(P.shard_image(cy[:256].cpu(), cpu(8)),
                                                P.shard_image(tpack, cpu(8)), cpu(8))
    for k in range(1, 8):
        _equal(f"{label} rank {k}", out.shards[k], out.shards[0])
    _vs_cpu(label, out, tout)
    del yrep, prep, out, pack
    label = f"{sq} RGB sharded_color_step n=8"
    crec, cm = step(label, {"hp_roundtrip": 16}, lambda: P.sharded_color_step(p, cfg, m8)(P.shard_rgb(rgb, m8)))
    tcrec, _tcm = P.sharded_color_step(p, cfg, cpu(8))(P.shard_rgb(rgb_np[:, :256], cpu(8)))
    _vs_cpu(label, crec, tcrec, exact=False)
    print(f"    metrics mse {float(cm['mse']):.6f}")
    del crec
    label = f"{sq} RGB sharded_color_encode n=8"
    enc, _meta_fn = P.sharded_color_encode(p, cfg, m8)
    planes = step(label, {"hp_dct": 16}, lambda: enc(P.shard_rgb(rgb, m8)))
    tenc, _ = P.sharded_color_encode(p, cfg, cpu(8))
    tplanes = tenc(P.shard_rgb(rgb_np[:, :256], cpu(8)))
    _vs_cpu(label + " y", planes[0], tplanes[0], exact=False)
    _vs_cpu(label + " cb", planes[1], tplanes[1], rows=128, exact=False)
    del planes
    label = f"{n_img}x{side}^2 sharded_serving_step n=8"
    (bc, br), bm = step(label, {"hp_roundtrip_u8": 8},
                        lambda: P.sharded_serving_step(p, cfg, m8)(P.shard_batch(batch, m8)))
    (tbc, tbr), _tbm = P.sharded_serving_step(p, cfg, cpu(8))(P.shard_batch(batch[:8], cpu(8)))
    if float(bm["images"]) != n_img:
        _fail(f"{label}: {float(bm['images'])} images")
    _vs_cpu(label + " coefficients", bc, tbc)
    _vs_cpu(label + " reconstruction", br, tbr)
    del bc, br
    g4 = P.grid_mesh((2, 2), [dev] * 4)
    label = f"{sq} sharded_codec_step_grid (2, 2)"
    (gc, gr), _gm = step(label, {"hp_roundtrip": 4},
                         lambda: P.sharded_codec_step_grid(p, cfg, g4)(P.shard_image_grid(xf, g4)))
    (tgc, tgr), _ = P.sharded_codec_step_grid(p, cfg, cpu(4, True))(P.shard_image_grid(xf_cpu, cpu(4, True)))
    _vs_cpu(label + " coefficients", gc, tgc)
    _vs_cpu(label + " reconstruction", gr, tgr)
    del gc, gr
    label = f"{sq} RGB sharded_color_step_grid (2, 2)"
    gcrec, _ = step(label, {"hp_roundtrip": 8},
                    lambda: P.sharded_color_step_grid(p, cfg, g4)(P.shard_rgb_grid(rgb, g4)))
    tgcrec, _ = P.sharded_color_step_grid(p, cfg, cpu(4, True))(P.shard_rgb_grid(rgb_np[:, :256], cpu(4, True)))
    _vs_cpu(label, gcrec, tgcrec, exact=False)
    del gcrec
    cmap = P.shard_image(hp.dct_plain(xf), m8)
    tmap = P.shard_image(hp.dct_plain(xf_cpu), cpu(8))
    label = f"{sq} sharded_idct n=8"
    rid = step(label, {"hp_idct": 8}, lambda: P.sharded_idct(p, cfg, m8)(cmap))
    _vs_cpu(label, rid, P.sharded_idct(p, cfg, cpu(8))(tmap))
    label = f"{sq} sharded_scaled_decode factor 2 n=8"
    half = step(label, {}, lambda: P.sharded_scaled_decode(cfg, m8, 2)(cmap))
    if half.shape != (SQUARE // 2, SQUARE // 2):
        _fail(f"{label}: shape {half.shape}")
    thalf = P.sharded_scaled_decode(cfg, cpu(8), 2)(tmap)
    a = half.shards[0][:128].cpu().numpy()
    err = float(np.abs(a - P.gather(thalf)[: a.shape[0]]).max())
    if err > 1e-3:
        _fail(f"{label}: {err} from the CPU twins")
    print(f"    first {a.shape[0]} rows within {err:.2e} of the CPU run (a float64 basis, rounded once)")
    del rid, half, cmap
    step("dryrun_multichip(8) on 8 virtual ranks", DRYRUN_LAUNCHES,
         lambda: dryrun_multichip(8, [dev] * 8))
    launches = counts()
    for name in rk.LAUNCHES:
        if launches[name] < 1:
            _fail(f"multi-device main path never launched {name}")
    print("  launches:", json.dumps(launches))
    return launches


def phase_study_path(dev) -> dict:
    """The five study drivers at SQUARE^2, the counters set to 0 just before
    and read just after; each driver moves exactly its counters (one
    warm-up and REPS timed calls per measurement, plus its checks)."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import study
    from tpudct_torch.kernels import variants as V
    from tpudct_torch.studies import color_fused_ab, color_variants, color_variants2, inv_formulations, u8_perf

    _phase(6, "study path")
    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES, study.LAUNCHES, V.LAUNCHES)
    hp.reset_launches()
    ck.reset_launches()
    study.reset_launches()
    V.reset_launches()
    k = 1 + u8_perf.REPS
    floors = step(f"{SQUARE}^2 studies.u8_perf.main",
                  {"u8_copy": k, "u8_copy2": k, "hp_encode_u8": k + 1, "hp_decode_u8": k, "hp_roundtrip_u8": k},
                  lambda: u8_perf.main(SQUARE, dev))
    # the fused and composed encodes and decodes once for the counts, then
    # six timed stages: each kernel runs in two of them
    n = 1 + 2 * (1 + color_fused_ab.REPS)
    fused = step(f"{SQUARE}^2 studies.color_fused_ab.main",
                 {"color_encode_420_u8": n, "color_decode_420_u8": n, "color_split_420_u8": n,
                  "hp_encode_u8": 2 * n, "hp_decode_u8": 2 * n, "color_merge_420_u8": n},
                 lambda: color_fused_ab.main(SQUARE, dev))
    # the variant studies: their checks once, then the timed pairs (shipped
    # twice), each kernel in as many pairs as name it
    k = 1 + color_variants.REPS
    cv = step(f"{SQUARE}^2 studies.color_variants.main",
              {"color_split_420_u8": 1 + 4 * k, "color_merge_420_u8": 1 + 3 * k, "color_merge_v1": 1 + k,
               "color_merge_v12": 1 + 2 * k, "color_split_v3": 1 + 2 * k},
              lambda: color_variants.main(SQUARE, dev))
    cv2 = step(f"{SQUARE}^2 studies.color_variants2.main",
               {"color_split_420_u8": 1 + 3 * k, "color_merge_420_u8": 1 + 2 * k, "color_merge_v4": 1 + 2 * k,
                "color_merge_v6": 1 + k, "color_split_v5": 1 + 2 * k},
               lambda: color_variants2.main(SQUARE, dev))
    k = 1 + inv_formulations.REPS
    inv = step(f"{SQUARE}^2 studies.inv_formulations.main",
               {"hp_dct": 2, "idct_x_b": 1 + k, "idct_x_c": 1 + k, "hp_idct": 3 * k},
               lambda: inv_formulations.main(SQUARE, dev))
    launches = counts()
    n_m, n_l, n_c = (cv["entries"][k] for k in ("merge", "y", "chroma"))
    for out, key, total in ((cv, "v1", n_m), (cv, "v3_y", n_l), (cv, "v3_cb", n_c), (cv, "v3_cr", n_c),
                            (cv2, "v4", n_m), (cv2, "v6", n_m), (cv2, "v5_y", n_l)):
        _zero(f"the {key} check", out[f"{key}_differ"], out[f"{key}_max"], total)
    _tie_class("the V12 merge against the shipped merge", cv["v12_differ"], cv["v12_max"], n_m)
    for plane in ("cb", "cr"):
        _tie_class(f"the V5 split's {plane}", cv2[f"v5_{plane}_differ"], cv2[f"v5_{plane}_max"], n_c)
    for v in ("b", "c"):
        if not inv[f"{v}_max_err"] <= 1e-4:
            _fail(f"idct_x {v}: {inv[f'{v}_max_err']} from the f64 golden")
    print(f"  variant checks on (3, 256, 512): V1, V3, V4, V6 0 differences; V12 {cv['v12_differ']} of {n_m} merge "
          f"outputs, V5 cb {cv2['v5_cb_differ']}, cr {cv2['v5_cr_differ']} of {n_c}; idct_x b, c "
          f"{inv['b_max_err']:.2e}, {inv['c_max_err']:.2e} from the f64 golden at 512^2")
    if fused["decode_differ"]:
        _fail(f"the fused decode differs from decode_color_u8 on {fused['decode_differ']} outputs")
    if fused["cb_differ"] or fused["cr_differ"]:
        _fail(f"the fused encode's chroma differs from the composed path's ({fused['cb_differ']}, "
              f"{fused['cr_differ']} entries)")
    n_y = fused["entries"]["y"]
    if fused["y_max_diff"] > 1 or fused["y_differ"] > 0.005 * n_y:
        _fail(f"the fused encode's luma differs on {fused['y_differ']} of {n_y} entries "
              f"(max {fused['y_max_diff']})")
    print(f"  fused decode bit-identical to decode_color_u8 on the same coefficients; fused Cb/Cr equal "
          f"to the composed path's; fused Y +-1 on {fused['y_differ']} of {n_y} entries "
          f"({fused['y_differ'] / n_y:.4%}); B1 over its byte floor {floors['roundtrip_over_floor']:.2f}x")
    for name in (*study.LAUNCHES, *V.LAUNCHES):
        if launches[name] < 1:
            _fail(f"study path never launched {name}")
    print("  launches:", json.dumps(launches))
    return launches


def phase_measurement_path(dev, card: str) -> dict:
    """tpudct_torch.benchmark's benches on the card, the counters set to 0
    just before and read just after; each bench moves exactly its counters
    (one warm-up and BENCH_REPS timed calls per measurement)."""
    from tpudct_torch import benchmark as B
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import study

    _phase(6, "measurement path")
    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES, study.LAUNCHES)
    hp.reset_launches()
    ck.reset_launches()
    study.reset_launches()
    k, n_img, side = 1 + BENCH_REPS, *BATCH
    color = {"color_split_420_u8": k, "hp_encode_u8": 2 * k, "hp_decode_u8": 2 * k, "color_merge_420_u8": k}
    sweep_sizes = (256, 512, 1024)
    benches = [
        ("bench_pipeline hp 1024", {"hp_dct": 2 * k, "hp_idct": k},
         lambda: B.bench_pipeline("hp", 1024, reps=BENCH_REPS, device=dev)),
        ("bench_pipeline batched 1024", {}, lambda: B.bench_pipeline("batched", 1024, reps=BENCH_REPS, device=dev)),
        ("bench_pipeline fast 1024", {}, lambda: B.bench_pipeline("fast", 1024, reps=BENCH_REPS, device=dev)),
        ("bench_pipeline cublas 256", {}, lambda: B.bench_pipeline("cublas", 256, reps=BENCH_REPS, device=dev)),
        # above the per-block loop's cap (512^2): the products batched over the blocks
        ("bench_pipeline cublas 1024", {}, lambda: B.bench_pipeline("cublas", 1024, reps=BENCH_REPS, device=dev)),
        (f"bench_fused_roundtrip {SQUARE}", {"hp_roundtrip": k},
         lambda: B.bench_fused_roundtrip(SQUARE, reps=BENCH_REPS, device=dev)),
        (f"bench_serving_throughput {n_img}x{side}", {"hp_roundtrip_u8": k},
         lambda: B.bench_serving_throughput(side, n_img, reps=BENCH_REPS, device=dev)),
        (f"bench_color {SQUARE}", color, lambda: B.bench_color(SQUARE, reps=BENCH_REPS, device=dev)),
        ("bench_color_serving 8x1024", color, lambda: B.bench_color_serving(1024, 8, reps=BENCH_REPS, device=dev)),
        (f"sweep {sweep_sizes}", {"hp_dct": 2 * k * len(sweep_sizes), "hp_idct": k * len(sweep_sizes)},
         lambda: B.sweep(sweep_sizes, reps=BENCH_REPS, device=dev)),
    ]
    for label, expected, fn in benches:
        out = step(label, expected, fn)
        for row in out if isinstance(out, list) else [out]:
            times = [v for key, v in row.items() if key.endswith("_ms") and not key.startswith("ref_")]
            if row["backend"] != torch.cuda.get_device_name(dev) or not all(np.isfinite(times)) or min(times) < 0:
                _fail(f"{label}: {row}")
            print(f"    {json.dumps(row)} [{card}]")
    launches = counts()
    print("  launches:", json.dumps(launches))
    return launches


def _bound(name: str, h: int, w: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one call at h x w: the larger
    of its bytes over the HBM rate and its operations over the f32 rate."""
    _src, _ref, bpp, ops = KERNELS[name]
    t_bytes, t_ops = bpp * h * w / HBM_PEAK_BPS * 1e3, ops * h * w / FP32_PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time(fn, dev, reps: int) -> float:
    """Median device ms per call of fn() on dev: the package's timer
    (tpudct_torch.utils.timing.device_time_ms: one warm-up call, then CUDA
    events around each call, the L2 flushed outside them before every call)."""
    from tpudct_torch.utils.timing import device_time_ms

    return device_time_ms(lambda _: fn(), torch.empty(0, device=dev), reps=reps)


def phase_timing(dev, card: str) -> dict:
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import study
    from tpudct_torch.kernels import variants as V

    _phase(7, f"timing ({card})")
    times = {"library": {}}
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
        if label == f"{SQUARE}^2":  # the color kernels at 8192^2 only
            rgb = _rgb_noise(h, w, seed=6, dev=dev)
            for mode in COLOR_MODES:
                split, merge = (getattr(ck, f"color_{d}_{mode}_u8") for d in ("split", "merge"))
                planes = split(rgb)
                fns[f"color_split_{mode}_u8"] = (lambda f=split: f(rgb),
                                                 lambda m=mode: ck.split_plain(rgb, m))
                fns[f"color_merge_{mode}_u8"] = (lambda f=merge, pl=planes: f(*pl),
                                                 lambda m=mode, pl=planes: ck.merge_plain(*pl, m))
            # the study kernels: the copies work in place on their own map
            # (its values stay), the fused pair on its own RGB and planes
            xs = _noise(h, w, seed=8, dev=dev)
            rgb_s = _rgb_noise(h, w, seed=12, dev=dev)
            planes_s = study.color_encode_420_u8(rgb_s)
            fns["u8_copy"] = (lambda: study.u8_copy(xs), lambda: study.copy_plain(xs))
            fns["u8_copy2"] = (lambda: study.u8_copy2(xs), lambda: study.copy2_plain(xs))
            fns["color_encode_420_u8"] = (lambda: study.color_encode_420_u8(rgb_s),
                                          lambda: study.encode_420_plain(rgb_s))
            fns["color_decode_420_u8"] = (lambda: study.color_decode_420_u8(*planes_s),
                                          lambda: study.decode_420_plain(*planes_s))
            # the study variants: the merges on B8's planes of rgb, the splits
            # on rgb, idct_x on hp_dct's coefficients
            p420 = ck.color_split_420_u8(rgb)
            for kern in (V._k_merge_v1, V._k_merge_v12, V._k_merge_v4, V._k_merge_v6):
                fns[kern.name] = (lambda f=V.make_merge(kern): f(*p420), lambda t=kern.plain: t(*p420))
            for kern in (V._k_split_v3, V._k_split_v5):
                fns[kern.name] = (lambda f=V.make_split(kern): f(rgb), lambda t=kern.plain: t(rgb))
            for v in ("b", "c"):
                fns[f"idct_x_{v}"] = (lambda v=v: V.idct_x(cf, v),
                                      lambda t=(hp.idct_plain if v == "b" else V.idct_c_plain): t(cf))
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
            p1 = _time(plain, dev, 3)
            k1 = _time(kern, dev, 20)
            k2 = _time(kern, dev, 20)
            p2 = _time(plain, dev, 3)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            gbps = bpp * h * w / (ms * 1e-3) / 1e9
            times[(name, label)] = (ms, plain_ms)
            bound = f"; bound {_bound(name, h, w)[0]:.4f} ms" if name in KERNELS else ""
            print(f"  {label} {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; "
                  f"kernel {gbps:.1f} GB/s = {gbps * 1e9 / HBM_PEAK_BPS:.1%} of 3.35 TB/s{bound} "
                  f"[{card}]")
        if label == f"{SQUARE}^2":
            dst = torch.empty_like(xs)
            copy = [_time(lambda: dst.copy_(xs), dev, 20) for _ in range(2)]
            times["library"]["u8_copy"] = (copy[0] + copy[1]) / 2
            print(f"  {label} Tensor.copy_ into a distinct tensor (u8_copy's library call): {copy[0]:.4f} / "
                  f"{copy[1]:.4f} ms [{card}]")
            rt, floor = times[("hp_roundtrip_u8", label)][0], times[("u8_copy2", label)][0]
            print(f"  {label} hp_roundtrip_u8 (B1) {rt:.4f} ms against B1's byte floor u8_copy2 (B18) "
                  f"{floor:.4f} ms: {rt / floor:.2f}x [{card}]")
            v1, b9 = times[("color_merge_v1", label)][0], times[("color_merge_420_u8", label)][0]
            print(f"  {label} color_merge_v1 (compare-form round) {v1:.4f} ms beside color_merge_420_u8 (B9, "
                  f"add-form round) {b9:.4f} ms: {v1 / b9:.3f}x [{card}]")
    ring_times, copy_ms = _time_rings(dev, card)
    times.update(ring_times)
    times["library"]["ring_forward"] = copy_ms
    return times


def _ring_bytes(n: int, side: int) -> dict:
    """Bytes each whole ring moves at n ranks on a side^2 map (each launch's
    inputs read once and outputs written once, summed over its launches)."""
    px = side * side // n  # pixels of one slot
    return {
        "ring_all_gather": n * n * 2 * px,
        "ring_decode_gather": (2 * n + 3 * n * (n - 1) + 2 * n) * px,
        "ring_decode_color_gather": (3 * n + 6 * n * (n - 1) + 4.5 * n) * px,
    }


def _time_rings(dev, card: str) -> tuple:
    """B14-B16 over a whole SQUARE^2 slot with its forward (kernel and twin,
    Tensor.copy_ beside B14), then per launch and per whole ring at each
    rank count.  Returns (times, B14's library ms)."""
    from tpudct_torch import parallel as P
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import ring as rk

    x = _noise(SQUARE, SQUARE, seed=9, dev=dev)
    c = hp.hp_encode_u8(x)
    cy, ccb, ccr = _color_planes(_rgb_noise(SQUARE, SQUARE, seed=10, dev=dev))
    pack = P.chroma_band_pack(ccb, ccr, 1)
    e = torch.empty_like
    dst, fwd, rec, fy, fc = e(x), e(c), e(x), e(cy), e(pack)
    rgb = torch.empty((3, SQUARE, SQUARE), dtype=torch.uint8, device=dev)
    fns = {
        "ring_forward": (lambda: rk.ring_forward(x, dst), lambda: rk.forward_plain(x, dst)),
        "ring_forward_decode": (lambda: rk.ring_forward_decode(c, fwd, rec),
                                lambda: rk.forward_decode_plain(c, fwd, rec)),
        "ring_forward_decode_color": (lambda: rk.ring_forward_decode_color(cy, pack, fy, fc, rgb),
                                      lambda: rk.forward_decode_color_plain(cy, pack, fy, fc, rgb)),
    }
    times = {}
    for name, (kern, plain) in fns.items():
        p1 = _time(plain, dev, 3)
        k1 = _time(kern, dev, 20)
        k2 = _time(kern, dev, 20)
        p2 = _time(plain, dev, 3)
        ms = (k1 + k2) / 2
        times[(name, f"{SQUARE}^2")] = (ms, (p1 + p2) / 2)
        gbps = KERNELS[name][2] * SQUARE * SQUARE / (ms * 1e-3) / 1e9
        print(f"  {SQUARE}^2 slot with its forward, {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms; {gbps:.1f} GB/s = {gbps * 1e9 / HBM_PEAK_BPS:.1%} of 3.35 TB/s; bound "
              f"{_bound(name, SQUARE, SQUARE)[0]:.4f} ms [{card}]")
    copy = [_time(lambda: dst.copy_(x), dev, 20) for _ in range(2)]
    print(f"  {SQUARE}^2 Tensor.copy_ (B14's library call): {copy[0]:.4f} / {copy[1]:.4f} ms [{card}]")
    for n in (1, 2, 4, 8):
        mesh, br = P.band_mesh(devices=[dev] * n), SQUARE // n
        pack_n = P.chroma_band_pack(ccb, ccr, n)
        launch = {
            "B14": lambda: rk.ring_forward(x[:br], dst[:br]),
            "B15": lambda: rk.ring_forward_decode(c[:br], fwd[:br], rec[:br]),
            "B16": lambda: rk.ring_forward_decode_color(cy[:br], pack_n[:br], fy[:br], fc[:br], rgb[:, :br]),
        }
        args = {
            "ring_all_gather": (P.shard_image(x, mesh), mesh),
            "ring_decode_gather": (P.shard_image(c, mesh), mesh),
            "ring_decode_color_gather": (P.shard_image(cy, mesh), P.shard_image(pack_n, mesh), mesh),
        }
        per = {k: _time(f, dev, 20) for k, f in launch.items()}
        whole = {name: _time(lambda: getattr(P, name)(*a), dev, 5) for name, a in args.items()}
        times[("rings", n)] = (per, whole)
        bounds = {k: b / HBM_PEAK_BPS * 1e3 for k, b in _ring_bytes(n, SQUARE).items()}
        print(f"  n={n} ({br}x{SQUARE} slots): per launch with forward B14 {per['B14']:.4f}, B15 "
              f"{per['B15']:.4f}, B16 {per['B16']:.4f} ms; whole ring "
              + ", ".join(f"{k} {whole[k]:.4f} ms (bound {bounds[k]:.4f})" for k in whole) + f" [{card}]")
    return times, (copy[0] + copy[1]) / 2


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    import tpudct_torch  # noqa: F401  (fails here outside a checkout of the repo)

    from tpudct_torch.utils.timing import card as card_label

    dev = torch.device("cuda", 0)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"   ({fn.__name__} took {time.perf_counter() - t0:.1f} s)", flush=True)
        return out

    card = timed(phase_card)
    timed(phase_build)
    timed(phase_tf32)
    errs = timed(phase_compare, dev)
    timed(phase_gate, dev)
    runs = [timed(phase, dev) for phase in (phase_main_path, phase_color_main_path, phase_multi_main_path,
                                             phase_study_path)]
    runs.append(timed(phase_measurement_path, dev, card))
    times = timed(phase_timing, dev, card)
    kernels = []
    for name, (src, replaces, _bpp, _ops) in KERNELS.items():
        bound_ms, bound_by = _bound(name, SQUARE, SQUARE)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(run.get(name, 0) for run in runs), "max_abs_err": errs[name],
            "ms": times[(name, f"{SQUARE}^2")][0], "plain_ms": times[(name, f"{SQUARE}^2")][1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": times["library"].get(name),
        })
    print(card_label())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
