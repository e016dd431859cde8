#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpudct_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --mp-worker ...   (one process of phase 6's multi-process path)

Builds the port's CUDA kernels (the hp codec B1-B7, the YCbCr split and
merge B8-B13, the ring hops B14-B16 and the study kernels B17-B36: the u8
copy floors, the fused 4:2:0 color encode and decode, the color split/merge
variants, the inverse formulations and the u8 roundtrip and encode
variants) from ``tpudct_torch/csrc`` and, in order:

  1. prints the card (name, power limit), the torch version and nvcc's;
  2. builds the kernels (one nvcc per source, in parallel; the seconds
     printed) and prints nvcc's register/stack/spill lines, and from
     ``cuobjdump -sass`` of the library each B1, B2, B3 (B15), B7, B16, B19,
     B20 instance's and B22's count of instructions, of conversion
     instructions (I2F, I2FP, F2I, F2IP, FRND, F2F) and MUFU, beside
     its registers and spills, and B8's (k_color_split<2, 2, kCHW, whole>) and
     B30/B31's (k_enc_half); a B1/B2/B3/B7/B19 instance with an FRND, a
     spill, or more I2F or F2I than B6's block index fails, and so does
     B22 with a spill;
  3. turns TF32 off and prints both flags;
  4. holds each kernel against its plain torch twin at 512^2 and 8192^2,
     q_scale 1 and 2.5, retain_k None and 6 (where the kernel takes it),
     every decode tier, both forward cores and the scaled decode at
     fr = fc in {1, 2, 4, 8} and (2, 4), both output types; the u8 kernels also
     at the padded 4000x3072 frame, the 32768x1024 batch and an off-grid
     40x136, the f32-literal roundtrip ("dct", highest) at the frame and
     the scaled decode at the batch, as the main path runs them
     (coefficients, u8 reconstructions and f32 outputs bit-identical, B1's
     coefficients equal to B2's and its reconstruction to B3's; the f32
     roundtrip's truncated reconstruction within +-1 on at most 1e-4 of
     pixels, the count printed; the scaled decode also equal to
     box_pool_u8(hp_decode_u8)); and checks that TF32 does
     not reach the plain contractions; then each of the six color kernels
     (split and merge at 4:2:0, 4:2:2, 4:4:4) bit for bit against its twin
     at 512^2, 8192^2, the padded 4032x3072 camera frame and the 32768x1024
     serving stack; at each of those shapes hp_encode_u8 and hp_decode_u8
     on the split's luma plane and on its stacked chroma (chroma table),
     and at 8192^2 4:2:0 the scaled decode of that stack at (1, 1) and
     (2, 2), as the color path runs them; and the 4:4:4 merge over all
     256^3 (y, cb, cr) triples against the compare-form round (0
     mismatches); then the direct colour instances (k_color_split<RH, RW,
     false, kCHW/kHWC>, k_color_merge<RH, RW, kTrunc, kHWC>) bit for bit
     against their twins at the 4032x3024 camera frame, a ragged 3001x4003
     frame and 8192^2, interleaved and planar, every mode, and
     roundtrip_color_u8's planes and RGB bit for bit against the grid's
     chain (edge pad, B8-B13, the codec on the grid planes, crops, zero
     pads); then the u8 colour path's two chain calls against the six
     per-kernel wrappers' chain, planes, RGB and launch counts bit for
     bit, at the camera frame, a ragged 4031x3023 frame and the camera
     frame at a 1-byte offset, interleaved and planar, every mode; then
     the three ring kernels at 512^2 (n = 8) and 8192^2
     (n = 1, 2, 4, 8 virtual ranks on the card): one slot of each against
     its twin, and every rank's outputs of ring_all_gather,
     ring_decode_gather and ring_decode_color_gather bit-identical to the
     gathered truth (the coefficients; hp_decode_u8 and its twin on the
     whole map; decode_color_u8 and the twins' decode and merge), which
     also holds B3 and B9 against their twins after their chains moved
     into the shared headers; then B14 (csrc/copy.cuh's body) bit for bit
     against its twin on byte runs of odd lengths (below one 16-byte
     vector, around the body's 512-byte chunk grain and 16 and 32 KiB
     tiles, 1001, 1 MiB +-1) and of each 8192^2 ring slot, src and dst at byte offsets
     (0, 0), (1, 1) and (1, 3), the bytes around each run untouched; then
     the study kernels at 512^2 and 8192^2 bit for bit against their
     twins: u8_copy (in place: its output is its input) and u8_copy2 (both
     outputs; both kernels also on a ragged 3x1001 map, whose bytes end
     off the 16-byte vectors), the
     fused encode and decode at the default config and at q_scale 2.5 with
     retain_k 6, the fused encode also for every integer core and cb2011 and
     on saturated RGB (all 0, all 255, the pure primaries, and every
     (r, g, b) triple, whose luma lands on both sides of every .5 tie);
     B16 and B20 (csrc/strip420.cuh's one body) on uniform int8 noise planes (so the decode's clamps are reached) at 512^2 and 8192^2,
     for every integer core and the alias cb2011, at q_scale 1 and 2.5, B16
     on every ring slot at n = 1, 2, 4, 8, with its forwards; B1 (u8 noise
     with all-0, all-255 and checkerboard blocks; its coefficients equal to
     B2's), B3 (uniform int8 noise) on the butterfly, highest and high
     tiers and B15 on every ring slot at n = 1, 2, 4, 8, for every integer
     core and cb2011, at 512^2 and 8192^2, bit for bit; B7 on uniform int8
     noise for every integer core and cb2011 at (q_scale 1, luma) and
     (2.5, chroma), every (fr, fc) of {1, 2, 4, 8}^2, f32 and u8 out, at
     512^2 and 8192^2, bit for bit against its twin and
     box_pool_u8(hp_decode_u8); then the study
     variants at 512^2 and 8192^2 bit for bit
     against their twins (kernels.variants: the merges V1, V12, V4, V6 on
     B8's planes, the splits V3, V5, idct_x "b" and "c" on hp_dct's
     coefficients), V1, V4, V6 also equal to B9's output and V3 to B8's, V12
     and V5 within +-1 on at most 0.5% of them (counts printed), idct_x "b"
     equal to hp_idct, idct_x "c" also on a wide-range f32 map with +-0,
     and idct_x leaving its input as it was;
     then the u8
     study variants B27-B36 at 512^2 and 8192^2 on u8 noise with all-0,
     all-255 and alternating 0/255 blocks: each bit for bit against its
     twin, B27-B29 (q_scale 1 and 2.5) also equal to hp_roundtrip_u8 and
     B32-B36 to hp_encode_u8, E2 (B30) saturating at both -128 and 127
     (counts printed);
  5. runs the float64 golden-model correctness gate at 512^2 (u8 path with
     the encode/decode/roundtrip bit-identity check, the f32 path, and the
     f32-literal core under transform "dct") and the color420_u8, f32,
     scaled, streamed_gray and streamed_color family gates;
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
     4032x3024 camera frame (the direct instances), 32 x 1024^2 frames
     through the bulk helpers at every mode (B8-B13),
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
     idct_x "b" and "c" within 1e-4 of the f64 golden), and the u8 variant
     drivers (u8_variants in modes int, bf, abbf, cs; enc_variants in modes
     a, b, d, e; rt_split_ab with 3 trials; scaled_ab), each moving exactly
     its counters and every difference count they report 0 (each of the ten
     u8 variant counters must move), and five more drivers
     (timing_xval: B1 at 8192^2 by device_time_ms, by the amortized wall of
     a 1024-launch chain and by a line through chains of 8..648 launches;
     bulk_ab: 64 x 512^2 frames per image and stacked, its spot-check;
     onchip_recheck: the gate, the one-rank decode ring at 512^2 and 8192^2
     equal to hp_decode_u8, the f32 color path timed; deadzone_study and
     rans_interleave_ab on the host, no launch), each moving exactly its
     counters; then the
     measurement path, its counters set to 0 just before it:
     tpudct_torch.benchmark's bench_pipeline for hp, batched, fast
     (1024^2) and cublas (256^2, its per-block loop, and 1024^2, above the
     loop's cap: the products batched), bench_fused_roundtrip,
     bench_serving_throughput, bench_color, bench_color_serving and sweep
     over 256..1024, each moving exactly its counters, every returned dict
     printed with the card; then the file path, its counters set to 0 just
     before it: tpudct_torch.cli.main in process on .npy images in a
     temporary directory -- an 8192^2 photo-like gray frame through
     ``encode --entropy auto`` (one B2), ``inspect``, ``decode`` (one B3),
     ``run --coeffs`` (one B1) and ``decode --scale 2/8`` (one B7), the
     4032x3024 camera frame through ``encode --color`` (B8 and two B2) and
     ``decode`` (two B3 and B9) and ``encode --color --chroma 444`` (B12
     and two B2) -- each moving exactly its counters, every JSON record
     printed with the card; then the files held against
     serialize.coefficients_to_bytes / color_to_bytes of the plain twins'
     coefficients computed on the card, the decoded rasters against
     decode_gray_auto, decode_gray_scaled_auto and decode_color_auto on
     those coefficients, run's file against encode's; and every entropy
     stage (raw, spectral, huffman, rans, xz, banded, banded:4:rans,
     auto-exact) on the twins' coefficients of the frame's 2048^2 corner,
     each parsed back to the same map by the native decoders and by the
     pure-Python ones (TPUDCT_NO_NATIVE_JPEG set); it prints whether the
     host JPEG library built; then the streamed path
     (tpudct_torch.utils.streaming: pinned, double-buffered staging), its
     counters set to 0 just before it: a 16384^2 photo-like gray frame
     through encode_gray_streamed_bytes in 8 bands of 2048 rows (8 B2),
     decode_gray_streamed in full, at scale_m=2 (8 B7), n_planes=4, a
     row_range off the band edges and into a .npy memmap (B3 per band),
     roundtrip_u8_streamed in bands of 4096 (4 B1), the CLI's ``encode
     --band-rows 2048`` and ``decode --band-rows 2048`` on its .npy, an
     8192^2 off-int8 stream (transform "dct") decoded on B6, an 8192^2
     photo-like RGB frame through the streamed color encode and decode at
     4:2:0 and 4:4:4 and the 4032x3024 camera frame at 4:2:0 and 4:2:2
     (B8/B10/B12 and 2 B2, 2 B3 and B9/B11/B13 per band),
     roundtrip_u8_streamed_sharded over 4 virtual ranks (B1 per rank and
     band), save_sharded and save_color_sharded -- each moving exactly
     its counters; then the bytes against the in-memory banded writer
     (coefficients_to_bytes banded:8 of encode_gray_auto, color_to_bytes
     banded:4 of encode_color_u8, the camera frame's planes), every
     decode against decode_gray_auto / decode_gray_scaled_auto /
     decode_color_auto, the sharded calls against roundtrip_u8 and the
     single-host banded writer; per call its host wall split into staging
     copies, H2D, kernels, D2H, waits, finishing and entropy
     (streaming.seconds of the profiling registry, CUDA events), the
     device busy share, and its own peak of device memory beside one
     band's bytes (the 8-band gray calls fail at half of the image's
     bytes); and the in-memory calls that
     return numpy, with their walls and peaks; then the archive path: the
     nine phases of tpudct_torch.studies.partial_at_scale, each a process
     of its own, in a temporary directory deleted afterwards -- a 65536^2
     gray raster (2^32 pixels) written, streamed into a banded .tdc in 32
     bands of 2048 rows (32 B2), thumbnailed (no launch), ROI-decoded at
     rows 32000:32100 (B3, and the covering band in memory: B2, B3) and
     decoded at 1/8 scale (32 B7, and band 15 in memory: B2, B7); a
     32768^2 RGB raster streamed into a .tdcc (16 B8, 32 B2), thumbnailed
     and ROI-decoded at rows 16000:16100 (two B6, and the covering band in
     memory: B8, two B2, two B6) -- each phase reporting exactly its
     launches, every validation flag true (the ROIs and the scaled band
     bit-identical to their bands in memory, the ROI's segment to the
     in-memory coefficients), each phase's seconds, peak host memory and
     streamed split printed (this path runs right after phase 2: a
     child's ru_maxrss starts from its parent's resident set, so its
     processes start from the smallest parent); then the bulk and measuring
     path, its counters set to 0 just before it: tpudct_torch.cli.main in
     process -- ``batch`` over 32 photo-like 1024^2 .npy frames, the
     4000x2992 frame and a corrupt .npy (one B2 per width), a rerun (none),
     ``batch --color`` over 8 RGB 1024^2 frames and the 4032x3024 frame,
     the streamed branches with streaming.STREAM_PIXELS patched to
     SQUARE^2/4 (``batch`` of an 8192^2 frame, ``unbatch`` of it and of the
     camera frame's .tdcc), ``unbatch --ext .npy`` of the gray and the color
     files in full and at ``--scale 4/8``; then ``bench`` (8192^2 --fused
     --color; 1024^2 --batch 32 --color; --host-entropy and --e2e at
     2048^2), ``sweep``, ``table``, ``table --color``, ``curve``, ``scale``
     on 1, 2, 4, 8 virtual ranks, ``selftest --families``, ``profile``
     (its trace.json must name k_rt_f32), ``compare`` and ``info`` (it must
     report cuda and the card) -- each call moving exactly its counters;
     then every file against the per-file library call and every raster
     against the per-file decode, bit for bit; then the coefficient path,
     its counters set to 0 just before it: an 8192^2 photo-like gray frame
     and the 4032x3024 camera frame at 4:2:0 encoded by the plain twins as
     import_jpeg's stream (transform "dct", q_scale 1, IJG quality-90
     tables as custom q-tables), through ``edit`` for every op, a
     block-aligned ``--crop`` and ``--grayscale`` (none: host work),
     ``transcode`` rans -> huffman -> banded:4 -> rans (none) and
     ``decode`` of every output (one B6 per gray decode; the camera
     frame's color decode none, its widths off the kernel grid) -- each
     call moving exactly its counters; then every decode bit-identical to
     the plain twins' decode of the file's coefficients, every edited map
     equal to its op applied to the unedited map, the restage to the same
     coefficients and back to the source's bytes, and per op the count of
     pixels where decode(edit) differs from op(decode); where the host
     JPEG library builds also jpg -> tdc -> jpg bit-exact and ``decode
     in.jpg`` (the card's machine has no libjpeg headers: the phase says
     the legs ran in the CPU tests only); then the multi-process path:
     two worker processes of this script (``--mp-worker``), each joining a
     gloo group through distributed_init on a localhost port and driving 2
     virtual ranks on the card with its slab of each input, through
     sharded_codec_step and the grid step on 8192^2, sharded_color_step
     and sharded_color_encode on 8192^2 RGB, sharded_serving_step on 32 x
     1024^2 frames, save_sharded, save_color_sharded and gather of every
     output -- every hash, file, byte count and metric equal to the same
     steps in this process on 4 virtual ranks, the workers' launches adding
     up to that run's, and per step the host wall and its gloo seconds;
     then the headline bench path, its counters set to 0 just before it:
     ``python3 -m tpudct_torch.bench`` as a subprocess from the root of the
     checkout (TPUDCT_BENCH_TIMEOUT set) and tpudct_torch.bench.main() in
     process (the gates' launches and 1 + 5 B1), each exiting 0 with one
     stdout line of the reference's four keys and metric string,
     vs_baseline = round(29.4 / value, 2), after the gate and every
     family passed on stderr (jpg_import may skip); the subprocess's value
     within 10% of torch.profiler's device time of the same call (L2
     flushed), and main() with a pipeline whose coefficients are one step
     off exiting 1 with one ``correctness gate failed`` line;
  7. times each kernel against its twin with
     tpudct_torch.utils.timing.device_time_ms (CUDA events, the median of
     each batch of calls, L2 flushed before every call; order plain,
     kernel, kernel, plain); B17 in turns with Tensor.copy_ of the same
     bytes into a distinct tensor (kernel, copy_, copy_, kernel), B18
     in turns with x.view(torch.int8).clone() (its library call) and with
     the pair copy_ into a distinct u8 tensor, then its int8 clone, and
     beside B1 as B1's byte floor, V1 beside B9 (the compare-form round
     against the add form), B20 in turns with its composed counterpart
     (hp_decode_u8 on the luma and the stacked chroma, color_merge_420_u8);
     the direct colour instances at 8192^2 and, beside their bound, at the
     4032x3024 camera frame in turns with the grid's passes they replace,
     and the camera frame's 4:2:0 roundtrip_color_u8 in turns with the
     grid's chain; the ring kernels once over a whole 8192^2 slot with its forward (B14
     in turns with Tensor.copy_, B16 with its composed counterpart: B15 on
     the luma and the chroma pack slots, then color_merge_420_u8), then per
     launch (B14 in turns with Tensor.copy_ of the same slot, B16 with its
     composed counterpart, with the slot's bound) and per whole ring at
     n = 1, 2, 4, 8; the u8 study variants B27-B36 with their twins on
     their own 8192^2 noise map; B7 also at f = 8 and with f32 out; then
     prints the headline bench's value against B1's time.

Each phase prints its seconds.  Any failure ends the run with a non-zero
exit.  The second-to-last line is a JSON summary of the kernels (launches
on the main paths, max abs error against the twin, kernel and twin ms at
8192^2, the bound from the bytes and operations of that call, what bounds
it, the library call's ms beside B14, B17 and B18); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script raises before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

_SRC, _REF = "tpudct_torch/csrc/hp_codec.cu", "tpudct/kernels/hp_pallas.py"
_ISRC = "tpudct_torch/csrc/hp_inverse.cu"
_CSRC, _CREF = "tpudct_torch/csrc/color_codec.cu", "tpudct/kernels/color_pallas.py"
_RSRC, _RREF = "tpudct_torch/csrc/ring.cu", "tpudct/parallel/ring.py"
_SSRC = "tpudct_torch/csrc/study.cu"
_CV, _CV2, _INV = (f"benchmarks/{n}.py" for n in ("color_variants", "color_variants2", "inv_formulations"))
_UV, _EV = "benchmarks/u8_variants.py", "benchmarks/enc_variants.py"
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
# f32 luma (24) plus the u8 encode's (B2, B1's encode half: the forward and
# the quantizer) on the luma and half as much on the chroma (25.5), the
# fused decode B16's chain; the color variants count as B8
# and B9, idct_x "b" as B6 and "c" (B22, the nonzero terms only) as the
# inverse's dequantization and shift (2) plus, per direction, three digits'
# nonzero terms (haweel: 44 of Ts's 64, 3 x 5.5 per output), the digit sums'
# two adds and the digit split (3 roundings, 2 subtractions): 49; the scaled
# decode (B7, B3's add-only chain) as the dequantization (1), 5.5 nonzero
# terms per output and direction, the + 128 and the floor (2) and the window
# sum (1): 15.  Every kernel here is bound by its bytes at these counts (see
# _bound).
KERNELS = {
    "hp_roundtrip_u8": (_SRC, f"{_REF}:678", 3, 36),
    "hp_encode_u8": (_SRC, f"{_REF}:627", 2, 17),
    "hp_decode_u8": (_SRC, f"{_REF}:651", 2, 19),
    "hp_roundtrip": (_SRC, f"{_REF}:576", 12, 36),
    "hp_roundtrip_f32core": (_SRC, f"{_REF}:445", 12, 68),  # hp_roundtrip's _k_rt_f32_bf
    "hp_dct": (_SRC, f"{_REF}:519", 8, 17),
    "hp_idct": (_SRC, f"{_REF}:550", 8, 17),
    "hp_scaled_decode_u8": (_ISRC, f"{_REF}:824", 1 + 1 / 4, 15),  # timed at fr = fc = 2, out_u8
    "color_split_420_u8": (_CSRC, f"{_CREF}:234", 4.5, 19),
    "color_merge_420_u8": (_CSRC, f"{_CREF}:270", 4.5, 19),
    "color_split_422_u8": (_CSRC, f"{_CREF}:381", 5, 26),
    "color_merge_422_u8": (_CSRC, f"{_CREF}:417", 5, 19),
    "color_split_444_u8": (_CSRC, f"{_CREF}:453", 6, 38),
    "color_merge_444_u8": (_CSRC, f"{_CREF}:477", 6, 19),
    # the u8 colour path's direct instances (no TPU kernel: they replace the
    # grid's edge pad, layout copy, zero pads and stacks around B8-B13)
    "color_split_direct_420": (_CSRC, "none", 4.5, 19),
    "color_merge_direct_420": (_CSRC, "none", 4.5, 19),
    "color_split_direct_422": (_CSRC, "none", 5, 26),
    "color_merge_direct_422": (_CSRC, "none", 5, 19),
    "color_split_direct_444": (_CSRC, "none", 6, 38),
    "color_merge_direct_444": (_CSRC, "none", 6, 19),
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
    "idct_x_c": (_ISRC, f"{_INV}:81", 8, 49),
    # the u8 study variants (kernels.variants): B27-B29 launch B1's kernel,
    # B32-B36 B2's; B30 (E2) and B31 (E3) are one direction of B2's forward
    # (E2 also scales by 12) and the quantizer with the saturation
    "rt_u8_vint": (_SRC, f"{_UV}:40", 3, 36),
    "rt_u8_vbf": (_SRC, f"{_UV}:80", 3, 36),
    "rt_u8_vcs": (_SRC, f"{_UV}:120", 3, 36),
    "enc_nosub": (_SSRC, f"{_EV}:39", 2, 12),
    "enc_nolane": (_SSRC, f"{_EV}:60", 2, 11),
    "enc_xor": (_SRC, f"{_EV}:75", 2, 17),
    "enc_nibble": (_SRC, f"{_EV}:81", 2, 17),
    "enc_truncless": (_SRC, f"{_EV}:119", 2, 17),
    "enc_nibble_truncless": (_SRC, f"{_EV}:143", 2, 17),
    "enc_k256": (_SRC, f"{_EV}:169", 2, 17),
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
# bulk_ab's frames (images x side)
BULK_AB = (64, 512)
# the file path: every --entropy stage is held at this side (auto-exact
# trial-encodes every stage, seconds per stage at 8192^2 on the host)
ENTROPY_SIDE = 2048
ENTROPY_STAGES = ("raw", "spectral", "huffman", "rans", "xz", "banded", "banded:4:rans", "auto-exact")
# `selftest --families` on the card: the golden gate's u8 pass (B1, then B2
# and B3 against it), color420_u8 (direct split, two encodes, two decodes,
# direct merge), f32 (B5, B6), scaled (B7 beside B2 and B3), streamed gray
# (3 bands) and color (1 band: B8, B9), each beside its in-memory call (the
# color one direct)
SELFTEST_LAUNCHES = {"hp_roundtrip_u8": 1, "hp_encode_u8": 12, "hp_decode_u8": 12, "hp_dct": 1, "hp_idct": 1,
                     "hp_scaled_decode_u8": 1, "color_split_420_u8": 1, "color_merge_420_u8": 1,
                     "color_split_direct_420": 2, "color_merge_direct_420": 2}
# the streamed path: a 268-Mpx gray scan in 2048-row bands (the roundtrip
# in 4096-row bands) and an 8192^2 RGB frame
STREAM_SIDE, STREAM_BAND, STREAM_RT_BAND, STREAM_COLOR = 16384, 2048, 4096, 8192
# the archive path: tpudct_torch.studies.partial_at_scale's sizes (a 65536^2
# gray archive and a 32768^2 RGB one in 2048-row bands), each phase a
# subprocess of at most ARCHIVE_TIMEOUT_S
ARCHIVE_SIDE, ARCHIVE_BAND, ARCHIVE_COLOR = 65536, 2048, 32768
ARCHIVE_TIMEOUT_S = 600
# the rings: (side, virtual rank counts on the card)
RING_CASES = ((512, (8,)), (SQUARE, (1, 2, 4, 8)))
# B14's edge cases (copy.cuh): byte counts below one 16-byte vector, around
# the 512-byte chunk grain and 16 and 32 KiB (the bulk copies' tiles), 1001,
# 1 MiB +-1 (many blocks), and a slot of each ring at SQUARE^2; each at
# (src, dst) byte offsets from a 16-byte boundary: the bulk path, a peeled
# head, and the byte path (offsets that differ mod 16)
COPY_EDGE_BYTES = (1, 15, 17, 511, 513, 1001, 16383, 16385, 32767, 32769, 2**20 - 1, 2**20 + 1)
COPY_OFFSETS = ((0, 0), (1, 1), (1, 3))


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
        if line.startswith("nvcc "):
            print("  build:", line)
        elif any(k in line for k in ("Compiling entry", "registers", "spill", "stack frame")):
            print("  ptxas:", line.strip().removeprefix("ptxas info    :").strip())
    _sass_conversions(lib, _build.build_log())


# SASS opcodes of type conversions (16 per clock per SM on sm_90), and MUFU
CONVERSIONS = ("I2F", "I2FP", "F2I", "F2IP", "FRND", "F2F")


def _instance(fn: str):
    """(label, kind) of a SASS or ptxas function name that is an instance of
    B1 (k_rt_u8<core, inv>), B2 (k_encode_u8<core>), B3/B15
    (k_decode_u8<core>), B19 (k_color_encode_420<core>), B16
    (k_ring_forward_decode_color<core>), B20 (k_color_decode_420<core>), B8
    (k_color_split<2, 2, false, kCHW, whole>, also the direct split of a
    planar 4:2:0 frame whose planes end where it does), the other direct
    colour instances (k_color_split<RH, RW, false, kCHW/kHWC, whole or
    not>, k_color_merge<RH, RW, kTrunc, kHWC>), B6
    (k_idct, the block index's conversions alone), B30/B31
    (k_enc_half<dir>), B7 (k_scaled_decode_u8<core>) or B22
    (k_idct_split3), else None; kind is "u8" for B1/B2/B3, "encode420" for
    B19, "strip" for B16/B20, "split" for B8, "direct" for the direct
    instances, "idct" for B6, "enchalf" for B30/B31, "scaled" for B7,
    "split3" for B22."""
    from tpudct_torch.kernels.cores import CORES

    if m := re.search(r"k_rt_u8ILi(\d)ELi(n1|\d)E", fn):  # n1: kDense, -1
        return f"k_rt_u8<{CORES[int(m.group(1))]}, {'dense' if m.group(2) == 'n1' else 'add-only'} inverse>", "u8"
    if m := re.search(r"k_encode_u8ILi(\d)E", fn):
        return f"k_encode_u8<{CORES[int(m.group(1))]}>", "u8"
    if m := re.search(r"k_decode_u8ILi(n1|\d)E", fn):  # n1: kDense, -1
        return f"k_decode_u8<{'dense' if m.group(1) == 'n1' else CORES[int(m.group(1))]}>", "u8"
    if m := re.search(r"k_color_encode_420ILi(\d)E", fn):
        return f"k_color_encode_420<{CORES[int(m.group(1))]}>", "encode420"
    if m := re.search(r"(k_ring_forward_decode_color|k_color_decode_420)ILi(\d)E", fn):
        return f"{m.group(1)}<{CORES[int(m.group(2))]}>", "strip"
    if re.search(r"k_color_splitILi2ELi2ELb0EL[^E]*AddrE1ELb1E", fn):
        return "k_color_split<2, 2, kCHW, whole>", "split"
    if m := re.search(r"k_color_(split|merge)ILi(\d)ELi(\d)E(?!Lb1E).*?AddrE([12])E(Lb1E)?", fn):
        return f"k_color_{m[1]}<{m[2]}, {m[3]}, {('kCHW', 'kHWC')[int(m[4]) - 1]}{', whole' * bool(m[5])}>", "direct"
    if re.search(r"\d+k_idctE", fn):
        return "k_idct", "idct"
    if m := re.search(r"k_scaled_decode_u8ILi(\d)E", fn):
        return f"k_scaled_decode_u8<{CORES[int(m.group(1))]}>", "scaled"
    if re.search(r"\d+k_idct_split3E", fn):
        return "k_idct_split3", "split3"
    if m := re.search(r"k_enc_halfILi(\d)E", fn):
        return f"k_enc_half<{('kEncRows', 'kEncCols')[int(m.group(1))]}>", "enchalf"
    return None


def _ptxas_instances(log: str) -> dict:
    """label -> (registers, spill store bytes, spill load bytes) of each
    instance _instance names, from nvcc's -Xptxas -v output."""
    found, cur = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = _instance(m.group(1))
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            found[cur[0]] = [0, int(m.group(1)), int(m.group(2))]
        elif cur and cur[0] in found and (m := re.search(r"Used (\d+) registers", line)):
            found[cur[0]][0] = int(m.group(1))
            cur = None
    return found


def _sass_conversions(lib, log: str) -> None:
    """Static counts of conversion instructions (and MUFU) in each instance
    of B1, B2, B3 (B15), B7, B16, B19 and B20 (one per integer core; B1 and
    B3 also on the dense inverse), in B22 (whose bf16 rounding is one F2F
    per value and digit), in B8 (k_color_split<2, 2, kCHW, whole>), in the
    14 other direct colour instances and in B30/B31 (k_enc_half, whose round keeps the
    reference's trunc: printed only), from cuobjdump -sass of the built
    library, beside ptxas's registers and spills; for B7 also the
    instructions before its epilogue switch (the decode to the floors,
    shared by its 16 epilogues).  Fails where a B1/B2/B3/B7/B19 instance has
    an FRND, more I2F/I2FP or F2I/F2IP than B6 (k_idct: the block index's
    division, no conversion per pixel), or spills, and where B22 or a
    direct instance spills."""
    from tpudct_torch.kernels._build import nvcc_path
    from tpudct_torch.kernels.cores import CORES

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    regs = _ptxas_instances(log)
    counts = {}
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        found = _instance(fn.split("\n", 1)[0])
        if not found:
            continue
        seq = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9]*)", fn)
        ops = collections.Counter(seq)
        counts[found] = ops
        r, st, ld = regs.get(found[0], ("?", "?", "?"))
        shared = f" ({seq.index('BRX')} before the epilogue switch)" if found[1] == "scaled" and "BRX" in seq else ""
        print(f"  sass: {found[0]}: {sum(ops.values())} instructions{shared}; "
              + ", ".join(f"{k} {ops[k]}" for k in CONVERSIONS + ("MUFU",))
              + f"; ptxas {r} registers, {st} + {ld} bytes spilled")
    kinds = collections.Counter(kind for _, kind in counts)
    want = {"strip": 2 * len(CORES), "u8": 4 * len(CORES) + 1, "encode420": len(CORES), "split": 1, "idct": 1,
            "enchalf": 2, "scaled": len(CORES), "split3": 1, "direct": 14}
    if kinds != want:
        _fail(f"cuobjdump -sass shows instances {dict(kinds)}, not {want}")
    base = next(ops for (_, kind), ops in counts.items() if kind == "idct")
    for (label, kind), ops in counts.items():
        if kind in ("split3", "direct") and (label not in regs or regs[label][1] or regs[label][2]):
            _fail(f"{label}: ptxas reports spills (or no entry): {regs.get(label)}")
        if kind not in ("u8", "encode420", "scaled"):
            continue
        i2f, f2i = ops["I2F"] + ops["I2FP"], ops["F2I"] + ops["F2IP"]
        if ops["FRND"] or i2f > base["I2F"] + base["I2FP"] or f2i > base["F2I"] + base["F2IP"]:
            _fail(f"{label}: {ops['FRND']} FRND, {i2f} I2F and {f2i} F2I in SASS, against k_idct's "
                  f"{base['I2F'] + base['I2FP']} I2F and {base['F2I'] + base['F2IP']} F2I (the block index)")
        if label not in regs or regs[label][1] or regs[label][2]:
            _fail(f"{label}: ptxas reports spills (or no entry): {regs.get(label)}")


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
        e1 = _same(f"hp_roundtrip_u8 coeffs {tag}", c, pc)
        e2 = _same(f"hp_roundtrip_u8 recon {tag}", r, pr)
        ce = hp.hp_encode_u8(x, q_scale=qs, retain_k=rk)
        e3 = _same(f"hp_encode_u8 {tag}", ce, hp.encode_u8_plain(x, q_scale=qs, retain_k=rk))
        _equal(f"hp_encode_u8 {tag} vs hp_roundtrip_u8's coefficients", ce, c)
        rd = hp.hp_decode_u8(ce, q_scale=qs, decode_precision=prec)
        e4 = _same(f"hp_decode_u8 {tag}", rd, hp.decode_u8_plain(ce, q_scale=qs, decode_precision=prec))
        _equal(f"hp_decode_u8 {tag} vs hp_roundtrip_u8's reconstruction", rd, r)
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
        print(f"  {tag}: roundtrip_u8, encode_u8, decode_u8 and the f32 coefficients bit-identical to their "
              f"twins and to each other; f32 recon pixels differing (truncated) {n_f32}")
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
    _compare_color_direct(dev, errs)
    _compare_color_chain(dev)
    _compare_ring(dev, errs)
    _compare_copy_edges(dev, errs)
    _compare_study(dev, errs)
    _compare_strip(dev, errs)
    _compare_u8_cores(dev, errs)
    _compare_scaled_cores(dev, errs)
    _compare_variants(dev, errs)
    _compare_u8_variants(dev, errs)
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
        # B22 also on a wide-range map with +-0 (subnormal digits, digits
        # rounding into the next binade)
        wide = _wide_f32(s, s, seed=s + 15, dev=dev)
        e = _same(f"idct_x c {s}^2 wide-range f32 with +-0", V.idct_x(wide, "c"), V.idct_c_plain(wide))
        errs["idct_x_c"] = max(errs["idct_x_c"], e)
        print(f"  {s}^2: the six color variants and idct_x b, c bit-identical to their twins (c also on a "
              f"wide-range f32 map with +-0); against B8/B9 "
              f"differing: {', '.join(counts)}; idct_x b equals hp_idct, c within "
              f"{float((rc - rb).abs().max()):.2e} of it")


def _saturating_u8(h: int, w: int, seed: int, dev) -> torch.Tensor:
    """u8 noise with all-0, all-255 and alternating 0/255 8x8 blocks in every
    fourth block row: the level shift's extremes, which drive E2 (B30) to
    both ends of int8."""
    x = _noise(h, w, seed=seed, dev=dev)
    alt = ((torch.arange(8)[:, None] + torch.arange(8)) % 2 * 255).to(torch.uint8)
    pats = torch.stack([torch.zeros_like(alt), torch.full_like(alt, 255), alt]).to(dev)
    rows = x.view(h // 8, 8, w // 8, 8)[::4]
    i = torch.arange(rows.shape[0], device=dev)[:, None]
    j = torch.arange(w // 8, device=dev)[None, :]
    rows.copy_(pats[(i + j) % 3].permute(0, 2, 1, 3))
    return x


def _compare_u8_variants(dev, errs: dict) -> None:
    """The u8 study variants (B27-B36) at 512^2 and 8192^2 on u8 noise with
    saturating blocks (_saturating_u8): each bit for bit against its twin;
    B27-B29 (q_scale 1 and 2.5) also equal to hp_roundtrip_u8 (B1), B32-B36
    to hp_encode_u8 (B2) on the same input; E2's saturated entries counted
    (fails unless both -128 and 127 occur)."""
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import variants as V

    for s in COMPARE_SIZES:
        x = _saturating_u8(s, s, seed=s + 15, dev=dev)
        for f in (V.rt_u8_vint, V.rt_u8_vbf, V.rt_u8_vcs):
            for qs in (1.0, 2.5):
                (c, r), (pc, pr) = f(x, q_scale=qs), hp.roundtrip_u8_plain(x, q_scale=qs)
                tag = f"{f.__name__} {s}^2 q_scale={qs}"
                errs[f.__name__] = max(errs[f.__name__], _same(f"{tag} coeffs", c, pc), _same(f"{tag} recon", r, pr))
                c1, r1 = hp.hp_roundtrip_u8(x, q_scale=qs)
                _equal(f"{tag} coeffs vs hp_roundtrip_u8", c, c1)
                _equal(f"{tag} recon vs hp_roundtrip_u8", r, r1)
        b2 = hp.hp_encode_u8(x)
        for kern in (V._k_enc_nosub, V._k_enc_nolane, V._k_enc_xor, V._k_enc_nibble, V._k_enc_truncless,
                     V._k_enc_nibble_truncless, V._k_enc_k256):
            out = V._mk(kern, 128, 512)(x)
            errs[kern.name] = max(errs[kern.name], _same(f"{kern.name} {s}^2", out, kern.plain(x)))
            if kern is V._k_enc_nosub:
                lo, hi = int((out == -128).sum()), int((out == 127).sum())
                if not lo or not hi:
                    _fail(f"enc_nosub {s}^2: saturated entries -128: {lo}, 127: {hi} (both ends expected)")
            elif kern is not V._k_enc_nolane:
                _equal(f"{kern.name} {s}^2 vs hp_encode_u8", out, b2)
        print(f"  {s}^2: rt_u8_vint/vbf/vcs bit-identical to their twins and to hp_roundtrip_u8 (q_scale 1, 2.5); "
              f"enc_nosub, enc_nolane bit-identical to their twins, enc_nosub saturated at -128 on {lo} and at 127 "
              f"on {hi} of {out.numel()} entries; enc_xor, nibble, truncless, nibble_truncless, k256 equal to "
              f"hp_encode_u8 and their twins")


def _zero(label: str, n: int, mx: int, total: int) -> None:
    if n:
        _fail(f"{label}: {n} of {total} entries differ (max {mx})")


def _compare_copy_edges(dev, errs: dict) -> None:
    """B14 (copy.cuh's body) against its twin, bit for bit, on byte runs of
    COPY_EDGE_BYTES and of each ring slot at SQUARE^2, src and dst at each of
    COPY_OFFSETS; the bytes around dst's run must stay as they were."""
    from tpudct_torch.kernels import ring as rk

    slots = tuple(SQUARE * SQUARE // n for n in RING_CASES[-1][1])
    pad = 16
    src = _noise(1, max(COPY_EDGE_BYTES + slots) + pad, seed=15, dev=dev)[0]
    for nbytes in COPY_EDGE_BYTES + slots:
        for so, do in COPY_OFFSETS:
            outs = []
            for fn in (rk.ring_forward, rk.forward_plain):
                buf = torch.full((nbytes + pad,), 0xA5, dtype=torch.uint8, device=dev)
                fn(src[so:so + nbytes], buf[do:do + nbytes])
                outs.append(buf)
            e = _same(f"ring_forward {nbytes} bytes at offsets ({so}, {do}), with the bytes around it", *outs)
            errs["ring_forward"] = max(errs["ring_forward"], e)
    print(f"  ring_forward on {len(COPY_EDGE_BYTES) + len(slots)} byte counts ({', '.join(map(str, COPY_EDGE_BYTES))} "
          f"and the slots {', '.join(map(str, slots))}) at (src, dst) offsets {list(COPY_OFFSETS)}: bit-identical "
          "to its twin, the bytes around each run untouched")


def _compare_study(dev, errs: dict) -> None:
    """The study kernels (B17-B20) against their twins, bit for bit: the
    copies at 512^2, 8192^2 and on a ragged 3x1001 map (a byte tail past the
    16-byte vectors), B17 in place, B18's u8 and int8 outputs; the fused
    encode and decode at 512^2 and 8192^2 at the default config and at
    q_scale 2.5 with retain_k 6; the fused encode also for every integer
    core and cb2011 at both configs, and on saturated RGB (_saturated_rgb),
    where its conversion-free round meets the clip and the .5 ties."""
    from tpudct_torch.kernels import study
    from tpudct_torch.kernels.cores import CORES

    maps = [(f"{s}^2", _noise(s, s, seed=s + 3, dev=dev)) for s in COMPARE_SIZES]
    maps.append(("3x1001", _noise(3, 1001, seed=4, dev=dev)))
    for label, x in maps:
        y = x.clone()
        out = study.u8_copy(y)
        if out.data_ptr() != y.data_ptr():
            _fail(f"u8_copy {label}: the output is not its input (the copy is in place)")
        errs["u8_copy"] = max(errs["u8_copy"], _same(f"u8_copy {label}", out, study.copy_plain(x.clone())))
        _equal(f"u8_copy {label} values", out, x)
        for part, a, b in zip(("u8", "int8"), study.u8_copy2(x.clone()), study.copy2_plain(x.clone())):
            errs["u8_copy2"] = max(errs["u8_copy2"], _same(f"u8_copy2 {label} {part}", a, b))
    inputs = [(f"{s}^2 noise", _rgb_noise(s, s, seed=s + 5, dev=dev)) for s in COMPARE_SIZES]
    inputs += list(_saturated_rgb(dev))
    for label, rgb in inputs:
        for core in CORES + ("cb2011",):
            for kw in ({}, {"q_scale": 2.5, "retain_k": 6}):
                tag = f"{label} {core} {kw or 'default'}"
                planes = study.color_encode_420_u8(rgb, transform=core, **kw)
                for plane, a, b in zip(("y", "cb", "cr"), planes, study.encode_420_plain(rgb, transform=core, **kw)):
                    errs["color_encode_420_u8"] = max(errs["color_encode_420_u8"],
                                                      _same(f"color_encode_420_u8 {tag} {plane}", a, b))
                if label.endswith("noise") and core == "haweel":  # B20 on every core: _compare_strip
                    qs = kw.get("q_scale", 1.0)
                    e = _same(f"color_decode_420_u8 {tag}", study.color_decode_420_u8(*planes, q_scale=qs),
                              study.decode_420_plain(*planes, q_scale=qs))
                    errs["color_decode_420_u8"] = max(errs["color_decode_420_u8"], e)
    print(f"  u8_copy and u8_copy2 at {', '.join(label for label, _ in maps)}, color_encode_420_u8 and "
          f"color_decode_420_u8 at {', '.join(f'{s}^2' for s in COMPARE_SIZES)} (default; q_scale 2.5, "
          f"retain_k 6), color_encode_420_u8 also on {', '.join(label for label, _ in inputs)} for "
          f"{', '.join(CORES)} and cb2011: bit-identical to their twins")


def _saturated_rgb(dev):
    """(label, (3, H, W) u8 RGB) inputs that reach the fused encode's clip
    and .5 ties: 512^2 of all-0, all-255 and pure red, green, blue, cyan,
    magenta and yellow bands, and 4096^2 holding every (r, g, b) triple
    once (so every luma value, and each side of every .5 tie, occurs)."""
    s = COMPARE_SIZES[0]
    colors = torch.tensor([[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255],
                           [0, 255, 255], [255, 0, 255], [255, 255, 0]], dtype=torch.uint8)
    band = torch.arange(s) * len(colors) // s
    yield f"{s}^2 saturated bands", colors[band].T[:, None, :].expand(3, s, s).contiguous().to(dev)
    n = torch.arange(1 << 24, dtype=torch.int32, device=dev).reshape(4096, 4096)
    yield "4096^2 every RGB triple", torch.stack([((n >> sh) & 255).to(torch.uint8) for sh in (16, 8, 0)])


def _i8_noise(shape, seed: int, dev) -> torch.Tensor:
    """Uniform int8 noise: coefficients no encoder gives, so the decode's
    clamps are reached both ways."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(-128, 128, size=shape, dtype=np.int8), device=dev)


def _compare_strip(dev, errs: dict) -> None:
    """B16 and B20 (csrc/strip420.cuh's one body) against their twins, bit
    for bit, on uniform int8 noise planes at 512^2 and 8192^2, for every
    integer core (and the alias cb2011), at the default config and at
    q_scale 2.5 (the config with retain_k 6: retain_k reaches only the
    encoder); B16 on every slot of the ring at n = 1, 2, 4, 8 (a forward on
    every slot but the last, as a rank's last hop; at n = 1 with it)."""
    from tpudct_torch.kernels import ring as rk
    from tpudct_torch.kernels import study
    from tpudct_torch.kernels.cores import CORES
    from tpudct_torch.parallel import chroma_band_pack

    for s in COMPARE_SIZES:
        y = _i8_noise((s, s), s + 21, dev)
        cb, cr = _i8_noise((s // 2, s // 2), s + 22, dev), _i8_noise((s // 2, s // 2), s + 23, dev)
        for core in CORES + ("cb2011",):
            for qs in (1.0, 2.5):
                e = _same(f"color_decode_420_u8 {s}^2 int8 noise {core} q_scale={qs}",
                          study.color_decode_420_u8(y, cb, cr, q_scale=qs, transform=core),
                          study.decode_420_plain(y, cb, cr, q_scale=qs, transform=core))
                errs["color_decode_420_u8"] = max(errs["color_decode_420_u8"], e)
                for n in RING_CASES[-1][1]:
                    br, pack = s // n, chroma_band_pack(cb, cr, n)
                    for r in range(n):
                        ys, ps = y[r * br:(r + 1) * br], pack[r * br:(r + 1) * br]
                        fwd = r < n - 1 or n == 1
                        outs = []
                        for fn in (rk.ring_forward_decode_color, rk.forward_decode_color_plain):
                            fy, fc = (torch.full_like(ys, 7), torch.full_like(ps, 7)) if fwd else (None, None)
                            rgb = torch.full((3, br, s), 9, dtype=torch.uint8, device=dev)
                            fn(ys, ps, fy, fc, rgb, q_scale=qs, transform=core)
                            outs.append((rgb, fy, fc) if fwd else (rgb,))
                        for part, k, p in zip(("rgb", "fy", "fc"), *outs):
                            e = _same(f"ring_forward_decode_color {s}^2 int8 noise {core} q_scale={qs} n={n} "
                                      f"slot {r} {part}", k, p)
                            errs["ring_forward_decode_color"] = max(errs["ring_forward_decode_color"], e)
        print(f"  {s}^2 int8 noise: color_decode_420_u8 and ring_forward_decode_color on every slot at n = "
              f"{', '.join(map(str, RING_CASES[-1][1]))}, for {', '.join(CORES)} and cb2011 at q_scale 1 and "
              "2.5, bit-identical to their twins")


def _compare_u8_cores(dev, errs: dict) -> None:
    """B1, B2, B3 and B15 on every compiled core (csrc/hp_block.cuh), bit
    for bit against their twins, at 512^2 and 8192^2: B1 on u8 noise (with
    all-0, all-255 and +-checkerboard blocks), its coefficients equal to
    B2's; B3 on uniform int8 noise (so the decode's clamps are reached both
    ways), on the butterfly, highest and high tiers; for every integer core
    and the alias cb2011, at (q_scale 1, luma, retain_k None) and (2.5,
    chroma, 6); B15 on every slot of the ring at n = 1, 2, 4, 8 (a forward on
    every slot but the last, and at n = 1)."""
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import ring as rk
    from tpudct_torch.kernels.cores import CORES

    board = ((torch.arange(8)[:, None] + torch.arange(8)[None, :]) % 2 * 255).to(torch.uint8).to(dev)
    for s in COMPARE_SIZES:
        x = _noise(s, s, seed=s + 31, dev=dev)
        for j, block in enumerate((torch.zeros_like(board), torch.full_like(board, 255), board, 255 - board)):
            x[:8, 8 * j:8 * j + 8] = block
        q = _i8_noise((s, s), s + 32, dev)
        for core in CORES + ("cb2011",):
            for qs, table, retain in ((1.0, "luma", None), (2.5, "chroma", 6)):
                cfg = dict(q_scale=qs, q_table=table, transform=core)
                tag = f"{s}^2 {core} q_scale={qs} {table}"
                ce = hp.hp_encode_u8(x, retain_k=retain, **cfg)
                for tier in ("butterfly", "highest", "high"):
                    c, r = hp.hp_roundtrip_u8(x, retain_k=retain, decode_precision=tier, **cfg)
                    pc, pr = hp.roundtrip_u8_plain(x, retain_k=retain, decode_precision=tier, **cfg)
                    e = max(_same(f"hp_roundtrip_u8 coeffs {tag} retain_k={retain} {tier}", c, pc),
                            _same(f"hp_roundtrip_u8 recon {tag} retain_k={retain} {tier}", r, pr))
                    errs["hp_roundtrip_u8"] = max(errs["hp_roundtrip_u8"], e)
                    _equal(f"hp_encode_u8 {tag} retain_k={retain} vs hp_roundtrip_u8's coefficients", ce, c)
                    e = _same(f"hp_decode_u8 int8 noise {tag} {tier}",
                              hp.hp_decode_u8(q, decode_precision=tier, **cfg),
                              hp.decode_u8_plain(q, decode_precision=tier, **cfg))
                    errs["hp_decode_u8"] = max(errs["hp_decode_u8"], e)
                for n in RING_CASES[-1][1]:
                    br = s // n
                    for r in range(n):
                        slot = q[r * br:(r + 1) * br]
                        fwd = r < n - 1 or n == 1
                        outs = []
                        for fn in (rk.ring_forward_decode, rk.forward_decode_plain):
                            f = torch.full_like(slot, 7) if fwd else None
                            rec = torch.full(slot.shape, 9, dtype=torch.uint8, device=dev)
                            fn(slot, f, rec, q_scale=qs, q_table=table, transform=core)
                            outs.append((rec, f) if fwd else (rec,))
                        for part, k, p in zip(("rec", "fwd"), *outs):
                            e = _same(f"ring_forward_decode int8 noise {tag} n={n} slot {r} {part}", k, p)
                            errs["ring_forward_decode"] = max(errs["ring_forward_decode"], e)
        print(f"  {s}^2: hp_roundtrip_u8 (u8 noise, edge blocks; = hp_encode_u8's coefficients) and hp_decode_u8 "
              f"(int8 noise) on the butterfly, highest and high tiers, ring_forward_decode on every slot at n = "
              f"{', '.join(map(str, RING_CASES[-1][1]))}, for {', '.join(CORES)} and cb2011 at (q_scale 1, luma) "
              "and (2.5, chroma, retain_k 6): bit-identical to their twins")


def _compare_scaled_cores(dev, errs: dict) -> None:
    """B7 on every compiled core (one instance each) and the alias cb2011,
    at 512^2 and 8192^2, on uniform int8 noise with an all -128 and an all
    127 block (so both clamps of the decode are reached), at (q_scale 1,
    luma) and (2.5, chroma): every (fr, fc) of {1, 2, 4, 8}^2, f32 and u8
    out, bit for bit against its twin and against box_pool_u8 of
    hp_decode_u8's output."""
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels.cores import CORES
    from tpudct_torch.ops.scaled import box_pool_u8
    from tpudct_torch.ops.transform import to_uint8

    factors = (1, 2, 4, 8)
    for s in COMPARE_SIZES:
        q = _i8_noise((s, s), s + 33, dev)
        q[:8, :8], q[:8, 8:16] = -128, 127
        for core in CORES + ("cb2011",):
            for qs, table in ((1.0, "luma"), (2.5, "chroma")):
                cfg = dict(q_scale=qs, q_table=table, transform=core)
                dec = hp.hp_decode_u8(q, **cfg)
                if not ((dec == 0).any() and (dec == 255).any()):
                    _fail(f"{s}^2 {core} q_scale={qs}: the int8 noise reaches neither clamp")
                for fr in factors:
                    for fc in factors:
                        pooled = box_pool_u8(dec, fr, fc)
                        for out_u8 in (False, True):
                            tag = f"hp_scaled_decode_u8 int8 noise {s}^2 {core} q_scale={qs} {table} ({fr}, {fc}) " \
                                  f"out_u8={out_u8}"
                            out = hp.hp_scaled_decode_u8(q, fr, fc, out_u8=out_u8, **cfg)
                            e = _same(tag, out, hp.scaled_decode_u8_plain(q, fr, fc, out_u8=out_u8, **cfg))
                            errs["hp_scaled_decode_u8"] = max(errs["hp_scaled_decode_u8"], e)
                            _same(f"{tag} vs box_pool_u8(hp_decode_u8)", out, to_uint8(pooled) if out_u8 else pooled)
        print(f"  {s}^2 int8 noise: hp_scaled_decode_u8 at every (fr, fc) of {{1, 2, 4, 8}}^2, f32 and u8 out, for "
              f"{', '.join(CORES)} and cb2011 at (q_scale 1, luma) and (2.5, chroma): bit-identical to its twin and "
              "to box_pool_u8(hp_decode_u8)")


def _wide_f32(h: int, w: int, seed: int, dev) -> torch.Tensor:
    """f32 noise over a wide range of magnitudes, 2^-149 (subnormal) to
    2^100 (far enough below bf16's largest finite value that every digit
    and sum of B22 stays finite), either sign, with +0.0 and -0.0 mixed in."""
    rng = np.random.default_rng(seed)
    v = rng.choice([-1.0, 1.0], (h, w)) * rng.uniform(1.0, 2.0, (h, w)) * np.exp2(rng.integers(-149, 101, (h, w)))
    v[rng.random((h, w)) < 0.1] = 0.0
    v[rng.random((h, w)) < 0.1] = -0.0
    return torch.as_tensor(v.astype(np.float32), device=dev)


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


def _parent_color_chain(p, cfg, rgb, mode: str) -> tuple:
    """(planes, RGB) of the u8 colour roundtrip as it ran on the reference's
    (64, 256) grid: the frame to planes (one copy where interleaved), the
    edge pad to the grid, B8/B10/B12, hp_encode_u8 on the grid planes and
    the crops; the zero pads back to the grid, the chroma stack, hp_decode_u8,
    B9/B11/B13 and the crop."""
    import torch.nn.functional as F
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.models import color as mc
    from tpudct_torch.ops.padding import pad_to_kernel, padded_shape

    planar = rgb.movedim(-1, 0).contiguous() if rgb.shape[-1] == 3 else rgb
    h, w = planar.shape[1:]
    x, _ = pad_to_kernel(planar, 64, 256)
    y, cb, cr = getattr(ck, f"color_split_{mode}_u8")(x)
    cy = p.encode_u8(y, mc._luma_cfg(cfg))
    cc = p.encode_u8(torch.cat([cb, cr]), mc._chroma_cfg(cfg))
    ph = cb.shape[0]
    y8 = padded_shape(h, w)
    c8 = padded_shape(*mc._chroma_plane_shape(False if mode == "444" else mode, h, w))
    planes = {"y": cy[: y8[0], : y8[1]], "cb": cc[:ph][: c8[0], : c8[1]], "cr": cc[ph:][: c8[0], : c8[1]]}

    def zpad(c, a, b):
        return F.pad(c, (0, b - c.shape[1], 0, a - c.shape[0]))

    yd = p.decode_u8(zpad(planes["y"], *x.shape[1:]), mc._luma_cfg(cfg))
    cd = p.decode_u8(torch.cat([zpad(planes[k], *cb.shape) for k in ("cb", "cr")]), mc._chroma_cfg(cfg))
    return planes, getattr(ck, f"color_merge_{mode}_u8")(yd, cd[:ph], cd[ph:]).movedim(0, -1)[:h, :w]


def _compare_color_direct(dev, errs: dict) -> None:
    """The direct instances against their twins, and the u8 colour
    roundtrip (roundtrip_color_u8: the direct split, hp_encode_u8 and
    hp_decode_u8 at the planes' shapes, the direct merge) against the
    reference grid's chain, planes and RGB bit for bit: the camera frame, a
    ragged 3001x4003 frame and SQUARE^2, interleaved and planar, every
    mode."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.models import color as mc

    p, cfg = get_pipeline("hp"), CodecConfig()
    cam = torch.as_tensor(_camera_rgb(*COLOR_FRAME), device=dev)
    frames = [("x".join(map(str, COLOR_FRAME)) + " camera frame", cam),
              ("3001x4003 ragged frame", _rgb_noise(3001, 4003, seed=61, dev=dev).movedim(0, -1).contiguous()),
              (f"{SQUARE}^2", _rgb_noise(SQUARE, SQUARE, seed=62, dev=dev).movedim(0, -1).contiguous())]
    for label, hwc in frames:
        h, w = hwc.shape[:2]
        for layout, x in (("interleaved", hwc), ("planar", hwc.movedim(-1, 0).contiguous())):
            for mode in COLOR_MODES:
                split, merge = f"color_split_direct_{mode}", f"color_merge_direct_{mode}"
                tag = f"{label} {layout} {mode}"
                y, cc = ck.color_split_direct_u8(x, mode, layout)
                ty, tcc = ck.split_direct_plain(x, mode, layout)
                errs[split] = max(errs[split], _same(f"{split} {tag} y", y, ty), _same(f"{split} {tag} cc", cc, tcc))
                half = cc.shape[0] // 2
                out = ck.color_merge_direct_u8(y, cc[:half], cc[half:], h, w, mode)
                e = _same(f"{merge} {tag}", out, ck.merge_direct_plain(y, cc[:half], cc[half:], h, w, mode))
                errs[merge] = max(errs[merge], e)
                planes, _meta, rec = mc.roundtrip_color_u8(p, x, cfg, subsample=False if mode == "444" else mode)
                want, want_rec = _parent_color_chain(p, cfg, x, mode)
                for k in ("y", "cb", "cr"):
                    _equal(f"roundtrip_color_u8 {tag} plane {k} vs the grid's chain", planes[k], want[k])
                _equal(f"roundtrip_color_u8 {tag} RGB vs the grid's chain", rec, want_rec.contiguous())
        print(f"  {label}: the direct split and merge bit-identical to their twins, and roundtrip_color_u8's "
              f"planes and RGB to the grid's chain, interleaved and planar, 4:2:0, 4:2:2 and 4:4:4")


def _launch_counts() -> dict:
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp

    return {**ck.LAUNCHES, **hp.LAUNCHES}


def _launch_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}


def _wrapper_chain(p, cfg, x, layout: str, mode: str) -> tuple:
    """(planes, RGB, launches) of the u8 colour roundtrip through the six
    per-kernel wrappers, as ``models/color.py`` ran it before its two chain
    calls: the direct split, ``hp_encode_u8`` on luma and on the stacked
    chroma, ``hp_decode_u8`` on each, the direct merge."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.models import color as mc

    h, w = x.shape[:2] if layout == "interleaved" else x.shape[1:]
    before = _launch_counts()
    y, cc = ck.color_split_direct_u8(x, mode, layout)
    cy = p._encode_u8_plane(y, mc._luma_cfg(cfg))
    ccq = p._encode_u8_plane(cc, mc._chroma_cfg(cfg))
    half = ccq.shape[0] // 2
    yd = p._decode_u8_plane(cy, mc._luma_cfg(cfg))
    cd = p._decode_u8_plane(ccq, mc._chroma_cfg(cfg))
    rgb = ck.color_merge_direct_u8(yd, cd[:half], cd[half:], h, w, mode)
    return {"y": cy, "cb": ccq[:half], "cr": ccq[half:]}, rgb, _launch_delta(before)


def _offset_frame(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` that starts one byte into its allocation (the
    direct kernels' byte accesses, ``align`` 1)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _compare_color_chain(dev) -> None:
    """The u8 colour path's two chain calls (``color_encode_u8_chain_launch``,
    ``color_decode_u8_chain_launch``: ``roundtrip_color_u8``,
    ``roundtrip_color_auto``, ``encode_color_u8`` and ``decode_color_u8`` on a
    card) against the six-wrapper chain: planes and RGB bit for bit and
    the same ``LAUNCHES`` deltas, on the camera frame, a ragged 4031x3023
    frame and the camera frame at a 1-byte offset, interleaved and planar,
    4:2:0, 4:2:2 and 4:4:4; and planes from separate buffers through
    ``decode_color_u8`` (the chroma stacked by one copy)."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.models import color as mc

    p, cfg = get_pipeline("hp"), CodecConfig()
    cam = torch.as_tensor(_camera_rgb(*COLOR_FRAME), device=dev)
    frames = [("x".join(map(str, COLOR_FRAME)) + " camera frame", cam, False),
              ("4031x3023 ragged frame", _rgb_noise(4031, 3023, seed=63, dev=dev).movedim(0, -1).contiguous(),
               False),
              ("camera frame at a 1-byte offset", cam, True)]
    n = 0
    for label, hwc, offset in frames:
        for layout, x in (("interleaved", hwc), ("planar", hwc.movedim(-1, 0).contiguous())):
            if offset:
                x = _offset_frame(x)
                if x.data_ptr() % 16 == 0:
                    _fail(f"{label}: the frame is 16-byte aligned")
            for mode in COLOR_MODES:
                sub = False if mode == "444" else mode
                tag = f"{label} {layout} {mode}"
                want, want_rgb, want_n = _wrapper_chain(p, cfg, x, layout, mode)
                before = _launch_counts()
                planes, meta, rgb = mc.roundtrip_color_u8(p, x, cfg, subsample=sub)
                got_n = _launch_delta(before)
                if got_n != want_n:
                    _fail(f"roundtrip_color_u8 {tag}: launches {got_n}, the wrappers' {want_n}")
                auto = mc.roundtrip_color_auto(p, x, cfg, subsample=sub)
                enc, meta2 = mc.encode_color_u8(p, x, cfg, subsample=sub)
                apart = {k: v.clone() for k, v in planes.items()}
                for k in mc.PLANES:
                    _equal(f"roundtrip_color_u8 {tag} plane {k} vs the wrappers' chain", planes[k], want[k])
                    _equal(f"roundtrip_color_auto {tag} plane {k} vs the wrappers' chain", auto[0][k], want[k])
                    _equal(f"encode_color_u8 {tag} plane {k} vs the wrappers' chain", enc[k], want[k])
                for what, got in (("roundtrip_color_u8", rgb), ("roundtrip_color_auto", auto[2]),
                                  ("decode_color_u8", mc.decode_color_u8(p, enc, meta2, cfg)),
                                  ("decode_color_u8 of separate planes", mc.decode_color_u8(p, apart, meta, cfg))):
                    _equal(f"{what} {tag} RGB vs the wrappers' chain", got, want_rgb)
                n += 1
        print(f"  {label}: the two chain calls' planes and RGB bit-identical to the six wrappers' chain, "
              f"the same launches, interleaved and planar, 4:2:0, 4:2:2 and 4:4:4")
    torch.cuda.synchronize()
    print(f"  colour chains: {n} of {n} frame, layout and mode cases bit-identical to the wrappers' chain")


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
        e = _same(f"hp_encode_u8 {tag}", c, hp.encode_u8_plain(x, q_table=table))
        errs["hp_encode_u8"] = max(errs["hp_encode_u8"], e)
        e = _same(f"hp_decode_u8 {tag}", hp.hp_decode_u8(c, q_table=table), hp.decode_u8_plain(c, q_table=table))
        errs["hp_decode_u8"] = max(errs["hp_decode_u8"], e)
        counts.append(f"{plane} {tuple(x.shape)}")
        if scaled and table == "chroma":
            for fr in (1, 2):
                for out_u8 in (False, True):
                    s = hp.hp_scaled_decode_u8(c, fr, fr, q_table=table, out_u8=out_u8)
                    e = _same(f"hp_scaled_decode_u8 {tag} ({fr}, {fr}) out_u8={out_u8}", s,
                              hp.scaled_decode_u8_plain(c, fr, fr, q_table=table, out_u8=out_u8))
                    errs["hp_scaled_decode_u8"] = max(errs["hp_scaled_decode_u8"], e)
            counts.append("hp_scaled_decode_u8 (1, 1), (2, 2) (f32, u8) bit-identical")
    print(f"    {mode}: hp_encode_u8 and hp_decode_u8 bit-identical on {'; '.join(counts)}")


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
        return {f"color_split_direct_{mode}": 1, "hp_encode_u8": 2, "hp_decode_u8": 2,
                f"color_merge_direct_{mode}": 1}

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
    # the bulk helpers stack frames on the (64, 256) grid: B8-B13, every mode
    for mode in COLOR_MODES:
        sub = False if mode == "444" else mode
        label = f"{n_img}x{side}^2 encode_color_batch_auto {mode}"
        enc = step(label, {f"color_split_{mode}_u8": 1, "hp_encode_u8": 2},
                   lambda: mc.encode_color_batch_auto(p, frames, cfg, subsample=sub))
        label = f"{n_img}x{side}^2 decode_color_batch_auto {mode}"
        dec = step(label, {"hp_decode_u8": 2, f"color_merge_{mode}_u8": 1},
                   lambda: mc.decode_color_batch_auto(p, [(pl, m, cfg) for pl, m in enc]))
        if len(dec) != n_img or any(r.shape != (side, side, 3) for r in dec):
            _fail(f"{label}: {len(dec)} frames of shapes {sorted({r.shape for r in dec})}")
        _color_band_check(f"{n_img}x{side}^2 bulk {mode} frame 0", frames[0], enc[0][0], dec[0], sub, cfg)
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
# decode ring (B2) and the color roundtrip feeding the color ring (the
# direct split, 2 B2, 2 B3, the direct merge); both rings; B6 per rank in
# sharded_idct, on the full and on the progressive map; B1 per rank in each
# of the streamed sharded roundtrip's three host bands and one for the whole
# image it is held against; B5 per rank on the luma of the sharded color
# encode feeding save_color_sharded; the streamed color codec's two bands
# (B8 and 2 B2, then 2 B3 and B9 each) and the in-memory pass it is held
# against (the direct split, 2 B2, 2 B3, the direct merge)
DRYRUN_LAUNCHES = {
    "hp_roundtrip": 24, "hp_roundtrip_u8": 33, "hp_encode_u8": 9, "hp_decode_u8": 8, "hp_idct": 16,
    "hp_dct": 8, "color_split_420_u8": 2, "color_merge_420_u8": 2,
    "color_split_direct_420": 2, "color_merge_direct_420": 2,
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
    """The nine study drivers at SQUARE^2, the counters set to 0 just before
    and read just after; each driver moves exactly its counters (one
    warm-up and REPS timed calls per measurement, plus its checks)."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import study
    from tpudct_torch.kernels import variants as V
    from tpudct_torch.studies import color_fused_ab, color_variants, color_variants2, inv_formulations, u8_perf

    from tpudct_torch.kernels import ring as rk

    _phase(6, "study path")
    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES, study.LAUNCHES, V.LAUNCHES, rk.LAUNCHES)
    hp.reset_launches()
    ck.reset_launches()
    study.reset_launches()
    V.reset_launches()
    rk.reset_launches()
    k = 1 + u8_perf.REPS
    floors = step(f"{SQUARE}^2 studies.u8_perf.main",
                  {"u8_copy": k, "u8_copy2": k, "hp_encode_u8": k + 1, "hp_decode_u8": k, "hp_roundtrip_u8": k},
                  lambda: u8_perf.main(SQUARE, dev))
    # the fused and composed encodes and decodes once for the counts, then
    # six timed stages: each kernel runs in two of them
    n = 1 + 2 * (1 + color_fused_ab.REPS)
    fused = step(f"{SQUARE}^2 studies.color_fused_ab.main",
                 {"color_encode_420_u8": n, "color_decode_420_u8": n, "color_split_direct_420": n,
                  "hp_encode_u8": 2 * n, "hp_decode_u8": 2 * n, "color_merge_direct_420": n},
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
    _u8_variant_studies(step, dev)
    _other_studies(step, dev)
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


def _u8_variant_studies(step, dev) -> None:
    """The u8 variant drivers at SQUARE^2 through ``step``: u8_variants and
    enc_variants in every mode, rt_split_ab and scaled_ab; each moves
    exactly its counters (checks once, each timing one warm-up and REPS
    calls, each A/B TRIALS turns) and reports 0 differences."""
    from tpudct_torch.studies import enc_variants, rt_split_ab, scaled_ab, u8_variants

    k, t = 1 + u8_variants.REPS, u8_variants.TRIALS
    expected = {"int": {"hp_roundtrip_u8": 1, "rt_u8_vint": 1 + k},
                "bf": {"hp_roundtrip_u8": 1, "rt_u8_vbf": 1 + 2 * k},
                "abbf": {"hp_roundtrip_u8": t * k, "rt_u8_vbf": t * k},
                "cs": {"hp_roundtrip_u8": 1 + t * k, "rt_u8_vcs": 1 + t * k}}
    outs = [step(f"{SQUARE}^2 studies.u8_variants.main {w}", expected[w],
                 lambda w=w: u8_variants.main(SQUARE, w, dev)) for w in u8_variants.MODES]
    k = 1 + enc_variants.REPS
    expected = {"a": {"enc_nosub": k}, "b": {"enc_nolane": k, "enc_xor": 1 + k, "hp_encode_u8": 1},
                "d": {"hp_encode_u8": 3 + k, "enc_truncless": 1 + k, "enc_nibble": 1 + k,
                      "enc_nibble_truncless": 1 + k},
                "e": {"hp_encode_u8": 1 + k, "enc_k256": 1 + k}}
    outs += [step(f"{SQUARE}^2 studies.enc_variants.main {w}", expected[w],
                  lambda w=w: enc_variants.main(w, SQUARE, dev)) for w in enc_variants.MODES]
    n = 1 + 3 * (1 + rt_split_ab.REPS)
    outs.append(step(f"{SQUARE}^2 studies.rt_split_ab.main (3 trials)",
                     {"hp_roundtrip_u8": n, "hp_encode_u8": n, "hp_decode_u8": n},
                     lambda: rt_split_ab.main(SQUARE, 3, dev)))
    n = 2 * (2 + scaled_ab.REPS)
    outs.append(step(f"{SQUARE}^2 studies.scaled_ab.main", {"hp_encode_u8": 1, "hp_scaled_decode_u8": n,
                                                            "hp_decode_u8": n}, lambda: scaled_ab.main(SQUARE, dev)))
    names = [f"u8_variants {w}" for w in u8_variants.MODES] + [f"enc_variants {w}" for w in enc_variants.MODES]
    counts = {f"{name} {key}": v for name, o in zip(names + ["rt_split_ab", "scaled_ab"], outs)
              for key, v in o.items() if key.endswith("differ")}
    if any(counts.values()):
        _fail(f"the u8 variant studies report differences: {counts}")
    print(f"  u8 variant studies' checks: {json.dumps(counts)}")


def _other_studies(step, dev) -> None:
    """The other five drivers through ``step``: timing_xval at SQUARE^2 (B1
    in device_time_ms, one K_BIG chain and a chain per K, WALL_REPS times
    each), bulk_ab at BULK_AB (both arms' warm-ups, REPS walls each, the
    spot-check), onchip_recheck (the 512^2 gate, the one-rank decode ring
    at 512^2 and 8192^2, the f32 color roundtrip timed), and the host-only
    deadzone_study and rans_interleave_ab (no launch); each moves exactly
    its counters."""
    from tpudct_torch.studies import bulk_ab, deadzone_study, onchip_recheck, rans_interleave_ab, timing_xval

    t = timing_xval
    xval = step(f"{SQUARE}^2 studies.timing_xval.main",
                {"hp_roundtrip_u8": 1 + t.REPS + t.WALL_REPS * (t.K_BIG + sum(t.KS))},
                lambda: timing_xval.main(SQUARE, dev))
    print(f"  B1 at {SQUARE}^2: device_time_ms {xval['device_time_ms']:.4f} ms, amortized K={t.K_BIG} "
          f"{xval['amortized_ms']:.4f} ms ({xval['amortized_over_timer']:.3f}x), fit {xval['fit_ms']:.4f} ms "
          f"({xval['fit_over_timer']:.3f}x, intercept {xval['intercept_ms']:.3f} ms, R^2 {xval['r2']:.6f})")
    n, side = BULK_AB
    k = bulk_ab.REPS * (n + 1)
    bulk = step(f"studies.bulk_ab.main {n}x{side}^2",
                {"hp_encode_u8": 2 + k + 1 + bulk_ab.CHECKED, "hp_decode_u8": 2 + k},
                lambda: bulk_ab.main(n, side, dev))
    rc = step("studies.onchip_recheck.main",
              {"hp_roundtrip_u8": 1, "hp_encode_u8": 1 + len(onchip_recheck.RING_SIDES),
               "hp_decode_u8": 1 + len(onchip_recheck.RING_SIDES), "ring_forward": len(onchip_recheck.RING_SIDES),
               "ring_forward_decode": len(onchip_recheck.RING_SIDES), "hp_dct": 2 * (1 + onchip_recheck.REPS),
               "hp_idct": 2 * (1 + onchip_recheck.REPS)},
              lambda: onchip_recheck.main(dev))
    if rc:
        _fail(f"studies.onchip_recheck.main returned {rc}")
    step("studies.deadzone_study.main (host only)", {}, deadzone_study.main)
    step("studies.rans_interleave_ab.main (host only)", {}, rans_interleave_ab.main)
    print(f"  bulk_ab: encode per-image {bulk['encode_per_image_s']:.4f} s, stacked {bulk['encode_stacked_s']:.4f} s; "
          f"decode per-image {bulk['decode_per_image_s']:.4f} s, stacked {bulk['decode_stacked_s']:.4f} s")


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
    color = {"color_split_direct_420": k, "hp_encode_u8": 2 * k, "hp_decode_u8": 2 * k,
             "color_merge_direct_420": k}
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


def _twin_color_planes(rgb: np.ndarray, mode: str, dev) -> tuple:
    """(planes, meta) of models.color.encode_color_u8 on an (H, W, 3) u8
    frame, every kernel replaced by its plain twin, on the card."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.models import color as mc
    from tpudct_torch.ops.padding import pad_to_kernel, padded_shape

    h, w = rgb.shape[:2]
    x, _ = pad_to_kernel(torch.as_tensor(rgb, device=dev).movedim(-1, 0).contiguous(), *mc._GRID)
    y, cb, cr = ck.split_plain(x, mode)
    cy = hp.encode_u8_plain(y)
    cc = hp.encode_u8_plain(torch.cat([cb, cr]), q_table="chroma")
    sub = mc.normalize_subsample(mode)
    ch, cw = mc._chroma_plane_shape(sub, h, w)
    (yh, yw), (c8h, c8w) = padded_shape(h, w), padded_shape(ch, cw)
    ph = cb.shape[0]
    planes = {"y": cy[:yh, :yw], "cb": cc[:ph][:c8h, :c8w], "cr": cc[ph:][:c8h, :c8w]}
    meta = {"orig_shape": (h, w), "chroma_shape": (ch, cw), "subsample": sub}
    return {k: v.cpu().numpy() for k, v in planes.items()}, meta


def phase_file_path(dev, card: str) -> dict:
    """The file path (python -m tpudct_torch encode/inspect/decode/run) in
    process, its counters set to 0 just before it and read just after; each
    CLI call moves exactly its counters.  Then the bytes against the plain
    twins' coefficients, the rasters against the library's decoders, and
    every entropy stage at ENTROPY_SIDE^2 through both decoders."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.models import color as mc
    from tpudct_torch.models.dispatch import decode_gray_auto, decode_gray_scaled_auto
    from tpudct_torch.utils import native, serialize

    _phase(6, "file path")
    cfg, p = CodecConfig(), get_pipeline("hp")
    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES)
    print("  host libraries: entropy", native.build("entropy").name,
          "| JPEG", "built" if native.jpeg_library() is not None else "unavailable (no libjpeg)")
    sq, cam = f"{SQUARE}^2", "x".join(map(str, COLOR_FRAME))
    gray = _camera_frame(SQUARE, SQUARE, seed=42)
    rgb = _camera_rgb(*COLOR_FRAME)
    with tempfile.TemporaryDirectory() as tmp:
        f = {k: os.path.join(tmp, k) for k in (
            "gray.npy", "rgb.npy", "g.tdc", "g.npy", "run.npy", "run.tdc", "s.npy", "c.tdcc", "c.npy", "c444.tdcc")}
        np.save(f["gray.npy"], gray)
        np.save(f["rgb.npy"], rgb)

        def cli_step(label, expected, argv) -> list:
            return _cli_records(step, card, label, expected, argv)

        hp.reset_launches()
        ck.reset_launches()
        t0 = time.perf_counter()
        enc = cli_step(f"{sq} encode --entropy auto", {"hp_encode_u8": 1},
                       ["encode", "--entropy", "auto", f["gray.npy"], f["g.tdc"]])
        ins = cli_step(f"{sq} inspect", {}, ["inspect", f["g.tdc"]])
        cli_step(f"{sq} decode", {"hp_decode_u8": 1}, ["decode", f["g.tdc"], f["g.npy"]])
        cli_step(f"{sq} run --coeffs", {"hp_roundtrip_u8": 1},
                 ["run", f["gray.npy"], f["run.npy"], "--coeffs", f["run.tdc"]])
        cli_step(f"{sq} decode --scale 2/8", {"hp_scaled_decode_u8": 1},
                 ["decode", "--scale", "2/8", f["g.tdc"], f["s.npy"]])
        cenc = cli_step(f"{cam} encode --color", {"color_split_direct_420": 1, "hp_encode_u8": 2},
                        ["encode", "--color", f["rgb.npy"], f["c.tdcc"]])
        cli_step(f"{cam} decode .tdcc", {"hp_decode_u8": 2, "color_merge_direct_420": 1},
                        ["decode", f["c.tdcc"], f["c.npy"]])
        cli_step(f"{cam} encode --color --chroma 444", {"color_split_direct_444": 1, "hp_encode_u8": 2},
                 ["encode", "--color", "--chroma", "444", f["rgb.npy"], f["c444.tdcc"]])
        launches = counts()
        print(f"  file path: {time.perf_counter() - t0:.1f} s for the CLI calls; launches:", json.dumps(launches))
        # the files and rasters against the plain twins' coefficients (these
        # checks' launches come after the counts were read)
        data = {k: open(f[k], "rb").read() for k in ("g.tdc", "run.tdc", "c.tdcc", "c444.tdcc")}
        x = torch.as_tensor(gray, device=dev)
        c_twin = hp.encode_u8_plain(x)
        want = serialize.coefficients_to_bytes(c_twin.cpu().numpy(), 1.0, None, orig_shape=(SQUARE, SQUARE))
        if data["g.tdc"] != want or data["run.tdc"] != want:
            _fail(f"{sq}: the .tdc files ({len(data['g.tdc'])}, {len(data['run.tdc'])} bytes) differ from "
                  f"coefficients_to_bytes of the twin's coefficients ({len(want)} bytes)")
        if enc[0]["bytes"] != len(want) or ins[0]["codec"] != serialize.inspect_stream(want)["codec"]:
            _fail(f"{sq}: records {enc}, {ins}")
        shape = (SQUARE, SQUARE)
        for label, path, ref in (
            ("decode", "g.npy", decode_gray_auto(p, c_twin, cfg, shape)),
            ("run", "run.npy", decode_gray_auto(p, c_twin, cfg, shape)),
            ("decode --scale 2/8", "s.npy", decode_gray_scaled_auto(p, c_twin, cfg, shape, 2)),
        ):
            if not np.array_equal(np.load(f[path]), ref):
                _fail(f"{sq} {label}: the raster differs from the library's decode of the twin's coefficients")
        print(f"  {sq}: .tdc ({ins[0]['codec']}, {len(want)} bytes) = coefficients_to_bytes of the twin's "
              f"coefficients; run --coeffs = encode; decode, run and --scale 2/8 rasters = "
              f"decode_gray_auto / decode_gray_scaled_auto of them")
        for key, mode in (("c.tdcc", "420"), ("c444.tdcc", "444")):
            planes, meta = _twin_color_planes(rgb, mode, dev)
            want = serialize.color_to_bytes(planes, meta, 1.0, None, "haweel")
            if data[key] != want:
                _fail(f"{cam} {mode}: the .tdcc ({len(data[key])} bytes) differs from color_to_bytes of the "
                      f"twins' planes ({len(want)} bytes)")
            if mode == "420":
                ref = mc.decode_color_auto(p, planes, meta, cfg, device=dev).cpu().numpy()
                if cenc[0]["bytes"] != len(want) or not np.array_equal(np.load(f["c.npy"]), ref):
                    _fail(f"{cam}: the decoded raster differs from decode_color_auto of the twins' planes")
            print(f"  {cam} {mode}: .tdcc ({len(want)} bytes) = color_to_bytes of the twins' planes"
                  + ("; decoded raster = decode_color_auto of them" if mode == "420" else ""))
    _entropy_stages(c_twin[:ENTROPY_SIDE, :ENTROPY_SIDE].cpu().numpy(), card)
    return launches


def _cli_records(step, card: str, label: str, expected: dict, argv: list, rc: int = 0) -> list:
    """tpudct_torch.cli.main(argv) in process as one step (exactly the
    counters in `expected` move); its output printed, its JSON records
    returned.  Fails unless it exits with `rc`."""
    from tpudct_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = step(label, expected, lambda: cli.main(argv))
    text = out.getvalue()
    for line in text.splitlines():
        print(f"    {line}" + (f" [{card}]" if line.startswith("{") else ""))
    if got != rc:
        _fail(f"{label}: exit code {got}, expected {rc}\n{text}")
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _stacked_launches(names, chunk: int, kind) -> int:
    """Stacked launches of a bulk verb over `names`: one per kind (a padded
    width) in each chunk of the sorted names."""
    names = sorted(names)
    return sum(len({kind(n) for n in names[i : i + chunk]}) for i in range(0, len(names), chunk))


def _threaded(fn, items) -> list:
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(fn, items))


def phase_bulk_path(dev, card: str) -> dict:
    """The bulk and measuring verbs (python -m tpudct_torch batch, unbatch,
    bench, sweep, table, curve, scale, selftest, profile, compare, info) in
    process on .npy files in a temporary directory, the counters set to 0
    just before and read just after; each call moves exactly its counters.
    Then every bulk output against the per-file call: each .tdc/.tdcc
    against coefficients_to_bytes / color_to_bytes of encode_gray_auto /
    encode_color_auto of that file alone, each decoded raster against
    decode_gray_auto, decode_gray_scaled_auto, decode_color_auto and
    decode_color_scaled of its file's coefficients, the streamed branches
    (streaming.STREAM_PIXELS patched down) against encode_gray_streamed_bytes,
    decode_gray_streamed and decode_color_streamed."""
    import shutil

    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.models import color as mc
    from tpudct_torch.utils import streaming as st

    _phase(6, "bulk and measuring path")
    t_phase = time.perf_counter()
    cfg, p = CodecConfig(), get_pipeline("hp")
    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES)
    n_img, side = BATCH
    k = 1 + BENCH_REPS
    # the bulk verbs' chunks: batch --decode-threads 16 takes 64 files at a
    # time, unbatch 4 per host thread (cpu_count, at most 16)
    unbatch_chunk = 4 * min(os.cpu_count() or 4, 16)
    width = lambda name: "cam" if name.startswith("cam") else "frame"  # noqa: E731
    sq, cam, ccam = f"{SQUARE}^2", "x".join(map(str, FRAME)), "x".join(map(str, COLOR_FRAME))
    with tempfile.TemporaryDirectory() as tmp:
        d = {k_: os.path.join(tmp, k_) for k_ in ("gray", "rgb", "big", "tdc", "tdcc", "stream", "pix", "pix4",
                                                  "cpix", "cpix4", "spix", "trace")}
        for k_ in ("gray", "rgb", "big"):
            os.mkdir(d[k_])
        gray = {f"f{i:02d}.npy": _camera_frame(side, side, seed=100 + i) for i in range(n_img)}
        gray["cam.npy"] = _camera_frame(*FRAME, seed=7)
        rgb = {f"f{i:02d}.npy": np.stack([_camera_frame(side, side, seed=200 + 3 * i + c) for c in range(3)], -1)
               for i in range(8)}
        rgb["cam.npy"] = _camera_rgb(*COLOR_FRAME)
        for name, img in gray.items():
            np.save(os.path.join(d["gray"], name), img)
        for name, img in rgb.items():
            np.save(os.path.join(d["rgb"], name), img)
        with open(os.path.join(d["gray"], "bad.npy"), "wb") as f:
            f.write(b"\x93NUMPY not a raster")
        big = _camera_frame(SQUARE, SQUARE, seed=42)
        np.save(os.path.join(d["big"], "big.npy"), big)
        hp.reset_launches()
        ck.reset_launches()
        t0 = time.perf_counter()
        n_gray = _stacked_launches(gray, 64, width)
        rec = _cli_records(step, card, f"batch {n_img}x{side}^2 + {cam} + a corrupt .npy", {"hp_encode_u8": n_gray},
                           ["batch", "--decode-threads", "16", d["gray"], d["tdc"]])[0]
        if (rec["encoded"], rec["failed"], rec["skipped"]) != (n_img + 1, 1, 0):
            _fail(f"batch: {rec}")
        gray_batch = rec
        rec = _cli_records(step, card, "batch rerun", {}, ["batch", "--decode-threads", "16", d["gray"], d["tdc"]])[0]
        if (rec["encoded"], rec["skipped"]) != (0, n_img + 2):
            _fail(f"batch rerun: {rec}")
        n_rgb = _stacked_launches(rgb, 64, width)
        rec = _cli_records(step, card, f"batch --color 8x{side}^2 + {ccam}",
                           {"color_split_420_u8": n_rgb, "hp_encode_u8": 2 * n_rgb},
                           ["batch", "--color", "--decode-threads", "16", d["rgb"], d["tdcc"]])[0]
        if (rec["encoded"], rec["failed"]) != (len(rgb), 0):
            _fail(f"batch --color: {rec}")
        color_batch = rec
        # the streamed branches: above the threshold (patched down from 2^32
        # to a quarter of SQUARE^2) the SQUARE^2 frame and the camera frame's
        # .tdcc stream, band by band; the gray camera frame does not
        saved = st.STREAM_PIXELS
        st.STREAM_PIXELS = SQUARE * SQUARE // 4
        print(f"  streaming.STREAM_PIXELS patched from {saved} to {st.STREAM_PIXELS} for the streamed branches")
        try:
            rec = _cli_records(step, card, f"batch {sq} (streamed)", {"hp_encode_u8": -(-SQUARE // 8192)},
                               ["batch", d["big"], d["stream"]])[0]
            if rec["encoded"] != 1:
                _fail(f"batch streamed: {rec}")
            shutil.copy(os.path.join(d["tdcc"], "cam.npy.tdcc"), d["stream"])
            bands = -(-mc.color_kernel_shape(*COLOR_FRAME)[0] // 8192)
            rec = _cli_records(step, card, f"unbatch --ext .npy {sq} .tdc + {ccam} .tdcc (streamed)",
                               {"hp_decode_u8": 1 + 2 * bands, "color_merge_420_u8": bands},
                               ["unbatch", "--ext", ".npy", d["stream"], d["spix"]])[0]
            if (rec["decoded"], rec["failed"]) != (2, 0):
                _fail(f"unbatch streamed: {rec}")
        finally:
            st.STREAM_PIXELS = saved
        tdc_names = [n + ".tdc" for n in gray]
        n_dec = _stacked_launches(tdc_names, unbatch_chunk, width)
        for flags, key, out in ((["--ext", ".npy"], "hp_decode_u8", "pix"),
                                (["--ext", ".npy", "--scale", "4/8"], "hp_scaled_decode_u8", "pix4")):
            rec = _cli_records(step, card, f"unbatch {' '.join(flags)} {n_img + 1} .tdc", {key: n_dec},
                               ["unbatch", *flags, d["tdc"], d[out]])[0]
            if (rec["decoded"], rec["failed"]) != (n_img + 1, 0):
                _fail(f"unbatch {flags}: {rec}")
        rec = _cli_records(step, card, "unbatch rerun", {}, ["unbatch", "--ext", ".npy", d["tdc"], d["pix"]])[0]
        if rec["skipped"] != n_img + 1:
            _fail(f"unbatch rerun: {rec}")
        n_cdec = _stacked_launches(rgb, unbatch_chunk, width)
        _cli_records(step, card, f"unbatch --ext .npy {len(rgb)} .tdcc",
                     {"hp_decode_u8": 2 * n_cdec, "color_merge_420_u8": n_cdec},
                     ["unbatch", "--ext", ".npy", d["tdcc"], d["cpix"]])
        _cli_records(step, card, f"unbatch --ext .npy --scale 4/8 {len(rgb)} .tdcc",
                     {"hp_scaled_decode_u8": 2 * len(rgb)},
                     ["unbatch", "--ext", ".npy", "--scale", "4/8", d["tdcc"], d["cpix4"]])
        t_bulk = time.perf_counter() - t0
        _measuring_verbs(step, card, k, d, gray_tdc=os.path.join(d["tdc"], "f00.npy.tdc"))
        launches = counts()
        t_cli = time.perf_counter() - t0
        print(f"  bulk and measuring path: {t_cli:.1f} s for the CLI calls ({t_bulk:.1f} s bulk); launches:",
              json.dumps(launches))
        print(f"  batch {n_img}x{side}^2 + {cam}: {json.dumps(gray_batch['ms'])} ms, "
              f"{(n_img + 1) / gray_batch['ms']['wall'] * 1e3:.2f} images/s; batch --color 8x{side}^2 + "
              f"{ccam}: {json.dumps(color_batch['ms'])} ms [{card}]")
        # the checks (their launches come after the counts were read)
        _check_bulk(p, cfg, dev, d, gray, rgb, big)
    print(f"  bulk and measuring phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _measuring_verbs(step, card: str, k: int, d: dict, gray_tdc: str) -> None:
    """bench, sweep, table, curve, scale, selftest, profile, compare, info,
    each one step; every time they print finite and not negative."""
    import torch as _t

    n_img, side = BATCH
    color = lambda n: {"color_split_direct_420": n, "hp_encode_u8": 2 * n,  # noqa: E731
                       "hp_decode_u8": 2 * n, "color_merge_direct_420": n}
    reps = ["--reps", str(BENCH_REPS)]
    out = {}
    out["bench"] = _cli_records(step, card, f"bench --size {SQUARE} --fused --color",
                                {"hp_dct": 2 * k, "hp_idct": k, "hp_roundtrip": k, **color(k)},
                                ["bench", "--size", str(SQUARE), "--pipelines", "hp", "--fused", "--color", *reps])
    # bench_pipeline, the serving tier, then bench_color and the color serving tier
    serving = {**color(2 * k), "hp_roundtrip_u8": k, "hp_dct": 2 * k, "hp_idct": k}
    out["serving"] = _cli_records(step, card, f"bench --size {side} --batch {n_img} --color", serving,
                                  ["bench", "--size", str(side), "--pipelines", "hp", "--batch", str(n_img),
                                   "--color", *reps])
    out["entropy"] = _cli_records(step, card, f"bench --host-entropy --size {ENTROPY_SIDE}", {},
                                  ["bench", "--host-entropy", "--size", str(ENTROPY_SIDE)])
    # e2e: one image through a JPEG file, then `batch` over 8 JPEGs of 1024^2
    from tpudct_torch.utils import native

    print("  JPEG writes and reads (bench --e2e, table, curve) go through "
          + ("the host JPEG library" if native.jpeg_library() is not None else "PIL (no host JPEG library here)"))
    out["e2e"] = _cli_records(step, card, f"bench --e2e --size {ENTROPY_SIDE} --batch 8", {"hp_encode_u8": 2},
                              ["bench", "--e2e", "--size", str(ENTROPY_SIDE), "--batch", "8"])
    sizes = (1024, SQUARE)
    out["sweep"] = _cli_records(step, card, f"sweep --sizes {sizes}",
                                {"hp_dct": 2 * k * len(sizes), "hp_idct": k * len(sizes)},
                                ["sweep", "--sizes", ",".join(map(str, sizes)), *reps])
    out["table"] = _cli_records(step, card, "table", {"hp_roundtrip": 6}, ["table"])
    out["table_color"] = _cli_records(step, card, "table --color", {"hp_dct": 12, "hp_idct": 12},
                                      ["table", "--color"])
    out["curve"] = _cli_records(step, card, "curve", {"hp_roundtrip": 10}, ["curve"])
    counts = (1, 2, 4, 8)
    out["scale"] = _cli_records(step, card, f"scale --size {SQUARE} --devices {counts}",
                                {"hp_dct": sum(counts) * k, "hp_idct": sum(counts) * k},
                                ["scale", "--size", str(SQUARE), "--devices", ",".join(map(str, counts)), *reps])
    out["selftest"] = _cli_records(step, card, "selftest --families", SELFTEST_LAUNCHES, ["selftest", "--families"])
    out["profile"] = _cli_records(step, card, f"profile --size {ENTROPY_SIDE}", {"hp_roundtrip": k},
                                  ["profile", "--size", str(ENTROPY_SIDE), "--out", d["trace"], *reps])
    with open(os.path.join(d["trace"], "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernels = sorted(n for n in names if "k_rt_f32" in n)
    if not kernels:
        _fail("profile: trace.json names no CUDA kernel of the port (k_rt_f32...)")
    print(f"  profile: trace.json names {kernels}")
    a, b = (os.path.join(d["gray"], f"f0{i}.npy") for i in (0, 1))
    out["compare"] = _cli_records(step, card, "compare two .npy frames", {}, ["compare", a, b], rc=1)
    out["compare_tdc"] = _cli_records(step, card, "compare two .tdc files", {},
                                      ["compare", gray_tdc, gray_tdc])
    info = _cli_records(step, card, "info", {}, ["info"])[0]
    if info["backend"] != "cuda" or _t.cuda.get_device_name(0) not in info["devices"][0]:
        _fail(f"info: {info}")
    for key, rows in out.items():
        times = [v for r in rows for kk, v in r.items() if kk.endswith("_ms") and not kk.startswith("ref_")]
        if not all(np.isfinite(times)) or (times and min(times) < 0):
            _fail(f"{key}: {rows}")


def _check_bulk(p, cfg, dev, d: dict, gray: dict, rgb: dict, big: np.ndarray) -> None:
    """Every bulk output against the per-file call on the card."""
    from tpudct_torch.models import color as mc
    from tpudct_torch.models.dispatch import decode_gray_auto, decode_gray_scaled_auto, encode_gray_auto
    from tpudct_torch.utils import serialize
    from tpudct_torch.utils import streaming as st

    def read(*parts) -> bytes:
        with open(os.path.join(*parts), "rb") as f:
            return f.read()

    maps = {n: encode_gray_auto(p, img, cfg, device=dev) for n, img in gray.items()}
    maps = {n: (c.cpu().numpy(), hw) for n, (c, hw) in maps.items()}
    want = dict(zip(maps, _threaded(lambda n: serialize.coefficients_to_bytes(
        maps[n][0], cfg.q_scale, cfg.retain_k, orig_shape=maps[n][1], transform=cfg.transform,
        q_table=cfg.q_table), list(maps))))
    for n in gray:
        if read(d["tdc"], n + ".tdc") != want[n]:
            _fail(f"batch: {n}.tdc differs from coefficients_to_bytes(encode_gray_auto) of the file alone")
        c, hw = maps[n]
        full = decode_gray_auto(p, c, cfg, hw, device=dev)
        quarter = decode_gray_scaled_auto(p, c, cfg, hw, 4, device=dev)
        if not np.array_equal(np.load(os.path.join(d["pix"], n + ".tdc.npy")), full):
            _fail(f"unbatch: {n}.tdc.npy differs from decode_gray_auto of its coefficients")
        if not np.array_equal(np.load(os.path.join(d["pix4"], n + ".tdc.npy")), quarter):
            _fail(f"unbatch --scale 4/8: {n}.tdc.npy differs from decode_gray_scaled_auto of its coefficients")
    print(f"  batch: {len(gray)} .tdc = coefficients_to_bytes(encode_gray_auto) of each file alone; unbatch and "
          f"--scale 4/8: = decode_gray_auto / decode_gray_scaled_auto of each")
    enc = {n: mc.encode_color_auto(p, img, cfg, device=dev) for n, img in rgb.items()}
    enc = {n: ({kk: v.cpu().numpy() for kk, v in pl.items()}, meta) for n, (pl, meta) in enc.items()}
    want = dict(zip(enc, _threaded(lambda n: serialize.color_to_bytes(
        enc[n][0], enc[n][1], cfg.q_scale, cfg.retain_k, cfg.transform), list(enc))))
    for n in rgb:
        if read(d["tdcc"], n + ".tdcc") != want[n]:
            _fail(f"batch --color: {n}.tdcc differs from color_to_bytes(encode_color_auto) of the file alone")
        pl, meta = enc[n]
        full = mc.decode_color_auto(p, pl, meta, cfg, device=dev).cpu().numpy()
        half = mc.decode_color_scaled(p, pl, meta, cfg, 2, device=dev).cpu().numpy()
        if not np.array_equal(np.load(os.path.join(d["cpix"], n + ".tdcc.npy")), full):
            _fail(f"unbatch: {n}.tdcc.npy differs from decode_color_auto of its planes")
        if not np.array_equal(np.load(os.path.join(d["cpix4"], n + ".tdcc.npy")), half):
            _fail(f"unbatch --scale 4/8: {n}.tdcc.npy differs from decode_color_scaled of its planes")
    print(f"  batch --color: {len(rgb)} .tdcc = color_to_bytes(encode_color_auto) of each file alone; unbatch and "
          f"--scale 4/8: = decode_color_auto / decode_color_scaled of each")
    data, _hw = st.encode_gray_streamed_bytes(p, big, cfg, device=dev)
    if read(d["stream"], "big.npy.tdc") != data:
        _fail("batch (streamed): the .tdc differs from encode_gray_streamed_bytes of the frame")
    if not np.array_equal(np.load(os.path.join(d["spix"], "big.npy.tdc.npy")), st.decode_gray_streamed(
            p, data, device=dev)):
        _fail("unbatch (streamed): the raster differs from decode_gray_streamed")
    cdata = read(d["stream"], "cam.npy.tdcc")
    if not np.array_equal(np.load(os.path.join(d["spix"], "cam.npy.tdcc.npy")), st.decode_color_streamed(
            p, cdata, device=dev)):
        _fail("unbatch (streamed): the camera frame differs from decode_color_streamed")
    print(f"  streamed branches: the {SQUARE}^2 .tdc = encode_gray_streamed_bytes, its raster = "
          f"decode_gray_streamed; the camera .tdcc's raster = decode_color_streamed")


# the coefficient path: streams as import_jpeg emits them (transform "dct",
# q_scale 1, a JPEG's integer tables as custom q-tables; here IJG's at this
# quality), edited and restaged with a fast entropy stage
COEF_QUALITY, COEF_ENTROPY = 90, "rans"
# the multi-process path: worker processes x virtual ranks of each on the card
MP_PROCS, MP_RANKS = 2, 2
MP_BATCH = (32, 1024)


def _coef_crop(h: int, w: int) -> tuple:
    """(Y0, X0, H, W) of the coefficient path's crop of an h x w frame: a
    16-aligned origin (whole 4:2:0 chroma blocks) a quarter in, odd sizes
    (partial edge blocks) about half of each side."""
    return h // 4 // 16 * 16, w // 4 // 16 * 16, h // 2 - 3, w // 2 - 5


def _ijg_tables(quality: int) -> tuple:
    """(luma, chroma) names of IJG's integer tables at `quality` (libjpeg's
    jpeg_quality_scaling), registered as custom q-tables, as a JPEG file
    carries them."""
    from tpudct_torch.constants import Q, QC, register_q_table

    scale = 200 - 2 * quality if quality >= 50 else 5000 // quality
    return tuple(register_q_table(np.clip((t.astype(np.int64) * scale + 50) // 100, 1, 255).astype(np.float32))
                 for t in (Q, QC))


def _dct_streams(gray: np.ndarray, rgb: np.ndarray, dev) -> tuple:
    """The .tdc of `gray` and the 4:2:0 .tdcc of `rgb` that import_jpeg
    writes for JPEGs of the same coefficients: the plain twins (hp.dct_plain
    on the f32-literal dct core, color.split_plain) on the card, IJG
    quality-COEF_QUALITY tables, COEF_ENTROPY coded."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.models import color as mc
    from tpudct_torch.ops.padding import pad_to_kernel, padded_shape
    from tpudct_torch.utils import serialize

    yq, cq = _ijg_tables(COEF_QUALITY)

    def fwd(plane, table):
        return hp.dct_plain(plane.to(torch.float32), 1.0, table, "dct", int_core=False)

    c = fwd(torch.as_tensor(gray, device=dev), yq).cpu().numpy()
    g = serialize.coefficients_to_bytes(c, 1.0, None, orig_shape=gray.shape, transform="dct", q_table=yq,
                                        codec=COEF_ENTROPY)
    h, w = rgb.shape[:2]
    x, _ = pad_to_kernel(torch.as_tensor(rgb, device=dev).movedim(-1, 0).contiguous(), *mc._GRID)
    y, cb, cr = ck.split_plain(x, "420")
    ch, cw = mc._chroma_plane_shape("420", h, w)
    (yh, yw), (c8h, c8w) = padded_shape(h, w), padded_shape(ch, cw)
    planes = {"y": fwd(y, yq)[:yh, :yw], "cb": fwd(cb, cq)[:c8h, :c8w], "cr": fwd(cr, cq)[:c8h, :c8w]}
    meta = {"orig_shape": (h, w), "chroma_shape": (ch, cw), "subsample": "420", "y_q_table": yq, "c_q_table": cq}
    cdata = serialize.color_to_bytes({k: v.cpu().numpy() for k, v in planes.items()}, meta, 1.0, None, "dct",
                                     codec=COEF_ENTROPY)
    return g, cdata


@contextlib.contextmanager
def _plain_decode():
    """hp_idct and hp_decode_u8 swapped for their plain twins (the same
    value chains in torch ops, run on the card) while the block runs: the
    decode that a kernel decode is held against."""
    from tpudct_torch.kernels import hp

    saved = hp.hp_idct, hp.hp_decode_u8
    hp.hp_idct = lambda c, q_scale=1.0, q_table="luma", decode_precision="butterfly", transform="haweel": (
        hp.idct_plain(c, q_scale, q_table, decode_precision, transform))
    hp.hp_decode_u8 = lambda c, q_scale=1.0, q_table="luma", decode_precision="butterfly", transform="haweel": (
        hp.decode_u8_plain(c, q_scale, q_table, decode_precision, transform))
    try:
        yield
    finally:
        hp.hp_idct, hp.hp_decode_u8 = saved


_PARITY = (-1.0) ** np.arange(8)  # the DCT rows' parity under index reversal


def _block_op(m: np.ndarray, op: str) -> np.ndarray:
    """A geometric op on a coefficient map by its definition: hflip reverses
    the block columns and negates the odd coefficient columns, vflip the
    same on rows, transpose swaps the block grid and each block; rot90
    (clockwise) = hflip of transpose, rot270 = vflip of transpose, rot180 =
    vflip of hflip."""
    hb, wb = m.shape[0] // 8, m.shape[1] // 8
    b = m.reshape(hb, 8, wb, 8)
    if op == "hflip":
        return (b[:, :, ::-1, :] * _PARITY[None, None, None, :]).reshape(m.shape).astype(m.dtype)
    if op == "vflip":
        return (b[::-1] * _PARITY[None, :, None, None]).reshape(m.shape).astype(m.dtype)
    if op == "transpose":
        return np.ascontiguousarray(b.transpose(2, 3, 0, 1)).reshape(m.shape[1], m.shape[0])
    first, then = {"rot90": ("transpose", "hflip"), "rot270": ("transpose", "vflip"),
                   "rot180": ("hflip", "vflip")}[op]
    return _block_op(_block_op(m, first), then)


def _pixel_op(a: np.ndarray, op: str) -> np.ndarray:
    """The same op on a raster ((H, W) or (H, W, 3))."""
    return {"hflip": lambda: a[:, ::-1], "vflip": lambda: a[::-1], "rot180": lambda: a[::-1, ::-1],
            "transpose": lambda: a.swapaxes(0, 1), "rot90": lambda: np.rot90(a, -1, (0, 1)),
            "rot270": lambda: np.rot90(a, 1, (0, 1))}[op]()


def phase_coefficient_path(dev, card: str) -> dict:
    """The coefficient path (python -m tpudct_torch edit / transcode /
    decode) in process, its counters set to 0 just before it and read just
    after; each call moves exactly its counters (the edits and restages
    none: they are host work; a gray decode one B6 on the f32-literal dct
    core, since a quality-COEF_QUALITY table's coefficients exceed int8; a
    camera-frame color decode none, its widths off the kernel grid, so the
    f32 path's plain fallback).  Inputs: an 8192^2 photo-like gray frame
    and the 4032x3024 camera frame at 4:2:0 (sides multiples of 16, so every
    op is representable), encoded by the plain twins as import_jpeg's
    stream.  Then: every edited map equal to its op applied to the
    unedited map by definition (_block_op); every decode bit-identical to
    the plain twins' decode of the file's coefficients; the restage rans ->
    huffman -> banded:4 back to the same coefficients (and to the same
    bytes once rans again); per op the count of pixels where decode(edit)
    differs from op(decode) (a count, not a gate).  Where the host JPEG
    library builds, also jpg -> tdc -> jpg bit-exact and ``decode in.jpg``."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.models.color import decode_color_auto
    from tpudct_torch.models.dispatch import decode_gray_auto
    from tpudct_torch.utils import coefops, jpegcoef, native, serialize

    _phase(6, "coefficient path")
    t_phase = time.perf_counter()
    p = get_pipeline("hp")
    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES)
    jpeg = jpegcoef.coef_io_available()
    print(f"  coef_io_available(): {jpeg}; the host JPEG library: "
          + ("built" if native.jpeg_library() is not None else "unavailable (no libjpeg headers)"))
    sq, cam = f"{SQUARE}^2", "x".join(map(str, COLOR_FRAME))
    gray = _camera_frame(SQUARE, SQUARE, seed=42)
    rgb = _camera_rgb(*COLOR_FRAME)
    with tempfile.TemporaryDirectory() as tmp:
        f = lambda name: os.path.join(tmp, name)  # noqa: E731
        gdata, cdata = _dct_streams(gray, rgb, dev)
        for name, data in (("g.tdc", gdata), ("c.tdcc", cdata)):
            with open(f(name), "wb") as fh:
                fh.write(data)
        print(f"  {sq} .tdc {len(gdata)} bytes, {cam} .tdcc {len(cdata)} bytes (transform dct, "
              f"IJG quality {COEF_QUALITY} tables, {COEF_ENTROPY})")

        def cli_step(label, expected, argv) -> list:
            return _cli_records(step, card, label, expected, argv)

        hp.reset_launches()
        ck.reset_launches()
        t0 = time.perf_counter()
        edits = {}  # output -> (source, op or None, crop or None, grayscale)
        for src, label in (("g.tdc", sq), ("c.tdcc", cam)):
            stem, ext = os.path.splitext(src)
            for op in coefops.OPS:
                edits[f"{stem}.{op}{ext}"] = (src, op, None, False)
            edits[f"{stem}.crop{ext}"] = (src, None, _coef_crop(*(gray.shape if ext == ".tdc" else rgb.shape[:2])),
                                          False)
        edits["c.gray.tdc"] = ("c.tdcc", None, None, True)
        for out, (src, op, crop, gray_only) in edits.items():
            flags = (["--op", op] if op else []) + (["--crop", *map(str, crop)] if crop else [])
            flags += ["--grayscale"] if gray_only else []
            cli_step(f"{sq if src == 'g.tdc' else cam} edit {' '.join(flags)}", {},
                     ["edit", "--entropy", COEF_ENTROPY, *flags, f(src), f(out)])
        chain = ("g.tdc", "g.huffman.tdc", "g.banded4.tdc", "g.rans.tdc")
        for a, b, stage in zip(chain, chain[1:], ("huffman", "banded:4", "rans")):
            cli_step(f"{sq} transcode --entropy {stage}", {}, ["transcode", "--entropy", stage, f(a), f(b)])
        decodes = ["g.tdc", "c.tdcc", *edits, "g.banded4.tdc"]
        if jpeg:
            cli_step(f"{sq} transcode tdc -> jpg", {}, ["transcode", f("g.tdc"), f("g.jpg")])
            cli_step(f"{sq} transcode jpg -> tdc", {}, ["transcode", "--entropy", COEF_ENTROPY, f("g.jpg"),
                                                         f("g.jpg.tdc")])
            decodes.append("g.jpg")
        for name in decodes:
            color = name.endswith(".tdcc")
            cli_step(f"decode {name}", {} if color else {"hp_idct": 1},
                     ["decode", "--device", str(dev), f(name), f(name + ".npy")])
        launches = counts()
        print(f"  coefficient path: {time.perf_counter() - t0:.1f} s for the CLI calls; launches:",
              json.dumps(launches))
        # the checks (launches here come after the counts were read)
        cfg_of = {}
        maps = {}
        for name in decodes:
            if name.endswith(".jpg"):
                data = jpegcoef.import_jpeg(f(name), codec="raw")
            else:
                data = open(f(name), "rb").read()
            if name.endswith(".tdcc"):
                planes, meta = serialize.bytes_to_color(data)
                maps[name] = planes
                with _plain_decode():
                    ref = decode_color_auto(p, planes, meta, CodecConfig(q_scale=meta["q_scale"],
                                                                         transform=meta["transform"]), device=dev)
            else:
                c, qs, _k, shape, tr, qt = serialize.bytes_to_coefficients(
                    data, with_orig_shape=True, with_transform=True, with_q_table=True)
                maps[name] = {"y": c}
                cfg_of[name] = CodecConfig(q_scale=qs, transform=tr, q_table=qt)
                with _plain_decode():
                    ref = decode_gray_auto(p, c, cfg_of[name], shape, device=dev)
            if not np.array_equal(np.load(f(name + ".npy")), _host(ref)):
                _fail(f"decode {name}: the raster differs from the plain twins' decode of its coefficients")
        if counts() != launches:
            _fail(f"the twins' decodes launched kernels: {counts()} against {launches}")
        print(f"  {len(decodes)} decodes bit-identical to the plain twins' decodes of the same coefficients")
        for out, (src, op, crop, gray_only) in edits.items():
            for k, m in maps[out].items():
                base = maps[src]["y" if gray_only else k]
                if crop is not None:  # 4:2:0 chroma: the crop at half the luma's coordinates
                    sub = 2 if k != "y" else 1
                    y0, x0, hh, ww = crop[0] // sub, crop[1] // sub, -(-crop[2] // sub), -(-crop[3] // sub)
                    want = base[y0 : y0 + -(-hh // 8) * 8, x0 : x0 + -(-ww // 8) * 8]
                else:
                    want = _block_op(base, op) if op else base
                if not np.array_equal(m, want):
                    _fail(f"edit {out} plane {k}: the map differs from the op applied to {src}'s map")
        print(f"  {len(edits)} edited maps equal to their op applied to the unedited map, plane by plane")
        for a in chain[1:]:
            if not np.array_equal(serialize.bytes_to_coefficients(open(f(a), "rb").read())[0], maps["g.tdc"]["y"]):
                _fail(f"restage {a}: the coefficients differ from g.tdc's")
        if open(f("g.rans.tdc"), "rb").read() != gdata:
            _fail("restage rans -> huffman -> banded:4 -> rans: the bytes differ from the source's")
        print("  restage rans -> huffman -> banded:4 -> rans: the same coefficients at every hop, the source's bytes "
              "at the end")
        if jpeg:
            back = serialize.bytes_to_coefficients(open(f("g.jpg.tdc"), "rb").read())[0]
            if not np.array_equal(back, maps["g.tdc"]["y"]) or not np.array_equal(maps["g.jpg"]["y"], back):
                _fail("jpg -> tdc -> jpg: the coefficients differ")
            print("  jpg -> tdc -> jpg: the coefficients bit-exact; decode g.jpg as the twins'")
        else:
            print("  the JPEG legs (jpg -> tdc -> jpg, decode in.jpg) ran in the CPU tests only: no libjpeg "
                  "headers on this machine (a host library, not a device or kernel failure)")
        for src in ("g.tdc", "c.tdcc"):
            stem, ext = os.path.splitext(src)
            base = np.load(f(src + ".npy"))
            for op in coefops.OPS:
                got = np.load(f(f"{stem}.{op}{ext}.npy"))
                diff = np.abs(got.astype(np.int16) - _pixel_op(base, op))
                print(f"    {sq if src == 'g.tdc' else cam} {op}: decode(edit) differs from op(decode) on "
                      f"{int((diff > 0).any(axis=-1).sum() if diff.ndim == 3 else (diff > 0).sum())} of "
                      f"{diff.shape[0] * diff.shape[1]} pixels (max {int(diff.max())}) [{card}]")
    print(f"  coefficient phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _mp_inputs(side: int, batch: tuple) -> dict:
    """The multi-process path's inputs from seeds: a side^2 gray image
    (f32), a side^2 planar RGB (u8), a serving batch of batch[0] frames of
    batch[1]^2 (u8)."""
    rng = np.random.default_rng(5)
    return {
        "gray": rng.integers(0, 256, (side, side), dtype=np.uint8).astype(np.float32),
        "rgb": rng.integers(0, 256, (3, side, side), dtype=np.uint8),
        "batch": rng.integers(0, 256, (batch[0], batch[1], batch[1]), dtype=np.uint8),
    }


def _mp_steps(mesh, gmesh, parts: dict, side: int, out_dir: str) -> dict:
    """Every step of the multi-process path on `mesh` and `gmesh` with
    `parts` as this process's slabs: the gathered outputs' hashes, the
    metrics, the files' byte counts and hashes, and per step its host wall
    and the seconds its gloo collectives took (0 in one process)."""
    import hashlib

    import torch.distributed as dist

    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch import parallel as PP

    p, cfg = get_pipeline("hp"), CodecConfig()
    coll = [0.0]
    if dist.is_initialized():
        plain = dist.all_gather

        def timed_all_gather(*a, **k):
            t = time.perf_counter()
            try:
                return plain(*a, **k)
            finally:
                coll[0] += time.perf_counter() - t

        dist.all_gather = timed_all_gather
    res, walls = {}, {}

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def sync():
        if mesh.is_cuda:
            torch.cuda.synchronize()

    def timed(label, fn):
        c0 = coll[0]
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        walls[label] = (round(time.perf_counter() - t, 4), round(coll[0] - c0, 4))
        return out

    def metrics(m) -> dict:
        return {k: float(v) for k, v in m.items()}

    (c, r), m = timed("sharded_codec_step", lambda: PP.sharded_codec_step(p, cfg, mesh)(
        PP.shard_image(parts["gray"], mesh)))
    rgb_rec, mc = timed("sharded_color_step", lambda: PP.sharded_color_step(p, cfg, mesh)(
        PP.shard_rgb(parts["rgb"], mesh)))
    (bc, br), bm = timed("sharded_serving_step", lambda: PP.sharded_serving_step(p, cfg, mesh)(
        PP.shard_batch(parts["batch"], mesh)))
    (gc, gr), gm = timed("sharded_codec_step_grid", lambda: PP.sharded_codec_step_grid(p, cfg, gmesh)(
        PP.shard_image_grid(parts["gray"], gmesh)))
    step, meta_fn = PP.sharded_color_encode(p, cfg, mesh)
    planes = timed("sharded_color_encode", lambda: dict(zip(("y", "cb", "cr"), step(PP.shard_rgb(parts["rgb"], mesh)))))
    os.makedirs(out_dir, exist_ok=True)
    n_tdc = timed("save_sharded", lambda: PP.save_sharded(os.path.join(out_dir, "s.tdc"), c, orig_shape=(side, side)))
    n_tdcc = timed("save_color_sharded", lambda: PP.save_color_sharded(
        os.path.join(out_dir, "s.tdcc"), planes, meta_fn(side, side)))
    res["metrics"] = {"gray": metrics(m), "color": metrics(mc), "serving": metrics(bm), "grid": metrics(gm)}
    res["bytes"] = [n_tdc, n_tdcc]
    for k, v in (("coeffs", c), ("recon", r), ("rgb", rgb_rec), ("batch_coeffs", bc), ("batch_recon", br),
                 ("grid_coeffs", gc), ("grid_recon", gr), *planes.items()):
        res[k] = sha(timed(f"gather {k}", lambda v=v: PP.gather(v)))
    for name in ("s.tdc", "s.tdcc"):
        path = os.path.join(out_dir, name)
        res[name] = hashlib.sha256(open(path, "rb").read()).hexdigest() if os.path.exists(path) else None
    res["walls"] = walls
    return res


def _mp_worker(pid: int, nproc: int, port: int, side: int, batch_n: int, batch_side: int, out: str,
               device: str) -> int:
    """One process of the multi-process path: joins the gloo group, drives
    MP_RANKS virtual ranks on `device` with its slabs of the inputs, writes
    its results and its kernel launches as JSON."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.parallel import band_mesh, distributed_init, grid_mesh

    t0 = time.perf_counter()
    distributed_init(f"localhost:{port}", num_processes=nproc, process_id=pid, timeout=300)
    t_init = time.perf_counter() - t0
    devs = [device] * MP_RANKS
    mesh, gmesh = band_mesh(devices=devs), grid_mesh((2, 2), devices=devs)
    parts = {}
    for k, a in _mp_inputs(side, (batch_n, batch_side)).items():
        ax = 1 if k == "rgb" else 0
        n = a.shape[ax] // nproc
        parts[k] = np.ascontiguousarray(a.take(range(pid * n, (pid + 1) * n), axis=ax))
    hp.reset_launches()
    ck.reset_launches()
    res = _mp_steps(mesh, gmesh, parts, side, os.path.join(out, f"p{pid}"))
    res["launches"] = {k: v for c in (hp.LAUNCHES, ck.LAUNCHES) for k, v in c.items() if v}
    res["addressable"] = mesh.is_fully_addressable
    res["init_s"] = round(t_init, 3)
    with open(os.path.join(out, f"result{pid}.json"), "w") as fh:
        json.dump(res, fh)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def phase_multi_process_path(dev, card: str) -> dict:
    """The multi-process path: MP_PROCS worker processes (this script with
    --mp-worker), each joining a gloo group through distributed_init over a
    localhost port and driving MP_RANKS virtual ranks on the card with its
    slab of each input: sharded_codec_step (hp) and the grid step on a
    (2, 2) mesh on 8192^2 gray, sharded_color_step and sharded_color_encode
    on 8192^2 RGB, sharded_serving_step on 32 x 1024^2 frames, save_sharded
    and save_color_sharded, gather of every output.  Every gathered hash,
    file and byte count equal to a single-process run on MP_PROCS x MP_RANKS
    virtual ranks of this card, the metrics within rtol 1e-6 (equal here:
    the all-gathered partials add in rank order), the workers' launches
    adding up to the single run's.  A worker that fails fails the run."""
    import socket
    import subprocess
    import sys

    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.parallel import band_mesh, grid_mesh

    _phase(6, "multi-process path")
    t_phase = time.perf_counter()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        args = [str(MP_PROCS), str(port), str(SQUARE), *map(str, MP_BATCH), tmp, str(dev)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-worker", str(i), *args],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for i in range(MP_PROCS)]
        try:
            logs = [pr.communicate(timeout=400)[0] for pr in procs]
        finally:
            for pr in procs:
                pr.kill()
        t_workers = time.perf_counter() - t0
        for i, (pr, log) in enumerate(zip(procs, logs)):
            for line in log.splitlines()[-20:]:
                print(f"    [worker {i}] {line}")
            if pr.returncode:
                _fail(f"multi-process worker {i} exited with {pr.returncode}")
        got = [json.load(open(os.path.join(tmp, f"result{i}.json"))) for i in range(MP_PROCS)]
        n = MP_PROCS * MP_RANKS
        hp.reset_launches()
        ck.reset_launches()
        one = _mp_steps(band_mesh(devices=[dev] * n), grid_mesh((2, 2), devices=[dev] * n),
                        _mp_inputs(SQUARE, MP_BATCH), SQUARE, os.path.join(tmp, "single"))
        single_launches = {k: v for c in (hp.LAUNCHES, ck.LAUNCHES) for k, v in c.items() if v}
    worker_launches = collections.Counter()
    for i, r in enumerate(got):
        if r["addressable"]:
            _fail(f"worker {i}: its mesh is fully addressable")
        worker_launches.update(r["launches"])
        for k in one:
            if k in ("walls",) or (i and k in ("s.tdc", "s.tdcc")):
                continue
            if k == "metrics":
                for step_, mm in one[k].items():
                    for name, v in mm.items():
                        if abs(r[k][step_][name] - v) > 1e-6 * abs(v):
                            _fail(f"worker {i} {step_} {name}: {r[k][step_][name]} against {v}")
            elif r[k] != one[k]:
                _fail(f"worker {i} {k}: {r[k]} differs from the single-process run's {one[k]}")
        if i and (r["s.tdc"] or r["s.tdcc"]):
            _fail(f"worker {i} wrote a file; only process 0 writes")
    if dict(worker_launches) != single_launches:
        _fail(f"the workers launched {dict(worker_launches)}, the single-process run {single_launches}")
    print(f"  {MP_PROCS} processes x {MP_RANKS} virtual ranks on {card}: workers {t_workers:.1f} s in all "
          f"(init {[r['init_s'] for r in got]} s); gathered outputs, files ({one['bytes']} bytes) and metrics equal "
          f"to the single-process run on {n} ranks; launches {json.dumps(dict(worker_launches))}")
    for label in one["walls"]:
        w1 = one["walls"][label][0]
        ws = [r["walls"][label] for r in got]
        print(f"    {label}: host wall per worker {[w for w, _ in ws]} s (gloo {[c for _, c in ws]} s, "
              f"{[round(100 * c / w, 1) if w else 0.0 for w, c in ws]}%), single process {w1} s [{card}]")
    print(f"  multi-process phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(worker_launches)


# `python3 -m tpudct_torch.bench`: its one stdout line's keys and metric, its
# families (every one passes; jpg_import may skip: the card's machine has no
# libjpeg headers), the most the printed value may move from the profiler's
# device time of the same call, and its watchdog in the subprocess
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
HEADLINE_FAMILIES = ["color420_u8", "f32", "scaled", "streamed_gray", "streamed_color", "jpg_import"]
HEADLINE_PROFILER_RTOL = 0.10
HEADLINE_TIMEOUT_S = 600


def _headline_line(label: str, lines: list) -> dict:
    """The bench's stdout, checked: one line, the four keys, the reference's
    metric string at SQUARE, value > 0, vs_baseline = round(29.4 / value, 2)."""
    if len(lines) != 1:
        _fail(f"{label}: {len(lines)} stdout lines, expected 1: {lines}")
    rec = json.loads(lines[0])
    if (set(rec) != HEADLINE_KEYS or rec["unit"] != "ms"
            or rec["metric"] != f"{SQUARE}x{SQUARE} DCT+quant+IDCT ms/image per chip"
            or not rec["value"] > 0 or rec["vs_baseline"] != round(29.4 / rec["value"], 2)):
        _fail(f"{label}: {rec}")
    return rec


def _headline_reports(label: str, lines: list, dev) -> list:
    """The bench's stderr records, checked: the gate and every family pass
    (jpg_import may skip), then the line naming the device and the card."""
    recs = [json.loads(line) for line in lines if line.startswith("{")]
    gates, tail = recs[:-1], recs[-1] if recs else {}
    fams = [r.get("family") for r in gates]
    if fams != [None, *HEADLINE_FAMILIES] or tail.get("device") != str(dev) or not tail.get("card"):
        _fail(f"{label}: stderr records {recs}")
    for r in gates:
        if r["gate"] != "pass" and not (r.get("family") == "jpg_import" and r["gate"] == "skip"):
            _fail(f"{label}: {r}")
    return recs


def _profiled_rt_u8_ms(p, cfg, x, reps: int = 10) -> tuple:
    """(ms, events): the mean device time of the k_rt_u8 events that
    torch.profiler records over `reps` p.roundtrip_u8(x, cfg) calls, the L2
    flushed before each call as device_time_ms does, and how many it
    recorded (the card's profiler has recorded fewer kernels than calls)."""
    from torch.autograd import DeviceType

    from tpudct_torch.utils import profiling
    from tpudct_torch.utils.timing import FLUSH_BYTES

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=x.device)
    p.roundtrip_u8(x, cfg)
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        for _ in range(reps):
            flush.zero_()
            p.roundtrip_u8(x, cfg)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "k_rt_u8" in e.key]
    n = sum(e.count for e in ev)
    if not n:
        _fail(f"profiler: no k_rt_u8 event over {reps} calls")
    return sum(e.self_device_time_total for e in ev) / n / 1e3, n


def phase_headline_bench(dev, card: str) -> tuple:
    """The headline bench path, the counters set to 0 just before it and
    read just after: ``python3 -m tpudct_torch.bench`` as a subprocess from
    the root of the checkout (TPUDCT_BENCH_TIMEOUT set), then
    tpudct_torch.bench.main() in process (exactly the gates' launches and
    1 + 5 B1), each printing one line of the four keys after the gate and
    every family passed; the printed value within HEADLINE_PROFILER_RTOL of
    the profiler's device time of the same call; then main() with a
    pipeline whose coefficients are one step off: exit 1 and one
    ``correctness gate failed`` line.  Returns (launches, the subprocess's
    value in ms)."""
    import sys

    from tpudct_torch import bench
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.models import get_pipeline

    _phase(6, "headline bench")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "TPUDCT_GATE"}
    env["TPUDCT_BENCH_TIMEOUT"] = str(HEADLINE_TIMEOUT_S)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "tpudct_torch.bench"], cwd=root, env=env, capture_output=True,
                         text=True, timeout=HEADLINE_TIMEOUT_S + 60)
    wall = time.perf_counter() - t0
    for line in run.stderr.splitlines():
        print(f"    [stderr] {line}")
    if run.returncode:
        _fail(f"python3 -m tpudct_torch.bench exited with {run.returncode}: {run.stdout}")
    rec = _headline_line("python3 -m tpudct_torch.bench", run.stdout.splitlines())
    secs = _headline_reports("python3 -m tpudct_torch.bench", run.stderr.splitlines(), dev)[-1]
    print(f"  python3 -m tpudct_torch.bench: {run.stdout.strip()}; wall {wall:.1f} s (gates {secs['gates_s']} s, "
          f"main {secs['main_s']} s) [{card}]")

    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES)
    hp.reset_launches()
    ck.reset_launches()
    out, err = io.StringIO(), io.StringIO()

    def main_captured():
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            return bench.main()

    rc = step("tpudct_torch.bench.main()",
              {**SELFTEST_LAUNCHES, "hp_roundtrip_u8": SELFTEST_LAUNCHES["hp_roundtrip_u8"] + 1 + 5}, main_captured)
    launches = counts()
    if rc:
        _fail(f"tpudct_torch.bench.main() returned {rc}: {out.getvalue()}")
    rec2 = _headline_line("tpudct_torch.bench.main()", out.getvalue().splitlines())
    _headline_reports("tpudct_torch.bench.main()", err.getvalue().splitlines(), dev)
    print(f"  tpudct_torch.bench.main() in process: {json.dumps(rec2)} [{card}]")
    print("  launches:", json.dumps(launches))

    p, cfg = get_pipeline("hp"), bench.CodecConfig()
    x = torch.as_tensor(bench.selftest.synthetic_image(SQUARE).astype(np.uint8), device=dev)
    prof_ms, n_ev = _profiled_rt_u8_ms(p, cfg, x)
    dev_ratio = rec["value"] / prof_ms
    print(f"  value {rec['value']} ms against the profiler's device time of the same call (k_rt_u8, L2 flushed; "
          f"the mean of {n_ev} events over 10 calls) {prof_ms:.4f} ms: {dev_ratio:.3f}x [{card}]")
    if abs(dev_ratio - 1) > HEADLINE_PROFILER_RTOL:
        _fail(f"the bench's value {rec['value']} ms is off the profiler's device time {prof_ms:.4f} ms "
              f"by more than {HEADLINE_PROFILER_RTOL:.0%}")

    class OffByOne(type(p)):
        """Coefficients one quantizer step off everywhere."""

        def roundtrip_u8(self, image_u8, cfg):
            c, r = super().roundtrip_u8(image_u8, cfg)
            return c + 1, r

        def encode_u8(self, image_u8, cfg):
            return super().encode_u8(image_u8, cfg) + 1

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        bench.get_pipeline = lambda name: OffByOne()
        try:
            rc = bench.main()
        finally:
            bench.get_pipeline = get_pipeline
    lines = out.getvalue().splitlines()
    if rc != 1 or len(lines) != 1 or not json.loads(lines[0])["error"].startswith("correctness gate failed: "):
        _fail(f"a pipeline one step off: exit {rc}, stdout {lines}")
    print(f"  a pipeline one step off: exit 1, {lines[0]}")
    return launches, rec["value"]


def _archive_launches(n: int, nc: int) -> dict:
    """Each partial_at_scale phase's launches with n gray and nc color bands:
    B2 per gray band; the ROI's covering band streamed (B3) and in memory
    (B2, B3); B7 per band and the in-memory band (B2, B7); B8 and two B2 per
    color band; the color ROI's f32 decode (two B6) and its in-memory band
    (the direct split, two B2, two B6)."""
    return {"gen": {}, "enc": {"hp_encode_u8": n}, "preview": {},
            "roi": {"hp_decode_u8": 2, "hp_encode_u8": 1},
            "scale": {"hp_scaled_decode_u8": n + 1, "hp_encode_u8": 1}, "genc": {},
            "encc": {"color_split_420_u8": nc, "hp_encode_u8": 2 * nc}, "previewc": {},
            "roic": {"hp_idct": 4, "color_split_direct_420": 1, "hp_encode_u8": 2}}


def _archive_phase(phase: str, directory: str) -> dict:
    """One phase of ``python3 -m tpudct_torch.studies.partial_at_scale`` at
    the archive sizes, in its own process; its JSON line."""
    import sys

    root = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run([sys.executable, "-m", "tpudct_torch.studies.partial_at_scale", phase, "--dir", directory,
                          "--size", str(ARCHIVE_SIDE), "--band", str(ARCHIVE_BAND), "--size-c", str(ARCHIVE_COLOR)],
                         cwd=root, capture_output=True, text=True, timeout=ARCHIVE_TIMEOUT_S)
    if run.returncode:
        _fail(f"partial_at_scale {phase} exited with {run.returncode}: {run.stdout[-2000:]} {run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def phase_archive_path(card: str) -> dict:
    """The archive path: the nine phases of tpudct_torch.studies.
    partial_at_scale at its sizes, each a subprocess (its counters start at
    0 there and it reports its launches), in a temporary directory deleted
    afterwards (each raster once its encode has read it).  Every phase must
    report exactly its launches, every validation flag must hold, the
    thumbnails and the scaled raster must have their shapes; each phase's
    seconds, peak host memory, launches and streamed split are printed."""
    import shutil

    from tpudct_torch.studies import partial_at_scale as pas

    _phase(6, "archive path")
    n, nc = ARCHIVE_SIDE // ARCHIVE_BAND, ARCHIVE_COLOR // ARCHIVE_BAND
    expected = _archive_launches(n, nc)
    d = tempfile.mkdtemp(prefix="tpudct-archive-")
    recs, launches = {}, collections.Counter()
    try:
        print(f"  {d}: {shutil.disk_usage(d).free / 2**30:.1f} GiB free")
        for phase in pas.PHASES:
            rec = recs[phase] = _archive_phase(phase, d)
            if rec["phase"] != phase or rec["launches"] != expected[phase]:
                _fail(f"partial_at_scale {phase}: {rec}; expected launches {expected[phase]}")
            launches.update(rec["launches"])
            print(f"  {phase}: {json.dumps(rec)} [{card}]", flush=True)
            if phase in ("enc", "encc"):
                os.remove(os.path.join(d, pas.PIX if phase == "enc" else pas.RGB))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    s8, c8 = ARCHIVE_SIDE // 8, ARCHIVE_COLOR // 8
    checks = {
        "roi": recs["roi"]["bit_identical_vs_in_memory_band"] and recs["roi"]["of"] == n
        and recs["roi"]["rows"] == list(pas.roi_rows(ARCHIVE_SIDE, ARCHIVE_BAND)),
        "scale": recs["scale"]["band_bit_identical"] and recs["scale"]["shape"] == [s8, s8],
        "roic": recs["roic"]["bit_identical_vs_in_memory_band"],
        "preview": recs["preview"]["shape"] == [s8, s8],
        "previewc": recs["previewc"]["shape"] == [c8, c8, 3],
    }
    if not all(checks.values()):
        _fail(f"archive path checks: {checks}")
    tdc, tdcc = recs["enc"]["bytes"], recs["encc"]["bytes"]
    print(f"  {ARCHIVE_SIDE}^2 gray ({ARCHIVE_SIDE**2} pixels) -> {tdc} bytes (factor {recs['enc']['factor']}); "
          f"{ARCHIVE_COLOR}^2 RGB -> {tdcc} bytes (factor {recs['encc']['factor']}); the ROIs and band "
          f"{recs['scale']['band']}'s 1/8-scale rows bit-identical to their bands in memory")
    print("  phase s / maxrss MiB (at its start): " + ", ".join(
        f"{p} {r['s']} / {r['maxrss_mb']} ({r['start_maxrss_mb']})" for p, r in recs.items()) + f" [{card}]")
    print("  launches:", json.dumps(dict(launches)))
    return dict(launches)


def _memory_peak(fn) -> tuple:
    """(fn(), host wall s, peak of fn's own device allocations, peak of the
    bytes the caching allocator reserved during it): the allocated bytes
    just before the call are the baseline, the peak stats reset then."""
    torch.cuda.synchronize()
    base, base_r = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, torch.cuda.max_memory_allocated() - base, torch.cuda.max_memory_reserved() - base_r


def phase_streamed_path(dev, card: str) -> dict:
    """The streamed path (tpudct_torch.utils.streaming and the CLI's
    --band-rows), its counters set to 0 just before it and read just after;
    each call moves exactly its counters.  Per call: its host wall split
    into staging copies, H2D, kernels, D2H, entropy and waits
    (streaming.seconds of the profiling registry), the device busy share,
    and its own peak of device memory beside one band's bytes; the 8-band
    gray calls fail at half of the image's bytes.  Then every output against the in-memory path, and
    the in-memory calls that return numpy (the pageable-copy baseline) with
    their walls and peaks."""
    from tpudct_torch import CodecConfig, cli, get_pipeline
    from tpudct_torch import parallel as P
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.models import color as mc
    from tpudct_torch.models.dispatch import encode_gray_auto
    from tpudct_torch.utils import profiling, serialize
    from tpudct_torch.utils import streaming as st

    _phase(6, "streamed path")
    cfg, p = CodecConfig(), get_pipeline("hp")
    counts, step = _stepper(hp.LAUNCHES, ck.LAUNCHES)
    side, band, cside = STREAM_SIDE, STREAM_BAND, STREAM_COLOR
    nb, ncb = side // band, cside // band
    gl, cl, cam = f"{side}^2", f"{cside}^2", "x".join(map(str, COLOR_FRAME))
    roi = (side // 16 + 3, side * 7 // 16 + 5)  # off the band edges
    n_roi = -(-(-(-roi[1] // 8) * 8 - (roi[0] - roi[0] % 8)) // band)  # container rows 8-aligned
    gray = _camera_frame(side, side, seed=43)
    rgb = np.stack([_camera_frame(cside, cside, seed=s) for s in (44, 45, 46)], axis=-1)
    rgb_cam = _camera_rgb(*COLOR_FRAME)
    img8 = gray[:cside, :cside].copy()
    dct_cfg = CodecConfig(transform="dct")
    c_dct, _ = encode_gray_auto(p, img8, dct_cfg, device=dev)  # the f32 path: an off-int8 stream
    dct_stream = serialize.coefficients_to_bytes(
        c_dct.cpu().numpy(), orig_shape=img8.shape, transform="dct", codec=f"banded:{ncb}")
    c8k, _ = encode_gray_auto(p, img8, cfg, device=dev)
    cplanes, cmeta = mc.encode_color_u8(p, rgb, cfg, device=dev)
    mesh = P.band_mesh(devices=[dev] * 4)
    torch.cuda.synchronize()
    stats = []  # (label, wall s, peak, reserved peak, band bytes, seconds per part)

    def run(label, expected, fn, band_bytes, bound=None):
        profiling.reset()
        profiling.enable()
        try:
            out, wall, peak, resv = _memory_peak(lambda: step(label, expected, fn))
        finally:
            profiling.disable()
        stats.append((label, wall, peak, resv, band_bytes, st.seconds(profiling.snapshot())))
        if bound is not None and peak >= bound:
            _fail(f"{label}: peak device memory {peak} B reaches half of the image's bytes ({bound} B)")
        return out

    gband, cband = band * side, band * cside  # one band's pixels
    half = gray.nbytes // 2
    enc = {"hp_encode_u8": nb}
    dec = {"hp_decode_u8": nb}
    cenc = lambda mode, n: {f"color_split_{mode}_u8": n, "hp_encode_u8": 2 * n}  # noqa: E731
    cdec = lambda mode, n: {"hp_decode_u8": 2 * n, f"color_merge_{mode}_u8": n}  # noqa: E731
    cam_bands = -(-mc.color_kernel_shape(*COLOR_FRAME)[0] // band)
    with tempfile.TemporaryDirectory() as tmp:
        f = {k: os.path.join(tmp, k) for k in ("gray.npy", "g.tdc", "g.npy", "o.npy")}
        np.save(f["gray.npy"], gray)
        hp.reset_launches()
        ck.reset_launches()
        t0 = time.perf_counter()
        out = {}
        out["g"] = run(f"{gl} encode_gray_streamed_bytes band {band}", enc,
                       lambda: st.encode_gray_streamed_bytes(p, gray, cfg, band_rows=band, device=dev)[0],
                       2 * gband, half)
        g = out["g"]
        out["full"] = run(f"{gl} decode_gray_streamed", dec,
                          lambda: st.decode_gray_streamed(p, g, band_rows=band, device=dev), 2 * gband, half)
        out["s2"] = run(f"{gl} decode_gray_streamed scale_m=2", {"hp_scaled_decode_u8": nb},
                        lambda: st.decode_gray_streamed(p, g, band_rows=band, scale_m=2, device=dev),
                        gband + gband // 16, half)
        out["p4"] = run(f"{gl} decode_gray_streamed n_planes=4", dec,
                        lambda: st.decode_gray_streamed(p, g, band_rows=band, n_planes=4, device=dev),
                        2 * gband, half)
        out["roi"] = run(f"{gl} decode_gray_streamed row_range={roi}", {"hp_decode_u8": n_roi},
                         lambda: st.decode_gray_streamed(p, g, band_rows=band, row_range=roi, device=dev),
                         2 * gband, half)
        out["npy"] = run(f"{gl} decode_gray_streamed out_npy", dec,
                         lambda: st.decode_gray_streamed(p, g, band_rows=band, out_npy=f["o.npy"], device=dev),
                         2 * gband, half)
        out["rt"] = run(f"{gl} roundtrip_u8_streamed band {STREAM_RT_BAND}",
                        {"hp_roundtrip_u8": side // STREAM_RT_BAND},
                        lambda: st.roundtrip_u8_streamed(p, gray, cfg, band_rows=STREAM_RT_BAND, device=dev),
                        3 * STREAM_RT_BAND * side)
        out["dct"] = run(f"{cl} decode_gray_streamed, an off-int8 stream (transform dct)", {"hp_idct": ncb},
                         lambda: st.decode_gray_streamed(p, dct_stream, band_rows=band, device=dev),
                         5 * cband)
        for mode in ("420", "444"):
            sub = False if mode == "444" else mode
            cs = run(f"{cl} RGB encode_color_streamed_bytes {mode} band {band}", cenc(mode, ncb),
                     lambda: st.encode_color_streamed_bytes(p, rgb, cfg, band_rows=band, subsample=sub,
                                                            device=dev)[0], 6 * cband)
            out[f"c{mode}"] = cs
            out[f"cd{mode}"] = run(f"{cl} RGB decode_color_streamed {mode}", cdec(mode, ncb),
                                   lambda: st.decode_color_streamed(p, cs, band_rows=band, device=dev), 6 * cband)
        for mode in ("420", "422"):
            cs = run(f"{cam} encode_color_streamed_bytes {mode} band {band}", cenc(mode, cam_bands),
                     lambda: st.encode_color_streamed_bytes(p, rgb_cam, cfg, band_rows=band, subsample=mode,
                                                            device=dev)[0], 6 * band * COLOR_FRAME[1])
            out[f"cam{mode}"] = cs
            out[f"camd{mode}"] = run(f"{cam} decode_color_streamed {mode}", cdec(mode, cam_bands),
                                     lambda: st.decode_color_streamed(p, cs, band_rows=band, device=dev),
                                     6 * band * COLOR_FRAME[1])
        run(f"{gl} cli encode --band-rows {band}", enc,
            lambda: _cli(cli, ["encode", "--band-rows", str(band), f["gray.npy"], f["g.tdc"]], card),
            2 * gband, half)
        run(f"{gl} cli decode --band-rows {band}", dec,
            lambda: _cli(cli, ["decode", "--band-rows", str(band), f["g.tdc"], f["g.npy"]], card),
            2 * gband, half)
        out["sh"] = run(f"{cl} roundtrip_u8_streamed_sharded band {band} over 4 virtual ranks",
                        {"hp_roundtrip_u8": 4 * -(-cside // max(128, band - band % 128))},
                        lambda: st.roundtrip_u8_streamed_sharded(p, img8, mesh, cfg, band_rows=band), 3 * cband)
        sc = P.shard_image(c8k, mesh)
        splanes = {k: P.shard_image(v.contiguous(), mesh) for k, v in cplanes.items()}
        run(f"{cl} save_sharded over 4 virtual ranks", {},
            lambda: P.save_sharded(os.path.join(tmp, "sh.tdc"), sc, orig_shape=img8.shape), 0)
        run(f"{cl} RGB save_color_sharded over 4 virtual ranks", {},
            lambda: P.save_color_sharded(os.path.join(tmp, "sh.tdcc"), splanes, cmeta), 0)
        launches = counts()
        print(f"  streamed path: {time.perf_counter() - t0:.1f} s for the streamed calls; launches:",
              json.dumps(launches))
        # the checks (their launches come after the counts were read)
        files = {k: open(os.path.join(tmp, k), "rb").read() for k in ("g.tdc", "sh.tdc", "sh.tdcc")}
        npy_cli, npy_lib = np.load(f["g.npy"]), np.load(f["o.npy"])
    _check_streamed(p, cfg, dev, gray, rgb, rgb_cam, img8, out, files, npy_cli, npy_lib, roi, c_dct, c8k,
                    cplanes, cmeta, card)
    _print_streamed(stats, gray.nbytes, card)
    _inmemory_baselines(p, cfg, dev, gray, rgb, out["g"], out["c420"], card)
    return launches


def _cli(cli, argv: list, card: str) -> None:
    """tpudct_torch.cli.main(argv) in process; its output printed after."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    for line in buf.getvalue().splitlines():
        print(f"    {line}" + (f" [{card}]" if line.startswith("{") else ""))
    if rc != 0:
        _fail(f"cli {argv}: exit code {rc}")


def _check_streamed(p, cfg, dev, gray, rgb, rgb_cam, img8, out, files, npy_cli, npy_lib, roi, c_dct, c8k,
                    cplanes, cmeta, card: str) -> None:
    """Every streamed output against the in-memory path on the card."""
    from tpudct_torch import CodecConfig
    from tpudct_torch.models import color as mc
    from tpudct_torch.models.dispatch import decode_gray_auto, decode_gray_scaled_auto, encode_gray_auto
    from tpudct_torch.utils import serialize

    side, band, cside = STREAM_SIDE, STREAM_BAND, STREAM_COLOR
    gl, cl, cam = f"{side}^2", f"{cside}^2", "x".join(map(str, COLOR_FRAME))

    def same(label, got, want):
        if not np.array_equal(got, want):
            _fail(f"{label}: differs from the in-memory path")
        print(f"  {label}: equal to the in-memory path")

    c, shape = encode_gray_auto(p, gray, cfg, device=dev)
    c = c.cpu().numpy()
    want = serialize.coefficients_to_bytes(c, orig_shape=shape, codec=f"banded:{side // band}")
    if serialize.banded_rows(side, side // band) != [band] * (side // band):
        _fail("banded_rows does not split the gray frame into the streamed bands")
    same(f"{gl} streamed .tdc bytes ({len(out['g'])}) = coefficients_to_bytes(encode_gray_auto, banded:8)",
         np.frombuffer(out["g"], np.uint8), np.frombuffer(want, np.uint8))
    same(f"{gl} cli encode --band-rows file", np.frombuffer(files["g.tdc"], np.uint8), np.frombuffer(want, np.uint8))
    full = decode_gray_auto(p, c, cfg, shape, device=dev)
    same(f"{gl} decode_gray_streamed = decode_gray_auto", out["full"], full)
    same(f"{gl} decode_gray_streamed out_npy = decode_gray_auto", npy_lib, full)
    same(f"{gl} cli decode --band-rows = decode_gray_auto", npy_cli, full)
    same(f"{gl} scale_m=2 = decode_gray_scaled_auto", out["s2"], decode_gray_scaled_auto(p, c, cfg, shape, 2, device=dev))
    same(f"{gl} n_planes=4 = decode_gray_auto of the 4-plane map", out["p4"],
         decode_gray_auto(p, serialize._zero_high_planes(c.copy(), 4), cfg, shape, device=dev))
    a, b = roi
    a8, b8 = a - a % 8, -(-b // 8) * 8
    same(f"{gl} row_range={roi} = decode_gray_auto of rows {a8}:{b8}", out["roi"],
         decode_gray_auto(p, c[a8:b8], cfg, (b8 - a8, shape[1]), device=dev)[a - a8 : b - a8])
    mc8, mr8 = p.roundtrip_u8(torch.as_tensor(gray, device=dev), cfg)
    same(f"{gl} roundtrip_u8_streamed coefficients = roundtrip_u8", out["rt"][0], mc8.cpu().numpy())
    same(f"{gl} roundtrip_u8_streamed reconstruction = roundtrip_u8", out["rt"][1], mr8.cpu().numpy())
    del mc8, mr8
    dct_cfg = CodecConfig(transform="dct")
    same(f"{cl} off-int8 stream = decode_gray_auto", out["dct"],
         decode_gray_auto(p, c_dct, dct_cfg, img8.shape))
    for mode, img, label, n in (("420", rgb, f"{cl} RGB", cside // band), ("444", rgb, f"{cl} RGB", cside // band),
                                ("420", rgb_cam, cam, None), ("422", rgb_cam, cam, None)):
        key = ("c" if img is rgb else "cam") + mode
        sub = False if mode == "444" else mode
        planes, meta = mc.encode_color_u8(p, img, cfg, subsample=sub, device=dev)
        planes = {k: v.cpu().numpy() for k, v in planes.items()}
        if n is not None:
            cwant = serialize.color_to_bytes(planes, meta, codec=f"banded:{n}")
            same(f"{label} {mode} streamed .tdcc bytes ({len(out[key])}) = color_to_bytes(encode_color_u8, "
                 f"banded:{n})", np.frombuffer(out[key], np.uint8), np.frombuffer(cwant, np.uint8))
        else:
            back, _m = serialize.bytes_to_color(out[key])
            same(f"{label} {mode} streamed .tdcc planes = encode_color_u8's",
                 np.concatenate([back[k].ravel() for k in back]), np.concatenate([planes[k].ravel() for k in back]))
        same(f"{label} {mode} decode_color_streamed = decode_color_auto",
             out[("cd" if img is rgb else "camd") + mode],
             mc.decode_color_auto(p, planes, meta, cfg, device=dev).cpu().numpy())
    mc8, mr8 = p.roundtrip_u8(torch.as_tensor(img8, device=dev), cfg)
    same(f"{cl} roundtrip_u8_streamed_sharded (4 virtual ranks) = roundtrip_u8",
         np.concatenate([out["sh"][0].ravel(), out["sh"][1].ravel()]),
         np.concatenate([mc8.cpu().numpy().ravel(), mr8.cpu().numpy().ravel()]))
    c8 = c8k.cpu().numpy()
    same(f"{cl} save_sharded bytes = coefficients_to_bytes(banded:4)", np.frombuffer(files["sh.tdc"], np.uint8),
         np.frombuffer(serialize.coefficients_to_bytes(c8, orig_shape=img8.shape, codec="banded:4"), np.uint8))
    hplanes = {k: v.cpu().numpy() for k, v in cplanes.items()}
    same(f"{cl} RGB save_color_sharded bytes = color_to_bytes(banded:4)", np.frombuffer(files["sh.tdcc"], np.uint8),
         np.frombuffer(serialize.color_to_bytes(hplanes, cmeta, codec="banded:4"), np.uint8))


def _print_streamed(stats, image_bytes: int, card: str) -> None:
    """Each streamed call's host wall and its split, device busy share and
    peak device memory beside one band's bytes."""
    mb = 1 / 2**20
    for label, wall, peak, resv, band_bytes, sec in stats:
        split = ", ".join(f"{k} {sec.get(k, 0.0) * 1e3:.1f}" for k in
                          ("stage", "h2d", "kernels", "d2h", "wait", "finish", "entropy"))
        busy = sec.get("device_busy", 0.0)
        print(f"  {label}: wall {wall * 1e3:.1f} ms (ms: {split}); device busy {busy * 1e3:.1f} ms = "
              f"{busy / wall:.1%} of the wall; peak device memory {peak * mb:.1f} MiB allocated, "
              f"{resv * mb:.1f} MiB reserved, one band's bytes {band_bytes * mb:.1f} MiB, the gray image "
              f"{image_bytes * mb:.1f} MiB [{card}]")


def _inmemory_baselines(p, cfg, dev, gray, rgb, g_stream, c_stream, card: str) -> None:
    """The in-memory calls that return numpy (pageable host copies), with
    their walls and peaks: the streamed calls' baseline."""
    from tpudct_torch.models import color as mc
    from tpudct_torch.models.dispatch import decode_gray_auto, encode_gray_auto
    from tpudct_torch.utils import serialize

    mb = 1 / 2**20
    shape = gray.shape
    (c, _), w_enc, pk_enc, _r = _memory_peak(lambda: encode_gray_auto(p, gray, cfg, device=dev))
    c_np, w_fetch, _pk, _r = _memory_peak(lambda: c.cpu().numpy())
    del c
    t0 = time.perf_counter()
    serialize.coefficients_to_bytes(c_np, orig_shape=shape, codec=f"banded:{STREAM_SIDE // STREAM_BAND}")
    t_ent = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_back = serialize.bytes_to_coefficients(g_stream)[0]
    t_dent = time.perf_counter() - t0
    _rec, w_dec, pk_dec, _r = _memory_peak(lambda: decode_gray_auto(p, c_back, cfg, shape, device=dev))
    print(f"  in-memory {STREAM_SIDE}^2: encode_gray_auto {w_enc * 1e3:.1f} ms (peak {pk_enc * mb:.1f} MiB) + "
          f".cpu() of the coefficients {w_fetch * 1e3:.1f} ms + coefficients_to_bytes banded:8 "
          f"{t_ent * 1e3:.1f} ms; bytes_to_coefficients {t_dent * 1e3:.1f} ms + decode_gray_auto "
          f"(from host, to numpy) {w_dec * 1e3:.1f} ms (peak {pk_dec * mb:.1f} MiB) [{card}]")
    (planes, meta), w_cenc, pk_cenc, _r = _memory_peak(lambda: mc.encode_color_u8(p, rgb, cfg, device=dev))
    hplanes, w_cf, _pk, _r = _memory_peak(lambda: {k: v.cpu().numpy() for k, v in planes.items()})
    del planes
    t0 = time.perf_counter()
    back, bmeta = serialize.bytes_to_color(c_stream)
    t_cd = time.perf_counter() - t0
    _rec, w_cdec, pk_cdec, _r = _memory_peak(
        lambda: mc.decode_color_auto(p, back, bmeta, cfg, device=dev).cpu().numpy())
    print(f"  in-memory {STREAM_COLOR}^2 RGB 420: encode_color_u8 {w_cenc * 1e3:.1f} ms (peak "
          f"{pk_cenc * mb:.1f} MiB) + .cpu() of the planes {w_cf * 1e3:.1f} ms; bytes_to_color {t_cd * 1e3:.1f} ms "
          f"+ decode_color_auto to numpy {w_cdec * 1e3:.1f} ms (peak {pk_cdec * mb:.1f} MiB) [{card}]")


def _entropy_stages(c: np.ndarray, card: str) -> None:
    """Every --entropy stage on one map: written, then parsed back to the
    same map by the native decoders and by the pure-Python ones."""
    from tpudct_torch.utils import serialize

    label = f"{c.shape[0]}x{c.shape[1]}"
    for stage in ENTROPY_STAGES:
        t0 = time.perf_counter()
        blob = serialize.coefficients_to_bytes(c, codec=stage)
        t1 = time.perf_counter()
        native = serialize.bytes_to_coefficients(blob)[0]
        t2 = time.perf_counter()
        before = os.environ.get("TPUDCT_NO_NATIVE_JPEG")
        os.environ["TPUDCT_NO_NATIVE_JPEG"] = "1"  # the pure-Python decoders
        try:
            plain = serialize.bytes_to_coefficients(blob)[0]
        finally:
            if before is None:
                del os.environ["TPUDCT_NO_NATIVE_JPEG"]
            else:
                os.environ["TPUDCT_NO_NATIVE_JPEG"] = before
        t3 = time.perf_counter()
        if not (np.array_equal(native, c) and np.array_equal(plain, c)):
            _fail(f"{label} --entropy {stage}: the stream does not parse back to the same map")
        codec = serialize.inspect_stream(blob)["codec"]
        print(f"  {label} --entropy {stage} ({codec}): {len(blob)} bytes; encode {(t1 - t0) * 1e3:.1f} ms, "
              f"native parse {(t2 - t1) * 1e3:.1f} ms, pure-Python parse {(t3 - t2) * 1e3:.1f} ms "
              f"(host clock) [{card}]; both equal to the map")


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


def _in_turns(kern, other, dev, reps: int = 20) -> tuple:
    """(kernel ms, kernel ms, (other ms, other ms) or None): the kernel
    twice, with what it is held against (its library call, or the composed
    kernels computing the same function), where it has one, twice in
    between (kernel, other, other, kernel)."""
    k1 = _time(kern, dev, reps)
    lib = (_time(other, dev, reps), _time(other, dev, reps)) if other else None
    return k1, _time(kern, dev, reps), lib


def _composed_420(y, cc, half: int):
    """B20's composed counterpart: hp_decode_u8 on the luma plane and on
    the stacked chroma (chroma table), then color_merge_420_u8."""
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp

    return ck.color_merge_420_u8(hp.hp_decode_u8(y), *hp.hp_decode_u8(cc, q_table="chroma").split(half))


def _composed_ring(rk, ck, y, pack, fy, fc, ry, rc) -> None:
    """B16's composed counterpart on a slot: ring_forward_decode (B15) on
    the luma slot and on the chroma pack slot (chroma table), forwarding
    both, then color_merge_420_u8."""
    rk.ring_forward_decode(y, fy, ry)
    rk.ring_forward_decode(pack, fc, rc, q_table="chroma")
    half = pack.shape[0] // 2
    ck.color_merge_420_u8(ry, rc[:half], rc[half:])


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
            # the direct instances on the same frame, interleaved
            hwc = rgb.movedim(0, -1).contiguous()
            for mode in COLOR_MODES:
                yd, ccd = ck.color_split_direct_u8(hwc, mode)
                pl = (yd, *ccd.split(ccd.shape[0] // 2))
                fns[f"color_split_direct_{mode}"] = (lambda m=mode: ck.color_split_direct_u8(hwc, m),
                                                     lambda m=mode: ck.split_direct_plain(hwc, m))
                fns[f"color_merge_direct_{mode}"] = (lambda m=mode, pl=pl: ck.color_merge_direct_u8(*pl, h, w, m),
                                                     lambda m=mode, pl=pl: ck.merge_direct_plain(*pl, h, w, m))
            # the study kernels: the copies work in place on their own map
            # (its values stay), the fused pair on its own RGB and planes
            xs = _noise(h, w, seed=8, dev=dev)
            rgb_s = _rgb_noise(h, w, seed=12, dev=dev)
            planes_s = study.color_encode_420_u8(rgb_s)
            cc_s = torch.cat(planes_s[1:])
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
            # the u8 study variants on their own noise map (the tiles are inert)
            xv = _noise(h, w, seed=16, dev=dev)
            for f in (V.rt_u8_vint, V.rt_u8_vbf, V.rt_u8_vcs):
                fns[f.__name__] = (lambda f=f: f(xv), lambda: hp.roundtrip_u8_plain(xv))
            for kern in (V._k_enc_nosub, V._k_enc_nolane, V._k_enc_xor, V._k_enc_nibble, V._k_enc_truncless,
                         V._k_enc_nibble_truncless, V._k_enc_k256):
                fns[kern.name] = (lambda g=V._mk(kern, 128, 512): g(xv), lambda t=kern.plain: t(xv))
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
            "hp_scaled_decode_u8[2x2 f32]": (1 + 4 / 4, lambda: hp.hp_scaled_decode_u8(ci8, 2, 2),
                                             lambda: hp.scaled_decode_u8_plain(ci8, 2, 2)),
            "hp_scaled_decode_u8[8x8 f32]": (1 + 4 / 64, lambda: hp.hp_scaled_decode_u8(ci8, 8, 8),
                                             lambda: hp.scaled_decode_u8_plain(ci8, 8, 8)),
        }
        # the library calls, timed in turns with their kernels: u8_copy's,
        # Tensor.copy_ of the same bytes into a distinct tensor (torch skips
        # an in-place one); u8_copy2's, the one call with its int8 output's
        # values, x.view(torch.int8).clone() (2 B/px: it leaves out the
        # kernel's in-place u8 write)
        library, composed = {}, {}
        if label == f"{SQUARE}^2":
            dst = torch.empty_like(xs)
            library["u8_copy"] = ("Tensor.copy_ into a distinct tensor", lambda: dst.copy_(xs))
            library["u8_copy2"] = ("x.view(torch.int8).clone()", lambda: xs.view(torch.int8).clone())
            composed["color_decode_420_u8"] = lambda: _composed_420(planes_s[0], cc_s, h // 2)
        rows = [(name, KERNELS[name][2], kern, plain) for name, (kern, plain) in fns.items()]
        rows += [(name, *v) for name, v in variants.items()]
        for name, bpp, kern, plain in rows:
            p1 = _time(plain, dev, 3)
            k1, k2, lib = _in_turns(kern, library[name][1] if name in library else composed.get(name), dev)
            p2 = _time(plain, dev, 3)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            gbps = bpp * h * w / (ms * 1e-3) / 1e9
            times[(name, label)] = (ms, plain_ms)
            bound = f"; bound {_bound(name, h, w)[0]:.4f} ms" if name in KERNELS else ""
            print(f"  {label} {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; "
                  f"kernel {gbps:.1f} GB/s = {gbps * 1e9 / HBM_PEAK_BPS:.1%} of 3.35 TB/s{bound} "
                  f"[{card}]")
            if lib and name in library:
                times["library"][name] = (lib[0] + lib[1]) / 2
                print(f"  {label} {name} in turns with {library[name][0]} (its library call): kernel {k1:.4f}, "
                      f"library {lib[0]:.4f}, library {lib[1]:.4f}, kernel {k2:.4f} ms; kernel / library "
                      f"{ms / times['library'][name]:.3f} [{card}]")
            if lib and name in composed:
                c_ms = (lib[0] + lib[1]) / 2
                bound = _bound(name, h, w)[0]
                print(f"  {label} {name} in turns with its composed counterpart (hp_decode_u8 on the luma and "
                      f"the stacked chroma, then color_merge_420_u8): kernel {k1:.4f}, composed {lib[0]:.4f}, "
                      f"composed {lib[1]:.4f}, kernel {k2:.4f} ms; kernel at {bound / ms:.1%} of its bound "
                      f"{bound:.4f} ms, composed at {bound / c_ms:.1%}; kernel / composed {ms / c_ms:.3f} [{card}]")
        if label == f"{SQUARE}^2":
            _time_copy2_pair(fns["u8_copy2"][0], xs, dev, card)
            rt, floor = times[("hp_roundtrip_u8", label)][0], times[("u8_copy2", label)][0]
            print(f"  {label} hp_roundtrip_u8 (B1) {rt:.4f} ms against B1's byte floor u8_copy2 (B18) "
                  f"{floor:.4f} ms: {rt / floor:.2f}x [{card}]")
            v1, b9 = times[("color_merge_v1", label)][0], times[("color_merge_420_u8", label)][0]
            print(f"  {label} color_merge_v1 (compare-form round) {v1:.4f} ms beside color_merge_420_u8 (B9, "
                  f"add-form round) {b9:.4f} ms: {v1 / b9:.3f}x [{card}]")
    _time_direct_camera(dev, card)
    ring_times, copy_ms = _time_rings(dev, card)
    times.update(ring_times)
    times["library"]["ring_forward"] = copy_ms
    return times


def _time_direct_camera(dev, card: str) -> None:
    """At the camera frame (interleaved): each direct split and merge
    beside its twin and its bound, in turns with what it replaces on the
    reference's grid (the split: the layout copy, the edge pad to the grid,
    B8/B10/B12 and the chroma stack; the merge: B9/B11/B13 on the grid's
    planes); then the 4:2:0 roundtrip_color_u8 in turns with the grid's
    chain (device ms per call, host gaps between launches included)."""
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.models import color as mc
    from tpudct_torch.ops.padding import pad_to_kernel

    h, w = COLOR_FRAME
    cam = torch.as_tensor(_camera_rgb(h, w), device=dev)
    label = f"{h}x{w}"
    for mode in COLOR_MODES:
        split, merge = f"color_split_direct_{mode}", f"color_merge_direct_{mode}"
        grid_split, grid_merge = (getattr(ck, f"color_{d}_{mode}_u8") for d in ("split", "merge"))

        def passes(f=grid_split):
            cb, cr = f(pad_to_kernel(cam.movedim(-1, 0).contiguous(), 64, 256)[0])[1:]
            return torch.cat([cb, cr])

        yd, ccd = ck.color_split_direct_u8(cam, mode)
        pl = (yd, *ccd.split(ccd.shape[0] // 2))
        gpl = grid_split(pad_to_kernel(cam.movedim(-1, 0).contiguous(), 64, 256)[0])
        for name, kern, plain, other, what in (
            (split, lambda m=mode: ck.color_split_direct_u8(cam, m), lambda m=mode: ck.split_direct_plain(cam, m),
             passes, f"the layout copy, the edge pad, color_split_{mode}_u8 and the chroma stack"),
            (merge, lambda m=mode: ck.color_merge_direct_u8(*pl, h, w, m),
             lambda m=mode: ck.merge_direct_plain(*pl, h, w, m), lambda f=grid_merge: f(*gpl),
             f"color_merge_{mode}_u8 on the grid's planes"),
        ):
            p1 = _time(plain, dev, 3)
            k1, k2, (o1, o2) = _in_turns(kern, other, dev)
            bound = _bound(name, h, w)[0]
            ms = (k1 + k2) / 2
            print(f"  {label} {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms; bound {bound:.4f} ms, "
                  f"kernel at {bound / ms:.1%} of it; in turns with {what}: {o1:.4f} / {o2:.4f} ms, kernel / "
                  f"those {2 * ms / (o1 + o2):.3f} [{card}]")
    p, cfg = get_pipeline("hp"), CodecConfig()
    k1, k2, (o1, o2) = _in_turns(lambda: mc.roundtrip_color_u8(p, cam, cfg),
                                 lambda: _parent_color_chain(p, cfg, cam, "420"), dev)
    print(f"  {label} roundtrip_color_u8 4:2:0 (direct) {k1:.4f} / {k2:.4f} ms in turns with the grid's chain "
          f"{o1:.4f} / {o2:.4f} ms: {(k1 + k2) / (o1 + o2):.3f}x; floor 7.5 B/px "
          f"{7.5 * h * w / HBM_PEAK_BPS * 1e3:.4f} ms [{card}]")


def _time_copy2_pair(kern, xs, dev, card: str) -> None:
    """u8_copy2 (B18) in turns with the torch pair that writes what it
    writes: Tensor.copy_ of the u8 map into a distinct tensor, then the int8
    clone of that copy (each call reads the map once, 4 B/px in all)."""
    u = torch.empty_like(xs)

    def pair():
        u.copy_(xs)
        return u.view(torch.int8).clone()

    k1, k2, (a1, a2) = _in_turns(kern, pair, dev)
    n = xs.numel()
    print(f"  {SQUARE}^2 u8_copy2 in turns with copy_ into a distinct u8 tensor, then its int8 clone: kernel "
          f"{k1:.4f}, pair {a1:.4f}, pair {a2:.4f}, kernel {k2:.4f} ms; kernel / pair "
          f"{(k1 + k2) / (a1 + a2):.3f}; kernel {3 * n / ((k1 + k2) / 2 * 1e-3) / 1e9:.1f} GB/s at 3 B/px, pair "
          f"{4 * n / ((a1 + a2) / 2 * 1e-3) / 1e9:.1f} GB/s at 4 B/px [{card}]")


def _print_composed_ring(label: str, k1: float, k2: float, comp: tuple, bound: float, card: str) -> None:
    ms, c_ms = (k1 + k2) / 2, (comp[0] + comp[1]) / 2
    print(f"  {label}: ring_forward_decode_color (B16) in turns with its composed counterpart (B15 on the luma "
          f"and the chroma pack slots, forwarding both, then color_merge_420_u8): kernel {k1:.4f}, composed "
          f"{comp[0]:.4f}, composed {comp[1]:.4f}, kernel {k2:.4f} ms; kernel at {bound / ms:.1%} of its bound "
          f"{bound:.4f} ms, composed at {bound / c_ms:.1%}; kernel / composed {ms / c_ms:.3f} [{card}]")


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
    B14 in turns with Tensor.copy_), then per launch (B14 in turns with
    Tensor.copy_ of the same slot) and per whole ring at each rank count.
    Returns (times, B14's library ms at SQUARE^2)."""
    from tpudct_torch import parallel as P
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp
    from tpudct_torch.kernels import ring as rk

    x = _noise(SQUARE, SQUARE, seed=9, dev=dev)
    c = hp.hp_encode_u8(x)
    cy, ccb, ccr = _color_planes(_rgb_noise(SQUARE, SQUARE, seed=10, dev=dev))
    pack = P.chroma_band_pack(ccb, ccr, 1)
    e = torch.empty_like
    dst, fwd, rec, fy, fc = e(x), e(c), e(x), e(cy), e(pack)
    rgb = torch.empty((3, SQUARE, SQUARE), dtype=torch.uint8, device=dev)
    ry, rc = e(x), torch.empty(pack.shape, dtype=torch.uint8, device=dev)  # the composed B16's planes
    fns = {
        "ring_forward": (lambda: rk.ring_forward(x, dst), lambda: rk.forward_plain(x, dst)),
        "ring_forward_decode": (lambda: rk.ring_forward_decode(c, fwd, rec),
                                lambda: rk.forward_decode_plain(c, fwd, rec)),
        "ring_forward_decode_color": (lambda: rk.ring_forward_decode_color(cy, pack, fy, fc, rgb),
                                      lambda: rk.forward_decode_color_plain(cy, pack, fy, fc, rgb)),
    }
    times = {}
    others = {"ring_forward": lambda: dst.copy_(x),
              "ring_forward_decode_color": lambda: _composed_ring(rk, ck, cy, pack, fy, fc, ry, rc)}
    for name, (kern, plain) in fns.items():
        p1 = _time(plain, dev, 3)
        k1, k2, lib = _in_turns(kern, others.get(name), dev)
        p2 = _time(plain, dev, 3)
        ms = (k1 + k2) / 2
        times[(name, f"{SQUARE}^2")] = (ms, (p1 + p2) / 2)
        gbps = KERNELS[name][2] * SQUARE * SQUARE / (ms * 1e-3) / 1e9
        print(f"  {SQUARE}^2 slot with its forward, {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms; {gbps:.1f} GB/s = {gbps * 1e9 / HBM_PEAK_BPS:.1%} of 3.35 TB/s; bound "
              f"{_bound(name, SQUARE, SQUARE)[0]:.4f} ms [{card}]")
        if lib and name == "ring_forward":
            copy_ms = (lib[0] + lib[1]) / 2
            print(f"  {SQUARE}^2 {name} in turns with Tensor.copy_ (its library call): kernel {k1:.4f}, copy_ "
                  f"{lib[0]:.4f}, copy_ {lib[1]:.4f}, kernel {k2:.4f} ms; kernel / copy_ {ms / copy_ms:.3f} "
                  f"[{card}]")
        if lib and name == "ring_forward_decode_color":
            _print_composed_ring(f"{SQUARE}^2 slot", k1, k2, lib, _bound(name, SQUARE, SQUARE)[0], card)
    for n in (1, 2, 4, 8):
        mesh, br = P.band_mesh(devices=[dev] * n), SQUARE // n
        pack_n = P.chroma_band_pack(ccb, ccr, n)
        launch = {
            "B14": lambda: rk.ring_forward(x[:br], dst[:br]),
            "B15": lambda: rk.ring_forward_decode(c[:br], fwd[:br], rec[:br]),
        }
        b16 = _in_turns(lambda: rk.ring_forward_decode_color(cy[:br], pack_n[:br], fy[:br], fc[:br], rgb[:, :br]),
                        lambda: _composed_ring(rk, ck, cy[:br], pack_n[:br], fy[:br], fc[:br], ry[:br], rc[:br]),
                        dev)
        _print_composed_ring(f"n={n} ({br}x{SQUARE} slots)", *b16, 6 * br * SQUARE / HBM_PEAK_BPS * 1e3, card)
        args = {
            "ring_all_gather": (P.shard_image(x, mesh), mesh),
            "ring_decode_gather": (P.shard_image(c, mesh), mesh),
            "ring_decode_color_gather": (P.shard_image(cy, mesh), P.shard_image(pack_n, mesh), mesh),
        }
        b14 = _in_turns(launch.pop("B14"), lambda: dst[:br].copy_(x[:br]), dev)
        per = {"B14": (b14[0] + b14[1]) / 2, "B16": (b16[0] + b16[1]) / 2,
               **{k: _time(f, dev, 20) for k, f in launch.items()}}
        whole = {name: _time(lambda: getattr(P, name)(*a), dev, 5) for name, a in args.items()}
        times[("rings", n)] = (per, whole)
        bounds = {k: b / HBM_PEAK_BPS * 1e3 for k, b in _ring_bytes(n, SQUARE).items()}
        slot_bound = 2 * br * SQUARE / HBM_PEAK_BPS * 1e3
        print(f"  n={n} ({br}x{SQUARE} slots): B14 in turns with Tensor.copy_ of the slot: kernel {b14[0]:.4f}, "
              f"copy_ {b14[2][0]:.4f}, copy_ {b14[2][1]:.4f}, kernel {b14[1]:.4f} ms; kernel / copy_ "
              f"{2 * per['B14'] / sum(b14[2]):.3f}; bound {slot_bound:.4f} ms, kernel at "
              f"{slot_bound / per['B14']:.1%} of it [{card}]")
        print(f"  n={n} ({br}x{SQUARE} slots): per launch with forward B14 {per['B14']:.4f}, B15 "
              f"{per['B15']:.4f}, B16 {per['B16']:.4f} ms; whole ring "
              + ", ".join(f"{k} {whole[k]:.4f} ms (bound {bounds[k]:.4f})" for k in whole) + f" [{card}]")
    return times, copy_ms


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
    # first, while this process is small: a child's ru_maxrss starts from
    # its parent's resident set (carried over fork and exec)
    runs = [timed(phase_archive_path, card)]
    timed(phase_tf32)
    errs = timed(phase_compare, dev)
    timed(phase_gate, dev)
    runs += [timed(phase, dev) for phase in (phase_main_path, phase_color_main_path, phase_multi_main_path,
                                             phase_study_path)]
    runs.append(timed(phase_measurement_path, dev, card))
    runs.append(timed(phase_file_path, dev, card))
    runs.append(timed(phase_streamed_path, dev, card))
    runs.append(timed(phase_bulk_path, dev, card))
    runs.append(timed(phase_coefficient_path, dev, card))
    runs.append(timed(phase_multi_process_path, dev, card))
    launches, headline_ms = timed(phase_headline_bench, dev, card)
    runs.append(launches)
    times = timed(phase_timing, dev, card)
    b1_ms = times[("hp_roundtrip_u8", f"{SQUARE}^2")][0]
    print(f"headline bench value {headline_ms} ms against phase 7's B1 (hp_roundtrip_u8, {SQUARE}^2) {b1_ms:.4f} "
          f"ms: {headline_ms / b1_ms:.3f}x [{card}]")
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
    import sys

    if sys.argv[1:2] == ["--mp-worker"]:  # one process of phase 6's multi-process path
        raise SystemExit(_mp_worker(*map(int, sys.argv[2:8]), *sys.argv[8:10]))
    raise SystemExit(main())
