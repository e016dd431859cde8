// The 4:2:0 color decode of 16 x 256 luma strips: the one body of ring.cu's
// B16 (k_ring_forward_decode_color, which also forwards the coefficients it
// reads to the next rank) and study.cu's B20 (k_color_decode_420), and the
// strip geometry study.cu's fused encode (B19) stages in the same shape.
// TPU kernels replaced: tpudct/parallel/ring.py:568 (_ring_decode_color_kernel)
// and benchmarks/color_fused_ab.py:221 (_k_color_dec).
//
// Value chain, bit for bit: hp_decode_u8's (B3) butterfly decode of each
// luma and chroma 8x8 block (dequantize c * s, A^T M A over A = Ts, + 128,
// clamp and truncate to u8), then color_merge_420_u8's (B9) pixel chain
// (nearest 2x2 chroma, the BT.601 inverse with its true division, the add
// form round trunc(clip(z) + 0.5)).  B20's twin rounds with the compare form
// _to_u8, which equals the add form on every (y, cb, cr) triple
// (tests/test_torch_color.py's 256^3 sweep), so both kernels run the add form.
//
// Bound: memory.  Bytes per luma pixel (each input read once, each output
// written once): B16 6 (luma 1 + 1 forwarded, chroma 0.5 + 0.5, RGB 3), B20
// 4.5; at 8192^2 and 3.35 TB/s 0.120 and 0.090 ms.  The instructions come
// close to that: about 53 per luma pixel (1.5 coefficients and one merged
// pixel), 0.106 ms of the card's issue slots at 8192^2 and 1.98 GHz.
//
// Design.  The first strip body ran 31 rounded f32 operations per coefficient (a
// dense 8x8 product by Ts) and 10.5 (B16) or 13.5 (B20) type conversions
// per luma pixel, which run 16 per clock per SM against 128 f32 operations,
// so it was bound by instruction issue (30% and 20% of its byte bound).
// Here:
//  - An add-only inverse per integer core (hp_block.cuh's inv_core, which
//    B1, B3 and B15 run too): Ts is compiled in (core_ts, one kernel
//    instance per core), and each output sums only its nonzero terms
//    in the dense chain's k = 0..7 order, +-1 as an add or subtract and +-2
//    as v + v.  Exact: a product by +-1 or +-2 is exact, and a product by 0
//    adds +-0, which leaves every nonzero sum as it is, so only the sign of a
//    zero can differ, and the + 128 removes it (as long as no dequantized
//    value overflows f32).  About 8 adds per coefficient for haweel.
//  - No conversion instruction per pixel: a byte becomes f32 as the float
//    whose bits are 2^23's with the byte as its low mantissa (one PRMT),
//    minus 2^23; a value in [0, 2^23) is floored by adding 2^23 rounding
//    down (its integer part lands in the low mantissa bits).  What remains
//    (an I2F and an F2I or few) is the block index's integer division, once
//    a thread.
//  - The decoded strip is kept in shared memory as exact-integer f32 (the
//    chroma already shifted by -128), and each merge unit (2 rows x 8
//    columns) reads its four chroma pairs once and multiplies them once for
//    the four pixels that share them.
//  - One block of 96 threads per strip: each thread loads its 8x8 block's
//    rows (and forwards them, B16) and decodes it (threads 0-63 luma, 64-79
//    cb, 80-95 cr), then all merge.  80 registers and 24 KB of shared memory
//    give 8 blocks (24 warps) per SM.  Timed beside it on the card and
//    dropped (PERF.md section 6): a persistent grid staging each
//    strip's 6 KB of coefficients by TMA bulk copies, double-buffered (96
//    registers, 37 KB: 6 blocks per SM, 20-25% slower); a 4th warp that only
//    merges (3-5% slower); swizzled f32 planes free of bank conflicts (no
//    change).  One thread per 16x16 window, six blocks in flight, took the
//    first form to 255 registers and 4x the time.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "color_px.cuh"  // ColorConsts, luma_f32 (B19's luma)
#include "hp_block.cuh"  // HpConsts; the add-only block chain (B19's forward) and byte forms

namespace {

constexpr int kStripRows = 16, kStripCols = 256;  // the luma strip of one thread block
constexpr int kLumaBlocks = (kStripRows / 8) * (kStripCols / 8);  // 64
constexpr int kChromaBlocks = 2 * (kStripCols / 16);              // 16 cb + 16 cr
constexpr int kStripThreads = kLumaBlocks + kChromaBlocks;        // 96
constexpr int kChromaRows = kStripRows / 2, kChromaCols = kStripCols / 2;
constexpr int kMergeUnits = (kStripRows / 2) * (kStripCols / 8);  // 2 rows x 8 columns each: 256

// This thread block's strip: the luma (row, column) of its top-left pixel.
__device__ __forceinline__ void strip_origin(int w, long long& r0, long long& c0) {
  const int strips = w / kStripCols;
  r0 = static_cast<long long>(blockIdx.x / strips) * kStripRows;
  c0 = static_cast<long long>(blockIdx.x % strips) * kStripCols;
}

// ---- the merge's round ------------------------------------------------------

// trunc(clip(z) + 0.5) (color_px.cuh's trunc_u8) as an int: the same as
// clip(floor(fl(z + 0.5)), 0, 255) for |z| < 2^22 (the clip moves only
// values it sends to 0 or 255).  The floor: 1.5 * 2^23 + v rounded down has
// the bits 0x4B400000 + floor(v); the subtraction and the clip are one DPX
// instruction (max(min(a + b, c), 0)).
__device__ __forceinline__ uint32_t round_u8_bits(float z) {
  const int bits = __float_as_int(__fadd_rd(__fadd_rn(z, 0.5f), 12582912.0f));
  return static_cast<uint32_t>(__viaddmin_s32_relu(bits, -0x4B400000, 255));
}

// ---- the strip ---------------------------------------------------------------

// The strip's constants: the dequantization multipliers s (qdd) of the luma
// and the chroma tables, and the color chain's.
struct StripConsts {
  float sl[64], sc[64];
  ColorConsts kk;
};

// One 8x8 int8 block, its rows as 8-byte words, decoded with the
// multipliers s into rows 0..7 of plane (pitch floats apart), columns 8 g
// to + 8, as exact f32 minus `shift` (128 for chroma).  The unpack is
// bytes_minus_128's, written out beside its multiply: through the helper,
// then a multiply loop, nvcc compiles B16 and B20 to other code.
template <int kCore>
__device__ __forceinline__ void decode_block(const uint2 (&v)[8], const float (&s)[64], float shift, float* plane,
                                             int pitch, int g) {
  float x[64];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint32_t lo = v[r].x ^ 0x80808080u, hi = v[r].y ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[8 * r + e] = __fmul_rn(__fsub_rn(biased_byte(lo, e), kTwo23 + 128.0f), s[8 * r + e]);
      x[8 * r + 4 + e] = __fmul_rn(__fsub_rn(biased_byte(hi, e), kTwo23 + 128.0f), s[8 * r + 4 + e]);
    }
  }
  inv_core<kCore>(x);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* q = x + 8 * r + 4 * h;
      *reinterpret_cast<float4*>(plane + r * pitch + 8 * g + 4 * h) =
          make_float4(clamp_floor(q[0], shift), clamp_floor(q[1], shift), clamp_floor(q[2], shift),
                      clamp_floor(q[3], shift));
    }
}

// B9's pixel chain given pr = crc KR2 and pb = cbc KB2 (computed once for
// the 2x2 pixels that share them).
__device__ __forceinline__ void merge_px_420(float yf, float pr, float pb, const ColorConsts& k, uint32_t& r,
                                             uint32_t& g, uint32_t& b) {
  const float rf = __fadd_rn(yf, pr);
  const float bf = __fadd_rn(yf, pb);
  const float gf = __fdiv_rn(__fsub_rn(__fsub_rn(yf, __fmul_rn(rf, k.kr)), __fmul_rn(bf, k.kb)), k.kg);
  r = round_u8_bits(rf);
  g = round_u8_bits(gf);
  b = round_u8_bits(bf);
}

// Merge unit u of the decoded strip (rows 2 (u / 32) and the next, columns
// 8 (u % 32) to + 8) into planar rgb.
__device__ __forceinline__ void merge_unit(const float (&ys)[kStripRows][kStripCols],
                                           const float (&cs)[2][kChromaRows][kChromaCols], int u, long long r0,
                                           long long c0, int w, long long plane, uint8_t* __restrict__ rgb,
                                           const ColorConsts& kk) {
  const int rp = u / (kStripCols / 8), g = u % (kStripCols / 8), col = 8 * g;
  const float4 cb = *reinterpret_cast<const float4*>(&cs[0][rp][4 * g]);
  const float4 cr = *reinterpret_cast<const float4*>(&cs[1][rp][4 * g]);
  const float pb[4] = {__fmul_rn(cb.x, kk.kb2), __fmul_rn(cb.y, kk.kb2), __fmul_rn(cb.z, kk.kb2),
                       __fmul_rn(cb.w, kk.kb2)};
  const float pr[4] = {__fmul_rn(cr.x, kk.kr2), __fmul_rn(cr.y, kk.kr2), __fmul_rn(cr.z, kk.kr2),
                       __fmul_rn(cr.w, kk.kr2)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 2 * rp + i;
    const float4 ya = *reinterpret_cast<const float4*>(&ys[row][col]);
    const float4 yb = *reinterpret_cast<const float4*>(&ys[row][col + 4]);
    const float yv[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
    uint32_t r[8], gg[8], b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) merge_px_420(yv[j], pr[j / 2], pb[j / 2], kk, r[j], gg[j], b[j]);
    const long long o = (r0 + row) * w + c0 + col;
    *reinterpret_cast<uint2*>(rgb + o) = make_uint2(pack4(r[0], r[1], r[2], r[3]), pack4(r[4], r[5], r[6], r[7]));
    *reinterpret_cast<uint2*>(rgb + plane + o) =
        make_uint2(pack4(gg[0], gg[1], gg[2], gg[3]), pack4(gg[4], gg[5], gg[6], gg[7]));
    *reinterpret_cast<uint2*>(rgb + 2 * plane + o) =
        make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
  }
}

// Decode and merge this thread block's strip of a (h, w) luma map y and its
// (h/2, w/2) chroma planes cb, cr into planar rgb (planes `plane` elements
// apart), forwarding every coefficient row to fy / fcb / fcr where they are
// not null.  Thread t < 64 decodes luma block (t / 32, t % 32) of the
// strip, thread 64 + 16 p + b block b of chroma plane p (cb, cr); then all
// threads merge.  Launched by launch_strips (one block per strip).
template <int kCore>
__device__ __forceinline__ void decode_merge_strip_420(
    const int8_t* __restrict__ y, const int8_t* __restrict__ cb, const int8_t* __restrict__ cr, int8_t* fy,
    int8_t* fcb, int8_t* fcr, uint8_t* __restrict__ rgb, long long plane, int w, const StripConsts& k) {
  __shared__ __align__(16) float ys[kStripRows][kStripCols];
  __shared__ __align__(16) float cs[2][kChromaRows][kChromaCols];
  const int t = threadIdx.x;
  long long r0, c0;
  strip_origin(w, r0, c0);
  {
    const bool luma = t < kLumaBlocks;
    const int q = t - kLumaBlocks, pl = luma ? 0 : 1 + q / (kChromaCols / 8);
    const int by = luma ? t / (kStripCols / 8) : 0, g = luma ? t % (kStripCols / 8) : q % (kChromaCols / 8);
    const int pitch = luma ? w : w / 2;
    const long long o = luma ? (r0 + 8 * by) * w + c0 + 8 * g : (r0 / 2) * (w / 2) + c0 / 2 + 8 * g;
    const int8_t* src = pl == 0 ? y : pl == 1 ? cb : cr;
    int8_t* fwd = pl == 0 ? fy : pl == 1 ? fcb : fcr;
    uint2 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const long long ro = o + r * static_cast<long long>(pitch);
      v[r] = *reinterpret_cast<const uint2*>(src + ro);
      if (fwd) *reinterpret_cast<uint2*>(fwd + ro) = v[r];
    }
    if (luma)
      decode_block<kCore>(v, k.sl, 0.0f, &ys[8 * by][0], kStripCols, g);
    else
      decode_block<kCore>(v, k.sc, 128.0f, &cs[pl - 1][0][0], kChromaCols, g);
  }
  __syncthreads();
  for (int u = t; u < kMergeUnits; u += kStripThreads) merge_unit(ys, cs, u, r0, c0, w, plane, rgb, k.kk);
}

// Launches kernel(args...), a kernel that runs decode_merge_strip_420,
// over the strips of an (h, w) luma map (h % 16 == 0, w % 256 == 0, checked
// by the caller) on the current device in `stream`: one block of
// kStripThreads threads per strip.  Returns a cudaError_t value after
// checking the launch.
template <class... Params, class... Args>
int launch_strips(void (*kernel)(Params...), int h, int w, cudaStream_t stream, Args... args) {
  const long long strips = static_cast<long long>(h / kStripRows) * (w / kStripCols);
  kernel<<<dim3(static_cast<unsigned>(strips)), kStripThreads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
