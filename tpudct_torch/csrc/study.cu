// Study kernels for NVIDIA Hopper (sm_90a): the measurement path's copy
// floors and the fused 4:2:0 color codec, built with the codec sources by
// tpudct_torch/kernels/_build.py into one shared library with a plain C
// interface (loaded with ctypes).
//
// Entry points and the Pallas TPU kernels they replace (benchmarks/):
//   u8_copy_launch, i8 null   B17  k_u8_copy<false>  u8_perf.py u8_copy (_copy_kernel)
//   u8_copy_launch            B18  k_u8_copy<true>   u8_perf.py u8_copy2 (_copy2_kernel)
//   color_encode_420_launch   B19  k_color_encode_420
//                                  color_fused_ab.py color_encode_420_u8 (_k_color_enc)
//   color_decode_420_launch   B20  k_color_decode_420
//                                  color_fused_ab.py color_decode_420_u8 (_k_color_dec)
//
// What they compute.
//   B17  an (H, W) u8 map copied onto itself (dst may equal src: the
//        reference aliases its output to its input): the HBM floor of a u8
//        pass, 2 B/px.
//   B18  the same, plus the bytes once more as int8 (the wrapping cast, a
//        reinterpretation): hp_roundtrip_u8's (B1) byte pattern, 3 B/px, with
//        no arithmetic.
//   B19  (3, H, W) u8 RGB -> int8 coefficients of Y (H, W), Cb and Cr
//        (H/2, W/2) in one pass.  Luma: the f32 BT.601 KR r + KG g + KB b,
//        every product and sum rounded on its own (luma_f32), then _to_u8
//        (round_u8: clip, floor, +1 where frac >= 0.5) and the level shift;
//        NOT the production split's 16-bit fixed-point luma (B8), so B19's Y
//        differs from the composed path's by +-1 where the two roundings
//        part.  Chroma: B8's exact 2x2 pool, BT.601 and round (split_chroma).
//        Then B2's exact integer forward and quantizer (fwd_block) with the
//        luma table for Y and the chroma table for Cb and Cr.
//   B20  Y, Cb, Cr int8 -> (3, H, W) u8 RGB in one pass: B3's butterfly
//        decode of every block, trunc and clamp, nearest 2x2 chroma
//        replication and the BT.601 inverse with the compare-form round
//        _to_u8, which equals the production merge's add form (B9) on every
//        input, so B20 is bit-identical to decode_color_u8 (B3 twice, B9).
// The TPU kernels stack Cb over Cr for one K=128 contraction and pool with
// 0/1 matrices on the MXU; the integer forward is exact per 8x8 block, so
// here each chroma block is transformed on its own.  The plain twins in
// kernels/study.py compute the same chains, so kernel and twin agree bit for
// bit.
//
// Design.  B17/B18: a grid-stride loop of 16-byte loads and stores, a few
// waves of blocks.  B19: one thread block of 128 threads per 16 x 256 luma
// strip; each thread first reads a 2 x 16 window of the three planes (16
// bytes a row), writes its 32 shifted-luma bytes and its 8 Cb and 8 Cr bytes
// into shared memory, then threads 0-63 each run the forward of one luma
// block and threads 64-95 of one chroma block from shared memory (one 8x8
// block of f32 live per thread).  B20: B16's strip form (strip420.cuh)
// without the forward stores.  A thread per 16x16 window with six blocks in
// flight took B16's first form to 255 registers and 4x the time.
//
// Bound: memory.  Bytes per luma pixel (each input read once, each output
// written once): B17 2, B18 3, B19 and B20 4.5 (RGB 3, coefficients 1.5); at
// 8192^2 and 3.35 TB/s 0.040, 0.060 and 0.090 ms.  The arithmetic (B19: B8's
// and B2's chains plus the f32 luma, about 50 operations per pixel; B20: B3's
// 1.5 times plus B9's) is under that at the card's f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strip420.cuh"  // strip geometry and decode; HpConsts, fwd_block; ColorConsts, luma_f32

namespace {

constexpr int kCopyThreads = 256;
constexpr long long kMaxCopyBlocks = 132 * 16;  // a few waves of the H100's 132 SMs

// src and dst (and i8) 16-byte aligned; dst may equal src.
template <bool kI8>
__global__ void k_u8_copy(const uint8_t* src, uint8_t* dst, int8_t* i8, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = block_index();
  const long long n16 = n / 16;
  for (long long i = t; i < n16; i += stride) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[i];
    reinterpret_cast<uint4*>(dst)[i] = v;
    if constexpr (kI8) reinterpret_cast<uint4*>(i8)[i] = v;
  }
  for (long long i = n16 * 16 + t; i < n; i += stride) {
    const uint8_t v = src[i];
    dst[i] = v;
    if constexpr (kI8) i8[i] = static_cast<int8_t>(v);
  }
}

constexpr int kWinCols = 16;                                               // luma columns of a window
constexpr int kEncThreads = (kStripRows / 2) * (kStripCols / kWinCols);  // 2 x 16 windows: 128

__global__ void __launch_bounds__(kEncThreads)
    k_color_encode_420(const uint8_t* __restrict__ rgb, int8_t* __restrict__ y,
                       int8_t* __restrict__ cb, int8_t* __restrict__ cr, int h, int w,
                       const HpConsts kl, const HpConsts kc, const ColorConsts kk) {
  __shared__ __align__(16) uint8_t ys[kStripRows][kStripCols];                // luma u8
  __shared__ __align__(16) uint8_t cs[2][kStripRows / 2][kStripCols / 2];  // cb, cr u8
  long long r0, c0;
  strip_origin(w, r0, c0);
  const long long plane = static_cast<long long>(h) * w;
  const int t = threadIdx.x;
  {
    const int a = t / (kStripCols / kWinCols), g = t % (kStripCols / kWinCols);  // window row pair, column
    int sum[3][kWinCols / 2];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int v = 0; v < kWinCols / 2; ++v) sum[c][v] = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 2 * a + i;
      const long long ro = (r0 + row) * w + c0 + g * kWinCols;
      uint32_t px[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) load_bytes<16>(rgb + c * plane + ro, px[c]);
      uint32_t yv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < kWinCols; ++e) {
        const int r = byte_at(px[0], e), gg = byte_at(px[1], e), b = byte_at(px[2], e);
        const float yf = luma_f32(static_cast<float>(r), static_cast<float>(gg), static_cast<float>(b), kk);
        yv[e >> 2] |= round_u8(yf) << (8 * (e & 3));
        sum[0][e / 2] += r - 128;
        sum[1][e / 2] += gg - 128;
        sum[2][e / 2] += b - 128;
      }
      store_bytes<16>(&ys[row][g * kWinCols], yv);
    }
    uint32_t cbv[2] = {0u, 0u}, crv[2] = {0u, 0u};
#pragma unroll
    for (int v = 0; v < kWinCols / 2; ++v) {
      uint32_t zb, zr;
      split_chroma(sum[0][v], sum[1][v], sum[2][v], 0.25f, kk, zb, zr);
      cbv[v >> 2] |= zb << (8 * (v & 3));
      crv[v >> 2] |= zr << (8 * (v & 3));
    }
    store_bytes<8>(&cs[0][a][g * kWinCols / 2], cbv);
    store_bytes<8>(&cs[1][a][g * kWinCols / 2], crv);
  }
  __syncthreads();
  if (t >= kStripThreads) return;  // one warp stages only
  float x[64];
  if (t < kLumaBlocks) {
    const int by = t / (kStripCols / 8), bx = t % (kStripCols / 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) load_u8_shifted(&ys[by * 8 + i][bx * 8], x + 8 * i);
    fwd_block(x, kl);
    const long long o = (r0 + by * 8) * w + c0 + bx * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) store_i8(y + o + i * static_cast<long long>(w), x + 8 * i);
  } else {
    const int q = t - kLumaBlocks, pl = q / (kStripCols / 16), bx = q % (kStripCols / 16);
#pragma unroll
    for (int i = 0; i < 8; ++i) load_u8_shifted(&cs[pl][i][bx * 8], x + 8 * i);
    fwd_block(x, kc);
    const int cw = w / 2;
    const long long o = (r0 / 2) * cw + c0 / 2 + bx * 8;
    int8_t* out = pl ? cr : cb;
#pragma unroll
    for (int i = 0; i < 8; ++i) store_i8(out + o + i * static_cast<long long>(cw), x + 8 * i);
  }
}

__global__ void __launch_bounds__(kStripThreads)
    k_color_decode_420(const int8_t* __restrict__ y, const int8_t* __restrict__ cb,
                       const int8_t* __restrict__ cr, uint8_t* __restrict__ rgb, int h, int w,
                       const HpConsts kl, const HpConsts kc, const ColorConsts kk) {
  decode_merge_strip_420<true>(y, cb, cr, nullptr, nullptr, nullptr, rgb,
                               static_cast<long long>(h) * w, w, kl, kc, kk);
}

inline int strip_prologue(int device, int h, int w) {
  if (h <= 0 || w <= 0 || h % kStripRows || w % kStripCols) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

inline dim3 strip_grid(int h, int w) {
  return dim3(static_cast<unsigned>(static_cast<long long>(h / kStripRows) * (w / kStripCols)));
}

}  // namespace

// ---- C interface -------------------------------------------------------------
// Pointers are device pointers (16-byte aligned, contiguous) except the
// consts, host pointers to 320 floats laid out as HpConsts (luma, chroma;
// the integer core's tables for the encode, the butterfly's for the decode)
// or 9 floats laid out as ColorConsts.  u8_copy_launch copies n bytes of src
// to dst (which may be src) and, unless i8 is null, to i8; the color
// launchers need h % 16 == 0 and w % 256 == 0.  Each function returns a
// cudaError_t value (0 = ok; hp_error_string in hp_codec.cu names it) after
// checking the launch; it neither synchronizes nor allocates.

extern "C" {

int u8_copy_launch(const void* src, void* dst, void* i8, long long n, void* stream, int device) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err || n == 0) return err;
  const long long blocks = (n / 16 + kCopyThreads - 1) / kCopyThreads;
  const dim3 grid(static_cast<unsigned>(blocks < 1 ? 1 : blocks < kMaxCopyBlocks ? blocks : kMaxCopyBlocks));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(src);
  auto* d = static_cast<uint8_t*>(dst);
  if (i8)
    k_u8_copy<true><<<grid, kCopyThreads, 0, s>>>(x, d, static_cast<int8_t*>(i8), n);
  else
    k_u8_copy<false><<<grid, kCopyThreads, 0, s>>>(x, d, nullptr, n);
  return static_cast<int>(cudaGetLastError());
}

int color_encode_420_launch(const void* rgb, void* y, void* cb, void* cr, int h, int w,
                            const void* consts_luma, const void* consts_chroma, const void* color_consts,
                            void* stream, int device) {
  int err = strip_prologue(device, h, w);
  if (err) return err;
  k_color_encode_420<<<strip_grid(h, w), kEncThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<int8_t*>(y), static_cast<int8_t*>(cb),
      static_cast<int8_t*>(cr), h, w, *static_cast<const HpConsts*>(consts_luma),
      *static_cast<const HpConsts*>(consts_chroma), *static_cast<const ColorConsts*>(color_consts));
  return static_cast<int>(cudaGetLastError());
}

int color_decode_420_launch(const void* y, const void* cb, const void* cr, void* rgb, int h, int w,
                            const void* consts_luma, const void* consts_chroma, const void* color_consts,
                            void* stream, int device) {
  int err = strip_prologue(device, h, w);
  if (err) return err;
  k_color_decode_420<<<strip_grid(h, w), kStripThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(y), static_cast<const int8_t*>(cb), static_cast<const int8_t*>(cr),
      static_cast<uint8_t*>(rgb), h, w, *static_cast<const HpConsts*>(consts_luma),
      *static_cast<const HpConsts*>(consts_chroma), *static_cast<const ColorConsts*>(color_consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
