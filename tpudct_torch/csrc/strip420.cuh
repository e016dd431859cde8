// The 4:2:0 color decode of one 16 x 256 luma strip by one thread block,
// shared by ring.cu (B16, which also forwards what it reads) and study.cu
// (B20, the fused decode), and the strip geometry study.cu's fused encode
// (B19) stages in the same shape.
//
// Each of 96 threads first decodes one 8x8 block as hp_decode_u8 (B3) does:
// threads 0-63 a luma block, 64-79 a cb block, 80-95 a cr block, each into
// shared memory as u8; then all threads merge the strip 8 pixels at a time as
// color_merge_420_u8 (B9) does.  One thread per 16x16 window, decoding its two
// chroma blocks and then its four luma blocks in turn, needs 255 registers
// (8 warps per SM) and ran 4x slower as B16's first form.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "color_px.cuh"  // ColorConsts, byte_at, merge_px
#include "hp_block.cuh"  // HpConsts, inv_block, load_forward_i8, to_u8, ROWS

namespace {

constexpr int kStripRows = 16, kStripCols = 256;  // the luma strip of one thread block
constexpr int kLumaBlocks = (kStripRows / 8) * (kStripCols / 8);  // 64
constexpr int kChromaBlocks = 2 * (kStripCols / 16);              // 16 cb + 16 cr
constexpr int kStripThreads = kLumaBlocks + kChromaBlocks;        // 96

// This thread block's strip: the luma (row, column) of its top-left pixel.
__device__ __forceinline__ void strip_origin(int w, long long& r0, long long& c0) {
  const int strips = w / kStripCols;
  r0 = static_cast<long long>(blockIdx.x / strips) * kStripRows;
  c0 = static_cast<long long>(blockIdx.x % strips) * kStripCols;
}

// One 8x8 int8 block at element offset o of a map with rows of w: loaded,
// forwarded (when fwd is given) and decoded with the table k into x (f32,
// + 128, not yet clamped).
__device__ __forceinline__ void decode_block(const int8_t* __restrict__ src,
                                             int8_t* __restrict__ fwd, long long o, int w,
                                             const HpConsts& k, float (&x)[64]) {
  ROWS(load_forward_i8(src, fwd, ro, x + 8 * r));
  inv_block(x, k);
}

// The u8 of 8 decoded values as two little-endian words.
__device__ __forceinline__ uint2 pack_u8(const float* x) {
  uint2 v = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v.x |= to_u8(x[e]) << (8 * e);
    v.y |= to_u8(x[4 + e]) << (8 * e);
  }
  return v;
}

// Decode and merge this thread block's strip of a (h, w) luma map y and its
// (h/2, w/2) chroma planes cb, cr into planar rgb (planes `plane` elements
// apart), forwarding each block's bytes to fy / fcb / fcr where they are not
// null.  kCompareRound picks merge_px's rounding.  Call with kStripThreads
// threads.
template <bool kCompareRound>
__device__ __forceinline__ void decode_merge_strip_420(
    const int8_t* __restrict__ y, const int8_t* __restrict__ cb, const int8_t* __restrict__ cr,
    int8_t* __restrict__ fy, int8_t* __restrict__ fcb, int8_t* __restrict__ fcr,
    uint8_t* __restrict__ rgb, long long plane, int w, const HpConsts& kl, const HpConsts& kc,
    const ColorConsts& kk) {
  __shared__ __align__(16) uint8_t ys[kStripRows][kStripCols];
  __shared__ __align__(16) uint8_t cs[2][kStripRows / 2][kStripCols / 2];  // cb, cr
  long long r0, c0;
  strip_origin(w, r0, c0);
  const int t = threadIdx.x, cw = w / 2;
  float x[64];
  if (t < kLumaBlocks) {
    const int by = t / (kStripCols / 8), bx = t % (kStripCols / 8);
    decode_block(y, fy, (r0 + by * 8) * w + c0 + bx * 8, w, kl, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) *reinterpret_cast<uint2*>(&ys[by * 8 + i][bx * 8]) = pack_u8(x + 8 * i);
  } else {
    const int q = t - kLumaBlocks, pl = q / (kStripCols / 16), bx = q % (kStripCols / 16);
    decode_block(pl ? cr : cb, pl ? fcr : fcb, (r0 / 2) * cw + c0 / 2 + bx * 8, cw, kc, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) *reinterpret_cast<uint2*>(&cs[pl][i][bx * 8]) = pack_u8(x + 8 * i);
  }
  __syncthreads();
  constexpr int kSegs = kStripRows * kStripCols / 8;  // 8-pixel row segments of the strip
  for (int s = t; s < kSegs; s += kStripThreads) {
    const int row = s / (kStripCols / 8), col = (s % (kStripCols / 8)) * 8;
    uint32_t yw[2], cbw[1], crw[1];
    const uint2 yv = *reinterpret_cast<const uint2*>(&ys[row][col]);
    yw[0] = yv.x;
    yw[1] = yv.y;
    cbw[0] = *reinterpret_cast<const uint32_t*>(&cs[0][row / 2][col / 2]);
    crw[0] = *reinterpret_cast<const uint32_t*>(&cs[1][row / 2][col / 2]);
    uint32_t rv[2] = {0u, 0u}, gv[2] = {0u, 0u}, bv[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t r, g, b;
      merge_px<kCompareRound>(static_cast<float>(byte_at(yw, j)),
                              static_cast<float>(byte_at(cbw, j / 2) - 128),
                              static_cast<float>(byte_at(crw, j / 2) - 128), kk, r, g, b);
      const int sh = 8 * (j & 3);
      rv[j >> 2] |= r << sh;
      gv[j >> 2] |= g << sh;
      bv[j >> 2] |= b << sh;
    }
    const long long o = (r0 + row) * w + c0 + col;
    *reinterpret_cast<uint2*>(rgb + o) = make_uint2(rv[0], rv[1]);
    *reinterpret_cast<uint2*>(rgb + plane + o) = make_uint2(gv[0], gv[1]);
    *reinterpret_cast<uint2*>(rgb + 2 * plane + o) = make_uint2(bv[0], bv[1]);
  }
}

}  // namespace
