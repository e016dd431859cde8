// Two more kernels on hp_block.cuh's add-only inverse for NVIDIA Hopper
// (sm_90a), compiled apart from hp_codec.cu so that _build.py's one nvcc
// process per source runs them beside it: B22's unrolled digit sums and
// B7's 16 epilogues are slow in nvcc's front end (PERF.md section 6 has
// the build's seconds per source).
//
//   hp_scaled_decode_u8_launch  B7  hp_scaled_decode_u8 (tpudct/kernels/hp_pallas.py
//                                   _k_scaled_decode_u8_bf)
//   idct_split3_launch          B22 idct_x(., "c") of benchmarks/inv_formulations.py (_k_c)
//
// Value chains (hp_codec.cu's header has the codec's):
//   scaled   (B7) box sums of fr x fc windows of the clamped, truncated
//            butterfly decode (exact integers < 2^14), times 1/(fr fc) (a
//            power of two, so exact): bit-identical to
//            box_pool_u8(hp_decode_u8(c)), and to its twin
//            (kernels/hp.py scaled_decode_u8_plain).
//   split3   (B22) the butterfly inverse at q_scale 1 with each direction
//            taken per bf16 digit: M = fl(c * S); every value v of M is
//            split into three bf16 digits (round to nearest even: d1 =
//            bf16(v), d2 = bf16(v - d1), d3 = bf16(v - d1 - d2)); per digit
//            the column sum Ts^T d over k = 0..7, every product and sum
//            rounded; the three digit sums added (d1 + d2) + d3; then the
//            same on the rows of that result against Ts, + 128.  The TPU
//            form's three bf16 MXU passes per direction, in one fixed order.
//            Contract: bit-identical to the twin (kernels/variants.py
//            idct_c_plain) on every finite input whose digits are all
//            finite, which is every input with |v| at most bf16's largest
//            finite value (about 3.39e38) for every value v of M and of the
//            column sums.  The kernel skips Ts's zero terms, where the
//            dense chain adds fl(0 * d): that is +-0 for a finite digit, so
//            only a zero's sign can differ, and the + 128 removes it; for a
//            non-finite digit the dense chain's 0 * inf is NaN.  Such
//            inputs are outside the contract, not a fallback.
//
// Design: one thread per 8x8 block, the block held in registers, as in
// hp_codec.cu.
//   - B7 is B3's decode (k_decode_u8<core>) up to its floors, one instance
//     per integer core: the int8 rows as exact f32 by bit patterns, the
//     add-only inverse, floor_2p23; then it sums each window's floor bit
//     patterns (0x4B000000 + v) as integers (IADD3, three at a time) and
//     subtracts FR FC 0x4B000000 (mod 2^32): the exact window sum.  Its u8
//     output is that sum shifted right by log2(FR FC), its f32 output
//     (2^23 + sum) - 2^23 by the bits, times 1 / (FR FC): no I2F, F2I or
//     FRND per pixel.  (fr, fc) picks one of 16 epilogues by a switch that
//     is the same for every thread; the windows never cross a block (fr
//     and fc divide 8).
//   - B22 runs the same nonzero-term sums (inv_dot) on each bf16 digit of
//     its operand, haweel's Ts compiled in: 44 of Ts's 64 entries are
//     nonzero, and a product by +-1 or +-2 of a digit is exact (+-2 as v +
//     v), so each digit sum is about 4.75 adds per output instead of the
//     dense 8 products and 7 sums.  It transforms each column of its block
//     in place (the eight digit sums of column l overwrite column l once
//     its digits are taken), then each row, with no second 64-value array
//     live.  Its bf16 rounding is one conversion per value
//     (__float2bfloat16_rn): of the three forms measured (one per value,
//     one per pair of values, integer operations on the bits), the fastest
//     (PERF.md section 6).
//
// Bound: memory.  B7 moves 1 + 1/(fr fc) bytes per pixel (u8 out; 1 +
// 4/(fr fc) with f32 out), B22 8.  The add-only decode is about 15
// operations per pixel, B22 about 49 (per direction three digit splits and
// 3 x 5.5 nonzero terms and 2 adds, plus the dequantization and the +
// 128); the SASS instruction counts and times are in PERF.md (sections 6
// and 7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hp_block.cuh"  // HpConsts, the add-only decode chain, row access, the launch geometry, ROWS

namespace {

// ---- B22: the split3 inverse ---------------------------------------------

// The core k_idct_split3 compiles in: idct_x runs haweel (kernels/cores.py
// CORES[0]) at the luma table and q_scale 1; its wrapper checks the table.
constexpr int kSplit3Core = 0;

// v rounded to bf16 (to nearest, ties to even) as f32.
__device__ __forceinline__ float bf16_rn(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// v[0], v[S], ..., v[7 S] -> sum over k of Ts[k][i] v[k S], i = 0..7, in
// place, per bf16 digit: _split3 of benchmarks/inv_formulations.py (d1 =
// bf16(v), d2 = bf16(v - d1), d3 = bf16(v - d1 - d2)), then each digit's
// sum over its nonzero terms in the dense k order (inv_dot), the three
// added as (s1 + s2) + s3.
template <int S>
__device__ __forceinline__ void split3_dot8(float* v) {
  float r[8], d[3][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = v[k * S];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      d[p][k] = bf16_rn(r[k]);
      r[k] = __fsub_rn(r[k], d[p][k]);
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i * S] = __fadd_rn(__fadd_rn(inv_dot<kSplit3Core, 1>(i, d[0]), inv_dot<kSplit3Core, 1>(i, d[1])),
                         inv_dot<kSplit3Core, 1>(i, d[2]));
}

// B22: M = c S, then Ts^T M per digit down each column, in place, then the
// same along each row against Ts, + 128.
__global__ void k_idct_split3(const float* __restrict__ coef, float* __restrict__ rec, int h, int w,
                              const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
  ROWS(load_f32(coef + ro, x + 8 * r));
#pragma unroll
  for (int e = 0; e < 64; ++e) x[e] = __fmul_rn(x[e], k.s[e]);
#pragma unroll
  for (int l = 0; l < 8; ++l) split3_dot8<8>(x + l);
#pragma unroll
  for (int i = 0; i < 8; ++i) split3_dot8<1>(x + 8 * i);
#pragma unroll
  for (int e = 0; e < 64; ++e) x[e] = __fadd_rn(x[e], 128.0f);
  ROWS(store_f32(rec + ro, x + 8 * r));
}

// ---- B7: the scaled u8 decode ---------------------------------------------

// The FR x FC window at (i, j) of a block's floor_2p23 bit patterns, each
// 0x4B000000 + v (v the decode's u8 value), summed as integers: minus FR
// FC 0x4B000000 (mod 2^32) it is the window's sum of v, exact (at most 64 *
// 255 = 16320).
template <int FR, int FC>
__device__ __forceinline__ uint32_t window_sum(const uint32_t (&b)[64], int i, int j) {
  uint32_t s = 0u - FR * FC * 0x4B000000u;
#pragma unroll
  for (int a = 0; a < FR; ++a)
#pragma unroll
    for (int c = 0; c < FC; ++c) s += b[(i * FR + a) * 8 + j * FC + c];
  return s;
}

// N window sums (each at most 255 after the shift) as the N bytes of one
// output row, in one 8/4/2/1-byte store.
template <int N>
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint32_t* v) {
  if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack4(v[0], v[1], v[2], v[3]), pack4(v[4], v[5], v[6], v[7]));
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = pack4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(__byte_perm(v[0], v[1], 0x0040u));
  } else {
    *p = static_cast<uint8_t>(v[0]);
  }
}

// The (8 / FR) x (8 / FC) box averages of the block at block row br and
// column bc, from its floor_2p23 bit patterns, stored in the (h / FR, w /
// FC) output: u8, the window sum shifted right by log2(FR FC) (the
// truncated average: the sum is not negative), or f32, (2^23 + sum) - 2^23
// by the bits, times 1 / (FR FC), both exact.
template <int FR, int FC>
__device__ __forceinline__ void store_windows(const uint32_t (&b)[64], void* __restrict__ out, long long br,
                                              long long bc, int w, int out_u8) {
  constexpr int OR = 8 / FR, OC = 8 / FC;
  constexpr int kLog = (FR == 1 ? 0 : FR == 2 ? 1 : FR == 4 ? 2 : 3) + (FC == 1 ? 0 : FC == 2 ? 1 : FC == 4 ? 2 : 3);
  const long long ow = w / FC, oo = br * OR * ow + bc * OC;
#pragma unroll
  for (int i = 0; i < OR; ++i) {
    uint32_t s[OC];
#pragma unroll
    for (int j = 0; j < OC; ++j) s[j] = window_sum<FR, FC>(b, i, j);
    if (out_u8) {
#pragma unroll
      for (int j = 0; j < OC; ++j) s[j] >>= kLog;
      store_bytes<OC>(static_cast<uint8_t*>(out) + oo + i * ow, s);
    } else {
      float avg[OC];
#pragma unroll
      for (int j = 0; j < OC; ++j)
        avg[j] = __fmul_rn(__fsub_rn(__uint_as_float(0x4B000000u | s[j]), kTwo23), 1.0f / (FR * FC));
      store_row_f32<OC>(static_cast<float*>(out) + oo + i * ow, avg);
    }
  }
}

// B7: int8 (h, w) -> (h / fr, w / fc) box averages of B3's decode on the
// integer core kCore (the byte forms, the add-only inverse, floor_2p23),
// u8 (truncated) when out_u8, else f32.  One instance per core; (fr, fc)
// (each 1, 2, 4 or 8) picks one of 16 epilogues by a switch that is the
// same for every thread, each with static register indices and divisors.
template <int kCore>
__global__ void k_scaled_decode_u8(const int8_t* __restrict__ coef, void* __restrict__ out, int h, int w,
                                   int fr, int fc, int out_u8, const HpConsts k) {
  const long long nbw = w / 8, blk = block_index();
  if (blk >= (h / 8) * nbw) return;
  const long long br = blk / nbw, bc = blk - br * nbw;
  const long long o = br * 8 * static_cast<long long>(w) + bc * 8;
  float x[64];
  ROWS(load_forward_i8(coef, nullptr, ro, x + 8 * r));
  dequant_inverse<kCore>(x, k);
  uint32_t b[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) b[e] = __float_as_uint(floor_2p23(x[e]));
#define WINDOWS(FR, FC) \
  case FR * 16 + FC: store_windows<FR, FC>(b, out, br, bc, w, out_u8); break;
  switch (fr * 16 + fc) {
    WINDOWS(1, 1) WINDOWS(1, 2) WINDOWS(1, 4) WINDOWS(1, 8)
    WINDOWS(2, 1) WINDOWS(2, 2) WINDOWS(2, 4) WINDOWS(2, 8)
    WINDOWS(4, 1) WINDOWS(4, 2) WINDOWS(4, 4) WINDOWS(4, 8)
    WINDOWS(8, 1) WINDOWS(8, 2) WINDOWS(8, 4) WINDOWS(8, 8)
  }
#undef WINDOWS
}

}  // namespace

// ---- C interface -------------------------------------------------------------
// As hp_codec.cu's: device pointers except `consts` (320 host floats laid
// out as HpConsts); a cudaError_t value (0 = ok) after checking the launch.
// B7's `core` is its butterfly inverse's integer core (hp_block.cuh's
// core_ts, kernels/cores.py's CORES; it runs no other tier).

extern "C" {

int hp_scaled_decode_u8_launch(const void* coef, void* out, int h, int w, int fr, int fc,
                               int out_u8, int core, const void* consts, void* stream, int device) {
  using Kernel = decltype(&k_scaled_decode_u8<0>);
  static const Kernel kernels[kCores] = {k_scaled_decode_u8<0>, k_scaled_decode_u8<1>,
                                         k_scaled_decode_u8<2>, k_scaled_decode_u8<3>};
  const auto factor = [](int f) { return f == 1 || f == 2 || f == 4 || f == 8; };
  if (core < 0 || core >= kCores || !factor(fr) || !factor(fc))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w);
  if (err) return err;
  kernels[core]<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(coef), out, h, w, fr, fc, out_u8, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

// rec must not be coef: the kernel's pointers are __restrict__.
int idct_split3_launch(const void* coef, void* rec, int h, int w, const void* consts, void* stream,
                       int device) {
  if (coef == rec) return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w);
  if (err) return err;
  k_idct_split3<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coef), static_cast<float*>(rec), h, w, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
