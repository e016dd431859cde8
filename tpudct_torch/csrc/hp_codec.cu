// hp codec kernels for NVIDIA Hopper (sm_90a): the fused 8x8 blockwise
// approximate-DCT codec pass, built by tpudct_torch/kernels/_build.py with
// nvcc into a shared library with a plain C interface (loaded with ctypes).
//
// Entry points and the Pallas TPU kernels they replace
// (tpudct/kernels/hp_pallas.py):
//   hp_rt_u8_launch             B1  hp_roundtrip_u8  (_k_rt_u8_bf, _k_rt_u8)
//   hp_encode_u8_launch         B2  hp_encode_u8     (_k_encode_u8)
//   hp_decode_u8_launch         B3  hp_decode_u8     (_k_decode_u8_bf, _k_decode_u8);
//                               B15 with a forward pointer: ring_decode_gather's
//                                   hop (tpudct/parallel/ring.py _ring_decode_kernel)
//   hp_rt_f32_launch            B4  hp_roundtrip     (_k_rt_int_bf, _k_rt_int;
//                               B4' with literal=1:   _k_rt_f32_bf, _k_rt_f32)
//   hp_dct_launch               B5  hp_dct           (_k_dct_int, _k_dct_f32)
//   hp_idct_launch              B6  hp_idct          (_k_idct_bf, _k_idct)
//   hp_scaled_decode_u8_launch  B7  hp_scaled_decode_u8 (_k_scaled_decode_u8_bf)
//   idct_split3_launch          B22 idct_x(., "c") of benchmarks/inv_formulations.py (_k_c)
// (idct_x(., "b"), _k_b, is B6's butterfly at q_scale 1: hp_idct_launch, B21.)
//
// Value chain (identical to the reference's, rounding included):
//   forward, integer core
//            c = trunc(fl(fl(f32(Ts X Ts^T) * scale) + copysign(0.5)))
//            Ts X Ts^T is exact integer arithmetic (|Ts| <= 2, |X| <= 128,
//            every partial sum < 2^24, so it is exact in f32 with or
//            without FMA contraction); scale = d_i d_l / (Q q_scale) times
//            the zonal mask.  The multiply and the tie-add are each rounded
//            (__fmul_rn, __fadd_rn): an FMA there moves which .5 ties flip.
//   forward, f32-literal core (any f32 pixels; every transform)
//            Z = T (X - 128) T^T with the literal f32 T, rows k = 0..7 then
//            columns l = 0..7, every product and sum rounded on its own;
//            c = trunc(fl(fl(Z / (Q q_scale)) + copysign(0.5))) * mask.
//            True division (__fdiv_rn), as the reference divides: a
//            reciprocal multiply moves ties.  The zonal mask multiplies
//            after rounding, so a masked negative coefficient is -0.0.
//   inverse  M = fl(c * S); X = A^T M A summed k = 0..7 over rows, then
//            j = 0..7 over columns, every product and sum rounded on its own
//            (no FMA), then + 128.  A = Ts with S = Q q_scale d d^T is the
//            "butterfly" tier; A = T (f32 literals) with S = Q q_scale is
//            the "highest" tier: one body, two constant sets.  The
//            reference's "high" tier (a bf16x3 MXU product, there because
//            the TPU has no f32 MXU path) runs the "highest" constants.
//   u8 out   clamp(trunc(X + 128), 0, 255).
//   split3   (B22) the butterfly inverse at q_scale 1 with each direction
//            taken per bf16 digit: M = fl(c * S); every value v of M is
//            split exactly into three bf16 digits (round to nearest even:
//            d1 = bf16(v), d2 = bf16(v - d1), d3 = bf16(v - d1 - d2)); per
//            digit the column sum Ts^T d over k = 0..7, every product and
//            sum rounded; the three digit sums added (d1 + d2) + d3; then
//            the same on the rows of that result against Ts, + 128.  The
//            TPU form's three bf16 MXU passes per direction, in one fixed
//            order.
//   scaled   box sums of fr x fc windows of the clamped, truncated decode
//            (exact integers < 2^14), times 1/(fr fc) (a power of two, so
//            exact): bit-identical to box_pool_u8(hp_decode_u8(c)).
//
// The plain twins in kernels/hp.py (and kernels/variants.py for split3) sum
// in the same order, so kernel and twin agree bit for bit.
//
// Design: one thread per 8x8 block, the block held in registers.  A thread
// reads its block as 8 row loads of 8 bytes (u8/int8) or 32 bytes (f32);
// consecutive threads own horizontally adjacent blocks, so a warp's row
// load is one contiguous 256-byte (or 1 KiB) span.  The 8x8 constants ride
// the kernel parameters (constant bank, read uniformly by the warp).  The
// scaled decode pools inside the thread's block (fr and fc divide 8, so no
// window crosses a block) and is instantiated per (fr, fc) so that every
// register index is static.
//
// B1, B2 and B3 (and so B15) run hp_block.cuh's add-only chain, one
// instance per integer core (the launchers' `core`): their dense form was
// bound by instruction issue, not bytes (16 FMAs per pixel for the forward,
// about 31 rounded f32 operations per coefficient for the inverse and 3
// (B2, B3) or 5 (B1) type conversions per pixel, which issue 16 per clock
// per SM against 128 f32 operations).  B2 is B1's encode half, one
// device function (encode_block_u8), so the two code the same coefficients
// by construction.  Now:
//   - bytes become exact f32 by bit patterns (PRMT, then - 2^23 - 128), the
//     decode floors and clamps by min/max and a round-down add of 2^23, and
//     the bytes are packed by PRMT: no I2F, F2I or FRND per pixel;
//   - the forward Ts X Ts^T is exact integer arithmetic in f32, so it
//     runs in any order: even/odd butterflies, then each output's nonzero
//     terms (+-2 as one FMA), about 4.5 adds per pixel for haweel against
//     the dense form's 16 FMAs;
//   - the quantizer keeps the double rounding (fl(core * scale), then
//     fl(+ copysign(0.5))), and truncates by a round-down add of 2^23 to
//     the magnitude, the sign restored by copysign; the int8 byte is the
//     low byte of 1.5 * 2^23 + c;
//   - the inverse sums only the nonzero terms of the dense sums, in their
//     k = 0..7 order (the dequantized values are not integers, so the order
//     is the twin's): a zero term adds +-0, so only a zero's sign can
//     differ, and the + 128 removes it.
// The "highest" and "high" tiers (the dense f32 T) run inv_block in an
// instance of their own (inverse id kDense), on the same exact byte forms.
//
// Bound: memory.  The fused u8 pass moves 3 bytes per pixel (read u8, write
// int8 + u8): 192 MiB at 8192^2, about 60 us at the H100 SXM's 3.35 TB/s;
// the u8 encode and decode 2 (B15 3, with its forward); hp_dct and hp_idct
// move 8, the f32 roundtrips 12, the scaled u8 decode 1 + 1/(fr fc), the
// split3 inverse 8.  The arithmetic is ~2k f32 operations per block for the
// dense chains (the literal forward adds 64 IEEE divisions; split3 does
// three times the inverse's products and sums, plus 5 operations per digit
// split, ~7k);
// the add-only chains' SASS instruction counts and times are in PERF.md
// (sections 6 and 7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hp_block.cuh"  // HpConsts, the forward and decode chains, row access, block_origin, ROWS

namespace {

__device__ __forceinline__ void fwd_block_literal(float x[64], const HpConsts& k) {
  // x: f32 pixels in (not shifted), quantized and masked coefficients out.
  float u[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) x[e] = __fsub_rn(x[e], 128.0f);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = __fmul_rn(k.fwd[i * 8], x[c]);
#pragma unroll
      for (int kk = 1; kk < 8; ++kk)
        acc = __fadd_rn(acc, __fmul_rn(k.fwd[i * 8 + kk], x[kk * 8 + c]));
      u[i * 8 + c] = acc;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float z = __fmul_rn(u[i * 8], k.fwd[j * 8]);
#pragma unroll
      for (int l = 1; l < 8; ++l) z = __fadd_rn(z, __fmul_rn(u[i * 8 + l], k.fwd[j * 8 + l]));
      const float c = round_away(__fdiv_rn(z, k.fq[i * 8 + j]));
      x[i * 8 + j] = __fmul_rn(c, k.mask[i * 8 + j]);
    }
}

// ---- 8-wide row loads and stores -------------------------------------------

__device__ __forceinline__ void load_f32(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// f32 pixels: trunc to int32, subtract 128, wrap to int8 — the reference's
// (x.astype(int32) - 128).astype(int8) for the int core.
__device__ __forceinline__ void load_f32_shifted(const float* p, float* x) {
  float v[8];
  load_f32(p, v);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[e] = static_cast<float>(static_cast<int8_t>(__float2int_rz(v[e]) - 128));
}

template <int N>
__device__ __forceinline__ void store_row_f32(float* p, const float* x) {
  if constexpr (N == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

__device__ __forceinline__ void store_f32(float* p, const float* x) { store_row_f32<8>(p, x); }

// ---- kernels ---------------------------------------------------------------

// The u8 encode of the block at element offset o on the integer core kCore:
// its rows level-shifted to exact f32, the add-only forward, the quantizer
// without FRND/F2I, the int8 rows stored; x keeps the quantized
// coefficients.  B2 is this alone, B1 this and then its decode half, so
// both code the same coefficients by construction.
template <int kCore>
__device__ __forceinline__ void encode_block_u8(const uint8_t* __restrict__ img, int8_t* __restrict__ coef,
                                                long long o, int w, float (&x)[64], const HpConsts& k) {
  ROWS(load_u8_level(img + ro, x + 8 * r));
  fwd_core<kCore>(x);
  ROWS(quantize_store_i8(coef + ro, x + 8 * r, k.fq + 8 * r));
}

// The fused u8 pass on the integer core kCore: the encode, then the decode
// half on the inverse kInv: kCore's add-only inverse, or kDense (the
// "highest"/"high" tiers).
template <int kCore, int kInv>
__global__ void k_rt_u8(const uint8_t* __restrict__ img, int8_t* __restrict__ coef,
                        uint8_t* __restrict__ rec, int h, int w, const HpConsts k) {
  static_assert(kInv == kCore || kInv == kDense, "B1's inverse is its own core's or the dense one");
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
  encode_block_u8<kCore>(img, coef, o, w, x, k);
  dequant_inverse<kInv>(x, k);
  ROWS(store_u8_floor(rec + ro, x + 8 * r));
}

template <int kCore>
__global__ void k_encode_u8(const uint8_t* __restrict__ img, int8_t* __restrict__ coef,
                            int h, int w, const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
  encode_block_u8<kCore>(img, coef, o, w, x, k);
}

// The u8 decode on the integer core kCore's add-only inverse, or kDense
// (inv_block on the table a).  With fwd, each int8 row is also copied to fwd
// as it is read: the decode ring's hop (B15), forwarding the slot to the
// next rank while decoding it.
template <int kCore>
__global__ void k_decode_u8(const int8_t* __restrict__ coef, int8_t* __restrict__ fwd,
                            uint8_t* __restrict__ rec, int h, int w, const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
  ROWS(load_forward_i8(coef, fwd, ro, x + 8 * r));
  dequant_inverse<kCore>(x, k);
  ROWS(store_u8_floor(rec + ro, x + 8 * r));
}

// f32 image block -> quantized coefficients in x, on either core.
template <bool kLiteral>
__device__ __forceinline__ void load_fwd_f32(const float* __restrict__ img, long long o, int w,
                                             float x[64], const HpConsts& k) {
  if constexpr (kLiteral) {
    ROWS(load_f32(img + ro, x + 8 * r));
    fwd_block_literal(x, k);
  } else {
    ROWS(load_f32_shifted(img + ro, x + 8 * r));
    fwd_block(x, k);
  }
}

template <bool kLiteral>
__global__ void k_rt_f32(const float* __restrict__ img, float* __restrict__ coef,
                         float* __restrict__ rec, int h, int w, const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
  load_fwd_f32<kLiteral>(img, o, w, x, k);
  ROWS(store_f32(coef + ro, x + 8 * r));
  inv_block(x, k);
  ROWS(store_f32(rec + ro, x + 8 * r));
}

template <bool kLiteral>
__global__ void k_dct(const float* __restrict__ img, float* __restrict__ coef, int h, int w,
                      const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
  load_fwd_f32<kLiteral>(img, o, w, x, k);
  ROWS(store_f32(coef + ro, x + 8 * r));
}

__global__ void k_idct(const float* __restrict__ coef, float* __restrict__ rec, int h, int w,
                       const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
  ROWS(load_f32(coef + ro, x + 8 * r));
  inv_block(x, k);
  ROWS(store_f32(rec + ro, x + 8 * r));
}

// v -> its three bf16 digits as f32, d1 + d2 + d3 == v: _split3 of
// benchmarks/inv_formulations.py (each digit rounded to nearest even).
__device__ __forceinline__ void split3(float v, float& d1, float& d2, float& d3) {
  d1 = __bfloat162float(__float2bfloat16_rn(v));
  const float r1 = __fsub_rn(v, d1);
  d2 = __bfloat162float(__float2bfloat16_rn(r1));
  d3 = __bfloat162float(__float2bfloat16_rn(__fsub_rn(r1, d2)));
}

// sum over e = 0..7 of w[e * stride] * d[e], from e = 0, every product and
// sum rounded.
__device__ __forceinline__ float dot8(const float* w, int stride, const float* d) {
  float acc = __fmul_rn(w[0], d[0]);
#pragma unroll
  for (int e = 1; e < 8; ++e) acc = __fadd_rn(acc, __fmul_rn(w[e * stride], d[e]));
  return acc;
}

// The digit sums of one output: (dot8(d1) + dot8(d2)) + dot8(d3).
__device__ __forceinline__ float dot8_split3(const float* w, int stride, const float (&d)[3][8]) {
  return __fadd_rn(__fadd_rn(dot8(w, stride, d[0]), dot8(w, stride, d[1])), dot8(w, stride, d[2]));
}

__global__ void k_idct_split3(const float* __restrict__ coef, float* __restrict__ rec, int h, int w,
                              const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64], u[64], d[3][8];
  ROWS(load_f32(coef + ro, x + 8 * r));
#pragma unroll
  for (int e = 0; e < 64; ++e) x[e] = __fmul_rn(x[e], k.s[e]);
#pragma unroll
  for (int l = 0; l < 8; ++l) {  // columns: u = Ts^T M, per digit of M's column l
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) split3(x[kk * 8 + l], d[0][kk], d[1][kk], d[2][kk]);
#pragma unroll
    for (int i = 0; i < 8; ++i) u[i * 8 + l] = dot8_split3(k.a + i, 8, d);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // rows: u Ts, per digit of u's row i, + 128
#pragma unroll
    for (int l = 0; l < 8; ++l) split3(u[i * 8 + l], d[0][l], d[1][l], d[2][l]);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i * 8 + j] = __fadd_rn(dot8_split3(k.a + j, 8, d), 128.0f);
  }
  ROWS(store_f32(rec + ro, x + 8 * r));
}

// int8 (h, w) -> (h / FR, w / FC) box averages of the clamped, truncated
// decode; u8 (truncated) when out_u8, else f32.
template <int FR, int FC>
__global__ void k_scaled_decode_u8(const int8_t* __restrict__ coef, void* __restrict__ out,
                                   int h, int w, int out_u8, const HpConsts k) {
  constexpr int OR = 8 / FR, OC = 8 / FC;
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
  ROWS(load_i8(coef + ro, x + 8 * r));
  inv_block(x, k);
  float avg[OR * OC];
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      float sum = 0.0f;
#pragma unroll
      for (int a = 0; a < FR; ++a)
#pragma unroll
        for (int b = 0; b < FC; ++b) sum += clamp_trunc(x[(i * FR + a) * 8 + j * FC + b]);
      avg[i * OC + j] = sum * (1.0f / (FR * FC));
    }
  const long long nbw = w / 8, blk = block_index();
  const long long ow = w / FC;
  const long long oo = (blk / nbw) * OR * ow + (blk % nbw) * OC;
#pragma unroll
  for (int i = 0; i < OR; ++i) {
    if (out_u8)
      store_row_u8<OC>(static_cast<uint8_t*>(out) + oo + i * ow, avg + i * OC);
    else
      store_row_f32<OC>(static_cast<float*>(out) + oo + i * ow, avg + i * OC);
  }
}

constexpr int kThreads = 128;

inline dim3 grid_for(int h, int w) {
  const long long n = static_cast<long long>(h / 8) * (w / 8);
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads));
}

inline int prologue(int device, int h, int w) {
  if (h <= 0 || w <= 0 || h % 8 || w % 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

inline const HpConsts& consts_of(const void* p) { return *static_cast<const HpConsts*>(p); }

template <int FR, int FC>
void launch_scaled(const void* coef, void* out, int h, int w, int out_u8, const HpConsts& k,
                   cudaStream_t stream) {
  k_scaled_decode_u8<FR, FC><<<grid_for(h, w), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(coef), out, h, w, out_u8, k);
}

template <int FR>
int launch_scaled_fc(int fc, const void* coef, void* out, int h, int w, int out_u8,
                     const HpConsts& k, cudaStream_t stream) {
  switch (fc) {
    case 1: launch_scaled<FR, 1>(coef, out, h, w, out_u8, k, stream); return 0;
    case 2: launch_scaled<FR, 2>(coef, out, h, w, out_u8, k, stream); return 0;
    case 4: launch_scaled<FR, 4>(coef, out, h, w, out_u8, k, stream); return 0;
    case 8: launch_scaled<FR, 8>(coef, out, h, w, out_u8, k, stream); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ---- C interface -------------------------------------------------------------
// Pointers are device pointers except `consts`, a host pointer to 320 floats
// laid out as HpConsts.  hp_decode_u8_launch's `fwd` is null, or where to copy
// the int8 map as it is read (another card's memory once ring_enable_peer in
// ring.cu has given this card access to it).  `core` picks the integer core
// compiled in (hp_block.cuh's core_ts, kernels/cores.py's CORES) for the
// forward of B1 and B2.  B1's `inv` and B3's `core` pick the inverse: an
// integer core (for B1, its forward's), or kDense (-1) for inv_block on the
// table `a` (the "highest"/"high" tiers).  Each function returns a
// cudaError_t value (0 = ok) after checking the launch; it neither
// synchronizes nor allocates.

extern "C" {

int hp_rt_u8_launch(const void* img, void* coef, void* rec, int h, int w, int core, int inv,
                    const void* consts, void* stream, int device) {
  using Kernel = decltype(&k_rt_u8<0, 0>);
  static const Kernel kernels[2][kCores] = {
      {k_rt_u8<0, 0>, k_rt_u8<1, 1>, k_rt_u8<2, 2>, k_rt_u8<3, 3>},
      {k_rt_u8<0, kDense>, k_rt_u8<1, kDense>, k_rt_u8<2, kDense>, k_rt_u8<3, kDense>}};
  if (core < 0 || core >= kCores || (inv != core && inv != kDense))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w);
  if (err) return err;
  kernels[inv == kDense][core]<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<int8_t*>(coef), static_cast<uint8_t*>(rec), h, w,
      consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

int hp_encode_u8_launch(const void* img, void* coef, int h, int w, int core, const void* consts,
                        void* stream, int device) {
  using Kernel = decltype(&k_encode_u8<0>);
  static const Kernel kernels[kCores] = {k_encode_u8<0>, k_encode_u8<1>, k_encode_u8<2>, k_encode_u8<3>};
  if (core < 0 || core >= kCores) return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w);
  if (err) return err;
  kernels[core]<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<int8_t*>(coef), h, w, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

int hp_decode_u8_launch(const void* coef, void* rec, int h, int w, void* fwd, int core,
                        const void* consts, void* stream, int device) {
  using Kernel = decltype(&k_decode_u8<kDense>);
  static const Kernel kernels[1 + kCores] = {k_decode_u8<kDense>, k_decode_u8<0>, k_decode_u8<1>,
                                             k_decode_u8<2>, k_decode_u8<3>};
  if (core < kDense || core >= kCores) return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w);
  if (err) return err;
  kernels[core - kDense]<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(coef), static_cast<int8_t*>(fwd), static_cast<uint8_t*>(rec), h,
      w, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

int hp_rt_f32_launch(const void* img, void* coef, void* rec, int h, int w, int literal,
                     const void* consts, void* stream, int device) {
  int err = prologue(device, h, w);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(img);
  auto* c = static_cast<float*>(coef);
  auto* r = static_cast<float*>(rec);
  if (literal)
    k_rt_f32<true><<<grid_for(h, w), kThreads, 0, s>>>(x, c, r, h, w, consts_of(consts));
  else
    k_rt_f32<false><<<grid_for(h, w), kThreads, 0, s>>>(x, c, r, h, w, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

int hp_dct_launch(const void* img, void* coef, int h, int w, int literal, const void* consts,
                  void* stream, int device) {
  int err = prologue(device, h, w);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(img);
  auto* c = static_cast<float*>(coef);
  if (literal)
    k_dct<true><<<grid_for(h, w), kThreads, 0, s>>>(x, c, h, w, consts_of(consts));
  else
    k_dct<false><<<grid_for(h, w), kThreads, 0, s>>>(x, c, h, w, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

int hp_idct_launch(const void* coef, void* rec, int h, int w, const void* consts, void* stream,
                   int device) {
  int err = prologue(device, h, w);
  if (err) return err;
  k_idct<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coef), static_cast<float*>(rec), h, w, consts_of(consts));
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

int hp_scaled_decode_u8_launch(const void* coef, void* out, int h, int w, int fr, int fc,
                               int out_u8, const void* consts, void* stream, int device) {
  int err = prologue(device, h, w);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const HpConsts& k = consts_of(consts);
  switch (fr) {
    case 1: err = launch_scaled_fc<1>(fc, coef, out, h, w, out_u8, k, s); break;
    case 2: err = launch_scaled_fc<2>(fc, coef, out, h, w, out_u8, k, s); break;
    case 4: err = launch_scaled_fc<4>(fc, coef, out, h, w, out_u8, k, s); break;
    case 8: err = launch_scaled_fc<8>(fc, coef, out, h, w, out_u8, k, s); break;
    default: err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* hp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
