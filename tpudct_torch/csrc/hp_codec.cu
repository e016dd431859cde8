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
// (idct_x(., "b"), _k_b, is B6's butterfly at q_scale 1: hp_idct_launch, B21.)
// B7 (hp_scaled_decode_u8) and B22 (idct_x(., "c")) run the same block
// chains from hp_inverse.cu.
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
//
// The plain twins in kernels/hp.py sum in the same order, so kernel and
// twin agree bit for bit.
//
// Design: one thread per 8x8 block, the block held in registers.  A thread
// reads its block as 8 row loads of 8 bytes (u8/int8) or 32 bytes (f32);
// consecutive threads own horizontally adjacent blocks, so a warp's row
// load is one contiguous 256-byte (or 1 KiB) span.  The 8x8 constants ride
// the kernel parameters (constant bank, read uniformly by the warp).
//
// B1, B2 and B3 (and so B15) run hp_block.cuh's add-only chain, one
// instance per integer core (the launchers' `core`): their dense form was
// bound by instruction issue, not bytes (16 FMAs per pixel for the forward,
// about 31 rounded f32 operations per coefficient for the inverse and 3
// (B2, B3) or 5 (B1) type conversions per pixel, which issue 16 per clock
// per SM against 128 f32 operations).  B2 is B1's encode half, one device
// function (encode_block_u8), so the two code the same coefficients by
// construction.  Now:
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
// move 8, the f32 roundtrips 12.  The arithmetic is ~2k f32 operations per
// block for the dense chains (the literal forward adds 64 IEEE divisions)
// and about 1k for the add-only decode; the SASS instruction counts and
// times are in PERF.md (sections 6 and 7).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hp_block.cuh"  // HpConsts, the forward and decode chains, row access, the launch geometry, ROWS

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

// ---- f32 pixels for the integer core ---------------------------------------

// f32 pixels: trunc to int32, subtract 128, wrap to int8 — the reference's
// (x.astype(int32) - 128).astype(int8) for the int core.
__device__ __forceinline__ void load_f32_shifted(const float* p, float* x) {
  float v[8];
  load_f32(p, v);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[e] = static_cast<float>(static_cast<int8_t>(__float2int_rz(v[e]) - 128));
}

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

}  // namespace

// B2 and B3 on the caller's stream of the current device, without the device
// prologue: the extern "C" launchers below after theirs, and color_codec.cu's
// u8 colour chains between the direct split and merge (one cudaSetDevice per
// chain).  Arguments as the launchers'; a cudaError_t value.
int hp_encode_u8_enqueue(const void* img, void* coef, int h, int w, int core, const void* consts,
                         cudaStream_t s) {
  using Kernel = decltype(&k_encode_u8<0>);
  static const Kernel kernels[kCores] = {k_encode_u8<0>, k_encode_u8<1>, k_encode_u8<2>, k_encode_u8<3>};
  if (core < 0 || core >= kCores || h <= 0 || w <= 0 || h % 8 || w % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  kernels[core]<<<grid_for(h, w), kThreads, 0, s>>>(static_cast<const uint8_t*>(img),
                                                    static_cast<int8_t*>(coef), h, w, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

int hp_decode_u8_enqueue(const void* coef, void* rec, int h, int w, void* fwd, int core,
                         const void* consts, cudaStream_t s) {
  using Kernel = decltype(&k_decode_u8<kDense>);
  static const Kernel kernels[1 + kCores] = {k_decode_u8<kDense>, k_decode_u8<0>, k_decode_u8<1>,
                                             k_decode_u8<2>, k_decode_u8<3>};
  if (core < kDense || core >= kCores || h <= 0 || w <= 0 || h % 8 || w % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  kernels[core - kDense]<<<grid_for(h, w), kThreads, 0, s>>>(
      static_cast<const int8_t*>(coef), static_cast<int8_t*>(fwd), static_cast<uint8_t*>(rec), h,
      w, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

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
  if (core < 0 || core >= kCores) return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w);
  if (err) return err;
  return hp_encode_u8_enqueue(img, coef, h, w, core, consts, static_cast<cudaStream_t>(stream));
}

int hp_decode_u8_launch(const void* coef, void* rec, int h, int w, void* fwd, int core,
                        const void* consts, void* stream, int device) {
  if (core < kDense || core >= kCores) return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w);
  if (err) return err;
  return hp_decode_u8_enqueue(coef, rec, h, w, fwd, core, consts, static_cast<cudaStream_t>(stream));
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

const char* hp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
