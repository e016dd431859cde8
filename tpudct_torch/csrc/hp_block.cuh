// The hp codec's 8x8 block chains, one thread holding one 8x8 block in
// registers (see hp_codec.cu's header for the value chain and its
// rounding):
//  - the dense forward and quantizer fwd_block (B4, B5) and the dense
//    inverse inv_block (B4, B6, and the "highest"/"high" tiers of B1 and
//    B3);
//  - the add-only chain of B1, B2, B3, B7 and B15 on the butterfly tier,
//    shared with strip420.cuh's 4:2:0 strip (B16, B20) and study.cu's fused
//    4:2:0 encode (B19, so it codes exactly as hp_encode_u8 does): each
//    integer core's Ts compiled in (core_ts, one kernel instance per core),
//    the forward by even/odd butterflies, the inverse summing only its
//    nonzero terms in the dense order (inv_dot, which B22's per-digit sums
//    run too), and no conversion instruction per pixel (bytes <-> f32 by
//    bit patterns, floors and truncations by directed-rounding adds of
//    2^23, bytes packed by PRMT).
// Every form gives the dense chain's values bit for bit (tests/
// test_torch_hp_addonly.py, test_torch_strip420.py,
// test_torch_encode_addonly.py and test_torch_scaled_split3_addonly.py
// emulate them).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct HpConsts {
  float fwd[64];   // forward matrix: Ts (integer core) or T (f32-literal core)
  float fq[64];    // integer core: scale = d_i d_l / (Q q_scale) * mask;
                   // f32-literal core: the divisor Q q_scale
  float mask[64];  // f32-literal core: zonal mask applied after rounding
  float a[64];     // inverse transform matrix (Ts or T)
  float s[64];     // dequantization multiplier per position
};

__device__ __forceinline__ float round_away(float z) {
  return truncf(__fadd_rn(z, copysignf(0.5f, z)));
}

__device__ __forceinline__ void fwd_block(float x[64], const HpConsts& k) {
  // x: level-shifted integral pixels in, quantized coefficients out.
  float u[64];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = k.fwd[i * 8] * x[c];
#pragma unroll
      for (int kk = 1; kk < 8; ++kk) acc += k.fwd[i * 8 + kk] * x[kk * 8 + c];
      u[i * 8 + c] = acc;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float core = u[i * 8] * k.fwd[j * 8];
#pragma unroll
      for (int l = 1; l < 8; ++l) core += u[i * 8 + l] * k.fwd[j * 8 + l];
      x[i * 8 + j] = round_away(__fmul_rn(core, k.fq[i * 8 + j]));
    }
}

__device__ __forceinline__ void inv_block(float c[64], const HpConsts& k) {
  // c: quantized coefficients in, reconstruction + 128 (f32) out.
  float m[64], u[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) m[e] = __fmul_rn(c[e], k.s[e]);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      float acc = __fmul_rn(k.a[i], m[l]);
#pragma unroll
      for (int kk = 1; kk < 8; ++kk)
        acc = __fadd_rn(acc, __fmul_rn(k.a[kk * 8 + i], m[kk * 8 + l]));
      u[i * 8 + l] = acc;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(u[i * 8], k.a[j]);
#pragma unroll
      for (int l = 1; l < 8; ++l)
        acc = __fadd_rn(acc, __fmul_rn(u[i * 8 + l], k.a[l * 8 + j]));
      c[i * 8 + j] = __fadd_rn(acc, 128.0f);
    }
}

// ---- the integer cores ------------------------------------------------------

// The integer cores compiled in, in kernels/cores.py's CORES order (the
// launchers' `core` argument; cb2011 is rdct); kDense names the dense f32
// inverse on the table `a` (inv_block) where a launcher takes a core.
constexpr int kCores = 4;
constexpr int kDense = -1;

// Entry e (row-major) of core `core`'s Ts (tpudct_torch/constants.py).
__host__ __device__ constexpr int core_ts(int core, int e) {
  constexpr signed char ts[kCores][64] = {
      // haweel
      { 1,  1,  1,  1,  1,  1,  1,  1,
        1,  1,  0,  0,  0,  0, -1, -1,
        2,  1, -1, -2, -2, -1,  1,  2,
        0,  0, -1,  0,  0,  1,  0,  0,
        1, -1, -1,  1,  1, -1, -1,  1,
        1, -1,  0,  0,  0,  0,  1, -1,
        1, -2,  2, -1, -1,  2, -2,  1,
        0,  0,  0, -1,  1,  0,  0,  0},
      // rdct
      { 1,  1,  1,  1,  1,  1,  1,  1,
        1,  1,  1,  0,  0, -1, -1, -1,
        1,  0,  0, -1, -1,  0,  0,  1,
        1,  0, -1, -1,  1,  1,  0, -1,
        1, -1, -1,  1,  1, -1, -1,  1,
        1, -1,  0,  1, -1,  0,  1, -1,
        0, -1,  1,  0,  0,  1, -1,  0,
        0, -1,  1, -1,  1, -1,  1,  0},
      // wht
      { 1,  1,  1,  1,  1,  1,  1,  1,
        1,  1,  1,  1, -1, -1, -1, -1,
        1,  1, -1, -1, -1, -1,  1,  1,
        1,  1, -1, -1,  1,  1, -1, -1,
        1, -1, -1,  1,  1, -1, -1,  1,
        1, -1, -1,  1, -1,  1,  1, -1,
        1, -1,  1, -1, -1,  1, -1,  1,
        1, -1,  1, -1,  1, -1,  1, -1},
      // bas
      { 1,  1,  1,  1,  1,  1,  1,  1,
        1,  1,  0,  0,  0,  0, -1, -1,
        1,  0,  0, -1, -1,  0,  0,  1,
        0,  0, -1,  0,  0,  1,  0,  0,
        1, -1, -1,  1,  1, -1, -1,  1,
        1, -1,  0,  0,  0,  0,  1, -1,
        0, -1,  1,  0,  0,  1, -1,  0,
        0,  0,  0, -1,  1,  0,  0,  0},
  };
  return ts[core][e];
}

// True where core's Ts has the DCT's butterfly symmetry, which fwd8 uses:
// row r is symmetric (t[k] = t[7 - k]) for even r and antisymmetric for odd
// r, and in the first half of an even row, rows 0 and 4 are symmetric
// (t[k] = t[3 - k]) and rows 2 and 6 antisymmetric.
__host__ __device__ constexpr bool core_has_butterflies(int core) {
  for (int r = 0; r < 8; ++r)
    for (int k = 0; k < 4; ++k) {
      const int t = core_ts(core, 8 * r + k);
      if (t != (r % 2 ? -1 : 1) * core_ts(core, 8 * r + 7 - k)) return false;
      if (r % 2 == 0 && t != (r % 4 ? -1 : 1) * core_ts(core, 8 * r + 3 - k)) return false;
    }
  return true;
}
static_assert(core_has_butterflies(0) && core_has_butterflies(1) && core_has_butterflies(2) &&
                  core_has_butterflies(3),
              "fwd8 needs every compiled core's butterfly symmetry");

// The dense chain's next step for a table entry a in {+-1, +-2}: acc + a v,
// or a v where it starts the sum, without the product (v + v is 2 v).
__device__ __forceinline__ float add_term(float acc, bool first, int a, float v) {
  const float t = (a == 2 || a == -2) ? __fadd_rn(v, v) : v;
  if (first) return a < 0 ? -t : t;
  return a < 0 ? __fsub_rn(acc, t) : __fadd_rn(acc, t);
}

// sum over k = 0..7 of Ts[k][i] v[k S] (Ts of kCore: column i of Ts, or
// row i of Ts^T): the dense inverse's sum in its k order, its zero terms
// skipped (add_term).  Every index and table entry is a constant once the
// loops unroll.
template <int kCore, int S>
__device__ __forceinline__ float inv_dot(int i, const float* v) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = core_ts(kCore, k * 8 + i);
    if (a != 0) {
      acc = add_term(acc, first, a, v[k * S]);
      first = false;
    }
  }
  return acc;
}

// x: the dequantized block M in, A^T M A + 128 out (A = Ts of kCore): the
// dense inv_block's sums, their zero terms skipped.
template <int kCore>
__device__ __forceinline__ void inv_core(float (&x)[64]) {
  float u[64];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int l = 0; l < 8; ++l) u[i * 8 + l] = inv_dot<kCore, 8>(i, x + l);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i * 8 + j] = __fadd_rn(inv_dot<kCore, 1>(j, u + 8 * i), 128.0f);
}

// sum over k < n of t[k] v[k], t = row `row` of kCore's Ts, on integral
// f32: the +-1 terms first, then each +-2 term as one FMA, the zero terms
// skipped.  Exact in any order: every partial sum of the forward is an
// integer of magnitude at most 128 * 12^2 = 18432 < 2^24 (haweel's largest
// row has sum |t| = 12).
template <int kCore>
__device__ __forceinline__ float core_dot(int row, const float* v, int n) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int mag = 1; mag <= 2; ++mag)
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const int t = core_ts(kCore, 8 * row + k);
      if (t != mag && t != -mag) continue;
      acc = first ? static_cast<float>(t) * v[k] : fmaf(static_cast<float>(t), v[k], acc);
      first = false;
    }
  return acc;
}

// v[0], v[S], ..., v[7 S] (integral) -> Ts v in place: sums and differences
// of the mirrored pairs, then of those of the even half, then each output's
// nonzero terms (core_has_butterflies).
template <int kCore, int S>
__device__ __forceinline__ void fwd8(float* v) {
  float s[4], d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = v[k * S] + v[(7 - k) * S];
    d[k] = v[k * S] - v[(7 - k) * S];
  }
  const float e[2] = {s[0] + s[3], s[1] + s[2]}, o[2] = {s[0] - s[3], s[1] - s[2]};
#pragma unroll
  for (int r = 0; r < 8; r += 2) v[r * S] = core_dot<kCore>(r, r % 4 ? o : e, 2);
#pragma unroll
  for (int r = 1; r < 8; r += 2) v[r * S] = core_dot<kCore>(r, d, 4);
}

// x: the level-shifted pixels X in, Ts X Ts^T out (exact integral f32):
// the columns, then the rows, as fwd_block sums them.
template <int kCore>
__device__ __forceinline__ void fwd_core(float (&x)[64]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) fwd8<kCore, 8>(x + c);
#pragma unroll
  for (int i = 0; i < 8; ++i) fwd8<kCore, 1>(x + 8 * i);
}

// ---- bytes and f32 without conversion instructions -------------------------

constexpr float kTwo23 = 8388608.0f;  // 2^23: a float in [2^23, 2^24) has an ulp of 1

// Byte e of w, xor 0x80 where w holds int8 (then the byte is v + 128), as
// the float 2^23 + byte: its bits are 0x4B0000 and the byte.
__device__ __forceinline__ float biased_byte(uint32_t w, int e) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + e));
}

// The 8 bytes of lo, hi minus 128, as exact f32.
__device__ __forceinline__ void bytes_minus_128(uint32_t lo, uint32_t hi, float* x) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = __fsub_rn(biased_byte(lo, e), kTwo23 + 128.0f);
    x[4 + e] = __fsub_rn(biased_byte(hi, e), kTwo23 + 128.0f);
  }
}

// 8 u8 pixels (8-byte aligned, in device or shared memory) -> the
// level-shifted x - 128, exact f32.
__device__ __forceinline__ void load_u8_level(const uint8_t* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  bytes_minus_128(v.x, v.y, x);
}

// 2^23 + floor(clip(x, 0, 255)), the decode's u8 value min(max(trunc(x),
// 0), 255) plus 2^23: 2^23 + x rounded down is 2^23 + floor(x), the floor
// in the low mantissa bits (its bits are 0x4B000000 + the value).
__device__ __forceinline__ float floor_2p23(float x) {
  return __fadd_rd(fminf(fmaxf(x, 0.0f), 255.0f), kTwo23);
}

// floor(clip(x, 0, 255)) as an exact f32 minus `shift`.
__device__ __forceinline__ float clamp_floor(float x, float shift) {
  return __fsub_rn(floor_2p23(x), kTwo23 + shift);
}

// Four values in [0, 255] (or any words: their low bytes) as the bytes of
// one little-endian word.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u), 0x5410u);
}

// One decoded row (reconstruction + 128) -> its 8 u8 pixels in one 8-byte
// store: the low bytes of floor_2p23.
__device__ __forceinline__ void store_u8_floor(uint8_t* p, const float* x) {
  uint32_t b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = __float_as_uint(floor_2p23(x[e]));
  *reinterpret_cast<uint2*>(p) = make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

// trunc(fl(fl(core fq) + copysign(0.5))) (round_away of the scaled core:
// the value chain's double rounding) as exact f32, without FRND: 2^23 + |y|
// rounded down is 2^23 + floor|y| = 2^23 + |trunc y| (|y| < 2^23), and the
// sign is y's.
__device__ __forceinline__ float quantize(float core, float fq) {
  const float z = __fmul_rn(core, fq);
  const float y = __fadd_rn(z, copysignf(0.5f, z));
  return copysignf(__fsub_rn(__fadd_rd(fabsf(y), kTwo23), kTwo23), y);
}

// An integral c, |c| < 2^22, as a word whose low byte is c mod 256 (the
// int8 store's wrap), without F2I: 1.5 * 2^23 + c has the bits
// 0x4B400000 + c.
__device__ __forceinline__ uint32_t i8_bits(float c) {
  return __float_as_uint(__fadd_rn(c, 12582912.0f));
}

// One row of 8 forward sums Ts X Ts^T -> the quantized coefficients, in
// place, and as one 8-byte int8 row at p.
__device__ __forceinline__ void quantize_store_i8(int8_t* p, float* x, const float* fq) {
  uint32_t b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    x[e] = quantize(x[e], fq[e]);
    b[e] = i8_bits(x[e]);
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

// One 8-byte int8 row at element offset ro: copied as it is to fwd (unless
// fwd is null: the ring's forward to the next rank, B15) and unpacked as
// exact f32 (byte ^ 0x80 is the value + 128).
__device__ __forceinline__ void load_forward_i8(const int8_t* __restrict__ src,
                                                int8_t* __restrict__ fwd, long long ro,
                                                float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(src + ro);
  if (fwd) *reinterpret_cast<uint2*>(fwd + ro) = v;
  bytes_minus_128(v.x ^ 0x80808080u, v.y ^ 0x80808080u, x);
}

// x: the coefficients c in, A^T (c S) A + 128 out: inv_block (kDense) or
// the add-only inv_core of the integer core kCore.
template <int kCore>
__device__ __forceinline__ void dequant_inverse(float (&x)[64], const HpConsts& k) {
  if constexpr (kCore == kDense) {
    inv_block(x, k);
  } else {
#pragma unroll
    for (int e = 0; e < 64; ++e) x[e] = __fmul_rn(x[e], k.s[e]);
    inv_core<kCore>(x);
  }
}

// ---- f32 rows and the launch geometry --------------------------------------

// 8 f32 values of one row (32-byte aligned) in two 16-byte loads.
__device__ __forceinline__ void load_f32(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// N f32 values of one output row in one or two vector stores.
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

// One thread per 8x8 block, kThreads to a thread block (hp_codec.cu and
// hp_inverse.cu).
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

__device__ __forceinline__ long long block_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// Element offset of this thread's block (row 0), or -1 past the last block.
__device__ __forceinline__ long long block_origin(int h, int w) {
  const long long nbw = w / 8;
  const long long b = block_index();
  if (b >= (h / 8) * nbw) return -1;
  return (b / nbw) * 8 * static_cast<long long>(w) + (b % nbw) * 8;
}

}  // namespace

#define ROWS(stmt)                                                \
  _Pragma("unroll") for (int r = 0; r < 8; ++r) {                 \
    const long long ro = o + r * static_cast<long long>(w);       \
    stmt;                                                         \
  }
