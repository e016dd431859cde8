// The hp codec's 8x8 block chains: the integer-core forward and quantizer,
// shared by hp_codec.cu (B1, B2, B4, B5) and study.cu (B19), so the fused
// encode codes exactly as hp_encode_u8 does, and the block decode of
// hp_codec.cu (B1, B3 and B15, B4, B6, B7).  The 4:2:0 strip (B16, B20)
// decodes with its own add-only form of the same sums (strip420.cuh).  One
// thread holds one 8x8 block in registers; see hp_codec.cu's header for the
// value chain and its rounding.

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

// 8 int8 values, held as the raw 8 bytes of one row, -> f32.
__device__ __forceinline__ void unpack_i8(uint2 v, float* x) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = static_cast<float>(static_cast<int8_t>((v.x >> (8 * e)) & 0xffu));
    x[4 + e] = static_cast<float>(static_cast<int8_t>((v.y >> (8 * e)) & 0xffu));
  }
}

__device__ __forceinline__ void load_i8(const int8_t* p, float* x) {
  unpack_i8(*reinterpret_cast<const uint2*>(p), x);
}

// 8 u8 pixels (device or shared memory, 8-byte aligned) -> level-shifted f32.
__device__ __forceinline__ void load_u8_shifted(const uint8_t* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = static_cast<float>(static_cast<int>((v.x >> (8 * e)) & 0xffu) - 128);
    x[4 + e] = static_cast<float>(static_cast<int>((v.y >> (8 * e)) & 0xffu) - 128);
  }
}

// 8 quantized coefficients (integral f32 in int8 range) -> one 8-byte row.
__device__ __forceinline__ void store_i8(int8_t* p, const float* c) {
  uint2 v = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v.x |= (static_cast<uint32_t>(__float2int_rz(c[e])) & 0xffu) << (8 * e);
    v.y |= (static_cast<uint32_t>(__float2int_rz(c[4 + e])) & 0xffu) << (8 * e);
  }
  *reinterpret_cast<uint2*>(p) = v;
}

// One 8-byte int8 row at element offset ro: copied as it is to fwd (unless
// fwd is null: the ring's forward to the next rank, B15/B16) and unpacked.
__device__ __forceinline__ void load_forward_i8(const int8_t* __restrict__ src,
                                                int8_t* __restrict__ fwd, long long ro,
                                                float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(src + ro);
  if (fwd) *reinterpret_cast<uint2*>(fwd + ro) = v;
  unpack_i8(v, x);
}

__device__ __forceinline__ float clamp_trunc(float x) {
  return fminf(fmaxf(truncf(x), 0.0f), 255.0f);
}

__device__ __forceinline__ uint32_t to_u8(float x) {
  return static_cast<uint32_t>(clamp_trunc(x));
}

// N values of one output row: u8 with one 8/4/2/1-byte store.  The values
// are exact integers in [0, 255], so the cast is the truncation.
template <int N>
__device__ __forceinline__ void store_row_u8(uint8_t* p, const float* x) {
  if constexpr (N == 8) {
    uint2 v = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v.x |= to_u8(x[e]) << (8 * e);
      v.y |= to_u8(x[4 + e]) << (8 * e);
    }
    *reinterpret_cast<uint2*>(p) = v;
  } else if constexpr (N == 4) {
    uint32_t v = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) v |= to_u8(x[e]) << (8 * e);
    *reinterpret_cast<uint32_t*>(p) = v;
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(to_u8(x[0]) | (to_u8(x[1]) << 8));
  } else {
    *p = static_cast<uint8_t>(to_u8(x[0]));
  }
}

__device__ __forceinline__ void store_u8(uint8_t* p, const float* x) { store_row_u8<8>(p, x); }

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
