// The color codec's per-pixel chains and byte access helpers, shared by
// color_codec.cu (B8-B13) and ring.cu (B16), so the color ring merges
// exactly as color_merge_420_u8 does.  See color_codec.cu's header for the
// value chain and its rounding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ColorConsts {
  float kr, kg, kb;  // BT.601 luma weights, f32
  float kcb, kcr;    // 0.5 / (1 - KB), 0.5 / (1 - KR): forward chroma scales
  float kr2, kb2;    // 2 - 2 KR, 2 - 2 KB: inverse chroma scales
};

// N bytes at p (N in 4, 8, 16; p aligned to N) as N/4 little-endian words.
template <int N>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint32_t (&v)[N / 4]) {
  if constexpr (N == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (N == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int N>
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint32_t (&v)[N / 4]) {
  if constexpr (N == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = v[0];
  }
}

__device__ __forceinline__ int byte_at(const uint32_t* v, int e) {
  return static_cast<int>((v[e >> 2] >> (8 * (e & 3))) & 0xffu);
}

// clip(round_half_away(z), 0, 255), clip first: _to_u8 of color_pallas.py.
__device__ __forceinline__ uint32_t round_u8(float z) {
  const float zp = fminf(fmaxf(z, 0.0f), 255.0f);
  const float f = floorf(zp);
  return static_cast<uint32_t>(__fadd_rn(f, __fsub_rn(zp, f) >= 0.5f ? 1.0f : 0.0f));
}

// trunc(clip(z) + 0.5): _to_u8_trunc of color_pallas.py.
__device__ __forceinline__ uint32_t trunc_u8(float z) {
  return static_cast<uint32_t>(__float2int_rz(__fadd_rn(fminf(fmaxf(z, 0.0f), 255.0f), 0.5f)));
}

// One merged pixel: luma yf and the shifted chroma cbc = cb - 128,
// crc = cr - 128 (all exact integers as f32) -> r, g, b in [0, 255].
__device__ __forceinline__ void merge_px(float yf, float cbc, float crc, const ColorConsts& k,
                                         uint32_t& r, uint32_t& g, uint32_t& b) {
  const float rf = __fadd_rn(yf, __fmul_rn(crc, k.kr2));
  const float bf = __fadd_rn(yf, __fmul_rn(cbc, k.kb2));
  const float gf = __fdiv_rn(__fsub_rn(__fsub_rn(yf, __fmul_rn(rf, k.kr)), __fmul_rn(bf, k.kb)), k.kg);
  r = trunc_u8(rf);
  g = trunc_u8(gf);
  b = trunc_u8(bf);
}

}  // namespace
