// The color codec's per-pixel chains and byte access helpers of
// color_codec.cu (B8-B13 and the study variants B23-B26).  The 4:2:0 strip
// (B16, B20, strip420.cuh) reads ColorConsts and merges with the same
// chain, and study.cu's fused 4:2:0 encode (B19) runs luma_f32 and
// split_chroma's chain, both with their rounds in forms without conversion
// instructions.  See color_codec.cu's header for the value chain and its
// rounding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ColorConsts {
  float kr, kg, kb;  // BT.601 luma weights, f32
  float kcb, kcr;    // 0.5 / (1 - KB), 0.5 / (1 - KR): forward chroma scales
  float kr2, kb2;    // 2 - 2 KR, 2 - 2 KB: inverse chroma scales
  float c1, c2;      // KB (2 - 2 KB) / KG, KR (2 - 2 KR) / KG: the direct-form
                     // inverse's g weights (merge_px_direct), each rounded once
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

// BT.601 luma (KR r + KG g) + KB b in f32, every product and sum rounded.
__device__ __forceinline__ float luma_f32(float r, float g, float b, const ColorConsts& k) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, k.kr), __fmul_rn(g, k.kg)), __fmul_rn(b, k.kb));
}

// One chroma sample of the split: the integer window sums of (c - 128) of
// r, g, b over a window of 1/inv pixels (inv a power of two) -> cb, cr u8.
// P_c = sum * inv + 128 is exact; then the pooled BT.601 and _to_u8 or, with
// kTruncRound (the study's V5 split), _to_u8_trunc.
template <bool kTruncRound = false>
__device__ __forceinline__ void split_chroma(int sr, int sg, int sb, float inv, const ColorConsts& k,
                                             uint32_t& cb, uint32_t& cr) {
  const float pr = __fadd_rn(__fmul_rn(static_cast<float>(sr), inv), 128.0f);
  const float pg = __fadd_rn(__fmul_rn(static_cast<float>(sg), inv), 128.0f);
  const float pb = __fadd_rn(__fmul_rn(static_cast<float>(sb), inv), 128.0f);
  const float yp = luma_f32(pr, pg, pb, k);
  const float zb = __fadd_rn(__fmul_rn(__fsub_rn(pb, yp), k.kcb), 128.0f);
  const float zr = __fadd_rn(__fmul_rn(__fsub_rn(pr, yp), k.kcr), 128.0f);
  cb = kTruncRound ? trunc_u8(zb) : round_u8(zb);
  cr = kTruncRound ? trunc_u8(zr) : round_u8(zr);
}

// One merged pixel: luma yf and the shifted chroma cbc = cb - 128,
// crc = cr - 128 (all exact integers as f32) -> r, g, b in [0, 255], rounded
// by _to_u8_trunc (the production merge) or, with kCompareRound, by the
// compare form _to_u8 (the same values over every input, proven by the
// 256^3 sweep).
template <bool kCompareRound = false>
__device__ __forceinline__ void merge_px(float yf, float cbc, float crc, const ColorConsts& k,
                                         uint32_t& r, uint32_t& g, uint32_t& b) {
  const float rf = __fadd_rn(yf, __fmul_rn(crc, k.kr2));
  const float bf = __fadd_rn(yf, __fmul_rn(cbc, k.kb2));
  const float gf = __fdiv_rn(__fsub_rn(__fsub_rn(yf, __fmul_rn(rf, k.kr)), __fmul_rn(bf, k.kb)), k.kg);
  r = kCompareRound ? round_u8(rf) : trunc_u8(rf);
  g = kCompareRound ? round_u8(gf) : trunc_u8(gf);
  b = kCompareRound ? round_u8(bf) : trunc_u8(bf);
}

// The study's direct-form merge (V12): r and b as merge_px, g straight from
// the chroma, (yf - c1 cbc) - c2 crc, every product and difference rounded
// on its own; the compare-form round.
__device__ __forceinline__ void merge_px_direct(float yf, float cbc, float crc, const ColorConsts& k,
                                                uint32_t& r, uint32_t& g, uint32_t& b) {
  const float rf = __fadd_rn(yf, __fmul_rn(crc, k.kr2));
  const float bf = __fadd_rn(yf, __fmul_rn(cbc, k.kb2));
  const float gf = __fsub_rn(__fsub_rn(yf, __fmul_rn(cbc, k.c1)), __fmul_rn(crc, k.c2));
  r = round_u8(rf);
  g = round_u8(gf);
  b = round_u8(bf);
}

}  // namespace
