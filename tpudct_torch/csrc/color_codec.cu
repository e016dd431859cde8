// YCbCr split and merge kernels for NVIDIA Hopper (sm_90a): the color
// codec's conversion and chroma resampling, built with hp_codec.cu by
// tpudct_torch/kernels/_build.py into one shared library with a plain C
// interface (loaded with ctypes).
//
// Entry points and the Pallas TPU kernels they replace
// (tpudct/kernels/color_pallas.py), one template per direction, instantiated
// per chroma window RH x RW:
//   color_split_launch  k_color_split<2,2>  B8   color_split_420_u8  (_k_split)
//                       k_color_split<1,2>  B10  color_split_422_u8  (_k_split_422)
//                       k_color_split<1,1>  B12  color_split_444_u8  (_k_split_444)
//   color_merge_launch  k_color_merge<2,2>  B9   color_merge_420_u8  (_k_merge)
//                       k_color_merge<1,2>  B11  color_merge_422_u8  (_k_merge_422)
//                       k_color_merge<1,1>  B13  color_merge_444_u8  (_k_merge_444)
// and the 4:2:0 variants of the color variant studies (benchmarks/
// color_variants.py and color_variants2.py, make_split/make_merge):
//   color_merge_variant_launch 1   k_color_merge<2,2,kCompare>  B23 _k_merge_v1
//   color_merge_variant_launch 12  k_color_merge<2,2,kDirect>   B23 _k_merge_v12
//   color_split_variant_launch 5   k_color_split<2,2,true>      B26 _k_split_v5
// (the studies' other variants, B24 _k_split_v3, B25 _k_merge_v4 and
// _k_merge_v6, compute B8's and B9's values and launch B8 and B9).
//
// Value chain (the reference's, rounding included):
//   split  Y = (19595 r + 38470 g + 7471 b + 32768) >> 16 in int32 (exact);
//          per chroma sample, P_c = float(sum of (c - 128) over the RH x RW
//          window) * 1/(RH RW) + 128 for c in r, g, b (exact: small integers
//          times a power of two);
//          y' = (KR P_r + KG P_g) + KB P_b, cb = 128 + (P_b - y') kcb,
//          cr = 128 + (P_r - y') kcr, every product and sum rounded on its
//          own (__fmul_rn / __fadd_rn / __fsub_rn): an FMA moves the .5 ties
//          of the rounding below;
//          u8 = clip first, then floor + (frac >= 0.5) (color_pallas._to_u8).
//   merge  cbc = float(cb - 128), crc = float(cr - 128) of the chroma
//          sample at (i / RH, j / RW) (nearest replication; the shift
//          commutes with it, so computing it per pixel is bit-identical);
//          r = y + kr2 crc, b = y + kb2 cbc, g = ((y - KR r) - KB b) / KG,
//          separately rounded, the division a true one (__fdiv_rn: a
//          reciprocal multiply rounds differently);
//          u8 = trunc(clip(z) + 0.5) (color_pallas._to_u8_trunc), the
//          add form the reference proves equal to the compare form over all
//          256^3 (y, cb, cr) triples.
//   variants V1: the merge with the compare-form round (merge_px<true>): B9's
//          values on every input.  V12: r and b as above, g in the direct
//          form (y - c1 cbc) - c2 crc with c1 = KB (2 - 2 KB) / KG and
//          c2 = KR (2 - 2 KR) / KG (f64, rounded once), separately rounded,
//          the compare-form round: +-1 against B9 where the two g chains
//          round apart.  V5: the split with its chroma rounded by the add
//          form trunc(clip(z) + 0.5): +-1 against B8 where the f32 add of
//          0.5 crosses an integer.
// The f32 constants (KR, KG, KB, kcb, kcr, kr2, kb2, c1, c2) come from the
// caller (ColorConsts), the same values the plain twins in kernels/color.py
// and kernels/variants.py use, so kernel and twin agree bit for bit.
//
// Design: no reduction crosses threads, so one thread owns one RH x 16
// window of the luma grid (16 / RW chroma samples): it reads 16 bytes per
// row of each RGB plane, keeps the integer window sums in registers and
// writes 16 bytes per luma row and 16 / RW bytes per chroma plane (the
// merge the reverse).  Consecutive threads own consecutive windows of a
// row, so a warp's loads and stores are contiguous 512-byte spans.  No
// shared memory and no tensor cores: the TPU kernel's 0/1 pooling and
// replication matrices on the MXU and its (64, 256) tiles exist for the
// TPU's layout rules only.
//
// Bound: memory.  Bytes per pixel (each input read once, each output
// written once): split and merge 4:2:0 4.5 (the variants too), 4:2:2 5,
// 4:4:4 6; at 8192^2 and 3.35 TB/s that is 0.090, 0.100 and 0.120 ms.  The
// arithmetic (about 20 operations per pixel, the merge's true division
// among them) stays well under that at the card's f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color_px.cuh"  // ColorConsts, byte access, the roundings, split_chroma, merge_px(_direct)

namespace {

// The merge's per-pixel chain: B9-B13's (trunc round), V1's (compare
// round), V12's (direct-form g, compare round).
enum class Merge { kTrunc, kCompare, kDirect };

constexpr int kCols = 16;  // luma columns per thread
constexpr int kThreads = 256;

// Thread -> (luma offset of its window's top-left, its chroma offset), or
// false past the last window.
template <int RH, int RW>
__device__ __forceinline__ bool window(int h, int w, long long& o, long long& co) {
  const long long groups = w / kCols;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= (h / RH) * groups) return false;
  const long long crow = t / groups, g = t % groups;
  o = crow * RH * static_cast<long long>(w) + g * kCols;
  co = crow * (w / RW) + g * (kCols / RW);
  return true;
}

template <int RH, int RW, bool kTruncChroma = false>
__global__ void k_color_split(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ y,
                              uint8_t* __restrict__ cb, uint8_t* __restrict__ cr, int h, int w,
                              const ColorConsts k) {
  constexpr int V = kCols / RW;  // chroma samples of the window
  long long o, co;
  if (!window<RH, RW>(h, w, o, co)) return;
  const long long plane = static_cast<long long>(h) * w;
  int sum[3][V];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) sum[c][v] = 0;
#pragma unroll
  for (int a = 0; a < RH; ++a) {
    const long long ro = o + a * static_cast<long long>(w);
    uint32_t px[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) load_bytes<16>(rgb + c * plane + ro, px[c]);
    uint32_t yv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int r = byte_at(px[0], e), g = byte_at(px[1], e), b = byte_at(px[2], e);
      const uint32_t luma = static_cast<uint32_t>((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
      yv[e >> 2] |= luma << (8 * (e & 3));
#pragma unroll
      for (int c = 0; c < 3; ++c) sum[c][e / RW] += byte_at(px[c], e) - 128;
    }
    store_bytes<16>(y + ro, yv);
  }
  uint32_t cbv[V / 4], crv[V / 4];
#pragma unroll
  for (int q = 0; q < V / 4; ++q) cbv[q] = crv[q] = 0u;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    uint32_t zb, zr;
    split_chroma<kTruncChroma>(sum[0][v], sum[1][v], sum[2][v], 1.0f / (RH * RW), k, zb, zr);
    cbv[v >> 2] |= zb << (8 * (v & 3));
    crv[v >> 2] |= zr << (8 * (v & 3));
  }
  store_bytes<V>(cb + co, cbv);
  store_bytes<V>(cr + co, crv);
}

template <int RH, int RW, Merge kForm = Merge::kTrunc>
__global__ void k_color_merge(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                              const uint8_t* __restrict__ cr, uint8_t* __restrict__ out, int h,
                              int w, const ColorConsts k) {
  constexpr int V = kCols / RW;
  long long o, co;
  if (!window<RH, RW>(h, w, o, co)) return;
  const long long plane = static_cast<long long>(h) * w;
  uint32_t cbw[V / 4], crw[V / 4];
  load_bytes<V>(cb + co, cbw);
  load_bytes<V>(cr + co, crw);
  float cbc[V], crc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    cbc[v] = static_cast<float>(byte_at(cbw, v) - 128);
    crc[v] = static_cast<float>(byte_at(crw, v) - 128);
  }
#pragma unroll
  for (int a = 0; a < RH; ++a) {
    const long long ro = o + a * static_cast<long long>(w);
    uint32_t yw[4];
    load_bytes<16>(y + ro, yw);
    uint32_t rv[4] = {0u, 0u, 0u, 0u}, gv[4] = {0u, 0u, 0u, 0u}, bv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      uint32_t r, g, b;
      const float yf = static_cast<float>(byte_at(yw, e));
      if constexpr (kForm == Merge::kDirect)
        merge_px_direct(yf, cbc[e / RW], crc[e / RW], k, r, g, b);
      else
        merge_px<kForm == Merge::kCompare>(yf, cbc[e / RW], crc[e / RW], k, r, g, b);
      const int sh = 8 * (e & 3);
      rv[e >> 2] |= r << sh;
      gv[e >> 2] |= g << sh;
      bv[e >> 2] |= b << sh;
    }
    store_bytes<16>(out + ro, rv);
    store_bytes<16>(out + plane + ro, gv);
    store_bytes<16>(out + 2 * plane + ro, bv);
  }
}

template <int RH>
inline dim3 grid_for(int h, int w) {
  const long long n = static_cast<long long>(h / RH) * (w / kCols);
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads));
}

inline int prologue(int device, int h, int w, int rh, int rw) {
  const bool window_ok = (rh == 2 && rw == 2) || (rh == 1 && rw == 2) || (rh == 1 && rw == 1);
  if (!window_ok || h <= 0 || w <= 0 || h % rh || w % kCols)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

template <int RH, int RW, bool kTruncChroma = false>
void split(const void* rgb, void* y, void* cb, void* cr, int h, int w, const ColorConsts& k,
           cudaStream_t s) {
  k_color_split<RH, RW, kTruncChroma><<<grid_for<RH>(h, w), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(rgb), static_cast<uint8_t*>(y), static_cast<uint8_t*>(cb),
      static_cast<uint8_t*>(cr), h, w, k);
}

template <int RH, int RW, Merge kForm = Merge::kTrunc>
void merge(const void* y, const void* cb, const void* cr, void* out, int h, int w,
           const ColorConsts& k, cudaStream_t s) {
  k_color_merge<RH, RW, kForm><<<grid_for<RH>(h, w), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(cb),
      static_cast<const uint8_t*>(cr), static_cast<uint8_t*>(out), h, w, k);
}

}  // namespace

// ---- C interface -------------------------------------------------------------
// Pointers are device pointers (16-byte aligned, contiguous) except `consts`,
// a host pointer to 9 floats laid out as ColorConsts.  (rh, rw) is the chroma
// window: (2, 2) 4:2:0, (1, 2) 4:2:2, (1, 1) 4:4:4; h % rh == 0 and
// w % 16 == 0.  The variant launchers are 4:2:0 only and take the study's
// variant number: merge 1 (V1) or 12 (V12), split 5 (V5); any other is
// refused with cudaErrorInvalidValue.  Each function returns a cudaError_t
// value (0 = ok) after checking the launch (hp_error_string in hp_codec.cu
// names it); it neither synchronizes nor allocates.

extern "C" {

int color_split_launch(const void* rgb, void* y, void* cb, void* cr, int h, int w, int rh, int rw,
                       const void* consts, void* stream, int device) {
  int err = prologue(device, h, w, rh, rw);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const ColorConsts& k = *static_cast<const ColorConsts*>(consts);
  if (rh == 2)
    split<2, 2>(rgb, y, cb, cr, h, w, k, s);
  else if (rw == 2)
    split<1, 2>(rgb, y, cb, cr, h, w, k, s);
  else
    split<1, 1>(rgb, y, cb, cr, h, w, k, s);
  return static_cast<int>(cudaGetLastError());
}

int color_merge_launch(const void* y, const void* cb, const void* cr, void* out, int h, int w,
                       int rh, int rw, const void* consts, void* stream, int device) {
  int err = prologue(device, h, w, rh, rw);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const ColorConsts& k = *static_cast<const ColorConsts*>(consts);
  if (rh == 2)
    merge<2, 2>(y, cb, cr, out, h, w, k, s);
  else if (rw == 2)
    merge<1, 2>(y, cb, cr, out, h, w, k, s);
  else
    merge<1, 1>(y, cb, cr, out, h, w, k, s);
  return static_cast<int>(cudaGetLastError());
}

int color_split_variant_launch(const void* rgb, void* y, void* cb, void* cr, int h, int w,
                               int variant, const void* consts, void* stream, int device) {
  if (variant != 5) return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w, 2, 2);
  if (err) return err;
  split<2, 2, true>(rgb, y, cb, cr, h, w, *static_cast<const ColorConsts*>(consts),
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int color_merge_variant_launch(const void* y, const void* cb, const void* cr, void* out, int h,
                               int w, int variant, const void* consts, void* stream, int device) {
  if (variant != 1 && variant != 12) return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w, 2, 2);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const ColorConsts& k = *static_cast<const ColorConsts*>(consts);
  if (variant == 1)
    merge<2, 2, Merge::kCompare>(y, cb, cr, out, h, w, k, s);
  else
    merge<2, 2, Merge::kDirect>(y, cb, cr, out, h, w, k, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
