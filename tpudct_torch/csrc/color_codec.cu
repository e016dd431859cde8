// YCbCr split and merge kernels for NVIDIA Hopper (sm_90a): the color
// codec's conversion and chroma resampling, built with hp_codec.cu by
// tpudct_torch/kernels/_build.py into one shared library with a plain C
// interface (loaded with ctypes).
//
// Entry points and the Pallas TPU kernels they replace
// (tpudct/kernels/color_pallas.py), one template per direction, instantiated
// per chroma window RH x RW (the split's grid instances are its planar,
// whole ones, k_color_split<RH,RW,false,kCHW,true>):
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
//   color_split_variant_launch 5   k_color_split<2,2,true,..>   B26 _k_split_v5
// (the studies' other variants, B24 _k_split_v3, B25 _k_merge_v4 and
// _k_merge_v6, compute B8's and B9's values and launch B8 and B9), and the
// direct instances of the u8 colour path (models/color.py encode_color_u8,
// decode_color_u8), which replace no TPU kernel:
//   color_split_direct_launch  k_color_split<RH,RW,false,kHWC,whole> and
//                              <RH,RW,false,kCHW,whole> (the grid's, where whole)
//   color_merge_direct_launch  k_color_merge<RH,RW,kTrunc,kHWC>
// They take the place of the torch passes the reference's (64, 256) grid
// put around B8-B13: the edge pad to the grid (an index gather over the
// whole frame), the HWC -> CHW copy, the Cb/Cr concatenation, the zero pads
// of the coefficient planes back to the grid and the crop of the merged
// frame.  Two chains run them with hp_codec.cu's B2 and B3, the u8 colour
// path's encode and decode in one call each (models/color.py on a card):
//   color_encode_u8_chain_launch  the direct split, B2 on luma, B2 on the
//                                 stacked chroma
//   color_decode_u8_chain_launch  B3 on luma, B3 on the stacked chroma, the
//                                 direct merge
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
// The direct instances run the same per-pixel chains on the caller's frame.
// The split's windows tile the chroma planes' luma extent (RH ch x RW cw,
// which covers the luma plane); a window row is read at row min(i, h - 1)
// and, where it crosses the right edge, byte by byte at columns
// min(j, w - 1): the frame the edge pad builds, bit for bit, since every
// extent read lies inside the (64, 256) grid.  Inside the frame an
// interleaved window row is 48 contiguous bytes, read as three 16-byte loads
// where rows are 16-byte aligned (w % 16 == 0), else byte by byte;
// consecutive threads read consecutive 48-byte spans.
// Y is written at (yh, yw) and Cb above Cr at (ch, cw) each, 8 bytes at a
// time where a plane's pitch is 8 mod 16, and nothing past a plane's edge.
// The merge reads the planes at those shapes and writes the (h, w, 3)
// frame, 48 bytes per window row, byte by byte at the right edge.
// A frame whose planes end where it does (rows 16-byte aligned, h a
// multiple of 8 RH, w of 16: the camera frame, 8192^2, the grid) runs the
// split's whole instance: no clamp, no test, 16-byte loads and stores only;
// the clamping code in the same kernel cost B8 17% (more registers, loads
// no longer issued ahead), so it is an instance of its own.
//
// Bound: memory.  Bytes per pixel (each input read once, each output
// written once): split and merge 4:2:0 4.5 (the variants too), 4:2:2 5,
// 4:4:4 6; at 8192^2 and 3.35 TB/s that is 0.090, 0.100 and 0.120 ms.  The
// direct instances move the same bytes per pixel of the frame (the planes'
// 8-row and 8-column pads aside): 4:2:0 4.5, 0.0164 ms at 4032 x 3024.  The
// arithmetic (about 20 operations per pixel, the merge's true division
// among them) stays well under that at the card's f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color_px.cuh"  // ColorConsts, byte access, the roundings, split_chroma, merge_px(_direct)

namespace {

// The merge's per-pixel chain: B9-B13's (trunc round), V1's (compare
// round), V12's (direct-form g, compare round).
enum class Merge { kTrunc, kCompare, kDirect };

// How an instance addresses its RGB side.  The split reads a planar
// (3, H, W) frame (kCHW: B8, B10, B12, V5 on the grid, and the direct split
// of a planar frame) or an interleaved (H, W, 3) one (kHWC), edge-clamped on
// reads and masked on writes.  The merge writes the planar kernel grid
// (kGrid: B9, B11, B13 and the variants, the reference's (3, H, W)
// contract, H % RH == 0 and W % 16 == 0) or the interleaved frame (kHWC:
// the direct merge), masked at its edges.
enum class Addr { kGrid, kCHW, kHWC };

// An instance's geometry: the RGB frame (h, w); for the direct instances
// also the luma plane (yh, yw) and each chroma plane (ch, cw), their true
// sizes rounded up to 8 (the codec kernels' planes), and `align`: 16 where
// every RGB row starts 16-byte aligned, else 1.
struct Frame {
  int h, w, yh, yw, ch, cw, align;
};

constexpr int kCols = 16;  // luma columns per thread
constexpr int kThreads = 256;

// Channel c of pixel e of a 16-pixel window row held in 12 words: planar
// (r's 16 bytes, then g's, then b's) or interleaved (r, g, b of pixel 0,
// then of pixel 1, ...).
template <bool kHWC>
__device__ __forceinline__ int px_index(int c, int e) {
  return kHWC ? 3 * e + c : kCols * c + e;
}

// N bytes (a multiple of 16) at p into N / 4 words: 16-byte loads where p is
// 16-byte aligned (`al` 16, the same for every thread), else byte loads.
template <int N>
__device__ __forceinline__ void load_run(const uint8_t* p, int al, uint32_t* v) {
  if (al == 16) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      v[i] = p[4 * i] | (p[4 * i + 1] << 8) | (p[4 * i + 2] << 16) | (static_cast<uint32_t>(p[4 * i + 3]) << 24);
  }
}

// The reverse of load_run.
template <int N>
__device__ __forceinline__ void store_run(uint8_t* p, int al, const uint32_t* v) {
  if (al == 16) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = static_cast<uint8_t>(v[i >> 2] >> (8 * (i & 3)));
  }
}

// The 16 bytes of a codec plane's row at p, of which `left` (a multiple of
// 8: the planes are 8-aligned) remain in the row: one 16-byte access where
// the row pitch keeps it aligned (`wide`), else 8-byte ones; bytes past the
// row are not written, and read as 0.
__device__ __forceinline__ void store_row16(uint8_t* p, const uint32_t (&v)[4], int left, bool wide) {
  if (left >= 16 && wide) {
    store_bytes<16>(p, v);
    return;
  }
  if (left >= 8) *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  if (left >= 16) *reinterpret_cast<uint2*>(p + 8) = make_uint2(v[2], v[3]);
}

__device__ __forceinline__ void load_row16(const uint8_t* p, uint32_t (&v)[4], int left, bool wide) {
  if (left >= 16 && wide) {
    load_bytes<16>(p, v);
    return;
  }
  v[0] = v[1] = v[2] = v[3] = 0u;
  if (left >= 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
  if (left >= 16) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + 8);
    v[2] = q.x; v[3] = q.y;
  }
}

// Window row `sr` (already clamped), columns c0 .. c0 + 15 of the frame
// into q (px_index's layout): load_run where the window lies inside the
// frame (16-byte loads for a whole window, kWhole), else byte loads at
// columns clamped to w - 1 (the right edge; the edge pad's replication).
template <Addr kAddr, bool kWhole>
__device__ __forceinline__ void load_window_row(const uint8_t* rgb, const Frame& f, int sr, int c0,
                                                uint32_t (&q)[12]) {
  constexpr bool kHWC = kAddr == Addr::kHWC;
  const long long plane = static_cast<long long>(f.h) * f.w;
  const long long row = static_cast<long long>(sr) * f.w;
  if (kWhole || c0 + kCols <= f.w) {
    const int al = kWhole ? 16 : f.align;
    if constexpr (kHWC) {
      load_run<3 * kCols>(rgb + (row + c0) * 3, al, q);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) load_run<kCols>(rgb + c * plane + row + c0, al, q + 4 * c);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) q[i] = 0u;
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const long long col = min(c0 + e, f.w - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint32_t b = kHWC ? rgb[(row + col) * 3 + c] : rgb[c * plane + row + col];
      const int i = px_index<kHWC>(c, e);
      q[i >> 2] |= b << (8 * (i & 3));
    }
  }
}

// One window row of the split: the 16 luma bytes into yv, each pixel's
// (c - 128) added to its chroma sample's sums.
template <int RW, bool kHWC>
__device__ __forceinline__ void split_row(const uint32_t (&q)[12], uint32_t (&yv)[4],
                                          int (&sum)[3][kCols / RW]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) yv[i] = 0u;
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int r = byte_at(q, px_index<kHWC>(0, e)), g = byte_at(q, px_index<kHWC>(1, e)),
              b = byte_at(q, px_index<kHWC>(2, e));
    const uint32_t luma = static_cast<uint32_t>((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
    yv[e >> 2] |= luma << (8 * (e & 3));
    sum[0][e / RW] += r - 128;
    sum[1][e / RW] += g - 128;
    sum[2][e / RW] += b - 128;
  }
}

// One window row of the merge: 16 pixels from their luma bytes and the
// shifted chroma of their samples, into o (px_index's layout).
template <int RW, Merge kForm, bool kHWC>
__device__ __forceinline__ void merge_row(const uint32_t (&yw)[4], const float (&cbc)[kCols / RW],
                                          const float (&crc)[kCols / RW], const ColorConsts& k,
                                          uint32_t (&o)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) o[i] = 0u;
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    uint32_t px[3];
    const float yf = static_cast<float>(byte_at(yw, e));
    if constexpr (kForm == Merge::kDirect)
      merge_px_direct(yf, cbc[e / RW], crc[e / RW], k, px[0], px[1], px[2]);
    else
      merge_px<kForm == Merge::kCompare>(yf, cbc[e / RW], crc[e / RW], k, px[0], px[1], px[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int i = px_index<kHWC>(c, e);
      o[i >> 2] |= px[c] << (8 * (i & 3));
    }
  }
}

// The RH rows of a split window: luma stored, chroma sums added.  kWhole: the
// window lies inside the frame and the luma plane, rows 16-byte aligned, so
// every load and store is a 16-byte one and none is tested; else rows and
// columns past the frame read its last row and column, and luma past the
// plane is not stored.
template <int RH, int RW, Addr kAddr, bool kWhole>
__device__ __forceinline__ void split_rows(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ y,
                                           const Frame& f, int crow, int c0, int (&sum)[3][kCols / RW]) {
  uint32_t q[RH][12];  // every row's loads first, issued together
#pragma unroll
  for (int a = 0; a < RH; ++a) {
    const int r = crow * RH + a;
    load_window_row<kAddr, kWhole>(rgb, f, kWhole ? r : min(r, f.h - 1), c0, q[a]);
  }
#pragma unroll
  for (int a = 0; a < RH; ++a) {
    const int r = crow * RH + a;
    uint32_t yv[4];
    split_row<RW, kAddr == Addr::kHWC>(q[a], yv, sum);
    uint8_t* py = y + static_cast<long long>(r) * f.yw + c0;
    if constexpr (kWhole)
      store_bytes<16>(py, yv);
    else if (r < f.yh)
      store_row16(py, yv, f.yw - c0, f.yw % 16 == 0);
  }
}

// One thread per RH x 16 window; windows tile the chroma planes' luma
// extent (RH ch) x (RW cw), which covers the luma plane.  kWhole: every
// window is whole (split_rows), as on the grid (B8, B10, B12, V5: a planar
// frame with h % RH == 0 and w % 16 == 0, the planes at their exact shapes)
// and on a direct frame whose planes end where the frame does; one instance
// per case keeps the whole one's registers at the grid's.
template <int RH, int RW, bool kTruncChroma, Addr kAddr, bool kWhole>
__global__ void k_color_split(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ y,
                              uint8_t* __restrict__ cb, uint8_t* __restrict__ cr, const Frame f,
                              const ColorConsts k) {
  static_assert(kAddr != Addr::kGrid, "the split reads the frame planar (kCHW) or interleaved (kHWC)");
  constexpr int V = kCols / RW;  // chroma samples of the window
  const int groups = (f.cw * RW + kCols - 1) / kCols;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(f.ch) * groups) return;
  const int crow = static_cast<int>(t / groups), g = static_cast<int>(t % groups);
  const int c0 = g * kCols;
  int sum[3][V];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) sum[c][v] = 0;
  split_rows<RH, RW, kAddr, kWhole>(rgb, y, f, crow, c0, sum);
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
  const long long co = static_cast<long long>(crow) * f.cw + g * V;
  if constexpr (V == kCols && !kWhole) {  // 4:4:4 on a plane 8-aligned only
    store_row16(cb + co, cbv, f.cw - g * V, f.cw % 16 == 0);
    store_row16(cr + co, crv, f.cw - g * V, f.cw % 16 == 0);
  } else {
    store_bytes<V>(cb + co, cbv);
    store_bytes<V>(cr + co, crv);
  }
}

// Windows tile the (h, w) frame; the planes are read at the frame's plane
// shapes (f.yw, f.cw).  On the grid the frame is written planar (3, h, w);
// direct, interleaved, masked at its right and bottom edges.
template <int RH, int RW, Merge kForm = Merge::kTrunc, Addr kAddr = Addr::kGrid>
__global__ void k_color_merge(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
                              const uint8_t* __restrict__ cr, uint8_t* __restrict__ out,
                              const Frame f, const ColorConsts k) {
  constexpr int V = kCols / RW;
  const int groups = (f.w + kCols - 1) / kCols;
  const int rows = (f.h + RH - 1) / RH;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(rows) * groups) return;
  const int crow = static_cast<int>(t / groups), g = static_cast<int>(t % groups);
  const int c0 = g * kCols;
  const long long plane = static_cast<long long>(f.h) * f.w;
  const long long co = static_cast<long long>(crow) * f.cw + g * V;
  uint32_t cbw[V / 4], crw[V / 4];
  if constexpr (V == kCols && kAddr != Addr::kGrid) {  // 4:4:4 on a plane 8-aligned only
    load_row16(cb + co, cbw, f.cw - g * V, f.cw % 16 == 0);
    load_row16(cr + co, crw, f.cw - g * V, f.cw % 16 == 0);
  } else {
    load_bytes<V>(cb + co, cbw);
    load_bytes<V>(cr + co, crw);
  }
  float cbc[V], crc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    cbc[v] = static_cast<float>(byte_at(cbw, v) - 128);
    crc[v] = static_cast<float>(byte_at(crw, v) - 128);
  }
#pragma unroll
  for (int a = 0; a < RH; ++a) {
    const int r = crow * RH + a;
    if (kAddr != Addr::kGrid && r >= f.h) break;
    const long long yo = static_cast<long long>(r) * f.yw + c0;
    uint32_t yv[4], o[12];
    if constexpr (kAddr == Addr::kGrid) {
      load_bytes<16>(y + yo, yv);
      merge_row<RW, kForm, false>(yv, cbc, crc, k, o);
#pragma unroll
      for (int c = 0; c < 3; ++c) store_run<kCols>(out + c * plane + yo, 16, o + 4 * c);
    } else {
      load_row16(y + yo, yv, f.yw - c0, f.yw % 16 == 0);
      merge_row<RW, kForm, true>(yv, cbc, crc, k, o);
      uint8_t* px = out + (static_cast<long long>(r) * f.w + c0) * 3;
      if (c0 + kCols <= f.w) {
        store_run<3 * kCols>(px, f.align, o);
      } else {
        for (int i = 0; i < 3 * (f.w - c0); ++i) px[i] = static_cast<uint8_t>(o[i >> 2] >> (8 * (i & 3)));
      }
    }
  }
}

inline dim3 grid_for(long long windows) {
  return dim3(static_cast<unsigned>((windows + kThreads - 1) / kThreads));
}

inline bool window_ok(int rh, int rw) {
  return (rh == 2 && rw == 2) || (rh == 1 && rw == 2) || (rh == 1 && rw == 1);
}

inline int prologue(int device, int h, int w, int rh, int rw) {
  if (!window_ok(rh, rw) || h <= 0 || w <= 0 || h % rh || w % kCols)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

// The grid's frame: the planes at their exact shapes, (h, w) and
// (h / rh, w / rw); B8-B13 and the variants.
inline Frame grid_frame(int h, int w, int rh, int rw) {
  return Frame{h, w, h, w, h / rh, w / rw, 16};
}

inline int up8(int n) { return (n + 7) / 8 * 8; }

// A direct instance's frame, or false where `align` is neither 1 nor 16 or
// does not hold for the RGB pointer and its row pitch (`pitch` bytes).
inline bool direct_frame(int h, int w, int rh, int rw, int align, const void* rgb, long long pitch,
                         Frame& f) {
  if (align != 1 && align != 16) return false;
  if (reinterpret_cast<uintptr_t>(rgb) % align || pitch % align) return false;
  f = Frame{h, w, up8(h), up8(w), up8((h + rh - 1) / rh), up8((w + rw - 1) / rw), align};
  return true;
}

template <int RH, int RW, bool kTruncChroma, Addr kAddr, bool kWhole>
void launch_split(const void* rgb, void* y, void* cb, void* cr, const Frame& f, const ColorConsts& k,
                  cudaStream_t s) {
  const long long windows = static_cast<long long>(f.ch) * ((f.cw * RW + kCols - 1) / kCols);
  k_color_split<RH, RW, kTruncChroma, kAddr, kWhole><<<grid_for(windows), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(rgb), static_cast<uint8_t*>(y), static_cast<uint8_t*>(cb),
      static_cast<uint8_t*>(cr), f, k);
}

// kCHW for a planar frame, on the grid or not; kHWC for an interleaved one.
// The whole instance where every window is whole: 16-byte aligned rows, the
// chroma planes' luma extent equal to the frame, the luma pitch a multiple
// of 16 (always on the grid).
template <int RH, int RW, Addr kAddr = Addr::kCHW>
void split(const void* rgb, void* y, void* cb, void* cr, const Frame& f, const ColorConsts& k,
           cudaStream_t s) {
  if (f.align == 16 && f.w % kCols == 0 && f.cw * RW == f.w && f.ch * RH == f.h && f.yw % 16 == 0)
    launch_split<RH, RW, false, kAddr, true>(rgb, y, cb, cr, f, k, s);
  else
    launch_split<RH, RW, false, kAddr, false>(rgb, y, cb, cr, f, k, s);
}

template <int RH, int RW, Merge kForm = Merge::kTrunc, Addr kAddr = Addr::kGrid>
void merge(const void* y, const void* cb, const void* cr, void* out, const Frame& f,
           const ColorConsts& k, cudaStream_t s) {
  const long long windows = static_cast<long long>((f.h + RH - 1) / RH) * ((f.w + kCols - 1) / kCols);
  k_color_merge<RH, RW, kForm, kAddr><<<grid_for(windows), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(cb),
      static_cast<const uint8_t*>(cr), static_cast<uint8_t*>(out), f, k);
}

template <Addr kAddr>
void split_direct(const void* rgb, void* y, void* cc, const Frame& f, int rh, int rw,
                  const ColorConsts& k, cudaStream_t s) {
  void* cr = static_cast<uint8_t*>(cc) + static_cast<long long>(f.ch) * f.cw;  // Cr below Cb
  if (rh == 2)
    split<2, 2, kAddr>(rgb, y, cc, cr, f, k, s);
  else if (rw == 2)
    split<1, 2, kAddr>(rgb, y, cc, cr, f, k, s);
  else
    split<1, 1, kAddr>(rgb, y, cc, cr, f, k, s);
}

// The direct merge of an interleaved frame, by chroma window.
void merge_direct(const void* y, const void* cb, const void* cr, void* out, const Frame& f, int rh,
                  int rw, const ColorConsts& k, cudaStream_t s) {
  if (rh == 2)
    merge<2, 2, Merge::kTrunc, Addr::kHWC>(y, cb, cr, out, f, k, s);
  else if (rw == 2)
    merge<1, 2, Merge::kTrunc, Addr::kHWC>(y, cb, cr, out, f, k, s);
  else
    merge<1, 1, Merge::kTrunc, Addr::kHWC>(y, cb, cr, out, f, k, s);
}

}  // namespace

// hp_codec.cu's B2 and B3 on the current device, for the colour chains.
int hp_encode_u8_enqueue(const void* img, void* coef, int h, int w, int core, const void* consts,
                         cudaStream_t s);
int hp_decode_u8_enqueue(const void* coef, void* rec, int h, int w, void* fwd, int core,
                         const void* consts, cudaStream_t s);

// ---- C interface -------------------------------------------------------------
// Pointers are device pointers (16-byte aligned, contiguous) except `consts`,
// a host pointer to 9 floats laid out as ColorConsts.  (rh, rw) is the chroma
// window: (2, 2) 4:2:0, (1, 2) 4:2:2, (1, 1) 4:4:4; on the grid h % rh == 0
// and w % 16 == 0.  The direct launchers take any h, w > 0: the split reads
// the (h, w) frame, planar (`hwc` 0) or interleaved (`hwc` 1), writes y at
// (yh, yw) and cc, Cb's (ch, cw) rows above Cr's; the merge reads y and cb,
// cr at those shapes and writes the interleaved (h, w, 3) frame.  Their
// frame pointer (the split's rgb, the merge's out) may lie at any byte:
// `align` is 16 where it and the row pitch are 16-byte aligned, else 1, and
// is refused where it does not hold.  The variant launchers are 4:2:0 only and
// take the study's variant number: merge 1 (V1) or 12 (V12), split 5 (V5);
// any other is refused with cudaErrorInvalidValue.  The two chain launchers
// are the u8 colour path's six launches in one call each, on one stream, in
// the order and with the instances of the wrappers' chain: the encode runs
// the direct split of `rgb` into y and cc (Cb's rows above Cr's, scratch),
// then hp_codec.cu's B2 on y into cy (`core_y`, the `luma` HpConsts) and on
// cc into ccq (`core_c`, `chroma`); the decode runs B3 on cy into y and on
// ccq into cc (`inv_y`, `inv_c`: B3's `core`), then the direct merge of y
// and cc into `out`.  They return the first error: a refused frame launches
// nothing, a refused core id stops the chain at its launch.  Each function
// returns a cudaError_t
// value (0 = ok) after checking the launch (hp_error_string in hp_codec.cu
// names it); it neither synchronizes nor allocates.

extern "C" {

int color_split_launch(const void* rgb, void* y, void* cb, void* cr, int h, int w, int rh, int rw,
                       const void* consts, void* stream, int device) {
  int err = prologue(device, h, w, rh, rw);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const ColorConsts& k = *static_cast<const ColorConsts*>(consts);
  const Frame f = grid_frame(h, w, rh, rw);
  if (rh == 2)
    split<2, 2>(rgb, y, cb, cr, f, k, s);
  else if (rw == 2)
    split<1, 2>(rgb, y, cb, cr, f, k, s);
  else
    split<1, 1>(rgb, y, cb, cr, f, k, s);
  return static_cast<int>(cudaGetLastError());
}

int color_merge_launch(const void* y, const void* cb, const void* cr, void* out, int h, int w,
                       int rh, int rw, const void* consts, void* stream, int device) {
  int err = prologue(device, h, w, rh, rw);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const ColorConsts& k = *static_cast<const ColorConsts*>(consts);
  const Frame f = grid_frame(h, w, rh, rw);
  if (rh == 2)
    merge<2, 2>(y, cb, cr, out, f, k, s);
  else if (rw == 2)
    merge<1, 2>(y, cb, cr, out, f, k, s);
  else
    merge<1, 1>(y, cb, cr, out, f, k, s);
  return static_cast<int>(cudaGetLastError());
}

int color_split_direct_launch(const void* rgb, void* y, void* cc, int h, int w, int rh, int rw,
                              int hwc, int align, const void* consts, void* stream, int device) {
  Frame f;
  const long long pitch = hwc ? 3LL * w : w;
  if (!window_ok(rh, rw) || h <= 0 || w <= 0 || !direct_frame(h, w, rh, rw, align, rgb, pitch, f))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const ColorConsts& k = *static_cast<const ColorConsts*>(consts);
  if (hwc)
    split_direct<Addr::kHWC>(rgb, y, cc, f, rh, rw, k, s);
  else
    split_direct<Addr::kCHW>(rgb, y, cc, f, rh, rw, k, s);
  return static_cast<int>(cudaGetLastError());
}

int color_merge_direct_launch(const void* y, const void* cb, const void* cr, void* out, int h,
                              int w, int rh, int rw, int align, const void* consts, void* stream,
                              int device) {
  Frame f;
  if (!window_ok(rh, rw) || h <= 0 || w <= 0 || !direct_frame(h, w, rh, rw, align, out, 3LL * w, f))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  merge_direct(y, cb, cr, out, f, rh, rw, *static_cast<const ColorConsts*>(consts),
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int color_encode_u8_chain_launch(const void* rgb, void* y, void* cc, void* cy, void* ccq, int h,
                                 int w, int rh, int rw, int hwc, int align, int core_y, int core_c,
                                 const void* consts, const void* luma, const void* chroma,
                                 void* stream, int device) {
  Frame f;
  const long long pitch = hwc ? 3LL * w : w;
  if (!window_ok(rh, rw) || h <= 0 || w <= 0 || !direct_frame(h, w, rh, rw, align, rgb, pitch, f))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const ColorConsts& k = *static_cast<const ColorConsts*>(consts);
  if (hwc)
    split_direct<Addr::kHWC>(rgb, y, cc, f, rh, rw, k, s);
  else
    split_direct<Addr::kCHW>(rgb, y, cc, f, rh, rw, k, s);
  err = static_cast<int>(cudaGetLastError());
  if (!err) err = hp_encode_u8_enqueue(y, cy, f.yh, f.yw, core_y, luma, s);
  if (!err) err = hp_encode_u8_enqueue(cc, ccq, 2 * f.ch, f.cw, core_c, chroma, s);
  return err;
}

int color_decode_u8_chain_launch(const void* cy, const void* ccq, void* y, void* cc, void* out, int h,
                                 int w, int rh, int rw, int align, int inv_y, int inv_c,
                                 const void* consts, const void* luma, const void* chroma,
                                 void* stream, int device) {
  Frame f;
  if (!window_ok(rh, rw) || h <= 0 || w <= 0 || !direct_frame(h, w, rh, rw, align, out, 3LL * w, f))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  err = hp_decode_u8_enqueue(cy, y, f.yh, f.yw, nullptr, inv_y, luma, s);
  if (!err) err = hp_decode_u8_enqueue(ccq, cc, 2 * f.ch, f.cw, nullptr, inv_c, chroma, s);
  if (err) return err;
  const void* cr = static_cast<const uint8_t*>(cc) + static_cast<long long>(f.ch) * f.cw;  // Cr below Cb
  merge_direct(y, cc, cr, out, f, rh, rw, *static_cast<const ColorConsts*>(consts), s);
  return static_cast<int>(cudaGetLastError());
}

int color_split_variant_launch(const void* rgb, void* y, void* cb, void* cr, int h, int w,
                               int variant, const void* consts, void* stream, int device) {
  if (variant != 5) return static_cast<int>(cudaErrorInvalidValue);
  int err = prologue(device, h, w, 2, 2);
  if (err) return err;
  launch_split<2, 2, true, Addr::kCHW, true>(rgb, y, cb, cr, grid_frame(h, w, 2, 2),
                                             *static_cast<const ColorConsts*>(consts),
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
  const Frame f = grid_frame(h, w, 2, 2);
  if (variant == 1)
    merge<2, 2, Merge::kCompare>(y, cb, cr, out, f, k, s);
  else
    merge<2, 2, Merge::kDirect>(y, cb, cr, out, f, k, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
