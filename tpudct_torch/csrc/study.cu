// Study kernels for NVIDIA Hopper (sm_90a): the measurement path's copy
// floors and the fused 4:2:0 color codec, built with the codec sources by
// tpudct_torch/kernels/_build.py into one shared library with a plain C
// interface (loaded with ctypes).
//
// Entry points and the Pallas TPU kernels they replace (benchmarks/):
//   u8_copy_launch, i8 null   B17  k_u8_copy<false>  u8_perf.py u8_copy (_copy_kernel)
//   u8_copy_launch            B18  k_u8_copy<true>   u8_perf.py u8_copy2 (_copy2_kernel)
//   color_encode_420_launch   B19  k_color_encode_420
//                                  color_fused_ab.py color_encode_420_u8 (_k_color_enc)
//   color_decode_420_launch   B20  k_color_decode_420
//                                  color_fused_ab.py color_decode_420_u8 (_k_color_dec)
//   enc_half_launch, dir 0    B30  k_enc_half<kEncRows>  enc_variants.py E2 (_k_enc_nosub)
//   enc_half_launch, dir 1    B31  k_enc_half<kEncCols>  enc_variants.py E3 (_k_enc_nolane)
// (The other eight kernels of u8_variants.py and enc_variants.py, B27-B29 and
// B32-B36, compute B1's and B2's values and launch their kernels,
// hp_codec.cu's k_rt_u8 and k_encode_u8: kernels/variants.py.)
//
// What they compute.
//   B17  an (H, W) u8 map copied onto itself (dst may equal src: the
//        reference aliases its output to its input): the HBM floor of a u8
//        pass, 2 B/px.
//   B18  the same, plus the bytes once more as int8 (the wrapping cast, a
//        reinterpretation): hp_roundtrip_u8's (B1) byte pattern, 3 B/px, with
//        no arithmetic.
//   B19  (3, H, W) u8 RGB -> int8 coefficients of Y (H, W), Cb and Cr
//        (H/2, W/2) in one pass.  Luma: the f32 BT.601 KR r + KG g + KB b,
//        every product and sum rounded on its own (luma_f32), then _to_u8
//        (the compare form: clip, floor, +1 where frac >= 0.5) and the level
//        shift; NOT the production split's 16-bit fixed-point luma (B8), so
//        B19's Y differs from the composed path's by +-1 where the two
//        roundings part.  Chroma: B8's exact 2x2 pool, BT.601 and round
//        (split_chroma's chain).  Then B2's exact integer forward and
//        quantizer with the luma table for Y and the chroma table for Cb and
//        Cr, on the integer core `core` (one instance per core).
//   B20  Y, Cb, Cr int8 -> (3, H, W) u8 RGB in one pass: B3's butterfly
//        decode of every block, trunc and clamp, nearest 2x2 chroma
//        replication and the BT.601 inverse.  Its twin rounds with the
//        compare form _to_u8; the kernel with the production merge's add
//        form (B9), which equals it on every (y, cb, cr) triple, so B20 is
//        bit-identical to its twin and to decode_color_u8 (B3 twice, B9).
//   B30  (H, W) u8 -> int8, haweel, luma table, q_scale 1: the TPU study's
//        forward with its column half replaced by a scaling, so other values
//        than B2's: per 8x8 block round_away(fl(f32(12 (X - 128) Ts^T) S)),
//        saturated to [-128, 127] (S: B2's fused scale, by position in the
//        block).
//   B31  the same with the row half left out instead:
//        round_away(fl(f32(Ts (X - 128)) S)) (|value| <= 17, never saturated).
// The TPU kernels stack Cb over Cr for one K=128 contraction and pool with
// 0/1 matrices on the MXU; the integer forward is exact per 8x8 block, so
// here each chroma block is transformed on its own.  The plain twins in
// kernels/study.py compute the same chains, so kernel and twin agree bit for
// bit.
//
// Design.  B17/B18: copy.cuh's copy body, shared with B14 (see its header:
// TMA bulk copies through a ring of shared-memory stages, one block per SM,
// in place allowed; B18 stores each tile twice).  B19: one thread block of
// 128 threads per 16 x 256 luma strip; each thread first reads a 2 x 16
// window of the three planes (16 bytes a row), writes its 32 luma bytes and
// its 8 Cb and 8 Cr bytes into shared memory, then threads 0-63 each run
// the encode of one luma block and threads 64-95 of one chroma block from
// shared memory: B2's add-only chain (hp_block.cuh: load_u8_level, the
// butterfly forward fwd_core, quantize_store_i8; one 8x8 block of f32 live
// per thread).  No conversion instruction per pixel: a byte becomes f32 as
// biased_byte - 2^23, the chroma window sums stay exact in f32, and the
// compare-form round is two round-down adds (round_u8_2p23), its byte
// packed by PRMT.  B20: strip420.cuh's body, B16's without the forward (see
// its header: one thread block per 16 x 256 luma strip, an add-only inverse
// compiled per integer core, no conversion instructions per pixel).  Timed
// beside B19 and dropped (PERF.md section 6): B20's 96-thread shape, each
// luma thread taking its own block's luma in registers (95 registers, only
// 64 of 96 threads staging: 1.23x B19's time).
//
// Bound: memory.  Bytes per luma pixel (each input read once, each output
// written once): B17 2, B18 3, B19 and B20 4.5 (RGB 3, coefficients 1.5),
// B30 and B31 2; at 8192^2 and 3.35 TB/s 0.040, 0.060, 0.090 and 0.040 ms.
// The arithmetic (B19: B8's chain with the f32 luma and B2's on 1.5 coefficients, about 50 operations
// per luma pixel; B20: B3's 1.5 times plus B9's, about 53 instructions per
// luma pixel) is under that at the card's f32 rate, but its instructions
// take about as long to issue (0.09-0.11 ms at 8192^2 and 1.98 GHz).

#include <cuda_runtime.h>
#include <stdint.h>

#include "copy.cuh"      // the copy body (B17, B18)
#include "strip420.cuh"  // the strip body (B20) and geometry (B19); the add-only block chain; ColorConsts, luma_f32

namespace {

// n bytes of src -> dst (which may be src) and, for B18, -> i8: copy.cuh's body.
template <bool kI8>
__global__ void __launch_bounds__(kCopyThreads)
    k_u8_copy(const uint8_t* src, uint8_t* dst, int8_t* i8, long long n) {
  copy_bytes<kI8>(src, dst, i8, n);
}

// ---- B19: the fused 4:2:0 encode ----------------------------------------------

// B19's constants: the luma and chroma quantizer scales (the integer core's
// fq, retain_k folded in), then the color chain's.
struct EncodeConsts {
  float fl[64], fc[64];
  ColorConsts kk;
};

// Byte e of w as an exact f32: the bits 0x4B000000 and the byte, minus 2^23.
__device__ __forceinline__ float byte_f32(uint32_t w, int e) { return __fsub_rn(biased_byte(w, e), kTwo23); }

// 2^23 + round_u8(z), the compare form _to_u8 (color_px.cuh's round_u8:
// zp = clip(z, 0, 255), then floor(zp) + [zp - floor(zp) >= 0.5]), without
// FRND or F2I: that difference is exact, so round_u8 is floor(zp + 0.5)
// taken exactly; zp + 0.5 rounded down is no less than that integer (which
// is representable and no larger than the exact sum) and less than the next,
// and 2^23 + it rounded down has the floor, the byte, in its low mantissa
// bits.
__device__ __forceinline__ float round_u8_2p23(float z) {
  return __fadd_rd(__fadd_rd(fminf(fmaxf(z, 0.0f), 255.0f), 0.5f), kTwo23);
}

// One chroma sample from the sums sr, sg, sb of r, g, b over its 2 x 2
// window (exact f32) -> words whose low bytes are cb and cr: split_chroma's
// chain.  Its pooled channel sum * 0.25 + 128 over the sums of (c - 128) is
// the window sum * 0.25 here, both exact (a multiple of 1/4 below 256).
__device__ __forceinline__ void split_chroma_420(float sr, float sg, float sb, const ColorConsts& k, uint32_t& cb,
                                                 uint32_t& cr) {
  const float pr = __fmul_rn(sr, 0.25f), pg = __fmul_rn(sg, 0.25f), pb = __fmul_rn(sb, 0.25f);
  const float yp = luma_f32(pr, pg, pb, k);
  cb = __float_as_uint(round_u8_2p23(__fadd_rn(__fmul_rn(__fsub_rn(pb, yp), k.kcb), 128.0f)));
  cr = __float_as_uint(round_u8_2p23(__fadd_rn(__fmul_rn(__fsub_rn(pr, yp), k.kcr), 128.0f)));
}

// x: a block's level-shifted samples in, its coefficients out and stored as
// 8 int8 rows at p (pitch elements apart): fwd_core and quantize_store_i8,
// B2's chain, on the scales fq.
template <int kCore>
__device__ __forceinline__ void encode_rows(float (&x)[64], int8_t* p, long long pitch, const float* fq) {
  fwd_core<kCore>(x);
#pragma unroll
  for (int r = 0; r < 8; ++r) quantize_store_i8(p + r * pitch, x + 8 * r, fq + 8 * r);
}

// One block of 128 threads per 16 x 256 luma strip.  Thread t first reads a
// 2 x 16 window of the three planes (16 bytes a row), rows 2 (t / 16) and
// the next, columns 16 (t % 16) to + 16 of the strip, and stages its 32
// luma bytes and its 8 cb and 8 cr bytes in shared memory; after one
// barrier, threads 0-63 run the encode of luma block (t / 32, t % 32) and
// thread 64 + 16 p + b that of block b of chroma plane p (cb, cr), each
// from shared memory.
constexpr int kWinCols = 16;                                               // luma columns of a window
constexpr int kEncThreads = (kStripRows / 2) * (kStripCols / kWinCols);  // 2 x 16 windows: 128

template <int kCore>
__global__ void __launch_bounds__(kEncThreads)
    k_color_encode_420(const uint8_t* __restrict__ rgb, int8_t* __restrict__ y, int8_t* __restrict__ cb,
                       int8_t* __restrict__ cr, int h, int w, const EncodeConsts k) {
  __shared__ __align__(16) uint8_t ys[kStripRows][kStripCols];
  __shared__ __align__(16) uint8_t cs[2][kChromaRows][kChromaCols];
  long long r0, c0;
  strip_origin(w, r0, c0);
  const long long plane = static_cast<long long>(h) * w;
  const int t = threadIdx.x;
  {
    const int a = t / (kStripCols / kWinCols), g = t % (kStripCols / kWinCols);
    float sum[3][kWinCols / 2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 2 * a + i;
      const long long ro = (r0 + row) * w + c0 + g * kWinCols;
      uint32_t px[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) load_bytes<16>(rgb + c * plane + ro, px[c]);
      uint32_t yb[kWinCols];
#pragma unroll
      for (int e = 0; e < kWinCols; ++e) {
        float v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[c] = byte_f32(px[c][e >> 2], e & 3);
          sum[c][e / 2] = i == 0 && e % 2 == 0 ? v[c] : __fadd_rn(sum[c][e / 2], v[c]);
        }
        yb[e] = __float_as_uint(round_u8_2p23(luma_f32(v[0], v[1], v[2], k.kk)));
      }
      const uint32_t yv[4] = {pack4(yb[0], yb[1], yb[2], yb[3]), pack4(yb[4], yb[5], yb[6], yb[7]),
                              pack4(yb[8], yb[9], yb[10], yb[11]), pack4(yb[12], yb[13], yb[14], yb[15])};
      store_bytes<16>(&ys[row][g * kWinCols], yv);
    }
    uint32_t zb[kWinCols / 2], zr[kWinCols / 2];
#pragma unroll
    for (int v = 0; v < kWinCols / 2; ++v) split_chroma_420(sum[0][v], sum[1][v], sum[2][v], k.kk, zb[v], zr[v]);
    const uint32_t cbv[2] = {pack4(zb[0], zb[1], zb[2], zb[3]), pack4(zb[4], zb[5], zb[6], zb[7])};
    const uint32_t crv[2] = {pack4(zr[0], zr[1], zr[2], zr[3]), pack4(zr[4], zr[5], zr[6], zr[7])};
    store_bytes<8>(&cs[0][a][g * kWinCols / 2], cbv);
    store_bytes<8>(&cs[1][a][g * kWinCols / 2], crv);
  }
  __syncthreads();
  if (t >= kStripThreads) return;  // one warp stages only
  float x[64];
  if (t < kLumaBlocks) {
    const int by = t / (kStripCols / 8), bx = t % (kStripCols / 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) load_u8_level(&ys[by * 8 + i][bx * 8], x + 8 * i);
    encode_rows<kCore>(x, y + (r0 + by * 8) * w + c0 + bx * 8, w, k.fl);
  } else {
    const int q = t - kLumaBlocks, pl = q / (kChromaCols / 8), bx = q % (kChromaCols / 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) load_u8_level(&cs[pl][i][bx * 8], x + 8 * i);
    const int cw = w / 2;
    encode_rows<kCore>(x, (pl ? cr : cb) + (r0 / 2) * cw + c0 / 2 + bx * 8, cw, k.fc);
  }
}

template <int kCore>
__global__ void __launch_bounds__(kStripThreads)
    k_color_decode_420(const int8_t* __restrict__ y, const int8_t* __restrict__ cb,
                       const int8_t* __restrict__ cr, uint8_t* __restrict__ rgb, int h, int w,
                       const StripConsts k) {
  decode_merge_strip_420<kCore>(y, cb, cr, nullptr, nullptr, nullptr, rgb, static_cast<long long>(h) * w, w, k);
}

// ---- B30 and B31: one direction of B2's forward -------------------------------

// The direction k_enc_half transforms (enc_half_launch's `dir`), and the
// integer core it runs: haweel, core_ts's first table (the reference's
// study kernels run haweel only; kernels/variants.py checks the table).
constexpr int kEncRows = 0;  // B30 (E2): 12 (X - 128) Ts^T, each block row alone
constexpr int kEncCols = 1;  // B31 (E3): Ts (X - 128), each block column alone
constexpr int kHaweel = 0;

// One row of 8 sums v -> the int8 bytes of round_away(fl(v s)), saturated
// to [-128, 127] as the reference's f32 -> int8 cast saturates (a plain
// cast would wrap), in one 8-byte store at p.
__device__ __forceinline__ void store_sat_i8(int8_t* p, const float* v, const float* s) {
  uint32_t b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    b[e] = i8_bits(fminf(fmaxf(round_away(__fmul_rn(v[e], s[e])), -128.0f), 127.0f));
  *reinterpret_cast<uint2*>(p) = make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

// One thread per 8x8 block, as B2: the block's u8 rows level-shifted to
// exact f32, one direction of the butterfly forward (fwd8; E2 first scales
// by 12, so every partial sum is an integer of magnitude at most
// 12 * 128 * 12 = 18432 < 2^24 and exact), then the fused scale k.fq, the
// round and the saturation per entry.
template <int kDir>
__global__ void k_enc_half(const uint8_t* __restrict__ img, int8_t* __restrict__ out, int h, int w,
                           const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
  ROWS(load_u8_level(img + ro, x + 8 * r));
  if constexpr (kDir == kEncRows) {
#pragma unroll
    for (int e = 0; e < 64; ++e) x[e] = __fmul_rn(x[e], 12.0f);
#pragma unroll
    for (int i = 0; i < 8; ++i) fwd8<kHaweel, 1>(x + 8 * i);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) fwd8<kHaweel, 8>(x + c);
  }
  ROWS(store_sat_i8(out + ro, x + 8 * r, k.fq + 8 * r));
}

constexpr int kEncHalfThreads = 128;

inline int strip_prologue(int device, int h, int w) {
  if (h <= 0 || w <= 0 || h % kStripRows || w % kStripCols) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

inline dim3 strip_grid(int h, int w) {
  return dim3(static_cast<unsigned>(static_cast<long long>(h / kStripRows) * (w / kStripCols)));
}

}  // namespace

// ---- C interface -------------------------------------------------------------
// Pointers are device pointers (16-byte aligned, contiguous) except the
// consts, a host pointer to 137 floats: for the encode laid out as
// EncodeConsts (the luma and chroma quantizer scales, then ColorConsts),
// for the decode as StripConsts (the luma and chroma dequantization
// multipliers, then ColorConsts); `core` picks the integer core
// (hp_block.cuh's core_ts, kernels/cores.py's CORES).  u8_copy_launch copies n bytes of src
// to dst (which may be src) and, unless i8 is null, to i8; the color
// launchers need h % 16 == 0 and w % 256 == 0.  enc_half_launch reads the
// consts as HpConsts (320 floats, kernels/hp.py's packed tables; it reads
// the fused scale fq) and needs h % 8 == 0 and w % 8 == 0.  Each function returns a
// cudaError_t value (0 = ok; hp_error_string in hp_codec.cu names it) after
// checking the launch; it neither synchronizes nor allocates.

extern "C" {

int u8_copy_launch(const void* src, void* dst, void* i8, long long n, void* stream, int device) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err || n == 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(src);
  auto* d = static_cast<uint8_t*>(dst);
  if (i8) return launch_copy(k_u8_copy<true>, n, s, x, d, static_cast<int8_t*>(i8), n);
  return launch_copy(k_u8_copy<false>, n, s, x, d, static_cast<int8_t*>(nullptr), n);
}

int color_encode_420_launch(const void* rgb, void* y, void* cb, void* cr, int h, int w, int core,
                            const void* consts, void* stream, int device) {
  using Kernel = decltype(&k_color_encode_420<0>);
  static const Kernel kernels[kCores] = {k_color_encode_420<0>, k_color_encode_420<1>, k_color_encode_420<2>,
                                         k_color_encode_420<3>};
  if (core < 0 || core >= kCores) return static_cast<int>(cudaErrorInvalidValue);
  int err = strip_prologue(device, h, w);
  if (err) return err;
  kernels[core]<<<strip_grid(h, w), kEncThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<int8_t*>(y), static_cast<int8_t*>(cb),
      static_cast<int8_t*>(cr), h, w, *static_cast<const EncodeConsts*>(consts));
  return static_cast<int>(cudaGetLastError());
}

int color_decode_420_launch(const void* y, const void* cb, const void* cr, void* rgb, int h, int w, int core,
                            const void* consts, void* stream, int device) {
  using Kernel = decltype(&k_color_decode_420<0>);
  static const Kernel kernels[kCores] = {k_color_decode_420<0>, k_color_decode_420<1>, k_color_decode_420<2>,
                                         k_color_decode_420<3>};
  if (core < 0 || core >= kCores) return static_cast<int>(cudaErrorInvalidValue);
  int err = strip_prologue(device, h, w);
  if (err) return err;
  return launch_strips(kernels[core], h, w, static_cast<cudaStream_t>(stream), static_cast<const int8_t*>(y),
                       static_cast<const int8_t*>(cb), static_cast<const int8_t*>(cr), static_cast<uint8_t*>(rgb),
                       h, w, *static_cast<const StripConsts*>(consts));
}

int enc_half_launch(const void* img, void* out, int h, int w, int dir, const void* consts, void* stream,
                    int device) {
  if (h <= 0 || w <= 0 || h % 8 || w % 8 || (dir != kEncRows && dir != kEncCols))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  const long long blocks = static_cast<long long>(h / 8) * (w / 8);
  const dim3 grid(static_cast<unsigned>((blocks + kEncHalfThreads - 1) / kEncHalfThreads));
  using Kernel = decltype(&k_enc_half<kEncRows>);
  const Kernel kernel = dir == kEncRows ? k_enc_half<kEncRows> : k_enc_half<kEncCols>;
  kernel<<<grid, kEncHalfThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<int8_t*>(out), h, w, *static_cast<const HpConsts*>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
