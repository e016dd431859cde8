// hp codec kernels for NVIDIA Hopper (sm_90a): the fused 8x8 blockwise
// approximate-DCT codec pass, built by tpudct_torch/kernels/_build.py with
// nvcc into a shared library with a plain C interface (loaded with ctypes).
//
// Entry points and the Pallas TPU kernels they replace
// (tpudct/kernels/hp_pallas.py):
//   hp_rt_u8_launch      B1  hp_roundtrip_u8  (_k_rt_u8_bf, _k_rt_u8)
//   hp_encode_u8_launch  B2  hp_encode_u8     (_k_encode_u8)
//   hp_decode_u8_launch  B3  hp_decode_u8     (_k_decode_u8_bf, _k_decode_u8)
//   hp_rt_f32_launch     B4  hp_roundtrip     (_k_rt_int_bf, _k_rt_int)
//
// Value chain (identical to the reference's, rounding included):
//   forward  c = trunc(fl(fl(f32(Ts X Ts^T) * scale) + copysign(0.5)))
//            Ts X Ts^T is exact integer arithmetic (|Ts| <= 2, |X| <= 128,
//            every partial sum < 2^24, so it is exact in f32 with or
//            without FMA contraction); scale = d_i d_l / (Q q_scale) times
//            the zonal mask.  The multiply and the tie-add are each rounded
//            (__fmul_rn, __fadd_rn): an FMA there moves which .5 ties flip.
//   inverse  M = fl(c * S); X = A^T M A summed k = 0..7 over rows, then
//            j = 0..7 over columns, every product and sum rounded on its own
//            (no FMA), then + 128.  A = Ts with S = Q q_scale d d^T is the
//            "butterfly" tier; A = T (f32 literals) with S = Q q_scale is
//            the "highest" tier: one body, two constant sets.  The plain
//            twins in kernels/hp.py sum in the same order, so kernel and
//            twin agree bit for bit.
//   u8 out   clamp(trunc(X + 128), 0, 255).
//
// Design: one thread per 8x8 block, the block held in registers.  A thread
// reads its block as 8 row loads of 8 bytes (u8/int8) or 32 bytes (f32);
// consecutive threads own horizontally adjacent blocks, so a warp's row
// load is one contiguous 256-byte (or 1 KiB) span.  The 8x8 constants ride
// the kernel parameters (constant bank, read uniformly by the warp).
//
// Bound: memory.  The fused u8 pass moves 3 bytes per pixel (read u8, write
// int8 + u8): 192 MiB at 8192^2, about 60 us at the H100 SXM's 3.35 TB/s.
// The arithmetic is ~2k f32 operations per block.  This first version
// favours a plain, checkable shape over reaching that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct HpConsts {
  float ts[64];     // integer core Ts, row-major (exact small integers)
  float scale[64];  // forward quantization scale per position
  float a[64];      // inverse transform matrix (Ts or T)
  float s[64];      // dequantization multiplier per position
};

__device__ __forceinline__ void fwd_block(float x[64], const HpConsts& k) {
  // x: level-shifted pixels in, quantized coefficients (integral f32) out.
  float u[64];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = k.ts[i * 8] * x[c];
#pragma unroll
      for (int kk = 1; kk < 8; ++kk) acc += k.ts[i * 8 + kk] * x[kk * 8 + c];
      u[i * 8 + c] = acc;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float core = u[i * 8] * k.ts[j * 8];
#pragma unroll
      for (int l = 1; l < 8; ++l) core += u[i * 8 + l] * k.ts[j * 8 + l];
      const float z = __fmul_rn(core, k.scale[i * 8 + j]);
      x[i * 8 + j] = truncf(__fadd_rn(z, copysignf(0.5f, z)));
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

// ---- 8-wide row loads and stores -------------------------------------------

__device__ __forceinline__ void load_u8_shifted(const uint8_t* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = static_cast<float>(static_cast<int>((v.x >> (8 * e)) & 0xffu) - 128);
    x[4 + e] = static_cast<float>(static_cast<int>((v.y >> (8 * e)) & 0xffu) - 128);
  }
}

__device__ __forceinline__ void load_i8(const int8_t* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = static_cast<float>(static_cast<int8_t>((v.x >> (8 * e)) & 0xffu));
    x[4 + e] = static_cast<float>(static_cast<int8_t>((v.y >> (8 * e)) & 0xffu));
  }
}

// f32 pixels: trunc to int32, subtract 128, wrap to int8 — the reference's
// (x.astype(int32) - 128).astype(int8) for the int core.
__device__ __forceinline__ void load_f32_shifted(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[e] = static_cast<float>(static_cast<int8_t>(__float2int_rz(v[e]) - 128));
}

__device__ __forceinline__ void store_i8(int8_t* p, const float* c) {
  uint2 v = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v.x |= (static_cast<uint32_t>(__float2int_rz(c[e])) & 0xffu) << (8 * e);
    v.y |= (static_cast<uint32_t>(__float2int_rz(c[4 + e])) & 0xffu) << (8 * e);
  }
  *reinterpret_cast<uint2*>(p) = v;
}

__device__ __forceinline__ uint32_t to_u8(float x) {
  return static_cast<uint32_t>(fminf(fmaxf(truncf(x), 0.0f), 255.0f));
}

__device__ __forceinline__ void store_u8(uint8_t* p, const float* x) {
  uint2 v = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v.x |= to_u8(x[e]) << (8 * e);
    v.y |= to_u8(x[4 + e]) << (8 * e);
  }
  *reinterpret_cast<uint2*>(p) = v;
}

__device__ __forceinline__ void store_f32(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// ---- kernels ---------------------------------------------------------------

// Element offset of row r of this thread's block, or -1 past the last block.
__device__ __forceinline__ long long block_origin(int h, int w) {
  const long long nbw = w / 8;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= (h / 8) * nbw) return -1;
  return (b / nbw) * 8 * static_cast<long long>(w) + (b % nbw) * 8;
}

__global__ void k_rt_u8(const uint8_t* __restrict__ img, int8_t* __restrict__ coef,
                        uint8_t* __restrict__ rec, int h, int w, const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
#pragma unroll
  for (int r = 0; r < 8; ++r) load_u8_shifted(img + o + r * static_cast<long long>(w), x + 8 * r);
  fwd_block(x, k);
#pragma unroll
  for (int r = 0; r < 8; ++r) store_i8(coef + o + r * static_cast<long long>(w), x + 8 * r);
  inv_block(x, k);
#pragma unroll
  for (int r = 0; r < 8; ++r) store_u8(rec + o + r * static_cast<long long>(w), x + 8 * r);
}

__global__ void k_encode_u8(const uint8_t* __restrict__ img, int8_t* __restrict__ coef,
                            int h, int w, const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
#pragma unroll
  for (int r = 0; r < 8; ++r) load_u8_shifted(img + o + r * static_cast<long long>(w), x + 8 * r);
  fwd_block(x, k);
#pragma unroll
  for (int r = 0; r < 8; ++r) store_i8(coef + o + r * static_cast<long long>(w), x + 8 * r);
}

__global__ void k_decode_u8(const int8_t* __restrict__ coef, uint8_t* __restrict__ rec,
                            int h, int w, const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
#pragma unroll
  for (int r = 0; r < 8; ++r) load_i8(coef + o + r * static_cast<long long>(w), x + 8 * r);
  inv_block(x, k);
#pragma unroll
  for (int r = 0; r < 8; ++r) store_u8(rec + o + r * static_cast<long long>(w), x + 8 * r);
}

__global__ void k_rt_f32(const float* __restrict__ img, float* __restrict__ coef,
                         float* __restrict__ rec, int h, int w, const HpConsts k) {
  const long long o = block_origin(h, w);
  if (o < 0) return;
  float x[64];
#pragma unroll
  for (int r = 0; r < 8; ++r) load_f32_shifted(img + o + r * static_cast<long long>(w), x + 8 * r);
  fwd_block(x, k);
#pragma unroll
  for (int r = 0; r < 8; ++r) store_f32(coef + o + r * static_cast<long long>(w), x + 8 * r);
  inv_block(x, k);
#pragma unroll
  for (int r = 0; r < 8; ++r) store_f32(rec + o + r * static_cast<long long>(w), x + 8 * r);
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

}  // namespace

// ---- C interface -------------------------------------------------------------
// Pointers are device pointers except `consts`, a host pointer to 256 floats
// laid out as HpConsts.  Each function returns a cudaError_t value (0 = ok)
// after checking the launch; it neither synchronizes nor allocates.

extern "C" {

int hp_rt_u8_launch(const void* img, void* coef, void* rec, int h, int w,
                    const void* consts, void* stream, int device) {
  int err = prologue(device, h, w);
  if (err) return err;
  k_rt_u8<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<int8_t*>(coef), static_cast<uint8_t*>(rec), h, w,
      *static_cast<const HpConsts*>(consts));
  return static_cast<int>(cudaGetLastError());
}

int hp_encode_u8_launch(const void* img, void* coef, int h, int w, const void* consts,
                        void* stream, int device) {
  int err = prologue(device, h, w);
  if (err) return err;
  k_encode_u8<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<int8_t*>(coef), h, w,
      *static_cast<const HpConsts*>(consts));
  return static_cast<int>(cudaGetLastError());
}

int hp_decode_u8_launch(const void* coef, void* rec, int h, int w, const void* consts,
                        void* stream, int device) {
  int err = prologue(device, h, w);
  if (err) return err;
  k_decode_u8<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(coef), static_cast<uint8_t*>(rec), h, w,
      *static_cast<const HpConsts*>(consts));
  return static_cast<int>(cudaGetLastError());
}

int hp_rt_f32_launch(const void* img, void* coef, void* rec, int h, int w,
                     const void* consts, void* stream, int device) {
  int err = prologue(device, h, w);
  if (err) return err;
  k_rt_f32<<<grid_for(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(coef), static_cast<float*>(rec), h, w,
      *static_cast<const HpConsts*>(consts));
  return static_cast<int>(cudaGetLastError());
}

const char* hp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
