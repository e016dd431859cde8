// The one byte-copy body of the port, shared by ring.cu (B14,
// k_ring_forward: a ring hop's slot to the next rank's replica) and study.cu
// (B17/B18, k_u8_copy<kI8>: the u8 map in place, and B18 its bytes once more
// as int8).  TPU kernels they replace: tpudct/parallel/ring.py:124
// (_ring_all_gather_kernel), benchmarks/u8_perf.py:35 (_copy_kernel) and :53
// (_copy2_kernel).
//
// Bound: memory.  Each byte is read once and written once (B18: twice), 2
// (3) B per byte copied; at 8192^2 u8 and 3.35 TB/s 0.040 (0.060) ms, and a
// B14 slot at n ranks 0.040 / n ms.  No arithmetic: what costs time is how
// the reads and writes reach the memory.
//
// Design: the Tensor Memory Accelerator's bulk copies.  A persistent grid
// of kCopyBlocksPerSm blocks per SM (fewer where the copy is small), each
// block one contiguous chunk of the 16-byte aligned body (the chunks equal,
// to 512 bytes).  In each block one thread drives a ring of kCopyStages
// shared-memory stages of kCopyTile bytes: cp.async.bulk global -> shared,
// completing on the stage's mbarrier, then cp.async.bulk shared -> global
// (to dst, and for B18 to i8 as well) as each stage lands; a stage is loaded
// again once the store before the newest has read it (commit_group /
// wait_group.read 1), so up to kCopyStages tiles are in flight per block.
// The copy engine moves whole tiles: no registers hold data, and each
// request is one long contiguous read or write.  In place is safe: a tile is
// read whole before it is written back.  The bytes before src's first
// 16-byte boundary and after the last whole 16 go through single-byte
// accesses in the same launch; where dst (or i8) does not share src's offset
// mod 16, the whole copy does (bulk copies need 16-byte aligned addresses
// and sizes).  B14's dst may be a peer card's memory (once ring_enable_peer
// allowed it): a bulk store to it has never run (one card).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kCopyThreads = 128;  // thread 0 drives the ring; the head and tail bytes use all
constexpr int kCopyBlocksPerSm = 1;
constexpr int kCopyStages = 6;
constexpr int kCopyTile = 32 * 1024;                                    // bytes, a multiple of 16
constexpr int kCopySmem = kCopyStages * kCopyTile + kCopyStages * 8;  // the stages, then their mbarriers
constexpr long long kCopyGrain = 512;                                   // chunk granularity in bytes

template <bool kI8>
__device__ __forceinline__ void copy_byte(const uint8_t* src, uint8_t* dst, int8_t* i8, long long i) {
  const uint8_t v = src[i];
  dst[i] = v;
  if constexpr (kI8) i8[i] = static_cast<int8_t>(v);
}

__device__ __forceinline__ void bulk_load(uint32_t stage, const uint8_t* g, uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(stage), "l"(reinterpret_cast<uint64_t>(g)), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* g, uint32_t stage, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(g)), "r"(stage), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Copies n bytes of src to dst and, if kI8, to i8 (the wrapping cast).  dst
// may equal src.  Launched by launch_copy (kCopySmem bytes of dynamic shared
// memory, kCopyThreads threads a block).
template <bool kI8>
__device__ __forceinline__ void copy_bytes(const uint8_t* src, uint8_t* dst, int8_t* i8, long long n) {
  extern __shared__ __align__(128) uint8_t smem[];
  const long long t = static_cast<long long>(blockIdx.x) * kCopyThreads + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kCopyThreads;
  const uintptr_t off = reinterpret_cast<uintptr_t>(src) % 16;
  const bool bulk = reinterpret_cast<uintptr_t>(dst) % 16 == off &&
                    (!kI8 || reinterpret_cast<uintptr_t>(i8) % 16 == off);
  if (!bulk) {
    for (long long i = t; i < n; i += threads) copy_byte<kI8>(src, dst, i8, i);
    return;
  }
  const long long head = min(n, static_cast<long long>((16 - off) % 16));
  const long long body = (n - head) / 16 * 16;
  if (t < head) copy_byte<kI8>(src, dst, i8, t);
  if (t < n - head - body) copy_byte<kI8>(src, dst, i8, head + body + t);
  if (threadIdx.x != 0) return;
  long long chunk = (body + gridDim.x - 1) / gridDim.x;
  chunk = (chunk + kCopyGrain - 1) / kCopyGrain * kCopyGrain;
  const long long begin = blockIdx.x * chunk, end = min(body, begin + chunk);
  if (begin >= end) return;
  const uint8_t* s = src + head + begin;
  uint8_t* d = dst + head + begin;
  int8_t* e = kI8 ? i8 + head + begin : nullptr;
  const long long count = (end - begin + kCopyTile - 1) / kCopyTile;  // tiles; the last may be short
  auto bytes = [&](long long k) {
    return static_cast<uint32_t>(min(static_cast<long long>(kCopyTile), end - begin - k * kCopyTile));
  };
  const uint32_t stages = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t bars = stages + kCopyStages * kCopyTile;
  for (int k = 0; k < kCopyStages; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * k) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (long long k = 0; k < count && k < kCopyStages; ++k)
    bulk_load(stages + k * kCopyTile, s + k * kCopyTile, bytes(k), bars + 8 * k);
  for (long long k = 0; k < count; ++k) {
    const uint32_t stage = stages + (k % kCopyStages) * kCopyTile;
    wait_parity(bars + 8 * (k % kCopyStages), static_cast<uint32_t>((k / kCopyStages) & 1));
    bulk_store(d + k * kCopyTile, stage, bytes(k));
    if constexpr (kI8) bulk_store(e + k * kCopyTile, stage, bytes(k));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    const long long next = k - 1 + kCopyStages;  // into the stage tile k - 1 was stored from
    if (k >= 1 && next < count) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const long long p = (k - 1) % kCopyStages;
      bulk_load(stages + p * kCopyTile, s + next * kCopyTile, bytes(next), bars + 8 * p);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The persistent grid of `kernel` on the current device, kCopyBlocksPerSm
// blocks per SM: worked out once per (kernel, device), which also grants the
// kernel its dynamic shared memory there.
inline int persistent_blocks(const void* kernel, long long* blocks) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, long long> cache;
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find({kernel, device});
  if (it != cache.end()) {
    *blocks = it->second;
    return 0;
  }
  int sms = 0;
  err = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCopySmem));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (err) return err;
  *blocks = cache[{kernel, device}] = static_cast<long long>(sms) * kCopyBlocksPerSm;
  return 0;
}

// Launches kernel(args...), a kernel that runs copy_bytes over n bytes, on
// the current device in `stream`: the persistent grid, or one block per tile
// where the copy has fewer.  Returns a cudaError_t value after checking the
// launch.
template <class... Params, class... Args>
int launch_copy(void (*kernel)(Params...), long long n, cudaStream_t stream, Args... args) {
  long long blocks = 0;
  const int err = persistent_blocks(reinterpret_cast<const void*>(kernel), &blocks);
  if (err) return err;
  const long long need = (n + kCopyTile - 1) / kCopyTile;
  kernel<<<dim3(static_cast<unsigned>(need < blocks ? (need < 1 ? 1 : need) : blocks)), kCopyThreads, kCopySmem,
           stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
