// Ring collective kernels for NVIDIA Hopper (sm_90a): the hops of the band
// ring (tpudct_torch/parallel/ring.py), built with hp_codec.cu and
// color_codec.cu by tpudct_torch/kernels/_build.py into one shared library
// with a plain C interface (loaded with ctypes).
//
// Entry points and the Pallas TPU kernels they replace
// (tpudct/parallel/ring.py):
//   ring_forward_launch               B14  k_ring_forward
//                                          (_ring_all_gather_kernel)
//   ring_forward_decode_color_launch  B16  k_ring_forward_decode_color
//                                          (_ring_decode_color_kernel)
// B15 (_ring_decode_kernel) is hp_codec.cu's B3 kernel, k_decode_u8, given a
// forward pointer: hp_decode_u8_launch with a non-null fwd.
//
// What they compute.  A ring gathers n row bands so that every rank ends
// with the whole map.  One launch handles one slot (one band's rows) on
// one rank: B14 copies it to the same rows of rank r + 1's replica (or
// places the rank's own band); B15 forwards an int8 coefficient slot and
// decodes it into the rank's u8 reconstruction; B16 forwards a luma slot
// and its chroma pack slot (cb rows over cr rows, half the width) and
// decodes both and merges them into the rank's (3, H, W) RGB.  A null
// forward pointer skips the forward (a rank's last slot).
//
// Value chain: B16 is hp_decode_u8's (B3) block chain with the luma and the
// chroma tables and then color_merge_420_u8's (B9) pixel chain, bit for bit
// (strip420.cuh, the strip body the fused decode B20 shares), so the color
// ring decodes as decode_color_u8 of the gathered planes does.  Like the
// reference, the rings run the butterfly tier whatever the caller's
// decode_precision.
//
// Design.  On the TPU a ring hop is an RDMA whose wait the decode of the band
// already held hides.  Here the hop and the decode read the same bytes, so
// one pass does both.  The ordering of hops across ranks is the host's (CUDA
// events between the ranks' streams); no kernel waits on another.  B14 is
// copy.cuh's copy body, shared with B17/B18 (see its header: TMA bulk copies
// through a ring of shared-memory stages, one block per SM, any byte count
// and alignment).  B15 is B3 itself, one thread per 8x8 block, which writes
// each 8-byte row it reads to the next rank's replica (a peer card's memory
// where the ranks lie on two cards, through NVLink) and decodes it from
// registers.  B16 is strip420.cuh's body (see its header), one thread block
// per 16 x 256 luma strip: an add-only inverse compiled per integer core (the
// launcher's `core`), no conversion instructions per pixel, each thread
// forwarding the rows of its 8x8 block as it loads them, the decoded strip
// merged from shared memory.
//
// Bound: memory.  Bytes per luma pixel of one launch with its forward (each
// input read once, each output written once): B14 2, B15 3 (read int8,
// forward int8, write u8), B16 6 (luma 1 + 1, pack 0.5 + 0.5, RGB 3); at
// 8192^2 and 3.35 TB/s 0.040, 0.060 and 0.120 ms.  B15's arithmetic is B3's;
// B16's instructions (about 53 per luma pixel) come close to its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "copy.cuh"      // the copy body (B14)
#include "strip420.cuh"  // the strip decode and merge (B16)

namespace {

// A slot, src -> dst (the next rank's replica or the rank's own place):
// copy.cuh's body.
__global__ void __launch_bounds__(kCopyThreads)
    k_ring_forward(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long nbytes) {
  copy_bytes<false>(src, dst, nullptr, nbytes);
}

// The strips of a luma slot and its chroma pack slot (cb rows over cr rows,
// half the width), forwarded where fy is not null: strip420.cuh's body with
// the integer core kCore.
template <int kCore>
__global__ void __launch_bounds__(kStripThreads)
    k_ring_forward_decode_color(const int8_t* __restrict__ y, const int8_t* __restrict__ c, int8_t* fy,
                                int8_t* fc, uint8_t* __restrict__ rgb, long long plane, int h, int w,
                                const StripConsts k) {
  const long long cr = static_cast<long long>(h / 2) * (w / 2);  // the cr rows' offset in the pack
  decode_merge_strip_420<kCore>(y, c, c + cr, fy, fc, fc ? fc + cr : nullptr, rgb, plane, w, k);
}

}  // namespace

// ---- C interface -------------------------------------------------------------
// Pointers are device pointers except the consts, a host pointer to 137
// floats laid out as StripConsts (the luma and chroma dequantization
// multipliers, then ColorConsts); `core` picks the integer core (strip420.cuh's
// core_ts, kernels/strip420.py's CORES).
// The forward pointers may be null, and may point into another card's memory
// once ring_enable_peer has given this card access to it.  The kernel runs on
// `device` in `stream`.  Each function returns a cudaError_t value (0 = ok;
// hp_error_string in hp_codec.cu names it) after checking the launch; it
// neither synchronizes nor allocates.

extern "C" {

int ring_forward_launch(const void* src, void* dst, long long nbytes, void* stream, int device) {
  if (nbytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err || nbytes == 0) return err;
  return launch_copy(k_ring_forward, nbytes, static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(src),
                     static_cast<uint8_t*>(dst), nbytes);
}

int ring_forward_decode_color_launch(const void* y, const void* c, void* fy, void* fc, void* rgb,
                                     long long plane, int h, int w, int core, const void* consts,
                                     void* stream, int device) {
  using Kernel = decltype(&k_ring_forward_decode_color<0>);
  static const Kernel kernels[kCores] = {k_ring_forward_decode_color<0>, k_ring_forward_decode_color<1>,
                                         k_ring_forward_decode_color<2>, k_ring_forward_decode_color<3>};
  if (h <= 0 || w <= 0 || h % kStripRows || w % kStripCols || plane < static_cast<long long>(h) * w ||
      core < 0 || core >= kCores)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  return launch_strips(kernels[core], h, w, static_cast<cudaStream_t>(stream), static_cast<const int8_t*>(y),
                       static_cast<const int8_t*>(c), static_cast<int8_t*>(fy), static_cast<int8_t*>(fc),
                       static_cast<uint8_t*>(rgb), plane, h, w, *static_cast<const StripConsts*>(consts));
}

// Let kernels on `device` write to `peer`'s memory (a no-op if they already may).
int ring_enable_peer(int device, int peer) {
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  const cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // the call leaves this error to be read: clear it
    return 0;
  }
  return static_cast<int>(e);
}

}  // extern "C"
