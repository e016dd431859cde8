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
// chroma tables and then color_merge_420_u8's (B9) pixel chain, taken from
// the same headers (hp_block.cuh, color_px.cuh; the strip in strip420.cuh,
// which the fused decode B20 shares), so the color ring decodes bit for bit
// as decode_color_u8 of the gathered planes does.  Like the reference, the
// rings run the butterfly tier whatever the caller's decode_precision.
//
// Design.  On the TPU a ring hop is an RDMA whose wait the decode of the band
// already held hides.  Here the hop and the decode read the same bytes, so
// one pass does both: a thread reads each 8-byte row of its block once,
// writes it to the next rank's replica (a peer card's memory where the ranks
// lie on two cards, through NVLink) and decodes it from registers.  The
// ordering of hops across ranks is the host's (CUDA events between the ranks'
// streams); no kernel waits on another.  B14 is copy.cuh's copy body, shared
// with B17/B18 (see its header: TMA bulk copies through a ring of
// shared-memory stages, one block per SM, any byte count and alignment).  B15
// is B3 itself, one thread per 8x8 block.  B16 runs one thread block per 16 x
// 256 luma strip: each thread decodes one luma or chroma block (as B3, one
// block of f32 live) into shared memory as u8, then the block merges the
// strip from shared memory (as B9).  One thread per 16x16 window, decoding
// its two chroma blocks and then its four luma blocks in turn, needs 255
// registers (8 warps per SM) and runs 4x slower.
//
// Bound: memory.  Bytes per luma pixel of one launch with its forward (each
// input read once, each output written once): B14 2, B15 3 (read int8,
// forward int8, write u8), B16 6 (luma 1 + 1, pack 0.5 + 0.5, RGB 3); at
// 8192^2 and 3.35 TB/s 0.040, 0.060 and 0.120 ms.  The arithmetic is B3's
// (B15) or B3's twice plus B9's (B16), under that at the f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "copy.cuh"      // the copy body (B14)
#include "strip420.cuh"  // the strip decode and merge (HpConsts, ColorConsts, block_index)

namespace {

// A slot, src -> dst (the next rank's replica or the rank's own place):
// copy.cuh's body.
__global__ void __launch_bounds__(kCopyThreads)
    k_ring_forward(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long nbytes) {
  copy_bytes<false>(src, dst, nullptr, nbytes);
}

// One thread block per 16 x 256 luma strip (its chroma: one 8-row block row
// of cb and of cr, 128 wide, in the pack: cb rows over cr rows): B3's block
// decode of each luma and chroma block into shared memory, forwarding its
// bytes, then B9's merge (strip420.cuh).
__global__ void __launch_bounds__(kStripThreads)
    k_ring_forward_decode_color(const int8_t* __restrict__ y, const int8_t* __restrict__ c,
                                int8_t* __restrict__ fy, int8_t* __restrict__ fc,
                                uint8_t* __restrict__ rgb, long long plane, int h, int w,
                                const HpConsts kl, const HpConsts kc, const ColorConsts kk) {
  const long long cr = static_cast<long long>(h / 2) * (w / 2);  // the cr rows' offset in the pack
  decode_merge_strip_420<false>(y, c, c + cr, fy, fc, fc ? fc + cr : nullptr, rgb, plane, w, kl, kc,
                                kk);
}

}  // namespace

// ---- C interface -------------------------------------------------------------
// Pointers are device pointers except the consts, host pointers to 320 floats
// laid out as HpConsts (luma, chroma) or 9 floats laid out as ColorConsts.
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
                                     long long plane, int h, int w, const void* consts_luma,
                                     const void* consts_chroma, const void* color_consts,
                                     void* stream, int device) {
  if (h <= 0 || w <= 0 || h % kStripRows || w % kStripCols || plane < static_cast<long long>(h) * w)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  const long long strips = static_cast<long long>(h / kStripRows) * (w / kStripCols);
  k_ring_forward_decode_color<<<dim3(static_cast<unsigned>(strips)), kStripThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(y), static_cast<const int8_t*>(c), static_cast<int8_t*>(fy),
      static_cast<int8_t*>(fc), static_cast<uint8_t*>(rgb), plane, h, w,
      *static_cast<const HpConsts*>(consts_luma), *static_cast<const HpConsts*>(consts_chroma),
      *static_cast<const ColorConsts*>(color_consts));
  return static_cast<int>(cudaGetLastError());
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
