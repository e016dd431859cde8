"""Study kernels: the counterpart of the ``pl.pallas_call``s of
``benchmarks/u8_perf.py`` and ``benchmarks/color_fused_ab.py``.

Four wrappers, the reference's names and signatures, over hand-written CUDA
kernels in ``tpudct_torch/csrc/study.cu`` (see its header for the value
chains and the design):

  u8_copy              (H, W) u8 -> the same values, written in place        (B17)
  u8_copy2             (H, W) u8 -> (the u8 map, written in place, and its
                       bytes as int8: the wrapping cast)                     (B18)
  color_encode_420_u8  (3, H, W) u8 RGB -> int8 coefficients y (H, W),
                       cb, cr (H/2, W/2) in one pass                         (B19)
  color_decode_420_u8  y, cb, cr int8 -> (3, H, W) u8 RGB in one pass        (B20)

The copies are the byte floors of a u8 pass (B18 moves hp_roundtrip_u8's
3 bytes per pixel with no arithmetic).  The fused color pair is the study of
whether fusing the 4:2:0 split, the codec and the merge pays: B20 equals the
composed decode (``hp_decode_u8`` twice, ``color_merge_420_u8``) bit for bit;
B19's chroma equals the composed encode's, its luma comes from the f32
BT.601 sum (the study's own chain), not the production split's fixed-point
luma, so it differs from the composed path's by +-1 where the two roundings
part.

Each has a plain torch twin here computing the same values in the same
order.  A wrapper given a CPU tensor runs the twin; given a CUDA tensor it
launches the kernel or raises, and counts the launch in ``LAUNCHES``.
``br``/``tc``, ``band_rows``/``tile_cols`` and ``interpret`` (the
reference's TPU tile geometry and interpreter switch) are accepted and
inert.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import cores
from tpudct_torch.kernels import hp
from tpudct_torch.kernels import strip420
from tpudct_torch.kernels._build import call
from tpudct_torch.utils.color import rgb_from_ycbcr_planes, ycbcr_from_rgb_planes

#: Kernel launches per wrapper; a wrapper adds one only where it launches its
#: CUDA kernel (never for the CPU twin).
LAUNCHES = {"u8_copy": 0, "u8_copy2": 0, "color_encode_420_u8": 0, "color_decode_420_u8": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=64)
def encode_args(transform: str, q_scale: float, retain_k, y_q_table: str = "luma", c_q_table: str = "chroma"):
    """(core id, the 137 packed f32 B19 reads as EncodeConsts: the luma and
    chroma quantizer scales of the integer core, ``retain_k`` folded in,
    then the color constants).

    B19's forward is add-only, its core's Ts compiled in (``core_ts`` in
    ``csrc/hp_block.cuh``); raises as ``kernels.hp`` does for a transform
    without an integer core, and where the packed forward is not the table
    compiled for the transform's core."""
    kl = hp._args(transform, y_q_table, q_scale, retain_k, "butterfly", True)
    kc = hp._args(transform, c_q_table, q_scale, retain_k, "butterfly", True)
    core = cores.core_id(transform, kl.fwd, kc.fwd, kernel="color_encode_420_u8")
    packed = np.concatenate([kl.fq.ravel(), kc.fq.ravel(), ck._consts()]).astype(np.float32)
    packed.setflags(write=False)
    return core, packed


# ---------------------------------------------------------------------------
# Plain torch twins
# ---------------------------------------------------------------------------


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.copy_(x)


def copy2_plain(x: torch.Tensor):
    return x, x.view(torch.int8).clone()


def encode_420_plain(rgb_planar_u8, q_scale=1.0, retain_k=None, transform="haweel",
                     y_q_table="luma", c_q_table="chroma"):
    """Twin of B19: the f32 luma and its round to u8, the split's chroma
    (``color.split_plain``), then ``hp_encode_u8``'s twin per plane (the
    chroma planes stacked: the forward is per 8x8 block)."""
    y, _cb, _cr = ycbcr_from_rgb_planes(*(rgb_planar_u8[i].to(torch.float32) for i in range(3)))
    _y, cb, cr = ck.split_plain(rgb_planar_u8, "420")
    cy = hp.encode_u8_plain(ck._round_u8(y), q_scale, y_q_table, retain_k, transform)
    cc = hp.encode_u8_plain(torch.cat([cb, cr]), q_scale, c_q_table, retain_k, transform)
    return cy, cc[: cb.shape[0]], cc[cb.shape[0] :]


def decode_420_plain(y_i8, cb_i8, cr_i8, q_scale=1.0, transform="haweel", y_q_table="luma",
                     c_q_table="chroma"):
    """Twin of B20: ``hp_decode_u8``'s twin per plane (butterfly), nearest
    2x2 chroma replication, the BT.601 inverse and the compare-form round."""
    yu = hp.decode_u8_plain(y_i8, q_scale, y_q_table, "butterfly", transform)
    cu = hp.decode_u8_plain(torch.cat([cb_i8, cr_i8]), q_scale, c_q_table, "butterfly", transform)

    def up(c):
        return c.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1).to(torch.float32)

    h2 = cb_i8.shape[0]
    rgb = rgb_from_ycbcr_planes(yu.to(torch.float32), up(cu[:h2]), up(cu[h2:]))
    return torch.stack([ck._round_u8(v) for v in rgb])


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def u8_copy(x, br: int = 256, tc: int = 2048):
    """(H, W) u8 -> ``x`` itself, every byte read and written back in place
    (the reference aliases its output to its input)."""
    ck._check(x, 2, "u8_copy")
    if x.device.type == "cpu":
        return copy_plain(x)
    call("u8_copy_launch", x.device, x.data_ptr(), x.data_ptr(), None, x.numel())
    LAUNCHES["u8_copy"] += 1
    return x


def u8_copy2(x, br: int = 256, tc: int = 2048):
    """(H, W) u8 -> (``x``, written back in place, and a new int8 map of its
    bytes): one u8 read, one u8 and one int8 write, hp_roundtrip_u8's byte
    pattern with no arithmetic."""
    ck._check(x, 2, "u8_copy2")
    if x.device.type == "cpu":
        return copy2_plain(x)
    i8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    call("u8_copy_launch", x.device, x.data_ptr(), x.data_ptr(), i8.data_ptr(), x.numel())
    LAUNCHES["u8_copy2"] += 1
    return x, i8


def color_encode_420_u8(rgb_planar_u8, q_scale: float = 1.0, retain_k=None, transform: str = "haweel",
                        y_q_table: str = "luma", c_q_table: str = "chroma", band_rows=None,
                        tile_cols=None, interpret: bool = False):
    """(3, H, W) u8 RGB -> (y (H, W), cb, cr (H/2, W/2)) int8 coefficient
    planes, one kernel: BT.601, 4:2:0 pooling, level shift, transform and
    quantization.  H % 64 == 0 and W % 256 == 0."""
    name = "color_encode_420_u8"
    ck._check(rgb_planar_u8, 3, name)
    c, h, w = rgb_planar_u8.shape
    if c != 3:
        raise ValueError(f"{name} takes (3, H, W) planar RGB, got shape {tuple(rgb_planar_u8.shape)}")
    ck._check_grid(h, w)
    core, consts = encode_args(transform, q_scale, retain_k, y_q_table, c_q_table)
    if rgb_planar_u8.device.type == "cpu":
        return encode_420_plain(rgb_planar_u8, q_scale, retain_k, transform, y_q_table, c_q_table)
    dev = rgb_planar_u8.device
    y = torch.empty((h, w), dtype=torch.int8, device=dev)
    cb = torch.empty((h // 2, w // 2), dtype=torch.int8, device=dev)
    cr = torch.empty_like(cb)
    call("color_encode_420_launch", dev, rgb_planar_u8.data_ptr(), y.data_ptr(), cb.data_ptr(),
         cr.data_ptr(), h, w, core, consts.ctypes.data)
    LAUNCHES[name] += 1
    return y, cb, cr


def color_decode_420_u8(y_i8, cb_i8, cr_i8, q_scale: float = 1.0, transform: str = "haweel",
                        y_q_table: str = "luma", c_q_table: str = "chroma", band_rows=None,
                        tile_cols=None, interpret: bool = False):
    """(y (H, W), cb, cr (H/2, W/2)) int8 coefficient planes -> (3, H, W) u8
    RGB, one kernel: butterfly decode of the three planes, 2x2 replication
    and the BT.601 merge.  H % 64 == 0 and W % 256 == 0."""
    name = "color_decode_420_u8"
    for x in (y_i8, cb_i8, cr_i8):
        ck._check(x, 2, name, torch.int8)
    h, w = y_i8.shape
    if tuple(cb_i8.shape) != (h // 2, w // 2) or tuple(cr_i8.shape) != (h // 2, w // 2):
        raise ValueError(
            f"chroma planes must be ({h // 2}, {w // 2}) for a ({h}, {w}) luma plane, got "
            f"{tuple(cb_i8.shape)} / {tuple(cr_i8.shape)}"
        )
    ck._check_grid(h, w)
    core, consts = strip420.strip_args(transform, q_scale, y_q_table, c_q_table)
    if y_i8.device.type == "cpu":
        return decode_420_plain(y_i8, cb_i8, cr_i8, q_scale, transform, y_q_table, c_q_table)
    dev = y_i8.device
    if cb_i8.device != dev or cr_i8.device != dev:
        raise ValueError(f"{name}: operands on more than one device")
    out = torch.empty((3, h, w), dtype=torch.uint8, device=dev)
    call("color_decode_420_launch", dev, y_i8.data_ptr(), cb_i8.data_ptr(), cr_i8.data_ptr(),
         out.data_ptr(), h, w, core, consts.ctypes.data)
    LAUNCHES[name] += 1
    return out
