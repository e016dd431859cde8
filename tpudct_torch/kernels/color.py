"""YCbCr split/merge kernels: the counterpart of ``tpudct/kernels/color_pallas.py``.

Six wrappers, the reference's names and signatures, over two hand-written
CUDA templates in ``tpudct_torch/csrc/color_codec.cu`` (see its header for
the value chain and the design), instantiated per chroma window:

  color_split_420_u8  (3, H, W) u8 RGB -> y (H, W), cb, cr (H/2, W/2) u8   (B8)
  color_merge_420_u8  y (H, W) + cb, cr (H/2, W/2) u8 -> (3, H, W) u8 RGB  (B9)
  color_split_422_u8  chroma (H, W/2)                                      (B10)
  color_merge_422_u8                                                       (B11)
  color_split_444_u8  chroma (H, W)                                        (B12)
  color_merge_444_u8                                                       (B13)

and two more over the same templates, the u8 colour path's direct
instances (no TPU kernel; ``models/color.py`` ``encode_color_u8`` and
``decode_color_u8``), which address the caller's frame themselves, any
(H, W), so no pad, layout copy or stack runs around them:

  color_split_direct_u8  (H, W, 3) or (3, H, W) u8 RGB -> y at the luma
                         plane's shape, cb stacked above cr at the chroma
                         plane's (``direct_shapes``: true sizes up to 8)
  color_merge_direct_u8  y, cb, cr at those shapes -> (H, W, 3) u8 RGB

Each has a plain torch twin here computing the same values in the same
order: exact integer window sums, separately rounded f32 ops, a true
division, the same two roundings (the direct twins: the edge pad, the
planar twin and the crop, or the reverse).  A wrapper given a CPU tensor
runs the twin; given a CUDA tensor it launches the kernel or raises, and
counts the launch in ``LAUNCHES``.  ``band_rows``, ``tile_cols`` and
``interpret`` (the reference's TPU tile geometry and interpreter switch)
are accepted and inert.  The six gated wrappers' shape gate and refusals
are the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudct_torch.kernels.hp import check_placement, launch
from tpudct_torch.ops.padding import edge_pad_plain, padded_shape
from tpudct_torch.utils.color import F32, rgb_from_ycbcr_planes, ycbcr_from_rgb_planes

#: Chroma window (rows, cols) per subsampling mode.
WINDOWS = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}

#: Kernel launches per wrapper; a wrapper adds one only where it launches its
#: CUDA kernel (never for the CPU twin).
LAUNCHES = {f"color_{d}_{m}_u8": 0 for d in ("split", "merge") for m in WINDOWS}
LAUNCHES.update({f"color_{d}_direct_{m}": 0 for d in ("split", "merge") for m in WINDOWS})


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports(h: int, w: int) -> bool:
    """The reference's gate: tiles hold whole 2x2 pools (H % 64, W % 256)."""
    return h % 64 == 0 and w % 256 == 0


@functools.cache
def _consts() -> np.ndarray:
    """The 9 f32 constants the CUDA side reads as ColorConsts."""
    a = np.array([F32[k] for k in ("kr", "kg", "kb", "kcb", "kcr", "kr2", "kb2", "c1", "c2")], np.float32)
    a.setflags(write=False)
    return a


# ---------------------------------------------------------------------------
# Plain torch twins
# ---------------------------------------------------------------------------


def _luma_fx(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """BT.601 luma in 16-bit fixed point on int32 channels (exact)."""
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).to(torch.uint8)


def _pool(c: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """Window mean of an int32 channel: the exact integer sum of (c - 128)
    over rh x rw, times the power of two 1/(rh rw), plus 128."""
    h, w = c.shape
    s = (c - 128).reshape(h // rh, rh, w // rw, rw).sum(dim=(1, 3))
    return s.to(torch.float32) * (1.0 / (rh * rw)) + 128.0


def _round_u8(z: torch.Tensor) -> torch.Tensor:
    """clip first, then floor + (frac >= 0.5): ``color_pallas._to_u8``."""
    zp = z.clamp(0.0, 255.0)
    f = zp.floor()
    return (f + (zp - f >= 0.5).to(torch.float32)).to(torch.int32).to(torch.uint8)


def _trunc_u8(z: torch.Tensor) -> torch.Tensor:
    """trunc(clip(z) + 0.5): ``color_pallas._to_u8_trunc``."""
    return (z.clamp(0.0, 255.0) + 0.5).to(torch.int32).to(torch.uint8)


def split_plain(rgb_planar_u8: torch.Tensor, mode: str = "420"):
    """Twin of the split kernels: (3, H, W) u8 -> (y, cb, cr) u8."""
    rh, rw = WINDOWS[mode]
    r, g, b = (rgb_planar_u8[i].to(torch.int32) for i in range(3))
    _yp, cb, cr = ycbcr_from_rgb_planes(*(_pool(c, rh, rw) for c in (r, g, b)))
    return _luma_fx(r, g, b), _round_u8(cb), _round_u8(cr)


def merge_plain(y_u8: torch.Tensor, cb_u8: torch.Tensor, cr_u8: torch.Tensor, mode: str = "420"):
    """Twin of the merge kernels: (y, cb, cr) u8 -> (3, H, W) u8.  Chroma
    replicated to luma's grid, then the inverse transform (whose c - 128 is
    exact, so shifting before or after the replication is the same)."""
    rh, rw = WINDOWS[mode]

    def up(c):
        return c.repeat_interleave(rh, dim=0).repeat_interleave(rw, dim=1).to(torch.float32)

    r, g, b = rgb_from_ycbcr_planes(y_u8.to(torch.float32), up(cb_u8), up(cr_u8))
    return torch.stack([_trunc_u8(r), _trunc_u8(g), _trunc_u8(b)], dim=0)


def direct_shapes(h: int, w: int, mode: str = "420") -> tuple:
    """(luma plane, each chroma plane) shapes of the direct instances for an
    (h, w) frame: the true plane sizes rounded up to 8, the codec kernels'."""
    rh, rw = WINDOWS[mode]
    return padded_shape(h, w), padded_shape(-(-h // rh), -(-w // rw))


def split_direct_plain(rgb_u8: torch.Tensor, mode: str = "420", layout: str = "interleaved"):
    """Twin of the direct split: the frame edge-padded to the chroma planes'
    luma extent, the planar twin, the luma cropped, cb stacked above cr."""
    rh, rw = WINDOWS[mode]
    x = rgb_u8.movedim(-1, 0) if layout == "interleaved" else rgb_u8
    (yh, yw), (ch, cw) = direct_shapes(x.shape[1], x.shape[2], mode)
    y, cb, cr = split_plain(edge_pad_plain(x, ch * rh, cw * rw), mode)
    return y[:yh, :yw].contiguous(), torch.cat([cb, cr])


def merge_direct_plain(y_u8: torch.Tensor, cb_u8: torch.Tensor, cr_u8: torch.Tensor, h: int, w: int,
                       mode: str = "420") -> torch.Tensor:
    """Twin of the direct merge: the planar twin over the chroma samples
    that cover the frame, cropped to (h, w) and interleaved."""
    rh, rw = WINDOWS[mode]
    sh, sw = -(-h // rh), -(-w // rw)
    rgb = merge_plain(y_u8[: sh * rh, : sw * rw], cb_u8[:sh, :sw], cr_u8[:sh, :sw], mode)
    return rgb[:, :h, :w].movedim(0, -1).contiguous()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(x, ndim: int, name: str, dtype: torch.dtype = torch.uint8) -> None:
    """Validate a kernel operand (both devices, so the twin refuses what
    the kernel refuses)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} takes a torch.Tensor, got {type(x).__name__}")
    if x.dim() != ndim:
        raise ValueError(f"{name} takes a {ndim}-D tensor, got shape {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} takes {dtype}, got {x.dtype}")
    check_placement(x, name)


def _check_grid(h: int, w: int) -> None:
    if h <= 0 or w <= 0 or not supports(h, w):
        raise ValueError(
            f"color kernels need H % 64 == 0 and W % 256 == 0 (H, W > 0), got {h}x{w}"
        )


def _split(rgb_planar_u8, mode: str):
    name = f"color_split_{mode}_u8"
    _check(rgb_planar_u8, 3, name)
    c, h, w = rgb_planar_u8.shape
    if c != 3:
        raise ValueError(f"{name} takes (3, H, W) planar RGB, got shape {tuple(rgb_planar_u8.shape)}")
    _check_grid(h, w)
    if rgb_planar_u8.device.type == "cpu":
        return split_plain(rgb_planar_u8, mode)
    rh, rw = WINDOWS[mode]
    dev = rgb_planar_u8.device
    y = torch.empty((h, w), dtype=torch.uint8, device=dev)
    cb = torch.empty((h // rh, w // rw), dtype=torch.uint8, device=dev)
    cr = torch.empty_like(cb)
    launch("color_split_launch", (rgb_planar_u8, y, cb, cr), h, w, _consts(), rh, rw)
    LAUNCHES[name] += 1
    return y, cb, cr


def _merge(y_u8, cb_u8, cr_u8, mode: str):
    name = f"color_merge_{mode}_u8"
    for x in (y_u8, cb_u8, cr_u8):
        _check(x, 2, name)
    h, w = y_u8.shape
    rh, rw = WINDOWS[mode]
    cshape = (h // rh, w // rw)
    if tuple(cb_u8.shape) != cshape or tuple(cr_u8.shape) != cshape:
        # all geometry derives from the luma plane: a mismatched chroma plane
        # would be read past its end
        what = "4:4:4 planes must all be" if mode == "444" else "chroma planes must be"
        tail = "" if mode == "444" else f" for a ({h}, {w}) luma plane"
        raise ValueError(
            f"{what} ({cshape[0]}, {cshape[1]}){tail}, got "
            f"{tuple(cb_u8.shape)} / {tuple(cr_u8.shape)}"
        )
    _check_grid(h, w)
    if y_u8.device.type == "cpu":
        return merge_plain(y_u8, cb_u8, cr_u8, mode)
    out = torch.empty((3, h, w), dtype=torch.uint8, device=y_u8.device)
    launch("color_merge_launch", (y_u8, cb_u8, cr_u8, out), h, w, _consts(), rh, rw)
    LAUNCHES[name] += 1
    return out


def color_split_420_u8(rgb_planar_u8, band_rows: int = 512, tile_cols: int = 256,
                       interpret: bool = False):
    """(3, H, W) u8 RGB -> (y (H, W), cb, cr (H/2, W/2)) u8, one kernel."""
    return _split(rgb_planar_u8, "420")


def color_merge_420_u8(y_u8, cb_u8, cr_u8, band_rows: int = 512, tile_cols: int = 256,
                       interpret: bool = False):
    """(y (H, W), cb, cr (H/2, W/2)) u8 -> (3, H, W) u8 RGB, one kernel."""
    return _merge(y_u8, cb_u8, cr_u8, "420")


def color_split_422_u8(rgb_planar_u8, band_rows: int = 512, tile_cols: int = 256,
                       interpret: bool = False):
    """(3, H, W) u8 RGB -> (y (H, W), cb, cr (H, W/2)) u8, one kernel."""
    return _split(rgb_planar_u8, "422")


def color_merge_422_u8(y_u8, cb_u8, cr_u8, band_rows: int = 512, tile_cols: int = 256,
                       interpret: bool = False):
    """(y (H, W), cb, cr (H, W/2)) u8 -> (3, H, W) u8 RGB, one kernel."""
    return _merge(y_u8, cb_u8, cr_u8, "422")


def color_split_444_u8(rgb_planar_u8, band_rows: int = 512, tile_cols: int = 256,
                       interpret: bool = False):
    """(3, H, W) u8 RGB -> three full-res u8 YCbCr planes, one kernel."""
    return _split(rgb_planar_u8, "444")


def color_merge_444_u8(y_u8, cb_u8, cr_u8, band_rows: int = 512, tile_cols: int = 256,
                       interpret: bool = False):
    """Three full-res u8 YCbCr planes -> (3, H, W) u8 RGB, one kernel."""
    return _merge(y_u8, cb_u8, cr_u8, "444")


def _align(x: torch.Tensor, pitch: int) -> int:
    """16 where ``x``'s first byte and a row pitch of ``pitch`` bytes are
    16-byte aligned (the kernels' vector accesses), else 1 (byte accesses)."""
    return 16 if x.data_ptr() % 16 == 0 and pitch % 16 == 0 else 1


def color_split_direct_u8(rgb_u8, mode: str = "420", layout: str | None = None):
    """A uint8 frame, (H, W, 3) interleaved or (3, H, W) planar (``layout``,
    else as the shape says: channels last where the last dim is 3), any
    H, W > 0 -> (y at the luma plane's shape, cb stacked above cr at twice
    the chroma plane's rows) u8, one kernel.  On a card the frame is
    contiguous in its layout, at any byte offset."""
    name = f"color_split_direct_{mode}"
    if not isinstance(rgb_u8, torch.Tensor):
        raise TypeError(f"{name} takes a torch.Tensor, got {type(rgb_u8).__name__}")
    shape = tuple(rgb_u8.shape)
    layout = layout or ("interleaved" if shape[-1:] == (3,) else "planar")
    if layout not in ("interleaved", "planar"):
        raise ValueError(f"{name}: layout is 'interleaved' or 'planar', got {layout!r}")
    if rgb_u8.dim() != 3 or (shape[-1] if layout == "interleaved" else shape[0]) != 3:
        want = "(H, W, 3)" if layout == "interleaved" else "(3, H, W)"
        raise ValueError(f"{name} takes {want} {layout} RGB, got shape {shape}")
    if rgb_u8.dtype != torch.uint8:
        raise TypeError(f"{name} takes {torch.uint8}, got {rgb_u8.dtype}")
    h, w = shape[:2] if layout == "interleaved" else shape[1:]
    if h <= 0 or w <= 0:
        raise ValueError(f"{name} takes a non-empty frame, got {h}x{w}")
    if rgb_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {rgb_u8.device}")
    if rgb_u8.device.type == "cpu":
        return split_direct_plain(rgb_u8, mode, layout)
    if not rgb_u8.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    rh, rw = WINDOWS[mode]
    (yh, yw), (ch, cw) = direct_shapes(h, w, mode)
    dev = rgb_u8.device
    y = torch.empty((yh, yw), dtype=torch.uint8, device=dev)
    cc = torch.empty((2 * ch, cw), dtype=torch.uint8, device=dev)
    hwc = layout == "interleaved"
    launch("color_split_direct_launch", (rgb_u8, y, cc), h, w, _consts(), rh, rw, int(hwc),
           _align(rgb_u8, 3 * w if hwc else w))
    LAUNCHES[name] += 1
    return y, cc


def color_merge_direct_u8(y_u8, cb_u8, cr_u8, h: int, w: int, mode: str = "420"):
    """y at the luma plane's shape and cb, cr at the chroma plane's
    (``direct_shapes`` of (h, w)) u8 -> the (h, w, 3) interleaved u8 frame,
    one kernel."""
    name = f"color_merge_direct_{mode}"
    for x in (y_u8, cb_u8, cr_u8):
        _check(x, 2, name)
    if h <= 0 or w <= 0:
        raise ValueError(f"{name} takes a non-empty frame, got {h}x{w}")
    yshape, cshape = direct_shapes(h, w, mode)
    if tuple(y_u8.shape) != yshape or tuple(cb_u8.shape) != cshape or tuple(cr_u8.shape) != cshape:
        raise ValueError(
            f"{name} of a {h}x{w} frame takes y {yshape} and cb, cr {cshape}, got "
            f"{tuple(y_u8.shape)} / {tuple(cb_u8.shape)} / {tuple(cr_u8.shape)}"
        )
    if y_u8.device.type == "cpu":
        return merge_direct_plain(y_u8, cb_u8, cr_u8, h, w, mode)
    rh, rw = WINDOWS[mode]
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y_u8.device)
    launch("color_merge_direct_launch", (y_u8, cb_u8, cr_u8, out), h, w, _consts(), rh, rw,
           _align(out, 3 * w))
    LAUNCHES[name] += 1
    return out
