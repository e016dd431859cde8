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

Each has a plain torch twin here computing the same values in the same
order: exact integer window sums, separately rounded f32 ops, a true
division, the same two roundings.  A wrapper given a CPU tensor runs the
twin; given a CUDA tensor it launches the kernel or raises, and counts the
launch in ``LAUNCHES``.  ``band_rows``, ``tile_cols`` and ``interpret`` (the
reference's TPU tile geometry and interpreter switch) are accepted and
inert.  The shape gate and the refusals are the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudct_torch.kernels.hp import check_placement, launch
from tpudct_torch.utils.color import F32, rgb_from_ycbcr_planes, ycbcr_from_rgb_planes

#: Chroma window (rows, cols) per subsampling mode.
WINDOWS = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}

#: Kernel launches per wrapper; a wrapper adds one only where it launches its
#: CUDA kernel (never for the CPU twin).
LAUNCHES = {f"color_{d}_{m}_u8": 0 for d in ("split", "merge") for m in WINDOWS}


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
