"""Study variant kernels: the counterpart of the ``pl.pallas_call``s of
``benchmarks/color_variants.py``, ``benchmarks/color_variants2.py`` and
``benchmarks/inv_formulations.py``.

The reference hands a Pallas kernel function to ``make_merge`` or
``make_split``, which return the function that runs it at any (H, W).  Here
each of those kernel functions is a :class:`Variant` (its launch counter, the
C entry point it launches with its arguments, its plain torch twin) under
the reference's name, and ``make_merge``/``make_split`` return the function
that runs it:

  _k_merge_v1   B23  4:2:0 merge, compare-form round: B9's values on every
                     input (k_color_merge<2,2,kCompare>)
  _k_merge_v12  B23  4:2:0 merge, direct-form g, compare-form round: +-1
                     against B9 where the two g chains round apart
                     (k_color_merge<2,2,kDirect>)
  _k_split_v3   B24  the production split, fixed-point luma: B8's kernel
  _k_merge_v4   B25  merge with the chroma shifted at full resolution and the
                     trunc round: the same exact integers as B9's half
                     resolution shift, so B9's kernel
  _k_merge_v6   B25  the production merge: B9's kernel
  _k_split_v5   B26  B8 with its chroma rounded by trunc(clip(z) + 0.5): +-1
                     against B8 where the f32 add of 0.5 crosses an integer
                     (k_color_split<2,2,true>)

and ``idct_x(coeffs, variant)`` the inverse formulations (haweel, luma
table, ``q_scale`` 1):

  "b"  B21  the TPU's hybrid butterfly, which is hp_idct's butterfly tier:
            B6's kernel k_idct
  "c"  B22  both directions per bf16 digit of their operand
            (k_idct_split3 in csrc/hp_codec.cu, see its header)

Each launch counts in ``LAUNCHES`` under its own name, also where it runs
B6's, B8's or B9's kernel.  The plain torch twins: B21's is
``hp.idct_plain``, B24's and B25's ``color.split_plain``/``merge_plain``,
the others are here.  A function given CPU tensors runs the twin; given
CUDA tensors it launches the kernel or raises.  The kernels need their own
grid only (color: H even and W % 16; idct_x: 8x8 blocks), not the
reference's tile multiples, and refuse what they cannot take with a
ValueError.  ``br``/``tc`` (the reference's TPU tile geometry) are accepted
and inert.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpudct_torch.constants import LEVEL_SHIFT
from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import hp
from tpudct_torch.ops.blocks import as_block_grid, from_block_grid
from tpudct_torch.utils.color import F32, rgb_from_ycbcr_planes, ycbcr_from_rgb_planes

#: Kernel launches per study kernel; a function adds one only where it
#: launches its CUDA kernel (never for the CPU twin).
LAUNCHES = {
    "color_merge_v1": 0, "color_merge_v12": 0, "color_split_v3": 0, "color_merge_v4": 0,
    "color_merge_v6": 0, "color_split_v5": 0, "idct_x_b": 0, "idct_x_c": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain torch twins
# ---------------------------------------------------------------------------


def _up(c: torch.Tensor) -> torch.Tensor:
    """Nearest 2x2 chroma replication, as f32."""
    return c.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1).to(torch.float32)


def merge_v1_plain(y_u8, cb_u8, cr_u8) -> torch.Tensor:
    """Twin of V1: B9's chain with the compare-form round."""
    rgb = rgb_from_ycbcr_planes(y_u8.to(torch.float32), _up(cb_u8), _up(cr_u8))
    return torch.stack([ck._round_u8(v) for v in rgb])


def merge_v12_plain(y_u8, cb_u8, cr_u8) -> torch.Tensor:
    """Twin of V12: r = y + kr2 crc, b = y + kb2 cbc, g = (y - c1 cbc) -
    c2 crc, each op rounded on its own, the compare-form round."""
    k = F32
    yf, cbc, crc = y_u8.to(torch.float32), _up(cb_u8) - 128.0, _up(cr_u8) - 128.0
    r = yf + crc * k["kr2"]
    b = yf + cbc * k["kb2"]
    g = (yf - cbc * k["c1"]) - crc * k["c2"]
    return torch.stack([ck._round_u8(v) for v in (r, g, b)])


def split_v5_plain(rgb_planar_u8):
    """Twin of V5: B8's chain with the chroma rounded by trunc(clip(z) + 0.5)."""
    r, g, b = (rgb_planar_u8[i].to(torch.int32) for i in range(3))
    _yp, cb, cr = ycbcr_from_rgb_planes(*(ck._pool(c, 2, 2) for c in (r, g, b)))
    return ck._luma_fx(r, g, b), ck._trunc_u8(cb), ck._trunc_u8(cr)


@functools.cache
def _inv_args() -> hp._Args:
    """idct_x's tables: the butterfly dequantization and Ts, haweel, luma,
    q_scale 1 (the reference's ``hp._consts_bf(br, 1.0)``)."""
    return hp._args("haweel", "luma", 1.0, None, "butterfly", False)


def _split3(a: torch.Tensor) -> tuple:
    """a -> its three bf16 digits as f32 (round to nearest even), summing to a."""
    a1 = a.to(torch.bfloat16).to(torch.float32)
    r1 = a - a1
    a2 = r1.to(torch.bfloat16).to(torch.float32)
    return a1, a2, (r1 - a2).to(torch.bfloat16).to(torch.float32)


def idct_c_plain(coeffs: torch.Tensor) -> torch.Tensor:
    """Twin of B22: M = c S; per bf16 digit of M, Ts^T digit summed k = 0..7,
    the digit sums added (d1 + d2) + d3; the same on the rows against Ts;
    + 128."""
    k = _inv_args()
    grid = as_block_grid(coeffs)
    m = grid * hp._grid8(k.s, grid)
    at = np.ascontiguousarray(k.a.T)
    d = _split3(m)
    u = (hp._left(at, d[0]) + hp._left(at, d[1])) + hp._left(at, d[2])
    e = _split3(u)
    x = (hp._right(k.a, e[0]) + hp._right(k.a, e[1])) + hp._right(k.a, e[2])
    return from_block_grid(x + LEVEL_SHIFT)


# ---------------------------------------------------------------------------
# The study's kernel functions and the functions that run them
# ---------------------------------------------------------------------------


class Variant(NamedTuple):
    """One kernel function of the color variant studies."""

    name: str  # its LAUNCHES counter
    direction: str  # "merge" or "split"
    launcher: str  # the C entry point
    ints: tuple  # the entry point's int arguments after (h, w)
    plain: Callable  # the plain torch twin


_k_merge_v1 = Variant("color_merge_v1", "merge", "color_merge_variant_launch", (1,), merge_v1_plain)
_k_merge_v12 = Variant("color_merge_v12", "merge", "color_merge_variant_launch", (12,), merge_v12_plain)
_k_split_v3 = Variant("color_split_v3", "split", "color_split_launch", (2, 2),
                      functools.partial(ck.split_plain, mode="420"))
_k_merge_v4 = Variant("color_merge_v4", "merge", "color_merge_launch", (2, 2),
                      functools.partial(ck.merge_plain, mode="420"))
_k_merge_v6 = Variant("color_merge_v6", "merge", "color_merge_launch", (2, 2),
                      functools.partial(ck.merge_plain, mode="420"))
_k_split_v5 = Variant("color_split_v5", "split", "color_split_variant_launch", (5,), split_v5_plain)


def _check_grid(name: str, h: int, w: int) -> None:
    if h <= 0 or w <= 0 or h % 2 or w % 16:
        raise ValueError(f"{name} needs H % 2 == 0 and W % 16 == 0 (H, W > 0), got {h}x{w}")


def _of(kernel, direction: str) -> Variant:
    if not isinstance(kernel, Variant) or kernel.direction != direction:
        raise ValueError(f"make_{direction} takes one of the study's {direction} kernels, got {kernel!r}")
    return kernel


def make_merge(kernel: Variant, br: int = 512, tc: int = 256):
    """``kernel`` (a merge variant) as a function (y (H, W), cb, cr (H/2,
    W/2)) u8 -> (3, H, W) u8 RGB, one launch."""
    kernel = _of(kernel, "merge")

    def run(y_u8, cb_u8, cr_u8):
        for x in (y_u8, cb_u8, cr_u8):
            ck._check(x, 2, kernel.name)
        h, w = y_u8.shape
        if tuple(cb_u8.shape) != (h // 2, w // 2) or tuple(cr_u8.shape) != (h // 2, w // 2):
            raise ValueError(
                f"chroma planes must be ({h // 2}, {w // 2}) for a ({h}, {w}) luma plane, got "
                f"{tuple(cb_u8.shape)} / {tuple(cr_u8.shape)}"
            )
        _check_grid(kernel.name, h, w)
        if y_u8.device.type == "cpu":
            return kernel.plain(y_u8, cb_u8, cr_u8)
        out = torch.empty((3, h, w), dtype=torch.uint8, device=y_u8.device)
        hp.launch(kernel.launcher, (y_u8, cb_u8, cr_u8, out), h, w, ck._consts(), *kernel.ints)
        LAUNCHES[kernel.name] += 1
        return out

    return run


def make_split(kernel: Variant, br: int = 512, tc: int = 256):
    """``kernel`` (a split variant) as a function (3, H, W) u8 RGB -> (y (H,
    W), cb, cr (H/2, W/2)) u8, one launch."""
    kernel = _of(kernel, "split")

    def run(rgb_planar_u8):
        ck._check(rgb_planar_u8, 3, kernel.name)
        c, h, w = rgb_planar_u8.shape
        if c != 3:
            raise ValueError(f"{kernel.name} takes (3, H, W) planar RGB, got shape {tuple(rgb_planar_u8.shape)}")
        _check_grid(kernel.name, h, w)
        if rgb_planar_u8.device.type == "cpu":
            return kernel.plain(rgb_planar_u8)
        dev = rgb_planar_u8.device
        y = torch.empty((h, w), dtype=torch.uint8, device=dev)
        cb = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev)
        cr = torch.empty_like(cb)
        hp.launch(kernel.launcher, (rgb_planar_u8, y, cb, cr), h, w, ck._consts(), *kernel.ints)
        LAUNCHES[kernel.name] += 1
        return y, cb, cr

    return run


def idct_x(coeffs, variant: str):
    """(H, W) f32 quantized coefficients -> f32 reconstruction + 128,
    unclamped (haweel, luma table, q_scale 1): ``variant`` "b" (B21, hp_idct's
    butterfly) or "c" (B22, per bf16 digit).

    The reference aliases its output to its input
    (``input_output_aliases={0: 0}``), but under ``jax.jit`` without
    donation XLA copies the input first, so its caller's coefficients never
    change.  Here too: the result is a new tensor and ``coeffs`` stays as it
    is (8 B/px, each read once and each written once; the kernels' pointers
    are ``__restrict__``, so they are never given one buffer for both)."""
    if variant not in ("b", "c"):
        raise ValueError(f"idct_x variant must be 'b' or 'c', got {variant!r}")
    name = f"idct_x_{variant}"
    h, w = hp._check(coeffs, torch.float32, name)
    if coeffs.device.type == "cpu":
        return hp.idct_plain(coeffs) if variant == "b" else idct_c_plain(coeffs)
    rec = torch.empty((h, w), dtype=torch.float32, device=coeffs.device)
    hp.launch("hp_idct_launch" if variant == "b" else "idct_split3_launch", (coeffs, rec), h, w,
              _inv_args().packed)
    LAUNCHES[name] += 1
    return rec
