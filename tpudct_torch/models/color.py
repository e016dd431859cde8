"""JPEG-style color codec on top of a gray pipeline: the counterpart of
``tpudct/models/color.py``.

  RGB -> full-range BT.601 YCbCr (``utils/color.py``)
  Y     : full resolution, luminance table Q
  Cb, Cr: 4:2:0 (default) / 4:2:2 / 4:4:4, chrominance table QC, both
          planes coded through one launch (stacked vertically)

Two paths, chosen as the reference chooses them:

- f32 (``encode_color``/``decode_color``): float planes through the
  pipeline's ``encode``/``idct`` (on ``hp``: the ``hp_dct``/``hp_idct``
  kernels at kernel shapes), torch resampling and conversion;
- u8 (``encode_color_u8``/``decode_color_u8``): one direct split kernel
  on the caller's frame, one luma and one stacked-chroma launch of
  ``hp_encode_u8``, and back through two ``hp_decode_u8`` launches and one
  direct merge kernel writing the interleaved frame, every plane at its
  true size rounded up to 8; the gate is the reference's, on the (64, 256)
  kernel grid.  What the path decides for a frame shape (the gate, the
  plane shapes, the tables) is worked out once and kept (``_u8_plan``);
  on a card the encode's three launches and the decode's three are one
  native call each (``color_codec.cu``'s chain launchers), a CPU tensor
  runs the wrappers' plain twins.

The ``_auto`` helpers pick the u8 path where the input and the geometry
allow it, the bulk helpers stack same-width frames into one pass.  Host
(numpy) inputs run on ``dispatch.default_device(device)``: the first CUDA
card, or the device named (``device="cpu"`` runs the plain twins); a tensor
stays where it is.  Per-image functions return tensors on the device (the
f32 path's interleaved RGB is a ``movedim`` view, as the reference's
``moveaxis``; the u8 path's is contiguous); the bulk helpers return numpy
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpudct_torch.config import CodecConfig
from tpudct_torch.kernels import _build
from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import hp
from tpudct_torch.models.base import Pipeline
from tpudct_torch.models.hp_appr import _decode_prec
from tpudct_torch.models.dispatch import (
    _STACK_MAX_PIXELS,
    _bound,
    _cast,
    _chunk,
    _is_u8,
    _stack_groups,
    _tensor,
    _to_device,
    _to_host,
    default_device,
)
from tpudct_torch.ops.padding import (
    crop,
    kernel_padded_shape,
    pad_coeffs_to_kernel,
    pad_to_blocks,
    pad_to_kernel,
    padded_shape,
)
from tpudct_torch.ops.rounding import round_half_away
from tpudct_torch.utils import profiling
from tpudct_torch.utils.color import (
    downsample_420,
    downsample_422,
    rgb_to_ycbcr,
    upsample_420,
    upsample_422,
    ycbcr_to_rgb,
)

PLANES = ("y", "cb", "cr")

# The u8 path's kernel grid: rows by 64, columns by 256 (kernels.color.supports).
_GRID = (64, 256)


def _fits_i8(v) -> bool:
    """Whether a coefficient plane's values fit int8: int8/uint8 planes by
    their dtype, float planes by a value scan (array or tensor)."""
    if isinstance(v, torch.Tensor):
        if v.dtype in (torch.int8, torch.uint8):
            return True
    else:
        v = np.asarray(v)
        if v.dtype in (np.dtype(np.int8), np.dtype(np.uint8)):
            return True
    return bool(_bound(v) <= 127)


def normalize_subsample(subsample) -> "str | bool":
    """True/'420' -> '420', '422' -> '422', False/None/'444' -> False."""
    if subsample in (True, "420", 420):
        return "420"
    if subsample in ("422", 422):
        return "422"
    if subsample in (False, None, "444", 444):
        return False
    raise ValueError(f"unknown chroma subsampling {subsample!r}; use 420|422|444")


_DOWN = {"420": downsample_420, "422": downsample_422}
_UP = {"420": upsample_420, "422": upsample_422}


def _luma_cfg(cfg: CodecConfig, name: str = "luma") -> CodecConfig:
    """The color codec owns table assignment (Y against Q, Cb/Cr against
    QC): a caller's cfg.q_table is replaced."""
    return dataclasses.replace(cfg, q_table=name)


def _chroma_cfg(cfg: CodecConfig, name: str = "chroma") -> CodecConfig:
    return dataclasses.replace(cfg, q_table=name)


def _to_rgb_u8(y, cb, cr) -> torch.Tensor:
    """(H, W, 3) uint8 of f32 YCbCr planes: round half away, clip."""
    return round_half_away(ycbcr_to_rgb(y, cb, cr)).clamp(0.0, 255.0).to(torch.uint8)


def _f32_planes(planes: dict, device) -> dict:
    return {k: _cast(_tensor(planes[k], device), torch.float32) for k in PLANES}


def _stack(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Two planes stacked vertically (the chroma pair: one copy, a
    ``layout`` span)."""
    with profiling.span("layout"):
        return torch.cat([top, bottom], dim=0)


def encode_color(p: Pipeline, rgb, cfg: CodecConfig, subsample=True,
                 device=None) -> Tuple[dict, dict]:
    """(H, W, 3) RGB -> ({plane: coefficient map}, meta), the f32 path.

    Coefficient maps keep the block-padded plane shapes; ``meta`` holds the
    RGB size, the true chroma plane size and the subsampling mode."""
    mode = normalize_subsample(subsample)
    y, cb, cr = rgb_to_ycbcr(_tensor(rgb, device))
    h, w = y.shape
    if mode:
        cb, cr = _DOWN[mode](cb), _DOWN[mode](cr)
    ch, cw = cb.shape
    yp, _ = pad_to_blocks(y)
    cy = p.encode(yp, _luma_cfg(cfg))
    cbp, _ = pad_to_blocks(cb)
    crp, _ = pad_to_blocks(cr)
    cc = p.encode(_stack(cbp, crp), _chroma_cfg(cfg))
    ph = cbp.shape[0]
    meta = {"orig_shape": (h, w), "chroma_shape": (ch, cw), "subsample": mode}
    return {"y": cy, "cb": cc[:ph], "cr": cc[ph:]}, meta


def decode_color(p: Pipeline, planes: dict, meta: dict, cfg: CodecConfig, device=None):
    """Inverse of :func:`encode_color`: coefficient planes -> (H, W, 3) u8."""
    h, w = meta["orig_shape"]
    ch, cw = meta["chroma_shape"]
    pl = _f32_planes(planes, device)
    y = crop(p.idct(pl["y"], _luma_cfg(cfg, meta.get("y_q_table", "luma"))), h, w)
    cc = p.idct(_stack(pl["cb"], pl["cr"]), _chroma_cfg(cfg, meta.get("c_q_table", "chroma")))
    ph = pl["cb"].shape[0]
    cb, cr = crop(cc[:ph], ch, cw), crop(cc[ph:], ch, cw)
    mode = normalize_subsample(meta["subsample"])
    if mode:
        cb, cr = _UP[mode](cb, h, w), _UP[mode](cr, h, w)
    return _to_rgb_u8(y, cb, cr)


def decode_color_scaled(p: Pipeline, planes: dict, meta: dict, cfg: CodecConfig,
                        factor: int | None = None, *, m: int | None = None, device=None):
    """Fractional-scale color decode: coefficient planes -> (H/f, W/f, 3) u8.

    Pass ``factor`` (1/f, f in 1, 2, 4, 8) or ``m`` (M/8, M = 1..16).  Chroma
    planes scale anisotropically, so subsampling composes with the scale
    (a 4:2:0 plane at 1/f luma scale is the 1/(f/2) decode of the stored
    plane; at f = 2 the stored grid itself).  Integer factors take the fused
    u8 scaled decode (``hp_scaled_decode_u8``) where every plane fits int8
    and the padded planes pass the u8 gate, else the f32 scaled decode; M/8
    takes the area-resample einsum, doubling the numerator on subsampled
    axes (so subsampled modes take M <= 8)."""
    from tpudct_torch.ops.scaled import (
        scaled_decode,
        scaled_decode_m8,
        scaled_decode_u8,
        scaled_shape,
        scaled_shape_m8,
    )

    if factor is not None and m is not None:
        raise ValueError("pass either factor or m, not both")
    if factor is None and m is None:
        raise ValueError("pass factor (1/f) or m (M/8)")
    if m is not None and 8 % m == 0:
        factor, m = 8 // m, None
    h, w = meta["orig_shape"]
    mode = normalize_subsample(meta["subsample"])
    lcfg = _luma_cfg(cfg, meta.get("y_q_table", "luma"))
    ccfg = _chroma_cfg(cfg, meta.get("c_q_table", "chroma"))
    if m is not None:
        m_r = 2 * m if mode == "420" else m
        m_c = 2 * m if mode in ("420", "422") else m
        if max(m_r, m_c) > 16:
            raise ValueError(
                f"M/8 color decode with {mode} chroma supports M <= 8 "
                f"(chroma numerator {max(m_r, m_c)} > 16); use a 4:4:4 "
                "stream for upscale numerators"
            )
        pl = _f32_planes(planes, device)
        hs, ws = scaled_shape_m8(h, m), scaled_shape_m8(w, m)
        y = scaled_decode_m8(pl["y"], lcfg, m)[:hs, :ws]
        cc = scaled_decode_m8(_stack(pl["cb"], pl["cr"]), ccfg, m_r, m_cols=m_c)
        phs = pl["cb"].shape[0] * m_r // 8
        return _to_rgb_u8(y, cc[:phs][:hs, :ws], cc[phs:][:hs, :ws])
    if factor == 1:
        return decode_color(p, planes, meta, cfg, device)
    hs, ws = scaled_shape(h, factor), scaled_shape(w, factor)
    f_r = factor // 2 if mode == "420" else factor
    f_c = factor // 2 if mode in ("420", "422") else factor
    y_al, c_al = hp.scaled_pad_align(factor, factor), hp.scaled_pad_align(f_r, f_c)
    pl = {k: _tensor(planes[k], device) for k in PLANES}

    def u8_ok(plane, pcfg, al):
        return (
            hasattr(p, "decode_u8")
            and hp.supports_u8(*kernel_padded_shape(*plane.shape, *al),
                               pcfg.q_scale, pcfg.transform, pcfg.q_table)
            and _fits_i8(plane)
        )

    if u8_ok(pl["y"], lcfg, y_al) and all(u8_ok(pl[k], ccfg, c_al) for k in ("cb", "cr")):
        ypad, _ = pad_coeffs_to_kernel(_cast(pl["y"], torch.int8), *y_al)
        y = scaled_decode_u8(p, ypad, lcfg, factor)[:hs, :ws]
        cbpad, _ = pad_coeffs_to_kernel(_cast(pl["cb"], torch.int8), *c_al)
        crpad, _ = pad_coeffs_to_kernel(_cast(pl["cr"], torch.int8), *c_al)
        cc = scaled_decode_u8(p, _stack(cbpad, crpad), ccfg, f_r, f_c)
        phs = cbpad.shape[0] // f_r
    else:
        f32 = {k: _cast(v, torch.float32) for k, v in pl.items()}
        y = scaled_decode(f32["y"], lcfg, factor)[:hs, :ws]
        cc = scaled_decode(_stack(f32["cb"], f32["cr"]), ccfg, f_r, f_cols=f_c)
        phs = pl["cb"].shape[0] // f_r
    return _to_rgb_u8(y, cc[:phs][:hs, :ws], cc[phs:][:hs, :ws])


def roundtrip_color(p: Pipeline, rgb, cfg: CodecConfig, subsample=True, device=None):
    """Full color pass: returns (coefficient planes, meta, RGB u8 recon)."""
    planes, meta = encode_color(p, rgb, cfg, subsample=subsample, device=device)
    return planes, meta, decode_color(p, planes, meta, cfg, device)


# ---- u8-native path ---------------------------------------------------------


def _layout(rgb) -> tuple:
    """("planar" | "interleaved", h, w) of a 3-channel image, from its shape
    alone; an ambiguous (3, W, 3) reads as interleaved (channels last)."""
    shape = tuple(rgb.shape)
    if len(shape) != 3:
        raise ValueError(f"expected a 3-channel image, got shape {shape}")
    if shape[-1] == 3:
        return "interleaved", shape[0], shape[1]
    if shape[0] == 3:
        return "planar", shape[1], shape[2]
    raise ValueError(f"expected 3 channels, got shape {shape}")


def _u8_frame(rgb, device=None) -> tuple:
    """(tensor, layout) of a uint8 frame of either layout as the direct
    split reads it: contiguous in its own layout, or in the other one (a
    view), else copied (a ``layout`` span)."""
    layout, _h, _w = _layout(rgb)
    if not _is_u8(rgb):
        dt = str(rgb.dtype).removeprefix("torch.")
        raise ValueError(f"u8 color path needs uint8 input, got {dt}")
    x = _tensor(rgb, device)
    if x.is_contiguous():
        return x, layout
    if layout == "interleaved" and x.movedim(-1, 0).is_contiguous():
        return x.movedim(-1, 0), "planar"
    if layout == "planar" and x.movedim(0, -1).is_contiguous():
        return x.movedim(0, -1), "interleaved"
    with profiling.span("layout"):
        return x.contiguous(), layout


def _interleaved_f32(rgb, device=None) -> torch.Tensor:
    """Either layout -> (H, W, 3) f32 for the general path."""
    layout, _h, _w = _layout(rgb)
    x = _cast(_tensor(rgb, device), torch.float32)
    return x if layout == "interleaved" else x.movedim(0, -1)


# stacked-chroma (cb over cr) codec geometry per mode, from the luma (h, w)
_CHROMA_STACK = {
    "420": lambda h, w: (h, w // 2),
    "422": lambda h, w: (2 * h, w // 2),
    False: lambda h, w: (2 * h, w),
}


def supports_color_u8(p: Pipeline, cfg: CodecConfig, h: int, w: int, subsample="420") -> bool:
    """Gate of the u8 color path: a pipeline with the u8 codec, the 0.5
    deadzone the kernels bake in, the (64, 256) grid, and int8 coefficients
    against both tables (the chroma planes stacked)."""
    ch, cw = _CHROMA_STACK[normalize_subsample(subsample)](h, w)
    return (
        hasattr(p, "encode_u8")
        and cfg.deadzone == 0.5
        and h % 64 == 0
        and w % 256 == 0
        and hp.supports_u8(h, w, cfg.q_scale, cfg.transform, "luma")
        and hp.supports_u8(ch, cw, cfg.q_scale, cfg.transform, "chroma")
    )


def _mode_name(mode) -> str:
    """The kernels' name of a normalized mode: "420", "422" or "444"."""
    return mode or "444"


def _u8_kernels(mode):
    return {
        "420": (ck.color_split_420_u8, ck.color_merge_420_u8),
        "422": (ck.color_split_422_u8, ck.color_merge_422_u8),
        False: (ck.color_split_444_u8, ck.color_merge_444_u8),
    }[mode]


def _chroma_plane_shape(mode, h, w):
    """True chroma plane dims for a luma (h, w) (ceil-division)."""
    return {
        "420": (-(-h // 2), -(-w // 2)),
        "422": (h, -(-w // 2)),
        False: (h, w),
    }[mode]


def color_kernel_shape(h: int, w: int):
    """The u8 color path's padding: H to 64-multiples, W to 256-multiples
    (a 4032x3024 camera frame pads to 4032x3072)."""
    return kernel_padded_shape(h, w, *_GRID)


def _zero_pad(c: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    h, w = c.shape
    if (h, w) == (ph, pw):
        return c
    with profiling.span("pad"):
        return F.pad(c, (0, pw - w, 0, ph - h))


def _stacked(cb: torch.Tensor, cr: torch.Tensor):
    """The (2 h, w) stack of cb above cr as a view where cr directly follows
    cb in one contiguous buffer (the planes ``encode_color_u8`` returns),
    else None."""
    if (cb.shape != cr.shape or cb.dtype != cr.dtype or cb.device != cr.device
            or not (cb.is_contiguous() and cr.is_contiguous())
            or cb.untyped_storage().data_ptr() != cr.untyped_storage().data_ptr()
            or cr.storage_offset() != cb.storage_offset() + cb.numel()):
        return None
    h, w = cb.shape
    return cb.as_strided((2 * h, w), (w, 1))


class _U8Plan:
    """What the u8 path decides for one frame shape, layout, mode,
    pipeline type and configuration, worked out once (:func:`_u8_plan`):
    the gate's verdict, the plane shapes, the luma and chroma
    configurations, and on first use on a card each direction's core ids
    and constant tables, whose host addresses the chain launchers read.
    Holds no tensor.  The gate and the tables are evaluated lazily, so
    every refusal is raised where the unplanned path raised it."""

    __slots__ = ("ptype", "cfg", "hk", "wk", "layout", "mode", "name", "rh", "rw", "y8", "c8",
                 "chroma", "lcfg", "ccfg", "_ok", "_enc", "_dec")

    def __init__(self, ptype, h: int, w: int, layout: str, mode, cfg: CodecConfig):
        self.ptype, self.cfg, self.layout, self.mode = ptype, cfg, layout, mode
        self.hk, self.wk = color_kernel_shape(h, w)
        self.name = _mode_name(mode)
        self.rh, self.rw = ck.WINDOWS[self.name]
        self.y8, self.c8 = ck.direct_shapes(h, w, self.name)
        self.chroma = _chroma_plane_shape(mode, h, w)
        self.lcfg, self.ccfg = _luma_cfg(cfg), _chroma_cfg(cfg)
        self._ok = self._enc = self._dec = None

    @property
    def ok(self) -> bool:
        """:func:`supports_color_u8` on the kernel grid."""
        if self._ok is None:
            self._ok = supports_color_u8(self.ptype, self.cfg, self.hk, self.wk, self.mode)
        return self._ok

    def encoder(self) -> tuple:
        """(luma core, chroma core, tables, their addresses) of the encode
        chain: ``hp_encode_u8``'s ids and packed constants, after the
        colour constants."""
        if self._enc is None:
            self._enc = self._tables(lambda c: (c.transform, c.q_table, c.q_scale, c.retain_k,
                                                "butterfly", True), 0)
        return self._enc

    def decoder(self) -> tuple:
        """The same of the decode chain: ``hp_decode_u8``'s."""
        if self._dec is None:
            self._dec = self._tables(lambda c: (c.transform, c.q_table, c.q_scale, None,
                                                _decode_prec(c), False), 1)
        return self._dec

    def _tables(self, key, which: int) -> tuple:
        keys = [key(c) for c in (self.lcfg, self.ccfg)]
        ids = [hp._core_of(*k)[which] for k in keys]
        tables = (ck._consts(), *(hp._args(*k).packed for k in keys))
        return (*ids, tables, *(t.ctypes.data for t in tables))


_PLANS: dict = {}
_PLANS_MAX = 256


def _u8_plan(p: Pipeline, h: int, w: int, layout: str, mode, cfg: CodecConfig) -> _U8Plan:
    """The plan of a (normalized) mode's u8 path, from the cache; counts
    ``color.u8.plan.miss`` where it is built, ``color.u8.plan.hit`` where
    it is reused."""
    key = (type(p), h, w, layout, mode, cfg)
    plan = _PLANS.get(key)
    if plan is not None:
        profiling.count("color.u8.plan.hit", 1)
        return plan
    if len(_PLANS) >= _PLANS_MAX:
        _PLANS.clear()
    plan = _PLANS[key] = _U8Plan(type(p), h, w, layout, mode, cfg)
    profiling.count("color.u8.plan.miss", 1)
    return plan


# cleared with the caches keyed by table names (a plan holds the tables)
_u8_plan.cache_clear = _PLANS.clear


def _chain(fn_name: str, dev: torch.device, *args) -> None:
    """``fn_name(*args, stream, device)``, a colour chain launcher, on
    ``dev``'s current stream (its raw handle: ``current_stream(dev)``
    builds a Stream object, 30 times the cost); raises as ``_build.call``
    does."""
    lib = _build.library()
    err = getattr(lib, fn_name)(*args, torch._C._cuda_getCurrentRawStream(dev.index), dev.index)
    if err:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: {lib.hp_error_string(err).decode()}")


def _scratch(plan: _U8Plan, dev: torch.device) -> torch.Tensor:
    """One buffer for a chain's intermediate planes: luma, then the
    stacked chroma (the split's output and the codec's input, or the
    decodes' output and the merge's input)."""
    (yh, yw), (ch, cw) = plan.y8, plan.c8
    return torch.empty(yh * yw + 2 * ch * cw, dtype=torch.uint8, device=dev)


def _encode_chain(plan: _U8Plan, x: torch.Tensor, h: int, w: int, scratch) -> tuple:
    """(luma, stacked chroma) int8 coefficients of a card frame: the direct
    split and two ``hp_encode_u8`` launches in one native call."""
    (yh, yw), (ch, cw) = plan.y8, plan.c8
    dev = x.device
    cy = torch.empty((yh, yw), dtype=torch.int8, device=dev)
    ccq = torch.empty((2 * ch, cw), dtype=torch.int8, device=dev)
    s = scratch.data_ptr()
    core_y, core_c, _tables, k, kl, kc = plan.encoder()
    hwc = plan.layout == "interleaved"
    _chain("color_encode_u8_chain_launch", dev, x.data_ptr(), s, s + yh * yw, cy.data_ptr(),
           ccq.data_ptr(), h, w, plan.rh, plan.rw, int(hwc), ck._align(x, 3 * w if hwc else w),
           core_y, core_c, k, kl, kc)
    ck.LAUNCHES[f"color_split_direct_{plan.name}"] += 1
    hp.LAUNCHES["hp_encode_u8"] += 2
    return cy, ccq


def _decode_chain(plan: _U8Plan, cy: torch.Tensor, ccq: torch.Tensor, h: int, w: int,
                  scratch) -> torch.Tensor:
    """(h, w, 3) uint8 of card planes (luma, the stacked chroma: int8,
    contiguous, 16-byte aligned): two ``hp_decode_u8`` launches and the
    direct merge in one native call."""
    yh, yw = plan.y8
    dev = cy.device
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
    s = scratch.data_ptr()
    inv_y, inv_c, _tables, k, kl, kc = plan.decoder()
    _chain("color_decode_u8_chain_launch", dev, cy.data_ptr(), ccq.data_ptr(), s, s + yh * yw,
           out.data_ptr(), h, w, plan.rh, plan.rw, ck._align(out, 3 * w), inv_y, inv_c, k, kl, kc)
    hp.LAUNCHES["hp_decode_u8"] += 2
    ck.LAUNCHES[f"color_merge_direct_{plan.name}"] += 1
    return out


def _planned_frame(p: Pipeline, rgb_u8, cfg: CodecConfig, subsample, device, plan=None) -> tuple:
    """(frame, h, w, plan) of the u8 encode, ``plan`` reused where its
    layout is the frame's; raises where the gate refuses."""
    x, layout = _u8_frame(rgb_u8, device)
    h, w = x.shape[:2] if layout == "interleaved" else x.shape[1:]
    if plan is None or plan.layout != layout:
        plan = _u8_plan(p, h, w, layout, normalize_subsample(subsample), cfg)
    if not plan.ok:
        raise ValueError(
            f"u8 color path unsupported for {h}x{w} subsample={subsample} "
            "(needs hp pipeline and an int8-safe q_scale); use encode_color"
        )
    return x, h, w, plan


def _encode_u8(p: Pipeline, x: torch.Tensor, h: int, w: int, plan: _U8Plan, scratch=None) -> tuple:
    """(planes, meta, stacked chroma coefficients) of a planned frame: on a
    card one chain call, else the split and codec wrappers (the twins)."""
    if x.device.type == "cuda" and h > 0 and w > 0:
        cy, ccq = _encode_chain(plan, x, h, w, _scratch(plan, x.device) if scratch is None else scratch)
    else:
        y, cc = ck.color_split_direct_u8(x, plan.name, plan.layout)
        cy = p._encode_u8_plane(y, plan.lcfg)
        ccq = p._encode_u8_plane(cc, plan.ccfg)
    profiling.count("color.u8.direct", 1)
    ch = plan.c8[0]
    meta = {"orig_shape": (h, w), "chroma_shape": plan.chroma, "subsample": plan.mode}
    return {"y": cy, "cb": ccq[:ch], "cr": ccq[ch:]}, meta, ccq


def _decode_u8(p: Pipeline, y: torch.Tensor, cc: torch.Tensor, h: int, w: int, plan: _U8Plan,
               scratch=None) -> torch.Tensor:
    """(h, w, 3) uint8 of contiguous int8 luma and stacked chroma planes at
    the plan's shapes: on one card and 16-byte aligned, one chain call;
    else the codec and merge wrappers (the twins, and every refusal)."""
    profiling.count("color.u8.direct", 1)
    if (y.device.type == "cuda" and cc.device == y.device and h > 0 and w > 0
            and not y.data_ptr() % 16 and not cc.data_ptr() % 16):
        return _decode_chain(plan, y, cc, h, w, _scratch(plan, y.device) if scratch is None else scratch)
    yd = p._decode_u8_plane(y, plan.lcfg)
    cd = p._decode_u8_plane(cc, plan.ccfg)
    ch = plan.c8[0]
    return ck.color_merge_direct_u8(yd, cd[:ch], cd[ch:], h, w, plan.name)


def encode_color_u8(p: Pipeline, rgb_u8, cfg: CodecConfig, subsample=True, device=None):
    """u8 color encode: uint8 RGB (either layout) -> int8 coefficient planes.

    The direct split reads the frame as it lies (edge rows and columns
    replicated, as the reference's pad to :func:`color_kernel_shape` gives
    them) and writes luma and the stacked chroma at the 8-aligned true plane
    shapes; one ``hp_encode_u8`` launch codes each (on a card the three
    launches are one native call).  A ragged frame's planes have the f32
    path's shapes; cb and cr are the row halves of one buffer."""
    planes, meta, _ccq = _encode_u8(p, *_planned_frame(p, rgb_u8, cfg, subsample, device))
    return planes, meta


def decode_color_u8(p: Pipeline, planes: dict, meta: dict, cfg: CodecConfig, device=None):
    """Inverse of :func:`encode_color_u8` -> (H, W, 3) uint8 interleaved.

    Takes planes at the 8-aligned true plane shapes (what both encode paths
    give) and decodes luma and the stacked chroma (one ``hp_decode_u8``
    launch each; cb and cr from one buffer are stacked as a view, others by
    one copy); the direct merge writes the (H, W, 3) frame, contiguous (on
    a card the three launches are one native call)."""
    h, w = meta["orig_shape"]
    plan = _u8_plan(p, h, w, "interleaved", normalize_subsample(meta["subsample"]), cfg)
    y8, c8 = plan.y8, plan.c8
    shapes = {k: tuple(planes[k].shape) for k in PLANES}
    if shapes["y"] != y8 or shapes["cb"] != c8 or shapes["cr"] != c8:
        raise ValueError(
            f"u8 decode expects 8-aligned planes: y is {shapes['y']} (want {y8}), "
            f"cb/cr are {shapes['cb']}/{shapes['cr']} (want {c8}); "
            "use decode_color for other paddings"
        )
    pl = {k: _cast(_tensor(planes[k], device), torch.int8) for k in PLANES}
    cc = _stacked(pl["cb"], pl["cr"])
    if cc is None:
        cc = _stack(pl["cb"], pl["cr"])
    return _decode_u8(p, pl["y"].contiguous(), cc, h, w, plan)


def _decode_u8_padded(p: Pipeline, y_i8: torch.Tensor, cc_i8: torch.Tensor, cfg: CodecConfig,
                      mode) -> torch.Tensor:
    """The u8 decode of int8 planes at the kernel grid: the luma plane and
    the stacked chroma (cb over cr) -> (3, H, W) planar uint8 RGB (two
    ``hp_decode_u8`` launches and one merge)."""
    y = p.decode_u8(y_i8, _luma_cfg(cfg))
    cc = p.decode_u8(cc_i8, _chroma_cfg(cfg))
    chk = cc.shape[0] // 2
    _split, merge = _u8_kernels(mode)
    return merge(y, cc[:chk], cc[chk:])


def _roundtrip_u8(p: Pipeline, x: torch.Tensor, h: int, w: int, plan: _U8Plan) -> tuple:
    """The u8 encode and decode of a planned frame; on a card both chains
    share one scratch buffer (stream-ordered: the decode's writes follow
    the encode's reads)."""
    scratch = _scratch(plan, x.device) if x.device.type == "cuda" else None
    planes, meta, ccq = _encode_u8(p, x, h, w, plan, scratch)
    return planes, meta, _decode_u8(p, planes["y"], ccq, h, w, plan, scratch)


def roundtrip_color_u8(p: Pipeline, rgb_u8, cfg: CodecConfig, subsample=True, device=None):
    """u8 color pass: uint8 RGB -> (int8 coefficient planes, meta, uint8
    RGB reconstruction); any chroma mode (default 4:2:0)."""
    return _roundtrip_u8(p, *_planned_frame(p, rgb_u8, cfg, subsample, device))


# ---- auto dispatch -----------------------------------------------------------


def _u8_eligible_plan(p: Pipeline, rgb, cfg: CodecConfig, subsample):
    """The plan of uint8 pixels of either layout whose kernel-padded dims
    pass the gate (dtype and shape read without a transfer), else None."""
    if getattr(rgb, "dtype", None) is None or not _is_u8(rgb):
        return None
    try:
        layout, h, w = _layout(rgb)
    except ValueError:
        return None
    plan = _u8_plan(p, h, w, layout, normalize_subsample(subsample), cfg)
    return plan if plan.ok else None


def _u8_eligible(p: Pipeline, rgb, cfg: CodecConfig, subsample) -> bool:
    return _u8_eligible_plan(p, rgb, cfg, subsample) is not None


@profiling.entry
def encode_color_auto(p: Pipeline, rgb, cfg: CodecConfig, subsample=True, device=None):
    """Encode through the u8 path where the input and geometry allow it,
    else the f32 path; either layout."""
    plan = _u8_eligible_plan(p, rgb, cfg, subsample)
    if plan is not None:
        planes, meta, _ccq = _encode_u8(p, *_planned_frame(p, rgb, cfg, subsample, device, plan))
        return planes, meta
    return encode_color(p, _interleaved_f32(rgb, device), cfg, subsample=subsample)


def _u8_decodable(p: Pipeline, planes: dict, meta: dict, cfg: CodecConfig) -> bool:
    """The standard tables, the u8 gate on the kernel grid, the 8-aligned
    true plane shapes, and values that fit int8 (the f32 path's planes of
    out-of-range pixels may not)."""
    h, w = meta["orig_shape"]
    plan = _u8_plan(p, h, w, "interleaved", normalize_subsample(meta["subsample"]), cfg)
    return (
        meta.get("y_q_table", "luma") == "luma"
        and meta.get("c_q_table", "chroma") == "chroma"
        and plan.ok
        and tuple(planes["y"].shape) == plan.y8
        and tuple(planes["cb"].shape) == plan.c8
        and tuple(planes["cr"].shape) == plan.c8
        and all(_fits_i8(planes[k]) for k in PLANES)
    )


@profiling.entry
def decode_color_auto(p: Pipeline, planes: dict, meta: dict, cfg: CodecConfig, device=None):
    """Decode through the u8 path where the stream allows it (see
    :func:`_u8_decodable`), else the f32 path."""
    if _u8_decodable(p, planes, meta, cfg):
        return decode_color_u8(p, planes, meta, cfg, device)
    return decode_color(p, planes, meta, cfg, device)


@profiling.entry
def roundtrip_color_auto(p: Pipeline, rgb, cfg: CodecConfig, subsample=True, device=None):
    """Roundtrip whose decode takes the path the encode took.  Returns
    (planes, meta, rgb u8 interleaved)."""
    plan = _u8_eligible_plan(p, rgb, cfg, subsample)
    if plan is not None:
        return _roundtrip_u8(p, *_planned_frame(p, rgb, cfg, subsample, device, plan))
    return roundtrip_color(p, _interleaved_f32(rgb, device), cfg, subsample=subsample)


# ---- stacked bulk dispatch ---------------------------------------------------
#
# 8x8 blocks are independent and the chroma windows are at most 2 rows tall,
# so same-padded-width frames stack as one taller planar image through one
# split, one luma and one chroma codec launch and one merge (every padded
# height is a 64-multiple: no seam splits a window or a block).  Frames are
# padded and stacked on the host; each chunk runs on default_device(device).


def _host(x) -> torch.Tensor:
    return _to_host(x) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _np_planes(planes: dict) -> dict:
    return {k: _to_host(v).numpy() for k, v in planes.items()}


def encode_color_batch_auto(p: Pipeline, rgbs, cfg: CodecConfig, subsample=True,
                            max_pixels: int = _STACK_MAX_PIXELS, device=None) -> list:
    """Bulk color encode: one split, one luma and one chroma codec launch
    per same-width chunk of u8-eligible frames.

    Takes RGB images (either layout); returns ``[(planes, meta), ...]``
    (numpy planes) in input order, each bit-identical to
    :func:`encode_color_auto` on that frame alone; ineligible frames go
    through it one by one."""
    mode = normalize_subsample(subsample)
    results: list = [None] * len(rgbs)
    metas = []  # (idx, padded planar host tensor, h, w)
    for i, rgb in enumerate(rgbs):
        if not _u8_eligible(p, rgb, cfg, subsample):
            planes, meta = encode_color_auto(p, rgb, cfg, subsample=subsample, device=device)
            results[i] = (_np_planes(planes), meta)
            continue
        layout, h, w = _layout(rgb)
        x = _host(rgb)
        x = (x if layout == "planar" else x.movedim(-1, 0)).contiguous()
        metas.append((i, pad_to_kernel(x, *_GRID)[0], h, w))
    split, _merge = _u8_kernels(mode)
    keys = [x.shape[2] for _, x, _, _ in metas]
    sizes = [x.numel() for _, x, _, _ in metas]
    for _wk, indices in _stack_groups(keys).items():
        for chunk in _chunk(indices, sizes, max_pixels):
            frames = [metas[j][1] for j in chunk]
            stacked = frames[0] if len(frames) == 1 else torch.cat(frames, dim=1)
            y, cb, cr = split(_to_device(stacked, default_device(device)))
            del stacked
            cy = _to_host(p.encode_u8(y, _luma_cfg(cfg))).numpy()
            ph = cb.shape[0]
            cc = _to_host(p.encode_u8(_stack(cb, cr), _chroma_cfg(cfg))).numpy()
            ccb, ccr = cc[:ph], cc[ph:]
            y0 = c0 = 0
            for j in chunk:
                i, x, h, w = metas[j]
                hk, wk = x.shape[1], x.shape[2]
                chk, _cwk = _chroma_plane_shape(mode, hk, wk)
                ch, cw = _chroma_plane_shape(mode, h, w)
                y8, c8 = padded_shape(h, w), padded_shape(ch, cw)
                meta = {"orig_shape": (h, w), "chroma_shape": (ch, cw), "subsample": mode}
                results[i] = ({
                    "y": cy[y0 : y0 + y8[0], : y8[1]].copy(),
                    "cb": ccb[c0 : c0 + c8[0], : c8[1]].copy(),
                    "cr": ccr[c0 : c0 + c8[0], : c8[1]].copy(),
                }, meta)
                y0 += hk
                c0 += chk
    return results


def decode_color_batch_auto(p: Pipeline, items, max_pixels: int = _STACK_MAX_PIXELS,
                            device=None) -> list:
    """Bulk color decode: one luma and one chroma codec launch and one merge
    per same-width, same-config chunk of u8-decodable streams.

    Takes ``[(planes, meta, cfg), ...]``; returns interleaved (H, W, 3)
    uint8 numpy frames in input order, each bit-identical to
    :func:`decode_color_auto` on that stream alone."""
    results: list = [None] * len(items)
    metas = []  # (idx, ypad, cbpad, crpad, mode, cfg, h, w), host tensors
    for i, (planes, meta, cfg) in enumerate(items):
        if not _u8_decodable(p, planes, meta, cfg):
            results[i] = _to_host(decode_color_auto(p, planes, meta, cfg, device)).numpy()
            continue
        h, w = meta["orig_shape"]
        mode = normalize_subsample(meta["subsample"])
        hk, wk = color_kernel_shape(h, w)
        chk, cwk = _chroma_plane_shape(mode, hk, wk)
        yp = _zero_pad(_host(planes["y"]).to(torch.int8), hk, wk)
        cbp, crp = (_zero_pad(_host(planes[k]).to(torch.int8), chk, cwk) for k in ("cb", "cr"))
        metas.append((i, yp, cbp, crp, mode, cfg, h, w))
    if not metas:
        return results
    dev = default_device(device)
    keys = [(yp.shape[1], mode, cfg) for _, yp, _, _, mode, cfg, _, _ in metas]
    sizes = [yp.numel() * 3 for _, yp, _, _, _, _, _, _ in metas]
    for (_wk, mode, cfg), indices in _stack_groups(keys).items():
        _split, merge = _u8_kernels(mode)
        for chunk in _chunk(indices, sizes, max_pixels):
            ys = _to_device(torch.cat([metas[j][1] for j in chunk], dim=0), dev)
            cc = torch.cat([metas[j][2] for j in chunk] + [metas[j][3] for j in chunk], dim=0)
            y = p.decode_u8(ys, _luma_cfg(cfg))
            cc = p.decode_u8(_to_device(cc, dev), _chroma_cfg(cfg))
            ph = cc.shape[0] // 2
            rgb = merge(y, cc[:ph], cc[ph:])
            # interleave on the device: a strided host copy per frame costs more
            with profiling.span("layout"):
                rgb = rgb.movedim(0, -1).contiguous()
            rgb = _to_host(rgb).numpy()
            y0 = 0
            for j in chunk:
                i, yp, _, _, _, _, h, w = metas[j]
                results[i] = rgb[y0 : y0 + h, :w].copy()
                y0 += yp.shape[0]
    return results
