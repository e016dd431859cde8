"""Gray-plane dispatch: one gate for the u8 kernels, the f32 kernels and the
einsum path, the scaled decode and the stacked bulk helpers (the gray part
of ``tpudct/models/dispatch.py``).

The gate and the padding are the reference's, so both packages send a
shape down the same path:

- encode: edge-replicate pad to the dispatch grid (the transform is
  block-local, so pixels in the original region are unaffected), run the
  fastest eligible path, and crop the coefficient map back to the 8-aligned
  shape.
- decode: zero-pad the coefficient map to the grid (all-zero blocks decode
  to the constant level shift), decode, crop.

Inputs may be numpy arrays or tensors.  A tensor stays on its device (a
CUDA tensor runs the CUDA kernels, a CPU tensor their plain twins); a numpy
array goes to :func:`default_device`, as the reference's host arrays go to
its default accelerator: the first CUDA card, or the device the caller
names with ``device=`` (``device="cpu"`` runs the plain twins).  Without a
card and without ``device=``, a host array raises: nothing falls back to
the CPU unasked.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.models.base import Pipeline
from tpudct_torch.ops.padding import (
    crop,
    kernel_padded_shape,
    pad_coeffs_to_kernel,
    pad_to_blocks,
    pad_to_kernel,
    padded_shape,
)
from tpudct_torch.ops.transform import to_uint8
from tpudct_torch.utils import profiling
from tpudct_torch.utils.serialize import _abs_bound

# Row alignment per kernel family (kernels.hp.supports/supports_u8).
_U8_ROWS = 32
_F32_ROWS = 8
_LANE = 128


def default_device(device=None) -> torch.device:
    """Where host arrays run: ``device`` where the caller names one, else
    the first CUDA card.  Raises where there is no card and no ``device``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: host arrays run on the first card; pass device='cpu' "
            "to run the plain twins on the CPU"
        )
    return torch.device("cuda", 0)


def _tensor(a, device=None) -> torch.Tensor:
    """A tensor as it is; anything else on :func:`default_device`."""
    if isinstance(a, torch.Tensor):
        return a
    return _to_device(torch.as_tensor(np.asarray(a)), default_device(device))


def _is_card(dev: torch.device) -> bool:
    """Whether ``dev`` is a card: a tensor's copy between it and the host
    crosses the bus."""
    return dev.type != "cpu"


def _to_device(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on ``dev`` (to a card: one pageable copy, a
    ``to_device`` span)."""
    if not _is_card(dev):
        return x.to(dev)
    with profiling.span("to_device"):
        profiling.count("bytes.pageable", x.numel() * x.element_size())
        return x.to(dev)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A tensor on the host (from a card: one pageable copy, a ``to_host``
    span)."""
    if not _is_card(t.device):
        return t
    with profiling.span("to_host"):
        profiling.count("bytes.pageable", t.numel() * t.element_size())
        return t.cpu()


def _bound(a) -> float:
    """:func:`_abs_bound`, in a ``wait`` span where it reads a device tensor
    back (the host waits for the device)."""
    if isinstance(a, torch.Tensor) and _is_card(a.device):
        with profiling.span("wait"):
            return _abs_bound(a)
    return _abs_bound(a)


def choose_gray_path(p: Pipeline, h: int, w: int, cfg: CodecConfig) -> str:
    """Pure decision on shape and config: ``"u8"`` (fused int8 kernels),
    ``"f32"`` (the pipeline's f32 kernel path) or ``"general"`` (the
    pipeline's default path; also every non-hp pipeline)."""
    from tpudct_torch.kernels import hp

    if cfg.deadzone != 0.5:
        # encode-side deadzone rides the einsum quantizer only
        return "general"
    if hasattr(p, "roundtrip_u8"):
        if hp.supports_u8(
            *kernel_padded_shape(h, w, _U8_ROWS, _LANE),
            cfg.q_scale, cfg.transform, cfg.q_table,
        ):
            return "u8"
        if hp.supports(*kernel_padded_shape(h, w, _F32_ROWS, _LANE)):
            return "f32"
    return "general"


def _is_u8(img) -> bool:
    if isinstance(img, torch.Tensor):
        return img.dtype == torch.uint8
    return np.asarray(img).dtype == np.uint8


def _resolve_path(p: Pipeline, img, cfg: CodecConfig) -> str:
    """choose_gray_path, with float inputs demoted from "u8" to "f32" (a
    float may sit outside [0, 255], where a cast would wrap)."""
    h, w = tuple(img.shape)
    path = choose_gray_path(p, h, w, cfg)
    if path == "u8" and not _is_u8(img):
        return "f32"
    return path


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` (a conversion pass, a ``layout`` span, where the
    dtype differs)."""
    if x.dtype == dtype:
        return x
    with profiling.span("layout"):
        return x.to(dtype)


def _pad_for(path: str, img: torch.Tensor):
    """Edge-replicate pad an image to the grid of `path`, in its dtype."""
    if path == "u8":
        return pad_to_kernel(_cast(img, torch.uint8), _U8_ROWS, _LANE)
    if path == "f32":
        return pad_to_kernel(_cast(img, torch.float32), _F32_ROWS, _LANE)
    x = torch.as_tensor(img)
    if not x.dtype.is_floating_point:
        x = _cast(x, torch.float32)
    return pad_to_blocks(x)


def _crop8(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Crop a grid-padded coefficient map back to the 8-aligned shape."""
    return crop(c, *padded_shape(h, w))


@profiling.entry
def encode_gray_auto(p: Pipeline, img, cfg: CodecConfig, device=None):
    """Gray encode through the fastest eligible path.  Returns (coeffs,
    (h, w)) with `coeffs` at the 8-aligned padded shape (int8 when the u8
    kernels ran, f32 otherwise)."""
    img = _tensor(img, device)
    h, w = tuple(img.shape)
    path = _resolve_path(p, img, cfg)
    x, _ = _pad_for(path, img)
    c = p.encode_u8(x, cfg) if path == "u8" else p.encode(x, cfg)
    return _crop8(c, h, w), (h, w)


@profiling.entry
def decode_gray_auto(p: Pipeline, coeffs, cfg: CodecConfig, orig_shape,
                     device=None) -> np.ndarray:
    """Decode a quantized-coefficient map to a cropped uint8 numpy plane,
    on the int8 kernel whenever the values fit int8 and the zero-padded
    map meets the grid."""
    h, w = orig_shape
    coeffs = _tensor(coeffs, device)
    path = _decode_path(p, coeffs, cfg)
    return _to_host(_decode_padded(p, path, _pad_coeffs_for(path, coeffs), cfg)[:h, :w]).numpy()


def _pad_coeffs_for(path: str, coeffs: torch.Tensor) -> torch.Tensor:
    """Zero-pad a quantized map to the grid of its decode `path`, in that
    path's dtype (the general path takes the map as it is)."""
    if path == "u8":
        return pad_coeffs_to_kernel(_cast(coeffs, torch.int8), _U8_ROWS, _LANE)[0]
    if path == "f32":
        return pad_coeffs_to_kernel(_cast(coeffs, torch.float32), _F32_ROWS, _LANE)[0]
    return coeffs


def _decode_padded(p: Pipeline, path: str, cpad: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """The uint8 decode of a map padded by :func:`_pad_coeffs_for`."""
    return p.decode_u8(cpad, cfg) if path == "u8" else to_uint8(p.idct(cpad, cfg))


def _decode_path(p: Pipeline, coeffs, cfg: CodecConfig) -> str:
    """The decode path of a quantized map (array or tensor): ``"u8"`` where
    the values fit int8 and the zero-padded map meets the u8 grid, ``"f32"``
    where it meets the f32 grid, else ``"general"``."""
    from tpudct_torch.kernels import hp

    hc, wc = tuple(coeffs.shape)
    if not hasattr(p, "decode_u8"):
        return "general"
    if (
        hp.supports_u8(
            *kernel_padded_shape(hc, wc, _U8_ROWS, _LANE),
            cfg.q_scale, cfg.transform, cfg.q_table,
        )
        and _bound(coeffs) <= 127
    ):
        return "u8"
    return "f32" if hp.supports(*kernel_padded_shape(hc, wc, _F32_ROWS, _LANE)) else "general"


def _scaled_u8_align(p: Pipeline, coeffs, cfg: CodecConfig, fac: int):
    """(row, lane) padding under which a quantized map (array or tensor)
    takes the u8 scaled decode at factor ``fac``, or None where it does not
    (the values do not fit int8, or the padded map fails the u8 gate)."""
    from tpudct_torch.kernels import hp

    ra, la = hp.scaled_pad_align(fac, fac)
    if (
        hasattr(p, "decode_u8")
        and hp.supports_u8(
            *kernel_padded_shape(*tuple(coeffs.shape), ra, la),
            cfg.q_scale, cfg.transform, cfg.q_table,
        )
        and _bound(coeffs) <= 127
    ):
        return ra, la
    return None


def _scaled_plan(p: Pipeline, coeffs, cfg: CodecConfig, m: int) -> tuple:
    """How a quantized map (array or tensor) takes the M/8 scaled decode:
    ``("m8", None)`` for the area-resample einsum (8 % M != 0), ``("u8",
    (row, lane) padding)`` for the u8 scaled decode at 8/M, ``("f32",
    None)`` for the f32 scaled decode."""
    if 8 % m:
        return "m8", None
    align = _scaled_u8_align(p, coeffs, cfg, 8 // m)
    return ("u8", align) if align is not None else ("f32", None)


def _decode_scaled(p: Pipeline, plan: tuple, coeffs: torch.Tensor, cfg: CodecConfig,
                   m: int) -> torch.Tensor:
    """The uncropped uint8 M/8 decode of a map by its :func:`_scaled_plan`
    (the ``"u8"`` plan takes the map zero-padded to its alignment or
    unpadded)."""
    from tpudct_torch.ops.scaled import scaled_decode, scaled_decode_m8, scaled_decode_u8

    kind, align = plan
    if kind == "m8":
        return to_uint8(scaled_decode_m8(coeffs, cfg, m))
    if kind == "u8":
        cpad, _ = pad_coeffs_to_kernel(_cast(coeffs, torch.int8), *align)
        # out_u8: the truncation rides the kernel's epilogue
        return scaled_decode_u8(p, cpad, cfg, 8 // m, out_u8=True)
    return to_uint8(scaled_decode(coeffs, cfg, 8 // m))


def decode_gray_scaled_auto(p: Pipeline, coeffs, cfg: CodecConfig, orig_shape,
                            m: int, device=None) -> np.ndarray:
    """M/8 fractional-scale decode of a quantized map -> cropped uint8 numpy
    plane.  Integer 8/M factors pad to ``hp.scaled_pad_align`` and ride
    ``ops.scaled.scaled_decode_u8`` (the fused kernel, or its bit-identical
    composed form); M = 8 is the plain full decode; other numerators take
    the exact area-resample einsum (``scaled_decode_m8``)."""
    from tpudct_torch.ops.scaled import scaled_shape_m8

    h, w = orig_shape
    coeffs = _tensor(coeffs, device)
    if m == 8:
        return decode_gray_auto(p, coeffs, cfg, orig_shape)
    hs, ws = scaled_shape_m8(h, m), scaled_shape_m8(w, m)
    rec = _decode_scaled(p, _scaled_plan(p, coeffs, cfg, m), coeffs, cfg, m)
    return _to_host(rec[:hs, :ws]).numpy()


@profiling.entry
def roundtrip_gray(p: Pipeline, img, cfg: CodecConfig, device=None):
    """Core of :func:`roundtrip_gray_auto`: returns tensors (coeffs at the
    8-aligned shape, uint8 reconstruction cropped to (h, w))."""
    img = _tensor(img, device)
    h, w = tuple(img.shape)
    path = _resolve_path(p, img, cfg)
    x, _ = _pad_for(path, img)
    c, r = p.roundtrip_u8(x, cfg) if path == "u8" else p.roundtrip(x, cfg)
    return _crop8(c, h, w), r[:h, :w]


def roundtrip_gray_auto(p: Pipeline, img, cfg: CodecConfig, device=None):
    """Gray roundtrip through the fastest eligible path.  Returns (coeffs
    tensor at the 8-aligned shape, uint8 reconstruction cropped to (h, w)
    as a numpy array)."""
    c, r = roundtrip_gray(p, img, cfg, device)
    return c, _to_host(r).numpy()


# ---- stacked bulk dispatch -------------------------------------------------
#
# 8x8 blocks are independent and every kernel is block-local, so a set of
# same-width images is one taller image: a chunk costs one host-to-device
# copy, one launch and one copy back, bit-identically to the per-image path
# (image seams land on the row alignment, which is a multiple of 8).  The
# inputs are host arrays, padded and stacked on the host with the per-image
# helpers' own padding; each stacked chunk runs on :func:`default_device`.

# Cap on pixels per stacked launch: 2x the 8192^2 working set.
_STACK_MAX_PIXELS = 1 << 27


def _stack_groups(keys) -> dict:
    """Group item indices by stacking key, input order preserved."""
    groups: dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return groups


def _chunk(indices, sizes, max_pixels: int) -> list:
    out, cur, acc = [], [], 0
    for i in indices:
        if cur and acc + sizes[i] > max_pixels:
            out.append(cur)
            cur, acc = [], 0
        cur.append(i)
        acc += sizes[i]
    if cur:
        out.append(cur)
    return out


def _stacked(padded, device=None) -> torch.Tensor:
    """One tall map of same-width host tensors, on :func:`default_device`."""
    x = padded[0] if len(padded) == 1 else torch.cat(padded, dim=0)
    return _to_device(x, default_device(device))


def encode_gray_batch_auto(p: Pipeline, imgs, cfg: CodecConfig,
                           max_pixels: int = _STACK_MAX_PIXELS, device=None) -> list:
    """Bulk gray encode: one launch per same-width chunk.

    Takes a list of (H_i, W_i) host arrays; returns ``[(coeffs_np, (h, w)),
    ...]`` in input order, each bit-identical to :func:`encode_gray_auto`
    on that image alone.  Images group by (path, padded width, dtype)."""
    metas = []  # (path, padded, h, w)
    for img in imgs:
        x = torch.as_tensor(np.asarray(img))
        h, w = x.shape
        path = _resolve_path(p, x, cfg)
        metas.append((path, _pad_for(path, x)[0], h, w))
    keys = [(path, x.shape[1], x.dtype) for path, x, _, _ in metas]
    sizes = [x.numel() for _, x, _, _ in metas]
    results: list = [None] * len(imgs)
    for (path, _, _), indices in _stack_groups(keys).items():
        for chunk in _chunk(indices, sizes, max_pixels):
            stacked = _stacked([metas[i][1] for i in chunk], device)
            rows = [metas[i][1].shape[0] for i in chunk]
            c = p.encode_u8(stacked, cfg) if path == "u8" else p.encode(stacked, cfg)
            del stacked
            c = _to_host(c).numpy()  # one transfer for the whole chunk
            r0 = 0
            for i, nrows in zip(chunk, rows):
                _, _, h, w = metas[i]
                h8, w8 = padded_shape(h, w)
                results[i] = (c[r0 : r0 + h8, :w8].copy(), (h, w))
                r0 += nrows
    return results


def decode_gray_batch_auto(p: Pipeline, items, max_pixels: int = _STACK_MAX_PIXELS,
                           device=None) -> list:
    """Bulk gray decode: one launch per same-width, same-config chunk.

    Takes ``[(coeffs, cfg, (h, w)), ...]``; returns cropped uint8 numpy
    planes in input order, each bit-identical to :func:`decode_gray_auto`
    on that stream alone.  The config is part of the stacking key."""
    metas = []  # (path, padded, cfg, h, w)
    for coeffs, cfg, (h, w) in items:
        c = torch.as_tensor(np.asarray(coeffs))
        path = _decode_path(p, c, cfg)
        metas.append((path, _pad_coeffs_for(path, c), cfg, h, w))
    keys = [(path, x.shape[1], x.dtype, cfg) for path, x, cfg, _, _ in metas]
    sizes = [x.numel() for _, x, _, _, _ in metas]
    results: list = [None] * len(items)
    for (path, _, _, cfg), indices in _stack_groups(keys).items():
        for chunk in _chunk(indices, sizes, max_pixels):
            stacked = _stacked([metas[i][1] for i in chunk], device)
            shapes = [tuple(metas[i][1].shape) for i in chunk]
            r = _decode_padded(p, path, stacked, cfg)
            del stacked
            r = _to_host(r).numpy()
            r0 = 0
            for i, (ph, pw) in zip(chunk, shapes):
                _, _, _, h, w = metas[i]
                # clamp to this frame's slab, so an oversized orig_shape
                # never reads its neighbour
                results[i] = r[r0 : r0 + min(h, ph), : min(w, pw)].copy()
                r0 += ph
    return results


def decode_gray_scaled_batch_auto(p: Pipeline, items, m: int,
                                  max_pixels: int = _STACK_MAX_PIXELS, device=None) -> list:
    """Bulk M/8 fractional-scale decode: one launch per same-width,
    same-config chunk (the stacked twin of :func:`decode_gray_scaled_auto`).

    Takes ``[(coeffs, cfg, (h, w)), ...]``; returns cropped uint8 numpy
    planes in input order, each bit-identical to the per-stream helper.
    Integer 8/M factors stack through the fused scaled kernel (windows are
    f rows tall and frame slabs are 8f-row aligned), other numerators
    through the area-resample einsum; streams failing the u8 gate decode
    one by one."""
    from tpudct_torch.ops.scaled import scaled_decode_m8, scaled_decode_u8, scaled_shape_m8

    if m == 8:
        return decode_gray_batch_auto(p, items, max_pixels, device)
    results: list = [None] * len(items)
    metas = []  # (idx, padded, cfg, h, w, kind) kind in {"u8", "m8"}
    fac = None if 8 % m else 8 // m
    for i, (coeffs, cfg, (h, w)) in enumerate(items):
        c = torch.as_tensor(np.asarray(coeffs))
        if fac is None:
            # fractional numerator: blockwise einsum, stack-safe at the
            # 8-aligned seams every stream already has
            metas.append((i, c, cfg, h, w, "m8"))
            continue
        align = _scaled_u8_align(p, c, cfg, fac)
        if align is not None:
            metas.append((i, pad_coeffs_to_kernel(_cast(c, torch.int8), *align)[0], cfg, h, w, "u8"))
        else:
            results[i] = decode_gray_scaled_auto(p, _to_device(c, default_device(device)), cfg, (h, w), m)
    keys = [(kind, x.shape[1], x.dtype, cfg) for _, x, cfg, _, _, kind in metas]
    sizes = [x.numel() for _, x, _, _, _, _ in metas]
    for (kind, _, _, cfg), indices in _stack_groups(keys).items():
        for chunk in _chunk(indices, sizes, max_pixels):
            stacked = _stacked([metas[j][1] for j in chunk], device)
            shapes = [tuple(metas[j][1].shape) for j in chunk]
            if kind == "u8":
                rec = scaled_decode_u8(p, stacked, cfg, fac, out_u8=True)
            else:
                rec = to_uint8(scaled_decode_m8(stacked, cfg, m))
            del stacked
            r = _to_host(rec).numpy()
            r0 = 0
            for j, (xh, xw) in zip(chunk, shapes):
                i, _, _, h, w, _ = metas[j]
                slab, ws_max = (xh // fac, xw // fac) if kind == "u8" else (xh // 8 * m, xw // 8 * m)
                hs, ws = scaled_shape_m8(h, m), scaled_shape_m8(w, m)
                # clamp to the frame's scaled slab (see the full decode)
                results[i] = r[r0 : r0 + min(hs, slab), : min(ws, ws_max)].copy()
                r0 += slab
    return results
