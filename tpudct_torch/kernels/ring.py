"""Ring hop kernels: the counterpart of the three ``pl.pallas_call``s of
``tpudct/parallel/ring.py``.

Three wrappers over hand-written CUDA kernels, each handling one slot (one
band's rows) on one rank, with a plain torch twin here computing the same
values.  B14 and B16 are in ``tpudct_torch/csrc/ring.cu`` (see its header for
the design); B15 is ``hp_decode_u8``'s kernel (B3, ``csrc/hp_codec.cu``)
given a forward pointer, so the ring decodes with B3's very code:

  ring_forward               copy a slot to the next rank's replica        (B14)
  ring_forward_decode        forward an int8 slot and decode it to u8      (B15)
  ring_forward_decode_color  forward a luma slot and its chroma pack slot,
                             decode both and merge them to RGB (4:2:0)     (B16)

``tpudct_torch.parallel.ring`` runs the ring schedule over these.  Unlike
the other wrappers, the source and the forward destination may lie on two
cards (a peer pointer); the kernel runs on the source's card, in its
current stream, and writes into preallocated outputs.  A wrapper given CPU
tensors runs the twin; given CUDA tensors it launches the kernel or raises,
and counts the launch in ``LAUNCHES``.  B15 and B16 decode with the
butterfly tier (the reference's rings do, whatever ``decode_precision``),
with tables from ``kernels.hp``'s ``kernel_constants``, so they raise for a
transform without an integer core as ``hp_decode_u8`` does; both run the
add-only inverse compiled for the transform's integer core (B15 B3's
instance, B16 the strip body's, ``kernels.strip420``), and the wrappers
check that the core's compiled table is the transform's Ts
(``kernels.cores``).
"""

from __future__ import annotations

import torch

from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels._build import call
from tpudct_torch.kernels import hp
from tpudct_torch.kernels import strip420

#: Kernel launches per wrapper; a wrapper adds one only where it launches its
#: CUDA kernel (never for the CPU twin).
LAUNCHES = {"ring_forward": 0, "ring_forward_decode": 0, "ring_forward_decode_color": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _packed(transform: str, q_table: str, q_scale: float):
    """The 320 f32 decode constants (butterfly tier) the kernels read as HpConsts."""
    return hp._args(transform, q_table, q_scale, None, "butterfly", False).packed


# ---------------------------------------------------------------------------
# Plain torch twins
# ---------------------------------------------------------------------------


def forward_plain(src: torch.Tensor, dst: torch.Tensor) -> None:
    dst.copy_(src)


def forward_decode_plain(coef, fwd, rec, q_scale=1.0, q_table="luma", transform="haweel") -> None:
    if fwd is not None:
        fwd.copy_(coef)
    rec.copy_(hp.decode_u8_plain(coef, q_scale, q_table, "butterfly", transform))


def forward_decode_color_plain(y, c, fy, fc, rgb, q_scale=1.0, transform="haweel") -> None:
    if fy is not None:
        fy.copy_(y)
        fc.copy_(c)
    yu = hp.decode_u8_plain(y, q_scale, "luma", "butterfly", transform)
    cu = hp.decode_u8_plain(c, q_scale, "chroma", "butterfly", transform)
    half = y.shape[0] // 2
    rgb.copy_(ck.merge_plain(yu, cu[:half], cu[half:], "420"))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(x, dtype, shape, name: str, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: {what} must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must be {dtype} {tuple(shape)}, got {x.dtype} {tuple(x.shape)}")


def _on_cuda(name: str, src: torch.Tensor, *others) -> bool:
    """True for CUDA operands (the kernel), False for CPU ones (the twin);
    all operands lie on the same kind of device."""
    for t in (src, *others):
        if t is not None and t.device.type != src.device.type:
            raise ValueError(f"{name}: operands on {src.device} and {t.device}")
        if t is not None and t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} runs on cpu or cuda tensors, got {t.device}")
    return src.device.type == "cuda"


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def ring_forward(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy ``src`` into ``dst``: same shape and dtype, both contiguous;
    ``dst`` may lie on another card (B14)."""
    _check(dst, src.dtype, src.shape, "ring_forward", "dst")
    if not _on_cuda("ring_forward", src, dst):
        return forward_plain(src, dst)
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("ring_forward needs contiguous tensors")
    call("ring_forward_launch", src.device, src.data_ptr(), dst.data_ptr(),
            src.numel() * src.element_size())
    LAUNCHES["ring_forward"] += 1


def ring_forward_decode(coef, fwd, rec, q_scale: float = 1.0, q_table: str = "luma",
                        transform: str = "haweel") -> None:
    """int8 (h, w) slot -> ``rec`` (u8, same shape, same device), copying
    the slot into ``fwd`` first unless it is None (B15).  Bit-identical to
    ``hp_decode_u8`` with the butterfly tier."""
    h, w = hp._check(coef, torch.int8, "ring_forward_decode")
    _check(rec, torch.uint8, (h, w), "ring_forward_decode", "rec")
    if fwd is not None:
        _check(fwd, torch.int8, (h, w), "ring_forward_decode", "fwd")
    inv = hp._core_of(transform, q_table, q_scale, None, "butterfly", False)[1]
    if not _on_cuda("ring_forward_decode", coef, fwd, rec):
        return forward_decode_plain(coef, fwd, rec, q_scale, q_table, transform)
    if rec.device != coef.device:
        raise ValueError("ring_forward_decode: rec must lie on the slot's card")
    for t in (fwd, rec):
        if t is not None:
            hp.check_placement(t, "ring_forward_decode")
    consts = _packed(transform, q_table, q_scale)
    call("hp_decode_u8_launch", coef.device, coef.data_ptr(), rec.data_ptr(), h, w, _ptr(fwd), inv,
         consts.ctypes.data)
    LAUNCHES["ring_forward_decode"] += 1


def ring_forward_decode_color(y, c, fy, fc, rgb, q_scale: float = 1.0,
                              transform: str = "haweel") -> None:
    """int8 luma slot (h, w) and chroma pack slot (h, w/2) (cb rows over cr
    rows) -> ``rgb`` (3, h, w) u8, whose rows and columns are contiguous
    and whose planes may be any stride apart (a slot of a (3, H, W) image);
    copies the two slots into ``fy``/``fc`` first unless they are None
    (B16).  Bit-identical to ``decode_color_u8``'s chain: ``hp_decode_u8``
    of each plane, ``color_merge_420_u8``."""
    name = "ring_forward_decode_color"
    h, w = hp._check(y, torch.int8, name)
    if h % 16 or w % 256:
        raise ValueError(f"{name} needs h % 16 == 0 and w % 256 == 0, got {h}x{w}")
    _check(c, torch.int8, (h, w // 2), name, "the chroma pack")
    _check(rgb, torch.uint8, (3, h, w), name, "rgb")
    if (fy is None) != (fc is None):
        raise ValueError(f"{name}: forward both planes or neither")
    if fy is not None:
        _check(fy, torch.int8, (h, w), name, "fy")
        _check(fc, torch.int8, (h, w // 2), name, "fc")
    core, consts = strip420.strip_args(transform, q_scale)
    if not _on_cuda(name, y, c, fy, fc, rgb):
        return forward_decode_color_plain(y, c, fy, fc, rgb, q_scale, transform)
    if c.device != y.device or rgb.device != y.device:
        raise ValueError(f"{name}: the pack and rgb must lie on the slot's card")
    for t in (c, fy, fc):
        if t is not None:
            hp.check_placement(t, name)
    if rgb.stride()[1:] != (w, 1) or rgb.data_ptr() % 16:
        raise ValueError(f"{name}: rgb needs contiguous rows and a 16-byte aligned start")
    call("ring_forward_decode_color_launch", y.device, y.data_ptr(), c.data_ptr(), _ptr(fy), _ptr(fc),
         rgb.data_ptr(), rgb.stride(0), h, w, core, consts.ctypes.data)
    LAUNCHES["ring_forward_decode_color"] += 1
