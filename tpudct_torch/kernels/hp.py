"""hp codec kernels: the counterpart of ``tpudct/kernels/hp_pallas.py``.

Seven wrappers, each over hand-written CUDA kernels in
``tpudct_torch/csrc/hp_codec.cu`` (B7: ``csrc/hp_inverse.cu``; see their
headers for the value chains and the design), each with a plain torch twin
in this module that computes the same values in the same order:

  hp_roundtrip_u8      u8 (H, W) -> int8 coefficients + u8 reconstruction  (B1)
  hp_encode_u8         u8 (H, W) -> int8 coefficients                       (B2)
  hp_decode_u8         int8 (H, W) -> u8 reconstruction                     (B3)
  hp_roundtrip         f32 (H, W) -> f32 coefficients + f32 reconstruction  (B4
                       on the integer core, B4' on the f32-literal core)
  hp_dct               f32 (H, W) -> f32 quantized coefficients             (B5)
  hp_idct              f32 coefficients -> f32 reconstruction (+128)        (B6)
  hp_scaled_decode_u8  int8 (H, W) -> (H/fr, W/fc) box averages, f32 or u8  (B7)

A wrapper given a CPU tensor runs the twin; given a CUDA tensor it launches
the kernel or raises, and counts the launch in ``LAUNCHES``.  The kernels
need h % 8 == 0 and w % 8 == 0 only; ``supports``/``supports_u8``/
``supports_scaled_u8`` keep the reference's gates (lane 128, u8 rows 32, the
int8-fit bound) so dispatch takes the same path and the same padding in
both packages.

The codec's only parameters are 8x8 tables (``kernel_constants``), computed
in f64 and cast once to f32 exactly as the reference's ``_consts_int``/
``_consts_bf``/``_consts_f32`` compute them, so every transform, every
quantization table and ``retain_k`` ride the same kernels.  The literal
tables (T, Q q_scale, the zonal mask) exist for every transform; the
integer-core tables (Ts, the folded scale, the butterfly dequantization)
only where the transform has an integer core.  B1, B2, B3 (and the ring's
B15) and B7 run an add-only chain with Ts compiled in, one instance per
integer core: their wrappers pass the core's id (``kernels.cores``, checked
against the packed Ts), and for the inverse of B1 and B3 the dense
instance's on the "highest"/"high" tiers (B7 runs the butterfly tier
only).  B2 is B1's encode half: the u8 encode exists only for a transform
with an integer core (``supports_u8``).

``decode_precision="high"`` is the reference's bf16x3 inverse, which exists
because the TPU's matrix unit has no f32 path; here it runs the f32
"highest" body (within 2e-3 of the reference's "high" in f32, see
tests/test_torch_hp.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpudct_torch.constants import LEVEL_SHIFT, get_q_table, get_transform
from tpudct_torch.kernels import cores
from tpudct_torch.ops.blocks import as_block_grid, from_block_grid
from tpudct_torch.ops.quant import retention_mask
from tpudct_torch.ops.transform import to_uint8

LANE = 128

#: Kernel launches per wrapper (hp_roundtrip counts B4' apart from B4); a
#: wrapper adds one only where it launches its CUDA kernel (never for the
#: CPU twin).
LAUNCHES = {
    "hp_roundtrip_u8": 0, "hp_encode_u8": 0, "hp_decode_u8": 0, "hp_roundtrip": 0,
    "hp_roundtrip_f32core": 0, "hp_dct": 0, "hp_idct": 0, "hp_scaled_decode_u8": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Gates (same decisions as the reference)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _max_coeff(transform: str = "haweel", q_table: str = "luma") -> float:
    """Max |quantized coefficient| at q_scale=1: max_il sum|T_i| sum|T_l|
    128 / Q_il (~97.2 for haweel/luma); inf without an integer core."""
    tr = get_transform(transform)
    if not tr.has_integer_core:
        return float("inf")
    row_abs = np.abs(tr.ts.astype(np.float64)).sum(axis=1) * tr.d
    return float((np.outer(row_abs, row_abs) * 128.0 / get_q_table(q_table)).max())


def supports(h: int, w: int) -> bool:
    """The reference's f32-kernel gate (rows by 8, lanes by 128)."""
    return h % 8 == 0 and w % LANE == 0 and h >= 8 and w >= LANE


def supports_u8(h: int, w: int, q_scale: float = 1.0, transform: str = "haweel",
                q_table: str = "luma") -> bool:
    """The reference's u8-kernel gate: rows by 32, lanes by 128, an integer
    core, and coefficients that fit int8."""
    return (
        h % 32 == 0
        and w % LANE == 0
        and _max_coeff(transform, q_table) / q_scale <= 127.0
    )


def scaled_pad_align(fr: int, fc: int) -> tuple:
    """(row, lane) padding multiples that make any coefficient map satisfy
    :func:`supports_scaled_u8` at factors (fr, fc)."""
    return max(32, 8 * fr), LANE * fc


def supports_scaled_u8(h: int, w: int, fr: int, fc: int, q_scale: float = 1.0,
                       transform: str = "haweel", q_table: str = "luma") -> bool:
    """The reference's gate for the fused scaled decode: the u8 decode
    geometry, lane groups of 128 fc and 8-row output tiles."""
    return (
        supports_u8(h, w, q_scale, transform, q_table)
        and fr in (1, 2, 4, 8)
        and fc in (1, 2, 4, 8)
        and w % (LANE * fc) == 0
        and (h // fr) % 8 == 0
    )


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------


class HpConstants(NamedTuple):
    """The codec's parameters, 8x8 each.  Integer core (None for a
    transform without one): ``ts`` (int8); the forward scale d_i d_l /
    (Q q_scale) times the zonal mask; the butterfly dequantization ``qdd``
    = Q q_scale d_i d_l.  Literal, for every transform: ``t``; ``q`` = Q
    q_scale (the f32-literal divisor and the "highest" dequantization);
    the zonal ``mask``."""

    ts: Optional[np.ndarray]
    scale: Optional[np.ndarray]
    qdd: Optional[np.ndarray]
    t: np.ndarray
    q: np.ndarray
    mask: np.ndarray


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=64)
def kernel_constants(transform: str = "haweel", q_table: str = "luma",
                     q_scale: float = 1.0, retain_k=None) -> HpConstants:
    tr = get_transform(transform)
    qt = get_q_table(q_table)
    mask = retention_mask(retain_k)
    ts = scale = qdd = None
    if tr.has_integer_core:
        d = tr.d.astype(np.float64)
        ts = _frozen(tr.ts.astype(np.int8))
        scale = _frozen((np.outer(d, d) / (qt * np.float32(q_scale)) * mask).astype(np.float32))
        qdd = _frozen((qt.astype(np.float64) * float(q_scale) * np.outer(d, d)).astype(np.float32))
    return HpConstants(
        ts=ts, scale=scale, qdd=qdd,
        t=_frozen(np.array(tr.t, np.float32)),
        q=_frozen((qt * np.float32(q_scale)).astype(np.float32)),
        mask=_frozen(mask.astype(np.float32)),
    )


def _precision(name: str) -> str:
    """The inverse tier the kernels run: "high" (the reference's bf16x3
    product) runs the f32 "highest" body."""
    if name not in ("highest", "high", "butterfly"):
        raise ValueError(
            "decode_precision must be 'highest', 'high' or 'butterfly', "
            f"got {name!r}"
        )
    return "highest" if name == "high" else name


class _Args(NamedTuple):
    """One launch's tables: forward (fwd, fq, mask), inverse (a, s), and
    the same five packed as the 320 f32 the CUDA side reads as HpConsts."""

    fwd: np.ndarray
    fq: np.ndarray
    mask: np.ndarray
    a: np.ndarray
    s: np.ndarray
    packed: np.ndarray


@functools.lru_cache(maxsize=64)
def _args(transform, q_table, q_scale, retain_k, decode_precision, int_core) -> _Args:
    """Tables for one launch.  ``int_core`` picks the forward: the integer
    core (Ts, the folded scale, no mask) or the f32-literal core (T, the
    divisor Q q_scale, the mask after rounding).  Decode-only wrappers pass
    False: their kernels read no forward table, and the literal ones exist
    for every transform."""
    k = kernel_constants(transform, q_table, q_scale, retain_k)
    if int_core:
        if k.ts is None:
            raise ValueError(f"int core requested but {transform!r} has none")
        fwd, fq, mask = _frozen(k.ts.astype(np.float32)), k.scale, np.ones((8, 8), np.float32)
    else:
        fwd, fq, mask = k.t, k.q, k.mask
    if _precision(decode_precision) == "butterfly":
        if k.ts is None:
            raise ValueError(f"butterfly decode needs an integer core; {transform!r} has none")
        a, s = k.ts.astype(np.float32), k.qdd
    else:
        a, s = k.t, k.q
    packed = np.concatenate([m.ravel() for m in (fwd, fq, mask, a, s)]).astype(np.float32)
    return _Args(fwd, fq, _frozen(mask), _frozen(a), s, _frozen(packed))


@functools.lru_cache(maxsize=64)
def _core_of(transform, q_table, q_scale, retain_k, decode_precision, int_core) -> tuple:
    """The launchers' ids ``(core, inv)``: ``core``, the forward of B1 and
    B2 (with ``int_core``; else None), is the id of the integer core compiled for
    ``transform`` (``kernels.cores``); ``inv``, the inverse of B1, B3/B15
    and B7, is that core's id on the butterfly tier and ``cores.DENSE``
    (the dense f32 inverse) on the "highest"/"high" tiers.  Raises where a
    table the add-only chain would read is not the compiled one."""
    k = _args(transform, q_table, q_scale, retain_k, decode_precision, int_core)
    kernel = "the add-only u8 codec"
    core = cores.core_id(transform, k.fwd, kernel=kernel) if int_core else None
    if _precision(decode_precision) != "butterfly":
        return core, cores.DENSE
    return core, cores.core_id(transform, k.a, kernel=kernel)


# ---------------------------------------------------------------------------
# Plain torch twins: the kernels' value chain, the same sums in the same order
# ---------------------------------------------------------------------------


def _left(w: np.ndarray, g: torch.Tensor) -> torch.Tensor:
    """out[:, i, :, c] = sum_k w[i, k] * g[:, k, :, c], summed k = 0..7."""
    rows = []
    for i in range(8):
        acc = g[:, 0] * w[i, 0].item()
        for k in range(1, 8):
            acc = acc + g[:, k] * w[i, k].item()
        rows.append(acc)
    return torch.stack(rows, dim=1)


def _right(w: np.ndarray, g: torch.Tensor) -> torch.Tensor:
    """out[..., j] = sum_l g[..., l] * w[l, j], summed l = 0..7."""
    cols = []
    for j in range(8):
        acc = g[..., 0] * w[0, j].item()
        for l in range(1, 8):
            acc = acc + g[..., l] * w[l, j].item()
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def _grid8(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(m, device=like.device).reshape(1, 8, 1, 8)


def _round_away(z: torch.Tensor) -> torch.Tensor:
    """trunc(fl(z + copysign(0.5, z))): the reference's round half away."""
    return (z + torch.copysign(torch.full_like(z, 0.5), z)).trunc()


def _fwd_plain(x_int: torch.Tensor, k: _Args) -> torch.Tensor:
    """Level-shifted int32 pixel grid -> quantized coefficients (f32 grid).

    Ts X Ts^T in int32 is exact; then the rounded f32 scale multiply and
    the rounded tie-add, then truncation (round half away from zero)."""
    ts = k.fwd.astype(np.int32)
    core = _right(ts.T, _left(ts, x_int))
    return _round_away(core.to(torch.float32) * _grid8(k.fq, core))


def _fwd_literal_plain(x: torch.Tensor, k: _Args) -> torch.Tensor:
    """f32 pixel grid -> quantized, masked coefficients on the literal T:
    (X - 128), T X rows then columns, true division, round, mask."""
    z = _right(np.ascontiguousarray(k.fwd.T), _left(k.fwd, x - LEVEL_SHIFT))
    return _round_away(z / _grid8(k.fq, z)) * _grid8(k.mask, z)


def _inv_plain(c: torch.Tensor, k: _Args) -> torch.Tensor:
    """Coefficient grid -> reconstruction + 128 (f32 grid), A^T (c * S) A."""
    m = c.to(torch.float32) * _grid8(k.s, c)
    return _right(k.a, _left(np.ascontiguousarray(k.a.T), m)) + LEVEL_SHIFT


def _shift_u8(image_u8: torch.Tensor) -> torch.Tensor:
    return as_block_grid(image_u8).to(torch.int32) - 128


def _shift_f32(image: torch.Tensor) -> torch.Tensor:
    """(x.astype(int32) - 128).astype(int8): the integer core's input."""
    return (as_block_grid(image).to(torch.int32) - 128).to(torch.int8).to(torch.int32)


def _fwd_f32_plain(image: torch.Tensor, k: _Args, int_core: bool) -> torch.Tensor:
    if int_core:
        return _fwd_plain(_shift_f32(image), k)
    return _fwd_literal_plain(as_block_grid(image), k)


def roundtrip_u8_plain(image_u8, q_scale=1.0, q_table="luma", retain_k=None,
                       decode_precision="butterfly", transform="haweel"):
    k = _args(transform, q_table, q_scale, retain_k, decode_precision, True)
    c = _fwd_plain(_shift_u8(image_u8), k)
    return from_block_grid(c.to(torch.int8)), from_block_grid(to_uint8(_inv_plain(c, k)))


def encode_u8_plain(image_u8, q_scale=1.0, q_table="luma", retain_k=None, transform="haweel"):
    k = _args(transform, q_table, q_scale, retain_k, "butterfly", True)
    return from_block_grid(_fwd_plain(_shift_u8(image_u8), k).to(torch.int8))


def decode_u8_plain(coeffs_i8, q_scale=1.0, q_table="luma", decode_precision="butterfly",
                    transform="haweel"):
    k = _args(transform, q_table, q_scale, None, decode_precision, False)
    return from_block_grid(to_uint8(_inv_plain(as_block_grid(coeffs_i8), k)))


def roundtrip_plain(image, q_scale=1.0, q_table="luma", retain_k=None,
                    decode_precision="butterfly", transform="haweel", int_core=True):
    k = _args(transform, q_table, q_scale, retain_k, decode_precision, int_core)
    c = _fwd_f32_plain(image, k, int_core)
    return from_block_grid(c), from_block_grid(_inv_plain(c, k))


def dct_plain(image, q_scale=1.0, q_table="luma", transform="haweel", int_core=True):
    k = _args(transform, q_table, q_scale, None, "highest", int_core)
    return from_block_grid(_fwd_f32_plain(image, k, int_core))


def idct_plain(coeffs, q_scale=1.0, q_table="luma", decode_precision="butterfly",
               transform="haweel"):
    k = _args(transform, q_table, q_scale, None, decode_precision, False)
    return from_block_grid(_inv_plain(as_block_grid(coeffs), k))


def scaled_decode_u8_plain(coeffs_i8, fr, fc, q_scale=1.0, q_table="luma",
                           transform="haweel", out_u8=False):
    """Box sums of the clamped, truncated butterfly decode (exact integers,
    any order), times the power of two 1/(fr fc)."""
    k = _args(transform, q_table, q_scale, None, "butterfly", False)
    x = _inv_plain(as_block_grid(coeffs_i8), k).trunc().clamp(0.0, 255.0)
    h, w = coeffs_i8.shape
    avg = from_block_grid(x).reshape(h // fr, fr, w // fc, fc).sum(dim=(1, 3)) * (1.0 / (fr * fc))
    return to_uint8(avg) if out_u8 else avg


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(x, dtype: torch.dtype, name: str) -> tuple:
    """Validate a kernel operand; returns (h, w).  True for both devices,
    so the CPU twin refuses exactly what the kernel refuses."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} takes a torch.Tensor, got {type(x).__name__}")
    if x.dim() != 2:
        raise ValueError(f"{name} takes a 2-D (H, W) tensor, got shape {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} takes {dtype}, got {x.dtype}")
    h, w = x.shape
    if h == 0 or w == 0 or h % 8 or w % 8:
        raise ValueError(f"{name} needs h % 8 == 0 and w % 8 == 0, got {h}x{w}")
    check_placement(x, name)
    return h, w


def check_placement(x: torch.Tensor, name: str) -> None:
    """A kernel operand lies on the CPU (the twin) or on a CUDA card, and
    there contiguous and 16-byte aligned (the kernels' vector accesses)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {x.device}")
    if x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError(f"{name} needs a contiguous tensor")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} needs a 16-byte aligned tensor")


def launch(fn_name: str, tensors, h: int, w: int, consts: np.ndarray, *ints: int) -> None:
    """Call ``fn_name(*pointers, h, w, *ints, consts, stream, device)``, where
    ``consts`` is the packed f32 constant array the kernel reads."""
    from tpudct_torch.kernels._build import call

    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{fn_name}: operands on more than one device")
    call(fn_name, dev, *[t.data_ptr() for t in tensors], h, w, *ints, consts.ctypes.data)


def hp_roundtrip_u8(image_u8, q_scale: float = 1.0, q_table: str = "luma", retain_k=None,
                    decode_precision: str = "butterfly", transform: str = "haweel"):
    """Fused u8 codec pass: uint8 (H, W) -> (int8 coefficients, uint8 recon)."""
    h, w = _check(image_u8, torch.uint8, "hp_roundtrip_u8")
    core, inv = _core_of(transform, q_table, q_scale, retain_k, decode_precision, True)
    if image_u8.device.type == "cpu":
        return roundtrip_u8_plain(image_u8, q_scale, q_table, retain_k, decode_precision, transform)
    k = _args(transform, q_table, q_scale, retain_k, decode_precision, True)
    c = torch.empty((h, w), dtype=torch.int8, device=image_u8.device)
    r = torch.empty((h, w), dtype=torch.uint8, device=image_u8.device)
    launch("hp_rt_u8_launch", (image_u8, c, r), h, w, k.packed, core, inv)
    LAUNCHES["hp_roundtrip_u8"] += 1
    return c, r


def hp_encode_u8(image_u8, q_scale: float = 1.0, q_table: str = "luma", retain_k=None,
                 transform: str = "haweel"):
    """uint8 (H, W) image -> int8 quantized coefficients: B1's encode half."""
    h, w = _check(image_u8, torch.uint8, "hp_encode_u8")
    core = _core_of(transform, q_table, q_scale, retain_k, "butterfly", True)[0]
    if image_u8.device.type == "cpu":
        return encode_u8_plain(image_u8, q_scale, q_table, retain_k, transform)
    k = _args(transform, q_table, q_scale, retain_k, "butterfly", True)
    c = torch.empty((h, w), dtype=torch.int8, device=image_u8.device)
    launch("hp_encode_u8_launch", (image_u8, c), h, w, k.packed, core)
    LAUNCHES["hp_encode_u8"] += 1
    return c


def hp_decode_u8(coeffs_i8, q_scale: float = 1.0, q_table: str = "luma",
                 decode_precision: str = "butterfly", transform: str = "haweel"):
    """int8 (H, W) coefficients -> uint8 reconstruction (dequant, inverse,
    +128, truncation and clamp in one pass)."""
    h, w = _check(coeffs_i8, torch.int8, "hp_decode_u8")
    inv = _core_of(transform, q_table, q_scale, None, decode_precision, False)[1]
    if coeffs_i8.device.type == "cpu":
        return decode_u8_plain(coeffs_i8, q_scale, q_table, decode_precision, transform)
    k = _args(transform, q_table, q_scale, None, decode_precision, False)
    r = torch.empty((h, w), dtype=torch.uint8, device=coeffs_i8.device)
    launch("hp_decode_u8_launch", (coeffs_i8, r), h, w, k.packed, None, inv)  # no forward (B15 has one)
    LAUNCHES["hp_decode_u8"] += 1
    return r


def hp_roundtrip(image, q_scale: float = 1.0, q_table: str = "luma", retain_k=None,
                 decode_precision: str = "butterfly", transform: str = "haweel",
                 int_core: bool = True):
    """Fused codec pass: f32 (H, W) image -> (f32 coefficients, f32
    reconstruction).  ``int_core`` runs the exact integer core on integral
    pixel values, with ``retain_k`` riding the quantization scale (B4);
    False runs the f32-literal core, with ``retain_k`` as a mask after
    rounding (B4')."""
    h, w = _check(image, torch.float32, "hp_roundtrip")
    if image.device.type == "cpu":
        return roundtrip_plain(image, q_scale, q_table, retain_k, decode_precision, transform,
                               int_core)
    k = _args(transform, q_table, q_scale, retain_k, decode_precision, int_core)
    c = torch.empty((h, w), dtype=torch.float32, device=image.device)
    r = torch.empty((h, w), dtype=torch.float32, device=image.device)
    launch("hp_rt_f32_launch", (image, c, r), h, w, k.packed, int(not int_core))
    LAUNCHES["hp_roundtrip" if int_core else "hp_roundtrip_f32core"] += 1
    return c, r


def hp_dct(image, q_scale: float = 1.0, q_table: str = "luma", transform: str = "haweel",
           int_core: bool = True):
    """f32 (H, W) image -> f32 quantized coefficients.  ``int_core`` runs
    the exact integer core (integral pixel values); False the f32-literal
    core (any values, every transform).  No ``retain_k``, as in the
    reference: ``Pipeline.encode`` applies it."""
    h, w = _check(image, torch.float32, "hp_dct")
    if image.device.type == "cpu":
        return dct_plain(image, q_scale, q_table, transform, int_core)
    k = _args(transform, q_table, q_scale, None, "highest", int_core)
    c = torch.empty((h, w), dtype=torch.float32, device=image.device)
    launch("hp_dct_launch", (image, c), h, w, k.packed, int(not int_core))
    LAUNCHES["hp_dct"] += 1
    return c


def hp_idct(coeffs, q_scale: float = 1.0, q_table: str = "luma",
            decode_precision: str = "butterfly", transform: str = "haweel"):
    """f32 (H, W) quantized coefficients -> f32 reconstruction (+128, no
    clamp)."""
    h, w = _check(coeffs, torch.float32, "hp_idct")
    if coeffs.device.type == "cpu":
        return idct_plain(coeffs, q_scale, q_table, decode_precision, transform)
    k = _args(transform, q_table, q_scale, None, decode_precision, False)
    r = torch.empty((h, w), dtype=torch.float32, device=coeffs.device)
    launch("hp_idct_launch", (coeffs, r), h, w, k.packed)
    LAUNCHES["hp_idct"] += 1
    return r


def hp_scaled_decode_u8(coeffs_i8, fr: int, fc: int, q_scale: float = 1.0,
                        q_table: str = "luma", transform: str = "haweel", out_u8: bool = False):
    """int8 (H, W) coefficients -> (H/fr, W/fc) box averages of the
    clamped, truncated butterfly decode in one pass: f32, or uint8
    (truncated) with ``out_u8``.  Bit-identical to
    ``box_pool_u8(hp_decode_u8(c), fr, fc)``."""
    h, w = _check(coeffs_i8, torch.int8, "hp_scaled_decode_u8")
    if fr not in (1, 2, 4, 8) or fc not in (1, 2, 4, 8):
        raise ValueError(f"hp_scaled_decode_u8 factors must be in (1, 2, 4, 8), got ({fr}, {fc})")
    inv = _core_of(transform, q_table, q_scale, None, "butterfly", False)[1]
    if coeffs_i8.device.type == "cpu":
        return scaled_decode_u8_plain(coeffs_i8, fr, fc, q_scale, q_table, transform, out_u8)
    k = _args(transform, q_table, q_scale, None, "butterfly", False)
    out = torch.empty((h // fr, w // fc), dtype=torch.uint8 if out_u8 else torch.float32,
                      device=coeffs_i8.device)
    launch("hp_scaled_decode_u8_launch", (coeffs_i8, out), h, w, k.packed, fr, fc, int(out_u8), inv)
    LAUNCHES["hp_scaled_decode_u8"] += 1
    return out
