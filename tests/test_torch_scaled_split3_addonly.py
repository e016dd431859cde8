"""B7 (k_scaled_decode_u8<core>) and B22 (k_idct_split3), both in
tpudct_torch/csrc/hp_inverse.cu on hp_block.cuh's add-only inverse, on the
CPU.

The CUDA kernels cannot run here, so these tests emulate them in numpy
float32, step for step as the kernels write them, and hold the emulation
bit for bit against the unchanged twins (kernels.hp.scaled_decode_u8_plain,
kernels.variants.idct_c_plain), and the twins, at one shape each, against
the reference's Pallas kernels in interpret mode:
- B7: the int8 rows as exact f32 by bit patterns, the dequantization, the
  add-only inverse (inv_core), floor_2p23's bit patterns 0x4B000000 + v,
  each window's patterns summed as uint32 (wrapping) from 0 - FR FC
  0x4B000000, then the u8 output as the sum shifted right by log2(FR FC)
  and the f32 output as (the float with bits 0x4B000000 | sum) - 2^23,
  times 1 / (FR FC); every integer core and cb2011, luma and chroma, q_scale
  1 and 2.5, all 16 (fr, fc), both outputs, on uniform int8 noise whose
  decode reaches both clamps;
- the bf16 rounding of B22's digit split (__float2bfloat16_rn: round to
  nearest, ties to even), against torch's .to(torch.bfloat16) on every f32
  within 4 ulps of each bf16 tie over every exponent, subnormals, +-0 and
  values rounding into the next binade;
- B22: M = c S, then down each column in place, per bf16 digit, the sums
  of Ts's nonzero terms in the dense k order (inv_dot), the digit sums
  added (s1 + s2) + s3, then the same along each row, + 128; on hp_dct's
  coefficients, on normal(0, 300) maps with zeros and -0.0, and on a
  wide-range map (2^-149 to 2^100).
The card runs the kernels against their twins (chip_smoke.py phase 4).

Tolerances: bit-identical everywhere, except against the reference:
idct_x "c" within B6's class (2^-14, the f32 inverse's class against the
reference, tests/test_torch_variants.py); the scaled decode +-1 on at most
1e-4 of the decoded pixels (the reference's butterfly sums its bf16 splits
on the MXU, tests/test_torch_scaled.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_hp_addonly import (F32, TWO23, _add_rd_2p23, _from_blocks, _i8_map, _inv_core, _inv_dot,
                                         _minus_128, _near, _to_blocks)
from tests.test_torch_studies import _load
from tpudct.kernels import hp_pallas as R
from tpudct_torch.benchmark import synthetic_image
from tpudct_torch.constants import get_transform
from tpudct_torch.kernels import cores
from tpudct_torch.kernels import hp
from tpudct_torch.kernels import variants as V

_TRANSFORMS = cores.CORES + ("cb2011",)
_FACTORS = (1, 2, 4, 8)
B6_CLASS = 2.0 ** -14  # the f32 inverse's class against the reference (ROADMAP C)

# ---------------------------------------------------------------------------
# B7
# ---------------------------------------------------------------------------


def _floor_bits(x: np.ndarray) -> np.ndarray:
    """floor_2p23's bit patterns: 0x4B000000 + min(max(trunc(x), 0), 255)."""
    return _add_rd_2p23(np.minimum(np.maximum(x, F32(0)), F32(255))).view(np.uint32)


def _decode_bits(coef: np.ndarray, transform, q_table, q_scale) -> np.ndarray:
    """k_scaled_decode_u8 up to its floors: (n, 8, 8) bit patterns."""
    k = hp._args(transform, q_table, q_scale, None, "butterfly", False)
    ts = cores.source_tables()[get_transform(transform).name]
    c = _minus_128(_to_blocks(coef.view(np.uint8)) ^ np.uint8(0x80))
    return _floor_bits(_inv_core((c * k.s).astype(F32), ts))


def _windows(bits: np.ndarray, h: int, w: int, fr: int, fc: int, out_u8: bool) -> np.ndarray:
    """store_windows: each window's bit patterns summed as uint32 from 0 -
    FR FC 0x4B000000, then the u8 or the f32 output, in the (h / fr, w /
    fc) layout."""
    n, orr, oc = bits.shape[0], 8 // fr, 8 // fc
    win = bits.astype(np.uint64).reshape(n, orr, fr, oc, fc)
    s = (0 - fr * fc * 0x4B000000) % 2**32
    for a in range(fr):
        for b in range(fc):
            s = (s + win[:, :, a, :, b]) % 2**32  # one 32-bit add each, wrapping
    s = s.astype(np.uint32)
    assert s.max() <= 255 * fr * fc  # the exact window sum of the u8 values
    if out_u8:
        out = (s >> int(np.log2(fr * fc))).astype(np.uint8)
    else:
        out = (((np.uint32(0x4B000000) | s).view(F32) - F32(TWO23)) * F32(1.0 / (fr * fc))).astype(F32)
    return out.reshape(h // 8, w // 8, orr, oc).transpose(0, 2, 1, 3).reshape(h // fr, w // fc)


def emulate_scaled_decode_u8(coef: np.ndarray, fr: int, fc: int, transform="haweel", q_table="luma",
                             q_scale=1.0, out_u8=False) -> np.ndarray:
    """k_scaled_decode_u8<core>: the (h / fr, w / fc) box averages."""
    h, w = coef.shape
    return _windows(_decode_bits(coef, transform, q_table, q_scale), h, w, fr, fc, out_u8)


@pytest.mark.parametrize("q_scale", [1.0, 2.5])
@pytest.mark.parametrize("q_table", ["luma", "chroma"])
@pytest.mark.parametrize("transform", _TRANSFORMS)
def test_scaled_decode_chain_equals_the_twin(transform, q_table, q_scale):
    """Every (fr, fc) and both outputs, bit for bit, on int8 noise whose
    decode saturates both ways."""
    coef = _i8_map(seed=len(transform) + int(4 * q_scale) + len(q_table))
    h, w = coef.shape
    bits = _decode_bits(coef, transform, q_table, q_scale)
    v = bits - np.uint32(0x4B000000)
    assert (v == 0).any() and (v == 255).any()  # both clamps reached
    assert np.array_equal(_from_blocks(v.astype(np.uint8), h, w),
                          hp.decode_u8_plain(torch.as_tensor(coef), q_scale, q_table, "butterfly", transform).numpy())
    for fr in _FACTORS:
        for fc in _FACTORS:
            for out_u8 in (False, True):
                mine = _windows(bits, h, w, fr, fc, out_u8)
                want = hp.scaled_decode_u8_plain(torch.as_tensor(coef), fr, fc, q_scale, q_table, transform,
                                                 out_u8).numpy()
                assert mine.dtype == want.dtype and np.array_equal(mine, want), (fr, fc, out_u8)


def test_scaled_decode_matches_the_reference_at_64x1024():
    """The emulated B7 against tpudct's hp_scaled_decode_u8 (Pallas,
    interpret mode) on the hp encode's coefficients of u8 noise: +-1 on at
    most 1e-4 of the decoded pixels."""
    img = np.random.default_rng(12).integers(0, 256, size=(64, 1024), dtype=np.uint8)
    coef = hp.encode_u8_plain(torch.as_tensor(img)).numpy()
    for (fr, fc), out_u8 in (((2, 2), True), ((8, 8), False)):
        mine = emulate_scaled_decode_u8(coef, fr, fc, out_u8=out_u8)
        ref = np.asarray(R.hp_scaled_decode_u8(jnp.asarray(coef), fr, fc, interpret=True, out_u8=out_u8))
        d = np.abs(mine.astype(np.float64) - ref)
        assert d.max() <= 1 and (d > 0).sum() <= max(1, 1e-4 * img.size), (fr, fc, d.max(), (d > 0).sum())


# ---------------------------------------------------------------------------
# B22
# ---------------------------------------------------------------------------


def _bf16(v: np.ndarray) -> np.ndarray:
    """__float2bfloat16_rn then back to f32: round to nearest, ties to even,
    on the bits (the kept 16 bits plus a carry where the cut 16 are above
    half, or half with an odd kept part)."""
    b = np.asarray(v, F32).view(np.uint32).astype(np.uint64)
    return (((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)).view(F32)


def test_bf16_rounding_equals_torch_near_every_tie():
    """The digit split's rounding against torch's .to(torch.bfloat16), bit
    for bit (signs of zeros included), on every f32 within 4 ulps of each
    bf16 tie (low 16 bits 0x8000) for every exponent below infinity's and
    every 7-bit kept mantissa, both signs: subnormals, values rounding into
    the next binade (and past bf16's largest finite value), and +-0 and the
    smallest subnormals."""
    exp = np.arange(0, 255, dtype=np.uint64)[:, None]
    kept = np.arange(128, dtype=np.uint64)[None, :]
    v = _near(((exp << 23) | (kept << 16) | 0x8000).ravel().astype(np.uint32).view(F32))
    v = np.concatenate([v, -v, np.array([0.0, -0.0, 1e-45, -1e-45, 3.4028235e38, -3.4028235e38], F32)])
    v = v[np.isfinite(v)]
    want = torch.from_numpy(v.copy()).to(torch.bfloat16).to(torch.float32).numpy()
    assert np.array_equal(_bf16(v).view(np.uint32), want.view(np.uint32))
    assert np.isinf(_bf16(np.array([3.4028235e38], F32))).all()  # rounds up past bf16's largest finite value


def _split3_dot8(vs, ts: np.ndarray) -> list:
    """split3_dot8 on a list of 8 arrays (a column or a row): the three bf16
    digits (d1 = bf16(v), d2 = bf16(v - d1), d3 = bf16(v - d1 - d2)), then
    for each output i the digit sums over column i of ts, (s1 + s2) + s3."""
    r, digits = list(vs), []
    for _ in range(3):
        d = [_bf16(x) for x in r]
        digits.append(d)
        r = [(x - y).astype(F32) for x, y in zip(r, d)]
    return [((_inv_dot(digits[0], ts[:, i]) + _inv_dot(digits[1], ts[:, i])).astype(F32)
             + _inv_dot(digits[2], ts[:, i])).astype(F32) for i in range(8)]


def emulate_idct_split3(coeffs: np.ndarray) -> np.ndarray:
    """k_idct_split3: M = c S, each column in place, then each row, + 128."""
    h, w = coeffs.shape
    k = V._inv_args()
    ts = cores.source_tables()["haweel"]
    x = (_to_blocks(coeffs) * k.s).astype(F32)
    for l in range(8):
        for i, val in enumerate(_split3_dot8([x[:, kk, l] for kk in range(8)], ts)):
            x[:, i, l] = val
    for i in range(8):
        for j, val in enumerate(_split3_dot8([x[:, i, kk] for kk in range(8)], ts)):
            x[:, i, j] = val
    return _from_blocks((x + F32(128)).astype(F32), h, w)


def _coeff_map(kind: str, seed: int, h: int = 64, w: int = 128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "hp_dct":
        img = rng.integers(0, 256, size=(h, w)).astype(F32)
        return hp.dct_plain(torch.as_tensor(img)).numpy()
    if kind == "normal":
        m = rng.normal(0.0, 300.0, (h, w)).astype(F32)
    else:  # wide: 2^-149 (subnormal) to 2^100, far enough below bf16's largest finite value
        m = (rng.choice([-1.0, 1.0], (h, w)) * rng.uniform(1.0, 2.0, (h, w))
             * np.exp2(rng.integers(-149, 101, (h, w)))).astype(F32)
    m[rng.random((h, w)) < 0.15] = 0.0
    m[rng.random((h, w)) < 0.1] = -0.0
    return m


@pytest.mark.parametrize("kind", ["hp_dct", "normal", "wide"])
def test_split3_chain_equals_the_twin(kind):
    m = _coeff_map(kind, seed=len(kind))
    mine = emulate_idct_split3(m)
    want = V.idct_c_plain(torch.as_tensor(m)).numpy()
    assert np.isfinite(want).all() and np.array_equal(mine, want)


def test_split3_matches_the_reference_at_128x512():
    """The emulated B22 against benchmarks/inv_formulations.py's idct_x(., "c")
    (Pallas, interpret mode) on hp_dct's coefficients: within B6's class."""
    inv = _load("inv_formulations")
    img = synthetic_image(512, seed=3)[:128]
    with pltpu.force_tpu_interpret_mode():
        sc = np.asarray(R.hp_dct(jnp.asarray(img)))
        ref = np.asarray(inv.idct_x(jnp.asarray(sc), "c"))
    mine = emulate_idct_split3(sc.copy())
    assert np.array_equal(mine, V.idct_c_plain(torch.as_tensor(sc.copy())).numpy())
    assert np.abs(mine.astype(np.float64) - ref).max() <= B6_CLASS
