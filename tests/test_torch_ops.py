"""tpudct_torch.ops against tpudct.ops on the same seeded inputs.

Tolerances: layout, padding, rounding, quantization and retention are
exact (bit-identical).  The f32 blockwise transforms are bit-identical too:
the port sums in the order XLA's CPU products sum (``ops.transform``: an
FMA chain per output on 128-tiled shapes, four FMA chains added pairwise in
the K = 8 einsum), each FMA emulated exactly (``fma32``, checked here
against exact rational arithmetic).  So are the ``batched`` pipeline's
coefficients and f32 reconstructions, at every q_scale.  The first
transform test keeps its 2e-4 bound (it predates the exact order).
"""

import fractions

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudct.ops.blocks as RB
import tpudct.ops.padding as RP
import tpudct.ops.quant as RQ
import tpudct.ops.rounding as RR
import tpudct
import tpudct.ops.transform as RT
import tpudct_torch
import tpudct_torch.ops.blocks as PB
import tpudct_torch.ops.padding as PP
import tpudct_torch.ops.quant as PQ
import tpudct_torch.ops.rounding as PR
import tpudct_torch.ops.transform as PT


def _same(mine: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert tuple(mine.shape) == ref.shape
    assert mine.numpy().dtype == ref.dtype, (mine.dtype, ref.dtype)
    assert np.array_equal(mine.numpy(), ref)


def test_round_half_away_matches_reference():
    special = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.49999997, -0.49999997,
                        0.0, -0.0, 1e7 + 0.5, 3.4999998], np.float32)
    rnd = np.random.default_rng(0).normal(0, 40, 4096).astype(np.float32)
    halves = (np.random.default_rng(1).integers(-500, 500, 512) + 0.5).astype(np.float32)
    x = np.concatenate([special, rnd, halves])
    _same(PR.round_half_away(torch.as_tensor(x)), RR.round_half_away(jnp.asarray(x)))


def test_round_free_matches_reference():
    """C truncation, the reference's ``jnp.trunc``: +-0.5 ties and their
    neighbours, signed zeros, large values (beyond 2^23 every f32 is whole)
    and infinities."""
    special = np.array([0.5, -0.5, 1.5, -1.5, 254.5, 255.5, -0.49999997, 0.99999994, -0.0, 0.0,
                        2.0**23 + 1, -(2.0**24) - 2, 3.4e38, -3.4e38, np.inf, -np.inf], np.float32)
    rnd = np.random.default_rng(2).normal(0, 300, 2048).astype(np.float32)
    x = np.concatenate([special, rnd])
    got = PT.round_free(torch.as_tensor(x))
    _same(got, RT.round_free(jnp.asarray(x)))
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(np.asarray(RT.round_free(jnp.asarray(x)))))


@pytest.mark.parametrize("shape", [(8, 8), (16, 24), (64, 128)])
def test_block_layouts_match_reference(shape):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    h, w = shape
    b = PB.blockify(torch.as_tensor(x))
    _same(b, RB.blockify(jnp.asarray(x)))
    _same(PB.deblockify(b, h, w), x)
    _same(PB.as_block_grid(torch.as_tensor(x)), RB.as_block_grid(jnp.asarray(x)))
    _same(PB.from_block_grid(PB.as_block_grid(torch.as_tensor(x))), x)
    assert PB.num_blocks(h, w) == RB.num_blocks(h, w)


def test_block_grid_refuses_ragged():
    with pytest.raises(ValueError, match="pad first"):
        PB.as_block_grid(torch.zeros(10, 16))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(5, 7), (8, 8), (100, 200), (250, 130), (32, 128)])
def test_padding_matches_reference(shape, dtype):
    x = np.random.default_rng(3).integers(0, 256, size=shape).astype(dtype)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    (a, sa), (b, sb) = PP.pad_to_blocks(xt), RP.pad_to_blocks(xj)
    _same(a, b)
    assert sa == sb
    for row_align in (8, 32):
        (a, sa), (b, sb) = PP.pad_to_kernel(xt, row_align), RP.pad_to_kernel(xj, row_align)
        _same(a, b)
        assert sa == sb
        assert PP.kernel_padded_shape(*shape, row_align) == RP.kernel_padded_shape(*shape, row_align)
        c = x.astype(np.int8)
        (a, sa), (b, sb) = (PP.pad_coeffs_to_kernel(torch.as_tensor(c), row_align),
                            RP.pad_coeffs_to_kernel(jnp.asarray(c), row_align))
        _same(a, b)
    assert PP.padded_shape(*shape) == RP.padded_shape(*shape)
    _same(PP.crop(xt, 3, 4), RP.crop(xj, 3, 4))


@pytest.mark.parametrize("deadzone", [0.5, 0.35])
@pytest.mark.parametrize("q_table", ["luma", "chroma"])
@pytest.mark.parametrize("q_scale", [1.0, 2.5, 0.3])
def test_quantize_dequantize_match_reference(q_scale, q_table, deadzone):
    rng = np.random.default_rng(4)
    y = rng.normal(0, 300, size=(64, 128)).astype(np.float32)
    # plant exact .5 quotients at every position
    q = RQ._q_for(jnp.zeros(1, jnp.float32), q_scale, q_table)
    y[:8, :8] = (np.arange(64).reshape(8, 8) - 31.5) * np.asarray(q)
    c = PQ.quantize(torch.as_tensor(y), q_scale, q_table, deadzone)
    _same(c, RQ.quantize(jnp.asarray(y), q_scale, q_table, deadzone))
    _same(PQ.dequantize(c, q_scale, q_table), RQ.dequantize(jnp.asarray(c.numpy()), q_scale, q_table))


def test_quantize_refuses_bad_deadzone():
    with pytest.raises(ValueError, match="deadzone"):
        PQ.quantize(torch.zeros(8, 8), deadzone=0.6)


@pytest.mark.parametrize("k", [None, 1, 6, 10, 15])
def test_retention_matches_reference(k):
    assert np.array_equal(PQ.retention_mask(k), RQ.retention_mask(k))
    c = np.random.default_rng(5).integers(-50, 50, size=(16, 32)).astype(np.float32)
    _same(PQ.apply_retention(torch.as_tensor(c), k), RQ.apply_retention(jnp.asarray(c), k))


def test_level_shift_and_to_uint8_match_reference():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    _same(PT.level_shift(torch.as_tensor(u8)), RT.level_shift(jnp.asarray(u8)))
    f = np.random.default_rng(6).normal(100, 200, size=(16, 16)).astype(np.float32)
    _same(PT.level_shift(torch.as_tensor(f)), RT.level_shift(jnp.asarray(f)))
    _same(PT.level_unshift(torch.as_tensor(f)), RT.level_unshift(jnp.asarray(f)))
    _same(PT.to_uint8(torch.as_tensor(f)), RT.to_uint8(jnp.asarray(f)))


@pytest.mark.parametrize("transform", ["haweel", "rdct", "wht", "bas", "dct"])
@pytest.mark.parametrize("shape", [(16, 24), (128, 256)])
def test_blockwise_transforms_match_reference(shape, transform):
    x = np.random.default_rng(7).integers(0, 256, size=shape).astype(np.float32) - 128
    y = PT.dct2_blocks(torch.as_tensor(x), transform=transform)
    y_ref = np.asarray(RT.dct2_blocks(jnp.asarray(x), transform=transform))
    assert y.dtype == torch.float32 and np.abs(y.numpy() - y_ref).max() <= 2e-4
    z = PT.idct2_blocks(y, transform=transform)
    z_ref = np.asarray(RT.idct2_blocks(jnp.asarray(y.numpy()), transform=transform))
    assert np.abs(z.numpy() - z_ref).max() <= 2e-4
    assert np.abs(z.numpy() - x).max() <= 1e-3  # orthogonal: the inverse inverts


def _rn32(v: fractions.Fraction) -> float:
    """An exact rational rounded once to the nearest f32, ties to even
    (normal range)."""
    if v == 0:
        return 0.0
    sign, a = (-1 if v < 0 else 1), abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    while a >= fractions.Fraction(2) ** (e + 1):
        e += 1
    while a < fractions.Fraction(2) ** e:
        e -= 1
    m = a / fractions.Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    n = m.numerator // m.denominator
    rest = m - n
    if rest > fractions.Fraction(1, 2) or (rest == fractions.Fraction(1, 2) and n % 2):
        n += 1
    return sign * float(n * fractions.Fraction(2) ** (e - 23))


def test_fma32_rounds_once():
    """fma32(a, b, c) is RN32(a b + c) exactly: on random triples of mixed
    magnitudes and on triples whose float64 sum lands exactly on an f32
    tie while the exact sum does not (a = 1 + i 2^-23, b = 1 - i 2^-23 make
    a b = 1 - i^2 2^-46; c = 2^24 + 2 j puts a b + c just below a tie; the
    naive double rounding gets half of these wrong)."""
    rng = np.random.default_rng(11)
    n = 4000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-8, 9, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-8, 9, n)).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-8, 12, n)).astype(np.float32)
    i = np.arange(1, 65, dtype=np.float64)
    ta = np.concatenate([1 + i * 2.0 ** -23, -(1 + i * 2.0 ** -23)]).astype(np.float32)
    tb = np.concatenate([1 - i * 2.0 ** -23, 1 - i * 2.0 ** -23]).astype(np.float32)
    tc = np.concatenate([2.0 ** 24 + 2 * i, -(2.0 ** 24 + 2 * i)]).astype(np.float32)
    a, b, c = (np.concatenate(v) for v in ((a, ta, ta * 4), (b, tb, tb), (c, tc, tc * 4)))
    got = PT.fma32(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    want = np.array([_rn32(fractions.Fraction(float(x)) * fractions.Fraction(float(y)) + fractions.Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).sum() >= 64  # the ties are there to be missed


@pytest.mark.parametrize("transform", ["haweel", "rdct", "wht", "bas", "dct"])
@pytest.mark.parametrize("shape", [(128, 256), (128, 136), (40, 56)])
def test_blockwise_value_chain_is_the_reference(shape, transform):
    """dct2_blocks and idct2_blocks in f32 equal the reference's bit for bit:
    on 128-tiled shapes (the lane product, then the rows) and off that grid
    (the three-operand einsum, rows then lanes)."""
    rng = np.random.default_rng(shape[0] + shape[1])
    x = rng.integers(0, 256, size=shape).astype(np.float32) - 128
    y = PT.dct2_blocks(torch.as_tensor(x), transform=transform)
    assert np.array_equal(y.numpy(), np.asarray(RT.dct2_blocks(jnp.asarray(x), transform=transform)))
    c = (rng.integers(-60, 60, size=shape) * rng.random(shape) * 7).astype(np.float32)
    z = PT.idct2_blocks(torch.as_tensor(c), transform=transform)
    assert np.array_equal(z.numpy(), np.asarray(RT.idct2_blocks(jnp.asarray(c), transform=transform)))


@pytest.mark.parametrize("q_scale", [0.1, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("transform", ["haweel", "rdct", "wht", "bas", "dct"])
def test_batched_coefficients_are_the_reference(transform, q_scale):
    """The batched pipeline's coefficients and its f32 reconstruction equal
    the reference's on 128-tiled u8 noise: 0 differences (wht's values sit
    on many exact .5 ties, so one ulp of another order flips coefficients;
    off the grid the transforms alone are held above)."""
    cfg = tpudct_torch.CodecConfig(q_scale=q_scale, transform=transform)
    rcfg = tpudct.CodecConfig(q_scale=q_scale, transform=transform)
    p, rp = tpudct_torch.get_pipeline("batched"), tpudct.get_pipeline("batched")
    img = np.random.default_rng(int(100 * q_scale)).integers(0, 256, size=(128, 256)).astype(np.float32)
    c = p.dct(torch.as_tensor(img), cfg)
    c_ref = np.asarray(rp.dct(jnp.asarray(img), rcfg))
    assert np.array_equal(c.numpy(), c_ref)
    assert np.array_equal(p.idct(c, cfg).numpy(), np.asarray(rp.idct(jnp.asarray(c_ref), rcfg)))
