"""tpudct_torch.ops.scaled against tpudct.ops.scaled on the same seeded inputs.

Tolerances and their reasons:
- The matrices (pool, area, bases), the shapes and box_pool_u8: bit-identical
  (the same f64 construction cast once to f32; integer window sums times a
  power of two).
- scaled_decode_m8 / scaled_decode: within 1e-3 absolute in f32.  Both
  contract the same f32 inputs, the reference in f32 (lane-width K=128
  matmuls), the port in float64 rounded once to f32.  Seen: 6.1e-5.
- Under a reduced process-wide matmul precision the port's contractions
  give the values of the default precision, bit for bit (an f32 einsum on
  the CPU errs by about 5e-2 under "medium", which runs it in bf16).
- scaled_decode_u8: inherits the butterfly decode's class against the
  reference (+-1 on at most 1e-4 of decoded pixels, tests/test_torch_hp.py),
  so a pooled output moves by at most 1 on at most that many outputs.  Seen
  at 64x1024, seed 5: one decoded pixel of 65,536 differs (so one output per
  factor pair); the fused and the composed form agree with each other bit
  for bit, always.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudct
import tpudct.ops.scaled as RS
import tpudct.ops.transform as RT
import tpudct_torch
import tpudct_torch.ops.scaled as PS
import tpudct_torch.ops.transform as PT
from tpudct_torch.kernels import hp
from tpudct_torch.ops.transform import to_uint8


def _coeffs(shape, seed, transform="haweel"):
    img = np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)
    cfg = tpudct_torch.CodecConfig(transform=transform)
    c = tpudct_torch.get_pipeline("batched").dct(torch.as_tensor(img), cfg)
    return c.numpy()


def test_factors_and_ranges_equal_reference():
    assert PS.FACTORS == RS.FACTORS and PS.M_RANGE == RS.M_RANGE
    for f in RS.FACTORS:
        assert np.array_equal(PS.pool_matrix(f), RS.pool_matrix(f))
    for bad in (3, 16):
        with pytest.raises(ValueError) as mine:
            PS.pool_matrix(bad)
        with pytest.raises(ValueError) as ref:
            RS.pool_matrix(bad)
        assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="1..16"):
        PS.area_matrix(17)


@pytest.mark.parametrize("transform", ["haweel", "rdct", "wht", "bas", "dct"])
def test_matrices_and_bases_equal_reference(transform):
    for m in RS.M_RANGE:
        a, b = PS.area_matrix(m), RS.area_matrix(m)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        a, b = PS.scaled_basis_m(m, transform), RS.scaled_basis_m(m, transform)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for f in RS.FACTORS:
        assert np.array_equal(PS.scaled_basis(f, transform), RS.scaled_basis(f, transform))


def test_shapes_equal_reference():
    for n in (1, 7, 8, 100, 130, 4000, 2992):
        for f in RS.FACTORS:
            assert PS.scaled_shape(n, f) == RS.scaled_shape(n, f)
        for m in RS.M_RANGE:
            assert PS.scaled_shape_m8(n, m) == RS.scaled_shape_m8(n, m)


@pytest.mark.parametrize("m", list(range(1, 17)))
def test_scaled_decode_m8_matches_reference(m):
    cfg, rcfg = tpudct_torch.CodecConfig(q_scale=1.5), tpudct.CodecConfig(q_scale=1.5)
    for shape, seed in (((64, 256), m), ((40, 136), 100 + m)):
        c = _coeffs(shape, seed)
        mine = PS.scaled_decode_m8(torch.as_tensor(c), cfg, m)
        ref = np.asarray(RS.scaled_decode_m8(jnp.asarray(c), rcfg, m))
        assert mine.dtype == torch.float32 and tuple(mine.shape) == ref.shape
        assert np.abs(mine.numpy() - ref).max() <= 1e-3


@pytest.mark.parametrize("transform", ["haweel", "dct"])
def test_scaled_decode_and_anisotropic_match_reference(transform):
    cfg, rcfg = tpudct_torch.CodecConfig(transform=transform), tpudct.CodecConfig(transform=transform)
    c = _coeffs((64, 256), 3, transform)
    for fr, fc in ((2, 2), (4, 2), (1, 8), (8, 8)):
        mine = PS.scaled_decode(torch.as_tensor(c), cfg, fr, fc)
        ref = np.asarray(RS.scaled_decode(jnp.asarray(c), rcfg, fr, fc))
        assert tuple(mine.shape) == ref.shape and np.abs(mine.numpy() - ref).max() <= 1e-3
    mine = PS.scaled_decode_m8(torch.as_tensor(c), cfg, 3, 12)
    ref = np.asarray(RS.scaled_decode_m8(jnp.asarray(c), rcfg, 3, 12))
    assert tuple(mine.shape) == ref.shape and np.abs(mine.numpy() - ref).max() <= 1e-3
    with pytest.raises(ValueError, match="scaled_decode_m8"):
        PS.scaled_decode(torch.as_tensor(c), cfg, 3)


@pytest.mark.parametrize("op", ["scaled_decode_m8", "scaled_decode", "dct2_blocks", "idct2_blocks"])
def test_contractions_ignore_reduced_matmul_precision(op):
    cfg, rcfg = tpudct_torch.CodecConfig(transform="dct"), tpudct.CodecConfig(transform="dct")
    c = _coeffs((64, 256), 9, "dct")
    x = torch.as_tensor(c * 3.0)
    fns = {
        "scaled_decode_m8": (lambda: PS.scaled_decode_m8(torch.as_tensor(c), cfg, 3),
                             lambda: RS.scaled_decode_m8(jnp.asarray(c), rcfg, 3)),
        "scaled_decode": (lambda: PS.scaled_decode(torch.as_tensor(c), cfg, 2, 4),
                          lambda: RS.scaled_decode(jnp.asarray(c), rcfg, 2, 4)),
        "dct2_blocks": (lambda: PT.dct2_blocks(x, transform="dct"),
                        lambda: RT.dct2_blocks(jnp.asarray(x.numpy()), transform="dct")),
        "idct2_blocks": (lambda: PT.idct2_blocks(x, transform="dct"),
                         lambda: RT.idct2_blocks(jnp.asarray(x.numpy()), transform="dct")),
    }
    mine, ref = fns[op]
    prev = torch.get_float32_matmul_precision()
    assert prev == "highest"
    full = mine()
    torch.set_float32_matmul_precision("medium")
    try:
        assert torch.backends.cuda.matmul.allow_tf32
        reduced = mine()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert reduced.dtype == torch.float32 and torch.equal(reduced, full)
    assert np.abs(reduced.numpy() - np.asarray(ref())).max() <= 1e-3


@pytest.mark.parametrize("shape", [(64, 256), (48, 120), (16, 1024)])
def test_box_pool_u8_equals_reference(shape):
    x = np.random.default_rng(4).integers(0, 256, size=shape, dtype=np.uint8)
    for fr in RS.FACTORS:
        for fc in RS.FACTORS:
            mine = PS.box_pool_u8(torch.as_tensor(x), fr, fc)
            ref = np.asarray(RS.box_pool_u8(jnp.asarray(x), fr, fc))
            assert mine.dtype == torch.float32 and np.array_equal(mine.numpy(), ref)
    with pytest.raises(ValueError, match="divisible"):
        PS.box_pool_u8(torch.as_tensor(x[:, :-1]), 2)


@pytest.mark.parametrize("kw,fused", [
    ({}, True), ({"q_scale": 2.5}, True), ({"transform": "rdct"}, True),
    ({"decode_precision": "highest"}, False), ({"decode_precision": "high"}, False),
])
@pytest.mark.parametrize("out_u8", [False, True])
def test_scaled_decode_u8_matches_reference(kw, fused, out_u8, monkeypatch):
    calls = []
    kernel = hp.hp_scaled_decode_u8
    monkeypatch.setattr(hp, "hp_scaled_decode_u8", lambda *a, **k: calls.append(a) or kernel(*a, **k))
    p, rp = tpudct_torch.get_pipeline("hp"), tpudct.get_pipeline("hp")
    cfg, rcfg = tpudct_torch.CodecConfig(**kw), tpudct.CodecConfig(**kw)
    img = np.random.default_rng(5).integers(0, 256, size=(64, 1024), dtype=np.uint8)
    c = p.encode_u8(torch.as_tensor(img), cfg)
    for fr, fc in ((2, 2), (4, 2), (8, 8)):
        assert hp.supports_scaled_u8(64, 1024, fr, fc, cfg.q_scale, cfg.transform)
        mine = PS.scaled_decode_u8(p, c, cfg, fr, fc, out_u8=out_u8)
        ref = np.asarray(RS.scaled_decode_u8(rp, jnp.asarray(c.numpy()), rcfg, fr, fc, out_u8=out_u8))
        composed = PS.box_pool_u8(p.decode_u8(c, cfg), fr, fc)
        assert torch.equal(mine, to_uint8(composed) if out_u8 else composed)
        # "high" is the reference's bf16x3 product against the port's f32
        # body: +-1 on at most 5e-3 of decoded pixels (seen 8 of 65,536)
        share = 5e-3 if kw.get("decode_precision") == "high" else 1e-4
        d = np.abs(mine.numpy().astype(np.float64) - ref)
        assert d.max() <= 1 and (d > 0).sum() <= max(1, share * img.size)
    # the fused kernel runs where the effective tier is butterfly; the
    # composed branch follows the config, it is not a fallback
    assert len(calls) == (3 if fused else 0)


# decode_gray_scaled_auto's u8 M/8 upscales (m > 8) against the reference on
# 64x128 u8 noise (seed 3), coded by each side's hp encode (the same
# coefficients): pixels differing, by 1 each; every other (transform, m)
# gives 0.  Cause: wht's upscaled values land on exact integers, where the
# reference's f32 product chains (the K = 128 lane product's FMA chain, then
# the K = 8 row einsum's four FMA chains added pairwise, which reproduce
# its f32 output bit for bit at these m) can fall one ulp below the integer
# that the port's float64 contraction, rounded once, gives; the u8
# truncation then takes the integer below.
UPSCALE_U8_DIFFER = {("wht", 12): 44, ("wht", 16): 124}


@pytest.mark.parametrize("m", [12, 16])
@pytest.mark.parametrize("transform", ["haweel", "rdct", "wht", "bas", "dct"])
def test_u8_upscale_differences_per_transform(transform, m):
    """The u8 M/8 upscale's count of differing pixels per transform, held to
    the recorded count (UPSCALE_U8_DIFFER), each by at most 1."""
    from tpudct.models import dispatch as RD
    from tpudct_torch.models import dispatch as PD

    cfg, rcfg = tpudct_torch.CodecConfig(transform=transform), tpudct.CodecConfig(transform=transform)
    p, rp = tpudct_torch.get_pipeline("hp"), tpudct.get_pipeline("hp")
    img = np.random.default_rng(3).integers(0, 256, (64, 128)).astype(np.uint8)
    c, hw = PD.encode_gray_auto(p, img, cfg, device="cpu")
    r = PD.decode_gray_scaled_auto(p, c.numpy(), cfg, hw, m, device="cpu")
    r_ref = np.asarray(RD.decode_gray_scaled_auto(rp, c.numpy(), rcfg, hw, m))
    assert r.shape == r_ref.shape == (64 * m // 8, 128 * m // 8) and r.dtype == np.uint8
    d = np.abs(r.astype(np.int64) - r_ref.astype(np.int64))
    n = int((d > 0).sum())
    print(f"{transform} m={m}: {n} of {d.size} u8 pixels differ from the reference")
    assert d.max() <= 1 and n == UPSCALE_U8_DIFFER.get((transform, m), 0)
