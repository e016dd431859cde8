"""The hp kernels' plain torch twins (what a CPU tensor runs) against the
reference Pallas kernels in interpret mode.

Tolerances and their reasons:
- Coefficients: bit-identical.  Both packages compute the exact integer
  core, one rounded f32 scale multiply and one rounded tie-add.
- Reconstruction, "butterfly" tier: +-1 on at most 1e-4 of pixels.  The
  port sums the lane direction in f32 in order (j = 0..7); the reference
  sums three exact bf16 splits on the MXU.  Where the true value sits on
  an integer, the two sums can truncate to neighbouring integers.  Seen:
  0 pixels for haweel at these shapes, 1 of 49,152 for rdct.  The
  Walsh-Hadamard core ("wht") puts reconstructions ON integers by design
  (every product is +-1 times a multiple of Q/8), so there the same
  rounding difference flips +-1 on at most 0.5% (seen up to 0.17%).
- Reconstruction, "highest" tier: +-1 on at most 0.5% (the reference runs
  its inverse lane direction first, as a matmul; the port runs rows first,
  in order, in plain f32).  Seen: at most 2 of 49,152 for haweel,
  rdct and bas; "wht" again sits on integers and flips up to 1.3%, held
  to 2%.
- hp_roundtrip's f32 reconstruction: within 1e-4 absolute (seen 6.1e-5).
- hp_dct on the integer core: bit-identical (the same exact core and
  rounded scale as hp_roundtrip).
- The f32-literal core (hp_dct int_core=False, hp_roundtrip's B4'):
  coefficients +-1 on at most 0.5% of entries, the quantizer tie class
  (bench.py:82-91).  The port sums T X T^T in f32 in order, the reference
  emulates f32 on its matrix unit; a quotient within an ulp of .5 can round
  either way.  Seen at 64x256: 16 of 16,384 (haweel), 5 (rdct), 3 (dct).
- hp_idct and the B4' reconstruction: within 1e-4 absolute in f32 for
  "butterfly" and "highest" on encoded coefficients (seen 6.1e-5), where the
  coefficients agree.  "high": the reference's bf16x3 product against the
  port's f32 body, within 2e-3 (seen 1.4e-3); the truncated u8
  reconstruction +-1 on at most 5e-3 of pixels (seen at most 4 of 16,384
  for haweel, rdct and bas), 10% for "wht", whose reconstructions sit on
  integers (seen 917 of 16,384).
- The reference's f32-literal roundtrip runs its "highest" inverse for
  "high" (``_k_rt_f32``'s default); the port runs "highest" there too.
- hp_scaled_decode_u8: bit-identical to the reference at every factor pair
  and both output types (seen: 0 differing outputs for haweel), and always
  bit-identical to the port's own box_pool_u8(hp_decode_u8(c)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudct.kernels import hp_pallas as R
from tpudct_torch.kernels import hp as P

_SHAPES = [(32, 128), (64, 256), (128, 384)]
_CASES = [
    (tr, tier, qs, rk)
    for tr in ("haweel", "rdct", "wht", "bas")
    for tier in ("butterfly", "highest")
    for qs, rk in ((1.0, None), (2.5, 6))
]


def _recon_share(transform: str, tier: str) -> float:
    if tier == "butterfly":
        return 5e-3 if transform == "wht" else 1e-4
    return 2e-2 if transform == "wht" else 5e-3


def _image(i: int):
    h, w = _SHAPES[i % len(_SHAPES)]
    return np.random.default_rng(100 + i).integers(0, 256, size=(h, w), dtype=np.uint8)


def _assert_recon(mine, ref, share):
    d = np.abs(np.asarray(mine, np.int64) - np.asarray(ref, np.int64))
    assert d.max() <= 1
    assert (d > 0).sum() <= share * d.size, f"{(d > 0).sum()} of {d.size} pixels differ"


@pytest.mark.parametrize("i,transform,tier,q_scale,retain_k",
                         [(i, *c) for i, c in enumerate(_CASES)])
def test_roundtrip_u8_twin_matches_reference(i, transform, tier, q_scale, retain_k):
    img = _image(i)
    kw = dict(q_scale=q_scale, retain_k=retain_k, decode_precision=tier, transform=transform)
    c_ref, r_ref = R.hp_roundtrip_u8(jnp.asarray(img), interpret=True, **kw)
    c, r = P.hp_roundtrip_u8(torch.as_tensor(img), **kw)
    assert c.dtype == torch.int8 and r.dtype == torch.uint8 and tuple(c.shape) == img.shape
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    _assert_recon(r.numpy(), r_ref, _recon_share(transform, tier))
    assert P.LAUNCHES["hp_roundtrip_u8"] == 0  # the twin is no launch


@pytest.mark.parametrize("i,transform,tier,q_scale,retain_k",
                         [(i, *c) for i, c in enumerate(_CASES)])
def test_encode_decode_u8_twins_match_reference(i, transform, tier, q_scale, retain_k):
    img = _image(i + 1)
    c_ref = np.array(R.hp_encode_u8(
        jnp.asarray(img), q_scale=q_scale, retain_k=retain_k, transform=transform, interpret=True))
    c = P.hp_encode_u8(torch.as_tensor(img), q_scale=q_scale, retain_k=retain_k, transform=transform)
    assert c.dtype == torch.int8 and np.array_equal(c.numpy(), c_ref)
    kw = dict(q_scale=q_scale, decode_precision=tier, transform=transform)
    r_ref = R.hp_decode_u8(jnp.asarray(c_ref), interpret=True, **kw)
    r = P.hp_decode_u8(torch.as_tensor(c_ref), **kw)
    assert r.dtype == torch.uint8
    _assert_recon(r.numpy(), r_ref, _recon_share(transform, tier))
    # the split path equals the fused pass bit for bit
    c2, r2 = P.hp_roundtrip_u8(torch.as_tensor(img), retain_k=retain_k, **kw)
    assert torch.equal(c2, c) and torch.equal(r2, P.hp_decode_u8(c, **kw))


@pytest.mark.parametrize("i,transform,tier,q_scale,retain_k",
                         [(i, *c) for i, c in enumerate(_CASES)])
def test_roundtrip_f32_twin_matches_reference(i, transform, tier, q_scale, retain_k):
    img = _image(i + 2).astype(np.float32)
    kw = dict(q_scale=q_scale, retain_k=retain_k, decode_precision=tier, transform=transform)
    c_ref, r_ref = R.hp_roundtrip(jnp.asarray(img), interpret=True, **kw)
    c, r = P.hp_roundtrip(torch.as_tensor(img), **kw)
    assert c.dtype == torch.float32 and r.dtype == torch.float32
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    assert np.abs(r.numpy() - np.asarray(r_ref)).max() <= 1e-4
    _assert_recon(np.trunc(r.numpy()), np.trunc(np.asarray(r_ref)), _recon_share(transform, tier))


def test_wrappers_validate_operands():
    x = torch.zeros((32, 128), dtype=torch.uint8)
    with pytest.raises(TypeError, match="torch.uint8"):
        P.hp_roundtrip_u8(x.to(torch.float32))
    with pytest.raises(ValueError, match="2-D"):
        P.hp_encode_u8(x[None])
    with pytest.raises(ValueError, match="h % 8"):
        P.hp_roundtrip_u8(x[:30])
    with pytest.raises(TypeError, match="torch.int8"):
        P.hp_decode_u8(x)
    with pytest.raises(TypeError, match="Tensor"):
        P.hp_roundtrip(np.zeros((32, 128), np.float32))
    with pytest.raises(ValueError, match="decode_precision"):
        P.hp_decode_u8(x.to(torch.int8), decode_precision="fast")
    # "high" runs the f32 "highest" body
    c = torch.as_tensor(np.random.default_rng(1).integers(-40, 40, (32, 128), dtype=np.int8))
    assert torch.equal(P.hp_decode_u8(c, decode_precision="high"),
                       P.hp_decode_u8(c, decode_precision="highest"))
    with pytest.raises(TypeError, match="torch.float32"):
        P.hp_idct(c)
    with pytest.raises(ValueError, match="factors"):
        P.hp_scaled_decode_u8(c, 3, 2)
    with pytest.raises(ValueError, match="has none"):
        P.hp_dct(x.to(torch.float32), transform="dct")
    with pytest.raises(ValueError, match="has none"):
        P.hp_idct(x.to(torch.float32), transform="dct")


def test_kernels_need_only_8_aligned_shapes():
    """The twins (and kernels) take any 8-aligned shape, not only the
    reference's 32x128 grid; a block's result does not depend on its
    neighbours."""
    img = np.random.default_rng(5).integers(0, 256, size=(40, 136), dtype=np.uint8)
    c, r = P.hp_roundtrip_u8(torch.as_tensor(img))
    c_big, r_big = P.hp_roundtrip_u8(torch.as_tensor(np.pad(img, ((0, 24), (0, 120)))))
    assert torch.equal(c, c_big[:40, :136]) and torch.equal(r, r_big[:40, :136])


# ---- B4', B5, B6, B7 ---------------------------------------------------------


def _f32(a) -> np.ndarray:
    return np.array(a, np.float32)  # a writable copy (jax arrays are read-only)


def _assert_ties(mine, ref):
    d = np.abs(np.asarray(mine, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 1
    assert (d > 0).sum() <= 0.005 * d.size, f"{(d > 0).sum()} of {d.size} coefficients differ"


def _agreeing_blocks(c, c_ref):
    h, w = c.shape
    return (np.asarray(c) == np.asarray(c_ref)).reshape(h // 8, 8, w // 8, 8).all(axis=(1, 3))


def _block_max(d):
    h, w = d.shape
    return d.reshape(h // 8, 8, w // 8, 8).max(axis=(1, 3))


@pytest.mark.parametrize("transform", ["haweel", "rdct", "wht", "bas"])
@pytest.mark.parametrize("q_scale", [1.0, 2.5, 0.5])
def test_dct_int_core_twin_matches_reference(transform, q_scale):
    img = np.random.default_rng(7).integers(0, 256, size=(64, 256)).astype(np.float32)
    ref = R.hp_dct(jnp.asarray(img), q_scale=q_scale, transform=transform, interpret=True)
    c = P.hp_dct(torch.as_tensor(img), q_scale=q_scale, transform=transform)
    assert c.dtype == torch.float32 and np.array_equal(c.numpy(), np.asarray(ref))
    # the same coefficients as the fused pass
    assert torch.equal(c, P.hp_roundtrip(torch.as_tensor(img), q_scale=q_scale, transform=transform)[0])


@pytest.mark.parametrize("pixels", ["u8", "float"])
@pytest.mark.parametrize("transform", ["haweel", "rdct", "dct"])
@pytest.mark.parametrize("q_scale", [1.0, 0.5])
def test_dct_f32_literal_twin_matches_reference(transform, q_scale, pixels):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, size=(64, 256)).astype(np.float32)
    if pixels == "float":  # the literal core takes any f32 values
        img = (img + rng.normal(0, 3, img.shape)).astype(np.float32)
    ref = R.hp_dct(jnp.asarray(img), q_scale=q_scale, transform=transform, int_core=False,
                   interpret=True)
    c = P.hp_dct(torch.as_tensor(img), q_scale=q_scale, transform=transform, int_core=False)
    _assert_ties(c.numpy(), ref)


def _tiers(transforms):
    """(transform, tier) pairs; no butterfly without an integer core (the
    pipeline demotes "dct" to "highest")."""
    return [(t, tier) for t in transforms for tier in ("butterfly", "highest", "high")
            if not (t == "dct" and tier == "butterfly")]


@pytest.mark.parametrize("q_scale,retain_k", [(1.0, None), (2.5, 6), (0.5, None)])
@pytest.mark.parametrize("transform,tier", _tiers(["haweel", "rdct", "dct"]))
def test_roundtrip_f32core_twin_matches_reference(transform, tier, q_scale, retain_k):
    img = np.random.default_rng(9).integers(0, 256, size=(64, 256)).astype(np.float32)
    kw = dict(q_scale=q_scale, retain_k=retain_k, decode_precision=tier, transform=transform)
    c_ref, r_ref = R.hp_roundtrip(jnp.asarray(img), int_core=False, interpret=True, **kw)
    c, r = P.hp_roundtrip(torch.as_tensor(img), int_core=False, **kw)
    c_ref, r_ref = _f32(c_ref), _f32(r_ref)
    _assert_ties(c.numpy(), c_ref)
    same = _agreeing_blocks(c.numpy(), c_ref)
    assert same.mean() > 0.9
    # the reference's literal core runs "highest" for "high" as well
    assert _block_max(np.abs(r.numpy() - r_ref))[same].max() <= 1e-4
    if retain_k is not None:  # the mask multiplies after rounding: -0.0 where masked
        masked = np.tile(P.kernel_constants(transform, retain_k=retain_k).mask == 0, (8, 32))
        assert (c.numpy()[masked] == 0).all() and (c_ref[masked] == 0).all()
    # the fused pass equals hp_dct + apply_retention + hp_idct on the same core
    from tpudct_torch.ops.quant import apply_retention

    c2 = apply_retention(P.hp_dct(torch.as_tensor(img), q_scale=q_scale, transform=transform,
                                  int_core=False), retain_k)
    assert torch.equal(c2, c)
    assert torch.equal(P.hp_idct(c, q_scale=q_scale, decode_precision=tier, transform=transform), r)


def test_roundtrip_f32core_high_runs_highest():
    """_k_rt_f32 calls its inverse at the default precision, so the
    reference's f32-literal roundtrip with "high" is its "highest" roundtrip;
    the port's is too."""
    img = np.random.default_rng(10).integers(0, 256, size=(32, 128)).astype(np.float32)
    outs = {}
    for tier in ("high", "highest"):
        outs[tier] = R.hp_roundtrip(jnp.asarray(img), int_core=False, decode_precision=tier,
                                    interpret=True)
        mine = P.hp_roundtrip(torch.as_tensor(img), int_core=False, decode_precision=tier)
        outs["p" + tier] = mine
    for a, b in zip(outs["high"], outs["highest"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(outs["phigh"], outs["phighest"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("transform,tier", _tiers(["haweel", "rdct", "wht", "bas", "dct"]))
def test_idct_twin_matches_reference(transform, tier):
    img = np.random.default_rng(11).integers(0, 256, size=(64, 256)).astype(np.float32)
    c = _f32(R.hp_dct(jnp.asarray(img), transform=transform, int_core=transform != "dct",
                      interpret=True))
    ref = _f32(R.hp_idct(jnp.asarray(c), decode_precision=tier, transform=transform, interpret=True))
    r = P.hp_idct(torch.as_tensor(c), decode_precision=tier, transform=transform)
    assert r.dtype == torch.float32
    assert np.abs(r.numpy() - ref).max() <= (2e-3 if tier == "high" else 1e-4)
    share = (0.1 if transform == "wht" else 5e-3) if tier == "high" else _recon_share(transform, tier)
    _assert_recon(np.trunc(r.numpy()), np.trunc(ref), share)


@pytest.mark.parametrize("transform", ["haweel", "rdct", "wht", "bas"])
def test_high_tier_u8_matches_reference_high(transform):
    img = np.random.default_rng(12).integers(0, 256, size=(64, 256), dtype=np.uint8)
    share = 0.1 if transform == "wht" else 5e-3
    kw = dict(decode_precision="high", transform=transform)
    c_ref, r_ref = R.hp_roundtrip_u8(jnp.asarray(img), interpret=True, **kw)
    c, r = P.hp_roundtrip_u8(torch.as_tensor(img), **kw)
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    _assert_recon(r.numpy(), r_ref, share)
    _assert_recon(P.hp_decode_u8(c, **kw).numpy(),
                  R.hp_decode_u8(jnp.asarray(c.numpy()), interpret=True, **kw), share)
    cf, rf = P.hp_roundtrip(torch.as_tensor(img.astype(np.float32)), **kw)
    cf_ref, rf_ref = R.hp_roundtrip(jnp.asarray(img.astype(np.float32)), interpret=True, **kw)
    assert np.array_equal(cf.numpy(), np.asarray(cf_ref))
    assert np.abs(rf.numpy() - np.asarray(rf_ref)).max() <= 2e-3


@pytest.mark.parametrize("out_u8", [False, True])
@pytest.mark.parametrize("fr,fc", [(fr, fc) for fr in (1, 2, 4, 8) for fc in (1, 2, 4, 8)])
def test_scaled_decode_u8_twin_matches_reference(fr, fc, out_u8):
    from tpudct_torch.ops.scaled import box_pool_u8
    from tpudct_torch.ops.transform import to_uint8

    img = np.random.default_rng(13).integers(0, 256, size=(64, 1024), dtype=np.uint8)
    c = np.array(R.hp_encode_u8(jnp.asarray(img), interpret=True))
    ref = np.asarray(R.hp_scaled_decode_u8(jnp.asarray(c), fr, fc, out_u8=out_u8, interpret=True))
    s = P.hp_scaled_decode_u8(torch.as_tensor(c), fr, fc, out_u8=out_u8)
    assert s.dtype == (torch.uint8 if out_u8 else torch.float32) and s.shape == (64 // fr, 1024 // fc)
    assert np.array_equal(s.numpy(), ref)
    composed = box_pool_u8(P.hp_decode_u8(torch.as_tensor(c)), fr, fc)
    assert torch.equal(s, to_uint8(composed) if out_u8 else composed)


def test_new_kernels_take_8_aligned_shapes():
    """hp_dct, hp_idct, both roundtrip cores and the scaled decode take any
    8-aligned shape; a block's result does not depend on its neighbours."""
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, size=(40, 136)).astype(np.float32)
    big = torch.as_tensor(np.pad(img, ((0, 24), (0, 120))))
    x = torch.as_tensor(img)
    for int_core in (True, False):
        assert torch.equal(P.hp_dct(x, int_core=int_core), P.hp_dct(big, int_core=int_core)[:40, :136])
        for a, b in zip(P.hp_roundtrip(x, int_core=int_core), P.hp_roundtrip(big, int_core=int_core)):
            assert torch.equal(a, b[:40, :136])
    c = P.hp_dct(x)
    assert torch.equal(P.hp_idct(c), P.hp_idct(P.hp_dct(big))[:40, :136])
    c8 = c.to(torch.int8)
    s = P.hp_scaled_decode_u8(c8, 2, 4, out_u8=True)
    assert s.shape == (20, 34)
    assert torch.equal(s, P.hp_scaled_decode_u8(P.hp_dct(big).to(torch.int8), 2, 4, out_u8=True)[:20, :34])
