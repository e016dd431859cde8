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
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.3"):
        P.hp_decode_u8(x.to(torch.int8), decode_precision="high")


def test_kernels_need_only_8_aligned_shapes():
    """The twins (and kernels) take any 8-aligned shape, not only the
    reference's 32x128 grid; a block's result does not depend on its
    neighbours."""
    img = np.random.default_rng(5).integers(0, 256, size=(40, 136), dtype=np.uint8)
    c, r = P.hp_roundtrip_u8(torch.as_tensor(img))
    c_big, r_big = P.hp_roundtrip_u8(torch.as_tensor(np.pad(img, ((0, 24), (0, 120)))))
    assert torch.equal(c, c_big[:40, :136]) and torch.equal(r, r_big[:40, :136])
