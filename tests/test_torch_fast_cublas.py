"""tpudct_torch `fast` and `cublas` pipelines against the reference's and the
float64 golden model, on the CPU (both are plain torch: the reference runs
them through XLA).

Tolerances and their reasons:
- fast coefficients: bit-identical.  The core Ts X Ts^T is an exact integer
  in both packages (float64 here, int32 there), then the same f32 scale
  product and the same round half away.
- fast reconstruction: the reference contracts the inverse in f32 at
  "highest", the port in float64 rounded once, so a u8 pixel on an integer
  edge may truncate the other way: +-1 on at most 0.5% of pixels (seen: 0
  for haweel); the Walsh-Hadamard core (wht) puts reconstructions exactly
  on integers, where every ulp decides the truncation: +-1 on at most 2.5%
  (seen: 134 of 8,192, as ROADMAP C counts for the hp kernels).
- cublas: both contract each block's two 8x8 GEMMs in another order (f32
  there, float64 here), so coefficients are +-1 at exact .5 quantizer ties
  on at most 0.5% of entries and reconstructions within the per-block
  tie-flip bound; against tests/golden.py the same tie class.
- Refusals: the same exception type and message as the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudct
import tpudct_torch
from tests.golden import golden_roundtrip
from tpudct_torch.models import cublas_like

TRANSFORMS = ("haweel", "rdct", "wht", "bas")
SHAPES = ((128, 256), (72, 40))  # lane-aligned (the reference's block-diagonal branch) and ragged


def _pair(name):
    return tpudct_torch.get_pipeline(name), tpudct.get_pipeline(name)


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.float32)


def _ties(mine, ref, share=0.005):
    d = np.abs(np.asarray(mine, np.float64) - np.asarray(ref, np.float64))
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= max(4, share * d.size), ((d > 0).sum(), d.max())
    return int((d > 0).sum())


def _tie_flip_bound(c, c_ref, r, r_ref, cfg):
    """A flipped coefficient (u, v) moves a pixel of its block by at most
    0.5 * Q[u, v] q_scale; flips add up; truncation adds 1."""
    cd = np.abs(np.asarray(c, np.float64) - np.asarray(c_ref, np.float64))
    rd = np.abs(np.asarray(r, np.int64) - np.asarray(r_ref, np.int64))
    nbh, nbw = cd.shape[0] // 8, cd.shape[1] // 8
    q8 = tpudct_torch.constants.get_q_table(cfg.q_table) * cfg.q_scale
    bound = 0.5 * np.einsum("aibj,ij->ab", cd.reshape(nbh, 8, nbw, 8), q8) + 1.0
    assert (rd.reshape(nbh, 8, nbw, 8).max(axis=(1, 3)) <= bound).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_fast_coefficients_bit_identical_to_reference(transform, shape):
    p, rp = _pair("fast")
    cfg, rcfg = tpudct_torch.CodecConfig(transform=transform), tpudct.CodecConfig(transform=transform)
    img = _img(shape, seed=shape[1] + len(transform))
    c = p.dct(torch.as_tensor(img), cfg)
    c_ref = np.asarray(rp.dct(jnp.asarray(img), rcfg))
    assert c.dtype == torch.float32 and c.shape == c_ref.shape
    assert np.array_equal(c.numpy(), c_ref)


@pytest.mark.parametrize("kw", [{}, {"q_scale": 2.5}, {"retain_k": 6}, {"q_table": "chroma"},
                                {"transform": "wht"}])
def test_fast_roundtrip_within_the_tie_class(kw):
    """Coefficients bit-identical, reconstructions +-1 on <= 0.5% (the
    inverse's summation order)."""
    p, rp = _pair("fast")
    cfg, rcfg = tpudct_torch.CodecConfig(**kw), tpudct.CodecConfig(**kw)
    img = _img((64, 128), seed=3)
    c, r = p.roundtrip(torch.as_tensor(img), cfg)
    c_ref, r_ref = rp.roundtrip(jnp.asarray(img), rcfg)
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    assert r.dtype == torch.uint8
    _ties(r.numpy(), r_ref, 0.025 if kw.get("transform") == "wht" else 0.005)
    rec = p.idct(c, cfg).numpy()
    assert np.allclose(rec, np.asarray(rp.idct(jnp.asarray(c_ref), rcfg)), atol=1e-3)


def test_fast_takes_integer_images_and_ignores_matmul_precision():
    """uint8 input keeps its scale (the reference's all-zero-map fault); a
    reduced f32 matmul precision does not reach the float64 core."""
    p = tpudct_torch.get_pipeline("fast")
    cfg = tpudct_torch.CodecConfig()
    img = _img((64, 64), seed=4)
    want = p.dct(torch.as_tensor(img), cfg)
    assert torch.equal(p.dct(torch.as_tensor(img.astype(np.uint8)), cfg), want)
    assert want.abs().sum() > 0
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        assert torch.equal(p.dct(torch.as_tensor(img), cfg), want)
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.parametrize("name", ["fast", "cublas"])
def test_refusals_match_reference(name):
    p, rp = _pair(name)
    img = _img((64, 64), seed=5)
    for kw in ({"deadzone": 0.35},) + (({"transform": "dct"},) if name == "fast" else ()):
        with pytest.raises(ValueError) as mine:
            p.dct(torch.as_tensor(img), tpudct_torch.CodecConfig(**kw))
        with pytest.raises(ValueError) as ref:
            rp.dct(jnp.asarray(img), tpudct.CodecConfig(**kw))
        assert str(mine.value) == str(ref.value)
    if name == "fast":
        with pytest.raises(ValueError, match="no integer core"):
            p.idct(torch.zeros(8, 8), tpudct_torch.CodecConfig(transform="dct"))


@pytest.mark.parametrize("kw", [{}, {"q_scale": 2.5}, {"retain_k": 6}, {"transform": "rdct"},
                                {"transform": "dct"}])
def test_cublas_matches_reference_and_golden(kw):
    p, rp = _pair("cublas")
    cfg, rcfg = tpudct_torch.CodecConfig(**kw), tpudct.CodecConfig(**kw)
    img = _img((64, 64), seed=6)
    c, r = p.roundtrip(torch.as_tensor(img), cfg)
    c_ref, r_ref = rp.roundtrip(jnp.asarray(img), rcfg)
    assert c.dtype == torch.float32 and r.dtype == torch.uint8
    _ties(c.numpy(), c_ref)
    _tie_flip_bound(c.numpy(), c_ref, r.numpy(), r_ref, cfg)
    t = tpudct_torch.constants.get_transform(cfg.transform).t
    gc, gr = golden_roundtrip(img, q_scale=cfg.q_scale, retain_k=cfg.retain_k, t=t)
    _ties(c.numpy(), gc)
    _tie_flip_bound(c.numpy(), gc, r.numpy(), gr, cfg)


def test_cublas_is_capped():
    p = tpudct_torch.get_pipeline("cublas")
    side = int(cublas_like.MAX_PIXELS ** 0.5)
    with pytest.raises(ValueError, match="at most"):
        p.dct(torch.zeros(side + 8, side), tpudct_torch.CodecConfig())
    with pytest.raises(ValueError, match="at most"):
        p.idct(torch.zeros(side, side + 8), tpudct_torch.CodecConfig())
