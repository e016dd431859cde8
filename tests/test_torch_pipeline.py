"""tpudct_torch pipelines, dispatch and self-test against the reference.

Tolerances and their reasons:
- hp (default config, haweel butterfly): coefficients bit-identical; the
  uint8 reconstruction +-1 on at most 1e-4 of pixels (the inverse's
  lane-direction summation order differs, see test_torch_hp.py; seen: 0).
- batched: both packages run an f32 einsum in different orders, so
  coefficients may differ by +-1 at exact .5 quantizer ties on at most
  0.5% of entries — the reference's own equivalence class between its
  pipelines; against the float64 golden model the same class holds.
- Refusals: the same exception type and message as the reference.
"""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudct
import tpudct.models.dispatch as RD
import tpudct_torch
import tpudct_torch.constants
import tpudct_torch.models.dispatch as PD
from tests.golden import golden_roundtrip
from tpudct.benchmark import synthetic_image
from tpudct_torch import selftest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(name="hp"):
    return tpudct_torch.get_pipeline(name), tpudct.get_pipeline(name)


def _cfgs(**kw):
    return tpudct_torch.CodecConfig(**kw), tpudct.CodecConfig(**kw)


def _img(shape, seed=0, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(dtype)


def _assert_recon(mine, ref, share=1e-4):
    d = np.abs(np.asarray(mine, np.int64) - np.asarray(ref, np.int64))
    assert d.shape == np.shape(ref) and d.max() <= 1
    assert (d > 0).sum() <= share * d.size


def _assert_ties(mine, ref):
    d = np.abs(np.asarray(mine, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 1 and (d > 0).sum() <= max(4, 0.005 * d.size)


def _assert_tie_class(c, c_ref, r, r_ref, cfg):
    """Coefficients within the tie class, and reconstructions within the
    per-block tie-flip bound: a flipped coefficient (u, v) moves a pixel of
    its block by at most 0.5 * Q[u, v]; flips add up; truncation adds 1."""
    _assert_ties(c, c_ref)
    cd = np.abs(np.asarray(c, np.float64) - np.asarray(c_ref, np.float64))
    rd = np.abs(np.asarray(r, np.int64) - np.asarray(r_ref, np.int64))
    nbh, nbw = cd.shape[0] // 8, cd.shape[1] // 8
    q8 = tpudct_torch.constants.get_q_table(cfg.q_table) * cfg.q_scale
    bound = 0.5 * np.einsum("aibj,ij->ab", cd.reshape(nbh, 8, nbw, 8), q8) + 1.0
    assert (rd.reshape(nbh, 8, nbw, 8).max(axis=(1, 3)) <= bound).all()


def test_public_names_match_reference():
    assert set(tpudct_torch.__all__) == set(tpudct.__all__)
    assert set(tpudct_torch.available_pipelines()) == {"batched", "hp"}
    assert tpudct_torch.get_pipeline("cublas2") is tpudct_torch.get_pipeline("batched")
    with pytest.raises(KeyError, match="unknown pipeline"):
        tpudct_torch.get_pipeline("nope")
    import dataclasses

    ref = {f.name: f.default for f in dataclasses.fields(tpudct.CodecConfig)}
    mine = {f.name: f.default for f in dataclasses.fields(tpudct_torch.CodecConfig)}
    assert mine == ref


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(100, 200), (250, 130), (64, 256)])
def test_roundtrip_gray_auto_matches_reference(shape, dtype):
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    img = _img(shape, seed=shape[0], dtype=dtype)
    c, r = PD.roundtrip_gray_auto(p, img, cfg)
    c_ref, r_ref = RD.roundtrip_gray_auto(rp, img, rcfg)
    assert isinstance(r, np.ndarray) and r.dtype == np.uint8
    assert tuple(c.shape) == np.shape(c_ref) and c.numpy().dtype == np.asarray(c_ref).dtype
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    _assert_recon(r, r_ref)


@pytest.mark.parametrize("shape", [(100, 200), (250, 130), (64, 256)])
def test_encode_decode_gray_auto_match_reference(shape):
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    img = _img(shape, seed=shape[1])
    c, hw = PD.encode_gray_auto(p, img, cfg)
    c_ref, hw_ref = RD.encode_gray_auto(rp, img, rcfg)
    assert hw == hw_ref and c.dtype == torch.int8
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    r = PD.decode_gray_auto(p, c.numpy(), cfg, hw)
    r_ref = RD.decode_gray_auto(rp, np.asarray(c_ref), rcfg, hw_ref)
    _assert_recon(r, r_ref)
    # split path == fused path, bit for bit
    c2, r2 = PD.roundtrip_gray_auto(p, img, cfg)
    assert torch.equal(c2, c) and np.array_equal(PD.decode_gray_auto(p, c, cfg, hw), r2)


@pytest.mark.parametrize("kw", [
    {}, {"q_scale": 0.5}, {"transform": "dct"}, {"deadzone": 0.35}, {"transform": "wht"},
    {"q_table": "chroma"}, {"q_scale": 0.76}, {"q_scale": 0.77},
])
def test_choose_gray_path_matches_reference(kw):
    cfg, rcfg = _cfgs(**kw)
    for name in ("hp", "batched"):
        p, rp = _pair(name)
        for h, w in [(100, 200), (250, 130), (4000, 2992), (8192, 8192), (5, 7), (32, 128)]:
            assert PD.choose_gray_path(p, h, w, cfg) == RD.choose_gray_path(rp, h, w, rcfg)


@pytest.mark.parametrize("kw", [{"q_scale": 0.5}, {"transform": "dct"}])
def test_roundtrip_u8_refusals_match_reference(kw):
    (p, rp), (cfg, rcfg) = _pair(), _cfgs(**kw)
    img = _img((32, 128))
    with pytest.raises(ValueError) as ref:
        rp.roundtrip_u8(jnp.asarray(img), rcfg)
    with pytest.raises(ValueError) as mine:
        p.roundtrip_u8(torch.as_tensor(img), cfg)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        rp.encode_u8(jnp.asarray(img), rcfg)
    with pytest.raises(ValueError) as mine:
        p.encode_u8(torch.as_tensor(img), cfg)
    assert str(mine.value) == str(ref.value)


def test_decode_u8_refuses_off_grid_like_reference():
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    c = np.zeros((40, 128), np.int8)
    with pytest.raises(ValueError) as ref:
        rp.decode_u8(jnp.asarray(c), rcfg)
    with pytest.raises(ValueError) as mine:
        p.decode_u8(torch.as_tensor(c), cfg)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("call,kw", [
    ("dct", {}), ("idct", {}), ("roundtrip", {"exact_int_core": False}),
    ("roundtrip", {"transform": "dct"}), ("roundtrip", {"decode_precision": "high"}),
    ("roundtrip_u8", {"decode_precision": "high"}), ("decode_u8", {"transform": "dct"}),
])
def test_unported_paths_raise_not_implemented(call, kw):
    p, cfg = tpudct_torch.get_pipeline("hp"), tpudct_torch.CodecConfig(**kw)
    u8 = torch.as_tensor(_img((32, 128)))
    arg = {"roundtrip_u8": u8, "decode_u8": torch.zeros((32, 128), dtype=torch.int8)}.get(
        call, u8.to(torch.float32))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.3"):
        getattr(p, call)(arg, cfg)


@pytest.mark.parametrize("kw", [{}, {"retain_k": 6}, {"q_scale": 2.5}, {"decode_precision": "highest"}])
def test_hp_f32_roundtrip_matches_reference(kw):
    """The pipeline's f32 roundtrip (the hp_roundtrip kernel, B4), the call
    the reference's entry() drives."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs(**kw)
    img = _img((64, 256), seed=9, dtype=np.float32)
    c, r = p.roundtrip(torch.as_tensor(img), cfg)
    c_ref, r_ref = rp.roundtrip(jnp.asarray(img), rcfg)
    assert c.dtype == torch.float32 and r.dtype == torch.uint8
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    _assert_recon(r.numpy(), r_ref, 5e-3 if kw.get("decode_precision") == "highest" else 1e-4)


@pytest.mark.parametrize("kw", [{}, {"deadzone": 0.35}, {"transform": "dct"}, {"retain_k": 4}])
def test_hp_falls_back_to_batched_where_reference_does(kw):
    """Width 120 fails the reference's lane gate; deadzone != 0.5 takes the
    einsum quantizer: both run plain torch here, as XLA there."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs(**kw)
    img = _img((64, 120), seed=11, dtype=np.float32)
    c, r = p.roundtrip(torch.as_tensor(img), cfg)
    c_ref, r_ref = rp.roundtrip(jnp.asarray(img), rcfg)
    _assert_tie_class(c.numpy(), c_ref, r.numpy(), r_ref, cfg)


@pytest.mark.parametrize("kw", [{}, {"q_scale": 2.5}, {"retain_k": 6}, {"deadzone": 0.35},
                                {"transform": "rdct"}, {"transform": "dct"}])
def test_batched_matches_reference_and_golden(kw):
    (p, rp), (cfg, rcfg) = _pair("batched"), _cfgs(**kw)
    img = _img((64, 128), seed=12, dtype=np.float32)
    c, r = p.roundtrip(torch.as_tensor(img), cfg)
    c_ref, r_ref = rp.roundtrip(jnp.asarray(img), rcfg)
    _assert_tie_class(c.numpy(), c_ref, r.numpy(), r_ref, cfg)
    if not kw or "q_scale" in kw or "retain_k" in kw:
        gc, gr = golden_roundtrip(img, q_scale=cfg.q_scale, retain_k=cfg.retain_k)
        _assert_ties(c.numpy(), gc)


def test_batch_and_channels_match_reference():
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    imgs = _img((3, 32, 128), seed=13, dtype=np.float32)
    c, r = p.roundtrip_batch(torch.as_tensor(imgs), cfg)
    c_ref, r_ref = rp.roundtrip_batch(jnp.asarray(imgs), rcfg)
    assert np.array_equal(c.numpy(), np.asarray(c_ref)) and r.shape == (3, 32, 128)
    _assert_recon(r.numpy(), r_ref)
    hwc = np.moveaxis(imgs, 0, -1).copy()
    c, r = p.roundtrip_channels(torch.as_tensor(hwc), cfg)
    c_ref, r_ref = rp.roundtrip_channels(jnp.asarray(hwc), rcfg)
    assert np.array_equal(c.numpy(), np.asarray(c_ref)) and r.shape == (32, 128, 3)
    _assert_recon(r.numpy(), r_ref)
    c, r = p.roundtrip_padded(torch.as_tensor(imgs[0, :30, :100]), cfg)
    c_ref, r_ref = rp.roundtrip_padded(jnp.asarray(imgs[0, :30, :100]), rcfg)
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    _assert_recon(r.numpy(), r_ref)


def test_selftest_gate_passes_on_cpu():
    p, cfg = tpudct_torch.get_pipeline("hp"), tpudct_torch.CodecConfig()
    u8 = selftest.correctness_gate(p, cfg)
    assert u8["gate"] == "pass" and u8["path"] == "u8" and u8["device"] == "cpu"
    f32 = selftest.correctness_gate(p, cfg, size=256, force_f32=True)
    assert f32["path"] == "f32"
    assert selftest.correctness_gate(tpudct_torch.get_pipeline("batched"), cfg, size=256)["gate"] == "pass"


def test_selftest_gate_fails_a_wrong_codec():
    class Broken(type(tpudct_torch.get_pipeline("hp"))):
        def roundtrip_u8(self, image_u8, cfg):
            c, r = super().roundtrip_u8(image_u8, cfg)
            return c, r ^ 4  # flip a bit of every pixel

    with pytest.raises(AssertionError):
        selftest.correctness_gate(Broken(), tpudct_torch.CodecConfig(), size=128)


def test_selftest_golden_equals_test_golden():
    import tests.golden as G

    img = _img((64, 64), seed=14, dtype=np.float32)
    for kw in ({}, {"q_scale": 2.5, "retain_k": 6}):
        for a, b in zip(selftest.golden_roundtrip(img, **kw), G.golden_roundtrip(img, **kw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(selftest.synthetic_image(64), synthetic_image(64))


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA here: the script exits non-zero and prints no result; alone in
    a directory (without the package) it fails as well."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [(_ROOT, os.path.join(_ROOT, "chip_smoke.py"))]
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    runs.append((str(tmp_path), str(tmp_path / "chip_smoke.py")))
    for cwd, script in runs:
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
