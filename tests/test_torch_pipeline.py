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
- The f32 kernel paths (hp_dct, hp_idct, both roundtrip cores, "high"):
  the classes stated in test_torch_hp.py — coefficients bit-identical on
  the integer core and within the tie class on the f32-literal core; f32
  reconstructions within 1e-4 (2e-3 for "high"); u8 reconstructions within
  the per-block tie-flip bound and +-1 on at most 5e-3 of pixels.
- Scaled and stacked dispatch: every stacked result is bit-identical to its
  per-image helper; against the reference, the u8 classes above (seen: 0
  differing pixels for the default config).
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
    assert set(tpudct_torch.available_pipelines()) == set(tpudct.available_pipelines())
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
    c, r = PD.roundtrip_gray_auto(p, img, cfg, device="cpu")
    c_ref, r_ref = RD.roundtrip_gray_auto(rp, img, rcfg)
    assert isinstance(r, np.ndarray) and r.dtype == np.uint8
    assert tuple(c.shape) == np.shape(c_ref) and c.numpy().dtype == np.asarray(c_ref).dtype
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    _assert_recon(r, r_ref)


@pytest.mark.parametrize("shape", [(100, 200), (250, 130), (64, 256)])
def test_encode_decode_gray_auto_match_reference(shape):
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    img = _img(shape, seed=shape[1])
    c, hw = PD.encode_gray_auto(p, img, cfg, device="cpu")
    c_ref, hw_ref = RD.encode_gray_auto(rp, img, rcfg)
    assert hw == hw_ref and c.dtype == torch.int8
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    r = PD.decode_gray_auto(p, c.numpy(), cfg, hw, device="cpu")
    r_ref = RD.decode_gray_auto(rp, np.asarray(c_ref), rcfg, hw_ref)
    _assert_recon(r, r_ref)
    # split path == fused path, bit for bit
    c2, r2 = PD.roundtrip_gray_auto(p, img, cfg, device="cpu")
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
    """These seven calls refused with NotImplementedError until hp_dct,
    hp_idct, the f32-literal core and the "high" mapping were ported; each
    now runs and matches the reference's same call under the same config."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs(**kw)
    u8 = _img((32, 128), seed=15)
    c8 = np.array(rp.encode_u8(jnp.asarray(u8), tpudct.CodecConfig()))
    arg = {"roundtrip_u8": u8, "decode_u8": c8, "idct": c8.astype(np.float32)}.get(
        call, u8.astype(np.float32))
    mine = getattr(p, call)(torch.as_tensor(arg), cfg)
    ref = getattr(rp, call)(jnp.asarray(arg), rcfg)
    if call == "dct":
        assert np.array_equal(mine.numpy(), np.asarray(ref))
    elif call == "idct":
        assert np.abs(mine.numpy() - np.asarray(ref)).max() <= 1e-4
    elif call == "decode_u8":  # "dct" decodes at "highest"
        _assert_recon(mine.numpy(), ref, 5e-3)
    else:
        (c, r), (c_ref, r_ref) = mine, ref
        _assert_tie_class(c.numpy(), c_ref, r.numpy(), r_ref, cfg)
        if cfg.exact_int_core and cfg.transform != "dct":  # the same coefficients
            _assert_recon(r.numpy(), r_ref, 5e-3)


_F32_CFGS = [{"exact_int_core": False}, {"transform": "dct"}, {"decode_precision": "high"},
             {"q_scale": 0.5}]


@pytest.mark.parametrize("call", ["dct", "idct", "roundtrip", "encode"])
@pytest.mark.parametrize("kw", _F32_CFGS)
def test_hp_f32_paths_match_reference(kw, call):
    """dct, idct, roundtrip and encode at kernel shapes (hp_dct, hp_idct,
    hp_roundtrip on either core) under the configs that reach the f32
    kernels: coefficients within the tie class (bit-identical on the
    integer core), reconstructions within the per-block tie-flip bound and
    +-1 on at most 5e-3 of pixels ("high" and "highest" tiers)."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs(retain_k=6, **kw) if call == "encode" else _cfgs(**kw)
    img = _img((64, 256), seed=16, dtype=np.float32)
    int_core = cfg.exact_int_core and cfg.transform != "dct"
    if call == "idct":
        c = np.array(rp.dct(jnp.asarray(img), rcfg))
        r, r_ref = p.idct(torch.as_tensor(c), cfg), rp.idct(jnp.asarray(c), rcfg)
        tol = 2e-3 if cfg.decode_precision == "high" else 1e-4
        assert np.abs(r.numpy() - np.asarray(r_ref)).max() <= tol
        return
    mine = getattr(p, call)(torch.as_tensor(img), cfg)
    ref = getattr(rp, call)(jnp.asarray(img), rcfg)
    if call == "roundtrip":
        (c, r), (c_ref, r_ref) = mine, ref
        _assert_tie_class(c.numpy(), c_ref, r.numpy(), r_ref, cfg)
        if int_core:
            _assert_recon(r.numpy(), r_ref, 5e-3)
    elif int_core:
        assert np.array_equal(mine.numpy(), np.asarray(ref))
    else:
        _assert_ties(mine.numpy(), ref)


@pytest.mark.parametrize("kw", [{"q_scale": 0.5}, {"transform": "dct"}, {"exact_int_core": False}])
def test_gray_auto_f32_paths_match_reference(kw):
    """Configs off the int8 kernels encode through Pipeline.encode (hp_dct)
    and decode through hp_idct (exact_int_core=False alone stays on the
    int8 kernels, as in the reference): against the reference's auto
    helpers, and split == fused."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs(**kw)
    img = _img((100, 200), seed=17)
    c, hw = PD.encode_gray_auto(p, img, cfg, device="cpu")
    c_ref, hw_ref = RD.encode_gray_auto(rp, img, rcfg)
    assert hw == hw_ref and tuple(c.shape) == np.shape(c_ref)
    assert c.numpy().dtype == np.asarray(c_ref).dtype
    _assert_ties(c.numpy(), c_ref)
    r = PD.decode_gray_auto(p, c.numpy(), cfg, hw, device="cpu")
    r_ref = RD.decode_gray_auto(rp, np.asarray(c_ref), rcfg, hw_ref)
    assert r.shape == r_ref.shape and r.dtype == np.uint8
    if cfg.transform != "dct":  # the same coefficients
        assert np.array_equal(c.numpy(), np.asarray(c_ref))
        _assert_recon(r, r_ref)
    c2, r2 = PD.roundtrip_gray_auto(p, img, cfg, device="cpu")
    assert torch.equal(c2, c) and np.array_equal(r2, r)


@pytest.mark.parametrize("m", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("shape", [(100, 200), (250, 130)])
def test_decode_gray_scaled_auto_matches_reference(shape, m):
    """Integer factors ride scaled_decode_u8, m = 6 the area-resample
    einsum, m = 8 the full decode: the cropped u8 plane matches the
    reference's +-1 on at most 1e-4 of pixels (seen: 0)."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    c, hw = PD.encode_gray_auto(p, _img(shape, seed=m), cfg, device="cpu")
    r = PD.decode_gray_scaled_auto(p, c.numpy(), cfg, hw, m, device="cpu")
    r_ref = RD.decode_gray_scaled_auto(rp, c.numpy(), rcfg, hw, m)
    assert r.dtype == np.uint8 and r.shape == r_ref.shape
    _assert_recon(r, r_ref)
    # a tensor in gives the same plane
    assert np.array_equal(PD.decode_gray_scaled_auto(p, c, cfg, hw, m), r)


def _batch_inputs():
    rng = np.random.default_rng(18)
    shapes = [(100, 200), (64, 256), (40, 136), (100, 200), (250, 130), (64, 256)]
    return [rng.integers(0, 256, size=s, dtype=np.uint8) for s in shapes]


@pytest.mark.parametrize("kw", [{}, {"q_scale": 0.5}])
def test_encode_gray_batch_auto_matches_per_image_and_reference(kw):
    (p, rp), (cfg, rcfg) = _pair(), _cfgs(**kw)
    imgs = _batch_inputs()
    imgs[2] = imgs[2].astype(np.float32)  # an f32 image joins its own group
    out = PD.encode_gray_batch_auto(p, imgs, cfg, device="cpu")
    ref = RD.encode_gray_batch_auto(rp, imgs, rcfg)
    for img, (c, hw), (c_ref, hw_ref) in zip(imgs, out, ref):
        c1, hw1 = PD.encode_gray_auto(p, img, cfg, device="cpu")
        assert isinstance(c, np.ndarray) and hw == hw1 == hw_ref
        assert np.array_equal(c, c1.numpy())
        _assert_ties(c, c_ref)
    # chunking splits the stacks and changes nothing
    for (c, _), (c2, _) in zip(out, PD.encode_gray_batch_auto(p, imgs, cfg, max_pixels=30000,
                                                                    device="cpu")):
        assert np.array_equal(c, c2)


def test_decode_gray_batch_auto_matches_per_image_and_reference():
    (p, rp) = _pair()
    cfgs = [_cfgs(), _cfgs(q_scale=0.5), _cfgs(decode_precision="highest")]
    items, ritems = [], []
    for i, img in enumerate(_batch_inputs()):
        cfg, rcfg = cfgs[i % 3]
        c, hw = PD.encode_gray_auto(p, img, cfg, device="cpu")
        items.append((c.numpy(), cfg, hw))
        ritems.append((c.numpy(), rcfg, hw))
    out = PD.decode_gray_batch_auto(p, items, device="cpu")
    ref = RD.decode_gray_batch_auto(rp, ritems)
    for (c, cfg, hw), r, r_ref in zip(items, out, ref):
        assert np.array_equal(r, PD.decode_gray_auto(p, c, cfg, hw, device="cpu"))
        _assert_recon(r, r_ref, 5e-3)


@pytest.mark.parametrize("m", [2, 4, 6])
def test_decode_gray_scaled_batch_auto_matches_per_image_and_reference(m):
    (p, rp) = _pair()
    cfgs = [_cfgs(), _cfgs(q_scale=2.5), _cfgs(q_scale=0.5)]
    items, ritems = [], []
    for i, img in enumerate(_batch_inputs()):
        cfg, rcfg = cfgs[i % 3]
        c, hw = PD.encode_gray_auto(p, img, cfg, device="cpu")
        items.append((c.numpy(), cfg, hw))
        ritems.append((c.numpy(), rcfg, hw))
    out = PD.decode_gray_scaled_batch_auto(p, items, m, device="cpu")
    ref = RD.decode_gray_scaled_batch_auto(rp, ritems, m)
    for (c, cfg, hw), r, r_ref in zip(items, out, ref):
        assert np.array_equal(r, PD.decode_gray_scaled_auto(p, c, cfg, hw, m, device="cpu"))
        _assert_recon(r, r_ref, 5e-3)


@pytest.mark.parametrize("cuda", [False, True])
def test_host_arrays_run_on_the_default_device(cuda, monkeypatch):
    """Host arrays run on the first card; without one they raise unless the
    caller names the CPU; a tensor stays where it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    if cuda:
        assert PD.default_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PD.default_device()
        p, cfg = _pair()[0], _cfgs()[0]
        img = _batch_inputs()[0]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PD.encode_gray_auto(p, img, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PD.encode_gray_batch_auto(p, [img], cfg)
        from tpudct_torch.entry import entry

        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert PD.default_device("cpu") == torch.device("cpu")
    monkeypatch.undo()
    # every stacked chunk and every host array goes through default_device()
    calls = []
    monkeypatch.setattr(PD, "default_device", lambda device=None: calls.append(device) or torch.device("cpu"))
    p, cfg = _pair()[0], _cfgs()[0]
    imgs = _batch_inputs()
    out = PD.encode_gray_batch_auto(p, imgs, cfg, max_pixels=30000, device="cpu")
    n_chunks = len(calls)
    assert n_chunks >= 3 and set(calls) == {"cpu"}
    calls.clear()
    for img, (c, _) in zip(imgs, out):
        assert np.array_equal(PD.encode_gray_auto(p, img, cfg, device="cpu")[0].numpy(), c)
    assert calls == ["cpu"] * len(imgs)
    calls.clear()
    PD.encode_gray_auto(p, torch.as_tensor(imgs[0]), cfg)  # a tensor stays where it is
    assert not calls


def test_entry_matches_reference_entry():
    import __graft_entry__
    from tpudct_torch.entry import entry

    fn, (x,) = entry("cpu")
    rfn, (rx,) = __graft_entry__.entry()
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert np.array_equal(x.numpy(), np.asarray(rx))
    (c, r), (c_ref, r_ref) = fn(x), rfn(rx)
    assert np.array_equal(c.numpy(), np.asarray(c_ref))
    _assert_recon(r.numpy(), r_ref)


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
    u8 = selftest.correctness_gate(p, cfg, device="cpu")
    assert u8["gate"] == "pass" and u8["path"] == "u8" and u8["device"] == "cpu"
    f32 = selftest.correctness_gate(p, cfg, size=256, force_f32=True, device="cpu")
    assert f32["path"] == "f32"
    assert selftest.correctness_gate(tpudct_torch.get_pipeline("batched"), cfg, size=256,
                                    device="cpu")["gate"] == "pass"


def test_selftest_gate_fails_a_wrong_codec():
    class Broken(type(tpudct_torch.get_pipeline("hp"))):
        def roundtrip_u8(self, image_u8, cfg):
            c, r = super().roundtrip_u8(image_u8, cfg)
            return c, r ^ 4  # flip a bit of every pixel

    with pytest.raises(AssertionError):
        selftest.correctness_gate(Broken(), tpudct_torch.CodecConfig(), size=128, device="cpu")


def test_family_gates_pass_on_cpu():
    for name in ("hp", "batched"):
        reps = selftest.family_gates(tpudct_torch.get_pipeline(name), tpudct_torch.CodecConfig(),
                                     device="cpu")
        streamed = ["streamed_gray", "streamed_color"] if name == "hp" else ["streamed"]
        assert [r["family"] for r in reps] == ["color420_u8", "f32", "scaled", *streamed]
        assert reps[0]["gate"] == reps[-1]["gate"] == ("pass" if name == "hp" else "skip")
        assert all(r["gate"] == "pass" for r in reps[1:3])
        assert reps[2]["max_dev"] <= 1e-2 and ("fast_path" in reps[2]) == (name == "hp")


@pytest.mark.parametrize("kw", [{"transform": "dct"}, {"q_scale": 0.5}, {"exact_int_core": False},
                                {"q_scale": 2.5, "retain_k": 6}])
def test_selftest_gate_follows_config(kw):
    """The golden is built from the config (transform, Q table, q_scale,
    retain_k); the f32 roundtrip passes it under each config."""
    import tests.golden as G
    from tpudct_torch.constants import get_q_table, get_transform

    cfg = tpudct_torch.CodecConfig(**kw)
    img = _img((64, 64), seed=19, dtype=np.float32)
    mine = selftest.golden_for(img, cfg)
    ref = G.golden_roundtrip(img, cfg.q_scale, cfg.retain_k, t=get_transform(cfg.transform).t,
                             q=get_q_table(cfg.q_table))
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rep = selftest.correctness_gate(tpudct_torch.get_pipeline("hp"), cfg, size=128, force_f32=True,
                                   device="cpu")
    assert rep["gate"] == "pass"


def test_selftest_golden_equals_test_golden():
    import tests.golden as G

    img = _img((64, 64), seed=14, dtype=np.float32)
    for kw in ({}, {"q_scale": 2.5, "retain_k": 6}):
        for a, b in zip(selftest.golden_roundtrip(img, **kw), G.golden_roundtrip(img, **kw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # the default config's golden is the default golden
    for a, b in zip(selftest.golden_for(img, tpudct_torch.CodecConfig()), G.golden_roundtrip(img)):
        assert np.array_equal(a, b)
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
