"""tpudct_torch study kernels (kernels/study.py, B17-B20) and study drivers
against the reference's study modules in benchmarks/, on the CPU (the
wrappers run their plain twins; the reference's Pallas kernels run in
interpret mode).

The reference modules are loaded from benchmarks/ with importlib, never
edited, with bytecode writing off so nothing lands in benchmarks/.

Tolerances and their reasons:
- B17/B18 twins: bit-identical (a copy; the int8 map is the wrapping cast).
- B19 twin against color_encode_420_u8: the port rounds every f32 product
  and sum of the BT.601 transforms on its own; XLA on the CPU may contract
  them into FMAs (shown for the split's chroma in test_torch_color.py),
  which moves a luma or chroma value across a .5 tie and so one u8 level
  and one coefficient: +-1 on at most 0.5% of each plane (seen: 5 and 1
  luma entries of 262,144 at seeds 5 and 6, 0 chroma).
- B20 twin against color_decode_420_u8 on the same coefficients: +-1 on at
  most 0.5% of outputs for the same reason (seen: 0).
- Fused against composed, both in the port: the decode bit-identical on the
  same coefficients (B20's compare-form round equals B9's add form on every
  input); the encode's Cb and Cr bit-identical; its Y +-1 on at most 0.5%
  (the study's f32 luma against the production fixed-point luma; the
  reference counts 22 of 262,144 at seed 5).
"""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpudct_torch
import tpudct_torch.kernels.study as S
from tpudct_torch.models.color import decode_color_u8, encode_color_u8

_ROOT = pathlib.Path(__file__).resolve().parents[1]
PLANES = ("y", "cb", "cr")


def _load(name: str):
    """benchmarks/<name>.py as a module, without writing its bytecode."""
    spec = importlib.util.spec_from_file_location(f"_reference_{name}", _ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    old = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.dont_write_bytecode = old
    return mod


@pytest.fixture(scope="module")
def u8_perf():
    return _load("u8_perf")


@pytest.fixture(scope="module")
def fused_ab():
    return _load("color_fused_ab")


def _rgb(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _within(mine, ref, share=0.005) -> int:
    """+-1 on at most `share` of entries; returns the differing count."""
    d = np.abs(np.asarray(mine, np.int64) - np.asarray(ref, np.int64))
    assert d.shape == np.shape(ref) and d.max(initial=0) <= 1, d.max()
    n = int((d > 0).sum())
    assert n <= share * d.size, n
    return n


def test_reference_modules_leave_no_bytecode(u8_perf, fused_ab):
    assert not (_ROOT / "benchmarks" / "__pycache__").exists() or not any(
        p.name.startswith(("u8_perf", "color_fused_ab")) for p in (_ROOT / "benchmarks" / "__pycache__").iterdir()
    )


@pytest.mark.parametrize("shape", [(256, 2048), (512, 4096)])
def test_copy_twins_bit_identical_to_reference(u8_perf, shape):
    x = _rgb(shape, seed=shape[1])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(u8_perf.u8_copy(jnp.asarray(x)))
        ref2, ref2_i8 = (np.asarray(v) for v in u8_perf.u8_copy2(jnp.asarray(x)))
    t = torch.as_tensor(x.copy())
    out = S.u8_copy(t)
    assert out is t and np.array_equal(out.numpy(), ref)
    u, i8 = S.u8_copy2(t)
    assert u is t and i8.dtype == torch.int8 and ref2_i8.dtype == np.int8
    assert np.array_equal(u.numpy(), ref2) and np.array_equal(i8.numpy(), ref2_i8)


def test_copy_wrappers_take_any_u8_map_and_refuse_others():
    """The kernels copy any byte count (16-byte vectors and a tail), so the
    wrappers take any 2-D u8 map."""
    x = torch.as_tensor(_rgb((3, 1001), seed=1))
    want = x.clone()
    assert torch.equal(S.u8_copy(x), want)
    u, i8 = S.u8_copy2(x)
    assert torch.equal(u, want) and torch.equal(i8, want.view(torch.int8))
    with pytest.raises(TypeError, match="torch.uint8"):
        S.u8_copy(x.to(torch.int8))
    with pytest.raises(ValueError, match="2-D"):
        S.u8_copy2(x[None])
    with pytest.raises(TypeError, match="torch.Tensor"):
        S.u8_copy(x.numpy())


@pytest.mark.parametrize("kw", [{}, {"q_scale": 2.5, "retain_k": 6}])
@pytest.mark.parametrize("seed", [5, 6])
def test_fused_encode_twin_matches_reference(fused_ab, seed, kw):
    rgb = _rgb((3, 256, 1024), seed)
    ref = fused_ab.color_encode_420_u8(jnp.asarray(rgb), interpret=True, **kw)
    mine = S.color_encode_420_u8(torch.as_tensor(rgb), **kw)
    for a, b in zip(mine, ref):
        b = np.asarray(b)
        assert a.dtype == torch.int8 and tuple(a.shape) == b.shape
        _within(a.numpy(), b)


@pytest.mark.parametrize("seed", [5, 6])
def test_fused_decode_twin_matches_reference(fused_ab, seed):
    rgb = _rgb((3, 256, 1024), seed)
    planes = [np.asarray(v) for v in fused_ab.color_encode_420_u8(jnp.asarray(rgb), interpret=True)]
    ref = np.asarray(fused_ab.color_decode_420_u8(*(jnp.asarray(v) for v in planes), interpret=True))
    mine = S.color_decode_420_u8(*(torch.as_tensor(v.copy()) for v in planes))
    assert mine.dtype == torch.uint8 and tuple(mine.shape) == ref.shape == (3, 256, 1024)
    _within(mine.numpy(), ref)


@pytest.mark.parametrize("seed", [5, 6])
def test_fused_pair_against_the_composed_path(seed):
    """On the port's own composed path (encode_color_u8 / decode_color_u8):
    the fused decode bit-identical on the same coefficients, the fused
    encode's chroma bit-identical, its luma counted."""
    p, cfg = tpudct_torch.get_pipeline("hp"), tpudct_torch.CodecConfig()
    rgb = torch.as_tensor(_rgb((3, 256, 1024), seed))
    planes, meta = encode_color_u8(p, rgb, cfg)
    fused = S.color_encode_420_u8(rgb)
    assert torch.equal(fused[1], planes["cb"]) and torch.equal(fused[2], planes["cr"])
    n_luma = _within(fused[0].numpy(), planes["y"].numpy())
    assert n_luma > 0  # the two luma roundings do part on noise
    composed = decode_color_u8(p, planes, meta, cfg).movedim(-1, 0)
    assert torch.equal(S.color_decode_420_u8(*(planes[k] for k in PLANES)), composed)


def test_fused_wrappers_refuse_like_reference(fused_ab):
    y = torch.zeros(64, 256, dtype=torch.int8)
    c = torch.zeros(32, 128, dtype=torch.int8)
    with pytest.raises(ValueError) as mine:
        S.color_decode_420_u8(y, c[:16], c)
    with pytest.raises(ValueError) as ref:
        fused_ab.color_decode_420_u8(jnp.asarray(y.numpy()), jnp.asarray(c[:16].numpy()),
                                     jnp.asarray(c.numpy()), interpret=True)
    assert str(mine.value).split(", got")[0] == str(ref.value).split(", got")[0]
    with pytest.raises(ValueError, match="H % 64 == 0 and W % 256 == 0"):
        S.color_encode_420_u8(torch.zeros(3, 32, 256, dtype=torch.uint8))
    with pytest.raises(ValueError, match="H % 64 == 0 and W % 256 == 0"):
        S.color_decode_420_u8(torch.zeros(64, 128, dtype=torch.int8), *(torch.zeros(32, 64, dtype=torch.int8),) * 2)
    with pytest.raises(ValueError, match="planar RGB"):
        S.color_encode_420_u8(torch.zeros(4, 64, 256, dtype=torch.uint8))
    with pytest.raises(TypeError, match="torch.int8"):
        S.color_decode_420_u8(y.to(torch.uint8), c, c)
    with pytest.raises(ValueError, match="'dct' has none"):
        S.color_encode_420_u8(torch.zeros(3, 64, 256, dtype=torch.uint8), transform="dct")


def test_twins_count_no_launches():
    S.reset_launches()
    x = torch.as_tensor(_rgb((3, 64, 256), seed=2))
    S.color_decode_420_u8(*S.color_encode_420_u8(x))
    S.u8_copy2(S.u8_copy(x[0].contiguous()))
    assert set(S.LAUNCHES.values()) == {0}


def test_u8_perf_main_on_the_cpu(capsys):
    from tpudct_torch.studies import u8_perf

    out = u8_perf.main(256, device="cpu")
    keys = {"u8_copy_ms", "u8_copy2_ms", "hp_encode_u8_ms", "hp_decode_u8_ms", "hp_roundtrip_u8_ms"}
    assert keys <= set(out) and all(out[k] > 0 for k in keys)
    assert out["card"].startswith("cpu") and out["size"] == 256
    assert out["roundtrip_over_floor"] == out["hp_roundtrip_u8_ms"] / out["u8_copy2_ms"]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and all(line.endswith("[cpu: host clock, not a device time]") for line in lines)


def test_color_fused_ab_main_on_the_cpu(capsys):
    from tpudct_torch.studies import color_fused_ab

    out = color_fused_ab.main(256, device="cpu")
    assert out["decode_differ"] == 0 and out["cb_differ"] == 0 and out["cr_differ"] == 0
    assert 0 < out["y_differ"] <= 0.005 * out["entries"]["y"] and out["y_max_diff"] == 1
    for side in ("composed", "fused"):
        for stage in ("roundtrip", "encode", "decode"):
            assert out[f"{side}_{stage}_ms"] > 0
    assert "fused vs composed" in capsys.readouterr().out


def test_study_entry_points_follow_the_device_rule(monkeypatch):
    """Without a card and without device=, the drivers raise."""
    from tpudct_torch.studies import color_fused_ab, u8_perf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (u8_perf.main, color_fused_ab.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(256)
