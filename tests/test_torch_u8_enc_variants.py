"""The u8 study variants B27-B36 (kernels/variants.py) and their drivers
(tpudct_torch/studies/u8_variants.py, enc_variants.py, rt_split_ab.py,
scaled_ab.py) against the reference's ``benchmarks/u8_variants.py`` and
``benchmarks/enc_variants.py`` on the CPU: the port's functions run their
plain twins on CPU tensors, the reference's Pallas kernels run under
``pltpu.force_tpu_interpret_mode()``.  The reference modules are loaded
from benchmarks/ with importlib, never edited, with bytecode writing off.

Tolerances: none.  Every kernel function is held bit for bit against the
reference's on the same seeded u8 input: B27-B29's coefficients and
reconstructions, B30-B36's int8 maps, E2's (B30) at both ends of the int8
saturation (the reference's f32 -> int8 cast saturates; a plain cast
wraps).  The drivers report differences as counts, all 0.
"""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpudct_torch.kernels import hp
from tpudct_torch.kernels import variants as V

_ROOT = pathlib.Path(__file__).resolve().parents[1]


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
def uv():
    return _load("u8_variants")


@pytest.fixture(scope="module")
def ev():
    return _load("enc_variants")


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _saturating(shape, seed):
    """u8 noise with all-0, all-255 and alternating 0/255 8x8 blocks in every
    fourth block row (the level shift's extremes drive E2 to both ends of
    int8)."""
    x = _u8(shape, seed)
    alt = np.where((np.arange(8)[:, None] + np.arange(8)) % 2, 255, 0).astype(np.uint8)
    for i, bi in enumerate(range(0, shape[0], 32)):
        for j, bj in enumerate(range(0, shape[1], 8)):
            x[bi:bi + 8, bj:bj + 8] = (np.zeros((8, 8), np.uint8), np.full((8, 8), 255, np.uint8), alt)[(i + j) % 3]
    return x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("q_scale", [1.0, 2.5])
@pytest.mark.parametrize("name", ["rt_u8_vint", "rt_u8_vbf", "rt_u8_vcs"])
def test_roundtrip_variants_match_reference(uv, name, q_scale, seed):
    """B27-B29: coefficients and reconstructions bit-identical to the
    reference's kernel at 256x512, and to hp_roundtrip_u8's twin (B1)."""
    x = _u8((256, 512), seed)
    c, r = getattr(V, name)(torch.as_tensor(x), q_scale=q_scale)
    with pltpu.force_tpu_interpret_mode():
        c_ref, r_ref = getattr(uv, name)(jnp.asarray(x), q_scale=q_scale)
    assert c.dtype == torch.int8 and r.dtype == torch.uint8
    assert np.array_equal(c.numpy(), np.asarray(c_ref)) and np.array_equal(r.numpy(), np.asarray(r_ref))
    c1, r1 = hp.hp_roundtrip_u8(torch.as_tensor(x), q_scale=q_scale)
    assert torch.equal(c, c1) and torch.equal(r, r1)


# (kernel, br, tc, the reference's with_bias, whether it needs _b2_const, shape)
ENCODES = {
    "enc_nosub": ("_k_enc_nosub", 128, 512, False, False, (256, 512)),
    "enc_nolane": ("_k_enc_nolane", 128, 512, False, False, (256, 512)),
    "enc_xor": ("_k_enc_xor", 128, 512, False, False, (256, 512)),
    "enc_nibble": ("_k_enc_nibble", 128, 4096, True, False, (128, 4096)),
    "enc_truncless": ("_k_enc_truncless", 128, 4096, False, False, (128, 4096)),
    "enc_nibble_truncless": ("_k_enc_nibble_truncless", 128, 4096, True, False, (128, 4096)),
    "enc_k256": ("_k_enc_k256", 128, 4096, False, True, (128, 4096)),
}


@pytest.mark.parametrize("name", list(ENCODES))
def test_encode_variants_match_reference(ev, name):
    """B30-B36 against the reference's ``_mk(kern, br, tc, ...)``: int8 maps
    bit-identical; E4 and E6-E9 also equal to hp_encode_u8's twin (B2); E2's
    input reaches -128 and 127 in both."""
    kern, br, tc, wb, k256, shape = ENCODES[name]
    x = _saturating(shape, seed=len(name))
    mine = V._mk(getattr(V, kern), br, tc, with_bias=wb)(torch.as_tensor(x))
    extra = (ev._b2_const(),) if k256 else ()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ev._mk(getattr(ev, kern), br, tc, with_bias=wb, extra=extra)(jnp.asarray(x)))
    assert mine.dtype == torch.int8 and np.array_equal(mine.numpy(), ref)
    if name == "enc_nosub":
        assert (ref == -128).sum() > 0 and (ref == 127).sum() > 0
    elif name == "enc_nolane":
        assert np.abs(ref.astype(np.int64)).max() <= 17
    else:
        assert torch.equal(mine, hp.hp_encode_u8(torch.as_tensor(x)))


@pytest.mark.parametrize("shape,kw", [((40, 128), {}), ((64, 136), {}), ((64, 128), {"band_rows": 16}),
                                      ((64, 128), {"tile_cols": 64})])
def test_roundtrip_variants_refuse_what_the_reference_refuses(uv, shape, kw):
    """H % 32, W % 128 and the least band and tile: the reference's
    ValueError and message."""
    x = _u8(shape, 2)
    with pytest.raises(ValueError) as mine:
        V.rt_u8_vint(torch.as_tensor(x), **kw)
    with pytest.raises(ValueError) as ref:
        uv.rt_u8_vint(jnp.asarray(x), **kw)
    assert str(mine.value) == str(ref.value)


def test_mk_refuses_a_partial_grid():
    """The reference's grid (H // br, W // tc) would leave rows or columns
    unwritten: the port raises instead; a kernel function from elsewhere is
    refused too."""
    x = torch.as_tensor(_u8((256, 512), 3))
    for br, tc in ((256, 2048), (96, 512), (256, 384)):
        with pytest.raises(ValueError, match="unwritten"):
            V._mk(V._k_enc_xor, br, tc)(x)
    with pytest.raises(ValueError, match="encode_u8"):
        V._mk(V._k_rt_u8_interleave)
    assert V._mk(V._k_enc_xor, 128, 256)(x).shape == (256, 512)


def test_enc_half_twins_sum_the_stated_products():
    """E2's and E3's twins against a float64 numpy form of the same value
    chain (exact integer core, one f32 multiply, the f32 tie-add, trunc,
    saturation)."""
    x = _saturating((64, 128), 4)
    k = V._enc_args()
    ts = k.fwd.astype(np.int64)
    g = x.reshape(8, 8, 16, 8).astype(np.int64) - 128
    for twin, core in ((V.enc_nosub_plain, np.einsum("aibk,lk->aibl", 12 * g, ts)),
                       (V.enc_nolane_plain, np.einsum("ij,ajbl->aibl", ts, g))):
        z = core.astype(np.float32) * k.fq.reshape(1, 8, 1, 8)
        v = np.trunc(z + np.copysign(np.float32(0.5), z))
        if twin is V.enc_nosub_plain:  # past int8 at both ends: the saturation is needed
            assert v.min() < -128 and v.max() > 127
        want = np.clip(v, -128, 127).astype(np.int8).reshape(64, 128)
        assert np.array_equal(twin(torch.as_tensor(x)).numpy(), want)


def _no_launch():
    return all(v == 0 for v in V.LAUNCHES.values()) and all(v == 0 for v in hp.LAUNCHES.values())


@pytest.mark.parametrize("which", ["int", "bf", "abbf", "cs"])
def test_u8_variants_driver_on_the_cpu(monkeypatch, which):
    from tpudct_torch.studies import u8_variants

    monkeypatch.setattr(u8_variants, "REPS", 1)
    monkeypatch.setattr(u8_variants, "TRIALS", 2)
    V.reset_launches()
    hp.reset_launches()
    out = u8_variants.main(256, which, device="cpu")
    assert out.get("coeffs_differ", 0) == 0 and out.get("recon_differ", 0) == 0 and _no_launch()
    assert ("coeffs_differ" in out) == (which != "abbf")
    times = [t for v in out.get("trials", {}).values() for t in v] + [v for k, v in out.items() if k.endswith("_ms")]
    assert times and all(t > 0 for t in times)
    with pytest.raises(ValueError):
        u8_variants.main(256, "c", device="cpu")


@pytest.mark.parametrize("which", ["a", "b", "d", "e"])
def test_enc_variants_driver_on_the_cpu(monkeypatch, which):
    from tpudct_torch.studies import enc_variants

    monkeypatch.setattr(enc_variants, "REPS", 1)
    V.reset_launches()
    hp.reset_launches()
    out = enc_variants.main(which, 256, device="cpu")
    checks = [k for k in out if k.endswith("_differ")]
    assert len(checks) == {"a": 0, "b": 1, "d": 3, "e": 1}[which]
    assert all(out[k] == 0 for k in checks) and _no_launch()
    assert all(v > 0 for k, v in out.items() if k.endswith("_ms"))
    with pytest.raises(ValueError, match="sweep"):
        enc_variants.main("c", 256, device="cpu")


def test_rt_split_ab_and_scaled_ab_drivers_on_the_cpu(monkeypatch):
    from tpudct_torch.studies import rt_split_ab, scaled_ab

    monkeypatch.setattr(rt_split_ab, "REPS", 1)
    monkeypatch.setattr(scaled_ab, "REPS", 1)
    V.reset_launches()
    hp.reset_launches()
    out = rt_split_ab.main(256, 2, device="cpu")
    assert out["recon_differ"] == 0 and len(out["fused_ms"]) == len(out["split_ms"]) == 2
    monkeypatch.setattr(scaled_ab, "FACTORS", (2, 4))  # f = 8 needs W % 1024: the card runs it
    out = scaled_ab.main(512, device="cpu")
    assert out["f2_differ"] == 0 and out["f4_differ"] == 0 and _no_launch()
    assert min(out[f"f{f}_{arm}_ms"] for f in (2, 4) for arm in ("fused", "composed")) > 0
