"""tpudct_torch study variant kernels (kernels/variants.py, B21-B26) and
their study drivers against the reference's study modules in benchmarks/,
on the CPU (the functions run their plain twins; the reference's Pallas
kernels run in interpret mode).  Also the two repairs of the port's open
faults: the cublas pipeline above its per-block loop's cap, and the cause
of B19's luma difference.

The reference modules are loaded from benchmarks/ with importlib, never
edited, with bytecode writing off.  color_variants2.py defines its kernels
inside main(), so its FunctionDef nodes are compiled from the file, read
only, and run in a namespace holding the names they use.

Tolerances and their reasons:
- V1, V4, V6 merges: bit-identical to the reference kernels and to the
  port's production merge twin (the compare-form round equals the add form
  on every input; a chroma shift at either resolution gives the same exact
  integers; seen: 0 differences).
- V12 merge: +-1 on at most 0.5% against the reference and the production
  merge (the direct-form g rounds otherwise than B9's; XLA on the CPU may
  fuse its products into FMAs; seen: 0 at seeds 42 and 7).
- V3, V5 splits: Y bit-identical; chroma +-1 on at most 0.5% against the
  reference, every reference entry being the FMA-contracted chain's under
  one of its two operand orders, as test_torch_color.py shows for B8 (seen:
  Cb 1, Cr 2 of 32,768 at seed 42, 0 at seed 7).  V3 is B8, so bit-identical
  to the production split twin; V5 +-1 on at most 0.5% of it.
- idct_x "b": bit-identical to the port's hp_idct butterfly twin, and
  within B6's class of the reference (2^-14 = 6.1035e-5; the reference's
  inverse sums in another order).  "c": within the same class of the reference (seen:
  7.6e-6 on 3 of 262,144 entries at 512^2, 0 at 256x1024).
- cublas above the cap: coefficients +-1 at .5 ties on at most 0.5%,
  reconstructions within the per-block tie-flip bound (bench.py:82-114).
- B19's luma: the reference's fused Y equals, bit for bit, the port's
  encode of the luma as XLA on the CPU contracts it,
  fma(KB, b, fma(KR, r, KG g)), rounded by the compare form.
"""

import ast
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tpudct
import tpudct_torch
import tpudct_torch.kernels.study as S
import tpudct_torch.kernels.variants as V
from tests.test_torch_color import _F, _fma, _pooled_np, _round_np, _trunc_np
from tests.test_torch_fast_cublas import _tie_flip_bound, _ties
from tests.test_torch_studies import _ROOT, _load, _rgb, _within
from tpudct.kernels import color_pallas as cp
from tpudct.kernels import hp_pallas as rhp
from tpudct.utils.color import rgb_from_ycbcr_planes, ycbcr_from_rgb_planes
from tpudct_torch.benchmark import synthetic_image
from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import hp

SEEDS = (42, 7)
SMALL = (3, 256, 512)  # the studies' own check shape
B6_CLASS = 2.0 ** -14  # 6.1035e-5: the f32 inverse's class against the reference (ROADMAP C)


@pytest.fixture(scope="module")
def cv():
    return _load("color_variants")


@pytest.fixture(scope="module")
def cv2():
    """The kernels and make_* of benchmarks/color_variants2.py."""
    path = _ROOT / "benchmarks" / "color_variants2.py"
    main = next(n for n in ast.parse(path.read_text()).body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = ast.Module(body=[n for n in main.body if isinstance(n, ast.FunctionDef)], type_ignores=[])
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "functools": functools, "cp": cp,
          "rgb_from_ycbcr_planes": rgb_from_ycbcr_planes, "ycbcr_from_rgb_planes": ycbcr_from_rgb_planes}
    exec(compile(defs, str(path), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def inv():
    return _load("inv_formulations")


def _ref_kernel(cv, cv2, name):
    """(make_merge or make_split, kernel) of the reference study defining `name`."""
    if name in ("_k_merge_v1", "_k_merge_v12", "_k_split_v3"):
        v = cv.build_variants()
        return v["make_merge" if "merge" in name else "make_split"], v[name]
    return cv2["make_merge" if "merge" in name else "make_split"], cv2[name]


def _ref_split(rgb):
    return [np.asarray(a) for a in cp.color_split_420_u8(jnp.asarray(rgb), interpret=True)]


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


# ---- color variants (B23-B26) -------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["_k_merge_v1", "_k_merge_v12", "_k_merge_v4", "_k_merge_v6"])
def test_merge_variant_twins_match_reference(cv, cv2, name, seed):
    planes = _ref_split(_rgb(SMALL, seed))
    make, kern = _ref_kernel(cv, cv2, name)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(make(kern, br=64, tc=256)(*planes))
    mine = V.make_merge(getattr(V, name))(*_t(*planes))
    shipped = ck.merge_plain(*_t(*planes), "420")
    assert mine.dtype == torch.uint8 and tuple(mine.shape) == ref.shape == SMALL
    if name == "_k_merge_v12":
        n_ref, n_shipped = _within(mine.numpy(), ref), _within(mine, shipped)
        print(f"V12 seed {seed}: {n_ref} of {ref.size} outputs differ from the reference, "
              f"{n_shipped} from the production merge")
    else:
        assert np.array_equal(mine.numpy(), ref) and torch.equal(mine, shipped)


def _chroma_fma_np(rgb, rnd):
    """The 4:2:0 split chroma as XLA on the CPU contracts it, rounded by
    `rnd`, under either operand order of the luma sum's first FMA."""
    pr, pg, pb = _pooled_np(rgb, "420")
    kr, kg, kb = _F["kr"], _F["kg"], _F["kb"]
    return [(rnd(_fma(pb - yp, _F["kcb"], 128)), rnd(_fma(pr - yp, _F["kcr"], 128)))
            for yp in (_fma(kb, pb, _fma(kr, pr, kg * pg)), _fma(kb, pb, _fma(kg, pg, kr * pr)))]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["_k_split_v3", "_k_split_v5"])
def test_split_variant_twins_match_reference(cv, cv2, name, seed):
    rgb = _rgb(SMALL, seed)
    make, kern = _ref_kernel(cv, cv2, name)
    with pltpu.force_tpu_interpret_mode():
        ry, rcb, rcr = (np.asarray(a) for a in make(kern, br=64, tc=256)(jnp.asarray(rgb)))
    y, cb, cr = V.make_split(getattr(V, name))(torch.as_tensor(rgb))
    assert np.array_equal(y.numpy(), ry)
    counts = [_within(a.numpy(), b) for a, b in ((cb, rcb), (cr, rcr))]
    # the cause: every reference chroma entry is the contracted chain's
    (a_cb, a_cr), (b_cb, b_cr) = _chroma_fma_np(rgb, _trunc_np if name == "_k_split_v5" else _round_np)
    for ref, a, b in ((rcb, a_cb, b_cb), (rcr, a_cr, b_cr)):
        assert np.all((ref == a) | (ref == b))
    shipped = ck.split_plain(torch.as_tensor(rgb), "420")
    assert torch.equal(y, shipped[0])
    n_shipped = [_within(a, b) for a, b in zip((cb, cr), shipped[1:])]
    if name == "_k_split_v3":
        assert n_shipped == [0, 0]
    print(f"{name} seed {seed}: chroma differs from the reference on {counts}, from the production "
          f"split on {n_shipped} of {rcb.size} per plane")


def test_variant_twins_take_their_own_grid_and_refuse_what_they_cannot():
    """The kernels need H even and W % 16, not the reference's tiles."""
    rgb = torch.as_tensor(_rgb((3, 2, 16), seed=3))
    for name in ("_k_split_v3", "_k_split_v5"):
        y, cb, cr = V.make_split(getattr(V, name))(rgb)
        assert tuple(y.shape) == (2, 16) and tuple(cb.shape) == tuple(cr.shape) == (1, 8)
    planes = ck.split_plain(rgb, "420")
    for name in ("_k_merge_v1", "_k_merge_v12", "_k_merge_v4", "_k_merge_v6"):
        assert tuple(V.make_merge(getattr(V, name))(*planes).shape) == (3, 2, 16)
    split, merge = V.make_split(V._k_split_v5), V.make_merge(V._k_merge_v12)
    with pytest.raises(ValueError, match="H % 2 == 0 and W % 16 == 0"):
        split(torch.zeros(3, 2, 24, dtype=torch.uint8))
    with pytest.raises(ValueError, match="H % 2 == 0 and W % 16 == 0"):
        merge(torch.zeros(3, 16, dtype=torch.uint8), *(torch.zeros(1, 8, dtype=torch.uint8),) * 2)
    with pytest.raises(ValueError, match="chroma planes must be"):
        merge(torch.zeros(4, 16, dtype=torch.uint8), torch.zeros(1, 8, dtype=torch.uint8),
              torch.zeros(2, 8, dtype=torch.uint8))
    with pytest.raises(ValueError, match="planar RGB"):
        split(torch.zeros(4, 2, 16, dtype=torch.uint8))
    with pytest.raises(TypeError, match="torch.uint8"):
        split(rgb.to(torch.int8))
    with pytest.raises(TypeError, match="torch.Tensor"):
        merge(planes[0].numpy(), *planes[1:])
    with pytest.raises(ValueError, match="make_merge takes one of the study's merge kernels"):
        V.make_merge(V._k_split_v3)
    with pytest.raises(ValueError, match="make_split takes"):
        V.make_split("_k_split_v5")


# ---- inverse formulations (B21, B22) -------------------------------------------


@pytest.mark.parametrize("shape", [(512, 512), (256, 1024)])
def test_idct_x_twins_match_reference(inv, shape):
    img = synthetic_image(512) if shape == (512, 512) else synthetic_image(1024, seed=7)[:256]
    with pltpu.force_tpu_interpret_mode():
        sc = np.asarray(rhp.hp_dct(jnp.asarray(img)))
        ref = {v: np.asarray(inv.idct_x(jnp.asarray(sc), v)) for v in ("b", "c")}
    coeffs = torch.as_tensor(sc.copy())
    for v in ("b", "c"):
        mine = V.idct_x(coeffs, v)
        assert mine.dtype == torch.float32 and tuple(mine.shape) == shape
        d = np.abs(mine.numpy().astype(np.float64) - ref[v])
        assert d.max() <= B6_CLASS, (v, d.max())
        print(f"idct_x {v} {shape}: max {d.max():.2e} from the reference on {int((d > 0).sum())} of {d.size}")
    assert torch.equal(V.idct_x(coeffs, "b"), hp.idct_plain(coeffs))
    assert torch.equal(coeffs, torch.as_tensor(sc.copy()))  # the input stays as it was


def test_idct_c_twin_sums_per_digit():
    """The digits are exact (they sum back to M) and of bf16 precision, and
    the digit sums differ from the direct sum of b within f32's class."""
    m = torch.as_tensor(np.random.default_rng(9).normal(0, 300, (64, 64)).astype(np.float32))
    d = V._split3(m)
    assert torch.equal((d[0] + d[1]) + d[2], m)
    assert all(torch.equal(x, x.to(torch.bfloat16).to(torch.float32)) for x in d)
    c = hp.dct_plain(torch.as_tensor(synthetic_image(64, seed=9)))
    assert float((V.idct_x(c, "c") - V.idct_x(c, "b")).abs().max()) <= B6_CLASS


def test_idct_x_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="'b' or 'c'"):
        V.idct_x(torch.zeros(8, 8), "a")
    with pytest.raises(TypeError, match="torch.float32"):
        V.idct_x(torch.zeros(8, 8, dtype=torch.float64), "c")
    with pytest.raises(ValueError, match="h % 8 == 0 and w % 8 == 0"):
        V.idct_x(torch.zeros(8, 12), "b")
    with pytest.raises(ValueError, match="2-D"):
        V.idct_x(torch.zeros(1, 8, 8), "c")


def test_variant_twins_count_no_launches():
    V.reset_launches()
    rgb = torch.as_tensor(_rgb((3, 64, 256), seed=2))
    for s in ("_k_split_v3", "_k_split_v5"):
        planes = V.make_split(getattr(V, s))(rgb)
        for m in ("_k_merge_v1", "_k_merge_v12", "_k_merge_v4", "_k_merge_v6"):
            V.make_merge(getattr(V, m))(*planes)
    for v in ("b", "c"):
        V.idct_x(torch.zeros(8, 8), v)
    assert set(V.LAUNCHES.values()) == {0}


# ---- the study drivers ----------------------------------------------------------


def _lines_end_with_the_host_clock(capsys, n: int) -> None:
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == n and all(line.endswith("[cpu: host clock, not a device time]") for line in lines)


def test_color_variants_main_on_the_cpu(capsys):
    from tpudct_torch.studies import color_variants

    out = color_variants.main(256, device="cpu")
    assert out["v1_differ"] == 0 and out["v3_y_differ"] == out["v3_cb_differ"] == out["v3_cr_differ"] == 0
    assert out["v12_max"] <= 1 and out["v12_differ"] <= 0.005 * out["entries"]["merge"]
    assert all(out[f"{k}_ms"] > 0 for k in ("shipped", "v1", "v12", "v3", "v123", "shipped_repeat"))
    assert set(color_variants.build_variants()) == {"make_merge", "make_split", "_k_merge_v1", "_k_merge_v12",
                                                    "_k_split_v3"}
    _lines_end_with_the_host_clock(capsys, 7)


def test_color_variants2_main_on_the_cpu(capsys):
    from tpudct_torch.studies import color_variants2

    out = color_variants2.main(256, device="cpu")
    assert out["v4_differ"] == out["v6_differ"] == out["v5_y_differ"] == 0
    for k in ("cb", "cr"):
        assert out[f"v5_{k}_max"] <= 1 and out[f"v5_{k}_differ"] <= 0.005 * out["entries"]["chroma"]
    assert all(out[f"{k}_ms"] > 0 for k in ("shipped", "v4", "v5", "v6", "shipped_repeat"))
    _lines_end_with_the_host_clock(capsys, 6)


def test_inv_formulations_main_on_the_cpu(capsys):
    from tpudct_torch.studies import inv_formulations

    out = inv_formulations.main(256, device="cpu")
    assert 0 < out["b_max_err"] <= B6_CLASS and 0 < out["c_max_err"] <= B6_CLASS
    assert all(out[k] > 0 for k in ("idct_x_b_ms", "idct_x_c_ms", "hp_idct_highest_ms", "hp_idct_high_ms",
                                    "hp_idct_butterfly_ms"))
    _lines_end_with_the_host_clock(capsys, 7)


def test_variant_study_entry_points_follow_the_device_rule(monkeypatch):
    """Without a card and without device=, the drivers raise."""
    from tpudct_torch.studies import color_variants, color_variants2, inv_formulations

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (color_variants.main, color_variants2.main, inv_formulations.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(256)


# ---- the repairs ------------------------------------------------------------------


def test_cublas_above_the_cap_matches_reference():
    """512x1024 (twice the per-block loop's cap) runs, batched, within the
    tie class of the reference's lax.scan over the blocks."""
    p, rp = tpudct_torch.get_pipeline("cublas"), tpudct.get_pipeline("cublas")
    cfg, rcfg = tpudct_torch.CodecConfig(), tpudct.CodecConfig()
    img = np.random.default_rng(11).integers(0, 256, size=(512, 1024)).astype(np.float32)
    c, r = p.roundtrip(torch.as_tensor(img), cfg)
    c_ref, r_ref = rp.roundtrip(jnp.asarray(img), rcfg)
    assert c.dtype == torch.float32 and r.dtype == torch.uint8 and tuple(c.shape) == (512, 1024)
    n = _ties(c.numpy(), c_ref)
    _tie_flip_bound(c.numpy(), c_ref, r.numpy(), r_ref, cfg)
    print(f"cublas 512x1024: {n} of {c.numel()} coefficients differ from the reference")


@pytest.mark.parametrize("seed", [5, 6])
def test_fused_encode_luma_is_the_contracted_chain(seed):
    """The reference's fused encode (B19) computes its f32 luma as XLA on the
    CPU contracts KR r + KG g + KB b: fma(KB, b, fma(KR, r, KG g)).  Encoding
    that luma gives the reference's Y bit for bit; the port's separately
    rounded sum is +-1 where the two part."""
    fused_ab = _load("color_fused_ab")
    rgb = _rgb((3, 256, 1024), seed)
    ref_y = np.asarray(fused_ab.color_encode_420_u8(jnp.asarray(rgb), interpret=True)[0])
    r, g, b = (rgb[i].astype(np.float32) for i in range(3))
    luma = _round_np(_fma(_F["kb"], b, _fma(_F["kr"], r, _F["kg"] * g)))
    assert np.array_equal(hp.encode_u8_plain(torch.as_tensor(luma)).numpy(), ref_y)
    n = _within(S.color_encode_420_u8(torch.as_tensor(rgb))[0].numpy(), ref_y)
    print(f"B19 seed {seed}: the port's Y differs from the reference's on {n} of {ref_y.size}")
