"""tpudct_torch.parallel (mesh, sharded steps, rings) against tpudct.parallel
on the CPU.

The port's CPU mesh is ``["cpu"] * n`` (its kernel wrappers run their plain
twins); the reference's is the 8-device CPU mesh of tests/conftest.py, its
Pallas kernels and rings in interpret mode.  Both get the same numpy inputs.

Tolerances and their reasons:
- Mesh shapes, the shard and ring refusals: equal (the same exception type
  and message).
- Sharded steps: every rank runs the port's single-device pipeline, so the
  classes are those of test_torch_hp.py/test_torch_pipeline.py.  hp:
  coefficients bit-identical (integer core), u8 reconstructions +-1 on at
  most 1e-4 of pixels (the butterfly's summation order; seen: 0).  batched:
  coefficients +-1 at .5 ties on at most 0.5% of entries (the reference's
  f32 einsum against the port's f64 one), reconstructions within the
  per-block tie-flip bound.  f32 decodes within 1e-3 absolute.  Sharded and
  single-device results of the port are bit-identical (blocks are
  independent; each band takes the path the whole image takes).
- Metrics: within 1e-4 relative of the reference's psum and of a float64
  host recompute (f32 partial sums added in another order); the color
  step's against the reference within the color class's 2% (its
  reconstructions differ at the FMA ties below).
- Color: the class of test_torch_color.py's u8 path (MSE within 2%, mean
  absolute difference <= 0.5; the reference's XLA CPU run fuses FMAs into
  the YCbCr transforms, ROADMAP.md section C).
- Rings: the replicated payloads bit-identical to the reference's rings;
  each rank's reconstruction bit-identical to the port's own hp_decode_u8 /
  decode_color_u8 of the gathered planes; against the reference's rings the
  butterfly class (+-1 on at most 1e-4) and the merge class (+-1 on at most
  1e-4 of outputs), with the differing counts printed.
"""

import contextlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpudct
import tpudct.parallel as RP
import tpudct.parallel.ring as RR
import tpudct.parallel.sharding as RS
import tpudct_torch
import tpudct_torch.parallel as PP
import tpudct_torch.parallel.ring as PR
from tpudct.kernels import hp_pallas
from tpudct.models.color import roundtrip_color_u8 as ref_roundtrip_color_u8
from tpudct_torch.entry import dryrun_multichip
from tpudct_torch.kernels import hp
from tpudct_torch.kernels import ring as rk
from tpudct_torch.models.color import decode_color_u8

CPU8 = ["cpu"] * 8


def _pair(name="hp"):
    return tpudct_torch.get_pipeline(name), tpudct.get_pipeline(name)


def _cfgs(**kw):
    return tpudct_torch.CodecConfig(**kw), tpudct.CodecConfig(interpret=True, **kw)


def _meshes(n=8):
    return PP.band_mesh(devices=["cpu"] * n), RP.band_mesh(n_devices=n)


def _noise(shape, seed, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(dtype)


def _np(x):
    if isinstance(x, PP.Sharded):
        return PP.gather(x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _count(mine, ref, share, bound=1, label=""):
    """|mine - ref| <= bound everywhere and nonzero on at most `share`;
    prints and returns the differing count."""
    d = np.abs(_np(mine).astype(np.int64) - _np(ref).astype(np.int64))
    assert d.shape == _np(ref).shape and d.max(initial=0) <= bound, d.max()
    n = int((d > 0).sum())
    print(f"{label}: {n} of {d.size} differ (max {d.max(initial=0)})")
    assert n <= share * d.size, n
    return n


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _same_error(call, ref_call, exc=ValueError):
    with pytest.raises(exc) as mine:
        call()
    with pytest.raises(exc) as ref:
        ref_call()
    assert str(mine.value) == str(ref.value)


# ---- meshes -----------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_band_mesh_matches_reference(n):
    mine, ref = _meshes(n)
    assert mine.shape == (ref.shape["band"],) == (n,)
    assert mine.axis_names == tuple(ref.axis_names) == (PP.BAND_AXIS,)
    assert mine.devices == (torch.device("cpu"),) * n


@pytest.mark.parametrize("shape", [None, (2, 4), (8, 1), (2, 2)])
def test_grid_mesh_matches_reference(shape):
    mine, ref = PP.grid_mesh(shape, CPU8), RP.grid_mesh(shape)
    assert mine.shape == (ref.shape["band"], ref.shape["col"])
    assert mine.axis_names == tuple(ref.axis_names) == (PP.BAND_AXIS, PP.COL_AXIS)
    if shape is None:
        assert mine.shape == (4, 2)  # most-square factorization of 8


@pytest.mark.parametrize("call,ref_call", [
    (lambda: PP.band_mesh(9, CPU8), lambda: RP.band_mesh(9)),
    (lambda: PP.grid_mesh((4, 4), CPU8), lambda: RP.grid_mesh((4, 4))),
])
def test_mesh_errors_match_reference(call, ref_call):
    _same_error(call, ref_call)


def test_mesh_device_rule():
    """Repeated devices are virtual ranks; "cuda" is cuda:0; a mesh of CPU
    and CUDA devices, or of none, raises."""
    assert PP.band_mesh(devices=["cuda"] * 3).devices == (torch.device("cuda", 0),) * 3
    assert PP.band_mesh(devices=["cuda:0", "cuda:1"]).shape == (2,)
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        PP.band_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        PP.grid_mesh((1, 2), devices=["cuda:0", "cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        PP.band_mesh(devices=[])


@pytest.mark.parametrize("available,count", [(False, 0), (True, 0)])
def test_band_mesh_without_a_card_raises(monkeypatch, available, count):
    """devices=None means the CUDA cards: without one it raises (nothing
    falls back to the CPU unasked), and so does dryrun_multichip."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    for call in (PP.band_mesh, PP.grid_mesh, lambda: dryrun_multichip(8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---- sharding: validation --------------------------------------------------------------

_Z = np.zeros


@pytest.mark.parametrize("fn,mesh,shape,dtype", [
    ("shard_image", "band", (40, 64), np.float32),        # 5-row bands
    ("shard_image", "band", (60, 64), np.float32),        # 60 rows do not split 8 ways
    ("shard_image_grid", (2, 4), (256, 40), np.float32),  # 10-col tiles
    ("shard_image_grid", (2, 4), (40, 256), np.float32),  # 20-row bands
    ("shard_rgb", "band", (3, 64, 128), np.uint8),        # 8-row bands
    ("shard_rgb", "band", (3, 128, 120), np.uint8),       # width % 16
    ("shard_rgb_grid", (2, 4), (3, 16, 128), np.uint8),   # 8-row bands
    ("shard_rgb_grid", (2, 4), (3, 32, 32), np.uint8),    # 8-col tiles
    ("shard_batch", "band", (12, 8, 8), np.uint8),        # 12 images over 8
])
def test_shard_validation_matches_reference(fn, mesh, shape, dtype):
    if mesh == "band":
        mine, ref = _meshes()
    else:
        mine, ref = PP.grid_mesh(mesh, CPU8), RP.grid_mesh(mesh)
    x = _Z(shape, dtype)
    _same_error(lambda: getattr(PP, fn)(x, mine), lambda: getattr(RP, fn)(jnp.asarray(x), ref))


def test_sharded_layout_and_gather(image256):
    """Shards sit on their ranks with the reference's layout; gather
    reassembles; a step refuses a value of another layout or mesh."""
    mesh, gmesh = PP.band_mesh(devices=CPU8), PP.grid_mesh(devices=CPU8)
    xs = PP.shard_image(image256, mesh)
    assert xs.shape == (256, 256) and xs.dtype == torch.float32 and len(xs.shards) == 8
    assert [tuple(s.shape) for s in xs.shards] == [(32, 256)] * 8
    np.testing.assert_array_equal(PP.gather(xs), image256)
    xg = PP.shard_image_grid(image256, gmesh)
    assert [tuple(s.shape) for s in xg.shards] == [(64, 128)] * 8
    np.testing.assert_array_equal(xg.shards[3].numpy(), image256[64:128, 128:])  # rank 3 = band 1, col 1
    np.testing.assert_array_equal(PP.gather(xg), image256)
    rgb = _noise((3, 256, 64), 1)
    np.testing.assert_array_equal(PP.gather(PP.shard_rgb_grid(rgb, PP.grid_mesh((4, 2), CPU8))), rgb)
    p, _ = _pair()
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="expects a 'band'-sharded value"):
        PP.sharded_codec_step(p, cfg, mesh)(xg)
    with pytest.raises(ValueError, match="expects a 'band'-sharded value"):
        PP.sharded_codec_step(p, cfg, PP.band_mesh(4, CPU8))(xs)
    with pytest.raises(ValueError, match="needs a 2-D mesh"):
        PP.shard_image_grid(image256, mesh)


# ---- sharding: gray steps ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["hp", "batched"])
def test_sharded_roundtrip_matches_reference(name, image256):
    (p, rp), (cfg, rcfg), (mesh, rmesh) = _pair(name), _cfgs(), _meshes()
    c, r = PP.sharded_roundtrip(p, cfg, mesh)(PP.shard_image(image256, mesh))
    rc, rr = RP.sharded_roundtrip(rp, rcfg, rmesh)(RP.shard_image(jnp.asarray(image256), rmesh))
    np.testing.assert_array_equal(_np(c), RP.gather(rc))
    if name == "hp":
        _count(r, RP.gather(rr), 1e-4, label=f"{name} recon vs reference")
    else:  # batched: the reference's f32 value chain (ops.transform)
        np.testing.assert_array_equal(_np(r), RP.gather(rr))
    # sharded == the port's single-device pass on each rank's band, bit for
    # bit (batched's value order follows the shape, as the reference's does:
    # a 32-row band takes the einsum's order, the whole 256^2 the lane form)
    c1, r1 = (torch.cat(v) for v in zip(*(p.roundtrip(torch.as_tensor(b), cfg) for b in np.split(image256, 8))))
    np.testing.assert_array_equal(_np(c), c1.numpy())
    np.testing.assert_array_equal(_np(r), r1.numpy())


@pytest.mark.parametrize("name", ["hp", "batched"])
def test_sharded_codec_step_metrics(name, image256):
    """psum'd metrics: within 1e-4 relative of the reference's and of host f64."""
    (p, rp), (cfg, rcfg), (mesh, rmesh) = _pair(name), _cfgs(), _meshes()
    (c, r), m = PP.sharded_codec_step(p, cfg, mesh)(PP.shard_image(image256, mesh))
    (_rc, _rr), rm = RP.sharded_codec_step(rp, rcfg, rmesh)(RP.shard_image(jnp.asarray(image256), rmesh))
    rec, x = _np(r).astype(np.float64), image256.astype(np.float64)
    err = ((rec - x) ** 2).sum()
    host = {"mse": err / x.size, "peen_pct": 100.0 * err / (x**2).sum(),
            "nonzero_frac": (_np(c) != 0).mean()}
    host["psnr_db"] = 10.0 * np.log10(255.0**2 / host["mse"])
    assert set(m) == set(rm) == set(host)
    for k in host:
        assert _rel(m[k], host[k]) < 1e-4, (k, float(m[k]), host[k])
        assert _rel(m[k], rm[k]) < 1e-4, (k, float(m[k]), float(rm[k]))
    print({k: float(v) for k, v in m.items()})


def test_grid_step_matches_reference(image256):
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    mesh, rmesh = PP.grid_mesh(devices=CPU8), RP.grid_mesh()
    (c, r), m = PP.sharded_codec_step_grid(p, cfg, mesh)(PP.shard_image_grid(image256, mesh))
    (rc, _rr), rm = RP.sharded_codec_step_grid(rp, rcfg, rmesh)(RP.shard_image_grid(jnp.asarray(image256), rmesh))
    np.testing.assert_array_equal(_np(c), RP.gather(rc))
    c1, r1 = p.roundtrip(torch.as_tensor(image256), cfg)
    np.testing.assert_array_equal(_np(c), c1.numpy())
    np.testing.assert_array_equal(_np(r), r1.numpy())
    mse = ((_np(r).astype(np.float64) - image256) ** 2).mean()
    assert _rel(m["mse"], mse) < 1e-4 and _rel(m["mse"], rm["mse"]) < 1e-4


def test_grid_step_narrow_tiles_take_batched_fallback():
    """Tiles narrower than 128 run the batched path, as in the reference:
    equal to the port's batched pipeline on the whole image."""
    (p, _rp), (cfg, _rcfg) = _pair(), _cfgs()
    mesh = PP.grid_mesh(devices=CPU8)
    img = _noise((64, 32), 1, np.float32)  # (4, 2) tiles of 16 x 16
    (c, r), _m = PP.sharded_codec_step_grid(p, cfg, mesh)(PP.shard_image_grid(img, mesh))
    cb, rb = tpudct_torch.get_pipeline("batched").roundtrip(torch.as_tensor(img), cfg)
    np.testing.assert_array_equal(_np(c), cb.numpy())
    np.testing.assert_array_equal(_np(r), rb.numpy())


def test_gather_recon_replicates(image256):
    """gather_recon: every rank holds the whole reconstruction (the ring
    all-gather), equal to the sharded one and to the reference's."""
    (p, rp), (cfg, rcfg), (mesh, rmesh) = _pair(), _cfgs(), _meshes()
    xs = PP.shard_image(image256, mesh)
    c, full = PP.gather_recon(p, cfg, mesh)(xs)
    assert full.spec == "replicated" and full.shape == image256.shape
    _c2, r = PP.sharded_roundtrip(p, cfg, mesh)(xs)
    for s in full.shards:
        np.testing.assert_array_equal(s.numpy(), _np(r))
    _rc, rfull = RS.gather_recon(rp, rcfg, rmesh)(RP.shard_image(jnp.asarray(image256), rmesh))
    _count(full, np.asarray(rfull), 1e-4, label="gather_recon vs reference")


@pytest.mark.parametrize("name", ["hp", "batched"])
def test_sharded_idct_matches_reference(name, image256):
    (p, rp), (cfg, rcfg), (mesh, rmesh) = _pair(name), _cfgs(), _meshes()
    c = tpudct_torch.get_pipeline("batched").dct(torch.as_tensor(image256), cfg).numpy()
    r = PP.sharded_idct(p, cfg, mesh)(PP.shard_image(c, mesh))
    rr = RS.sharded_idct(rp, rcfg, rmesh)(RP.shard_image(jnp.asarray(c), rmesh))
    assert r.shape == (256, 256)
    np.testing.assert_allclose(_np(r), RP.gather(rr), atol=1e-3)
    per_band = torch.cat([p.idct(torch.as_tensor(b), cfg) for b in np.split(c, 8)])
    np.testing.assert_array_equal(_np(r), per_band.numpy())


@pytest.mark.parametrize("factor", [2, 4])
def test_sharded_scaled_decode_matches_reference(factor, image256):
    (cfg, rcfg), (mesh, rmesh) = _cfgs(), _meshes()
    c = tpudct_torch.get_pipeline("batched").dct(torch.as_tensor(image256), cfg).numpy()
    s = PP.sharded_scaled_decode(cfg, mesh, factor)(PP.shard_image(c, mesh))
    rs = RS.sharded_scaled_decode(rcfg, rmesh, factor)(RP.shard_image(jnp.asarray(c), rmesh))
    assert s.shape == (256 // factor, 256 // factor)
    np.testing.assert_allclose(_np(s), RP.gather(rs), atol=1e-3)


# ---- sharding: color and serving ---------------------------------------------------------


def _color_class(mine, ref, rgb):
    mine, ref = _np(mine).astype(np.float64), _np(ref).astype(np.float64)
    assert mine.shape == ref.shape
    m, m_ref = ((mine - rgb) ** 2).mean(), ((ref - rgb) ** 2).mean()
    assert abs(m - m_ref) <= 0.02 * m_ref
    d = np.abs(mine - ref)
    print(f"color vs reference: {int((d > 0).sum())} of {d.size} outputs differ (max {d.max()})")
    assert d.mean() <= 0.5


def test_sharded_color_step_matches_reference():
    (p, rp), (cfg, rcfg), (mesh, rmesh) = _pair(), _cfgs(), _meshes()
    h, w = 16 * 8 * 2, 128
    rgb = _noise((3, h, w), 11)
    rec, m = PP.sharded_color_step(p, cfg, mesh)(PP.shard_rgb(rgb, mesh))
    rrec, rm = RP.sharded_color_step(rp, rcfg, rmesh)(RP.shard_rgb(jnp.asarray(rgb), rmesh))
    assert rec.shape == (3, h, w) and rec.dtype == torch.uint8
    _color_class(rec, RP.gather(rrec), rgb)
    mse = ((rgb.astype(np.float64) - _np(rec)) ** 2).mean()
    assert _rel(m["mse"], mse) < 1e-4 and _rel(m["mse"], rm["mse"]) < 2e-2
    # the same band math on the whole image, unsharded: bit-identical
    from tpudct_torch.utils.color import ycbcr_merge_420_u8, ycbcr_split_420_u8

    y, cb, cr = ycbcr_split_420_u8(torch.as_tensor(rgb))
    _c, ry = p.roundtrip(y.to(torch.float32), cfg)
    _c2, rc = p.roundtrip(torch.cat([cb, cr]).to(torch.float32), tpudct_torch.CodecConfig(q_table="chroma"))
    np.testing.assert_array_equal(_np(rec), ycbcr_merge_420_u8(ry, rc[: h // 2], rc[h // 2 :], h, w).numpy())


def test_sharded_color_step_grid_matches_band_mesh():
    """Grid color == band color, bit for bit (16-aligned tiles keep pooling
    and blocks local); against the reference inside the color class."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    gmesh, rgmesh = PP.grid_mesh(devices=CPU8), RP.grid_mesh()
    h, w = 16 * 8, 256 * gmesh.shape[1]
    rgb = _noise((3, h, w), 23)
    rec_g, m_g = PP.sharded_color_step_grid(p, cfg, gmesh)(PP.shard_rgb_grid(rgb, gmesh))
    mesh = PP.band_mesh(devices=CPU8)
    rec_b, m_b = PP.sharded_color_step(p, cfg, mesh)(PP.shard_rgb(rgb, mesh))
    np.testing.assert_array_equal(_np(rec_g), _np(rec_b))
    assert _rel(m_g["mse"], m_b["mse"]) < 1e-4
    rrec, _rm = RP.sharded_color_step_grid(rp, rcfg, rgmesh)(RP.shard_rgb_grid(jnp.asarray(rgb), rgmesh))
    _color_class(rec_g, RP.gather(rrec), rgb)


@pytest.mark.parametrize("name", ["hp", "batched"])
def test_sharded_color_encode_matches_reference(name):
    (p, rp), (cfg, rcfg), (mesh, rmesh) = _pair(name), _cfgs(), _meshes()
    rgb = _noise((3, 256, 128), 9)
    step, meta_fn = PP.sharded_color_encode(p, cfg, mesh)
    rstep, rmeta_fn = RS.sharded_color_encode(rp, rcfg, rmesh)
    planes = step(PP.shard_rgb(rgb, mesh))
    rplanes = rstep(RP.shard_rgb(jnp.asarray(rgb), rmesh))
    assert meta_fn(256, 128) == rmeta_fn(256, 128)
    for k, a, b in zip(("y", "cb", "cr"), planes, rplanes):
        assert a.spec == "band" and a.shape == b.shape
        # the split's chroma and the f32 chain each sit in their +-1 class
        _count(a, RP.gather(b), 5e-3, label=f"{name} {k} plane vs reference")


def test_sharded_serving_step_matches_reference():
    """Coefficients bit-identical, reconstructions in the butterfly class,
    the same image count and metrics within 1e-4."""
    (p, rp), (cfg, rcfg), (mesh, rmesh) = _pair(), _cfgs(), _meshes()
    batch = _noise((16, 128, 128), 31)
    (c, r), m = PP.sharded_serving_step(p, cfg, mesh)(PP.shard_batch(batch, mesh))
    (rc, rr), rm = RP.sharded_serving_step(rp, rcfg, rmesh)(RP.shard_batch(jnp.asarray(batch), rmesh))
    assert r.shape == (16, 128, 128) and r.dtype == torch.uint8
    np.testing.assert_array_equal(_np(c), RP.gather(rc))
    _count(r, RP.gather(rr), 1e-4, label="serving recon vs reference")
    assert float(m["images"]) == float(rm["images"]) == 16
    mse = ((batch.astype(np.float64) - _np(r)) ** 2).mean()
    assert _rel(m["mse"], mse) < 1e-4 and _rel(m["mse"], rm["mse"]) < 1e-4


def test_serving_step_refuses_non_u8_pipeline():
    (cfg, rcfg), (mesh, rmesh) = _cfgs(), _meshes()
    _same_error(lambda: PP.sharded_serving_step(tpudct_torch.get_pipeline("batched"), cfg, mesh),
                lambda: RP.sharded_serving_step(tpudct.get_pipeline("batched"), rcfg, rmesh))


# ---- rings --------------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_all_gather_matches_reference(n, image256):
    mesh, rmesh = _meshes(n)
    full = PR.ring_all_gather(PP.shard_image(image256, mesh), mesh)
    rfull = np.asarray(RR.ring_all_gather(RP.shard_image(jnp.asarray(image256), rmesh), rmesh, interpret=True))
    np.testing.assert_array_equal(rfull, image256)
    assert full.spec == "replicated" and len(full.shards) == n
    for s in full.shards:
        np.testing.assert_array_equal(s.numpy(), rfull)


def _coeffs256(image256):
    c = hp.hp_encode_u8(torch.as_tensor(image256.astype(np.uint8)))
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(hp_pallas.hp_encode_u8(jnp.asarray(image256, jnp.uint8), interpret=True)))
    return c


@pytest.mark.parametrize("n", [2, 8])
def test_ring_decode_gather_matches_reference(n, image256):
    mesh, rmesh = _meshes(n)
    c = _coeffs256(image256)
    crep, rec = PR.ring_decode_gather(PP.shard_image(c, mesh), mesh)
    rcrep, rrec = RR.ring_decode_gather(RP.shard_image(jnp.asarray(c.numpy()), rmesh), rmesh, interpret=True)
    own = hp.hp_decode_u8(c).numpy()
    for a, b in zip(crep.shards, rec.shards):
        np.testing.assert_array_equal(a.numpy(), np.asarray(rcrep))
        np.testing.assert_array_equal(b.numpy(), own)
    _count(rec.shards[0], np.asarray(rrec), 1e-4, label=f"ring decode n={n} vs reference")


@pytest.mark.parametrize("n", [4, 8])
def test_ring_decode_color_gather_matches_reference(n, rng):
    """Seeds as tests/test_sharding.py's: 256x512 RGB from the rng fixture,
    coded by the reference; both rings get the same planes."""
    rgb = rng.integers(0, 256, (256, 512, 3), dtype=np.uint8)
    rp, rcfg = tpudct.get_pipeline("hp"), tpudct.CodecConfig(interpret=True)
    planes, meta, _rec = ref_roundtrip_color_u8(rp, jnp.asarray(rgb), rcfg)
    y, cb, cr = (np.asarray(planes[k], np.int8) for k in ("y", "cb", "cr"))
    pack = PR.chroma_band_pack(cb, cr, n)
    mesh, rmesh = _meshes(n)
    yrep, crep, out = PR.ring_decode_color_gather(PP.shard_image(y, mesh), PP.shard_image(pack, mesh), mesh)
    ryrep, rcrep, rout = RR.ring_decode_color_gather(
        RP.shard_image(jnp.asarray(y), rmesh), RP.shard_image(jnp.asarray(pack), rmesh), rmesh, 1.0, "haweel",
        interpret=True)
    own = decode_color_u8(tpudct_torch.get_pipeline("hp"), {"y": y, "cb": cb, "cr": cr}, dict(meta),
                          tpudct_torch.CodecConfig(), device="cpu").movedim(-1, 0).numpy()
    for a, b, o in zip(yrep.shards, crep.shards, out.shards):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ryrep))
        np.testing.assert_array_equal(b.numpy(), np.asarray(rcrep))
        np.testing.assert_array_equal(o.numpy(), own)
    _count(out.shards[0], np.asarray(rout), 1e-4, label=f"color ring n={n} vs reference")


@pytest.mark.parametrize("kind", ["array", "tensor"])
def test_chroma_band_pack_matches_reference(kind):
    cb, cr = _noise((64, 128), 1).astype(np.int8), _noise((64, 128), 2).astype(np.int8)
    ref = RR.chroma_band_pack(cb, cr, 4)
    wrap = torch.as_tensor if kind == "tensor" else np.asarray
    mine = PR.chroma_band_pack(wrap(cb), wrap(cr), 4)
    assert isinstance(mine, torch.Tensor) == (kind == "tensor")
    np.testing.assert_array_equal(_np(mine), ref)
    _same_error(lambda: PR.chroma_band_pack(cb, cr, 3), lambda: RR.chroma_band_pack(cb, cr, 3))


@pytest.mark.parametrize("case", ["gray_w", "gray_dct", "color_w", "color_rows", "color_pack", "color_dct"])
def test_ring_gates_match_reference(case):
    """The reference's interpret-mode refusals (its TPU-only VMEM and
    sublane limits dropped), with the same messages."""
    mesh, rmesh = _meshes()

    def both(shape, pack_shape=None):
        x = _Z(shape, np.int8)
        if pack_shape is None:
            return (PP.shard_image(x, mesh),), (RP.shard_image(jnp.asarray(x), rmesh),)
        c = _Z(pack_shape, np.int8)
        return ((PP.shard_image(x, mesh), PP.shard_image(c, mesh)),
                (RP.shard_image(jnp.asarray(x), rmesh), RP.shard_image(jnp.asarray(c), rmesh)))

    if case.startswith("gray"):
        (xs,), (rxs,) = both((64, 120) if case == "gray_w" else (64, 128))
        tr = "dct" if case == "gray_dct" else "haweel"
        _same_error(lambda: PR.ring_decode_gather(xs, mesh, transform=tr),
                    lambda: RR.ring_decode_gather(rxs, rmesh, transform=tr, interpret=True))
        return
    shape, pack = {"color_w": ((128, 128), (128, 64)), "color_rows": ((64, 256), (64, 128)),
                   "color_pack": ((128, 256), (128, 64)), "color_dct": ((128, 256), (128, 128))}[case]
    tr = "dct" if case == "color_dct" else "haweel"
    (ys, cs), (rys, rcs) = both(shape, pack)
    _same_error(lambda: PR.ring_decode_color_gather(ys, cs, mesh, 1.0, tr),
                lambda: RR.ring_decode_color_gather(rys, rcs, rmesh, 1.0, tr, interpret=True))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_launch_schedule(n, monkeypatch):
    """Per ring: n placements and n(n-1) forwards (B14); n placements then n^2
    decodes, n - 1 forwarding and one final per rank (B15); two placements
    per rank then n^2 color decodes (B16).  Each hop handles the slot the
    rank received at the hop before, and every slot is decoded once per
    rank."""
    calls = []
    for name in ("ring_forward", "ring_forward_decode", "ring_forward_decode_color"):
        real = getattr(rk, name)

        def counted(*a, _name=name, _real=real):
            calls.append((_name, a[1] is not None if _name == "ring_forward_decode" else None))
            return _real(*a)

        monkeypatch.setattr(rk, name, counted)
    mesh = PP.band_mesh(devices=["cpu"] * n)
    img = _noise((32 * n, 256), 3)
    c = hp.hp_encode_u8(torch.as_tensor(img))
    PR.ring_all_gather(PP.shard_image(img, mesh), mesh)
    assert calls == [("ring_forward", None)] * (n + n * (n - 1))
    calls.clear()
    _crep, rec = PR.ring_decode_gather(PP.shard_image(c, mesh), mesh)
    decodes = [fwd for name, fwd in calls if name == "ring_forward_decode"]
    assert len(calls) == n + n * n and len(decodes) == n * n
    assert decodes == [True] * (n * (n - 1)) + [False] * n
    for s in rec.shards:
        np.testing.assert_array_equal(s.numpy(), hp.hp_decode_u8(c).numpy())
    calls.clear()
    pack = torch.zeros((32 * n, 128), dtype=torch.int8)
    PR.ring_decode_color_gather(PP.shard_image(c, mesh), PP.shard_image(pack, mesh), mesh)
    assert [name for name, _ in calls] == ["ring_forward"] * (2 * n) + ["ring_forward_decode_color"] * (n * n)
    print(f"n={n}: B14 {n + n * (n - 1)} (all-gather), B14 {n} + B15 {n * n}, B14 {2 * n} + B16 {n * n}")


class _FakeStream:
    """A CUDA stream reduced to its ordering: ``seen[s]`` is the last op of
    stream ``s`` that this stream's next op is ordered after (a vector
    clock); events are snapshots of it."""

    def __init__(self, name):
        self.name, self.seen = name, {name: 0}

    def op(self):
        self.seen[self.name] += 1
        return self.name, self.seen[self.name]

    def after(self, op) -> bool:
        return self.seen.get(op[0], 0) >= op[1]

    def record_event(self):
        return dict(self.seen)

    def wait_event(self, event):
        for k, v in event.items():
            self.seen[k] = max(self.seen.get(k, 0), v)

    def wait_stream(self, other):
        self.wait_event(other.record_event())


@pytest.mark.parametrize("last", [False, True], ids=["all_gather", "decode"])
@pytest.mark.parametrize("cards", [(0,), (0, 1), (0, 1, 2, 3), (0, 0, 1, 1), (0, 0, 0, 0)])
def test_ring_stream_graph_orders_every_cross_card_write(cards, last, monkeypatch):
    """The event/wait graph of a CUDA-mesh ring, with streams and events
    faked on the CPU (cards given by index, virtual ranks sharing one):
    every write into a replica comes after the work its card's caller
    stream did before the ring (where the replica was allocated), every
    hop reads a slot after the write that filled it, every slot of every
    replica is written once, and each card's caller stream ends after
    every write into the replicas on that card, peer writes included."""
    n = len(cards)
    callers = {c: _FakeStream(f"caller{c}") for c in set(cards)}
    ranks = tuple(_FakeStream(f"rank{r}") for r in range(n))
    current = [None]

    @contextlib.contextmanager
    def on(stream):
        current[0] = stream
        yield
        current[0] = None

    monkeypatch.setattr(PR, "rank_streams", lambda mesh: ranks)
    monkeypatch.setattr(PR, "enable_peers", lambda mesh: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: callers[torch.device(d).index])
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", on)
    mesh = PP.band_mesh(devices=[f"cuda:{c}" for c in cards])
    allocated = {c: s.op() for c, s in callers.items()}  # the replicas and inputs, made before
    writes = {}

    def write(r, replica, slot):
        s = current[0]
        assert s is ranks[r], f"rank {r} ran on {s and s.name}"
        op = s.op()
        assert s.after(allocated[cards[replica]]), \
            f"rank {r} writes replica {replica} before cuda:{cards[replica]}'s earlier work"
        assert (replica, slot) not in writes, f"slot {slot} of replica {replica} written twice"
        writes[replica, slot] = op

    def read(r, slot):
        s = current[0]
        assert s is ranks[r] and (r, slot) in writes and s.after(writes[r, slot]), \
            f"rank {r} reads slot {slot} before it is written"

    def hop(r, slot):
        read(r, slot)
        write(r, (r + 1) % n, slot)

    PR._schedule(mesh, place=lambda r: write(r, r, r), hop=hop,
                 last=(lambda r, slot: read(r, slot)) if last else None)
    assert set(writes) == {(q, d) for q in range(n) for d in range(n)}
    for (replica, slot), op in writes.items():
        assert callers[cards[replica]].after(op), \
            f"cuda:{cards[replica]}'s caller does not wait for slot {slot} of replica {replica}"
    print(f"cards {cards}: {len(writes)} slot writes, each ordered before its card's caller")


def test_ring_kernel_wrappers_refuse_bad_operands():
    c = torch.zeros((32, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="dst must be"):
        rk.ring_forward(c, torch.zeros((32, 64), dtype=torch.int8))
    with pytest.raises(ValueError, match="rec must be"):
        rk.ring_forward_decode(c, None, torch.zeros((32, 128), dtype=torch.int8))
    for shape in ((8, 256), (32, 128)):  # the kernel's 16 x 256 strips
        with pytest.raises(ValueError, match="h % 16 == 0 and w % 256 == 0"):
            rk.ring_forward_decode_color(torch.zeros(shape, dtype=torch.int8), None, None, None, None)
    y = torch.zeros((32, 256), dtype=torch.int8)
    with pytest.raises(ValueError, match="forward both planes or neither"):
        rk.ring_forward_decode_color(y, torch.zeros((32, 128), dtype=torch.int8), y, None,
                                     torch.zeros((3, 32, 256), dtype=torch.uint8))
    with pytest.raises(ValueError, match="butterfly decode needs an integer core"):
        rk.ring_forward_decode(c, None, torch.zeros((32, 128), dtype=torch.uint8), transform="dct")


def test_ring_refuses_cards_without_peer_access(monkeypatch):
    """Ranks on two cards that cannot reach each other raise before any hop
    (never a copy through the host)."""
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)
    with pytest.raises(RuntimeError, match="cannot access cuda:1"):
        PR.enable_peers(PP.band_mesh(devices=["cuda:0", "cuda:1"]))
    PR.enable_peers(PP.band_mesh(devices=["cuda:0"] * 4))  # virtual ranks: no peers needed


# ---- the multi-device entry point ---------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_on_cpu_mesh(n):
    dryrun_multichip(n, ["cpu"] * n)
