"""tpudct_torch color codec (utils/color.py, kernels/color.py, models/color.py)
against the reference, on the CPU (the wrappers run their plain twins).

Tolerances and their reasons:
- Kernel twins (B8-B13) against the reference's Pallas kernels in interpret
  mode: Y bit-identical (exact integer luma).  The port rounds every f32
  product and sum of the YCbCr transforms on its own, in the reference's
  order, and divides truly; XLA on the CPU contracts each product into the
  add that follows it (an FMA) and turns the division by KG into a multiply
  by the f32 1/KG.  So split chroma is within +-1 on <= 0.5% of entries
  (seen: 0-15 of 65,536), and the merge within +-1 on <= 1e-4 of outputs
  (seen: 0-2 of 196,608, green at (cb, cr) = (78, 178), where the exact
  value is an integer + 0.5).  Two numpy emulations pin the cause: the
  twins equal the separately rounded chain bit for bit, and the reference
  equals the contracted chain bit for bit (the merge outright; the split's
  chroma entry by entry under one of the two operand orders XLA picks for
  the luma sum's first FMA).
- utils/color.py: within 1e-4 in f32 (the same FMA contractions); its u8
  helpers within +-1 at those ties.
- The u8 color path (per image, _auto, bulk): planes +-1 on <= 0.5%, recon
  MSE within 2%, mean absolute difference <= 0.5 (``bench.py``'s
  color420_u8 gate); the bulk helpers bit-identical to the per-frame ones.
- The f32 color path: coefficient planes in the tie class, reconstructions
  +-1 on <= 5e-3 of outputs (the f32 kernels' class, test_torch_hp.py).
- Refusals: the same exception type (and message, where the reference
  words it) as the reference.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpudct
import tpudct.kernels.color_pallas as RK
import tpudct.models.color as RC
import tpudct.utils.color as RU
import tpudct_torch
import tpudct_torch.kernels.color as K
import tpudct_torch.models.color as C
import tpudct_torch.utils.color as U

MODES = ("420", "422", "444")
_SUBSAMPLE = {"420": "420", "422": "422", "444": False}


def _pair(name="hp"):
    return tpudct_torch.get_pipeline(name), tpudct.get_pipeline(name)


def _cfgs(**kw):
    return tpudct_torch.CodecConfig(**kw), tpudct.CodecConfig(interpret=True, **kw)


def _rgb(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _smooth_rgb(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([128 + 100 * np.sin(yy / 20), 128 + 100 * np.cos(xx / 25), (yy + xx) / 3], -1)
    noise = np.random.default_rng(h * w).normal(0, 6, rgb.shape)
    return np.clip(rgb + noise, 0, 255).astype(np.uint8)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _diff(a, b):
    return np.abs(_np(a).astype(np.int64) - _np(b).astype(np.int64))


def _within(a, b, share):
    """+-1 on at most `share` of entries; returns the differing count."""
    d = _diff(a, b)
    assert d.shape == _np(b).shape and d.max(initial=0) <= 1, d.max()
    n = int((d > 0).sum())
    assert n <= share * d.size, n
    return n


def _assert_color_class(planes, rec, planes_ref, rec_ref, rgb):
    """bench.py's color420_u8 class: planes +-1 on <= 0.5%, recon MSE
    within 2%, mean absolute difference <= 0.5."""
    for k in ("y", "cb", "cr"):
        assert tuple(planes[k].shape) == tuple(np.shape(planes_ref[k]))
        assert _np(planes[k]).dtype == np.asarray(planes_ref[k]).dtype
        _within(planes[k], planes_ref[k], 0.005)
    rec, rec_ref = _np(rec), np.asarray(rec_ref)
    assert rec.shape == rec_ref.shape and rec.dtype == np.uint8
    m = ((rec.astype(np.float64) - rgb) ** 2).mean()
    m_ref = ((rec_ref.astype(np.float64) - rgb) ** 2).mean()
    assert abs(m - m_ref) <= 0.02 * m_ref + 1e-9
    assert _diff(rec, rec_ref).mean() <= 0.5


# ---- numpy f32 emulation of the kernels' value chain ---------------------------

_F = {k: np.float32(v) for k, v in U.F32.items()}


def _pooled_np(rgb, mode):
    """The window means of the three channels, f32 (exact)."""
    rh, rw = K.WINDOWS[mode]
    _, h, w = rgb.shape
    s = (rgb.astype(np.int64) - 128).reshape(3, h // rh, rh, w // rw, rw).sum(axis=(2, 4))
    return s.astype(np.float32) * np.float32(1.0 / (rh * rw)) + np.float32(128)


def _round_np(z):
    zp = np.clip(z, np.float32(0), np.float32(255))
    f = np.floor(zp)
    return (f + (zp - f >= 0.5)).astype(np.uint8)


def _split_np(rgb, mode):
    c = rgb.astype(np.int64)
    y = ((19595 * c[0] + 38470 * c[1] + 7471 * c[2] + 32768) >> 16).astype(np.uint8)
    pr, pg, pb = _pooled_np(rgb, mode)
    yp = (_F["kr"] * pr + _F["kg"] * pg) + _F["kb"] * pb
    return (y, _round_np(np.float32(128) + (pb - yp) * _F["kcb"]),
            _round_np(np.float32(128) + (pr - yp) * _F["kcr"]))


def _up_np(c, mode):
    rh, rw = K.WINDOWS[mode]
    return np.repeat(np.repeat((c.astype(np.int32) - 128).astype(np.float32), rh, 0), rw, 1)


def _trunc_np(v):
    return (np.clip(v, 0, 255) + np.float32(0.5)).astype(np.int32).astype(np.uint8)


def _merge_np(y, cb, cr, mode):
    yf, cbc, crc = y.astype(np.float32), _up_np(cb, mode), _up_np(cr, mode)
    r = yf + _F["kr2"] * crc
    b = yf + _F["kb2"] * cbc
    g = ((yf - _F["kr"] * r) - _F["kb"] * b) / _F["kg"]
    return np.stack([_trunc_np(v) for v in (r, g, b)])


# ---- numpy emulation of the reference's contracted chain (XLA on the CPU) ----


def _fma(a, b, c):
    """f32 fused multiply-add: the product of two f32 is exact in f64, the
    sum is rounded to f64 and then to f32 (a double rounding that can differ
    from one rounding only on an f64 sum exactly halfway between two f32)."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    return (a * b + c).astype(np.float32)


def _split_chroma_fma_np(rgb, mode):
    """Split chroma as the reference's XLA CPU run computes it: the luma sum
    and the chroma affine map as FMAs.  The first FMA of the luma sum takes
    either product as its addend; returns (cb, cr) under each choice."""
    pr, pg, pb = _pooled_np(rgb, mode)
    kr, kg, kb = _F["kr"], _F["kg"], _F["kb"]
    out = []
    for yp in (_fma(kb, pb, _fma(kr, pr, kg * pg)), _fma(kb, pb, _fma(kg, pg, kr * pr))):
        out.append((_round_np(_fma(pb - yp, _F["kcb"], 128)), _round_np(_fma(pr - yp, _F["kcr"], 128))))
    return out


def _merge_fma_np(y, cb, cr, mode):
    """The merge as the reference's XLA CPU run computes it: each product
    fused into its add, and g multiplied by the f32 reciprocal of KG."""
    yf, cbc, crc = y.astype(np.float32), _up_np(cb, mode), _up_np(cr, mode)
    r = _fma(_F["kr2"], crc, yf)
    b = _fma(_F["kb2"], cbc, yf)
    g = _fma(-_F["kb"], b, _fma(-_F["kr"], r, yf)) * (np.float32(1) / _F["kg"])
    return np.stack([_trunc_np(v) for v in (r, g, b)])


# ---- kernels ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_color_kernel_twins_match_reference(mode, seed):
    rgb = _rgb((3, 128, 512), seed)
    ry, rcb, rcr = (np.asarray(a) for a in getattr(RK, f"color_split_{mode}_u8")(jnp.asarray(rgb), interpret=True))
    y, cb, cr = getattr(K, f"color_split_{mode}_u8")(torch.as_tensor(rgb))
    assert np.array_equal(y.numpy(), ry)
    n_split = [_within(a, b, 0.005) for a, b in ((cb, rcb), (cr, rcr))]
    print(f"{mode} seed {seed}: split chroma differs on {n_split} of {rcb.size} per plane")
    for mine, emu in zip((y, cb, cr), _split_np(rgb, mode)):
        assert np.array_equal(mine.numpy(), emu)
    # the cause: every reference chroma entry is the contracted chain's
    (a_cb, a_cr), (b_cb, b_cr) = _split_chroma_fma_np(rgb, mode)
    for ref, a, b in ((rcb, a_cb, b_cb), (rcr, a_cr, b_cr)):
        assert np.all((ref == a) | (ref == b))
    # the merge on the reference's planes
    rm = np.asarray(getattr(RK, f"color_merge_{mode}_u8")(ry, rcb, rcr, interpret=True))
    m = getattr(K, f"color_merge_{mode}_u8")(*(torch.as_tensor(a.copy()) for a in (ry, rcb, rcr)))
    n_merge = _within(m, rm, 1e-4)
    print(f"{mode} seed {seed}: merge differs on {n_merge} of {rm.size}")
    assert np.array_equal(m.numpy(), _merge_np(ry, rcb, rcr, mode))
    assert np.array_equal(rm, _merge_fma_np(ry, rcb, rcr, mode))


def test_merge_trunc_round_equals_compare_round_over_all_triples():
    """The merge's add-form round trunc(clip(z) + 0.5) equals the compare
    form clip(round_half_away(z)) on every (y, cb, cr) triple (the merge's
    outputs depend on that triple alone): all 256^3 through the 4:4:4 twin,
    16 luma values at a time."""
    from tpudct_torch.ops.rounding import round_half_away

    cb, cr = torch.meshgrid(torch.arange(256), torch.arange(256), indexing="ij")
    cb = cb.to(torch.uint8).repeat(16, 1)
    cr = cr.to(torch.uint8).repeat(16, 1)
    mismatches = 0
    for y0 in range(0, 256, 16):
        y = torch.arange(y0, y0 + 16, dtype=torch.uint8).repeat_interleave(256)
        y = y.reshape(-1, 1).expand(-1, 256).contiguous()
        out = K.merge_plain(y, cb, cr, "444")
        rgb = U.rgb_from_ycbcr_planes(*(c.to(torch.float32) for c in (y, cb, cr)))
        ref = torch.stack([round_half_away(v).clamp(0, 255).to(torch.uint8) for v in rgb])
        mismatches += int((out != ref).sum())
    assert mismatches == 0


def test_color_kernels_gate_and_refuse_like_reference():
    for h in (32, 64, 96, 128, 4032):
        for w in (256, 320, 512, 3072):
            assert K.supports(h, w) == RK.supports(h, w)
    z = lambda *s: np.zeros(s, np.uint8)
    for mode in MODES:
        rsplit, split = getattr(RK, f"color_split_{mode}_u8"), getattr(K, f"color_split_{mode}_u8")
        rmerge, merge = getattr(RK, f"color_merge_{mode}_u8"), getattr(K, f"color_merge_{mode}_u8")
        for shape in ((3, 32, 256), (3, 64, 320)):
            with pytest.raises(ValueError) as ref:
                rsplit(jnp.asarray(z(*shape)), interpret=True)
            with pytest.raises(ValueError) as mine:
                split(torch.as_tensor(z(*shape)))
            assert str(mine.value) == str(ref.value)
        rh, rw = K.WINDOWS[mode]
        for y_shape, c_shape in (((64, 320), (64 // rh, 320 // rw)), ((64, 256), (64 // rh, 256 // rw + 8))):
            planes = (z(*y_shape), z(*c_shape), z(*c_shape))
            with pytest.raises(ValueError) as ref:
                rmerge(*(jnp.asarray(a) for a in planes), interpret=True)
            with pytest.raises(ValueError) as mine:
                merge(*(torch.as_tensor(a) for a in planes))
            assert str(mine.value) == str(ref.value)
        with pytest.raises(TypeError):
            split(z(3, 64, 256))  # not a tensor
        with pytest.raises(TypeError):
            split(torch.zeros((3, 64, 256), dtype=torch.float32))
        with pytest.raises(ValueError):
            split(torch.zeros((4, 64, 256), dtype=torch.uint8))
        with pytest.raises(ValueError, match="cpu or cuda"):
            split(torch.zeros((3, 64, 256), dtype=torch.uint8, device="meta"))
    assert all(v == 0 for v in K.LAUNCHES.values())  # twins count nothing


# ---- utils/color.py ---------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (33, 47)])
def test_utils_color_matches_reference(shape):
    rng = np.random.default_rng(shape[0])
    rgb = rng.uniform(0, 255, size=(*shape, 3)).astype(np.float32)
    t = torch.as_tensor(rgb)
    ycc, ycc_ref = U.rgb_to_ycbcr(t), RU.rgb_to_ycbcr(jnp.asarray(rgb))
    for a, b in zip(ycc, ycc_ref):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-4
    planes = [np.asarray(b) for b in ycc_ref]
    back = U.ycbcr_to_rgb(*(torch.as_tensor(p) for p in planes))
    assert np.abs(back.numpy() - np.asarray(RU.ycbcr_to_rgb(*planes))).max() <= 1e-4
    h, w = shape
    for down, up in (("downsample_420", "upsample_420"), ("downsample_422", "upsample_422")):
        d, d_ref = getattr(U, down)(torch.as_tensor(planes[1])), getattr(RU, down)(planes[1])
        assert d.shape == d_ref.shape and np.abs(d.numpy() - np.asarray(d_ref)).max() <= 1e-4
        u, u_ref = getattr(U, up)(d, h, w), getattr(RU, up)(d_ref, h, w)
        assert u.shape == (h, w) and np.abs(u.numpy() - np.asarray(u_ref)).max() <= 1e-4
    # the u8 helpers: +-1 at the FMA ties
    even = _rgb((3, 64, 96), shape[1])
    mine = U.ycbcr_split_420_u8(torch.as_tensor(even))
    ref = RU.ycbcr_split_420_u8(jnp.asarray(even))
    for a, b in zip(mine, ref):
        _within(a, b, 0.005)
    rec = U.ycbcr_merge_420_u8(*mine, 64, 96)
    rec_ref = RU.ycbcr_merge_420_u8(*(jnp.asarray(a.numpy()) for a in mine), 64, 96)
    _within(rec, rec_ref, 1e-3)


# ---- the u8 color path --------------------------------------------------------


@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("shape", [(128, 256), (100, 300), (252, 189), (98, 296)])
@pytest.mark.parametrize("mode", MODES)
def test_color_u8_path_matches_reference(mode, shape, layout):
    """encode/decode/roundtrip_color_u8 and the _auto forms, every mode, an
    aligned frame and ragged ones (a camera-aspect frame, a width not a
    multiple of 16), both layouts."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    sub = _SUBSAMPLE[mode]
    rgb = _smooth_rgb(*shape)
    x = rgb if layout == "interleaved" else np.ascontiguousarray(np.moveaxis(rgb, -1, 0))
    planes, meta = C.encode_color_u8(p, x, cfg, subsample=sub, device="cpu")
    planes_ref, meta_ref = RC.encode_color_u8(rp, jnp.asarray(x), rcfg, subsample=sub)
    assert meta == meta_ref
    rec = C.decode_color_u8(p, planes, meta, cfg)
    rec_ref = RC.decode_color_u8(rp, planes_ref, meta_ref, rcfg)
    _assert_color_class(planes, rec, planes_ref, rec_ref, rgb)
    # the reference's decode of the port's planes, and roundtrip == encode + decode
    rec_x = RC.decode_color_u8(rp, {k: jnp.asarray(v.numpy()) for k, v in planes.items()}, meta, rcfg)
    _within(rec, rec_x, 1e-3)
    pl2, meta2, rec2 = C.roundtrip_color_u8(p, x, cfg, subsample=sub, device="cpu")
    assert meta2 == meta and torch.equal(rec2, rec)
    for k in planes:
        assert torch.equal(pl2[k], planes[k])
    # _auto takes the u8 path for u8 pixels of either layout, any size
    pl3, meta3, rec3 = C.roundtrip_color_auto(p, x, cfg, subsample=sub, device="cpu")
    assert pl3["y"].dtype == torch.int8 and torch.equal(rec3, rec)
    pl4, meta4 = C.encode_color_auto(p, x, cfg, subsample=sub, device="cpu")
    assert torch.equal(C.decode_color_auto(p, pl4, meta4, cfg), rec)
    assert torch.equal(C.decode_color_auto(p, {k: v.numpy() for k, v in pl4.items()}, meta4, cfg,
                                           device="cpu"), rec)


@pytest.mark.parametrize("kw", [{"q_scale": 0.5}, {"transform": "dct"}])
def test_color_f32_path_matches_reference(kw):
    """Configs off the int8 bound (or without an integer core) take the f32
    path: hp_dct/hp_idct at kernel shapes, torch resampling."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs(**kw)
    rgb = _smooth_rgb(64, 256)
    assert not C.supports_color_u8(p, cfg, 64, 256) and not RC.supports_color_u8(rp, rcfg, 64, 256)
    for sub in ("420", False):
        planes, meta, rec = C.roundtrip_color_auto(p, rgb, cfg, subsample=sub, device="cpu")
        planes_ref, meta_ref, rec_ref = RC.roundtrip_color_auto(rp, jnp.asarray(rgb), rcfg, subsample=sub)
        assert meta == meta_ref
        for k in ("y", "cb", "cr"):
            d = np.abs(planes[k].numpy().astype(np.float64) - np.asarray(planes_ref[k], np.float64))
            assert planes[k].dtype == torch.float32 and d.max() <= 1 and (d > 0).mean() <= 0.005
        _within(rec, rec_ref, 5e-3)
        # decode of the reference's planes: the same class
        rec_x = C.decode_color_auto(p, {k: np.asarray(v) for k, v in planes_ref.items()}, meta_ref, cfg,
                                    device="cpu")
        _within(rec_x, rec_ref, 5e-3)


def test_color_f32_encode_of_float_pixels_matches_reference():
    """Float pixels (even out of [0, 255]) never take the u8 path."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    big = np.clip(_smooth_rgb(64, 256).astype(np.float32) * 2.0, -50, 400)
    planes, meta, rec = C.roundtrip_color_auto(p, big, cfg, device="cpu")
    planes_ref, _meta, rec_ref = RC.roundtrip_color_auto(rp, jnp.asarray(big), rcfg)
    assert planes["y"].dtype == torch.float32 and rec.dtype == torch.uint8
    _within(rec, rec_ref, 5e-3)
    # a stream whose values exceed int8 (constant 800 through the plain
    # batched pipeline: Y DC 336) decodes on the f32 path, not through a cast
    bp, rbp = _pair("batched")
    big = np.full((64, 256, 3), 800.0, np.float32)
    planes, meta = C.encode_color(bp, big, cfg, device="cpu")
    planes_ref, _meta = RC.encode_color(rbp, jnp.asarray(big), rcfg)
    assert max(float(v.abs().max()) for v in planes.values()) > 127
    assert not C._u8_decodable(p, planes, meta, cfg)
    rec = C.decode_color_auto(p, planes, meta, cfg)
    rec_ref = RC.decode_color_auto(rp, planes_ref, meta, rcfg)
    assert np.array_equal(rec.numpy(), np.asarray(rec_ref))


@pytest.mark.parametrize("scale", [{"factor": 2}, {"factor": 4}, {"m": 6}, {"m": 4}])
@pytest.mark.parametrize("mode", ["420", "444"])
def test_decode_color_scaled_matches_reference(mode, scale):
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    sub = _SUBSAMPLE[mode]
    rgb = _smooth_rgb(100, 300)
    planes, meta = C.encode_color_u8(p, rgb, cfg, subsample=sub, device="cpu")
    np_planes = {k: v.numpy() for k, v in planes.items()}
    out = C.decode_color_scaled(p, np_planes, meta, cfg, device="cpu", **scale)
    ref = RC.decode_color_scaled(rp, {k: jnp.asarray(v) for k, v in np_planes.items()}, meta, rcfg, **scale)
    assert out.dtype == torch.uint8
    _within(out, ref, 5e-3)
    # f32 planes of the same values take the f32 scaled decode: the same class
    f32 = {k: v.astype(np.float32) * 200 for k, v in np_planes.items()}
    out = C.decode_color_scaled(p, f32, meta, cfg, device="cpu", **scale)
    ref = RC.decode_color_scaled(rp, {k: jnp.asarray(v) for k, v in f32.items()}, meta, rcfg, **scale)
    _within(out, ref, 5e-3)


def test_decode_color_scaled_refusals_match_reference():
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    planes, meta = C.encode_color_u8(p, _smooth_rgb(64, 256), cfg, device="cpu")
    np_planes = {k: v.numpy() for k, v in planes.items()}
    for kw in ({"factor": 2, "m": 4}, {}, {"m": 12}):
        with pytest.raises(ValueError) as ref:
            RC.decode_color_scaled(rp, np_planes, meta, rcfg, **kw)
        with pytest.raises(ValueError) as mine:
            C.decode_color_scaled(p, np_planes, meta, cfg, device="cpu", **kw)
        assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("kw", [{}, {"q_scale": 0.5}, {"q_scale": 0.8}, {"deadzone": 0.35},
                                {"transform": "dct"}, {"transform": "wht"}])
def test_supports_color_u8_matches_reference(kw):
    (p, rp), (cfg, rcfg) = _pair(), _cfgs(**kw)
    bp, rbp = _pair("batched")
    for mode in ("420", "422", False, True, "444"):
        for h in (32, 64, 100, 4032, 8192):
            for w in (256, 300, 3024, 3072):
                hk, wk = C.color_kernel_shape(h, w)
                assert (hk, wk) == RC.color_kernel_shape(h, w)
                assert C.supports_color_u8(p, cfg, hk, wk, mode) == RC.supports_color_u8(rp, rcfg, hk, wk, mode)
                assert C.supports_color_u8(p, cfg, h, w, mode) == RC.supports_color_u8(rp, rcfg, h, w, mode)
                assert not C.supports_color_u8(bp, cfg, h, w, mode)
                assert C._chroma_plane_shape(C.normalize_subsample(mode), h, w) == RC._chroma_plane_shape(
                    RC.normalize_subsample(mode), h, w)


def test_color_u8_refusals_and_layouts_match_reference():
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    for args in ((p, rp, np.zeros((64, 256, 3), np.float32), {}),
                 (p, rp, np.zeros((64, 256, 3), np.uint8), {"q_scale": 0.25}),
                 (_pair("batched")[0], _pair("batched")[1], np.zeros((64, 256, 3), np.uint8), {})):
        mp, rpp, x, kw = args
        with pytest.raises(ValueError) as ref:
            RC.encode_color_u8(rpp, jnp.asarray(x), tpudct.CodecConfig(interpret=True, **kw))
        with pytest.raises(ValueError) as mine:
            C.encode_color_u8(mp, x, tpudct_torch.CodecConfig(**kw), device="cpu")
        assert str(mine.value) == str(ref.value)
    for sub in (7, "411"):
        with pytest.raises(ValueError) as ref:
            RC.normalize_subsample(sub)
        with pytest.raises(ValueError) as mine:
            C.normalize_subsample(sub)
        assert str(mine.value) == str(ref.value)
    # mis-shaped planes: decode_color_u8 refuses
    planes, meta = C.encode_color_u8(p, _smooth_rgb(64, 256), cfg, device="cpu")
    bad = {**{k: v.numpy() for k, v in planes.items()}, "cb": np.zeros((40, 128), np.int8)}
    with pytest.raises(ValueError) as ref:
        RC.decode_color_u8(rp, bad, meta, rcfg)
    with pytest.raises(ValueError) as mine:
        C.decode_color_u8(p, bad, meta, cfg, device="cpu")
    assert str(mine.value) == str(ref.value)
    # layouts: (3, W, 3) reads as interleaved; others refuse as the reference does
    for shape in ((3, 256, 3), (64, 256, 3), (3, 64, 256)):
        assert C._layout(np.zeros(shape)) == RC._layout(np.zeros(shape))
    for shape in ((64, 256), (4, 64, 256)):
        with pytest.raises(ValueError):
            C._layout(np.zeros(shape))
    # custom plane tables take the f32 path, as in the reference
    np_planes = {k: v.numpy() for k, v in planes.items()}
    custom = {**meta, "y_q_table": "chroma"}
    assert not C._u8_decodable(p, np_planes, custom, cfg)
    rec = C.decode_color_auto(p, np_planes, custom, cfg, device="cpu")
    rec_ref = RC.decode_color_auto(rp, {k: jnp.asarray(v) for k, v in np_planes.items()}, custom, rcfg)
    _within(rec, rec_ref, 5e-3)


def test_color_table_assignment_and_deadzone_match_reference():
    (p, rp) = _pair()
    rgb = _smooth_rgb(64, 256)
    a, _ = C.encode_color_auto(p, rgb, tpudct_torch.CodecConfig(), device="cpu")
    b, _ = C.encode_color_auto(p, rgb, tpudct_torch.CodecConfig(q_table="chroma"), device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    cfg, rcfg = _cfgs(deadzone=0.35)
    assert not C.supports_color_u8(p, cfg, 64, 256)
    planes, meta, rec = C.roundtrip_color_auto(p, rgb, cfg, device="cpu")
    planes_ref, _m, rec_ref = RC.roundtrip_color_auto(rp, jnp.asarray(rgb), rcfg)
    assert planes["y"].dtype == torch.float32
    for k in planes:
        d = np.abs(planes[k].numpy() - np.asarray(planes_ref[k]))
        assert d.max() <= 1 and (d > 0).mean() <= 0.005
    _within(rec, rec_ref, 5e-3)


# ---- bulk helpers -----------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_color_batch_matches_per_frame_and_reference(mode):
    """encode/decode_color_batch_auto equal the per-frame _auto helpers bit
    for bit across ragged sizes and a float frame (its own path), and the
    reference's batch helpers within the color class."""
    (p, rp), (cfg, rcfg) = _pair(), _cfgs()
    sub = _SUBSAMPLE[mode]
    rng = np.random.default_rng(23)
    shapes = [(100, 300), (97, 300), (64, 128), (100, 300)]
    rgbs = [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]
    rgbs.append(rng.integers(0, 256, (40, 200, 3)).astype(np.float32))
    got = C.encode_color_batch_auto(p, rgbs, cfg, subsample=sub, device="cpu")
    ref = RC.encode_color_batch_auto(rp, rgbs, rcfg, subsample=sub)
    for rgb, (planes, meta), (planes_ref, meta_ref) in zip(rgbs, got, ref):
        p1, m1 = C.encode_color_auto(p, rgb, cfg, subsample=sub, device="cpu")
        assert meta == m1 == meta_ref
        for k in ("y", "cb", "cr"):
            assert isinstance(planes[k], np.ndarray)
            assert np.array_equal(planes[k], p1[k].numpy())
            d = np.abs(planes[k].astype(np.float64) - np.asarray(planes_ref[k], np.float64))
            assert d.max() <= 1 and (d > 0).mean() <= 0.005
    items = [(planes, meta, cfg) for planes, meta in got]
    dec = C.decode_color_batch_auto(p, items, device="cpu")
    dec_ref = RC.decode_color_batch_auto(rp, [(pl, m, rcfg) for pl, m, _ in items])
    for (planes, meta, icfg), r, r_ref in zip(items, dec, dec_ref):
        assert isinstance(r, np.ndarray)
        assert np.array_equal(r, C.decode_color_auto(p, planes, meta, icfg, device="cpu").numpy())
        _within(r, r_ref, 5e-3)
    # chunking splits the stacks and changes nothing
    for (a, _), (b, _) in zip(got, C.encode_color_batch_auto(p, rgbs, cfg, subsample=sub,
                                                             max_pixels=100000, device="cpu")):
        for k in a:
            assert np.array_equal(a[k], b[k])


def test_color_batch_single_split_dispatch(monkeypatch):
    """Same-width u8 frames: one split, one luma and one stacked-chroma
    encode, one luma and one chroma decode and one merge for the chunk."""
    p, cfg = _pair()[0], _cfgs()[0]
    rng = np.random.default_rng(24)
    rgbs = [rng.integers(0, 256, (40 + 8 * i, 250, 3), dtype=np.uint8) for i in range(3)]
    calls = []
    for name in ("color_split_420_u8", "color_merge_420_u8"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name, **k: calls.append((_n, a[0].shape)) or _fn(*a, **k))
    for name in ("encode_u8", "decode_u8"):
        fn = getattr(type(p), name)
        monkeypatch.setattr(type(p), name,
                            lambda self, x, c, _fn=fn, _n=name: calls.append((_n, x.shape, c.q_table)) or _fn(self, x, c))
    got = C.encode_color_batch_auto(p, rgbs, cfg, device="cpu")
    total_hk = sum(-(-(40 + 8 * i) // 64) * 64 for i in range(3))
    assert calls == [("color_split_420_u8", (3, total_hk, 256)),
                     ("encode_u8", (total_hk, 256), "luma"),
                     ("encode_u8", (total_hk, 128), "chroma")]
    calls.clear()
    C.decode_color_batch_auto(p, [(pl, m, cfg) for pl, m in got], device="cpu")
    assert calls == [("decode_u8", (total_hk, 256), "luma"),
                     ("decode_u8", (total_hk, 128), "chroma"),
                     ("color_merge_420_u8", (total_hk, 256))]


def test_color_host_arrays_follow_the_device_rule(monkeypatch):
    """Without a card, a host array raises unless the CPU is named; a tensor
    stays where it is."""
    p, cfg = _pair()[0], _cfgs()[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rgb = _rgb((64, 256, 3), 25)
    for fn in (C.encode_color_auto, C.encode_color_u8, C.encode_color, C.roundtrip_color_auto):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(p, rgb, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.encode_color_batch_auto(p, [rgb], cfg)
    planes, meta, rec = C.roundtrip_color_auto(p, torch.as_tensor(rgb), cfg)
    assert rec.device.type == "cpu" and planes["y"].dtype == torch.int8
    np_planes = {k: v.numpy() for k, v in planes.items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.decode_color_auto(p, np_planes, meta, cfg)
    assert torch.equal(C.decode_color_auto(p, np_planes, meta, cfg, device="cpu"), rec)


def test_planar_edge_pad_equals_per_plane_pad():
    from tpudct_torch.ops.padding import pad_to_kernel

    x = torch.as_tensor(_rgb((3, 100, 300), 26))
    padded, hw = pad_to_kernel(x, 64, 256)
    assert hw == (100, 300) and padded.shape == (3, 128, 512)
    for c in range(3):
        assert torch.equal(padded[c], pad_to_kernel(x[c], 64, 256)[0])
    ref = np.pad(x.numpy(), ((0, 0), (0, 28), (0, 212)), mode="edge")
    assert np.array_equal(padded.numpy(), ref)


def test_color_gate_passes_on_cpu():
    from tpudct_torch import selftest

    rep = selftest.color_gate(tpudct_torch.get_pipeline("hp"), tpudct_torch.CodecConfig(), device="cpu")
    assert rep["gate"] == "pass" and rep["plane_diffs"] == {"y": 0, "cb": 0, "cr": 0}
    assert rep["recon_diff_pixels"] == 0 and rep["device"] == "cpu"
    skip = selftest.color_gate(tpudct_torch.get_pipeline("batched"), tpudct_torch.CodecConfig(), device="cpu")
    assert skip["gate"] == "skip"


# ---- the direct instances ------------------------------------------------------

_FRAMES = ((128, 256), (100, 300), (252, 189), (98, 296))


def _grid_chain(p, cfg, x, mode):
    """The u8 colour roundtrip on the reference's (64, 256) grid, as it ran
    before the direct instances: planar frame, edge pad to the grid, the
    planar split, the codec on the grid planes and the crops to the
    8-aligned plane shapes; zero pads back to the grid, the chroma stack,
    the decode, the planar merge and the crop."""
    import torch.nn.functional as F

    from tpudct_torch.ops.padding import pad_to_kernel, padded_shape

    planar = x if x.shape[0] == 3 and x.shape[-1] != 3 else x.movedim(-1, 0).contiguous()
    h, w = planar.shape[1:]
    xp, _ = pad_to_kernel(planar, 64, 256)
    y, cb, cr = getattr(K, f"color_split_{mode}_u8")(xp)
    cy = p.encode_u8(y, C._luma_cfg(cfg))
    cc = p.encode_u8(torch.cat([cb, cr]), C._chroma_cfg(cfg))
    ph = cb.shape[0]
    y8 = padded_shape(h, w)
    c8 = padded_shape(*C._chroma_plane_shape(_SUBSAMPLE[mode], h, w))
    planes = {"y": cy[: y8[0], : y8[1]], "cb": cc[:ph][: c8[0], : c8[1]], "cr": cc[ph:][: c8[0], : c8[1]]}

    def zpad(c, a, b):
        return F.pad(c, (0, b - c.shape[1], 0, a - c.shape[0]))

    yd = p.decode_u8(zpad(planes["y"], *xp.shape[1:]), C._luma_cfg(cfg))
    cd = p.decode_u8(torch.cat([zpad(planes[k], *cb.shape) for k in ("cb", "cr")]), C._chroma_cfg(cfg))
    return planes, getattr(K, f"color_merge_{mode}_u8")(yd, cd[:ph], cd[ph:]).movedim(0, -1)[:h, :w]


@pytest.mark.parametrize("shape", _FRAMES)
@pytest.mark.parametrize("layout", ("interleaved", "planar"))
@pytest.mark.parametrize("mode", MODES)
def test_direct_path_equals_the_grid_chain(mode, layout, shape):
    """roundtrip_color_u8 (the direct split and merge, the codec at the
    planes' own shapes) gives the grid chain's planes and RGB bit for bit;
    cb and cr are row halves of one buffer, the RGB is contiguous, and
    planes from separate buffers decode the same."""
    p, cfg = _pair()[0], _cfgs()[0]
    h, w = shape
    x = torch.as_tensor(_smooth_rgb(h, w))
    if layout == "planar":
        x = x.movedim(-1, 0).contiguous()
    planes, meta, rec = C.roundtrip_color_u8(p, x, cfg, subsample=_SUBSAMPLE[mode], device="cpu")
    want, want_rec = _grid_chain(p, cfg, x, mode)
    for k in ("y", "cb", "cr"):
        assert torch.equal(planes[k], want[k]), k
    assert torch.equal(rec, want_rec) and rec.is_contiguous() and rec.shape == (h, w, 3)
    assert C._stacked(planes["cb"], planes["cr"]) is not None
    apart = {k: v.clone() for k, v in planes.items()}
    assert C._stacked(apart["cb"], apart["cr"]) is None
    assert torch.equal(C.decode_color_u8(p, apart, meta, cfg), rec)


@pytest.mark.parametrize("mode", MODES)
def test_direct_kernels_equal_the_grid_kernels_cropped(mode):
    """The direct split of a ragged frame is the planar split of the
    frame edge-padded to the grid, cropped to the plane shapes; the direct
    merge is the planar merge's crop, interleaved."""
    from tpudct_torch.ops.padding import pad_to_kernel

    h, w = 98, 296
    x = torch.as_tensor(_rgb((h, w, 3), 31))
    y, cc = K.color_split_direct_u8(x, mode)
    (yh, yw), (ch, cw) = K.direct_shapes(h, w, mode)
    assert y.shape == (yh, yw) and cc.shape == (2 * ch, cw)
    gy, gcb, gcr = getattr(K, f"color_split_{mode}_u8")(pad_to_kernel(x.movedim(-1, 0), 64, 256)[0])
    assert torch.equal(y, gy[:yh, :yw])
    assert torch.equal(cc, torch.cat([gcb[:ch, :cw], gcr[:ch, :cw]]))
    assert torch.equal(K.color_split_direct_u8(x.movedim(-1, 0).contiguous(), mode, "planar")[1], cc)
    out = K.color_merge_direct_u8(y, cc[:ch], cc[ch:], h, w, mode)
    ref = getattr(K, f"color_merge_{mode}_u8")(gy, gcb, gcr).movedim(0, -1)[:h, :w]
    assert out.shape == (h, w, 3) and torch.equal(out, ref)


def test_direct_path_reads_any_strides_of_either_layout():
    """An interleaved view of a planar buffer reads as planar (no copy), a
    planar view of an interleaved one as interleaved; other strides are
    copied once; the planes are the same."""
    p, cfg = _pair()[0], _cfgs()[0]
    hwc = torch.as_tensor(_smooth_rgb(64, 200))
    want = C.encode_color_u8(p, hwc, cfg, device="cpu")[0]
    chw = hwc.movedim(-1, 0).contiguous()
    wide = torch.as_tensor(_smooth_rgb(64, 210))[:, 5:205]
    assert C._u8_frame(chw.movedim(0, -1))[1] == "planar"
    assert C._u8_frame(hwc.movedim(-1, 0))[1] == "interleaved"
    for x in (chw.movedim(0, -1), hwc.movedim(-1, 0), hwc.numpy(), wide):
        got = C.encode_color_u8(p, x, cfg, device="cpu")[0]
        ref = want if x is not wide else C.encode_color_u8(p, wide.contiguous(), cfg, device="cpu")[0]
        assert all(torch.equal(got[k], ref[k]) for k in ("y", "cb", "cr"))


def test_direct_wrappers_refuse_what_they_cannot_read():
    y = torch.zeros((104, 304), dtype=torch.uint8)
    c = torch.zeros((56, 152), dtype=torch.uint8)
    with pytest.raises(ValueError, match="takes y"):
        K.color_merge_direct_u8(y, c, c[:48], 100, 300, "420")
    with pytest.raises(ValueError, match=r"takes \(3, H, W\) planar RGB"):
        K.color_split_direct_u8(torch.zeros((4, 5, 6), dtype=torch.uint8))
    with pytest.raises(ValueError, match=r"takes \(H, W, 3\) interleaved RGB"):
        K.color_split_direct_u8(torch.zeros((3, 5, 6), dtype=torch.uint8), layout="interleaved")
    with pytest.raises(TypeError, match="uint8"):
        K.color_split_direct_u8(torch.zeros((4, 5, 3), dtype=torch.int16))
    with pytest.raises(ValueError, match="non-empty"):
        K.color_split_direct_u8(torch.zeros((0, 5, 3), dtype=torch.uint8))


def _registry(fn):
    """(fn(), the registry's snapshot of it): the registry on and reset
    around the call."""
    from tpudct_torch.utils import profiling

    profiling.reset()
    profiling.enable()
    try:
        return fn(), profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()


def test_direct_roundtrip_opens_no_pad_or_layout_span():
    """entry.roundtrip_color_auto on a u8 frame: no ``pad`` or ``layout``
    span under it (and no other span), ``color.u8.direct`` counts the
    encode and the decode, and the call looks up one plan."""
    from tpudct_torch.utils import profiling

    p, cfg = _pair()[0], _cfgs()[0]
    rgb = torch.as_tensor(_smooth_rgb(100, 300))
    C._u8_plan.cache_clear()
    _out, snap = _registry(lambda: C.roundtrip_color_auto(p, rgb, cfg))
    names = set(snap["spans"])
    assert names == {profiling.PREFIX + "entry.roundtrip_color_auto"}
    assert not {profiling.PREFIX + "pad", profiling.PREFIX + "layout"} & names
    assert snap["counters"] == {profiling.PREFIX + "color.u8.direct": 2,
                                profiling.PREFIX + "color.u8.plan.miss": 1}


# ---- the u8 path's plans --------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"q_scale": 0.5}, {"q_scale": 0.8}, {"deadzone": 0.35},
                                {"transform": "dct"}, {"transform": "wht"}])
def test_u8_plan_verdict_and_shapes_match_the_gate(kw):
    """A plan's verdict is supports_color_u8 on the kernel grid, for every
    mode, layout, ragged and aligned shape and configuration the gate's
    test covers (the batched pipeline refused); its plane shapes are the
    8-aligned true plane shapes; _u8_eligible reads it, on a hit as on a
    miss."""
    from tpudct_torch.ops.padding import padded_shape

    p, cfg = _pair()[0], _cfgs(**kw)[0]
    bp = _pair("batched")[0]
    C._u8_plan.cache_clear()
    for mode in ("420", "422", False, True, "444"):
        m = C.normalize_subsample(mode)
        for h in (32, 64, 100, 4032, 8192):
            for w in (256, 300, 3024, 3072):
                want = C.supports_color_u8(p, cfg, *C.color_kernel_shape(h, w), mode)
                for layout, shape in (("interleaved", (h, w, 3)), ("planar", (3, h, w))):
                    plan = C._u8_plan(p, h, w, layout, m, cfg)
                    assert plan.ok == want and plan.layout == layout and plan.mode == m
                    assert plan.y8 == padded_shape(h, w)
                    assert plan.c8 == padded_shape(*C._chroma_plane_shape(m, h, w))
                    assert plan.chroma == C._chroma_plane_shape(m, h, w)
                    assert plan.lcfg == C._luma_cfg(cfg) and plan.ccfg == C._chroma_cfg(cfg)
                    frame = np.broadcast_to(np.zeros((), np.uint8), shape)
                    assert C._u8_eligible(p, frame, cfg, mode) == want
                    assert C._u8_eligible(p, frame, cfg, mode) == want
                    assert not C._u8_plan(bp, h, w, layout, m, cfg).ok


def test_u8_plan_keeps_the_refusals():
    """A refusal is raised with its type and text on a plan's hit as on its
    miss: the gate's in encode_color_u8, the plane shapes' in
    decode_color_u8, an unknown mode's before any plan."""
    p, cfg = _pair()[0], _cfgs()[0]
    C._u8_plan.cache_clear()
    texts = []
    for _ in range(2):
        with pytest.raises(ValueError) as e:
            C.encode_color_u8(p, np.zeros((64, 256, 3), np.uint8), _cfgs(q_scale=0.25)[0], device="cpu")
        texts.append(str(e.value))
    assert texts[0] == texts[1] and texts[0].startswith("u8 color path unsupported for 64x256 subsample=True")
    planes, meta = C.encode_color_u8(p, _smooth_rgb(64, 256), cfg, device="cpu")
    bad = {**planes, "cb": torch.zeros((40, 128), dtype=torch.int8)}
    texts = []
    for _ in range(2):
        with pytest.raises(ValueError) as e:
            C.decode_color_u8(p, bad, meta, cfg, device="cpu")
        texts.append(str(e.value))
    assert texts[0] == texts[1] and texts[0].startswith("u8 decode expects 8-aligned planes")
    with pytest.raises(ValueError, match="unknown chroma subsampling"):
        C.roundtrip_color_auto(p, np.zeros((64, 256, 3), np.uint8), cfg, subsample="411", device="cpu")
    with pytest.raises(ValueError, match="unknown transform"):
        C.encode_color_auto(p, np.zeros((64, 256, 3), np.uint8), tpudct_torch.CodecConfig(transform="x"),
                            device="cpu")


@pytest.mark.parametrize("change", ["shape", "layout", "mode", "q_scale"])
def test_u8_plan_counts_a_miss_then_hits(change):
    """With the registry on, the first call on a frame shape counts one
    ``color.u8.plan.miss`` and the next ones ``hit``s (one lookup a
    roundtrip), with the same planes and RGB; a new shape, layout, mode or
    q_scale counts a new miss."""
    from tpudct_torch.utils import profiling

    p, cfg = _pair()[0], _cfgs()[0]
    hwc = torch.as_tensor(_smooth_rgb(64, 256))
    other = {
        "shape": (torch.as_tensor(_smooth_rgb(72, 256)), cfg, "420"),
        "layout": (hwc.movedim(-1, 0).contiguous(), cfg, "420"),
        "mode": (hwc, cfg, "422"),
        "q_scale": (hwc, _cfgs(q_scale=2.0)[0], "420"),
    }[change]
    C._u8_plan.cache_clear()
    miss, hit = profiling.PREFIX + "color.u8.plan.miss", profiling.PREFIX + "color.u8.plan.hit"

    def calls():
        return [C.roundtrip_color_auto(p, x, c, subsample=m)
                for x, c, m in ((hwc, cfg, "420"), (hwc, cfg, "420"), (hwc, cfg, "420"), other)]

    outs, snap = _registry(calls)
    assert snap["counters"][miss] == 2 and snap["counters"][hit] == 2
    for planes, _meta, rgb in outs[1:3]:
        assert all(torch.equal(planes[k], outs[0][0][k]) for k in C.PLANES)
        assert torch.equal(rgb, outs[0][2])
    (planes, meta, rgb), _ = _registry(lambda: C.roundtrip_color_u8(p, *other[:2], subsample=other[2]))
    assert all(torch.equal(planes[k], outs[3][0][k]) for k in C.PLANES) and torch.equal(rgb, outs[3][2])


@pytest.mark.parametrize("layout", ("interleaved", "planar"))
@pytest.mark.parametrize("mode", MODES)
def test_chain_calls_carry_the_wrappers_arguments(monkeypatch, mode, layout):
    """The two chain calls a card makes: the arity of their C signatures,
    the scratch planes' offsets, the frame's alignment, the wrappers' core
    ids and tables (by address) for each plane's table, and ``LAUNCHES``
    advanced as the six wrappers advance it (read here on CPU tensors,
    with the native call recorded instead of made)."""
    from tpudct_torch.kernels import _build
    from tpudct_torch.kernels import hp

    calls = []
    monkeypatch.setattr(C, "_chain", lambda name, dev, *args: calls.append((name, args)))
    p, cfg = _pair()[0], _cfgs(q_scale=1.5, retain_k=6)[0]
    h, w = 98, 296
    x = torch.as_tensor(_rgb((h, w, 3), 5))
    if layout == "planar":
        x = x.movedim(-1, 0).contiguous()
    plan = C._u8_plan(p, h, w, layout, _SUBSAMPLE[mode] or False, cfg)
    (yh, yw), (ch, cw) = plan.y8, plan.c8
    scratch = C._scratch(plan, x.device)
    assert scratch.numel() == yh * yw + 2 * ch * cw
    before = {**K.LAUNCHES, **hp.LAUNCHES}
    cy, ccq = C._encode_chain(plan, x, h, w, scratch)
    out = C._decode_chain(plan, cy, ccq, h, w, scratch)
    after = {**K.LAUNCHES, **hp.LAUNCHES}
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        f"color_split_direct_{mode}": 1, "hp_encode_u8": 2, "hp_decode_u8": 2,
        f"color_merge_direct_{mode}": 1}
    assert cy.shape == (yh, yw) and ccq.shape == (2 * ch, cw) and out.shape == (h, w, 3)
    s = scratch.data_ptr()
    (enc, ea), (dec, da) = calls
    assert (enc, dec) == ("color_encode_u8_chain_launch", "color_decode_u8_chain_launch")
    assert len(ea) + 2 == len(_build._SIGNATURES[enc]) and len(da) + 2 == len(_build._SIGNATURES[dec])
    hwc = layout == "interleaved"
    rh, rw = K.WINDOWS[mode]
    assert ea[:13] == (x.data_ptr(), s, s + yh * yw, cy.data_ptr(), ccq.data_ptr(), h, w, rh, rw,
                       int(hwc), K._align(x, 3 * w if hwc else w),
                       hp._core_of("haweel", "luma", 1.5, 6, "butterfly", True)[0],
                       hp._core_of("haweel", "chroma", 1.5, 6, "butterfly", True)[0])
    assert ea[13:] == (K._consts().ctypes.data,
                       hp._args("haweel", "luma", 1.5, 6, "butterfly", True).packed.ctypes.data,
                       hp._args("haweel", "chroma", 1.5, 6, "butterfly", True).packed.ctypes.data)
    assert da[:12] == (cy.data_ptr(), ccq.data_ptr(), s, s + yh * yw, out.data_ptr(), h, w, rh, rw,
                       K._align(out, 3 * w), hp._core_of("haweel", "luma", 1.5, None, "butterfly", False)[1],
                       hp._core_of("haweel", "chroma", 1.5, None, "butterfly", False)[1])
    assert da[12:] == (K._consts().ctypes.data,
                       hp._args("haweel", "luma", 1.5, None, "butterfly", False).packed.ctypes.data,
                       hp._args("haweel", "chroma", 1.5, None, "butterfly", False).packed.ctypes.data)
