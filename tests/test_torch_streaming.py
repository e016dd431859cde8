"""tpudct_torch.utils.streaming, the sharded saves and the CLI's streamed
branches against the reference's, on the CPU (``device="cpu"``: the same
band loop on the kernels' plain twins; the reference's functions run as
``tests/test_streaming.py`` runs them, on its 8-device CPU mesh).

Same seeded numpy inputs into both packages.  Tolerance: none for the gray
path, the sharded saves and everything the port holds against itself (its
streamed bytes against its in-memory banded writer, its streamed decodes
against its in-memory decodes): the same bytes, the same pixels, the same
``ValueError`` messages.  Where a color result of the port meets the
reference's, the color split's chroma may differ by +-1 on <= 0.5% of
entries and the merge by +-1 on <= 1e-4 of outputs (ROADMAP §C's counted
class, the reference's FMA contractions; test_torch_cli.py holds its
``.tdcc`` files the same way): the files are then held plane by plane to
that class and the count is printed.
"""

import contextlib
import json
import re
import struct

import numpy as np
import pytest
import torch

import tpudct.cli as RCLI
import tpudct.models.color as RC
import tpudct.models.dispatch as RD
import tpudct.parallel as RP
import tpudct.utils.serialize as RS
import tpudct.utils.streaming as RST
import tpudct_torch.cli as CLI
import tpudct_torch.parallel as PP
import tpudct_torch.utils.serialize as S
import tpudct_torch.utils.streaming as ST
from tpudct import CodecConfig as RCfg
from tpudct import get_pipeline as rget
from tpudct_torch import CodecConfig, get_pipeline
from tpudct_torch.kernels import hp as khp
from tpudct_torch.models import color as mcolor
from tpudct_torch.models import dispatch

CPU = "cpu"
INNERS = ("raw", "spectral", "huffman", "rans", "xz", "auto")


@pytest.fixture(scope="module", autouse=True)
def _native_loaded():
    """Load both packages' host C libraries before any streamed encode.  The
    reference's loader marks itself tried before it builds, so two entropy
    threads at its first use can find no library, and ``auto`` then picks
    another stage than it picks afterwards (a race in the reference; the
    port's loader is a cached call)."""
    from tpudct.utils import entropy as RE
    from tpudct_torch.utils import entropy as E

    assert RE.native_entropy_available() and E.native_entropy_available()


def _gray(shape, seed):
    """A photo-like u8 frame (gradients, waves, sensor noise)."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, shape[0])[:, None]
    x = np.linspace(0.0, 1.0, shape[1])[None, :]
    base = 90 + 80 * x * y + 40 * np.sin(9 * x + 4 * y) * np.cos(7 * y)
    return np.clip(base + rng.normal(0.0, 6.0, base.shape), 0, 255).astype(np.uint8)


def _rgb(shape, seed):
    g = _gray(shape, seed)
    return np.ascontiguousarray(np.stack([g, g[::-1], np.roll(g, 17, 1)], -1))


def _hp():
    return get_pipeline("hp"), rget("hp")


def _raises_alike(ref_call, mine_call):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as want:
        ref_call()
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        mine_call()


def _color_class(label, mine: bytes, ref: bytes, capsys) -> None:
    """Equal .tdcc bytes, or planes within the color split's counted class
    (Y exact, chroma +-1 on <= 0.5%), the count printed."""
    if mine == ref:
        return
    pl, meta = RS.bytes_to_color(mine)
    rpl, rmeta = RS.bytes_to_color(ref)
    assert meta == rmeta
    n = 0
    for k in ("y", "cb", "cr"):
        d = np.abs(pl[k].astype(np.int32) - rpl[k])
        n += int((d > 0).sum())
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, (label, k)
        if k == "y":
            assert not d.any(), label
    with capsys.disabled():
        print(f"{label}: {n} coefficient entries differ from the reference's")


def _pixel_class(label, mine, ref, capsys, share=1e-4) -> None:
    """Color pixels: equal, or +-1 on <= `share` (the merge's .5 ties)."""
    assert mine.shape == ref.shape and mine.dtype == ref.dtype == np.uint8, label
    d = np.abs(mine.astype(np.int16) - ref)
    n = int((d > 0).sum())
    if n:
        with capsys.disabled():
            print(f"{label}: {n} of {ref.size} pixels differ from the reference's")
    assert d.max() <= 1 and n <= share * ref.size, label


# ---- gray encode ------------------------------------------------------------------


GRAY_CASES = [((96, 128), 32), ((200, 312), 32), ((200, 312), 96), ((200, 312), 64), ((200, 312), 4096)]


@pytest.mark.parametrize("shape,band_rows", GRAY_CASES, ids=[f"{s[0]}x{s[1]}-{b}" for s, b in GRAY_CASES])
def test_gray_streamed_bytes_are_the_reference(shape, band_rows):
    """The reference's streamed bytes; and the port's in-memory banded
    writer's where its row split is the band split."""
    p, rp = _hp()
    img = _gray(shape, 1)
    want, hw = RST.encode_gray_streamed_bytes(rp, img, RCfg(), band_rows=band_rows)
    got, hw2 = ST.encode_gray_streamed_bytes(p, img, CodecConfig(), band_rows=band_rows, device=CPU)
    assert got == want and hw2 == hw == shape
    c, _ = dispatch.encode_gray_auto(p, img, CodecConfig(), device=CPU)
    c = c.numpy()
    h8 = c.shape[0]
    br = max(32, band_rows - band_rows % 32)
    splits = [min(br, h8 - a) for a in range(0, h8, br)]
    if S.banded_rows(h8, len(splits)) == splits:
        assert got == S.coefficients_to_bytes(c, orig_shape=shape, codec=f"banded:{len(splits)}")
    assert np.array_equal(S.bytes_to_coefficients(got)[0], c)


@pytest.mark.parametrize("inner", INNERS)
def test_gray_streamed_every_inner_is_the_reference(inner):
    p, rp = _hp()
    img = _gray((96, 128), 2)
    want, _ = RST.encode_gray_streamed_bytes(rp, img, RCfg(), band_rows=32, inner=inner)
    got, _ = ST.encode_gray_streamed_bytes(p, img, CodecConfig(), band_rows=32, inner=inner, device=CPU)
    assert got == want
    c, _ = dispatch.encode_gray_auto(p, img, CodecConfig(), device=CPU)
    assert got == S.coefficients_to_bytes(c.numpy(), orig_shape=(96, 128), codec=f"banded:3:{inner}")


# ---- gray decode ------------------------------------------------------------------


@pytest.fixture(scope="module")
def gray_streams():
    """A ragged 200x312 frame as a banded stream (band 64) and as a
    non-banded rans stream of the same coefficients."""
    p, _rp = _hp()
    img = _gray((200, 312), 3)
    banded, _ = ST.encode_gray_streamed_bytes(p, img, CodecConfig(), band_rows=64, device=CPU)
    c, (h, w) = dispatch.encode_gray_auto(p, img, CodecConfig(), device=CPU)
    return {"banded": banded, "rans": S.coefficients_to_bytes(c.numpy(), orig_shape=(h, w), codec="rans")}


DECODE_MODES = {
    "full": {},
    "planes-4": {"n_planes": 4},
    "scale-2": {"scale_m": 2},
    "scale-4": {"scale_m": 4},
    "scale-6": {"scale_m": 6},
    "rows": {"row_range": (37, 141)},
}


@pytest.mark.parametrize("stream", ["banded", "rans"])
@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_gray_streamed_decode_is_the_reference(gray_streams, stream, mode):
    """Each mode equal to the reference's streamed decode and to the port's
    in-memory decode of the same coefficients."""
    p, rp = _hp()
    kw = DECODE_MODES[mode]
    data = gray_streams[stream]
    want = RST.decode_gray_streamed(rp, data, band_rows=96, **kw)
    got = ST.decode_gray_streamed(p, data, band_rows=96, device=CPU, **kw)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    c = S.bytes_to_coefficients(data)[0]
    cfg = CodecConfig()
    if "n_planes" in kw:
        mem = dispatch.decode_gray_auto(p, S._zero_high_planes(c.copy(), 4), cfg, (200, 312), device=CPU)
    elif "scale_m" in kw:
        mem = dispatch.decode_gray_scaled_auto(p, c, cfg, (200, 312), kw["scale_m"], device=CPU)
    elif "row_range" in kw:
        mem = dispatch.decode_gray_auto(p, c[32:144], cfg, (112, 312), device=CPU)[5:109]
    else:
        mem = dispatch.decode_gray_auto(p, c, cfg, (200, 312), device=CPU)
    assert np.array_equal(got, mem)


def test_gray_streamed_decode_to_npy(gray_streams, tmp_path):
    p, rp = _hp()
    got = ST.decode_gray_streamed(p, gray_streams["banded"], band_rows=32, out_npy=str(tmp_path / "o.npy"),
                                  device=CPU)
    assert isinstance(got, np.memmap)
    got.flush()
    want = RST.decode_gray_streamed(rp, gray_streams["banded"], band_rows=32)
    assert np.array_equal(np.load(tmp_path / "o.npy"), want)


def test_band_rows_bound_the_kernel_bands(monkeypatch):
    """No band that reaches a kernel wrapper is taller than band_rows, even
    where the stream's one segment is the whole map (the counterpart of the
    reference's test of decode_gray_auto's calls)."""
    p, _rp = _hp()
    img = _gray((160, 128), 4)
    data, _ = ST.encode_gray_streamed_bytes(p, img, CodecConfig(), band_rows=4096, device=CPU)
    seen = []
    for name in ("hp_decode_u8", "hp_encode_u8", "hp_scaled_decode_u8"):
        real = getattr(khp, name)

        def spy(x, *a, real=real, **k):
            seen.append(x.shape[0])
            return real(x, *a, **k)

        monkeypatch.setattr(khp, name, spy)
    rec = ST.decode_gray_streamed(p, data, band_rows=32, device=CPU)
    ST.decode_gray_streamed(p, data, band_rows=64, scale_m=2, device=CPU)
    ST.encode_gray_streamed_bytes(p, img, CodecConfig(), band_rows=32, device=CPU)
    assert seen and max(seen) <= 64 and seen.count(32) >= 10
    assert np.array_equal(rec, dispatch.decode_gray_auto(p, S.bytes_to_coefficients(data)[0], CodecConfig(),
                                                         (160, 128), device=CPU))


def test_roi_decodes_only_covering_segments(monkeypatch):
    p, _rp = _hp()
    data, _ = ST.encode_gray_streamed_bytes(p, _gray((256, 128), 5), CodecConfig(), band_rows=32, device=CPU)
    seen = []
    real = S._decode_payload

    def spy(raw, code, h, w):
        seen.append(h)
        return real(raw, code, h, w)

    monkeypatch.setattr(S, "_decode_payload", spy)
    ST.decode_gray_streamed(p, data, band_rows=32, row_range=(64, 96), device=CPU)
    assert sum(seen) == 32


# ---- refusals ---------------------------------------------------------------------


def _corrupt_color_trailing(data: bytes) -> bytes:
    """Junk appended inside the Y plane's banded payload, sizes fixed up."""
    hsizec = struct.calcsize(RS._HEADERC)
    (ylen,) = struct.unpack("<I", data[hsizec : hsizec + 4])
    y = bytearray(data[hsizec + 4 : hsizec + 4 + ylen])
    hdr = RS._parse_plane_header(bytes(y))
    psize, hsize = hdr[9], hdr[10]
    y[hsize + psize : hsize + psize] = b"JUNK!"
    struct.pack_into("<I", y, struct.calcsize(RS._HEADER4) - 4, psize + 5)
    return data[:hsizec] + struct.pack("<I", len(y)) + bytes(y) + data[hsizec + 4 + ylen :]


def _refusal_cases():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (64, 128), dtype=np.uint8)
    rgb = rng.integers(0, 256, (64, 256, 3), dtype=np.uint8)
    c = rng.integers(-90, 90, (64, 128)).astype(np.int16)
    _code, payload = RS._encode_payload(c, "spectral", 6)
    oversized = RS._wrap_v4(64, 128, RS._CODEC_SPECTRAL, payload, 1.0, None, (72, 128), "haweel", "luma")
    planes = {"y": rng.integers(-20, 20, (64, 256)).astype(np.int16),
              "cb": rng.integers(-20, 20, (32, 128)).astype(np.int16),
              "cr": rng.integers(-20, 20, (32, 128)).astype(np.int16)}
    meta = {"orig_shape": (64, 256), "chroma_shape": (30, 128), "subsample": "420"}
    bad_chroma = RS.color_to_bytes(planes, meta, 1.0, None, "haweel", codec="raw")
    good_color = RS.color_to_bytes({k: v for k, v in planes.items()},
                                   {**meta, "chroma_shape": (32, 128)}, 1.0, None, "haweel",
                                   codec="banded:2:raw")
    tall = np.zeros((255 * 32 + 32, 128), np.uint8)
    return {
        "gray banded inner": ("encode_gray_streamed_bytes", (img,), {"inner": "banded"}),
        "color banded inner": ("encode_color_streamed_bytes", (rgb,), {"inner": "banded:4"}),
        "gray float pixels": ("encode_gray_streamed_bytes", (img.astype(np.float32),), {}),
        "color float pixels": ("encode_color_streamed_bytes", (rgb.astype(np.float32),), {}),
        "gray not int8-safe": ("encode_gray_streamed_bytes", (img,), {"cfg": "q0.01"}),
        "gray 256 bands": ("encode_gray_streamed_bytes", (tall,), {"band_rows": 32}),
        "color 256 bands": ("encode_color_streamed_bytes", (np.zeros((255 * 64 + 64, 256, 3), np.uint8),),
                            {"band_rows": 64}),
        "gray oversized orig_shape": ("decode_gray_streamed", (oversized,), {}),
        "gray row_range with scale": ("decode_gray_streamed", (oversized,), {"scale_m": 2, "row_range": (0, 8)}),
        "color inconsistent chroma": ("decode_color_streamed", (bad_chroma,), {"band_rows": 64}),
        "color trailing junk": ("decode_color_streamed", (_corrupt_color_trailing(good_color),),
                                {"band_rows": 64}),
        "roundtrip off-grid": ("roundtrip_u8_streamed", (img[:40],), {}),
    }


REFUSALS = _refusal_cases()


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_are_the_reference(name):
    fn, args, kw = REFUSALS[name]
    p, rp = _hp()
    kw = dict(kw)
    rkw, mkw = dict(kw), dict(kw)
    if kw.get("cfg") == "q0.01":
        rkw["cfg"], mkw["cfg"] = RCfg(q_scale=0.01), CodecConfig(q_scale=0.01)
    _raises_alike(lambda: getattr(RST, fn)(rp, *args, **rkw),
                  lambda: getattr(ST, fn)(p, *args, device=CPU, **mkw))


def test_corrupt_banded_gray_tail_raises():
    p, rp = _hp()
    data, _ = ST.encode_gray_streamed_bytes(p, _gray((96, 128), 6), CodecConfig(), band_rows=32, device=CPU)
    _raises_alike(lambda: RST.decode_gray_streamed(rp, data[:-4]),
                  lambda: ST.decode_gray_streamed(p, data[:-4], device=CPU))


# ---- color ------------------------------------------------------------------------


COLOR_CASES = [("420", (64, 128), 64), ("422", (64, 128), 64), ("444", (64, 128), 64), ("420", (200, 312), 64)]


@pytest.mark.parametrize("mode,shape,band_rows", COLOR_CASES, ids=[f"{m}-{s[0]}x{s[1]}" for m, s, _ in COLOR_CASES])
def test_color_streamed_codec_is_the_reference(mode, shape, band_rows, capsys):
    """The port's streamed bytes are its in-memory banded writer's where
    the splits agree, and its streamed decode its in-memory decode (no
    tolerance); against the reference's, the counted class."""
    p, rp = _hp()
    rgb = _rgb(shape, 7)
    sub = False if mode == "444" else mode
    got, hw = ST.encode_color_streamed_bytes(p, rgb, CodecConfig(), band_rows=band_rows, subsample=sub, device=CPU)
    want, _ = RST.encode_color_streamed_bytes(rp, rgb, RCfg(), band_rows=band_rows, subsample=sub)
    assert hw == shape
    _color_class(f"streamed {mode} {shape}", got, want, capsys)
    planes, meta = mcolor.encode_color_u8(p, rgb, CodecConfig(), subsample=sub, device=CPU)
    planes = {k: v.numpy() for k, v in planes.items()}
    hk = mcolor.color_kernel_shape(*shape)[0]
    n = -(-hk // band_rows)
    y8 = planes["y"].shape[0]
    if S.banded_rows(y8, n) == [min(band_rows, y8 - a) for a in range(0, y8, band_rows)]:
        assert got == S.color_to_bytes(planes, meta, codec=f"banded:{n}")
    back, _ = S.bytes_to_color(got)
    assert all(np.array_equal(back[k], planes[k]) for k in planes)
    mem = mcolor.decode_color_auto(p, planes, meta, CodecConfig(), device=CPU).numpy()
    rec = ST.decode_color_streamed(p, got, band_rows=band_rows, device=CPU)
    assert np.array_equal(rec, mem)
    # cross-reading: each package decodes the other's file as the other does
    for data in (got, want):
        _pixel_class(f"decode {mode} {shape}", ST.decode_color_streamed(p, data, band_rows=band_rows, device=CPU),
                     RST.decode_color_streamed(rp, data, band_rows=band_rows), capsys)


COLOR_PARTIAL = {"planes-4": {"n_planes": 4}, "scale-2": {"scale_m": 2}, "scale-3": {"scale_m": 3},
                 "rows": {"row_range": (37, 90)}}


@pytest.fixture(scope="module")
def color_stream():
    p, _rp = _hp()
    data, _ = ST.encode_color_streamed_bytes(p, _rgb((104, 260), 8), CodecConfig(), band_rows=64, device=CPU)
    return data  # 104 % 16 == 8: the chroma tail case


@pytest.mark.parametrize("mode", list(COLOR_PARTIAL))
def test_color_streamed_partial_modes_are_the_reference(color_stream, mode, capsys):
    p, rp = _hp()
    kw = COLOR_PARTIAL[mode]
    got = ST.decode_color_streamed(p, color_stream, band_rows=64, device=CPU, **kw)
    _pixel_class(f"color {mode}", got, RST.decode_color_streamed(rp, color_stream, band_rows=64, **kw), capsys)
    planes, meta = S.bytes_to_color(color_stream)
    cfg = CodecConfig(q_scale=meta["q_scale"], transform=meta["transform"])
    if "n_planes" in kw:
        pl, pm = S.partial_color_coefficients(color_stream, n_planes=4)
        mem = mcolor.decode_color(p, pl, pm, cfg, device=CPU)
    elif "scale_m" in kw:
        m = kw["scale_m"]
        fac = 8 // m if 8 % m == 0 else None
        mem = mcolor.decode_color_scaled(p, planes, meta, cfg, fac, m=None if fac else m, device=CPU)
    else:  # the in-memory --rows slicing: 16-row aligned, the chroma tail taken whole
        sl = {"y": planes["y"][32:96], "cb": planes["cb"][16:48], "cr": planes["cr"][16:48]}
        smeta = {**meta, "orig_shape": (64, 260), "chroma_shape": (32, 130)}
        mem = mcolor.decode_color(p, sl, smeta, cfg, device=CPU)[5:58]
    assert np.array_equal(got, mem.numpy())


def test_color_streamed_f32_path_stream_is_the_reference(capsys):
    """An off-int8 .tdcc (the f32 encode under transform "dct") streams
    through the f32 decode on every band."""
    p, rp = _hp()
    rgb = _rgb((192, 256), 10)
    cfg = CodecConfig(transform="dct")
    planes, meta = mcolor.encode_color(p, rgb.astype(np.float32), cfg, device=CPU)
    data = S.color_to_bytes({k: v.numpy() for k, v in planes.items()}, meta, cfg.q_scale, None, cfg.transform)
    got = ST.decode_color_streamed(p, data, band_rows=64, device=CPU)
    pl, m2 = S.bytes_to_color(data)
    mem = mcolor.decode_color_auto(p, pl, m2, CodecConfig(q_scale=m2["q_scale"], transform=m2["transform"]),
                                   device=CPU).numpy()
    assert np.array_equal(got, mem)
    _pixel_class("f32-path stream", got, RST.decode_color_streamed(rp, data, band_rows=64), capsys, share=5e-3)


def test_color_streamed_planar_small_and_npy(tmp_path):
    """Below one band, planar (3, H, W) input, a .npy output."""
    p, _rp = _hp()
    img = np.moveaxis(_rgb((40, 150), 11), -1, 0).copy()
    data, hw = ST.encode_color_streamed_bytes(p, img, CodecConfig(), band_rows=64, device=CPU)
    assert hw == (40, 150)
    planes, meta = mcolor.encode_color_u8(p, img, CodecConfig(), device=CPU)
    mem = mcolor.decode_color_auto(p, planes, meta, CodecConfig(), device=CPU).numpy()
    rec = ST.decode_color_streamed(p, data, band_rows=64, out_npy=str(tmp_path / "c.npy"), device=CPU)
    assert isinstance(rec, np.memmap)
    rec.flush()
    assert np.array_equal(np.load(tmp_path / "c.npy"), mem)
    with pytest.raises(ValueError, match="preallocated"):
        ST.decode_color_streamed(p, data, out=np.empty((40, 150), np.uint8), device=CPU)


# ---- the streamed roundtrips --------------------------------------------------------


def test_roundtrip_u8_streamed_is_the_reference():
    p, rp = _hp()
    img = _gray((160, 256), 12)
    wc, wr = RST.roundtrip_u8_streamed(rp, img, RCfg(), band_rows=64)
    c, r = ST.roundtrip_u8_streamed(p, img, CodecConfig(), band_rows=64, device=CPU)
    assert np.array_equal(c, wc) and np.array_equal(r, wr)
    mc, mr = p.roundtrip_u8(torch.as_tensor(img), CodecConfig())
    assert np.array_equal(c, mc.numpy()) and np.array_equal(r, mr.numpy())
    oc, orr = np.empty((160, 256), np.uint8), np.empty((160, 256), np.uint8)
    _raises_alike(lambda: RST.roundtrip_u8_streamed(rp, img, RCfg(), out_coeffs=oc, out_recon=orr),
                  lambda: ST.roundtrip_u8_streamed(p, img, CodecConfig(), out_coeffs=oc, out_recon=orr, device=CPU))


def test_roundtrip_color_u8_streamed_is_the_reference(capsys):
    p, rp = _hp()
    rgb = np.moveaxis(_rgb((192, 256), 13), -1, 0).copy()
    wpl, wmeta, wrec = RST.roundtrip_color_u8_streamed(rp, rgb, RCfg(), band_rows=64)
    pl, meta, rec = ST.roundtrip_color_u8_streamed(p, rgb, CodecConfig(), band_rows=64, device=CPU)
    assert meta == wmeta
    mpl, _m, mrec = mcolor.roundtrip_color_u8(p, rgb, CodecConfig(), device=CPU)
    assert all(np.array_equal(pl[k], mpl[k].numpy()) for k in pl) and np.array_equal(rec, mrec.numpy())
    _color_class("roundtrip_color_u8_streamed",
                 S.color_to_bytes(pl, meta, codec="raw"), RS.color_to_bytes(wpl, wmeta, codec="raw"), capsys)
    _pixel_class("roundtrip_color_u8_streamed", rec, wrec, capsys)


@pytest.fixture(scope="module")
def meshes():
    return PP.band_mesh(devices=[CPU] * 4), RP.band_mesh(4)


def test_roundtrip_u8_streamed_sharded_is_the_reference(meshes):
    mesh, rmesh = meshes
    p, rp = _hp()
    img = _gray((384, 128), 14)  # three host bands of 128 rows, 32 per rank
    wc, wr = RST.roundtrip_u8_streamed_sharded(rp, img, rmesh, RCfg(), band_rows=128)
    c, r = ST.roundtrip_u8_streamed_sharded(p, img, mesh, CodecConfig(), band_rows=128)
    assert np.array_equal(c, wc) and np.array_equal(r, wr)
    _raises_alike(lambda: RST.roundtrip_u8_streamed_sharded(rp, img[:96], rmesh, RCfg()),
                  lambda: ST.roundtrip_u8_streamed_sharded(p, img[:96], mesh, CodecConfig()))


# ---- the sharded saves --------------------------------------------------------------


def test_save_sharded_is_the_reference(meshes, tmp_path):
    """The reference's own save and the single-host banded:4 writer."""
    mesh, rmesh = meshes
    import jax.numpy as jnp

    c = np.random.default_rng(15).integers(-60, 60, (128, 128)).astype(np.float32)
    n = RP.save_sharded(str(tmp_path / "r.tdc"), RP.shard_image(jnp.asarray(c), rmesh), orig_shape=(125, 128))
    m = PP.save_sharded(str(tmp_path / "m.tdc"), PP.shard_image(c, mesh), orig_shape=(125, 128))
    got = (tmp_path / "m.tdc").read_bytes()
    assert m == n and got == (tmp_path / "r.tdc").read_bytes()
    assert got == S.coefficients_to_bytes(c, orig_shape=(125, 128), codec="banded:4")
    assert np.array_equal(S.bytes_to_coefficients(got)[0], c)
    gmesh = PP.grid_mesh((2, 2), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="requires band"):
        PP.save_sharded(str(tmp_path / "g.tdc"), PP.shard_image_grid(c, gmesh))


def test_save_color_sharded_is_the_reference(meshes, tmp_path):
    mesh, rmesh = meshes
    import jax.numpy as jnp

    rng = np.random.default_rng(16)
    planes = {"y": rng.integers(-50, 50, (128, 256)).astype(np.float32),
              "cb": rng.integers(-20, 20, (64, 128)).astype(np.float32),
              "cr": rng.integers(-20, 20, (64, 128)).astype(np.float32)}
    meta = {"orig_shape": (128, 256), "chroma_shape": (64, 128), "subsample": "420"}
    RP.save_color_sharded(str(tmp_path / "r.tdcc"),
                          {k: RP.shard_image(jnp.asarray(v), rmesh) for k, v in planes.items()}, meta)
    PP.save_color_sharded(str(tmp_path / "m.tdcc"), {k: PP.shard_image(v, mesh) for k, v in planes.items()}, meta)
    got = (tmp_path / "m.tdcc").read_bytes()
    assert got == (tmp_path / "r.tdcc").read_bytes()
    assert got == S.color_to_bytes(planes, meta, codec="banded:4")
    back, _ = S.bytes_to_color(got)
    assert all(np.array_equal(back[k], planes[k]) for k in planes)


# ---- the CLI ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_cli")
    np.save(d / "gray.npy", _gray((160, 136), 17))
    np.save(d / "rgb.npy", _rgb((128, 200), 18))
    return d


def _records(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def _both(capsys, argv, out_mine, out_ref) -> tuple:
    assert RCLI.main(argv + [str(out_ref)]) == 0
    want = _records(capsys)
    assert CLI.main(argv + [str(out_mine), "--device", CPU]) == 0
    return _records(capsys), want


def _same_records(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        assert g.pop("ms").keys() == w.pop("ms").keys()
        assert g == w


CLI_ENCODES = {
    "gray": ["--band-rows", "64"],
    "gray-xz": ["--band-rows", "32", "--entropy", "banded:4:xz"],
    "color": ["--color", "--band-rows", "64"],
    "color-444": ["--color", "--chroma", "444", "--band-rows", "64", "--entropy", "rans"],
}


@pytest.mark.parametrize("name", list(CLI_ENCODES))
def test_cli_streamed_encode_is_the_reference(files, capsys, name):
    d = files
    flags = CLI_ENCODES[name]
    color = "--color" in flags
    ext = "tdcc" if color else "tdc"
    src = d / ("rgb.npy" if color else "gray.npy")
    mine, ref = d / f"{name}.mine.{ext}", d / f"{name}.ref.{ext}"
    got, want = _both(capsys, ["encode", *flags, str(src)], mine, ref)
    if color and mine.read_bytes() != ref.read_bytes():
        _color_class(f"cli {name}", mine.read_bytes(), ref.read_bytes(), capsys)
        for r in (*got, *want):  # the byte counts follow the planes
            del r["bytes"], r["factor_vs_raw"]
    else:
        assert mine.read_bytes() == ref.read_bytes()
    assert got[0]["streamed"] is True
    _same_records(got, want)


CLI_DECODES = {
    "gray": ("gray", ["--band-rows", "64"]),
    "gray-scale": ("gray", ["--band-rows", "64", "--scale", "1/2"]),
    "gray-scale-3": ("gray", ["--band-rows", "32", "--scale", "3/8"]),
    "gray-planes": ("gray", ["--band-rows", "64", "--planes", "4"]),
    "gray-rows": ("gray", ["--band-rows", "64", "--rows", "37:141"]),
    "color": ("color", ["--band-rows", "64"]),
    "color-grayscale": ("color", ["--band-rows", "64", "--grayscale"]),
    "color-scale": ("color", ["--band-rows", "64", "--scale", "2/8"]),
    "color-grayscale-scale": ("color", ["--band-rows", "64", "--grayscale", "--scale", "4/8"]),
    "color-planes": ("color", ["--band-rows", "64", "--planes", "3"]),
    "color-grayscale-planes": ("color", ["--band-rows", "64", "--grayscale", "--planes", "5"]),
    "color-rows": ("color", ["--band-rows", "64", "--rows", "9:100"]),
    "color-grayscale-rows": ("color", ["--band-rows", "64", "--grayscale", "--rows", "3:30"]),
}


@pytest.mark.parametrize("out_ext", ["npy", "png"])
@pytest.mark.parametrize("name", list(CLI_DECODES))
def test_cli_streamed_decode_is_the_reference(files, capsys, name, out_ext):
    """Each package's CLI on the port's streamed file: the same pixels and
    records, a .npy output through the memmap."""
    d = files
    stream, flags = CLI_DECODES[name]
    ext = "tdcc" if stream == "color" else "tdc"
    src = d / f"{stream}.stream.{ext}"
    if not src.exists():
        extra = ["--color"] if stream == "color" else []
        npy = d / ("rgb.npy" if stream == "color" else "gray.npy")
        assert CLI.main(["encode", *extra, "--band-rows", "64", "--device", CPU, str(npy), str(src)]) == 0
        capsys.readouterr()
    out = [d / f"{name}.{who}.{out_ext}" for who in ("mine", "ref")]
    got, want = _both(capsys, ["decode", *flags, str(src)], out[0], out[1])
    _same_records(got, want)
    if out_ext == "npy":
        a, b = np.load(out[0]), np.load(out[1])
    else:
        from PIL import Image

        a, b = np.asarray(Image.open(out[0])), np.asarray(Image.open(out[1]))
    if stream == "color":
        _pixel_class(f"cli decode {name}", a, b, capsys, share=5e-3 if "--planes" in flags else 1e-4)
    else:
        assert np.array_equal(a, b)


def test_cli_auto_threshold_streams_like_the_reference(files, capsys, monkeypatch):
    """Images above STREAM_PIXELS stream with no flag (the threshold patched
    down in both packages, not a 4-Gpx frame); a color config the u8
    streamed encoder refuses takes the in-memory path instead."""
    d = files
    monkeypatch.setattr(RST, "STREAM_PIXELS", 64 * 64)
    monkeypatch.setattr(ST, "STREAM_PIXELS", 64 * 64)
    got, want = _both(capsys, ["encode", str(d / "gray.npy")], d / "auto.mine.tdc", d / "auto.ref.tdc")
    assert (d / "auto.mine.tdc").read_bytes() == (d / "auto.ref.tdc").read_bytes()
    assert got[0]["streamed"] is True and S.inspect_stream((d / "auto.mine.tdc").read_bytes())["codec"] == "banded"
    _same_records(got, want)
    assert CLI.main(["decode", "--device", CPU, str(d / "auto.mine.tdc"), str(d / "auto.npy")]) == 0
    assert "(streamed)" in capsys.readouterr().out
    monkeypatch.setattr(ST, "STREAM_PIXELS", 1 << 32)
    assert CLI.main(["decode", "--device", CPU, str(d / "auto.mine.tdc"), str(d / "mem.npy")]) == 0
    assert "(streamed)" not in capsys.readouterr().out
    assert np.array_equal(np.load(d / "auto.npy"), np.load(d / "mem.npy"))
    monkeypatch.setattr(ST, "STREAM_PIXELS", 1000)
    monkeypatch.setattr(RST, "STREAM_PIXELS", 1000)
    for flags, streamed in ((["--transform", "dct"], False), ([], True)):
        got, want = _both(capsys, ["encode", "--color", *flags, str(d / "rgb.npy")],
                          d / "auto.mine.tdcc", d / "auto.ref.tdcc")
        assert got[0].get("streamed", False) is streamed and want[0].get("streamed", False) is streamed
        _color_class("cli auto color", (d / "auto.mine.tdcc").read_bytes(), (d / "auto.ref.tdcc").read_bytes(),
                     capsys)


def test_cli_explicit_band_rows_refuses_f32_configs_like_the_reference(files, capsys):
    argv = ["encode", "--color", "--transform", "dct", "--band-rows", "64", str(files / "rgb.npy"),
            str(files / "x.tdcc")]
    assert RCLI.main(argv) == 1
    want = capsys.readouterr().err
    assert CLI.main(argv + ["--device", CPU]) == 1
    got = capsys.readouterr().err
    assert got == want and got.startswith("error: streamed color encode needs")


def test_streamed_files_cross_read(files, capsys):
    """Each package's streamed files decode in the other, streamed and in
    memory, to the same pixels."""
    p, rp = _hp()
    img = np.load(files / "gray.npy")
    mine, _ = ST.encode_gray_streamed_bytes(p, img, CodecConfig(), band_rows=32, device=CPU)
    ref, _ = RST.encode_gray_streamed_bytes(rp, img, RCfg(), band_rows=32)
    assert mine == ref
    want = RD.decode_gray_auto(rp, RS.bytes_to_coefficients(ref)[0], RCfg(), (160, 136))
    for data in (mine, ref):
        assert np.array_equal(ST.decode_gray_streamed(p, data, band_rows=64, device=CPU), want)
        assert np.array_equal(RST.decode_gray_streamed(rp, data, band_rows=64), want)
        assert np.array_equal(S.bytes_to_coefficients(data)[0], RS.bytes_to_coefficients(data)[0])
    rgb = np.load(files / "rgb.npy")
    cm, _ = ST.encode_color_streamed_bytes(p, rgb, CodecConfig(), band_rows=64, device=CPU)
    cr, _ = RST.encode_color_streamed_bytes(rp, rgb, RCfg(), band_rows=64)
    for data in (cm, cr):
        planes, meta = RS.bytes_to_color(data)
        ref_rec = np.asarray(RC.decode_color_auto(rp, planes, meta, RCfg()))
        _pixel_class("cross-read color", ST.decode_color_streamed(p, data, band_rows=64, device=CPU), ref_rec,
                     capsys)


# ---- the staging's stream and event graph --------------------------------------------


class _Clock:
    """A CUDA stream (or the host) reduced to its ordering: ``seen[s]`` is
    the last op of stream ``s`` that this one's next op is ordered after (a
    vector clock)."""

    def __init__(self, name):
        self.name, self.seen = name, {name: 0}

    def op(self):
        self.seen[self.name] += 1
        return self.name, self.seen[self.name]

    def after(self, op) -> bool:
        return op is None or self.seen.get(op[0], 0) >= op[1]

    def merge(self, seen: dict) -> None:
        for k, v in seen.items():
            self.seen[k] = max(self.seen.get(k, 0), v)

    def wait_event(self, event) -> None:
        self.merge(event.snap)


class _Event:
    def __init__(self, host, enable_timing=False):
        self.host, self.snap = host, {}

    def record(self, stream):
        stream.merge(self.host.seen)  # enqueued after the host's earlier work
        self.snap = dict(stream.seen)

    def synchronize(self):
        self.host.merge(self.snap)

    def elapsed_time(self, other):
        return 0.0


@pytest.mark.parametrize("n_bands,n_out", [(1, 1), (2, 1), (5, 1), (5, 2), (6, 3)])
def test_staging_orders_every_pinned_buffer_access(monkeypatch, n_bands, n_out):
    """The card path of ``_Staging`` with CUDA's streams and events faked on
    the CPU as vector clocks: no host fill of a pinned input buffer before
    the h2d copy that read it two bands ago, every h2d copy on the h2d
    stream after its fill, every kernel on the compute stream after its
    band's copy, every d2h copy on the d2h stream after its kernel and
    after the host's reads of that output buffer, every host read of an
    output buffer after its d2h copy, and every band finished in order."""
    host = _Clock("host")
    compute, h2d, d2h = _Clock("compute"), _Clock("h2d"), _Clock("d2h")
    made = iter([h2d, d2h])
    current = [None]

    @contextlib.contextmanager
    def on(stream):
        before, current[0] = current[0], stream
        yield
        current[0] = before

    def sync(device=None):
        for s in (compute, h2d, d2h):
            host.merge(s.seen)

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: compute)
    monkeypatch.setattr(torch.cuda, "Stream", lambda d=None: next(made))
    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing=False: _Event(host, enable_timing))
    monkeypatch.setattr(ST, "_pinned_bytes", lambda n: torch.empty(n, dtype=torch.uint8))
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None, raising=False)
    pinned = {}  # data_ptr -> (direction, slot)
    fills, reads, written, host_reads, produced, made_by = {}, {}, {}, {}, {}, {}
    real_copy = torch.Tensor.copy_

    def enqueue(stream):
        stream.merge(host.seen)
        return stream.op()

    def copy_(dst, src, non_blocking=False):
        s = current[0]
        key_src, key_dst = pinned.get(src.data_ptr()), pinned.get(dst.data_ptr())
        if key_src is not None:  # h2d: the band's input
            assert s is h2d and non_blocking
            op = enqueue(h2d)
            assert h2d.after(fills[key_src]), f"h2d reads {key_src} before its fill"
            reads[key_src] = op
            made_by[dst.data_ptr()] = op
        elif key_dst is not None:  # d2h: a band's output
            assert s is d2h and non_blocking
            op = enqueue(d2h)
            assert d2h.after(produced[src.data_ptr()]), "d2h reads an output before its kernel"
            assert d2h.after(host_reads.get(key_dst)), f"d2h overwrites {key_dst} before the host read it"
            written[key_dst] = op
        return real_copy(dst, src, non_blocking=non_blocking)

    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    st = ST._Staging("cpu")
    st.cuda = True
    st._init_streams()
    rng = np.random.default_rng(19)
    bands = [rng.integers(-100, 100, (16, 24)).astype(np.int16) for _ in range(n_bands)]
    done = []

    def fill_for(k):
        def fill(v):
            slot = k % 2
            assert host.after(reads.get(("in", slot))), f"band {k} refills slot {slot} before its h2d copy"
            np.copyto(v, bands[k])
            pinned[v.ctypes.data] = ("in", slot)
            fills[("in", slot)] = host.op()
        return fill

    def fn(x):
        assert current[0] is compute
        op = enqueue(compute)
        assert compute.after(made_by[x.data_ptr()]), "a kernel reads its input before the h2d copy"
        outs = tuple((x.to(torch.int32) * (i + 2)).contiguous() for i in range(n_out))
        for o in outs:
            produced[o.data_ptr()] = op
        return outs

    def finish_for(k):
        def finish(*arrays):
            slot = k % 2
            for i, a in enumerate(arrays):
                key = ("out", slot, i)
                assert host.after(written[key]), f"band {k} read before its d2h copy"
                host_reads[key] = host.op()
                assert np.array_equal(a, bands[k].astype(np.int32) * (i + 2))
            done.append(k)
        return finish

    real_pinned = st._pinned

    def pinned_view(key, shape, dtype):
        v = real_pinned(key, shape, dtype)
        if key[0] == "out":
            pinned[v.data_ptr()] = ("out", key[1], key[2])
        return v

    st._pinned = pinned_view
    with st:
        for k in range(n_bands):
            st.band([((16, 24), np.int16, fill_for(k))], fn, finish_for(k))
            assert done == list(range(k)), "a band finished out of order or too early"
    assert done == list(range(n_bands))


def test_bench_gates_are_the_reference(capsys):
    """``bench.py``'s streamed_gray and streamed_color gates on the port:
    the streamed bytes are the in-memory banded writer's (banded:3 gray,
    banded:1 color), the streamed decodes the in-memory decodes; the gray
    bytes are the reference's, the color within its counted class."""
    from tpudct.benchmark import synthetic_image as r_synthetic
    from tpudct_torch.benchmark import synthetic_image

    p, rp = _hp()
    gimg = synthetic_image(128).astype(np.uint8)[:96]
    assert np.array_equal(gimg, r_synthetic(128).astype(np.uint8)[:96])
    sdata, _ = ST.encode_gray_streamed_bytes(p, gimg, CodecConfig(), band_rows=32, device=CPU)
    c_ref, (gh, gw) = dispatch.encode_gray_auto(p, gimg, CodecConfig(), device=CPU)
    assert sdata == S.coefficients_to_bytes(c_ref.numpy(), orig_shape=(gh, gw), codec="banded:3")
    assert sdata == RST.encode_gray_streamed_bytes(rp, gimg, RCfg(), band_rows=32)[0]
    assert np.array_equal(ST.decode_gray_streamed(p, sdata, band_rows=32, device=CPU),
                          dispatch.decode_gray_auto(p, c_ref, CodecConfig(), (gh, gw), device=CPU))
    crgb = np.stack([gimg[:64], np.roll(gimg[:64], 3, 0), np.roll(gimg[:64], 5, 1)], -1)
    csdata, _ = ST.encode_color_streamed_bytes(p, crgb, CodecConfig(), band_rows=64, device=CPU)
    pl, meta = mcolor.encode_color_u8(p, crgb, CodecConfig(), device=CPU)
    assert csdata == S.color_to_bytes({k: v.numpy() for k, v in pl.items()}, meta, codec="banded:1")
    _color_class("bench gate color", csdata,
                 RST.encode_color_streamed_bytes(rp, crgb, RCfg(), band_rows=64)[0], capsys)
    assert np.array_equal(ST.decode_color_streamed(p, csdata, band_rows=64, device=CPU),
                          mcolor.decode_color_auto(p, pl, meta, CodecConfig(), device=CPU).numpy())
