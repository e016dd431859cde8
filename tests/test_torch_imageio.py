"""tpudct_torch.utils.imageio, ops.quant.q_scale_for_quality and the
compression metrics of utils.metrics against the reference's, on the CPU.

Same seeded images into both packages.  Tolerances: image files and pixels
bit-identical (the same libjpeg through the same C source, or the same PIL
and numpy code); q_scale_for_quality exact; the compression factors within
1e-12 (byte counts of identical streams); quality_report's MSE/PSNR/PEEN
within 1e-5 relative and SSIM within 1e-4, the tolerances of
test_torch_benchmark.py's metric test (the port sums in float64, the
reference in float32).
"""

import re

import numpy as np
import pytest
import torch

import tpudct.ops.quant as RQ
import tpudct.utils.imageio as RI
import tpudct.utils.metrics as RM
import tpudct_torch.ops.quant as Q
import tpudct_torch.utils.imageio as I
import tpudct_torch.utils.metrics as M
from tpudct_torch.utils import native


def _photo(h, w, seed, channels=0):
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    base = 90 + 80 * x * y + 40 * np.sin(9 * x + 4 * y)
    shape = (h, w, channels) if channels else (h, w)
    img = (base[..., None] if channels else base) + rng.normal(0.0, 6.0, shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("ext", [".npy", ".png", ".jpg"])
@pytest.mark.parametrize("channels", [0, 3])
def test_save_and_load_are_the_reference(tmp_path, ext, channels):
    img = _photo(40, 56, seed=channels + len(ext), channels=channels)
    mine, ref = tmp_path / f"mine{ext}", tmp_path / f"ref{ext}"
    I.save_image(str(mine), img, quality=90)
    RI.save_image(str(ref), img, quality=90)
    assert mine.read_bytes() == ref.read_bytes()
    for gray in (True, False):
        a = I.load_image(str(ref), force_gray=gray)
        b = RI.load_image(str(mine), force_gray=gray)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.uint8
    if ext != ".jpg":  # the lossless formats give the pixels back
        np.testing.assert_array_equal(I.load_image(str(mine), force_gray=False), img)


def test_npy_loads_as_a_read_only_memory_map(tmp_path):
    img = _photo(24, 32, seed=1, channels=3)
    np.save(tmp_path / "x.npy", img)
    a = I.load_image(str(tmp_path / "x.npy"), force_gray=False)
    assert isinstance(a, np.memmap) and not a.flags.writeable
    np.testing.assert_array_equal(I.load_image(str(tmp_path / "x.npy")),
                                  RI.load_image(str(tmp_path / "x.npy")))


def test_jpeg_entry_points_are_the_reference(tmp_path):
    imgs = [_photo(32, 48, seed=s, channels=c) for s, c in ((1, 0), (2, 3), (3, 0))]
    assert I.native_backend_available()
    for q in (75, 100):
        for img in imgs:
            assert I.encode_jpeg_bytes(img, q) == RI.encode_jpeg_bytes(img, q)
    paths = []
    for i, img in enumerate(imgs):
        p = str(tmp_path / f"{i}.jpg")
        RI.save_jpeg(p, img, quality=85)
        paths.append(p)
    for gray in (True, False):
        for a, b in zip(I.load_jpeg_batch(paths, 2, gray), RI.load_jpeg_batch(paths, 2, gray)):
            np.testing.assert_array_equal(a, b)
        for p in paths:
            np.testing.assert_array_equal(I.load_jpeg(p, gray), RI.load_jpeg(p, gray))
    bad = paths + [str(tmp_path / "missing.jpg")]
    assert I.load_jpeg_batch(bad, errors="none")[-1] is None
    with pytest.raises(IOError):
        I.load_jpeg_batch(bad)
    assert I.probe_image_size(paths[1]) == RI.probe_image_size(paths[1]) == (32, 48)
    assert I.probe_image_size(str(tmp_path / "missing.jpg")) is None


def test_without_the_native_library_jpeg_goes_through_pil(tmp_path, monkeypatch):
    """TPUDCT_NO_NATIVE_JPEG: the reference's PIL fallback, in both directions."""
    from PIL import Image

    img = _photo(32, 40, seed=4, channels=3)
    monkeypatch.setenv("TPUDCT_NO_NATIVE_JPEG", "1")
    assert not I.native_backend_available()
    p = str(tmp_path / "pil.jpg")
    I.save_jpeg(p, img, quality=90)
    want = np.asarray(Image.open(p).convert("L"))
    np.testing.assert_array_equal(I.load_jpeg(p), want)
    np.testing.assert_array_equal(I.load_image(p), want)
    buf = I.encode_jpeg_bytes(img, 90)
    assert buf[:2] == b"\xff\xd8" and len(buf) > 100


@pytest.mark.parametrize("bad", ["x.webp", "x"])
def test_unsupported_outputs_refused_like_reference(tmp_path, bad):
    img = _photo(8, 8, seed=5)
    with pytest.raises(ValueError) as want:
        RI.save_image(str(tmp_path / bad), img)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        I.save_image(str(tmp_path / bad), img)


def test_q_scale_for_quality_is_the_reference():
    for q in range(-3, 105):
        assert Q.q_scale_for_quality(q) == RQ.q_scale_for_quality(q)
    assert Q.q_scale_for_quality(50) == 1.0


@pytest.mark.parametrize("shape,level", [((64, 128), 6), ((40, 56), 9), ((37, 53), 6)])
def test_compression_factor_is_the_reference(shape, level):
    """8-aligned maps: the auto .tdc payload; others: zlib of the raw map."""
    img = _photo(*shape, seed=shape[1])
    rng = np.random.default_rng(shape[0])
    c = np.round(rng.laplace(0.0, 2.0, shape)).astype(np.int16)
    want = RM.compression_factor(img, c, level)
    assert abs(M.compression_factor(img, c, level) - want) <= 1e-12 * want
    assert abs(M.compression_factor(torch.as_tensor(img), torch.as_tensor(c), level) - want) <= 1e-12 * want


def test_quality_report_is_the_reference():
    img = _photo(64, 96, seed=6)
    rec = np.clip(img.astype(np.int16) + np.random.default_rng(7).integers(-3, 4, img.shape), 0, 255).astype(np.uint8)
    c = np.round(np.random.default_rng(8).laplace(0.0, 2.0, img.shape)).astype(np.int16)
    mine, ref = M.quality_report(img, rec, c, device="cpu"), RM.quality_report(img, rec, c)
    assert mine.keys() == ref.keys()
    for k in ("compression_factor", "jpeg_factor"):
        assert abs(mine[k] - ref[k]) <= 1e-12 * ref[k], k
    for k in ("mse", "psnr_db", "peen_pct"):
        assert abs(mine[k] - ref[k]) <= 1e-5 * abs(ref[k]), k
    assert abs(mine["ssim"] - ref["ssim"]) <= 1e-4
    assert M.jpeg_compression_factor(img, rec, 90) == RM.jpeg_compression_factor(img, rec, 90)


def test_jpeg_library_absent_leaves_jpeg_to_pil(tmp_path, monkeypatch):
    """A JPEG library that does not build (no libjpeg headers) is None,
    not an error; the entropy library is unaffected."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "jpeg_codec.c").write_text("#include <no_such_header.h>\n")
    (src / "entropy.c").write_bytes((native.CSRC / "entropy.c").read_bytes())
    monkeypatch.setattr(native, "CSRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    native._jpeg_or_none.cache_clear()
    try:
        assert native.jpeg_library() is None
        assert native.entropy_library() is not None
    finally:
        native._load.cache_clear()
        native._jpeg_or_none.cache_clear()
