"""tpudct_torch.utils.entropy (and the host C library of
tpudct_torch.utils.native) against tpudct.utils.entropy, on the CPU.

Same seeded int16 maps into both packages.  Tolerance: none — the Huffman
and rANS streams are byte-identical (the same C source, compiler and flags
on one host), each package decodes the other's streams to the exact map,
and the pure-Python decoders equal the native ones.
"""

import numpy as np
import pytest

import tpudct.utils.entropy as RE
import tpudct_torch.utils.entropy as E
from tpudct_torch.utils import native


def _map(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "laplace":  # coefficient-like: small AC, larger DC
        c = np.round(rng.laplace(0.0, 2.5, shape))
        c[::8, ::8] = rng.integers(-400, 400, size=c[::8, ::8].shape)
    elif kind == "sparse":  # mostly zero blocks (a retained, coarse map)
        c = np.where(rng.random(shape) < 0.05, rng.integers(-9, 10, shape), 0)
    elif kind == "extremes":  # the int16 edges the symbol model codes
        c = rng.choice(np.array([-32767, -256, -1, 0, 1, 255, 32767]), size=shape)
    else:  # "zeros"
        c = np.zeros(shape)
    return c.astype(np.int16)


MAPS = [("laplace", (64, 128), 1), ("laplace", (40, 56), 2), ("sparse", (96, 64), 3),
        ("extremes", (16, 24), 4), ("extremes", (64, 64), 5), ("zeros", (8, 8), 6)]
IDS = [f"{k}-{s[0]}x{s[1]}" for k, s, _ in MAPS]


@pytest.mark.parametrize("kind,shape,seed", MAPS, ids=IDS)
def test_huffman_bytes_are_the_reference(kind, shape, seed):
    c = _map(kind, shape, seed)
    mine, ref = E.huff_encode(c), RE.huff_encode(c)
    assert mine == ref
    np.testing.assert_array_equal(E.huff_decode(ref, *shape), c)
    np.testing.assert_array_equal(RE.huff_decode(mine, *shape), c)
    np.testing.assert_array_equal(E._py_decode(mine, *shape), c)


@pytest.mark.parametrize("bands,interleave", [(0, 0), (1, 0), (3, 0), (16, 0), (0, 4), (2, 4)])
@pytest.mark.parametrize("kind,shape,seed", MAPS, ids=IDS)
def test_rans_bytes_are_the_reference(kind, shape, seed, bands, interleave):
    c = _map(kind, shape, seed)
    mine = E.rans_encode(c, bands, interleave)
    ref = RE.rans_encode(c, bands, interleave)
    assert mine == ref
    np.testing.assert_array_equal(E.rans_decode(ref, *shape), c)
    np.testing.assert_array_equal(RE.rans_decode(mine, *shape), c)
    np.testing.assert_array_equal(E._py_rans_decode(mine, *shape), c)


def test_int16_edges_round_trip_through_every_decoder():
    """+-32767, the largest magnitudes the 4-bit size field codes."""
    c = _map("extremes", (32, 40), 9)
    assert (c == -32767).any() and (c == 32767).any()
    for enc, dec, py in ((E.huff_encode, E.huff_decode, E._py_decode),
                         (E.rans_encode, E.rans_decode, E._py_rans_decode)):
        s = enc(c)
        np.testing.assert_array_equal(dec(s, 32, 40), c)
        np.testing.assert_array_equal(py(s, 32, 40), c)


@pytest.mark.parametrize("fn", ["huff_encode", "rans_encode"])
def test_int16_min_is_refused_like_reference(fn):
    """-32768 has magnitude category 16, which the symbol model cannot code:
    entropy.c's has_int16_min makes both encoders refuse it."""
    c = _map("laplace", (16, 24), 10)
    c[3, 5] = -32768
    with pytest.raises(ValueError) as want:
        getattr(RE, fn)(c)
    with pytest.raises(ValueError, match=str(want.value)):
        getattr(E, fn)(c)


def test_native_switch_turns_the_library_off(monkeypatch):
    """TPUDCT_NO_NATIVE_JPEG: decoders fall back to pure Python, encoders
    raise, as the reference's do when its library is absent."""
    c = _map("laplace", (16, 24), 7)
    h, r = E.huff_encode(c), E.rans_encode(c)
    monkeypatch.setenv("TPUDCT_NO_NATIVE_JPEG", "1")
    assert not E.native_entropy_available() and not E.rans_available()
    np.testing.assert_array_equal(E.huff_decode(h, 16, 24), c)
    np.testing.assert_array_equal(E.rans_decode(r, 16, 24), c)
    with pytest.raises(RuntimeError, match="native entropy codec unavailable"):
        E.huff_encode(c)
    with pytest.raises(RuntimeError, match="native entropy codec unavailable"):
        E.rans_encode(c)


@pytest.mark.parametrize("fn,args", [
    ("rans_encode", {"bands": 17}),
    ("rans_encode", {"interleave": 2}),
])
def test_refusals_are_the_reference(fn, args):
    c = _map("laplace", (16, 16), 8)
    with pytest.raises(ValueError) as want:
        getattr(RE, fn)(c, **args)
    with pytest.raises(ValueError, match=str(want.value)):
        getattr(E, fn)(c, **args)


@pytest.mark.parametrize("fn", ["huff_encode", "rans_encode"])
def test_unaligned_maps_refused_like_reference(fn):
    c = np.zeros((12, 16), np.int16)
    with pytest.raises(ValueError) as want:
        getattr(RE, fn)(c)
    with pytest.raises(ValueError, match=str(want.value)):
        getattr(E, fn)(c)


@pytest.mark.parametrize("fn,bad", [("huff_decode", b"\x01\x02\x03"), ("rans_decode", b"\xff" * 5)])
def test_corrupt_streams_raise(fn, bad):
    with pytest.raises(ValueError):
        getattr(E, fn)(bad, 8, 8)


def test_build_command_is_the_makefile_s():
    """The Makefile's flags, one source per library, libjpeg only in the
    JPEG library's link."""
    ent = native.command("entropy", "out.so")
    jpg = native.command("jpeg", "out.so")
    for cmd in (ent, jpg):
        assert cmd[1:7] == ["-O3", "-march=native", "-Wall", "-fPIC", "-pthread", "-shared"]
        assert cmd[-2:] == ["-lpthread", "-lm"]
    assert ent[9].endswith("csrc/entropy.c") and "-ljpeg" not in ent
    assert jpg[9].endswith("csrc/jpeg_codec.c") and "-ljpeg" in jpg


def test_build_writes_only_into_its_build_dir(tmp_path, monkeypatch):
    """Building both libraries leaves csrc/ as it was: the outputs go to the
    build directory, named by a hash of source, compiler and flags."""
    from tpudct.utils import imageio as RI

    RI._load_native()  # the reference's own library (make -C csrc), first
    before = sorted(p.name for p in native.CSRC.iterdir())
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths = [native.build(name) for name in ("entropy", "jpeg")]
    assert sorted(p.name for p in native.CSRC.iterdir()) == before
    assert all(p.parent == tmp_path / "build" and p.exists() for p in paths)
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(p.name for p in paths)
    assert native.build("entropy") == paths[0]  # built once: found by its name


def test_failed_entropy_build_raises_with_the_compiler_s_stderr(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "entropy.c").write_text("this is not C\n")
    monkeypatch.setattr(native, "CSRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed .* on csrc/entropy.c:\n.*error"):
        native.build("entropy")
    assert not any((tmp_path / "build").iterdir())  # no partial library left
