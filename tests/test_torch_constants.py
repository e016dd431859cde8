"""tpudct_torch constants, kernel parameters and gates against the reference.

Tolerance: none.  Every table, transform core, row norm, kernel constant
and gate decision must equal the reference's bit for bit, since they are
the codec's only parameters: with equal parameters both packages compute
the same codec.
"""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import tpudct.constants as R
import tpudct_torch
import tpudct_torch.constants as P
from tpudct.kernels import hp_pallas
from tpudct_torch.kernels import hp

_INT_CORES = ["haweel", "rdct", "wht", "bas"]


def test_tables_and_cores_equal_reference():
    assert P.BLOCK_SIZE == R.BLOCK_SIZE and P.LEVEL_SHIFT == R.LEVEL_SHIFT
    for a, b in [(P.HAWEEL_TS, R.HAWEEL_TS), (P.T, R.T), (P.Q, R.Q), (P.QC, R.QC),
                 (P.haweel_row_norms(), R.haweel_row_norms()),
                 (P.haweel_integer_core(), R.haweel_integer_core())]:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_derive_T_is_the_reference():
    """T's literals are the Haweel construction (within 5e-9 in float64),
    and the derivation is the reference's in both dtypes."""
    np.testing.assert_allclose(P.T, P.derive_T(np.float64), atol=5e-9)
    for dtype in (np.float64, np.float32):
        a, b = P.derive_T(dtype), R.derive_T(dtype)
        assert a.dtype == b.dtype == dtype and np.array_equal(a, b)


@pytest.mark.parametrize("scale", [1.0, 0.5, 2.5])
def test_tiled_Q_is_the_reference(scale):
    a, b = P.tiled_Q(128, 256, scale), R.tiled_Q(128, 256, scale)
    assert a.shape == (128, 256) and a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(P.tiled_Q(16, 8, scale, np.float64), R.tiled_Q(16, 8, scale, np.float64))
    # a tile that is not whole blocks: both refuse (the reference by assert)
    with pytest.raises(ValueError, match="not a grid"):
        P.tiled_Q(12, 16)
    with pytest.raises(AssertionError):
        R.tiled_Q(12, 16)


@pytest.mark.parametrize("name", sorted(R.TRANSFORMS) + sorted(R.TRANSFORM_ALIASES))
def test_transform_registry_equals_reference(name):
    a, b = P.get_transform(name), R.get_transform(name)
    assert a.name == b.name and a.has_integer_core == b.has_integer_core
    for x, y in [(a.t, b.t), (a.ts, b.ts), (a.d, b.d)]:
        if y is None:
            assert x is None
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_registry_names_and_errors():
    assert sorted(P.TRANSFORMS) == sorted(R.TRANSFORMS)
    assert P.TRANSFORM_ALIASES == R.TRANSFORM_ALIASES
    with pytest.raises(ValueError, match="unknown transform"):
        P.get_transform("nope")
    with pytest.raises(KeyError, match="unknown quantization table"):
        P.get_q_table("nope")


def test_registered_table_gets_the_same_name_in_both_packages():
    table = np.random.default_rng(3).integers(1, 120, size=(8, 8)).astype(np.float32)
    name_p, name_r = P.register_q_table(table), R.register_q_table(table)
    assert name_p == name_r and name_p.startswith("q:")
    assert np.array_equal(P.get_q_table(name_p), R.get_q_table(name_r))
    assert P.register_q_table(table) == name_p  # re-registering is a no-op
    with pytest.raises(ValueError, match="already registered"):
        P.register_q_table(table + 1, name=name_p)
    with pytest.raises(ValueError, match="8x8"):
        P.register_q_table(np.ones((4, 4)))
    with pytest.raises(ValueError, match="> 0"):
        P.register_q_table(np.zeros((8, 8)))


@pytest.mark.parametrize("retain_k", [None, 6])
@pytest.mark.parametrize("q_scale", [1.0, 2.5])
@pytest.mark.parametrize("q_table", ["luma", "chroma"])
@pytest.mark.parametrize("transform", _INT_CORES)
def test_kernel_constants_equal_reference_tiles(transform, q_table, q_scale, retain_k):
    """The 8x8 tables equal the top-left block of the reference's tiled
    Pallas constants (_consts_int, _consts_bf, _consts_f32)."""
    k = hp.kernel_constants(transform, q_table, q_scale, retain_k)
    bdts, _, scale = hp_pallas._consts_int(32, q_scale, retain_k, transform, q_table)
    qdd, _, _ = hp_pallas._consts_bf(32, q_scale, transform, q_table)
    bdt, _, qt = hp_pallas._consts_f32(32, q_scale, transform, q_table)
    for mine, ref in [(k.ts, bdts), (k.scale, scale), (k.qdd, qdd), (k.t, bdt), (k.q, qt)]:
        assert mine.dtype == ref.dtype
        assert np.array_equal(mine, ref[:8, :8])


def test_kernel_constants_refuse_a_transform_without_integer_core():
    """A transform without an integer core has only the literal tables; its
    integer-core forward and butterfly inverse are refused, as in the
    reference's _consts_int and _consts_bf."""
    k = hp.kernel_constants("dct")
    assert k.ts is None and k.scale is None and k.qdd is None
    with pytest.raises(ValueError, match="has none"):
        hp._args("dct", "luma", 1.0, None, "highest", True)
    with pytest.raises(ValueError, match="has none"):
        hp._args("dct", "luma", 1.0, None, "butterfly", False)
    for ref in (lambda: hp_pallas._consts_int(32, 1.0, None, "dct"),
                lambda: hp_pallas._consts_bf(32, 1.0, "dct")):
        with pytest.raises(ValueError, match="has none"):
            ref()


@pytest.mark.parametrize("retain_k", [None, 6])
@pytest.mark.parametrize("q_scale", [1.0, 0.5])
@pytest.mark.parametrize("transform", sorted(R.TRANSFORMS))
def test_literal_tables_equal_reference_tiles(transform, q_scale, retain_k):
    """T, Q q_scale and the mask of the f32-literal core equal the top-left
    block of the reference's _consts_f32 and hp_roundtrip's mask tile, for
    every transform."""
    from tpudct.ops.quant import retention_mask

    k = hp.kernel_constants(transform, "luma", q_scale, retain_k)
    bdt, _, qt = hp_pallas._consts_f32(32, q_scale, transform, "luma")
    for mine, ref in [(k.t, bdt[:8, :8]), (k.q, qt[:8, :8]),
                      (k.mask, retention_mask(retain_k).astype(np.float32))]:
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    a = hp._args(transform, "luma", q_scale, retain_k, "highest", False)
    assert np.array_equal(a.fwd, k.t) and np.array_equal(a.mask, k.mask)
    assert a.packed.dtype == np.float32 and a.packed.size == 5 * 64


def test_scaled_gates_agree_with_reference():
    for fr in (1, 2, 3, 4, 8):
        for fc in (1, 2, 4, 8):
            assert hp.scaled_pad_align(fr, fc) == hp_pallas.scaled_pad_align(fr, fc)
            for h, w in [(64, 1024), (64, 128), (60, 1024), (32, 512), (256, 2048), (96, 384)]:
                for q_scale, transform in [(1.0, "haweel"), (0.5, "haweel"), (1.0, "dct")]:
                    assert hp.supports_scaled_u8(h, w, fr, fc, q_scale, transform) == \
                        hp_pallas.supports_scaled_u8(h, w, fr, fc, q_scale, transform)


@pytest.mark.parametrize("q_table", ["luma", "chroma"])
@pytest.mark.parametrize("transform", sorted(R.TRANSFORMS))
def test_gates_agree_with_reference(transform, q_table):
    assert hp._max_coeff(transform, q_table) == hp_pallas._max_coeff(transform, q_table)
    for h in (8, 16, 32, 40, 64, 96, 4000):
        for w in (8, 120, 128, 256, 300, 3072):
            assert hp.supports(h, w) == hp_pallas.supports(h, w)
            for q_scale in (0.5, 0.76, 0.77, 1.0, 2.5):
                assert hp.supports_u8(h, w, q_scale, transform, q_table) == hp_pallas.supports_u8(
                    h, w, q_scale, transform, q_table
                )


def test_haweel_int8_bound():
    assert 97.0 < hp._max_coeff("haweel", "luma") < 97.5


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(tpudct_torch.__path__, "tpudct_torch.")
    )


def test_port_imports_no_jax():
    """Every module of the port and chip_smoke.py import without JAX or the
    reference package (the card's machine has neither)."""
    mods = _port_modules() + ["chip_smoke"]
    assert "tpudct_torch.kernels.hp" in mods and "tpudct_torch.models.dispatch" in mods
    assert "tpudct_torch.ops.scaled" in mods and "tpudct_torch.entry" in mods
    assert {"tpudct_torch.kernels.color", "tpudct_torch.models.color", "tpudct_torch.utils.color"} <= set(mods)
    assert {"tpudct_torch.kernels.ring", "tpudct_torch.parallel", "tpudct_torch.parallel.mesh",
            "tpudct_torch.parallel.sharding", "tpudct_torch.parallel.ring"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpudct'))\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env, check=True, timeout=120)


_FAKE_NVCC = {
    # every compile fails
    "compile": 'echo "fake nvcc: compile refused" >&2; exit 2\n',
    # compiles write their object; the link fails
    "link": 'case "$*" in *-shared*) echo "fake nvcc: link refused" >&2; exit 1;; esac\n'
            'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n',
}


@pytest.mark.parametrize("stage", sorted(_FAKE_NVCC))
def test_failed_build_raises_with_nvccs_stderr(stage, monkeypatch, tmp_path):
    """A compile or link that nvcc refuses raises with its stderr, and leaves
    no library behind to load."""
    from tpudct_torch.kernels import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + _FAKE_NVCC[stage])
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    what = "hp_codec.cu" if stage == "compile" else "the link"
    with pytest.raises(RuntimeError, match=f"nvcc failed .* on {what}:\n.*fake nvcc: {stage} refused"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("edited", ["hp_block.cuh", "copy.cuh", "strip420.cuh"])
def test_library_name_follows_the_shared_headers(edited, monkeypatch, tmp_path):
    """The library is named by a hash of the sources AND the headers they
    include, so an edited header rebuilds (the ring kernels share the block
    decode and the 4:2:0 merge with B3 and B9, and B14 shares the copy body
    with B17/B18, through csrc/*.cuh)."""
    from tpudct_torch.kernels import _build

    names = {p.name for p in _build.headers()}
    assert {"hp_block.cuh", "color_px.cuh", "strip420.cuh", "copy.cuh"} <= names
    assert {p.name for p in _build.SOURCES} == {"hp_codec.cu", "hp_inverse.cu", "color_codec.cu", "ring.cu",
                                                "study.cu"}
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.SOURCES[0].parent, csrc)
    monkeypatch.setattr(_build, "SOURCES", tuple(csrc / p.name for p in _build.SOURCES))
    before = _build.library_path()
    assert before == _build.library_path()
    header = csrc / edited
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path()
    assert after != before and after.parent == before.parent


# An element copy loop: a for statement whose one statement stores an indexed
# element loaded from an indexed element (the form B14's and B17's loops had
# before they shared csrc/copy.cuh).
_COPY_LOOP = re.compile(r"for\s*\([^;]*;[^;]*;[^)]*\)\s*\w+\[\w+\]\s*=\s*\w+\[\w+\];")


@pytest.mark.parametrize("source", ["ring.cu", "study.cu"])
def test_copy_kernels_share_one_copy_body(source):
    """B14 (ring.cu) and B17/B18 (study.cu) run csrc/copy.cuh's body: each
    source includes it and calls copy_bytes, and neither keeps a copy loop,
    a 16-byte vector access or a grid cap of its own."""
    from tpudct_torch.kernels import _build

    csrc = _build.SOURCES[0].parent
    text = (csrc / source).read_text()
    assert '#include "copy.cuh"' in text
    assert re.search(r"copy_bytes<(false|kI8)>\(src, dst, (nullptr|i8), n(bytes)?\);", text)
    assert "kMaxCopyBlocks" not in text and "uint4" not in text
    assert not _COPY_LOOP.search(text)
    assert _COPY_LOOP.search("for (long long i = done + t; i < nbytes; i += stride) dst[i] = src[i];")
    assert _COPY_LOOP.search("for (long long i = t; i < n16; i += stride) d[i] = s[i];")
    body = (csrc / "copy.cuh").read_text()
    assert body.count("void copy_bytes(") == 1 and "kMaxCopyBlocks" not in body


def _c_interface() -> dict:
    """name -> argument kinds ('p' pointer, 'l' long long, 'i' int) of every
    function in the sources' ``extern "C"`` blocks."""
    from tpudct_torch.kernels import _build

    found = {}
    for src in _build.SOURCES:
        text = src.read_text()
        block = text[text.index('extern "C" {'):]
        for name, params in re.findall(r"^(?:int|const char\*) (\w+)\(([^)]*)\)", block, re.M):
            found[name] = "".join(
                "p" if "*" in a else "l" if "long long" in a else "i" for a in params.split(",")
            )
    return found


def test_ctypes_signatures_match_the_c_interface():
    """Every function the library declares to ctypes exists in the sources'
    C interface with the same arguments, so a changed launcher (B3's gained
    the ring's forward pointer) cannot be called with a stale signature; the
    launchers end with (stream, device)."""
    import ctypes

    from tpudct_torch.kernels import _build

    kind = {ctypes.c_void_p: "p", ctypes.c_longlong: "l", ctypes.c_int: "i"}
    c = _c_interface()
    for name, argtypes in _build._SIGNATURES.items():
        assert c.get(name) == "".join(kind[t] for t in argtypes), name
        if name.endswith("_launch"):
            assert c[name].endswith("pi"), name
    assert set(c) - set(_build._SIGNATURES) == {"hp_error_string"}
    assert c["hp_decode_u8_launch"] == "ppiipippi"  # coef, rec, h, w, fwd, core, consts, stream, device
    assert c["hp_rt_u8_launch"] == "pppiiiippi"  # img, coef, rec, h, w, core, inv, consts, stream, device
    # coef, out, h, w, fr, fc, out_u8, core, consts, stream, device
    assert c["hp_scaled_decode_u8_launch"] == "ppiiiiiippi"
    assert c["idct_split3_launch"] == "ppiippi"  # coef, rec, h, w, consts, stream, device
