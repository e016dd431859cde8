"""The 4:2:0 strip body of B16 and B20 (tpudct_torch/csrc/strip420.cuh and
its host side, tpudct_torch/kernels/strip420.py), on the CPU.

The CUDA body cannot run here, so these tests hold what it is built from:
- the integer cores compiled into it (parsed from csrc/hp_block.cuh, which
  defines them once for the strip and for B1/B3/B15) are the package's Ts,
  and every transform name reaches the right instance;
- its add-only inverse, emulated step for step in numpy float32 (each
  output sums only its nonzero terms in k = 0..7 order, +-1 as an add or
  subtract, +-2 as v + v), gives the dense twin's f32 values bit for bit
  (kernels.hp._inv_plain, then + 128), for every core, both tables and
  q_scale 0.5, 1 and 2.5, on random int8 blocks and extremes;
- its conversion-free byte <-> f32 forms, over all 256 bytes, and its
  merge round without the clip, over all 256^3 (y, cb, cr) triples;
- the wrappers' check that the compiled table is the transform's Ts;
- that B16 and B20 run the one body;
- and the B20 twin against the reference on int8 noise for every core.
The card runs the kernels against their twins (chip_smoke.py phase 4).

Tolerances: bit-identical everywhere, except the B20 twin against the
reference's interpreted Pallas kernel: XLA on the CPU may contract the
BT.601 products into FMAs (tests/test_torch_studies.py), +-1 on at most
0.5% of outputs.
"""

import importlib.util
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudct_torch.constants import TRANSFORMS, get_transform
from tpudct_torch.kernels import _build
from tpudct_torch.kernels import color as ck
from tpudct_torch.kernels import cores
from tpudct_torch.kernels import hp
from tpudct_torch.kernels import ring as rk
from tpudct_torch.kernels import strip420
from tpudct_torch.kernels import study

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _ROOT / "tpudct_torch" / "csrc"
F32 = np.float32


def _header_tables() -> list:
    """[(name, 8x8 table)] in the order core_ts lists them, parsed here
    from the header on its own (not through kernels.cores)."""
    text = (_CSRC / "hp_block.cuh").read_text()
    body = re.search(r"constexpr int core_ts\(int core, int e\) \{(.*?)return ts\[core\]\[e\];", text, re.S).group(1)
    out = []
    for name, entries in re.findall(r"//\s*(\w+)\s*\n\s*\{([^}]*)\}", body):
        vals = [int(v) for v in entries.replace("\n", " ").split(",") if v.strip()]
        out.append((name, np.array(vals).reshape(8, 8)))
    return out


@pytest.mark.parametrize("core", cores.CORES)
def test_compiled_tables_are_the_integer_cores(core):
    tables = _header_tables()
    assert [name for name, _ in tables] == list(cores.CORES)
    assert re.search(r"constexpr int kCores = %d;" % len(cores.CORES), (_CSRC / "hp_block.cuh").read_text())
    compiled = dict(tables)[core]
    assert np.array_equal(compiled, TRANSFORMS[core].ts)
    assert np.array_equal(cores.source_tables()[core], compiled)
    assert set(np.unique(compiled)) <= {-2, -1, 0, 1, 2}
    core_id, packed = strip420.strip_args(core, 1.0)
    assert core_id == cores.CORES.index(core)
    assert packed.dtype == np.float32 and packed.shape == (137,)


def test_core_tables_are_defined_once():
    """csrc/ defines core_ts (and kCores) once, in hp_block.cuh, which the
    strip includes: B1/B3/B15 and B16/B20 compile the same tables."""
    defs = {p.name: len(re.findall(r"constexpr int core_ts\(", p.read_text())) for p in _CSRC.iterdir()
            if p.suffix in (".cu", ".cuh")}
    assert {name: n for name, n in defs.items() if n} == {"hp_block.cuh": 1}
    assert sum(len(re.findall(r"constexpr int kCores =", p.read_text())) for p in _CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")) == 1
    assert '#include "hp_block.cuh"' in (_CSRC / "strip420.cuh").read_text()
    assert cores.HEADER == _CSRC / "hp_block.cuh"


def test_every_integer_core_transform_has_an_instance():
    """Every transform with an integer core, aliases included, maps to the
    instance compiled for its Ts (cb2011 to rdct's); "dct" raises as the
    butterfly decode does."""
    for name, tr in TRANSFORMS.items():
        if tr.has_integer_core:
            assert cores.CORES[strip420.strip_args(name, 1.0)[0]] == name
    assert strip420.strip_args("cb2011", 1.0)[0] == cores.CORES.index("rdct")
    assert get_transform("cb2011").name == "rdct"
    with pytest.raises(ValueError, match="butterfly decode needs an integer core"):
        strip420.strip_args("dct", 1.0)


@pytest.mark.parametrize("transform", ["haweel", "wht"])
def test_packed_constants_are_the_decode_tables(transform):
    """StripConsts: the luma and chroma dequantization multipliers (the
    butterfly tier's s) and the 9 color constants, as the kernel reads them."""
    _, packed = strip420.strip_args(transform, 2.5, "luma", "chroma")
    for i, table in enumerate(("luma", "chroma")):
        s = hp._args(transform, table, 2.5, None, "butterfly", False).s
        assert np.array_equal(packed[64 * i:64 * (i + 1)], s.ravel())
    assert np.array_equal(packed[128:], ck._consts())
    assert not packed.flags.writeable


# ---------------------------------------------------------------------------
# The add-only inverse, emulated in numpy float32
# ---------------------------------------------------------------------------


def _add_only_inverse(c: np.ndarray, ts: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(n, 8, 8) int8 blocks -> A^T (c s) A + 128 in f32, A = ts, in
    hp_block.cuh's order: dequantize, then for each output the nonzero
    terms of the dense sum in k = 0..7 order (inv_core, add_term)."""

    def dot(vs, coeffs):
        acc = None
        for a, v in zip(coeffs, vs):
            if a == 0:
                continue
            t = v + v if abs(a) == 2 else v
            if acc is None:
                acc = -t if a < 0 else t
            else:
                acc = acc - t if a < 0 else acc + t
        return acc

    m = c.astype(F32) * s.astype(F32)
    u = np.empty_like(m)
    for i in range(8):
        for l in range(8):
            u[:, i, l] = dot([m[:, k, l] for k in range(8)], ts[:, i])
    out = np.empty_like(m)
    for i in range(8):
        for j in range(8):
            out[:, i, j] = dot([u[:, i, l] for l in range(8)], ts[:, j]) + F32(128.0)
    return out


def _blocks(seed: int) -> np.ndarray:
    """Random int8 blocks and extremes: all -128, all 127, one nonzero (127
    and -128) at each position, and a +-127 checkerboard and its negation."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(-128, 128, size=(96, 8, 8), dtype=np.int16)
    full = np.stack([np.full((8, 8), -128), np.full((8, 8), 127)])
    one = np.zeros((128, 8, 8), np.int16)
    for p in range(64):
        one[p].flat[p] = 127
        one[64 + p].flat[p] = -128
    board = np.where((np.arange(8)[:, None] + np.arange(8)[None, :]) % 2 == 0, 127, -127)
    return np.concatenate([rand, full, one, np.stack([board, -board])]).astype(np.int8)


@pytest.mark.parametrize("q_scale", [0.5, 1.0, 2.5])
@pytest.mark.parametrize("q_table", ["luma", "chroma"])
@pytest.mark.parametrize("core", cores.CORES)
def test_add_only_inverse_equals_the_dense_twin(core, q_table, q_scale):
    k = hp._args(core, q_table, q_scale, None, "butterfly", False)
    c = _blocks(seed=len(core) + int(10 * q_scale))
    mine = _add_only_inverse(c, cores.source_tables()[core], k.s)
    grid = torch.as_tensor(np.ascontiguousarray(c.transpose(1, 0, 2))[None])  # (1, 8, n, 8) block grid
    dense = hp._inv_plain(grid, k)[0].numpy().transpose(1, 0, 2)
    assert mine.dtype == dense.dtype == F32
    assert np.array_equal(mine.view(np.uint32), dense.view(np.uint32))
    # the clamps are reached: the decode saturates both ways on these inputs
    assert (dense < 0).any() and (dense > 255).any()


# ---------------------------------------------------------------------------
# Conversion-free forms
# ---------------------------------------------------------------------------


def _bits_f32(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(F32)


def test_byte_to_f32_bit_forms_over_all_bytes():
    """biased_byte: the float with 2^23's bits and the byte as its low
    mantissa is 2^23 + byte, so minus 2^23 (u8) or, after xor 0x80, minus
    2^23 + 128 (int8) is the byte's value, exactly."""
    b = np.arange(256, dtype=np.uint32)
    assert np.array_equal(_bits_f32(0x4B000000 | b) - F32(2**23), b.astype(F32))
    as_i8 = b.astype(np.uint8).view(np.int8).astype(F32)
    assert np.array_equal(_bits_f32(0x4B000000 | (b ^ 0x80)) - F32(2**23 + 128), as_i8)
    # __byte_perm(w, 0x4B000000, 0x7440 + e): byte e of w, then 0, 0, 0x4B
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    for e in range(4):
        perm = 0x4B000000 | ((w >> np.uint32(8 * e)) & np.uint32(0xFF))
        assert np.array_equal(_bits_f32(perm) - F32(2**23), ((w >> np.uint32(8 * e)) & 0xFF).astype(F32))


def test_f32_to_byte_bit_forms_over_all_bytes():
    """The floors: 2^23 + k and 1.5 * 2^23 + k have the bits 0x4B000000 + k
    and 0x4B400000 + k (k an integer in range), so the decode's
    clamp_floor and the merge's round read k from the low bits; and
    floor(clip(x, 0, 255)) is B3's clamp_trunc min(max(trunc(x), 0), 255)."""
    k = np.arange(256)
    assert np.array_equal((F32(2**23) + k.astype(F32)).view(np.uint32), 0x4B000000 + k)
    kk = np.arange(-512, 768)
    assert np.array_equal((F32(1.5 * 2**23) + kk.astype(F32)).view(np.uint32), 0x4B400000 + kk)
    assert np.array_equal((F32(2**23) + k.astype(F32)).view(np.uint32) & 0xFF, k)
    fracs = np.array([0.0, 1e-7, 0.25, 0.5, 0.75, 0.99999994], F32)
    x = (np.arange(-300, 600, dtype=F32)[:, None] + fracs[None, :]).ravel()
    x = np.concatenate([x, np.array([-3e38, -1e9, -1.0, -0.0, 1e9, 3e38], F32)])
    ref = np.minimum(np.maximum(np.trunc(x), F32(0)), F32(255))
    assert np.array_equal(np.floor(np.clip(x, F32(0), F32(255))), ref)


def test_merge_round_without_the_clip_over_all_triples():
    """round_u8_bits: clip(floor(fl(z + 0.5)), 0, 255) equals the merge's
    trunc(clip(z) + 0.5) for every r, g, b that B9's chain gives over all
    256^3 (y, cb, cr) triples (the products per chroma sample, as the strip
    computes them once for 2x2 pixels)."""
    kr, kg, kb = (F32(ck.F32[n]) for n in ("kr", "kg", "kb"))
    kr2, kb2 = F32(ck.F32["kr2"]), F32(ck.F32["kb2"])
    c = np.arange(256, dtype=F32) - F32(128)
    crc, cbc = np.meshgrid(c, c, indexing="ij")
    pr, pb = crc * kr2, cbc * kb2
    mismatches = 0
    for yv in range(256):
        y = F32(yv)
        rf, bf = y + pr, y + pb
        gf = ((y - rf * kr) - bf * kb) / kg
        for z in (rf, gf, bf):
            assert z.dtype == F32 and np.abs(z).max() < 2**22
            add_form = np.trunc(np.clip(z, F32(0), F32(255)) + F32(0.5))
            mine = np.clip(np.floor(z + F32(0.5)), F32(0), F32(255))
            mismatches += int((add_form != mine).sum())
    assert mismatches == 0


def test_strip_merge_equals_the_twins_merge():
    """The strip's merge (products once per chroma sample) gives the 4:2:0
    twin's values: merge_plain on a plane pair enumerating every (y, cb,
    cr), against the f32 chain written as strip420.cuh writes it."""
    rng = np.random.default_rng(9)
    y = rng.integers(0, 256, size=(64, 256), dtype=np.uint8)
    cb, cr = (rng.integers(0, 256, size=(32, 128), dtype=np.uint8) for _ in range(2))
    want = ck.merge_plain(*(torch.as_tensor(a) for a in (y, cb, cr)), "420").numpy()
    kr, kg, kb = (F32(ck.F32[n]) for n in ("kr", "kg", "kb"))
    up = lambda a: np.repeat(np.repeat(a.astype(F32) - F32(128), 2, 0), 2, 1)  # noqa: E731
    pr, pb = up(cr) * F32(ck.F32["kr2"]), up(cb) * F32(ck.F32["kb2"])
    yf = y.astype(F32)
    rf, bf = yf + pr, yf + pb
    gf = ((yf - rf * kr) - bf * kb) / kg
    mine = np.stack([np.clip(np.floor(z + F32(0.5)), 0, 255).astype(np.uint8) for z in (rf, gf, bf)])
    assert np.array_equal(mine, want)


# ---------------------------------------------------------------------------
# The wrappers and the one body
# ---------------------------------------------------------------------------


@pytest.fixture
def wrong_table(monkeypatch):
    """kernels.cores reading a header whose haweel table differs from
    haweel's Ts in one entry."""
    tables = {name: t.copy() for name, t in cores.source_tables().items()}
    tables["haweel"][3, 3] = 1
    monkeypatch.setattr(cores, "source_tables", lambda: tables)
    strip420.strip_args.cache_clear()
    hp._core_of.cache_clear()
    yield
    strip420.strip_args.cache_clear()
    hp._core_of.cache_clear()


def _b16(transform):
    y = torch.zeros((32, 256), dtype=torch.int8)
    rk.ring_forward_decode_color(y, torch.zeros((32, 128), dtype=torch.int8), None, None,
                                 torch.zeros((3, 32, 256), dtype=torch.uint8), transform=transform)


def _b20(transform):
    study.color_decode_420_u8(torch.zeros((64, 256), dtype=torch.int8),
                              *(torch.zeros((32, 128), dtype=torch.int8),) * 2, transform=transform)


@pytest.mark.parametrize("wrapper", [_b16, _b20], ids=["B16", "B20"])
def test_wrappers_raise_when_the_compiled_table_differs(wrapper, wrong_table):
    with pytest.raises(ValueError, match="no compiled inverse for 'haweel'"):
        wrapper("haweel")
    wrapper("wht")  # the other cores' tables still match
    wrapper("cb2011")


@pytest.mark.parametrize("source", ["ring.cu", "study.cu"])
def test_color_decode_kernels_share_one_strip_body(source):
    """B16 (ring.cu) and B20 (study.cu) run strip420.cuh's one body: each
    kernel is a template over the integer core that calls
    decode_merge_strip_420<kCore>, and neither the body nor B20's source
    keeps the compare-form round switch or a dense inverse of its own."""
    text = (_CSRC / source).read_text()
    body = (_CSRC / "strip420.cuh").read_text()
    assert '#include "strip420.cuh"' in text
    assert len(re.findall(r"decode_merge_strip_420<kCore>\(", text)) == 1
    assert len(re.findall(r"void decode_merge_strip_420\(", body)) == 1
    for t in (text, body):
        assert "kCompareRound" not in t and "merge_px<true>" not in t
        assert "inv_block(" not in t and "merge_px<" not in t
    assert len(re.findall(r"launch_strips\(kernels\[core\]", text)) == 1
    assert re.search(r"static const Kernel kernels\[kCores\] = \{", text)


def test_launchers_take_a_core_id():
    """The C launchers take the core id and one StripConsts pointer; the
    ctypes signatures say so."""
    sig = _build._SIGNATURES
    assert sig["ring_forward_decode_color_launch"][8] is _build._I  # core, after plane, h, w
    assert sig["color_decode_420_launch"][6] is _build._I  # core, after h, w
    for src, name in (("ring.cu", "ring_forward_decode_color_launch"), ("study.cu", "color_decode_420_launch")):
        decl = re.search(name + r"\(([^)]*)\)", (_CSRC / src).read_text()).group(1)
        assert "int core, const void* consts" in " ".join(decl.split())


# ---------------------------------------------------------------------------
# The B20 twin against the reference, every core, on int8 noise
# ---------------------------------------------------------------------------


def _load_fused_ab():
    spec = importlib.util.spec_from_file_location("_reference_color_fused_ab",
                                                  _ROOT / "benchmarks" / "color_fused_ab.py")
    mod = importlib.util.module_from_spec(spec)
    old = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.dont_write_bytecode = old
    return mod


@pytest.fixture(scope="module")
def fused_ab():
    return _load_fused_ab()


@pytest.mark.parametrize("core", cores.CORES)
def test_b20_twin_on_int8_noise_matches_reference(core, fused_ab):
    """Uniform int8 planes (not encoder output), so the decode's clamps are
    reached, through the B20 wrapper's twin and the reference's fused
    decode in interpret mode; and the twin equals the composed chain (the
    hp twin per plane, then the 4:2:0 merge twin)."""
    rng = np.random.default_rng(len(core))
    planes = [rng.integers(-128, 128, size=s, dtype=np.int8) for s in ((64, 256), (32, 128), (32, 128))]
    mine = study.color_decode_420_u8(*(torch.as_tensor(p) for p in planes), q_scale=2.5, transform=core).numpy()
    ref = np.asarray(fused_ab.color_decode_420_u8(*(jnp.asarray(p) for p in planes), q_scale=2.5,
                                                  transform=core, interpret=True))
    diff = np.abs(mine.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    yu = hp.decode_u8_plain(torch.as_tensor(planes[0]), 2.5, "luma", "butterfly", core)
    cu = hp.decode_u8_plain(torch.as_tensor(np.concatenate(planes[1:])), 2.5, "chroma", "butterfly", core)
    composed = ck.merge_plain(yu, cu[:32], cu[32:], "420").numpy()
    assert np.array_equal(mine, composed)
    assert (yu == 0).any() and (yu == 255).any()
