"""The add-only block chains of B1 (k_rt_u8<core>) and B3 (k_decode_u8<core>,
which B15 runs with a forward pointer), tpudct_torch/csrc/hp_block.cuh, on
the CPU (B7 and B22 on the same chain: tests/test_torch_scaled_split3_addonly.py).

The CUDA kernels cannot run here, so these tests emulate them in numpy
float32, step for step as the kernels write them, and hold the emulation
against the unchanged twins (kernels.hp: roundtrip_u8_plain,
decode_u8_plain) and, at one shape, the reference's Pallas kernels in
interpret mode:
- the level shift and the int8 unpack: bytes -> f32 by bit patterns
  (biased_byte), over all 256 bytes of each signedness;
- B1's forward Ts X Ts^T: even/odd butterflies, then each output's
  nonzero terms (the +-1 terms first, each +-2 term as one FMA), exact;
- the quantizer: fl(core * scale), fl(+ copysign(0.5)), the truncation by
  a round-down add of 2^23 to the magnitude, the sign by copysign, the
  int8 byte as the low byte of 1.5 * 2^23 + c; proved on every f32 within
  4 ulps of each k + 0.5 (the rounding boundaries) and of each integer;
- the decode: dequantize, the inverse's nonzero terms in the dense k = 0..7
  order (inv_core), then the floor and clamp by min/max and a round-down
  add of 2^23 (floor_2p23), the bytes packed from its low bits;
- the wrappers (B1, B3/B15, B7, and B22's idct_x "c") pass the compiled
  core's id, or check it, and raise where the compiled table is not the
  transform's Ts; the "highest"/"high" tiers take the dense instance.
The card runs the kernels against their twins (chip_smoke.py phase 4).

Tolerances: bit-identical everywhere, except the 64x256 case against the
reference's interpreted kernels, whose butterfly reconstruction sums its
bf16 splits on the MXU (tests/test_torch_hp.py): +-1 on at most 1e-4 of
pixels (the coefficients bit-identical).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudct.kernels import hp_pallas as R
from tpudct_torch.constants import get_transform
from tpudct_torch.kernels import _build
from tpudct_torch.kernels import cores
from tpudct_torch.kernels import hp
from tpudct_torch.kernels import ring as rk
from tpudct_torch.kernels import variants as V

F32 = np.float32
TWO23 = 2.0**23
_CSRC = _build.SOURCES[0].parent
_TRANSFORMS = cores.CORES + ("cb2011",)

# ---------------------------------------------------------------------------
# The kernels' scalar forms, in numpy
# ---------------------------------------------------------------------------


def _biased_byte(b) -> np.ndarray:
    """biased_byte: the float whose bits are 0x4B000000 and the byte, 2^23 + b."""
    return (np.uint32(0x4B000000) | np.asarray(b, np.uint32)).view(F32)


def _minus_128(b) -> np.ndarray:
    """bytes_minus_128: biased_byte - (2^23 + 128), one rounded f32 subtract."""
    return _biased_byte(b) - F32(TWO23 + 128)


def _add_rd_2p23(v: np.ndarray) -> np.ndarray:
    """__fadd_rd(v, 2^23) for f32 v in [0, 2^23): the sum in f64 (exact or
    short of the next integer), rounded down to the f32 grid of
    [2^23, 2^24), whose ulp is 1."""
    return np.floor(v.astype(np.float64) + TWO23).astype(F32)


def _quantize(core: np.ndarray, fq: np.ndarray) -> np.ndarray:
    """hp_block.cuh's quantize: trunc(fl(fl(core fq) + copysign(0.5))) as
    fabs, a round-down add of 2^23, - 2^23, copysign."""
    z = (core * fq).astype(F32)
    y = (z + np.copysign(F32(0.5), z)).astype(F32)
    return np.copysign(_add_rd_2p23(np.abs(y)) - F32(TWO23), y).astype(F32)


def _i8_bits(c: np.ndarray) -> np.ndarray:
    """i8_bits' low byte: 1.5 * 2^23 + c, its bits' low byte, as int8."""
    return ((c + F32(1.5 * TWO23)).astype(F32).view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def _floor_u8(x: np.ndarray) -> np.ndarray:
    """store_u8_floor's byte: the low byte of floor_2p23(x) =
    __fadd_rd(min(max(x, 0), 255), 2^23)."""
    bits = _add_rd_2p23(np.minimum(np.maximum(x, F32(0)), F32(255))).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8)


# ---------------------------------------------------------------------------
# The block chains, on (n, 8, 8) float32 blocks
# ---------------------------------------------------------------------------


def _core_dot(t, v, n):
    """core_dot: the nonzero terms of sum_k t[k] v[k], k < n, the +-1 terms
    first, then each +-2 term as one FMA (exact here: integers)."""
    acc = None
    for mag in (1, 2):
        for k in range(n):
            if abs(int(t[k])) != mag:
                continue
            term = F32(t[k]) * v[k]
            acc = term if acc is None else (acc + term).astype(F32)
    return acc


def _fwd8(v, ts):
    """fwd8 on a list of 8 arrays: mirrored sums and differences, then those
    of the even half, then each row's nonzero terms."""
    s = [v[k] + v[7 - k] for k in range(4)]
    d = [v[k] - v[7 - k] for k in range(4)]
    e, o = [s[0] + s[3], s[1] + s[2]], [s[0] - s[3], s[1] - s[2]]
    return [_core_dot(ts[r], (e if r % 4 == 0 else o) if r % 2 == 0 else d, 2 if r % 2 == 0 else 4)
            for r in range(8)]


def _fwd_core(x: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """fwd_core: fwd8 down each column, then along each row."""
    x = x.copy()
    for c in range(8):
        for r, val in enumerate(_fwd8([x[:, k, c] for k in range(8)], ts)):
            x[:, r, c] = val
    for i in range(8):
        for r, val in enumerate(_fwd8([x[:, i, k] for k in range(8)], ts)):
            x[:, i, r] = val
    return x


def _inv_dot(vs, coeffs):
    """inv_dot: sum over k of coeffs[k] vs[k] (coeffs in {0, +-1, +-2}),
    only the nonzero terms, in the dense k = 0..7 order (add_term: +-2 as
    v + v, the first term negated where its entry is negative)."""
    acc = None
    for a, v in zip(coeffs, vs):
        if a == 0:
            continue
        t = v + v if abs(a) == 2 else v
        acc = (-t if a < 0 else t) if acc is None else (acc - t if a < 0 else acc + t)
    return acc


def _inv_core(m: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """inv_core: A^T M A + 128 (A = ts), each output summing only its
    nonzero terms in the dense k = 0..7 order (inv_dot)."""
    u = np.empty_like(m)
    for i in range(8):
        for l in range(8):
            u[:, i, l] = _inv_dot([m[:, k, l] for k in range(8)], ts[:, i])
    out = np.empty_like(m)
    for i in range(8):
        for j in range(8):
            out[:, i, j] = _inv_dot([u[:, i, l] for l in range(8)], ts[:, j]) + F32(128)
    return out


def _to_blocks(img: np.ndarray) -> np.ndarray:
    h, w = img.shape
    return img.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _from_blocks(b: np.ndarray, h: int, w: int) -> np.ndarray:
    return b.reshape(h // 8, w // 8, 8, 8).transpose(0, 2, 1, 3).reshape(h, w)


def _dense_inverse(c: np.ndarray, k) -> np.ndarray:
    """inv_block (the dense instance), through the twin's own sums."""
    grid = torch.as_tensor(np.ascontiguousarray(c.transpose(1, 0, 2))[None])  # (1, 8, n, 8) block grid
    return hp._inv_plain(grid, k)[0].numpy().transpose(1, 0, 2)


def _decode_half(c: np.ndarray, k, tier: str, ts: np.ndarray) -> np.ndarray:
    """dequant_inverse then store_u8_floor's bytes."""
    if tier == "butterfly":
        x = _inv_core((c * k.s).astype(F32), ts)
    else:
        x = _dense_inverse(c, k)
    return _floor_u8(x)


def emulate_rt_u8(img: np.ndarray, transform, q_table, q_scale, retain_k, tier):
    """k_rt_u8<core, inv>: (int8 coefficients, u8 reconstruction)."""
    h, w = img.shape
    ts = cores.source_tables()[get_transform(transform).name]
    k = hp._args(transform, q_table, q_scale, retain_k, tier, True)
    x = _minus_128(_to_blocks(img))
    core = _fwd_core(x, ts)
    exact = np.einsum("ik,nkl,jl->nij", ts, _to_blocks(img).astype(np.int64) - 128, ts)
    assert np.array_equal(core, exact)  # the forward is exact integer arithmetic
    c = _quantize(core, k.fq)
    return _from_blocks(_i8_bits(c), h, w), _from_blocks(_decode_half(c, k, tier, ts), h, w)


def emulate_decode_u8(coef: np.ndarray, transform, q_table, q_scale, tier):
    """k_decode_u8<core> (or <kDense>): the u8 reconstruction."""
    h, w = coef.shape
    k = hp._args(transform, q_table, q_scale, None, tier, False)
    ts = cores.source_tables().get(get_transform(transform).name)
    c = _minus_128(_to_blocks(coef.view(np.uint8)) ^ np.uint8(0x80))
    return _from_blocks(_decode_half(c, k, tier, ts), h, w)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _u8_image(seed: int, h: int = 64, w: int = 128) -> np.ndarray:
    """u8 noise with all-0, all-255 and +-checkerboard (0/255) blocks."""
    img = np.random.default_rng(seed).integers(0, 256, size=(h, w), dtype=np.uint8)
    board = ((np.arange(8)[:, None] + np.arange(8)[None, :]) % 2 * 255).astype(np.uint8)
    for j, block in enumerate((np.zeros((8, 8), np.uint8), np.full((8, 8), 255, np.uint8), board, 255 - board)):
        img[:8, 8 * j:8 * j + 8] = block
    return img


def _i8_map(seed: int, h: int = 64, w: int = 128) -> np.ndarray:
    """Uniform int8 noise (-128 included), an all -128 and an all 127 block
    and a +-127 checkerboard: the decode saturates both ways."""
    m = np.random.default_rng(seed).integers(-128, 128, size=(h, w), dtype=np.int8)
    board = np.where((np.arange(8)[:, None] + np.arange(8)[None, :]) % 2 == 0, 127, -127).astype(np.int8)
    m[:8, :8], m[:8, 8:16], m[:8, 16:24], m[:8, 24:32] = -128, 127, board, -board
    return m


# ---------------------------------------------------------------------------
# The chains against the twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("retain_k", [None, 6])
@pytest.mark.parametrize("q_scale", [1.0, 2.5])
@pytest.mark.parametrize("q_table", ["luma", "chroma"])
@pytest.mark.parametrize("transform", _TRANSFORMS)
def test_rt_u8_chain_equals_the_twin(transform, q_table, q_scale, retain_k):
    img = _u8_image(seed=len(transform) + int(4 * q_scale) + (retain_k or 0))
    for tier in ("butterfly", "highest"):
        c, r = emulate_rt_u8(img, transform, q_table, q_scale, retain_k, tier)
        pc, pr = hp.roundtrip_u8_plain(torch.as_tensor(img), q_scale, q_table, retain_k, tier, transform)
        assert np.array_equal(c, pc.numpy()), tier
        assert np.array_equal(r, pr.numpy()), tier
    # B2 (B1's encode half) codes the same coefficients
    assert np.array_equal(c, hp.encode_u8_plain(torch.as_tensor(img), q_scale, q_table, retain_k, transform).numpy())


@pytest.mark.parametrize("q_scale", [1.0, 2.5])
@pytest.mark.parametrize("q_table", ["luma", "chroma"])
@pytest.mark.parametrize("transform", _TRANSFORMS)
def test_decode_u8_chain_equals_the_twin(transform, q_table, q_scale):
    coef = _i8_map(seed=len(transform) + int(4 * q_scale))
    for tier in ("butterfly", "highest"):
        mine = emulate_decode_u8(coef, transform, q_table, q_scale, tier)
        want = hp.decode_u8_plain(torch.as_tensor(coef), q_scale, q_table, tier, transform).numpy()
        assert np.array_equal(mine, want), tier
        assert (want == 0).any() and (want == 255).any()  # both clamps reached


def test_dense_instance_serves_a_transform_without_a_core():
    """B3's dense instance decodes "dct" (no integer core) on the highest
    tier through the same byte forms."""
    coef = _i8_map(seed=3)
    for q_scale in (1.0, 2.5):
        mine = emulate_decode_u8(coef, "dct", "luma", q_scale, "highest")
        assert np.array_equal(mine, hp.decode_u8_plain(torch.as_tensor(coef), q_scale, "luma", "highest",
                                                       "dct").numpy())


# ---------------------------------------------------------------------------
# Exhaustive scalar proofs
# ---------------------------------------------------------------------------


def test_bytes_to_f32_over_all_bytes():
    """The level shift (u8: byte - 128) and the int8 unpack (byte ^ 0x80,
    then - 128) are exact for all 256 bytes."""
    b = np.arange(256, dtype=np.uint32)
    assert np.array_equal(_minus_128(b), (b.astype(np.int64) - 128).astype(F32))
    assert np.array_equal(_minus_128(b ^ 0x80), b.astype(np.uint8).view(np.int8).astype(F32))


def _near(centres: np.ndarray, ulps: int = 4) -> np.ndarray:
    """Every f32 within `ulps` ulps of each centre."""
    out = [centres.astype(F32)]
    for direction in (np.inf, -np.inf):
        v = centres.astype(F32)
        for _ in range(ulps):
            v = np.nextafter(v, F32(direction))
            out.append(v)
    return np.concatenate(out)


def test_quantizer_bit_path_near_every_boundary():
    """quantize and i8_bits against the twin's round half away
    (_round_away: trunc(fl(z + copysign(0.5, z)))) and the int8 wrap, on
    every f32 within 4 ulps of each k + 0.5 (the rounding boundaries) and of
    each integer k (the truncation's), k in -128..127, and on +-0."""
    k = np.arange(-128, 128, dtype=np.float64)
    z = np.concatenate([_near(k + 0.5), _near(k), np.array([0.0, -0.0, 1e-30, -1e-30], F32)])
    mine = _quantize(z, F32(1.0))
    want = hp._round_away(torch.as_tensor(z)).numpy()
    assert np.array_equal(mine, want)
    assert np.array_equal(_i8_bits(mine), want.astype(np.int64).astype(np.int8))
    # the truncation alone on values near the integers
    y = _near(k)
    trunc = np.copysign(_add_rd_2p23(np.abs(y)) - F32(TWO23), y)
    assert np.array_equal(trunc, np.trunc(y))
    # the wrap past int8, as the old store's F2I & 0xff: |c| < 2^22
    c = np.array([128, 200, 255, 256, 1000, -129, -256, -1000, 2**22 - 1, -(2**22 - 1)], F32)
    assert np.array_equal(_i8_bits(c), c.astype(np.int64).astype(np.int8))


def test_floor_clamp_over_a_range():
    """store_u8_floor's byte is clamp_trunc's value, min(max(trunc(x), 0),
    255), on and between the integers and at the extremes."""
    fracs = np.array([0.0, 1e-7, 0.25, 0.5, 0.75, 0.99999994], F32)
    x = (np.arange(-300, 600, dtype=F32)[:, None] + fracs[None, :]).ravel()
    x = np.concatenate([x, _near(np.arange(-2.0, 258.0)), np.array([-3e38, -1e9, -0.0, 1e9, 3e38], F32)])
    want = np.minimum(np.maximum(np.trunc(x), F32(0)), F32(255)).astype(np.uint8)
    assert np.array_equal(_floor_u8(x), want)


# ---------------------------------------------------------------------------
# The wrappers, the C interface, the sources
# ---------------------------------------------------------------------------


def test_wrappers_pass_the_compiled_core():
    """B1 takes its forward's core on every tier; the inverse of B1 and
    B3/B15 is the core on the butterfly tier, DENSE on the others (also for
    a transform without an integer core)."""
    for name in _TRANSFORMS:
        cid = cores.CORES.index(get_transform(name).name)
        for tier in ("butterfly", "highest", "high"):
            inv = cid if tier == "butterfly" else cores.DENSE
            assert hp._core_of(name, "luma", 1.0, None, tier, True) == (cid, inv)
            assert hp._core_of(name, "chroma", 2.5, None, tier, False) == (None, inv)
    assert hp._core_of("dct", "luma", 1.0, None, "highest", False) == (None, cores.DENSE)
    with pytest.raises(ValueError, match="butterfly decode needs an integer core"):
        hp._core_of("dct", "luma", 1.0, None, "butterfly", False)


@pytest.fixture
def wrong_table(monkeypatch):
    """kernels.cores reading a header whose haweel table differs from
    haweel's Ts in one entry."""
    tables = {name: t.copy() for name, t in cores.source_tables().items()}
    tables["haweel"][1, 0] = 0
    monkeypatch.setattr(cores, "source_tables", lambda: tables)
    hp._core_of.cache_clear()
    yield
    hp._core_of.cache_clear()


def test_wrappers_raise_when_the_compiled_table_differs(wrong_table):
    img = torch.as_tensor(_u8_image(seed=1))
    coef = torch.as_tensor(_i8_map(seed=1))
    rec = torch.empty(coef.shape, dtype=torch.uint8)
    calls = [lambda: hp.hp_roundtrip_u8(img), lambda: hp.hp_roundtrip_u8(img, decode_precision="highest"),
             lambda: hp.hp_decode_u8(coef), lambda: rk.ring_forward_decode(coef, None, rec),
             lambda: hp.hp_scaled_decode_u8(coef, 2, 2), lambda: hp.hp_scaled_decode_u8(coef, 8, 1, out_u8=True),
             lambda: V.idct_x(coef.to(torch.float32), "c")]
    for call in calls:
        with pytest.raises(ValueError, match="no compiled inverse for 'haweel'"):
            call()
    hp.hp_decode_u8(coef, decode_precision="highest")  # the dense instance reads no compiled table
    hp.hp_roundtrip_u8(img, transform="wht")  # the other cores' tables still match
    hp.hp_scaled_decode_u8(coef, 2, 2, transform="rdct")
    V.idct_x(coef.to(torch.float32), "b")  # B6's dense kernel reads its table


def test_launchers_take_a_core():
    """The C launchers of B1, B3 and B7 take the inverse's id in one form (a
    core or kDense for B1 and B3, a core for B7, which runs the butterfly
    tier only; B1 also its forward's core), and every instance the
    launchers name is compiled from the add-only chain."""
    sig = _build._SIGNATURES
    assert sig["hp_rt_u8_launch"][5:7] == (_build._I, _build._I)  # core, inv after h, w
    assert sig["hp_decode_u8_launch"][5] is _build._I  # core after fwd
    assert sig["hp_scaled_decode_u8_launch"][4:8] == (_build._I,) * 4  # fr, fc, out_u8, core
    src = (_CSRC / "hp_codec.cu").read_text()
    inverse = (_CSRC / "hp_inverse.cu").read_text()
    for text, name, params in ((src, "hp_rt_u8_launch", "int core, int inv"),
                               (src, "hp_decode_u8_launch", "void* fwd, int core"),
                               (inverse, "hp_scaled_decode_u8_launch", "int out_u8, int core")):
        decl = " ".join(re.search(name + r"\(([^)]*)\)", text).group(1).split())
        assert params in decl
    instances = re.findall(r"k_rt_u8<([0-3]), ([0-3]|kDense)>", src)
    assert len(instances) == 2 * 4 + 1  # + the decltype
    assert all(inv in (core, "kDense") for core, inv in instances)
    assert len(re.findall(r"k_decode_u8<(?:kDense|[0-3])>", src)) == 1 + 4 + 1
    assert len(re.findall(r"k_scaled_decode_u8<[0-3]>", inverse)) == 4 + 1
    assert "k_scaled_decode_u8" not in src and "k_idct_split3" not in src  # both live in hp_inverse.cu


# The functions of hp_block.cuh that B1's and B3's add-only instances run.
_CHAIN = ("biased_byte", "bytes_minus_128", "load_u8_level", "floor_2p23", "pack4", "store_u8_floor",
          "quantize", "i8_bits", "quantize_store_i8", "load_forward_i8", "core_dot", "fwd8", "fwd_core",
          "add_term", "inv_core", "dequant_inverse")


def _function_body(text: str, name: str) -> str:
    start = re.search(r"\b" + name + r"\([^;{]*\)\s*\{", text)
    assert start, name
    depth, i = 0, start.end() - 1
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError(name)


def test_the_chain_has_no_conversion_in_its_source():
    """No function of the chain converts between int and float (no casts,
    truncf or __float2int), and the kernels run the chain, not the dense
    forward or the converting row helpers (the card's SASS counts:
    chip_smoke.py phase 2): B1 and B2 through one encode function
    (encode_block_u8), B1, B3 and B7 through dequant_inverse; B7 reads its
    rows as B3 does and sums its windows' floor_2p23 bit patterns; B7's old
    converting row helpers are gone."""
    text = (_CSRC / "hp_block.cuh").read_text()
    src = (_CSRC / "hp_codec.cu").read_text()
    inverse = (_CSRC / "hp_inverse.cu").read_text()
    bodies = {name: _function_body(text, name) for name in _CHAIN}
    bodies["encode_block_u8"] = _function_body(src, "encode_block_u8")
    for name in ("window_sum", "store_bytes", "store_windows"):  # B7's integer window sums and stores
        bodies[name] = _function_body(inverse, name)
    for name, body in bodies.items():
        for banned in ("truncf", "__float2int", "static_cast<int", "(int)", "round_away(", "roundf", "rintf"):
            assert banned not in body, (name, banned)
        assert "static_cast<float>" not in body or name == "core_dot", name
    assert "static_cast<float>(t)" in _function_body(text, "core_dot")  # a compile-time table constant
    kernels = {k: _function_body(src, k) for k in ("k_rt_u8", "k_encode_u8", "k_decode_u8", "encode_block_u8")}
    kernels["k_scaled_decode_u8"] = _function_body(inverse, "k_scaled_decode_u8")
    for kernel, body in kernels.items():
        for banned in ("fwd_block", "inv_block", "load_u8_shifted", "store_i8", "store_u8", "load_i8",
                       "clamp_trunc", "store_row_u8", "to_u8", "unpack_i8"):
            assert not re.search(r"\b" + banned + r"\(", body), (kernel, banned)
    for gone in ("load_i8", "unpack_i8", "clamp_trunc", "to_u8", "store_row_u8"):  # B7's old converting rows
        assert not re.search(r"\b" + gone + r"\(", text + src + inverse), gone
    assert "dequant_inverse<kCore>" in _function_body(src, "k_decode_u8")
    scaled = kernels["k_scaled_decode_u8"]
    assert "load_forward_i8(coef, nullptr" in scaled and "dequant_inverse<kCore>" in scaled
    assert "floor_2p23(" in scaled and "store_windows<FR, FC>" in scaled
    for kernel in ("k_rt_u8", "k_encode_u8"):
        assert "encode_block_u8<kCore>" in _function_body(src, kernel)
    assert "fwd_core<kCore>" in bodies["encode_block_u8"]


# ---------------------------------------------------------------------------
# One case against the reference
# ---------------------------------------------------------------------------


def test_chains_match_the_reference_at_64x256():
    """The emulated B1 and B3 chains against tpudct's hp_roundtrip_u8 and
    hp_decode_u8 (Pallas, interpret mode): coefficients bit-identical,
    reconstructions +-1 on at most 1e-4 of pixels (the reference's bf16
    split sums; tests/test_torch_hp.py)."""
    img = _u8_image(seed=64, h=64, w=256)
    c, r = emulate_rt_u8(img, "haweel", "luma", 1.0, None, "butterfly")
    c_ref, r_ref = R.hp_roundtrip_u8(jnp.asarray(img), interpret=True)
    assert np.array_equal(c, np.asarray(c_ref))
    d = np.abs(r.astype(np.int64) - np.asarray(r_ref, np.int64))
    assert d.max() <= 1 and (d > 0).sum() <= 1e-4 * d.size
    rd = emulate_decode_u8(c, "haweel", "luma", 1.0, "butterfly")
    assert np.array_equal(rd, r)
    d = np.abs(rd.astype(np.int64) - np.asarray(R.hp_decode_u8(jnp.asarray(c), interpret=True), np.int64))
    assert d.max() <= 1 and (d > 0).sum() <= 1e-4 * d.size
