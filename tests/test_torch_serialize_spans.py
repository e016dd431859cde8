"""The container's dtype casts as spans of the port's registry: a map's bound
scan and int16 copy on its way into the bytes (``entropy.narrow``) and the
decoded map's float32 copy (``entropy.widen``), on the CPU.

One span of each per plane, whatever the stage; nothing with the registry
off; and the bytes and the parsed maps are the same with it on and off, and
the reference's.  A 2056x2048 map is 4,210,688 coefficients, just above
``_AUTO_EXACT_MAX``: ``auto`` runs the sampled estimate there.
"""

import numpy as np
import pytest

import tpudct.utils.serialize as RS
from tpudct_torch.utils import profiling
from tpudct_torch.utils import serialize as S

P = profiling.PREFIX
CASTS = (P + "entropy.narrow", P + "entropy.widen")
SHAPE = (2056, 2048)


@pytest.fixture
def registry():
    """The registry on and empty; off and empty afterwards."""
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


def _coeffs(shape, seed: int, scale: float = 3.0) -> np.ndarray:
    """A coefficient-like int8 map, as the u8 kernels give it: Laplacian AC
    shrinking along the anti-diagonals, DC a smooth field."""
    rng = np.random.default_rng(seed)
    h, w = shape
    u = np.arange(h)[:, None] % 8
    v = np.arange(w)[None, :] % 8
    c = np.round(rng.laplace(0.0, scale, shape) / (1.0 + 0.6 * (u + v)))
    by, bx = np.mgrid[0 : h // 8, 0 : w // 8]
    c[::8, ::8] = np.round(60 * np.sin(by / 3.0) * np.cos(bx / 5.0))
    return np.clip(c, -127, 127).astype(np.int8)


def _gray_round_trip(c, codec):
    data = S.coefficients_to_bytes(c, orig_shape=(SHAPE[0] - 3, SHAPE[1]), codec=codec)
    return data, S.bytes_to_coefficients(data, with_orig_shape=True)


def _color_round_trip():
    planes = {"y": _coeffs((56, 72), 1), "cb": _coeffs((32, 40), 2, 1.5), "cr": _coeffs((32, 40), 3, 1.5)}
    meta = {"orig_shape": (50, 70), "chroma_shape": (25, 35), "subsample": "420"}
    data = S.color_to_bytes(planes, meta, 1.0, None, "haweel", codec="auto")
    return planes, meta, data, S.bytes_to_color(data)


@pytest.mark.parametrize("codec", ["auto", "rans"])
def test_a_gray_round_trip_records_one_narrow_and_one_widen(registry, codec):
    _gray_round_trip(_coeffs(SHAPE, 7), codec)
    spans = registry.snapshot()["spans"]
    assert [spans[k]["count"] for k in CASTS] == [1, 1]
    assert all(spans[k]["total_s"] == spans[k]["self_s"] > 0 for k in CASTS)


def test_a_color_container_records_one_of_each_per_plane(registry):
    _color_round_trip()
    spans = registry.snapshot()["spans"]
    assert [spans[k]["count"] for k in CASTS] == [3, 3]


def test_off_records_nothing():
    profiling.disable()
    profiling.reset()
    _gray_round_trip(_coeffs(SHAPE, 7), "auto")
    _color_round_trip()
    assert profiling.snapshot() == {"spans": {}, "counters": {}, "records": []}


def test_bytes_and_maps_are_the_same_on_and_off_and_the_reference_s():
    c = _coeffs(SHAPE, 11)
    assert c.size > S._AUTO_EXACT_MAX
    profiling.disable()
    profiling.reset()
    off = _gray_round_trip(c, "auto"), _color_round_trip()
    profiling.enable()
    try:
        on = _gray_round_trip(c, "auto"), _color_round_trip()
    finally:
        profiling.disable()
        profiling.reset()
    (data, parsed), (planes, meta, cdata, (cplanes, cmeta)) = on
    assert data == off[0][0] == RS.coefficients_to_bytes(c, orig_shape=(SHAPE[0] - 3, SHAPE[1]), codec="auto")
    assert parsed[0].dtype == off[0][1][0].dtype == np.float32
    np.testing.assert_array_equal(parsed[0], off[0][1][0])
    np.testing.assert_array_equal(parsed[0], c)
    assert parsed[1:] == off[0][1][1:] == (1.0, None, (SHAPE[0] - 3, SHAPE[1]))
    assert cdata == off[1][2] == RS.color_to_bytes(planes, meta, 1.0, None, "haweel", codec="auto")
    for k in ("y", "cb", "cr"):
        assert cplanes[k].dtype == off[1][3][0][k].dtype == np.float32
        np.testing.assert_array_equal(cplanes[k], off[1][3][0][k])
        np.testing.assert_array_equal(cplanes[k], planes[k])
    assert cmeta == off[1][3][1]
