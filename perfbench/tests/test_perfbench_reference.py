"""The plain reference: its frozen tables, and its results against direct
per-block and per-pixel formulas written out here."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import codec as ref


def _t() -> np.ndarray:
    ts = np.array(ref.TS, np.float64)
    return ts / np.sqrt((ts * ts).sum(axis=1))[:, None]


def test_frozen_t_is_orthogonal():
    t = _t()
    np.testing.assert_allclose(t @ t.T, np.eye(8), atol=1e-15)
    ts = np.array(ref.TS)
    gram = ts @ ts.T
    assert (gram == np.diag(np.diag(gram))).all()  # the integer core's rows are orthogonal
    assert set(np.unique(ts)) <= {-2, -1, 0, 1, 2}


def test_frozen_tables():
    assert ref.TABLES["luma"][0][:4] == (16, 11, 10, 16)
    assert ref.TABLES["chroma"][3][:3] == (47, 66, 99)
    assert (ref.KR, ref.KG, ref.KB) == (0.299, 0.587, 0.114)


def _direct_roundtrip(x: np.ndarray, q: np.ndarray):
    """Block by block: C = round_half_away(T (X - 128) T^T / Q), then
    trunc(T^T (C Q) T + 128) clipped."""
    t = _t()
    h, w = x.shape
    c = np.zeros((h, w))
    r = np.zeros((h, w), np.uint8)
    for i in range(0, h, 8):
        for j in range(0, w, 8):
            y = t @ (x[i:i + 8, j:j + 8] - 128.0) @ t.T / q
            cb = np.sign(y) * np.floor(np.abs(y) + 0.5)
            c[i:i + 8, j:j + 8] = cb
            v = t.T @ (cb * q) @ t + 128.0
            r[i:i + 8, j:j + 8] = np.clip(np.trunc(v), 0, 255)
    return c, r


@pytest.mark.parametrize("table", ["luma", "chroma"])
def test_gray_reference_agrees_with_the_direct_formula(table):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    q = np.array(ref.TABLES[table], np.float64)
    c, r = _direct_roundtrip(x.astype(np.float64), q)
    rc = ref.encode_plane(torch.from_numpy(x), table, 1.0).numpy()
    rr = ref.decode_plane(torch.from_numpy(rc), table, 1.0).numpy()
    # the direct form rounds T's irrational entries, so an exact tie may
    # fall either side there: the two agree but for a handful of ties
    assert (rc != c).mean() < 0.003 and np.abs(rc - c).max() <= 1
    rr_of_c = ref.decode_plane(torch.from_numpy(c), table, 1.0).numpy()
    assert (rr_of_c.astype(int) - r).__abs__().max() <= 1 and (rr_of_c != r).mean() < 0.01
    assert rr.shape == x.shape


def test_exact_ties_round_half_away():
    # a flat block of X - 128 = v: TS X TS^T has 64 v at DC, over 8 * 16, so DC = v / 2
    for v, dc in ((12, 6), (1, 1), (3, 2), (-1, -1), (-3, -2)):
        c = ref.encode_plane(torch.full((8, 8), 128 + v, dtype=torch.uint8), "luma", 1.0)
        assert c[0, 0] == dc and (c.flatten()[1:] == 0).all()


def test_edge_padding_repeats_the_last_row_and_column():
    x = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    p = ref._edge_pad(x, 8, 8)
    assert p.shape == (8, 8) and (p[3:, :4] == x[-1]).all() and (p[:, 4:] == p[:, 3:4]).all()
    assert ref.encode_plane(x, "luma", 1.0).shape == (8, 8)


def test_color_split_and_merge_follow_t871_per_pixel():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (6, 10, 3)).astype(np.float64)
    y, cb, cr = ref.split_420(torch.from_numpy(rgb.astype(np.uint8)))
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    assert (y.numpy() == np.floor(0.299 * r + 0.587 * g + 0.114 * b + 0.5)).all()
    m = rgb.reshape(3, 2, 5, 2, 3).mean(axis=(1, 3))
    ym = 0.299 * m[..., 0] + 0.587 * m[..., 1] + 0.114 * m[..., 2]
    want_cb = np.floor(np.clip(128 + (m[..., 2] - ym) / 1.772, 0, 255) + 0.5)
    want_cr = np.floor(np.clip(128 + (m[..., 0] - ym) / 1.402, 0, 255) + 0.5)
    assert (cb.numpy() == want_cb).all() and (cr.numpy() == want_cr).all()
    out = ref.merge_420(y, cb, cr).numpy().astype(np.float64)
    yy = y.numpy().astype(np.float64)
    up = lambda c: np.repeat(np.repeat(c.numpy().astype(np.float64), 2, 0), 2, 1) - 128
    rr = yy + 1.402 * up(cr)
    bb = yy + 1.772 * up(cb)
    gg = (yy - 0.299 * rr - 0.114 * bb) / 0.587
    want = np.stack([np.floor(np.clip(v, 0, 255) + 0.5) for v in (rr, gg, bb)], -1)
    assert (out == want).all()


def test_color_roundtrip_shapes_and_odd_sizes():
    rgb = torch.randint(0, 256, (21, 35, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    planes = ref.encode_color_420(rgb, 1.0)
    assert planes["y"].shape == (24, 40) and planes["cb"].shape == (16, 24)
    assert ref.decode_color_420(planes, (21, 35), 1.0).shape == (21, 35, 3)


def test_lower_precision_differs():
    x = torch.randint(0, 256, (64, 64), dtype=torch.uint8, generator=torch.Generator().manual_seed(2))
    c64 = ref.encode_plane(x, "luma", 1.0)
    c16 = ref.encode_plane(x, "luma", 1.0, torch.bfloat16).to(torch.float64)
    r64 = ref.decode_plane(c64, "luma", 1.0)
    r16 = ref.decode_plane(c64, "luma", 1.0, torch.bfloat16)
    assert (r64 != r16).float().mean() > 0.1
    assert not math.isclose(float((c64 != c16).float().mean()), 0.0)
