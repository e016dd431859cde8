"""Transform and quantization constants (numpy only).

A copy of ``tpudct/constants.py`` that imports nothing of the JAX package,
so the port loads on a machine without JAX.  ``tests/test_torch_constants.py``
proves every table, core and derived row norm here equal to the
reference's bit for bit.

T factors as ``T = D @ Ts`` where ``Ts`` is an integer matrix with entries
in {0, +-1, +-2} and ``D`` is the diagonal of reciprocal row norms; the
CUDA kernels run the forward contraction on ``Ts`` exactly and fold ``D``
into one f32 scale per coefficient position.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

BLOCK_SIZE = 8

# Signed integer core of the Haweel approximate DCT.  Row r of T equals
# HAWEEL_TS[r] / ||HAWEEL_TS[r]||_2.
HAWEEL_TS = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, 1, 0, 0, 0, 0, -1, -1],
        [2, 1, -1, -2, -2, -1, 1, 2],
        [0, 0, -1, 0, 0, 1, 0, 0],
        [1, -1, -1, 1, 1, -1, -1, 1],
        [1, -1, 0, 0, 0, 0, 1, -1],
        [1, -2, 2, -1, -1, 2, -2, 1],
        [0, 0, 0, -1, 1, 0, 0, 0],
    ],
    dtype=np.int8,
)

# The float literals of the original CUDA codec's T matrix; the canonical
# runtime values (the "highest" decode tier multiplies by these).
T = np.array(
    [
        [0.35355339, 0.35355339, 0.35355339, 0.35355339, 0.35355339, 0.35355339, 0.35355339, 0.35355339],
        [0.5, 0.5, 0.0, 0.0, 0.0, 0.0, -0.5, -0.5],
        [0.4472136, 0.2236068, -0.2236068, -0.4472136, -0.4472136, -0.2236068, 0.2236068, 0.4472136],
        [0.0, 0.0, -0.70710678, 0.0, 0.0, 0.70710678, 0.0, 0.0],
        [0.35355339, -0.35355339, -0.35355339, 0.35355339, 0.35355339, -0.35355339, -0.35355339, 0.35355339],
        [0.5, -0.5, 0.0, 0.0, 0.0, 0.0, 0.5, -0.5],
        [0.2236068, -0.4472136, 0.4472136, -0.2236068, -0.2236068, 0.4472136, -0.4472136, 0.2236068],
        [0.0, 0.0, 0.0, -0.70710678, 0.70710678, 0.0, 0.0, 0.0],
    ],
    dtype=np.float32,
)

# Standard JPEG luminance quantization table.
Q = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)

# Standard JPEG chrominance quantization table (ITU-T T.81 Table K.2).
QC = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)

Q_TABLES = {"luma": Q, "chroma": QC}

LEVEL_SHIFT = 128.0


def get_q_table(name: str) -> np.ndarray:
    try:
        return Q_TABLES[name]
    except KeyError:
        raise KeyError(
            f"unknown quantization table {name!r}; available: {sorted(Q_TABLES)}"
        ) from None


def register_q_table(table, name: str | None = None) -> str:
    """Register a custom 8x8 quantization table; returns its name.

    Without an explicit `name`, the content-derived name "q:xxxxxx" (24-bit
    blake2s of the f32 values) is used, the same name the reference
    package derives for the same values.  Re-registering the same values
    is a no-op; DIFFERENT values under an existing name raise, which keeps
    the name-keyed kernel-constant caches sound.  The stored table is a
    write-protected copy.
    """
    t = np.array(table, dtype=np.float32)
    t.setflags(write=False)
    if t.shape != (BLOCK_SIZE, BLOCK_SIZE):
        raise ValueError(f"q_table must be 8x8, got shape {t.shape}")
    if not np.isfinite(t).all() or (t <= 0).any():
        raise ValueError("q_table entries must be finite and > 0")
    if name is None:
        name = "q:" + hashlib.blake2s(t.tobytes(), digest_size=3).hexdigest()
    if not name or len(name.encode("ascii", "replace")) > 8:
        raise ValueError(f"q_table name {name!r} must be 1-8 ASCII bytes")
    existing = Q_TABLES.get(name)
    if existing is not None:
        if not np.array_equal(existing, t):
            raise ValueError(
                f"q_table {name!r} is already registered with different values"
            )
        return name
    Q_TABLES[name] = t
    return name


def haweel_row_norms() -> np.ndarray:
    """Euclidean norms of the integer-core rows: (2*sqrt2, 2, sqrt20, sqrt2, ...)."""
    return np.sqrt((HAWEEL_TS.astype(np.float64) ** 2).sum(axis=1))


def haweel_integer_core() -> np.ndarray:
    """The {0,+-1,+-2} integer matrix Ts with T = diag(1/row_norms) @ Ts."""
    return HAWEEL_TS.copy()


def derive_T(dtype=np.float32) -> np.ndarray:
    """T from first principles (the Haweel construction): Ts with each row
    divided by its Euclidean norm, so the literal ``T`` above is provably
    the Haweel matrix and not an arbitrary constant."""
    ts = HAWEEL_TS.astype(np.float64)
    return (ts / haweel_row_norms()[:, None]).astype(dtype)


def tiled_Q(rows: int, cols: int, scale: float = 1.0, dtype=np.float32) -> np.ndarray:
    """Q times ``scale`` (in f32) repeated over a rows x cols tile of whole
    blocks: the per-block-position divisor of the original's
    divide_matrices (utils_kernels.cu:34-44)."""
    if rows % BLOCK_SIZE or cols % BLOCK_SIZE:
        raise ValueError(f"tiled_Q: {rows}x{cols} is not a grid of {BLOCK_SIZE}x{BLOCK_SIZE} blocks")
    return np.tile(Q * np.float32(scale), (rows // BLOCK_SIZE, cols // BLOCK_SIZE)).astype(dtype)


# ---------------------------------------------------------------------------
# Transform registry
# ---------------------------------------------------------------------------


def _exact_dct8(dtype=np.float64) -> np.ndarray:
    """The exact 8-point DCT-II matrix (orthonormal)."""
    k = np.arange(8)[:, None].astype(np.float64)
    n = np.arange(8)[None, :].astype(np.float64)
    c = np.cos((2 * n + 1) * k * np.pi / 16.0)
    c *= np.where(k == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    return c.astype(dtype)


def _rdct_core() -> np.ndarray:
    """round(2 * DCT8): the Cintra-Bayer (2011) {0, +-1} core, rows orthogonal."""
    ts = np.round(2.0 * _exact_dct8()).astype(np.int8)
    g = ts.astype(np.int64) @ ts.astype(np.int64).T
    if not (g == np.diag(np.diag(g))).all():
        raise AssertionError("rdct rows must be orthogonal")
    return ts


def _wht_core() -> np.ndarray:
    """Sequency-ordered 8x8 Walsh-Hadamard ({+-1} core, H @ H.T = 8I)."""
    h = np.array([[1]], np.int64)
    for _ in range(3):
        h = np.block([[h, h], [h, -h]])
    sequency = (np.diff(h, axis=1) != 0).sum(axis=1)
    ts = h[np.argsort(sequency, kind="stable")].astype(np.int8)
    g = ts.astype(np.int64) @ ts.astype(np.int64).T
    if not (g == 8 * np.eye(8, dtype=np.int64)).all():
        raise AssertionError("wht rows must be orthogonal")
    return ts


def _bas_core() -> np.ndarray:
    """Sparse sign transform in the Bouguezel-Ahmad-Swamy style: each row a
    sparsification of the rdct row, rows exactly orthogonal."""
    ts = np.array([
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, 1, 0, 0, 0, 0, -1, -1],
        [1, 0, 0, -1, -1, 0, 0, 1],
        [0, 0, -1, 0, 0, 1, 0, 0],
        [1, -1, -1, 1, 1, -1, -1, 1],
        [1, -1, 0, 0, 0, 0, 1, -1],
        [0, -1, 1, 0, 0, 1, -1, 0],
        [0, 0, 0, -1, 1, 0, 0, 0],
    ], np.int8)
    g = ts.astype(np.int64) @ ts.astype(np.int64).T
    if not (g == np.diag([8, 4, 4, 2, 8, 4, 4, 2])).all():
        raise AssertionError("bas rows must be orthogonal")
    return ts


@dataclasses.dataclass(frozen=True)
class Transform:
    """One 8x8 blockwise transform: orthogonal T (f32), optional integer
    core Ts with T = diag(d) @ Ts, and d = reciprocal row norms (f32)."""

    name: str
    t: np.ndarray
    ts: Optional[np.ndarray]  # int8 small integers, or None (no integer core)
    d: Optional[np.ndarray]  # 1/row_norms, None iff ts is None

    @property
    def has_integer_core(self) -> bool:
        return self.ts is not None


def _norm_t(ts: np.ndarray) -> tuple:
    norms = np.sqrt((ts.astype(np.float64) ** 2).sum(axis=1))
    d = (1.0 / norms).astype(np.float32)
    t = (ts.astype(np.float64) / norms[:, None]).astype(np.float32)
    return t, d


def _build_transforms() -> dict:
    rd_ts, wh_ts, ba_ts = _rdct_core(), _wht_core(), _bas_core()
    rd_t, rd_d = _norm_t(rd_ts)
    wh_t, wh_d = _norm_t(wh_ts)
    ba_t, ba_d = _norm_t(ba_ts)
    return {
        # The literal T matrix; d from the exact row norms, not from T.
        "haweel": Transform(
            "haweel", T, HAWEEL_TS, (1.0 / haweel_row_norms()).astype(np.float32)
        ),
        "rdct": Transform("rdct", rd_t, rd_ts, rd_d),
        "wht": Transform("wht", wh_t, wh_ts, wh_d),
        "bas": Transform("bas", ba_t, ba_ts, ba_d),
        # Exact DCT-II: no integer core, so no kernel of this package takes it.
        "dct": Transform("dct", _exact_dct8(np.float32), None, None),
    }


TRANSFORMS = _build_transforms()

# cb2011: the Cintra-Bayer 2011 transform is definitionally round(2*DCT8).
TRANSFORM_ALIASES = {"cb2011": "rdct"}


def get_transform(name: str) -> Transform:
    try:
        return TRANSFORMS[TRANSFORM_ALIASES.get(name, name)]
    except KeyError:
        raise ValueError(
            f"unknown transform {name!r}; available: {sorted(TRANSFORMS)}"
            f" (aliases: {TRANSFORM_ALIASES})"
        ) from None
