"""The plain codec that decides ``correct``: what the system computes,
written from the specification in plain PyTorch, with frozen constants.

It imports nothing of the system under test.  Every table is a copy made
here once:

- the Haweel approximate DCT as its integer core ``TS`` (entries in
  {0, +-1, +-2}); T = diag(1 / ||TS_r||) TS, so T X T^T is the integer
  product TS X TS^T divided by the products of two row norms;
- the JPEG luminance and chrominance quantization tables (ITU-T T.81
  Tables K.1 and K.2);
- the full-range BT.601 colour constants of ITU-T T.871;
- the 4:2:0 rule: each chroma sample is the mean of a 2x2 window (an odd
  trailing row or column repeated), and each pixel takes its window's
  sample back.

Encode: X - 128 in 8x8 blocks, TS X TS^T exactly, divided by
``sqrt(n_u n_v) * Q[u, v] * q_scale`` (``n`` the squared row norms), rounded
half away from zero.  Decode: dequantize, T^T C T + 128, truncated and
clipped to 0..255.  In float64 the integer product is exact and a tie
k + 1/2 stays exact wherever the divisor is rational, so the float64 result
is the exact one but for a few values that lie within 1e-12 of a rounding
edge.  ``dtype`` selects the precision: float64 is the reference, bfloat16
is the control (the precision below the float32 that the configurations
state).
"""

from __future__ import annotations

import math

import torch

TS = (
    (1, 1, 1, 1, 1, 1, 1, 1),
    (1, 1, 0, 0, 0, 0, -1, -1),
    (2, 1, -1, -2, -2, -1, 1, 2),
    (0, 0, -1, 0, 0, 1, 0, 0),
    (1, -1, -1, 1, 1, -1, -1, 1),
    (1, -1, 0, 0, 0, 0, 1, -1),
    (1, -2, 2, -1, -1, 2, -2, 1),
    (0, 0, 0, -1, 1, 0, 0, 0),
)

TABLES = {
    "luma": (
        (16, 11, 10, 16, 24, 40, 51, 61),
        (12, 12, 14, 19, 26, 58, 60, 55),
        (14, 13, 16, 24, 40, 57, 69, 56),
        (14, 17, 22, 29, 51, 87, 80, 62),
        (18, 22, 37, 56, 68, 109, 103, 77),
        (24, 35, 55, 64, 81, 104, 113, 92),
        (49, 64, 78, 87, 103, 121, 120, 101),
        (72, 92, 95, 98, 112, 100, 103, 99),
    ),
    "chroma": (
        (17, 18, 24, 47, 99, 99, 99, 99),
        (18, 21, 26, 66, 99, 99, 99, 99),
        (24, 26, 56, 99, 99, 99, 99, 99),
        (47, 66, 99, 99, 99, 99, 99, 99),
        (99, 99, 99, 99, 99, 99, 99, 99),
        (99, 99, 99, 99, 99, 99, 99, 99),
        (99, 99, 99, 99, 99, 99, 99, 99),
        (99, 99, 99, 99, 99, 99, 99, 99),
    ),
}

# ITU-T T.871: Y = KR R + KG G + KB B; Cb = 128 + (B - Y) / (2 - 2 KB);
# Cr = 128 + (R - Y) / (2 - 2 KR).
KR, KG, KB = 0.299, 0.587, 0.114

# Rows of pixels per block of work, so a reference at 8192^2 stays small.
ROWS = 1024


def _norm2() -> list:
    return [sum(v * v for v in row) for row in TS]


def _divisor(table: str, q_scale: float) -> list:
    """sqrt(n_u n_v) Q[u][v] q_scale in float64: exact where n_u n_v is a
    square, which is where a quantizer tie can be exact."""
    n2 = _norm2()
    q = TABLES[table]
    return [[math.sqrt(n2[u] * n2[v]) * q[u][v] * q_scale for v in range(8)] for u in range(8)]


def check_codec(codec: dict) -> None:
    """Refuse a codec configuration this reference does not compute."""
    want = {"transform": "haweel", "retain_k": None, "deadzone": 0.5}
    for key, value in want.items():
        if codec.get(key) != value:
            raise ValueError(f"the reference computes {key}={value!r} only, got {codec.get(key)!r}")
    if codec.get("q_table", "luma") not in TABLES:
        raise ValueError(f"no frozen table {codec.get('q_table')!r}")


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    return torch.sign(v) * torch.floor(v.abs() + 0.5)


def _edge_pad(x: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Repeat the last row and column up to multiples of (mh, mw)."""
    h, w = x.shape[:2]
    ph, pw = -h % mh, -w % mw
    if ph:
        x = torch.cat([x, x[-1:].expand(ph, *x.shape[1:])], dim=0)
    if pw:
        x = torch.cat([x, x[:, -1:].expand(x.shape[0], pw, *x.shape[2:])], dim=1)
    return x


def encode_plane(x_u8: torch.Tensor, table: str, q_scale: float,
                 dtype=torch.float64) -> torch.Tensor:
    """(H, W) uint8 -> quantized coefficients at the 8-aligned shape, as
    ``dtype`` values (integers)."""
    x = _edge_pad(x_u8, 8, 8)
    hp, wp = x.shape
    ts = torch.tensor(TS, dtype=dtype, device=x.device)
    div = torch.tensor(_divisor(table, q_scale), dtype=torch.float64, device=x.device).to(dtype)
    out = torch.empty((hp, wp), dtype=dtype, device=x.device)
    for r0 in range(0, hp, ROWS):
        xb = (x[r0:r0 + ROWS].to(dtype) - 128).reshape(-1, 8, wp // 8, 8)
        y = torch.einsum("ij,ajbk,lk->aibl", ts, xb, ts)
        out[r0:r0 + ROWS] = _round_half_away(y / div[None, :, None, :]).reshape(-1, wp)
    return out


def decode_plane(c: torch.Tensor, table: str, q_scale: float, dtype=torch.float64) -> torch.Tensor:
    """Quantized coefficients (8-aligned) -> uint8 plane of the same shape."""
    hp, wp = c.shape
    ts = torch.tensor(TS, dtype=dtype, device=c.device)
    div = torch.tensor(_divisor(table, q_scale), dtype=torch.float64, device=c.device)
    q = torch.tensor(TABLES[table], dtype=torch.float64, device=c.device) * q_scale
    # T^T (C Q) T = TS^T (C Q / (n_u n_v)) TS, and Q / sqrt(n_u n_v) = Q^2 / div
    dq = (q * q / div).to(dtype)
    out = torch.empty((hp, wp), dtype=torch.uint8, device=c.device)
    for r0 in range(0, hp, ROWS):
        cb = c[r0:r0 + ROWS].to(dtype).reshape(-1, 8, wp // 8, 8) * dq[None, :, None, :]
        x = torch.einsum("ji,ajbk,kl->aibl", ts, cb, ts) + 128
        out[r0:r0 + ROWS] = torch.trunc(x).clamp(0, 255).reshape(-1, wp).to(torch.uint8)
    return out


def _round_half_up_u8(v: torch.Tensor) -> torch.Tensor:
    return torch.floor(v.clamp(0, 255) + 0.5).to(torch.uint8)


def split_420(rgb_u8: torch.Tensor, dtype=torch.float64) -> tuple:
    """(H, W, 3) uint8 RGB -> (y (H, W), cb, cr (ceil(H/2), ceil(W/2))) uint8:
    T.871 luma per pixel, chroma of each 2x2 window's mean RGB, each rounded
    half up once."""
    x = _edge_pad(rgb_u8, 2, 2).to(dtype)
    h, w = rgb_u8.shape[:2]
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = _round_half_up_u8(KR * r + KG * g + KB * b)[:h, :w]
    hp, wp = r.shape

    def pool(c):
        return c.reshape(hp // 2, 2, wp // 2, 2).sum(dim=(1, 3)) * 0.25

    rp, gp, bp = pool(r), pool(g), pool(b)
    yp = KR * rp + KG * gp + KB * bp
    cb = _round_half_up_u8(128 + (bp - yp) * (0.5 / (1 - KB)))
    cr = _round_half_up_u8(128 + (rp - yp) * (0.5 / (1 - KR)))
    return y, cb, cr


def merge_420(y_u8: torch.Tensor, cb_u8: torch.Tensor, cr_u8: torch.Tensor,
              dtype=torch.float64) -> torch.Tensor:
    """Inverse of :func:`split_420` on decoded planes (y cropped to (H, W),
    chroma to its 4:2:0 shape) -> (H, W, 3) uint8, rounded half up."""
    h, w = y_u8.shape
    y = y_u8.to(dtype)

    def up(c):
        return c.to(dtype).repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w] - 128

    cb, cr = up(cb_u8), up(cr_u8)
    r = y + (2 - 2 * KR) * cr
    b = y + (2 - 2 * KB) * cb
    g = (y - KR * r - KB * b) / KG
    return torch.stack([_round_half_up_u8(v) for v in (r, g, b)], dim=-1)


def chroma_shape(h: int, w: int) -> tuple:
    return -(-h // 2), -(-w // 2)


def aligned(h: int, w: int) -> tuple:
    return -(-h // 8) * 8, -(-w // 8) * 8


def encode_color_420(rgb_u8: torch.Tensor, q_scale: float, dtype=torch.float64) -> dict:
    """(H, W, 3) uint8 -> {"y", "cb", "cr"} quantized planes at their
    8-aligned shapes: luma against the luma table, chroma against the
    chroma table."""
    h, w = rgb_u8.shape[:2]
    # the edge repeat reaches whole 8x8 chroma blocks before the split
    y, cb, cr = split_420(_edge_pad(rgb_u8, 16, 16), dtype)
    ya, ca = aligned(h, w), aligned(*chroma_shape(h, w))
    return {
        "y": encode_plane(y[: ya[0], : ya[1]], "luma", q_scale, dtype),
        "cb": encode_plane(cb[: ca[0], : ca[1]], "chroma", q_scale, dtype),
        "cr": encode_plane(cr[: ca[0], : ca[1]], "chroma", q_scale, dtype),
    }


def decode_color_420(planes: dict, shape: tuple, q_scale: float, dtype=torch.float64) -> torch.Tensor:
    """Quantized planes at 8-aligned shapes -> (H, W, 3) uint8 RGB."""
    h, w = shape
    ch, cw = chroma_shape(h, w)
    y = decode_plane(planes["y"], "luma", q_scale, dtype)[:h, :w]
    cb = decode_plane(planes["cb"], "chroma", q_scale, dtype)[:ch, :cw]
    cr = decode_plane(planes["cr"], "chroma", q_scale, dtype)[:ch, :cw]
    return merge_420(y, cb, cr, dtype)
