"""Rate-aware quantization study: deadzone rounding against the codec's
round-half-away, as BD-rate; the port of ``benchmarks/deadzone_study.py``.

    python -m tpudct_torch.studies.deadzone_study

The codec rounds |y|/Q half away from zero (theta = 0.5).  A deadzone
quantizer rounds AC magnitudes at theta < 0.5: coefficients near a bin edge
fall toward zero, which costs distortion and saves rate.  Each theta gives
its own 10-point rate-distortion curve (qualities 10..95), and its
Bjøntegaard delta rate against the theta = 0.5 curve says whether the trade
beats moving along the quality axis.  DC keeps theta = 0.5.  Also swept:
breaking every exact .5 tie toward zero (the theta -> 0.5⁻ limit, the most
the documented ±1 tie class can give).

Host only, no device: the float64 golden codec (``selftest``'s numpy model)
for the coefficients and the pixels, the host rANS stage
(``utils.entropy.rans_encode`` over the repo's ``csrc/entropy.c``) for the
bytes, on ``benchmark.photographic_image`` and ``structured_image``.  It
prints one JSON line per image and variant; its numbers are the
reference's for the same inputs.
"""

from __future__ import annotations

import json

import numpy as np

from tpudct_torch.constants import Q, get_transform
from tpudct_torch.ops.quant import q_scale_for_quality
from tpudct_torch.selftest import blockify_np, deblockify_np, round_half_away_np

QUALITIES = (10, 20, 30, 40, 50, 60, 70, 80, 90, 95)
THETAS = (0.45, 0.40, 0.35, 0.30)


def quantize_deadzone(img, t, q8, theta: float):
    """Blockwise forward transform + deadzone quantization:
    sign(y) * floor(|y|/Q + theta) for AC, round-half-away for DC.
    theta = 0.5 reproduces the codec's quantizer exactly."""
    h, w = img.shape
    xb = blockify_np(img.astype(np.float64)) - 128.0
    yb = np.einsum("ij,bjk,lk->bil", t, xb, t)
    scaled = yb / q8
    c = np.sign(scaled) * np.floor(np.abs(scaled) + theta)
    c[:, 0, 0] = round_half_away_np(scaled[:, 0, 0])
    return deblockify_np(c, h, w)


def quantize_tiebreak_to_zero(img, t, q8):
    """Round-half-away except exact .5 ties, which break toward zero: the
    boundary case of the documented ±1 tie class.  Returns (map, AC ties)."""
    h, w = img.shape
    xb = blockify_np(img.astype(np.float64)) - 128.0
    yb = np.einsum("ij,bjk,lk->bil", t, xb, t)
    scaled = yb / q8
    mag = np.abs(scaled)
    tie = (mag + 0.5) == np.floor(mag + 0.5)  # |x|/Q is an exact k+0.5
    c = np.sign(scaled) * np.where(tie, np.floor(mag), np.floor(mag + 0.5))
    c[:, 0, 0] = round_half_away_np(scaled[:, 0, 0])
    return deblockify_np(c, h, w), int(tie[:, 1:, :].sum() + tie[:, 0, 1:].sum())


def decode(cmap, t, q8):
    h, w = cmap.shape
    yb = blockify_np(cmap.astype(np.float64)) * q8
    xb = np.einsum("ji,bjk,kl->bil", t, yb, t) + 128.0
    return np.clip(np.trunc(deblockify_np(xb, h, w)), 0, 255)


def _point(img, c, t, q8) -> tuple:
    """(rANS bytes, PSNR dB) of one quantized map."""
    from tpudct_torch.utils.entropy import rans_encode

    rec = decode(c, t, q8)
    mse = float(((rec - img) ** 2).mean())
    return len(rans_encode(np.ascontiguousarray(c, np.int16))), 10 * np.log10(255.0**2 / max(mse, 1e-9))


def curve(img, transform: str, quantizer, qualities):
    """[(bytes, PSNR), ...] of `quantizer` over `qualities`."""
    t = get_transform(transform).t.astype(np.float64)
    rows = []
    for q in qualities:
        q8 = Q.astype(np.float64) * q_scale_for_quality(q)
        rows.append(_point(img, quantizer(img, t, q8), t, q8))
    return rows


def main(qualities=QUALITIES, size: int = 512) -> list:
    """Print one JSON line per image and variant; return the lines."""
    from tpudct_torch.benchmark import bd_rate_pct, photographic_image, structured_image

    lines = []

    def emit(row: dict) -> None:
        lines.append(row)
        print(json.dumps(row), flush=True)

    for name, img in (("photo", photographic_image(size)), ("circuit", structured_image(size))):
        img = np.asarray(img, np.float64)
        base = curve(img, "haweel", lambda i, t, q8: quantize_deadzone(i, t, q8, 0.5), qualities)
        for theta in THETAS:
            rows = curve(img, "haweel", lambda i, t, q8, th=theta: quantize_deadzone(i, t, q8, th), qualities)
            emit({"image": name, "variant": f"deadzone theta={theta}",
                  "bd_rate_pct_vs_round_half_away": round(bd_rate_pct(base, rows), 2)})
        # tie-break-to-zero: the ±1 tie freedom spent on rate
        t = get_transform("haweel").t.astype(np.float64)
        tie_rows, tie_counts = [], []
        for q in qualities:
            q8 = Q.astype(np.float64) * q_scale_for_quality(q)
            c, nties = quantize_tiebreak_to_zero(img, t, q8)
            tie_rows.append(_point(img, c, t, q8))
            tie_counts.append(nties)
        emit({"image": name, "variant": "tie-break-to-zero",
              "bd_rate_pct_vs_round_half_away": round(bd_rate_pct(base, tie_rows), 2),
              "ac_ties_per_quality": tie_counts, "coeffs": int(img.size)})
    return lines


if __name__ == "__main__":
    main()
