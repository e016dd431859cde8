"""Correctness gates: the codec held against a float64 numpy golden model.

Port of the reference's ``bench.py`` ``correctness_gate`` and the kernel
families of its ``family_gates`` (color420_u8, f32, scaled), with its own
copy of the golden model (``tests/golden.py``), so it runs where neither
JAX nor the test tree can be imported.  Tolerances are the reference's
documented equivalence class: coefficients match the golden except at
exact .5 quantizer ties (+-1 on <= 0.5% of entries); the reconstruction
differs only where a tie flipped (the per-block bound below); MSE within 2%
of the golden's; color planes within +-1 on <= 0.5%.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudct_torch.constants import BLOCK_SIZE, Q, T, get_q_table, get_transform


def synthetic_image(size: int, seed: int = 42) -> np.ndarray:
    """Deterministic uint8-valued float image (uniform noise from a seed)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(size, size)).astype(np.float32)


# ---- float64 golden model --------------------------------------------------


def round_half_away_np(x):
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def blockify_np(x, bs=BLOCK_SIZE):
    h, w = x.shape
    return x.reshape(h // bs, bs, w // bs, bs).transpose(0, 2, 1, 3).reshape(-1, bs, bs)


def deblockify_np(b, h, w, bs=BLOCK_SIZE):
    return b.reshape(h // bs, w // bs, bs, bs).transpose(0, 2, 1, 3).reshape(h, w)


def zonal_mask_np(k, bs=BLOCK_SIZE):
    if k is None:
        return np.ones((bs, bs))
    u, v = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
    return (u + v < k).astype(np.float64)


def golden_dct(img, q_scale=1.0, retain_k=None, dtype=np.float64, t=None, q=None):
    t = (T if t is None else t).astype(dtype)
    q = (Q if q is None else np.asarray(q)).astype(dtype) * q_scale
    h, w = img.shape
    xb = blockify_np(img.astype(dtype)) - 128.0
    yb = np.einsum("ij,bjk,lk->bil", t, xb, t)
    cb = round_half_away_np(yb / q) * zonal_mask_np(retain_k)
    return deblockify_np(cb, h, w)


def golden_idct(coeffs, q_scale=1.0, dtype=np.float64, t=None, q=None):
    t = (T if t is None else t).astype(dtype)
    q = (Q if q is None else np.asarray(q)).astype(dtype) * q_scale
    h, w = coeffs.shape
    yb = blockify_np(coeffs.astype(dtype)) * q
    xb = np.einsum("ji,bjk,kl->bil", t, yb, t) + 128.0
    return deblockify_np(xb, h, w)


def golden_roundtrip(img, q_scale=1.0, retain_k=None, t=None, q=None):
    c = golden_dct(img, q_scale, retain_k, t=t, q=q)
    r = golden_idct(c, q_scale, t=t, q=q)
    return c, np.clip(np.trunc(r), 0, 255).astype(np.uint8)


def golden_for(img, cfg):
    """golden_roundtrip under `cfg`: its transform's T, its Q table, its
    q_scale and retain_k (the default config gives golden_roundtrip(img))."""
    return golden_roundtrip(img, cfg.q_scale, cfg.retain_k,
                            t=get_transform(cfg.transform).t, q=get_q_table(cfg.q_table))


# ---- the gates -------------------------------------------------------------


def _check(cond, msg: str) -> None:
    # an explicit raise, not `assert`: the gate must survive python -O
    if not cond:
        raise AssertionError(msg)


def correctness_gate(p, cfg, size: int = 512, force_f32: bool = False, device=None) -> dict:
    """One size x size seed-42 image through pipeline `p` on `device`,
    held against the golden model under `cfg`.

    On the u8 path (the default config's), the standalone encode and
    decode must also agree with the fused roundtrip bit for bit.
    ``force_f32`` takes the f32 roundtrip instead (the hp_roundtrip kernel).
    ``device`` None is the first CUDA card (see ``dispatch.default_device``).
    """
    from tpudct_torch.kernels import hp
    from tpudct_torch.models.dispatch import default_device

    device = default_device(device)
    img = synthetic_image(size)
    u8_path = not force_f32 and hasattr(p, "roundtrip_u8") and hp.supports_u8(
        size, size, cfg.q_scale, cfg.transform, cfg.q_table
    )
    if u8_path:
        xu8 = torch.as_tensor(img.astype(np.uint8), device=device)
        c, r = p.roundtrip_u8(xu8, cfg)
        c_split = p.encode_u8(xu8, cfg)
        r_split = p.decode_u8(c_split, cfg)
        _check(torch.equal(c_split, c), "standalone encode_u8 disagrees with the fused roundtrip")
        _check(torch.equal(r_split, r), "standalone decode_u8 disagrees with the fused roundtrip")
    else:
        c, r = p.roundtrip(torch.as_tensor(img, device=device), cfg)
    rep = check_against_golden(img, c, r, cfg)
    return {
        "gate": "pass", "size": size, "path": "u8" if u8_path else "f32",
        "device": str(device), **rep,
    }


def check_against_golden(img: np.ndarray, c, r, cfg, golden=None) -> dict:
    """Hold coefficients `c` and uint8 reconstruction `r` (tensors or
    arrays) of the image `img` against the golden model under `cfg`
    (:func:`golden_for`, unless `golden` gives (coeffs, recon)): the tie
    class, the per-block tie-flip bound and MSE within 2%.  Raises
    AssertionError on a breach."""
    h, w = img.shape
    gc, gr = golden_for(img, cfg) if golden is None else golden
    c = np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c).astype(np.float64)
    r = np.asarray(r.cpu() if isinstance(r, torch.Tensor) else r)
    _check(c.shape == (h, w) and r.shape == (h, w), f"shapes {c.shape}, {r.shape} != {(h, w)}")
    cdiff = np.abs(c - gc)
    ties = int((cdiff > 0).sum())
    _check(cdiff.max() <= 1.0, f"coefficient error {cdiff.max()} exceeds the +-1 tie class")
    _check(
        ties <= max(4, int(c.size * 0.005)),
        f"{ties} coefficient mismatches (> 0.5% of {c.size}): not ties",
    )
    _check(r.dtype == np.uint8, f"reconstruction dtype {r.dtype}")
    rdiff = np.abs(r.astype(np.int64) - gr.astype(np.int64))
    # Per-block tie-flip bound: a flipped coefficient (u,v) moves any pixel
    # of its block by at most max|T_u| * max|T_l| * Q[u,v] <= 0.5 * Q[u,v];
    # ties in one block stack additively, truncation adds 1.
    q8 = get_q_table(cfg.q_table) * cfg.q_scale
    nbh, nbw = h // 8, w // 8
    bound = 0.5 * np.einsum("aibj,ij->ab", cdiff.reshape(nbh, 8, nbw, 8), q8) + 1.0
    worst = (rdiff.reshape(nbh, 8, nbw, 8).max(axis=(1, 3)) - bound).max()
    _check(worst <= 0, f"reconstruction error exceeds the per-block tie-flip bound by {worst}")
    mse = float(((r.astype(np.float64) - img) ** 2).mean())
    gmse = float(((gr.astype(np.float64) - img) ** 2).mean())
    _check(abs(mse - gmse) <= 0.02 * gmse + 1e-9, f"MSE {mse} vs golden {gmse}: quality drifted >2%")
    return {"coeff_ties": ties, "recon_max_diff": int(rdiff.max()), "mse": mse, "golden_mse": gmse}


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def color_gate(p, cfg, device=None) -> dict:
    """The reference's ``color420_u8`` family gate: an RGB made from the
    256^2 seed-42 image and two rolls of it through ``roundtrip_color_u8``
    on `device` (the color kernels and the u8 codec kernels on a card),
    held against the same pass on the CPU twins: every plane within +-1 on
    at most 0.5% of entries, reconstruction MSE within 2%, mean absolute
    difference at most 0.5.  Kernel and twin agree bit for bit, so a card
    should show 0 differences.  Skipped for a pipeline without u8 kernels.
    ``device`` None is the first CUDA card."""
    from tpudct_torch.models.color import roundtrip_color_u8
    from tpudct_torch.models.dispatch import default_device

    if not hasattr(p, "roundtrip_u8"):
        return {"gate": "skip", "family": "color420_u8",
                "reason": f"pipeline {p.name!r} has no u8 kernels"}
    device = default_device(device)
    g = synthetic_image(256)
    rgb = np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], -1).astype(np.uint8)
    pl_k, _meta, rec_k = roundtrip_color_u8(p, rgb, cfg, device=device)
    pl_t, _meta2, rec_t = roundtrip_color_u8(p, rgb, cfg, device="cpu")
    plane_diffs = {}
    for k in ("y", "cb", "cr"):
        d = np.abs(_np(pl_k[k]).astype(np.int32) - _np(pl_t[k]).astype(np.int32))
        _check(d.max() <= 1 and (d > 0).mean() <= 0.005,
               f"color420_u8 plane {k}: kernels vs twins differ beyond the tie class "
               f"(max {d.max()}, frac {(d > 0).mean():.4f})")
        plane_diffs[k] = int((d > 0).sum())
    rec_k, rec_t = _np(rec_k), _np(rec_t)
    m_k = float(((rec_k.astype(np.float64) - rgb) ** 2).mean())
    m_t = float(((rec_t.astype(np.float64) - rgb) ** 2).mean())
    _check(abs(m_k - m_t) <= 0.02 * m_t + 1e-9, f"color420_u8 recon MSE drifted: {m_k} vs {m_t}")
    rd = np.abs(rec_k.astype(np.int32) - rec_t.astype(np.int32))
    _check(rd.mean() <= 0.5, "color420_u8 recon: kernels vs twins mean diff > 0.5")
    return {"gate": "pass", "family": "color420_u8", "mse": m_k, "twin_mse": m_t,
            "plane_diffs": plane_diffs, "recon_diff_pixels": int((rd > 0).sum()),
            "device": str(device)}


def family_gates(p, cfg, device=None) -> list:
    """The kernel families of the reference's ``family_gates``, one 256^2
    case each, on `device`:

    - color420_u8: :func:`color_gate`;
    - f32: the seed-42 image through ``p.dct`` and ``p.idct`` (hp_dct and
      hp_idct at kernel shapes), held against the golden model;
    - scaled: the 1/2 decode (``ops.scaled.scaled_decode``) within 1e-2 of
      the box average of the full f32 decode; with u8 kernels, the fast
      form ``scaled_decode_u8`` (hp_scaled_decode_u8) equal to
      ``box_pool_u8(decode_u8)`` bit for bit;
    - streamed_gray, streamed_color (pipelines with u8 kernels; one
      "streamed" skip otherwise): a 96x128 image in 32-row bands and a
      64x128 RGB in one 64-row band through ``utils.streaming``'s encoders
      and decoders, the bytes equal to the in-memory banded writer's
      (``banded:3``, ``banded:1``) and the pixels to ``decode_gray_auto`` /
      ``decode_color_auto``.

    The reference's last family, jpg_import, waits for the JPEG
    coefficient import (ROADMAP A.4a(ii)).  ``device`` None is the first
    CUDA card."""
    from tpudct_torch.models.dispatch import default_device
    from tpudct_torch.ops.scaled import box_pool_u8, scaled_decode, scaled_decode_u8
    from tpudct_torch.ops.transform import to_uint8

    device = default_device(device)
    reports = [color_gate(p, cfg, device)]
    img = synthetic_image(256)
    x = torch.as_tensor(img, device=device)
    c = p.dct(x, cfg)
    full = p.idct(c, cfg)
    rep = check_against_golden(img, c, to_uint8(full), cfg)
    reports.append({**rep, "gate": "pass", "family": "f32", "size": 256, "path": "f32"})

    s = _np(scaled_decode(c, cfg, 2)).astype(np.float64)
    box = _np(full).astype(np.float64).reshape(128, 2, 128, 2).mean(axis=(1, 3))
    derr = float(np.abs(s - box).max())
    _check(derr <= 1e-2, f"scaled 1/2 decode deviates from box average by {derr}")
    rep = {"gate": "pass", "family": "scaled", "max_dev": derr}
    if hasattr(p, "decode_u8"):
        c8 = p.encode_u8(torch.as_tensor(img.astype(np.uint8), device=device), cfg)
        fast = scaled_decode_u8(p, c8, cfg, 2)
        _check(torch.equal(fast, box_pool_u8(p.decode_u8(c8, cfg), 2)),
               "fast scaled decode diverged from pool(decode_u8) contract")
        rep["fast_path"] = "pass"
    reports.append(rep)
    reports.extend(_streamed_gates(p, cfg, device))
    return reports


def _streamed_gates(p, cfg, device) -> list:
    """The streamed_gray and streamed_color families of :func:`family_gates`."""
    from tpudct_torch.models.color import decode_color_auto, encode_color_u8
    from tpudct_torch.models.dispatch import decode_gray_auto, encode_gray_auto
    from tpudct_torch.utils import serialize, streaming

    if not hasattr(p, "encode_u8"):
        return [{"gate": "skip", "family": "streamed", "reason": f"pipeline {p.name!r} has no u8 kernels"}]
    gimg = synthetic_image(128).astype(np.uint8)[:96]  # 96x128: 3 bands
    sdata, _ = streaming.encode_gray_streamed_bytes(p, gimg, cfg, band_rows=32, device=device)
    c_ref, (gh, gw) = encode_gray_auto(p, gimg, cfg, device=device)
    mdata = serialize.coefficients_to_bytes(
        _np(c_ref), cfg.q_scale, cfg.retain_k, orig_shape=(gh, gw), transform=cfg.transform,
        q_table=cfg.q_table, codec="banded:3",
    )
    _check(sdata == mdata, "streamed gray encode bytes differ from the in-memory banded writer")
    rec_s = streaming.decode_gray_streamed(p, sdata, band_rows=32, device=device)
    rec_m = decode_gray_auto(p, c_ref, cfg, (gh, gw))
    _check(np.array_equal(rec_s, rec_m), "streamed gray decode differs from the in-memory decode")
    reports = [{"gate": "pass", "family": "streamed_gray", "bytes": len(sdata)}]

    crgb = np.stack([gimg[:64], np.roll(gimg[:64], 3, 0), np.roll(gimg[:64], 5, 1)], -1)
    csdata, _ = streaming.encode_color_streamed_bytes(p, crgb, cfg, band_rows=64, device=device)
    pl_ref, meta_ref = encode_color_u8(p, crgb, cfg, device=device)
    cmdata = serialize.color_to_bytes(
        {k: _np(v) for k, v in pl_ref.items()}, meta_ref, cfg.q_scale, cfg.retain_k, cfg.transform,
        codec="banded:1",
    )
    _check(csdata == cmdata, "streamed color encode bytes differ from the in-memory banded writer")
    crec_s = streaming.decode_color_streamed(p, csdata, band_rows=64, device=device)
    crec_m = _np(decode_color_auto(p, pl_ref, meta_ref, cfg))
    _check(np.array_equal(crec_s, crec_m), "streamed color decode differs from the in-memory decode")
    reports.append({"gate": "pass", "family": "streamed_color", "bytes": len(csdata)})
    return reports
