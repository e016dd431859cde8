#!/usr/bin/env python3
"""Where the time goes in the port's main-path steps (gray, color,
multi-device, and the composed and fused 4:2:0 color pair of the study), on
one CUDA card.

    python3 profile_steps.py

Each step runs once to warm up, then REPS (5) times under
``torch.profiler`` (``tpudct_torch.utils.profiling.trace``); per call it
prints the host wall time (the calls end in ``torch.cuda.synchronize()``), the device busy time (the sum of the
device-side events: kernels, copies, memsets; summed over the streams of
virtual ranks, so it may exceed the wall), the idle share (1 - busy / wall)
and the four largest device items.  For the ring all-gather on 8 virtual
ranks it also prints the host functions with the most own time per call
(``cProfile``, which slows every Python call, so read the shares).  Inputs
are made from seeds, as in ``chip_smoke.py``; the card's name and power
limit head the output.  Needs a CUDA device.
"""

from __future__ import annotations

import cProfile
import os
import pstats
import time

import numpy as np
import torch

REPS = 5


def _profile(label: str, fn) -> None:
    from torch.autograd import DeviceType

    from tpudct_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / REPS * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / REPS / 1e3
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:4]
    items = "; ".join(f"{e.key[:70]} {e.self_device_time_total / REPS / 1e3:.4f} ms" for e in top)
    print(f"{label}: wall {wall:.4f} ms, device busy {busy:.4f} ms, idle {1 - busy / wall:.0%}; {items}",
          flush=True)


def _gray_steps(p, cfg, dev) -> None:
    from tpudct_torch import CodecConfig
    from tpudct_torch.entry import entry
    from tpudct_torch.models import dispatch as d

    rng = np.random.default_rng(42)
    img = rng.integers(0, 256, size=(8192, 8192), dtype=np.uint8)
    x8k = torch.as_tensor(img, device=dev)
    xcam = torch.as_tensor(rng.integers(0, 256, size=(4000, 2992), dtype=np.uint8), device=dev)
    batch = torch.as_tensor(rng.integers(0, 256, size=(32 * 1024, 1024), dtype=np.uint8), device=dev)
    xf32 = x8k.to(torch.float32)
    ce, shape = d.encode_gray_auto(p, x8k, cfg)
    cfg_q = CodecConfig(q_scale=0.5)
    cq, _ = d.encode_gray_auto(p, x8k, cfg_q)
    cb = p.encode_u8(batch, cfg).cpu().numpy()
    items = [(cb[i * 1024 : (i + 1) * 1024], cfg, (1024, 1024)) for i in range(32)]
    fn, (ex,) = entry()
    steps = [
        ("8192^2 roundtrip_gray_auto (recon to host)", lambda: d.roundtrip_gray_auto(p, x8k, cfg)),
        ("4000x2992 roundtrip_gray_auto (recon to host)", lambda: d.roundtrip_gray_auto(p, xcam, cfg)),
        ("8192^2 roundtrip_u8 (device only)", lambda: p.roundtrip_u8(x8k, cfg)),
        ("32x1024^2 roundtrip_u8 (device only)", lambda: p.roundtrip_u8(batch, cfg)),
        ("8192^2 f32 hp.roundtrip (device only)", lambda: p.roundtrip(xf32, cfg)),
        ("8192^2 encode_gray_auto q_scale=0.5 (coeffs on device)", lambda: d.encode_gray_auto(p, x8k, cfg_q)),
        ("8192^2 decode_gray_auto q_scale=0.5 (recon to host)", lambda: d.decode_gray_auto(p, cq, cfg_q, shape)),
        ("4000x2992 roundtrip_gray_auto transform=dct (recon to host)",
         lambda: d.roundtrip_gray_auto(p, xcam, CodecConfig(transform="dct"))),
        ("8192^2 hp.roundtrip exact_int_core=False (device only)",
         lambda: p.roundtrip(xf32, CodecConfig(exact_int_core=False))),
        ("8192^2 decode_gray_auto decode_precision=high (recon to host)",
         lambda: d.decode_gray_auto(p, ce, CodecConfig(decode_precision="high"), shape)),
        ("8192^2 decode_gray_scaled_auto m=4 (to host)", lambda: d.decode_gray_scaled_auto(p, ce, cfg, shape, 4)),
        ("8192^2 decode_gray_scaled_auto m=1 (to host)", lambda: d.decode_gray_scaled_auto(p, ce, cfg, shape, 1)),
        ("8192^2 decode_gray_scaled_auto m=6 (to host)", lambda: d.decode_gray_scaled_auto(p, ce, cfg, shape, 6)),
        ("32x1024^2 decode_gray_scaled_batch_auto m=4 (host in and out)",
         lambda: d.decode_gray_scaled_batch_auto(p, items, 4)),
        ("entry() 512^2 (device only)", lambda: fn(ex)),
    ]
    for label, step in steps:
        _profile(label, step)


def _host_top(fn, k: int = 6) -> str:
    """The k functions with the most own host time per call of fn."""
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(REPS):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: kv[1][2], reverse=True)[:k]
    return "; ".join(f"{name} ({os.path.basename(path)}:{line}) {tt / REPS * 1e3:.4f} ms"
                     for (path, line, name), (_cc, _nc, tt, _ct, _callers) in rows)


def _multi_steps(p, cfg, dev) -> None:
    """The multi-device steps on 8 virtual ranks of the card, at 8192^2."""
    from tpudct_torch import parallel as P
    from tpudct_torch.kernels import color as ck
    from tpudct_torch.kernels import hp

    rng = np.random.default_rng(46)
    x = torch.as_tensor(rng.integers(0, 256, size=(8192, 8192), dtype=np.uint8), device=dev)
    rgb = torch.as_tensor(rng.integers(0, 256, size=(3, 8192, 8192), dtype=np.uint8), device=dev)
    batch = torch.as_tensor(rng.integers(0, 256, size=(32, 1024, 1024), dtype=np.uint8), device=dev)
    y, cb, cr = ck.color_split_420_u8(rgb)
    cc = hp.hp_encode_u8(torch.cat([cb, cr]), q_table="chroma")
    mesh = P.band_mesh(devices=[dev] * 8)
    xf, xs = P.shard_image(x.to(torch.float32), mesh), P.shard_image(x, mesh)
    cs = P.shard_image(hp.hp_encode_u8(x), mesh)
    ys = P.shard_image(hp.hp_encode_u8(y), mesh)
    ps = P.shard_image(P.chroma_band_pack(cc[:4096], cc[4096:], 8), mesh)
    bs = P.shard_batch(batch, mesh)
    steps = [
        ("8192^2 sharded_codec_step, 8 virtual ranks", lambda: P.sharded_codec_step(p, cfg, mesh)(xf)),
        ("8192^2 ring_all_gather, 8 virtual ranks", lambda: P.ring_all_gather(xs, mesh)),
        ("8192^2 ring_decode_gather, 8 virtual ranks", lambda: P.ring_decode_gather(cs, mesh)),
        ("8192^2 ring_decode_color_gather, 8 virtual ranks", lambda: P.ring_decode_color_gather(ys, ps, mesh)),
        ("32x1024^2 sharded_serving_step, 8 virtual ranks", lambda: P.sharded_serving_step(p, cfg, mesh)(bs)),
    ]
    for label, step in steps:
        _profile(label, step)
    print("8192^2 ring_all_gather, 8 virtual ranks, host functions by own time per call (cProfile):",
          _host_top(lambda: P.ring_all_gather(xs, mesh)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_steps.py needs a CUDA device")
    from tpudct_torch import CodecConfig, get_pipeline
    from tpudct_torch.kernels import study
    from tpudct_torch.models import color as mc
    from tpudct_torch.utils.timing import card

    print(card())
    dev = torch.device("cuda", 0)
    p, cfg = get_pipeline("hp"), CodecConfig()
    _gray_steps(p, cfg, dev)
    rng = np.random.default_rng(44)
    rgb_np = rng.integers(0, 256, size=(8192, 8192, 3), dtype=np.uint8)
    rgb = torch.as_tensor(rgb_np, device=dev)
    cam = torch.as_tensor(rng.integers(0, 256, size=(4032, 3024, 3), dtype=np.uint8), device=dev)
    frames = [rng.integers(0, 256, size=(1024, 1024, 3), dtype=np.uint8) for _ in range(32)]
    for sub in ("420", "422", False):
        _profile(f"8192^2 roundtrip_color_auto {sub or '444'} (device in and out)",
                 lambda s=sub: mc.roundtrip_color_auto(p, rgb, cfg, subsample=s))
    _profile("8192^2 roundtrip_color_auto 420 (host array in, recon to host)",
             lambda: mc.roundtrip_color_auto(p, rgb_np, cfg)[2].cpu().numpy())
    _profile("4032x3024 roundtrip_color_auto 420 (device)", lambda: mc.roundtrip_color_auto(p, cam, cfg))
    enc = mc.encode_color_batch_auto(p, frames, cfg)
    _profile("32x1024^2 encode_color_batch_auto (host in, numpy planes out)",
             lambda: mc.encode_color_batch_auto(p, frames, cfg))
    items = [(pl, m, cfg) for pl, m in enc]
    _profile("32x1024^2 decode_color_batch_auto (numpy planes in, host frames out)",
             lambda: mc.decode_color_batch_auto(p, items))
    _profile("8192^2 roundtrip_color_auto q_scale=0.5, f32 path (device)",
             lambda: mc.roundtrip_color_auto(p, rgb, CodecConfig(q_scale=0.5)))
    planes, meta = mc.encode_color_u8(p, rgb, cfg)
    rgb_planar = rgb.movedim(-1, 0).contiguous()
    _profile("8192^2 planar RGB encode_color_u8 + decode_color_u8, composed 4:2:0 (device)",
             lambda: mc.decode_color_u8(p, *mc.encode_color_u8(p, rgb_planar, cfg), cfg))
    _profile("8192^2 planar RGB color_encode_420_u8 + color_decode_420_u8, fused (device)",
             lambda: study.color_decode_420_u8(*study.color_encode_420_u8(rgb_planar)))
    for m in (4, 2, 6):
        _profile(f"8192^2 decode_color_scaled m={m} (device)",
                 lambda m=m: mc.decode_color_scaled(p, planes, meta, cfg, m=m))
    _multi_steps(p, cfg, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
