"""The entry points of ``__graft_entry__``, ported: ``entry`` and ``dryrun_multichip``.

    fn, (example,) = entry()          # the first CUDA card; entry("cpu") for the twins
    coeffs, recon = fn(example)
    dryrun_multichip(8, ["cuda:0"] * 8)  # every multi-device step on 8 ranks

``entry()``'s step is the hp pipeline's fused encode + decode pass with the
default ``CodecConfig``: on a CUDA tensor one launch of the ``hp_roundtrip``
kernel (B4) and the u8 conversion; on a CPU tensor the kernel's plain twin.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudct_torch.config import CodecConfig
from tpudct_torch.models import get_pipeline
from tpudct_torch.models.dispatch import default_device


def entry(device=None):
    """(fn, (example,)): ``fn(image)`` returns (f32 coefficients, uint8
    reconstruction); ``example`` is the 512x512 seed-42 noise image as f32
    on ``device`` (None: the first CUDA card; raises without one)."""
    cfg, p = CodecConfig(), get_pipeline("hp")

    def fn(image):
        return p.roundtrip(image, cfg)

    img = np.random.default_rng(42).integers(0, 256, size=(512, 512)).astype(np.float32)
    return fn, (torch.as_tensor(img, device=default_device(device)),)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One pass of every multi-device step on an n-rank band mesh, at tiny
    shapes: the counterpart of ``__graft_entry__.dryrun_multichip``.

    ``devices=None`` takes the CUDA cards (raises without ``n_devices`` of
    them); ``devices=["cuda:0"] * n`` gives n virtual ranks on one card and
    ``devices=["cpu"] * n`` runs the plain twins on the CPU.  In the
    reference's order: the sharded codec step, the color step, the serving
    step, the decode ring and the color decode ring, the grid codec and grid
    color steps (n >= 4), the scaled decode at factor 2, ``sharded_idct`` on
    the full coefficient map and on the progressive map of its spectral
    blob (``serialize.partial_coefficients``, 4 planes), the streamed
    sharded roundtrip (three host bands, each sharded over the ranks) held
    against the whole-image ``roundtrip_u8``, ``save_sharded`` and
    ``save_color_sharded`` held against the single-host banded writer (and
    read back), and the streamed color codec held against the in-memory
    color pass.  The streamed steps run on the first rank's device."""
    import os
    import tempfile

    from tpudct_torch.kernels.hp import hp_encode_u8
    from tpudct_torch.models.color import decode_color_auto, encode_color_u8, roundtrip_color_u8
    from tpudct_torch.parallel import (
        band_mesh, chroma_band_pack, gather, grid_mesh, ring_decode_color_gather, ring_decode_gather,
        save_color_sharded, save_sharded, shard_batch, shard_image, shard_image_grid, shard_rgb,
        shard_rgb_grid, sharded_codec_step, sharded_codec_step_grid, sharded_color_encode,
        sharded_color_step, sharded_color_step_grid, sharded_idct, sharded_scaled_decode,
        sharded_serving_step,
    )
    from tpudct_torch.utils import serialize
    from tpudct_torch.utils.streaming import (
        decode_color_streamed, encode_color_streamed_bytes, roundtrip_u8_streamed_sharded,
    )

    def noise(seed, shape, dtype=np.uint8):
        return np.random.default_rng(seed).integers(0, 256, size=shape).astype(dtype)

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {what}")

    mesh = band_mesh(n_devices=n_devices, devices=devices)
    dev0 = mesh.devices[0]
    cfg, p = CodecConfig(), get_pipeline("hp")

    h, w = 8 * n_devices * 2, 128  # two 8-row block bands per rank
    (coeffs, recon), m = sharded_codec_step(p, cfg, mesh)(shard_image(noise(0, (h, w), np.float32), mesh))
    check(coeffs.shape == (h, w) and recon.shape == (h, w) and float(m["mse"]) >= 0.0, "codec step")

    ch = 16 * n_devices
    rgb_in = noise(2, (3, ch, 128))
    crec, cm = sharded_color_step(p, cfg, mesh)(shard_rgb(rgb_in, mesh))
    check(crec.shape == (3, ch, 128) and float(cm["mse"]) >= 0.0, "color step")

    bb = 2 * n_devices
    (bc, br), bm = sharded_serving_step(p, cfg, mesh)(shard_batch(noise(5, (bb, 32, 128)), mesh))
    check(br.shape == (bb, 32, 128) and float(bm["images"]) == bb, "serving step")

    coeffs8 = hp_encode_u8(torch.as_tensor(noise(4, (h, w)), device=dev0))
    crep, rrec = ring_decode_gather(shard_image(coeffs8, mesh), mesh)
    check(crep.shape == (h, w) and rrec.shape == (h, w), "decode ring")

    planes, _meta, _rec = roundtrip_color_u8(p, noise(6, (64 * n_devices, 256, 3)), cfg, device=dev0)
    pack = chroma_band_pack(planes["cb"].to(torch.int8), planes["cr"].to(torch.int8), n_devices)
    _yr, _cr, rgb = ring_decode_color_gather(
        shard_image(planes["y"].to(torch.int8), mesh), shard_image(pack, mesh), mesh,
        float(cfg.q_scale), cfg.transform,
    )
    check(rgb.shape == (3, 64 * n_devices, 256), "color decode ring")

    if n_devices >= 4:
        gmesh = grid_mesh(devices=mesh.devices)
        nb, nc = gmesh.shape
        gh, gw = 8 * nb * 2, 8 * nc * 2
        (gc, _gr), gm = sharded_codec_step_grid(p, cfg, gmesh)(
            shard_image_grid(noise(1, (gh, gw), np.float32), gmesh))
        check(gc.shape == (gh, gw) and float(gm["mse"]) >= 0.0, "grid codec step")
        gch, gcw = 16 * nb, 16 * nc * 8
        gcrec, gcm = sharded_color_step_grid(p, cfg, gmesh)(shard_rgb_grid(noise(3, (3, gch, gcw)), gmesh))
        check(gcrec.shape == (3, gch, gcw) and float(gcm["mse"]) >= 0.0, "grid color step")

    half = sharded_scaled_decode(cfg, mesh, 2)(coeffs)
    check(half.shape == (h // 2, w // 2), "scaled decode")
    full = sharded_idct(p, cfg, mesh)(coeffs)
    check(full.shape == (h, w), "sharded idct")
    coeffs_np = gather(coeffs)
    partial = serialize.partial_coefficients(serialize.coefficients_to_bytes(coeffs_np, codec="spectral"), 4)
    prec = sharded_idct(p, cfg, mesh)(shard_image(partial["coeffs"], mesh))
    check(prec.shape == (h, w), "progressive sharded idct")

    sh = 32 * n_devices * 3  # three host bands at band_rows = 32 n
    simg = noise(7, (sh, 128))
    sc, sr = roundtrip_u8_streamed_sharded(p, simg, mesh, cfg, band_rows=32 * n_devices)
    mc, mr = p.roundtrip_u8(torch.as_tensor(simg, device=dev0), cfg)
    check(np.array_equal(sc, mc.cpu().numpy()) and np.array_equal(sr, mr.cpu().numpy()),
          "streamed sharded roundtrip differs from the whole-image pass")

    with tempfile.TemporaryDirectory() as tmp:
        tdc, tdcc = os.path.join(tmp, "c.tdc"), os.path.join(tmp, "c.tdcc")
        save_sharded(tdc, coeffs, cfg.q_scale, cfg.retain_k, orig_shape=(h, w))
        with open(tdc, "rb") as f:
            data = f.read()
        ref = serialize.coefficients_to_bytes(
            coeffs_np, q_scale=cfg.q_scale, retain_k=cfg.retain_k, orig_shape=(h, w),
            codec=f"banded:{n_devices}",
        )
        check(data == ref, "save_sharded differs from the single-host banded writer")
        check(np.array_equal(serialize.bytes_to_coefficients(data)[0], coeffs_np), "save_sharded read back")
        cenc, cmeta_fn = sharded_color_encode(p, cfg, mesh)
        cplanes = dict(zip(("y", "cb", "cr"), cenc(shard_rgb(rgb_in, mesh))))
        cmeta = cmeta_fn(ch, 128)
        save_color_sharded(tdcc, cplanes, cmeta, cfg.q_scale, cfg.retain_k)
        with open(tdcc, "rb") as f:
            cdata = f.read()
        host = {k: gather(v) for k, v in cplanes.items()}
        cref = serialize.color_to_bytes(host, cmeta, cfg.q_scale, cfg.retain_k, cfg.transform,
                                        codec=f"banded:{n_devices}")
        check(cdata == cref, "save_color_sharded differs from the single-host banded writer")
        back, back_meta = serialize.bytes_to_color(cdata)
        check(back_meta["orig_shape"] == (ch, 128)
              and all(np.array_equal(back[k], host[k]) for k in host), "save_color_sharded read back")

    sdata, _hw = encode_color_streamed_bytes(p, rgb_in, cfg, band_rows=64, device=dev0)
    pl_ref, meta_ref = encode_color_u8(p, rgb_in, cfg, device=dev0)
    rec_ref = decode_color_auto(p, pl_ref, meta_ref, cfg).cpu().numpy()
    check(np.array_equal(decode_color_streamed(p, sdata, band_rows=64, device=dev0), rec_ref),
          "streamed color decode differs from the in-memory pass")
