"""Gray scans to ``.tdc`` bytes and back, in memory: the CLI's gray
``encode`` and ``decode`` without the file.  Per call, on a host (H, W)
uint8 image: ``models.dispatch.encode_gray_auto``, the coefficients to the
host, ``utils.serialize.coefficients_to_bytes`` with the configuration's
entropy stage, ``bytes_to_coefficients`` with the header, and
``decode_gray_auto`` under a ``CodecConfig`` built from that header (the
CLI's ``decode``).  The host entropy stage and the container's dtype casts
do most of the work.  The answer is the coefficients that went into the
bytes, those read back, the header read back and the reconstruction; the
stats count the bytes."""

from __future__ import annotations

import torch


# What the harness and its tests read of this driver (see ``gray_device``).
ANSWER_FROM = ("tpudct_torch.models.dispatch", "decode_gray_auto", None, None)
ENTRIES = ("encode_gray_auto", "decode_gray_auto")
STAGES = {"entropy": ("coefficients_to_bytes", "bytes_to_coefficients")}


def pageable_bytes(config) -> int | None:
    """The image in, the parsed float32 map at its 8-aligned shape in for
    the decode, and the pixels out (the coefficients out are the driver's
    own copy)."""
    h, w = config["shape"]
    return 2 * h * w + 4 * _aligned(h) * _aligned(w)


def _aligned(n: int) -> int:
    return -(-n // 8) * 8


class Driver:
    def __init__(self, ctx):
        from tpudct_torch import CodecConfig, get_pipeline
        from tpudct_torch.models import dispatch
        from tpudct_torch.utils import serialize

        self.ctx = ctx
        self.pool = [x.cpu().numpy() for x in ctx.inputs]
        self.p, self.cfg = get_pipeline(ctx.config["pipeline"]), CodecConfig(**ctx.config["codec"])
        self.d, self.serialize = dispatch, serialize
        self.pixels = self.pool[0].size

    def call(self, slot):
        span, dev, cfg = self.ctx.spans, self.ctx.device, self.cfg
        with span("encode_gray_auto"):
            c, hw = self.d.encode_gray_auto(self.p, self.pool[slot], cfg, device=dev)
        with span("coeffs_to_host"):
            c = c.cpu().numpy()
        with span("coefficients_to_bytes"):
            data = self.serialize.coefficients_to_bytes(c, cfg.q_scale, cfg.retain_k, orig_shape=hw,
                                                        transform=cfg.transform, q_table=cfg.q_table,
                                                        codec=self.ctx.config["entropy"])
        with span("bytes_to_coefficients"):
            back, q_scale, _k, orig, transform, q_table = self.serialize.bytes_to_coefficients(
                data, with_orig_shape=True, with_transform=True, with_q_table=True)
        with span("decode_gray_auto"):
            dcfg = type(cfg)(q_scale=q_scale, transform=transform, q_table=q_table)
            r = self.d.decode_gray_auto(self.p, back, dcfg, orig, device=dev)
        header = {"orig_shape": tuple(orig), "q_scale": q_scale, "transform": transform, "q_table": q_table}
        return {"coeffs": c, "coeffs_back": back, "header": header, "recon": r}, {"bytes": len(data)}

    def source(self, slot):
        return torch.from_numpy(self.pool[slot]).to(self.ctx.device)

    def release(self):
        self.p = self.d = self.serialize = None


def setup(ctx):
    return Driver(ctx)
