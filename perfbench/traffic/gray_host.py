"""The library's host API for gray images, without entropy: per call
``encode_gray_auto`` on a host array, the coefficients to the host, then
``decode_gray_auto``, which returns a host array.  Four pageable copies of
the image's size set its time; the kernels are a small share and there is
no entropy stage."""

from __future__ import annotations

import torch


# What the harness and its tests read of this driver (see ``gray_device``).
ANSWER_FROM = ("tpudct_torch.models.dispatch", "decode_gray_auto", None, None)
ENTRIES = ("encode_gray_auto", "decode_gray_auto")
STAGES: dict = {}


def pageable_bytes(config) -> int | None:
    """The image in, its int8 coefficients in for the decode, the pixels out."""
    h, w = config["shape"]
    return 3 * h * w


class Driver:
    def __init__(self, ctx):
        from tpudct_torch import CodecConfig, get_pipeline
        from tpudct_torch.models import dispatch

        self.ctx = ctx
        self.pool = [x.cpu().numpy() for x in ctx.inputs]
        self.p, self.cfg = get_pipeline(ctx.config["pipeline"]), CodecConfig(**ctx.config["codec"])
        self.d = dispatch
        self.pixels = self.pool[0].size

    def call(self, slot):
        span, dev = self.ctx.spans, self.ctx.device
        with span("encode_gray_auto"):
            c, hw = self.d.encode_gray_auto(self.p, self.pool[slot], self.cfg, device=dev)
        with span("coeffs_to_host"):
            c = c.cpu().numpy()
        with span("decode_gray_auto"):
            r = self.d.decode_gray_auto(self.p, c, self.cfg, hw, device=dev)
        return {"coeffs": c, "recon": r}, {}

    def source(self, slot):
        return torch.from_numpy(self.pool[slot]).to(self.ctx.device)

    def release(self):
        self.p = self.d = None


def setup(ctx):
    return Driver(ctx)
