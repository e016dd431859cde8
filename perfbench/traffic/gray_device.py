"""Gray images resident on the card, as in a GPU pipeline: per call
``models.dispatch.roundtrip_gray`` on a CUDA uint8 image, then a
synchronize.  The kernel layer (B1) and host dispatch carry the call; no
host copies, no entropy stage."""

from __future__ import annotations


class Driver:
    def __init__(self, ctx):
        from tpudct_torch import CodecConfig, get_pipeline
        from tpudct_torch.models import dispatch

        self.ctx, self.pool = ctx, ctx.inputs
        self.p, self.cfg = get_pipeline(ctx.config["pipeline"]), CodecConfig(**ctx.config["codec"])
        self.roundtrip = dispatch.roundtrip_gray
        self.pixels = self.pool[0].numel()

    def call(self, slot):
        span = self.ctx.spans
        with span("roundtrip_gray"):
            c, r = self.roundtrip(self.p, self.pool[slot], self.cfg)
        with span("synchronize"):
            self.ctx.sync()
        return {"coeffs": c, "recon": r}, {}

    def source(self, slot):
        return self.pool[slot]

    def release(self):
        self.p = self.roundtrip = None


def setup(ctx):
    return Driver(ctx)
