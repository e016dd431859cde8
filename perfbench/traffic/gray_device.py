"""Gray images resident on the card, as in a GPU pipeline: per call
``models.dispatch.roundtrip_gray`` on a CUDA uint8 image, then a
synchronize.  The kernel layer (B1) and host dispatch carry the call; no
host copies, no entropy stage."""

from __future__ import annotations


# What the harness and its tests read of this driver besides its calls, so
# that a cell on it needs no entry of its own in them:
#: the port's function whose result a call's answer reads, and the places in
#: that result of the decoded pixels and of the coefficients (None: the
#: result is the pixels; no coefficients)
ANSWER_FROM = ("tpudct_torch.models.dispatch", "roundtrip_gray", 1, 0)
#: the port's entry spans (``entry.<name>``) that a call opens, once each
ENTRIES = ("roundtrip_gray",)
#: the harness's spans around each stage of a call, by stage ("entropy": the
#: serializer and entropy stage), for the metrics that read a stage
STAGES: dict = {}


def pageable_bytes(config) -> int | None:
    """Bytes a call moves through the port's pageable copies, or None."""
    return None


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
