"""RGB frames resident on the card: per call
``models.color.roundtrip_color_auto`` on a CUDA (H, W, 3) uint8 frame at
the configuration's chroma mode, then a synchronize.  The colour kernels
(split, merge) and the u8 codec kernels run with the plain layout and
padding passes around them; no host copies, no entropy stage."""

from __future__ import annotations


# What the harness and its tests read of this driver (see ``gray_device``).
ANSWER_FROM = ("tpudct_torch.models.color", "roundtrip_color_auto", 2, 0)
ENTRIES = ("roundtrip_color_auto",)
STAGES: dict = {}


def pageable_bytes(config) -> int | None:
    return None


class Driver:
    def __init__(self, ctx):
        from tpudct_torch import CodecConfig, get_pipeline
        from tpudct_torch.models import color

        self.ctx, self.pool = ctx, ctx.inputs
        self.p, self.cfg = get_pipeline(ctx.config["pipeline"]), CodecConfig(**ctx.config["codec"])
        self.roundtrip = color.roundtrip_color_auto
        self.pixels = self.pool[0].shape[0] * self.pool[0].shape[1]

    def call(self, slot):
        span = self.ctx.spans
        with span("roundtrip_color_auto"):
            planes, _meta, rgb = self.roundtrip(self.p, self.pool[slot], self.cfg,
                                                subsample=self.ctx.config["chroma"])
        with span("synchronize"):
            self.ctx.sync()
        return {"planes": planes, "rgb": rgb}, {}

    def source(self, slot):
        return self.pool[slot]

    def release(self):
        self.p = self.roundtrip = None


def setup(ctx):
    return Driver(ctx)
