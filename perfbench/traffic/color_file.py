"""Compressing photos to ``.tdcc`` bytes and back, in memory: the CLI's
``encode --color`` and ``decode`` without the file.  Per call, on a host
(H, W, 3) uint8 frame: ``models.color.encode_color_auto``, the planes to
the host, ``utils.serialize.color_to_bytes`` with the configuration's
entropy stage, ``utils.serialize.bytes_to_color``, ``decode_color_auto``
and the RGB to the host.  The host entropy stage does most of the work.
The answer is the planes read back from the bytes and the decoded RGB;
the stats count the bytes."""

from __future__ import annotations

import torch


# What the harness and its tests read of this driver (see ``gray_device``).
ANSWER_FROM = ("tpudct_torch.models.color", "decode_color_auto", None, None)
ENTRIES = ("encode_color_auto", "decode_color_auto")
STAGES = {"entropy": ("color_to_bytes", "bytes_to_color")}
SUBSAMPLE = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}


def pageable_bytes(config) -> int | None:
    """The frame in, then the parsed planes in as float32 at their 8-aligned
    shapes (the RGB out is the driver's own copy)."""
    h, w = config["shape"]
    rh, rw = SUBSAMPLE[config["chroma"]]
    planes = _aligned(h) * _aligned(w) + 2 * _aligned(-(-h // rh)) * _aligned(-(-w // rw))
    return 3 * h * w + 4 * planes


def _aligned(n: int) -> int:
    return -(-n // 8) * 8


class Driver:
    def __init__(self, ctx):
        from tpudct_torch import CodecConfig, get_pipeline
        from tpudct_torch.models import color
        from tpudct_torch.utils import serialize

        self.ctx = ctx
        self.pool = [x.cpu().numpy() for x in ctx.inputs]
        self.p, self.cfg = get_pipeline(ctx.config["pipeline"]), CodecConfig(**ctx.config["codec"])
        self.color, self.serialize = color, serialize
        self.pixels = self.pool[0].shape[0] * self.pool[0].shape[1]

    def call(self, slot):
        span, dev, cfg, conf = self.ctx.spans, self.ctx.device, self.cfg, self.ctx.config
        with span("encode_color_auto"):
            planes, meta = self.color.encode_color_auto(self.p, self.pool[slot], cfg,
                                                        subsample=conf["chroma"], device=dev)
        with span("planes_to_host"):
            planes = {k: v.cpu().numpy() for k, v in planes.items()}
        with span("color_to_bytes"):
            data = self.serialize.color_to_bytes(planes, meta, cfg.q_scale, cfg.retain_k,
                                                 cfg.transform, codec=conf["entropy"])
        with span("bytes_to_color"):
            planes, meta = self.serialize.bytes_to_color(data)
        with span("decode_color_auto"):
            dcfg = type(cfg)(q_scale=meta["q_scale"], transform=meta["transform"])
            rgb = self.color.decode_color_auto(self.p, planes, meta, dcfg, device=dev)
        with span("rgb_to_host"):
            rgb = rgb.cpu().numpy()
        return {"planes": planes, "rgb": rgb}, {"bytes": len(data)}

    def source(self, slot):
        return torch.from_numpy(self.pool[slot]).to(self.ctx.device)

    def release(self):
        self.p = self.color = self.serialize = None


def setup(ctx):
    return Driver(ctx)
