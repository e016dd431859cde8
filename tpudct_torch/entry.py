"""The flagship forward step, the counterpart of ``__graft_entry__.entry()``.

    fn, (example,) = entry()          # the first CUDA card; entry("cpu") for the twins
    coeffs, recon = fn(example)

The step is the hp pipeline's fused encode + decode pass with the default
``CodecConfig``: on a CUDA tensor one launch of the ``hp_roundtrip`` kernel
(B4) and the u8 conversion; on a CPU tensor the kernel's plain twin.
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
