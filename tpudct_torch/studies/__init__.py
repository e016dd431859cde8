"""Study drivers on the card: the counterparts of ``benchmarks/u8_perf.py``
and ``benchmarks/color_fused_ab.py``, each ``main(size=8192, device=None)``
and runnable as ``python -m tpudct_torch.studies.<name> [size]``."""

import torch

from tpudct_torch.utils.timing import card


def device_label(dev: torch.device) -> str:
    """What a study's lines are measured on: the card's name and power
    limit, or the host clock."""
    return card(dev.index or 0) if dev.type == "cuda" else "cpu: host clock, not a device time"
