"""Study drivers on the card: the counterparts of ``benchmarks/u8_perf.py``,
``color_fused_ab.py``, ``color_variants.py``, ``color_variants2.py``,
``inv_formulations.py``, ``u8_variants.py``, ``enc_variants.py``,
``rt_split_ab.py`` and ``scaled_ab.py``, each with ``main(..., device=None)``
and runnable as ``python -m tpudct_torch.studies.<name>`` with the
reference's arguments."""

import torch

from tpudct_torch.utils.timing import card


def device_label(dev: torch.device) -> str:
    """What a study's lines are measured on: the card's name and power
    limit, or the host clock."""
    return card(dev.index or 0) if dev.type == "cuda" else "cpu: host clock, not a device time"


def differ(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(entries that differ, max abs difference) of two integer maps."""
    d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    return int((d > 0).sum()), int(d.max())
