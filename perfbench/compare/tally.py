"""What the comparisons share: answers moved to the judging device, and the
tally of one pair of arrays."""

from __future__ import annotations

import numpy as np
import torch


def on(x, device) -> torch.Tensor:
    """A tensor or numpy array as a tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


class Tally:
    """Differing elements, elements and the widest gap over pairs of
    arrays; a pair of different shapes counts as differing everywhere."""

    def __init__(self):
        self.diff, self.n, self.max = 0, 0, 0.0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        if got.shape != want.shape:
            self.miss(want.numel())
            return
        d = (got.to(torch.float64) - want.to(torch.float64)).abs()
        self.n += d.numel()
        self.diff += int((d > 0).sum())
        self.max = max(self.max, float(d.max()))

    def miss(self, n: int) -> None:
        self.diff += n
        self.n += n
        self.max = float("inf")

    def share(self) -> float:
        return self.diff / self.n
