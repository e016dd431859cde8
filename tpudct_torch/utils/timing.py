"""Device-time measurement: the counterpart of ``tpudct/utils/timing.py``.

The original CUDA codec wraps each transform phase in cudaEvent pairs and
prints "DCT (w,h): ms" (main_newAppr.cu:266-287).  The port times the same
way: CUDA events around each call on the card, the L2 cache flushed before
every call (the 50 MB L2 would otherwise hold a 8192^2 u8 image between
calls, which no real caller finds warm) and the flush left out of the timed
span, the median of the calls (a stray slow call does not move it).  The
reference's chained-slope protocol (a fori_loop of K data-dependent calls,
the slope between two K) exists only because of the TPU's RPC relay, where
nothing synchronizes; ``k_pair``, ``min_span_s`` and ``max_k`` are accepted
and inert, so ``op`` need not be chainable.

A CPU tensor means the caller asked for the CPU: the function then times
with ``time.perf_counter`` (a CPU op is done when it returns).  A CPU time
is never a device time.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Sequence

import torch

#: Bytes zeroed before each timed call on the card: 10x the H100's 50 MB L2.
FLUSH_BYTES = 512 * 2**20


def card(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its line ``index``), the
    label every device number is printed with."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[index]


def device_time_ms(
    op: Callable,
    example: torch.Tensor,
    k_pair: Sequence[int] | None = None,
    reps: int = 5,
    min_span_s: float = 0.05,
    max_k: int = 8192,
) -> float:
    """Median per-call time of ``op(example)`` in milliseconds over ``reps``
    calls, after one untimed warm-up call (which builds the kernels on a
    first launch).

    On a CUDA ``example``: device time between CUDA events recorded on the
    device's current stream around each call, with ``FLUSH_BYTES`` zeroed
    before it (outside the events).  On a CPU ``example``: host wall time
    (``time.perf_counter``).  ``k_pair``, ``min_span_s`` and ``max_k`` are the
    reference's chain-length knobs, inert here."""
    if not isinstance(example, torch.Tensor):
        raise TypeError(f"device_time_ms times op on a torch.Tensor, got {type(example).__name__}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    op(example)
    dev = example.device
    times = []
    if dev.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            op(example)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev)
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        op(example)
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class PhaseTimer:
    """Structured per-phase timing record (the printf replacement for the
    reference's 'DCT (w,h): ms' lines)."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    def record(self, name: str, ms: float):
        self.phases[name] = ms

    def measure(self, name: str, op: Callable, example, **kw):
        ms = device_time_ms(op, example, **kw)
        self.phases[name] = ms
        return ms

    def report(self) -> dict:
        return dict(self.phases)
