"""Device-time profiling, the deep-dive companion to ``utils.timing``: the
counterpart of ``tpudct/utils/profiling.py`` on ``torch.profiler``.

``trace`` records the host and (where there is a card) the device timeline
around a block; ``annotate`` names a region on it.  A trace written to a
directory is a Chrome trace (``trace.json``), which Perfetto and
chrome://tracing open.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a block and yield the profiler (``key_averages()`` sums its
    events by name, device events under ``DeviceType.CUDA``); with
    ``log_dir``, write the timeline there as ``trace.json`` on exit::

        with profiling.trace("build/trace") as prof:
            roundtrip(x)
            torch.cuda.synchronize()
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return record_function(name)
