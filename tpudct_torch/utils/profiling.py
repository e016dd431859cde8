"""The port's spans and counters, and device-time profiling on
``torch.profiler``: the counterpart of ``tpudct/utils/profiling.py``.

The registry is off unless :func:`enable` (or :func:`trace`) turns it on.
Off, :func:`span` tests one module flag and returns a shared no-op context
(no clock read, no allocation, no lock), and :func:`count` and :func:`keep`
do nothing.  On, each span records its name, its start and end on
``time.perf_counter_ns``, its thread, its parent and the id of its root: the
spans of one call share their root's id.  A span's parent is the span open
where it was created, so a span created on the caller's thread and run on a
worker (:meth:`Span.run`) names the caller's span.  While a
``torch.profiler`` records, each span is also a ``record_function`` range:
on the profiler's timeline and clock, with a device-side annotation over
the kernels launched inside it.

:func:`snapshot` gives, per span name, the count, the total seconds, the
self seconds (the total less what the span's children cover) and the kept
ones (:func:`keep`); the counters; and the newest ``RING`` span records.

Every name starts with ``PREFIX``; callers pass the rest:

- ``entry.<fn>``: the library's entry points (``models/dispatch.py``
  ``roundtrip_gray``, ``encode_gray_auto``, ``decode_gray_auto``;
  ``models/color.py`` ``roundtrip_color_auto``, ``encode_color_auto``,
  ``decode_color_auto``), the roots of their calls;
- ``pad`` (edge and zero pads that copy: ``ops/padding.py``,
  ``models/color.py`` ``_zero_pad``) and ``layout`` (``_u8_frame``'s copy
  of a frame strided in neither layout, the chroma stacks of planes from
  separate buffers, dtype casts and the bulk merge's interleave);
- the counter ``color.u8.direct``: a u8 colour encode or decode that ran
  the direct split or merge (``models/color.py``), one each; and
  ``color.u8.plan.miss`` / ``color.u8.plan.hit``: a lookup of the u8
  colour path's per-shape plan that built it / found it;
- ``to_device``, ``to_host`` and the counter ``bytes.pageable``: a host
  array's copy to the card and a device tensor's copy back, in the port's
  own calls;
- ``wait``: a gate's blocking read of a device tensor (``_abs_bound``);
- ``entropy.trial.<codec>``, ``entropy.pack``, ``entropy.sample``,
  ``entropy.encode.<codec>`` and ``entropy.decode.<codec>``
  (``utils/serialize.py``): ``auto``'s trials, the spectral reorder they
  share, the sampled estimate, the real encode and a plane's decode; the
  spans whose bytes went into the stream are kept;
- ``entropy.narrow`` and ``entropy.widen`` (``utils/serialize.py``): the
  container's dtype casts, a map's bound scan and int16 copy on the way in
  (``_validate_map``) and the decoded map's float32 copy on the way out
  (``_parse_plane``);
- ``streaming.<part>`` (``utils/streaming.py``): spans ``stage``, ``wait``,
  ``finish``, ``entropy``; counters of seconds from CUDA events ``h2d``,
  ``kernels``, ``d2h``, ``device_busy``.

``trace`` records the host and (where there is a card) the device timeline
around a block, the registry on.  A trace written to a directory is a
Chrome trace (``trace.json``), which Perfetto and chrome://tracing open.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "tpudct_torch."
#: Span records kept, the newest (a window of a device cell makes ~250k calls).
RING = 1 << 16

_on = False
_lock = threading.Lock()
_ids = itertools.count(1)
_open: contextvars.ContextVar = contextvars.ContextVar("tpudct_torch_span", default=None)
_stats: dict = {}  # name -> [count, total ns, self ns, kept, kept ns]
_counters: dict = {}
_ring: collections.deque = collections.deque(maxlen=RING)


class _Off:
    """The span while the registry is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def run(self, fn, *args):
        return fn(*args)


_OFF = _Off()


class Span:
    """One recorded span; use :func:`span`."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start", "end", "kept",
                 "_children", "_token", "_range")

    def __init__(self, name: str, parent: "Span | None"):
        self.name, self.parent = name, parent
        self.id = next(_ids)
        self.root = self.id if parent is None else parent.root
        self.start = self.end = None
        self.kept = False
        self._children: list = []

    def __enter__(self) -> "Span":
        self.thread = threading.get_ident()
        self._token = _open.set(self)
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _open.reset(self._token)
        _close(self)
        return None

    def run(self, fn, *args):
        """fn(*args) inside this span, on whatever thread calls it (a pool's
        worker: the span keeps the parent it was created under)."""
        with self:
            return fn(*args)

    def record(self) -> dict:
        return {"name": self.name, "id": self.id, "root": self.root, "thread": self.thread,
                "parent": None if self.parent is None else self.parent.id,
                "start_ns": self.start, "end_ns": self.end, "kept": self.kept}


def _covered(s: Span) -> int:
    """ns of ``s`` that its children cover (their union: children on worker
    threads overlap)."""
    total, end = 0, s.start
    for a, b in sorted(s._children):
        a, b = max(a, end), min(b, s.end)
        if b > a:
            total += b - a
            end = b
    return total


def _close(s: Span) -> None:
    ns = s.end - s.start
    with _lock:
        own = ns - _covered(s) if s._children else ns
        st = _stats.get(s.name)
        if st is None:
            st = _stats[s.name] = [0, 0, 0, 0, 0]
        st[0] += 1
        st[1] += ns
        st[2] += own
        p = s.parent
        if p is not None and p.end is None:  # a child that outlives its parent covers none of it
            p._children.append((s.start, s.end))
        _ring.append(s)


def span(name: str):
    """A span ``PREFIX + name``: a context manager; while the registry is
    off, a shared no-op."""
    if not _on:
        return _OFF
    return Span(PREFIX + name, _open.get())


#: The reference's name for a named region of the trace: a span.
annotate = span


def entry(fn):
    """``fn`` as a library entry point: each call inside a span
    ``entry.<fn's name>``, the root of the spans the call opens."""
    name = "entry." + fn.__name__

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _on:
            return fn(*args, **kwargs)
        with span(name):
            return fn(*args, **kwargs)

    return call


def keep(s) -> None:
    """Mark a closed span as kept: its result went into the output (the
    entropy trial or encode whose payload the stream holds)."""
    if not isinstance(s, Span):
        return
    with _lock:
        st = _stats.setdefault(s.name, [0, 0, 0, 0, 0])
        st[3] += 1
        st[4] += s.end - s.start
        s.kept = True


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``PREFIX + name``."""
    if _on:
        key = PREFIX + name
        with _lock:
            _counters[key] = _counters.get(key, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop every aggregate, counter and record."""
    with _lock:
        _stats.clear()
        _counters.clear()
        _ring.clear()


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s", "kept", "kept_s"}},
    "counters": {name: value}, "records": [span record, ...]}``, the
    records oldest first."""
    with _lock:
        spans = {n: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9, "kept": k, "kept_s": ks / 1e9}
                 for n, (c, t, s, k, ks) in _stats.items()}
        return {"spans": spans, "counters": dict(_counters), "records": [s.record() for s in _ring]}


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a block, the registry on (the port's spans are ranges of the
    trace), and yield the profiler (``key_averages()`` sums its events by
    name, device events under ``DeviceType.CUDA``); with ``log_dir``, write
    the timeline there as ``trace.json`` on exit::

        with profiling.trace("build/trace") as prof:
            roundtrip(x)
            torch.cuda.synchronize()
    """
    global _on
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was, _on = _on, True
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        _on = was
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
