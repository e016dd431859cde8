"""Read a ``torch.profiler`` trace of a stretch of calls: the device's
intervals, the benchmark's own host spans, and what follows from them.

Device time is the union of the device's intervals (kernels, copies,
memsets), never their sum: a copy that overlaps a kernel is busy time
once.  A user annotation (a ``record_function`` range of the benchmark or
of the port) also shows on the device's timeline, over the kernels launched
inside it; it is no device time, and is kept apart by its kind.  Times here
are the profiler's microseconds.
"""

from __future__ import annotations

import dataclasses

TOP = 10  # entries per breakdown list


@dataclasses.dataclass
class Trace:
    """One traced stretch: ``calls`` whole calls from ``t0`` to ``t1``."""

    calls: int
    t0: float
    t1: float
    device: list  # (name, start, end) of every device interval
    spans: list  # (name, start, end) of the benchmark's host spans
    annotations: list = dataclasses.field(default_factory=list)  # device-side user annotations

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self, keep=lambda name: True) -> float:
        """Seconds of the stretch in which a kept device interval ran."""
        return union(self.clipped(keep)) / 1e6

    def clipped(self, keep=lambda name: True) -> list:
        return [(max(s, self.t0), min(e, self.t1)) for n, s, e in self.device
                if keep(n) and e > self.t0 and s < self.t1]


def kind(name: str) -> str:
    """``h2d``, ``d2h``, ``d2d``, ``memset`` or ``kernel``, by the name CUPTI
    gives a device interval."""
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith("Memcpy"):
        return "d2d"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def union(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, t0: float, t1: float) -> list:
    """(start, end) of the stretches in [t0, t1] that no interval covers."""
    out, at = [], t0
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


def from_profiler(prof, span_names, call_span: str) -> Trace:
    """The stretch a profiler recorded: device intervals, device-side user
    annotations, and the host spans whose names are in ``span_names``; the
    stretch runs from the first ``call_span`` to the end of the last."""
    from torch.autograd import DeviceType

    device, spans, annotations = [], [], []
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            (annotations if e.is_user_annotation else device).append(iv)
        elif e.name in span_names:
            spans.append(iv)
    calls = [(s, e) for n, s, e in spans if n == call_span]
    t0, t1 = (min(s for s, _ in calls), max(e for _, e in calls)) if calls else (0.0, 0.0)
    return Trace(len(calls), t0, t1, device, spans, annotations)


def _innermost(spans, t0: float, t1: float) -> list:
    """[t0, t1] cut at every span boundary: (start, end, name of the innermost
    span open there, or "between calls").  Spans of one thread nest."""
    events = sorted([(s, 1, -e, n) for n, s, e in spans] + [(e, 0, 0, n) for n, s, e in spans])
    out, stack, at = [], [], t0
    for t, opening, _, name in events:
        t = min(max(t, t0), t1)
        if t > at:
            out.append((at, t, stack[-1] if stack else "between calls"))
            at = t
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if at < t1:
        out.append((at, t1, stack[-1] if stack else "between calls"))
    return out


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the device's idle
    time by the innermost benchmark span open while it idled."""
    by_op: dict = {}
    for n, s, e in tr.device:
        s, e = max(s, tr.t0), min(e, tr.t1)
        if e > s:
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s) / 1e6
    by_span: dict = {}
    segments = _innermost(tr.spans, tr.t0, tr.t1)
    k = 0
    for s, e in gaps(tr.clipped(), tr.t0, tr.t1):
        while k < len(segments) and segments[k][1] <= s:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < e:
            a, b, name = segments[j]
            cut = min(b, e) - max(a, s)
            if cut > 0:
                by_span[name] = by_span.get(name, 0.0) + cut / 1e6
            j += 1

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}
