"""Host-to-device and device-to-host copy time per traced call: the union of
those copies' device intervals over the stretch, over its calls."""

from perfbench import trace as tracing


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    busy = tr.busy_s(lambda name: tracing.kind(name) in ("h2d", "d2h"))
    return busy * 1e3 / tr.calls if busy > 0 else None
