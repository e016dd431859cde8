"""The codec pass against the card's memory bandwidth: the bytes a call
must move at least (the configuration's ``floor_bytes_per_px`` times its
pixels) at the card's peak bandwidth, over the device time per call that
is not a host copy (the union of kernels, device copies and memsets).
It reads the same work whatever kernels implement the pass."""

from perfbench import trace as tracing


def read(run):
    tr = run.trace
    if tr is None or not tr.calls or run.peaks is None:
        return None
    busy = tr.busy_s(lambda name: tracing.kind(name) not in ("h2d", "d2h"))
    if busy <= 0:
        return None
    floor_s = run.config["floor_bytes_per_px"] * run.pixels / run.calls / run.peaks["hbm_bytes_per_s"]
    return 100.0 * floor_s * tr.calls / busy
