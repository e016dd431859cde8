"""The device's idle share of the traced stretch: 100 less the union of every
device interval (kernels, copies, memsets) over the stretch, from the
first traced call's start to the last one's end."""


def read(run):
    tr = run.trace
    if tr is None or not tr.calls or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
