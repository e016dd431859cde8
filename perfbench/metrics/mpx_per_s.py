"""Input megapixels of the calls completed in the window, over the window:
from the first call's start to the last call's end on the host's clock
(the window ends with the call that was running at ``--seconds``)."""


def read(run):
    return run.pixels / run.window_s / 1e6 if run.calls else None
