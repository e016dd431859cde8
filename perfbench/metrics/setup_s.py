"""Seconds from the process's start to the first call of the window:
imports, the card's context, loading (or, in a fresh checkout, building)
the kernels, making the inputs and the warm-up calls."""


def read(run):
    return run.setup_s
