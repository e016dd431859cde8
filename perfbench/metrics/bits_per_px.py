"""Coded size: the bytes of every call's stream, times 8, over the input
pixels of those calls.  It guards the file size that a faster entropy
stage could give away."""


def read(run):
    n = run.stats.get("bytes")
    return n * 8 / run.pixels if n and run.pixels else None
