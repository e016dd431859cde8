"""Host milliseconds per call in the serializer and entropy stage: the
benchmark's spans around ``color_to_bytes`` and ``bytes_to_color``, summed
over the window's calls."""

SPANS = ("color_to_bytes", "bytes_to_color")


def read(run):
    s = sum(run.spans.get(k, 0.0) for k in SPANS)
    return s * 1e3 / run.calls if s > 0 and run.calls else None
