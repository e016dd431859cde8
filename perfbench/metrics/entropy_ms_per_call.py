"""Host milliseconds per call in the serializer and entropy stage: the
benchmark's spans around it (the driver's ``STAGES["entropy"]``, such as
``color_to_bytes`` and ``bytes_to_color``), summed over the window's
calls."""


def read(run):
    s = sum(run.spans.get(k, 0.0) for k in run.stages.get("entropy", ()))
    return s * 1e3 / run.calls if s > 0 and run.calls else None
