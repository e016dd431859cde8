"""Host milliseconds per call in the container's dtype casts: the total
time of the port's ``entropy.narrow`` (a map's bound scan and int16 copy
on its way into the bytes) and ``entropy.widen`` (the decoded map's
float32 copy) spans, from the registry's snapshot of a traced run over
the harness's ``REGISTRY_S`` of calls before the window, read as
``dispatch_self_ms_per_call`` reads it."""

SPANS = ("tpudct_torch.entropy.narrow", "tpudct_torch.entropy.widen")


def read(run):
    if run.registry is None or not run.registry_calls:
        return None
    got = [run.registry["spans"][k]["total_s"] for k in SPANS if k in run.registry["spans"]]
    return sum(got) * 1e3 / run.registry_calls if got else None
