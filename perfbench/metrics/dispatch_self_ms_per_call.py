"""Host milliseconds per call in the port's library entry and dispatch: the
self time of its ``entry.<fn>`` spans (each span's time less its children's
``pad``, ``layout``, ``to_device``, ``to_host``, ``wait`` and entropy
spans), from the registry's snapshot of a traced run over the harness's
``REGISTRY_S`` of calls before the window, read as ``perfbench/spans.py``
reads it."""

from perfbench import spans


def read(run):
    if run.registry is None or not run.registry_calls:
        return None
    return spans.readings(run.registry, run.registry_calls)["dispatch_self_ms_per_call"]
