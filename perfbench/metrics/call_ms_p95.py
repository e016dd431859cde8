"""The 95th percentile of the window's call times, every call counted, each
call timed by CUDA events recorded before and after it (the device's
clock); linear interpolation between ranks."""


def percentile(values, q: float) -> float:
    v = sorted(values)
    x = (len(v) - 1) * q / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def read(run):
    return percentile(run.call_ms, 95.0) if run.call_ms else None
