"""The arithmetic of the metrics on synthetic call logs and traces."""

import statistics

import pytest

from perfbench import harness
from perfbench import trace as tracing


def _run(**kw):
    base = dict(config={"floor_bytes_per_px": 3.0}, setup_s=12.5, window_s=10.0,
                calls=1000, pixels=1000 * 4096, call_ms=[], stats={}, spans={}, trace=None,
                peaks={"hbm_bytes_per_s": 3.35e12})
    base.update(kw)
    return harness.Run(**base)


def _read(name, run):
    return harness.load("metrics", name).read(run)


def test_rate_counts_every_pixel_over_the_whole_window():
    assert _read("mpx_per_s", _run()) == pytest.approx(1000 * 4096 / 10.0 / 1e6)
    assert _read("mpx_per_s", _run(calls=0, pixels=0)) is None


def test_p95_over_every_call():
    ms = [float(k) for k in range(1, 101)]  # 1..100
    assert _read("call_ms_p95", _run(call_ms=ms)) == pytest.approx(95.05)
    # agrees with the inclusive quantile of the standard library
    assert _read("call_ms_p95", _run(call_ms=ms)) == pytest.approx(
        statistics.quantiles(ms, n=20, method="inclusive")[18])
    assert _read("call_ms_p95", _run(call_ms=[7.0])) == 7.0
    assert _read("call_ms_p95", _run(call_ms=[])) is None


def test_bits_per_px_and_setup():
    assert _read("bits_per_px", _run(stats={"bytes": 512_000})) == pytest.approx(512_000 * 8 / 4_096_000)
    assert _read("bits_per_px", _run()) is None
    assert _read("setup_s", _run()) == 12.5


def _trace(device, calls=4, t0=0.0, t1=1000.0, spans=()):
    return tracing.Trace(calls, t0, t1, list(device), list(spans))


def test_union_counts_overlap_once():
    assert tracing.union([(0, 10), (5, 15), (20, 30)]) == 25
    assert tracing.union([(0, 10), (2, 3)]) == 10
    assert tracing.gaps([(10, 20), (15, 30), (50, 60)], 0, 100) == [(0, 10), (30, 50), (60, 100)]


def test_idle_share_and_roofline_and_copies():
    dev = [("void k_rt_u8<0, 0>(...)", 100.0, 300.0), ("Memcpy HtoD (Pageable -> Device)", 250.0, 500.0),
           ("Memcpy DtoH (Device -> Pageable)", 600.0, 700.0), ("Memset (Device)", 700.0, 720.0)]
    tr = _trace(dev)
    assert _read("device_idle_pct", _run(trace=tr)) == pytest.approx(100 * (1 - 520 / 1000))
    assert _read("copy_ms_per_call", _run(trace=tr)) == pytest.approx((250 + 100) / 1e3 / 4)
    # the kernel and the memset, 220 us over 4 calls, against 3 B/px x 4096 px at 3.35 TB/s
    floor = 3.0 * 4096 / 3.35e12
    assert _read("codec_roofline_pct", _run(trace=tr)) == pytest.approx(100 * floor * 4 / 220e-6)
    assert _read("codec_roofline_pct", _run(trace=tr, peaks=None)) is None
    assert tracing.kind("Memcpy DtoD (Device -> Device)") == "d2d"


def test_readers_find_nothing_without_a_trace():
    for name in ("device_idle_pct", "codec_roofline_pct", "copy_ms_per_call"):
        assert _read(name, _run()) is None
        assert _read(name, _run(trace=_trace([]))) is None, name


def test_entropy_spans_per_call():
    spans = {"color_to_bytes": 3.0, "bytes_to_color": 1.0, "encode_color_auto": 9.0}
    stages = {"entropy": ("color_to_bytes", "bytes_to_color")}
    assert _read("entropy_ms_per_call", _run(spans=spans, calls=10, stages=stages)) == pytest.approx(400.0)
    assert _read("entropy_ms_per_call", _run(spans=spans, calls=10)) is None  # a driver with no such stage
    assert _read("entropy_ms_per_call", _run(stages=stages)) is None


def test_dispatch_self_time_reads_the_registry_as_spans_py_does():
    from perfbench import spans as S

    snap = {"spans": {"tpudct_torch.entry.encode_gray_auto": {"count": 4, "total_s": 0.04, "self_s": 0.004,
                                                              "kept": 0, "kept_s": 0.0},
                      "tpudct_torch.to_device": {"count": 4, "total_s": 0.03, "self_s": 0.03, "kept": 0,
                                                 "kept_s": 0.0}},
            "counters": {}, "records": []}
    got = _read("dispatch_self_ms_per_call", _run(registry=snap, registry_calls=4))
    assert got == pytest.approx(1.0) == S.readings(snap, 4)["dispatch_self_ms_per_call"]
    assert _read("dispatch_self_ms_per_call", _run()) is None  # an untraced run: no snapshot
    assert _read("dispatch_self_ms_per_call", _run(registry=snap, registry_calls=0)) is None
    assert _read("dispatch_self_ms_per_call", _run(registry={"spans": {}, "counters": {}}, registry_calls=4)) is None


class _Event:
    def __init__(self, name, start, end, cuda=False, annotation=False):
        from torch.autograd import DeviceType

        self.name, self.is_user_annotation = name, annotation
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = type("Interval", (), {"start": start, "end": end})()


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_a_device_side_annotation_is_no_device_time():
    """A port span's range on the device's timeline, over no kernel, named as
    no harness span is: kept out of the device's intervals by its kind."""
    base = [_Event("call", 0.0, 1000.0), _Event("call", 1000.0, 2000.0),
            _Event("void k_rt_u8<0, 0>(...)", 100.0, 300.0, cuda=True),
            _Event("Memcpy DtoH (Device -> Pageable)", 1100.0, 1200.0, cuda=True),
            _Event("tpudct_torch.entry.roundtrip_gray", 10.0, 990.0)]  # the port's host-side range
    ranges = [_Event("tpudct_torch.entry.roundtrip_gray", 400.0, 900.0, cuda=True, annotation=True),
              _Event("call", 1300.0, 1900.0, cuda=True, annotation=True)]  # and the harness's
    plain = tracing.from_profiler(_Profile(base), {"call"}, "call")
    tr = tracing.from_profiler(_Profile(base + ranges), {"call"}, "call")
    assert [n for n, _, _ in tr.device] == ["void k_rt_u8<0, 0>(...)", "Memcpy DtoH (Device -> Pageable)"]
    assert tr.annotations == [("tpudct_torch.entry.roundtrip_gray", 400.0, 900.0), ("call", 1300.0, 1900.0)]
    assert tr.busy_s() == plain.busy_s() == pytest.approx(300e-6)
    assert (tr.calls, tr.t0, tr.t1) == (2, 0.0, 2000.0) and len(tr.spans) == 2
    assert _read("device_idle_pct", _run(trace=tr)) == pytest.approx(100 * (1 - 300 / 2000))


def test_breakdown_names_ops_and_the_spans_open_in_each_gap():
    dev = [("k_a", 100.0, 300.0), ("k_b", 400.0, 450.0), ("k_a", 500.0, 600.0)]
    spans = [("call", 0.0, 1000.0), ("dispatch", 0.0, 90.0), ("sync", 300.0, 980.0)]
    b = tracing.breakdown(_trace(dev, spans=spans))
    assert b["device_ops"] == [["k_a", pytest.approx(300e-6)], ["k_b", pytest.approx(50e-6)]]
    # each stretch of a gap goes to the innermost span open there
    assert dict(b["idle_gaps"]) == {"dispatch": pytest.approx(90e-6), "call": pytest.approx(30e-6),
                                    "sync": pytest.approx(530e-6)}
    b = tracing.breakdown(_trace(dev, spans=[("call", 0.0, 900.0)]))
    assert dict(b["idle_gaps"]) == {"call": pytest.approx(550e-6), "between calls": pytest.approx(100e-6)}


def test_reservoir_is_uniform_and_seeded():
    def draw(seed):
        r = harness.Reservoir(4, seed)
        for k in range(1000):
            r.offer(k)
        return sorted(r.items)

    assert draw(7) == draw(7) and draw(7) != draw(8)
    hits = [0] * 10
    for seed in range(2000):
        for v in draw(seed):
            hits[v // 100] += 1
    assert min(hits) > 0.8 * 800 and max(hits) < 1.2 * 800
