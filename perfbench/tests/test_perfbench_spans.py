"""``perfbench/spans.py``: the readings of the port's registry, on planted
snapshots and device intervals, and over each cell's traffic on the CPU at
its ``test_shape``, with what its traffic driver says a call opens and
moves."""

import pytest
import torch

from perfbench import harness
from perfbench import spans as S

P = "tpudct_torch."


def _span(count, total, self_s=None, kept_s=0.0):
    return {"count": count, "total_s": total, "self_s": total if self_s is None else self_s,
            "kept": int(kept_s > 0), "kept_s": kept_s}


def test_readings_of_a_planted_snapshot():
    snap = {"spans": {P + "entry.encode_gray_auto": _span(4, 0.040, 0.004),
                      P + "entry.decode_gray_auto": _span(4, 0.060, 0.002),
                      P + "to_device": _span(8, 0.050), P + "to_host": _span(4, 0.030),
                      P + "entropy.trial.xz": _span(4, 0.300), P + "entropy.trial.rans": _span(4, 0.020, kept_s=0.020),
                      P + "entropy.encode.rans": _span(2, 0.080, kept_s=0.080),
                      P + "entropy.decode.rans": _span(6, 0.5), P + "entropy.pack": _span(4, 0.1)},
            "counters": {P + "bytes.pageable": 4 * 3 * 2**20}, "records": []}
    r = S.readings(snap, 4)
    assert r["dispatch_self_ms_per_call"] == pytest.approx(1.5)
    assert r["pageable_mib_per_call"] == 3.0
    assert r["staging_ms_per_call"] == pytest.approx(20.0)
    # decodes and the shared pack are neither kept nor lost
    assert r["entropy_useful_pct"] == pytest.approx(100 * 0.1 / 0.4)
    assert S.readings({"spans": {}, "counters": {}, "records": []}, 4) == dict.fromkeys(r)


def test_layout_time_is_the_kernels_inside_the_pad_and_layout_ranges():
    ann = [(P + "pad", 100.0, 300.0), (P + "layout", 400.0, 450.0), (P + "entry.roundtrip_color_auto", 0.0, 900.0)]
    dev = [("index_elementwise_kernel", 100.0, 250.0), ("elementwise_kernel", 240.0, 300.0),
           ("Memcpy DtoD (Device -> Device)", 400.0, 450.0), ("Memset (Device)", 440.0, 460.0),
           ("k_color_split", 500.0, 600.0)]
    # 100..300 covered once, the memset's 440..450; the copy and the split outside
    assert S.layout_ms_per_call(ann, dev, 2) == pytest.approx((200 + 10) / 1e3 / 2)
    assert S.layout_ms_per_call(ann[2:], dev, 2) is None


@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]])
def test_each_cell_reads_its_spans_on_the_cpu(name, monkeypatch):
    """The CPU stands in for a card so that the host cells' copies count:
    each call moves exactly its bytes."""
    from tpudct_torch.models import dispatch

    monkeypatch.setattr(dispatch, "_is_card", lambda dev: True)
    bench = harness.benchmark()
    cell = harness.read_json("cells", name)
    config = harness.read_json("configs", harness.workload(bench, name)["config"])
    config["shape"] = cell["test_shape"]
    cell["warmup_calls"] = 1
    traffic = harness.load("traffic", cell["driver"])
    r = S.measure(name, 2**31 + 5, 2, 1, torch.device("cpu"), cell=cell, config=config)
    assert 0 < r["dispatch_self_ms_per_call"] <= r["harness_ms_per_call"][S.CALL]
    for entry in traffic.ENTRIES:
        assert r["spans_ms_per_call"][f"entry.{entry}"]["count"] == 1, entry
    pageable = traffic.pageable_bytes(config)
    assert r["pageable_mib_per_call"] == (None if pageable is None else pageable / 2**20)
    assert (r["staging_ms_per_call"] is None) == (pageable is None)
    entropy = "entropy" in traffic.STAGES
    assert (r["entropy_useful_pct"] is None) == (not entropy)
    if entropy:
        assert 0 < r["entropy_useful_pct"] < 100
    assert r["profiled_calls"] == 1 and r["layout_ms_per_call"] is None  # no device ranges here
    assert r["breakdown"]["idle_gaps"]


def test_the_cost_blocks_alternate_and_pair_up():
    from perfbench import tracing_cost

    order, a, b = [], iter([10.0, 12.0, 11.0, 13.0]), iter([11.0, 12.5, 12.0, 12.0])

    def first():
        order.append("a")
        return next(a)

    def second():
        order.append("b")
        return next(b)

    r = tracing_cost.alternate(4, first, second)
    assert order == ["a", "b", "b", "a", "a", "b", "b", "a"]
    assert r["second_slower"] == 3 and r["second_minus_first"]["n"] == 4
    assert r["first"]["median"] == 11.5 and r["second"]["median"] == 12.0
