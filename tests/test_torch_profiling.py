"""The port's span and counter registry (``tpudct_torch.utils.profiling``)
and the spans and counters the library records, on the CPU at small
shapes."""

from __future__ import annotations

import threading
import tracemalloc
import types

import numpy as np
import pytest
import torch

from tpudct_torch import CodecConfig, get_pipeline
from tpudct_torch.models import color, dispatch
from tpudct_torch.utils import profiling, serialize, streaming

P = profiling.PREFIX


@pytest.fixture
def registry():
    """The registry on and empty; off and empty afterwards."""
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


def _clock(monkeypatch, ticks):
    """perf_counter_ns of the registry reads ``ticks`` in turn."""
    it = iter(ticks)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=lambda: next(it)))


def _frame(h: int, w: int, seed: int = 3) -> np.ndarray:
    """A smooth RGB frame with a little noise: every codec codes it small."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 60 * np.sin(xx / 9.0 + k) * np.cos(yy / 13.0) for k in range(3)], -1)
    return np.clip(base + rng.normal(0, 2, base.shape), 0, 255).astype(np.uint8)


def test_off_records_nothing_and_allocates_nothing():
    profiling.disable()
    profiling.reset()
    assert profiling.span("a") is profiling.span("b")
    tracemalloc.start()
    try:
        for _ in range(1000):
            with profiling.span("pad"):
                profiling.count("bytes.pageable", 10)
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, profiling.__file__)])
    finally:
        tracemalloc.stop()
    assert snap.statistics("lineno") == []
    assert profiling.snapshot() == {"spans": {}, "counters": {}, "records": []}


def test_nesting_gives_the_self_time(registry, monkeypatch):
    _clock(monkeypatch, [0, 10, 40, 50, 55, 100])
    with registry.span("outer") as outer:
        with registry.span("inner"):
            pass
        with registry.span("inner"):
            pass
    snap = registry.snapshot()["spans"]
    assert snap[P + "outer"]["total_s"] == pytest.approx(100e-9)
    assert snap[P + "outer"]["self_s"] == pytest.approx(65e-9)  # 100 - 30 - 5
    assert snap[P + "inner"]["count"] == 2
    assert snap[P + "inner"]["total_s"] == snap[P + "inner"]["self_s"] == pytest.approx(35e-9)
    recs = registry.snapshot()["records"]
    assert [r["name"] for r in recs] == [P + "inner", P + "inner", P + "outer"]
    assert all(r["root"] == outer.id for r in recs)
    assert [r["parent"] for r in recs] == [outer.id, outer.id, None]


def test_children_on_workers_cover_their_union(registry, monkeypatch):
    """Two children that overlap (as trials on a pool do) cover their union
    of the parent, not their sum."""
    _clock(monkeypatch, [0, 10, 20, 60, 70, 100])
    with registry.span("parent"):
        a, b = registry.span("child"), registry.span("child")
        with a:  # enters at 10
            with b:  # 20 .. 60
                pass
        # a ends at 70
    spans = registry.snapshot()["spans"]
    assert spans[P + "parent"]["self_s"] == pytest.approx(40e-9)  # 100 - (70 - 10)


def test_a_worker_trial_names_its_callers_span(registry):
    c = np.zeros((64, 128), np.int16)
    c[::8, ::8] = np.arange(128, dtype=np.int16).reshape(8, 16)
    with registry.span("caller") as caller:
        serialize._exact_auto(c, 6, 1)
    trials = [r for r in registry.snapshot()["records"] if r["name"].startswith(P + "entropy.trial.")]
    names = {r["name"] for r in trials}
    assert P + "entropy.trial.xz" in names and P + "entropy.trial.spectral" in names
    assert all(r["parent"] == caller.id and r["root"] == caller.id for r in trials)
    here = threading.get_ident()
    assert {r["name"] for r in trials if r["thread"] != here} >= {P + "entropy.trial.xz"}
    assert [r["name"] for r in trials if r["thread"] == here] == [P + "entropy.trial.spectral"]


@pytest.mark.parametrize("codec", ["auto", "auto-exact"])
def test_the_kept_trial_is_the_codec_in_the_stream(registry, codec):
    c = np.zeros((64, 128), np.int16)
    c[::8, ::8] = 7
    data = serialize.coefficients_to_bytes(c, codec=codec)
    kept = [r["name"] for r in registry.snapshot()["records"] if r["kept"]]
    chosen = serialize.inspect_stream(data)["codec"]
    assert P + f"entropy.trial.{chosen}" in kept
    spans = registry.snapshot()["spans"]
    assert spans[P + f"entropy.trial.{chosen}"]["kept"] == 1
    assert sum(v["kept"] for k, v in spans.items() if ".trial." in k) == 1


def test_the_sampled_estimate_keeps_the_real_encode(registry):
    rng = np.random.default_rng(5)
    c = (rng.laplace(0, 1.5, (768, 1024)) * (rng.random((768, 1024)) < 0.2)).astype(np.int16)
    code, payload = serialize._encode_payload(c, "auto", 6, sampled_auto=True)
    spans = registry.snapshot()["spans"]
    name = serialize._CODEC_NAMES[code]
    assert spans[P + f"entropy.encode.{name}"] == {**spans[P + f"entropy.encode.{name}"], "count": 1, "kept": 1}
    assert spans[P + "entropy.sample"]["count"] == 1
    assert all(v["kept"] == 0 for k, v in spans.items() if ".trial." in k)
    assert serialize._decode_payload(payload, code, *c.shape).tolist() == c.tolist()


def test_counters_and_reset(registry):
    registry.count("bytes.pageable", 5)
    registry.count("bytes.pageable", 7)
    registry.count("streaming.h2d", 0.25)
    with registry.span("pad"):
        pass
    snap = registry.snapshot()
    assert snap["counters"] == {P + "bytes.pageable": 12, P + "streaming.h2d": 0.25}
    assert snap["spans"][P + "pad"]["count"] == 1 and len(snap["records"]) == 1
    registry.reset()
    assert registry.snapshot() == {"spans": {}, "counters": {}, "records": []}
    assert registry._on


def test_a_span_is_a_record_function_range_under_the_profiler(registry):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with registry.span("layout"):
            torch.ones(64).cumsum(0)
    assert P + "layout" in {e.name for e in prof.events()}
    # and trace() turns the registry on for its block, then restores it
    registry.disable()
    with profiling.trace() as prof:
        with profiling.span("pad"):
            torch.ones(8).sum()
    assert P + "pad" in {e.name for e in prof.events()}
    assert not profiling._on


def test_a_gray_pair_counts_exactly_its_pageable_bytes(registry, monkeypatch):
    """encode_gray_auto and decode_gray_auto of a host array, the CPU
    standing in for a card: the image in, the int8 coefficients in, the
    reconstruction out, each once."""
    monkeypatch.setattr(dispatch, "_is_card", lambda dev: True)
    p, cfg = get_pipeline("hp"), CodecConfig()
    img = np.random.default_rng(1).integers(0, 256, (64, 256), dtype=np.uint8)
    c, hw = dispatch.encode_gray_auto(p, img, cfg, device="cpu")
    c = c.numpy()
    r = dispatch.decode_gray_auto(p, c, cfg, hw, device="cpu")
    snap = registry.snapshot()
    assert snap["counters"] == {P + "bytes.pageable": img.nbytes + c.nbytes + r.nbytes}
    spans = snap["spans"]
    assert spans[P + "to_device"]["count"] == 2 and spans[P + "to_host"]["count"] == 1
    assert spans[P + "entry.encode_gray_auto"]["count"] == spans[P + "entry.decode_gray_auto"]["count"] == 1
    roots = {r["name"] for r in snap["records"] if r["parent"] is None}
    assert roots == {P + "entry.encode_gray_auto", P + "entry.decode_gray_auto"}


def test_on_the_cpu_nothing_crosses(registry):
    p, cfg = get_pipeline("hp"), CodecConfig()
    img = np.random.default_rng(2).integers(0, 256, (40, 100), dtype=np.uint8)
    c, r = dispatch.roundtrip_gray(p, img, cfg, device="cpu")
    snap = registry.snapshot()
    assert snap["counters"] == {}
    # the ragged image pads to the u8 grid, inside the entry span
    pad = [x for x in snap["records"] if x["name"] == P + "pad"]
    entry = [x for x in snap["records"] if x["name"] == P + "entry.roundtrip_gray"]
    assert len(pad) == 1 and len(entry) == 1 and pad[0]["parent"] == entry[0]["id"]
    s = snap["spans"][P + "entry.roundtrip_gray"]
    assert s["self_s"] == pytest.approx(s["total_s"] - snap["spans"][P + "pad"]["total_s"])


def test_color_bytes_and_outputs_equal_with_tracing_on_and_off():
    p, cfg = get_pipeline("hp"), CodecConfig()
    rgb = _frame(64, 256)

    def once():
        planes, meta = color.encode_color_auto(p, rgb, cfg, subsample="420", device="cpu")
        planes = {k: v.numpy().copy() for k, v in planes.items()}
        data = serialize.color_to_bytes(planes, meta, codec="auto")
        back, bmeta = serialize.bytes_to_color(data)
        out = color.decode_color_auto(p, back, bmeta, cfg, device="cpu").numpy().copy()
        return planes, data, out

    profiling.disable()
    profiling.reset()
    off = once()
    profiling.enable()
    try:
        on = once()
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    assert on[1] == off[1]
    assert all(np.array_equal(on[0][k], off[0][k]) for k in ("y", "cb", "cr"))
    assert np.array_equal(on[2], off[2])
    chosen = [pl["codec"] for pl in serialize.inspect_stream(on[1])["planes"]]
    kept = [r["name"].rsplit(".", 1)[1] for r in snap["records"]
            if r["kept"] and ".trial." in r["name"]]
    assert kept == chosen
    assert snap["spans"][P + "entry.encode_color_auto"]["count"] == 1
    assert {P + f"entropy.decode.{c}" for c in chosen} <= set(snap["spans"])


def test_streaming_parts_are_spans_and_counters(registry):
    p, cfg = get_pipeline("hp"), CodecConfig()
    img = np.random.default_rng(4).integers(0, 256, (128, 128), dtype=np.uint8)
    streaming.roundtrip_u8_streamed(p, img, cfg, band_rows=32, device="cpu")
    parts = streaming.seconds(registry.snapshot())
    assert set(parts) == {"stage", "finish"} and all(v >= 0 for v in parts.values())
    assert registry.snapshot()["spans"][P + "streaming.stage"]["count"] == 4
