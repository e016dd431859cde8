"""The gray ``.tdc`` cell's own parts: the lossless comparison of the
container, the photo-like gray inputs, and the reader of the container's
dtype casts.  On the CPU at the cell's ``test_shape``."""

import time

import numpy as np
import pytest
import torch

from perfbench import harness

CELL = "gray8192.tdc"
P = "tpudct_torch."


def run_small(seconds=0.2, seed=2**31 + 77):
    bench = harness.benchmark()
    cell = harness.read_json("cells", CELL)
    config = harness.read_json("configs", harness.workload(bench, CELL)["config"])
    config["shape"] = cell["test_shape"]
    cell["warmup_calls"] = 1
    return harness.run_cell(CELL, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                            bench=bench, cell=cell, config=config)


def _flip(field):
    """What a faulty parser returns in place of ``bytes_to_coefficients``'s
    (coeffs, q_scale, retain_k, orig_shape, transform, q_table)."""
    def fault(out):
        coeffs, q_scale, retain_k, orig, transform, q_table = out
        if field == "coefficient":
            coeffs = coeffs.copy()
            coeffs[9, 17] += 1
        elif field == "orig_shape":
            orig = (orig[0] - 8, orig[1])
        elif field == "q_scale":
            q_scale = q_scale * 1.5
        elif field == "transform":
            transform = "rdct"
        elif field == "q_table":
            q_table = "chroma"
        return coeffs, q_scale, retain_k, orig, transform, q_table
    return fault


@pytest.mark.parametrize("field", ["coefficient", "orig_shape", "q_scale", "transform", "q_table"])
def test_a_parser_that_changes_one_value_is_not_correct(monkeypatch, field):
    from tpudct_torch.utils import serialize

    real, fault = serialize.bytes_to_coefficients, _flip(field)
    monkeypatch.setattr(serialize, "bytes_to_coefficients", lambda *a, **k: fault(real(*a, **k)))
    r = run_small()
    assert r["checks"]["stream_diff_count"]["value"] >= 1, r["checks"]
    assert not r["correct"]


def test_the_stream_count_counts_each_coefficient_and_header_field():
    compare = harness.load("compare", "gray_file")
    codec = harness.read_json("configs", "gray8192photo")["codec"]
    x = harness.load("inputs", "photo_gray").make(3, 1, (64, 128), torch.device("cpu"))
    sound = compare.reference_answer(x[0], codec, torch.float64)
    back = sound["coeffs_back"].clone()
    back[0, :3] += 2
    bad = dict(sound, coeffs_back=back, header=dict(sound["header"], q_scale=1.25, q_table="chroma"))
    nums = compare.numbers([(0, sound), (0, bad)], lambda k: x[k], codec, torch.device("cpu"))
    assert nums["stream_diff_count"] == 3 + 2
    assert nums["coef_diff_share"] == 3 / (2 * back.numel()) and nums["coef_max_diff"] == 2


def test_photo_gray_gives_every_seed_the_same_scenes():
    gen = harness.load("inputs", "photo_gray")
    shape, cpu = (96, 128), torch.device("cpu")
    scenes = [gen.scene(k, *shape, cpu) for k in range(4)]
    a, b = gen.make(2**31 + 5, 4, shape, cpu), gen.make(2**31 + 6, 4, shape, cpu)
    assert a.shape == (4, *shape) and a.dtype == torch.uint8
    assert torch.equal(a, gen.make(2**31 + 5, 4, shape, cpu)) and not torch.equal(a, b)

    def order(frames):
        """Each frame's scene: the one it lies within sensor noise of."""
        gaps = [[float((f.float() - s.clamp(0, 255)).abs().mean()) for s in scenes] for f in frames]
        assert all(sorted(g)[0] < 2.5 < sorted(g)[1] for g in gaps), gaps  # sigma 2 noise: mean |n| 1.6
        return [int(np.argmin(g)) for g in gaps]

    assert sorted(order(a)) == sorted(order(b)) == [0, 1, 2, 3]
    # the same scene in two seeds differs by its noise alone
    k = order(a)[0]
    same = b[order(b).index(k)]
    assert 0 < float((a[0].float() - same.float()).abs().mean()) < 4


def test_container_cast_time_reads_the_two_spans_of_the_registry():
    def span(total):
        return {"count": 4, "total_s": total, "self_s": total, "kept": 0, "kept_s": 0.0}

    snap = {"spans": {P + "entropy.narrow": span(0.2), P + "entropy.widen": span(0.6),
                      P + "entropy.encode.rans": span(3.0), P + "entry.decode_gray_auto": span(1.0)},
            "counters": {}, "records": []}
    base = dict(config={}, setup_s=1.0, window_s=1.0, calls=1, pixels=1, call_ms=[], stats={}, spans={},
                trace=None, peaks=None)
    read = harness.load("metrics", "container_cast_ms_per_call").read
    assert read(harness.Run(**base, registry=snap, registry_calls=4)) == pytest.approx(200.0)
    assert read(harness.Run(**base)) is None  # an untraced run: no registry
    assert read(harness.Run(**base, registry=snap, registry_calls=0)) is None
    assert read(harness.Run(**base, registry={"spans": {}, "counters": {}}, registry_calls=4)) is None
