"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file."""

import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names += [w["name"], w["config"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])


def test_metrics_follow_the_contract(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        assert "setup_s" in [m["name"] for m in harness.metrics_of(bench, w, False)]
        assert len(harness.metrics_of(bench, w, False)) >= 2
        assert harness.metrics_of(bench, w, True)


def test_every_cell_resolves_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        conf = harness.read_json("configs", c["name"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert conf["floor_bytes_per_px"] > 0
    used = set()
    for w in bench["workloads"]:
        cell = harness.read_json("cells", w["name"])
        assert cell["config"] == w["config"] in configs
        used.add(w["config"])
        for kind, key in (("traffic", "driver"), ("inputs", "inputs"), ("compare", "compare")):
            assert (harness.HERE / kind / f"{cell[key]}.py").is_file(), (kind, cell[key])
        assert cell["sample"] >= 1 and cell["pool"] >= 1 and cell["warmup_calls"] >= 1
        assert set(cell["trace"]) == {"lead_s", "max_s", "min_calls", "max_calls"}
        assert cell["trace"]["lead_s"] < bench["run_seconds"]
        assert len(cell["test_shape"]) == len(harness.read_json("configs", w["config"])["shape"])
        traffic = harness.load("traffic", cell["driver"])
        assert {"ANSWER_FROM", "ENTRIES", "STAGES", "pageable_bytes"} <= set(vars(traffic)), cell["driver"]
        for m in harness.metrics_of(bench, w["name"], False) + harness.metrics_of(bench, w["name"], True):
            assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    assert used == set(configs)


def test_peaks_name_the_card_and_its_bandwidth():
    peaks = json.loads((harness.HERE / "peaks.json").read_text())
    assert peaks["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"] == 3.35e12
