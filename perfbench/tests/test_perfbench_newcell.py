"""A cell and a per-layer metric on the port's registry are added with new
files and entries in ``BENCHMARK.json`` only: on a copy of the benchmark
that holds them, the copy's own tests of the contract, of a small CPU run
(untraced and traced), of a broken timed path and of the bfloat16 control
pass for the new cell, the new metric is reported, and no file that was
there changes."""

import json
import os
import shutil
import subprocess
import sys

from perfbench import harness

CONFIG = "grayprobe"
CELL = "grayprobe.device"
METRIC = "entry_spans_per_call"
READER = '''"""The port's entry spans a call opens, from the registry's snapshot."""


def read(run):
    if run.registry is None or not run.registry_calls:
        return None
    n = sum(v["count"] for k, v in run.registry["spans"].items() if ".entry." in k)
    return n / run.registry_calls if n else None
'''
IGNORED = ("__pycache__", ".cache")


def _files(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and not set(p.relative_to(root).parts) & set(IGNORED)}


def _gray_device_cell():
    """The first cell on the ``gray_device`` driver, and its configuration."""
    for w in harness.benchmark()["workloads"]:
        cell = harness.read_json("cells", w["name"])
        if cell["driver"] == "gray_device":
            return cell, harness.read_json("configs", w["config"])
    raise LookupError("no cell runs the gray_device driver")


def _add_cell_and_metric(top):
    here = top / "perfbench"
    cell, conf = _gray_device_cell()
    conf.update(name=CONFIG, shape=[2048, 2048],
                source=f"{conf['name']}'s deployment at 2048x2048, a planted configuration of this test")
    (here / "configs" / f"{CONFIG}.json").write_text(json.dumps(conf, indent=2))
    cell = dict(cell, config=CONFIG, test_shape=[128, 256])
    (here / "cells" / f"{CELL}.json").write_text(json.dumps(cell, indent=2))
    (here / "metrics" / f"{METRIC}.py").write_text(READER)
    bench = json.loads((top / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONFIG, "source": conf["source"], "file": f"perfbench/configs/{CONFIG}.json",
                             "reduced": [], "why": "a planted configuration"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "device", "chips": 1,
                               "why": "a planted cell on the gray_device driver"})
    bench["per_layer"].append({"name": METRIC, "unit": "1", "better": "lower", "source": "program_span",
                               "layer": "library entry and dispatch", "moves": "mpx_per_s", "workloads": [CELL]})
    (top / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns(*IGNORED))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _files(tmp_path)
    _add_cell_and_metric(tmp_path)

    tests = "perfbench/tests/"
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))  # the port, behind the copy's own perfbench
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-rA",
         tests + "test_perfbench_contract.py", tests + "test_perfbench_harness.py", tests + "test_perfbench_control.py",
         "-k", f"test_perfbench_contract or {CELL}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600, check=False)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = [line.split(" ", 1)[1] for line in out.stdout.splitlines() if line.startswith("PASSED ")]
    for test in ("test_a_sound_run_is_correct", "test_a_traced_run_reports_the_stretch",
                 "test_a_traced_run_hands_the_run_the_registry", "test_a_broken_timed_path_is_not_correct",
                 "test_the_bfloat16_control_fails_a_limit", "test_every_cell_resolves_by_name"):
        assert any(test in p for p in passed), (test, out.stdout[-3000:])
    assert all(CELL in p or "test_perfbench_contract" in p for p in passed)
    # the traced run reported the new metric, read by the new file alone
    assert any(f"test_a_traced_run_reports_the_stretch[{CELL}]" in p for p in passed)

    after = _files(tmp_path)
    changed = sorted(k for k in before if after.get(k) != before[k])
    assert changed == ["BENCHMARK.json"], changed
    assert sorted(set(after) - set(before)) == [f"perfbench/cells/{CELL}.json", f"perfbench/configs/{CONFIG}.json",
                                                f"perfbench/metrics/{METRIC}.py"]
