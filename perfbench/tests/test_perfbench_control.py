"""The control of each cell's comparison: the plain reference in the
system's place, computed in bfloat16 (the precision below the float32 the
configurations state), has to come out not correct.  On the CPU at the
cell's ``test_shape``; on the card (marked ``card``) at the cell's own size,
through ``perfbench/control.py``."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _parts(name):
    cell = harness.read_json("cells", name)
    config = harness.read_json("configs", cell["config"])
    return cell, config, harness.load("compare", cell["compare"]), harness.load("inputs", cell["inputs"])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_bfloat16_control_fails_a_limit(name, seed):
    cell, config, compare, gen = _parts(name)
    x = gen.make(seed, 2, tuple(cell["test_shape"]), torch.device("cpu"))
    answers = [(k, compare.reference_answer(x[k], config["codec"], torch.bfloat16)) for k in range(2)]
    nums = compare.numbers(answers, lambda k: x[k], config["codec"], torch.device("cpu"))
    assert any(v > cell["limits"][k] for k, v in nums.items()), nums


@pytest.mark.parametrize("name", CELLS)
def test_the_float64_reference_in_the_system_place_is_exact(name):
    cell, config, compare, gen = _parts(name)
    x = gen.make(5, 1, tuple(cell["test_shape"]), torch.device("cpu"))
    nums = compare.numbers([(0, compare.reference_answer(x[0], config["codec"], torch.float64))],
                           lambda k: x[k], config["codec"], torch.device("cpu"))
    assert all(v == 0 for v in nums.values()), nums


@pytest.mark.card
def test_the_control_fails_at_the_cells_size_on_the_card(card):
    for name in CELLS:
        out = subprocess.run([sys.executable, "perfbench/control.py", "--workload", name, "--seeds", "21"],
                             cwd=harness.ROOT, capture_output=True, text=True, timeout=600, check=False)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert not all(line["within_limits"].values()), line


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gray8192.device",
                          "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600, check=False)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["metrics"]["mpx_per_s"]["value"] > 0
