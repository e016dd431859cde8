"""Nothing the benchmark runs may load JAX or the reference package, and
the plain reference may load nothing of the system under test."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from perfbench import harness

HERE = pathlib.Path(harness.__file__).resolve().parent


def _imports(path: pathlib.Path) -> set:
    """Top-level names of every module a file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_reference_package(path):
    assert not _imports(path) & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")) + sorted((HERE / "compare").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_and_comparisons_import_nothing_of_the_system(path):
    assert "tpudct_torch" not in _imports(path), path


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpudct_torch_fake.sub", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpudct.models", object())
    assert harness.forbidden_modules() == ["tpudct"]


def test_a_run_imports_neither_jax_nor_the_reference_package():
    code = ("import sys; sys.path.insert(0, %r); import torch; from perfbench import harness; "
            "import tpudct_torch.models.dispatch, tpudct_torch.models.color, tpudct_torch.utils.serialize; "
            "[harness.load(k, n) for k, n in (('traffic', 'gray_device'), ('traffic', 'color_file'), "
            "('compare', 'color_roundtrip'), ('inputs', 'photo_rgb'))]; "
            "print(harness.forbidden_modules())") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=harness.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def _run(args, cwd, tmp_path, hide_card=True):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(HOME=str(tmp_path), TMPDIR=str(tmp_path))
    if hide_card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120, check=False)


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    out = _run(["--workload", "gray8192.device", "--seed", str(2**31 + 7), "--seconds", "1",
                "--trace", "0"], harness.ROOT, tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_beside_only_its_own_files_the_run_fails(tmp_path):
    import shutil

    shutil.copytree(HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(["--workload", "gray8192.device", "--seed", "1", "--seconds", "1", "--trace", "0"],
               tmp_path, tmp_path, hide_card=False)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # on the card the system's package is what is missing; here, the card
    assert "tpudct_torch" in out.stderr or "CUDA card" in out.stderr
