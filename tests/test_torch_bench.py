"""``python3 -m tpudct_torch.bench``, the port's headline entry point, against
the reference's ``bench.py`` on the CPU.

On the CPU ``main(size, device="cpu")`` gates the plain twins and times the
f32 pair on the host clock, so no number here is a device time; what must
agree with the reference is the contract: one JSON line on stdout with the
reference's four keys and metric string (``vs_baseline`` = 29.4 / value,
rounded as the line prints it), the gate reports on stderr with the
reference's families and keys, and one ``{"error": ...}`` line with exit 1
on a wrong pipeline, a gate that raises, a missing card or a hang.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

import bench as RB
import tpudct
import tpudct_torch
from test_torch_jpegcoef import registries  # noqa: F401  (the shared registry fixture)
from tpudct_torch import bench, selftest
from tpudct_torch.utils.jpegcoef import coef_io_available

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(autouse=True)
def _no_watchdog(monkeypatch):
    """No watchdog thread in the test process (it would end the process)."""
    monkeypatch.setenv("TPUDCT_BENCH_TIMEOUT", "0")
    monkeypatch.delenv("TPUDCT_GATE", raising=False)


def _run(capsys, **kw) -> tuple:
    """(rc, stdout lines, stderr records) of bench.main(**kw)."""
    rc = bench.main(**kw)
    out, err = capsys.readouterr()
    return rc, out.splitlines(), [json.loads(line) for line in err.splitlines()]


def _headline(lines: list, size: int) -> dict:
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert set(rec) == KEYS and rec["unit"] == "ms"
    assert rec["metric"] == f"{size}x{size} DCT+quant+IDCT ms/image per chip"  # bench.py:448
    assert rec["value"] > 0 and rec["vs_baseline"] == round(29.4 / rec["value"], 2)
    return rec


def test_main_prints_one_headline_line_after_the_gates(capsys, registries):
    rc, out, err = _run(capsys, size=256, device="cpu")
    assert rc == 0
    _headline(out, 256)
    fams = ["color420_u8", "f32", "scaled", "streamed_gray", "streamed_color", "jpg_import"]
    assert [r.get("family") for r in err[:-1]] == [None, *fams]
    assert err[0]["size"] == 512 and err[0]["path"] == "u8"  # bench.py's gate size, on the twins
    assert all(r["gate"] == "pass" for r in err[:-2])
    assert err[-2]["gate"] == ("pass" if coef_io_available() else "skip")
    assert {k: err[-1].pop(k) for k in ("device", "card")} == {"device": "cpu", "card": None}
    assert set(err[-1]) == {"gates_s", "main_s"} and 0 < err[-1]["gates_s"] <= err[-1]["main_s"]


def test_gate_reports_carry_the_reference_keys(capsys, monkeypatch, registries):
    """batched at the gate size of test_selftest_is_the_reference (128): the
    reference's gate and families, in its order, each with its keys (the
    port's add only "device")."""
    monkeypatch.setattr(bench, "get_pipeline", lambda name: tpudct_torch.get_pipeline("batched"))
    rc, out, err = _run(capsys, size=128, device="cpu")
    assert rc == 0
    _headline(out, 128)
    rp, rcfg = tpudct.get_pipeline("batched"), tpudct.CodecConfig()
    want = [RB.correctness_gate(rp, rcfg, size=128), *RB.family_gates(rp, rcfg)]
    got = err[:-1]
    assert [r.get("family") for r in got] == [r.get("family") for r in want]
    assert [r.get("family") for r in got] == [None, "color420_u8", "f32", "scaled", "streamed", "jpg_import"]
    for g, w in zip(got, want):
        assert set(w) <= set(g) and set(g) - set(w) <= {"device"}, (g, w)
        assert g["gate"] == w["gate"]


class _OffByOne(type(tpudct_torch.get_pipeline("hp"))):
    """Coefficients one quantizer step off everywhere: a subtle miscompile
    the tie class must not absorb (tests/test_entry.py's WrongPipeline).
    The split path is wrapped too: the port's gate runs it on the CPU."""

    def roundtrip(self, image, cfg):
        c, r = super().roundtrip(image, cfg)
        return c + 1.0, r

    def roundtrip_u8(self, image_u8, cfg):
        c, r = super().roundtrip_u8(image_u8, cfg)
        return c + 1, r

    def encode_u8(self, image_u8, cfg):
        return super().encode_u8(image_u8, cfg) + 1


def test_a_wrong_pipeline_fails_before_timing(capsys, monkeypatch):
    cfg = tpudct_torch.CodecConfig()
    with pytest.raises(AssertionError) as gate:
        selftest.correctness_gate(_OffByOne(), cfg, device="cpu")
    monkeypatch.setattr(bench, "get_pipeline", lambda name: _OffByOne())
    monkeypatch.setattr(bench, "device_time_ms", lambda *a, **k: pytest.fail("a wrong pipeline was timed"))
    rc, out, err = _run(capsys, size=256, device="cpu")
    assert rc == 1 and err == []
    assert out == [json.dumps({"error": f"correctness gate failed: {gate.value}"})]


@pytest.mark.parametrize("exc", [RuntimeError, OSError, ValueError])
def test_a_gate_that_raises_gives_one_error_line(capsys, monkeypatch, exc):
    def boom(*a, **k):
        raise exc("launch failed")

    monkeypatch.setattr(selftest, "family_gates", boom)
    rc = bench.main(size=256, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 1 and "Traceback" not in out + err
    assert out.splitlines() == [json.dumps({"error": "correctness gate failed: launch failed"})]


def test_basic_gate_skips_the_families(capsys, monkeypatch):
    monkeypatch.setenv("TPUDCT_GATE", "basic")
    monkeypatch.setattr(selftest, "family_gates", lambda *a, **k: pytest.fail("families ran"))
    rc, out, err = _run(capsys, size=256, device="cpu")
    assert rc == 0 and [r.get("gate") for r in err] == ["pass", None]
    _headline(out, 256)


def _python(code_or_module: list, timeout_s: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TPUDCT_GATE")}
    env["TPUDCT_BENCH_TIMEOUT"] = timeout_s
    return subprocess.run([sys.executable, *code_or_module], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)


def test_without_a_card_the_module_prints_one_error_line():
    """This box has no CUDA device: no CPU fallback, one error line naming it."""
    run = _python(["-m", "tpudct_torch.bench"], "120")
    assert run.returncode == 1, run.stderr
    lines = run.stdout.splitlines()
    assert len(lines) == 1 and set(json.loads(lines[0])) == {"error"}
    assert "correctness gate failed: no CUDA device" in json.loads(lines[0])["error"]
    assert "Traceback" not in run.stdout + run.stderr


@pytest.mark.parametrize("cancel", [False, True])
def test_watchdog_ends_a_hung_run(cancel):
    """TPUDCT_BENCH_TIMEOUT=1 and a main that sleeps: the timeout line and
    exit 1; setting the returned event first cancels it."""
    code = ("import time; from tpudct_torch.bench import _arm_watchdog; done = _arm_watchdog(); "
            + ("done.set(); " if cancel else "") + "time.sleep(2.5); print('finished')")
    run = _python(["-c", code], "1")
    if cancel:
        assert run.returncode == 0 and run.stdout.splitlines() == ["finished"]
    else:
        assert run.returncode == 1, run.stderr
        assert run.stdout.splitlines() == [json.dumps({
            "error": "bench timed out after 1s (a kernel launch or synchronize hung, or a kernel build wedged)"})]


def test_watchdog_disarmed_at_zero():
    import threading

    n = threading.active_count()
    done = bench._arm_watchdog()  # TPUDCT_BENCH_TIMEOUT=0 (the fixture)
    assert threading.active_count() == n and not done.is_set()
