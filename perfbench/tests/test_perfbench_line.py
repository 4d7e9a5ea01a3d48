"""The result line: only the contract's keys, ``checks`` last; no card
means a non-zero exit and no result; so does a checkout that holds only
the benchmark."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

import perfbench.run as run
from perfbench.common import ROOT, Check, Outcome, Trace, load_cell
from perfbench.tests.tiny_cells import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _outcome():
    tr = Trace(kernels=[("k1", 0, 5), ("k2", 10, 5)], host=[("x", 4, 10)],
               window_s=2e-8, units=2)
    return Outcome(e2e={"md_ns_per_day": 1.5}, setup_end=run.T0 + 3.0,
                   attempted=10, failed=0, memory_peak_bytes=7,
                   readings={"energy_gap": 0.0, "force_gap": 0.0,
                             "replay_gap": 0.0},
                   counters={"units": 2, "rebuilds": 1,
                             "peak": "fp32", "forwards": [], "dims": None},
                   trace=tr)


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(monkeypatch, trace):
    cell = load_cell("md-fp32-r128")
    drv = type("D", (), {"run": staticmethod(lambda *a, **k: _outcome())})
    monkeypatch.setattr(run, "__name__", "perfbench.run")
    import perfbench.common as common
    real = common.load_module

    def fake(kind, name):
        return drv if kind == "drivers" else real(kind, name)
    monkeypatch.setattr(common, "load_module", fake)
    line, checks = run.run_cell(cell.name, 1, 1.0, trace,
                                torch.device("cpu"))
    keys = list(line)
    assert keys[-1] == "checks"
    assert keys[:5] == KEYS
    assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
    assert ("breakdown" in keys) == trace
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["busy_s"] > 0
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {"md_ns_per_day", "setup_s"}
        assert line["metrics"]["setup_s"]["value"] == pytest.approx(3.0)
    assert all(isinstance(c, Check) for c in checks)
    json.dumps(line)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "md-w4a8-r128", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_is_no_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch\n"
            f"sys.path.insert(0, {str(tmp_path)!r})\n"
            "import perfbench.run as r\n"
            "line, _ = r.run_cell('md-fp32-r128', 1, 0.1, False,"
            " torch.device('cpu'))\n"
            "print(line)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


def test_tiny_run_line_is_json():
    cell = tiny("md-fp32-r128")
    from perfbench.common import load_module
    out = load_module("drivers", "md").run(cell, 2 ** 31 + 3, 0.2, True,
                                           torch.device("cpu"))
    vals = run.metric_values(cell, out, True)
    for name, v in vals.items():
        assert set(v) == {"value", "unit"} and v["value"] == v["value"]
    json.dumps(vals)
