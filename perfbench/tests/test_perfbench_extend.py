"""A later cell, configuration, mix, per-layer metric and roofline entry
are new files and new entries: in a copy of the benchmark, a throwaway
cell made only of new files loads, runs on the CPU and reports its new
metric, with no file that was there edited."""
import hashlib
import json
import shutil
import subprocess
import sys

from perfbench.common import ROOT


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted((root / "perfbench").rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_of_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    pb = tmp_path / "perfbench"
    config = json.loads((pb / "configs" / "so3krates-fp32.json").read_text())
    config["name"] = "so3krates-fp32-small"
    config["model"].update(feat=16, vec_feat=4, n_layers=1, n_rbf=4,
                           cutoff=4.0, dir_bits=6)
    config["reduced"] = ["feat", "vec_feat", "n_layers", "n_rbf"]
    (pb / "configs" / "so3krates-fp32-small.json").write_text(
        json.dumps(config))
    traffic = json.loads(
        (pb / "traffic" / "md-azobenzene-r128.json").read_text())
    traffic.update(replicas=2, segment_steps=3, trace_segments=1)
    (pb / "traffic" / "md-azobenzene-r2.json").write_text(json.dumps(traffic))
    (pb / "cells" / "md-small.json").write_text(json.dumps(
        {"limits": {"energy_gap": 1e-3, "force_gap": 1e-3,
                    "replay_gap": 1e-3}}))
    (pb / "metrics" / "md.steps_traced.py").write_text(
        "def read(outcome):\n"
        "    return float(outcome.trace.units) if outcome.trace else None\n")
    (pb / "rooflines" / "never_runs.py").write_text(
        "PATTERN = r'no_such_kernel'\n\n\n"
        "def work(dims, fwd):\n    return 1.0, {}\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "so3krates-fp32-small",
                             "source": "https://arxiv.org/pdf/2603.05343",
                             "file": "perfbench/configs/"
                                     "so3krates-fp32-small.json",
                             "reduced": config["reduced"], "why": "a test"})
    bench["workloads"].append({"name": "md-small",
                               "config": "so3krates-fp32-small",
                               "traffic": "md-azobenzene-r2", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "md_ns_per_day":
            m["workloads"].append("md-small")
    bench["per_layer"].append({
        "name": "md.steps_traced", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "MD loop", "moves":
        "md_ns_per_day", "workloads": ["md-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before

    code = ("import sys, json, torch\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(tmp_path)!r}]\n"
            "torch.set_num_threads(2)\n"
            "import perfbench.run as r\n"
            f"assert r.__file__.startswith({str(tmp_path)!r})\n"
            "line, _ = r.run_cell('md-small', 2**31 + 1, 0.2, True,"
            " torch.device('cpu'))\n"
            "print(json.dumps(line))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["md.steps_traced"]["value"] == 3.0
