"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""
import json
import re

import pytest

from perfbench.common import HERE, ROOT, load_cell, load_json, load_module

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "perfbench/run.py"]
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in BENCH["configs"])) \
        == len(BENCH["configs"])
    assert len(set(WORKLOADS)) == len(WORKLOADS)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_setup_and_metric_coverage():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in WORKLOADS:
        cell = load_cell(w)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w
        for m in cell.per_layer:
            assert m["moves"] in reported, (w, m["name"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_files_found_by_name(workload):
    cell = load_cell(workload)
    assert (HERE / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert callable(load_module("drivers", cell.traffic["driver"]).run)
    for m in cell.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_configs_are_unique_files_with_their_cuts():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        data = load_json(ROOT / c["file"])
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] == []
        assert data["assumed"] == []
        used = [w for w in BENCH["workloads"] if w["config"] == c["name"]]
        assert used, c["name"]


def test_roofline_entries_name_patterns():
    for path in sorted((HERE / "rooflines").glob("*.py")):
        entry = load_module("rooflines", path.stem)
        re.compile(entry.PATTERN)
        assert callable(entry.work)


def test_every_file_name_is_made_of_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
