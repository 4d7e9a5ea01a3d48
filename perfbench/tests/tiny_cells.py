"""Small copies of the benchmark's cells for the CPU: the real cell's
files and limits, with the model and the traffic cut to a size a test
run holds."""
import dataclasses

from perfbench.common import HERE, Cell, load_cell, load_json

TINY_MODEL = dict(feat=16, vec_feat=4, n_layers=2, n_rbf=4, cutoff=4.0,
                  dir_bits=8)
TINY_TRAFFIC = {
    "md": dict(replicas=3, segment_steps=5, trace_segments=1),
    "qat": dict(frames=32, batch=4, dir_bits=6, lee_rotations=1,
                schedule_steps=20, trace_steps=1, trajectories=8),
    "serve": dict(rate_rps=100.0, engine_max_batch=8, max_batch=8,
                  trace_s=0.3, check_sample=16,
                  check_block=8),
}


# cells whose files are here but which BENCHMARK.json does not run yet
PLANNED = {"serve-w4a8-poisson": ("so3krates-gaq-w4a8",
                                  "serve-poisson-9to24")}


def _planned(name: str):
    config, traffic = PLANNED[name]
    return Cell(name, {"name": name, "chips": 1},
                load_json(HERE / "configs" / f"{config}.json"),
                load_json(HERE / "traffic" / f"{traffic}.json"),
                load_json(HERE / "cells" / f"{name}.json")["limits"], [], [])


def tiny(name: str):
    """The workload ``name`` of BENCHMARK.json (or a planned cell), cut to
    a CPU test's size (its limits as they stand)."""
    cell = _planned(name) if name in PLANNED else load_cell(name)
    config = dict(cell.config, model=dict(cell.config["model"],
                                          **TINY_MODEL))
    traffic = dict(cell.traffic, **TINY_TRAFFIC[cell.traffic["driver"]])
    return dataclasses.replace(cell, config=config, traffic=traffic)
