"""The dry run's sweep: every arch x shape x mesh cell of the reference's
dry run under each policy, one ``python -m repro_torch.launch.dryrun``
process per cell, ``--jobs`` of them at a time, each killed after
:data:`CELL_LIMIT_S` seconds (the CLI itself has no limit, as the
reference's has none); ``--cells`` runs only the cells it names. A cell's record and reshard log are written
under the policy's tag (``artifacts/dryrun_torch/<arch>__<shape>__<mesh>
__<policy>.json`` and ``.reshards.json``); ``--out`` gets copies of both,
each cell's output, and ``summary.json``: per cell its exit code,
seconds, error, the reshards (count and bytes), collective bytes, and
counted FLOPs per device against ``analytic_flops / n_devices``, and the
steps its scans ran and charged (``models/lm/scan.py``, read from the
cell's ``scans:`` line); per policy the cells passed, and the reshards by
op (count and bytes).

    PYTHONPATH=src python -m repro_torch.tools.dryrun_sweep \\
        --policies tp fsdp zero3 cp --out artifacts/dryrun_sweep

``--probe arch:shape:mesh:policy`` instead runs that one cell in this
process up to its first sLSTM block's steady step (its
``models.lm.xlstm._slstm_cell`` call number :data:`STEADY_CALL`, which
the scan runs for real), times that step :data:`PROBE_REPS` times
each on the cell's DTensors under the dry run's dispatch modes, on the
same DTensors under a bare ``ReshardMode`` alone (without which torch
2.11 refuses the step), and on plain ``meta`` tensors of the global
shapes with no mode, prints the three seconds per step, DTensor's
dispatch with its reshards (the second less the third) and the counting
modes' cost (the first less the second), and stops the cell.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

from repro_torch import configs
from repro_torch.launch.dryrun import cell_path, reshards_path
from repro_torch.launch.reshard import ReshardMode, reshard_totals

__all__ = ["sweep_cells", "run_sweep", "probe_slstm", "main"]

POLICIES = ("tp", "fsdp", "zero3", "cp")
CELL_LIMIT_S = 900.0
# the probe times the scan's steady step (k = 2: the third call)
# PROBE_REPS times each way
STEADY_CALL, PROBE_REPS = 3, 20


def sweep_cells(policies):
    """(arch, shape, mesh, policy) of every cell on both meshes; the
    sLSTM's long cells first, so that they overlap the rest."""
    cells = [(a, s.shape_name, m, p) for p in policies
             for a in configs.ARCH_IDS for s in configs.shapes_for(a)
             for m in ("single", "multi")]
    slow = {("xlstm-1.3b", "prefill_32k"): 0, ("xlstm-1.3b", "train_4k"): 1}
    return sorted(cells, key=lambda c: slow.get(c[:2], 2))


_SCANS = re.compile(r"scans: (\d+) passes, (\d+) steps, ran (\d+), "
                    r"charged (\d+)(; (\d+) passes found no steady)?")


def _scans(log: Path):
    """The scans' steps from the ``scans:`` line of a cell's output
    (``launch.dryrun.scan_line``), or None where it printed none."""
    m = _SCANS.search(log.read_text()) if log.exists() else None
    if m is None:
        return None
    return {"passes": int(m[1]), "steps": int(m[2]), "ran": int(m[3]),
            "charged": int(m[4]), "unsteady": int(m[6] or 0)}


def _summarise(cell, rc, seconds, timed_out, log=None):
    arch, shape, mesh, policy = cell
    row = {"arch": arch, "shape": shape, "mesh": mesh, "policy": policy,
           "rc": rc, "seconds": round(seconds, 1), "timed_out": timed_out,
           "scans": _scans(log) if log is not None else None}
    path = Path(cell_path(arch, shape, mesh, policy))
    if not path.exists():
        row["error"] = "no record" + (" (killed at its limit)"
                                      if timed_out else "")
        return row
    rec = json.loads(path.read_text())
    log = json.loads(Path(reshards_path(arch, shape, mesh, policy))
                     .read_text())
    n, nbytes, counts = reshard_totals(log)
    row.update({
        "error": rec.get("error"), "n_devices": rec["n_devices"],
        "flops": rec["flops"], "analytic_flops": rec["analytic_flops"],
        "flops_ratio": (rec["flops"] * rec["n_devices"]
                        / rec["analytic_flops"]
                        if rec["analytic_flops"] > 0 and rec["flops"] >= 0
                        else None),
        "collective_bytes": rec["collective_bytes"],
        "collective_counts": rec["collective_counts"],
        "reshards": n, "reshard_bytes": nbytes, "reshard_counts": counts,
        "reshard_ops": sorted({e["op"] for e in log}),
        "compile_s": rec["compile_s"]})
    return row


def run_sweep(cells, jobs: int, timeout: float, out: Path):
    """Runs ``cells`` (:func:`sweep_cells`) and returns the rows of
    ``summary.json``."""
    root = Path(__file__).resolve().parents[3]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    (out / "logs").mkdir(parents=True, exist_ok=True)
    pending, running, rows = list(cells), [], []
    try:
        while pending or running:
            while pending and len(running) < jobs:
                cell = pending.pop(0)
                arch, shape, mesh, policy = cell
                for p in (cell_path(arch, shape, mesh, policy),
                          reshards_path(arch, shape, mesh, policy)):
                    if os.path.exists(p):
                        os.remove(p)
                log = open(out / "logs" / f"{arch}__{shape}__{mesh}__"
                           f"{policy}.txt", "w")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--policy", policy, "--tag", policy],
                    cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
                running.append((cell, proc, log, time.monotonic()))
            time.sleep(0.5)
            still = []
            for cell, proc, log, t0 in running:
                took = time.monotonic() - t0
                timed_out = proc.poll() is None and took > timeout
                if timed_out:
                    proc.kill()
                    proc.wait()
                if proc.poll() is None:
                    still.append((cell, proc, log, t0))
                    continue
                log.close()
                row = _summarise(cell, proc.returncode, took, timed_out,
                                 Path(log.name))
                rows.append(row)
                sc = row["scans"]
                print(f"{' x '.join(cell)}: rc {proc.returncode}, "
                      f"{took:.1f} s, "
                      f"{row.get('reshards', '-')} reshards"
                      + (f", scan steps ran {sc['ran']} charged "
                         f"{sc['charged']} of {sc['steps']}" if sc else "")
                      + (f", ERROR {row['error']}" if row.get("error")
                         else ""), flush=True)
            running = still
    finally:
        for _, proc, log, _ in running:
            proc.kill()
            proc.wait()
            log.close()
    return rows


def _totals(rows):
    by_policy = {}
    for r in rows:
        t = by_policy.setdefault(r["policy"], {
            "cells": 0, "passed": 0, "timed_out": [], "failed": [],
            "flops_over_4x": []})
        t["cells"] += 1
        name = f"{r['arch']} x {r['shape']} x {r['mesh']}"
        if r["rc"] == 0 and not r.get("error"):
            t["passed"] += 1
        elif r["timed_out"]:
            t["timed_out"].append(name)
        else:
            t["failed"].append(f"{name}: {r.get('error')}")
        if r.get("flops_ratio") and r["flops_ratio"] > 4:
            t["flops_over_4x"].append(f"{name}: {r['flops_ratio']:.2f}x")
    return by_policy


def _by_op(rows, out: Path):
    """Reshards by policy and op, (count, bytes), from the copied logs."""
    table = {}
    for r in rows:
        p = out / "records" / (f"{r['arch']}__{r['shape']}__{r['mesh']}__"
                               f"{r['policy']}.reshards.json")
        if not p.exists():
            continue
        for e in json.loads(p.read_text()):
            n, b, _ = reshard_totals([e])
            c = table.setdefault(r["policy"], {}).setdefault(
                e["op"], {"reshards": 0, "bytes": 0, "cells": set()})
            c["reshards"] += n
            c["bytes"] += sum(b.values())
            c["cells"].add(f"{r['arch']} x {r['shape']} x {r['mesh']}")
    return {p: {op: dict(c, cells=len(c["cells"])) for op, c in t.items()}
            for p, t in table.items()}


def probe_slstm(arch, shape, mesh, policy, reps: int = PROBE_REPS,
                **knobs) -> dict:
    """Seconds per sLSTM cell step of one cell's dry run, three ways (the
    module docstring); the cell stops after its first sLSTM block's
    steady step. ``knobs`` go to ``run_cell`` (tests: a smoke config)."""
    import torch
    from torch.utils._python_dispatch import _disable_current_modes
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.lm import xlstm

    class _Stop(Exception):
        pass

    plain, calls, res = xlstm._slstm_cell, [], {}

    def per_step(fn):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def probed(params, cfg, x_t, state):
        calls.append(time.monotonic())
        if len(calls) < STEADY_CALL:
            return plain(params, cfg, x_t, state)
        res["dtensor_with_modes_s"] = per_step(
            lambda: plain(params, cfg, x_t, state))
        with _disable_current_modes():
            with ReshardMode():     # the step may need its reshards to run
                res["dtensor_s"] = per_step(
                    lambda: plain(params, cfg, x_t, state))
            m_params = {k: meta(v) for k, v in params.items()}
            m_x, m_state = meta(x_t), tuple(meta(v) for v in state)
            res["meta_s"] = per_step(
                lambda: plain(m_params, cfg, m_x, m_state))
        raise _Stop("probe done")

    xlstm._slstm_cell = probed
    try:
        t0 = time.monotonic()
        rec = run_cell(arch, shape, mesh, policy=policy, **knobs)
    finally:
        xlstm._slstm_cell = plain
    return {"cell": [arch, shape, mesh, policy], "reps": reps,
            "before_first_step_s": round(calls[0] - t0, 2) if calls
            else None, **res,
            "dtensor_dispatch_s": (res["dtensor_s"] - res["meta_s"]
                                   if res else None),
            "modes_s": (res["dtensor_with_modes_s"] - res["dtensor_s"]
                        if res else None),
            "error": None if res else rec.get("error")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policies", nargs="+", default=list(POLICIES),
                    choices=POLICIES)
    ap.add_argument("--cells", nargs="*", default=None,
                    help="arch:shape:mesh:policy, instead of the sweep")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default="artifacts/dryrun_sweep")
    ap.add_argument("--probe", default=None,
                    help="arch:shape:mesh:policy: time its sLSTM step "
                    "three ways")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.probe:
        res = probe_slstm(*args.probe.split(":"))
        print(json.dumps(res))
        (out / "slstm_probe.json").write_text(json.dumps(res, indent=2))
        return 0
    cells = ([tuple(c.split(":")) for c in args.cells] if args.cells
             else sweep_cells(args.policies))
    t0 = time.monotonic()
    rows = run_sweep(cells, args.jobs, CELL_LIMIT_S, out)
    (out / "records").mkdir(exist_ok=True)
    for r in rows:
        for p in (cell_path(r["arch"], r["shape"], r["mesh"], r["policy"]),
                  reshards_path(r["arch"], r["shape"], r["mesh"],
                                r["policy"])):
            if os.path.exists(p):
                shutil.copy(p, out / "records")
    summary = {"seconds": round(time.monotonic() - t0, 1),
               "jobs": args.jobs, "timeout_s": CELL_LIMIT_S,
               "policies": _totals(rows), "reshards_by_op": _by_op(rows, out),
               "cells": rows}
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    for p, t in summary["policies"].items():
        print(f"{p}: {t['passed']} of {t['cells']} passed; timed out "
              f"{t['timed_out']}; failed {len(t['failed'])}; FLOPs over 4x "
              f"{t['flops_over_4x']}")
    print(json.dumps(summary["reshards_by_op"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
