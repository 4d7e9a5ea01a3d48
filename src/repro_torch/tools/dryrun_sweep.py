"""The dry run's sweep: every arch x shape x mesh cell of the reference's
dry run under each policy, one ``python -m repro_torch.launch.dryrun``
process per cell, ``--jobs`` of them at a time, each killed after
:data:`CELL_LIMIT_S` seconds (the CLI itself has no limit, as the
reference's has none); ``--cells`` runs only the cells it names. A cell's record and reshard log are written
under the policy's tag (``artifacts/dryrun_torch/<arch>__<shape>__<mesh>
__<policy>.json`` and ``.reshards.json``); ``--out`` gets copies of both,
each cell's output, and ``summary.json``: per cell its exit code,
seconds, error, the reshards (count and bytes), collective bytes, and
counted FLOPs per device against ``analytic_flops / n_devices``; per
policy the cells passed, and the reshards by op (count and bytes).

    PYTHONPATH=src python -m repro_torch.tools.dryrun_sweep \\
        --policies tp fsdp zero3 cp --out artifacts/dryrun_sweep

``--probe arch:shape:mesh:policy`` instead runs that one cell in this
process for :data:`PROBE_S` seconds and prints the seconds per sLSTM cell
step (``models.lm.xlstm._slstm_cell`` timed from its second call on),
and the steps the whole cell runs; the cell is then stopped.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from repro_torch import configs
from repro_torch.launch.dryrun import cell_path, reshards_path
from repro_torch.launch.reshard import reshard_totals

__all__ = ["sweep_cells", "run_sweep", "probe_slstm", "main"]

POLICIES = ("tp", "fsdp", "zero3", "cp")
CELL_LIMIT_S = 900.0
PROBE_S = 120.0


def sweep_cells(policies):
    """(arch, shape, mesh, policy) of every cell on both meshes; the
    sLSTM's long cells first, so that they overlap the rest."""
    cells = [(a, s.shape_name, m, p) for p in policies
             for a in configs.ARCH_IDS for s in configs.shapes_for(a)
             for m in ("single", "multi")]
    slow = {("xlstm-1.3b", "prefill_32k"): 0, ("xlstm-1.3b", "train_4k"): 1}
    return sorted(cells, key=lambda c: slow.get(c[:2], 2))


def _summarise(cell, rc, seconds, timed_out):
    arch, shape, mesh, policy = cell
    row = {"arch": arch, "shape": shape, "mesh": mesh, "policy": policy,
           "rc": rc, "seconds": round(seconds, 1), "timed_out": timed_out}
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
                row = _summarise(cell, proc.returncode, took, timed_out)
                rows.append(row)
                print(f"{' x '.join(cell)}: rc {proc.returncode}, "
                      f"{took:.1f} s, "
                      f"{row.get('reshards', '-')} reshards"
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


def probe_slstm(arch, shape, mesh, policy, seconds: float) -> dict:
    """Seconds per sLSTM cell step of one cell's dry run (the module
    docstring)."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.lm import xlstm

    class _Stop(Exception):
        pass

    calls = []
    plain = xlstm._slstm_cell

    def timed(*a, **k):
        calls.append(time.monotonic())
        if calls[-1] - calls[0] > seconds:
            raise _Stop(f"probe stopped after {seconds} s")
        return plain(*a, **k)

    cfg = configs.get_config(arch)
    cell = next(s for s in configs.shapes_for(arch)
                if s.shape_name == shape)
    n_slstm = cfg.n_layers // (cfg.xlstm_mlstm_per_slstm + 1)
    xlstm._slstm_cell = timed
    try:
        t0 = time.monotonic()
        rec = run_cell(arch, shape, mesh, policy=policy)
    finally:
        xlstm._slstm_cell = plain
    n = len(calls) - 1
    per = (calls[-1] - calls[1]) / (n - 1) if n > 1 else None
    return {"cell": [arch, shape, mesh, policy], "probe_s": seconds,
            "before_first_step_s": round(calls[0] - t0, 2) if calls
            else None,
            "steps_timed": n, "s_per_step": per,
            "slstm_layers": n_slstm, "steps_in_cell": n_slstm * cell.seq_len,
            "error": rec.get("error")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policies", nargs="+", default=list(POLICIES),
                    choices=POLICIES)
    ap.add_argument("--cells", nargs="*", default=None,
                    help="arch:shape:mesh:policy, instead of the sweep")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default="artifacts/dryrun_sweep")
    ap.add_argument("--probe", default=None,
                    help="arch:shape:mesh:policy: time its sLSTM steps")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.probe:
        res = probe_slstm(*args.probe.split(":"), PROBE_S)
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
