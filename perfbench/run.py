"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's files are found by the names in
``BENCHMARK.json`` (see ``perfbench/common.py``); the cell's driver sets
up, measures for ``--seconds`` and compares what the timed path produced
with the plain reference. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
the window and a few units profiled after it. The numbers compared are
printed beside their limits as the last lines on standard error and
under ``checks``, the last key of the line. The program's build and
kernel caches live in ``build/`` inside the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def forbidden_modules():
    from perfbench.common import FORBIDDEN
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def metric_values(cell, outcome, trace: bool):
    """The line's metrics: end-to-end ones from the driver's window, or
    per-layer ones from their readers (a reader that finds nothing to
    read returns None and its metric is left out)."""
    from perfbench.common import load_module
    out = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = outcome.setup_end - T0
            else:
                value = outcome.e2e.get(m["name"])
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = load_module("metrics", m["name"]).read(outcome)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             chips: int = 1):
    """Run a cell once on ``device``: (result line, checks). The line's
    keys are the contract's, ``checks`` last."""
    import torch

    from perfbench.common import checks_from, load_cell, load_module
    cell = load_cell(name)
    driver = load_module("drivers", cell.traffic["driver"])
    print(f"setup imports and device {time.perf_counter() - T0:.3f} s",
          file=sys.stderr)
    outcome = driver.run(cell, seed, seconds, trace, device)
    checks = checks_from(outcome.readings, cell.limits)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": chips,
                   "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": all(c.ok for c in checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metric_values(cell, outcome, trace),
            "device": device_info}
    if trace and outcome.trace is not None:
        tr = outcome.trace
        if "untraced" in outcome.counters and tr.units:
            seconds, units = outcome.counters["untraced"]
            print(f"trace: {1e3 * tr.window_s / tr.units!r} ms a unit "
                  f"profiled ({tr.units} units), "
                  f"{1e3 * seconds / max(units, 1)!r} ms unprofiled "
                  f"({units} units); device busy "
                  f"{1e3 * tr.busy_s() / tr.units!r} ms a unit",
                  file=sys.stderr)
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    return line, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.common import load_cell
    chips = load_cell(args.workload).workload["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, checks = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device, chips)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded in the measured "
              f"process: {bad}", file=sys.stderr)
        return 4
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
