"""The readings that a cell's limits are set from, on the chip.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3 --out <file.jsonl>

For each seed of ``--seeds`` one run of the program as the timed path
runs it (a short window at the cell's own size), and for each seed of
``--control-seeds`` one run in which the reference at the next lower
precision takes the program's place (W8 weights as W4 in a W4A8
configuration; float32 products in TF32 in a float32 one). Every run's
numbers compared go to ``--out``, one JSON line each, and to standard
output. ``--fault-seeds`` runs the program with a fault planted in what
it is fed (QAT's ``half_batch``: each of the first steps' batches is its
first half twice, so the loss is the mean over half the rows). The
benchmark's own runs never run the control or a fault. All runs share
one process, so the kernels load once.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import perfbench.run  # noqa: E402,F401  (the cache directories)


def main(argv=None) -> int:
    import torch

    from perfbench.common import load_cell, load_module
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="seeds for the planted fault (QAT: half_batch)")
    ap.add_argument("--fault", default="half_batch")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    driver = load_module("drivers", cell.traffic["driver"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    runs = [(int(s), "program") for s in args.seeds.split(",") if s] \
        + [(int(s), "control") for s in args.control_seeds.split(",") if s] \
        + [(int(s), args.fault) for s in args.fault_seeds.split(",") if s]
    with open(args.out, "a") as f:
        for seed, side in runs:
            t0 = time.perf_counter()
            kw = {"control": True} if side == "control" else \
                {} if side == "program" else {"fault": side}
            out = driver.run(cell, seed, args.seconds, False, device, **kw)
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "readings": out.readings, "e2e": out.e2e,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
