"""The serve cell's knee, swept once on the chip.

    python3 perfbench/sweep.py --workload serve-w4a8-poisson \
        --seed <n> --rates 200,400,800 --seconds 8 --out <file.jsonl>

One engine and scheduler, built and warmed up as the cell builds them;
then for each offered rate one open-loop window of the cell's traffic
(``drivers/serve.py``), awaited to its end. Each rate's line holds the
offered and achieved rates (completed requests over the time from the
window's start to the last completion), the admission queue's mean
depth as each request was submitted over the middle tenth of the window
and over its last tenth, and the p50 and p95 latency from the scheduled
arrivals. A rate is sustained where the achieved rate is within 2% of
the offered one and the queue is no deeper at the end than at the
middle (one request of slack: a queue that does not grow still moves by
a request or so). The knee is the highest sustained rate below the first
rate (ascending) that is not: past it a sustained reading is a queue
that happened to be short at both samples.
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
    import numpy as np
    import torch

    from perfbench.common import load_cell, load_module
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 3
    from repro_torch.serving.bucketing import Graph
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    serve = load_module("drivers", "serve")
    _, _, sched = serve.build(cell, args.seed, device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    knee, failed_once = None, False
    with open(args.out, "a") as f:
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            times, mols = serve.requests(cell, args.seed + k, rate,
                                         args.seconds)
            graphs = [Graph(species=s, coords=c) for s, c in mols]
            depths = []
            t0, sent, _ = serve.open_loop(sched, graphs, times,
                                          depths=depths)
            results = serve.await_all(sent, t0 + args.seconds)
            done = [h.t_done for (_, h), r in zip(sent, results)
                    if r is not None]
            lat = np.array([h.t_done - (t0 + t) if r is not None
                            else serve.FAILED_LATENCY_S
                            for (t, h), r in zip(sent, results)])
            achieved = len(done) / (max(done) - t0) if done else 0.0
            n = len(depths)
            line = {"offered_rps": rate, "achieved_rps": achieved,
                    "queue_mid": float(np.mean(
                        depths[int(0.45 * n):int(0.55 * n) + 1])),
                    "queue_end": float(np.mean(depths[int(0.9 * n):])),
                    "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                    "p95_ms": float(np.percentile(lat, 95)) * 1e3,
                    "n": len(sent), "failed": len(sent) - len(done),
                    "device": torch.cuda.get_device_name(device)}
            line["sustained"] = (achieved >= 0.98 * rate and
                                 line["queue_end"] <= line["queue_mid"] + 1)
            if line["sustained"] and not failed_once:
                knee = rate
            failed_once = failed_once or not line["sustained"]
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            time.sleep(1.0)
        f.write(json.dumps({"knee_rps": knee}) + "\n")
    print(json.dumps({"knee_rps": knee}))
    sched.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
