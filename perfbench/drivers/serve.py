"""Online force requests: single molecules through ``MicroBatchScheduler``
into ``QuantizedEngine.infer_batch``, offered open-loop at a fixed rate.

Set-up draws the weights on the device and the window's requests on the
host from the seed (``reference/requests.py``: ``round(rate * seconds)``
molecules from the traffic's size mixture, Poisson arrival times), builds
the engine on the traffic's buckets and the scheduler on its batching
limits; the scheduler's own warm-up runs every shape class the buckets
admit. The window submits each request at its scheduled time whatever
has completed; each request's latency runs from that time to its
completion, and one that was refused or failed counts as
``FAILED_LATENCY_S``. After the window every request is awaited, up to a
minute past its close.

What is compared, with the program's state freed: the energies and
forces of a sample of the served requests drawn from the seed (the
largest molecules always in it), against the reference's for the same
molecules (``energy_gap``, ``force_gap``: the widest gap over the
sample's RMS), and the share of requests that never came back
(``lost``).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.common import (Outcome, Profiled, SetupClock, annotate,
                              make_params, worst_gap)
from perfbench.drivers.md import Side, dims_of, quant_of
from perfbench.reference.requests import arrivals, molecules

FAILED_LATENCY_S = 1e6      # a refused or failed request's latency
_WAIT_AFTER_S = 60.0


def requests(cell, seed: int, rate: float, seconds: float):
    """The window's (arrival times, [(species, coords)])."""
    t = cell.traffic
    rng = np.random.default_rng(seed)
    times = arrivals(rng, rate, seconds)
    mols = molecules(rng, len(times), t["size_mix"],
                     cell.config["model"]["n_species"], t["density"])
    return times, mols


def build(cell, seed: int, device):
    """(params, engine, scheduler): the weights from the seed, the engine
    on the traffic's buckets, the scheduler warmed up."""
    from repro_torch.models.so3krates import So3kratesConfig
    from repro_torch.server.scheduler import (MicroBatchScheduler,
                                              SchedulerConfig)
    from repro_torch.serving.engine import QuantizedEngine, ServeConfig
    cfg, t = cell.config, cell.traffic
    params = make_params(dims_of(cfg), seed, device)
    engine = QuantizedEngine(
        So3kratesConfig(**cfg["model"]), params,
        ServeConfig(mode=cfg["serve"]["mode"],
                    bucket_sizes=tuple(t["buckets"]),
                    max_batch=t["engine_max_batch"],
                    mddq_kernel=cfg["serve"]["mddq_kernel"]),
        device=device)
    sched = MicroBatchScheduler(engine, SchedulerConfig(
        max_batch=t["max_batch"], deadline_ms=t["deadline_ms"],
        warmup=True))
    return params, engine, sched


def open_loop(sched, graphs, times, prof=None, trace_from=0.0,
              depths=None):
    """Submit at the scheduled times. With ``prof`` (a
    :class:`~perfbench.common.Profiled`) the profiler records from
    ``trace_from`` seconds into the window to the last submission, and
    its trace is read after that; ``depths``, a list, gets the queue's
    depth after each submission. Returns (t0, sent, trace)."""
    on, sent = False, []
    t0 = time.monotonic()
    for t_arr, g in zip(times, graphs):
        if prof is not None and not on and t_arr >= trace_from:
            prof.start()
            on, t_on = True, time.monotonic()
        delay = t0 + t_arr - time.monotonic()
        if delay > 0:
            with annotate("serve.load_generator_sleeps"):
                time.sleep(delay)
        with annotate("serve.submit"):
            try:
                sent.append((float(t_arr), sched.submit(g)))
            except RuntimeError as exc:     # shed or closed: refused
                sent.append((float(t_arr), exc))
        if depths is not None:
            depths.append(sched.queue_depth())
    tr = None
    if on:
        t_off = time.monotonic()
        tr = prof.stop(1)
        tr.span = (t_on, t_off)
    return t0, sent, tr


def await_all(sent, t_close: float):
    """Each request's result, or None where it was refused, failed or
    did not come back within a minute of ``t_close``."""
    out = []
    for _, h in sent:
        if isinstance(h, Exception):
            out.append(None)
            continue
        try:
            left = max(t_close + _WAIT_AFTER_S - time.monotonic(), 0.0)
            out.append(h.result(timeout=left))
        except Exception:       # the engine's failure or a timeout: lost
            out.append(None)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool = False) -> Outcome:
    from repro_torch.serving.bucketing import Graph
    cfg, t = cell.config, cell.traffic
    clock = SetupClock(device)
    times, mols = requests(cell, seed, t["rate_rps"], seconds)
    graphs = [Graph(species=s, coords=c) for s, c in mols]
    clock.mark("requests")
    params, engine, sched = build(cell, seed, device)
    clock.mark("engine and warm-up")
    n_warm = len(sched._flushes)
    prof = Profiled(device) if trace else None
    setup_end = clock.done()

    t0, sent, tr = open_loop(sched, graphs, times, prof,
                             max(seconds - t["trace_s"], 0.0))
    t_close = t0 + seconds
    results = await_all(sent, t_close)
    lat = np.array([FAILED_LATENCY_S if r is None
                    else h.t_done - (t0 + t_arr)
                    for (t_arr, h), r in zip(sent, results)])
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    flushes = [f for f in list(sched._flushes)[n_warm:]
               if f.t_start <= t_close]
    sched.close()
    del engine, sched
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = compare(cell, seed, params, mols, results, control)
    counters = flush_counters(flushes)
    served = [m for m, r in zip(mols, results) if r is not None]
    counters.update(peak=cfg["peak"],
                    dims=dims_of(cfg),
                    forwards=[_forward(cfg, served)])
    if tr is not None:
        done = [m for (t_arr, h), m, r in zip(sent, mols, results)
                if r is not None and tr.span[0] <= h.t_done <= tr.span[1]]
        counters["trace_forwards"] = [_forward(cfg, done)]
    failed = int(sum(r is None for r in results))
    return Outcome(e2e={"serve_p95_ms": float(np.percentile(lat, 95)) * 1e3},
                   setup_end=setup_end, attempted=len(sent), failed=failed,
                   memory_peak_bytes=memory_peak, readings=readings,
                   counters=counters, trace=tr)


def _forward(cfg, mols) -> Dict[str, object]:
    """The served molecules as one forward's real atoms and edges."""
    atoms = sum(len(s) for s, _ in mols)
    cut2 = cfg["model"]["cutoff"] ** 2
    edges = 0
    for _, c in mols:
        d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        edges += int((d2 < cut2).sum()) - len(c)
    return {"kind": "served", "mode": cfg["serve"]["mode"], "atoms": atoms,
            "edges": edges, "factor": 2,
            "vectors_quantized": cfg["serve"]["mode"] != "fp32",
            "codebook": 2 ** cfg["model"]["dir_bits"]}


def flush_counters(flushes) -> Dict[str, object]:
    if not flushes:
        return {}
    return {"flush_wait_s": [f.wait_s for f in flushes],
            "flush_requests": [f.n_requests for f in flushes],
            "flush_host_s": [f.prep_s + f.dispatch_s for f in flushes]}


def sample(seed: int, mols, results, k: int) -> List[int]:
    """Up to ``k`` served requests: the largest always, the rest drawn
    from the seed."""
    served = [i for i, r in enumerate(results) if r is not None]
    if len(served) <= k:
        return served
    by_size = sorted(served, key=lambda i: -len(mols[i][0]))
    top = by_size[:k // 8]
    rest = sorted(set(served) - set(top))
    rng = np.random.default_rng(seed + 1)
    return sorted(top + list(rng.choice(rest, k - len(top), replace=False)))


def compare(cell, seed, params, mols, results, control=False
            ) -> Dict[str, float]:
    cfg = cell.config
    device = params["embed"].device
    lost = sum(r is None for r in results) / max(len(results), 1)
    idx = sample(seed, mols, results, cell.traffic["check_sample"])
    dims = dims_of(cfg)
    truth = Side(params, dims, quant_of(cfg), device)
    got_side = Side(params, dims, quant_of(cfg, control=True), device,
                    tf32=cfg["serve"]["mode"] == "fp32") if control else None
    e_got, e_ref, f_got, f_ref = [], [], [], []
    block = cell.traffic["check_block"]
    for lo in range(0, len(idx), block):
        part = idx[lo:lo + block]
        n = max(len(mols[i][0]) for i in part)
        sp = torch.zeros(len(part), n, dtype=torch.int64, device=device)
        co = torch.zeros(len(part), n, 3, device=device)
        mask = torch.zeros(len(part), n, dtype=torch.bool, device=device)
        for row, i in enumerate(part):
            k = len(mols[i][0])
            sp[row, :k] = torch.as_tensor(mols[i][0], device=device)
            co[row, :k] = torch.as_tensor(mols[i][1], device=device)
            mask[row, :k] = True
        e, f = truth.ef(sp, co, mask)
        e_ref.append(e)
        f_ref.append(f[mask])
        if control:
            e, f = got_side.ef(sp, co, mask)
            e_got.append(e)
            f_got.append(f[mask])
        else:
            e_got.append(torch.tensor([results[i].energy for i in part],
                                      device=device))
            f_got.append(torch.cat([torch.as_tensor(results[i].forces,
                                                    device=device)
                                    for i in part]))
    if not idx:
        return {"energy_gap": float("inf"), "force_gap": float("inf"),
                "lost": lost}
    return {"energy_gap": worst_gap(torch.cat(e_got), torch.cat(e_ref)),
            "force_gap": worst_gap(torch.cat(f_got), torch.cat(f_ref)),
            "lost": lost}
