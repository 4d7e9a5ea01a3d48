"""Batched-replica molecular dynamics: ``MDEngine.run`` over captured
segments, the way a user fills a card with one small-molecule force field.

Set-up draws the weights and the Maxwell-Boltzmann velocities from the
seed on the device, tiles the traffic's molecule into its replicas,
builds the engine and warms up the one segment program the window
replays. The window runs whole segments (``MDEngine.run`` over one record
interval, which ends in a host sync) until ``seconds`` have passed, so it
closes on a synchronized segment boundary; with ``trace`` the profiled
segments follow it.

What is compared, after the window, with the program's state freed:
the energies and forces at the first state and at the window's last
state, against the reference's at the same coordinates
(``energy_gap``, ``force_gap``); and the window's last segment, which the
reference integrates again from the state the segment started from
(``replay_gap``: the largest coordinate gap over the RMS displacement of
the segment).
"""
from __future__ import annotations

import sys
import time
from typing import Dict

import torch

from perfbench.common import (Outcome, Profiled, SetupClock, annotate,
                              generator, make_params, worst_gap)
from perfbench.reference import so3krates as ref
from perfbench.reference.integrate import verlet
from perfbench.reference.molecules import KB, azobenzene


def dims_of(config) -> ref.ModelDims:
    m = config["model"]
    return ref.ModelDims(**{k: m[k] for k in ("n_species", "feat",
                                               "vec_feat", "n_layers",
                                               "n_rbf", "cutoff", "tau")})


def quant_of(config, control: bool = False) -> ref.Quant:
    """The served quantization of a configuration; ``control`` lowers
    each stated precision one step (W8 -> W4; float32 runs as TF32,
    which the caller switches on)."""
    m, mode = config["model"], config["serve"]["mode"]
    return ref.Quant(mode=mode, w_bits_eqv=m["w_bits"],
                     w_bits_inv=4 if control else m["w_bits_inv"],
                     a_bits=m["a_bits"], dir_bits=m["dir_bits"])


def replicas(traffic, seed: int, device):
    """(species (R, n) int64, coords (R, n, 3), mask, masses (R, n),
    veloc (R, n, 3)): the molecule tiled, velocities Maxwell-Boltzmann at
    the traffic's temperature with each replica's centre-of-mass drift
    removed, all drawn on the device from the seed."""
    coords, species, masses = azobenzene(device)
    R, n = traffic["replicas"], coords.shape[0]
    species = species.expand(R, n).contiguous()
    coords = coords.expand(R, n, 3).contiguous()
    mask = torch.ones(R, n, dtype=torch.bool, device=device)
    masses = masses.expand(R, n).contiguous()
    std = torch.sqrt(KB * traffic["temperature_K"] / masses)[..., None]
    v = torch.randn(R, n, 3, generator=generator(seed, device, 2),
                    device=device) * std
    p = (masses[..., None] * v).sum(1, keepdim=True) \
        / masses.sum(1)[:, None, None]
    return species, coords, mask, masses, v - p


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool = False) -> Outcome:
    from repro_torch.md.engine import MDConfig, MDEngine
    from repro_torch.models.so3krates import So3kratesConfig

    cfg, traffic = cell.config, cell.traffic
    clock = SetupClock(device)
    model = So3kratesConfig(**cfg["model"])
    dims = dims_of(cfg)
    seg = traffic["segment_steps"]
    params = make_params(dims, seed, device)
    species, coords, mask, masses, veloc = replicas(traffic, seed, device)
    md = MDConfig(mode=cfg["serve"]["mode"], dt_fs=traffic["dt_fs"],
                  skin=traffic["skin"], record_every=seg,
                  mddq_kernel=cfg["serve"]["mddq_kernel"])
    clock.mark("inputs")
    engine = MDEngine(model, params=params, md=md, device=device)
    clock.mark("engine")
    sp32 = species.to(torch.int32)
    start = engine.init_state(0, sp32, coords, mask, masses, veloc=veloc)
    first = (start.coords.clone(), start.e_pot.clone(), start.forces.clone())
    clock.mark("init_state")
    # warm up: the segment's capture, then one replay
    state, _ = engine.run(start, sp32, mask, masses, n_steps=seg)
    clock.mark("capture")
    state, _ = engine.run(state, sp32, mask, masses, n_steps=seg)
    rebuilds0 = int(state.nlist.n_rebuilds)
    clock.mark("replay")
    setup_end = clock.done()

    # per segment: host seconds, coords at its start, mean temperature
    # at its end, the engine's rebuilds so far
    steps, prev, tr, log = 0, state, None, []

    def segment():
        nonlocal state, prev, steps
        prev, t = state, time.perf_counter()
        with annotate("md.segment"):
            state, rec = engine.run(state, sp32, mask, masses, n_steps=seg)
        steps += seg
        log.append((time.perf_counter() - t, prev.coords,
                    float(rec["temperature_K"].mean()), rec["n_rebuilds"]))

    while time.perf_counter() - setup_end < seconds:
        segment()
    window_s = time.perf_counter() - setup_end
    n_window, window_steps = len(log), steps
    # the profiled segments follow the window: a prepared profiler slows
    # every launch, recorded or not
    if trace:
        prof = Profiled(device)
        prof.start()
        for _ in range(traffic["trace_segments"]):
            segment()
        tr = prof.stop(traffic["trace_segments"] * seg)
    R = species.shape[0]
    ns_per_day = R * window_steps * traffic["dt_fs"] * 1e-6 / window_s \
        * 86400.0
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    rebuilds = int(state.nlist.n_rebuilds) - rebuilds0
    # real edges at each segment's start: a random-weight force field
    # binds nothing, so the molecules come apart and the count falls
    edges = [int(ref.cutoff_edges(c, mask, dims.cutoff)[0].numel())
             for _, c, _, _ in log]
    drift(log[:n_window], edges[:n_window], rebuilds0, seg, R)
    final = (state.coords.clone(), state.e_pot.clone(), state.forces.clone())
    prev = (prev.coords.clone(), prev.veloc.clone())
    del engine, state, start, log
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = compare(cfg, params, species, mask, masses, traffic, first,
                       prev, final, control)

    def forward(part):
        return {"kind": "served", "mode": cfg["serve"]["mode"],
                "atoms": int(mask.sum()),
                "edges": round(sum(part) / max(len(part), 1)),
                "vectors_quantized": cfg["serve"]["mode"] != "fp32",
                "codebook": 2 ** cfg["model"]["dir_bits"], "factor": 2}
    counters: Dict[str, object] = {
        "units": steps, "rebuilds": rebuilds, "peak": cfg["peak"],
        "forwards": [forward(edges[:n_window])], "dims": dims}
    if tr is not None:
        counters["trace_forwards"] = [forward(edges[n_window:])]
        counters["untraced"] = (window_s, window_steps)
    return Outcome(e2e={"md_ns_per_day": ns_per_day}, setup_end=setup_end,
                   attempted=steps, failed=0, memory_peak_bytes=memory_peak,
                   readings=readings, counters=counters, trace=tr)


def drift(log, edges, rebuilds0: int, seg: int, replicas: int) -> None:
    """Print, for each quarter of the window's segments, the host
    milliseconds a step, the mean temperature, the real edges a replica
    and the rebuilds per 1,000 steps (``rebuilds0``: the count before
    them): whether the window's work stays steady while the molecules
    drift."""
    if not log:
        return
    n, last = len(log), rebuilds0
    for q in range(4):
        part = range(q * n // 4, (q + 1) * n // 4)
        if not part:
            continue
        ms = 1e3 * sum(log[i][0] for i in part) / (len(part) * seg)
        temp = sum(log[i][2] for i in part) / len(part)
        e = sum(edges[i] for i in part) / (len(part) * replicas)
        rb = 1e3 * (log[part[-1]][3] - last) / (len(part) * seg)
        last = log[part[-1]][3]
        print(f"md quarter {q + 1}: segments {len(part)}, {ms:.4f} ms a "
              f"step, {temp:.1f} K, {e:.1f} real edges a replica, "
              f"{rb:.1f} rebuilds per 1,000 steps", file=sys.stderr)


def compare(cfg, params, species, mask, masses, traffic, first, prev, final,
            control: bool = False) -> Dict[str, float]:
    """The numbers compared. ``first`` and ``final``: (coords, energies,
    forces) the program produced; ``prev``: (coords, veloc) at the start
    of the last segment. With ``control`` the lowered reference takes the
    program's place: its energies, forces and segment are compared."""
    dims = dims_of(cfg)
    truth = Side(params, dims, quant_of(cfg), species.device)
    got = truth
    if control:
        got = Side(params, dims, quant_of(cfg, control=True),
                   species.device, tf32=cfg["serve"]["mode"] == "fp32")
    seg, dt = traffic["segment_steps"], traffic["dt_fs"]
    out = {"energy_gap": 0.0, "force_gap": 0.0}
    for coords, e_prog, f_prog in (first, final):
        e_ref, f_ref = truth.ef(species, coords, mask)
        if control:
            e_prog, f_prog = got.ef(species, coords, mask)
        out["energy_gap"] = max(out["energy_gap"], worst_gap(e_prog, e_ref))
        out["force_gap"] = max(out["force_gap"], worst_gap(f_prog, f_ref))
    r_ref, _ = truth.segment(species, prev, mask, masses, dt, seg)
    r_prog = final[0]
    if control:
        r_prog, _ = got.segment(species, prev, mask, masses, dt, seg)
    moved = (r_ref - prev[0]).pow(2).sum(-1).mean().sqrt()
    out["replay_gap"] = worst_gap(r_prog, r_ref, moved)
    return out


class Side:
    """One side of the comparison: the reference at one precision."""

    def __init__(self, params, dims, quant, device, tf32=False):
        self.dims, self.quant, self.tf32 = dims, quant, tf32
        self.weights = ref.served_weights(params, dims, quant)
        self.codebook = ref.fibonacci_codebook(quant.dir_bits, device) \
            if quant.mode != "fp32" else None

    def ef(self, species, coords, mask):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            return ref.energy_and_forces(self.weights, self.dims, self.quant,
                                         species, coords, mask,
                                         self.codebook)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def segment(self, species, prev, mask, masses, dt, steps):
        return verlet(lambda r: self.ef(species, r, mask)[1], prev[0],
                      prev[1], masses, mask, dt, steps)
