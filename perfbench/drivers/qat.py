"""GAQ quantization-aware finetuning: the trainer's full QAT step, replayed.

Set-up draws the weights and the training frames from the seed on the
device (the traffic's frames: the protocol's classical NVE sampling of
the molecule, by the benchmark's own integrator and force field,
labelled by the force field), builds one step object the way
``training.so3_trainer.train`` does (one ``captured.Programs``
carrying the parameters and the AdamW state, the ``full`` step kind
through ``step_body``), and drives it through its
first three steps: the first is the capture's warm-up run, the next two
replays. The window then goes on with the same object, one step after
another, each reading its loss back as ``train`` does, until ``seconds``
have passed; with ``trace`` the profiled steps follow it. Each epoch's
order of the frames and each step's LEE rotations are drawn from the
seed; every step is a batch of distinct frames.

What is compared (the three first steps, which the reference follows
from the same weights, frames and rotations): each step's loss
(``loss_gap``), the first gradient as AdamW took it, worked out from its
first moment after one step (``grad_gap``, by the worst leaf), and the
parameters' change over the three steps (``update_gap``, by the worst
leaf whose reference gradient is at least a thousandth of the median
leaf's).
"""
from __future__ import annotations

import functools
import sys
import time
from typing import Dict, List

import torch

from perfbench.common import (Outcome, Profiled, SetupClock, annotate,
                              generator, make_params)
from perfbench.drivers.md import dims_of
from perfbench.reference import qat as ref
from perfbench.reference.integrate import verlet
from perfbench.reference.molecules import KB, ClassicalFF, azobenzene
from perfbench.reference.so3krates import cutoff_edges, fibonacci_codebook


def frames(traffic, seed: int, device):
    """The training set: (coords (S, n, 3), energy (S,), forces (S, n, 3),
    species (n,)). The protocol's classical NVE sampling
    (``data/synthetic_md.py`` ``sample_dataset_md``): velocity Verlet of
    the classical force field from the equilibrium geometry with
    Maxwell-Boltzmann velocities at the traffic's temperature (their
    mean removed), a frame every ``stride`` steps, run as
    ``trajectories`` trajectories side by side (the protocol runs one)
    so set-up takes S / trajectories frames' steps; labelled by the
    force field and standardized (energy to zero mean and unit spread,
    forces by the same scale)."""
    eq, species, masses = azobenzene(device)
    T, n = traffic["trajectories"], eq.shape[0]
    g = generator(seed, device, 3)
    std = torch.sqrt(KB * traffic["temperature_K"] / masses)[:, None]
    v = torch.randn(T, n, 3, generator=g, device=device) * std
    v = v - v.mean(1, keepdim=True)
    r = eq.expand(T, n, 3).contiguous()
    ff, m = ClassicalFF(device), masses.expand(T, n)
    mask = torch.ones(T, n, dtype=torch.bool, device=device)
    out = []
    for _ in range(traffic["frames"] // T):
        r, v = verlet(ff.forces, r, v, m, mask, traffic["dt_fs"],
                      traffic["stride"])
        out.append(r)
    coords = torch.stack(out, 1).reshape(-1, n, 3)
    e, f = ff.energy(coords), ff.forces(coords)
    scale = torch.clamp(e.std(correction=0), min=1e-6)
    return coords, (e - e.mean()) / scale, f / scale, species


def schedule(traffic, seed: int, n_frames: int, n_steps: int, device):
    """Per step: the frame indices (each epoch a permutation, cut into
    batches) and the LEE rotations, drawn on the device from the seed."""
    g = generator(seed, device, 4)
    B, k = traffic["batch"], traffic["lee_rotations"]
    per_epoch = n_frames // B
    idx: List[torch.Tensor] = []
    while len(idx) < n_steps:
        perm = torch.randperm(n_frames, generator=g, device=device)
        idx += [perm[s * B:(s + 1) * B] for s in range(per_epoch)]
    quat = torch.randn(n_steps, k, 4, generator=g, device=device)
    return idx[:n_steps], ref.rotations_from_quaternions(quat)


def qat_quant(config, traffic, control=False) -> ref.QatQuant:
    m = config["model"]
    q = ref.QatQuant(w_bits_eqv=m["w_bits"], w_bits_inv=m["w_bits_inv"],
                     a_bits=m["a_bits"], dir_bits=traffic["dir_bits"])
    return ref.lowered(q) if control else q


def train_spec(traffic) -> ref.TrainSpec:
    return ref.TrainSpec(force_weight=traffic["force_weight"],
                         lee_weight=traffic["lee_weight"], lr=traffic["lr"],
                         total_steps=traffic["total_steps"])


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool = False, fault: str = "") -> Outcome:
    from repro_torch.captured import Programs, clone_tree
    from repro_torch.core.codebook import make_codebook
    from repro_torch.models.so3krates import So3kratesConfig
    from repro_torch.training.so3_trainer import (TrainConfig, make_loss_fn,
                                                  make_optimizer, step_body)

    cfg, traffic = cell.config, cell.traffic
    clock = SetupClock(device)
    dims = dims_of(cfg)
    model = So3kratesConfig(**dict(cfg["model"],
                                   dir_bits=traffic["dir_bits"]))
    params = make_params(dims, seed, device)
    coords, energy, forces, species = frames(traffic, seed, device)
    data = {"coords": coords, "energy": energy, "forces": forces,
            "species": species}
    n_sched = traffic["schedule_steps"]
    idx, rots = schedule(traffic, seed, coords.shape[0], n_sched, device)
    clock.mark("inputs")

    tcfg = TrainConfig(batch_size=traffic["batch"], lr=traffic["lr"],
                       force_weight=traffic["force_weight"],
                       lee_weight=traffic["lee_weight"],
                       lee_rotations=traffic["lee_rotations"])
    codebook = make_codebook(model.dir_bits, device=device)
    opt = make_optimizer(tcfg, traffic["total_steps"])
    steps = Programs(device=device, name="the SO3 training step",
                     state=(clone_tree(params, device), opt.init(params)))
    body = functools.partial(step_body, make_loss_fn(model, species, codebook,
                                                     tcfg), opt, data)
    feed = [i.clone() for i in idx[:3]]
    if fault == "half_batch":
        half = traffic["batch"] // 2
        feed = [torch.cat([i[:half], i[:half]]) for i in feed]
    clock.mark("program")

    losses, first_mu = [], None
    for s in range(3):
        loss, _, _ = steps.run("full", body, idx=feed[s], rotations=rots[s])
        losses.append(float(loss))
        if s == 0:
            first_mu = clone_tree(steps.state[1].mu)
            clock.mark("capture")
    after3 = clone_tree(steps.state[0])
    clock.mark("replays")
    setup_end = clock.done()

    done, tr, launch_s = 3, None, 0.0

    def step() -> float:
        """One step; returns the host seconds spent in the call that
        launches it (the inputs' copies and the graph's launch)."""
        nonlocal done
        s = done % n_sched
        with annotate("qat.step"):
            t = time.perf_counter()
            loss, _, _ = steps.run("full", body, idx=idx[s],
                                   rotations=rots[s])
            launch = time.perf_counter() - t
            float(loss)
        done += 1
        return launch

    while time.perf_counter() - setup_end < seconds:
        launch_s += step()
    window_s = time.perf_counter() - setup_end
    n_window = done - 3
    # the profiled steps follow the window: a prepared profiler slows
    # every launch, recorded or not
    if trace:
        prof = Profiled(device)
        prof.start()
        for _ in range(traffic["trace_steps"]):
            step()
        tr = prof.stop(traffic["trace_steps"])
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del steps, body
    if device.type == "cuda":
        torch.cuda.empty_cache()

    b1 = opt.b1
    program = {"losses": losses,
               "grad": {k: m / (1 - b1) for k, m in first_mu.items()},
               "update": {k: after3[k] - params[k] for k in params}}
    readings = compare(cfg, traffic, params, data, idx[:3], rots[:3],
                       program, control)
    B, n = traffic["batch"], coords.shape[1]
    e_batch = int(cutoff_edges(coords[:B], torch.ones(
        B, n, dtype=torch.bool, device=device), dims.cutoff)[0].numel())
    qd = dict(kind="qat", vectors_quantized=True,
              codebook=2 ** traffic["dir_bits"], factor=6)
    counters: Dict[str, object] = {
        "peak": traffic.get("peak", cfg["peak"]), "dims": dims,
        "forwards": [dict(qd, atoms=B * n, edges=e_batch),
                     dict(qd, atoms=n, edges=e_batch // B,
                          calls=2 * traffic["lee_rotations"])]}
    if tr is not None:
        counters["untraced"] = (window_s, n_window)
        counters["launch_s"] = launch_s
    return Outcome(e2e={"qat_step_ms": 1e3 * window_s / max(n_window, 1)},
                   setup_end=setup_end, attempted=n_window, failed=0,
                   memory_peak_bytes=memory_peak, readings=readings,
                   counters=counters, trace=tr)


def reference_steps(cfg, traffic, params, data, idx, rots, quant):
    """The reference's three steps: losses, the first clipped gradient,
    the parameters after the third."""
    dims, spec = dims_of(cfg), train_spec(traffic)
    codebook = fibonacci_codebook(quant.dir_bits, params["embed"].device)
    p = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for s in range(len(idx)):
        batch = [data[k].index_select(0, idx[s])
                 for k in ("coords", "energy", "forces")]
        value, grads = ref.loss_and_grads(p, dims, quant, spec,
                                          data["species"], *batch, rots[s],
                                          codebook)
        p, mu, nu, clipped = ref.adamw_step(spec, p, grads, mu, nu, s + 1)
        losses.append(float(value))
        if s == 0:
            first = clipped
    return {"losses": losses, "grad": first,
            "update": {k: p[k] - params[k] for k in params}}


def _leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep=None) -> float:
    """Worst leaf's | |got| - |want| | over the larger of its |want| and
    the median leaf's |want|."""
    norms = {k: float(torch.linalg.vector_norm(w.double()))
             for k, w in want.items()}
    med = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for k in want:
        if keep is not None and k not in keep:
            continue
        g = float(torch.linalg.vector_norm(got[k].double()))
        worst = max(worst, abs(g - norms[k]) / max(norms[k], med, 1e-30))
    return worst


def compare(cfg, traffic, params, data, idx, rots, program,
            control=False) -> Dict[str, float]:
    with torch.enable_grad():
        truth = reference_steps(cfg, traffic, params, data, idx, rots,
                                qat_quant(cfg, traffic))
        got = program if not control else reference_steps(
            cfg, traffic, params, data, idx, rots, qat_quant(cfg, traffic, True))
    g_norms = {k: float(torch.linalg.vector_norm(g.double()))
               for k, g in truth["grad"].items()}
    med = sorted(g_norms.values())[len(g_norms) // 2]
    moving = {k for k, v in g_norms.items() if v >= 1e-3 * med}
    print(f"update_gap leaves out (reference gradient under 1e-3 of the "
          f"median leaf's): {sorted(set(g_norms) - moving)}",
          file=sys.stderr)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(got["losses"], truth["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(got["grad"], truth["grad"]),
            "update_gap": _leaf_gap(got["update"], truth["update"], moving)}

