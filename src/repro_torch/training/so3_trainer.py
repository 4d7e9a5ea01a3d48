"""QAT trainer for the So3krates GAQ model (paper §IV-A protocol):
counterpart of ``repro/training/so3_trainer.py``.

Finetune-only: train an FP32 model, then quantization-aware finetuning
with
  * branch-separated staged warm-up (vector quantizers frozen for the
    first ``warmup_epochs``),
  * LEE regularization on the force outputs (quantized modes only), on
    the batch's first molecule,
  * AdamW with cosine decay.

The force loss and the LEE term differentiate through forces taken with
``create_graph=True``, so every step runs a second-order backward. The
batch runs as one batched forward (the JAX package vmaps one molecule's
energy; the port's model takes each abs-max scale per molecule), so a
quantized forward launches the MDDQ encode kernel once per layer on the
card; a LEE rotation runs two single-molecule forwards.

Random draws (epoch permutations, LEE rotations) come from a numpy
generator seeded by ``TrainConfig.seed``; ``train`` also takes both as
given, so a test can hand it the JAX package's.

The reference jits its two step kinds (``step_warm``, ``step_full``) and
``evaluate``'s batch. Here each is one plain function over fixed-shape
buffers (:func:`step_body`, ``evaluate``'s batch errors), which the card
captures as a CUDA graph per step kind and per batch shape and replays
(``repro_torch.captured.Programs``) and the CPU calls eagerly: the same
code either way. A step gathers its frames from the device-resident
dataset by an index buffer and writes its new parameters and AdamW state
into the buffers it read, the counterpart of donated arguments; the host
draws the permutations and rotations and copies them in before each
step, and reads each step's loss, as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.captured import Programs, clone_tree, copy_into
from repro_torch.core.codebook import make_codebook
from repro_torch.core.lee import lee_regularizer, random_rotations
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import so3krates as so3
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule

__all__ = ["TrainConfig", "make_loss_fn", "loss_and_grads", "train_step",
           "step_body", "make_optimizer", "train", "evaluate", "to_device"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 60
    warmup_epochs: int = 10      # vector-quant freeze (paper: 10/80)
    batch_size: int = 8
    lr: float = 2e-3
    force_weight: float = 10.0
    lee_weight: float = 0.1      # applied to quantized models only
    lee_rotations: int = 1
    seed: int = 0


def to_device(data: Dict, device: DeviceLike = None) -> Dict:
    """A dataset dict (tensors or arrays) with every array on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=dev) for k, v in data.items()}


def make_loss_fn(cfg: so3.So3kratesConfig, species: torch.Tensor,
                 codebook: Optional[torch.Tensor], tcfg: TrainConfig):
    """``loss_fn(params, coords, e_ref, f_ref, rotations) -> (total,
    (l_e, l_f))``. ``rotations`` (k, 3, 3) are the LEE term's, used in
    quantized modes with ``lee_weight > 0`` (``loss_fn.use_lee``) and
    ignored otherwise."""
    use_lee = cfg.quant != "none" and tcfg.lee_weight > 0

    def loss_fn(params, coords, e_ref, f_ref, rotations):
        e, f = so3.energy_and_forces(params, cfg, species, coords, codebook,
                                     create_graph=True)
        l_e = ((e - e_ref) ** 2).mean()
        l_f = ((f - f_ref) ** 2).sum(-1).mean()
        total = l_e + tcfg.force_weight * l_f
        if use_lee:
            def force_fn(c):
                return so3.forces(params, cfg, species, c, codebook,
                                  create_graph=True)
            l_lee = lee_regularizer(force_fn, coords[0], rotations=rotations)
            total = total + tcfg.lee_weight * l_lee
        return total, (l_e, l_f)

    loss_fn.use_lee = use_lee
    return loss_fn


def loss_and_grads(loss_fn, params: so3.Params, coords, e_ref, f_ref,
                   rotations):
    """(loss, (l_e, l_f), {name: gradient}), all detached. A parameter the
    loss does not reach (``svq_kmeans`` detaches the vector branch) gets
    a zero gradient, as under JAX."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, (l_e, l_f) = loss_fn(leaves, coords, e_ref, f_ref, rotations)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    return loss.detach(), (l_e.detach(), l_f.detach()), grads


def train_step(loss_fn, opt: AdamW, params: so3.Params,
               opt_state: AdamWState, coords, e_ref, f_ref, rotations):
    """One optimizer step: (params, opt_state, loss, (l_e, l_f))."""
    loss, aux, grads = loss_and_grads(loss_fn, params, coords, e_ref, f_ref,
                                      rotations)
    params, opt_state = opt.update(grads, opt_state, params)
    return params, opt_state, loss, aux


def step_body(loss_fn, opt: AdamW, data: Dict, state, idx: torch.Tensor,
              rotations):
    """One optimizer step in place, the body the card captures per step
    kind: :func:`train_step` on the frames ``idx`` (int64, on ``data``'s
    device) of the device-resident ``data``, its new parameters and AdamW
    state written into ``state`` = (params, opt_state). Returns (loss,
    l_e, l_f), detached."""
    batch = [data[k].index_select(0, idx) for k in ("coords", "energy",
                                                    "forces")]
    *new, loss, (l_e, l_f) = train_step(loss_fn, opt, *state, *batch,
                                        rotations)
    copy_into(state, tuple(new))
    return loss, l_e, l_f


def make_optimizer(tcfg: TrainConfig, total_steps: int) -> AdamW:
    return AdamW(lr=cosine_schedule(tcfg.lr, total_steps // 20, total_steps),
                 grad_clip=10.0)


def train(cfg: so3.So3kratesConfig, data: Dict, tcfg: TrainConfig,
          init: Optional[so3.Params] = None, verbose: bool = False,
          device: DeviceLike = None,
          perms: Optional[Sequence[np.ndarray]] = None,
          rotations: Optional[Sequence[np.ndarray]] = None
          ) -> Tuple[so3.Params, Dict[str, list]]:
    """Train (or QAT-finetune, when ``init`` is given) on a synthetic-MD
    dict, on ``device``. ``perms`` (one index array per epoch) and
    ``rotations`` (one (k, 3, 3) array per step) replace the draws from
    ``default_rng(tcfg.seed)``. ``history`` holds per epoch the mean
    loss, E-MSE and F-MSE, and per step its host-clock milliseconds
    (``step_ms``; each step ends by reading its loss). The steps run
    :func:`step_body` on buffers of the run's own, cloned from ``init``
    (which is never written); on the card one captured program per step
    kind, whose first step is its capture's warm-up run. Returns a clone
    of the final parameters; the programs and their pool go with the
    run."""
    dev = resolve_device(device)
    data = to_device(data, dev)
    rng = np.random.default_rng(tcfg.seed)
    species = data["species"]
    codebook = make_codebook(cfg.dir_bits, device=dev) \
        if cfg.quant != "none" else None
    params = init if init is not None \
        else so3.init_params(cfg, tcfg.seed, dev)
    params = clone_tree(params, dev)

    n = data["coords"].shape[0]
    steps_per_epoch = max(n // tcfg.batch_size, 1)
    opt = make_optimizer(tcfg, tcfg.epochs * steps_per_epoch)
    steps = Programs(device=dev, name="the SO3 training step",
                     state=(params, opt.init(params)))
    loss_fns = {"warm-up": make_loss_fn(dataclasses.replace(
        cfg, freeze_vec_quant=True), species, codebook, tcfg),
        "full": make_loss_fn(cfg, species, codebook, tcfg)}

    history = {"loss": [], "e_mse": [], "f_mse": [], "step_ms": []}
    step = 0
    for epoch in range(tcfg.epochs):
        perm = perms[epoch] if perms is not None else rng.permutation(n)
        kind = "warm-up" if epoch < tcfg.warmup_epochs else "full"
        ep_loss = ep_e = ep_f = 0.0
        for s in range(steps_per_epoch):
            t0 = time.perf_counter()
            idx = torch.as_tensor(np.asarray(
                perm[s * tcfg.batch_size:(s + 1) * tcfg.batch_size]),
                dtype=torch.int64)
            rots = None
            if loss_fns[kind].use_lee:
                rots = torch.as_tensor(np.array(
                    rotations[step] if rotations is not None
                    else random_rotations(rng, tcfg.lee_rotations),
                    np.float32))
            loss, l_e, l_f = steps.run(
                kind, functools.partial(step_body, loss_fns[kind], opt, data),
                idx=idx, rotations=rots)
            ep_loss += float(loss)
            ep_e += float(l_e)
            ep_f += float(l_f)
            history["step_ms"].append((time.perf_counter() - t0) * 1e3)
            step += 1
        history["loss"].append(ep_loss / steps_per_epoch)
        history["e_mse"].append(ep_e / steps_per_epoch)
        history["f_mse"].append(ep_f / steps_per_epoch)
        if verbose and (epoch % 5 == 0 or epoch == tcfg.epochs - 1):
            print(f"epoch {epoch:3d} loss {history['loss'][-1]:.5f} "
                  f"E-mse {history['e_mse'][-1]:.5f} "
                  f"F-mse {history['f_mse'][-1]:.5f}", flush=True)
    return clone_tree(steps.state[0]), history


def evaluate(cfg: so3.So3kratesConfig, params: so3.Params, data: Dict,
             batch: int = 32, device: DeviceLike = None
             ) -> Dict[str, float]:
    """Energy/force MAE in the dataset's units (eV -> report meV
    upstream), one batched forward + backward per ``batch`` frames: on
    the card a captured program per batch size, each batch's errors
    cloned before the next."""
    dev = resolve_device(device)
    data = to_device(data, dev)
    species = data["species"]
    codebook = make_codebook(cfg.dir_bits, device=dev) \
        if cfg.quant != "none" else None

    def batch_errors(coords, energy, forces):
        e, f = so3.energy_and_forces(params, cfg, species, coords, codebook)
        return (e - energy).abs(), (f - forces).abs().mean((-1, -2))
    progs = Programs(device=dev, name="the SO3 evaluation batch")
    maes_e, maes_f = [], []
    n = data["coords"].shape[0]
    for s in range(0, n, batch):
        part = {k: data[k][s:s + batch] for k in ("coords", "energy",
                                                  "forces")}
        err_e, err_f = progs.run(part["coords"].shape[0], batch_errors,
                                 **part)
        maes_e.append(err_e.clone())
        maes_f.append(err_f.clone())
    return {"e_mae": float(torch.cat(maes_e).mean()),
            "f_mae": float(torch.cat(maes_f).mean())}
