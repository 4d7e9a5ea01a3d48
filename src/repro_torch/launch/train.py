"""Training launcher of the LMs (every arch of ``configs.ARCH_IDS``):
counterpart of ``repro/launch/train.py``, on a ``torch.distributed``
device mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 50 --batch 8 --seq 256 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 30 --quant qat_w4a8 --grad-compression ef8   # on the card

The loop is the reference's: ``init_lm`` from seed 0;
``AdamW(cosine_schedule(lr, steps // 10, steps), weight_decay=0.1,
grad_clip=1.0)``; with ``--grad-compression ef8`` the gradients go
through ``ef_compress`` before the update; a ``CheckpointManager(ckpt_dir,
keep=2)`` whose newest valid step, when there is one, is restored and
resumed from; batches from ``synthetic_token_batches(seed=17)``; a loss
line every 10 steps and at the last; a save every ``--ckpt-every`` steps
and at the end, with ``extra={"loss": ...}``; and the closing check that
the last logged loss is below the first. ``--smoke`` takes the reduced
config of the family in float32; without it the full config runs in its
``cfg.dtype`` (bf16 activations, float32 parameters). ``--spmd-timeout``
arms :class:`StragglerWatchdog` around each step.

A checkpoint holds the parameters only, as the reference's does, so a
directory written by either launcher holds the same arrays under the same
keys. The optimizer state and the error-feedback residual are not saved:
a resumed run starts AdamW's moments, its step count (and so the
schedule's warm-up) and the residual from zero, and its data from the
stream's first batch, as the reference's does.

The mesh, as the reference's: the parameters are DTensors placed by
``sharding.param_specs`` on it and each batch by ``batch_specs``; a
resume restores onto those placements, and the step runs under
``implicit_replication()``. Under ``--smoke`` it is the local (1, 1)
mesh (``mesh.make_local_mesh``, which opens a process group of one
process). Without it, it is the production mesh when the launcher runs
on a world of 256 ranks (512 with ``--multi-pod``; a launcher such as
``torchrun`` sets ``WORLD_SIZE``, and the group is opened from the
environment), and the local mesh, printing ``[mesh] local (1, 1)``, in
a world of one process. ``--multi-pod`` on a world that is not 512 ranks
raises, naming the world's size. ``--device`` (the card unless given
``cpu``) is the port's own flag; with no card and no ``--device`` the
launcher raises. ``main`` returns the final parameters gathered into
plain tensors.

The reference jits its step with ``donate_argnums=(0, 1, 2)``. Here the
step is one body over the launcher's own state (:func:`make_body`):
``make_step``'s step, its new parameters, AdamW state and error-feedback
residual written into the buffers it read. On the card the first step is
the warm-up run of its capture and every later step replays the graph
(``repro_torch.captured.Programs``), the batch copied into static
DTensors of the batch's placements; the CPU runs the body eagerly. A
resume restores before the first step, so the graph is captured over the
restored weights; the checkpoints and the returned parameters read the
state's buffers.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs, tree
from repro_torch.captured import Programs, copy_into
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     production_world)
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.lm.config import ShapeCell
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.optim.compression import ef_compress, ef_init

__all__ = ["StragglerWatchdog", "make_step", "make_body", "launch_mesh",
           "parser", "main"]


class StragglerWatchdog:
    """Aborts a hung step so the launcher can restart from the last
    checkpoint: ``SIGALRM`` after ``timeout_s`` raises ``TimeoutError`` in
    the main thread; leaving the block disarms it and puts the previous
    handler back. 0 disables."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._previous = None

    def __enter__(self):
        if self.timeout_s > 0:
            self._previous = signal.signal(signal.SIGALRM, self._fire)
            signal.setitimer(signal.ITIMER_REAL, self.timeout_s)
        return self

    def _fire(self, *_):
        raise TimeoutError(f"step exceeded {self.timeout_s}s (straggler?)")

    def __exit__(self, *exc):
        if self.timeout_s > 0:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, self._previous)
        return False


def make_step(cfg, opt: AdamW, use_ef: bool):
    """The launcher's step: (params, opt_state, ef_state, batch) ->
    (params, opt_state, ef_state, loss), ``make_train_step`` with the
    gradients through ``ef_compress`` when ``use_ef``."""
    def train_step(params, opt_state, ef_state, batch):
        loss, grads = steps.lm_value_and_grad(params, cfg, batch)
        if use_ef:
            grads, ef_state = ef_compress(grads, ef_state)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, ef_state, loss
    return train_step


def make_body(cfg, opt: AdamW, use_ef: bool):
    """The launcher's step as the body the card captures: ``body(state,
    batch) -> loss``, ``state`` = (params, opt_state, ef_state) getting
    :func:`make_step`'s new values in place."""
    step = make_step(cfg, opt, use_ef)

    def body(state, batch):
        *new, loss = step(*state, batch)
        copy_into(state, tuple(new))
        return loss
    return body


def _world(dev: torch.device) -> int:
    """The process group's size, the group opened from the environment
    first when a launcher started this process as one of several."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dist.get_world_size() if dist.is_initialized() else 1


def launch_mesh(smoke: bool, multi_pod: bool, dev: torch.device):
    """The launcher's mesh (the module docstring)."""
    world = _world(dev)
    if multi_pod and world != production_world(True):
        raise RuntimeError(
            f"--multi-pod needs a world of {production_world(True)} ranks "
            f"(2 pods x 16 x 16); this launch has a world of {world}")
    if smoke:
        return make_local_mesh(dev)
    if world == production_world(multi_pod):
        return make_production_mesh(multi_pod=multi_pod, device=dev)
    if world != 1:
        raise RuntimeError(
            f"the production mesh needs a world of {production_world()} "
            f"ranks; this launch has a world of {world}")
    print("[mesh] local (1, 1)", flush=True)
    return make_local_mesh(dev)


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="none",
                    choices=["none", "qat_w4a8"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "ef8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--spmd-timeout", type=float, default=0.0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the current CUDA device by default; cpu runs the "
                         "plain PyTorch path")
    return ap


def main(argv=None) -> argparse.Namespace:
    """Run the launcher. Returns the parsed flags with what the run left:
    ``_cfg``, ``_params`` (the final parameters) and ``_log`` (one
    ``(step, loss, seconds since the loop began)`` per logged step, the
    clock unrounded). A process group the launcher opens for its mesh
    is closed when it returns or raises; one already open is left so."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    opened = not dist.is_initialized()
    try:
        return _train(args, dev)
    finally:
        if opened and dist.is_initialized():
            dist.destroy_process_group()


def _train(args: argparse.Namespace, dev: torch.device
           ) -> argparse.Namespace:
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    cfg = dataclasses.replace(cfg, quant_mode=args.quant,
                              dtype=torch.float32 if args.smoke
                              else cfg.dtype,
                              attn_chunk_q=min(1024, args.seq),
                              ssm_chunk=min(cfg.ssm_chunk, args.seq))

    mesh = launch_mesh(args.smoke, args.multi_pod, dev)
    cell = ShapeCell("custom", args.seq, args.batch, "train")

    params = tfm.init_lm(cfg, seed=0, device=dev)
    p_sh = shd.to_shardings(shd.param_specs(params, cfg, mesh), mesh)
    params = shd.place(params, p_sh)
    opt = AdamW(lr=cosine_schedule(args.lr, args.steps // 10, args.steps),
                weight_decay=0.1, grad_clip=1.0)
    opt_state = opt.init(params)
    use_ef = args.grad_compression == "ef8"
    ef_state = ef_init(params) if use_ef else None

    ckpt_dir = args.ckpt_dir or os.path.join("artifacts", "ckpt",
                                             cfg.name.replace("/", "_"))
    mgr = CheckpointManager(ckpt_dir, keep=2)
    start_step = 0
    latest = mgr.latest_step()
    if latest is not None:
        print(f"[resume] restoring step {latest} from {ckpt_dir}",
              flush=True)
        params = mgr.restore(latest, params, device=dev, shardings=p_sh)
        start_step = latest + 1

    b_sh = shd.to_shardings(shd.batch_specs(cfg, cell, mesh), mesh)
    body = make_body(cfg, opt, use_ef)
    program = Programs(device=dev, name="the launcher's step",
                       state=(params, opt_state, ef_state))
    del params, opt_state, ef_state
    log = []
    loss = None
    t_start = time.monotonic()
    data_iter = synthetic_token_batches(cfg, args.batch, args.seq, seed=17)
    with contextlib.closing(data_iter), implicit_replication():
        for step in range(start_step, args.steps):
            batch = {k: distribute_tensor(
                torch.from_numpy(v).to(dev), mesh,
                b_sh.get(k, b_sh.get("tokens")).placements)
                for k, v in next(data_iter).items()}
            with StragglerWatchdog(args.spmd_timeout):
                loss = program.run("step", body, batch=batch)
            loss = _full(loss).clone()
            if step % 10 == 0 or step == args.steps - 1:
                loss_f = float(loss)
                elapsed = time.monotonic() - t_start
                log.append((step, loss_f, elapsed))
                print(f"step {step:5d} loss {loss_f:.4f} ({elapsed:.1f}s)",
                      flush=True)
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                mgr.save(step, program.state[0],
                         extra={"loss": float(loss)})

    params = program.state[0]
    args._cfg, args._params, args._log = cfg, tree.tree_map(_full,
                                                           params), log
    if loss is None:
        print(f"done: step {args.steps - 1} was already checkpointed")
        return args
    mgr.save(args.steps - 1, params, extra={"loss": float(loss)})
    losses = [f for _, f, _ in log]
    print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss did not improve"
    return args


if __name__ == "__main__":
    main()
