"""Training launcher of the LMs (every arch of ``configs.ARCH_IDS``):
counterpart of ``repro/launch/train.py``, on one device.

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

There is no mesh: ``--multi-pod`` (the reference's production mesh over
pods) raises ``NotImplementedError``, as mesh and sharding are ROADMAP.md
§A item 3. ``--device`` (the card unless given ``cpu``) is the port's own
flag; with no card and no ``--device`` the launcher raises.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models.lm import transformer as tfm
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.optim.compression import ef_compress, ef_init

__all__ = ["StragglerWatchdog", "make_step", "parser", "main"]


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
    clock unrounded)."""
    args = parser().parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod needs the production device mesh over pods: mesh "
            "and sharding are ROADMAP.md §A item 3; the port trains on one "
            "device")
    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    cfg = dataclasses.replace(cfg, quant_mode=args.quant,
                              dtype=torch.float32 if args.smoke
                              else cfg.dtype,
                              attn_chunk_q=min(1024, args.seq),
                              ssm_chunk=min(cfg.ssm_chunk, args.seq))

    params = tfm.init_lm(cfg, seed=0, device=dev)
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
        params = mgr.restore(latest, params, device=dev)
        start_step = latest + 1

    step_fn = make_step(cfg, opt, use_ef)
    log = []
    loss = None
    t_start = time.monotonic()
    data_iter = synthetic_token_batches(cfg, args.batch, args.seq, seed=17)
    with contextlib.closing(data_iter):
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(data_iter).items()}
            with StragglerWatchdog(args.spmd_timeout):
                params, opt_state, ef_state, loss = step_fn(
                    params, opt_state, ef_state, batch)
            if step % 10 == 0 or step == args.steps - 1:
                loss_f = float(loss)
                elapsed = time.monotonic() - t_start
                log.append((step, loss_f, elapsed))
                print(f"step {step:5d} loss {loss_f:.4f} ({elapsed:.1f}s)",
                      flush=True)
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                mgr.save(step, params, extra={"loss": float(loss)})

    args._cfg, args._params, args._log = cfg, params, log
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
