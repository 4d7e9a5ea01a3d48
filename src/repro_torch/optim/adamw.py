"""AdamW and a cosine learning-rate schedule: counterpart of
``repro/optim/adamw.py``.

Parameters, gradients and moments are ``{name: tensor}`` dicts. The step
count, the bias corrections and the learning rate are float32 tensors on
the parameters' device, as the JAX package takes them in float32, and
nothing here reads a value back to the host. Scalar divisors are tensors
(IEEE division on every device).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

__all__ = ["AdamWState", "AdamW", "cosine_schedule"]

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor   # () float32, the count of updates taken
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Schedule] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # global-norm clip; 0 disables

    def init(self, params: Tree) -> AdamWState:
        some = next(iter(params.values()))
        return AdamWState(
            step=torch.zeros((), dtype=torch.float32, device=some.device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState,
               params: Tree) -> Tuple[Tree, AdamWState]:
        step = state.step + 1
        if self.grad_clip > 0:
            # the JAX package's leaf order: keys sorted
            gnorm = torch.sqrt(sum((grads[k] ** 2).sum()
                                   for k in sorted(grads)))
            scale = torch.minimum(
                torch.ones_like(gnorm),
                torch.full_like(gnorm, self.grad_clip) / (gnorm + 1e-9))
            grads = {k: g * scale for k, g in grads.items()}
        mu = {k: self.b1 * state.mu[k] + (1 - self.b1) * g
              for k, g in grads.items()}
        nu = {k: self.b2 * state.nu[k] + (1 - self.b2) * g * g
              for k, g in grads.items()}
        bc1 = 1 - torch.full_like(step, self.b1) ** step
        bc2 = 1 - torch.full_like(step, self.b2) ** step
        lr = self.lr(step) if callable(self.lr) \
            else torch.full_like(step, self.lr)
        new = {k: p - lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                             + self.eps)
                            + self.weight_decay * p)
               for k, p in params.items()}
        return new, AdamWState(step=step, mu=mu, nu=nu)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.0) -> Schedule:
    """Linear warm-up over ``warmup`` steps, then cosine decay to
    ``floor`` at ``total``; takes and returns float32 tensors."""
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / torch.full_like(step, max(warmup, 1))
        prog = torch.clamp((step - warmup)
                           / torch.full_like(step, max(total - warmup, 1)),
                           0.0, 1.0)
        cos = floor + (base_lr - floor) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return torch.where(step < warmup, warm, cos)
    return f
