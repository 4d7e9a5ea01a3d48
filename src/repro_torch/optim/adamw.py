"""AdamW and a cosine learning-rate schedule: counterpart of
``repro/optim/adamw.py``.

Parameters, gradients and moments are trees of tensors
(``repro_torch.tree``): the SO3 trainer's flat ``{name: tensor}`` dicts
and the LM's nested dicts with stacked per-layer leaves alike. The
global norm of the clip sums the leaves in JAX's order (dict keys
sorted, sequences by index), as ``jax.tree.leaves`` lists them. The
step count is an int32 tensor as in the JAX state; the bias corrections
and the learning rate are float32 tensors on the parameters' device, as
the JAX package takes them in float32, and nothing here reads a value
back to the host. Scalar divisors are tensors (IEEE division on every
device).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWState", "AdamW", "cosine_schedule"]

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, the count of updates taken
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
        some = leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=some.device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState,
               params: Tree) -> Tuple[Tree, AdamWState]:
        step = state.step + 1
        if self.grad_clip > 0:
            gnorm = torch.sqrt(sum((g ** 2).sum() for g in leaves(grads)))
            scale = torch.minimum(
                torch.ones_like(gnorm),
                torch.full_like(gnorm, self.grad_clip) / (gnorm + 1e-9))
            grads = tree_map(lambda g: g * scale, grads)
        # the reference's formulas op for op, each op in place on the
        # leaf's own temporaries: the same roundings, a third of the
        # buffers (allocating a fresh buffer per op dominated the CPU's
        # time at the LM's widths)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: torch.mul(m, b1).add_(
            torch.mul(g, 1 - b1)), state.mu, grads)
        nu = tree_map(lambda n, g: torch.mul(n, b2).add_(
            torch.mul(g, 1 - b2).mul_(g)), state.nu, grads)
        t = step.to(torch.float32)
        bc1 = 1 - torch.full_like(t, b1) ** t
        bc2 = 1 - torch.full_like(t, b2) ** t
        lr = self.lr(step) if callable(self.lr) \
            else torch.full_like(t, self.lr)

        def upd(p, m, n):
            # p - lr * ((m / bc1) / (sqrt(n / bc2) + eps) + wd * p)
            den = torch.div(n, bc2).sqrt_().add_(self.eps)
            u = torch.div(m, bc1).div_(den).add_(
                torch.mul(p, self.weight_decay))
            return torch.sub(p, u.mul_(lr))
        new = tree_map(upd, params, mu, nu)
        return new, AdamWState(step=step, mu=mu, nu=nu)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.0) -> Schedule:
    """Linear warm-up over ``warmup`` steps, then cosine decay to
    ``floor`` at ``total``; takes the step count as a tensor of any dtype
and returns a float32 tensor."""
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
