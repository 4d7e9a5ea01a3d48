"""The MoE blocks' routing, recorded and pinned: how a gap between two
runs of one MoE model (the card against the CPU, the port against the
JAX package) is split into moved routing and arithmetic.

A router's float32 sums fall in another order on another device or in
another package, so a choice at a near tie of two probabilities can
move; since a choice's place in its expert's buffer is a cumulative sum
over the group, one moved choice can also change which later choices the
capacity keeps. :func:`routing_sites` records every routing's chosen
experts in call order (layer by layer, as the model runs them) and, with
``pin``, makes each routing take another run's choices (the gate values
are then the run's own probabilities at those choices); what is left of
a gap is arithmetic. :func:`moved_routing` counts, per routing, the
choices and the kept flags that differ between two runs.

    with routing_sites() as cpu_sites:
        want = run_on_the_cpu()
    with routing_sites(pin=cpu_sites):
        got = run_on_the_card()        # the CPU's routing, pinned

Not on the served path: ``moe_forward`` runs its own top-k unless this
context is active.
"""
from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.lm import moe

__all__ = ["routing_sites", "keep_of", "moved_routing"]


@contextlib.contextmanager
def routing_sites(pin=None):
    """Inside the block, every MoE routing appends its chosen experts
    (ng, Tg, k) to the yielded list as a CPU int64 tensor; with ``pin``
    (such a list from another run, in the same order: tensors or numpy
    arrays) each routing takes the pinned choices instead."""
    rec: List[torch.Tensor] = []
    pins = iter(pin or ())
    plain = moe._top_k

    def top_k(probs, k):
        vals, idx = plain(probs, k)
        if pin is not None:
            idx = torch.as_tensor(np.asarray(next(pins))).to(
                device=probs.device, dtype=torch.long)
            vals = torch.gather(probs, -1, idx)
        rec.append(idx.detach().cpu())
        return vals, idx

    moe._top_k = top_k
    try:
        yield rec
    finally:
        moe._top_k = plain


def keep_of(expert_idx, cfg) -> torch.Tensor:
    """The kept flags (ng, Tg, k) of a routing's choices (ng, Tg, k): the
    capacity of a group of Tg tokens, and each choice's place in its
    expert's buffer, as ``moe._route_group`` computes them."""
    idx = torch.as_tensor(np.asarray(expert_idx)).long()
    ng, Tg, k = idx.shape
    flat = F.one_hot(idx, cfg.n_experts).reshape(ng, Tg * k, -1)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1)
    return (pos < moe.capacity(cfg, Tg)).reshape(ng, Tg, k)


def moved_routing(a_sites, b_sites, cfg):
    """Per routing of two runs, (choices that differ, kept flags that
    differ)."""
    assert len(a_sites) == len(b_sites)
    moved = []
    for a, b in zip(a_sites, b_sites):
        ia = torch.as_tensor(np.asarray(a)).long()
        ib = torch.as_tensor(np.asarray(b)).long()
        moved.append((int((ia != ib).sum()),
                      int((keep_of(ia, cfg) != keep_of(ib, cfg)).sum())))
    return moved
