"""Mixture-of-Experts layer: a top-k router and grouped, capacity-bounded
dispatch. Counterpart of ``repro/models/lm/moe.py``, in plain PyTorch
einsums where the reference has jnp ones.

Tokens are routed in groups of ``Tg = min(MOE_GROUP, B * S)``; each
token picks its top-k experts by router probability, and each expert
takes at most ``C = max(int(Tg * k / E * capacity_factor), 1)`` choices
of a group (a truncation, as the reference computes it). A choice's place
in its expert's buffer is an exclusive cumulative sum over the group's
``Tg * k`` choices, token-major and choice-minor; a choice past ``C`` is
dropped (it adds zero, the residual passes). The router runs in float32
whatever the quantization mode. Ties among equal probabilities go to the
lower expert index, as ``jax.lax.top_k`` breaks them (a stable
descending sort; ``torch.topk`` promises no order among ties).

A decode step routes its ``B`` tokens as one group, so its capacity is
``max(int(B * k / E * capacity_factor), 1)`` and a decode does not
reproduce the prefill's routing (nor does the reference's).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quantizers import unpack_int4
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm.layers import (dense_init, normal_init,
                                          params_to_torch, silu)

__all__ = ["MOE_GROUP", "moe_arrays", "init_moe", "capacity",
           "moe_forward"]

MOE_GROUP = 512  # tokens per routing group


def _expert_w(w, dt: torch.dtype) -> torch.Tensor:
    """Expert weights in ``dt``: float, or serve-quantized ``(q, scale)``
    (int8, or uint8 int4 nibbles), dequantized whole at every call."""
    if isinstance(w, tuple):
        wq, s = w
        if wq.dtype == torch.uint8:
            wq = unpack_int4(wq)
        return wq.to(dt) * s.to(dt)
    return w.to(dt)


def moe_arrays(cfg, rng: np.random.Generator, depth=None):
    """The MoE block's parameters as float32 numpy arrays with the shapes
    and scales of the JAX ``init_moe``, stacked on the leading ``depth``
    axes: ``router`` (d, E) (kept float32 by ``params_to_torch``), the
    experts ``wg``/``wu`` (E, d, ff) / sqrt(d) and ``wd`` (E, ff, d) /
    sqrt(ff)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": dense_init(rng, d, E, depth),
            "wg": normal_init(rng, (E, d, ff), d, depth),
            "wu": normal_init(rng, (E, d, ff), d, depth),
            "wd": normal_init(rng, (E, ff, d), ff, depth)}


def init_moe(cfg, rng=0, device: DeviceLike = None):
    """One MoE block's random parameters, drawn with numpy from ``rng`` (a
    seed or a ``np.random.Generator``), not JAX's bits."""
    return params_to_torch(moe_arrays(cfg, np.random.default_rng(rng)), cfg,
                           resolve_device(device))


def capacity(cfg, Tg: int) -> int:
    """Choices each expert takes from a group of ``Tg`` tokens."""
    return max(int(Tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest probabilities, ties to the lower
    index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_group(params, xg: torch.Tensor, cfg, C: int):
    """xg: (ng, Tg, d) -> dispatch, combine (ng, Tg, E, C) float32, aux."""
    ng, Tg, _ = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = xg.to(torch.float32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)                      # (ng, Tg, E)
    gate_vals, expert_idx = _top_k(probs, k)                   # (ng, Tg, k)

    onehot = F.one_hot(expert_idx, E)                          # (ng,Tg,k,E)
    flat = onehot.reshape(ng, Tg * k, E)
    pos = torch.cumsum(flat, dim=1) - flat                     # exclusive
    pos = (pos * flat).sum(-1).reshape(ng, Tg, k)
    keep = pos < C

    oh_e = onehot.to(torch.float32)
    oh_c = F.one_hot(torch.where(keep, pos, C), C + 1).to(
        torch.float32)[..., :C]                                # (ng,Tg,k,C)
    dispatch = torch.einsum("gtke,gtkc->gtec", oh_e, oh_c)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", oh_e, oh_c,
                           gate_vals * keep.to(torch.float32))

    # Switch load-balance loss: E * sum_e fraction_e * router_prob_e
    f = dispatch.sum((1, 3)) / torch.clamp(dispatch.sum((1, 2, 3)),
                                           min=1.0)[..., None]  # (ng, E)
    p = probs.mean(1)
    aux = E * torch.mean(torch.sum(f * p, dim=-1))
    return dispatch, combine, aux


def moe_forward(params, x: torch.Tensor, cfg):
    """x: (B, S, d) -> ((B, S, d), the balance loss, a 0-dim float32).
    ``B * S`` must be a multiple of the group ``min(MOE_GROUP, B * S)``
    (``ValueError``)."""
    B, S, d = x.shape
    T = B * S
    Tg = min(MOE_GROUP, T)
    if T % Tg:
        raise ValueError(f"tokens {T} % group {Tg} != 0")
    ng = T // Tg
    xg = x.reshape(ng, Tg, d)
    dispatch, combine, aux = _route_group(params, xg, cfg, capacity(cfg, Tg))

    dt = x.dtype
    xe = torch.einsum("gtd,gtec->gecd", xg, dispatch.to(dt))   # (ng,E,C,d)
    g = torch.einsum("gecd,edf->gecf", xe, _expert_w(params["wg"], dt))
    u = torch.einsum("gecd,edf->gecf", xe, _expert_w(params["wu"], dt))
    h = silu(g) * u
    ye = torch.einsum("gecf,efd->gecd", h, _expert_w(params["wd"], dt))
    y = torch.einsum("gecd,gtec->gtd", ye, combine.to(dt))
    return y.reshape(B, S, d), aux
