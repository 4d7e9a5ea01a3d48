"""LM assembly: parameters, the prefill forward and loss, the cache and
the decode step of the transformer block pattern.

Counterpart of ``n_groups``, ``init_lm``, ``forward``, ``lm_loss``,
``init_cache`` and ``decode_step`` of ``repro/models/lm/transformer.py``.
The parameter tree has the JAX package's layout (nested dicts, per-layer
leaves stacked on a leading depth axis, ``(q, scale)`` tuples once
quantized), so a JAX tree crosses over through
``weights.lm_params_from_numpy``. Where the JAX package scans over
layers, the port loops over them in Python: ``forward`` splits each
stacked leaf into its layers once (``torch.unbind``, one stacked
gradient buffer in the backward), and with ``cfg.remat`` recomputes each
layer in the backward (``torch.utils.checkpoint``, as the reference
wraps its group function in ``jax.checkpoint``). ``lm_loss`` is
differentiable: its value and the gradient of every leaf are held
against ``jax.value_and_grad`` of the reference's (plain and
``qat_w4a8``, ``tests/test_torch_lm_train.py``). A leaf with no path to
the loss (the untied ``embed`` of an embedding frontend) gets no
gradient from autograd, where JAX gives zeros:
``launch.steps.lm_value_and_grad`` fills them in. The ``zamba2`` and
``xlstm`` patterns and MoE blocks are ROADMAP.md §A item 2 and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import (apply_mlp, dense_init,
                                          params_to_torch, rmsnorm)

__all__ = ["n_groups", "init_lm", "forward", "lm_loss", "init_cache",
           "lm_head", "decode_step"]

Params = Dict[str, Any]


def _check_supported(cfg: LMConfig) -> None:
    if cfg.block_pattern != "transformer":
        raise NotImplementedError(
            f"block pattern {cfg.block_pattern!r}: only the transformer "
            "pattern is ported (ROADMAP.md §A item 2)")
    if cfg.moe:
        raise NotImplementedError("MoE blocks are not ported "
                                  "(ROADMAP.md §A item 2)")


def n_groups(cfg: LMConfig) -> int:
    """Entries on the parameter tree's depth axis: one per layer."""
    _check_supported(cfg)
    return cfg.n_layers


def init_lm(cfg: LMConfig, seed: int = 0,
            device: DeviceLike = None) -> Params:
    """Random parameters with the shapes and scales of the JAX
    ``init_lm`` (transformer pattern), drawn with numpy from ``seed``
    (not JAX's bits): embeddings N(0, 0.02^2), projections
    N(0, 1) / sqrt(fan_in), norms 1, QKV biases 0, ``tau`` = attn_tau,
    all ``cfg.param_dtype`` but ``tau`` (float32).
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, L = cfg.d_model, cfg.n_layers

    def ones(*shape):
        return np.ones(shape, np.float32)

    p: Params = {"embed": rng.standard_normal((cfg.vocab, d),
                                              dtype=np.float32)
                 * np.float32(0.02),
                 "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(rng, d, cfg.vocab)
    blocks = {"ln1": ones(L, d), "ln2": ones(L, d),
              "attn": attn.attention_arrays(cfg, rng, L)}
    if cfg.mlp_kind == "swiglu":
        blocks["mlp"] = {"wg": dense_init(rng, d, cfg.d_ff, L),
                         "wu": dense_init(rng, d, cfg.d_ff, L),
                         "wd": dense_init(rng, cfg.d_ff, d, L)}
    elif cfg.mlp_kind == "squared_relu":
        blocks["mlp"] = {"wi": dense_init(rng, d, cfg.d_ff, L),
                         "wd": dense_init(rng, cfg.d_ff, d, L)}
    p["blocks"] = blocks
    return params_to_torch(p, cfg, dev)


def init_cache(cfg: LMConfig, batch: int, seq: int,
               device: DeviceLike = None) -> Params:
    """Zeroed KV cache for ``seq`` positions, leaves stacked over layers:
    ``{"blocks": {"k_q", "v_q", "k_s", "v_s"}}`` (int8 cache) or
    ``{"blocks": {"k", "v"}}`` in ``cfg.dtype``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    one = attn.init_kv_cache(cfg, batch, seq, cfg.dtype, dev)
    return {"blocks": {k: v[None].repeat(cfg.n_layers, *([1] * v.ndim))
                       for k, v in one.items()}}


def _unstack(tree, n: int):
    """The n per-layer trees of a tree of stacked leaves, each leaf split
    once (``torch.unbind``). Under autograd the split's backward stacks
    the layers' gradients into one buffer; indexing ``tree[i]`` per layer
    would allocate and add a zero tensor of the whole stacked leaf n
    times."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_unstack(v, n) for v in tree]
        return [tuple(p[i] for p in parts) for i in range(n)]
    return torch.unbind(tree)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, i) for v in tree)
    return tree[i]


def lm_head(params: Params, cfg: LMConfig) -> torch.Tensor:
    """The output projection (d, V) in ``cfg.dtype``. A serving loop makes
    it once and hands it to every :func:`decode_step` (for tied embeddings
    in bf16 that saves re-reading and re-rounding the float32 embedding
    table on every step; the rounding is the same)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(cfg.dtype)


def _norm(cfg: LMConfig):
    def norm(h, w):
        return rmsnorm(h, w, f32_stats=cfg.norm_f32)
    return norm


def _block(g: Params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """One transformer layer (attention, then the MLP) on its own
    parameters ``g``."""
    norm = _norm(cfg)
    x = x + attn.causal_attention(g["attn"], norm(x, g["ln1"]), cfg)
    if cfg.mlp_kind != "none":
        x = x + apply_mlp(g["mlp"], norm(x, g["ln2"]), cfg)
    return x


def forward(params: Params, cfg: LMConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward (the prefill). tokens: (B, S) integer ids,
    or embeds: (B, S, d) for non-token frontends. Returns (logits (B, S,
    V) float32, aux): ``aux`` is a 0-dim float32 zero, the MoE balance
    loss that dense blocks do not have. With ``cfg.remat`` and grad mode
    on, each layer's activations are recomputed in the backward."""
    _check_supported(cfg)
    if embeds is not None:
        x = embeds.to(cfg.dtype)
    else:
        x = params["embed"][tokens.long()].to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in _unstack(params["blocks"], n_groups(cfg)):
        if remat:
            x = checkpoint(_block, g, x, cfg, use_reentrant=False)
        else:
            x = _block(g, x, cfg)
    norm = _norm(cfg)
    x = norm(x, params["final_norm"])
    logits = (x @ lm_head(params, cfg)).to(torch.float32)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_loss(params: Params, cfg: LMConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross entropy over ``batch["labels"]`` (B, S), under
    ``batch.get("mask")`` (ones when absent) and divided by
    ``max(sum(mask), 1)``, plus 0.01 x the aux loss. Differentiable in
    every parameter that reaches it (the module's note on the rest)."""
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"))
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    mask = mask.to(torch.float32)
    ce = torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)
    return ce + 0.01 * aux


def decode_step(params: Params, cfg: LMConfig, cache: Params,
                tokens: torch.Tensor, cur_index: int,
                head: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1) integer ids, or (B, 1, d)
    embeddings for non-token frontends; ``cur_index``: the position this
    token takes, a Python int in ``[0, cache_len)`` (``ValueError``
    otherwise). Updates ``cache`` in place; returns (logits (B, V) f32,
    cache). ``head`` is :func:`lm_head`'s result, made here when omitted.
    """
    _check_supported(cfg)
    if tokens.ndim == 3:
        x = tokens.to(cfg.dtype)
    else:
        x = params["embed"][tokens.long()].to(cfg.dtype)
    norm = _norm(cfg)
    for i in range(n_groups(cfg)):
        g = _layer(params["blocks"], i)
        c = _layer(cache["blocks"], i)
        h, _ = attn.decode_attention(g["attn"], norm(x, g["ln1"]), cfg, c,
                                     cur_index)
        x = x + h
        if cfg.mlp_kind != "none":
            x = x + apply_mlp(g["mlp"], norm(x, g["ln2"]), cfg)
    x = norm(x, params["final_norm"])
    if head is None:
        head = lm_head(params, cfg)
    logits = (x[:, 0] @ head).to(torch.float32)
    return logits, cache
