"""LM assembly: parameters, the prefill forward and loss, the cache and
the decode step of the three block patterns.

Counterpart of ``n_groups``, ``init_lm``, ``forward``, ``lm_loss``,
``init_cache`` and ``decode_step`` of ``repro/models/lm/transformer.py``.
The parameter tree has the JAX package's layout (nested dicts, per-group
leaves stacked on a leading depth axis, ``(q, scale)`` tuples once
quantized), so a JAX tree crosses over through
``weights.lm_params_from_numpy``. Block patterns, as in the reference:

- ``transformer``: ``n_layers`` groups of [attention + MLP or MoE]
  (``blocks["moe"]`` in place of ``mlp``);
- ``zamba2``: ``n_layers // zamba_mamba_per_attn`` groups of
  [``zamba_mamba_per_attn`` Mamba2 blocks (``blocks["mamba"]``, stacked
  over (groups, per group)) + ONE shared attention + MLP block
  (``params["shared"]``, not stacked), reused at every group's end];
- ``xlstm``: ``n_layers // (xlstm_mlstm_per_slstm + 1)`` groups of
  [``xlstm_mlstm_per_slstm`` mLSTM blocks + one sLSTM block].

Where the JAX package scans over groups, the port loops over them in
Python: ``forward`` splits each stacked leaf into its groups once
(``torch.unbind``, one stacked gradient buffer in the backward), and with
``cfg.remat`` recomputes each group in the backward
(``torch.utils.checkpoint``, as the reference wraps its group function
in ``jax.checkpoint``); the shared block's gradient sums over its uses.
``lm_loss`` is differentiable: its value and the gradient of every leaf
are held against ``jax.value_and_grad`` of the reference's. A leaf with
no path to the loss (the untied ``embed`` of an embedding frontend) gets
no gradient from autograd, where JAX gives zeros:
``launch.steps.lm_value_and_grad`` fills them in.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm import ssm as ssm_lib
from repro_torch.models.lm import xlstm as xlstm_lib
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import (apply_mlp, dense_init, mlp_arrays,
                                          params_to_torch, rmsnorm)

__all__ = ["n_groups", "init_lm", "forward", "lm_loss", "init_cache",
           "lm_head", "decode_step"]

Params = Dict[str, Any]


def n_groups(cfg: LMConfig) -> int:
    """Entries on the parameter tree's depth axis: one per layer
    (transformer), per Mamba2 group (zamba2) or per mLSTM/sLSTM group
    (xlstm)."""
    if cfg.block_pattern == "transformer":
        return cfg.n_layers
    if cfg.block_pattern == "zamba2":
        return cfg.n_layers // cfg.zamba_mamba_per_attn
    if cfg.block_pattern == "xlstm":
        return cfg.n_layers // (cfg.xlstm_mlstm_per_slstm + 1)
    raise ValueError(cfg.block_pattern)


def init_lm(cfg: LMConfig, seed: int = 0,
            device: DeviceLike = None) -> Params:
    """Random parameters with the tree, shapes and scales of the JAX
    ``init_lm``, drawn with numpy from ``seed`` (not JAX's bits):
    embeddings N(0, 0.02^2), projections N(0, 1) / sqrt(fan_in), norms
    1, QKV biases 0, ``tau`` = attn_tau, the families' own leaves as
    their modules draw them; all ``cfg.param_dtype`` but the float32
    leaves of ``layers.F32_LEAVES``.
    """
    G = n_groups(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def ones(*shape):
        return np.ones(shape, np.float32)

    p: Params = {"embed": rng.standard_normal((cfg.vocab, d),
                                              dtype=np.float32)
                 * np.float32(0.02),
                 "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(rng, d, cfg.vocab)
    if cfg.block_pattern == "transformer":
        blocks = {"ln1": ones(G, d), "ln2": ones(G, d),
                  "attn": attn.attention_arrays(cfg, rng, G)}
        if cfg.moe:
            blocks["moe"] = moe_lib.moe_arrays(cfg, rng, G)
        elif cfg.mlp_kind != "none":
            blocks["mlp"] = mlp_arrays(cfg, rng, G)
    elif cfg.block_pattern == "zamba2":
        per = cfg.zamba_mamba_per_attn
        blocks = {"mamba": {"ln": ones(G, per, d),
                            "m": ssm_lib.mamba2_arrays(cfg, rng, (G, per))}}
        p["shared"] = {"ln1": ones(d), "ln2": ones(d),
                       "attn": attn.attention_arrays(cfg, rng),
                       "mlp": mlp_arrays(cfg, rng)}
    else:
        M = cfg.xlstm_mlstm_per_slstm
        blocks = {"mlstm": {"ln": ones(G, M, d),
                            "b": xlstm_lib.mlstm_arrays(cfg, rng, (G, M))},
                  "slstm": {"ln": ones(G, d),
                            "b": xlstm_lib.slstm_arrays(cfg, rng, G)}}
    p["blocks"] = blocks
    return params_to_torch(p, cfg, dev)


def _rep(tree, *lead: int):
    """Each leaf of ``tree`` repeated over new leading axes ``lead``, as
    its own memory (the reference broadcasts; the port's decode writes
    each entry in place)."""
    if isinstance(tree, dict):
        return {k: _rep(v, *lead) for k, v in tree.items()}
    return tree.reshape((1,) * len(lead) + tree.shape).repeat(
        *lead, *([1] * tree.ndim))


def init_cache(cfg: LMConfig, batch: int, seq: int,
               device: DeviceLike = None) -> Params:
    """The decode state for ``seq`` positions, leaves stacked over groups:
    transformer ``{"blocks": kv}``; zamba2 ``{"blocks": {"mamba": {conv,
    ssm} (G, per, ...), "attn": kv}}``; xlstm ``{"blocks": {"mlstm":
    {state, norm} (G, M, ...), "slstm": {h, c, n, m}}}``. ``kv`` is
    ``{"k_q", "v_q", "k_s", "v_s"}`` (quantized cache) or ``{"k", "v"}``
    in ``cfg.dtype``; the conv cache is ``cfg.dtype``, the SSM and
    mLSTM state float32, the sLSTM's m -1e30."""
    G = n_groups(cfg)
    dev = resolve_device(device)
    dt = cfg.dtype
    if cfg.block_pattern == "transformer":
        return {"blocks": _rep(attn.init_kv_cache(cfg, batch, seq, dt, dev),
                               G)}
    if cfg.block_pattern == "zamba2":
        return {"blocks": {
            "mamba": _rep(ssm_lib.init_mamba2_cache(cfg, batch, dt, dev), G,
                          cfg.zamba_mamba_per_attn),
            "attn": _rep(attn.init_kv_cache(cfg, batch, seq, dt, dev), G)}}
    return {"blocks": {
        "mlstm": _rep(xlstm_lib.init_mlstm_cache(cfg, batch, dt, dev), G,
                      cfg.xlstm_mlstm_per_slstm),
        "slstm": _rep(xlstm_lib.init_slstm_cache(cfg, batch, dt, dev), G)}}


def _unstack(tree, n: int):
    """The n per-group trees of a tree of stacked leaves, each leaf split
    once (``torch.unbind``). Under autograd the split's backward stacks
    the groups' gradients into one buffer; indexing ``tree[i]`` per group
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


def _group_fn(cfg: LMConfig, shared: Optional[Params]):
    """f(g, x) -> (x, the MoE balance loss or None) for one group on its
    own parameters ``g`` (``shared``: zamba2's shared block)."""
    norm = _norm(cfg)

    def transformer_group(g, x):
        x = x + attn.causal_attention(g["attn"], norm(x, g["ln1"]), cfg)
        if cfg.moe:
            h, aux = moe_lib.moe_forward(g["moe"], norm(x, g["ln2"]), cfg)
            return x + h, aux
        if cfg.mlp_kind != "none":
            x = x + apply_mlp(g["mlp"], norm(x, g["ln2"]), cfg)
        return x, None

    def zamba_group(g, x):
        for mg in _unstack(g["mamba"], cfg.zamba_mamba_per_attn):
            x = x + ssm_lib.mamba2_forward(mg["m"], norm(x, mg["ln"]), cfg)
        s = shared
        x = x + attn.causal_attention(s["attn"], norm(x, s["ln1"]), cfg)
        return x + apply_mlp(s["mlp"], norm(x, s["ln2"]), cfg), None

    def xlstm_group(g, x):
        for mg in _unstack(g["mlstm"], cfg.xlstm_mlstm_per_slstm):
            x = x + xlstm_lib.mlstm_forward(mg["b"], norm(x, mg["ln"]), cfg)
        sg = g["slstm"]
        return x + xlstm_lib.slstm_forward(sg["b"], norm(x, sg["ln"]),
                                           cfg), None

    return {"transformer": transformer_group, "zamba2": zamba_group,
            "xlstm": xlstm_group}[cfg.block_pattern]


def forward(params: Params, cfg: LMConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward (the prefill). tokens: (B, S) integer ids,
    or embeds: (B, S, d) for non-token frontends. Returns (logits (B, S,
    V) float32, aux): ``aux`` is the MoE balance loss summed over the
    groups and divided by their number, a 0-dim float32 (zero without
    MoE blocks). With ``cfg.remat`` and grad mode on, each group's
    activations are recomputed in the backward."""
    G = n_groups(cfg)
    if embeds is not None:
        x = embeds.to(cfg.dtype)
    else:
        x = params["embed"][tokens.long()].to(cfg.dtype)
    group = _group_fn(cfg, params.get("shared"))
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in _unstack(params["blocks"], G):
        if remat:
            x, a = checkpoint(group, g, x, use_reentrant=False)
        else:
            x, a = group(g, x)
        if a is not None:
            aux = aux + a
    x = _norm(cfg)(x, params["final_norm"])
    logits = (x @ lm_head(params, cfg)).to(torch.float32)
    return logits, aux / G


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
                tokens: torch.Tensor, cur_index: Union[int, torch.Tensor],
                head: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1) integer ids, or (B, 1, d)
    embeddings for non-token frontends; ``cur_index``: the position this
    token takes, a Python int in ``[0, cache_len)`` (``ValueError``
    otherwise, where a KV cache is written) or, as the reference's traced
    ``cur_index``, a 0-d int32 tensor on the model's device, which the
    step reads only there (no host sync; the caller checks its range).
    The recurrent blocks (Mamba2, mLSTM, sLSTM) take no position. The
    same position gives the same result either way. Updates ``cache`` in
    place; returns (logits (B, V) f32, cache). ``head`` is :func:`lm_head`'s
    result, made here when omitted. A MoE block routes the step's B
    tokens as one group (see ``moe.py``).
    """
    if tokens.ndim == 3:
        x = tokens.to(cfg.dtype)
    else:
        x = params["embed"][tokens.long()].to(cfg.dtype)
    norm = _norm(cfg)
    shared = params.get("shared")
    for i in range(n_groups(cfg)):
        g = _layer(params["blocks"], i)
        c = _layer(cache["blocks"], i)
        if cfg.block_pattern == "transformer":
            h, _ = attn.decode_attention(g["attn"], norm(x, g["ln1"]), cfg,
                                         c, cur_index)
            x = x + h
            if cfg.moe:
                x = x + moe_lib.moe_forward(g["moe"], norm(x, g["ln2"]),
                                            cfg)[0]
            elif cfg.mlp_kind != "none":
                x = x + apply_mlp(g["mlp"], norm(x, g["ln2"]), cfg)
        elif cfg.block_pattern == "zamba2":
            for j in range(cfg.zamba_mamba_per_attn):
                mg = _layer(g["mamba"], j)
                x = x + ssm_lib.mamba2_step(mg["m"], norm(x, mg["ln"]), cfg,
                                            _layer(c["mamba"], j))[0]
            h, _ = attn.decode_attention(shared["attn"],
                                         norm(x, shared["ln1"]), cfg,
                                         c["attn"], cur_index)
            x = x + h
            x = x + apply_mlp(shared["mlp"], norm(x, shared["ln2"]), cfg)
        else:
            for j in range(cfg.xlstm_mlstm_per_slstm):
                mg = _layer(g["mlstm"], j)
                x = x + xlstm_lib.mlstm_step(mg["b"], norm(x, mg["ln"]), cfg,
                                             _layer(c["mlstm"], j))[0]
            sg = g["slstm"]
            x = x + xlstm_lib.slstm_step(sg["b"], norm(x, sg["ln"]), cfg,
                                         c["slstm"])[0]
    x = norm(x, params["final_norm"])
    if head is None:
        head = lm_head(params, cfg)
    logits = (x[:, 0] @ head).to(torch.float32)
    return logits, cache
