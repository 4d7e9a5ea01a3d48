"""Step functions of the LM (train, prefill and serve), the input specs
of a shape cell and the abstract trees: counterpart of
``repro/launch/steps.py``.

``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` return
plain callables over the port's ``lm_loss``, ``forward`` and
``decode_step``, run eagerly: on plain tensors on one device, or on
DTensors placed on a device mesh (``launch/sharding.py``), where DTensor
propagates the placements op by op (call them under
``torch.distributed.tensor.experimental.implicit_replication()``: the
model makes plain tensors, RoPE tables and masks, that meet the
parameters). ``lm_value_and_grad`` is
``jax.value_and_grad(lm_loss)``, with zeros for a leaf the loss does not
reach, as JAX gives them. ``input_specs``, ``abstract_params``,
``abstract_cache`` and ``abstract_opt_state`` give the shapes and dtypes
of the JAX functions' ``ShapeDtypeStruct``s as tensors on the ``meta``
device: no weight is drawn and no memory allocated, so the 110B config's
tree takes milliseconds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.launch.sharding import placements
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.lm.config import LMConfig, ShapeCell
from repro_torch.optim.adamw import AdamW, AdamWState

__all__ = ["lm_value_and_grad", "constrain_grads", "make_train_step",
           "make_prefill_step", "make_serve_step", "input_specs",
           "abstract_params", "abstract_cache", "abstract_opt_state"]


def lm_value_and_grad(params, cfg: LMConfig, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, dict]:
    """(loss, grads) of ``lm_loss`` at ``params`` (a tree of float
    tensors, left as they are): the gradient tree has the parameters'
    structure, and a leaf with no path to the loss (the untied ``embed``
    of an embedding frontend) gets zeros, as ``jax.value_and_grad``
    gives, so the optimizer's weight decay and the error-feedback
    residual see it as in JAX."""
    flat = tree.items(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for _, p in flat]
        loss = tfm.lm_loss(tree.unflatten(
            params, {k: v for (k, _), v in zip(flat, leaves)}), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree.unflatten(params, {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(flat, grads)})


def constrain_grads(grads, params, grad_specs):
    """Each DTensor gradient redistributed to the placements its
    ``PartitionSpec`` gives on its parameter's mesh (a partial sum over
    the data axes then lowers as a reduce-scatter, not an all-reduce); a
    plain tensor's gradient is left as it is."""
    def leaf(g, p, spec):
        if not isinstance(p, DTensor):
            return g
        return g.redistribute(p.device_mesh, placements(spec, p.device_mesh))
    return tree.tree_map(leaf, grads, params, grad_specs)


def make_train_step(cfg: LMConfig, opt: AdamW,
                    grad_specs=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, loss): one
    ``opt.update`` on :func:`lm_value_and_grad`'s gradients.

    grad_specs: optional PartitionSpec tree (``sharding.param_specs``);
    each gradient is redistributed to it right after autodiff
    (:func:`constrain_grads`), the reference's ZeRO-2-style constraint."""

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = lm_value_and_grad(params, cfg, batch)
        if grad_specs is not None:
            grads = constrain_grads(grads, params, grad_specs)
        new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, loss

    return train_step


def make_prefill_step(cfg: LMConfig) -> Callable:
    """(params, batch) -> logits (B, S, V) float32. Inference prefill: the
    full forward over ``batch["tokens"]`` or ``batch["embeds"]``, with no
    cache write-back."""

    def prefill_step(params, batch):
        logits, _ = tfm.forward(params, cfg, tokens=batch.get("tokens"),
                                embeds=batch.get("embeds"))
        return logits

    return prefill_step


def make_serve_step(cfg: LMConfig) -> Callable:
    """(params, cache, tokens, cur_index) -> (logits, cache). One new
    token (or (B, 1, d) embedding) against the KV cache, updated in
    place."""

    def serve_step(params, cache, tokens, cur_index):
        return tfm.decode_step(params, cfg, cache, tokens, cur_index)

    return serve_step


def input_specs(cfg: LMConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Stand-ins (``meta`` tensors) for every model input of this cell."""
    B, S = cell.global_batch, cell.seq_len

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    tok = spec((B, S), torch.int32)
    if cell.kind in ("train", "prefill"):
        x = ({"tokens": tok} if cfg.frontend == "token"
             else {"embeds": spec((B, S, cfg.d_model), cfg.dtype)})
        return dict(x, labels=tok) if cell.kind == "train" else x
    # decode: one new token against a cache of length S
    if cfg.frontend == "token":
        return {"tokens": spec((B, 1), torch.int32)}
    return {"embeds": spec((B, 1, cfg.d_model), cfg.dtype)}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _float_params(cfg: LMConfig):
    """``init_lm``'s tree for ``cfg`` as meta tensors: the same keys,
    shapes and dtypes, nothing drawn."""
    G = tfm.n_groups(cfg)
    d, V, pdt, f32 = cfg.d_model, cfg.vocab, cfg.param_dtype, torch.float32
    nh, nkv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

    def w(*shape, dtype=pdt):
        return _meta(shape, dtype)

    def attn(*lead):
        a = {"wq": w(*lead, d, nh * hd), "wk": w(*lead, d, nkv * hd),
             "wv": w(*lead, d, nkv * hd), "wo": w(*lead, nh * hd, d)}
        if cfg.qkv_bias:
            a.update(bq=w(*lead, nh * hd), bk=w(*lead, nkv * hd),
                     bv=w(*lead, nkv * hd))
        if cfg.qk_norm:
            a["tau"] = w(*lead, dtype=f32)
        return a

    def mlp(*lead):
        if cfg.mlp_kind == "swiglu":
            return {"wg": w(*lead, d, ff), "wu": w(*lead, d, ff),
                    "wd": w(*lead, ff, d)}
        return {"wi": w(*lead, d, ff), "wd": w(*lead, ff, d)}

    p = {"embed": w(V, d), "final_norm": w(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = w(d, V)
    if cfg.block_pattern == "transformer":
        blocks = {"ln1": w(G, d), "ln2": w(G, d), "attn": attn(G)}
        if cfg.moe:
            E = cfg.n_experts
            blocks["moe"] = {"router": w(G, d, E, dtype=f32),
                             "wg": w(G, E, d, ff), "wu": w(G, E, d, ff),
                             "wd": w(G, E, ff, d)}
        elif cfg.mlp_kind != "none":
            blocks["mlp"] = mlp(G)
    elif cfg.block_pattern == "zamba2":
        lead = (G, cfg.zamba_mamba_per_attn)
        di, H = cfg.d_inner, cfg.n_ssm_heads
        GN = cfg.ssm_groups * cfg.ssm_state
        m = {"w_z": w(*lead, d, di), "w_x": w(*lead, d, di),
             "w_B": w(*lead, d, GN), "w_C": w(*lead, d, GN),
             "w_dt": w(*lead, d, H), "conv_w": w(*lead, 4, di),
             "conv_b": w(*lead, di), "A_log": w(*lead, H, dtype=f32),
             "D": w(*lead, H, dtype=f32), "dt_bias": w(*lead, H, dtype=f32),
             "norm_w": w(*lead, di), "out_proj": w(*lead, di, d)}
        blocks = {"mamba": {"ln": w(*lead, d), "m": m}}
        p["shared"] = {"ln1": w(d), "ln2": w(d), "attn": attn(),
                       "mlp": mlp()}
    else:
        lead = (G, cfg.xlstm_mlstm_per_slstm)
        di = d * cfg.xlstm_proj_factor
        H = cfg.n_heads
        dk, dv, dh = di // H // 2, di // H, d // H
        mb = {"w_gate": w(*lead, d, di), "w_up": w(*lead, d, di),
              "wq": w(*lead, di, H * dk), "wk": w(*lead, di, H * dk),
              "wv": w(*lead, di, H * dv), "wif": w(*lead, di, 2 * H),
              "norm_w": w(*lead, di), "down": w(*lead, di, d)}
        sb = {"w_in": w(G, d, 4 * d), "r": w(G, H, dh, 4 * dh),
              "b": w(G, 4 * d), "norm_w": w(G, d), "down": w(G, d, d)}
        blocks = {"mlstm": {"ln": w(*lead, d), "b": mb},
                  "slstm": {"ln": w(G, d), "b": sb}}
    p["blocks"] = blocks
    return p


def abstract_params(cfg: LMConfig):
    """The parameter tree of ``cfg`` as meta tensors; in a serve mode
    quantized as ``quant.apply.quantize_params_tree`` quantizes it
    (``(codes, scale)`` tuples)."""
    if not cfg.quant_mode.startswith("serve"):
        return _float_params(cfg)
    from repro_torch.quant.apply import quantize_params_tree
    return quantize_params_tree(
        _float_params(dataclasses.replace(cfg, quant_mode="none")), cfg)


def abstract_cache(cfg: LMConfig, cell: ShapeCell):
    """``init_cache(cfg, cell.global_batch, cell.seq_len)`` as meta
    tensors."""
    return tfm.init_cache(cfg, cell.global_batch, cell.seq_len,
                          device="meta")


def abstract_opt_state(cfg: LMConfig, opt: AdamW) -> AdamWState:
    """``opt.init`` of :func:`abstract_params`, as meta tensors."""
    return opt.init(abstract_params(cfg))
