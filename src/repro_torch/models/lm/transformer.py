"""LM assembly for decode: parameters, cache and the decode step of the
transformer block pattern.

Counterpart of ``init_lm``, ``init_cache`` and ``decode_step`` of
``repro/models/lm/transformer.py``. The parameter tree has the JAX
package's layout (nested dicts, per-layer leaves stacked on a leading
depth axis, ``(q, scale)`` tuples once quantized), so a JAX tree crosses
over through ``weights.lm_params_from_numpy``. Where the JAX package
scans over layers, the port loops over them in Python. The ``zamba2`` and
``xlstm`` patterns and MoE blocks are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import apply_mlp, rmsnorm

__all__ = ["init_lm", "init_cache", "lm_head", "decode_step"]

Params = Dict[str, Any]


def _check_supported(cfg: LMConfig) -> None:
    if cfg.block_pattern != "transformer":
        raise NotImplementedError(
            f"block pattern {cfg.block_pattern!r}: only the transformer "
            "pattern is ported (ROADMAP.md §A)")
    if cfg.moe:
        raise NotImplementedError("MoE blocks are not ported "
                                  "(ROADMAP.md §A)")


def init_lm(cfg: LMConfig, seed: int = 0,
            device: DeviceLike = None) -> Params:
    """Random parameters with the shapes and scales of the JAX
    ``init_lm`` (transformer pattern), drawn with numpy from ``seed``
    (not JAX's bits): embeddings N(0, 0.02^2), projections
    N(0, 1) / sqrt(fan_in), norms 1, QKV biases 0, all ``cfg.param_dtype``.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.hd
    nh, nkv = cfg.n_heads, cfg.n_kv_heads

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    def stacked(fan_in, fan_out):
        w = np.empty((L, fan_in, fan_out), np.float32)
        for i in range(L):
            rng.standard_normal((fan_in, fan_out), dtype=np.float32,
                                out=w[i])
        w /= np.sqrt(np.float32(fan_in))
        return w

    def ones(*shape):
        return np.ones(shape, np.float32)

    p: Params = {"embed": normal(cfg.vocab, d) * np.float32(0.02),
                 "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(d, cfg.vocab) / np.sqrt(np.float32(d))
    a = {"wq": stacked(d, nh * hd), "wk": stacked(d, nkv * hd),
         "wv": stacked(d, nkv * hd), "wo": stacked(nh * hd, d)}
    if cfg.qkv_bias:
        a.update(bq=np.zeros((L, nh * hd), np.float32),
                 bk=np.zeros((L, nkv * hd), np.float32),
                 bv=np.zeros((L, nkv * hd), np.float32))
    if cfg.qk_norm:
        a["tau"] = np.full((L,), cfg.attn_tau, np.float32)
    blocks = {"ln1": ones(L, d), "ln2": ones(L, d), "attn": a}
    if cfg.mlp_kind == "swiglu":
        blocks["mlp"] = {"wg": stacked(d, cfg.d_ff),
                         "wu": stacked(d, cfg.d_ff),
                         "wd": stacked(cfg.d_ff, d)}
    elif cfg.mlp_kind == "squared_relu":
        blocks["mlp"] = {"wi": stacked(d, cfg.d_ff),
                         "wd": stacked(cfg.d_ff, d)}
    p["blocks"] = blocks

    def to_torch(tree):
        if isinstance(tree, dict):
            return {k: to_torch(v) for k, v in tree.items()}
        return torch.from_numpy(tree).to(device=dev, dtype=cfg.param_dtype)
    return to_torch(p)


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


def decode_step(params: Params, cfg: LMConfig, cache: Params,
                tokens: torch.Tensor, cur_index: int,
                head: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1) integer ids; ``cur_index``: the position this
    token takes, a Python int in ``[0, cache_len)`` (``ValueError``
    otherwise). Updates ``cache`` in place; returns (logits (B, V) f32,
    cache). ``head`` is :func:`lm_head`'s result, made here when omitted.
    """
    _check_supported(cfg)
    x = params["embed"][tokens.long()].to(cfg.dtype)

    def norm(h, w):
        return rmsnorm(h, w, f32_stats=cfg.norm_f32)

    for i in range(cfg.n_layers):
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
