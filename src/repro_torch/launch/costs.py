"""Analytic per-cell cost model: FLOPs and HBM bytes for every block type,
counterpart of ``repro/launch/costs.py`` with the same arithmetic in the
same order, on the port's ``LMConfig`` (torch dtypes).

Why analytic: the reference's XLA cost analysis counts a scanned loop body
once, and the port's dry run (``launch/dryrun.py``) counts only the
products its step dispatches on one device's shards; the implementation's
whole-cluster work comes from the architecture algebra. Collective
traffic is counted from the step itself (``launch/hlo_analysis.py``),
since it depends on how DTensor redistributes, which this model does not
follow.

Conventions
  * FLOPs: 2*MAC for matmuls/einsums; elementwise ignored (<1%).
  * Attention counts the deployed implementation's work: q-chunked blockwise
    attention evaluates ALL (q, kv) pairs with causal masking -> 2x the
    causally-useful work for train/prefill. The MODEL_FLOPS ratio in the
    roofline surfaces exactly this kind of overhead.
  * HBM bytes: weights + caches + the activation tensors that round-trip HBM
    (block inputs/outputs, written fwd / read bwd); attention logits and SSD
    chunk temporaries are not counted: the reference's chunked formulations
    keep them in on-chip memory (the port's plain PyTorch writes them to
    HBM, so it moves more than this model counts).
  * All numbers are GLOBAL (whole cluster, one step); divide by n_chips for
    per-chip roofline terms.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.lm.config import LMConfig, ShapeCell
from repro_torch.models.lm.moe import MOE_GROUP

__all__ = ["forward_flops_per_token", "cell_flops", "model_flops",
           "cell_hbm_bytes"]


def _dtype_bytes(cfg: LMConfig) -> float:
    return 2.0 if cfg.dtype == torch.bfloat16 else 4.0


def _weight_bytes_per_param(cfg: LMConfig) -> float:
    if cfg.quant_mode == "serve_w8a8":
        return 1.0
    if cfg.quant_mode == "serve_w4a8":
        return 0.5
    return 4.0 if cfg.param_dtype == torch.float32 else 2.0


# --------------------------------------------------------------------------
# per-layer forward FLOPs (per token unless noted)
# --------------------------------------------------------------------------

def _attn_proj_flops(cfg) -> float:
    return 2 * cfg.d_model * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
        + 2 * cfg.n_heads * cfg.hd * cfg.d_model


def _attn_score_flops(cfg, s_ctx: float) -> float:
    """Per token, attending over s_ctx keys (QK^T + PV)."""
    return 2 * 2 * cfg.n_heads * cfg.hd * s_ctx


def _mlp_flops(cfg) -> float:
    if cfg.mlp_kind == "swiglu":
        return 2 * 3 * cfg.d_model * cfg.d_ff
    if cfg.mlp_kind == "squared_relu":
        return 2 * 2 * cfg.d_model * cfg.d_ff
    return 0.0


def _moe_flops(cfg, tokens_per_group: float) -> float:
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    C = max(tokens_per_group * k / E * cf, 1.0)
    router = 2 * cfg.d_model * E
    # dispatch+combine einsums: 2 ops x 2MAC x E*C*d per group of Tg tokens
    per_tok_dispatch = 2 * 2 * E * C * cfg.d_model / tokens_per_group
    experts = 2 * 3 * k * cf * cfg.d_model * cfg.d_ff
    return router + per_tok_dispatch + experts


def _mamba_flops(cfg, decode: bool) -> float:
    d, di = cfg.d_model, cfg.d_inner
    H, N, G, P = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    L = cfg.ssm_chunk
    proj = 2 * d * (2 * di + 2 * G * N + H) + 2 * di * d
    conv = 2 * 4 * di
    if decode:
        scan = 2 * G * N + 2 * H * P + 4 * H * N * P
    else:
        scan = 2 * G * L * N + 2 * H * L * (P + 1) + 4 * H * N * P
    return proj + conv + scan


def _mlstm_flops(cfg, decode: bool) -> float:
    d = cfg.d_model
    di = d * cfg.xlstm_proj_factor
    H = cfg.n_heads
    dk, dv = di // H // 2, di // H
    L = cfg.ssm_chunk
    proj = 2 * d * 2 * di + 2 * di * (2 * H * dk + H * dv + 2 * H) + 2 * di * d
    if decode:
        scan = 4 * H * dk * (dv + 1)
    else:
        scan = 2 * H * L * dk + 2 * H * L * (dv + 1) + 4 * H * dk * (dv + 1)
    return proj + scan


def _slstm_flops(cfg) -> float:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return 2 * d * 4 * d + 2 * H * dh * 4 * dh + 2 * d * d


def forward_flops_per_token(cfg: LMConfig, cell: ShapeCell) -> float:
    """Implementation FLOPs per token, forward pass, whole network."""
    decode = cell.kind == "decode"
    S = cell.seq_len
    # context length each token attends over in the deployed implementation
    if decode:
        s_ctx = S                       # one token vs full cache
    else:
        s_ctx = S                       # blockwise attention: ALL pairs
    T_group = min(MOE_GROUP, cell.global_batch * (1 if decode else S))

    if cfg.block_pattern == "transformer":
        per_layer = _attn_proj_flops(cfg) + _attn_score_flops(cfg, s_ctx)
        per_layer += _moe_flops(cfg, T_group) if cfg.moe else _mlp_flops(cfg)
        body = cfg.n_layers * per_layer
    elif cfg.block_pattern == "zamba2":
        G = cfg.n_layers // cfg.zamba_mamba_per_attn
        body = cfg.n_layers * _mamba_flops(cfg, decode)
        body += G * (_attn_proj_flops(cfg) + _attn_score_flops(cfg, s_ctx)
                     + _mlp_flops(cfg))
    elif cfg.block_pattern == "xlstm":
        Gg = cfg.n_layers // (cfg.xlstm_mlstm_per_slstm + 1)
        n_m = cfg.n_layers - Gg
        body = n_m * _mlstm_flops(cfg, decode) + Gg * _slstm_flops(cfg)
    else:
        raise ValueError(cfg.block_pattern)
    head = 2 * cfg.d_model * cfg.vocab
    return body + head


def cell_flops(cfg: LMConfig, cell: ShapeCell) -> float:
    """Total implementation FLOPs for one step (global)."""
    tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    fwd = tokens * forward_flops_per_token(cfg, cell)
    return 3.0 * fwd if cell.kind == "train" else fwd


def model_flops(cfg: LMConfig, cell: ShapeCell) -> float:
    """The 6*N*D (train) / 2*N*D (inference) yardstick, N = active params."""
    tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    N = cfg.active_param_count()
    return (6.0 if cell.kind == "train" else 2.0) * N * tokens


# --------------------------------------------------------------------------
# HBM bytes
# --------------------------------------------------------------------------

def _activation_width(cfg: LMConfig) -> float:
    """Block-level activation tensors that round-trip HBM, per token, in
    units of elements (see module docstring)."""
    d = cfg.d_model
    if cfg.block_pattern == "transformer":
        per = 4 * d + (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
        per += 2 * cfg.d_ff if cfg.mlp_kind == "swiglu" else cfg.d_ff
        if cfg.moe:
            per += 2 * cfg.top_k * cfg.capacity_factor * cfg.d_ff
        return cfg.n_layers * per
    if cfg.block_pattern == "zamba2":
        di = cfg.d_inner
        per_mamba = 3 * d + 3 * di
        G = cfg.n_layers // cfg.zamba_mamba_per_attn
        per_attn = 4 * d + (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd + 2 * cfg.d_ff
        return cfg.n_layers * per_mamba + G * per_attn
    if cfg.block_pattern == "xlstm":
        di = d * cfg.xlstm_proj_factor
        Gg = cfg.n_layers // (cfg.xlstm_mlstm_per_slstm + 1)
        return (cfg.n_layers - Gg) * (3 * d + 4 * di) + Gg * (2 * d + 4 * d)
    raise ValueError(cfg.block_pattern)


def _cache_bytes(cfg: LMConfig, cell: ShapeCell) -> float:
    """Total decode-cache bytes (global)."""
    B, S = cell.global_batch, cell.seq_len
    kv_b = (cfg.kv_bits / 8.0 + 4.0 / cfg.hd) if cfg.kv_quant else _dtype_bytes(cfg)
    if cfg.block_pattern == "transformer":
        return (cfg.n_layers * B * cfg.n_kv_heads * cfg.kv_replicate * S
                * cfg.hd * 2 * kv_b)
    if cfg.block_pattern == "zamba2":
        G = cfg.n_layers // cfg.zamba_mamba_per_attn
        attn = G * B * cfg.n_kv_heads * S * cfg.hd * 2 * kv_b
        ssm = cfg.n_layers * B * (cfg.n_ssm_heads * cfg.ssm_state
                                  * cfg.ssm_head_dim * 4 + 3 * cfg.d_inner * 2)
        return attn + ssm
    if cfg.block_pattern == "xlstm":
        di = cfg.d_model * cfg.xlstm_proj_factor
        H = cfg.n_heads
        dk, dv = di // H // 2, di // H
        Gg = cfg.n_layers // (cfg.xlstm_mlstm_per_slstm + 1)
        mlstm = (cfg.n_layers - Gg) * B * H * dk * (dv + 1) * 4
        slstm = Gg * B * 4 * cfg.d_model * 4
        return mlstm + slstm
    raise ValueError(cfg.block_pattern)


def cell_hbm_bytes(cfg: LMConfig, cell: ShapeCell) -> Dict[str, float]:
    """Global HBM traffic for one step, split by source."""
    tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    P = cfg.param_count()
    wb = _weight_bytes_per_param(cfg)
    act_b = _dtype_bytes(cfg)
    act_elems = _activation_width(cfg) * tokens

    if cell.kind == "train":
        # fwd read + bwd read of weights; grads write+read; adam: read p,mu,nu
        # + write p,mu,nu (fp32 master)
        weights = P * (2 * wb + 2 * 4 + 6 * 4)
        acts = act_elems * act_b * 2            # write fwd, read bwd
        cache = 0.0
        logits = cell.global_batch * cell.seq_len * cfg.vocab * 4 * 2
    elif cell.kind == "prefill":
        weights = P * wb
        acts = act_elems * act_b
        cache = 0.0
        logits = cell.global_batch * cell.seq_len * cfg.vocab * 4
    else:  # decode
        weights = P * wb
        acts = act_elems * act_b
        cache = _cache_bytes(cfg, cell)          # read full cache once
        logits = cell.global_batch * cfg.vocab * 4
    return {"weights": weights, "activations": acts, "cache": cache,
            "logits": logits, "total": weights + acts + cache + logits}
