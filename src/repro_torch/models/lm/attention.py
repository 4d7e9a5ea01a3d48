"""GQA decode attention with a KV cache, optionally int8-quantized.

Counterpart of the decode half of ``repro/models/lm/attention.py``
(``init_kv_cache``, ``_project_qkv``, ``decode_attention``). With
``cfg.kv_quant`` the new token's K and V rows are quantized and written
into the cache by one launch of the act-quant kernel's KV entry (K5,
per-token abs-max, the scale taken in the activation dtype as the JAX
decode takes it; replicated heads read their kv head by index), and the
attention over the
int8 cache runs in the int8-KV decode kernel (K6), which dequantizes and
computes the softmax in float32 (as the TPU kernel does; the JAX jnp
path dequantizes and takes the logits in the activation dtype, so in
bf16 the two agree to bf16 rounding). Without ``kv_quant`` the attention
is plain PyTorch, as the JAX package leaves it to XLA.

The cache is updated in place: the new token's row is written at
``cur_index`` into the tensors the caller passed, which are also
returned. ``cur_index`` is a Python int, and ``cur_index >= cache_len``
raises ``ValueError`` (JAX's ``dynamic_update_index_in_dim`` would
silently clamp it to the last row). Training and prefill
(``causal_attention``) and the int4 cache (``kv_bits=4``) are not ported.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.attention_norm import l2_normalize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.lm.layers import apply_rope, qlinear

__all__ = ["init_kv_cache", "decode_attention"]

Cache = Dict[str, torch.Tensor]


def _check_kv_bits(cfg) -> None:
    if cfg.kv_quant and cfg.kv_bits != 8:
        raise NotImplementedError(
            f"kv_bits={cfg.kv_bits}: only the int8 KV cache is ported "
            "(the packed int4 cache is listed in ROADMAP.md §A)")


def init_kv_cache(cfg, batch: int, seq: int, dtype: torch.dtype,
                  device: DeviceLike = None) -> Cache:
    _check_kv_bits(cfg)
    device = resolve_device(device)
    nkv, hd = cfg.n_kv_heads * cfg.kv_replicate, cfg.hd
    if cfg.kv_quant:
        return {
            "k_q": torch.zeros((batch, nkv, seq, hd), dtype=torch.int8,
                               device=device),
            "v_q": torch.zeros((batch, nkv, seq, hd), dtype=torch.int8,
                               device=device),
            "k_s": torch.zeros((batch, nkv, seq), dtype=torch.float32,
                               device=device),
            "v_s": torch.zeros((batch, nkv, seq), dtype=torch.float32,
                               device=device),
        }
    return {"k": torch.zeros((batch, nkv, seq, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, nkv, seq, hd), dtype=dtype,
                             device=device)}


def _project_qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    mode = cfg.quant_mode
    q = qlinear(x, params["wq"], mode, params.get("bq")).reshape(B, S, nh, hd)
    k = qlinear(x, params["wk"], mode, params.get("bk")).reshape(B, S, nkv,
                                                                 hd)
    v = qlinear(x, params["wv"], mode, params.get("bv")).reshape(B, S, nkv,
                                                                 hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.qk_norm:
        q = l2_normalize(q) * params["tau"].to(x.dtype)
        k = l2_normalize(k)
        scale = 1.0
    else:
        scale = hd ** -0.5
    return q, k, v, scale


def decode_attention(params, x: torch.Tensor, cfg, cache: Cache,
                     cur_index: int):
    """One decode step. x: (B, 1, d); the cache holds ``cache_len`` past
    tokens. Writes the new token's K/V at ``cur_index`` (the same
    position for every batch row) in place and attends to positions
    ``[0, cur_index]``. Returns (out (B, 1, d), cache).

    Raises ``ValueError`` when ``cur_index`` is not in ``[0, cache_len)``.
    """
    _check_kv_bits(cfg)
    B = x.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    seq = (cache["k_q"] if cfg.kv_quant else cache["k"]).shape[2]
    if not 0 <= cur_index < seq:
        raise ValueError(f"cur_index={cur_index} outside the cache's "
                         f"[0, {seq}) positions")
    positions = torch.full((B, 1), cur_index, device=x.device)
    q, k_new, v_new, scale = _project_qkv(params, x, cfg, positions)
    k_new = k_new[:, 0]                              # (B, kv, hd)
    v_new = v_new[:, 0]
    nkv = nkv * cfg.kv_replicate
    g = nh // nkv
    q = q[:, 0].reshape(B, nkv, g, hd)               # (B, kv_eff, g, hd)

    if cfg.kv_quant:
        ops.append_kv_int8(k_new, v_new, cache["k_q"], cache["k_s"],
                           cache["v_q"], cache["v_s"], cur_index,
                           cfg.kv_replicate)
        rows = B * nkv
        out = ops.decode_attention_int8kv(
            q.to(torch.float32).reshape(rows, g, hd),
            cache["k_q"].reshape(rows, seq, hd), cache["k_s"].reshape(rows,
                                                                      seq),
            cache["v_q"].reshape(rows, seq, hd), cache["v_s"].reshape(rows,
                                                                      seq),
            cur_index + 1, scale)
        out = out.to(x.dtype).reshape(B, 1, nh * hd)
    else:
        if cfg.kv_replicate > 1:
            # contiguous repeat keeps the q-group -> kv-head mapping
            k_new = torch.repeat_interleave(k_new, cfg.kv_replicate, dim=1)
            v_new = torch.repeat_interleave(v_new, cfg.kv_replicate, dim=1)
        cache["k"][:, :, cur_index] = k_new.to(cache["k"].dtype)
        cache["v"][:, :, cur_index] = v_new.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        logits = torch.einsum("bkgd,bksd->bkgs", q, k) * scale
        valid = torch.arange(seq, device=x.device) <= cur_index
        logits = logits.masked_fill(~valid, -1e30)
        w = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        out = torch.einsum("bkgs,bksd->bkgd", w, v).reshape(B, 1, nh * hd)
    return qlinear(out, params["wo"], cfg.quant_mode), cache
