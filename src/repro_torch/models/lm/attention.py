"""GQA attention: the q-chunked causal prefill and the KV-cache decode.

Counterpart of ``repro/models/lm/attention.py`` (``init_attention``,
``_project_qkv``, ``causal_attention``, ``init_kv_cache``,
``decode_attention``).

The prefill (``causal_attention``) keeps the reference's blockwise
formulation: query blocks of ``min(cfg.attn_chunk_q, S)`` rows, each
against its full row of keys, the causal mask filled with -1e30, the
logits in the activation dtype, the softmax in float32 and cast back,
then P·V and the output projection. The reference is plain jnp, so this
is plain PyTorch; ``scaled_dot_product_attention`` would round bf16
elsewhere than the reference does.

With ``cfg.kv_quant`` and ``kv_bits=8`` the new token's K and V rows are
quantized and written into the cache by one launch of the act-quant
kernel's KV entry (K5, per-token abs-max, the scale taken in the
activation dtype as the JAX decode takes it; replicated heads read their
kv head by index), and the attention over the int8 cache runs in the
int8-KV decode kernel (K6), which dequantizes and computes the softmax
in float32 (as the TPU kernel does; the JAX jnp path dequantizes and
takes the logits in the activation dtype, so in bf16 the two agree to
bf16 rounding). With ``kv_bits=4`` the cache holds ``hd // 2`` bytes of
packed nibbles per row (``core.quantizers.pack_int4``) and both the
write and the attention are the reference's jnp formulation in plain
PyTorch: no kernel of either package serves the int4 cache. Without
``kv_quant`` the attention is plain PyTorch, as the JAX package leaves
it to XLA.

The cache is updated in place: the new token's row is written at
``cur_index`` into the tensors the caller passed, which are also
returned. ``cur_index`` is a Python int, for which ``cur_index >=
cache_len`` raises ``ValueError`` (JAX's ``dynamic_update_index_in_dim``
would silently clamp it to the last row), or, as the reference's traced
``cur_index``, a 0-d int32 tensor on the activations' device: RoPE, the
mask, the cache writes (``index_copy_``) and both kernels then read it
there, so the step never waits on the host and one captured step serves
every position. A tensor position is not range-checked here: the caller
that owns the host counter checks it.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.attention_norm import l2_normalize
from repro_torch.core.quantizers import (pack_int4, qmax, scale_from_amax,
                                         unpack_int4)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import write_at
from repro_torch.models.lm.layers import (apply_rope, dense_init,
                                          params_to_torch, qlinear)

__all__ = ["attention_arrays", "init_attention", "causal_attention",
           "init_kv_cache", "decode_attention"]

Cache = Dict[str, torch.Tensor]
Position = Union[int, torch.Tensor]


def attention_arrays(cfg, rng: np.random.Generator,
                     depth: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The attention block's parameters as float32 numpy arrays, with the
    shapes of the JAX ``init_attention`` (``bq/bk/bv`` zeros when
    ``qkv_bias``, ``tau = attn_tau`` when ``qk_norm``), stacked on a
    leading ``depth`` axis when given."""
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    lead = (depth,) if depth else ()
    p = {"wq": dense_init(rng, d, nh * hd, depth),
         "wk": dense_init(rng, d, nkv * hd, depth),
         "wv": dense_init(rng, d, nkv * hd, depth),
         "wo": dense_init(rng, nh * hd, d, depth)}
    if cfg.qkv_bias:
        p.update(bq=np.zeros(lead + (nh * hd,), np.float32),
                 bk=np.zeros(lead + (nkv * hd,), np.float32),
                 bv=np.zeros(lead + (nkv * hd,), np.float32))
    if cfg.qk_norm:
        p["tau"] = np.full(lead, cfg.attn_tau, np.float32)
    return p


def init_attention(cfg, rng=0,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """One attention block's random parameters (the JAX
    ``init_attention``'s shapes, dtypes and scales), drawn with numpy from
    ``rng`` (a seed or a ``np.random.Generator``), not JAX's bits."""
    return params_to_torch(attention_arrays(cfg, np.random.default_rng(rng)),
                           cfg, resolve_device(device))


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


def causal_attention(params, x: torch.Tensor, cfg,
                     positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Full prefill attention. x: (B, S, d) -> (B, S, d). Query blocks of
    ``min(cfg.attn_chunk_q, S)`` rows, each against its full row, so the
    (S, S) scores of all heads are never held at once; ``S`` must be a
    multiple of the block (``ValueError``)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v, scale = _project_qkv(params, x, cfg, positions)
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = q.reshape(B, S, nkv, nh // nkv, hd)
    bq = min(cfg.attn_chunk_q, S)
    if S % bq:
        raise ValueError(f"S={S} % chunk {bq} != 0")
    row_ids = torch.arange(S, device=x.device)
    outs = []
    for i in range(S // bq):
        qi = q[:, i * bq:(i + 1) * bq]                      # (B,bq,kv,g,hd)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qi, k) * scale
        q_pos = i * bq + torch.arange(bq, device=x.device)
        mask = row_ids[None, :] <= q_pos[:, None]           # (bq, S)
        logits = logits.masked_fill(~mask, -1e30)
        w = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", w, v))
    out = torch.cat(outs, dim=1).reshape(B, S, nh * hd)
    return qlinear(out, params["wo"], cfg.quant_mode)


# --- decode -------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, seq: int, dtype: torch.dtype,
                  device: DeviceLike = None) -> Cache:
    device = resolve_device(device)
    nkv, hd = cfg.n_kv_heads * cfg.kv_replicate, cfg.hd
    if cfg.kv_quant:
        if cfg.kv_bits not in (4, 8):
            raise ValueError(f"kv_bits={cfg.kv_bits}: expected 8 or 4")
        w, qdt = (hd, torch.int8) if cfg.kv_bits == 8 else (hd // 2,
                                                            torch.uint8)
        return {
            "k_q": torch.zeros((batch, nkv, seq, w), dtype=qdt,
                               device=device),
            "v_q": torch.zeros((batch, nkv, seq, w), dtype=qdt,
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


def _append_kv_int4(k_new, v_new, cache: Cache, cur_index: Position
                    ) -> None:
    """The reference's int4 KV write: per-row abs-max scale
    ``max(|row|, 1e-8) / 7`` in the activation dtype (widened to
    float32), codes ``clip(round(row / scale), -7, 7)`` packed two to a
    byte, stored at ``cur_index``."""
    for name, rows in (("k", k_new), ("v", v_new)):
        s = scale_from_amax(rows.abs().amax(dim=-1), 4).to(torch.float32)
        q = torch.clamp(torch.round(rows.to(torch.float32) / s[..., None]),
                        -qmax(4), qmax(4)).to(torch.int8)
        write_at(cache[f"{name}_q"], cur_index, pack_int4(q))
        write_at(cache[f"{name}_s"], cur_index, s)


def decode_attention(params, x: torch.Tensor, cfg, cache: Cache,
                     cur_index: Position):
    """One decode step. x: (B, 1, d); the cache holds ``cache_len`` past
    tokens. Writes the new token's K/V at ``cur_index`` (the same
    position for every batch row; an int or a 0-d int32 tensor on x's
    device) in place and attends to positions ``[0, cur_index]``.
    Returns (out (B, 1, d), cache).

    Raises ``ValueError`` when an int ``cur_index`` is not in ``[0,
    cache_len)``.
    """
    B = x.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    seq = (cache["k_q"] if cfg.kv_quant else cache["k"]).shape[2]
    if isinstance(cur_index, torch.Tensor):
        positions = cur_index.reshape(1, 1).expand(B, 1)
    else:
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

    if cfg.kv_quant and cfg.kv_bits == 8:
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
            cur_index if isinstance(cur_index, torch.Tensor)
            else cur_index + 1, scale)
        return qlinear(out.to(x.dtype).reshape(B, 1, nh * hd), params["wo"],
                       cfg.quant_mode), cache

    if cfg.kv_replicate > 1:
        # contiguous repeat keeps the q-group -> kv-head mapping
        k_new = torch.repeat_interleave(k_new, cfg.kv_replicate, dim=1)
        v_new = torch.repeat_interleave(v_new, cfg.kv_replicate, dim=1)
    if cfg.kv_quant:
        _append_kv_int4(k_new, v_new, cache, cur_index)
        k = (unpack_int4(cache["k_q"]).to(x.dtype)
             * cache["k_s"][..., None].to(x.dtype))
        v = (unpack_int4(cache["v_q"]).to(x.dtype)
             * cache["v_s"][..., None].to(x.dtype))
    else:
        write_at(cache["k"], cur_index, k_new.to(cache["k"].dtype))
        write_at(cache["v"], cur_index, v_new.to(cache["v"].dtype))
        k, v = cache["k"], cache["v"]
    logits = torch.einsum("bkgd,bksd->bkgs", q, k) * scale
    valid = torch.arange(seq, device=x.device) <= cur_index
    logits = logits.masked_fill(~valid, -1e30)
    w = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", w, v).reshape(B, 1, nh * hd)
    return qlinear(out, params["wo"], cfg.quant_mode), cache
