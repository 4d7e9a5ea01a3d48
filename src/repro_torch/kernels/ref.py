"""Plain PyTorch versions of the port's kernels (the correctness oracles).

Counterpart of ``repro/kernels/ref.py``. The CPU path of every kernel
wrapper runs these, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card. Where a kernel is meant to match bit for bit (the
quantized matmuls, the MDDQ encode, the activation quantizer), the
version here performs the same float32 operations in the same order.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizers import (quantize_log_magnitude,
                                         scale_from_amax, unpack_int4)

__all__ = ["w8a8_matmul_ref", "w4a8_matmul_ref", "nearest_code_ref",
           "mddq_encode_ref", "edge_softmax_ref", "act_quant_ref",
           "kv_append_int8_ref", "write_at", "decode_attention_int8kv_ref",
           "NEG_BIAS"]

NEG_BIAS = -1e9   # masked-edge logit; matches the dense forward's pair mask
_NEAREST_CHUNK = 4096


# --- quant_matmul ----------------------------------------------------------

def w8a8_matmul_ref(a_q, a_scale, w_q, w_scale):
    """int8 x int8 matmul with row/col scales.

    The integer product runs in float64, which is exact here (|acc| <=
    127 * 127 * K stays far below 2**53) and available on every device
    (CUDA has no int32 matmul); the conversion to float32 then rounds the
    exact integer once, as an int32 -> float32 cast would.
    """
    acc = torch.matmul(a_q.to(torch.float64), w_q.to(torch.float64))
    return acc.to(torch.float32) * a_scale * w_scale


def w4a8_matmul_ref(a_q, a_scale, w_packed, w_scale):
    return w8a8_matmul_ref(a_q, a_scale, unpack_int4(w_packed), w_scale)


# --- mddq -------------------------------------------------------------------

def _norm3(v: torch.Tensor) -> torch.Tensor:
    """sqrt((x*x + y*y) + z*z), each operation rounded on its own."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt((x * x + y * y) + z * z)


def nearest_code_ref(u: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """First-index argmax of ``(ux*cx + uy*cy) + uz*cz`` over the codebook.

    u: (N, 3); codebook: (C, 3). Scanned in 4096-codeword chunks (so the
    score matrix never materializes at full width), with a strict ``>``
    across chunks so the first maximizing index wins everywhere, as in
    ``repro/core/codebook.py``'s chunked search.
    """
    n = u.shape[0]
    best = torch.full((n,), -2.0, dtype=u.dtype, device=u.device)
    idx = torch.zeros((n,), dtype=torch.int32, device=u.device)
    ux, uy, uz = u[:, 0:1], u[:, 1:2], u[:, 2:3]
    for base in range(0, codebook.shape[0], _NEAREST_CHUNK):
        c = codebook[base:base + _NEAREST_CHUNK]
        scores = (ux * c[:, 0] + uy * c[:, 1]) + uz * c[:, 2]
        i = torch.argmax(scores, dim=1)
        s = torch.gather(scores, 1, i[:, None])[:, 0]
        take = s > best
        best = torch.where(take, s, best)
        idx = torch.where(take, (i + base).to(torch.int32), idx)
    return idx


def mddq_encode_ref(v, codebook, mag_bits=8, m_min=1e-6, m_max=1e3):
    """v: (N, 3) -> (dir_idx int32 (N,), mag_code int32 (N,)).

    The direction is ``v / max(|v|, 1e-12)`` by division, as
    ``repro/kernels/ref.py`` divides (the TPU kernel multiplies by a
    reciprocal instead, which can move a near-tie by one ulp).
    """
    m = _norm3(v)
    u = v / torch.clamp(m, min=1e-12)[:, None]
    idx = nearest_code_ref(u, codebook)
    mag = quantize_log_magnitude(m, mag_bits, m_min, m_max)
    return idx, mag


# --- edge softmax (sparse serving path) --------------------------------------

def edge_softmax_ref(q_scaled, k, bias, senders, receivers, edge_mask,
                     values, n_nodes):
    """Segment softmax + weighted segment sum over an edge list.

    q_scaled/k: (N, F); bias/senders/receivers/edge_mask: (E,);
    values: (E, W). out[i] = sum_{e: recv=i} alpha_e * values[e], alpha
    the per-receiver softmax of q[recv] . k[send] + bias; masked edges get
    logit -1e9 and zeroed values. The stabilizing max carries no gradient
    (it cancels analytically), and the division is a double ``where``: a
    receiver with no edges yields exactly 0 and its backward never forms
    1/denom^2 (``repro/kernels/ops.py``'s CPU path guards the same way).
    Differentiable with plain autograd; the index sums use ``index_add``,
    which runs on atomics on the card (last-bit run-to-run variation).
    """
    logits = (q_scaled.index_select(0, receivers)
              * k.index_select(0, senders)).sum(-1) + bias
    logits = torch.where(edge_mask, logits, torch.full_like(logits, NEG_BIAS))
    seg_max = torch.full((n_nodes,), float("-inf"), dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, receivers.long(), logits.detach(),
                                     reduce="amax", include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    p = torch.exp(logits - seg_max.index_select(0, receivers))
    denom = torch.zeros((n_nodes,), dtype=p.dtype, device=p.device) \
        .index_add(0, receivers, p)
    vals = values * edge_mask[:, None].to(values.dtype)
    num = torch.zeros((n_nodes, values.shape[1]), dtype=p.dtype,
                      device=p.device) \
        .index_add(0, receivers, p[:, None] * vals)
    has = denom > 0
    safe = torch.where(has, denom, torch.ones_like(denom))[:, None]
    return torch.where(has[:, None], num / safe, torch.zeros_like(num))


# --- activation quantization (the A8 step, the int8 KV write) ----------------

def act_quant_ref(x: torch.Tensor):
    """x: (M, K) float32 or bfloat16 -> (q int8 (M, K), scale f32 (M, 1)).

    ``scale = max(max|x|, 1e-8) / 127`` per row, taken in x's dtype (for
    bfloat16 the floor and the quotient round to bf16, as the JAX LM
    decode's KV write computes them) and widened to float32; then
    ``q = clip(round(x / scale), -127, 127)`` in float32, half to even.
    Every division is correctly rounded, on the CPU and on the card.
    """
    scale = scale_from_amax(x.abs().amax(dim=-1, keepdim=True), 8) \
        .to(torch.float32)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def kv_append_int8_ref(k_new, v_new, k_q, k_s, v_q, v_s, cur_index,
                       replicate: int = 1) -> None:
    """The LM decode's int8 KV write, in place.

    k_new/v_new: (B, nkv, D) float32 or bfloat16, the new token's rows;
    k_q/v_q: (B, nkv * replicate, S, D) int8 and k_s/v_s: (B, nkv *
    replicate, S) f32, the cache. Each effective head h takes the row of
    kv head ``h // replicate`` (``repeat_interleave``), quantized by
    :func:`act_quant_ref`; its codes go to ``q[:, h, cur_index]`` and its
    scale to ``s[:, h, cur_index]``, and nothing else in the cache changes.
    ``cur_index`` is an int or a 0-d integer tensor on the cache's device,
    written through with ``index_copy_`` (no host read of it).
    """
    if replicate > 1:
        k_new = torch.repeat_interleave(k_new, replicate, dim=1)
        v_new = torch.repeat_interleave(v_new, replicate, dim=1)
    lead, d = k_new.shape[:-1], k_new.shape[-1]
    q, s = act_quant_ref(torch.stack((k_new, v_new)).reshape(-1, d))
    q, s = q.reshape(2, *lead, d), s.reshape(2, *lead)
    write_at(k_q, cur_index, q[0])
    write_at(v_q, cur_index, q[1])
    write_at(k_s, cur_index, s[0])
    write_at(v_s, cur_index, s[1])


def write_at(cache: torch.Tensor, index, row: torch.Tensor) -> None:
    """``cache[:, :, index] = row`` in place, for an int ``index`` or a
    0-d integer tensor on the cache's device (``index_copy_``, which
    reads the index on the device: no host sync)."""
    if isinstance(index, torch.Tensor):
        cache.index_copy_(2, index.reshape(1).long(), row.unsqueeze(2))
    else:
        cache[:, :, index] = row


# --- int8-KV decode attention -------------------------------------------------

def decode_attention_int8kv_ref(q, k_q, k_scale, v_q, v_scale, n_valid,
                                softmax_scale):
    """One-token decode attention over an int8 K/V cache, grouped layout.

    q: (BH, G, D) f32; k_q/v_q: (BH, S, D) int8; k_scale/v_scale: (BH, S)
    f32. Attends to tokens ``[0, n_valid)`` for an int ``n_valid``, or to
    ``[0, p]`` for a 0-d integer tensor holding the decode position
    ``p``; the tokens past them are masked out of the softmax (weight
    exactly 0) rather than sliced off, so both give the same result and
    a tensor is never read on the host. Returns (BH, G,
    D) f32. With G = 1 and n_valid = S it is ``repro/kernels/ref.py``'s
    ``decode_attention_int8kv_ref``.
    """
    k = k_q.to(torch.float32) * k_scale[..., None]
    v = v_q.to(torch.float32) * v_scale[..., None]
    logits = torch.einsum("bgd,bsd->bgs", q, k) * softmax_scale
    idx = torch.arange(k_q.shape[1], device=q.device)
    valid = idx <= n_valid if isinstance(n_valid, torch.Tensor) \
        else idx < n_valid
    logits = torch.where(valid, logits,
                         torch.full_like(logits, float("-inf")))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bgs,bsd->bgd", w, v)
