"""Public entry points around the kernels: counterpart of
``repro/kernels/ops.py``.

Each entry calls a kernel wrapper (the CUDA kernel on CUDA tensors, its
plain version on CPU tensors) and, where forces must differentiate
through it, carries the straight-through or reference backward as a
``torch.autograd.Function``. The quantized matmuls take float32
activations and quantize them inside the matmul kernel (one launch per
product); the LM decode's int8 KV write is one launch of the act-quant
kernel's KV entry per layer (:func:`append_kv_int8`).
The TPU wrappers' padding to 128-multiples (of the matmul operands and
of the MDDQ codebook) is not copied: the CUDA kernels mask ragged shapes
themselves.
"""
from __future__ import annotations

import torch

from repro_torch.core.mddq import MDDQConfig, fake_quant_from_codes
from repro_torch.core.quantizers import (abs_max_scale,
                                         dequantize_log_magnitude, pack_int4,
                                         quantize)
from repro_torch.kernels import attention_int8kv as _attn
from repro_torch.kernels._launch import count_launch
from repro_torch.kernels.act_quant import act_quant, kv_append_int8
from repro_torch.kernels.edge_softmax import edge_softmax_fused
from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
from repro_torch.kernels.quant_matmul import (w4a8_matmul_f32a,
                                              w8a8_matmul_f32a)
from repro_torch.kernels.ref import edge_softmax_ref

__all__ = ["prepare_w8", "prepare_w4", "quantize_activations",
           "quantized_products", "matmul_w8a8", "matmul_w4a8", "mddq_encode",
           "mddq_qdq_kernel", "edge_gather", "refine_edge_mask",
           "edge_softmax",
           "prepare_kv_int8", "append_kv_int8", "decode_attention_int8kv"]


# --- weight preparation (offline) -------------------------------------------

def prepare_w8(w: torch.Tensor):
    """fp32 (K, N) -> (w_q int8 (K, N), w_scale f32 (1, N)) per column."""
    scale = abs_max_scale(w, 8, channel_axis=1)
    return quantize(w, scale, 8), scale


def prepare_w4(w: torch.Tensor):
    """fp32 (K, N) -> (packed uint8 (K, N//2), w_scale f32 (1, N))."""
    scale = abs_max_scale(w, 4, channel_axis=1)
    return pack_int4(quantize(w, scale, 4)), scale


def quantize_activations(x: torch.Tensor):
    """f32 (M, K) -> (int8 (M, K), scale f32 (M, 1)) per-row dynamic A8,
    through the act-quant kernel on CUDA tensors (bit for bit the plain
    ``max(max|x|, 1e-8) / 127`` formula it runs on CPU tensors)."""
    return act_quant(x.contiguous())


# --- quantized matmul (K1 / K2) ----------------------------------------------

def quantized_products():
    """Holder of ``quantized_products.launches``: the quantized products
    asked of the card (calls of :func:`matmul_w8a8` and
    :func:`matmul_w4a8` on CUDA tensors, counted as the kernels count
    their launches, captures and replays included), which each take one
    f32-A matmul launch with the A8 step inside it."""


quantized_products.launches = 0


def matmul_w8a8(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(w) with per-row A8 activations. x: (M, K) f32,
    quantized as :func:`quantize_activations` does, in the same launch."""
    if x.is_cuda:
        count_launch(quantized_products)
    return w8a8_matmul_f32a(x.contiguous(), w_q, w_scale)


def matmul_w4a8(x: torch.Tensor, w_packed: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(w); w_packed: (K, N//2) uint8 nibbles."""
    if x.is_cuda:
        count_launch(quantized_products)
    return w4a8_matmul_f32a(x.contiguous(), w_packed, w_scale)


# --- MDDQ encode (K4) ---------------------------------------------------------

def mddq_encode(v: torch.Tensor, codebook: torch.Tensor,
                mag_bits: int = 8, m_min: float = 1e-6, m_max: float = 1e3):
    """v: (..., 3); codebook: (C, 3) -> (dir_idx int32, mag_code int32),
    each of shape (...)."""
    lead = v.shape[:-1]
    idx, mag = mddq_encode_kernel(v.reshape(-1, 3).contiguous(), codebook,
                                  mag_bits=mag_bits, m_min=m_min, m_max=m_max)
    return idx.reshape(lead), mag.reshape(lead)


class _MDDQQdq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, cfg: MDDQConfig, codebook):
        idx, mag = mddq_encode(v, codebook, mag_bits=cfg.magnitude_bits,
                               m_min=cfg.m_min, m_max=cfg.m_max)
        m_q = dequantize_log_magnitude(mag, cfg.magnitude_bits, cfg.m_min,
                                       cfg.m_max)[..., None]
        q_dir = codebook[idx]
        out = q_dir * m_q
        m2 = (v * v).sum(-1, keepdim=True)
        ctx.cfg = cfg
        ctx.save_for_backward(v, q_dir, m_q)
        # 1e-24 = core.mddq._EPS ** 2
        return torch.where(m2 <= 1e-24, torch.zeros_like(out), out)

    @staticmethod
    def backward(ctx, g):
        v, q_dir, m_q = ctx.saved_tensors
        with torch.enable_grad():
            v_ = v.detach().requires_grad_()
            out = fake_quant_from_codes(v_, ctx.cfg, q_dir, m_q)
            (gv,) = torch.autograd.grad(out, v_, g)
        return gv, None, None


def mddq_qdq_kernel(v: torch.Tensor, mddq_cfg: MDDQConfig,
                    codebook: torch.Tensor) -> torch.Tensor:
    """Serve-time MDDQ quantize-dequantize through the encode kernel.

    Forward: the encode (codebook argmax + log-magnitude code) and the
    table decode; zero vectors (|v|^2 <= 1e-24) map to exactly zero.
    Backward: the fake-quant reference's gradient (straight-through
    magnitude, Geometric STE on the direction) evaluated at the codes the
    forward found, so no second search runs; the JAX package re-runs the
    reference forward instead, which differs only at a near-tie.
    v: (..., 3); codebook: (C, 3), frozen (no gradient).
    """
    if mddq_cfg.magnitude_domain != "log":
        raise NotImplementedError(
            "the encode kernel quantizes magnitudes on the log grid only; "
            "use the fake-quant reference for linear-domain configs")
    return _MDDQQdq.apply(v, mddq_cfg, codebook)


# --- edge gather and fused edge softmax (K3) ----------------------------------

def edge_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for edge lists, as ``index_select``, whose backward is
    an ``index_add`` (atomics on the card; advanced indexing would take a
    sort-based scatter instead). The JAX package's blocked one-hot
    backward is an adaptation to serialized scatters on XLA's CPU backend,
    not needed here."""
    return torch.index_select(x, 0, idx)


def refine_edge_mask(coords_flat: torch.Tensor, senders: torch.Tensor,
                     receivers: torch.Tensor, edge_mask: torch.Tensor,
                     cutoff: float) -> torch.Tensor:
    """A Verlet-skin list's mask tightened to the true cutoff at the
    current coordinates: ``edge_mask & (d^2 < cutoff^2)``, the predicate
    of ``serving.bucketing.device_edge_list``. The edges it drops stay in
    the list's layout, inside their receivers' runs, which the edge
    softmax takes (pass the unrefined mask as its ``layout_mask``).
    Boolean output, no gradient. coords_flat: (N, 3); senders, receivers:
    (E,) int32; edge_mask: (E,) bool."""
    rij = coords_flat.index_select(0, senders) \
        - coords_flat.index_select(0, receivers)
    d2 = (rij * rij).sum(-1)
    return edge_mask & (d2 < cutoff * cutoff)


class _EdgeSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_scaled, k, bias, values, senders, receivers,
                edge_mask, cap: int, layout_mask):
        ctx.save_for_backward(q_scaled, k, bias, values, senders, receivers,
                              edge_mask)
        return edge_softmax_fused(q_scaled, k, bias, values, senders,
                                  receivers, edge_mask, cap, layout_mask)

    @staticmethod
    def backward(ctx, g):
        # true gradients through the plain version (identical maths to the
        # kernel), as the JAX package runs the oracle's gradients
        q, k, bias, values, senders, receivers, edge_mask = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, bias, values)]
            out = edge_softmax_ref(ins[0], ins[1], ins[2], senders, receivers,
                                   edge_mask, ins[3], q.shape[0])
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None, None, None, None)


def edge_softmax(q_scaled, k, bias, values, senders, receivers, edge_mask,
                 *, cap: int, layout_mask=None) -> torch.Tensor:
    """out[i] = sum_{e: recv(e)=i} alpha_e * values[e], alpha the segment
    softmax of q_scaled[recv] . k[send] + bias over each receiver.

    Always the fused kernel on CUDA tensors (and its plain version on CPU
    tensors), differentiable through the plain version's gradients. The
    inputs follow the ``bucketing.EdgeList`` layout, whose mask is
    ``layout_mask`` (None: ``edge_mask``); ``edge_mask`` may be any subset
    of it, such as a refined skin list (:func:`refine_edge_mask`). A
    receiver with no unmasked edge yields exactly 0.
    """
    return _EdgeSoftmax.apply(q_scaled.contiguous(), k.contiguous(),
                              bias.contiguous(), values.contiguous(),
                              senders, receivers, edge_mask, cap,
                              layout_mask)


# --- int8-KV decode attention (K5 for the cache write, K6) --------------------

def prepare_kv_int8(k: torch.Tensor, v: torch.Tensor):
    """(..., D) float32 or bfloat16 K and V -> (k_q int8 (..., D), k_s f32
    (...), v_q, v_s): per-token abs-max int8 codes and scales, the scale
    taken in the input's dtype (``repro/kernels/ops.py``'s formula, and the
    JAX LM decode's KV write). Both go through one act-quant launch; it
    builds whole caches (tests, phase 2), not the decode's write."""
    lead, d = k.shape[:-1], k.shape[-1]
    q, s = act_quant(torch.stack((k, v)).reshape(-1, d))
    q, s = q.reshape(2, *lead, d), s.reshape(2, *lead)
    return q[0], s[0], q[1], s[1]


def append_kv_int8(k_new, v_new, k_q, k_s, v_q, v_s, cur_index,
                   replicate: int = 1) -> None:
    """The LM decode's int8 KV write, in place: the new token's K and V
    rows (B, nkv, D) quantized per row as :func:`prepare_kv_int8` does and
    stored at ``cur_index`` (an int, or a 0-d int32 tensor on the card) of
    the (B, nkv * replicate, S, ...) cache, one kernel launch
    (``act_quant.kv_append_int8``)."""
    kv_append_int8(k_new, v_new, k_q, k_s, v_q, v_s, cur_index, replicate)


def decode_attention_int8kv(q, k_q, k_scale, v_q, v_scale, n_valid,
                            softmax_scale: float) -> torch.Tensor:
    """One-token attention over an int8 cache, grouped layout: q (BH, G,
    D) f32, k_q/v_q (BH, S, D) int8, scales (BH, S) f32, the tokens
    ``[0, n_valid)`` for an int ``n_valid``, or ``[0, p]`` for the decode
    position ``p`` as a 0-d int32 tensor on the card; returns (BH, G, D)
    f32."""
    return _attn.decode_attention_int8kv(q, k_q, k_scale, v_q, v_scale,
                                         n_valid, softmax_scale)
