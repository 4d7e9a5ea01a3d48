"""Model-level quantization: a float LM parameter tree -> the serve-time
W8/W4 representation ``qlinear``'s serve modes consume.

Counterpart of ``repro/quant/apply.py``, with the same policy: every
projection matrix whose path matches ``_QUANT_PATTERNS`` becomes a
``(q, scale)`` tuple with per-output-channel scales taken over the
contracting axis (-2) only, so stacked ``(depth, K, N)`` weights get
independent scales per matrix; embeddings, the head, norms and biases
stay float. Codes and scales equal the JAX package's bit for bit, on the
CPU and on the card.
"""
from __future__ import annotations

import re
from typing import Any

import torch

from repro_torch.core.quantizers import pack_int4, qmax, scale_from_amax

__all__ = ["quantize_matrix", "quantize_params_tree", "quantized_bytes"]

# paths (regex) of weights that go through qlinear or the expert einsums
_QUANT_PATTERNS = [
    r"attn/w[qkvo]$",
    r"mlp/(wg|wu|wi|wd)$",
    r"moe/(wg|wu|wd)$",
    r"(^|/)m/(w_z|w_x|w_B|w_C|w_dt|out_proj)$",
    r"b/(w_gate|w_up|wq|wk|wv|down|w_in)$",
]


def _per_matrix_scale(w: torch.Tensor, bits: int) -> torch.Tensor:
    return scale_from_amax(w.abs().amax(dim=-2, keepdim=True), bits)


def quantize_matrix(w: torch.Tensor, mode: str):
    """One float weight (..., K, N) -> ``serve_w8a8``: (int8 (..., K, N),
    f32 scale (..., 1, N)); ``serve_w4a8``: (uint8 (..., K, N/2) nibbles,
    low nibble first, f32 scale), on the int4 grid [-7, 7]."""
    if mode not in ("serve_w8a8", "serve_w4a8"):
        raise ValueError(mode)
    bits = 8 if mode == "serve_w8a8" else 4
    s = _per_matrix_scale(w, bits)
    q = torch.clamp(torch.round(w / s), -qmax(bits), qmax(bits)) \
        .to(torch.int8)
    return (q if bits == 8 else pack_int4(q)), s.to(torch.float32)


def quantize_params_tree(params, cfg):
    """Quantize every matching leaf of a nested-dict parameter tree in
    ``cfg.quant_mode``; other leaves pass through unchanged."""
    mode = cfg.quant_mode
    if mode not in ("serve_w8a8", "serve_w4a8"):
        raise ValueError(f"quant_mode {mode!r} is not a serve mode")

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if tree.ndim >= 2 and any(re.search(p, path)
                                  for p in _QUANT_PATTERNS):
            if mode == "serve_w4a8" and tree.shape[-1] % 2:
                return tree       # odd minor dim: left float, as in JAX
            return quantize_matrix(tree, mode)
        return tree
    return walk(params, "")


def quantized_bytes(tree: Any) -> int:
    """Bytes of a (possibly quantized) tree as stored: int8/uint8 leaves
    count one byte per element."""
    if isinstance(tree, dict):
        return sum(quantized_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(quantized_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
