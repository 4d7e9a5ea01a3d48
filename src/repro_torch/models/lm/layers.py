"""Shared LM building blocks: norms, rotary, MLPs, quantized linear.

Counterpart of ``repro/models/lm/layers.py``. ``qlinear``'s serve modes
are a dequantize-next-to-compute product with no activation
quantization, ``(x @ w_q.to(x.dtype)) * w_scale``: the JAX package leaves
it to XLA, and the port to ``torch.matmul``. ``qat_w4a8`` (the LM's QAT)
belongs to the LM family's slice and is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizers import unpack_int4

__all__ = ["rmsnorm", "qlinear", "mlp_swiglu", "mlp_squared_relu",
           "apply_mlp", "rope_freqs", "apply_rope"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            f32_stats: bool = True) -> torch.Tensor:
    dt = x.dtype
    if f32_stats:
        x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(x.dtype)).to(dt)


def qlinear(x: torch.Tensor, w, mode: str = "none",
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., K); w: (K, N) float, or ``(w_q, w_scale)`` in the serve
    modes (int8 (K, N), or uint8 (K, N/2) nibbles in ``serve_w4a8``;
    scale (1, N) f32)."""
    if mode == "none":
        y = x @ w.to(x.dtype)
    elif mode in ("serve_w8a8", "serve_w4a8"):
        w_q, w_scale = w
        if mode == "serve_w4a8" and w_q.dtype == torch.uint8:
            w_q = unpack_int4(w_q)
        y = (x @ w_q.to(x.dtype)) * w_scale.to(x.dtype)
    elif mode == "qat_w4a8":
        raise NotImplementedError(
            "qat_w4a8 is training-time fake quantization: the training "
            "slice (ROADMAP.md §A) has not been ported")
    else:
        raise ValueError(f"unknown quant mode {mode!r}")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)          # jax.nn.silu's formula


def mlp_swiglu(params, x, mode="none"):
    g = qlinear(x, params["wg"], mode)
    u = qlinear(x, params["wu"], mode)
    return qlinear(_silu(g) * u, params["wd"], mode)


def mlp_squared_relu(params, x, mode="none"):
    h = torch.relu(qlinear(x, params["wi"], mode))
    return qlinear(h * h, params["wd"], mode)


def apply_mlp(params, x, cfg, mode=None):
    mode = cfg.quant_mode if mode is None else mode
    if cfg.mlp_kind == "swiglu":
        return mlp_swiglu(params, x, mode)
    if cfg.mlp_kind == "squared_relu":
        return mlp_squared_relu(params, x, mode)
    raise ValueError(cfg.mlp_kind)


# --- rotary ------------------------------------------------------------------

def rope_freqs(hd: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,). The angles are float32,
    the result is cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs       # (B, S, D/2)
    cos = torch.cos(ang)[..., None, :]                         # (B, S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
