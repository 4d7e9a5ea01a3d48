"""Shared LM building blocks: norms, rotary, MLPs, quantized linear.

Counterpart of ``repro/models/lm/layers.py``. ``qlinear``'s serve modes
are a dequantize-next-to-compute product with no activation
quantization, ``(x @ w_q.to(x.dtype)) * w_scale``: the JAX package leaves
it to XLA, and the port to ``torch.matmul``. ``qat_w4a8`` is the LM's
training-time fake quantization, as the reference computes it: W4 per
output channel (the abs-max over every other axis of ``w``), A8 per
tensor (one abs-max scale over the whole activation), both through
``core.quantizers.fake_quant_ste`` (straight-through rounding, the clip's
gradient 0.5 at exactly +-qmax), then ``xq @ wq``. The LM takes no
second derivative, so the estimators run with ``nested=False``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantizers import fake_quant_ste, unpack_int4

__all__ = ["rmsnorm", "lead_shape", "dense_init", "normal_init",
           "params_to_torch", "qlinear", "silu", "softplus", "mlp_swiglu",
           "mlp_squared_relu", "mlp_arrays", "apply_mlp", "rope_freqs",
           "apply_rope"]

# leaves the JAX package creates in float32 whatever ``param_dtype`` is
F32_LEAVES = ("tau", "router", "A_log", "D", "dt_bias")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            f32_stats: bool = True) -> torch.Tensor:
    dt = x.dtype
    if f32_stats:
        x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(x.dtype)).to(dt)


def lead_shape(depth) -> tuple:
    """The leading stack axes a ``depth`` argument names: none for None,
    ``(depth,)`` for an int, the tuple itself otherwise."""
    if depth is None:
        return ()
    return (depth,) if isinstance(depth, int) else tuple(depth)


def normal_init(rng: np.random.Generator, shape, fan_in: int,
                depth=None) -> np.ndarray:
    """N(0, 1) / sqrt(fan_in) float32 arrays of ``shape``, drawn with
    numpy, stacked on the leading ``depth`` axes (an int or a tuple) with
    one draw of ``shape`` per entry, in order."""
    lead = lead_shape(depth)
    w = np.empty(lead + tuple(shape), np.float32)
    for m in w.reshape((-1,) + tuple(shape)):
        rng.standard_normal(shape, dtype=np.float32, out=m)
    w /= np.sqrt(np.float32(fan_in))
    return w


def dense_init(rng: np.random.Generator, fan_in: int, fan_out: int,
               depth=None) -> np.ndarray:
    """N(0, 1) / sqrt(fan_in) float32 weights, drawn with numpy (the JAX
    ``dense_init``'s scale, not its bits): ``(fan_in, fan_out)``, or
    stacked on the leading ``depth`` axes (an int or a tuple) with one
    draw per matrix, in order."""
    return normal_init(rng, (fan_in, fan_out), fan_in, depth)


def params_to_torch(tree, cfg, device: torch.device):
    """A nested dict of numpy arrays -> tensors on ``device``, every leaf
    in ``cfg.param_dtype`` but those of ``F32_LEAVES`` (``tau``, the MoE
    router, the SSM's ``A_log``, ``D`` and ``dt_bias``), which stay
    float32 as in JAX."""
    if isinstance(tree, dict):
        return {k: (torch.from_numpy(v).to(device) if k in F32_LEAVES
                    else params_to_torch(v, cfg, device))
                for k, v in tree.items()}
    return torch.from_numpy(tree).to(device=device, dtype=cfg.param_dtype)


def qlinear(x: torch.Tensor, w, mode: str = "none",
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., K); w: (K, N) float (fake-quantized in ``qat_w4a8``), or
    ``(w_q, w_scale)`` in the serve modes (int8 (K, N), or uint8 (K, N/2)
    nibbles in ``serve_w4a8``; scale (1, N) f32)."""
    if mode == "none":
        y = x @ w.to(x.dtype)
    elif mode in ("serve_w8a8", "serve_w4a8"):
        w_q, w_scale = w
        if mode == "serve_w4a8" and w_q.dtype == torch.uint8:
            w_q = unpack_int4(w_q)
        y = (x @ w_q.to(x.dtype)) * w_scale.to(x.dtype)
    elif mode == "qat_w4a8":
        wq = fake_quant_ste(w, 4, channel_axis=w.ndim - 1)
        xq = fake_quant_ste(x, 8)
        y = xq @ wq.to(x.dtype)
    else:
        raise ValueError(f"unknown quant mode {mode!r}")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)          # jax.nn.silu's formula


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s formula, ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mlp_swiglu(params, x, mode="none"):
    g = qlinear(x, params["wg"], mode)
    u = qlinear(x, params["wu"], mode)
    return qlinear(silu(g) * u, params["wd"], mode)


def mlp_squared_relu(params, x, mode="none"):
    h = torch.relu(qlinear(x, params["wi"], mode))
    return qlinear(h * h, params["wd"], mode)


def mlp_arrays(cfg, rng: np.random.Generator, depth=None):
    """The MLP's weights as float32 numpy arrays (the JAX ``init_mlp``'s
    shapes and scales), stacked on the leading ``depth`` axes."""
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"wg": dense_init(rng, d, ff, depth),
                "wu": dense_init(rng, d, ff, depth),
                "wd": dense_init(rng, ff, d, depth)}
    if cfg.mlp_kind == "squared_relu":
        return {"wi": dense_init(rng, d, ff, depth),
                "wd": dense_init(rng, ff, d, depth)}
    raise ValueError(cfg.mlp_kind)


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
