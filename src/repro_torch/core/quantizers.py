"""Linear (invariant-branch) quantizers and the log-magnitude codec.

Counterpart of ``repro/core/quantizers.py``: symmetric abs-max scales,
real quantization to a signed grid, int4 nibble packing (low nibble
first along the last axis) and the log-domain magnitude quantizer Q_m of
MDDQ. ``torch.round`` rounds half to even, like ``jnp.round``, so codes
agree with the JAX package bit for bit.

Clips that carry gradient go through :func:`clip`, which splits the
gradient at a bound the way ``jnp.clip`` does (half to each side);
``torch.clamp`` passes all of it, so the abs-max entry of every
fake-quantized tensor, which lands exactly on ``qmax``, would get twice
the reference's gradient.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ste import round_ste

__all__ = ["QuantConfig", "qmax", "clip", "div_by_constant",
           "scale_from_amax", "abs_max_scale", "quantize", "dequantize",
           "fake_quant", "fake_quant_ste", "pack_int4", "unpack_int4",
           "log_magnitude_bounds", "quantize_log_magnitude",
           "dequantize_log_magnitude", "f32"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration of a symmetric linear quantizer."""

    bits: int = 8
    # axis along which a separate scale is computed; None = per-tensor
    channel_axis: Optional[int] = None
    # numerical floor for scales so zero tensors don't produce inf
    eps: float = 1e-8

    @property
    def levels(self) -> int:
        return 2 ** self.bits


def qmax(bits: int) -> int:
    """Largest representable magnitude of a signed symmetric b-bit grid."""
    return 2 ** (bits - 1) - 1


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)`` with
    tensor bounds, so an entry exactly on a bound gets half the gradient,
    as in JAX (``torch.clamp`` gives it all). The bounds are 0-d tensors
    filled on x's device (no host-to-device copy, so no sync)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def div_by_constant(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, correctly rounded on every device. On CUDA, PyTorch
    divides by a Python scalar by multiplying with its reciprocal, which
    moves about 4% of abs-max scales by an ulp; a tensor divisor gets the
    IEEE division there too, as on the CPU and in the CUDA kernels."""
    return x / torch.full_like(x, c)


def scale_from_amax(amax: torch.Tensor, bits: int,
                    eps: float = 1e-8) -> torch.Tensor:
    """``max(amax, eps) / qmax(bits)`` in amax's dtype, correctly rounded
    on every device: the one rounding of every abs-max scale in the
    package (weights, activations, the int8 KV write)."""
    return div_by_constant(torch.clamp(amax, min=eps), qmax(bits))


def abs_max_scale(x: torch.Tensor, bits: int,
                  channel_axis: Optional[int] = None,
                  eps: float = 1e-8) -> torch.Tensor:
    """Symmetric abs-max calibration: scale such that max|x| maps to qmax.
    With ``channel_axis`` the max runs over every other axis (kept)."""
    if channel_axis is None:
        amax = x.abs().amax()
    else:
        axes = tuple(i for i in range(x.ndim) if i != channel_axis % x.ndim)
        amax = x.abs().amax(dim=axes, keepdim=True)
    return scale_from_amax(amax, bits, eps)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Real quantization to a signed integer grid (int8 storage)."""
    m = qmax(bits)
    return torch.clamp(torch.round(x / scale), -m, m).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def fake_quant(x: torch.Tensor, scale: torch.Tensor,
               bits: int) -> torch.Tensor:
    """Quantize-dequantize without STE (gradients are zero a.e.)."""
    m = qmax(bits)
    return torch.clamp(torch.round(x / scale), -m, m) * scale


def fake_quant_ste(x: torch.Tensor, bits: int = 8,
                   channel_axis: Optional[int] = None,
                   scale: Optional[torch.Tensor] = None,
                   nested: bool = False) -> torch.Tensor:
    """Fake quantization with straight-through rounding. The clip is taken
    before the rounding, so saturated entries get zero gradient and an
    entry exactly on ``qmax`` half of it (:func:`clip`, as ``jnp.clip``).
    ``nested``: see ``core.ste``."""
    if scale is None:
        scale = abs_max_scale(x.detach(), bits, channel_axis)
    m = qmax(bits)
    return round_ste(clip(x / scale, -m, m), nested) * scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack values in [-8, 7] pairwise along the last axis into uint8,
    low nibble first. The last axis must be even."""
    if q.shape[-1] % 2 != 0:
        raise ValueError(f"last dim must be even, got {tuple(q.shape)}")
    q = q.to(torch.int32) & 0xF            # two's complement nibble
    lo = q[..., 0::2]
    hi = q[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; int8 values in [-8, 7]."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2) \
        .to(torch.int8)


@functools.lru_cache(maxsize=None)
def log_magnitude_bounds(m_min: float, m_max: float):
    """``(log m_min, log m_max)`` as float32 values, the constants both the
    codec below and the MDDQ encode kernel use (float32 ``log`` taken on
    the CPU, so every device sees the same two numbers; once per pair, so
    a captured or traced step reads no tensor for them)."""
    lo = torch.log(torch.tensor(m_min, dtype=torch.float32))
    hi = torch.log(torch.tensor(m_max, dtype=torch.float32))
    return float(lo), float(hi)


def quantize_log_magnitude(m: torch.Tensor, bits: int = 8,
                           m_min: float = 1e-6,
                           m_max: float = 1e3) -> torch.Tensor:
    """Quantize positive magnitudes on a log grid -> int32 codes."""
    levels = 2 ** bits - 1
    lo, hi = log_magnitude_bounds(m_min, m_max)
    lm = torch.log(torch.clamp(m, f32(m_min), f32(m_max)))
    t = (lm - lo) / f32(hi - lo)
    return torch.clamp(torch.round(t * levels), 0, levels).to(torch.int32)


def dequantize_log_magnitude(code: torch.Tensor, bits: int = 8,
                             m_min: float = 1e-6,
                             m_max: float = 1e3) -> torch.Tensor:
    levels = 2 ** bits - 1
    lo, hi = log_magnitude_bounds(m_min, m_max)
    t = code.to(torch.float32) / levels
    return torch.exp(lo + t * f32(hi - lo))


def f32(x: float) -> float:
    """Round a Python float to the nearest float32, as JAX's weak-typed
    scalars do inside float32 expressions (numpy's conversion, the same
    IEEE rounding as a float32 tensor's, reads no tensor)."""
    return float(np.float32(x))
