"""Straight-through estimators, including the paper's Geometric STE.

Counterpart of ``repro/core/ste.py``. Geometric STE (paper Eq. 8): for a
unit direction u quantized to codeword q, the backward pass projects the
incoming gradient onto the tangent space of S^2 at u,
dL/du := (I - u u^T) dL/dq. Both estimators pass no gradient to q.
"""
from __future__ import annotations

import torch

__all__ = ["geometric_ste_direction", "identity_ste"]


class _IdentitySTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, q):
        return q.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GeometricSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, q):
        ctx.save_for_backward(u)
        return q.clone()

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        # (I - u u^T) g  ==  g - u <u, g>
        radial = (u * g).sum(-1, keepdim=True)
        return g - u * radial, None


def identity_ste(u: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain STE: forward -> q, backward -> the gradient straight to u."""
    return _IdentitySTE.apply(u, q)


def geometric_ste_direction(u: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Forward: quantized direction q. Backward: tangent-projected gradient.

    u: (..., 3) unit directions (pre-quantization); q: (..., 3) codewords.
    """
    return _GeometricSTE.apply(u, q)
