"""Straight-through estimators, including the paper's Geometric STE.

Counterpart of ``repro/core/ste.py``. Geometric STE (paper Eq. 8): for a
unit direction u quantized to codeword q, the backward pass projects the
incoming gradient onto the tangent space of S^2 at u,
dL/du := (I - u u^T) dL/dq. Both estimators pass no gradient to q.

Nested differentiation (a force loss: forces taken with
``create_graph=True``, then the parameter gradient of a loss on them).
The JAX package's estimators are ``custom_vjp`` rules, and JAX applies
such a rule only in the innermost derivative that sees the estimator's
input: an outer derivative differentiates its forward as written, where
the rounded value or the codeword has zero derivative, and reaches the
input only through what the rule's backward saved (the geometric STE's
``u``). With ``nested=True`` an estimator here does the same: it passes
gradient in a recording backward (grad mode on: the force pass) and none
in a non-recording one (the parameter pass over it); the geometric
STE's backward stays differentiable in ``u``. With ``nested=False``
(every first-order use) it passes gradient in every backward.
"""
from __future__ import annotations

import torch

__all__ = ["geometric_ste_direction", "identity_ste", "round_ste"]


def _outer(ctx) -> bool:
    """In a nested estimator's backward: True in the non-recording pass,
    where the reference's derivative of the forward is zero."""
    return ctx.nested and not torch.is_grad_enabled()


class _IdentitySTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, q, nested):
        ctx.nested = nested
        return q.clone()

    @staticmethod
    def backward(ctx, g):
        return (None if _outer(ctx) else g), None, None


class _GeometricSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, q, nested):
        ctx.nested = nested
        ctx.save_for_backward(u)
        return q.clone()

    @staticmethod
    def backward(ctx, g):
        if _outer(ctx):
            return None, None, None
        (u,) = ctx.saved_tensors
        # (I - u u^T) g  ==  g - u <u, g>
        radial = (u * g).sum(-1, keepdim=True)
        return g - u * radial, None, None


class _RoundSTE(torch.autograd.Function):
    """``round(y)``, nested: straight through in a recording backward,
    zero in a non-recording one."""
    @staticmethod
    def forward(ctx, y):
        ctx.nested = True
        return torch.round(y)

    @staticmethod
    def backward(ctx, g):
        return None if _outer(ctx) else g


def identity_ste(u: torch.Tensor, q: torch.Tensor,
                 nested: bool = False) -> torch.Tensor:
    """Plain STE: forward -> q, backward -> the gradient straight to u."""
    return _IdentitySTE.apply(u, q, nested)


def geometric_ste_direction(u: torch.Tensor, q: torch.Tensor,
                            nested: bool = False) -> torch.Tensor:
    """Forward: quantized direction q. Backward: tangent-projected gradient.

    u: (..., 3) unit directions (pre-quantization); q: (..., 3) codewords.
    """
    return _GeometricSTE.apply(u, q, nested)


def round_ste(y: torch.Tensor, nested: bool = False) -> torch.Tensor:
    """``round(y)`` with a straight-through gradient (see the module's
    note for ``nested``)."""
    if nested:
        return _RoundSTE.apply(y)
    return y + (torch.round(y) - y).detach()
