"""Robust attention normalization (paper §III-E): counterpart of
``repro/core/attention_norm.py``. Cosine attention l2-normalizes queries
and keys, logits = tau * <q_hat, k_hat> (+ an optional invariant bias),
so low-bit rounding of q/k cannot let one large magnitude dominate the
softmax. The norm's floor splits its gradient at a tie, as
``jnp.maximum`` does."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["l2_normalize", "cosine_attention_logits",
           "robust_attention_weights"]

_EPS = 1e-6


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = _EPS) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.maximum(norm, norm.new_full((), eps))


def cosine_attention_logits(q: torch.Tensor, k: torch.Tensor,
                            tau: float = 10.0,
                            bias: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """q: (..., n_q, d), k: (..., n_k, d) -> logits (..., n_q, n_k)."""
    logits = tau * torch.einsum("...qd,...kd->...qk", l2_normalize(q),
                                l2_normalize(k))
    if bias is not None:
        logits = logits + bias
    return logits


def robust_attention_weights(q: torch.Tensor, k: torch.Tensor,
                             tau: float = 10.0,
                             bias: Optional[torch.Tensor] = None,
                             mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Softmax over keys of :func:`cosine_attention_logits`; masked-out
    pairs (``mask`` False) get the logit -1e9."""
    logits = cosine_attention_logits(q, k, tau, bias)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    z = torch.exp(logits - logits.amax(-1, keepdim=True))
    return z / z.sum(-1, keepdim=True)
