"""Robust attention normalization (paper §III-E): counterpart of
``repro/core/attention_norm.py``. Cosine attention l2-normalizes queries
and keys so low-bit rounding of q/k cannot let one large magnitude
dominate the softmax."""
from __future__ import annotations

import torch

__all__ = ["l2_normalize"]

_EPS = 1e-6


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = _EPS) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)
