"""Gradient compression with error feedback: counterpart of
``repro/optim/compression.py``.

1. :func:`ef_compress` / :class:`ErrorFeedbackState`: each step, (grad +
   residual) is quantized to int8 per leaf (one abs-max scale per leaf)
   and the quantization error is carried to the next step, so the
   long-run update stays unbiased (Karimireddy et al. 2019). This models
   the numerics of a compressed all-reduce and is what the training
   launcher runs under ``--grad-compression ef8``.
2. :func:`int8_psum`: an all-reduce whose payload is int8 codes, on
   ``torch.distributed``: an all-reduce ``MAX`` of the scale (so every
   rank dequantizes with the same one), then an int32 ``SUM`` of the
   codes, dequantized once. It takes the place of the reference's
   ``shard_map`` ``pmax`` and ``psum``; like the reference's launcher, the
   port's does not wire it into training.

Trees are ``repro_torch.tree`` trees of float tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.quantizers import abs_max_scale, dequantize, quantize
from repro_torch.tree import tree_map

__all__ = ["ErrorFeedbackState", "ef_init", "ef_compress", "int8_psum",
           "int8_psum_tree"]


class ErrorFeedbackState(NamedTuple):
    residual: Any


def ef_init(params) -> ErrorFeedbackState:
    return ErrorFeedbackState(tree_map(torch.zeros_like, params))


@torch.no_grad()
def ef_compress(grads, state: ErrorFeedbackState, bits: int = 8
                ) -> Tuple[Any, ErrorFeedbackState]:
    """Quantize (grads + residual) per leaf; carry the error. Returns the
    dequantized gradients (what a compressed all-reduce would deliver)
    and the new state."""
    residual = []

    def leaf(g, r):
        tot = g + r
        scale = abs_max_scale(tot, bits)
        deq = dequantize(quantize(tot, scale, bits), scale)
        residual.append(tot - deq)
        return deq

    deq = tree_map(leaf, grads, state.residual)
    rest = iter(residual)
    return deq, ErrorFeedbackState(tree_map(lambda _: next(rest), deq))


def int8_psum(x: torch.Tensor, group: Optional[Any] = None) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` (the default process group
    when None) with an int8 payload: each rank quantizes against the
    largest scale of any rank, the int32 sum of the codes is exact, and
    the result is that sum times the shared scale. Every rank calls it
    with the same shape; returns float32."""
    scale = abs_max_scale(x.detach(), 8)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = quantize(x.detach(), scale, 8).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(torch.float32) * scale


def int8_psum_tree(grads, group: Optional[Any] = None):
    return tree_map(lambda g: int8_psum(g, group), grads)
