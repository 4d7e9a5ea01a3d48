"""One-token decode attention over an int8 K/V cache: kernel wrapper.

Replaces the Pallas TPU kernel ``decode_attention_int8kv`` of
``repro/kernels/attention_int8kv.py``. On CUDA tensors
:func:`decode_attention_int8kv` launches ``csrc/attention_int8kv.cu`` or
raises; on CPU tensors it runs ``kernels.ref.decode_attention_int8kv_ref``.

Layout: the grouped one of the LM decode, not the TPU wrapper's
collapsed ``(BH, D)`` with K/V replicated per query head. Each row holds
the ``G`` query heads of one kv head, so each cached token is read once
for all of them. ``n_valid`` replaces the decode's ``-1e30`` mask: the
kernel attends to tokens ``[0, n_valid)``, which is the same function,
since a masked token's weight is exactly 0 in float32. The TPU kernel's
rule ``S % bs == 0`` is a TPU tiling contract and is not copied.

The kernel dequantizes K and V in shared memory and runs the online
softmax (running max, denominator and accumulator, all f32) over tiles
of 32 tokens. The sequence is split across blocks, with a second small
kernel combining the splits in order: at batch 8 with 2 kv heads there
are only 16 rows for 132 SMs, so the split, and not the rows, fills the
card (about two blocks per SM, and never a split without a token).

What bounds it on the H100: bytes (2 * D code bytes and 8 scale bytes
per cached token, against about 4 * G * D flops); at the decode's
shapes (16 rows of at most 1,024 tokens) the two launches take longer.

``decode_attention_int8kv.launches`` counts calls that launched the
kernels (one per call; CPU calls do not count).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_tensor, stream_of
from repro_torch.kernels.ref import decode_attention_int8kv_ref

__all__ = ["decode_attention_int8kv", "n_splits"]

_TILE = 32                 # tokens per shared-memory tile (csrc TILE)
_TARGET_BLOCKS = 2 * 132   # two blocks per H100 SM


def n_splits(rows: int, n_valid: int) -> int:
    """How many sequence splits the kernel runs: enough blocks for about
    two per SM, but never a split shorter than one tile."""
    return max(1, min(math.ceil(n_valid / _TILE),
                      math.ceil(_TARGET_BLOCKS / max(rows, 1))))


def decode_attention_int8kv(q: torch.Tensor, k_q: torch.Tensor,
                            k_scale: torch.Tensor, v_q: torch.Tensor,
                            v_scale: torch.Tensor, n_valid: int,
                            softmax_scale: float) -> torch.Tensor:
    """q (BH, G, D) f32; k_q/v_q (BH, S, D) int8; k_scale/v_scale (BH, S)
    f32; attends to tokens ``[0, n_valid)``, ``1 <= n_valid <= S``.
    Returns (BH, G, D) f32."""
    bh, g, d = q.shape
    s = k_q.shape[1]
    if not 1 <= n_valid <= s:
        raise ValueError(f"n_valid={n_valid} outside [1, {s}]")
    if not q.is_cuda:
        return decode_attention_int8kv_ref(q, k_q, k_scale, v_q, v_scale,
                                           n_valid, softmax_scale)
    dev = q.device
    check_tensor("q", q, torch.float32, (bh, g, d), dev)
    for name, t, dt, shape in (("k_q", k_q, torch.int8, (bh, s, d)),
                               ("v_q", v_q, torch.int8, (bh, s, d)),
                               ("k_scale", k_scale, torch.float32, (bh, s)),
                               ("v_scale", v_scale, torch.float32, (bh, s))):
        check_tensor(name, t, dt, shape, dev)
    splits = n_splits(bh, n_valid)
    chunk = math.ceil(math.ceil(n_valid / splits) / _TILE) * _TILE
    splits = math.ceil(n_valid / chunk)
    out = torch.empty((bh, g, d), dtype=torch.float32, device=dev)
    part_m = torch.empty((bh, splits, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((bh, splits, g, d), dtype=torch.float32,
                           device=dev)
    err = _build.library().repro_decode_attention_int8kv(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), bh, g, d, s, n_valid, chunk,
        splits, float(softmax_scale), dev.index, stream_of(dev))
    _build.check(err, "repro_decode_attention_int8kv")
    decode_attention_int8kv.launches += 1
    return out


decode_attention_int8kv.launches = 0
