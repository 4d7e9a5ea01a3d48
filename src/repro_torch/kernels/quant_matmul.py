"""Fused dequantize-matmul for W8A8 and W4A8: kernel wrappers.

Replaces the Pallas TPU kernels ``w8a8_matmul`` and ``w4a8_matmul`` of
``repro/kernels/quant_matmul.py``. On a CUDA tensor each wrapper launches
its kernel from ``csrc/quant_matmul.cu`` (a tiled shared-memory int8
GEMM on ``__dp4a`` with exact int32 accumulation; the W4 entry
sign-extends nibbles while it stages the weight tile) or raises; on a
CPU tensor it runs the plain version from ``kernels/ref.py``. The kernel
matches the plain version bit for bit.

What bounds it on the H100: at the serving shapes (M = 256, K <= 80,
N <= 192) the bytes moved, dominated by the float32 output, not the
integer work; the kernel reads each operand tile once per output tile and
masks ragged M, N and K itself, so callers pass unpadded operands (the
TPU wrapper's 128-padding is a TPU contract and is not copied).

``w8a8_matmul.launches`` / ``w4a8_matmul.launches`` count kernel
launches (CPU calls do not count).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_tensor, stream_of
from repro_torch.kernels.ref import w4a8_matmul_ref, w8a8_matmul_ref

__all__ = ["w8a8_matmul", "w4a8_matmul"]


def _launch(entry: str, a_q, a_scale, w, w_scale, n: int) -> torch.Tensor:
    m, k = a_q.shape
    dev = a_q.device
    check_tensor("a_q", a_q, torch.int8, (m, k), dev)
    check_tensor("a_scale", a_scale, torch.float32, (m, 1), dev)
    check_tensor("w_scale", w_scale, torch.float32, (1, n), dev)
    if w.device != dev or not w.is_contiguous() or w.shape[0] != k:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device} does not "
                         f"fit a_q {tuple(a_q.shape)} on {dev}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = getattr(lib, entry)(a_q.data_ptr(), a_scale.data_ptr(),
                              w.data_ptr(), w_scale.data_ptr(),
                              out.data_ptr(), m, n, k, dev.index,
                              stream_of(dev))
    _build.check(err, entry)
    return out


def w8a8_matmul(a_q: torch.Tensor, a_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """out[m, n] = (sum_k a_q[m, k] * w_q[k, n]) * a_scale[m] * w_scale[n].

    a_q (M, K) int8, a_scale (M, 1) f32, w_q (K, N) int8, w_scale (1, N)
    f32 -> (M, N) f32.
    """
    if not a_q.is_cuda:
        return w8a8_matmul_ref(a_q, a_scale, w_q, w_scale)
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q: expected torch.int8, got {w_q.dtype}")
    out = _launch("repro_qmm_w8a8", a_q, a_scale, w_q, w_scale,
                  w_q.shape[1])
    w8a8_matmul.launches += 1
    return out


def w4a8_matmul(a_q: torch.Tensor, a_scale: torch.Tensor,
                w_packed: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """W4A8 variant: ``w_packed`` (K, N/2) uint8 holds two signed nibbles
    per byte along N, low nibble first (``core.quantizers.pack_int4``)."""
    if not a_q.is_cuda:
        return w4a8_matmul_ref(a_q, a_scale, w_packed, w_scale)
    if w_packed.dtype != torch.uint8:
        raise TypeError(f"w_packed: expected torch.uint8, "
                        f"got {w_packed.dtype}")
    out = _launch("repro_qmm_w4a8", a_q, a_scale, w_packed, w_scale,
                  w_packed.shape[1] * 2)
    w4a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
w4a8_matmul.launches = 0
