"""Per-row abs-max int8 quantization (the A8 step): kernel wrapper.

Replaces the Pallas TPU kernel ``act_quant`` of
``repro/kernels/act_quant.py``. On a CUDA tensor :func:`act_quant`
launches ``csrc/act_quant.cu`` or raises; on a CPU tensor it runs
``kernels.ref.act_quant_ref``. The two agree bit for bit on finite
inputs, in both input types: float32 (the A8 step in front of every
quantized matmul of the SO3 path) and bfloat16 (the LM decode's KV
write, whose scale is rounded to bf16 before the codes divide by it, as
the JAX decode computes it in the activation dtype).

The kernel gives one warp to each row: a shuffle reduction for the
abs-max, then one pass over the row (still in cache) that writes the
codes, and the scale.

What bounds it on the H100: bytes (one read of the input, one byte per
code and four per scale written); at the serving shapes (256 rows of at
most 80 for the SO3 path, 32 rows of 64 per LM layer) the launch itself
takes longer than that.

``act_quant.launches`` counts kernel launches (CPU calls do not count).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_tensor, stream_of
from repro_torch.kernels.ref import act_quant_ref

__all__ = ["act_quant"]

_ENTRIES = {torch.float32: "repro_act_quant_f32",
            torch.bfloat16: "repro_act_quant_bf16"}


def act_quant(x: torch.Tensor):
    """x: (M, K) float32 or bfloat16 -> (q int8 (M, K), scale f32 (M, 1)),
    ``scale = max(max|x|, 1e-8) / 127`` per row (taken in x's dtype) and
    ``q = clip(round(x / scale), -127, 127)``."""
    if not x.is_cuda:
        return act_quant_ref(x)
    entry = _ENTRIES.get(x.dtype)
    if entry is None:
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    m, k = x.shape
    dev = x.device
    check_tensor("x", x, x.dtype, (m, k), dev)
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    scale = torch.empty((m, 1), dtype=torch.float32, device=dev)
    err = getattr(_build.library(), entry)(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), m, k, dev.index,
        stream_of(dev))
    _build.check(err, entry)
    act_quant.launches += 1
    return q, scale


act_quant.launches = 0
