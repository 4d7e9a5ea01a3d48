"""Fused edge-list attention (segment softmax + weighted scatter): wrapper.

Replaces the Pallas TPU kernel ``edge_softmax_kernel`` of
``repro/kernels/edge_softmax.py``. On a CUDA tensor
:func:`edge_softmax_fused` launches ``csrc/edge_softmax.cu`` or raises; on
a CPU tensor it runs ``kernels.ref.edge_softmax_ref``.

The kernel gives one warp to each receiver node: it finds the node's
real edges by binary search over the molecule's slot range (keyed by
receiver, with masked padding slots keyed past every node, because
``build_edge_list`` pads with self-loops that are not in receiver order),
then runs the online-softmax recurrence over them with lanes across the
feature and value columns. A node with no real edge gets exactly 0.

What bounds it on the H100: memory. Per real edge it reads a key row and
a value row and does a few flops per byte; every row is read by a whole
warp on consecutive addresses. The TPU kernel's one-hot (be, cap)
matmuls, which put the scatter on the MXU, have no counterpart here.

``edge_softmax_fused.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_tensor, stream_of
from repro_torch.kernels.ref import edge_softmax_ref

__all__ = ["edge_softmax_fused", "MAX_F", "MAX_W"]

MAX_F = 128   # query/key width the kernel keeps in registers (4 per lane)
MAX_W = 256   # value width of the register accumulator (8 per lane)


def edge_softmax_fused(q_scaled: torch.Tensor, k: torch.Tensor,
                       bias: torch.Tensor, values: torch.Tensor,
                       senders: torch.Tensor, receivers: torch.Tensor,
                       edge_mask: torch.Tensor, cap: int) -> torch.Tensor:
    """out[i] = sum over real edges e -> i of alpha_e * values[e].

    q_scaled, k: (N, F) f32 with N = B * cap; bias: (E,) f32; values:
    (E, W) f32; senders, receivers: (E,) int32 flat node indices;
    edge_mask: (E,) bool; E = B * ec under the ``bucketing.EdgeList``
    layout. Returns (N, W) f32. No autograd here: ``kernels.ops`` wraps it.
    """
    n, f = q_scaled.shape
    e, w = values.shape
    if not q_scaled.is_cuda:
        return edge_softmax_ref(q_scaled, k, bias, senders, receivers,
                                edge_mask, values, n)
    if n % cap or e % (n // cap):
        raise ValueError(f"{n} nodes / {e} edges do not tile molecules of "
                         f"{cap} atoms")
    if f > MAX_F or w > MAX_W:
        raise ValueError(f"F={f} or W={w} above the kernel's {MAX_F}/{MAX_W}")
    ec = e // (n // cap)
    dev = q_scaled.device
    check_tensor("q_scaled", q_scaled, torch.float32, (n, f), dev)
    check_tensor("k", k, torch.float32, (n, f), dev)
    check_tensor("bias", bias, torch.float32, (e,), dev)
    check_tensor("values", values, torch.float32, (e, w), dev)
    check_tensor("senders", senders, torch.int32, (e,), dev)
    check_tensor("receivers", receivers, torch.int32, (e,), dev)
    check_tensor("edge_mask", edge_mask, torch.bool, (e,), dev)
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    err = _build.library().repro_edge_softmax(
        q_scaled.data_ptr(), k.data_ptr(), bias.data_ptr(),
        values.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
        edge_mask.data_ptr(), out.data_ptr(), n, cap, ec, f, w, dev.index,
        stream_of(dev))
    _build.check(err, "repro_edge_softmax")
    edge_softmax_fused.launches += 1
    return out


edge_softmax_fused.launches = 0
