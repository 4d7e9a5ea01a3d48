"""Fused edge-list attention (segment softmax + weighted scatter): wrapper.

Replaces the Pallas TPU kernel ``edge_softmax_kernel`` of
``repro/kernels/edge_softmax.py``. On a CUDA tensor
:func:`edge_softmax_fused` launches ``csrc/edge_softmax.cu`` or raises; on
a CPU tensor it runs ``kernels.ref.edge_softmax_ref``.

The kernel gives one warp to each receiver node, four warps to a block.
The warp finds the node's listed edges by a 32-ary search over the
molecule's slot range (a ballot over one probe per lane and round, keyed
by receiver, with padding slots keyed past every node, because
``build_edge_list`` pads with self-loops that are not in receiver order).
The search reads the list's layout mask; the edge mask may be any subset
of it (an MD skin list refined to the true cutoff masks edges in the
middle of a receiver's run), and a masked edge inside a segment takes no
part in the softmax. A node with no unmasked edge writes exactly 0. The
edges go in chunks of up to 32, one per lane for the logits, with one
warp max and one warp sum per chunk rescaling a running softmax state,
and lanes across the value columns for P.V. :func:`segment_bounds_model`
and :func:`chunked_softmax_model` repeat both steps on the CPU.

What bounds it on the H100: memory. Per real edge it reads a key row and
a value row and does a few flops per byte; at the serving shape the
bytes take ~0.5 us, and the launch and each warp's few dependent round
trips to memory take the rest. The TPU kernel's one-hot (be, cap)
matmuls, which put the scatter on the MXU, have no counterpart here.

``edge_softmax_fused.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_tensor, count_launch, stream_of
from repro_torch.kernels.ref import edge_softmax_ref

__all__ = ["edge_softmax_fused", "MAX_F", "MAX_W", "CHUNK",
           "segment_bounds_model", "chunked_softmax_model"]

MAX_F = 128   # query/key width of the kernel's shared query row
MAX_W = 256   # value width of the register accumulator (8 per lane)
CHUNK = 32    # edges per softmax step: one per lane
_INT_MAX = 2 ** 31 - 1


def edge_softmax_fused(q_scaled: torch.Tensor, k: torch.Tensor,
                       bias: torch.Tensor, values: torch.Tensor,
                       senders: torch.Tensor, receivers: torch.Tensor,
                       edge_mask: torch.Tensor, cap: int,
                       layout_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """out[i] = sum over unmasked edges e -> i of alpha_e * values[e].

    q_scaled, k: (N, F) f32 with N = B * cap; bias: (E,) f32; values:
    (E, W) f32; senders, receivers: (E,) int32 flat node indices;
    edge_mask: (E,) bool; E = B * ec under the ``bucketing.EdgeList``
    layout, whose mask is ``layout_mask`` (None: ``edge_mask`` itself);
    ``edge_mask`` must be a subset of it. Returns (N, W) f32. No autograd
    here: ``kernels.ops`` wraps it.
    """
    if layout_mask is None:
        layout_mask = edge_mask
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
    check_tensor("layout_mask", layout_mask, torch.bool, (e,), dev)
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    err = _build.library().repro_edge_softmax(
        q_scaled.data_ptr(), k.data_ptr(), bias.data_ptr(),
        values.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
        edge_mask.data_ptr(), layout_mask.data_ptr(), out.data_ptr(), n,
        cap, ec, f, w, dev.index, stream_of(dev))
    _build.check(err, "repro_edge_softmax")
    count_launch(edge_softmax_fused)
    return out


edge_softmax_fused.launches = 0


# --- the kernel's two steps, on the CPU ---------------------------------------

def _search_round(lo, hi, keys, target):
    """csrc ``search_round``: one probe per lane at lo + j * stride, a
    ballot of the probes below target (a prefix: the keys are sorted)."""
    stride = (hi - lo + 31) // 32
    probes = lo + stride * np.arange(32)
    probes = probes[probes < hi]
    c = int((keys[probes] < target).sum())
    if c == 0:
        return lo, lo
    return lo + (c - 1) * stride + 1, min(hi, lo + c * stride)


def segment_bounds_model(receivers: np.ndarray, layout_mask: np.ndarray,
                         node: int, cap: int, ec: int):
    """The kernel's 32-ary search for ``node``'s listed edges: (start, end,
    rounds), with [start, end) the slots keyed ``node`` under the key
    ``layout ? receiver : INT_MAX`` in the node's molecule; both bounds
    move in the same rounds, as in the kernel."""
    keys = np.where(layout_mask, receivers.astype(np.int64), _INT_MAX)
    b = node // cap
    s = e = (b * ec, (b + 1) * ec)
    rounds = 0
    while s[0] < s[1] or e[0] < e[1]:
        if s[0] < s[1]:
            s = _search_round(*s, keys, node)
        if e[0] < e[1]:
            e = _search_round(*e, keys, node + 1)
        rounds += 1
    return s[0], e[0], rounds


def chunked_softmax_model(q_scaled, k, bias, values, senders, receivers,
                          edge_mask, cap: int,
                          layout_mask=None) -> torch.Tensor:
    """The kernel's arithmetic per node in float32: segments from
    :func:`segment_bounds_model` on the layout mask (None: ``edge_mask``),
    then per chunk of up to 32 listed edges the logits of the unmasked
    ones, one max and one sum, and the running (max, denominator,
    accumulator) rescaled by ``exp(m_old - m_new)`` (by 1 while every edge
    so far was masked); 0 for a node with no unmasked edge."""
    n = q_scaled.shape[0]
    ec = values.shape[0] // (n // cap)
    layout = edge_mask if layout_mask is None else layout_mask
    recv, lay = receivers.numpy(), layout.numpy()
    out = torch.zeros((n, values.shape[1]), dtype=torch.float32)
    for node in range(n):
        start, end, _ = segment_bounds_model(recv, lay, node, cap, ec)
        m_run = torch.tensor(float("-inf"))
        l_run = torch.tensor(0.0)
        acc = torch.zeros(values.shape[1])
        for c0 in range(start, end, CHUNK):
            c1 = min(c0 + CHUNK, end)
            live = edge_mask[c0:c1]
            logits = k[senders[c0:c1].long()] @ q_scaled[node] + bias[c0:c1]
            logits = torch.where(live, logits, torch.tensor(float("-inf")))
            m_new = torch.maximum(m_run, logits.max())
            if torch.isinf(m_new):
                continue                 # every edge so far masked
            corr = torch.exp(m_run - m_new)
            p = torch.where(live, torch.exp(logits - m_new),
                            torch.tensor(0.0))
            l_run = l_run * corr + p.sum()
            acc = acc * corr + p[live] @ values[c0:c1][live]
            m_run = m_new
        if l_run > 0:
            out[node] = acc / l_run
    return out
