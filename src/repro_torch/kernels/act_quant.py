"""Per-row abs-max int8 quantization (the A8 step) and the LM decode's
int8 KV write: kernel wrappers.

Replaces the Pallas TPU kernel ``act_quant`` of
``repro/kernels/act_quant.py``. Both entries launch a kernel of
``csrc/act_quant.cu`` on CUDA tensors (or raise) and run their plain
version of ``kernels.ref`` on CPU tensors; kernel and plain version agree
bit for bit on finite inputs, in both input types: float32 and bfloat16,
whose scale is rounded to bf16 before the codes divide by it, as the JAX
decode computes it in the activation dtype.

:func:`act_quant` is the TPU kernel's own contract, (M, K) rows in, codes
and scales out: one warp per row, a shuffle reduction for the abs-max,
then one pass over the row (still in cache) that writes the codes. No main
path runs it: the SO3 path quantizes inside the matmul launch, and the LM
decode takes :func:`kv_append_int8`.

:func:`kv_append_int8` is the LM decode's whole int8 KV write in one
launch per layer and step: it reads the new token's K and V rows where
the projection left them (strided views, last dim contiguous), quantizes
each as :func:`act_quant` would, and stores codes and scales straight
into the cache at ``cur_index``: a Python int, or a 0-d int32 tensor on
the card that the kernel reads there (the decode's traced position, so a
captured step serves every position). A replicated head reads its kv
head by index. One warp per (batch row, effective head, K|V), a block for the K
and V rows of one head; each lane holds ``elems_per_lane(hd)`` elements
in registers (:func:`kv_append_lane_map` is the work split, held on the
CPU by the tests).

What bounds both on the H100: bytes (one read of the input, one byte per
code and four per scale written); at the serving shapes (32 rows of 64
per LM layer) the launch itself takes far longer than that.

``act_quant.launches`` and ``kv_append_int8.launches`` count kernel
launches (CPU calls do not count).
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (check_position, check_tensor,
                                        count_launch, stream_of)
from repro_torch.kernels.ref import act_quant_ref, kv_append_int8_ref

__all__ = ["act_quant", "kv_append_int8", "elems_per_lane",
           "kv_append_lane_map", "KV_HEAD_DIMS"]

_ENTRIES = {torch.float32: "repro_act_quant_f32",
            torch.bfloat16: "repro_act_quant_bf16"}
_KV_ENTRIES = {torch.float32: "repro_kv_append_int8_f32",
               torch.bfloat16: "repro_kv_append_int8_bf16"}
KV_HEAD_DIMS = (8, 64, 128)   # the KV write's instantiations (as K6's)
_KV_WARPS = 2                 # warps per block (csrc KV_WARPS)


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
    count_launch(act_quant)
    return q, scale


act_quant.launches = 0


def elems_per_lane(hd: int) -> int:
    """Consecutive row elements each lane of the KV write holds: 4 at
    head_dim 128, else 2 (at 8, only four lanes of the warp work)."""
    return 4 if hd == 128 else 2


def kv_append_lane_map(batch: int, n_kv: int, hd: int,
                       replicate: int = 1) -> Dict[str, np.ndarray]:
    """The KV write's work split, as the kernel indexes it.

    The grid is ``batch * n_kv * replicate`` blocks of two warps; warp w of
    block i takes row ``2 * i + w``: tensor ``row & 1`` (0 = K, 1 = V),
    effective head ``bh = row >> 1`` of batch row ``bh // H``. Returns,
    per thread (shape (blocks, 64)): ``tensor``, ``b``, ``h`` (the
    effective head written), ``src`` (the kv head read), ``first`` (the
    first of the lane's ``elems_per_lane(hd)`` consecutive elements, -1
    for an idle lane) and ``scale`` (whether the lane stores the scale).
    """
    heads = n_kv * replicate
    epl = elems_per_lane(hd)
    block = np.arange(batch * heads)[:, None]
    thread = np.arange(32 * _KV_WARPS)[None, :]
    lane = thread & 31
    row = block * _KV_WARPS + (thread >> 5)
    bh = row >> 1
    h = bh % heads
    out = {"tensor": row & 1, "b": bh // heads, "h": h,
           "src": h // replicate,
           "first": np.where(lane < hd // epl, lane * epl, -1),
           "scale": lane == 0}
    return {k: np.broadcast_to(v, row.shape).copy() for k, v in out.items()}


def kv_append_int8(k_new: torch.Tensor, v_new: torch.Tensor,
                   k_q: torch.Tensor, k_s: torch.Tensor, v_q: torch.Tensor,
                   v_s: torch.Tensor, cur_index: Union[int, torch.Tensor],
                   replicate: int = 1) -> None:
    """Quantize the new token's K and V rows into the int8 cache, in place.

    k_new/v_new: (B, nkv, hd) float32 or bfloat16 (views allowed, last dim
    contiguous); k_q/v_q: (B, nkv * replicate, S, hd) int8 and k_s/v_s:
    (B, nkv * replicate, S) float32, contiguous. Effective head h stores
    the codes and scale of ``new[:, h // replicate]`` (as
    ``act_quant``) at position ``cur_index``, which must lie in ``[0,
    S)``; nothing else in the cache changes. ``cur_index`` is a Python
    int (checked here) or a 0-d int32 tensor on the cache's device, read
    there (the kernel clamps it into ``[0, S)``; the caller owns the
    range). On the card hd must be 8, 64 or 128, and the rows aligned to
    the lane's vector load.
    """
    B, nkv, hd = k_new.shape
    if replicate < 1:
        raise ValueError(f"replicate={replicate}: expected >= 1")
    heads = nkv * replicate
    if v_new.shape != (B, nkv, hd):
        raise ValueError(f"v_new: expected shape {(B, nkv, hd)}, got "
                         f"{tuple(v_new.shape)}")
    if k_q.dim() != 4:
        raise ValueError(f"k_q: expected (B, H, S, hd), got "
                         f"{tuple(k_q.shape)}")
    seq = k_q.shape[2]
    for name, t, shape in (("k_q", k_q, (B, heads, seq, hd)),
                           ("v_q", v_q, (B, heads, seq, hd)),
                           ("k_s", k_s, (B, heads, seq)),
                           ("v_s", v_s, (B, heads, seq))):
        if t.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    on_device = isinstance(cur_index, torch.Tensor)
    if not on_device and not 0 <= cur_index < seq:
        raise ValueError(f"cur_index={cur_index} outside the cache's "
                         f"[0, {seq}) positions")
    if not k_new.is_cuda:
        kv_append_int8_ref(k_new, v_new, k_q, k_s, v_q, v_s, cur_index,
                           replicate)
        return
    entry = _KV_ENTRIES.get(k_new.dtype)
    if entry is None or v_new.dtype != k_new.dtype:
        raise TypeError(f"k_new, v_new: expected both float32 or both "
                        f"bfloat16, got {k_new.dtype} and {v_new.dtype}")
    if hd not in KV_HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel takes head_dim in "
                         f"{KV_HEAD_DIMS}")
    # the checks below run on every decode step of every layer: each
    # reads a tensor property once (they cost host time, not card time)
    dev = k_new.get_device()
    epl = elems_per_lane(hd)
    strides = []
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        sb, sh, sd = t.stride()
        sb, sh = (sb if B > 1 else 0), (sh if nkv > 1 else 0)
        if t.get_device() != dev:
            raise ValueError(f"{name}: on {t.device}, expected cuda:{dev}")
        if sd != 1:
            raise ValueError(f"{name}: the last dim must be contiguous")
        if t.data_ptr() % (epl * t.element_size()) or sb % epl or sh % epl:
            raise ValueError(f"{name}: each lane loads {epl} elements at "
                             "once; rows must be aligned to them")
        if max(sb, sh) >= 2 ** 31:
            raise ValueError(f"{name}: strides past the kernel's int range")
        strides += [sb, sh]
    ptrs = []
    for name, t, dt in (("k_q", k_q, torch.int8), ("k_s", k_s, torch.float32),
                        ("v_q", v_q, torch.int8), ("v_s", v_s, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.get_device() != dev:
            raise ValueError(f"{name}: on {t.device}, expected cuda:{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        ptrs.append(t.data_ptr())
    if ptrs[0] % epl or ptrs[2] % epl:
        raise ValueError(f"k_q, v_q: each lane stores {epl} codes at once; "
                         "the caches must be aligned to them")
    if on_device:
        check_position("cur_index", cur_index, k_new.device)
        cur_ptr, cur = cur_index.data_ptr(), 0
    else:
        cur_ptr, cur = None, cur_index
    if B * heads == 0:
        return
    err = getattr(_build.library(), entry)(
        k_new.data_ptr(), v_new.data_ptr(), *strides, *ptrs, B, heads,
        replicate, seq, hd, cur_ptr, cur, dev, stream_of(k_new.device))
    _build.check(err, entry)
    count_launch(kv_append_int8)


kv_append_int8.launches = 0
