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

The kernel takes one launch. Each block of 4 warps takes a sequence
split of one row, and each warp a contiguous run of whole 32-token steps
with its own online-softmax state in registers (lane t scores token t
against the row's G heads; each lane accumulates D / 32 fixed dims of
P.V); the warps merge once at the end. With several splits the last
block of a row to finish combines the row's splits in order, counted by
a per-row ticket in a buffer kept per device and stream, or, for a
captured program, in the program's own store (``_launch.owned_buffers``);
the kernel resets each ticket it uses, so the buffer is zeroed once.
The splits give every warp at least one 32-token step and the card at
most about two blocks per SM: at the decode's 16 rows, up to 128 valid
tokens take one block per row and no combine.

What bounds it on the H100: bytes (2 * D code bytes and 8 scale bytes
per cached token, against about 4 * G * D flops) at long caches; at the
decode's shapes (16 rows of at most a few hundred valid tokens) the
latency of one launch and one round trip to device memory.

The position may also live on the card: in place of ``n_valid``, the
decode position ``p`` (the reference's traced ``cur_index``) as a 0-d
int32 tensor on q's device, which every block reads (``n_valid = p +
1``), so one captured decode step serves every position. The host then cannot plan from n_valid: the grid takes the
splits the cache length S needs (the most any position can), each block
derives from the n_valid it reads the host's own plan, chunk and run
(:func:`device_split_plan`). The host's plan's splits are live; a split
past them exits at once (an empty partial would weigh exactly 0), and
the ticket combine counts and merges the live splits in order, so the
result does not depend on which block finishes last and equals the int
entry's bit for bit, and one live split writes the output itself.

``decode_attention_int8kv.launches`` counts calls that launched the
kernel (one launch per call; CPU calls do not count).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (check_position, check_tensor,
                                        count_launch, owned_buffers,
                                        stream_of)
from repro_torch.kernels.ref import decode_attention_int8kv_ref

__all__ = ["decode_attention_int8kv", "n_splits", "split_plan",
           "device_split_plan", "warp_token_ranges"]

_WARPS = 4                 # warps per block (csrc WARPS)
_STEP = 32                 # tokens a warp takes per step (one per lane)
_TARGET_BLOCKS = 2 * 132   # two blocks per H100 SM
_HEAD_DIMS = (8, 64, 128)  # the kernel's instantiations
_MAX_GROUP = 16

_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
_tickets_lock = threading.Lock()


def n_splits(rows: int, n_valid: int) -> int:
    """How many sequence splits the kernel runs: enough blocks for about
    two per SM, but never fewer than one 32-token step per warp."""
    return max(1, min(math.ceil(n_valid / (_WARPS * _STEP)),
                      math.ceil(_TARGET_BLOCKS / max(rows, 1))))


def split_plan(rows: int, n_valid: int) -> Tuple[int, int, int]:
    """(splits, chunk, run): split y takes the tokens [y * chunk,
    min((y + 1) * chunk, n_valid)), and warp w of its block the run of
    ``run`` tokens from y * chunk + w * run within it. chunk and run are
    whole 32-token steps; no split is empty."""
    splits = n_splits(rows, n_valid)
    chunk = math.ceil(math.ceil(n_valid / splits) / _STEP) * _STEP
    splits = math.ceil(n_valid / chunk)
    run = math.ceil(chunk / _STEP / _WARPS) * _STEP
    return splits, chunk, run


def device_split_plan(rows: int, seq: int,
                      n_valid: int) -> Tuple[int, int, int]:
    """The plan of a device position: (splits, chunk, run) with the grid's
    splits sized from the cache length ``seq`` on the host (the most any
    position needs) and chunk and run those of :func:`split_plan` of
    ``n_valid``, which each block derives as the kernel does. Split y
    takes the tokens [y * chunk, min((y + 1) * chunk, n_valid)): the
    first ``split_plan(rows, n_valid)[0]`` splits, the rest none."""
    _, chunk, run = split_plan(rows, n_valid)
    return n_splits(rows, seq), chunk, run


def warp_token_ranges(rows: int, n_valid: int, seq: Optional[int] = None
                      ) -> Iterator[Tuple[int, int, int, int]]:
    """(split, warp, first token, end) of every warp's run, as the kernel
    indexes them (an empty run has end <= first): under the host plan, or
    with ``seq`` under the device plan of an ``seq``-token cache."""
    splits, chunk, run = (split_plan(rows, n_valid) if seq is None
                          else device_split_plan(rows, seq, n_valid))
    for y in range(splits):
        split_end = min(y * chunk + chunk, n_valid)
        for w in range(_WARPS):
            begin = y * chunk + w * run
            yield y, w, begin, min(begin + run, split_end)


def _ticket_buffer(dev: torch.device, stream: int, rows: int) -> torch.Tensor:
    """The per-row tickets of the split combine on ``dev`` and ``stream``
    (in the store of the program warmed up and captured there, if one
    is), zeroed when first made (one memset) and kept zero by the kernel.
    A per-stream buffer too small is replaced; a program's lives as long
    as the program, whose graph holds its pointer."""
    store, key = owned_buffers(stream), ("tickets", dev.index)
    if store is None:
        store, key = _tickets, (dev.index, stream)
    with _tickets_lock:
        buf = store.get(key)
        if buf is None or buf.numel() < rows:
            # a capture's eager warm-up makes its program's buffer: made
            # inside the capture, it would be zeroed on no replay
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "decode_attention_int8kv: no ticket buffer for this "
                    "program before its capture; run the call eagerly on "
                    "the capturing stream first")
            buf = torch.zeros((max(rows, 256),), dtype=torch.int32,
                              device=dev)
            store[key] = buf
        return buf


def decode_attention_int8kv(q: torch.Tensor, k_q: torch.Tensor,
                            k_scale: torch.Tensor, v_q: torch.Tensor,
                            v_scale: torch.Tensor,
                            n_valid: Union[int, torch.Tensor],
                            softmax_scale: float) -> torch.Tensor:
    """q (BH, G, D) f32; k_q/v_q (BH, S, D) int8; k_scale/v_scale (BH, S)
    f32; attends to tokens ``[0, n_valid)``. ``n_valid`` is a Python int
    (``ValueError`` unless it lies in ``[1, S]``), or in its place the
    decode position ``p`` as a 0-d int32 tensor on q's device, read on the
    device: the tokens ``[0, p]`` (the kernel clamps ``p`` into ``[0,
    S)``; the caller owns the range). Returns (BH, G, D) f32."""
    bh, g, d = q.shape
    s = k_q.shape[1]
    on_device = isinstance(n_valid, torch.Tensor)
    if not on_device and not 1 <= n_valid <= s:
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
    if d not in _HEAD_DIMS or not 1 <= g <= _MAX_GROUP:
        raise ValueError(f"head_dim {d} and group {g}: the kernel takes "
                         f"head_dim in {_HEAD_DIMS} and 1..{_MAX_GROUP} "
                         "query heads per kv head")
    for name, t in (("q", q), ("k_q", k_q), ("v_q", v_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel loads 16-byte vectors; "
                             "its data must be 16-byte aligned")
    if on_device:
        check_position("n_valid", n_valid, dev)
        splits, chunk, run = n_splits(bh, s), 0, 0
        pos_ptr, n_host = n_valid.data_ptr(), 0
    else:
        n_host = n_valid
        splits, chunk, run = split_plan(bh, n_host)
        pos_ptr = None
    stream = stream_of(dev)
    out = torch.empty((bh, g, d), dtype=torch.float32, device=dev)
    part_m = torch.empty((bh, splits, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((bh, splits, g, d), dtype=torch.float32,
                           device=dev)
    tickets = _ticket_buffer(dev, stream, bh)
    err = _build.library().repro_decode_attention_int8kv(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), tickets.data_ptr(), bh, g, d,
        s, n_host, chunk, run, splits, pos_ptr, float(softmax_scale),
        dev.index, stream)
    _build.check(err, "repro_decode_attention_int8kv")
    count_launch(decode_attention_int8kv)
    return out


decode_attention_int8kv.launches = 0
