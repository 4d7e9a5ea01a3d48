"""Fused dequantize-matmul for W8A8 and W4A8: kernel wrappers.

Replaces the Pallas TPU kernels ``w8a8_matmul`` and ``w4a8_matmul`` of
``repro/kernels/quant_matmul.py``. On a CUDA tensor each wrapper launches
its kernel from ``csrc/quant_matmul.cu`` or raises; on a CPU tensor it
runs the plain version from ``kernels/ref.py``. The kernel matches the
plain version bit for bit.

Two pairs of entries share the kernel:

* :func:`w8a8_matmul` / :func:`w4a8_matmul` take int8 activations and
  their row scales, the TPU kernels' contract;
* :func:`w8a8_matmul_f32a` / :func:`w4a8_matmul_f32a` take float32
  activations and quantize each row in the block before the product (the
  act-quant kernel's arithmetic, ``csrc/act_quant.cuh``), so the A8 step
  and the product are one launch. ``ops.matmul_w8a8``/``matmul_w4a8``, the
  serving path's entries, call these.

The kernel runs ``mma.sync`` m16n8k32 on the int8 tensor cores (exact
int32 sums) over 16x64 output tiles, one block of 4 warps each. The K of a
tile is staged once, zero-padded to a multiple of 32; the weight tile is
transposed while it is staged, 4 k-rows x 4 columns per thread with a
byte permute, and W4 nibbles are sign-extended in the same step.
:func:`staging_model` and :func:`mma_model` repeat, in numpy, what the
kernel stages, which shared-memory banks its lanes touch and how its
fragments feed the tensor cores, so the CPU tests hold the layout the
card cannot show.

What bounds it on the H100: at the serving shapes (M = 256, K <= 80,
N <= 192) the bytes moved, dominated by the float32 output, not the
integer work; the kernel masks ragged M, N and K itself, so callers pass
unpadded operands (the TPU wrapper's 128-padding is a TPU contract and is
not copied).

``<wrapper>.launches`` counts kernel launches of each entry (CPU calls
do not count).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_tensor, count_launch, stream_of
from repro_torch.kernels.ref import (act_quant_ref, w4a8_matmul_ref,
                                     w8a8_matmul_ref)

__all__ = ["w8a8_matmul", "w4a8_matmul", "w8a8_matmul_f32a",
           "w4a8_matmul_f32a", "staging_model", "mma_model"]

# csrc/quant_matmul.cu's tiling
BM, BN, WARPS = 16, 64, 4
KC = 128             # K bytes staged per step
SW = KC // 4 + 4     # shared row stride in 32-bit words


def _launch(entry: str, acts, w, w_scale, n: int) -> torch.Tensor:
    """Launch ``entry`` on the activation tensors ``acts`` (``(a_q,
    a_scale)`` or ``(x,)``, checked by the caller), the weight and its
    column scales; returns the (M, N) f32 output."""
    m, k = acts[0].shape
    dev = acts[0].device
    check_tensor("w_scale", w_scale, torch.float32, (1, n), dev)
    if w.device != dev or not w.is_contiguous() or w.shape[0] != k:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device} does not "
                         f"fit activations with K={k} on {dev}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = getattr(_build.library(), entry)(
        *(t.data_ptr() for t in acts), w.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), m, n, k, dev.index, stream_of(dev))
    _build.check(err, entry)
    return out


def _check_int8_acts(a_q, a_scale) -> None:
    m, k = a_q.shape
    check_tensor("a_q", a_q, torch.int8, (m, k), a_q.device)
    check_tensor("a_scale", a_scale, torch.float32, (m, 1), a_q.device)


def _weight_dtype(name: str, w, dtype) -> None:
    if w.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {w.dtype}")


def w8a8_matmul(a_q: torch.Tensor, a_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """out[m, n] = (sum_k a_q[m, k] * w_q[k, n]) * a_scale[m] * w_scale[n].

    a_q (M, K) int8, a_scale (M, 1) f32, w_q (K, N) int8, w_scale (1, N)
    f32 -> (M, N) f32.
    """
    if not a_q.is_cuda:
        return w8a8_matmul_ref(a_q, a_scale, w_q, w_scale)
    _weight_dtype("w_q", w_q, torch.int8)
    _check_int8_acts(a_q, a_scale)
    out = _launch("repro_qmm_w8a8", (a_q, a_scale), w_q, w_scale,
                  w_q.shape[1])
    count_launch(w8a8_matmul)
    return out


def w4a8_matmul(a_q: torch.Tensor, a_scale: torch.Tensor,
                w_packed: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """W4A8 variant: ``w_packed`` (K, N/2) uint8 holds two signed nibbles
    per byte along N, low nibble first (``core.quantizers.pack_int4``)."""
    if not a_q.is_cuda:
        return w4a8_matmul_ref(a_q, a_scale, w_packed, w_scale)
    _weight_dtype("w_packed", w_packed, torch.uint8)
    _check_int8_acts(a_q, a_scale)
    out = _launch("repro_qmm_w4a8", (a_q, a_scale), w_packed, w_scale,
                  w_packed.shape[1] * 2)
    count_launch(w4a8_matmul)
    return out


def w8a8_matmul_f32a(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    """:func:`w8a8_matmul` of ``act_quant(x)``, in one launch: x (M, K) f32,
    each row quantized to int8 codes under ``max(max|x|, 1e-8) / 127``."""
    if not x.is_cuda:
        return w8a8_matmul_ref(*act_quant_ref(x), w_q, w_scale)
    _weight_dtype("w_q", w_q, torch.int8)
    check_tensor("x", x, torch.float32, tuple(x.shape), x.device)
    out = _launch("repro_qmm_w8a8_f32a", (x,), w_q, w_scale, w_q.shape[1])
    count_launch(w8a8_matmul_f32a)
    return out


def w4a8_matmul_f32a(x: torch.Tensor, w_packed: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    """:func:`w4a8_matmul` of ``act_quant(x)``, in one launch."""
    if not x.is_cuda:
        return w4a8_matmul_ref(*act_quant_ref(x), w_packed, w_scale)
    _weight_dtype("w_packed", w_packed, torch.uint8)
    check_tensor("x", x, torch.float32, tuple(x.shape), x.device)
    out = _launch("repro_qmm_w4a8_f32a", (x,), w_packed, w_scale,
                  w_packed.shape[1] * 2)
    count_launch(w4a8_matmul_f32a)
    return out


w8a8_matmul.launches = 0
w4a8_matmul.launches = 0
w8a8_matmul_f32a.launches = 0
w4a8_matmul_f32a.launches = 0


# --- the kernel's staging and fragments, in numpy ----------------------------

def _byte_perm(x, y, sel: int):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
           [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= pool[(sel >> (4 * i)) & 0x7] << (8 * i)
    return out


def _transpose4(r):
    """csrc ``transpose4``: word j of the result holds byte j of r[0..3]."""
    t0 = _byte_perm(r[0], r[1], 0x5140)
    t1 = _byte_perm(r[0], r[1], 0x7362)
    t2 = _byte_perm(r[2], r[3], 0x5140)
    t3 = _byte_perm(r[2], r[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _sext_nibbles(p):
    """csrc ``sext_nibbles``: four nibbles of p, sign-extended to bytes
    (``__vsub4(x ^ 0x08080808, 0x08080808)``, bytewise without borrow)."""
    x = (p & 0xF) | ((p & 0xF0) << 4) | ((p & 0xF00) << 8) \
        | ((p & 0xF000) << 12)
    x ^= 0x08080808
    out = np.zeros_like(x)
    for i in range(4):
        out |= (((x >> (8 * i)) & 0xFF) - 8) % 256 << (8 * i)
    return out


def _bytes_at(mat, rows, cols):
    """mat[rows, cols] as uint32 (0 outside mat)."""
    ok = (rows < mat.shape[0]) & (cols < mat.shape[1])
    out = np.zeros(rows.shape, np.uint32)
    out[ok] = mat[rows[ok], cols[ok]]
    return out


def _banks_distinct(addr) -> bool:
    """One warp's 32-bit shared accesses (lanes along the last axis) hit
    32 distinct banks, or the same word."""
    for a in addr.reshape(-1, addr.shape[-1]):
        banks = {}
        for word in a.tolist():
            banks.setdefault(word % 32, set()).add(word)
        if any(len(v) > 1 for v in banks.values()):
            return False
    return True


def staging_model(a_q: np.ndarray, w: np.ndarray, n: int, w4: bool,
                  m0: int, n0: int, k0: int):
    """What one block of ``qmm_kernel`` stages for the K step at ``k0``.

    a_q (M, K) int8; w (K, N) int8 or, for W4, (K, N/2) uint8 packed
    nibbles; ``n`` = N. Returns (As (BM, SW) uint32, Ws (BN, SW) uint32,
    kp, conflict_free): the shared tiles as the kernel writes them (words
    of four k-consecutive bytes, row m of A, column n of W, K zero-padded
    to ``kp``, a multiple of 32), and whether every shared store of the
    step and every fragment read of the product hits distinct banks.
    """
    m, k = a_q.shape
    kp = min(KC, (k - k0 + 31) // 32 * 32)
    a8 = a_q.view(np.uint8)
    lane = np.arange(32)

    # A: 16-byte chunks, row fastest (one row per lane of an 8-lane phase)
    As = np.zeros((BM, SW), np.uint32)
    units = np.arange(BM * (kp // 16))
    row, ch = units % BM, units // BM
    for i in range(16):
        b = _bytes_at(a8, m0 + row, np.where(k0 + 16 * ch + i < k,
                                             k0 + 16 * ch + i, k))
        As[row, 4 * ch + i // 4] |= b << (8 * (i % 4))
    # 16-byte stores: an 8-lane phase must cover 8 distinct 16-byte groups
    groups = (row * SW + 4 * ch) // 4
    pad = (-len(groups)) % 8
    phases = np.concatenate([groups, groups[:1].repeat(pad)]).reshape(-1, 8)
    ok = all(len({int(x) % 8 for x in ph}) == len(set(ph.tolist()))
             for ph in phases)

    # W: 4 k-rows x 4 columns per lane, transposed with byte permutes
    Ws = np.zeros((BN, SW), np.uint32)
    w_bytes = w.view(np.uint8)
    stores = []
    for u in range(4 * (kp // 32)):
        nq = 4 * (u & 3) + (lane >> 3)
        kq = 8 * (u >> 2) + (lane & 7)
        gn = n0 + 4 * nq
        rows = []
        for i in range(4):
            gk = k0 + 4 * kq + i
            live = (gk < k) & (gn < n)
            if w4:
                p = _bytes_at(w_bytes, gk, gn // 2)
                p |= np.where(gn + 2 < n, _bytes_at(w_bytes, gk, gn // 2 + 1),
                              0).astype(np.uint32) << 8
                word = _sext_nibbles(p)
            else:
                word = np.zeros(32, np.uint32)
                for c in range(4):
                    word |= np.where(gn + c < n, _bytes_at(w_bytes, gk, gn + c),
                                     0).astype(np.uint32) << (8 * c)
            rows.append(np.where(live, word, 0).astype(np.uint32))
        cols = _transpose4(rows)
        h = lane >> 4
        for s in range(4):
            r = 4 * nq + ((s + 2 * h) & 3)
            Ws[r, kq] = np.where(h == 1, cols[(s + 2) & 3], cols[s])
            stores.append(r * SW + kq)
    ok &= _banks_distinct(np.array(stores))
    # fragment reads: lane (g, t) reads row g (and g + 8), word 8 ks + t (+4)
    g, t = lane >> 2, lane & 3
    reads = [r * SW + 8 * ks + t + d for ks in range(kp // 32)
             for r in (g, g + 8) for d in (0, 4)]
    return As, Ws, kp, ok and _banks_distinct(np.array(reads))


def _bytes_of(words):
    """(..., ) uint32 -> (..., 4) int8, low byte first."""
    return ((words[..., None] >> (8 * np.arange(4))) & 0xFF) \
        .astype(np.uint8).view(np.int8)


def _mma_m16n8k32(a_regs, b_regs):
    """``mma.sync.m16n8k32.row.col.s32.s8.s8.s32`` on 32 lanes' registers,
    by the PTX fragment layouts: lane (g, t) holds A rows g and g + 8 at
    k = 4t..4t+3 (regs 0, 1) and 16 + 4t.. (regs 2, 3), B column g at the
    same k (regs 0, 1), and returns D[g, 2t..2t+1], D[g + 8, 2t..2t+1]."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    kk = 4 * t[:, None] + np.arange(4)
    A[g[:, None], kk] = _bytes_of(a_regs[:, 0])
    A[g[:, None] + 8, kk] = _bytes_of(a_regs[:, 1])
    A[g[:, None], kk + 16] = _bytes_of(a_regs[:, 2])
    A[g[:, None] + 8, kk + 16] = _bytes_of(a_regs[:, 3])
    B[kk, g[:, None]] = _bytes_of(b_regs[:, 0])
    B[kk + 16, g[:, None]] = _bytes_of(b_regs[:, 1])
    D = A @ B
    return np.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                     D[g + 8, 2 * t + 1]], axis=1)


def mma_model(a_q: np.ndarray, a_scale: np.ndarray, w: np.ndarray,
              w_scale: np.ndarray, w4: bool):
    """``qmm_kernel``'s result, block by block in numpy: the staged tiles
    of :func:`staging_model`, each warp's fragments fed to the tensor-core
    product by their PTX layouts, and the epilogue's float32 order.
    Returns (out (M, N) f32, conflict_free over every block and step)."""
    m, k = a_q.shape
    n = w.shape[1] * (2 if w4 else 1)
    out = np.zeros((m, n), np.float32)
    a_s = a_scale.reshape(-1).astype(np.float32)
    w_s = w_scale.reshape(-1).astype(np.float32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    ok = True
    for m0 in range(0, m, BM):
        for n0 in range(0, n, BN):
            acc = np.zeros((WARPS, 2, 32, 4), np.int64)
            for k0 in range(0, k, KC):
                As, Ws, kp, fine = staging_model(a_q, w, n, w4, m0, n0, k0)
                ok &= fine
                for ks in range(kp // 32):
                    kw = 8 * ks + t
                    a = np.stack([As[g, kw], As[g + 8, kw], As[g, kw + 4],
                                  As[g + 8, kw + 4]], axis=1)
                    for wp in range(WARPS):
                        for f in range(2):
                            col = 16 * wp + 8 * f + g
                            b = np.stack([Ws[col, kw], Ws[col, kw + 4]],
                                         axis=1)
                            acc[wp, f] += _mma_m16n8k32(a, b)
            for wp in range(WARPS):
                for f in range(2):
                    for i in range(4):
                        rows = m0 + g + 8 * (i // 2)
                        cols = n0 + 16 * wp + 8 * f + 2 * t + i % 2
                        live = (rows < m) & (cols < n)
                        r, c = rows[live], cols[live]
                        v = acc[wp, f, live, i].astype(np.int32) \
                            .astype(np.float32)
                        out[r, c] = (v * a_s[r]) * w_s[c]
    return out, ok
