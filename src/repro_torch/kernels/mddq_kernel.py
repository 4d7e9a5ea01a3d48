"""MDDQ encode (nearest spherical codeword + log-magnitude code): wrapper.

Replaces the Pallas TPU kernel ``mddq_encode_kernel`` of
``repro/kernels/mddq_kernel.py``. On a CUDA tensor
:func:`mddq_encode_kernel` launches ``csrc/mddq_encode.cu`` or raises; on
a CPU tensor it runs ``kernels.ref.mddq_encode_ref``.

Formula (both versions): ``u = v / max(|v|, 1e-12)`` by division, scores
``(ux*cx + uy*cy) + uz*cz`` with every operation rounded on its own, the
first maximizing index, and the log-magnitude code rounded half to even.
The two versions therefore agree exactly.

The kernel gives one thread to each vector and streams the (3, C) planar
codebook through shared memory in 2048-codeword tiles; with few vectors
it also splits the codebook across blocks and combines the splits' bests
in order in a second small kernel (so the first index still wins).

What bounds it on the H100: FP32 operations (5 per vector-codeword pair
on the CUDA cores: the fixed rounding order keeps it off the tensor
cores); the bytes are 12 per vector and 12 per codeword.

``mddq_encode_kernel.launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quantizers import f32, log_magnitude_bounds
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_tensor, stream_of
from repro_torch.kernels.ref import mddq_encode_ref

__all__ = ["mddq_encode_kernel"]

_THREADS = 256     # vectors per block (csrc/mddq_encode.cu THREADS)
_TILE = 2048       # codewords per shared-memory tile (csrc TILE)
_TARGET_BLOCKS = 2 * 132   # two blocks per H100 SM


def _n_splits(n_vectors: int, n_codes: int) -> int:
    """How many codebook splits the search runs: enough blocks to reach
    ~two per SM, but never a split smaller than one shared-memory tile."""
    blocks = max(1, math.ceil(n_vectors / _THREADS))
    return max(1, min(math.ceil(n_codes / _TILE),
                      math.ceil(_TARGET_BLOCKS / blocks)))


def mddq_encode_kernel(v: torch.Tensor, codebook: torch.Tensor, *,
                       mag_bits: int = 8, m_min: float = 1e-6,
                       m_max: float = 1e3):
    """v: (N, 3) f32; codebook: (C, 3) f32 (any C). The kernel reads the
    planar (3, C) layout, which ``codebook.T`` is without a copy for
    ``core.codebook.make_codebook``'s codebooks.

    Returns (idx int32 (N,), mag int32 (N,)).
    """
    if not v.is_cuda:
        return mddq_encode_ref(v, codebook, mag_bits, m_min, m_max)
    n, c = v.shape[0], codebook.shape[0]
    dev = v.device
    codebook_t = codebook.T.contiguous()
    check_tensor("v", v, torch.float32, (n, 3), dev)
    check_tensor("codebook_t", codebook_t, torch.float32, (3, c), dev)
    splits = _n_splits(n, c)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    mag = torch.empty((n,), dtype=torch.int32, device=dev)
    part_score = torch.empty((splits, n), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=dev)
    lo, hi = log_magnitude_bounds(m_min, m_max)
    err = _build.library().repro_mddq_encode(
        v.data_ptr(), codebook_t.data_ptr(), idx.data_ptr(), mag.data_ptr(),
        part_score.data_ptr(), part_idx.data_ptr(), n, c, splits,
        2 ** mag_bits - 1, f32(m_min), f32(m_max), lo, f32(hi - lo),
        dev.index, stream_of(dev))
    _build.check(err, "repro_mddq_encode")
    mddq_encode_kernel.launches += 1
    return idx, mag


mddq_encode_kernel.launches = 0
