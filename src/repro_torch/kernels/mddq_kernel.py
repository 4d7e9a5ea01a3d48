"""MDDQ encode (nearest spherical codeword + log-magnitude code): wrapper.

Replaces the Pallas TPU kernel ``mddq_encode_kernel`` of
``repro/kernels/mddq_kernel.py``. On a CUDA tensor
:func:`mddq_encode_kernel` launches ``csrc/mddq_encode.cu`` or raises; on
a CPU tensor it runs ``kernels.ref.mddq_encode_ref``.

Formula (every version): ``u = v / max(|v|, 1e-12)`` by division, scores
``(ux*cx + uy*cy) + uz*cz`` with every operation rounded on its own, the
first maximizing index, and the log-magnitude code rounded half to even.
The kernels therefore agree exactly with the plain version.

Which kernel runs depends on the codebook. A codebook whose z column
strictly decreases with the index, which ``core.codebook.make_codebook``
checks once when it builds one and records as ``codebook.z_sorted``,
takes the band search: one launch, one warp per vector, scoring only a
seed window around the vector's Fibonacci index and, where the seed
cannot certify its answer, the z-band that holds every codeword scoring
as well as the seed's best (``csrc/mddq_encode.cu`` derives the band).
Every codebook the port builds takes it. Any other codebook takes the
full search: one thread per vector over the whole codebook in
shared-memory tiles, split across blocks, and a second kernel that
combines the splits in order.

What bounds it on the H100: the full search, FP32 operations (5 per
vector-codeword pair; the fixed rounding order keeps it off the tensor
cores); the band search, which scores ~1,000 codewords per nonzero
vector, its L2 reads of the seed windows and each warp's chain of them.

``mddq_encode_kernel.launches`` counts calls that launched a kernel (one
per call, either search); ``mddq_encode_kernel.full_launches`` counts the
calls among them that took the full search. :func:`band_search_model`
repeats the band search's decisions in plain PyTorch, for the tests and
for counting the work the band search needs.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.core.quantizers import f32, log_magnitude_bounds
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_tensor, count_launch, stream_of
from repro_torch.kernels.ref import _norm3, mddq_encode_ref

__all__ = ["mddq_encode_kernel", "seed_half_width", "z_band",
           "band_search_model", "probe_vectors"]

_THREADS = 256     # vectors per block of the full search (csrc THREADS)
_TILE = 2048       # codewords per shared-memory tile (csrc TILE)
_TARGET_BLOCKS = 2 * 132   # two blocks per H100 SM
_ETA = 1e-5        # slack of the band's half-width squared (csrc ETA)


def _n_splits(n_vectors: int, n_codes: int) -> int:
    """How many codebook splits the full search runs: enough blocks to
    reach ~two per SM, but never a split smaller than one shared-memory
    tile."""
    blocks = max(1, math.ceil(n_vectors / _THREADS))
    return max(1, min(math.ceil(n_codes / _TILE),
                      math.ceil(_TARGET_BLOCKS / blocks)))


def seed_half_width(n_codes: int) -> int:
    """K0: the band search first scores the codewords i0 +- K0."""
    return 2 * math.ceil(math.sqrt(n_codes))


def mddq_encode_kernel(v: torch.Tensor, codebook: torch.Tensor, *,
                       mag_bits: int = 8, m_min: float = 1e-6,
                       m_max: float = 1e3):
    """v: (N, 3) f32; codebook: (C, 3) f32 (any C). The kernels read the
    planar (3, C) layout, which ``codebook.T`` is without a copy for
    ``core.codebook.make_codebook``'s codebooks; those also carry
    ``z_sorted = True``, which selects the band search.

    Returns (idx int32 (N,), mag int32 (N,)).
    """
    if not v.is_cuda:
        return mddq_encode_ref(v, codebook, mag_bits, m_min, m_max)
    n, c = v.shape[0], codebook.shape[0]
    dev = v.device
    codebook_t = codebook.T.contiguous()
    check_tensor("v", v, torch.float32, (n, 3), dev)
    check_tensor("codebook_t", codebook_t, torch.float32, (3, c), dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    mag = torch.empty((n,), dtype=torch.int32, device=dev)
    lo, hi = log_magnitude_bounds(m_min, m_max)
    levels = 2 ** mag_bits - 1
    if getattr(codebook, "z_sorted", False):
        err = _build.library().repro_mddq_encode_band(
            v.data_ptr(), codebook_t.data_ptr(), idx.data_ptr(),
            mag.data_ptr(), n, c, seed_half_width(c), levels, f32(m_min),
            f32(m_max), lo, f32(hi - lo), dev.index, stream_of(dev))
        _build.check(err, "repro_mddq_encode_band")
    else:
        splits = _n_splits(n, c)
        part_score = torch.empty((splits, n), dtype=torch.float32,
                                 device=dev)
        part_idx = torch.empty((splits, n), dtype=torch.int32, device=dev)
        err = _build.library().repro_mddq_encode(
            v.data_ptr(), codebook_t.data_ptr(), idx.data_ptr(),
            mag.data_ptr(), part_score.data_ptr(), part_idx.data_ptr(), n, c,
            splits, levels, f32(m_min), f32(m_max), lo, f32(hi - lo),
            dev.index, stream_of(dev))
        _build.check(err, "repro_mddq_encode")
        count_launch(mddq_encode_kernel, "full_launches")
    count_launch(mddq_encode_kernel)
    return idx, mag


mddq_encode_kernel.launches = 0
mddq_encode_kernel.full_launches = 0


# --- the band search in plain PyTorch -------------------------------------------

def _scores(u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(ux*cx + uy*cy) + uz*cz for u (N, 3) against c (N, K, 3)."""
    return (u[:, None, 0] * c[..., 0] + u[:, None, 1] * c[..., 1]) \
        + u[:, None, 2] * c[..., 2]


def _direction(u: torch.Tensor):
    """(|u|, the z of u / |u|, e): taken from u * 2^-e, which holds u's
    largest component in [0.5, 1) exactly, so no square underflows."""
    _, e = torch.frexp(u.abs().amax(-1))
    w = torch.ldexp(u, -e[:, None].to(u.dtype))
    r = torch.sqrt((w[:, 0] * w[:, 0] + w[:, 1] * w[:, 1]) + w[:, 2] * w[:, 2])
    return r, w[:, 2] / r, e


def _band_limits(u: torch.Tensor, s: torch.Tensor):
    """(hz - delta, hz + delta), delta^2 = 2 - 2 s / |u| + ETA, in float32
    and in the kernel's order of operations."""
    r, hz, e = _direction(u)
    t = torch.ldexp(s, -e.to(s.dtype)) / r
    delta = torch.sqrt(torch.clamp((2 - 2 * t) + _ETA, min=0))
    return hz - delta, hz + delta


def z_band(u: torch.Tensor, z: torch.Tensor, s: torch.Tensor):
    """Index range [lo, hi] of the codewords whose z lies within delta of
    the z of u / |u|: every codeword that scores s or more against u lies
    in it. u: (N, 3), nonzero rows; z: (C,) strictly decreasing; s: (N,)."""
    lo_t, hi_t = _band_limits(u, s)
    lo = torch.searchsorted(-z, -hi_t, side="left")
    hi = torch.searchsorted(-z, -lo_t, side="right") - 1
    return lo, hi


def band_search_model(v: torch.Tensor, codebook: torch.Tensor):
    """The band kernel's search in plain PyTorch: zero vectors, the seed
    window, the certificate and the rescan of the band, with the kernel's
    float32 arithmetic. v: (N, 3); codebook (C, 3) with a strictly
    decreasing z column. Returns (idx int32 (N,), scored int64 (N,): the
    codewords the kernel scores for each vector, certified bool (N,))."""
    C = codebook.shape[0]
    k0 = seed_half_width(C)
    z = codebook[:, 2]
    u = v / torch.clamp(_norm3(v), min=1e-12)[:, None]
    zero = (u == 0).all(-1)
    _, hz, _ = _direction(u)
    i0 = torch.round((1 - hz) * (0.5 * C) - 0.5)
    # fmaxf(NaN, 0) is 0 in the kernel; torch.clamp would keep the NaN
    i0 = torch.clamp(torch.nan_to_num(i0, nan=0.0), 0, C - 1).to(torch.int64)
    a = torch.clamp(i0 - k0, min=0)
    b = torch.clamp(i0 + k0, max=C - 1)
    ids = i0[:, None] - k0 + torch.arange(2 * k0 + 1, device=v.device)
    inside = (ids >= 0) & (ids < C)
    s = _scores(u, codebook[ids.clamp(0, C - 1)])
    # outside the window, and NaN (which never beats -2), score below -2
    s = torch.where(inside & ~torch.isnan(s), s, torch.full_like(s, -3.0))
    j = torch.argmax(s, dim=1)                 # the first maximizing index
    best = s.gather(1, j[:, None])[:, 0]
    idx = ids.gather(1, j[:, None])[:, 0]
    searched = ~zero & (best > -2)
    lo_t, hi_t = _band_limits(u, best)
    certified = (((a == 0) | (z[(a - 1).clamp(min=0)] > hi_t))
                 & ((b == C - 1) | (z[(b + 1).clamp(max=C - 1)] < lo_t)))
    lo, hi = z_band(u, z, best)
    scored = torch.where(searched, b - a + 1, torch.zeros_like(a))
    for n in torch.nonzero(searched & ~certified).flatten().tolist():
        l, h = int(lo[n]), int(hi[n])
        sn = _scores(u[n:n + 1], codebook[None, l:h + 1])[0]
        idx[n] = l + int(torch.argmax(sn))
        scored[n] += h - l + 1
    idx = torch.where(searched, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), scored, certified | ~searched


def probe_vectors(codebook: torch.Tensor, seed: int = 0,
                  n: int = 64) -> Dict[str, torch.Tensor]:
    """Inputs that probe an exact codebook search, by kind, each (k, 3)
    float32 on the codebook's device, made from numpy ``seed``: Gaussian
    vectors of spread magnitudes, exact codewords, the poles, the
    equator, the normalised midpoints of index neighbours and of spatial
    neighbours (near ties: two codewords score within an ulp or two),
    zero vectors and vectors shorter than 1e-12. ``n`` sets the count of
    each kind."""
    rng = np.random.default_rng(seed)
    cb = codebook.detach().cpu().numpy().astype(np.float64)
    C = cb.shape[0]

    def midpoints(a, b):
        m = cb[a] + cb[b]
        return m / np.linalg.norm(m, axis=-1, keepdims=True)
    i = rng.integers(0, C - 1, n)
    near = rng.integers(0, C, max(1, n // 4))
    dots = cb[near] @ cb.T
    dots[np.arange(near.size), near] = -np.inf
    nbrs = np.argsort(-dots, axis=1)[:, :4]
    theta = rng.uniform(0, 2 * np.pi, n)
    cases = {
        "gaussian": rng.normal(size=(n, 3))
        * np.exp(2 * rng.normal(size=(n, 1))),
        "codewords": cb[rng.integers(0, C, n)]
        * np.exp(rng.normal(size=(n, 1))),
        "poles": np.array([[0, 0, 1], [0, 0, -1], [0, 0, 7.5],
                           [0, 0, -1e-3]]),
        "equator": np.stack([np.cos(theta), np.sin(theta),
                             np.zeros(n)], -1),
        "index_midpoints": midpoints(i, i + 1),
        "spiral_midpoints": midpoints(np.repeat(near, 4), nbrs.ravel()),
        "zero": np.zeros((max(1, n // 8), 3)),
        "tiny": rng.normal(size=(max(1, n // 8), 3)) * 1e-14,
    }
    return {k: torch.from_numpy(v.astype(np.float32)).to(codebook.device)
            for k, v in cases.items()}
