"""Spherical codebooks for the direction quantizer Q_d : S^2 -> C.

Counterpart of ``repro/core/codebook.py``. ``fibonacci_sphere`` is the
same numpy construction (copied, so the codebook is bit-identical to the
JAX package's, which MDDQ argmax parity depends on), and so is
``octahedral_sphere``, a codebook closed under the 24 rotations of the
octahedral group. ``nearest_code``
runs the MDDQ encode kernel (K4) on CUDA tensors and the chunked plain
search on CPU tensors. Codebooks are stored planar, (3, C), the encode
kernel's layout, and handed out as their (C, 3) transpose, so the kernel
takes them without a copy. ``make_codebook`` also checks once, in numpy,
whether the z column strictly decreases with the index (it does for
every Fibonacci codebook) and records it as ``codebook.z_sorted``, which
sends the encode to the band search; an octahedral codebook is not
sorted by z, so on the card it takes the encode kernel's full search.
"""
from __future__ import annotations

import functools
import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
from repro_torch.kernels.ref import nearest_code_ref

__all__ = ["fibonacci_sphere", "octahedral_sphere", "is_z_sorted",
           "make_codebook", "nearest_code", "quantize_direction",
           "covering_radius"]


def fibonacci_sphere(n: int) -> np.ndarray:
    """n near-uniform points on S^2 via the Fibonacci lattice. (n, 3) float32."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)           # polar angle
    golden = np.pi * (1.0 + 5.0 ** 0.5)           # golden angle * 2
    theta = golden * i
    x = np.sin(phi) * np.cos(theta)
    y = np.sin(phi) * np.sin(theta)
    z = np.cos(phi)
    pts = np.stack([x, y, z], axis=-1)
    return (pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)


def octahedral_sphere(n: int) -> np.ndarray:
    """Codebook closed under the octahedral rotation subgroup: a Fibonacci
    seed restricted to one fundamental domain, replicated by the 24
    rotations of the cube/octahedron group and deduplicated. Size <= n.
    (k, 3) float32."""
    group = _octahedral_rotations()
    seed_n = max(1, n // 24)
    seed = fibonacci_sphere(seed_n * 4)  # oversample, keep fundamental domain
    # fundamental domain of the octahedral group: x >= y >= z >= 0 (approx)
    mask = (seed[:, 0] >= seed[:, 1]) & (seed[:, 1] >= seed[:, 2]) \
        & (seed[:, 2] >= 0)
    seed = seed[mask][:seed_n]
    if len(seed) == 0:
        seed = np.array([[1.0, 0.0, 0.0]], dtype=np.float32)
    orbit = np.einsum("gij,nj->gni", group, seed).reshape(-1, 3)
    # dedup points that coincide (a seed on a symmetry axis has a small orbit)
    rounded = np.round(orbit * 1e5).astype(np.int64)
    _, idx = np.unique(rounded, axis=0, return_index=True)
    pts = orbit[np.sort(idx)]
    return (pts / np.linalg.norm(pts, axis=-1, keepdims=True)) \
        .astype(np.float32)


def _octahedral_rotations() -> np.ndarray:
    """The 24 rotation matrices of the octahedral group (signed
    permutations with determinant +1). (24, 3, 3) float32."""
    mats = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product([1, -1], repeat=3):
            m = np.zeros((3, 3))
            for r, c in enumerate(perm):
                m[r, c] = signs[r]
            if np.isclose(np.linalg.det(m), 1.0):
                mats.append(m)
    out = np.stack(mats).astype(np.float32)
    assert out.shape[0] == 24
    return out


def is_z_sorted(points: np.ndarray) -> bool:
    """Whether the z column of a (C, 3) codebook strictly decreases with
    the index, the property the band search of the encode kernel needs."""
    return bool(np.all(np.diff(points[:, 2]) < 0))


@functools.lru_cache(maxsize=None)
def _codebook(bits: int, kind: str, device: str) -> torch.Tensor:
    if kind == "fibonacci":
        points = fibonacci_sphere(2 ** bits)
    elif kind == "octahedral":
        points = octahedral_sphere(2 ** bits)
    else:
        raise ValueError(f"unknown codebook kind {kind!r}")
    cb = torch.from_numpy(np.ascontiguousarray(points.T)).to(device).T
    cb.z_sorted = is_z_sorted(points)
    return cb


def make_codebook(bits: int = 8, kind: str = "fibonacci",
                  device="cpu") -> torch.Tensor:
    """(2**bits, 3) float32 codebook on ``device`` (``"octahedral"``: the
    closest size the group's orbits allow), cached per (bits,
    kind, device): a 16-bit codebook is 65,536 trig evaluations on the
    host that should run once. The result is the transpose view of a
    contiguous (3, C) tensor, with ``z_sorted`` set. Callers must not
    modify it."""
    return _codebook(bits, kind, str(torch.device(device)))


def nearest_code(u: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the max-cosine codeword for each direction (first index on
    ties). u: (..., 3); codebook: (C, 3) -> int32 (...,).

    On CUDA this is the encode kernel, which normalizes its input by
    division; for unit-length ``u`` that is the identity except within an
    ulp of a tie.
    """
    flat = u.reshape(-1, 3)
    if flat.is_cuda:
        idx, _ = mddq_encode_kernel(flat.contiguous(), codebook)
    else:
        idx = nearest_code_ref(flat, codebook)
    return idx.reshape(u.shape[:-1])


def quantize_direction(u: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Q_d: snap unit vectors to their nearest codeword. Shape-preserving."""
    return codebook[nearest_code(u, codebook)]


def covering_radius(codebook: torch.Tensor, n_samples: int = 200_000,
                    seed: int = 0,
                    samples: Optional[np.ndarray] = None) -> float:
    """Monte-Carlo estimate of delta_d = sup_u min_c angle(u, c) (radians)
    over ``n_samples`` Gaussian directions drawn with numpy from ``seed``,
    or over ``samples`` (k, 3) as given (e.g. the JAX package's draw).
    Scores are the plain ``u @ codebook.T`` product, as the JAX package
    takes them."""
    if samples is None:
        samples = np.random.default_rng(seed).standard_normal(
            (n_samples, 3)).astype(np.float32)
    v = torch.as_tensor(np.array(samples, np.float32),
                        device=codebook.device)
    u = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    best = torch.full((u.shape[0],), -2.0, device=u.device)
    for s in range(0, u.shape[0], 16_384):
        best[s:s + 16_384] = (u[s:s + 16_384] @ codebook.T).amax(-1)
    return float(torch.arccos(torch.clamp(best, -1.0, 1.0)).max())
