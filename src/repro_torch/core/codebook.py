"""Spherical codebooks for the direction quantizer Q_d : S^2 -> C.

Counterpart of ``repro/core/codebook.py``. ``fibonacci_sphere`` is the
same numpy construction (copied, so the codebook is bit-identical to the
JAX package's, which MDDQ argmax parity depends on). ``nearest_code``
runs the MDDQ encode kernel (K4) on CUDA tensors and the chunked plain
search on CPU tensors. Codebooks are stored planar, (3, C), the encode
kernel's layout, and handed out as their (C, 3) transpose, so the kernel
takes them without a copy. ``make_codebook`` also checks once, in numpy,
whether the z column strictly decreases with the index (it does for
every Fibonacci codebook) and records it as ``codebook.z_sorted``, which
sends the encode to the band search.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
from repro_torch.kernels.ref import nearest_code_ref

__all__ = ["fibonacci_sphere", "is_z_sorted", "make_codebook",
           "nearest_code"]


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


def is_z_sorted(points: np.ndarray) -> bool:
    """Whether the z column of a (C, 3) codebook strictly decreases with
    the index, the property the band search of the encode kernel needs."""
    return bool(np.all(np.diff(points[:, 2]) < 0))


@functools.lru_cache(maxsize=None)
def _codebook(bits: int, kind: str, device: str) -> torch.Tensor:
    if kind != "fibonacci":
        raise ValueError(f"unknown or unported codebook kind {kind!r}")
    points = fibonacci_sphere(2 ** bits)
    cb = torch.from_numpy(np.ascontiguousarray(points.T)).to(device).T
    cb.z_sorted = is_z_sorted(points)
    return cb


def make_codebook(bits: int = 8, kind: str = "fibonacci",
                  device="cpu") -> torch.Tensor:
    """(2**bits, 3) float32 codebook on ``device``, cached per (bits,
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
