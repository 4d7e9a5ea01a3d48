"""Local Equivariance Error (LEE), paper Eq. 1: counterpart of
``repro/core/lee.py``, the metric and the regularizer.

LEE(f; G, R) = || f(rho_in(R) . G) - rho_out(R) f(G) ||_2

For force-field models rho_in rotates atom coordinates and rho_out the
predicted per-atom forces. Rotations are drawn with numpy in float32,
as the JAX package draws its own in float32: a caller holding the JAX
package's rotations passes them as numpy arrays and both packages rotate
the same float32 coordinates by the same float32 matrices. The
regularizer is differentiable (second order through a force model's
``create_graph`` gradient).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

__all__ = ["rotation_from_quaternion", "random_rotation", "random_rotations",
           "lee", "lee_regularizer"]

Seed = Union[int, np.random.Generator]


def rotation_from_quaternion(q: np.ndarray) -> np.ndarray:
    """(..., 4) quaternions (w, x, y, z), normalized here -> (..., 3, 3)
    rotations, in q's float type (the JAX package's matrix, entry for
    entry)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = (q[..., i] for i in range(4))
    one = np.ones_like(w)
    return np.stack([
        np.stack([one - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), one - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  one - 2 * (x * x + y * y)], -1)], axis=-2)


def random_rotations(seed: Seed, n: int) -> np.ndarray:
    """n uniform (Haar) rotations from normalized Gaussian quaternions
    drawn with numpy's ``default_rng(seed)`` (a seed, or a Generator that
    is drawn from in place): (n, 3, 3) float32."""
    q = np.random.default_rng(seed).standard_normal((n, 4))
    return rotation_from_quaternion(q.astype(np.float32))


def random_rotation(seed: Seed) -> np.ndarray:
    """One uniform (Haar) rotation: (3, 3) float32."""
    return random_rotations(seed, 1)[0]


def lee(force_fn: Callable[[torch.Tensor], torch.Tensor],
        coords: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """LEE of a force model. coords: (n_atoms, 3); rot: (3, 3), on one
    device; ``force_fn`` maps coordinates to per-atom forces (n_atoms,
    3), with species and the rest closed over."""
    f_rot_in = force_fn(coords @ rot.T)           # f(R . G)
    rot_f = force_fn(coords) @ rot.T              # rho(R) f(G)
    return torch.linalg.norm(f_rot_in - rot_f)


def lee_regularizer(force_fn: Callable[[torch.Tensor], torch.Tensor],
                    coords: torch.Tensor, seed: Optional[Seed] = None,
                    n_rotations: int = 1,
                    rotations=None) -> torch.Tensor:
    """E_R[LEE] over ``n_rotations`` rotations drawn from ``seed`` (a seed
    or a numpy Generator), or over ``rotations`` (k, 3, 3), an array or
    a tensor, as given (e.g. the JAX package's), taken in ``coords``'
    dtype; differentiable. Each rotation runs the force model twice, on
    the rotated and on the given coordinates."""
    if rotations is None:
        rotations = random_rotations(seed, n_rotations)
    if not isinstance(rotations, torch.Tensor):
        rotations = np.array(rotations, np.float32)
    rots = torch.as_tensor(rotations, dtype=coords.dtype,
                           device=coords.device)
    return torch.stack([lee(force_fn, coords, r) for r in rots]).mean()
