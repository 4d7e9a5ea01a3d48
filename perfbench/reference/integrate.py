"""Plain velocity Verlet, the reference for an MD segment: from (r, v),
with the forces worked out at r first, ``steps`` steps of

    v' = v + dt/2 F(r) / m,  r' = r + dt v',  v'' = v' + dt/2 F(r') / m

in eV, Angstrom, amu and fs (``molecules.FS`` converts); padded atoms
(mask False) never move."""
from __future__ import annotations

from typing import Callable

import torch

from perfbench.reference.molecules import FS

__all__ = ["verlet"]


def verlet(forces: Callable[[torch.Tensor], torch.Tensor],
           coords: torch.Tensor, veloc: torch.Tensor, masses: torch.Tensor,
           mask: torch.Tensor, dt_fs: float, steps: int):
    """(coords, veloc) after ``steps`` steps. coords, veloc (B, n, 3);
    masses, mask (B, n)."""
    dt = dt_fs * FS
    inv_m = torch.where(mask, 1.0 / masses.clamp_min(1e-9),
                        torch.zeros_like(masses))[..., None]
    f = forces(coords)
    r, v = coords, veloc
    for _ in range(steps):
        v = v + 0.5 * dt * f * inv_m
        r = r + dt * v
        f = forces(r)
        v = v + 0.5 * dt * f * inv_m
    return r, v
