"""The molecules the cells run, and the classical force field that labels
the training frames.

Frozen copy of ``src/repro_torch/data/synthetic_md.py`` at commit
dde5d65 (``azobenzene_topology``, ``MASSES``, ``SPECIES_MAP`` and
``ClassicalFF.energy``): an azobenzene-like 24-atom molecule (C12 H10 N2,
rMD17's largest), its equilibrium geometry, bonds and angles, and a
harmonic bond + harmonic angle + Lennard-Jones force field. Kept here so
a later change to the program cannot change the yardstick.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["SPECIES_MAP", "MASSES", "FS", "KB", "azobenzene",
           "azobenzene_topology", "ClassicalFF"]

C, N, H = 6, 7, 1
SPECIES_MAP = {1: 0, 6: 1, 7: 2}            # element -> embedding row
MASSES = [12.011] * 12 + [14.007] * 2 + [1.008] * 10
FS = 1.0 / 10.180505      # 1 fs in sqrt(amu * A^2 / eV)
KB = 8.617333e-5          # eV / K


def azobenzene_topology():
    """Coordinates (24, 3), elements (24,), bonds [(i, j, r0, k)], angles
    [(i, j, k, th0, ka)]. Atom order: ring A carbons 0-5, ring B carbons
    6-11, N 12-13, H 14-23."""
    cc, ch, cn, nn = 1.39, 1.08, 1.43, 1.25
    coords = np.zeros((24, 3))
    for r, (cx, sign) in enumerate([(-2.85, -1), (2.85, 1)]):
        for i in range(6):
            ang = np.pi / 3 * i + (np.pi / 6 if sign > 0 else -np.pi / 6)
            coords[6 * r + i] = [cx + cc * np.cos(ang), cc * np.sin(ang), 0.0]
    coords[12] = [-0.95, 0.30, 0.0]
    coords[13] = [0.95, -0.30, 0.0]
    species = np.array([C] * 12 + [N] * 2 + [H] * 10)

    bonds: List[Tuple[int, int, float, float]] = []
    kb, kbh = 25.0, 28.0
    for r in range(2):
        for i in range(6):
            bonds.append((6 * r + i, 6 * r + (i + 1) % 6, cc, kb))
    ra = int(np.argmin(np.linalg.norm(coords[0:6] - coords[12], axis=1)))
    rb = int(np.argmin(np.linalg.norm(coords[6:12] - coords[13], axis=1))) + 6
    bonds.append((ra, 12, cn, kb))
    bonds.append((rb, 13, cn, kb))
    bonds.append((12, 13, nn, 35.0))
    h_idx = 14
    for r, ring in enumerate([range(0, 6), range(6, 12)]):
        center = coords[list(ring)].mean(0)
        for ci in ring:
            if ci in (ra, rb):
                continue
            direction = coords[ci] - center
            direction /= np.linalg.norm(direction)
            coords[h_idx] = coords[ci] + ch * direction
            bonds.append((ci, h_idx, ch, kbh))
            h_idx += 1
    assert h_idx == 24

    adj = {i: [] for i in range(24)}
    for i, j, *_ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    angles: List[Tuple[int, int, int, float, float]] = []
    for j in range(24):
        nb = adj[j]
        for a in range(len(nb)):
            for b in range(a + 1, len(nb)):
                i, k = nb[a], nb[b]
                v1 = coords[i] - coords[j]
                v2 = coords[k] - coords[j]
                th0 = float(np.arccos(np.clip(
                    v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2)),
                    -1, 1)))
                angles.append((i, j, k, th0, 3.0))
    return coords, species, bonds, angles


def azobenzene(device):
    """(coords (24, 3) f32, embedding rows (24,) int64, masses (24,) f32)
    on ``device``."""
    coords, species, _, _ = azobenzene_topology()
    rows = [SPECIES_MAP[int(s)] for s in species]
    return (torch.tensor(coords, dtype=torch.float32, device=device),
            torch.tensor(rows, dtype=torch.int64, device=device),
            torch.tensor(MASSES, dtype=torch.float32, device=device))


class ClassicalFF:
    """Harmonic bonds and angles plus Lennard-Jones between atoms that
    share neither a bond nor an angle."""

    def __init__(self, device, lj_eps: float = 0.002, lj_sigma: float = 2.4):
        _, _, bonds, angles = azobenzene_topology()
        excluded = {(min(i, j), max(i, j)) for i, j, *_ in bonds}
        for i, j, k, *_ in angles:
            excluded.add((min(i, k), max(i, k)))
        nb = [(i, j) for i in range(24) for j in range(i + 1, 24)
              if (i, j) not in excluded]

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        def ints(x):
            return torch.tensor(x, dtype=torch.int64, device=device)
        self.bond_idx = ints([(i, j) for i, j, *_ in bonds])
        self.bond_r0 = f32([b[2] for b in bonds])
        self.bond_k = f32([b[3] for b in bonds])
        self.angle_idx = ints([(i, j, k) for i, j, k, *_ in angles])
        self.angle_th0 = f32([a[3] for a in angles])
        self.angle_k = f32([a[4] for a in angles])
        self.nb_pairs = ints(nb)
        self.lj_eps, self.lj_sigma = lj_eps, lj_sigma

    def energy(self, coords: torch.Tensor) -> torch.Tensor:
        """coords (..., 24, 3) -> energies (...)."""
        def at(idx):
            return coords.index_select(-2, idx)
        d = torch.linalg.vector_norm(at(self.bond_idx[:, 0])
                                     - at(self.bond_idx[:, 1]), dim=-1)
        e_bond = (self.bond_k * (d - self.bond_r0) ** 2).sum(-1)
        a = at(self.angle_idx[:, 0]) - at(self.angle_idx[:, 1])
        b = at(self.angle_idx[:, 2]) - at(self.angle_idx[:, 1])
        cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                                 * torch.linalg.vector_norm(b, dim=-1) + 1e-9)
        th = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))
        e_angle = (self.angle_k * (th - self.angle_th0) ** 2).sum(-1)
        rij = at(self.nb_pairs[:, 0]) - at(self.nb_pairs[:, 1])
        s6 = (self.lj_sigma ** 2 / (rij ** 2).sum(-1)) ** 3
        e_lj = (4 * self.lj_eps * (s6 ** 2 - s6)).sum(-1)
        return e_bond + e_angle + e_lj

    def forces(self, coords: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            c = coords.detach().requires_grad_()
            (g,) = torch.autograd.grad(self.energy(c).sum(), c)
        return -g
