"""Synthetic molecular-dynamics dataset (rMD17 stand-in): counterpart of
``repro/data/synthetic_md.py``.

An azobenzene-like 24-atom molecule (C12 H10 N2) with a classical force
field (harmonic bonds + harmonic angles + Lennard-Jones non-bonded);
configurations are sampled around equilibrium or from an NVE trajectory
of the classical potential, and labelled with its energies and forces.
The topology is numpy (the JAX package's construction, copied); the
force field runs on any device, its forces by autograd. Random draws
come from numpy generators.

Units: eV, Angstrom (so "meV" numbers are 1e-3 of these energies).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.quantizers import clip
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.md.nve import _FS, init_state

__all__ = ["C", "N", "H", "SPECIES_MAP", "MASSES", "azobenzene_topology",
           "ClassicalFF", "make_ff", "sample_dataset", "sample_dataset_md"]

# species codes
C, N, H = 6, 7, 1
SPECIES_MAP = {1: 0, 6: 1, 7: 2}  # -> embedding rows
# masses for the atom order (C*12, N*2, H*10), amu
MASSES = [12.011] * 12 + [14.007] * 2 + [1.008] * 10

Seed = Union[int, np.random.Generator]


def azobenzene_topology():
    """Coordinates (24,3), species (24,), bonds [(i,j,r0,k)], angles [(i,j,k,th0,ka)].

    Atom order: ring A carbons 0-5, ring B carbons 6-11, N 12-13, H 14-23.
    """
    cc, ch, cn, nn = 1.39, 1.08, 1.43, 1.25
    coords = np.zeros((24, 3))
    # two hexagons in the xy-plane, bridged by N=N
    for r, (cx, sign) in enumerate([(-2.85, -1), (2.85, 1)]):
        for i in range(6):
            ang = np.pi / 3 * i + (np.pi / 6 if sign > 0 else -np.pi / 6)
            coords[6 * r + i] = [cx + cc * np.cos(ang), cc * np.sin(ang), 0.0]
    # N atoms between the rings
    coords[12] = [-0.95, 0.30, 0.0]
    coords[13] = [0.95, -0.30, 0.0]
    species = np.array([C] * 12 + [N] * 2 + [H] * 10)

    bonds: List[Tuple[int, int, float, float]] = []
    kb, kbh = 25.0, 28.0  # eV / A^2
    for r in range(2):
        for i in range(6):
            bonds.append((6 * r + i, 6 * r + (i + 1) % 6, cc, kb))
    # ring-N bonds: attach N12 to ring-A atom closest, N13 to ring-B
    ra = int(np.argmin(np.linalg.norm(coords[0:6] - coords[12], axis=1)))
    rb = int(np.argmin(np.linalg.norm(coords[6:12] - coords[13], axis=1))) + 6
    bonds.append((ra, 12, cn, kb))
    bonds.append((rb, 13, cn, kb))
    bonds.append((12, 13, nn, 35.0))
    # hydrogens on the remaining ring carbons
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

    # angles: for every atom with >= 2 bonds, all bonded pairs
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
                    v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2)), -1, 1)))
                angles.append((i, j, k, th0, 3.0))
    return coords, species, bonds, angles


@dataclasses.dataclass(frozen=True)
class ClassicalFF:
    bond_idx: torch.Tensor    # (B, 2) int
    bond_r0: torch.Tensor     # (B,)
    bond_k: torch.Tensor      # (B,)
    angle_idx: torch.Tensor   # (A, 3) int
    angle_th0: torch.Tensor   # (A,)
    angle_k: torch.Tensor     # (A,)
    nb_pairs: torch.Tensor    # (P, 2) non-bonded pairs
    lj_eps: float = 0.002
    lj_sigma: float = 2.4

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
        th = torch.arccos(clip(cos, -1 + 1e-7, 1 - 1e-7))
        e_angle = (self.angle_k * (th - self.angle_th0) ** 2).sum(-1)

        rij = at(self.nb_pairs[:, 0]) - at(self.nb_pairs[:, 1])
        d2 = (rij ** 2).sum(-1)
        s6 = (self.lj_sigma ** 2 / d2) ** 3
        e_lj = (4 * self.lj_eps * (s6 ** 2 - s6)).sum(-1)
        return e_bond + e_angle + e_lj

    def forces(self, coords: torch.Tensor) -> torch.Tensor:
        """-dE/dr by autograd, (..., 24, 3), detached."""
        with torch.enable_grad():
            c = coords.detach().requires_grad_()
            (g,) = torch.autograd.grad(self.energy(c).sum(), c)
        return -g


def make_ff(device: DeviceLike = None
            ) -> Tuple[torch.Tensor, torch.Tensor, ClassicalFF]:
    """(equilibrium coords (24, 3) float32, species rows (24,) int64, the
    force field), on ``device``."""
    dev = resolve_device(device)
    coords, species, bonds, angles = azobenzene_topology()
    bonded = {(min(i, j), max(i, j)) for i, j, *_ in bonds}
    # 1-3 pairs (share an angle) are also excluded from LJ
    for i, j, k, *_ in angles:
        bonded.add((min(i, k), max(i, k)))
    nb = [(i, j) for i in range(24) for j in range(i + 1, 24)
          if (i, j) not in bonded]

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    def ints(x):
        return torch.tensor(x, dtype=torch.int64, device=dev)
    ff = ClassicalFF(
        bond_idx=ints([(i, j) for i, j, *_ in bonds]),
        bond_r0=f32([b[2] for b in bonds]),
        bond_k=f32([b[3] for b in bonds]),
        angle_idx=ints([(i, j, k) for i, j, k, *_ in angles]),
        angle_th0=f32([a[3] for a in angles]),
        angle_k=f32([a[4] for a in angles]),
        nb_pairs=ints(nb),
    )
    sp = ints([SPECIES_MAP[int(s)] for s in species])
    return f32(coords), sp, ff


def _labelled(coords, species, ff, standardize):
    """The dataset dict: labels from the classical FF, standardized so MAEs
    report in eV as E * e_scale + e_shift and F * e_scale."""
    e = ff.energy(coords)
    f = ff.forces(coords)
    e_shift = e.mean() if standardize else torch.zeros_like(e[0])
    e_scale = torch.clamp(e.std(correction=0), min=1e-6) if standardize \
        else torch.ones_like(e[0])
    return {"coords": coords, "energy": (e - e_shift) / e_scale,
            "forces": f / e_scale, "species": species,
            "e_shift": e_shift, "e_scale": e_scale}


def sample_dataset(seed: Seed, n_samples: int, sigma: float = 0.04,
                   standardize: bool = True, sigma_mixture: bool = True,
                   device: DeviceLike = None):
    """Perturb the equilibrium geometry with numpy noise from ``seed``;
    label with the classical FF.

    Returns a dict with coords (S, 24, 3), energy (S,), forces (S, 24, 3),
    species (24,), plus the standardization constants e_shift / e_scale
    (E_orig = E * e_scale + e_shift, F_orig = F * e_scale).
    """
    eq, species, ff = make_ff(device)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((n_samples,) + tuple(eq.shape))
    if sigma_mixture:
        # broaden PES coverage so learned potentials stay stable in MD
        sigmas = np.array([0.02, 0.05, 0.08, 0.12])
        noise = noise * sigmas[rng.integers(0, len(sigmas), n_samples)][
            :, None, None]
    else:
        noise = noise * sigma
    coords = eq[None] + torch.from_numpy(noise.astype(np.float32)).to(
        eq.device)
    return _labelled(coords, species, ff, standardize)


def sample_dataset_md(seed: Seed, n_samples: int,
                      temperature_K: float = 300.0, dt_fs: float = 0.5,
                      stride: int = 40, standardize: bool = True,
                      device: DeviceLike = None,
                      veloc: Optional[np.ndarray] = None):
    """Frames of a classical-FF NVE trajectory at the given temperature,
    one every ``stride`` steps (the rMD17 protocol). Initial velocities
    are Maxwell-Boltzmann from numpy ``seed`` (``md.nve.init_state``), or
    ``veloc`` as given (e.g. the JAX package's state)."""
    eq, species, ff = make_ff(device)
    masses = torch.tensor(MASSES, dtype=torch.float32, device=eq.device)
    r, v, f = init_state(seed, eq, masses, ff.forces, temperature_K,
                         veloc=veloc)
    dt = dt_fs * _FS
    inv_m = (1.0 / masses)[:, None]
    frames = []
    for _ in range(n_samples):
        for _ in range(stride):
            v_half = v + 0.5 * dt * f * inv_m
            r = r + dt * v_half
            f = ff.forces(r)
            v = v_half + 0.5 * dt * f * inv_m
        frames.append(r)
    return _labelled(torch.stack(frames), species, ff, standardize)
