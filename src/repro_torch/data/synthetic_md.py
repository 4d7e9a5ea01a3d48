"""Synthetic molecular-dynamics dataset (rMD17 stand-in): counterpart of
``repro/data/synthetic_md.py``.

An azobenzene-like 24-atom molecule (C12 H10 N2) with a classical force
field (harmonic bonds + harmonic angles + Lennard-Jones non-bonded);
configurations are sampled around equilibrium or from an NVE trajectory
of the classical potential, and labelled with its energies and forces.
The topology is numpy (the JAX package's construction, copied); the
force field runs on any device, its forces by autograd. Random draws
come from numpy generators.

The NVE sampler is the reference's two nested ``lax.scan``s: one frame
is ``stride`` velocity-Verlet steps over the carried (r, v, f)
(:meth:`FrameSampler.body`). On the card that body is captured once per
(atom count, stride, dt) and replayed once per frame
(``repro_torch.captured.Programs``); the CPU calls it eagerly.

Units: eV, Angstrom (so "meV" numbers are 1e-3 of these energies).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.captured import Programs, copy_into
from repro_torch.core.quantizers import clip
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.md.nve import _FS, init_state

__all__ = ["C", "N", "H", "SPECIES_MAP", "MASSES", "azobenzene_topology",
           "ClassicalFF", "make_ff", "sample_dataset", "FrameSampler",
           "frame_sampler", "sample_frames_md", "sample_dataset_md"]

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


class FrameSampler:
    """The classical-MD frames of one device: the force field, made once
    so that its tensors outlive the graphs that read them, and one
    :class:`~repro_torch.captured.Programs` that carries the state
    (r, v, f) and holds a frame program per (atom count, stride, dt).
    Use :func:`frame_sampler`; one run at a time (``lock``)."""

    def __init__(self, device: torch.device):
        self.eq, self.species, self.ff = make_ff(device)
        self.masses = torch.tensor(MASSES, dtype=torch.float32,
                                   device=self.eq.device)
        self.inv_m = (1.0 / self.masses)[:, None]
        self.programs = Programs(
            device=self.eq.device, name="the classical-MD frame",
            state=tuple(torch.zeros_like(self.eq) for _ in range(3)))
        self.lock = threading.Lock()

    def body(self, stride: int, dt_fs: float):
        """One frame: ``stride`` velocity-Verlet steps from the carried
        (r, v, f), written back into it (what a captured frame replays)."""
        dt = dt_fs * _FS
        inv_m, forces = self.inv_m, self.ff.forces

        def frame(state):
            r, v, f = state
            for _ in range(stride):
                v_half = v + 0.5 * dt * f * inv_m
                r = r + dt * v_half
                f = forces(r)
                v = v_half + 0.5 * dt * f * inv_m
            copy_into(state, (r, v, f))
        return frame

    def frames(self, state, n_samples: int, stride: int, dt_fs: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(coords, veloc), each (n_samples, n, 3): the state after each of
        ``n_samples`` frames from ``state`` (r, v, f), cloned out before
        the next frame runs."""
        progs, key = self.programs, (self.eq.shape[0], stride, dt_fs)
        body = self.body(stride, dt_fs)
        with self.lock:
            copy_into(progs.state, state)
            coords, veloc = (self.eq.new_empty((n_samples,) + self.eq.shape)
                             for _ in range(2))
            for i in range(n_samples):
                progs.run(key, body)
                coords[i].copy_(progs.state[0])
                veloc[i].copy_(progs.state[1])
        return coords, veloc


_SAMPLERS: Dict[torch.device, FrameSampler] = {}
_SAMPLERS_LOCK = threading.Lock()


def frame_sampler(device: DeviceLike = None) -> FrameSampler:
    """The device's :class:`FrameSampler`, made on first use and kept, so
    that its captured frames serve every later call."""
    dev = resolve_device(device)
    with _SAMPLERS_LOCK:
        if dev not in _SAMPLERS:
            _SAMPLERS[dev] = FrameSampler(dev)
        return _SAMPLERS[dev]


def sample_frames_md(seed: Seed, n_samples: int,
                     temperature_K: float = 300.0, dt_fs: float = 0.5,
                     stride: int = 40, device: DeviceLike = None,
                     veloc: Optional[np.ndarray] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frames of :func:`sample_dataset_md` unlabelled: (coords,
    veloc), each (n_samples, 24, 3)."""
    sampler = frame_sampler(device)
    state = init_state(seed, sampler.eq, sampler.masses, sampler.ff.forces,
                       temperature_K, veloc=veloc)
    return sampler.frames(state, n_samples, stride, dt_fs)


def sample_dataset_md(seed: Seed, n_samples: int,
                      temperature_K: float = 300.0, dt_fs: float = 0.5,
                      stride: int = 40, standardize: bool = True,
                      device: DeviceLike = None,
                      veloc: Optional[np.ndarray] = None):
    """Frames of a classical-FF NVE trajectory at the given temperature,
    one every ``stride`` steps (the rMD17 protocol). Initial velocities
    are Maxwell-Boltzmann from numpy ``seed`` (``md.nve.init_state``), or
    ``veloc`` as given (e.g. the JAX package's state). On the card each
    frame replays the frame program (:class:`FrameSampler`)."""
    sampler = frame_sampler(device)
    coords, _ = sample_frames_md(seed, n_samples, temperature_K, dt_fs,
                                 stride, sampler.eq.device, veloc)
    return _labelled(coords, sampler.species, sampler.ff, standardize)
