"""NVE molecular dynamics (velocity Verlet): counterpart of
``repro/md/nve.py``.

Units: eV, Angstrom, and a time unit t* chosen so that masses are in amu:
with E in eV, m in amu, 1 t* = 10.1805 fs; dt is given in fs and
converted. ``lax.scan`` becomes a Python loop over device tensors; the
host reads nothing until a segment's energy record is taken.

A segment of ``length`` steps and its energy record is one plain
function over the state's buffers (:func:`nve_segment`), which writes
the new state into the state it read. The reference jits the whole
trajectory; the card captures a segment once per length (the record
interval and the tail) and replays it (``repro_torch.captured
.Programs``), and the CPU calls it eagerly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.captured import Programs, clone_tree, copy_into

__all__ = ["MDState", "kinetic_energy", "init_state", "nve_segment",
           "nve_trajectory", "energy_drift_rate"]

# 1 fs in sqrt(amu * A^2 / eV)
_FS = 1.0 / 10.180505
_KB = 8.617333e-5  # eV / K


class MDState(NamedTuple):
    coords: torch.Tensor    # (n, 3) Angstrom
    veloc: torch.Tensor     # (n, 3) A / t*
    forces: torch.Tensor    # (n, 3) eV / A


def kinetic_energy(state: MDState, masses: torch.Tensor) -> torch.Tensor:
    return 0.5 * (masses[:, None] * state.veloc ** 2).sum()


def init_state(rng: Union[np.random.Generator, int], coords: torch.Tensor,
               masses: torch.Tensor,
               force_fn: Callable[[torch.Tensor], torch.Tensor],
               temperature_K: float = 300.0,
               veloc: Optional[np.ndarray] = None) -> MDState:
    """Maxwell-Boltzmann velocities at the given temperature (kB in
    eV/K) with the centre-of-mass drift removed, drawn with numpy from
    ``rng`` (a Generator or a seed); or ``veloc`` as given (e.g. the JAX
    package's state, so both packages integrate one state)."""
    if veloc is None:
        rng = np.random.default_rng(rng)
        std = torch.sqrt(_KB * temperature_K / masses)[:, None]
        v = torch.from_numpy(rng.standard_normal(tuple(coords.shape))
                             .astype(np.float32)).to(coords.device) * std
        v = v - v.mean(0, keepdim=True)
    else:
        v = torch.as_tensor(np.array(veloc, np.float32),
                            device=coords.device)
    return MDState(coords=coords, veloc=v, forces=force_fn(coords))


def nve_segment(state: MDState, masses: torch.Tensor,
                force_fn: Callable[[torch.Tensor], torch.Tensor],
                energy_fn: Callable[[torch.Tensor], torch.Tensor],
                dt_fs: float, length: int) -> torch.Tensor:
    """``length`` velocity-Verlet steps from ``state``, whose tensors get
    the new state (the body a captured segment replays); returns the
    total energy at its end."""
    dt = dt_fs * _FS
    inv_m = (1.0 / masses)[:, None]
    s = state
    for _ in range(length):
        v_half = s.veloc + 0.5 * dt * s.forces * inv_m
        r_new = s.coords + dt * v_half
        f_new = force_fn(r_new)
        s = MDState(r_new, v_half + 0.5 * dt * f_new * inv_m, f_new)
    copy_into(state, s)
    return energy_fn(state.coords) + kinetic_energy(state, masses)


def nve_trajectory(state: MDState, masses: torch.Tensor,
                   force_fn: Callable[[torch.Tensor], torch.Tensor],
                   energy_fn: Callable[[torch.Tensor], torch.Tensor],
                   dt_fs: float, n_steps: int, record_every: int = 10):
    """Run velocity Verlet; returns (final_state, recorded total energies
    as a (n_records,) tensor).

    All ``n_steps`` are integrated: when ``record_every`` does not divide
    ``n_steps`` the remainder is run as a final shorter segment with one
    extra energy sample at its end, so the record has length
    ``ceil(n_steps / record_every)`` and the last interval may be shorter
    than the others (drop that sample before fitting a drift slope).

    Each segment is :func:`nve_segment` over a state of the run's own
    (``state`` is never written) through the run's
    :class:`~repro_torch.captured.Programs` (on the card one captured
    program per segment length), each record cloned before the next
    segment. The returned state is a clone of the run's.
    """
    segments = Programs(device=state.coords.device, name="the NVE segment",
                        state=clone_tree(state))

    def body(length):
        return lambda state: nve_segment(state, masses, force_fn, energy_fn,
                                         dt_fs, length)
    n_records, tail = divmod(n_steps, record_every)
    energies = []
    for length in [record_every] * n_records + ([tail] if tail else []):
        energies.append(segments.run(length, body(length)).clone())
    return (clone_tree(segments.state),
            torch.stack(energies) if energies else torch.zeros(0))


def energy_drift_rate(energies, dt_fs: float, record_every: int,
                      n_atoms: int) -> float:
    """Least-squares slope of total energy, in eV/atom/ps.

    Assumes uniform ``record_every`` spacing between samples: when a
    trajectory ran a shorter remainder segment, drop its final sample
    before fitting. ``energies``: (n_records,) array or tensor.
    """
    if isinstance(energies, torch.Tensor):
        energies = energies.detach().cpu().numpy()
    e = np.asarray(energies, np.float64)
    t_ps = np.arange(e.shape[0]) * dt_fs * record_every * 1e-3
    t = t_ps - t_ps.mean()
    slope = np.sum(t * (e - e.mean())) / np.sum(t * t)
    return float(slope) / n_atoms
