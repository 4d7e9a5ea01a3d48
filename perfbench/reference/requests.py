"""Online force requests: the molecules and their arrival times.

Frozen copy of ``src/repro_torch/server/traffic.py`` and
``serving/bucketing.random_graph`` at commit dde5d65 (the weighted
size-class mixture, molecules placed uniformly in a cube whose side
keeps the atom density fixed, Poisson arrivals), so a later change to
the program cannot change the yardstick; ``drivers/serve.py`` holds the
open-loop replay, which times each request from its scheduled arrival.

A run's requests are a fixed amount of work: ``round(rate * seconds)``
molecules, with arrival times the sorted uniform draws of a Poisson
process conditioned on that count, and sizes drawn from the mixture.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["molecules", "arrivals"]


def molecules(rng: np.random.Generator, n: int, size_mix: Sequence[Dict],
              n_species: int, density: float
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """n (species int32 (k,), coords float32 (k, 3)) from the mixture:
    a class by weight, a size uniform in its range, atoms uniform in a
    cube of side (k / density)^(1/3), species uniform."""
    weights = np.asarray([c["weight"] for c in size_mix], np.float64)
    classes = rng.choice(len(size_mix), size=n, p=weights / weights.sum())
    out = []
    for ci in classes:
        c = size_mix[ci]
        k = int(rng.integers(c["min_atoms"], c["max_atoms"] + 1))
        side = (k / density) ** (1.0 / 3.0)
        coords = rng.uniform(0.0, side, size=(k, 3))
        out.append((rng.integers(0, n_species, k).astype(np.int32),
                    coords.astype(np.float32)))
    return out


def arrivals(rng: np.random.Generator, rate: float, seconds: float
             ) -> np.ndarray:
    """Arrival times (s) of ``round(rate * seconds)`` requests in
    [0, seconds): a Poisson process of that rate given its count."""
    n = int(round(rate * seconds))
    return np.sort(rng.uniform(0.0, seconds, size=n))
