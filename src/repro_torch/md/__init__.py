"""repro_torch.md — molecular dynamics on the quantized force field (the
port's counterpart of ``repro.md``).

* :mod:`repro_torch.md.nve` — the minimal velocity-Verlet integrator
  (single molecule, caller supplies ``force_fn``/``energy_fn``).
* :mod:`repro_torch.md.engine` — the device-resident :class:`MDEngine`:
  batched replica NVE over the quantized sparse forward, with
  Verlet-skin neighbour lists (:mod:`repro_torch.md.neighbor`) selected
  on the device and no host sync inside a record segment.
"""
from repro_torch.md.engine import MDConfig, MDEngine, ReplicaState, pad_replicas
from repro_torch.md.neighbor import (NeighborList, build_neighbor_list,
                                     maybe_rebuild, needs_rebuild)
from repro_torch.md.nve import (MDState, energy_drift_rate, init_state,
                                kinetic_energy, nve_trajectory)

__all__ = [
    "MDConfig", "MDEngine", "ReplicaState", "pad_replicas",
    "NeighborList", "build_neighbor_list", "maybe_rebuild", "needs_rebuild",
    "MDState", "energy_drift_rate", "init_state", "kinetic_energy",
    "nve_trajectory",
]
