"""Device-resident MD engine over the quantized sparse forward:
counterpart of ``repro/md/engine.py``.

An MD run is 10^4-10^6 force calls, so any per-step host work multiplies
into the wall clock. The integration loop stays on the device:

* **velocity Verlet, one record segment at a time** — the JAX package's
  ``lax.scan`` becomes a Python loop over device tensors. Nothing inside
  a segment reads a tensor on the host; the host syncs only at record
  checkpoints (the overflow flag, the guardrails, the record itself). On
  the card the segment is captured as a program per (replica batch
  shape, edge capacity, segment length), the counterpart of the JAX
  engine's ``_segment_jit`` (``repro_torch.captured``): it ends by
  copying its new state into the static state it read, so each replay
  advances that state in place, and ``run`` copies only the record to
  the host. The CPU runs the segment eagerly (:meth:`MDEngine._segment`,
  also the body a capture records).
* **Verlet-skin neighbour lists** (``md/neighbor.py``) — built at
  ``cutoff + skin``, selected against a fresh build on the device every
  step by the displacement criterion, and refined to the true cutoff
  inside the forward (``refine_cutoff=True``), so forces are exactly
  those of a fresh list every step.
* **the quantized sparse forward** — ``serving.forward.
  sparse_energy_and_forces``: the f32-A quantized matmul kernels (K1/K2),
  the edge softmax (K3, on the skin list's layout with the refined mask)
  and, with ``mddq_kernel``, the MDDQ encode (K4); forces by autograd.
* **batched replicas** — a padded ``(B, cap, ...)`` batch of molecules
  integrated together; padded atoms get exactly zero force and never
  move.

Runs on CUDA unless ``device="cpu"`` is passed (then every kernel runs
its plain PyTorch version); with no card and no ``"cpu"`` it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.captured import (CapturedProgram, copy_into, map_tensors,
                                  new_pool)
from repro_torch.core.codebook import make_codebook
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.guardrails import GuardrailViolation, check_finite_tree
from repro_torch.kernels import ops
from repro_torch.kernels._launch import count_launch
from repro_torch.md.neighbor import (NeighborList, build_neighbor_list,
                                     maybe_rebuild)
from repro_torch.md.nve import _FS, _KB
from repro_torch.models.so3krates import So3kratesConfig, init_params
from repro_torch.obs.metrics import REGISTRY
from repro_torch.serving.bucketing import EDGE_LANE, count_edges
from repro_torch.serving.forward import sparse_energy_and_forces
from repro_torch.serving.qparams import QuantizedParams, quantize_so3_params

__all__ = ["MDConfig", "ReplicaState", "MDEngine", "pad_replicas",
           "FORCE_CALLS"]


def _force_call_counter(mode: str):
    def counter():
        """Holder of ``launches``: the force calls of this mode run on
        the card, counted as the kernels count their launches (a
        captured segment's per replay)."""
    counter.__name__ = f"md_force_calls_{mode}"
    counter.launches = 0
    return counter


# per mode: MD force calls on the card (``kernels._launch.count_launch``)
FORCE_CALLS = {m: _force_call_counter(m) for m in ("fp32", "w8a8", "w4a8")}


@dataclasses.dataclass(frozen=True)
class MDConfig:
    """MD-side knobs, orthogonal to the model architecture config (the
    JAX package's fields)."""
    mode: str = "w8a8"               # "fp32" | "w8a8" | "w4a8"
    dt_fs: float = 0.5               # integration step, femtoseconds
    # skin radius (Angstrom): the list is built at cutoff + skin and
    # stays valid until some atom moves skin/2; 0 = rebuild every step
    skin: float = 0.45
    record_every: int = 50           # steps between energy records
    # per-molecule edge slots of the skin list; None = sized at
    # init_state from the initial cutoff+skin edge count times the
    # safety factor, rounded up to EDGE_LANE
    edge_capacity: Optional[int] = None
    edge_capacity_safety: float = 1.3
    # MDDQ on l=1 features; None = follow the mode (on for quantized)
    quant_vectors: Optional[bool] = None
    # kept from the JAX package's config; in the port the device decides:
    # the kernels on every CUDA tensor, their plain versions on the CPU
    use_kernels: Optional[bool] = None
    edge_kernel: Optional[bool] = None
    # serve-time MDDQ through the encode kernel's quantize-dequantize
    mddq_kernel: bool = False
    # audit: count cutoff edges missed by the skin list every step
    # (O(cap^2) extra work, for tests and audits)
    track_missed: bool = False
    # -- guardrails, checked at each record checkpoint --
    check_finite: bool = True
    # max admissible |e_tot - e_tot(first checkpoint)| per replica (eV);
    # None = drift monitor off
    drift_limit: Optional[float] = None

    def __post_init__(self):
        if self.mode not in ("fp32", "w8a8", "w4a8"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.skin < 0:
            raise ValueError("skin must be >= 0")
        if self.drift_limit is not None and self.drift_limit <= 0:
            raise ValueError("drift_limit must be > 0 or None")

    @property
    def vectors_quantized(self) -> bool:
        if self.quant_vectors is None:
            return self.mode != "fp32"
        return self.quant_vectors


class ReplicaState(NamedTuple):
    """Integration state of a padded batch of replicas, all on the
    device."""
    coords: torch.Tensor     # (B, cap, 3) Angstrom
    veloc: torch.Tensor      # (B, cap, 3) A / t*
    forces: torch.Tensor     # (B, cap, 3) eV / A
    e_pot: torch.Tensor      # (B,) potential energy at coords
    nlist: NeighborList      # skin edge list + rebuild bookkeeping
    missed: torch.Tensor     # () int32, cumulative missed cutoff edges
    #                          (advanced only when MDConfig.track_missed)


def pad_replicas(species: np.ndarray, coords: np.ndarray, n_replicas: int,
                 capacity: Optional[int] = None):
    """Tile one molecule into a padded replica batch: species (n,),
    coords (n, 3) -> (species (B, cap) int32, coords (B, cap, 3) f32,
    mask (B, cap) bool) numpy arrays with B = n_replicas and cap =
    capacity (default n). Replicas start identical; their velocities come
    from ``MDEngine.init_state``."""
    n = int(species.shape[0])
    cap = n if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < molecule size {n}")
    sp = np.zeros((n_replicas, cap), np.int32)
    co = np.zeros((n_replicas, cap, 3), np.float32)
    mask = np.zeros((n_replicas, cap), bool)
    sp[:, :n] = np.asarray(species, np.int32)
    co[:, :n] = np.asarray(coords, np.float32)
    mask[:, :n] = True
    return sp, co, mask


class MDEngine:
    """Batched, device-resident NVE integrator for the quantized model."""

    def __init__(self, model_cfg: So3kratesConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 md: MDConfig = MDConfig(),
                 qparams: Optional[QuantizedParams] = None,
                 codebook: Optional[torch.Tensor] = None, seed: int = 0,
                 device: DeviceLike = None):
        """From fp32 ``params`` (quantized here per ``md.mode``; None =
        ``init_params(seed)``) or from pre-quantized ``qparams`` and their
        codebook (shared with a ``QuantizedEngine`` by its
        ``md_engine()``), on ``device`` (None = the CUDA device, or
        raise)."""
        self.model_cfg = model_cfg
        self.md = md
        self.device = resolve_device(device)
        if qparams is None:
            if params is None:
                params = init_params(model_cfg, seed, self.device)
            params = {k: v.to(self.device) for k, v in params.items()}
            qparams = quantize_so3_params(params, md.mode)
        self.qparams = qparams
        self._quant_vec = md.vectors_quantized
        if codebook is None and self._quant_vec:
            codebook = make_codebook(model_cfg.dir_bits, device=self.device)
        self._codebook = codebook
        # captured segments by (batch shape, edge capacity, length)
        self._programs: Dict[tuple, CapturedProgram] = {}
        self._graph_pool = None

    def _tensor(self, a, dtype) -> torch.Tensor:
        """An array or tensor as ``dtype`` on the engine's device (numpy
        input is copied: a read-only array is fine)."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.as_tensor(np.array(a), dtype=dtype, device=self.device)

    # -- forces --------------------------------------------------------------

    def _energy_forces(self, species, coords, mask, nlist: NeighborList):
        """Quantized sparse forward at the true cutoff: the skin list's
        mask is refined to d < cutoff at these coordinates inside the
        forward, so the edge set equals a fresh rebuild's."""
        if self.device.type == "cuda":
            count_launch(FORCE_CALLS[self.md.mode])
        return sparse_energy_and_forces(
            self.qparams, self.model_cfg, species, coords, mask,
            nlist.senders, nlist.receivers, nlist.edge_mask,
            self._codebook, quant_vectors=self._quant_vec,
            mddq_kernel=self.md.mddq_kernel, refine_cutoff=True)

    def _count_missed(self, coords, mask, nlist: NeighborList):
        """Cutoff edges absent from the refined skin list (must be 0: the
        audit behind MDConfig.track_missed), on the device."""
        B, cap = mask.shape
        cutoff = self.model_cfg.cutoff
        rij = coords[:, :, None, :] - coords[:, None, :, :]
        d2 = (rij * rij).sum(-1)
        eye = torch.eye(cap, dtype=torch.bool, device=coords.device)
        fresh = ((d2 < cutoff * cutoff) & ~eye & mask[:, :, None]
                 & mask[:, None, :])
        em = ops.refine_edge_mask(coords.reshape(-1, 3), nlist.senders,
                                  nlist.receivers, nlist.edge_mask, cutoff)
        # flat (b, i, j) of every slot: receivers // cap is b, and
        # b * cap * cap + i * cap + j = receivers * cap + senders % cap
        slot = (nlist.receivers.long() * cap + nlist.senders.long() % cap)
        have = torch.zeros(B * cap * cap, dtype=torch.int32,
                           device=coords.device).index_add_(
            0, slot, em.to(torch.int32)).reshape(B, cap, cap) > 0
        return (fresh & ~have).sum().to(torch.int32)

    # -- integration ---------------------------------------------------------

    def _step(self, s: ReplicaState, species, mask, inv_m, dt):
        v_half = s.veloc + 0.5 * dt * s.forces * inv_m
        r_new = s.coords + dt * v_half
        # rebuild BEFORE the force call: while the largest displacement
        # stays under skin/2 the old list is conservative, and the moment
        # it is not, the list is rebuilt at these coordinates
        nlist = maybe_rebuild(s.nlist, r_new, mask, self.model_cfg.cutoff,
                              self.md.skin)
        e_pot, f_new = self._energy_forces(species, r_new, mask, nlist)
        v_new = v_half + 0.5 * dt * f_new * inv_m
        missed = s.missed
        if self.md.track_missed:
            missed = missed + self._count_missed(r_new, mask, nlist)
        return ReplicaState(r_new, v_new, f_new, e_pot, nlist, missed)

    def _segment(self, state: ReplicaState, species, mask, masses,
                 length: int):
        """``length`` velocity-Verlet steps on device tensors with no host
        sync, then one energy/temperature record (device tensors)."""
        dt = self.md.dt_fs * _FS
        inv_m = torch.where(mask, 1.0 / masses.clamp_min(1e-9),
                            torch.zeros_like(masses))[..., None]
        for _ in range(length):
            state = self._step(state, species, mask, inv_m, dt)
        m_eff = torch.where(mask, masses, torch.zeros_like(masses))
        e_kin = 0.5 * (m_eff[..., None] * state.veloc ** 2).sum((1, 2))
        # 3N - 3 degrees of freedom: init_state removes the per-replica
        # centre-of-mass momentum and NVE conserves it at zero
        n_dof = (3.0 * mask.sum(-1).to(torch.float32) - 3.0).clamp_min(1.0)
        rec = {"e_pot": state.e_pot, "e_tot": state.e_pot + e_kin,
               "temperature_K": 2.0 * e_kin / (n_dof * _KB)}
        return state, rec

    def _captured_segment(self, state: ReplicaState, species, mask, masses,
                          length: int):
        """:meth:`_segment` through the program of its shape: replayed, or
        captured on first use (its eager warm-up is this call)."""
        key = (tuple(mask.shape), state.nlist.edge_capacity, length)
        inputs = dict(state=state, species=species, mask=mask,
                      masses=masses)
        prog = self._programs.get(key)
        if prog is not None:
            return prog.replay(**inputs)

        def segment(state, species, mask, masses):
            new, rec = self._segment(state, species, mask, masses, length)
            copy_into(state, new)      # the next replay starts from here
            return state, rec
        if self._graph_pool is None:
            self._graph_pool = new_pool()
        prog = CapturedProgram(segment, inputs, device=self.device,
                               pool=self._graph_pool,
                               name=f"the MD segment {key}")
        self._programs[key] = prog
        return prog.first_result

    # -- public API ----------------------------------------------------------

    def device_inputs(self, species, mask, masses):
        """(species int32, mask bool, masses f32 broadcast to mask's
        shape) as tensors on the engine's device."""
        mask = self._tensor(mask, torch.bool)
        masses = self._tensor(masses, torch.float32).expand(mask.shape)
        return self._tensor(species, torch.int32), mask, masses

    def init_state(self, rng: Union[np.random.Generator, int], species,
                   coords, mask, masses, temperature_K: float = 300.0,
                   edge_capacity: Optional[int] = None,
                   veloc: Optional[np.ndarray] = None) -> ReplicaState:
        """Maxwell-Boltzmann initialization of a padded replica batch.

        species (B, cap) int32, coords (B, cap, 3), mask (B, cap) bool,
        masses (cap,) or (B, cap) amu. Velocities are drawn with numpy
        from ``rng`` (a Generator or a seed), or taken from ``veloc``
        (B, cap, 3) as given (e.g. the JAX package's initial state). Sizes
        the skin list's edge capacity from this configuration unless
        given, builds it and evaluates the initial forces. Raises if the
        initial cutoff+skin graph overflows the capacity.
        """
        species, mask_t, masses_t = self.device_inputs(species, mask,
                                                       masses)
        coords_t = self._tensor(coords, torch.float32)
        B, cap = mask_t.shape

        ec = self.md.edge_capacity if edge_capacity is None else edge_capacity
        if ec is None:
            counts = count_edges(coords_t.cpu().numpy(),
                                 mask_t.cpu().numpy(),
                                 self.model_cfg.cutoff + self.md.skin)
            ec = int(counts.max()) * self.md.edge_capacity_safety
            ec = -(-max(int(ec), 1) // EDGE_LANE) * EDGE_LANE
            ec = min(ec, -(-cap * cap // EDGE_LANE) * EDGE_LANE)
        if ec % EDGE_LANE != 0:
            raise ValueError(
                f"edge_capacity {ec} is not a multiple of {EDGE_LANE}")

        nlist = build_neighbor_list(coords_t, mask_t, self.model_cfg.cutoff,
                                    self.md.skin, ec)
        if bool(nlist.overflow):
            raise ValueError(
                f"initial cutoff+skin graph overflows edge_capacity={ec}; "
                "raise MDConfig.edge_capacity or edge_capacity_safety")

        m3 = mask_t[..., None]
        if veloc is None:
            std = torch.sqrt(_KB * temperature_K
                             / masses_t.clamp_min(1e-9))[..., None]
            normal = np.random.default_rng(rng).standard_normal((B, cap, 3))
            v = self._tensor(normal.astype(np.float32), torch.float32) \
                * std * m3
            # remove the per-replica centre-of-mass drift over real atoms
            m = (masses_t * mask_t)[..., None]
            p = (m * v).sum(1, keepdim=True) \
                / m.sum(1, keepdim=True).clamp_min(1e-9)
            v = (v - p) * m3
        else:
            v = self._tensor(veloc, torch.float32)

        e_pot, forces = self._energy_forces(species, coords_t, mask_t, nlist)
        return ReplicaState(coords=coords_t, veloc=v, forces=forces,
                            e_pot=e_pot, nlist=nlist,
                            missed=torch.zeros((), dtype=torch.int32,
                                               device=self.device))

    def run(self, state: ReplicaState, species, mask, masses,
            n_steps: int, record_every: Optional[int] = None
            ) -> Tuple[ReplicaState, Dict[str, np.ndarray]]:
        """Integrate ``n_steps`` of NVE, one host sync per record.

        Each ``record_every``-step segment runs with no host sync (on the
        card, a replay of its captured program); at its end the host
        reads the overflow flag (raising if an on-device rebuild exceeded
        the edge capacity: the trajectory is invalid past that point),
        runs the guardrails and keeps the record. The returned state is
        the caller's own (no program's buffer).
        Returns the final state and ``e_pot`` / ``e_tot`` /
        ``temperature_K`` arrays of shape ``(n_records, B)`` (one extra,
        shorter-interval sample covers any remainder: no step is
        dropped), plus ``n_rebuilds`` and ``missed_edges``.
        """
        if record_every is None:
            record_every = self.md.record_every
        species, mask, masses = self.device_inputs(species, mask, masses)
        n_records, tail = divmod(n_steps, record_every)
        lengths = [record_every] * n_records + ([tail] if tail else [])
        recs = []
        e_ref: Optional[np.ndarray] = None   # first checkpoint's e_tot
        captured = self.device.type == "cuda"
        segment = self._captured_segment if captured else self._segment
        for length in lengths:
            state, rec = segment(state, species, mask, masses, length)
            if bool(state.nlist.overflow):   # the per-checkpoint host sync
                raise RuntimeError(
                    "skin neighbour list overflowed its edge capacity "
                    f"({state.nlist.edge_capacity}) during the run; raise "
                    "MDConfig.edge_capacity / edge_capacity_safety")
            rec = {k: v.cpu().numpy() for k, v in rec.items()}
            if self.md.check_finite:
                bad = check_finite_tree({"e_tot": rec["e_tot"],
                                         "e_pot": rec["e_pot"]})
                if bad is not None:
                    raise GuardrailViolation(
                        f"non-finite {bad} at an MD checkpoint (mode "
                        f"{self.md.mode}) — the trajectory exploded",
                        reason="nonfinite", severity="fatal",
                        detail={"mode": self.md.mode, "array": bad})
            if self.md.drift_limit is not None:
                if e_ref is None:
                    e_ref = rec["e_tot"]
                else:
                    drift = float(np.abs(rec["e_tot"] - e_ref).max())
                    # drift as a fraction of the limit, published whether
                    # or not the guardrail trips
                    REGISTRY.gauge("md_energy_drift_ratio",
                                   mode=self.md.mode).set(
                        drift / self.md.drift_limit)
                    if drift > self.md.drift_limit:
                        raise GuardrailViolation(
                            f"energy drift {drift:.4g} eV exceeds "
                            f"drift_limit={self.md.drift_limit} eV "
                            f"(mode {self.md.mode})",
                            reason="energy_drift", severity="suspect",
                            detail={"mode": self.md.mode, "value": drift,
                                    "limit": self.md.drift_limit})
            recs.append(rec)
        if captured and lengths:
            # the state lives in a program's static buffers: hand back a copy
            state = map_tensors(torch.clone, state)
        records = {k: np.stack([r[k] for r in recs])
                   for k in recs[0]} if recs else {}
        records["n_rebuilds"] = int(state.nlist.n_rebuilds)
        records["missed_edges"] = int(state.missed)
        return state, records

    # -- introspection -------------------------------------------------------

    @property
    def backend(self) -> str:
        return self.device.type
