"""``QuantizedEngine``: batched, bucketed, quantized inference on the card.

Counterpart of ``repro/serving/engine.py``. Variable-size molecular
graphs in, per-molecule energies and forces out, with bucketing
(``serving.bucketing``), two execution paths (``serving.forward``: the
dense O(n^2) oracle and the sparse O(E) edge-list path; ``"auto"`` takes
the edge list where it is profitable and falls back to dense when a
batch overflows the bucket's edge capacity), real quantized weights
(``serving.qparams``) through the hand-written CUDA kernels, and exact
masking of padded atoms.

    from repro_torch.models.so3krates import So3kratesConfig
    from repro_torch.serving import Graph, QuantizedEngine, ServeConfig

    engine = QuantizedEngine.from_config(
        So3kratesConfig(feat=32, vec_feat=8, n_layers=2),
        serve=ServeConfig(mode="w8a8", bucket_sizes=(16, 32), max_batch=8))
    engine.warmup()            # builds the kernels, runs every shape class
    results = engine.infer_batch([Graph(species, coords), ...])

The engine runs on CUDA unless ``device="cpu"`` is passed (then every
kernel runs its plain PyTorch version). ``md_engine()`` hands the
quantized weights and codebook to an ``md.MDEngine``. Not ported yet: the
engine's writes to the metrics registry, the sampled LEE probe of the
guardrails and the packed-artifact constructor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.codebook import make_codebook
from repro_torch.core.lee import random_rotations
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.guardrails import (GuardrailConfig, GuardrailViolation,
                                    check_result)
from repro_torch.models.so3krates import So3kratesConfig, init_params
from repro_torch.serving.bucketing import (BucketSpec, Graph,
                                           build_edge_list, count_edges,
                                           pad_graphs, plan_batches)
from repro_torch.serving.forward import (batched_energy_and_forces,
                                         sparse_energy_and_forces)
from repro_torch.serving.qparams import (fp32_bytes, quantize_so3_params,
                                         serving_bytes)

__all__ = ["ServeConfig", "MoleculeResult", "QuantizedEngine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-side knobs, orthogonal to the model architecture config."""
    mode: str = "w8a8"                       # "fp32" | "w8a8" | "w4a8"
    bucket_sizes: tuple = (16, 32, 64, 128)  # atom-capacity ladder
    max_batch: int = 64                      # molecules per batch
    # MDDQ on l=1 features at serve time; None = on for quantized modes,
    # off for fp32 so fp32 is a true reference
    quant_vectors: Optional[bool] = None
    pad_species: int = 0
    # "dense" (O(n^2) oracle), "sparse" (always prefer the edge list) or
    # "auto" (edge list where profitable); sparse-preferring paths run a
    # batch dense when it overflows the bucket's edge capacity
    path: str = "auto"
    # per-molecule edge slots; None = bucketing.default_edge_capacity(cap)
    edge_capacity: Optional[int] = None
    # kept from the JAX package's config; in the port the device decides:
    # the fused kernel on every CUDA batch, its plain version on the CPU
    edge_kernel: Optional[bool] = None
    # serve-time vector quantization through the encode-kernel
    # quantize-dequantize instead of the fake-quant reference (on CUDA
    # both search the codebook with the encode kernel)
    mddq_kernel: bool = False

    def __post_init__(self):
        if self.path not in ("dense", "sparse", "auto"):
            raise ValueError(f"unknown path {self.path!r}")

    @property
    def vectors_quantized(self) -> bool:
        if self.quant_vectors is None:
            return self.mode != "fp32"
        return self.quant_vectors

    def buckets(self) -> List[BucketSpec]:
        return [BucketSpec(capacity=c, max_batch=self.max_batch,
                           edge_capacity=self.edge_capacity)
                for c in self.bucket_sizes]


@dataclasses.dataclass(frozen=True)
class MoleculeResult:
    """Per-molecule inference output with padding stripped."""
    energy: float
    forces: np.ndarray       # (n_atoms, 3)
    n_atoms: int
    bucket_capacity: int     # shape class the molecule rode in
    batch_size: int          # batch rows (incl. alignment dummies)
    path: str = "dense"      # execution path the molecule's batch took
    flags: tuple = ()        # guardrail Flags that fired (mode "mark")


class QuantizedEngine:
    """Batched quantized-inference engine for the SO3krates force field."""

    # "auto" dispatches sparse only when the dense pairwise work is at
    # least this many times the padded edge-slot count (the JAX package's
    # heuristic, kept so both packages dispatch alike)
    _SPARSE_PROFIT_FACTOR = 4

    def __init__(self, model_cfg: So3kratesConfig,
                 params: Dict[str, torch.Tensor], serve: ServeConfig, *,
                 device: DeviceLike = None,
                 guardrails: Optional[GuardrailConfig] = None):
        """Quantize fp32 ``params`` for ``serve.mode`` and place weights
        and codebook on ``device`` (None = the CUDA device, or raise)."""
        self.model_cfg = model_cfg
        self.serve = serve
        self.device = resolve_device(device)
        self.guardrails = (guardrails if guardrails is not None
                           else GuardrailConfig())
        if self.guardrails.lee_probe_every > 0:
            raise NotImplementedError("the sampled LEE probe is not ported "
                                      "yet; use lee_diagnostic")
        params = {k: v.to(self.device) for k, v in params.items()}
        self._fp32_bytes = fp32_bytes(params)
        self.qparams = quantize_so3_params(params, serve.mode)
        self._quant_vec = serve.vectors_quantized
        self._codebook = (make_codebook(model_cfg.dir_bits,
                                        device=self.device)
                          if self._quant_vec else None)
        self._buckets = serve.buckets()
        # batches dispatched per path; "sparse_fallback" counts batches a
        # sparse-preferring config had to run dense (edge-capacity overflow)
        self.dispatch_stats = {"dense": 0, "sparse": 0, "sparse_fallback": 0}

    @classmethod
    def from_config(cls, model_cfg: So3kratesConfig,
                    params: Optional[Dict[str, torch.Tensor]] = None,
                    serve: ServeConfig = ServeConfig(), seed: int = 0,
                    device: DeviceLike = None,
                    guardrails: Optional[GuardrailConfig] = None
                    ) -> "QuantizedEngine":
        """Build from a model config and fp32 params (``init_params(seed)``
        when None)."""
        device = resolve_device(device)
        if params is None:
            params = init_params(model_cfg, seed, device)
        return cls(model_cfg, params, serve, device=device,
                   guardrails=guardrails)

    # -- introspection ------------------------------------------------------

    def memory_report(self) -> Dict[str, float]:
        served = serving_bytes(self.qparams)
        return {"fp32_bytes": self._fp32_bytes, "served_bytes": served,
                "compression_x": round(self._fp32_bytes / max(served, 1), 2)}

    def stats_snapshot(self) -> Dict[str, int]:
        return dict(self.dispatch_stats)

    def reset_stats(self) -> Dict[str, int]:
        """Zero the dispatch counters, returning the pre-reset snapshot."""
        snap = self.stats_snapshot()
        for k in self.dispatch_stats:
            self.dispatch_stats[k] = 0
        return snap

    # -- serving ------------------------------------------------------------

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               batch_sizes: Optional[Sequence[int]] = None) -> float:
        """Run every admissible (bucket, batch class) shape once on every
        path this config can dispatch (dense always: it is the overflow
        fallback), which builds the CUDA kernels on first use. There is no
        compilation per shape. Returns the seconds spent."""
        t0 = time.monotonic()
        caps = list(buckets) if buckets else [b.capacity
                                              for b in self._buckets]
        for cap in caps:
            spec = next(b for b in self._buckets if b.capacity == cap)
            sizes = (list(batch_sizes) if batch_sizes else
                     sorted({spec.batch_class(n)
                             for n in range(1, spec.max_batch + 1)}))
            for bsz in sizes:
                species = np.zeros((bsz, cap), np.int32)
                coords = np.zeros((bsz, cap, 3), np.float32)
                mask = np.zeros((bsz, cap), bool)
                self._run_dense(species, coords, mask)
                if self._wants_sparse(spec):
                    el = build_edge_list(coords, mask, self.model_cfg.cutoff,
                                         spec.edges)
                    self._run_sparse(species, coords, mask, el)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic() - t0

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_dense(self, species, coords, mask):
        arrays = [self._on_device(a) for a in (species, coords, mask)]
        return batched_energy_and_forces(
            self.qparams, self.model_cfg, *arrays, self._codebook,
            quant_vectors=self._quant_vec, mddq_kernel=self.serve.mddq_kernel)

    def _run_sparse(self, species, coords, mask, el):
        arrays = [self._on_device(a) for a in (
            species, coords, mask, el.senders, el.receivers, el.edge_mask)]
        return sparse_energy_and_forces(
            self.qparams, self.model_cfg, *arrays, self._codebook,
            quant_vectors=self._quant_vec, mddq_kernel=self.serve.mddq_kernel)

    def _sparse_profitable(self, spec: BucketSpec) -> bool:
        """n^2 pairwise work >= 4x the padded edge slots."""
        return spec.capacity ** 2 >= self._SPARSE_PROFIT_FACTOR * spec.edges

    def _wants_sparse(self, spec: BucketSpec) -> bool:
        if self.serve.path == "sparse":
            return True
        return self.serve.path == "auto" and self._sparse_profitable(spec)

    def _dispatch(self, species, coords, mask, spec: BucketSpec):
        """Run one padded batch down the configured path. Returns
        (energies, forces, path_taken)."""
        if self._wants_sparse(spec):
            el = build_edge_list(coords, mask, self.model_cfg.cutoff,
                                 spec.edges)
            if el is not None:
                self.dispatch_stats["sparse"] += 1
                e, f = self._run_sparse(species, coords, mask, el)
                return e, f, "sparse"
            self.dispatch_stats["sparse_fallback"] += 1
        self.dispatch_stats["dense"] += 1
        e, f = self._run_dense(species, coords, mask)
        return e, f, "dense"

    def infer_batch(self, graphs: Sequence[Graph],
                    on_flag: Optional[str] = None) -> List[MoleculeResult]:
        """Energies and forces for a heterogeneous list of molecules, in
        input order with padding stripped, after the guardrails: a fatal
        flag raises :class:`GuardrailViolation` (``on_flag="raise"``, the
        default) or is attached to the result (``"mark"``)."""
        results = self._infer_raw(graphs)
        g = self.guardrails
        if not g.active:
            return results
        flagged = {}
        for i, r in enumerate(results):
            flags = check_result(r.energy, r.forces, r.bucket_capacity, g)
            if flags:
                flagged[i] = flags
        if not flagged:
            return results
        if (on_flag if on_flag is not None else g.on_flag) == "raise":
            worst = max((f for fl in flagged.values() for f in fl),
                        key=lambda f: f.fatal)
            raise GuardrailViolation(
                f"guardrail {worst.reason} on {len(flagged)}/{len(results)} "
                f"molecule(s) (mode={self.serve.mode})", reason=worst.reason,
                severity=worst.severity,
                detail={"value": worst.value, "limit": worst.limit,
                        "mode": self.serve.mode})
        return [dataclasses.replace(r, flags=flagged[i]) if i in flagged
                else r for i, r in enumerate(results)]

    def _infer_raw(self, graphs: Sequence[Graph]) -> List[MoleculeResult]:
        plans = plan_batches(graphs, self._buckets)
        results: List[Optional[MoleculeResult]] = [None] * len(graphs)
        for plan in plans:
            species, coords, mask = pad_graphs(
                graphs, plan, pad_species=self.serve.pad_species)
            e, f, path = self._dispatch(species, coords, mask, plan.bucket)
            e = e.cpu().numpy()              # device -> host: the sync point
            f = f.cpu().numpy()
            for row, gi in enumerate(plan.graph_indices):
                n = graphs[gi].n_atoms
                results[gi] = MoleculeResult(
                    energy=float(e[row]), forces=f[row, :n], n_atoms=n,
                    bucket_capacity=plan.bucket.capacity,
                    batch_size=plan.batch_size, path=path)
        return results  # type: ignore[return-value]

    # -- MD bridge ----------------------------------------------------------

    def md_engine(self, md=None):
        """A :class:`repro_torch.md.MDEngine` on this engine's device that
        shares its quantized weights and codebook: serve traffic and run
        MD off one set of serving-format parameters. ``md`` is an
        ``MDConfig`` whose ``mode`` must match (default: one built from
        this engine's mode)."""
        from repro_torch.md.engine import MDConfig, MDEngine
        if md is None:
            md = MDConfig(mode=self.serve.mode)
        if md.mode != self.serve.mode:
            raise ValueError(
                f"MDConfig.mode {md.mode!r} != ServeConfig.mode "
                f"{self.serve.mode!r}: the quantized weights are shared")
        return MDEngine(self.model_cfg, md=md, qparams=self.qparams,
                        codebook=self._codebook, device=self.device)

    # -- diagnostics --------------------------------------------------------

    def edge_occupancy(self, graphs: Sequence[Graph]) -> Dict[str, float]:
        """How full the sparse path's edge slots would be for this traffic:
        per-plan real-edge counts against capacity (for sizing
        ``ServeConfig.edge_capacity``)."""
        occ, overflow = [], 0
        for plan in plan_batches(graphs, self._buckets):
            _, coords, mask = pad_graphs(graphs, plan,
                                         pad_species=self.serve.pad_species)
            counts = count_edges(coords, mask, self.model_cfg.cutoff)
            cap_e = plan.bucket.edges
            occ.append(float(counts.max()) / cap_e)
            overflow += int((counts > cap_e).sum())
        return {"max_occupancy": max(occ) if occ else 0.0,
                "mean_occupancy": float(np.mean(occ)) if occ else 0.0,
                "molecules_overflowing": overflow}

    def lee_diagnostic(self, graphs: Sequence[Graph], seed: int = 0,
                       n_rotations: int = 4,
                       rotations: Optional[np.ndarray] = None
                       ) -> Dict[str, float]:
        """Local Equivariance Error of the served model,
        || F(R.G) - R F(G) || per molecule, over ``rotations`` ((n, 3, 3),
        e.g. the JAX package's) or else ``n_rotations`` Haar rotations
        drawn from ``seed`` (``core.lee.random_rotations``). Coordinates
        and rotations are float32 and rotate in float32, as in the JAX
        package. Padded atoms are excluded: their forces are exactly zero
        on both sides."""
        rots = (random_rotations(seed, n_rotations) if rotations is None
                else np.asarray(rotations, np.float32))
        base = self._infer_raw(graphs)
        errs = []
        for R in rots:
            rotated = [Graph(g.species,
                             np.asarray(g.coords, np.float32) @ R.T)
                       for g in graphs]
            for r0, r1 in zip(base, self._infer_raw(rotated)):
                errs.append(float(np.linalg.norm(
                    r1.forces - r0.forces @ R.T)))
        return {"lee_mean": float(np.mean(errs)),
                "lee_max": float(np.max(errs)),
                "n_rotations": len(rots), "n_graphs": len(graphs)}
