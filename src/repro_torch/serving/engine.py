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
kernel runs its plain PyTorch version). On the card each shape class,
(path, batch rows, bucket[, edge slots]), is served by a captured
program (``repro_torch.captured``), the counterpart of the JAX engine's
jitted forwards: the forward and its autograd backward (the forces) as
one CUDA graph, captured in ``warmup`` or, for a shape warmup did not
cover, on its first dispatch (timed into
``engine_warmup_compile_seconds``, as a jit compile is), and replayed
after that. Host prep, the edge list, the host-to-device copies and the
guardrails stay outside the graph. The CPU runs the same forward
functions eagerly (:meth:`QuantizedEngine._eager_dense`,
:meth:`QuantizedEngine._eager_sparse`, also the body a capture
records). ``from_quantized`` builds it
from serving-format weights with no fp32 tree (the packed-artifact cold
start, ``server.artifact``); ``md_engine()`` hands the quantized weights
and codebook to an ``md.MDEngine``. The serving hooks the scheduler
reads are the JAX engine's: ``last_infer_breakdown``, ``warmup_report``,
``guard_stats`` (with the sampled LEE probe of the guardrails) and the
registry counters of ``obs.metrics``; ``compiled_shapes`` holds the
captured shape classes, as the JAX engine's holds its compiled ones
(empty on the CPU, which captures nothing), and ``shapes_seen`` every
shape class run on either device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.captured import CapturedProgram, new_pool
from repro_torch.core.codebook import make_codebook
from repro_torch.core.lee import random_rotations
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.guardrails import (Flag, GuardrailConfig,
                                    GuardrailViolation, check_result)
from repro_torch.models.so3krates import So3kratesConfig, init_params
from repro_torch.obs.metrics import REGISTRY
from repro_torch.serving.bucketing import (BucketSpec, Graph,
                                           build_edge_list, count_edges,
                                           pad_graphs, plan_batches)
from repro_torch.serving.forward import (batched_energy_and_forces,
                                         sparse_energy_and_forces)
from repro_torch.serving.qparams import (QTensor, QuantizedParams,
                                         fp32_bytes, quantize_so3_params,
                                         serving_bytes, serving_fp32_equiv)

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
    # which cluster replica served the batch (0 outside a cluster)
    replica_id: int = 0
    # content tag of the packed artifact the serving weights came from
    # ("" for engines built straight from fp32 params)
    artifact_version: str = ""
    flags: tuple = ()        # guardrail Flags that fired (mode "mark")
    # precision-escalation audit trail (guardrails.EscalationRecord)
    escalations: tuple = ()
    # the request trace this result answers ("" when tracing is off or
    # the result came from a direct infer_batch call)
    trace_id: str = ""


def _to_device(v, device: torch.device):
    if isinstance(v, QTensor):
        return QTensor(v.kind, v.data.to(device),
                       None if v.scale is None else v.scale.to(device))
    return v.to(device)


class QuantizedEngine:
    """Batched quantized-inference engine for the SO3krates force field."""

    # "auto" dispatches sparse only when the dense pairwise work is at
    # least this many times the padded edge-slot count (the JAX package's
    # heuristic, kept so both packages dispatch alike)
    _SPARSE_PROFIT_FACTOR = 4

    def __init__(self, model_cfg: So3kratesConfig,
                 params: Optional[Dict[str, torch.Tensor]],
                 serve: ServeConfig, *,
                 qparams: Optional[QuantizedParams] = None,
                 fp32_nbytes: Optional[int] = None,
                 device: DeviceLike = None, artifact_version: str = "",
                 guardrails: Optional[GuardrailConfig] = None):
        """Quantize fp32 ``params`` for ``serve.mode``, or take
        serving-format ``qparams`` as they are (exactly one of the two),
        and place weights and codebook on ``device`` (None = the CUDA
        device, or raise). ``fp32_nbytes`` carries the fp32 footprint for
        ``memory_report`` when no fp32 tree exists; ``artifact_version``
        is echoed into every :class:`MoleculeResult`."""
        if (params is None) == (qparams is None):
            raise ValueError("pass exactly one of params / qparams")
        self.model_cfg = model_cfg
        self.serve = serve
        self.device = resolve_device(device)
        self.artifact_version = artifact_version
        self.guardrails = (guardrails if guardrails is not None
                           else GuardrailConfig())
        if qparams is None:
            params = {k: v.to(self.device) for k, v in params.items()}
            self._fp32_bytes = fp32_bytes(params)
            self.qparams = quantize_so3_params(params, serve.mode)
        else:
            self._fp32_bytes = (fp32_nbytes if fp32_nbytes is not None
                                else serving_fp32_equiv(qparams))
            self.qparams = {k: _to_device(v, self.device)
                            for k, v in qparams.items()}
        self._quant_vec = serve.vectors_quantized
        self._codebook = (make_codebook(model_cfg.dir_bits,
                                        device=self.device)
                          if self._quant_vec else None)
        self._buckets = serve.buckets()
        # batches dispatched per path; "sparse_fallback" counts batches a
        # sparse-preferring config had to run dense (edge-capacity overflow)
        self.dispatch_stats = {"dense": 0, "sparse": 0, "sparse_fallback": 0}
        # guardrail telemetry: molecules checked / flagged per detector,
        # LEE probes run (counts advance only when guardrails.active)
        self.guard_stats = {"checked": 0, "flagged_nonfinite": 0,
                            "flagged_outlier": 0, "flagged_lee": 0,
                            "lee_probes": 0}
        self._n_infer_calls = 0             # LEE probe sampling counter
        # every (path, shape) the forwards have run, and those captured
        # as programs (the JAX engine's compiled_shapes; on the card both
        # hold the same classes, and steady traffic after warmup adds
        # none)
        self.shapes_seen = set()
        self.compiled_shapes = set()
        self._programs: Dict[tuple, CapturedProgram] = {}
        self._graph_pool = None
        self._warming = False
        # the registry carries the same counts under the JAX names and
        # labels, accumulating across engines; the dicts above stay the
        # per-engine view that reset_stats zeroes
        self._m_dispatch = {
            k: REGISTRY.counter("engine_dispatch_total",
                                mode=serve.mode, path=k)
            for k in self.dispatch_stats}
        self._m_guard = {
            k: REGISTRY.counter("engine_guard_total",
                                mode=serve.mode, event=k)
            for k in self.guard_stats}
        # per-(bucket, batch_size, path) warmup accounting and the last
        # _infer_raw stage breakdown (read by the scheduler's worker)
        self.warmup_report: List[Dict] = []
        self.last_infer_breakdown: Dict[str, float] = {}

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

    @classmethod
    def from_quantized(cls, model_cfg: So3kratesConfig,
                       qparams: QuantizedParams, serve: ServeConfig,
                       fp32_nbytes: Optional[int] = None,
                       device: DeviceLike = None, artifact_version: str = "",
                       guardrails: Optional[GuardrailConfig] = None
                       ) -> "QuantizedEngine":
        """Build from serving-format parameters (``quantize_so3_params``'
        output, or a packed artifact's): no fp32 tree, no quantization
        pass."""
        return cls(model_cfg, None, serve, qparams=qparams,
                   fp32_nbytes=fp32_nbytes, device=device,
                   artifact_version=artifact_version, guardrails=guardrails)

    # -- introspection ------------------------------------------------------

    def memory_report(self) -> Dict[str, float]:
        served = serving_bytes(self.qparams)
        return {"fp32_bytes": self._fp32_bytes, "served_bytes": served,
                "compression_x": round(self._fp32_bytes / max(served, 1), 2)}

    def stats_snapshot(self) -> Dict[str, int]:
        return dict(self.dispatch_stats)

    def guard_snapshot(self) -> Dict[str, int]:
        """Copy of the guardrail counters (checked/flagged per detector,
        LEE probes run)."""
        return dict(self.guard_stats)

    def reset_stats(self) -> Dict[str, int]:
        """Zero the dispatch and guardrail counters, returning the
        pre-reset dispatch snapshot."""
        snap = self.stats_snapshot()
        for stats in (self.dispatch_stats, self.guard_stats):
            for k in stats:
                stats[k] = 0
        return snap

    # -- serving ------------------------------------------------------------

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               batch_sizes: Optional[Sequence[int]] = None) -> float:
        """Run every admissible (bucket, batch class) shape once on every
        path this config can dispatch (dense always: it is the overflow
        fallback), which builds the CUDA kernels on first use, and on the
        card captures each as a program (the run is the capture's eager
        warm-up). Returns the seconds spent; ``warmup_report`` holds one
        entry per (bucket, batch size, path), each ended by a
        synchronize."""
        t0 = time.monotonic()
        self.warmup_report = []

        def timed(path: str, cap: int, bsz: int, fn) -> None:
            s0 = time.monotonic()
            fn()
            self._sync()
            dt = time.monotonic() - s0
            self.warmup_report.append(
                {"bucket": cap, "batch_size": bsz, "path": path,
                 "mode": self.serve.mode, "seconds": dt, "t0": s0})
            REGISTRY.histogram("engine_warmup_compile_seconds",
                               mode=self.serve.mode, path=path).observe(dt)

        caps = list(buckets) if buckets else [b.capacity
                                              for b in self._buckets]
        self._warming = True
        try:
            self._warm(caps, batch_sizes, timed)
        finally:
            self._warming = False
        total = time.monotonic() - t0
        REGISTRY.counter("engine_warmup_seconds_total",
                         mode=self.serve.mode).inc(total)
        return total

    def _warm(self, caps, batch_sizes, timed) -> None:
        for cap in caps:
            spec = next(b for b in self._buckets if b.capacity == cap)
            sizes = (list(batch_sizes) if batch_sizes else
                     sorted({spec.batch_class(n)
                             for n in range(1, spec.max_batch + 1)}))
            for bsz in sizes:
                species = np.zeros((bsz, cap), np.int32)
                coords = np.zeros((bsz, cap, 3), np.float32)
                mask = np.zeros((bsz, cap), bool)
                timed("dense", cap, bsz,
                      lambda: self._run_dense(species, coords, mask))
                if self._wants_sparse(spec):
                    el = build_edge_list(coords, mask, self.model_cfg.cutoff,
                                         spec.edges)
                    timed("sparse", cap, bsz,
                          lambda: self._run_sparse(species, coords, mask, el))

    def _sync(self) -> None:
        """Wait for this engine's own work: the current stream of its
        device (a cluster replica's stream), not the whole card, which
        other replicas share."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _eager_dense(self, species, coords, mask):
        """The dense forward and its backward on device tensors: the CPU's
        path and the body of a dense program."""
        return batched_energy_and_forces(
            self.qparams, self.model_cfg, species, coords, mask,
            self._codebook, quant_vectors=self._quant_vec,
            mddq_kernel=self.serve.mddq_kernel)

    def _eager_sparse(self, species, coords, mask, senders, receivers,
                      edge_mask):
        """The sparse forward and its backward on device tensors: the
        CPU's path and the body of a sparse program."""
        return sparse_energy_and_forces(
            self.qparams, self.model_cfg, species, coords, mask, senders,
            receivers, edge_mask, self._codebook,
            quant_vectors=self._quant_vec,
            mddq_kernel=self.serve.mddq_kernel)

    def _run_dense(self, species, coords, mask):
        key = ("dense",) + species.shape
        return self._run(key, self._eager_dense, dict(
            species=species, coords=coords, mask=mask))

    def _run_sparse(self, species, coords, mask, el):
        key = ("sparse",) + species.shape + (el.edge_capacity,)
        return self._run(key, self._eager_sparse, dict(
            species=species, coords=coords, mask=mask, senders=el.senders,
            receivers=el.receivers, edge_mask=el.edge_mask))

    def _run(self, key: tuple, eager, arrays: Dict[str, np.ndarray]):
        """One padded batch of shape class ``key``: eager on the CPU; on
        the card the class's program replayed, or captured first (timed
        into ``engine_warmup_compile_seconds``, as the JAX engine's jit
        compiles a shape on first call)."""
        self.shapes_seen.add(key)
        host = {k: torch.from_numpy(a) for k, a in arrays.items()}
        if self.device.type != "cuda":
            return eager(**host)
        prog = self._programs.get(key)
        if prog is not None:
            return prog.replay(**host)
        s0 = time.monotonic()
        prog = self._capture(key, eager, host)
        if not self._warming:        # warmup times its own entries
            REGISTRY.histogram("engine_warmup_compile_seconds",
                               mode=self.serve.mode,
                               path=key[0]).observe(time.monotonic() - s0)
        return prog.first_result

    def _eager_run(self, key: tuple, eager, arrays: Dict[str, np.ndarray]):
        """:meth:`_run` without programs: the eager forward on the
        engine's device (the CPU's path; on the card for comparisons)."""
        self.shapes_seen.add(key)
        return eager(**{k: torch.from_numpy(a).to(self.device)
                        for k, a in arrays.items()})

    def _capture(self, key: tuple, eager, host) -> CapturedProgram:
        """Capture shape class ``key``'s program (its eager warm-up runs
        on ``host``'s values) into the engine's graph pool."""
        if self._graph_pool is None:
            self._graph_pool = new_pool()
        prog = CapturedProgram(eager, host, device=self.device,
                               pool=self._graph_pool,
                               name=f"the {self.serve.mode} engine's "
                                    f"{key} program")
        self._programs[key] = prog
        self.compiled_shapes.add(key)
        return prog


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
                self._count_dispatch("sparse")
                e, f = self._run_sparse(species, coords, mask, el)
                return e, f, "sparse"
            self._count_dispatch("sparse_fallback")
        self._count_dispatch("dense")
        e, f = self._run_dense(species, coords, mask)
        return e, f, "dense"

    def _count_dispatch(self, path: str) -> None:
        self.dispatch_stats[path] += 1
        self._m_dispatch[path].inc()

    def _count_guard(self, event: str, n: int = 1) -> None:
        self.guard_stats[event] += n
        self._m_guard[event].inc(n)

    def infer_batch(self, graphs: Sequence[Graph],
                    on_flag: Optional[str] = None) -> List[MoleculeResult]:
        """Energies and forces for a heterogeneous list of molecules, in
        input order with padding stripped, after the guardrails
        (non-finite values, the force envelope, and every
        ``lee_probe_every``-th call the sampled LEE probe): a fatal flag
        raises :class:`GuardrailViolation` (``on_flag="raise"``, the
        default) or is attached to the result (``"mark"``, the
        scheduler's)."""
        results = self._infer_raw(graphs)
        g = self.guardrails
        if not g.active:
            return results
        self._n_infer_calls += 1
        self._count_guard("checked", len(results))
        flagged: Dict[int, tuple] = {}
        for i, r in enumerate(results):
            flags = check_result(r.energy, r.forces, r.bucket_capacity, g)
            if flags:
                flagged[i] = flags
        if g.lee_probe_every > 0 \
                and self._n_infer_calls % g.lee_probe_every == 0:
            for i, flag in self._lee_probe(graphs, results):
                flagged[i] = flagged.get(i, ()) + (flag,)
        if not flagged:
            return results
        for flags in flagged.values():
            for f in flags:
                event = {"nonfinite": "flagged_nonfinite",
                         "force_outlier": "flagged_outlier",
                         "lee": "flagged_lee"}.get(f.reason)
                if event is not None:
                    self._count_guard(event)
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
        """Plan, pad, dispatch and copy back, with no guardrail pass: also
        the re-run path of the LEE probe and ``lee_diagnostic``."""
        t_start = time.monotonic()
        plans = plan_batches(graphs, self._buckets)
        prep_s = dispatch_s = sync_s = 0.0
        results: List[Optional[MoleculeResult]] = [None] * len(graphs)
        for plan in plans:
            t0 = time.monotonic()
            species, coords, mask = pad_graphs(
                graphs, plan, pad_species=self.serve.pad_species)
            t1 = time.monotonic()
            e, f, path = self._dispatch(species, coords, mask, plan.bucket)
            t2 = time.monotonic()
            e = e.cpu().numpy()              # device -> host: the sync point
            f = f.cpu().numpy()
            t3 = time.monotonic()
            prep_s += t1 - t0
            dispatch_s += t2 - t1
            sync_s += t3 - t2
            for row, gi in enumerate(plan.graph_indices):
                n = graphs[gi].n_atoms
                results[gi] = MoleculeResult(
                    energy=float(e[row]), forces=f[row, :n], n_atoms=n,
                    bucket_capacity=plan.bucket.capacity,
                    batch_size=plan.batch_size, path=path,
                    artifact_version=self.artifact_version)
        # read by the scheduler's worker right after infer_batch returns,
        # on the same thread
        self.last_infer_breakdown = {
            "prep_s": prep_s, "dispatch_s": dispatch_s, "sync_s": sync_s,
            "n_plans": len(plans), "total_s": time.monotonic() - t_start}
        return results  # type: ignore[return-value]

    def _probe_rotation(self, n: int) -> np.ndarray:
        """The LEE probe's rotation for the engine's n-th guarded call: a
        float32 Haar rotation drawn with numpy from ``lee_seed + n`` (the
        JAX engine draws from ``PRNGKey(lee_seed + n)``, which the port
        does not reproduce; a parity test substitutes that R here)."""
        return random_rotations(self.guardrails.lee_seed + n, 1)[0]

    def _lee_probe(self, graphs: Sequence[Graph],
                   results: Sequence[MoleculeResult]):
        """Sampled equivariance check: re-run the batch under one rotation
        and compare rotated against counter-rotated forces (paper Eq. 1,
        online). Float32 coordinates rotate by a float32 R, as in
        ``lee_diagnostic``. Returns ``(index, Flag)`` pairs for molecules
        whose LEE exceeds the limit, and sets the
        ``engine_lee_probe_level`` gauge to the worst LEE over the
        limit."""
        g = self.guardrails
        self._count_guard("lee_probes")
        R = np.asarray(self._probe_rotation(self._n_infer_calls), np.float32)
        rotated = [Graph(gr.species, np.asarray(gr.coords, np.float32) @ R.T)
                   for gr in graphs]
        first = self.last_infer_breakdown
        rerun = self._infer_raw(rotated)
        # the call's breakdown covers both runs, as its wall time does
        self.last_infer_breakdown = {
            k: first[k] + v for k, v in self.last_infer_breakdown.items()}
        out = []
        level = 0.0
        for i, (r0, r1) in enumerate(zip(results, rerun)):
            if not np.isfinite(r0.forces).all():
                continue            # non-finite is already flagged fatal
            err = float(np.linalg.norm(r1.forces - r0.forces @ R.T))
            if np.isfinite(err):
                level = max(level, err / max(g.lee_limit, 1e-12))
            if not np.isfinite(err) or err > g.lee_limit:
                out.append((i, Flag("lee", "suspect", value=err,
                                    limit=g.lee_limit)))
        REGISTRY.gauge("engine_lee_probe_level",
                       mode=self.serve.mode).set(level)
        return out

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
