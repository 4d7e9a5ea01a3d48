"""Replica pool + shape-class-aware router: counterpart of
``repro/cluster/pool.py``.

``ClusterPool`` stands up N :class:`~repro_torch.cluster.replica.Replica`\\ s
— one :class:`~repro_torch.serving.engine.QuantizedEngine` per device,
``cuda:0..k-1`` round robin (:func:`pick_devices`: on one card every
replica is on ``cuda:0``, each with its own stream; with ``device="cpu"``
every replica is on the CPU) — behind one ``submit()`` that looks exactly
like the single-engine ``MicroBatchScheduler``'s, so the traffic replays
in ``repro_torch.server.traffic`` run unchanged against either.

**Routing** (``_route``) is join-shortest-queue with bucket affinity:

1. replicas whose queue is at ``max_queue`` are ineligible; if none is
   eligible the request is **shed** with ``SchedulerOverloaded`` and a
   ``retry_after_s`` hint (bounded admission — under overload the pool
   refuses loudly rather than queueing without bound);
2. among eligible replicas, candidates are those within
   ``affinity_slack`` of the shortest queue (the JSQ core: load
   balance first);
3. among candidates, prefer the replica already holding queued requests
   of the *same shape class* (batches fill faster and flush "full"
   instead of waiting out the deadline), then the shape class's static
   home replica (so a lightly loaded cluster keeps each bucket's
   compiled shapes hot on the same engine), then the shortest queue.

**Rolling hot swap** (``swap_artifact``): load a packed artifact once
(checksums verified), then for each replica — one at a time, the rest
keep serving — build a new engine on that replica's device from the
already-deserialized weights, *warm it up* on the replica's stream
(ending in a synchronize of that stream, so the first flush after the
exchange reads weights that are on the card), and exchange engines
under the replica's flush lock. The in-flight flush finishes on the old
weights; everything after runs the new ones; zero requests are dropped
and the artifact's content tag is stamped into every subsequent
result's ``artifact_version``.

**Failover**: a replica that dies (injected ``kill_replica`` or a real
engine exception) hands its queued and in-flight handles back to the
pool, which requeues them onto surviving replicas — a request is only
resolved with the replica's error after ``max_requeues`` failovers, or
when no survivor remains. ``stats()`` merges per-replica heartbeat
snapshots with router counters and the shared flush telemetry.

**Guardrails** (the JAX package's docs/guardrails.md): a pool may mix
precision tiers (``from_tiers`` — w4a8 traffic replicas backed by
w8a8/fp32 escalation replicas running singleton flushes). A flush
result whose engine-side detectors fired is triaged through
:meth:`_on_flagged`: re-run one tier up (audit trail in
``MoleculeResult.escalations``, bounded by ``max_escalations``), else a
typed ``GuardrailViolation`` (fatal) or
annotated delivery (suspect). A watchdog thread quarantines replicas
whose worker stalls past ``stall_timeout_s`` or whose sliding-window
flagged rate trips the circuit breaker: handles are expropriated and
requeued (zero lost), the engine cold-restarts on the same device, and
the replacement serves again only after ``probation_s``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.cluster.replica import ChunkHandle, Replica, ReplicaFailed
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.guardrails import (EscalationRecord, GuardrailConfig,
                                    GuardrailViolation, tier_rank)
from repro_torch.models.so3krates import So3kratesConfig, init_params
from repro_torch.obs.metrics import REGISTRY
from repro_torch.serving.bucketing import Graph, assign_bucket
from repro_torch.serving.engine import (MoleculeResult, QuantizedEngine,
                                        ServeConfig)
from repro_torch.serving.qparams import fp32_bytes, quantize_so3_params
from repro_torch.server.artifact import (ArtifactError, ensure_mode_matches,
                                         load_artifact)
from repro_torch.server.scheduler import (RequestHandle, SchedulerClosed,
                                          SchedulerConfig,
                                          SchedulerOverloaded)
from repro_torch.server.stats import flush_summary
from repro_torch.weights import qparams_from_numpy

__all__ = ["ClusterConfig", "ClusterPool", "pick_devices"]


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Pool-level knobs. Batch formation inside each replica follows the
    same ``max_batch``/``deadline_ms`` semantics as ``SchedulerConfig``
    (it *is* the same ``BatchQueue`` policy)."""
    n_replicas: int = 2
    max_batch: int = 8
    deadline_ms: float = 20.0
    warmup: bool = True          # replicas pre-compile before serving
    # bounded admission per replica; the pool sheds when every live
    # replica is at the bound (None = unbounded)
    max_queue: Optional[int] = None
    # JSQ slack: a replica may be preferred for shape-class affinity as
    # long as its queue is within this many requests of the shortest
    affinity_slack: int = 2
    # failovers a single request may survive before its error resolves
    max_requeues: int = 2
    # -- guardrails / tiered escalation (all defaults keep them off) --
    # precision-tier re-runs one flagged request may receive before its
    # replica resolves it locally (typed error for fatal, annotated
    # delivery for suspect)
    max_escalations: int = 1
    # sliding window of recent flush results each replica keeps for the
    # circuit breaker (0 = keep none)
    breaker_window: int = 20
    # breaker trip condition: flagged fraction of the window above this
    # rate (None = breaker off), evaluated only once the window holds at
    # least breaker_min_events results — a single flagged request on a
    # cold window must not quarantine a healthy replica
    breaker_flag_rate: Optional[float] = None
    breaker_min_events: int = 10
    # a quarantined replica's respawned engine serves again only after
    # this probation hold (its warmup typically overlaps it)
    probation_s: float = 5.0
    # pool watchdog: a worker busy on one unit of work longer than this
    # is declared stalled and quarantined (None = watchdog off)
    stall_timeout_s: Optional[float] = None
    watchdog_interval_s: float = 0.25
    # quarantines one replica id may survive before it is left dead
    # (a replica that keeps tripping is hardware/weights, not luck)
    max_quarantines: int = 2

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.affinity_slack < 0:
            raise ValueError("affinity_slack must be >= 0")
        if self.max_escalations < 0:
            raise ValueError("max_escalations must be >= 0")
        if self.breaker_window < 0:
            raise ValueError("breaker_window must be >= 0")
        if self.breaker_flag_rate is not None \
                and not (0.0 <= self.breaker_flag_rate <= 1.0):
            raise ValueError("breaker_flag_rate must be in [0, 1] or None")
        if self.stall_timeout_s is not None and self.stall_timeout_s <= 0:
            raise ValueError("stall_timeout_s must be > 0 or None")
        if self.watchdog_interval_s <= 0:
            raise ValueError("watchdog_interval_s must be > 0")

    def scheduler_config(self) -> SchedulerConfig:
        # warmup/max_queue are pool-driven (parallel warmup, router-side
        # shedding); the per-replica queue enforces the bound defensively
        return SchedulerConfig(max_batch=self.max_batch,
                               deadline_ms=self.deadline_ms,
                               warmup=False, max_queue=self.max_queue)


def pick_devices(n: int, device: DeviceLike = None) -> List[torch.device]:
    """Devices for ``n`` replicas: ``cuda:0..k-1`` round robin over the
    ``k`` cards, with a warning when fewer cards than replicas exist (on
    one card every replica is on ``cuda:0``, each with its own stream).
    An explicit ``device`` pins every replica to it (``"cpu"``: the plain
    path). With no card and no ``device`` it raises, as every entry point
    of the port does."""
    if device is not None:
        return [resolve_device(device)] * n
    resolve_device(None)                 # raises without a card
    k = torch.cuda.device_count()
    if k < n:
        warnings.warn(
            f"cluster wants {n} replicas but only {k} CUDA device(s) "
            "exist — replicas will share devices (one stream each)")
    return [torch.device("cuda", i % k) for i in range(n)]


def _settle(device: torch.device) -> None:
    """Wait for the calling thread's current stream on ``device``: the
    weight copies and quantization of an engine built on this thread are
    done before another thread's stream reads them."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class ClusterPool:
    """N device-pinned engine replicas behind one shape-aware router."""

    def __init__(self, engines: Sequence[QuantizedEngine],
                 cluster: ClusterConfig = ClusterConfig(),
                 wait_ready: bool = True):
        """Build from pre-constructed (already device-pinned) engines —
        one replica each; ``len(engines)`` overrides
        ``cluster.n_replicas``. Prefer the ``from_config`` /
        ``from_artifact`` constructors."""
        if not engines:
            raise ValueError("need at least one engine")
        # engines must agree on everything *except* precision mode: a
        # tiered fleet (w4a8 traffic replicas + w8a8/fp32 escalation
        # replicas) differs only in mode, so bucket ladders and batch
        # formation stay identical across the whole pool
        norm = {dataclasses.replace(e.serve, mode=engines[0].serve.mode)
                for e in engines}
        if len(norm) != 1:
            raise ValueError(
                "all replica engines must share one ServeConfig "
                "(precision mode may differ for a tiered fleet)")
        ranks = [tier_rank(e.serve.mode) for e in engines]
        self._primary_rank = min(ranks)
        # the pool's nominal serve is the primary (cheapest) tier's —
        # that is the tier ordinary traffic routes to
        self.serve = engines[ranks.index(self._primary_rank)].serve
        self.model_cfg = engines[0].model_cfg
        self.cluster = dataclasses.replace(cluster, n_replicas=len(engines))
        if cluster.max_batch > self.serve.max_batch:
            raise ValueError(
                f"ClusterConfig.max_batch {cluster.max_batch} exceeds "
                f"ServeConfig.max_batch {self.serve.max_batch}")
        self._buckets = self.serve.buckets()
        self._lock = threading.Lock()
        self._open = True
        self._n_routed = 0
        self._n_shed = 0
        self._n_requeued = 0
        self._n_failures = 0
        self._n_chunks_routed = 0
        self._n_chunks_requeued = 0
        self._routed_per_replica: Dict[int, int] = {}
        # extra stats() sections registered by higher layers (the
        # session manager attaches its recovery telemetry here so one
        # pool.stats() call shows the whole serving+sessions picture)
        self._stats_sources: Dict[str, object] = {}
        self._retry_cache = (0.0, 0.0)   # (monotonic stamp, estimate)
        # guardrail / escalation / quarantine telemetry
        self._n_flagged = 0
        self._n_escalated = 0
        self._n_escalation_failures = 0
        self._n_quarantined = 0
        self._n_respawned = 0
        self._n_permanent_deaths = 0
        self._n_stalls_detected = 0
        self._n_breaker_trips = 0
        self._quarantine_counts: Dict[int, int] = {}
        # fleet-lifetime accumulators for counters of engines this pool
        # retired (rolling swap_artifact exchanges, quarantine
        # cold-restarts): without these, stats() summed only the
        # *current* engines' dispatch/guardrail counters and every
        # exchange silently zeroed the fleet totals
        self._retired_dispatch: Dict[str, int] = {}
        self._retired_detectors: Dict[str, int] = {}
        self._n_engines_retired = 0
        # static bucket -> home replica map (affinity tie-break): spread
        # the ladder round-robin over *primary-tier* replicas so each
        # "owns" some shape classes (escalation replicas never get homes)
        primary_ids = [i for i, r in enumerate(ranks)
                       if r == self._primary_rank]
        caps = sorted(b.capacity for b in self._buckets)
        self._home = {cap: primary_ids[i % len(primary_ids)]
                      for i, cap in enumerate(caps)}
        sched_cfg = self.cluster.scheduler_config()
        # escalation tiers run singleton flushes (max_batch=1, zero
        # deadline, unbounded queue): an escalated re-run is then
        # bit-identical to a direct batch-of-1 call on that tier
        esc_cfg = SchedulerConfig(max_batch=1, deadline_ms=0.0,
                                  warmup=False, max_queue=None)
        self._replicas = [
            Replica(i, eng,
                    sched_cfg if ranks[i] == self._primary_rank else esc_cfg,
                    on_failure=self._on_replica_failure,
                    warmup=cluster.warmup,
                    on_flagged=self._on_flagged,
                    breaker_window=cluster.breaker_window)
            for i, eng in enumerate(engines)]
        # health-plane linkage (watch_alerts): recent alerts the pool
        # has been handed, surfaced under stats()["alerts"]
        self._alerts_seen: deque = deque(maxlen=64)
        self._n_alerts_seen = 0
        self._alert_unsub = None
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        if (cluster.stall_timeout_s is not None
                or cluster.breaker_flag_rate is not None):
            self._watchdog = threading.Thread(
                target=self._watch, name="cluster-watchdog", daemon=True)
            self._watchdog.start()
        self._publish_fleet_gauges()
        if wait_ready:
            self.wait_ready()

    # -- construction --------------------------------------------------------

    @classmethod
    def from_quantized(cls, model_cfg: So3kratesConfig, qparams,
                       serve: ServeConfig,
                       cluster: ClusterConfig = ClusterConfig(),
                       fp32_nbytes: Optional[int] = None,
                       devices: Optional[Sequence] = None,
                       artifact_version: str = "",
                       guardrails: Optional[GuardrailConfig] = None,
                       device: DeviceLike = None) -> "ClusterPool":
        """One engine per device from a single serving-format tree of
        tensors. Replicas on one device share its weight tensors (they
        are only read); ``devices`` (explicit) or :func:`pick_devices`
        with ``device`` place them."""
        if devices is None:
            devices = pick_devices(cluster.n_replicas, device)
        engines = [QuantizedEngine.from_quantized(
            model_cfg, qparams, serve, fp32_nbytes=fp32_nbytes,
            device=d, artifact_version=artifact_version,
            guardrails=guardrails) for d in devices]
        for d in set(devices):
            _settle(torch.device(d))
        return cls(engines, cluster)

    @classmethod
    def from_config(cls, model_cfg: So3kratesConfig,
                    params=None, serve: ServeConfig = ServeConfig(),
                    cluster: ClusterConfig = ClusterConfig(),
                    seed: int = 0,
                    devices: Optional[Sequence] = None,
                    guardrails: Optional[GuardrailConfig] = None,
                    device: DeviceLike = None) -> "ClusterPool":
        """Quantize fp32 params once (``init_params(seed)``, numpy, when
        None) on the first replica's device, replicate the serving tree
        across devices."""
        if devices is None:
            devices = pick_devices(cluster.n_replicas, device)
        base = QuantizedEngine.from_config(model_cfg, params=params,
                                           serve=serve, seed=seed,
                                           device=devices[0])
        return cls.from_quantized(
            model_cfg, base.qparams, serve, cluster,
            fp32_nbytes=base.memory_report()["fp32_bytes"], devices=devices,
            guardrails=guardrails)

    @classmethod
    def from_tiers(cls, model_cfg: So3kratesConfig, params=None,
                   serve: ServeConfig = ServeConfig(),
                   tier_plan: Optional[Dict[str, int]] = None,
                   cluster: ClusterConfig = ClusterConfig(),
                   seed: int = 0,
                   devices: Optional[Sequence] = None,
                   guardrails: Optional[GuardrailConfig] = None,
                   device: DeviceLike = None) -> "ClusterPool":
        """Mixed-precision fleet from ONE fp32 params tree (random init
        when None): ``tier_plan`` maps precision tier -> replica count,
        e.g. ``{"w4a8": 2, "w8a8": 1, "fp32": 1}`` — two cheap traffic
        replicas backed by one escalation replica each at w8a8 and fp32.
        Every tier is quantized from the *same* weights, so an escalated
        re-run answers the same model at higher precision. Replicas are
        ordered cheapest tier first (ids 0..N-1); ``devices`` (when
        given) must cover the total replica count, else
        :func:`pick_devices` places them (``device="cpu"``: all on the
        CPU). Random init draws with numpy from ``seed``
        (``init_params``), not with the JAX package's key: parity tests
        hand both packages the same numpy ``params``."""
        if tier_plan is None:
            tier_plan = {"w4a8": 2, "w8a8": 1, "fp32": 1}
        plan = sorted(tier_plan.items(), key=lambda kv: tier_rank(kv[0]))
        total = sum(n for _, n in plan)
        if total < 1:
            raise ValueError("tier_plan must place at least one replica")
        if devices is None:
            devices = pick_devices(total, device)
        elif len(devices) < total:
            raise ValueError(f"tier_plan wants {total} replicas but only "
                             f"{len(devices)} devices were given")
        if params is None:
            params = init_params(model_cfg, seed, devices[0])
        params = {k: v.to(devices[0]) for k, v in params.items()}
        nbytes = fp32_bytes(params)
        engines, i = [], 0
        for tier, n in plan:
            if n <= 0:
                continue
            qp = quantize_so3_params(params, tier)
            tier_serve = dataclasses.replace(serve, mode=tier)
            for _ in range(n):
                engines.append(QuantizedEngine.from_quantized(
                    model_cfg, qp, tier_serve, fp32_nbytes=nbytes,
                    device=devices[i], guardrails=guardrails))
                i += 1
        for d in set(devices):
            _settle(torch.device(d))
        return cls(engines, cluster)

    @classmethod
    def from_artifact(cls, path: str, serve: Optional[ServeConfig] = None,
                      cluster: ClusterConfig = ClusterConfig(),
                      devices: Optional[Sequence] = None,
                      device: DeviceLike = None) -> "ClusterPool":
        """Cold-start a whole pool from one packed artifact (written by
        either package): a single deserialize + checksum pass, then
        per-device replication."""
        if devices is None:
            devices = pick_devices(cluster.n_replicas, device)
        art = load_artifact(path)
        if serve is None:
            serve = art.serve
        else:
            ensure_mode_matches(art.serve.mode, serve.mode)
        return cls.from_quantized(
            art.model_cfg, qparams_from_numpy(art.qparams, devices[0]),
            serve, cluster, fp32_nbytes=art.fp32_bytes, devices=devices,
            artifact_version=art.version_tag)

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until every replica finished (parallel) warmup."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for r in self._replicas:
            left = None if deadline is None else max(deadline
                                                     - time.monotonic(), 0)
            if not r.ready.wait(left):
                raise TimeoutError(
                    f"replica {r.replica_id} not ready within {timeout}s")

    # -- client side ---------------------------------------------------------

    def submit(self, graph: Graph) -> RequestHandle:
        """Route one molecule to a replica. Raises like ``infer_batch``
        for off-ladder molecules, :class:`SchedulerClosed` when the pool
        is closed or no replica survives, :class:`SchedulerOverloaded`
        (with ``retry_after_s``) when bounded admission sheds."""
        handle = RequestHandle(graph, time.monotonic())
        try:
            handle.bucket_capacity = assign_bucket(graph.n_atoms,
                                                   self._buckets).capacity
            if handle.trace is not None:
                handle.trace.set_attr("bucket", handle.bucket_capacity)
            # a replica can die between routing and admission: re-route,
            # the alive set is re-read each attempt
            for _ in range(2 * len(self._replicas)):
                rep = self._route(handle.bucket_capacity)
                if rep.try_submit(handle):
                    with self._lock:
                        self._n_routed += 1
                        self._routed_per_replica[rep.replica_id] = (
                            self._routed_per_replica.get(
                                rep.replica_id, 0) + 1)
                    REGISTRY.counter("serve_requests_total",
                                     surface="pool",
                                     event="submitted").inc()
                    return handle
            with self._lock:
                self._n_shed += 1
            REGISTRY.counter("serve_requests_total", surface="pool",
                             event="shed").inc()
            raise SchedulerOverloaded(
                "no replica admitted the request (queues filled while "
                "routing)", self._retry_after())
        except BaseException as e:
            handle._reject(e)
            raise

    def submit_chunk(self, fn, bucket_capacity: int,
                     preferred_replica: Optional[int] = None,
                     session_id: str = "",
                     chunk_idx: int = 0,
                     min_tier: Optional[str] = None) -> ChunkHandle:
        """Route one session chunk (``fn(engine) -> result``) to a
        replica, under the same admission/affinity policy as one-shot
        traffic. ``bucket_capacity`` must be on the pool's bucket ladder
        (the session molecule's shape class — chunks share batch-affinity
        state with same-shape inference). ``preferred_replica`` is a
        stickiness hint: the replica that ran the previous chunk keeps
        the trajectory when it is live and below the admission bound,
        so device-resident arrays and compiled segment shapes stay warm;
        routing silently falls back to JSQ when it is not. Raises
        :class:`SchedulerOverloaded`/:class:`SchedulerClosed` exactly
        like :meth:`submit` — the session manager's typed
        retry-with-backoff handles sheds. ``min_tier`` routes the chunk
        to a replica at (or above) that precision tier — the session
        manager's guardrail escalation re-runs a flagged MD chunk one
        tier up through this."""
        if bucket_capacity not in self._home:
            raise ValueError(
                f"bucket_capacity {bucket_capacity} is not on the pool's "
                f"ladder {sorted(self._home)}")
        handle = ChunkHandle(fn, time.monotonic(),
                             bucket_capacity=bucket_capacity,
                             session_id=session_id, chunk_idx=chunk_idx)
        min_rank = (self._primary_rank if min_tier is None
                    else tier_rank(min_tier))
        mq = self.cluster.max_queue
        try:
            if preferred_replica is not None:
                for rep in self._replicas:
                    if (rep.replica_id == preferred_replica
                            and rep.accepting
                            and tier_rank(rep.tier) >= min_rank
                            and (mq is None or rep.depth() < mq)
                            and rep.try_submit(handle)):
                        with self._lock:
                            self._n_chunks_routed += 1
                            self._routed_per_replica[rep.replica_id] = (
                                self._routed_per_replica.get(
                                    rep.replica_id, 0) + 1)
                        return handle
            for _ in range(2 * len(self._replicas)):
                rep = self._route(handle.bucket_capacity, min_rank=min_rank)
                if rep.try_submit(handle):
                    with self._lock:
                        self._n_chunks_routed += 1
                        self._routed_per_replica[rep.replica_id] = (
                            self._routed_per_replica.get(
                                rep.replica_id, 0) + 1)
                    return handle
            with self._lock:
                self._n_shed += 1
            raise SchedulerOverloaded(
                "no replica admitted the chunk (queues filled while "
                "routing)", self._retry_after())
        except BaseException as e:
            handle._reject(e)
            raise

    def infer(self, graphs: Sequence[Graph],
              timeout: Optional[float] = None,
              timeout_s: Optional[float] = None) -> List[MoleculeResult]:
        """Convenience: submit all, wait for all (in input order).
        ``timeout_s`` raises the typed
        :class:`~repro_torch.server.scheduler.RequestTimeout` per request."""
        handles = [self.submit(g) for g in graphs]
        return [h.result(timeout=timeout, timeout_s=timeout_s)
                for h in handles]

    def close(self) -> None:
        """Stop admitting, drain every replica, join their workers."""
        with self._lock:
            if not self._open:
                return
            self._open = False
        if self._watchdog is not None:
            self._watchdog_stop.set()
            self._watchdog.join()
        if self._alert_unsub is not None:
            self._alert_unsub()
            self._alert_unsub = None
        for r in self._replicas:
            r.begin_close()
        for r in self._replicas:
            if not r._expropriated:   # an expropriated stuck worker may
                r.join()              # sleep past close — don't wait on it

    def __enter__(self) -> "ClusterPool":
        return self

    def __exit__(self, *exc):
        self.close()

    # -- routing -------------------------------------------------------------

    def _live(self) -> List[Replica]:
        return [r for r in self._replicas if r.accepting]

    def _retry_after(self) -> float:
        """Backoff hint for shed requests: about one flush's service
        time from recent telemetry, floored at the batching deadline.
        Cached for 0.5 s — sheds happen at the offered request rate
        during overload, exactly when per-shed replica-lock sweeps
        would contend with the serving workers."""
        now = time.monotonic()
        with self._lock:
            stamp, est = self._retry_cache
            if now - stamp < 0.5 and est > 0.0:
                return est
        recent = [s for r in self._replicas for s in r.recent_service_s()]
        est = (sum(recent) / len(recent)) if recent else 0.0
        est = max(est, self.cluster.deadline_ms * 1e-3, 0.01)
        with self._lock:
            self._retry_cache = (now, est)
        return est

    def _route(self, cap: int, ignore_bound: bool = False,
               min_rank: Optional[int] = None) -> Replica:
        """JSQ + bucket affinity over live replicas (see module doc).

        Tier selection: ordinary traffic (``min_rank=None``) routes to
        the primary (cheapest) tier; escalated work passes the minimum
        acceptable ``tier_rank``. Either way the *lowest* qualifying
        tier with a live replica is used — so when every primary
        replica is gone, traffic degrades up-tier (more precise, more
        expensive) rather than failing."""
        with self._lock:
            if not self._open:
                raise SchedulerClosed("cluster pool is closed")
        floor = self._primary_rank if min_rank is None else min_rank
        live = [r for r in self._live() if tier_rank(r.tier) >= floor]
        if not live:
            raise SchedulerClosed("no live replicas")
        lo = min(tier_rank(r.tier) for r in live)
        live = [r for r in live if tier_rank(r.tier) == lo]
        depths = {r.replica_id: r.depth() for r in live}
        mq = self.cluster.max_queue
        if mq is not None and not ignore_bound:
            ok = [r for r in live if depths[r.replica_id] < mq]
            if not ok:
                with self._lock:
                    self._n_shed += 1
                retry = self._retry_after()
                raise SchedulerOverloaded(
                    f"all {len(live)} live replica queues at max_queue="
                    f"{mq}: request shed (retry in ~{retry:.3f}s)", retry)
        else:
            ok = live
        d_min = min(depths[r.replica_id] for r in ok)
        cands = [r for r in ok
                 if depths[r.replica_id] <= d_min + self.cluster.affinity_slack]
        home = self._home.get(cap, 0)

        def preference(r: Replica):
            return (-r.depth_of(cap),                  # fill same-shape batches
                    0 if r.replica_id == home else 1,  # bucket's home replica
                    depths[r.replica_id],              # then shortest queue
                    r.replica_id)
        return min(cands, key=preference)

    # -- failover ------------------------------------------------------------

    def _on_replica_failure(self, rep: Replica,
                            orphans: List[RequestHandle],
                            error: BaseException) -> None:
        """Called from a dying replica's worker thread (no locks held):
        requeue its queued + in-flight handles onto survivors."""
        with self._lock:
            self._n_failures += 1
        REGISTRY.counter("pool_events_total",
                         event="replica_failure").inc()
        self._requeue_orphans(rep, orphans, error)

    def _requeue_orphans(self, rep: Replica, orphans: List[RequestHandle],
                         error: BaseException) -> None:
        """Requeue a dead/quarantined replica's handles onto survivors:
        same precision tier first, then (when none remains) the lowest
        live tier — a request is resolved with ``error`` only after
        ``max_requeues`` failovers or when no survivor admits it."""
        rep_rank = tier_rank(rep.tier)
        tries = ((rep_rank,) if rep_rank == self._primary_rank
                 else (rep_rank, self._primary_rank))
        for h in orphans:
            h.n_requeues += 1
            if h.n_requeues > self.cluster.max_requeues:
                if h.trace is not None:
                    h.trace.event("requeue_budget_exhausted",
                                  from_replica=rep.replica_id,
                                  n_requeues=h.n_requeues)
                h._resolve(error=error, replica_id=rep.replica_id)
                continue
            if h.trace is not None:
                # re-enter a queue *before* any survivor can pick the
                # handle: the hop's queue segment starts here (it
                # closes the dead replica's serve segment for in-flight
                # work; queued orphans just start a fresh queue segment)
                h.trace.bump_hop()
                h.trace.event("requeued", from_replica=rep.replica_id,
                              error=type(error).__name__)
                h.trace.begin("queue")
            REGISTRY.counter("pool_events_total", event="requeued").inc()
            placed = False
            for min_rank in tries:
                for _ in range(2 * len(self._replicas)):
                    try:
                        # never shed an already-admitted request:
                        # failover requeue bypasses the admission bound
                        surv = self._route(h.bucket_capacity,
                                           ignore_bound=True,
                                           min_rank=min_rank)
                    except (SchedulerClosed, SchedulerOverloaded):
                        break
                    if surv.try_submit(h, force=True):
                        placed = True
                        break
                if placed:
                    break
            if placed:
                with self._lock:
                    self._n_requeued += 1
                    if isinstance(h, ChunkHandle):
                        self._n_chunks_requeued += 1
            else:
                h._resolve(error=error, replica_id=rep.replica_id)

    # -- guardrail escalation ------------------------------------------------

    def _on_flagged(self, rep: Replica, handle: RequestHandle,
                    result: MoleculeResult) -> bool:
        """Replica guardrail-triage hook (called from its worker thread,
        no replica locks held): re-run a flagged request one precision
        tier up when the ladder and the escalation budget allow. True =
        pool took ownership (the handle now sits in a higher-tier
        replica's queue); False = the flagging replica resolves it
        locally."""
        with self._lock:
            self._n_flagged += 1
        if len(handle.escalations) >= self.cluster.max_escalations:
            return False
        from_rank = tier_rank(rep.tier)
        targets = sorted(
            (r for r in self._replicas
             if r is not rep and r.accepting
             and tier_rank(r.tier) > from_rank),
            key=lambda r: (tier_rank(r.tier), r.depth(), r.replica_id))
        reason = result.flags[0].reason if result.flags else "flagged"
        if handle.trace is not None and targets:
            # hop bookkeeping *before* the first try_submit: once a
            # target admits the handle its worker may open the next
            # serve segment immediately, so the escalation's queue
            # segment must already be the open one
            handle.trace.bump_hop()
            handle.trace.event("escalated", from_tier=rep.tier,
                               from_replica=rep.replica_id, reason=reason)
            handle.trace.begin("queue", tier=targets[0].tier,
                               escalated=True)
        for tgt in targets:
            # append the audit hop *before* submitting: the target's
            # flush stamps handle.escalations into its result
            handle.escalations.append(EscalationRecord(
                from_tier=rep.tier, to_tier=tgt.tier, reason=reason,
                from_replica=rep.replica_id))
            if tgt.try_submit(handle, force=True):
                with self._lock:
                    self._n_escalated += 1
                REGISTRY.counter("pool_events_total",
                                 event="escalated").inc()
                return True
            handle.escalations.pop()
        if handle.trace is not None and targets:
            # no target admitted: the flagging replica resolves locally;
            # the optimistic queue segment closes at resolve (~0s)
            handle.trace.event("escalation_failed", from_tier=rep.tier)
        with self._lock:
            self._n_escalation_failures += 1
        REGISTRY.counter("pool_events_total",
                         event="escalation_failed").inc()
        return False

    # -- watchdog / circuit breaker / quarantine -----------------------------

    def _watch(self) -> None:
        """Pool watchdog loop: every ``watchdog_interval_s`` sweep the
        replicas for (a) a worker stuck on one unit of work past
        ``stall_timeout_s`` — the engine-lock stall ``sessions.faults``
        injects — and (b) a flagged-rate circuit-breaker trip. Either
        quarantines the replica: its handles are expropriated and
        requeued (zero requests lost), the engine is cold-restarted on
        the same device, and the replacement is re-admitted only after
        ``probation_s``."""
        c = self.cluster
        while not self._watchdog_stop.wait(c.watchdog_interval_s):
            with self._lock:
                if not self._open:
                    return
            for idx, rep in enumerate(list(self._replicas)):
                if rep._expropriated:
                    continue        # already quarantined, worker winding down
                if c.stall_timeout_s is not None:
                    busy = rep.busy_duration()
                    if busy is not None and busy > c.stall_timeout_s:
                        with self._lock:
                            self._n_stalls_detected += 1
                        REGISTRY.counter("pool_events_total",
                                         event="stall_detected").inc()
                        self._quarantine(idx, GuardrailViolation(
                            f"replica {rep.replica_id} stalled: busy "
                            f"{busy:.2f}s > stall_timeout_s="
                            f"{c.stall_timeout_s}s", reason="stall"))
                        continue
                if c.breaker_flag_rate is not None:
                    events, flagged = rep.flag_window()
                    if (events >= c.breaker_min_events
                            and flagged / events > c.breaker_flag_rate):
                        with self._lock:
                            self._n_breaker_trips += 1
                        self._quarantine(idx, GuardrailViolation(
                            f"replica {rep.replica_id} circuit breaker: "
                            f"{flagged}/{events} recent flushes flagged "
                            f"(> {c.breaker_flag_rate:.0%})",
                            reason="breaker"))

    def _quarantine(self, idx: int, error: GuardrailViolation) -> None:
        """Take a sick replica out of service: expropriate + requeue its
        handles, cold-restart its engine on the same device, hold the
        replacement on probation. A replica id that trips more than
        ``max_quarantines`` times stays dead — a replica that keeps
        tripping is a hardware or weights problem, not bad luck."""
        rep = self._replicas[idx]
        with self._lock:
            if not self._open:
                return
            n = self._quarantine_counts.get(rep.replica_id, 0) + 1
            self._quarantine_counts[rep.replica_id] = n
            self._n_quarantined += 1
        REGISTRY.counter("pool_events_total",
                         event="quarantined").inc()
        orphans = rep.expropriate(error)
        self._requeue_orphans(rep, orphans, error)
        if n > self.cluster.max_quarantines:
            with self._lock:
                self._n_permanent_deaths += 1
            return
        old = rep.engine
        # the expropriated worker runs no further flushes on old (its
        # handles are gone); fold its counters into the fleet totals
        # before the cold restart discards the engine
        self._retire_engine_counters(old)
        eng = QuantizedEngine.from_quantized(
            old.model_cfg, old.qparams, old.serve,
            device=old.device, artifact_version=old.artifact_version,
            guardrails=old.guardrails)
        _settle(eng.device)
        fresh = Replica(rep.replica_id, eng, rep.config,
                        on_failure=self._on_replica_failure,
                        warmup=self.cluster.warmup,
                        on_flagged=self._on_flagged,
                        breaker_window=self.cluster.breaker_window)
        fresh.hold_admission(self.cluster.probation_s)
        self._replicas[idx] = fresh
        with self._lock:
            self._n_respawned += 1
        self._publish_fleet_gauges()

    def kill_replica(self, replica_id: int, mode: str = "drain") -> None:
        """Injectable failure (tests, chaos drills, cluster_bench):
        replica ``replica_id`` dies; its requests fail over to
        survivors. ``mode="in_flight"`` also fails the flush being
        formed — see :meth:`Replica.kill`."""
        self._replicas[replica_id].kill(mode)

    def _retire_engine_counters(self, engine: QuantizedEngine) -> None:
        """Fold a retiring engine's dispatch/guardrail counters into the
        pool's fleet-lifetime accumulators before the engine is dropped
        (swap_artifact exchange, quarantine cold-restart) — ``stats()``
        adds these back so fleet totals survive engine exchanges. The
        process-wide ``repro_torch.obs`` registry needs no such handling:
        its instruments are keyed by (name, labels), not by engine."""
        dispatch = engine.stats_snapshot()
        detectors = engine.guard_snapshot()
        with self._lock:
            for k, v in dispatch.items():
                self._retired_dispatch[k] = (
                    self._retired_dispatch.get(k, 0) + v)
            for k, v in detectors.items():
                self._retired_detectors[k] = (
                    self._retired_detectors.get(k, 0) + v)
            self._n_engines_retired += 1

    # -- rolling weight swap -------------------------------------------------

    def swap_artifact(self, path: str,
                      warmup: bool = True) -> Dict[str, object]:
        """Zero-downtime rolling weight swap from a packed artifact.

        The artifact is read and checksum-verified once; each live
        replica then gets a fresh engine on its own device — warmed up
        *before* the exchange on the replica's stream, while the old
        engine (and every other replica) keeps serving — and swaps under
        its flush lock. At any instant at most one replica is briefly
        paused (bounded by one flush), the rest serve; no request is
        dropped. Results carry the new ``artifact_version`` from the
        first post-swap flush of each replica onward. The new engine
        keeps the old one's guardrails (the JAX package's swap drops
        them).
        """
        art = load_artifact(path)
        ensure_mode_matches(art.serve.mode, self.serve.mode)
        if art.model_cfg != self.model_cfg:
            raise ArtifactError(
                "artifact model config does not match the pool's — a "
                "rolling swap replaces weights, not architecture")
        report = []
        on_device: Dict[torch.device, dict] = {}
        for rep in self._replicas:
            if not rep.accepting:
                continue             # dead replicas don't get new weights
            if tier_rank(rep.tier) != tier_rank(art.serve.mode):
                continue             # escalation tiers keep their own weights
            t0 = time.monotonic()
            if rep.device not in on_device:
                on_device[rep.device] = qparams_from_numpy(art.qparams,
                                                           rep.device)
            eng = QuantizedEngine.from_quantized(
                art.model_cfg, on_device[rep.device], self.serve,
                fp32_nbytes=art.fp32_bytes, device=rep.device,
                artifact_version=art.version_tag,
                guardrails=rep.engine.guardrails)
            _settle(eng.device)
            warm_s = rep.warm(eng) if warmup else 0.0
            old_engine = rep.engine
            pause_s = rep.swap_engine(eng)
            # swap_engine held the flush lock: once it returns, the old
            # engine serves no more work and its counters are final
            self._retire_engine_counters(old_engine)
            REGISTRY.counter("pool_events_total",
                             event="engine_swapped").inc()
            report.append({"replica_id": rep.replica_id,
                           "warmup_s": warm_s, "pause_s": pause_s,
                           "total_s": time.monotonic() - t0})
        return {"version_tag": art.version_tag, "replicas": report}

    # -- telemetry -----------------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def queue_depth(self) -> int:
        return sum(r.depth() for r in self._replicas)

    def _publish_fleet_gauges(self) -> None:
        """Fleet composition into the obs registry (``obs_top`` reads
        the exported file, not ``stats()``): live replicas per tier."""
        tiers: Dict[str, int] = {}
        for r in self._replicas:
            if r.accepting or r.busy_duration() is not None:
                tiers[r.tier] = tiers.get(r.tier, 0) + 1
        for tier, n in tiers.items():
            REGISTRY.gauge("cluster_replicas", tier=tier).set(n)

    def watch_alerts(self, bus) -> "ClusterPool":
        """Subscribe the pool to an alert bus (duck-typed: anything with
        ``subscribe(fn) -> unsubscribe``, such as
        :class:`repro_torch.obs.slo.AlertBus`):
        alerts are recorded (bounded history, ``stats()["alerts"]``)
        and counted under ``pool_events_total{event="alert"}`` so the
        fleet's own heartbeat carries the health plane's verdicts.
        *Acting* on alerts stays the guardrail/watchdog layer's job —
        the bus hands the pool attributed evidence, not commands.
        Returns ``self`` so ``ClusterPool.from_config(...)
        .watch_alerts(bus)`` chains."""
        def _on_alert(alert) -> None:
            with self._lock:
                self._alerts_seen.append(alert)
                self._n_alerts_seen += 1
            REGISTRY.counter("pool_events_total", event="alert").inc()
        if self._alert_unsub is not None:
            self._alert_unsub()
        self._alert_unsub = bus.subscribe(_on_alert)
        return self

    def flush_records(self) -> List:
        """Every replica's :class:`FlushRecord` list, merged — the
        flush-slice source of a timeline export
        (:func:`repro_torch.obs.timeline.chrome_trace`)."""
        return [f for r in self._replicas for f in r.records()]

    def warmup_records(self) -> List[Dict]:
        """Per-replica warmup/compile report entries (each tagged with
        its ``replica`` id) — the compile-slice source for the
        timeline export."""
        out: List[Dict] = []
        for r in self._replicas:
            for rec in getattr(r.engine, "warmup_report", None) or []:
                out.append({"replica": r.replica_id, **rec})
        return out

    def reset_stats(self) -> None:
        """Zero per-phase telemetry (flush records, completion/error and
        router counters, engine dispatch counters) — benches call this
        between phases so rates reconcile within the phase. Liveness
        state is untouched."""
        for r in self._replicas:
            r.reset_records()
            r.engine.reset_stats()
        with self._lock:
            self._n_routed = 0
            self._n_shed = 0
            self._n_requeued = 0
            self._n_failures = 0
            self._n_chunks_routed = 0
            self._n_chunks_requeued = 0
            self._routed_per_replica = {}
            self._retry_cache = (0.0, 0.0)
            # per-phase view: retired-engine accumulators zero with the
            # engine counters they extend (fleet-lifetime totals live in
            # the process-wide obs registry, which reset_stats never
            # touches)
            self._retired_dispatch = {}
            self._retired_detectors = {}

    def attach_stats_source(self, name: str, fn) -> None:
        """Register an extra ``stats()`` section: ``fn()`` must return a
        JSON-able dict, reported under ``name``. ``repro_torch.sessions``
        attaches its session/fault/checkpoint telemetry here so
        operators (and the sessions bench) read one merged snapshot."""
        with self._lock:
            self._stats_sources[name] = fn

    def stats(self) -> Dict[str, object]:
        """Cluster-wide snapshot: per-replica health/heartbeat, router
        counters (routing balance, sheds, failovers), merged flush
        telemetry (per-replica breakdown included), and the summed
        engine dispatch counters — same headline keys as
        ``MicroBatchScheduler.stats()`` so replays and benches read
        either."""
        replicas = [r.snapshot() for r in self._replicas]
        flushes = [f for r in self._replicas for f in r.records()]
        with self._lock:
            router = {
                "n_routed": self._n_routed,
                "n_shed": self._n_shed,
                "n_requeued": self._n_requeued,
                "n_failures": self._n_failures,
                "n_chunks_routed": self._n_chunks_routed,
                "n_chunks_requeued": self._n_chunks_requeued,
                "routed_per_replica": {
                    str(k): v for k, v in
                    sorted(self._routed_per_replica.items())},
            }
            sources = dict(self._stats_sources)
        # fleet totals = current engines + engines retired by swaps /
        # quarantine cold-restarts (the satellite fix: exchanges used to
        # silently zero these)
        with self._lock:
            dispatch: Dict[str, int] = dict(self._retired_dispatch)
            n_retired = self._n_engines_retired
        for r in self._replicas:
            for k, v in r.engine.stats_snapshot().items():
                dispatch[k] = dispatch.get(k, 0) + v
        out: Dict[str, object] = {
            "n_replicas": len(self._replicas),
            "n_live": len(self._live()),
            "n_submitted": router["n_routed"],
            "n_completed": sum(r["n_completed"] for r in replicas),
            "n_shed": router["n_shed"],
            "warmup_s": max((r["warmup_s"] for r in replicas), default=0.0),
            "replicas": replicas,
            "router": router,
            "n_engines_retired": n_retired,
        }
        out["chunks"] = {
            "n_routed": router["n_chunks_routed"],
            "n_requeued": router["n_chunks_requeued"],
            "n_completed": sum(r["n_chunks_completed"] for r in replicas),
            "n_errors": sum(r["n_chunk_errors"] for r in replicas),
            "n_stalls_injected": sum(r["n_stalls_injected"]
                                     for r in replicas),
        }
        tiers: Dict[str, int] = {}
        for r in self._replicas:
            tiers[r.tier] = tiers.get(r.tier, 0) + 1
        with self._lock:
            detectors: Dict[str, int] = dict(self._retired_detectors)
        for r in self._replicas:
            for k, v in r.engine.guard_snapshot().items():
                detectors[k] = detectors.get(k, 0) + v
        with self._lock:
            out["tiers"] = tiers
            out["guardrails"] = {
                "n_flagged": self._n_flagged,
                "n_escalated": self._n_escalated,
                "n_escalation_failures": self._n_escalation_failures,
                "n_quarantined": self._n_quarantined,
                "n_breaker_trips": self._n_breaker_trips,
                "n_stalls_detected": self._n_stalls_detected,
                "n_respawned": self._n_respawned,
                "n_permanent_deaths": self._n_permanent_deaths,
                "detectors": detectors,
            }
        with self._lock:
            out["alerts"] = {
                "n_seen": self._n_alerts_seen,
                "recent": [a.to_json() for a in self._alerts_seen],
            }
        for name, fn in sources.items():
            try:
                out[name] = fn()
            except Exception as e:   # a sick stats source must not
                out[name] = {"error": repr(e)}  # break the heartbeat
        out.update(flush_summary(flushes))
        out["engine_dispatch"] = dispatch
        return out
