"""Dynamic micro-batching scheduler: counterpart of ``repro/server/scheduler.py``.

``QuantizedEngine.infer_batch`` is synchronous: the caller supplies a
whole batch and waits. Online requests arrive one at a time, and the
server must *form* batches under a latency budget. Two pieces do it, with
the JAX package's semantics:

* :class:`BatchQueue` — the pure queueing/flush policy, with no thread
  and no engine: per-shape-class admission queues over the engine's
  bucket ladder, the two flush triggers (full / deadline), the
  anti-starvation flush order, and drain;
* :class:`MicroBatchScheduler` — one worker thread owning one engine,
  fed by one :class:`BatchQueue`.

Policy:

* **per-shape-class admission queues** — each molecule is assigned its
  bucket (the same ``assign_bucket`` as ``infer_batch``) and queued with
  peers of the same shape class, so every flush is one
  ``engine.infer_batch`` call of one bucket and one batch class;
* **two flush triggers** — a queue flushes when it holds ``max_batch``
  requests ("full") or when its oldest request has waited
  ``deadline_ms`` ("deadline"); ``max_batch=1, deadline_ms=0`` is
  per-request serving;
* **bounded admission** — with ``max_queue`` set, ``submit`` sheds with
  :class:`SchedulerOverloaded` (carrying ``retry_after_s``); ``submit``
  after ``close()`` raises :class:`SchedulerClosed`: a request is
  admitted (and resolves) or refused loudly, never left hanging;
* **request -> result identity** — flushes from different buckets
  complete out of order, but each :class:`RequestHandle` resolves to
  its own molecule's result;
* **no new shape under traffic** — the scheduler calls
  ``engine.warmup()`` at start by default; every shape a flush can
  produce is in the engine's admissible set (``engine.shapes_seen``),
  and on the card captured as a program (``engine.compiled_shapes``),
  so a flush replays one.

The worker thread owns the engine and issues every kernel launch of a
flush. Before its loop it makes the engine's card the thread's current
CUDA device (the kernel wrappers launch on the current stream of the
tensor's device, and the ctypes launches on the calling thread's current
device) and it runs with grad mode on (grad mode is per thread; the
forces are an autograd backward). ``submit`` is thread-safe and cheap:
it appends to a queue and signals the worker.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.guardrails import GuardrailViolation
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER
from repro_torch.serving.bucketing import BucketSpec, Graph, assign_bucket
from repro_torch.serving.engine import MoleculeResult, QuantizedEngine
from repro_torch.server.stats import FlushRecord, flush_summary

__all__ = ["SchedulerConfig", "SchedulerClosed", "SchedulerOverloaded",
           "RequestTimeout", "RequestHandle", "BatchQueue",
           "MicroBatchScheduler"]


class SchedulerClosed(RuntimeError):
    """``submit`` was called on a closed scheduler: the request was NOT admitted and no handle exists — callers
    must not wait on anything. Raised instead of silently hanging."""


class RequestTimeout(TimeoutError):
    """``RequestHandle.result(timeout_s=...)`` expired before the
    request resolved. Subclasses :class:`TimeoutError` so callers that
    caught the old builtin keep working; typed so the session manager
    and the pool watchdog can tell a deadline miss (request may still
    complete — retrying a pure chunk is safe) from an engine error."""


class SchedulerOverloaded(RuntimeError):
    """Bounded admission refused a request: every eligible queue is at
    ``max_queue``. ``retry_after_s`` is a hint — roughly how long the
    backlog needs to drain one batch — for client backoff."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Batch-formation knobs (the engine's ServeConfig stays in charge of
    shapes, paths, and kernels)."""
    max_batch: int = 8        # flush a queue at this many requests
    deadline_ms: float = 20.0  # max batching wait for the oldest request
    warmup: bool = True       # run every shape class before serving
    # bounded admission: total queued requests before submit sheds with
    # SchedulerOverloaded (None = unbounded)
    max_queue: Optional[int] = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")


class RequestHandle:
    """A pending request's future. ``result()`` blocks until the flush
    containing this molecule completes, then returns its
    :class:`MoleculeResult` (or re-raises the engine's exception).

    ``replica_id`` is set when the request resolves (0 for the
    single-engine scheduler; the serving replica's id in a cluster —
    after failover this is the survivor that actually completed it).
    ``n_requeues`` counts cluster failover requeues (0 outside clusters).

    ``trace`` is the request's :class:`repro_torch.obs.trace.RequestTrace`
    (``None`` when tracing is disabled — the default). It is minted here
    so the root span starts exactly at ``t_submit``, and finished in
    ``_resolve`` at exactly ``t_done``, whichever path (scheduler,
    cluster replica, failover survivor) resolves the handle.
    """

    __slots__ = ("graph", "t_submit", "t_done", "bucket_capacity",
                 "replica_id", "n_requeues", "escalations", "trace",
                 "_event", "_result", "_error")

    _trace_kind = "request"  # ChunkHandle overrides

    def __init__(self, graph: Graph, t_submit: float,
                 bucket_capacity: int = 0):
        self.graph = graph
        self.t_submit = t_submit
        self.t_done: Optional[float] = None
        self.bucket_capacity = bucket_capacity
        self.replica_id: Optional[int] = None
        self.n_requeues = 0
        # precision-tier escalation trail (guardrails
        # EscalationRecords, appended by ClusterPool when a flagged
        # result is re-run one tier up; stamped into the final result)
        self.escalations: list = []
        self.trace = TRACER.start_request(kind=type(self)._trace_kind,
                                          t0=t_submit)
        self._event = threading.Event()
        self._result: Optional[MoleculeResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _reject(self, exc: BaseException) -> None:
        """Submit-path rejection (oversize / shed / closed): the handle
        is never returned to the caller, so finish its trace here —
        rejections stay observable and no trace is left unfinished."""
        if self.trace is not None:
            self.trace.finish(status="rejected",
                              error=type(exc).__name__)

    def result(self, timeout: Optional[float] = None,
               timeout_s: Optional[float] = None) -> MoleculeResult:
        """Block for the result. ``timeout_s`` (alias of the older
        ``timeout``; it wins when both are given) bounds the wait and
        raises a typed :class:`RequestTimeout` instead of blocking
        forever — the request itself stays in flight and may still
        resolve (a pool watchdog recovering a stalled replica resolves
        it later; first resolution wins)."""
        t = timeout_s if timeout_s is not None else timeout
        if not self._event.wait(t):
            raise RequestTimeout(
                f"request not completed within {t}s (submitted "
                f"{time.monotonic() - self.t_submit:.3f}s ago)")
        if self._error is not None:
            raise self._error
        return self._result  # type: ignore[return-value]

    @property
    def latency_s(self) -> float:
        """Submit -> completion wall clock (queue wait + batching wait +
        service). Only valid once ``done()``."""
        if self.t_done is None:
            raise RuntimeError("request not completed")
        return self.t_done - self.t_submit

    def _resolve(self, result=None, error=None, replica_id=None):
        # first resolution wins: after a watchdog expropriates a stalled
        # replica and requeues its in-flight work, both the survivor and
        # the (eventually waking) stuck worker resolve the same handle —
        # the late one must be a no-op, not a result swap under a reader
        if self._event.is_set():
            return
        self._result, self._error = result, error
        if replica_id is not None:
            self.replica_id = replica_id
        now = time.monotonic()
        self.t_done = now
        if self.trace is not None:
            # same instant as t_done: the trace's span durations sum
            # exactly to latency_s (the tiling invariant, obs.trace)
            self.trace.finish(
                now,
                status="error" if error is not None else "ok",
                error=type(error).__name__ if error is not None else None,
                replica_id=self.replica_id,
                bucket=self.bucket_capacity,
                n_requeues=self.n_requeues,
                n_escalations=len(self.escalations))
        if REGISTRY.enabled:
            # per-request e2e latency, windowed-p99 SLO feed; labelled
            # by kind so chunk runtimes never pollute the request p99
            REGISTRY.histogram(
                "serve_request_latency_seconds",
                kind=type(self)._trace_kind,
                bucket=str(self.bucket_capacity)).observe(
                now - self.t_submit)
        self._event.set()


class BatchQueue:
    """Per-shape-class admission queues + the flush policy, with no
    thread of its own.

    In the JAX package every cluster replica drives this same policy
    beside :class:`MicroBatchScheduler`: each owner holds its own lock
    around every call (nothing here is synchronized) and runs the
    identical policy — what queues exist, when one flushes, which
    flushes first, and what draining means.
    """

    def __init__(self, buckets: List[BucketSpec], config: SchedulerConfig):
        self.config = config
        self._buckets = list(buckets)
        self._queues: Dict[int, Deque[RequestHandle]] = {
            b.capacity: deque() for b in self._buckets}

    def bucket_of(self, graph: Graph) -> BucketSpec:
        """Shape class a graph will be queued (and dispatched) under.
        Raises like ``infer_batch`` for molecules off the ladder."""
        return assign_bucket(graph.n_atoms, self._buckets)

    def append(self, handle: RequestHandle) -> None:
        """Admit one handle to its shape class's queue. The handle's
        ``bucket_capacity`` must already be set (``bucket_of``)."""
        self._queues[handle.bucket_capacity].append(handle)

    def depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth_of(self, capacity: int) -> int:
        return len(self._queues[capacity])

    def is_full(self) -> bool:
        mq = self.config.max_queue
        return mq is not None and self.depth() >= mq

    def oldest_deadline(self) -> Optional[float]:
        """Monotonic time at which the oldest queued request's batching
        budget expires (None when all queues are empty)."""
        t = None
        for q in self._queues.values():
            if q:
                cand = q[0].t_submit + self.config.deadline_ms * 1e-3
                t = cand if t is None else min(t, cand)
        return t

    def pick_flush(self, now: float, drain: bool
                   ) -> Optional[Tuple[int, List[RequestHandle], str]]:
        """Choose (capacity, handles, reason) for the next flush, or None
        when no trigger has fired. Among all *triggered* queues (full, or
        head's deadline expired) the one whose head request is oldest
        goes first — a bucket whose queue refills to max_batch faster
        than flushes complete must not starve deadline-expired requests
        in other buckets. With ``drain`` the oldest non-empty queue
        flushes unconditionally (close()/failover teardown)."""
        best = None          # (head_t_submit, cap, reason)
        oldest = None        # (head_t_submit, cap) over non-empty queues
        deadline_s = self.config.deadline_ms * 1e-3
        for cap, q in self._queues.items():
            if not q:
                continue
            head_t = q[0].t_submit
            if oldest is None or head_t < oldest[0]:
                oldest = (head_t, cap)
            if len(q) >= self.config.max_batch:
                reason = "full"
            elif now >= head_t + deadline_s:
                reason = "deadline"
            else:
                continue
            if best is None or head_t < best[0]:
                best = (head_t, cap, reason)
        if best is not None:
            _, cap, reason = best
            return cap, self._pop(cap), reason
        if drain and oldest is not None:
            return oldest[1], self._pop(oldest[1]), "drain"
        return None

    def _pop(self, cap: int) -> List[RequestHandle]:
        q = self._queues[cap]
        return [q.popleft() for _ in range(min(len(q),
                                               self.config.max_batch))]

    def drain_all(self) -> List[RequestHandle]:
        """Remove and return every queued handle (failover: the pool
        requeues them onto surviving replicas)."""
        out: List[RequestHandle] = []
        for q in self._queues.values():
            out.extend(q)
            q.clear()
        return out


class MicroBatchScheduler:
    """Online request scheduler over a :class:`QuantizedEngine`.

    Use as a context manager (or call ``close()``), so the worker thread
    drains and exits::

        with MicroBatchScheduler(engine, SchedulerConfig()) as sched:
            handles = [sched.submit(g) for g in graphs]
            results = [h.result() for h in handles]
    """

    def __init__(self, engine: QuantizedEngine,
                 config: SchedulerConfig = SchedulerConfig()):
        self.engine = engine
        self.config = config
        if config.max_batch > engine.serve.max_batch:
            raise ValueError(
                f"SchedulerConfig.max_batch {config.max_batch} exceeds "
                f"ServeConfig.max_batch {engine.serve.max_batch}: flushes "
                "must fit one engine batch")
        self._queue = BatchQueue(engine.serve.buckets(), config)
        self._lock = threading.Condition()
        self._open = True
        self._flushes: List[FlushRecord] = []
        self._n_submitted = 0
        self._n_completed = 0
        self._n_shed = 0
        self._n_guard_flagged = 0
        self._service_ema: Optional[float] = None
        # dual-write into the process-wide metrics plane (obs.metrics):
        # the per-instance counters above stay the thin stats() view,
        # the registry carries fleet-lifetime labelled totals
        self._m_requests = {
            k: REGISTRY.counter("serve_requests_total",
                                surface="scheduler", event=k)
            for k in ("submitted", "completed", "shed", "guard_flagged")}
        self._m_wait = REGISTRY.histogram("serve_queue_wait_seconds",
                                          surface="scheduler")
        self._m_service = REGISTRY.histogram("serve_flush_seconds",
                                             surface="scheduler")
        self.warmup_s = engine.warmup() if config.warmup else 0.0
        self._worker = threading.Thread(
            target=self._serve_loop, name="microbatch-scheduler", daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, graph: Graph) -> RequestHandle:
        """Admit one molecule. Raises like ``infer_batch`` for molecules
        larger than the bucket ladder; :class:`SchedulerClosed` after
        ``close()``; :class:`SchedulerOverloaded` when bounded admission
        (``max_queue``) sheds the request."""
        handle = RequestHandle(graph, time.monotonic())
        try:
            with self._lock:
                # bucket assignment under the lock keeps oversize
                # rejection ordered with close(); it is a few
                # comparisons, not work
                handle.bucket_capacity = (
                    self._queue.bucket_of(graph).capacity)
                if not self._open:
                    raise SchedulerClosed(
                        "scheduler is closed: request not admitted")
                if self._queue.is_full():
                    self._n_shed += 1
                    self._m_requests["shed"].inc()
                    retry = self._retry_after_locked()
                    raise SchedulerOverloaded(
                        f"admission queue at max_queue="
                        f"{self.config.max_queue}: request shed "
                        f"(retry in ~{retry:.3f}s)", retry)
                self._queue.append(handle)
                self._n_submitted += 1
                self._m_requests["submitted"].inc()
                self._lock.notify()
        except BaseException as e:
            handle._reject(e)
            raise
        if handle.trace is not None:
            handle.trace.set_attr("bucket", handle.bucket_capacity)
        return handle

    def _retry_after_locked(self) -> float:
        """Backoff hint: roughly one flush's service time, or the
        batching deadline when nothing has been served yet."""
        if self._service_ema is not None:
            return self._service_ema
        return max(self.config.deadline_ms * 1e-3, 0.01)

    def close(self):
        """Stop admitting, drain every queue, join the worker."""
        with self._lock:
            if not self._open:
                return
            self._open = False
            self._lock.notify()
        self._worker.join()

    def __enter__(self) -> "MicroBatchScheduler":
        return self

    def __exit__(self, *exc):
        self.close()

    # -- telemetry ----------------------------------------------------------

    def queue_depth(self) -> int:
        with self._lock:
            return self._queue.depth()

    def stats(self) -> Dict[str, object]:
        """Flush telemetry (batch-size distribution = achieved bucket
        occupancy, flush reasons, queue depths) + request counters and
        the engine's dispatch counters."""
        with self._lock:
            flushes = list(self._flushes)
            out = {"n_submitted": self._n_submitted,
                   "n_completed": self._n_completed,
                   "n_shed": self._n_shed,
                   "n_guard_flagged": self._n_guard_flagged,
                   "warmup_s": self.warmup_s}
        out.update(flush_summary(flushes))
        out["engine_dispatch"] = self.engine.stats_snapshot()
        return out

    # -- worker side --------------------------------------------------------

    def _serve_loop(self):
        try:
            # this thread issues every launch of a flush: on the engine's
            # card, with grad mode on whatever the creating thread had
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            with torch.enable_grad():
                self._flush_loop()
        except BaseException as exc:
            # a worker that dies outside a flush must not leave admitted
            # requests waiting: stop admitting and fail what is queued
            with self._lock:
                self._open = False
                pending = self._queue.drain_all()
            for h in pending:
                h._resolve(error=exc, replica_id=0)
            raise

    def _flush_loop(self):
        while True:
            with self._lock:
                while True:
                    now = time.monotonic()
                    depth = self._queue.depth()
                    picked = self._queue.pick_flush(now, drain=not self._open)
                    if picked is not None:
                        break
                    if not self._open and depth == 0:
                        return
                    deadline = self._queue.oldest_deadline()
                    self._lock.wait(
                        None if deadline is None else max(deadline - now, 0))
                cap, handles, reason = picked
            # engine work runs outside the lock: submit stays non-blocking
            wait_s = time.monotonic() - handles[0].t_submit
            t0 = time.monotonic()
            for h in handles:
                if h.trace is not None:
                    # close the queue segment, open serve, same instant
                    h.trace.begin("serve", t0, replica=0, bucket=cap,
                                  flush_reason=reason)
            try:
                # on_flag="mark": a poison molecule must fail *its own*
                # handle with a typed error, not its batch peers — the
                # per-handle triage happens below
                results = self.engine.infer_batch(
                    [h.graph for h in handles], on_flag="mark")
            except BaseException as e:  # propagate to every waiting client
                for h in handles:
                    h._resolve(error=e, replica_id=0)
                continue
            service_s = time.monotonic() - t0
            # bookkeeping strictly before resolving: a client returning
            # from result() must already see this flush in stats()
            n_flagged = sum(1 for r in results if r.flags)
            trace_ids = tuple(h.trace.trace_id for h in handles
                              if h.trace is not None)
            # stub engines in tests may not expose the profiling hook
            bd = getattr(self.engine, "last_infer_breakdown", None) or {}
            with self._lock:
                self._n_completed += len(handles)
                self._n_guard_flagged += n_flagged
                self._service_ema = (service_s if self._service_ema is None
                                     else 0.8 * self._service_ema
                                     + 0.2 * service_s)
                self._flushes.append(FlushRecord(
                    capacity=cap, n_requests=len(handles), reason=reason,
                    queue_depth=depth, wait_s=wait_s, service_s=service_s,
                    path=results[0].path, batch_size=results[0].batch_size,
                    replica_id=0, trace_ids=trace_ids,
                    prep_s=bd.get("prep_s", 0.0),
                    dispatch_s=bd.get("dispatch_s", 0.0),
                    sync_s=bd.get("sync_s", 0.0),
                    t_start=t0))
            self._m_requests["completed"].inc(len(handles))
            if n_flagged:
                self._m_requests["guard_flagged"].inc(n_flagged)
            self._m_wait.observe(wait_s)
            self._m_service.observe(service_s)
            REGISTRY.counter("serve_flushes_total", surface="scheduler",
                             reason=reason).inc()
            for h, r in zip(handles, results):
                if h.trace is not None:
                    r = dataclasses.replace(r, trace_id=h.trace.trace_id)
                    for f in r.flags:
                        h.trace.event("guardrail_flag", reason=f.reason,
                                      severity=f.severity)
                # fatal flags (non-finite values) are never delivered:
                # the single-engine scheduler has no higher tier to
                # escalate to, so the handle gets the typed error.
                # Suspect flags ride out annotated in result.flags.
                fatal = next((f for f in r.flags if f.fatal), None)
                if fatal is not None:
                    h._resolve(error=GuardrailViolation(
                        f"guardrail {fatal.reason}: result withheld",
                        reason=fatal.reason, severity=fatal.severity),
                        replica_id=0)
                else:
                    h._resolve(result=r, replica_id=0)
