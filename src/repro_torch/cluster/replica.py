"""One cluster replica: counterpart of ``repro/cluster/replica.py``.

A :class:`Replica` is the ``n_replicas=1`` building block the pool
(``repro_torch.cluster.pool``) stands up N of: it owns

* one :class:`~repro_torch.serving.engine.QuantizedEngine` on one
  device (its weights and codebook there),
* one :class:`~repro_torch.server.scheduler.BatchQueue` — the *same*
  queueing/flush policy object the single-engine
  ``MicroBatchScheduler`` runs, so batch formation semantics are
  identical at every replica count,
* one worker thread that warms the engine up, then serves flushes, and
  one CUDA stream (on a CUDA device) that every launch of the worker
  goes to. JAX gives each replica its own device and so its own
  execution queue; replicas sharing one card get one stream each, so a
  replica's synchronize (``QuantizedEngine._sync``, the copy back of a
  flush) waits for its own work only. The worker makes the engine's
  card its current device and runs with grad mode on (forces are an
  autograd backward), as the scheduler's worker does. It tallies its
  kernel launches by role (``flush:<tier>``, ``chunk:<tier>``,
  ``warmup:<tier>``; ``kernels._launch.role_launches``).

What a replica adds over the single-engine scheduler is the cluster's
failure and upgrade surface:

* **engine hot swap** — ``swap_engine(new_engine)`` exchanges the
  serving engine under a lock that is held during each flush, so the
  in-flight flush finishes on the old weights, everything after runs
  the new ones, and no request is ever dropped (the pool drives this
  one replica at a time for a zero-downtime rolling swap);
* **failure** — ``kill()`` (the injectable abrupt failure used by
  tests and ``benchmarks/cluster_bench.py``) takes the *failover
  path*: the replica stops accepting, hands every unresolved handle —
  queued and, for in-flight kills, the flush being attempted — to the
  pool's ``on_failure`` callback for requeue onto survivors, and its
  thread exits. A real **engine exception** during a flush resolves
  the error to that flush's handles (exactly like the single-engine
  scheduler — a poison request must not be requeued to cascade-kill
  survivors); only ``MAX_CONSECUTIVE_ERRORS`` erroring flushes in a
  row are treated as the replica itself being broken, taking the
  failover path for the *queued* (never-attempted) requests. A replica
  never silently eats requests;
* **heartbeat telemetry** — ``snapshot()`` reports liveness, queue
  depth, completions, the serving artifact version, and the age of the
  last completed flush (the heartbeat the pool surfaces in
  ``stats()``);
* **session chunks** — a :class:`ChunkHandle` (one ``MDEngine.run``
  call from ``repro_torch.sessions``) queues beside one-shot traffic and
  runs on the worker thread under the same engine lock as a flush.
  Flushes go first: latency-sensitive batches preempt bulk MD work at
  every chunk boundary. Queued chunks fail over with the one-shot
  orphans; an in-flight ``kill(mode="in_flight")`` fails whichever work
  was picked — flush or chunk. ``inject_stall`` adds the slow-flush
  fault the session chaos harness schedules.

Locking: the replica's condition variable guards its queue and flags
(never held during engine work); ``_engine_lock`` is held for the
duration of each flush and by ``swap_engine``. The pool may take
replica locks while holding its own; replica worker threads call back
into the pool only with no replica lock held — that ordering
(pool -> replica, never the reverse) is what makes the whole thing
deadlock-free.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
import contextlib
from typing import Any, Callable, Deque, Dict, List, Optional

import torch

from repro_torch.guardrails import GuardrailViolation
from repro_torch.kernels._launch import launch_role
from repro_torch.obs.metrics import REGISTRY
from repro_torch.serving.engine import QuantizedEngine
from repro_torch.server.scheduler import (BatchQueue, RequestHandle,
                                          SchedulerConfig)
from repro_torch.server.stats import FlushRecord

__all__ = ["ChunkHandle", "Replica", "ReplicaFailed"]


class ReplicaFailed(RuntimeError):
    """A replica died (injected kill or engine failure). Requests that
    exhausted their failover requeue budget resolve with this error."""


class ChunkHandle(RequestHandle):
    """A unit of *session* work: an opaque ``fn(engine) -> result``
    closure (in practice one ``MDEngine.run`` call from
    ``repro_torch.sessions``) that a replica's worker runs on its pinned
    engine, under the same ``_engine_lock`` as a flush — so a rolling
    ``swap_engine`` waits for an in-flight chunk and every later chunk
    sees the post-swap engine.

    It rides the existing :class:`RequestHandle` future/failover
    machinery: ``bucket_capacity`` is the session molecule's shape
    class (chunks share JSQ + affinity routing with same-shape one-shot
    traffic), ``n_requeues`` counts failovers, and a dying replica
    hands queued chunks to the pool's ``on_failure`` exactly like
    one-shot requests. Unlike a flush, a chunk that raises resolves the
    error to *this* handle only — the session manager, which holds the
    authoritative pre-chunk state, decides whether to re-submit.
    """

    __slots__ = ("fn", "session_id", "chunk_idx")

    _trace_kind = "chunk"

    def __init__(self, fn: Callable[[QuantizedEngine], Any],
                 t_submit: float, bucket_capacity: int = 0,
                 session_id: str = "", chunk_idx: int = 0):
        super().__init__(None, t_submit, bucket_capacity)
        self.fn = fn
        self.session_id = session_id
        self.chunk_idx = chunk_idx
        if self.trace is not None:
            self.trace.set_attr("session_id", session_id)
            self.trace.set_attr("chunk_idx", chunk_idx)


class Replica:
    """One engine + queue + worker thread of a cluster pool."""

    # erroring flushes in a row before the replica declares itself
    # broken (a hard device failure errors every flush; a poison
    # request only errors its own — see module doc)
    MAX_CONSECUTIVE_ERRORS = 3

    def __init__(self, replica_id: int, engine: QuantizedEngine,
                 config: SchedulerConfig,
                 on_failure: Callable[["Replica", List[RequestHandle],
                                       BaseException], None],
                 warmup: bool = True,
                 on_flagged: Optional[Callable] = None,
                 breaker_window: int = 0):
        """``on_flagged(replica, handle, result) -> bool`` is the pool's
        guardrail triage hook, called (with no replica locks held) for
        each flush result whose detectors fired: True means the pool
        took ownership (requeued the handle one precision tier up),
        False means this replica resolves it locally (typed error for
        fatal flags, annotated delivery for suspect ones).
        ``breaker_window`` sizes the sliding flagged-rate window the
        pool's circuit breaker reads via :meth:`flag_window` (0 = keep
        none)."""
        self.replica_id = replica_id
        self.engine = engine
        self.config = config
        self.warmup_s = 0.0
        self.ready = threading.Event()      # set once warmup finished (or failed)
        self._queue = BatchQueue(engine.serve.buckets(), config)
        self._chunks: Deque[ChunkHandle] = deque()   # session segments
        self._lock = threading.Condition()
        self._engine_lock = threading.Lock()  # held per flush and per swap
        self._accepting = True
        self._closing = False
        self._fail_next_flush = False
        self._fail_error: Optional[BaseException] = None
        self._on_failure = on_failure
        self._on_flagged = on_flagged
        self._do_warmup = warmup
        self._flushes: List[FlushRecord] = []
        self._n_completed = 0
        self._n_errors = 0              # flush errors resolved to handles
        self._n_chunks_completed = 0
        self._n_chunk_errors = 0
        self._chunk_service_s = 0.0
        self._stall_s = 0.0             # injected slow-flush fault (one-shot)
        self._n_stalls_injected = 0
        self._consecutive_errors = 0
        self._n_flagged = 0             # flush results with guardrail flags
        self._recent_flags: Deque[bool] = deque(maxlen=max(breaker_window, 0))
        # watchdog surface: when the worker picked work and what it holds
        self._busy_since: Optional[float] = None
        self._in_flight: List[RequestHandle] = []
        # set by expropriate(): the pool already rehomed every handle;
        # the (possibly stuck) worker must exit silently when it wakes
        self._expropriated = False
        self._admit_at = 0.0            # monotonic probation gate
        self._last_beat = time.monotonic()
        # fleet-level obs plane: instruments are shared across replicas
        # (and across engine exchanges) by (name, labels) identity
        self._m_wait = REGISTRY.histogram("serve_queue_wait_seconds",
                                          surface="replica")
        self._m_service = REGISTRY.histogram("serve_flush_seconds",
                                             surface="replica")
        self._m_completed = REGISTRY.counter(
            "serve_requests_total", surface="replica", event="completed")
        self._m_chunks = {
            k: REGISTRY.counter("cluster_chunks_total", event=k)
            for k in ("completed", "error")}
        # health-plane feeds: live per-replica queue depth (anomaly
        # detectors) and a per-replica service histogram (latency-skew
        # detection needs the replica label; the fleet-level
        # serve_flush_seconds{surface="replica"} aggregate stays as-is)
        self._m_depth = REGISTRY.gauge("cluster_queue_depth",
                                       replica=str(replica_id))
        self._m_service_r = REGISTRY.histogram("replica_flush_seconds",
                                               replica=str(replica_id))
        # the worker's execution queue on a CUDA device (None on the CPU)
        self.stream = (torch.cuda.Stream(device=engine.device)
                       if engine.device.type == "cuda" else None)
        self._worker = threading.Thread(
            target=self._run, name=f"cluster-replica-{replica_id}",
            daemon=True)
        self._worker.start()

    # -- pool side -----------------------------------------------------------

    @property
    def device(self):
        return self.engine.device

    def on_stream(self):
        """Context that makes this replica's stream current: everything
        the worker runs, and what the pool runs for this replica on its
        own thread (warming a swapped-in or restarted engine), launches
        there."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def warm(self, engine: QuantizedEngine) -> float:
        """Warm ``engine`` up for this replica from the calling thread:
        on the replica's stream, with grad mode on; ``warmup`` ends in a
        synchronize of that stream. Returns its seconds."""
        with self.on_stream(), torch.enable_grad(), \
                launch_role(f"warmup:{engine.serve.mode}"):
            return engine.warmup()

    @property
    def tier(self) -> str:
        """Precision tier = the engine's serving mode (w4a8/w8a8/fp32)."""
        return self.engine.serve.mode

    @property
    def accepting(self) -> bool:
        with self._lock:
            return (self._accepting and not self._closing
                    and time.monotonic() >= self._admit_at)

    def depth(self) -> int:
        """Queued one-shot requests + queued session chunks: chunks are
        real load, so JSQ routing and the admission bound must see them."""
        with self._lock:
            return self._queue.depth() + len(self._chunks)

    def depth_of(self, capacity: int) -> int:
        with self._lock:
            return self._queue.depth_of(capacity)

    def try_submit(self, handle: RequestHandle, force: bool = False) -> bool:
        """Admit one routed handle (one-shot request or session
        :class:`ChunkHandle`). Returns False — so the router picks
        another replica — when this one has died, is closing, or (unless
        ``force``, the failover-requeue path: already-admitted requests
        are never shed) its total depth is at the bound."""
        with self._lock:
            if not self._accepting or self._closing \
                    or time.monotonic() < self._admit_at:
                return False
            mq = self.config.max_queue
            if (not force and mq is not None
                    and self._queue.depth() + len(self._chunks) >= mq):
                return False
            if isinstance(handle, ChunkHandle):
                self._chunks.append(handle)
            else:
                self._queue.append(handle)
            self._m_depth.set(self._queue.depth() + len(self._chunks))
            self._lock.notify()
            return True

    def inject_stall(self, seconds: float) -> None:
        """Fault injection: the next unit of engine work (flush or
        chunk) sleeps ``seconds`` while holding the engine lock — the
        'slow flush' failure mode (GC pause, thermal throttle, a
        straggler device) that delays everything behind it without
        killing anything."""
        with self._lock:
            self._stall_s = float(seconds)
            self._n_stalls_injected += 1

    def swap_engine(self, new_engine: QuantizedEngine) -> float:
        """Exchange the serving engine. Blocks until the in-flight flush
        (if any) completes on the old engine; queued and future requests
        run the new one. Returns seconds spent waiting + swapping. The
        caller (the pool's rolling swap) warms ``new_engine`` first,
        under :meth:`on_stream` and ending in a synchronize of that
        stream, so the first post-swap flush reads weights that are on
        the card. ``new_engine`` must be on the replica's device."""
        if new_engine.device != self.engine.device:
            raise ValueError(f"engine on {new_engine.device}, replica "
                             f"{self.replica_id} on {self.engine.device}")
        t0 = time.monotonic()
        with self._engine_lock:
            self.engine = new_engine
        return time.monotonic() - t0

    def hold_admission(self, seconds: float) -> None:
        """Probation gate: ``accepting`` stays False (and ``try_submit``
        refuses) until ``seconds`` from now — how the pool re-admits a
        quarantined replica's replacement only after its probation
        window (warmup typically overlaps the hold)."""
        with self._lock:
            self._admit_at = time.monotonic() + float(seconds)

    def busy_duration(self) -> Optional[float]:
        """Seconds the worker has been inside its current unit of work
        (None when idle) — the stall signal the pool watchdog polls. A
        healthy flush holds this for milliseconds; an engine-lock stall
        holds it for the stall's duration."""
        with self._lock:
            if self._busy_since is None:
                return None
            return time.monotonic() - self._busy_since

    def flag_window(self):
        """(events, flagged) over the sliding breaker window — the
        flagged-rate the pool's circuit breaker trips on."""
        with self._lock:
            return len(self._recent_flags), sum(self._recent_flags)

    def expropriate(self, error: BaseException) -> List[RequestHandle]:
        """Forcibly take every unresolved handle away from this replica
        — called by the pool's watchdog (stalled worker) or circuit
        breaker (quarantine), from *outside* the worker thread, without
        touching the engine lock the worker may be stuck holding.

        The replica stops accepting; queued requests, queued chunks,
        and the in-flight work the worker is currently executing are
        all returned for the pool to requeue. The worker, whenever it
        wakes, sees ``_expropriated``, still resolves its (now
        possibly duplicate) results — first resolution wins at the
        handle — and exits without the ``_die`` failover path, which
        the pool already performed on its behalf."""
        with self._lock:
            self._expropriated = True
            self._accepting = False
            orphans = (list(self._in_flight) + self._queue.drain_all()
                       + list(self._chunks))
            self._in_flight = []
            self._chunks.clear()
            self._m_depth.set(0.0)
            self._lock.notify()
        return [h for h in orphans if not h.done()]

    def kill(self, mode: str = "drain") -> None:
        """Inject a replica failure. ``mode="drain"``: stop before the
        next flush — queued requests become orphans for the pool to
        requeue. ``mode="in_flight"``: additionally fail the flush being
        formed, so requests that were already popped out of the queue
        (in flight) exercise the requeue path too."""
        if mode not in ("drain", "in_flight"):
            raise ValueError(f"unknown kill mode {mode!r}")
        with self._lock:
            self._fail_error = ReplicaFailed(
                f"replica {self.replica_id} killed ({mode})")
            if mode == "in_flight":
                self._fail_next_flush = True
            else:
                self._accepting = False
            self._lock.notify()

    def begin_close(self) -> None:
        """Phase 1 of shutdown: stop admitting, let the worker drain."""
        with self._lock:
            self._closing = True
            self._lock.notify()

    def join(self) -> None:
        self._worker.join()

    def close(self) -> None:
        self.begin_close()
        self.join()

    # -- telemetry -----------------------------------------------------------

    def records(self) -> List[FlushRecord]:
        with self._lock:
            return list(self._flushes)

    def recent_service_s(self, k: int = 4) -> List[float]:
        """Last k flushes' service times (cheap slice under the lock —
        the pool's retry_after estimate polls this per shed request)."""
        with self._lock:
            return [f.service_s for f in self._flushes[-k:]]

    def reset_records(self) -> None:
        """Zero phase-local telemetry: flush records and the
        completion/error counters (liveness state is untouched)."""
        with self._lock:
            self._flushes.clear()
            self._n_completed = 0
            self._n_errors = 0

    def snapshot(self) -> Dict[str, object]:
        """Heartbeat/health snapshot (stats.py style) for pool.stats()."""
        now = time.monotonic()
        with self._lock:
            sizes = [f.n_requests for f in self._flushes]
            return {
                "replica_id": self.replica_id,
                "device": str(self.engine.device) if self.engine.device
                          is not None else "default",
                "alive": self._accepting,
                "tier": self.engine.serve.mode,
                "on_probation": now < self._admit_at,
                "busy_s": (now - self._busy_since
                           if self._busy_since is not None else 0.0),
                "n_flagged": self._n_flagged,
                "artifact_version": self.engine.artifact_version,
                "queue_depth": self._queue.depth() + len(self._chunks),
                "chunk_depth": len(self._chunks),
                "n_completed": self._n_completed,
                "n_errors": self._n_errors,
                "n_chunks_completed": self._n_chunks_completed,
                "n_chunk_errors": self._n_chunk_errors,
                "chunk_service_s": self._chunk_service_s,
                "n_stalls_injected": self._n_stalls_injected,
                "n_flushes": len(self._flushes),
                "mean_batch": (sum(sizes) / len(sizes)) if sizes else 0.0,
                "warmup_s": self.warmup_s,
                "heartbeat_age_s": now - self._last_beat,
            }

    # -- worker side ---------------------------------------------------------

    def _die(self, in_flight: List[RequestHandle],
             error: BaseException) -> None:
        """Stop serving and hand every unresolved handle to the pool.
        Called from the worker thread with no locks held."""
        with self._lock:
            self._accepting = False
            orphans = in_flight + self._queue.drain_all() + list(self._chunks)
            self._chunks.clear()
            # a dead replica holds nothing: leaving the last pre-death
            # depth in the gauge would skew the summed fleet signal
            self._m_depth.set(0.0)
        self._on_failure(self, orphans, error)

    def _take_stall(self) -> float:
        with self._lock:
            s, self._stall_s = self._stall_s, 0.0
            return s

    def _run_chunk(self, chunk: ChunkHandle) -> bool:
        """Execute one session chunk on the worker thread. Returns False
        when the replica declared itself broken (a run of consecutive
        errors) and the worker must exit.

        A chunk exception resolves the error to the chunk's own handle —
        never a blind pool requeue: the session manager holds the
        authoritative pre-chunk state and decides whether re-running is
        safe (it always is, chunks are pure functions of that state, but
        the *decision* belongs to the layer that can also checkpoint)."""
        t0 = time.monotonic()
        if chunk.trace is not None:
            chunk.trace.begin("serve", t0, replica=self.replica_id,
                              tier=self.tier)
        chunk_error = None
        stall = self._take_stall()
        with self._engine_lock:   # swaps wait for the chunk, not v.v.
            if stall:
                time.sleep(stall)
            engine = self.engine
            try:
                with launch_role(f"chunk:{engine.serve.mode}"):
                    result = chunk.fn(engine)
            except BaseException as e:
                chunk_error = e
        if chunk_error is not None:
            with self._lock:
                self._busy_since = None
                self._in_flight = []
                if self._expropriated:
                    # pool already rehomed the chunk — do NOT resolve
                    # the error (the re-run elsewhere must win); exit
                    return False
                self._n_chunk_errors += 1
                self._consecutive_errors += 1
                broken = (self._consecutive_errors
                          >= self.MAX_CONSECUTIVE_ERRORS)
            self._m_chunks["error"].inc()
            chunk._resolve(error=chunk_error, replica_id=self.replica_id)
            if broken:
                self._die([], chunk_error)
                return False
            return True
        with self._lock:
            self._busy_since = None
            self._in_flight = []
            expropriated = self._expropriated
            self._n_chunks_completed += 1
            self._chunk_service_s += time.monotonic() - t0
            self._consecutive_errors = 0
            self._last_beat = time.monotonic()
        # a genuine result is still the best resolution — first resolve
        # wins if the pool's re-run already answered
        self._m_chunks["completed"].inc()
        chunk._resolve(result=result, replica_id=self.replica_id)
        return not expropriated

    def _run(self):
        try:
            # every launch of this thread: on the engine's card, on the
            # replica's stream, with grad mode on whatever the creating
            # thread had
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            with self.on_stream(), torch.enable_grad():
                if self._do_warmup:
                    with launch_role(f"warmup:{self.tier}"):
                        self.warmup_s = self.engine.warmup()
        except BaseException as e:
            self.ready.set()
            self._die([], e)
            return
        with self._lock:
            self._last_beat = time.monotonic()
        self.ready.set()
        try:
            with self.on_stream(), torch.enable_grad():
                self._serve()
        except BaseException as e:
            # a worker that dies outside a unit of work must not leave
            # admitted requests waiting: fail over what it holds
            with self._lock:
                held, self._in_flight = list(self._in_flight), []
                expropriated = self._expropriated
            if not expropriated:
                self._die([h for h in held if not h.done()], e)

    def _serve(self):
        while True:
            in_flight: List[RequestHandle] = []
            chunk: Optional[ChunkHandle] = None
            with self._lock:
                while True:
                    now = time.monotonic()
                    if self._expropriated:
                        # pool watchdog/breaker already rehomed every
                        # handle — exit without the _die failover path
                        return
                    if not self._accepting:          # killed (drain mode)
                        err = self._fail_error or ReplicaFailed(
                            f"replica {self.replica_id} failed")
                        picked = None
                        break
                    depth = self._queue.depth()     # pre-pop, FlushRecord
                    picked = self._queue.pick_flush(now,
                                                    drain=self._closing)
                    if picked is not None:
                        break
                    # flush-first, then chunks: latency-sensitive
                    # one-shot batches preempt bulk MD work at every
                    # chunk boundary (the chunk length is the session
                    # layer's latency/throughput knob — see
                    # docs/sessions.md)
                    if self._chunks:
                        chunk = self._chunks.popleft()
                        break
                    if self._closing and depth == 0:
                        return
                    ddl = self._queue.oldest_deadline()
                    self._lock.wait(
                        None if ddl is None else max(ddl - now, 0))
                if (picked is not None or chunk is not None) \
                        and self._fail_next_flush:
                    # injected in-flight failure: this work was popped
                    # (in flight) when the replica died
                    err = self._fail_error or ReplicaFailed(
                        f"replica {self.replica_id} failed in flight")
                    in_flight = picked[1] if picked is not None else [chunk]
                    picked = None
                    chunk = None
                    self._accepting = False
                if picked is not None or chunk is not None:
                    # watchdog surface: what the worker holds, since when
                    self._busy_since = time.monotonic()
                    self._in_flight = (list(picked[1]) if picked is not None
                                       else [chunk])
                    self._m_depth.set(self._queue.depth()
                                      + len(self._chunks))
            if picked is None and chunk is None:
                self._die(in_flight, err)
                return
            if chunk is not None:
                if not self._run_chunk(chunk):
                    return
                continue
            cap, handles, reason = picked
            wait_s = time.monotonic() - handles[0].t_submit
            t0 = time.monotonic()
            for h in handles:
                if h.trace is not None:
                    h.trace.begin("serve", t0, replica=self.replica_id,
                                  tier=self.tier, bucket=cap,
                                  flush_reason=reason)
            flush_error = None
            stall = self._take_stall()
            with self._engine_lock:   # swap waits for the flush, not v.v.
                if stall:
                    time.sleep(stall)
                engine = self.engine
                try:
                    with launch_role(f"flush:{engine.serve.mode}"):
                        results = engine.infer_batch(
                            [h.graph for h in handles], on_flag="mark")
                except BaseException as e:
                    flush_error = e
            if flush_error is not None:
                # resolve the error to this flush's handles (same as the
                # single-engine scheduler) — requeueing a poison request
                # would cascade-kill survivors. Only a run of erroring
                # flushes means the replica itself is broken: then fail
                # over the queued (never-attempted) work. All of this
                # runs with no locks held (_die's contract).
                with self._lock:
                    self._busy_since = None
                    self._in_flight = []
                    if self._expropriated:
                        # pool already requeued these handles elsewhere —
                        # resolving the error here could beat the re-run
                        return
                    self._n_errors += 1
                    self._consecutive_errors += 1
                    broken = (self._consecutive_errors
                              >= self.MAX_CONSECUTIVE_ERRORS)
                for h in handles:
                    h._resolve(error=flush_error,
                               replica_id=self.replica_id)
                if broken:
                    self._die([], flush_error)
                    return
                continue
            service_s = time.monotonic() - t0
            # stamp the escalation audit trail the pool appended to each
            # handle (and the obs trace id) into its delivered result
            results = [dataclasses.replace(
                           r, replica_id=self.replica_id,
                           escalations=tuple(h.escalations),
                           trace_id=(h.trace.trace_id
                                     if h.trace is not None else ""))
                       for h, r in zip(handles, results)]
            trace_ids = tuple(h.trace.trace_id for h in handles
                              if h.trace is not None)
            # stub engines in tests may not expose the profiling hook
            bd = getattr(engine, "last_infer_breakdown", None) or {}
            with self._lock:
                self._busy_since = None
                self._in_flight = []
                expropriated = self._expropriated
                self._n_completed += len(handles)
                self._consecutive_errors = 0
                self._last_beat = time.monotonic()
                self._flushes.append(FlushRecord(
                    capacity=cap, n_requests=len(handles), reason=reason,
                    queue_depth=depth, wait_s=wait_s, service_s=service_s,
                    path=results[0].path, batch_size=results[0].batch_size,
                    replica_id=self.replica_id, trace_ids=trace_ids,
                    prep_s=bd.get("prep_s", 0.0),
                    dispatch_s=bd.get("dispatch_s", 0.0),
                    sync_s=bd.get("sync_s", 0.0),
                    t_start=t0))
                # feed the circuit-breaker window (flush results only —
                # chunk health is the session layer's concern)
                for r in results:
                    self._recent_flags.append(bool(r.flags))
                self._n_flagged += sum(1 for r in results if r.flags)
            self._m_completed.inc(len(handles))
            self._m_wait.observe(wait_s)
            self._m_service.observe(service_s)
            self._m_service_r.observe(service_s)
            REGISTRY.counter("serve_flushes_total", surface="replica",
                             reason=reason).inc()
            for h, r in zip(handles, results):
                if h.trace is not None and r.flags:
                    for f in r.flags:
                        h.trace.event("guardrail_flag", reason=f.reason,
                                      severity=f.severity,
                                      replica=self.replica_id,
                                      tier=self.tier)
                if r.flags:
                    # triage, hook first (no replica locks held): the
                    # pool may take ownership and re-run one tier up
                    if self._on_flagged is not None \
                            and self._on_flagged(self, h, r):
                        continue
                    fatal = next((f for f in r.flags if f.fatal), None)
                    if fatal is not None:
                        h._resolve(error=GuardrailViolation(
                            f"guardrail {fatal.reason}: result withheld "
                            f"(replica {self.replica_id}, tier {self.tier})",
                            reason=fatal.reason, severity=fatal.severity,
                            detail={"value": fatal.value,
                                    "limit": fatal.limit,
                                    "mode": self.tier,
                                    "replica_id": self.replica_id}),
                            replica_id=self.replica_id)
                        continue
                    # suspect-only with nowhere to go: deliver annotated
                h._resolve(result=r, replica_id=self.replica_id)
            if expropriated:
                return
