"""Per-request trace spans for the serving stack: a copy of
``repro/obs/trace.py`` (stdlib only; the port imports nothing of the JAX
package, so a trace from either package reads the same).

A :class:`RequestTrace` is minted when a :class:`RequestHandle` is
created (``MicroBatchScheduler.submit`` / ``ClusterPool.submit`` /
``submit_chunk``) and rides the handle through queueing, flushes,
escalation re-runs, and failover requeues until ``_resolve`` finishes
it. The span model is a *tiling* state machine:

- the root span covers exactly ``[t_submit, t_done]``;
- child spans (``queue`` / ``serve``) partition that interval with no
  gaps and no overlap, because ``begin(name, now)`` closes the open
  child at the same ``now`` it opens the next one, and ``finish(now)``
  closes the last child and the root at the same ``now`` that
  ``RequestHandle._resolve`` stamps into ``t_done``.

So "child durations sum to the end-to-end latency" is structural, not
a timing-noise property. Escalation hops (``EscalationRecord``),
failover requeues, guardrail flags, and session checkpoints attach as
span *events*; each re-entry into a queue bumps the trace's ``hop``
counter so a latency report can attribute first-attempt time vs
escalation/requeue time.

Everything here is stdlib-only and thread-safe. Tracing is **off** by
default: ``Tracer.start_request`` returns ``None`` and every hook in
the hot path is a ``handle.trace is not None`` check.

All span timestamps are ``time.monotonic()`` (duration math); the only
wall-clock field is ``wall_time``, stamped once at ``finish`` for
export/correlation.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "RequestTrace", "Tracer", "TRACER",
           "configure_tracing", "get_tracer"]


class Span:
    __slots__ = ("span_id", "parent_id", "name", "t0", "t1", "attrs")

    def __init__(self, span_id: str, parent_id: Optional[str], name: str,
                 t0: float, attrs: Optional[Dict] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs or {}

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def to_json(self) -> Dict:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "t0": self.t0, "t1": self.t1,
                "duration_s": self.duration_s, "attrs": dict(self.attrs)}


class RequestTrace:
    """Span tree for one request/chunk. See module docstring for the
    tiling invariant. All methods are no-ops after ``finish`` — late
    writers (a stalled worker completing a flush the watchdog already
    expropriated and a survivor already resolved) cannot corrupt a
    delivered trace, mirroring ``RequestHandle``'s first-resolution-wins
    rule."""

    __slots__ = ("trace_id", "kind", "attrs", "hop", "status",
                 "wall_time", "root", "spans", "events",
                 "_open", "_seq", "_lock", "_finished", "_on_finish")

    def __init__(self, trace_id: str, kind: str, t0: float,
                 attrs: Optional[Dict] = None,
                 on_finish: Optional[Callable[["RequestTrace"], None]] = None):
        self.trace_id = trace_id
        self.kind = kind
        self.attrs: Dict = dict(attrs or {})
        self.hop = 0
        self.status = "open"
        self.wall_time: Optional[float] = None
        self.root = Span("0", None, kind, t0)
        self.spans: List[Span] = []
        self.events: List[Dict] = []
        self._open: Optional[Span] = None
        self._seq = 0
        self._lock = threading.Lock()
        self._finished = False
        self._on_finish = on_finish
        # every request is born queued
        self._begin_locked("queue", t0, {})

    # -- span state machine ---------------------------------------------

    def _begin_locked(self, name: str, now: float, attrs: Dict) -> None:
        if self._open is not None:
            self._open.t1 = now
        self._seq += 1
        attrs = dict(attrs)
        attrs.setdefault("hop", self.hop)
        span = Span(str(self._seq), self.root.span_id, name, now, attrs)
        self.spans.append(span)
        self._open = span

    def begin(self, name: str, now: Optional[float] = None,
              **attrs) -> None:
        """Close the open segment and start ``name`` at the same
        instant (segments tile by construction)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._finished:
                return
            self._begin_locked(name, now, attrs)

    def event(self, name: str, now: Optional[float] = None,
              **attrs) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._finished:
                return
            self.events.append({"t": now, "name": name,
                                "attrs": dict(attrs)})

    def bump_hop(self) -> int:
        """A re-entry into a queue (escalation / failover requeue)."""
        with self._lock:
            if not self._finished:
                self.hop += 1
            return self.hop

    def set_attr(self, key: str, value) -> None:
        with self._lock:
            if not self._finished:
                self.attrs[key] = value

    def finish(self, now: Optional[float] = None, status: str = "ok",
               **attrs) -> None:
        """Close the open segment and the root at the same instant.
        Idempotent; first finish wins."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._finished:
                return
            self._finished = True
            if self._open is not None:
                self._open.t1 = now
                self._open = None
            self.root.t1 = now
            self.status = status
            self.attrs.update(attrs)
            self.wall_time = time.time()  # export timestamp only
        if self._on_finish is not None:
            self._on_finish(self)

    @property
    def finished(self) -> bool:
        return self._finished

    # -- readout ----------------------------------------------------------

    def to_json(self) -> Dict:
        with self._lock:
            return {
                "trace_id": self.trace_id,
                "kind": self.kind,
                "status": self.status,
                "wall_time": self.wall_time,
                "t0": self.root.t0,
                "t1": self.root.t1,
                "duration_s": self.root.duration_s,
                "hops": self.hop,
                "attrs": dict(self.attrs),
                "spans": [self.root.to_json()] + [s.to_json()
                                                  for s in self.spans],
                "events": [dict(e) for e in self.events],
            }


class Tracer:
    """Process-wide trace collector.

    Disabled by default — ``start_request`` returns ``None`` so every
    instrumentation site degrades to one attribute check. When enabled,
    finished traces land in a bounded ring buffer (``drain()``) and,
    if configured, a sink's ``write(dict)`` (e.g.
    :class:`repro_torch.obs.export.JsonlTraceSink`).

    Sink export is **asynchronous**: ``_complete`` (called from the
    serving worker's ``_resolve``) only appends the finished trace to a
    queue; a background thread does the ``to_json`` + serialization +
    file I/O, overlapping with engine compute instead of stalling the
    flush loop. ``flush()`` blocks until the queue is drained;
    ``configure`` flushes before disabling or swapping the sink, so
    "disable then read the sink file" sees every finished trace.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = False
        self._sink = None
        self._completed: deque = deque(maxlen=4096)
        self._ids = itertools.count(1)
        self.n_started = 0
        self.n_finished = 0
        self.n_sink_errors = 0
        # async sink export (see class docstring)
        self._export_cv = threading.Condition()
        self._export_q: deque = deque()
        self._export_busy = False
        self._export_thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, enabled: Optional[bool] = None, sink=None,
                  capacity: Optional[int] = None) -> "Tracer":
        if enabled is False or sink is not None:
            # drain pending exports into the *old* sink before it is
            # detached/replaced
            self.flush()
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
            if sink is not None or enabled is False:
                self._sink = sink
            if capacity is not None:
                self._completed = deque(self._completed, maxlen=capacity)
        return self

    def start_request(self, kind: str = "request",
                      t0: Optional[float] = None,
                      **attrs) -> Optional[RequestTrace]:
        if not self._enabled:
            return None
        t0 = time.monotonic() if t0 is None else t0
        trace_id = f"{kind[:1]}-{next(self._ids):08d}"
        with self._lock:
            self.n_started += 1
        return RequestTrace(trace_id, kind, t0, attrs,
                            on_finish=self._complete)

    def _complete(self, trace: RequestTrace) -> None:
        # hot path (worker thread inside _resolve): two appends, no
        # serialization — to_json happens lazily in drain()/the export
        # thread; a finished trace is immutable so deferral is safe
        with self._lock:
            self.n_finished += 1
            self._completed.append(trace)
            sink = self._sink
        if sink is not None:
            with self._export_cv:
                self._export_q.append(trace)
                if (self._export_thread is None
                        or not self._export_thread.is_alive()):
                    self._export_thread = threading.Thread(
                        target=self._export_loop, name="trace-export",
                        daemon=True)
                    self._export_thread.start()
                self._export_cv.notify()

    def _export_loop(self) -> None:
        while True:
            with self._export_cv:
                while not self._export_q:
                    self._export_busy = False
                    self._export_cv.notify_all()
                    self._export_cv.wait()
                trace = self._export_q.popleft()
                self._export_busy = True
            sink = self._sink
            if sink is None:
                continue
            try:
                sink.write(trace.to_json())
            except Exception:
                with self._lock:
                    self.n_sink_errors += 1

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every queued trace has been handed to the sink.
        Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._export_cv:
            while self._export_q or self._export_busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._export_cv.wait(remaining)
        return True

    def drain(self) -> List[Dict]:
        """Pop and return every buffered finished trace."""
        with self._lock:
            out = list(self._completed)
            self._completed.clear()
        return [t.to_json() for t in out]

    def reset(self) -> None:
        with self._export_cv:
            self._export_q.clear()
        with self._lock:
            self._completed.clear()
            self.n_started = 0
            self.n_finished = 0
            self.n_sink_errors = 0


#: The process-wide tracer every handle mints from.
TRACER = Tracer()


def configure_tracing(enabled: Optional[bool] = None, sink=None,
                      capacity: Optional[int] = None) -> Tracer:
    return TRACER.configure(enabled=enabled, sink=sink, capacity=capacity)


def get_tracer() -> Tracer:
    return TRACER
