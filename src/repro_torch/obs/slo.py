"""Declarative SLOs with multi-window burn-rate alerting: a copy of
``repro/obs/slo.py`` (stdlib only; the port imports nothing of the JAX
package, nor torch: the health monitor's thread never touches the card).

The metrics registry collects; this module is the half that *judges*
it. An :class:`SLO` declares an objective over the
:class:`~repro_torch.obs.metrics.MetricsRegistry` — a bad/total ratio, a
windowed latency quantile, a physics level gauge, or a discrete event
counter — and an :class:`SLOEvaluator` samples the registry on a
cadence, evaluates every SLO against the sampled history, and emits
typed :class:`Alert` objects (with the metric evidence attached) into
an :class:`AlertBus` on each ok->breached edge.

Burn-rate semantics (ratio SLOs) follow the Prometheus / SRE-workbook
multi-window pattern: the bad fraction is computed over a *fast* and a
*slow* trailing window from counter deltas between registry snapshots,
normalised by the objective into a burn rate, and the SLO breaches
only when **both** windows burn above ``burn_threshold`` — the slow
window keeps one bad blip from paging, the fast window ends the alert
quickly once the system recovers. Windowed quantile SLOs subtract
log-bucket histograms at the two window edges, so an old latency storm
ages out of the readout instead of polluting the cumulative p99
forever.

The catalogue (:func:`default_slos`) reads the series the port's
engine, scheduler, cluster, MD engine and sessions write, under the JAX
package's names and labels. Everything here is side-effect free against
the serving hot path: evaluation *reads* snapshots; the only writes are
the ``slo_breached{slo=...}`` status gauges and the
``repro_obs_alerts_total`` counter bumped by the bus.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry

__all__ = [
    "Alert", "AlertBus", "SLO", "SLOEvaluator", "HealthMonitor",
    "SampleWindow", "default_slos",
]


# --------------------------------------------------------------------------
# alerts


@dataclasses.dataclass(frozen=True)
class Alert:
    """One typed, attributed health event.

    ``source`` is ``"slo"`` or ``"anomaly"``; ``evidence`` carries the
    metric readouts that justified the alert (window deltas, burn
    rates, per-label values) so a subscriber — or a human reading the
    ``--alerts-out`` JSONL — can attribute it without re-deriving."""
    name: str
    severity: str              # "page" | "warn" | "info"
    source: str                # "slo" | "anomaly"
    message: str
    value: float = 0.0
    threshold: float = 0.0
    t: float = 0.0             # monotonic evaluation time
    wall_time: float = 0.0     # time.time() at emission
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    evidence: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict:
        return {
            "name": self.name, "severity": self.severity,
            "source": self.source, "message": self.message,
            "value": self.value, "threshold": self.threshold,
            "t": self.t, "wall_time": self.wall_time,
            "labels": dict(self.labels),
            "evidence": dict(self.evidence),
        }


class AlertBus:
    """Fan-out hub for alerts: bounded history + subscriber callbacks.

    Subscribers must not raise — if one does, the exception is swallowed
    and counted, because an alert consumer must never take down the
    evaluation loop (let alone serving). ``subscribe`` returns an
    unsubscribe callable. Every published alert also bumps
    ``repro_obs_alerts_total{name=,severity=}``."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 history: int = 256):
        self._lock = threading.Lock()
        self._subs: List[Callable[[Alert], None]] = []
        self._history: deque = deque(maxlen=history)
        self._counts: Dict[str, int] = {}
        self.registry = registry if registry is not None else REGISTRY
        self.n_published = 0
        self.n_subscriber_errors = 0

    def subscribe(self, fn: Callable[[Alert], None]) -> Callable[[], None]:
        with self._lock:
            self._subs.append(fn)

        def _unsubscribe() -> None:
            with self._lock:
                if fn in self._subs:
                    self._subs.remove(fn)
        return _unsubscribe

    def publish(self, alert: Alert) -> None:
        with self._lock:
            self._history.append(alert)
            self._counts[alert.name] = self._counts.get(alert.name, 0) + 1
            self.n_published += 1
            subs = list(self._subs)
        self.registry.counter("repro_obs_alerts_total",
                              alert=alert.name,
                              severity=alert.severity).inc()
        for fn in subs:
            try:
                fn(alert)
            except Exception:
                with self._lock:
                    self.n_subscriber_errors += 1

    def history(self) -> List[Alert]:
        with self._lock:
            return list(self._history)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


# --------------------------------------------------------------------------
# snapshot sampling


def _match(labels: Mapping[str, str], where: Mapping[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in where.items())


class _Sample:
    """One timestamped, indexed registry snapshot."""
    __slots__ = ("t", "counters", "gauges", "hists")

    def __init__(self, t: float, snapshot: Dict):
        self.t = t
        self.counters: Dict[str, List[Tuple[Dict, float]]] = {}
        self.gauges: Dict[str, List[Tuple[Dict, float]]] = {}
        self.hists: Dict[str, List[Tuple[Dict, Dict]]] = {}
        for e in snapshot.get("counters", ()):
            self.counters.setdefault(e["name"], []).append(
                (e["labels"], e["value"]))
        for e in snapshot.get("gauges", ()):
            self.gauges.setdefault(e["name"], []).append(
                (e["labels"], e["value"]))
        for e in snapshot.get("histograms", ()):
            self.hists.setdefault(e["name"], []).append((e["labels"], e))

    def counter_sum(self, name: str, where: Mapping[str, str]) -> float:
        return sum(v for lb, v in self.counters.get(name, ())
                   if _match(lb, where))

    def gauge_values(self, name: str, where: Mapping[str, str]
                     ) -> List[Tuple[Dict, float]]:
        return [(lb, v) for lb, v in self.gauges.get(name, ())
                if _match(lb, where)]

    def hist_agg(self, name: str, where: Mapping[str, str]
                 ) -> Tuple[int, float, Dict[str, int]]:
        """Summed ``(count, sum, buckets)`` over matching label sets."""
        count, total = 0, 0.0
        buckets: Dict[str, int] = {}
        for lb, e in self.hists.get(name, ()):
            if not _match(lb, where):
                continue
            count += int(e.get("count", 0))
            total += float(e.get("sum", 0.0))
            for k, n in (e.get("buckets") or {}).items():
                buckets[k] = buckets.get(k, 0) + int(n)
        return count, total, buckets


class SampleWindow:
    """Bounded deque of timestamped registry samples with windowed
    delta readouts. Shared by the SLO evaluator and the anomaly
    monitor (:mod:`repro_torch.obs.anomaly`)."""

    def __init__(self, maxlen: int = 512):
        self.samples: deque = deque(maxlen=maxlen)

    def sample(self, registry: MetricsRegistry,
               now: Optional[float] = None) -> _Sample:
        s = _Sample(time.monotonic() if now is None else now,
                    registry.snapshot())
        self.samples.append(s)
        return s

    @property
    def latest(self) -> Optional[_Sample]:
        return self.samples[-1] if self.samples else None

    @property
    def previous(self) -> Optional[_Sample]:
        return self.samples[-2] if len(self.samples) >= 2 else None

    def at_or_before(self, t: float,
                     allow_partial: bool = False) -> Optional[_Sample]:
        """Newest sample with ``sample.t <= t`` — the far edge of a
        trailing window ending at the latest sample. ``allow_partial``
        falls back to the oldest sample when the history does not yet
        span the window (rates are then over the available history —
        still sound, just a shorter window)."""
        best = None
        for s in self.samples:
            if s.t <= t + 1e-9:
                best = s
            else:
                break
        if best is None and allow_partial and self.samples:
            best = self.samples[0]
        return best

    def counter_delta(self, name: str, where: Mapping[str, str],
                      window_s: float, allow_partial: bool = False
                      ) -> Optional[float]:
        """Counter increase over the trailing window; None when the
        history does not cover the window (unless ``allow_partial``)."""
        now = self.latest
        if now is None:
            return None
        then = self.at_or_before(now.t - window_s, allow_partial)
        if then is None or then is now:
            return None
        return max(0.0, now.counter_sum(name, where)
                   - then.counter_sum(name, where))

    def hist_delta(self, name: str, where: Mapping[str, str],
                   window_s: float, allow_partial: bool = False
                   ) -> Optional[Tuple[int, float, Dict[str, int]]]:
        """Windowed ``(count, sum, buckets)`` histogram increase."""
        now = self.latest
        if now is None:
            return None
        then = self.at_or_before(now.t - window_s, allow_partial)
        if then is None or then is now:
            return None
        c1, s1, b1 = now.hist_agg(name, where)
        c0, s0, b0 = then.hist_agg(name, where)
        buckets = {k: n - b0.get(k, 0) for k, n in b1.items()
                   if n - b0.get(k, 0) > 0}
        return max(0, c1 - c0), max(0.0, s1 - s0), buckets


def quantile_from_buckets(buckets: Mapping[str, int], q: float) -> float:
    """Upper-edge quantile over a (possibly windowed-delta) log-bucket
    dict as emitted by ``Histogram.snapshot()["buckets"]`` — keys are
    stringified bucket indices, ``"u"`` for the underflow bucket."""
    total = sum(buckets.values())
    if total <= 0:
        return 0.0
    # None (underflow) sorts first, as in Histogram.percentile
    items = sorted((((None if k == "u" else int(k)), n)
                    for k, n in buckets.items()),
                   key=lambda kv: -math.inf if kv[0] is None else kv[0])
    target = q * total
    cum = 0
    for idx, n in items:
        cum += n
        if cum >= target:
            return _metrics.Histogram._bucket_edge(idx)
    return _metrics.Histogram._bucket_edge(items[-1][0])


# --------------------------------------------------------------------------
# SLO declaration + evaluation


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative service-level objective.

    ``kind`` selects the indicator:

    - ``"ratio"`` — bad/total counter fraction vs ``objective`` (the
      max acceptable bad fraction), multi-window burn-rate gated:
      breached only when ``(frac / objective) >= burn_threshold`` in
      BOTH the fast and the slow trailing window.
    - ``"quantile"`` — windowed histogram quantile ``q`` of ``metric``
      vs ``objective`` (an absolute bound, e.g. seconds), again gated
      on both windows.
    - ``"level"`` — latest value of gauge ``metric`` (max over matching
      label sets) vs ``objective``; no windows (a level is already a
      state, not a rate).
    - ``"event"`` — increase of counter ``metric`` since the previous
      evaluation step vs ``objective`` (default 0: any new event
      breaches). The first step arms the baseline, so events that
      pre-date the evaluator never fire.

    ``where`` / ``bad_where`` / ``total_where`` are label-subset
    filters; matching label sets are summed. ``allow_partial`` lets the
    windowed kinds evaluate before the history spans the slow window
    (short replays, startup) — strict coverage is the default."""
    name: str
    kind: str                                   # ratio|quantile|level|event
    description: str = ""
    severity: str = "page"
    metric: str = ""                            # quantile/level/event
    where: Mapping[str, str] = dataclasses.field(default_factory=dict)
    bad: str = ""                               # ratio: bad counter
    bad_where: Mapping[str, str] = dataclasses.field(default_factory=dict)
    total: str = ""                             # ratio: total counter
    total_where: Mapping[str, str] = dataclasses.field(default_factory=dict)
    objective: float = 0.0
    q: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 1.0
    min_events: int = 1
    allow_partial: bool = False
    runbook: str = ""

    def __post_init__(self):
        if self.kind not in ("ratio", "quantile", "level", "event"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "ratio" and not (self.bad and self.total):
            raise ValueError(f"ratio SLO {self.name!r} needs bad+total")
        if self.kind in ("quantile", "level", "event") and not self.metric:
            raise ValueError(f"{self.kind} SLO {self.name!r} needs metric")


class SLOEvaluator:
    """Samples a registry and evaluates a catalogue of SLOs.

    ``step()`` takes one snapshot, re-evaluates every SLO, publishes an
    :class:`Alert` per ok->breached edge (edge-triggered: a breach that
    persists does not re-page; it re-arms once the SLO clears), writes
    ``slo_breached{slo=...}`` status gauges, and returns the alerts it
    published this step. Pass ``now`` explicitly for deterministic
    tests."""

    def __init__(self, slos: Iterable[SLO],
                 registry: Optional[MetricsRegistry] = None,
                 bus: Optional[AlertBus] = None,
                 max_samples: int = 512):
        self.slos = list(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError("duplicate SLO names in catalogue")
        self.registry = registry if registry is not None else REGISTRY
        self.bus = bus
        self.window = SampleWindow(maxlen=max_samples)
        self._breached: Dict[str, bool] = {}
        self._event_base: Dict[str, Optional[float]] = {}
        self._status: Dict[str, Dict] = {}

    # -- per-kind evaluation ------------------------------------------

    def _eval_ratio(self, slo: SLO) -> Dict:
        out = {"breached": False, "value": 0.0, "evaluable": False,
               "evidence": {}}
        burns = {}
        for tag, w in (("fast", slo.fast_window_s),
                       ("slow", slo.slow_window_s)):
            bad = self.window.counter_delta(
                slo.bad, slo.bad_where, w, slo.allow_partial)
            tot = self.window.counter_delta(
                slo.total, slo.total_where, w, slo.allow_partial)
            if bad is None or tot is None:
                return out  # history does not cover the slow window yet
            frac = (bad / tot) if (tot >= slo.min_events
                                   and tot > 0) else 0.0
            burn = frac / max(slo.objective, 1e-12)
            burns[tag] = burn
            out["evidence"][f"{tag}_window_s"] = w
            out["evidence"][f"{tag}_bad"] = bad
            out["evidence"][f"{tag}_total"] = tot
            out["evidence"][f"{tag}_burn"] = burn
        out["evaluable"] = True
        out["value"] = burns["fast"]
        out["breached"] = (burns["fast"] >= slo.burn_threshold
                           and burns["slow"] >= slo.burn_threshold)
        return out

    def _eval_quantile(self, slo: SLO) -> Dict:
        out = {"breached": False, "value": 0.0, "evaluable": False,
               "evidence": {}}
        qs = {}
        for tag, w in (("fast", slo.fast_window_s),
                       ("slow", slo.slow_window_s)):
            d = self.window.hist_delta(
                slo.metric, slo.where, w, slo.allow_partial)
            if d is None:
                return out
            count, _, buckets = d
            if count < slo.min_events:
                qs[tag] = 0.0
            else:
                qs[tag] = quantile_from_buckets(buckets, slo.q)
            out["evidence"][f"{tag}_window_s"] = w
            out["evidence"][f"{tag}_count"] = count
            out["evidence"][f"{tag}_q{slo.q:g}"] = qs[tag]
        out["evaluable"] = True
        out["value"] = qs["fast"]
        out["breached"] = (qs["fast"] > slo.objective
                          and qs["slow"] > slo.objective)
        return out

    def _eval_level(self, slo: SLO) -> Dict:
        out = {"breached": False, "value": 0.0, "evaluable": False,
               "evidence": {}}
        now = self.window.latest
        if now is None:
            return out
        vals = now.gauge_values(slo.metric, slo.where)
        if not vals:
            return out  # gauge never written: objective not armed
        level = max(v for _, v in vals)
        out["evaluable"] = True
        out["value"] = level
        out["breached"] = level > slo.objective
        out["evidence"]["levels"] = {
            _metrics.label_suffix(lb) or "{}": v for lb, v in vals}
        return out

    def _eval_event(self, slo: SLO) -> Dict:
        out = {"breached": False, "value": 0.0, "evaluable": False,
               "evidence": {}}
        now = self.window.latest
        if now is None:
            return out
        cur = now.counter_sum(slo.metric, slo.where)
        base = self._event_base.get(slo.name)
        self._event_base[slo.name] = cur
        if base is None:
            return out  # first step arms the baseline
        delta = max(0.0, cur - base)
        out["evaluable"] = True
        out["value"] = delta
        out["breached"] = delta > slo.objective
        out["evidence"]["delta"] = delta
        out["evidence"]["cumulative"] = cur
        return out

    _EVAL = {"ratio": _eval_ratio, "quantile": _eval_quantile,
             "level": _eval_level, "event": _eval_event}

    # -- stepping ------------------------------------------------------

    def step(self, now: Optional[float] = None) -> List[Alert]:
        self.window.sample(self.registry, now)
        t = self.window.latest.t
        alerts: List[Alert] = []
        for slo in self.slos:
            # one misconfigured SLO must not kill the rest of the
            # catalogue — isolate, surface, keep evaluating
            try:
                res = self._EVAL[slo.kind](self, slo)
            except Exception as e:
                self.registry.counter("repro_obs_health_eval_errors_total",
                                      stepper="slo", slo=slo.name).inc()
                self._status[slo.name] = {
                    "kind": slo.kind, "severity": slo.severity,
                    "breached": False, "evaluable": False, "errored": True,
                    "error": f"{type(e).__name__}: {e}",
                    "value": 0.0, "objective": slo.objective, "t": t,
                }
                continue
            breached = bool(res["breached"])
            was = self._breached.get(slo.name, False)
            self._breached[slo.name] = breached
            self._status[slo.name] = {
                "kind": slo.kind, "severity": slo.severity,
                "breached": breached, "evaluable": res["evaluable"],
                "value": res["value"], "objective": slo.objective,
                "t": t,
            }
            self.registry.gauge("slo_breached", slo=slo.name).set(
                1.0 if breached else 0.0)
            if breached and not was:
                evidence = dict(res["evidence"])
                evidence["slo_kind"] = slo.kind
                alerts.append(Alert(
                    name=slo.name, severity=slo.severity, source="slo",
                    message=(slo.description or slo.name)
                    + f": value {res['value']:.6g} vs objective "
                      f"{slo.objective:.6g}",
                    value=float(res["value"]), threshold=slo.objective,
                    t=t, wall_time=time.time(),
                    labels={"slo": slo.name}, evidence=evidence))
        if self.bus is not None:
            for a in alerts:
                self.bus.publish(a)
        return alerts

    def status(self) -> Dict[str, Dict]:
        """Latest per-SLO readout (breached / value / evaluable)."""
        return {k: dict(v) for k, v in self._status.items()}


# --------------------------------------------------------------------------
# background monitor


class HealthMonitor:
    """Drives one or more steppers (:class:`SLOEvaluator`,
    :class:`~repro_torch.obs.anomaly.AnomalyMonitor`) on a background
    interval thread. ``step_all(now)`` is the synchronous path for
    deterministic tests and final flushes."""

    def __init__(self, steppers: Iterable, interval_s: float = 1.0):
        self.steppers = list(steppers)
        self.interval_s = max(0.02, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.n_steps = 0

    def step_all(self, now: Optional[float] = None) -> List[Alert]:
        alerts: List[Alert] = []
        for s in self.steppers:
            try:
                alerts.extend(s.step(now))
            except Exception:
                # health evaluation must never take down serving, but a
                # dead stepper must still be visible to the operator
                reg = getattr(s, "registry", None) or REGISTRY
                reg.counter("repro_obs_health_eval_errors_total",
                            stepper=type(s).__name__).inc()
        self.n_steps += 1
        return alerts

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.step_all()

    def start(self) -> "HealthMonitor":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-health", daemon=True)
            self._thread.start()
        return self

    def stop(self, final_step: bool = True) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if final_step:
            self.step_all()


# --------------------------------------------------------------------------
# catalogue


def default_slos(fast_window_s: float = 60.0,
                 slow_window_s: float = 300.0,
                 latency_p99_s: float = 0.5,
                 shed_objective: float = 0.01,
                 escalation_objective: float = 0.02,
                 frame_loss_objective: float = 1e-3,
                 allow_partial: bool = False) -> List[SLO]:
    """The stack's stock SLO catalogue (docs/observability.md has the
    table + runbooks). Thresholds are constructor knobs so short chaos
    replays can shrink the windows without redefining the catalogue."""
    w = dict(fast_window_s=fast_window_s, slow_window_s=slow_window_s,
             allow_partial=allow_partial)
    return [
        SLO(name="latency_p99", kind="quantile",
            metric="serve_request_latency_seconds",
            where={"kind": "request"}, q=0.99, objective=latency_p99_s,
            min_events=20, severity="page",
            description="windowed request p99 latency",
            runbook="check replica skew + compile storms in obs_top; "
                    "trace_report --chrome-trace for the flush timeline",
            **w),
        SLO(name="shed_rate", kind="ratio",
            bad="serve_requests_total", bad_where={"event": "shed"},
            total="serve_requests_total",
            total_where={"event": "submitted"},
            objective=shed_objective, severity="page",
            description="admission shed fraction",
            runbook="queue depths in obs_top; raise max_queue or "
                    "add replicas",
            **w),
        SLO(name="escalation_rate", kind="ratio",
            bad="pool_events_total", bad_where={"event": "escalated"},
            total="serve_requests_total",
            total_where={"event": "submitted"},
            objective=escalation_objective, severity="warn",
            description="guardrail escalation fraction",
            runbook="guard_snapshot per-detector counts; check input "
                    "distribution vs calibration (docs/guardrails.md)",
            **w),
        SLO(name="session_frame_loss", kind="ratio",
            bad="session_frames_total", bad_where={"event": "lost"},
            total="session_frames_total", total_where={},
            objective=frame_loss_objective, severity="page",
            description="MD session frame loss fraction",
            runbook="sessions stats + checkpoint lag; resume from "
                    "last checkpoint (docs/sessions.md)",
            **w),
        SLO(name="md_energy_drift", kind="level",
            metric="md_energy_drift_ratio", objective=1.0,
            severity="page",
            description="MD energy drift vs configured limit",
            runbook="session escalates the chunk a tier up; if w8a8 "
                    "still drifts, shrink dt or check the artifact",
            ),
        SLO(name="lee_probe_level", kind="level",
            metric="engine_lee_probe_level", objective=1.0,
            severity="warn",
            description="local equivariance error probe vs limit",
            runbook="LEE above limit means quantization broke "
                    "SO(3) consistency: recalibrate / raise bits",
            ),
        SLO(name="replica_failure", kind="event",
            metric="pool_events_total",
            where={"event": "replica_failure"}, objective=0.0,
            severity="page", description="replica worker died",
            runbook="pool respawns + requeues automatically; check "
                    "the replica's last flush in the timeline",
            ),
        SLO(name="replica_stall", kind="event",
            metric="pool_events_total",
            where={"event": "stall_detected"}, objective=0.0,
            severity="page", description="replica stalled past "
            "stall_timeout_s (watchdog quarantined it)",
            runbook="usually a wedged device dispatch; inspect the "
                    "quarantined replica's flush breakdown",
            ),
    ]
