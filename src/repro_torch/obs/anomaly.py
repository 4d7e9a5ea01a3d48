"""Rolling-window anomaly detectors for things SLOs can't pre-declare:
a copy of ``repro/obs/anomaly.py`` (stdlib only, no torch).

An SLO needs a known objective; these detectors instead learn a
baseline online and flag *change*: queue-depth runaway, compile storms
(warmup histogram spikes mid-serving), per-replica latency
skew, and escalation-rate trend breaks. Two statistics back them:

- :class:`EwmaZScore` — exponentially-weighted mean/variance with a
  z-score readout against the pre-update baseline.
- :func:`robust_zscore` — median/MAD z-score over a bounded history;
  with a constant baseline (MAD 0) any departure scores ``inf``, which
  is exactly the semantics a compile-storm detector wants ("steady
  state is zero compiles; any compile is a spike").

Detectors read the same :class:`~repro_torch.obs.slo.SampleWindow`
snapshot history the SLO evaluator uses, operate on *deltas* between samples
(so pre-existing counter totals never fire), are edge-triggered, and
carry explicit floors (``min_depth``, ``min_events``) so a quiet
system cannot alert on noise — the chaos drill's clean arm gates that
property at zero false positives.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Mapping, Optional

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.slo import Alert, AlertBus, SampleWindow

__all__ = [
    "EwmaZScore", "robust_zscore", "Detector", "QueueDepthRunaway",
    "CompileStorm", "ReplicaLatencySkew", "EscalationTrend",
    "AnomalyMonitor", "default_detectors",
]


class EwmaZScore:
    """Online EWMA mean/variance with z-score against the baseline.

    ``score(x)`` is evaluated BEFORE ``update(x)`` folds the point in,
    so a spike is judged against the pre-spike baseline. Needs
    ``min_points`` updates before it scores (returns 0.0 until then)."""

    def __init__(self, alpha: float = 0.3, min_points: int = 3,
                 eps: float = 1e-9):
        self.alpha = float(alpha)
        self.min_points = int(min_points)
        self.eps = float(eps)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def score(self, x: float) -> float:
        if self.n < self.min_points:
            return 0.0
        return (x - self.mean) / math.sqrt(self.var + self.eps)

    def update(self, x: float) -> None:
        if self.n == 0:
            self.mean = float(x)
            self.var = 0.0
        else:
            d = x - self.mean
            incr = self.alpha * d
            self.mean += incr
            self.var = (1.0 - self.alpha) * (self.var + d * incr)
        self.n += 1


def robust_zscore(history, x: float, eps: float = 1e-12) -> float:
    """Median/MAD z-score of ``x`` against ``history`` (MAD scaled by
    1.4826 to estimate sigma). A constant history (MAD 0) scores any
    departure as ``+/-inf`` and an exact match as 0.0."""
    xs = sorted(history)
    if not xs:
        return 0.0

    def _median(vals):
        m = len(vals) // 2
        return (vals[m] if len(vals) % 2
                else 0.5 * (vals[m - 1] + vals[m]))
    med = _median(xs)
    mad = _median(sorted(abs(v - med) for v in xs))
    if mad < eps:
        if abs(x - med) < eps:
            return 0.0
        return math.inf if x > med else -math.inf
    return (x - med) / (1.4826 * mad)


class Detector:
    """Base class: ``check(window)`` returns a breach dict (message,
    value, threshold, evidence) or None. Subclasses keep their own
    online state; the monitor handles edge-triggering + publishing."""
    name = "detector"
    severity = "warn"

    def check(self, window: SampleWindow) -> Optional[Dict]:
        raise NotImplementedError


class QueueDepthRunaway(Detector):
    """Total queue depth growing without bound: depth above an
    absolute floor AND strictly increasing for ``consecutive`` samples
    AND a robust z-score break vs the trailing depth history. The
    floor keeps an idle/low-rate system from ever firing."""
    name = "queue_depth_runaway"
    severity = "page"

    def __init__(self, gauge: str = "cluster_queue_depth",
                 min_depth: float = 8.0, consecutive: int = 3,
                 z_threshold: float = 4.0, history: int = 64):
        self.gauge = gauge
        self.min_depth = float(min_depth)
        self.consecutive = int(consecutive)
        self.z_threshold = float(z_threshold)
        self._depths: deque = deque(maxlen=history)

    def check(self, window: SampleWindow) -> Optional[Dict]:
        now = window.latest
        if now is None:
            return None
        depth = sum(v for _, v in now.gauge_values(self.gauge, {}))
        baseline = list(self._depths)
        self._depths.append(depth)
        if depth < self.min_depth:
            return None
        k = self.consecutive
        if len(baseline) < k + 2:
            return None
        recent = baseline[-k:] + [depth]
        if not all(b < a for b, a in zip(recent, recent[1:])):
            return None
        z = robust_zscore(baseline[:-k] or baseline, depth)
        if z <= self.z_threshold:
            return None
        return {"message": f"queue depth runaway: {depth:.0f} and "
                           f"rising for {k} samples (z={z:.2f})",
                "value": depth, "threshold": self.min_depth,
                "evidence": {"depth": depth, "z": z,
                             "recent": recent}}


class CompileStorm(Detector):
    """New "compiles" observed mid-serving. On the card there is no XLA
    compile: a "compile" is the first run of a (bucket, batch class,
    path) shape, which builds the CUDA kernels on first use and is timed
    into ``engine_warmup_compile_seconds`` by ``QuantizedEngine.warmup``
    (a warmup on a swap or a cold restart counts too). Steady-state
    serving on a warmed bucket ladder runs no such warmup, so the
    baseline of per-sample count deltas is 0 and any burst of
    ``min_compiles`` or more in one sampling interval fires. The
    thresholds are the JAX package's."""
    name = "compile_storm"
    severity = "warn"

    def __init__(self, hist: str = "engine_warmup_compile_seconds",
                 min_compiles: int = 1, warm_samples: int = 2):
        self.hist = hist
        self.min_compiles = int(min_compiles)
        self.warm_samples = int(warm_samples)
        self._seen = 0

    def check(self, window: SampleWindow) -> Optional[Dict]:
        now, prev = window.latest, window.previous
        self._seen += 1
        if now is None or prev is None:
            return None
        c1, s1, _ = now.hist_agg(self.hist, {})
        c0, s0, _ = prev.hist_agg(self.hist, {})
        delta = c1 - c0
        # startup warmup lands between the first samples; don't page on it
        if self._seen <= self.warm_samples:
            return None
        if delta < self.min_compiles:
            return None
        return {"message": f"compile storm: {delta} new compile(s) "
                           f"({s1 - s0:.2f}s) in one interval",
                "value": float(delta),
                "threshold": float(self.min_compiles),
                "evidence": {"new_compiles": delta,
                             "compile_seconds": s1 - s0}}


class ReplicaLatencySkew(Detector):
    """One replica serving far slower than its peers: per-replica mean
    flush service time over a trailing window (from
    ``replica_flush_seconds{replica=...}`` deltas); fires when the
    slowest qualifying replica's mean exceeds ``ratio`` times the
    median of the qualifying means. Needs at least two replicas with
    ``min_events`` flushes in the window."""
    name = "replica_latency_skew"
    severity = "warn"

    def __init__(self, hist: str = "replica_flush_seconds",
                 ratio: float = 4.0, min_events: int = 8,
                 window_s: float = 10.0):
        self.hist = hist
        self.ratio = float(ratio)
        self.min_events = int(min_events)
        self.window_s = float(window_s)

    def check(self, window: SampleWindow) -> Optional[Dict]:
        now = window.latest
        if now is None:
            return None
        then = window.at_or_before(now.t - self.window_s,
                                   allow_partial=True)
        if then is None or then is now:
            return None
        means: Dict[str, float] = {}
        for lb, e in now.hists.get(self.hist, ()):
            rep = lb.get("replica", "?")
            c0, s0, _ = then.hist_agg(self.hist, {"replica": rep})
            dc = int(e.get("count", 0)) - c0
            ds = float(e.get("sum", 0.0)) - s0
            if dc >= self.min_events:
                means[rep] = ds / dc
        if len(means) < 2:
            return None
        vals = sorted(means.values())
        med = vals[len(vals) // 2] if len(vals) % 2 else 0.5 * (
            vals[len(vals) // 2 - 1] + vals[len(vals) // 2])
        worst_rep = max(means, key=means.get)
        worst = means[worst_rep]
        if med <= 0 or worst < self.ratio * med:
            return None
        return {"message": f"replica {worst_rep} mean flush "
                           f"{worst * 1e3:.2f}ms vs fleet median "
                           f"{med * 1e3:.2f}ms",
                "value": worst / med, "threshold": self.ratio,
                "evidence": {"means_ms":
                             {r: m * 1e3 for r, m in means.items()},
                             "worst_replica": worst_rep}}


class EscalationTrend(Detector):
    """Escalation-rate trend break: robust z-score of the current
    per-sample escalation delta against the trailing delta history.
    A quiet fleet has an all-zero baseline, so the first escalation
    burst scores ``inf`` and fires; a persistently-escalating fleet
    folds the rate into the baseline and the alert clears (this is a
    change detector — the sustained level is ``escalation_rate``'s
    SLO to judge)."""
    name = "escalation_trend"
    severity = "warn"

    def __init__(self, counter: str = "pool_events_total",
                 where: Optional[Mapping[str, str]] = None,
                 z_threshold: float = 3.0, min_delta: float = 1.0,
                 history: int = 64):
        self.counter = counter
        self.where = dict(where) if where else {"event": "escalated"}
        self.z_threshold = float(z_threshold)
        self.min_delta = float(min_delta)
        self._deltas: deque = deque(maxlen=history)
        self._prev: Optional[float] = None

    def check(self, window: SampleWindow) -> Optional[Dict]:
        now = window.latest
        if now is None:
            return None
        cur = now.counter_sum(self.counter, self.where)
        prev, self._prev = self._prev, cur
        if prev is None:
            return None  # first sample arms the baseline
        delta = max(0.0, cur - prev)
        baseline = list(self._deltas)
        self._deltas.append(delta)
        if delta < self.min_delta or len(baseline) < 3:
            return None
        z = robust_zscore(baseline, delta)
        if z <= self.z_threshold:
            return None
        return {"message": f"escalation trend break: {delta:.0f} "
                           f"escalation(s) this interval (z={z:.2f})",
                "value": delta, "threshold": self.min_delta,
                "evidence": {"delta": delta, "z": z,
                             "cumulative": cur}}


def default_detectors() -> List[Detector]:
    return [QueueDepthRunaway(), CompileStorm(), ReplicaLatencySkew(),
            EscalationTrend()]


class AnomalyMonitor:
    """Steps a set of detectors over fresh registry samples; same
    ``step(now)`` contract as
    :class:`~repro_torch.obs.slo.SLOEvaluator`, so a
    :class:`~repro_torch.obs.slo.HealthMonitor` can drive both. Detector
    hits are edge-triggered into the bus and mirrored to
    ``anomaly_active{detector=...}`` gauges."""

    def __init__(self, detectors: Optional[List[Detector]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 bus: Optional[AlertBus] = None,
                 max_samples: int = 512):
        self.detectors = (default_detectors() if detectors is None
                          else list(detectors))
        self.registry = registry if registry is not None else REGISTRY
        self.bus = bus
        self.window = SampleWindow(maxlen=max_samples)
        self._active: Dict[str, bool] = {}
        self._lock = threading.Lock()

    def step(self, now: Optional[float] = None) -> List[Alert]:
        with self._lock:
            self.window.sample(self.registry, now)
            t = self.window.latest.t
            alerts: List[Alert] = []
            for det in self.detectors:
                try:
                    hit = det.check(self.window)
                except Exception:
                    hit = None  # a broken detector must not stop the rest
                active = hit is not None
                was = self._active.get(det.name, False)
                self._active[det.name] = active
                self.registry.gauge("anomaly_active",
                                    detector=det.name).set(
                    1.0 if active else 0.0)
                if active and not was:
                    alerts.append(Alert(
                        name=det.name, severity=det.severity,
                        source="anomaly", message=hit["message"],
                        value=float(hit.get("value", 0.0)),
                        threshold=float(hit.get("threshold", 0.0)),
                        t=t, wall_time=time.time(),
                        labels={"detector": det.name},
                        evidence=dict(hit.get("evidence", {}))))
        if self.bus is not None:
            for a in alerts:
                self.bus.publish(a)
        return alerts

    def status(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self._active)
