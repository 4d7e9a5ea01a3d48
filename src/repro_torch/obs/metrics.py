"""Process-wide metrics registry: a copy of ``repro/obs/metrics.py``.

Stdlib only, copied so the port imports nothing of the JAX package; the
metric names, labels and readouts are the JAX package's, so one
dashboard reads either. Three instrument kinds:

- :class:`Counter` — monotonic float total (Prometheus counter
  semantics), keyed by ``(name, labels)`` in the process-wide registry.
- :class:`Gauge` — last-write-wins level.
- :class:`Histogram` — log-bucketed (base ``2**0.25``, ~19% bucket
  resolution) with count/sum/min/max and p50/p95/p99 readout.

All instruments are thread-safe. ``REGISTRY.set_enabled(False)`` turns
every write into a no-op; reads still work. ``snapshot()`` returns one
JSON-able labelled document. The port's engine, scheduler, cluster, MD
engine and sessions write it under the JAX package's names;
:func:`repro_torch.obs.export.prometheus_text` renders it and the health
plane (:mod:`repro_torch.obs.slo`, :mod:`repro_torch.obs.anomaly`)
judges it.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

# log-bucket base: 4 buckets per octave (~19% relative resolution)
_BASE = 2.0 ** 0.25
_LOG_BASE = math.log(_BASE)


def label_suffix(labels: Dict[str, str]) -> str:
    """Prometheus-style ``{k="v",...}`` suffix, keys sorted, '' if none."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


class _Instrument:
    __slots__ = ("name", "labels", "_lock", "_registry")

    def __init__(self, registry: "MetricsRegistry", name: str,
                 labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._registry = registry

    @property
    def key(self) -> str:
        return self.name + label_suffix(self.labels)


class Counter(_Instrument):
    """Monotonic total. ``inc`` with a negative amount raises."""
    __slots__ = ("_value",)

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.key} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Instrument):
    """Last-write-wins level; ``add`` for deltas (queue depth +-1)."""
    __slots__ = ("_value",)

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Instrument):
    """Log-bucketed histogram with quantile readout.

    Buckets are ``(_BASE**(i-1), _BASE**i]``; values <= 0 land in a
    dedicated underflow bucket reported as 0.0. Quantiles return the
    upper edge of the bucket where the cumulative count crosses ``q`` —
    i.e. an over-estimate by at most one bucket width (~19%), which is
    the right bias for latency gates.
    """
    __slots__ = ("_buckets", "_count", "_sum", "_min", "_max")

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._buckets: Dict[Optional[int], int] = {}
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    @staticmethod
    def _bucket_index(value: float) -> Optional[int]:
        if value <= 0.0:
            return None  # underflow bucket
        return int(math.ceil(math.log(value) / _LOG_BASE - 1e-12))

    @staticmethod
    def _bucket_edge(index: Optional[int]) -> float:
        return 0.0 if index is None else _BASE ** index

    def observe(self, value: float) -> None:
        if not self._registry.enabled:
            return
        idx = self._bucket_index(value)
        with self._lock:
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    def percentile(self, q: float) -> float:
        """Upper bucket edge at quantile ``q`` in [0, 1]; 0.0 if empty."""
        with self._lock:
            if self._count == 0:
                return 0.0
            target = q * self._count
            # None (underflow) sorts first
            items = sorted(self._buckets.items(),
                           key=lambda kv: -math.inf if kv[0] is None
                           else kv[0])
            cum = 0
            for idx, n in items:
                cum += n
                if cum >= target:
                    return min(self._bucket_edge(idx), self._max)
            return self._max

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> Dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "p50": 0.0, "p95": 0.0, "p99": 0.0,
                        "buckets": {}}
            base = {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    # JSON-able bucket dict ("u" = underflow) so the
                    # health plane (repro_torch.obs.slo) can compute
                    # windowed quantiles from snapshot deltas
                    "buckets": {("u" if k is None else str(k)): n
                                for k, n in self._buckets.items()}}
        base["p50"] = self.percentile(0.50)
        base["p95"] = self.percentile(0.95)
        base["p99"] = self.percentile(0.99)
        return base


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

#: Catch-all label set a name's instruments fold into once it exceeds
#: the registry's per-name cardinality cap.
OVERFLOW_LABELS = {"overflow": "true"}
_OVERFLOW_COUNTER = "repro_obs_label_overflow_total"


class MetricsRegistry:
    """Get-or-create instrument registry keyed by ``(name, labels)``.

    One process-wide instance (:data:`REGISTRY`) backs the whole stack;
    separate instances exist only for tests. Re-registering a name with
    a different instrument kind raises — a name means one thing.

    Label cardinality is bounded: once a name has ``max_label_sets``
    distinct label sets, further *new* label sets fold into one
    ``{overflow="true"}`` catch-all instrument (per name) and each
    folded lookup bumps ``repro_obs_label_overflow_total`` — a
    per-``session_id``-style label can no longer leak instruments
    forever, and the leak is visible instead of silent. Existing label
    sets keep resolving normally.
    """

    def __init__(self, max_label_sets: int = 1024):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, str], _Instrument] = {}
        self._kinds: Dict[str, str] = {}
        self._label_counts: Dict[str, int] = {}
        self.max_label_sets = int(max_label_sets)
        self.enabled = True

    def _overflow_counter_locked(self) -> Counter:
        key = (_OVERFLOW_COUNTER, "")
        inst = self._instruments.get(key)
        if inst is None:
            inst = Counter(self, _OVERFLOW_COUNTER, {})
            self._instruments[key] = inst
            self._kinds[_OVERFLOW_COUNTER] = "counter"
            self._label_counts[_OVERFLOW_COUNTER] = 1
        return inst

    def _get(self, kind: str, name: str, labels: Dict[str, str]):
        key = (name, label_suffix(labels))
        with self._lock:
            seen = self._kinds.get(name)
            if seen is not None and seen != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {seen}, "
                    f"cannot re-register as {kind}")
            inst = self._instruments.get(key)
            if inst is None:
                if (labels != OVERFLOW_LABELS
                        and self._label_counts.get(name, 0)
                        >= self.max_label_sets):
                    overflow = self._overflow_counter_locked()
                    labels = dict(OVERFLOW_LABELS)
                    key = (name, label_suffix(labels))
                    inst = self._instruments.get(key)
                    # instrument locks differ from the registry lock,
                    # so bumping under it cannot deadlock
                    overflow.inc()
                    if inst is not None:
                        return inst
                inst = _KINDS[kind](self, name, labels)
                self._instruments[key] = inst
                self._kinds[name] = kind
                self._label_counts[name] = (
                    self._label_counts.get(name, 0) + 1)
            return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get("histogram", name, labels)

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def reset(self) -> None:
        """Drop every instrument (tests / bench arms)."""
        with self._lock:
            self._instruments.clear()
            self._kinds.clear()
            self._label_counts.clear()

    def snapshot(self) -> Dict:
        """One labelled JSON-able document over every instrument."""
        with self._lock:
            instruments = list(self._instruments.values())
        out: Dict[str, List[Dict]] = {"counters": [], "gauges": [],
                                      "histograms": []}
        for inst in sorted(instruments, key=lambda i: i.key):
            entry = {"name": inst.name, "labels": dict(inst.labels)}
            if isinstance(inst, Counter):
                entry["value"] = inst.value
                out["counters"].append(entry)
            elif isinstance(inst, Gauge):
                entry["value"] = inst.value
                out["gauges"].append(entry)
            else:
                entry.update(inst.snapshot())
                out["histograms"].append(entry)
        return out

    def flat(self) -> Dict[str, float]:
        """``{"name{labels}": value}`` convenience view (histograms
        expand to ``name_count`` / ``name_sum`` keys)."""
        snap = self.snapshot()
        out: Dict[str, float] = {}
        for e in snap["counters"] + snap["gauges"]:
            out[e["name"] + label_suffix(e["labels"])] = e["value"]
        for e in snap["histograms"]:
            sfx = label_suffix(e["labels"])
            out[e["name"] + "_count" + sfx] = e["count"]
            out[e["name"] + "_sum" + sfx] = e["sum"]
        return out


#: The process-wide registry every component dual-writes into.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def snapshot() -> Dict:
    """Module-level shorthand: the unified labelled snapshot."""
    return REGISTRY.snapshot()
