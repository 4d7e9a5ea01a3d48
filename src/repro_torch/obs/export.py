"""Exporters for the obs plane: JSONL trace sink, Prometheus text
exposition, and a periodic background exporter for ``launch serve
--metrics-out/--trace-out``. A copy of ``repro/obs/export.py`` (stdlib
only, no torch): the exposition is byte for byte the JAX package's for
the same snapshot, and a trace file written by either package loads in
the other.

Wall-clock (``time.time``) appears here and only here — exporters stamp
export timestamps; every duration upstream is monotonic.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, Optional

from repro_torch.obs import metrics as _metrics

__all__ = ["prometheus_text", "write_metrics", "JsonlTraceSink",
           "PeriodicExporter"]


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def prometheus_text(snapshot: Optional[Dict] = None,
                    registry: Optional[_metrics.MetricsRegistry] = None
                    ) -> str:
    """Render a registry snapshot in Prometheus text exposition format.

    Counters/gauges emit one sample each; histograms emit summary-style
    ``_count`` / ``_sum`` plus ``quantile``-labelled samples from the
    log-bucket readout.
    """
    if snapshot is None:
        snapshot = (registry or _metrics.REGISTRY).snapshot()
    lines = []
    typed = set()

    def _type_line(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for e in snapshot.get("counters", ()):
        name = _prom_name(e["name"])
        _type_line(name, "counter")
        lines.append(f"{name}{_metrics.label_suffix(e['labels'])} "
                     f"{e['value']:.10g}")
    for e in snapshot.get("gauges", ()):
        name = _prom_name(e["name"])
        _type_line(name, "gauge")
        lines.append(f"{name}{_metrics.label_suffix(e['labels'])} "
                     f"{e['value']:.10g}")
    for e in snapshot.get("histograms", ()):
        name = _prom_name(e["name"])
        _type_line(name, "summary")
        for q in ("p50", "p95", "p99"):
            labels = dict(e["labels"])
            labels["quantile"] = {"p50": "0.5", "p95": "0.95",
                                  "p99": "0.99"}[q]
            lines.append(f"{name}{_metrics.label_suffix(labels)} "
                         f"{e[q]:.10g}")
        sfx = _metrics.label_suffix(e["labels"])
        lines.append(f"{name}_count{sfx} {e['count']}")
        lines.append(f"{name}_sum{sfx} {e['sum']:.10g}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_metrics(path: str,
                  registry: Optional[_metrics.MetricsRegistry] = None
                  ) -> None:
    """Atomically write the current exposition to ``path``."""
    text = prometheus_text(registry=registry)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"# exported_at {time.time():.3f}\n")
        f.write(text)
    os.replace(tmp, path)


class JsonlTraceSink:
    """Append-only JSONL sink for finished traces (one trace per line).

    Thread-safe; lines are flushed as written so a crash loses at most
    the in-flight line. Pass to ``configure_tracing(sink=...)``.

    With ``max_bytes`` set the sink rotates: when the active file would
    exceed the cap it is renamed to ``<path>.1`` (shifting ``.1`` ->
    ``.2`` and so on, dropping the oldest past ``keep``) and a fresh
    file is opened — a week-long MD session keeps at most
    ``(keep + 1) * max_bytes`` of trace on disk instead of one
    unbounded JSONL.
    """

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 keep: int = 3):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self.keep = max(0, int(keep))
        self._lock = threading.Lock()
        self._f = open(path, "a")
        self._bytes = os.path.getsize(path)
        self.n_written = 0
        self.n_rotations = 0

    def _rotate_locked(self) -> None:
        self._f.close()
        oldest = f"{self.path}.{self.keep}"
        if self.keep > 0 and os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if self.keep > 0:
            os.replace(self.path, f"{self.path}.1")
        else:
            os.remove(self.path)
        self._f = open(self.path, "a")
        self._bytes = 0
        self.n_rotations += 1

    def write(self, trace_doc: Dict) -> None:
        data = json.dumps(trace_doc, separators=(",", ":"),
                          sort_keys=True) + "\n"
        with self._lock:
            if self._f is None:
                return
            if (self.max_bytes is not None and self._bytes > 0
                    and self._bytes + len(data) > self.max_bytes):
                self._rotate_locked()
            self._f.write(data)
            self._f.flush()
            self._bytes += len(data)
            self.n_written += 1

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_traces(path: str):
    """Read a JSONL trace file back into a list of trace dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class PeriodicExporter:
    """Background thread writing the Prometheus exposition to a file on
    an interval (plus a final write on ``stop``). This is the
    ``launch serve --metrics-out`` plumbing; trace export is push-based
    via :class:`JsonlTraceSink` so it needs no thread.

    ``stop()`` is idempotent and also registered via :mod:`atexit`, and
    when a ``tracer`` / ``trace_sink`` are attached it drains the
    tracer's export queue and closes the sink after the final metrics
    write — an interpreter exit can no longer drop the trace tail."""

    def __init__(self, metrics_path: str, interval_s: float = 5.0,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 tracer=None, trace_sink: Optional[JsonlTraceSink] = None):
        self.metrics_path = metrics_path
        self.interval_s = max(0.05, float(interval_s))
        self._registry = registry
        self._tracer = tracer
        self._trace_sink = trace_sink
        self._stop = threading.Event()
        self._stopped = False
        self._stop_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run,
                                        name="obs-exporter", daemon=True)
        self.n_exports = 0

    def _export(self) -> None:
        write_metrics(self.metrics_path, registry=self._registry)
        self.n_exports += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._export()
            except Exception:
                pass  # a failed export must never take down serving

    def start(self) -> "PeriodicExporter":
        self._thread.start()
        atexit.register(self.stop)
        return self

    def stop(self) -> None:
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        try:
            self._export()  # final snapshot
        except Exception:
            pass
        if self._tracer is not None:
            try:
                self._tracer.flush(timeout=10.0)
            except Exception:
                pass
        if self._trace_sink is not None:
            try:
                self._trace_sink.close()
            except Exception:
                pass
        try:
            atexit.unregister(self.stop)
        except Exception:
            pass
