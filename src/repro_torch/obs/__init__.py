"""The port's observability plane: copies of the JAX package's
``repro.obs`` modules (stdlib only: none imports JAX, the JAX package or
torch, so the health monitor's and the exporter's threads never touch the
card). The metrics registry and request traces, the exporters
(Prometheus text, JSONL traces), the health plane (SLO burn rates,
anomaly detectors) and the Chrome-trace timeline."""
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, get_registry, snapshot)
from repro_torch.obs.trace import (TRACER, RequestTrace, Span, Tracer,
                                   configure_tracing, get_tracer)
from repro_torch.obs.export import (JsonlTraceSink, PeriodicExporter,
                                    load_traces, prometheus_text,
                                    write_metrics)
from repro_torch.obs.slo import (SLO, Alert, AlertBus, HealthMonitor,
                                 SampleWindow, SLOEvaluator, default_slos)
from repro_torch.obs.anomaly import (AnomalyMonitor, CompileStorm, Detector,
                                     EscalationTrend, EwmaZScore,
                                     QueueDepthRunaway, ReplicaLatencySkew,
                                     default_detectors, robust_zscore)
from repro_torch.obs.timeline import (chrome_trace, validate_chrome_trace,
                                      write_chrome_trace)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "REGISTRY",
    "get_registry", "snapshot",
    "Span", "RequestTrace", "Tracer", "TRACER", "configure_tracing",
    "get_tracer",
    "prometheus_text", "write_metrics", "JsonlTraceSink",
    "PeriodicExporter", "load_traces",
    "Alert", "AlertBus", "SLO", "SLOEvaluator", "HealthMonitor",
    "SampleWindow", "default_slos",
    "AnomalyMonitor", "Detector", "EwmaZScore", "QueueDepthRunaway",
    "CompileStorm", "ReplicaLatencySkew", "EscalationTrend",
    "default_detectors", "robust_zscore",
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
]
