"""The port's metrics registry and request traces (copies of
``repro.obs.metrics`` and ``repro.obs.trace``)."""
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, get_registry, snapshot)
from repro_torch.obs.trace import (TRACER, RequestTrace, Span, Tracer,
                                   configure_tracing, get_tracer)

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "snapshot", "TRACER", "RequestTrace", "Span",
           "Tracer", "configure_tracing", "get_tracer"]
