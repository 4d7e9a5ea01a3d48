"""The port's metrics registry (a copy of ``repro.obs.metrics``)."""
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, get_registry, snapshot)

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "snapshot"]
