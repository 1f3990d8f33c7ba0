"""paddle_tpu_torch.observability — the serving telemetry the engine
needs: the metrics registry (`metrics`), request/step span tracing
(`tracing`), SLO tiers (`slo`), the windowed metric series
(`timeseries`) and device roofline peaks (`roofline`).  `metrics`,
`tracing`, `slo` and `timeseries` are stdlib-only copies of the JAX
package's modules of the same names."""

from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, get_registry, log_buckets,
)
from .slo import SLOTier, SLOTargets, goodput, DEFAULT_SLO_TARGETS
from . import roofline, timeseries, tracing

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "log_buckets", "SLOTier", "SLOTargets", "goodput",
    "DEFAULT_SLO_TARGETS", "roofline", "timeseries", "tracing",
]
