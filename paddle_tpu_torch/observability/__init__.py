"""paddle_tpu_torch.observability — the serving telemetry: the metrics
registry (`metrics`), request/step span tracing (`tracing`), SLO tiers
(`slo`), the windowed metric series (`timeseries`), the fleet's merged
series (`fleet_series`), burn-rate alerts (`alerts`) and device roofline
peaks (`roofline`).  All but `roofline` are stdlib-only copies of the
JAX package's modules of the same names."""

from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, get_registry, log_buckets,
)
from .slo import SLOTier, SLOTargets, goodput, DEFAULT_SLO_TARGETS
from .timeseries import TimeSeriesStore, delta_quantile
from .alerts import Alert, BurnRateRule, AlertManager, default_burn_rules
from .fleet_series import FleetMetricsAggregator
from . import alerts, fleet_series, roofline, timeseries, tracing

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "log_buckets", "SLOTier", "SLOTargets", "goodput",
    "DEFAULT_SLO_TARGETS", "TimeSeriesStore", "delta_quantile", "Alert",
    "BurnRateRule", "AlertManager", "default_burn_rules",
    "FleetMetricsAggregator", "alerts", "fleet_series", "roofline",
    "timeseries", "tracing",
]
