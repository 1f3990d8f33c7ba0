"""paddle_tpu_torch.observability — the serving telemetry: the metrics
registry (`metrics`), request/step span tracing (`tracing`), SLO tiers
(`slo`), the windowed metric series (`timeseries`), the fleet's merged
series (`fleet_series`), burn-rate alerts (`alerts`), the training-loop
bracket (`telemetry.StepTelemetry`) and device roofline peaks
(`roofline`).  All but `roofline` and `telemetry` (which opens
`torch.profiler` spans) are stdlib-only copies of the JAX package's
modules of the same names."""

from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, get_registry, log_buckets,
)
from .slo import SLOTier, SLOTargets, goodput, DEFAULT_SLO_TARGETS
from .timeseries import TimeSeriesStore, delta_quantile
from .alerts import Alert, BurnRateRule, AlertManager, default_burn_rules
from .fleet_series import FleetMetricsAggregator
from .telemetry import StepTelemetry
from . import alerts, fleet_series, roofline, telemetry, timeseries, tracing

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "log_buckets", "SLOTier", "SLOTargets", "goodput",
    "DEFAULT_SLO_TARGETS", "TimeSeriesStore", "delta_quantile", "Alert",
    "BurnRateRule", "AlertManager", "default_burn_rules",
    "FleetMetricsAggregator", "StepTelemetry", "alerts", "fleet_series",
    "roofline", "telemetry", "timeseries", "tracing",
]
