"""Metrics core: low-overhead, thread-safe Counter/Gauge/Histogram with
labeled series and a process-global registry (SURVEY §5.5 observability;
ref role: the reference spreads this across glog counters, the fluid
profiler's op statistics, and VisualDL scalar logs — here it is one
registry every layer writes into and one exposition format operators
scrape).

Design constraints, in order:

  * WRITE cost rules.  These sit on the decode-step and eager-dispatch
    hot paths; an observe is one lock acquire, one bisect over ~20
    bucket bounds, three float adds.  No allocation after the series
    is created, no string formatting anywhere near the hot path
    (label resolution returns a cached child object — resolve once,
    write many).
  * Histograms are log-spaced by default: serving latencies span five
    orders of magnitude (µs host bookkeeping → seconds of queue wait),
    where linear buckets either saturate or alias.
  * Exposition is pull-shaped: `snapshot()` (nested dict for python
    consumers: tests, bench JSON, per-rank aggregation),
    `prometheus_text()` (the standard scrape format, served by
    LLMServer's /metrics thread), `dump_json(path)` (one file per
    rank under the launch log dir).
"""

from __future__ import annotations

import bisect
import json
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "log_buckets", "DEFAULT_MAX_SERIES",
]

_INF = float("inf")

# Per-metric bound on labeled-series fan-out.  A label drawn from an
# unbounded domain (request ids, raw prompts...) would otherwise grow
# the registry without limit; past the cap, writes land in a shared
# detached sink (callers keep working) and the overflow is counted in
# the registry's `metrics_series_dropped_total`.
DEFAULT_MAX_SERIES = 256


def log_buckets(lo: float, hi: float, per_decade: int = 4):
    """Log-spaced bucket upper bounds covering [lo, hi] with
    `per_decade` bounds per factor of 10 (a +Inf bucket is implicit in
    every Histogram).  Default shape for latency metrics."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    step = 10.0 ** (1.0 / per_decade)
    out, b = [], float(lo)
    while b < hi * (1 + 1e-9):
        out.append(b)
        b *= step
    return tuple(out)


def _label_key(labelnames, labelvalues) -> str:
    return ",".join(f"{k}={v}" for k, v in zip(labelnames, labelvalues))


class _Metric:
    """Common label-series machinery.  An unlabeled metric is its own
    single series (key ""); a labeled one is a family whose `.labels()`
    children share the family lock and bucket bounds."""

    kind = "untyped"

    def __init__(self, name, help="", labelnames=(), max_series=None,
                 on_drop=None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[str, object] = {}
        self._max_series = DEFAULT_MAX_SERIES if max_series is None \
            else int(max_series)
        self._on_drop = on_drop
        self._overflow_series = None   # shared sink past the cap
        self.dropped = 0
        if not self.labelnames:
            self._series[""] = self._new_series()

    def _new_series(self):
        raise NotImplementedError

    def labels(self, *labelvalues, **labelkw):
        """Resolve (and cache) the child series for one label-value
        combination.  Callers on hot paths should resolve once and keep
        the child."""
        if labelkw:
            if labelvalues:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                labelvalues = tuple(labelkw[k] for k in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: unknown label {e} "
                    f"(declared: {self.labelnames})") from None
        labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"values {self.labelnames}, got {len(labelvalues)}")
        key = _label_key(self.labelnames, labelvalues)
        dropped = False
        with self._lock:
            child = self._series.get(key)
            if child is None:
                if len(self._series) >= self._max_series:
                    # cardinality guard: don't grow, don't break the
                    # caller — hand back the shared sink (excluded from
                    # snapshots) and count the drop
                    if self._overflow_series is None:
                        self._overflow_series = self._new_series()
                    child = self._overflow_series
                    self.dropped += 1
                    dropped = True
                else:
                    child = self._new_series()
                    self._series[key] = child
        if dropped and self._on_drop is not None:
            try:
                self._on_drop(self.name)
            except Exception:
                pass
        return child

    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use "
                f".labels(...) to pick a series")
        return self._series[""]

    def snapshot(self) -> dict:
        with self._lock:
            series = {k: s._snap() for k, s in self._series.items()}
        return {"type": self.kind, "help": self.help,
                "labels": list(self.labelnames), "series": series}


class _CounterSeries:
    __slots__ = ("_value", "_lock")

    def __init__(self, lock):
        self._value = 0.0
        self._lock = lock

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _snap(self):
        return {"value": self._value}


class Counter(_Metric):
    """Monotone event count (requests admitted, tokens generated...)."""

    kind = "counter"

    def _new_series(self):
        return _CounterSeries(self._lock)

    def inc(self, n=1.0):
        self._solo().inc(n)

    @property
    def value(self):
        return self._solo().value


class _GaugeSeries:
    __slots__ = ("_value", "_lock")

    def __init__(self, lock):
        self._value = 0.0
        self._lock = lock

    def set(self, v):
        with self._lock:
            self._value = float(v)

    def inc(self, n=1.0):
        with self._lock:
            self._value += n

    def dec(self, n=1.0):
        self.inc(-n)

    @property
    def value(self):
        return self._value

    def _snap(self):
        return {"value": self._value}


class Gauge(_Metric):
    """Point-in-time level (queue depth, slot occupancy, EMA rates)."""

    kind = "gauge"

    def _new_series(self):
        return _GaugeSeries(self._lock)

    def set(self, v):
        self._solo().set(v)

    def inc(self, n=1.0):
        self._solo().inc(n)

    def dec(self, n=1.0):
        self._solo().dec(n)

    @property
    def value(self):
        return self._solo().value


class _HistogramSeries:
    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds, lock):
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def mean(self):
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q):
        """Bucket-resolution quantile (upper bound of the bucket the
        q-th observation falls in) — coarse by design, good enough for
        p50/p99 dashboards without keeping raw samples."""
        if not self._count:
            return 0.0
        rank = q * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank and c:
                return self._bounds[i] if i < len(self._bounds) else _INF
        return _INF

    def _snap(self):
        cum, buckets = 0, []
        for i, b in enumerate(self._bounds):
            cum += self._counts[i]
            buckets.append([b, cum])
        buckets.append(["+Inf", self._count])
        return {"count": self._count, "sum": self._sum, "buckets": buckets}


class Histogram(_Metric):
    """Distribution with cumulative log-spaced buckets (Prometheus
    semantics: per-bound counts are cumulative, +Inf == count)."""

    kind = "histogram"

    DEFAULT_BUCKETS = log_buckets(1e-4, 60.0, per_decade=3)  # seconds

    def __init__(self, name, help="", labelnames=(), buckets=None,
                 max_series=None, on_drop=None):
        self.buckets = tuple(sorted(buckets)) if buckets \
            else self.DEFAULT_BUCKETS
        super().__init__(name, help, labelnames, max_series=max_series,
                         on_drop=on_drop)

    def _new_series(self):
        return _HistogramSeries(self.buckets, self._lock)

    def observe(self, v):
        self._solo().observe(v)

    @property
    def count(self):
        return self._solo().count

    @property
    def sum(self):
        return self._solo().sum

    def mean(self):
        return self._solo().mean()

    def quantile(self, q):
        return self._solo().quantile(q)


class MetricsRegistry:
    """Named collection of metrics; get-or-create accessors so layers
    can instrument without coordinating creation order.  One process
    global instance (`get_registry()`) plus private instances where
    isolation matters (each LLMEngine owns one — concurrent engines in
    one process must not sum their slot gauges together)."""

    def __init__(self, namespace="", max_series_per_metric=None):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._max_series = max_series_per_metric
        self._dropped = None    # lazy metrics_series_dropped_total

    def _full(self, name):
        return f"{self.namespace}_{name}" if self.namespace else name

    def _note_dropped(self, metric_name):
        """Cardinality-guard overflow hook: count the dropped series
        under `metrics_series_dropped_total{metric=...}`.  The counter
        is built directly (its own guard disabled) so an overflowing
        registry can never recurse through the hook."""
        c = self._dropped
        if c is None:
            with self._lock:
                c = self._dropped
                if c is None:
                    full = self._full("metrics_series_dropped_total")
                    c = self._metrics.get(full)
                    if c is None:
                        c = Counter(
                            full,
                            help="labeled series dropped by the "
                                 "per-metric cardinality guard",
                            labelnames=("metric",), max_series=4096)
                        self._metrics[full] = c
                    self._dropped = c
        c.labels(metric=metric_name).inc()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        name = self._full(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, labelnames=labelnames,
                        max_series=self._max_series,
                        on_drop=self._note_dropped, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            elif tuple(labelnames) != m.labelnames:
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{m.labelnames}, asked for {tuple(labelnames)}")
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        return self._metrics.get(self._full(name)) or self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def clear(self):
        """Drop every metric (tests; a fresh engine makes a fresh
        registry instead)."""
        with self._lock:
            self._metrics.clear()
            self._dropped = None
        if self is _REGISTRY:
            # the op-timing fast path caches its histogram + children;
            # dropping the registry's metrics must orphan-proof it
            global _OP_TIME
            _OP_TIME = None
            _OP_TIME_CHILDREN.clear()

    # -- exposition ---------------------------------------------------------

    def snapshot(self) -> dict:
        """{metric_name: {type, help, labels, series: {labelkey:
        value-struct}}} — the python-facing form every other consumer
        (bench JSON, per-rank aggregation, tests) builds on."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.snapshot() for name, m in metrics}

    def prometheus_text(self) -> str:
        """Standard text exposition (scraped by the LLMServer /metrics
        thread; ref: the format VisualDL-era dashboards never had)."""
        out = []
        for name, snap in sorted(self.snapshot().items()):
            if snap["help"]:
                out.append(f"# HELP {name} {snap['help']}")
            out.append(f"# TYPE {name} {snap['type']}")
            for key, val in sorted(snap["series"].items()):
                base = _prom_labels(key)
                if snap["type"] == "histogram":
                    for b, c in val["buckets"]:
                        le = _prom_float(b)
                        out.append(
                            f"{name}_bucket{_prom_labels(key, ('le', le))}"
                            f" {c}")
                    out.append(f"{name}_sum{base} {_prom_float(val['sum'])}")
                    out.append(f"{name}_count{base} {val['count']}")
                else:
                    out.append(f"{name}{base} {_prom_float(val['value'])}")
        return "\n".join(out) + "\n"

    def dump_json(self, path=None) -> str:
        """JSON form of snapshot(); writes `path` when given, returns
        the serialized text either way."""
        text = json.dumps(self.snapshot(), sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


def _prom_float(v) -> str:
    if isinstance(v, str):
        return v  # the "+Inf" bound
    if v != v:
        return "NaN"
    if v in (_INF, -_INF):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _prom_labels(key: str, extra=None) -> str:
    parts = []
    if key:
        for kv in key.split(","):
            k, _, v = kv.partition("=")
            # exposition-format escaping: backslash first, then quote
            # and newline (a raw newline would tear the sample line)
            v = (v.replace("\\", "\\\\").replace('"', '\\"')
                  .replace("\n", "\\n"))
            parts.append(f'{k}="{v}"')
    if extra is not None:
        parts.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(parts) + "}" if parts else ""


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry (training telemetry, dispatch op
    timing, anything not needing per-instance isolation)."""
    return _REGISTRY


# -- dispatch op-timing hook (core/dispatch.py hot path) ---------------------
#
# Kept here (not in dispatch) so the histogram family exists exactly once
# and framework.logging can read it without importing dispatch.  Buckets
# span 1µs (cached jit-call overhead) to 10s (first-compile outliers).

_OP_TIME = None
_OP_TIME_CHILDREN: dict[str, _HistogramSeries] = {}


def _op_time_hist() -> Histogram:
    global _OP_TIME
    if _OP_TIME is None:
        _OP_TIME = _REGISTRY.histogram(
            "op_host_time_seconds",
            help="sampled host wall time per eager op dispatch "
                 "(FLAGS_op_timing gates collection)",
            labelnames=("op",),
            buckets=log_buckets(1e-6, 10.0, per_decade=3))
    return _OP_TIME


def observe_op_time(op_name: str, seconds: float):
    """Record one sampled dispatch duration (called from core.dispatch
    only when FLAGS_op_timing is on; the child lookup is dict-cached so
    the sampled path stays one lock + one bisect)."""
    child = _OP_TIME_CHILDREN.get(op_name)
    if child is None:
        child = _op_time_hist().labels(op=op_name)
        _OP_TIME_CHILDREN[op_name] = child
    child.observe(seconds)


def op_time_snapshot() -> dict:
    """{op: {count, sum, mean}} for the sampled dispatch timings (the
    op-counter analog with time attached; framework.logging re-exports
    this as `op_time_stats`)."""
    hist = _REGISTRY.get("op_host_time_seconds")
    if hist is None:
        return {}
    out = {}
    for key, val in hist.snapshot()["series"].items():
        op = key.partition("=")[2]
        out[op] = {"count": val["count"], "sum": val["sum"],
                   "mean": val["sum"] / val["count"] if val["count"] else 0.0}
    return out
