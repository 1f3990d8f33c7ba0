"""Bounded-ring time-series store over the metrics registry (the fleet
observability plane).

Everything below the router works from *instantaneous* state: `/metrics`
is a point-in-time scrape, `health()` is a point poll, and the autoscale
and overload controllers decide off whatever the last poll happened to
see.  This module is the memory: a `TimeSeriesStore` samples a
`MetricsRegistry` on an interval and turns cumulative metric state into
windowed series —

  * counter   -> per-second rate over the sampling interval (resets
                 tolerated: a counter that went backwards is treated as
                 restarted, the window is the new value alone);
  * gauge     -> last value;
  * histogram -> windowed-delta quantiles: subtract two cumulative
                 bucket snapshots and take bucket-resolution quantiles
                 of the *observations that happened in between*
                 (`delta_quantile`), plus an observation rate and a
                 windowed mean.  An interval with no observations
                 records nothing — a gap, not a zero — so latency
                 windows never dilute toward 0 while idle.

Storage is tiered bounded rings: tier 0 keeps every sample at the
sampling interval, each coarser tier keeps the mean of a fixed period
(e.g. 10 s, 60 s), so hours of history fit a fixed budget.  Rings are
preallocated `array('d')` pairs — 16 bytes per point, no allocation on
the sample path — which makes `memory_bytes()` an exact figure, not an
estimate, and lets the store enforce `max_bytes` by refusing to admit
new series once the budget is spent (`series_dropped` counts refusals).

Sampling runs on its own daemon thread (`start()`/`stop()`), never on
the engine driver thread: the per-tick cost is one `registry.snapshot()`
plus float pushes, entirely off the decode hot path.
"""

from __future__ import annotations

import threading
import time
from array import array

__all__ = ["TimeSeriesStore", "delta_quantile", "DEFAULT_TIERS"]

_INF = float("inf")

# (period_s, capacity): 5 min at 1 s, 1 h at 10 s, 8 h at 60 s —
# 1140 points/series = ~18 KiB/series at 16 B/point.
DEFAULT_TIERS = ((1.0, 300), (10.0, 360), (60.0, 480))

# dict slots, key string, accumulators... charged per series on top of
# the exact ring bytes so the budget reflects real footprint shape.
_SERIES_OVERHEAD = 512


def delta_quantile(prev_snap, cur_snap, q):
    """Bucket-resolution quantile of the observations BETWEEN two
    cumulative histogram snapshots (the `_snap()` dict shape:
    ``{"count", "sum", "buckets": [[bound, cum], ..., ["+Inf", n]]}``).

    ``prev_snap=None`` degenerates to the plain single-snapshot
    quantile.  A shrunken count (registry cleared / process restart)
    treats the window as the current snapshot alone.  An empty window
    returns 0.0, mirroring `Histogram.quantile` on an empty histogram;
    mass in the overflow bucket quantiles to +Inf."""
    cb = cur_snap["buckets"]
    if prev_snap is None or cur_snap["count"] < prev_snap["count"]:
        pb = None
    else:
        pb = prev_snap["buckets"]
    total = cur_snap["count"] - (prev_snap["count"] if pb is not None else 0)
    if total <= 0:
        return 0.0
    rank = q * total
    prev_cum = 0
    for i, (b, c) in enumerate(cb):
        if pb is not None:
            c = c - pb[i][1]
        if c < prev_cum:            # clamp torn / non-monotone deltas
            c = prev_cum
        if c >= rank and c > prev_cum:
            return _INF if b == "+Inf" else float(b)
        prev_cum = c
    return _INF


class _Ring:
    """Fixed-capacity (t, v) ring over two preallocated float arrays:
    16 bytes per point, push is O(1), reads return ascending time."""

    __slots__ = ("_t", "_v", "_cap", "_n", "_head")

    def __init__(self, cap):
        self._cap = int(cap)
        self._t = array("d", [0.0]) * self._cap
        self._v = array("d", [0.0]) * self._cap
        self._n = 0
        self._head = 0          # index of the oldest point

    def push(self, t, v):
        i = (self._head + self._n) % self._cap
        if self._n == self._cap:
            self._head = (self._head + 1) % self._cap
        else:
            self._n += 1
        self._t[i] = t
        self._v[i] = v

    def __len__(self):
        return self._n

    def last(self):
        if not self._n:
            return None
        i = (self._head + self._n - 1) % self._cap
        return (self._t[i], self._v[i])

    def points(self, since=None, limit=None):
        out = []
        start = 0
        if limit is not None and limit < self._n:
            start = self._n - limit
        for k in range(start, self._n):
            i = (self._head + k) % self._cap
            t = self._t[i]
            if since is not None and t < since:
                continue
            out.append((t, self._v[i]))
        return out

    def nbytes(self):
        return 16 * self._cap


class _Series:
    """One key's tiered rings plus the coarse-tier accumulators."""

    __slots__ = ("rings", "acc")

    def __init__(self, tiers):
        self.rings = [_Ring(cap) for _, cap in tiers]
        # per coarse tier: [bucket_start, sum, count]
        self.acc = [[None, 0.0, 0] for _ in tiers[1:]]


class TimeSeriesStore:
    """Samples one or more registries into tiered bounded rings.

    Series keys are ``metric{label=value,...}`` (no braces when
    unlabeled); histogram-derived series append ``:p50``/``:p90``/
    ``:p99``/``:rate``/``:mean``; counters become their rate under the
    bare key.  ``extra`` is an optional zero-arg callable returning
    ``{key: float}`` sampled each tick (derived gauges — e.g. slot
    occupancy — that no registry metric carries directly)."""

    def __init__(self, registries=(), interval_s=1.0, tiers=None,
                 quantiles=(0.5, 0.9, 0.99), max_bytes=8 << 20,
                 extra=None, clock=time.time):
        if hasattr(registries, "snapshot"):
            registries = (registries,)
        self._registries = tuple(registries)
        self.interval_s = float(interval_s)
        self.tiers = tuple(tiers) if tiers else DEFAULT_TIERS
        self.quantiles = tuple(quantiles)
        self.max_bytes = int(max_bytes)
        self._extra = extra
        self._clock = clock
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._prev_counter: dict[str, tuple] = {}   # key -> (t, value)
        self._prev_hist: dict[str, tuple] = {}      # key -> (t, snap)
        self._per_series_bytes = (
            sum(16 * cap for _, cap in self.tiers) + _SERIES_OVERHEAD)
        self.series_dropped = 0
        self.samples = 0
        self._seq = 0
        self._thread = None
        self._stop = threading.Event()

    # -- write side ---------------------------------------------------------

    def sample(self, now=None):
        """Take one sample of every registry (plus ``extra``).  Called
        by the sampler thread, or directly by tests with a fake
        clock."""
        now = self._clock() if now is None else float(now)
        extra = {}
        if self._extra is not None:
            try:
                extra = self._extra() or {}
            except Exception:
                extra = {}
        snaps = [reg.snapshot() for reg in self._registries]
        with self._lock:
            self.samples += 1
            self._seq += 1
            for snap in snaps:
                for mname, m in snap.items():
                    kind = m["type"]
                    for lkey, val in m["series"].items():
                        base = f"{mname}{{{lkey}}}" if lkey else mname
                        if kind == "counter":
                            self._push_rate(base, now, val["value"])
                        elif kind == "histogram":
                            self._push_hist(base, now, val)
                        else:
                            self._push(base, now, val["value"])
            for k, v in extra.items():
                self._push(str(k), now, float(v))

    def _push_rate(self, key, now, value):
        prev = self._prev_counter.get(key)
        self._prev_counter[key] = (now, value)
        if prev is None:
            return
        pt, pv = prev
        dt = now - pt
        if dt <= 0:
            return
        d = value - pv
        if d < 0:               # counter reset: window = new value alone
            d = value
        self._push(key, now, d / dt)

    def _push_hist(self, key, now, snap):
        prev = self._prev_hist.get(key)
        self._prev_hist[key] = (now, snap)
        if prev is None:
            return
        pt, psnap = prev
        dt = now - pt
        if dt <= 0:
            return
        dcount = snap["count"] - psnap["count"]
        if dcount < 0:          # reset: the window is the snapshot alone
            psnap, dcount = None, snap["count"]
        self._push(key + ":rate", now, max(0, dcount) / dt)
        if dcount <= 0:
            return              # idle interval: a gap, not a zero
        dsum = snap["sum"] - (psnap["sum"] if psnap else 0.0)
        self._push(key + ":mean", now, dsum / dcount)
        for q in self.quantiles:
            self._push(f"{key}:p{int(round(q * 100))}", now,
                       delta_quantile(psnap, snap, q))

    def _push(self, key, now, value):
        s = self._series.get(key)
        if s is None:
            if (len(self._series) + 1) * self._per_series_bytes \
                    > self.max_bytes:
                self.series_dropped += 1
                return
            s = self._series[key] = _Series(self.tiers)
        s.rings[0].push(now, value)
        for ti, (period, _cap) in enumerate(self.tiers[1:]):
            acc = s.acc[ti]
            bucket = (now // period) * period
            if acc[0] is None:
                acc[0] = bucket
            elif bucket != acc[0]:
                if acc[2]:
                    s.rings[ti + 1].push(acc[0], acc[1] / acc[2])
                acc[0], acc[1], acc[2] = bucket, 0.0, 0
            acc[1] += value
            acc[2] += 1

    # -- read side ----------------------------------------------------------

    def keys(self):
        with self._lock:
            return sorted(self._series)

    def latest(self, key):
        with self._lock:
            s = self._series.get(key)
            return s.rings[0].last() if s else None

    def points(self, key, tier=0):
        with self._lock:
            s = self._series.get(key)
            return s.rings[tier].points() if s else []

    def window(self, key, seconds, now=None):
        """Points within the trailing window, read from the finest tier
        and extended backwards from coarser tiers where the fine ring
        no longer reaches.  Ascending time."""
        now = self._clock() if now is None else float(now)
        since = now - float(seconds)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return []
            out = s.rings[0].points(since=since)
            reach = out[0][0] if out else now
            for ring in s.rings[1:]:
                older = [p for p in ring.points(since=since)
                         if p[0] < reach]
                if older:
                    out = older + out
                    reach = out[0][0]
            return out

    def window_mean(self, key, seconds, now=None):
        pts = self.window(key, seconds, now=now)
        if not pts:
            return None
        return sum(v for _, v in pts) / len(pts)

    def window_max(self, key, seconds, now=None):
        pts = self.window(key, seconds, now=now)
        return max((v for _, v in pts), default=None)

    def tail(self, n=30, keys=None):
        """{key: [[t, v], ...last n tier-0 points]} — the /debug/fleet
        and shipping shape."""
        with self._lock:
            items = self._series.items() if keys is None else \
                [(k, self._series[k]) for k in keys if k in self._series]
            return {k: [[t, v] for t, v in s.rings[0].points(limit=n)]
                    for k, s in items}

    def export(self, n=15):
        """Shipping payload: the last ``n`` tier-0 points per series,
        stamped with a monotone seq.  Overlapping tails make a dropped
        push harmless — the aggregator dedupes by timestamp and the
        next push re-covers the gap."""
        with self._lock:
            seq = self._seq
        return {"t": self._clock(), "seq": seq,
                "interval_s": self.interval_s,
                "series": self.tail(n=n)}

    def memory_bytes(self):
        """Exact bytes the admitted rings occupy (rings are
        preallocated, so this is also the ceiling)."""
        with self._lock:
            return len(self._series) * self._per_series_bytes

    # -- sampler thread -----------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample()
                except Exception:
                    pass        # sampling must never take anything down

        self._thread = threading.Thread(
            target=_loop, name="ts-sampler", daemon=True)
        self._thread.start()

    def stop(self):
        t, self._thread = self._thread, None
        if t is not None:
            self._stop.set()
            t.join(timeout=2.0)
