"""Fleet-wide merge of per-replica time series: the port of the JAX
package's `observability/fleet_series.py`.

Each replica's `TimeSeriesStore` exports overlapping tails of its
tier-0 series (`LLMServer.metrics_series()`); a router or an operator
feeds those payloads into one `FleetMetricsAggregator`.  The aggregator
keeps a bounded per-replica copy of every series (the replica is the
dict key, not a label baked into the series name), dedupes overlapping
pushes by timestamp, and answers the windowed queries a control plane
runs on: per-tier TTFT / ITL quantiles, goodput and error rate from SLO
met / missed counter rates, occupancy, and fleet mean / max / sum.

Pool labels: each replica can be tagged with its placement pool
("prefill" | "decode" | "mixed") by `set_pool()`, and every fleet
aggregate takes an optional ``pool=`` filter, so a prefill replica's
TTFT spike never looks like decode latency.

Staleness is the failure contract: a replica whose lease is fenced,
which is quarantined, or which died gets `mark_stale()`-ed (and one
that falls silent goes stale by age).  Stale series are EXCLUDED from
every fleet aggregate — a dead replica's frozen last points must not
drag a fleet mean — but their tails stay readable in `snapshot()`,
marked stale.  The next successful ingest clears the flag: a dropped
push costs freshness only.

Every read takes ``now=`` (default: the aggregator's clock), so a test
or a replay gets the same answers from the same payloads.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["FleetMetricsAggregator", "ENGINE_NS", "tier_key"]

ENGINE_NS = "llm_engine"


def tier_key(metric, tier, suffix=""):
    """Series key for an engine tier-labeled metric as the replica
    store names it: ``llm_engine_<metric>{tier=<tier>}<suffix>``."""
    return f"{ENGINE_NS}_{metric}{{tier={tier}}}{suffix}"


class _ReplicaSeries:
    __slots__ = ("series", "last_t", "last_ingest", "last_seq", "stale",
                 "stale_reason", "interval_s", "costs", "pool")

    def __init__(self):
        self.series: dict[str, deque] = {}
        self.last_t: dict[str, float] = {}
        self.last_ingest = 0.0
        self.last_seq = -1
        self.stale = False
        self.stale_reason = ""
        self.interval_s = None
        self.costs = None
        self.pool = "mixed"


class FleetMetricsAggregator:
    """Merged per-replica series with stale-aware windowed queries."""

    def __init__(self, stale_after_s=10.0, tail_points=240,
                 clock=time.time):
        self.stale_after_s = float(stale_after_s)
        self.tail_points = int(tail_points)
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: dict[str, _ReplicaSeries] = {}
        self.ingests = 0

    # -- write side ---------------------------------------------------------

    def ingest(self, replica, payload, now=None):
        """Merge one `TimeSeriesStore.export()` payload.  Overlapping
        tails dedupe on timestamp; any successful ingest clears the
        stale flag (recovery after a dropped push or restart)."""
        if not payload or not isinstance(payload, dict):
            return
        now = self._clock() if now is None else float(now)
        series = payload.get("series") or {}
        with self._lock:
            rs = self._replicas.get(replica)
            if rs is None:
                rs = self._replicas[replica] = _ReplicaSeries()
            rs.last_ingest = now
            rs.last_seq = payload.get("seq", rs.last_seq)
            rs.interval_s = payload.get("interval_s", rs.interval_s)
            rs.stale = False
            rs.stale_reason = ""
            if payload.get("costs") is not None:
                rs.costs = payload["costs"]
            for key, pts in series.items():
                dq = rs.series.get(key)
                if dq is None:
                    dq = rs.series[key] = deque(maxlen=self.tail_points)
                last = rs.last_t.get(key, -1e30)
                for p in pts:
                    t, v = float(p[0]), float(p[1])
                    if t > last:
                        dq.append((t, v))
                        last = t
                rs.last_t[key] = last
            self.ingests += 1

    def set_pool(self, replica, pool):
        """Tag `replica` with its placement pool so the
        ``pool=`` filters below scope aggregates to one specialist
        pool.  Idempotent; unknown replicas get a slot eagerly so the
        tag survives arriving before the first ingest."""
        with self._lock:
            rs = self._replicas.get(replica)
            if rs is None:
                rs = self._replicas[replica] = _ReplicaSeries()
            rs.pool = str(pool or "mixed")

    def mark_stale(self, replica, reason="marked"):
        """Freeze a replica's series out of fleet aggregates (lease
        fenced, quarantined, SIGKILLed...).  Tails stay readable."""
        with self._lock:
            rs = self._replicas.get(replica)
            if rs is None:
                rs = self._replicas[replica] = _ReplicaSeries()
            rs.stale = True
            rs.stale_reason = reason

    # -- read side ----------------------------------------------------------

    def _is_stale(self, rs, now):
        return rs.stale or (now - rs.last_ingest) > self.stale_after_s

    def replicas(self, now=None):
        """{name: {stale, stale_reason, age_s, series, seq}}."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            return {name: {"stale": self._is_stale(rs, now),
                           "stale_reason": rs.stale_reason,
                           "age_s": now - rs.last_ingest,
                           "series": len(rs.series),
                           "seq": rs.last_seq,
                           "pool": rs.pool}
                    for name, rs in self._replicas.items()}

    def replica_window(self, replica, key, seconds, now=None):
        now = self._clock() if now is None else float(now)
        since = now - float(seconds)
        with self._lock:
            rs = self._replicas.get(replica)
            if rs is None:
                return []
            dq = rs.series.get(key)
            return [(t, v) for t, v in dq or () if t >= since]

    def _windows(self, key, seconds, now, include_stale=False,
                 pool=None):
        """[(replica, [(t, v), ...non-empty]), ...] over live replicas
        (optionally only those tagged with placement pool `pool`)."""
        since = now - float(seconds)
        out = []
        for name, rs in self._replicas.items():
            if pool is not None and rs.pool != pool:
                continue
            if not include_stale and self._is_stale(rs, now):
                continue
            dq = rs.series.get(key)
            if not dq:
                continue
            pts = [(t, v) for t, v in dq if t >= since]
            if pts:
                out.append((name, pts))
        return out

    def fleet_mean(self, key, seconds, now=None, pool=None):
        """Mean over every in-window point across live replicas, or
        None when no live replica has data in the window."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            wins = self._windows(key, seconds, now, pool=pool)
        n = sum(len(pts) for _, pts in wins)
        if not n:
            return None
        return sum(v for _, pts in wins for _, v in pts) / n

    def fleet_max(self, key, seconds, now=None, pool=None):
        now = self._clock() if now is None else float(now)
        with self._lock:
            wins = self._windows(key, seconds, now, pool=pool)
        vals = [v for _, pts in wins for _, v in pts]
        return max(vals) if vals else None

    def fleet_sum(self, key, seconds, now=None, pool=None):
        """Sum over replicas of each replica's window mean — the fleet
        total for per-replica rates (fleet req/s = sum of replica
        req/s), robust to replicas pushing at different cadences."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            wins = self._windows(key, seconds, now, pool=pool)
        if not wins:
            return None
        return sum(sum(v for _, v in pts) / len(pts) for _, pts in wins)

    # -- control-plane queries ---------------------------------------------

    def error_rate(self, tier, seconds, now=None):
        """Windowed SLO error rate for one tier from fleet met/missed
        counter rates; None when the window carries no completions
        (no-traffic can never fire an alert)."""
        met = self.fleet_sum(
            tier_key("slo_met_total", tier), seconds, now=now)
        missed = self.fleet_sum(
            tier_key("slo_missed_total", tier), seconds, now=now)
        if met is None and missed is None:
            return None
        total = (met or 0.0) + (missed or 0.0)
        if total <= 1e-12:
            return None
        return (missed or 0.0) / total

    def goodput(self, tier, seconds, now=None):
        e = self.error_rate(tier, seconds, now=now)
        return None if e is None else 1.0 - e

    def tier_ttft(self, tier, seconds, q=50, now=None):
        return self.fleet_max(
            tier_key("tier_ttft_seconds", tier, f":p{q}"), seconds, now=now)

    def tier_itl(self, tier, seconds, q=50, now=None):
        return self.fleet_max(
            tier_key("tier_itl_seconds", tier, f":p{q}"), seconds, now=now)

    def ttft_p50(self, seconds, now=None):
        return self.fleet_max(f"{ENGINE_NS}_ttft_seconds:p50", seconds,
                              now=now)

    def itl_p50(self, seconds, now=None):
        return self.fleet_max(f"{ENGINE_NS}_itl_seconds:p50", seconds,
                              now=now)

    def occupancy(self, seconds, now=None):
        return self.fleet_mean(f"{ENGINE_NS}_occupancy", seconds, now=now)

    # -- pool-scoped queries ------------------------------------

    def pool_ttft(self, pool, seconds, q=50, now=None):
        return self.fleet_max(f"{ENGINE_NS}_ttft_seconds:p{q}", seconds,
                              now=now, pool=pool)

    def pool_itl(self, pool, seconds, q=50, now=None):
        return self.fleet_max(f"{ENGINE_NS}_itl_seconds:p{q}", seconds,
                              now=now, pool=pool)

    def pool_occupancy(self, pool, seconds, now=None):
        return self.fleet_mean(f"{ENGINE_NS}_occupancy", seconds,
                               now=now, pool=pool)

    def snapshot(self, tail_n=20, now=None):
        """Per-replica series tails + staleness for /debug/fleet."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            out = {}
            for name, rs in self._replicas.items():
                tails = {k: [[t, v] for t, v in list(dq)[-tail_n:]]
                         for k, dq in rs.series.items()}
                out[name] = {"stale": self._is_stale(rs, now),
                             "stale_reason": rs.stale_reason,
                             "age_s": now - rs.last_ingest,
                             "seq": rs.last_seq,
                             "interval_s": rs.interval_s,
                             "costs": rs.costs,
                             "pool": rs.pool,
                             "series": tails}
            return out
