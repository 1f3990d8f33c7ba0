"""The port's fleet series and burn-rate alerts
(`paddle_tpu_torch/observability/{fleet_series,alerts}.py`): the JAX
suite's alert-hysteresis and aggregator tests mirrored on the port, then
the cross-package contract: the same payloads and the same `now=` give
the same aggregates, the same fire and resolve events and the same
snapshots in both packages, for scripted payloads and for a port
server's own `metrics_series()` payloads.

Every clock is injected (`now=` or a fake clock); nothing here depends
on host scheduling."""

import numpy as np
import pytest

from paddle_tpu_torch.inference import LLMServer
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.observability import (AlertManager, BurnRateRule,
                                            FleetMetricsAggregator,
                                            MetricsRegistry, TimeSeriesStore,
                                            default_burn_rules)
from paddle_tpu_torch.observability.fleet_series import ENGINE_NS, tier_key


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt
        return self.t


def _jax():
    pytest.importorskip("jax")
    from paddle_tpu.observability import alerts as JA
    from paddle_tpu.observability import fleet_series as JF
    return JA, JF


# -- burn-rate alerting hysteresis (the JAX suite's cases) --------------------


def _rule(cls=BurnRateRule, **kw):
    kw.setdefault("target", 0.9)
    kw.setdefault("fast_window_s", 60.0)
    kw.setdefault("slow_window_s", 300.0)
    kw.setdefault("fast_burn", 2.0)
    kw.setdefault("slow_burn", 1.0)
    kw.setdefault("fire_after", 2)
    kw.setdefault("resolve_after", 2)
    kw.setdefault("resolve_frac", 0.5)
    return cls("r", "interactive", **kw)


def _mgr(rule, clock=None, **kw):
    return AlertManager([rule], clock=clock or FakeClock(), **kw)


def _const_rate(e):
    def fn(tier, window_s, now=None):
        return e
    return fn


def test_alert_fires_after_consecutive_breaches_and_resolves():
    fired, resolved = [], []
    clock = FakeClock()
    mgr = _mgr(_rule(), clock=clock, on_fire=fired.append,
               on_resolve=resolved.append)
    hot = _const_rate(0.5)
    assert mgr.evaluate(hot) == []
    assert not mgr.firing()
    clock.tick()
    trans = mgr.evaluate(hot)
    assert len(trans) == 1 and trans[0].state == "firing"
    assert mgr.firing() and fired and fired[0].burn_fast == \
        pytest.approx(5.0)
    calm = _const_rate(0.05)
    assert mgr.evaluate(calm) == []
    assert mgr.evaluate(hot) == []
    assert mgr.evaluate(calm) == []
    assert mgr.firing()
    trans = mgr.evaluate(calm)
    assert len(trans) == 1 and trans[0].state == "resolved"
    assert not mgr.firing() and resolved
    snap = mgr.snapshot()
    assert snap["fired_total"] == 1 and snap["evaluations"] == 6
    assert [a["state"] for a in snap["history"]] == ["resolved"]


def test_no_traffic_never_fires_but_resolves():
    mgr = _mgr(_rule())
    none = _const_rate(None)
    for _ in range(10):
        mgr.evaluate(none)
    assert not mgr.firing()
    assert mgr.burn_rates()["r"]["fast"] is None
    hot = _const_rate(0.5)
    mgr.evaluate(hot)
    mgr.evaluate(hot)
    assert mgr.firing()
    mgr.evaluate(none)
    mgr.evaluate(none)
    assert not mgr.firing()


def test_one_window_alone_cannot_fire():
    mgr = _mgr(_rule())

    def fast_only(tier, window_s, now=None):
        return 0.5 if window_s < 100 else 0.0

    for _ in range(5):
        mgr.evaluate(fast_only)
    assert not mgr.firing()


def test_non_consecutive_breaches_do_not_fire():
    mgr = _mgr(_rule(fire_after=2))
    hot, calm = _const_rate(0.5), _const_rate(0.0)
    for _ in range(4):
        mgr.evaluate(hot)
        mgr.evaluate(calm)
    assert not mgr.firing()


def test_hook_that_raises_is_ignored():
    def boom(alert):
        raise RuntimeError("hook")
    mgr = _mgr(_rule(fire_after=1), on_fire=boom)
    assert len(mgr.evaluate(_const_rate(0.5))) == 1 and mgr.firing()


def test_rule_validation_and_defaults():
    with pytest.raises(ValueError):
        BurnRateRule("r", "interactive", target=1.0)
    with pytest.raises(ValueError):
        BurnRateRule("r", "interactive", target=0.0)
    r = BurnRateRule("r", "interactive")
    assert r.target == 0.95 and r.budget == pytest.approx(0.05)
    rules = default_burn_rules()
    assert {r.tier for r in rules} == {"interactive", "standard", "batch"}
    assert all(r.name == f"slo-burn-{r.tier}" for r in rules)


# -- the fleet aggregator (the JAX suite's cases) -----------------------------


def _payload(pts, key="llm_engine_occupancy", seq=1, t=100.0):
    return {"t": t, "seq": seq, "interval_s": 1.0,
            "series": {key: [[float(a), float(b)] for a, b in pts]}}


def test_ingest_dedupes_overlapping_tails():
    agg = FleetMetricsAggregator(clock=FakeClock(100.0))
    agg.ingest("r0", _payload([(1, 1.0), (2, 2.0), (3, 3.0)]), now=100.0)
    agg.ingest("r0", _payload([(2, 2.0), (3, 3.0), (4, 4.0)], seq=2),
               now=100.5)
    pts = agg.replica_window("r0", "llm_engine_occupancy", 1000.0,
                             now=100.5)
    assert [t for t, _ in pts] == [1.0, 2.0, 3.0, 4.0]
    assert agg.ingests == 2
    assert agg.replicas(now=100.5)["r0"]["seq"] == 2


def test_stale_by_age_and_mark_and_recovery():
    clock = FakeClock(100.0)
    agg = FleetMetricsAggregator(stale_after_s=5.0, clock=clock)
    agg.ingest("r0", _payload([(99, 1.0)]), now=100.0)
    agg.ingest("r1", _payload([(99, 3.0)]), now=100.0)
    assert agg.fleet_mean("llm_engine_occupancy", 60.0, now=100.0) == \
        pytest.approx(2.0)
    clock.t = 104.0
    agg.ingest("r0", _payload([(103, 1.0)], seq=2), now=104.0)
    clock.t = 107.0
    assert agg.replicas()["r1"]["stale"] is True
    assert agg.fleet_mean("llm_engine_occupancy", 60.0) == \
        pytest.approx(1.0)
    agg.mark_stale("r0", reason="lease-fenced")
    assert agg.replicas()["r0"]["stale_reason"] == "lease-fenced"
    assert agg.fleet_mean("llm_engine_occupancy", 60.0) is None
    assert agg.snapshot()["r0"]["series"]["llm_engine_occupancy"]
    agg.ingest("r0", _payload([(106, 5.0)], seq=3), now=107.0)
    assert agg.replicas()["r0"]["stale"] is False
    assert agg.fleet_mean("llm_engine_occupancy", 60.0) == \
        pytest.approx(7.0 / 3.0)


def test_fleet_sum_is_sum_of_replica_means():
    agg = FleetMetricsAggregator(clock=FakeClock(100.0))
    key = tier_key("slo_met_total", "interactive")
    agg.ingest("r0", _payload([(98, 2.0), (99, 2.0)], key=key), now=100.0)
    agg.ingest("r1", _payload([(99, 3.0)], key=key), now=100.0)
    assert agg.fleet_sum(key, 60.0, now=100.0) == pytest.approx(5.0)


def test_error_rate_and_goodput():
    agg = FleetMetricsAggregator(clock=FakeClock(100.0))
    met = tier_key("slo_met_total", "interactive")
    missed = tier_key("slo_missed_total", "interactive")
    assert agg.error_rate("interactive", 60.0, now=100.0) is None
    agg.ingest("r0", {"t": 100.0, "seq": 1, "interval_s": 1.0,
                      "series": {met: [[99.0, 3.0]],
                                 missed: [[99.0, 1.0]]}}, now=100.0)
    assert agg.error_rate("interactive", 60.0, now=100.0) == \
        pytest.approx(0.25)
    assert agg.goodput("interactive", 60.0, now=100.0) == \
        pytest.approx(0.75)
    assert agg.error_rate("interactive", 0.5, now=200.0) is None


def test_pool_filters_scope_aggregates():
    agg = FleetMetricsAggregator(clock=FakeClock(100.0))
    key = f"{ENGINE_NS}_itl_seconds:p50"
    agg.set_pool("p0", "prefill")
    agg.ingest("p0", _payload([(99, 0.5)], key=key), now=100.0)
    agg.ingest("d0", _payload([(99, 0.01)], key=key), now=100.0)
    agg.set_pool("d0", "decode")
    assert agg.pool_itl("decode", 60.0, now=100.0) == pytest.approx(0.01)
    assert agg.pool_itl("prefill", 60.0, now=100.0) == pytest.approx(0.5)
    assert agg.itl_p50(60.0, now=100.0) == pytest.approx(0.5)
    assert agg.replicas(now=100.0)["p0"]["pool"] == "prefill"


def test_tier_key_matches_store_naming():
    reg = MetricsRegistry(namespace="llm_engine")
    c = reg.counter("slo_met_total", labelnames=("tier",))
    c.labels(tier="interactive").inc()
    ts = TimeSeriesStore(reg, tiers=((1.0, 8),), clock=FakeClock())
    ts.sample(now=0.0)
    c.labels(tier="interactive").inc(2)
    ts.sample(now=1.0)
    key = tier_key("slo_met_total", "interactive")
    assert key in ts.keys()
    agg = FleetMetricsAggregator(clock=FakeClock(1.0))
    agg.ingest("r0", ts.export(), now=1.0)
    assert agg.fleet_sum(key, 60.0, now=1.0) == pytest.approx(2.0)


# -- the same inputs through both packages -------------------------------------


KEYS = [f"{ENGINE_NS}_occupancy", f"{ENGINE_NS}_ttft_seconds:p50",
        f"{ENGINE_NS}_itl_seconds:p50", f"{ENGINE_NS}_tokens_per_sec",
        tier_key("slo_met_total", "interactive"),
        tier_key("slo_missed_total", "interactive"),
        tier_key("tier_ttft_seconds", "interactive", ":p99")]


def _script(seed=7):
    """A seeded timeline of (now, replica, payload or action): three
    replicas in two pools pushing overlapping tails at their own
    cadences, one marked stale and recovering, one falling silent."""
    rng = np.random.default_rng(seed)
    events, last = [], {}
    for step in range(60):
        now = 1000.0 + 0.5 * step
        for i, name in enumerate(("r0", "r1", "r2")):
            if step % (i + 1) or (name == "r2" and step > 40):
                continue
            t0 = last.get(name, now - 3.0)
            pts = {k: [[float(t), float(rng.uniform(0, 4))]
                       for t in np.arange(max(t0 - 1.0, now - 4.0), now,
                                          0.5)]
                   for k in KEYS if rng.random() < 0.9}
            last[name] = now
            events.append((now, name, {"t": now, "seq": step,
                                       "interval_s": 0.5,
                                       "series": pts}))
        if step == 20:
            events.append((now, "r1", "stale"))
    return events


def _drive(agg, mgr, events, t_end=1040.0):
    """Ingest the timeline; after every event query everything and
    evaluate the alerts.  Returns every answer in order."""
    out = []
    for now, name, what in events:
        if what == "stale":
            agg.mark_stale(name, reason="lease-fenced")
        else:
            agg.ingest(name, what, now=now)
        for w in (2.0, 10.0, 60.0):
            out.append([agg.fleet_mean(k, w, now=now) for k in KEYS])
            out.append([agg.fleet_max(k, w, now=now) for k in KEYS])
            out.append([agg.fleet_sum(k, w, now=now) for k in KEYS])
            out.append([agg.error_rate("interactive", w, now=now),
                        agg.goodput("interactive", w, now=now),
                        agg.tier_ttft("interactive", w, q=99, now=now),
                        agg.ttft_p50(w, now=now), agg.itl_p50(w, now=now),
                        agg.occupancy(w, now=now),
                        agg.pool_itl("decode", w, now=now),
                        agg.pool_occupancy("prefill", w, now=now)])
        out.append(agg.replicas(now=now))
        out.append([a.to_dict() for a in mgr.evaluate(agg.error_rate,
                                                      now=now)])
    out.append(agg.snapshot(tail_n=5, now=t_end))
    out.append(agg.replica_window("r0", KEYS[0], 30.0, now=t_end))
    out.append(mgr.snapshot())
    out.append(mgr.burn_rates())
    return out


def _pair(JA, JF, stale_after_s=3.0):
    aggs, mgrs = [], []
    for A, F in ((JA, JF), (None, None)):
        Agg = FleetMetricsAggregator if F is None else \
            F.FleetMetricsAggregator
        Mgr = AlertManager if A is None else A.AlertManager
        Rule = BurnRateRule if A is None else A.BurnRateRule
        rules_fn = default_burn_rules if A is None else A.default_burn_rules
        agg = Agg(stale_after_s=stale_after_s, tail_points=32,
                  clock=FakeClock(0.0))
        agg.set_pool("r0", "decode")
        agg.set_pool("r1", "prefill")
        rules = rules_fn(fast_window_s=2.0, slow_window_s=10.0,
                         fire_after=2, resolve_after=2) + [
            _rule(Rule, fast_window_s=1.0, slow_window_s=5.0,
                  fire_after=1, resolve_after=3)]
        aggs.append(agg)
        mgrs.append(Mgr(rules, clock=FakeClock(0.0)))
    return aggs, mgrs


def test_same_payloads_same_answers_in_both_packages():
    """A scripted timeline into a JAX and a port aggregator and alert
    manager: every aggregate, every replica table, every alert
    transition and both snapshots are equal, exactly."""
    JA, JF = _jax()
    (jagg, tagg), (jmgr, tmgr) = _pair(JA, JF)
    events = _script()
    theirs, mine = _drive(jagg, jmgr, events), _drive(tagg, tmgr, events)
    assert mine == theirs
    fired = [a for step in mine if isinstance(step, list) for a in step
             if isinstance(a, dict) and a.get("state") == "firing"]
    assert fired and tmgr.snapshot()["fired_total"] >= 1


def test_server_payloads_same_answers_in_both_packages():
    """A port server's own `metrics_series()` payloads (its sampler
    driven with `now=`), after greedy traffic, into both packages'
    aggregators: the series carry the engine's tier keys, and every
    aggregate and snapshot agrees."""
    JA, JF = _jax()
    model = TModel(TConfig.from_preset("tiny"), device="cpu", seed=4)
    srv = LLMServer(model, name="series", series_interval=3600.0,
                    watchdog_deadline=None, max_slots=2, max_len=64,
                    max_prompt_len=32, min_bucket=8, prefill_chunk=8)
    try:
        store = srv.series_store
        store.sample(now=10.0)
        rng = np.random.default_rng(1)
        for i in range(3):
            reqs = [srv.submit(rng.integers(0, 256, 6 + 3 * j), 5,
                               tier=("interactive", "standard")[j % 2])
                    for j in range(3)]
            for r in reqs:
                r.result(timeout=300)
            store.sample(now=11.0 + i)
        payload = srv.metrics_series(n=8)
    finally:
        srv.shutdown()
    assert payload["name"] == "series" and payload["costs"] == []
    met = tier_key("slo_met_total", "interactive")
    assert met in payload["series"]
    assert f"{ENGINE_NS}_tokens_per_sec" in payload["series"]
    (jagg, tagg), (jmgr, tmgr) = _pair(JA, JF, stale_after_s=60.0)
    for agg, mgr in ((jagg, jmgr), (tagg, tmgr)):
        agg.ingest("a", payload, now=13.0)
        agg.ingest("b", dict(payload, seq=payload["seq"] + 1), now=13.5)
        agg.mark_stale("b", reason="quarantined")
    for now in (13.5, 14.0, 30.0):
        for k in payload["series"]:
            assert tagg.fleet_sum(k, 5.0, now=now) == \
                jagg.fleet_sum(k, 5.0, now=now)
            assert tagg.fleet_max(k, 5.0, now=now) == \
                jagg.fleet_max(k, 5.0, now=now)
        assert tagg.error_rate("standard", 5.0, now=now) == \
            jagg.error_rate("standard", 5.0, now=now)
        assert [a.to_dict() for a in tmgr.evaluate(tagg.error_rate,
                                                   now=now)] == \
            [a.to_dict() for a in jmgr.evaluate(jagg.error_rate, now=now)]
    assert tagg.snapshot(now=14.0) == jagg.snapshot(now=14.0)
    assert tmgr.snapshot() == jmgr.snapshot()
