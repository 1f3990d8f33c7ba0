"""Multi-window SLO burn-rate alerting: the port of the JAX package's
`observability/alerts.py`.

An error budget is ``1 - target`` goodput; the *burn rate* of a window
is ``error_rate / budget`` (1.0 spends the budget exactly on schedule);
a rule fires only when BOTH a fast and a slow window burn above their
thresholds (the fast window detects, the slow one rejects blips).  On
top sits evaluation hysteresis: ``fire_after`` consecutive breaching
evaluations to fire, ``resolve_after`` consecutive calm ones (the fast
burn under ``resolve_frac`` of its threshold, or no traffic) to
resolve, so an alert cannot flap at poll cadence.

Inputs are pulled: ``AlertManager.evaluate(error_rate_fn, now=)`` asks
for the windowed error rate per (tier, window), e.g.
`FleetMetricsAggregator.error_rate`.  ``None`` (no traffic in the
window) never *fires* a rule; while a rule fires it counts toward
resolution.  Transitions produce `Alert` records and run the manager's
``on_fire`` / ``on_resolve`` hooks (outside its lock; a hook that
raises is ignored).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .slo import SLOTier

__all__ = ["Alert", "BurnRateRule", "AlertManager", "default_burn_rules"]


class Alert:
    """One alert lifecycle: fired at some instant with the burn rates
    that tripped it, later resolved (or still firing)."""

    __slots__ = ("name", "tier", "severity", "state", "fired_t",
                 "resolved_t", "burn_fast", "burn_slow", "message")

    def __init__(self, name, tier, severity, fired_t, burn_fast,
                 burn_slow, message=""):
        self.name = name
        self.tier = tier
        self.severity = severity
        self.state = "firing"
        self.fired_t = fired_t
        self.resolved_t = None
        self.burn_fast = burn_fast
        self.burn_slow = burn_slow
        self.message = message

    def resolve(self, now):
        self.state = "resolved"
        self.resolved_t = now

    def to_dict(self):
        return {"name": self.name, "tier": self.tier,
                "severity": self.severity, "state": self.state,
                "fired_t": self.fired_t, "resolved_t": self.resolved_t,
                "burn_fast": self.burn_fast, "burn_slow": self.burn_slow,
                "message": self.message}

    def __repr__(self):
        return (f"Alert({self.name!r}, {self.state}, "
                f"fast={self.burn_fast:.2f}, slow={self.burn_slow:.2f})")


class BurnRateRule:
    """Per-tier error-budget rule: fire when the fast AND slow window
    burn rates both exceed their thresholds for ``fire_after``
    consecutive evaluations; resolve after ``resolve_after``
    consecutive calm evaluations (fast burn < resolve_frac *
    fast_burn, or no traffic)."""

    __slots__ = ("name", "tier", "target", "fast_window_s",
                 "slow_window_s", "fast_burn", "slow_burn", "fire_after",
                 "resolve_after", "resolve_frac", "severity")

    def __init__(self, name, tier, target=None, fast_window_s=60.0,
                 slow_window_s=300.0, fast_burn=6.0, slow_burn=3.0,
                 fire_after=2, resolve_after=3, resolve_frac=0.5,
                 severity="page"):
        if target is None:
            target = 0.95
        if not (0.0 < target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {target}")
        self.name = name
        self.tier = str(tier)
        self.target = float(target)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.fire_after = int(fire_after)
        self.resolve_after = int(resolve_after)
        self.resolve_frac = float(resolve_frac)
        self.severity = severity

    @property
    def budget(self):
        return max(1e-9, 1.0 - self.target)

    def to_dict(self):
        return {"name": self.name, "tier": self.tier, "target": self.target,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "fast_burn": self.fast_burn, "slow_burn": self.slow_burn,
                "fire_after": self.fire_after,
                "resolve_after": self.resolve_after,
                "resolve_frac": self.resolve_frac,
                "severity": self.severity}


def default_burn_rules(targets=None, **kw):
    """One rule per SLO tier at a 95% goodput target: page on a 6x/3x
    fast/slow burn pair.  ``kw`` overrides any BurnRateRule knob."""
    targets = targets if targets is not None else \
        {t: 0.95 for t in SLOTier.ALL}
    return [BurnRateRule(f"slo-burn-{tier}", tier, target=tgt, **kw)
            for tier, tgt in sorted(targets.items())]


class _RuleState:
    __slots__ = ("breach", "calm", "alert", "burn_fast", "burn_slow")

    def __init__(self):
        self.breach = 0
        self.calm = 0
        self.alert = None       # the currently-firing Alert, if any
        self.burn_fast = None
        self.burn_slow = None


class AlertManager:
    """Evaluates burn-rate rules against windowed error rates and keeps
    the firing set plus a bounded history of transitions."""

    def __init__(self, rules=(), on_fire=None, on_resolve=None,
                 clock=time.time, history=64):
        self._rules = list(rules)
        self._on_fire = on_fire
        self._on_resolve = on_resolve
        self._clock = clock
        self._lock = threading.Lock()
        self._state = {r.name: _RuleState() for r in self._rules}
        self.history = deque(maxlen=history)
        self.evaluations = 0
        self.fired_total = 0

    @property
    def rules(self):
        return tuple(self._rules)

    def evaluate(self, error_rate_fn, now=None):
        """One evaluation pass.  ``error_rate_fn(tier, window_s,
        now=now)`` returns the windowed error rate in [0, 1] or None
        when the window holds no traffic.  Returns the list of Alert
        transitions (newly fired or newly resolved) this pass."""
        now = self._clock() if now is None else float(now)
        transitions = []
        callbacks = []
        with self._lock:
            self.evaluations += 1
            for rule in self._rules:
                st = self._state[rule.name]
                ef = error_rate_fn(rule.tier, rule.fast_window_s, now=now)
                es = error_rate_fn(rule.tier, rule.slow_window_s, now=now)
                bf = None if ef is None else ef / rule.budget
                bs = None if es is None else es / rule.budget
                st.burn_fast, st.burn_slow = bf, bs
                breaching = (bf is not None and bs is not None
                             and bf >= rule.fast_burn
                             and bs >= rule.slow_burn)
                if st.alert is None:
                    st.calm = 0
                    st.breach = st.breach + 1 if breaching else 0
                    if st.breach >= rule.fire_after:
                        st.breach = 0
                        st.alert = Alert(
                            rule.name, rule.tier, rule.severity, now,
                            bf, bs,
                            message=(f"{rule.tier}: burn fast={bf:.2f}x "
                                     f"(>= {rule.fast_burn}x) slow="
                                     f"{bs:.2f}x (>= {rule.slow_burn}x) "
                                     f"of {rule.budget:.3f} budget"))
                        self.history.append(st.alert)
                        self.fired_total += 1
                        transitions.append(st.alert)
                        if self._on_fire:
                            callbacks.append((self._on_fire, st.alert))
                else:
                    st.breach = 0
                    calm = (bf is None
                            or bf < rule.fast_burn * rule.resolve_frac)
                    st.calm = st.calm + 1 if calm else 0
                    if st.calm >= rule.resolve_after:
                        st.calm = 0
                        st.alert.resolve(now)
                        transitions.append(st.alert)
                        if self._on_resolve:
                            callbacks.append((self._on_resolve, st.alert))
                        st.alert = None
        for fn, alert in callbacks:     # outside the lock; never raise
            try:
                fn(alert)
            except Exception:
                pass
        return transitions

    def firing(self):
        with self._lock:
            return [st.alert for st in self._state.values()
                    if st.alert is not None]

    def burn_rates(self):
        """{rule_name: {tier, fast, slow, firing}} from the most recent
        evaluation (None = no traffic in that window)."""
        with self._lock:
            out = {}
            for rule in self._rules:
                st = self._state[rule.name]
                out[rule.name] = {"tier": rule.tier,
                                  "fast": st.burn_fast,
                                  "slow": st.burn_slow,
                                  "firing": st.alert is not None}
            return out

    def snapshot(self):
        with self._lock:
            return {
                "rules": [r.to_dict() for r in self._rules],
                "firing": [st.alert.to_dict()
                           for st in self._state.values()
                           if st.alert is not None],
                "history": [a.to_dict() for a in self.history],
                "evaluations": self.evaluations,
                "fired_total": self.fired_total,
            }
