"""SLO tiers, per-tier latency targets, and goodput accounting.

Serving traffic is not one class: a chat turn that misses 250 ms ITL is
a product failure, while an overnight eval sweep only cares that it
finishes.  This module defines the three-tier taxonomy carried on every
`Request`/`RouterRequest` and the measurement side of differentiated
service — per-tier TTFT/ITL targets and *goodput*, the fraction of
finished requests that met their tier's targets.  Goodput (not raw
throughput) is the headline serving metric: a saturated engine that
streams mostly-late tokens has high throughput and terrible goodput.

The scheduler side (weighted fair queuing, tier-aware preemption, the
overload degradation ladder) lives in `inference/`; everything here is
pure bookkeeping so it can be unit-tested without an engine.
"""

from __future__ import annotations

__all__ = ["SLOTier", "SLOTargets", "goodput", "DEFAULT_SLO_TARGETS"]


class SLOTier:
    """The three service classes, ordered by protection.

    ``interactive``  user-facing chat/completion turns; protected first.
    ``standard``     default tier for API traffic with relaxed latency.
    ``batch``        offline/bulk work; first to degrade, park, or shed
                     under overload, but never starved outright (the
                     router's weighted rotation always gives it a lane).

    Tiers are plain strings on the wire (JSON params, journal records,
    healthz) — this class just centralises validation and ordering.
    """

    INTERACTIVE = "interactive"
    STANDARD = "standard"
    BATCH = "batch"

    #: All tiers, most-protected first.
    ALL = (INTERACTIVE, STANDARD, BATCH)

    _RANK = {INTERACTIVE: 2, STANDARD: 1, BATCH: 0}

    @classmethod
    def check(cls, tier):
        """Normalise + validate a tier name; returns the canonical str."""
        if tier is None:
            return cls.STANDARD
        t = str(tier).strip().lower()
        if t not in cls._RANK:
            raise ValueError(
                f"unknown SLO tier {tier!r}; expected one of {cls.ALL}")
        return t

    @classmethod
    def rank(cls, tier):
        """Protection rank: batch=0 < standard=1 < interactive=2.

        Preemption ladders sort ascending (lowest rank parks first);
        admission/serve orders sort descending.
        """
        return cls._RANK[cls.check(tier)]

    @classmethod
    def lowest(cls):
        """The tier the degradation ladder targets first."""
        return cls.BATCH


#: Default per-tier (ttft_s, itl_s) targets.  Deliberately loose for
#: the batch tier: it has no interactive user, only a completion SLA.
DEFAULT_SLO_TARGETS = {
    SLOTier.INTERACTIVE: (1.0, 0.25),
    SLOTier.STANDARD: (10.0, 1.0),
    SLOTier.BATCH: (120.0, 10.0),
}


class SLOTargets:
    """Per-tier TTFT/ITL targets and the met/missed decision.

    A finished request meets its SLO when its TTFT and its *mean* ITL
    are both within the tier's targets.  Mean (not max) ITL is used so
    a single slow step — a preemption park/resume, a compile — does not
    condemn an otherwise-healthy stream; sustained slowness still
    fails the mean.
    """

    def __init__(self, targets=None):
        self._t = {k: tuple(v) for k, v in DEFAULT_SLO_TARGETS.items()}
        for tier, tgt in (targets or {}).items():
            tier = SLOTier.check(tier)
            ttft_s, itl_s = tgt
            if ttft_s <= 0 or itl_s <= 0:
                raise ValueError(
                    f"SLO targets must be positive, got {tgt!r} for {tier}")
            self._t[tier] = (float(ttft_s), float(itl_s))

    def for_tier(self, tier):
        """(ttft_s, itl_s) targets for `tier`."""
        return self._t[SLOTier.check(tier)]

    def met(self, tier, ttft_s, mean_itl_s):
        """True iff a request with these latencies met its tier's SLO."""
        ttft_tgt, itl_tgt = self.for_tier(tier)
        return ttft_s <= ttft_tgt and mean_itl_s <= itl_tgt

    def as_dict(self):
        return {t: self._t[t] for t in SLOTier.ALL}


def goodput(met, missed):
    """Per-tier + overall SLO attainment from met/missed counts.

    `met`/`missed` map tier -> count.  Tiers with no finished requests
    report attainment 1.0 (nothing was late).  Returns
    ``{tier: frac, ..., "overall": frac}``.
    """
    out = {}
    tot_m = tot_x = 0
    for tier in SLOTier.ALL:
        m = int(met.get(tier, 0))
        x = int(missed.get(tier, 0))
        tot_m += m
        tot_x += x
        out[tier] = m / (m + x) if (m + x) else 1.0
    out["overall"] = tot_m / (tot_m + tot_x) if (tot_m + tot_x) else 1.0
    return out
