"""Hysteresis-based overload controller: a reversible degradation ladder.

Under sustained overload the engine should not fail requests at random
(`QueueFull`) — it should *degrade the lowest SLO tier first*, in
steps, and undo each step once pressure clears.  The controller reads
live engine signals each step and walks a 4-rung ladder:

  rung 1  disable speculative decoding for the lowest tier (frees the
          verify budget + draft overhead for protected traffic)
  rung 2  shrink the lowest tier's prefill-chunk share of
          `step_token_budget` (its prefills no longer get the
          first-chunk guarantee; protected prefills keep full budget)
  rung 3  stop admitting the lowest tier (queued batch requests wait;
          nothing is failed yet)
  rung 4  shed the lowest tier with a typed `Overloaded` rejection
          (queued + newly submitted batch requests fail fast so
          clients can back off / retry elsewhere)

Escalation and de-escalation are both hysteretic: a rung moves only
after `up_steps` consecutive pressured ticks (resp. `down_steps`
consecutive calm ticks) *and* a minimum dwell at the current rung, and
the pressure/calm thresholds are separated high/low water marks — so a
noisy signal cannot flap the ladder.  The controller is pure host-side
state with an injected signal dict, so every transition is unit-testable
without an engine.
"""

from __future__ import annotations

__all__ = ["OverloadConfig", "OverloadController"]


class OverloadConfig:
    """Thresholds + hysteresis for the degradation ladder.

    Pressure signals (any one trips a "pressured" tick):
      queue_high      protected (non-lowest-tier) queue depth
      preempt_high    preemptions observed since the last tick
      host_high       host-tier (swap pool) block occupancy fraction
      itl_high_s      decode ITL EMA, seconds (None disables — wall
                      clock is too noisy for CPU CI, so tests leave it
                      off and production sets it from the SLO targets)

    Calm requires *every* signal under its low-water mark.  Ticks that
    are neither pressured nor calm hold the current rung (hysteresis
    band).  `up_steps`/`down_steps`/`min_dwell` are measured in engine
    steps; down_steps >> up_steps so the ladder reacts fast and
    recovers cautiously.
    """

    def __init__(self, queue_high=8, queue_low=1,
                 preempt_high=1, preempt_low=0,
                 host_high=0.75, host_low=0.25,
                 itl_high_s=None, itl_low_s=None,
                 up_steps=2, down_steps=8, min_dwell=4,
                 degraded_prefill_frac=0.25, max_rung=4):
        if not (0 <= queue_low <= queue_high):
            raise ValueError("need 0 <= queue_low <= queue_high")
        if not (0 <= preempt_low <= preempt_high):
            raise ValueError("need 0 <= preempt_low <= preempt_high")
        if not (0.0 <= host_low <= host_high <= 1.0):
            raise ValueError("need 0 <= host_low <= host_high <= 1")
        if itl_high_s is not None and itl_low_s is None:
            itl_low_s = itl_high_s / 2.0
        if up_steps < 1 or down_steps < 1 or min_dwell < 0:
            raise ValueError("up_steps/down_steps >= 1, min_dwell >= 0")
        if not (0.0 < degraded_prefill_frac <= 1.0):
            raise ValueError("degraded_prefill_frac in (0, 1]")
        if not (1 <= max_rung <= 4):
            raise ValueError("max_rung in [1, 4]")
        self.queue_high = int(queue_high)
        self.queue_low = int(queue_low)
        self.preempt_high = float(preempt_high)
        self.preempt_low = float(preempt_low)
        self.host_high = float(host_high)
        self.host_low = float(host_low)
        self.itl_high_s = None if itl_high_s is None else float(itl_high_s)
        self.itl_low_s = None if itl_low_s is None else float(itl_low_s)
        self.up_steps = int(up_steps)
        self.down_steps = int(down_steps)
        self.min_dwell = int(min_dwell)
        self.degraded_prefill_frac = float(degraded_prefill_frac)
        self.max_rung = int(max_rung)


class OverloadController:
    """Walks the ladder from per-step signal dicts.

    `update(sig)` takes one tick's signals and returns the (possibly
    new) rung.  Expected keys (missing keys read as zero, so callers
    can feed partial signals in tests):

      queue_depth   protected-tier queued requests (router or engine)
      parked        requests parked on the host tier (any > 0 is
                    pressure: the preempt ladder is already active)
      preempt_rate  preemptions since the previous tick
      host_frac     host swap-pool occupancy in [0, 1]
      itl_ema       decode inter-token-latency EMA, seconds

    Note the *protected* queue depth: a backlog that is purely
    lowest-tier must not wedge the ladder at rung 3/4 forever — batch
    waiting its fair-queue turn is the design working, not overload.
    """

    def __init__(self, config=None):
        self.cfg = config or OverloadConfig()
        self.rung = 0
        self.escalations = 0
        self.deescalations = 0
        #: rung after each transition, in order — lets tests pin the
        #: exact ladder walk (e.g. [1, 2, 3, 4, 3, 2, 1, 0]).
        self.history = []
        self._hot = 0
        self._cold = 0
        self._dwell = self.cfg.min_dwell  # first escalation is not delayed

    def _pressured(self, sig):
        c = self.cfg
        if sig.get("queue_depth", 0) >= c.queue_high:
            return True
        if sig.get("parked", 0) > 0:
            return True
        if sig.get("preempt_rate", 0) >= c.preempt_high:
            return True
        if sig.get("host_frac", 0.0) >= c.host_high:
            return True
        if c.itl_high_s is not None and sig.get("itl_ema", 0.0) >= c.itl_high_s:
            return True
        return False

    def _calm(self, sig):
        c = self.cfg
        if sig.get("queue_depth", 0) > c.queue_low:
            return False
        if sig.get("parked", 0) > 0:
            return False
        if sig.get("preempt_rate", 0) > c.preempt_low:
            return False
        if sig.get("host_frac", 0.0) > c.host_low:
            return False
        if c.itl_low_s is not None and sig.get("itl_ema", 0.0) > c.itl_low_s:
            return False
        return True

    def update(self, sig, force_up=False):
        """One tick.  `force_up` (fault injection) escalates immediately,
        bypassing hysteresis — used to pin ladder transitions in tests."""
        c = self.cfg
        self._dwell += 1
        if force_up:
            if self.rung < c.max_rung:
                self._move(self.rung + 1)
            return self.rung
        if self._pressured(sig):
            self._hot += 1
            self._cold = 0
        elif self._calm(sig):
            self._cold += 1
            self._hot = 0
        else:  # hysteresis band: hold
            self._hot = 0
            self._cold = 0
        if (self._hot >= c.up_steps and self._dwell >= c.min_dwell
                and self.rung < c.max_rung):
            self._move(self.rung + 1)
        elif (self._cold >= c.down_steps and self._dwell >= c.min_dwell
                and self.rung > 0):
            self._move(self.rung - 1)
        return self.rung

    def _move(self, rung):
        if rung > self.rung:
            self.escalations += 1
        else:
            self.deescalations += 1
        self.rung = rung
        self.history.append(rung)
        self._hot = 0
        self._cold = 0
        self._dwell = 0
