"""Deterministic fault injection — the port of the JAX package's
`testing/faults.py` switchboard, reduced to what the port's sites use.

Production code calls ``faults.fire(site, **ctx)`` at a named site;
tests arm rules against the site.  A rule fires by call count:
``after`` skips the first k calls at its site, ``times`` bounds how
many calls trip it (None: every call after ``after``), and a tripped
call raises `InjectedFault`.

``fire`` does nothing unless the harness is switched on (``ENABLED``,
the counterpart of the JAX package's ``FLAGS_fault_injection``: the
port has no flags module) AND a rule is installed; the dormant cost is
one list check.  Tests switch it on and off around the rules they arm::

    faults.ENABLED = True
    get_injector().inject("kv.swap_out", times=None)
    ...
    get_injector().clear()
    faults.ENABLED = False

Sites wired in the port:

  ===========  ========================================================
  site         raised from
  ===========  ========================================================
  kv.alloc     LLMEngine._alloc_blocks, before each paged-pool
               allocation; an injected fault is a FAILED allocation (a
               schedulable event feeding the preempt ladder), never an
               error (ctx: need, free)
  kv.swap_out  LLMEngine park path, before a slot's blocks are gathered
               for the host tier; the engine falls back to
               drop-and-recompute (ctx: slot, rid)
  kv.swap_in   LLMEngine resume path, before the host blocks scatter
               back to the pool; the request RE-PARKS with its host tier
               intact (ctx: slot, rid)
  ===========  ========================================================
"""

from __future__ import annotations

import threading

__all__ = ["InjectedFault", "FaultInjector", "get_injector", "fire",
           "ENABLED"]

#: the harness's master switch (see the module docstring)
ENABLED = False


class InjectedFault(RuntimeError):
    """An error raised on purpose by the fault harness."""


class _Rule:
    __slots__ = ("site", "after", "times", "fired", "seen")

    def __init__(self, site, after, times):
        self.site = site
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.fired = 0       # calls that actually tripped
        self.seen = 0        # calls at this site since installation

    def trips(self):
        """Count one call at the site; True when this call trips."""
        self.seen += 1
        if self.seen <= self.after or (self.times is not None
                                       and self.fired >= self.times):
            return False
        self.fired += 1
        return True


class FaultInjector:
    """Process-global rule table the `fire()` sites consult."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: list[_Rule] = []

    def inject(self, site, *, times=1, after=0):
        """Arm one rule: the ``after+1``-th .. ``after+times``-th calls
        at `site` raise `InjectedFault`.  Returns the rule
        (``rule.fired`` counts trips)."""
        rule = _Rule(site, after, times)
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear(self, site=None):
        """Drop every rule (or just `site`'s)."""
        with self._lock:
            if site is None:
                self._rules.clear()
            else:
                self._rules = [r for r in self._rules if r.site != site]

    def rules(self, site=None):
        with self._lock:
            return [r for r in self._rules
                    if site is None or r.site == site]

    def fire(self, site, **ctx):
        """Consult the rule table for `site`; raise when a rule trips.
        `ctx` describes the call (the sites pass it; no rule reads it
        here)."""
        with self._lock:
            tripped = next((r for r in self._rules
                            if r.site == site and r.trips()), None)
        if tripped is not None:
            raise InjectedFault(f"injected fault at {site} "
                                f"(trip {tripped.fired})")


_INJECTOR = FaultInjector()


def get_injector() -> FaultInjector:
    return _INJECTOR


def fire(site, **ctx):
    """Hot-path entry: a no-op while no rule is armed or the harness is
    switched off (`ENABLED`)."""
    if not _INJECTOR._rules or not ENABLED:
        return
    _INJECTOR.fire(site, **ctx)
