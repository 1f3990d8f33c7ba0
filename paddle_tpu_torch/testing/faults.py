"""Deterministic fault injection — the port of the JAX package's
`testing/faults.py` switchboard, reduced to what the port's sites use.

Production code calls ``faults.fire(site, **ctx)`` at a named site;
tests arm rules against the site.  A rule fires by call count:
``after`` skips the first k calls at its site, ``times`` bounds how
many calls trip it (None: every call after ``after``); a rule with
``prob < 1`` trips a counted call with that probability, drawn from a
``random.Random(seed)`` made at ``inject()`` time, so a seeded run
replays exactly.  A tripped call sleeps ``delay`` seconds, runs
``callback(ctx)`` (an exception it returns is raised instead), then
raises ``exc`` (default `InjectedFault`); ``exc=None`` with a delay or
a callback wedges the site instead of failing it.

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

  ===============  ====================================================
  site             raised from
  ===============  ====================================================
  kv.alloc         LLMEngine._alloc_blocks, before each paged-pool
                   allocation; an injected fault is a FAILED
                   allocation (a schedulable event feeding the preempt
                   ladder), never an error (ctx: need, free)
  kv.swap_out      LLMEngine park path, before a slot's blocks are
                   gathered for the host tier; the engine falls back to
                   drop-and-recompute (ctx: slot, rid)
  kv.swap_in       LLMEngine resume path, before the host blocks
                   scatter back to the pool; the request RE-PARKS with
                   its host tier intact (ctx: slot, rid)
  kv.prefetch      LLMEngine._prefetch_tick, once per scheduler step of a
                   tiered engine (`hot_window`); an injected fault
                   SKIPS the tick: no block is promoted, the extension
                   rows are read in place (ctx: depth, ext_used)
  engine.overload  LLMEngine._overload_tick, once per scheduler step
                   while the overload ladder is armed; an injected
                   fault FORCES one ladder escalation (bypassing
                   hysteresis), never an error (ctx: rung)
  engine.canary    LLMServer canary self-probe, when the golden
                   request's tokens are compared; an injected fault IS
                   a canary mismatch: the server quarantines itself
                   (ctx: name)
  engine.stall     LLMServer driver loop, before each scheduler step
                   (after replica.crash); arm with ``exc=None,
                   delay=N`` to wedge the step loop and trip the hang
                   watchdog (ctx: name)
  replica.crash    LLMServer driver loop, before each actual scheduler
                   step (never on idle wakeups); a raise there crashes
                   the driver: every pending request fails with
                   EngineUnhealthy (ctx: name)
  replica.poison   LLMServer.submit of a request carrying `chaos_mark`,
                   once it is queued; a tripped rule arms the driver
                   to raise that fault at its next real step, right
                   after replica.crash (the poison drill: co-batched
                   requests die with it) (ctx: name, mark)
  router.admit     Router.submit, before the bound check and the
                   journal write: a raise rejects the request at the
                   door, nothing recorded (ctx: rid, client, tier)
  router.dispatch  Router._dispatch, before each dispatch to a replica;
                   a raise is a dispatch error: the request is requeued
                   and the replica fenced only after three in a row
                   (ctx: rid, replica)
  fabric.pull      client side of a fabric transfer: a prefix pull
                   (LLMEngine._pull_remote_prefix, op "pull"), a disk
                   resume's claim (LLMEngine._resume_disk, op "disk")
                   and a peer take (LLMServer.adopt, op "take"); a pull
                   recomputes locally, a disk resume recomputes, a take
                   raises FabricError to the caller (ctx: addr, op)
  fabric.push      LLMEngine.fabric_handler, before serving any verb;
                   the peer gets a refusal and recomputes (ctx: verb)
  fabric.disk_io   DiskTier, before each block or ticket read / write;
                   a failed write leaves the KV where it was, a failed
                   read recomputes (ctx: op, key)
  fabric.handoff_  a handoff sender thread, before each frame: the
  chunk            stream tears and the prefill side decodes locally
                   (ctx: addr, sid, seq)
  handoff.adopt    LLMServer.adopt of a staged handoff ticket: raises
                   to the caller, who replays the prompt (ctx: sid,
                   name)
  router.crash     HARouter's HA loop, every `crash_poll_s`; a raise
                   is the primary's SIGKILL-equivalent (`HARouter.crash`:
                   the leader lease is left to expire) (ctx: job, epoch)
  journal.tail     JournalTailer, before applying each stream frame; a
                   raise drops the connection and the reconnect resyncs
                   the shadow from a fresh snapshot (ctx: job, kind)
  metrics.ship     a ProcessFleet child's series pusher, before each
                   push; a raise drops that push only (ctx: name)
  store.rpc        TCPStore client, before each RPC attempt; a
                   ConnectionError (`InjectedConnectionError`) is a
                   dropped socket the client reconnects and retries
                   under the op's deadline (ctx: op, key, attempt)
  store.crash      TCPStore request handler, before each op is
                   applied; an injected fault is a SIGKILL of the
                   master: listener and every connection torn down
                   (`TCPStore.crash`), nothing applied (ctx: op, key)
  ===============  ====================================================

`truncate_file` and `corrupt_bytes` damage a file on disk the way a
crash mid-write or rotten media would (the store's WAL and snapshot
tests use them).
"""

from __future__ import annotations

import os
import random
import threading
import time

__all__ = ["InjectedFault", "InjectedConnectionError", "FaultInjector",
           "get_injector", "fire", "ENABLED", "truncate_file",
           "corrupt_bytes"]

#: the harness's master switch (see the module docstring)
ENABLED = False


class InjectedFault(RuntimeError):
    """An error raised on purpose by the fault harness."""


class InjectedConnectionError(ConnectionError, InjectedFault):
    """An injected fault the store treats as a dropped socket (a
    ConnectionError, so its recovery path cannot tell it from a real
    one)."""


class _Rule:
    __slots__ = ("site", "after", "times", "exc", "delay", "prob", "rng",
                 "callback", "fired", "seen")

    def __init__(self, site, after, times, exc, delay, prob, seed,
                 callback):
        self.site = site
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.exc = exc
        self.delay = float(delay)
        self.prob = float(prob)
        self.rng = random.Random(seed)
        self.callback = callback
        self.fired = 0       # calls that actually tripped
        self.seen = 0        # calls at this site since installation

    def trips(self):
        """Count one call at the site; True when this call trips."""
        self.seen += 1
        if self.seen <= self.after or (self.times is not None
                                       and self.fired >= self.times):
            return False
        if self.prob < 1.0 and self.rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


class FaultInjector:
    """Process-global rule table the `fire()` sites consult."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: list[_Rule] = []

    def inject(self, site, *, times=1, after=0, exc=InjectedFault,
               delay=0.0, prob=1.0, seed=0, callback=None):
        """Arm one rule: the ``after+1``-th .. ``after+times``-th calls
        at `site` trip it (each with probability `prob`).  A trip
        sleeps `delay`, runs ``callback(ctx)`` (an exception instance
        or class it returns is raised), then raises `exc`; ``exc=None``
        raises nothing.  Returns the rule (``rule.fired`` counts
        trips)."""
        rule = _Rule(site, after, times, exc, delay, prob, seed, callback)
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
        """Consult the rule table for `site`; the first rule that trips
        acts (sleep, callback, raise).  Outside the lock: a wedged site
        must not block other sites."""
        with self._lock:
            tripped = next((r for r in self._rules
                            if r.site == site and r.trips()), None)
        if tripped is None:
            return
        if tripped.delay > 0:
            time.sleep(tripped.delay)
        exc = tripped.exc
        if tripped.callback is not None:
            out = tripped.callback(ctx)
            if isinstance(out, BaseException) or (
                    isinstance(out, type)
                    and issubclass(out, BaseException)):
                exc = out
        if exc is not None:
            if isinstance(exc, type):
                exc = exc(f"injected fault at {site} "
                          f"(trip {tripped.fired})")
            raise exc


_INJECTOR = FaultInjector()


def get_injector() -> FaultInjector:
    return _INJECTOR


def fire(site, **ctx):
    """Hot-path entry: a no-op while no rule is armed or the harness is
    switched off (`ENABLED`)."""
    if not _INJECTOR._rules or not ENABLED:
        return
    _INJECTOR.fire(site, **ctx)


def truncate_file(path, keep_bytes=None, frac=0.5):
    """Tear a file the way a crash mid-write would: keep only the first
    `keep_bytes` (default `frac` of the current size).  Returns the new
    size."""
    size = os.path.getsize(path)
    keep = int(size * frac) if keep_bytes is None else int(keep_bytes)
    keep = max(0, min(keep, size))
    with open(path, "r+b") as f:
        f.truncate(keep)
        f.flush()
        os.fsync(f.fileno())
    return keep


def corrupt_bytes(path, n=1, offset=None, seed=0):
    """Corrupt a file silently, as rotten media would: XOR `n` bytes at
    seeded positions (or from `offset` on) with a non-zero mask, the
    size unchanged, so only a checksum can tell.  Returns the corrupted
    offsets."""
    size = os.path.getsize(path)
    if size == 0:
        return []
    rng = random.Random(seed)
    n = max(1, min(int(n), size))
    if offset is None:
        offs = sorted(rng.sample(range(size), n))
    else:
        offs = [min(int(offset) + i, size - 1) for i in range(n)]
    with open(path, "r+b") as f:
        for off in offs:
            f.seek(off)
            b = f.read(1)[0]
            f.seek(off)
            f.write(bytes([b ^ rng.randrange(1, 256)]))
        f.flush()
        os.fsync(f.fileno())
    return offs
