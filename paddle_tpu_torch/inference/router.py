"""Serving fleet control plane: a front-door router over N replicas
with prefix-affinity balancing, crash failover, and zero-lost-request
recovery — the port of the JAX package's `inference/router.py`, host
only: its names, constants, metric names and help text, fault sites
and journal records are the JAX module's, so a journal written by
either package's router replays in the other's (`RoutingJournal`).
The router makes no CUDA call: it runs on host threads, its callbacks
run on the replicas' callback threads, and its journal writes host
bytes.

The contract, in one sentence: once `Router.submit()` accepts a
request, the client receives its complete token stream exactly once —
bitwise identical to what a single healthy engine would have produced —
no matter which replicas crash along the way.

How the pieces deliver that:

  * **bounded tier-weighted fair queue** (`_FairQueue`) — admission is
    bounded (`QueueFull` load shedding, *before* the contract
    attaches) and doubly fair: lanes are (SLO tier, client), pops
    follow a weighted tier rotation (interactive:standard:batch =
    4:2:1 by default — batch never starves, but can never occupy more
    than its share ahead of interactive), and within a tier it is FIFO
    per client, round-robin across clients, so one chatty client
    cannot starve the rest.  Failover resubmissions re-enter at the
    FRONT of their lane and bypass the bound — an accepted request is
    never shed.  Deadline-expired requests are shed at dispatch time,
    BEFORE consuming a prefill chunk on a replica.
  * **durable routing journal** (`RoutingJournal`) — an append-only
    JSONL log of accept/route/tok/done events.  A successor router
    replays it (`Router.resubmit_incomplete`) to resubmit every
    accepted-but-unfinished request with the tokens already delivered
    pre-seeded for dedupe, so even a *router* crash loses nothing.
  * **prefix-affinity dispatch** (`PrefixShadow`) — a host-side,
    block-granularity shadow of each replica's radix prefix cache picks
    the replica holding the longest shared prefix of the prompt;
    misses fall back to least-loaded (router-tracked in-flight count
    plus the queue depth last scraped from /healthz).
  * **crash failover** — a replica is declared dead on an injected
    fault, an `EngineUnhealthy` completion, a failed health poll, or
    lease expiry.  The router fences the dead lease's generation in
    the store (a wedged heartbeat can never resurrect it), cancels and
    detaches every request the replica owned, and resubmits each to a
    healthy replica with full prompt replay.  Replayed tokens the
    client already holds are deduped by position — correct because a
    request's stream depends only on its own seed and knobs, never on
    co-batched neighbors or slot (pinned by the engine's per-slot
    determinism tests), so the replay regenerates the identical stream.
    A stale attempt's late callbacks are ignored via epoch fencing:
    the per-request epoch is bumped at every dispatch AND at detach
    time, so even a falsely-declared-dead replica (health blip, lease
    expiry on a merely-slow heartbeat) whose cancelled attempt later
    completes *cleanly* can neither truncate nor extend the stream.
  * **graceful drain** (`Router.drain`) — stop routing to a replica,
    let `LLMServer.shutdown(drain=True)` finish its in-flight work,
    release the lease, detach: scale-down without failover.
  * **autoscale hook** — each health poll folds queue depth, replica
    occupancy, and TTFT p50 into a signal; `AutoscalePolicy` turns it
    into +1/0/-1 and the `autoscale=` callback acts on it (e.g.
    `LocalFleet.spawn` + `Router.add_replica`).
  * **KV fabric hooks** — dispatch attaches a stable
    `session_id` (the router rid) plus a cross-replica pull hint when
    another live replica's shadow holds a longer prefix than the
    chosen target (the target's engine pulls those blocks instead of
    recomputing them); failover prefers ADOPTING the dead replica's
    session tickets from the shared disk tier over prompt replay
    (`migrations_total` vs `requests_replayed_total`); `drain()`
    live-migrates parked sessions to survivors by peer take.  A dead
    replica's prefix shadow is dropped with it — a stale shadow would
    keep winning affinity picks and emitting pull hints at a corpse.
  * **disaggregated pools** — replicas advertise a
    `pool_role` ("prefill" | "decode" | "mixed"); once both specialist
    pools have live members, placement goes two-phase: fresh prompts
    land on the prefill pool (still ranked by prefix affinity), each
    prefill dispatch nominates the least-loaded decode replica as its
    chunk-stream handoff target, and when the prefill retires as a
    handoff the staged ticket is adopted there (`handoffs_total`).  A
    torn handoff falls back to prompt replay placed on the decode
    pool; an empty pool falls back to mixed placement — the
    specialisation never strands a request.

Fault sites (`paddle_tpu_torch.testing.faults`): `router.admit` fires
inside `submit()` before the bound check (force admission failures);
`router.dispatch` fires before every dispatch; `replica.crash` and
`replica.poison` fire in the replica driver loop (see
`serving.LLMServer._serve`).
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from ..distributed.store import StoreError
from ..observability.metrics import MetricsRegistry
from ..observability.slo import SLOTier
from ..observability.alerts import AlertManager, default_burn_rules
from ..observability.fleet_series import FleetMetricsAggregator
from ..observability import tracing as _tr
from ..testing import faults as _faults
from .engine import (DeadlineExceeded, EngineUnhealthy, Overloaded,
                     PoisonedRequest, QueueFull, ResultTimeout)
from .fleet_serving import (fence_replica, live_replicas,
                            set_replica_status)

__all__ = ["Router", "RouterRequest", "RoutingJournal", "PrefixShadow",
           "AutoscalePolicy"]

_ROUTER_RIDS = itertools.count()

# consecutive dispatch failures (connection errors at submit time)
# before the target replica is declared dead rather than retried
_DISPATCH_FAIL_FENCE = 3

# disaggregated serving: how much busier (inflight + queue)
# than the lightest prefill-pool member a decode replica may be and
# still attract a fresh prompt whose prefix majority-lives in its
# cache.  Deep enough that an agentic fan-out burst keeps landing on
# the replica holding its shared context instead of re-prefilling it
# through the prefill pool and paying one KV handoff per sibling
_LOCALITY_SLACK = 12


class RoutingJournal:
    """Durable routing journal: one JSONL record per event, flushed per
    write (fsync optional).  Events: ``accept`` (prompt + sampling
    params), ``route`` (rid -> replica attempt), ``tok`` (one token
    delivered to the client), ``done``/``failed`` (terminal), and
    ``failover`` (informational).  `incomplete()` reconstructs every
    accepted-but-unfinished request with its delivered-token prefix —
    the recovery unit for both replica failover (in-process) and
    router restart (cross-process)."""

    def __init__(self, path, fsync=False, compact_bytes=None):
        self.path = str(path)
        self._f = open(self.path, "a", encoding="utf-8")
        self._fsync = bool(fsync)
        # long-lived routers: once the file crosses
        # this size, completed requests are compacted away in place
        self._compact_bytes = (None if compact_bytes is None
                               else int(compact_bytes))
        self._lock = threading.Lock()
        self.compactions = 0
        # hot-standby streaming: subscribers observe every
        # appended line (and full-file resets after a compaction) in
        # write order — the feed a JournalStreamServer fans out
        self._subscribers = []
        # bytes appended since the last compaction, seeded with the
        # pre-existing file size so a reopened oversized journal
        # compacts on its first record.  The trigger runs on this
        # delta, not the absolute file size: once the live
        # (incomplete-request) state alone exceeds the threshold, a
        # size-based trigger would re-fire the full replay + rewrite +
        # fsync on EVERY record — O(n^2) I/O on the routing hot path —
        # whereas the delta re-arms only after another compact_bytes
        # of appends.
        self._since_compact = os.path.getsize(self.path)

    def record(self, ev, rid, **fields):
        line = json.dumps({"ev": ev, "rid": rid, **fields},
                          sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
            self._notify_locked("line", line)
            self._since_compact += len(line) + 1
            if (self._compact_bytes is not None
                    and self._since_compact >= self._compact_bytes):
                self._compact_locked()

    def subscribe(self, fn):
        """Register a streaming subscriber: ``fn("line", jsonl_line)``
        per appended record, ``fn("reset", full_file_text)`` after a
        compaction rewrote the file.  Called under the journal lock (so
        the feed order equals the write order) — subscribers must be
        quick and must not raise."""
        with self._lock:
            self._subscribers.append(fn)

    def unsubscribe(self, fn):
        with self._lock:
            try:
                self._subscribers.remove(fn)
            except ValueError:
                pass

    def subscribe_with_snapshot(self, fn) -> str:
        """Atomically read the current journal text AND register `fn`:
        the returned snapshot plus the subsequent "line" events form a
        gapless, duplicate-free feed (reading then subscribing would
        drop the lines appended between; subscribing then reading
        would duplicate them — either corrupts a standby's
        delivered-token prefixes on replay)."""
        with self._lock:
            self._f.flush()
            try:
                with open(self.path, encoding="utf-8") as f:
                    snap = f.read()
            except OSError:
                snap = ""
            self._subscribers.append(fn)
            return snap

    def _notify_locked(self, kind, data):
        for fn in self._subscribers:
            try:
                fn(kind, data)
            except Exception:   # noqa: BLE001 — a sick subscriber
                pass            # must not poison the routing hot path

    def compact(self):
        """Rewrite the journal dropping every completed request; the
        replay of the compacted file reconstructs exactly the
        `incomplete()` map of the original (parity pinned by test)."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self):
        """Keep only accepted-but-unfinished requests, as normalized
        records (accept, route, one tok per delivered token — replay
        order equals delivery order).  Crash-safe: tmp file + fsync +
        atomic rename; a crash mid-compaction leaves the original
        journal untouched."""
        live = {rid: st for rid, st in self.replay(self.path).items()
                if not st["done"]}
        tmp = self.path + ".compact.tmp"
        with open(tmp, "w", encoding="utf-8") as out:
            for rid, st in live.items():
                tid = st["params"].get("trace_id")
                out.write(json.dumps(
                    {"ev": "accept", "rid": rid, "prompt": st["prompt"],
                     "max_new_tokens": st["max_new_tokens"],
                     "params": st["params"], "client": st["client"],
                     "trace_id": tid},
                    sort_keys=True) + "\n")
                if st["replica"] is not None:
                    out.write(json.dumps(
                        {"ev": "route", "rid": rid,
                         "replica": st["replica"], "trace_id": tid},
                        sort_keys=True) + "\n")
                for t in st["delivered"]:
                    out.write(json.dumps(
                        {"ev": "tok", "rid": rid, "t": t,
                         "trace_id": tid},
                        sort_keys=True) + "\n")
            out.flush()
            os.fsync(out.fileno())
        old = self._f
        os.replace(tmp, self.path)
        old.close()
        self._f = open(self.path, "a", encoding="utf-8")
        self._since_compact = 0
        self.compactions += 1
        if self._subscribers:
            with open(self.path, encoding="utf-8") as f:
                self._notify_locked("reset", f.read())

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()

    @staticmethod
    def replay(path) -> dict:
        """Parse a journal into {rid: state}.  A torn final line (the
        crash contract of an append-only log) ends the replay cleanly
        rather than raising."""
        out = {}
        try:
            f = open(path, encoding="utf-8")
        except OSError:
            return out
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break                      # torn tail
                rid, ev = rec["rid"], rec["ev"]
                if ev == "accept":
                    out[rid] = {"prompt": rec["prompt"],
                                "max_new_tokens": rec["max_new_tokens"],
                                "params": rec.get("params", {}),
                                "client": rec.get("client", ""),
                                "delivered": [], "replica": None,
                                "done": False, "error": None}
                    continue
                st = out.get(rid)
                if st is None:
                    continue
                if ev == "route":
                    st["replica"] = rec["replica"]
                elif ev == "tok":
                    st["delivered"].append(rec["t"])
                elif ev in ("done", "failed"):
                    st["done"] = True
                    if ev == "failed":
                        st["error"] = rec.get("error") or "RuntimeError"
        return out

    @staticmethod
    def incomplete(path) -> dict:
        return {rid: st for rid, st in RoutingJournal.replay(path).items()
                if not st["done"]}


class PrefixShadow:
    """Host-side shadow of one replica's radix prefix cache at block
    granularity: answers "how many leading prompt tokens does this
    replica likely hold?" with zero RPCs.  Approximate by design — the
    replica evicts LRU leaves under pool pressure, the shadow evicts
    LRU block entries at the same capacity — and a stale entry costs
    one prefill, never correctness."""

    def __init__(self, block_tokens, max_blocks):
        self.block_tokens = int(block_tokens)
        self.max_blocks = int(max_blocks)
        self._blocks = OrderedDict()     # block-prefix bytes -> True

    def _key(self, toks, n_blocks):
        return toks[:n_blocks * self.block_tokens].tobytes()

    def observe(self, prompt):
        """Record a dispatched prompt's full blocks as (about to be)
        cached on the replica."""
        if self.block_tokens <= 0:
            return
        toks = np.asarray(prompt, np.int32).reshape(-1)
        for j in range(1, toks.size // self.block_tokens + 1):
            key = self._key(toks, j)
            if key in self._blocks:
                self._blocks.move_to_end(key)
            else:
                self._blocks[key] = True
                while len(self._blocks) > self.max_blocks:
                    self._blocks.popitem(last=False)

    def match_tokens(self, prompt) -> int:
        """Longest shadowed prefix of `prompt` in tokens — whole blocks
        only, capped below the prompt length (at least one row must
        prefill), mirroring the real cache's match rule."""
        if self.block_tokens <= 0:
            return 0
        toks = np.asarray(prompt, np.int32).reshape(-1)
        matched = 0
        for j in range(1, (toks.size - 1) // self.block_tokens + 1):
            key = self._key(toks, j)
            if key not in self._blocks:
                break
            self._blocks.move_to_end(key)
            matched = j * self.block_tokens
        return matched

    def clear(self):
        """Drop every shadowed block (the owning replica died: its
        cache died with it, and a stale shadow would keep attracting
        affinity traffic and pull hints to prompts nobody holds)."""
        self._blocks.clear()

    def __len__(self):
        return len(self._blocks)


#: Default weighted tier rotation: of every 7 consecutive pops with all
#: tiers backlogged, interactive gets 4, standard 2, batch 1.
_DEFAULT_TIER_WEIGHTS = {SLOTier.INTERACTIVE: 4, SLOTier.STANDARD: 2,
                         SLOTier.BATCH: 1}


class _FairQueue:
    """Bounded tier-weighted fair queue.

    Two-level fairness: lanes are (SLO tier, client).  `pop` walks a
    weighted tier rotation — tiers with no queued work donate their
    turn, so batch drains whenever it alone has work (never starves)
    but can never take more than its weighted share while interactive
    is backlogged, and interactive can never sit behind a batch burst.
    Within a tier: FIFO per client, round-robin across clients.
    Single-tier streams behave exactly like the pre-tier queue.

    `push(force=True)` and `push_front` bypass the bound (failover
    resubmissions of already-accepted requests must never be shed)."""

    def __init__(self, max_queue=None, tier_weights=None):
        self.max_queue = max_queue
        w = dict(_DEFAULT_TIER_WEIGHTS)
        if tier_weights:
            for t, n in tier_weights.items():
                w[SLOTier.check(t)] = int(n)
        # highest-protection tiers lead the rotation
        self._schedule = []
        for tier in SLOTier.ALL:
            self._schedule += [tier] * max(1, w.get(tier, 1))
        self._cursor = 0
        self._lanes = {t: OrderedDict() for t in SLOTier.ALL}
        self._depth = {t: 0 for t in SLOTier.ALL}
        self._n = 0
        self._cond = threading.Condition()

    @staticmethod
    def _tier_of(item):
        return SLOTier.check(getattr(item, "tier", None))

    def _push_locked(self, item, client, front=False):
        tier = self._tier_of(item)
        lanes = self._lanes[tier]
        lane = lanes.setdefault(client, deque())
        if front:
            lane.appendleft(item)
            lanes.move_to_end(client, last=False)
        else:
            lane.append(item)
        self._depth[tier] += 1
        self._n += 1
        self._cond.notify()

    def push(self, item, client="", force=False):
        with self._cond:
            if (not force and self.max_queue is not None
                    and self._n >= self.max_queue):
                raise QueueFull(
                    f"router admission queue at capacity "
                    f"({self.max_queue}); request rejected")
            self._push_locked(item, client)

    def push_front(self, item, client=""):
        """Resubmission path: head of the client's lane, lane moved to
        the head of its tier's rotation — replayed work goes out first
        (within its tier; the tier rotation still applies)."""
        with self._cond:
            self._push_locked(item, client, front=True)

    def pop(self, timeout=None):
        with self._cond:
            if not self._cond.wait_for(lambda: self._n > 0, timeout):
                return None
            S = len(self._schedule)
            for i in range(S):
                tier = self._schedule[(self._cursor + i) % S]
                lanes = self._lanes[tier]
                if not lanes:
                    continue        # empty tier donates its turn
                self._cursor = (self._cursor + i + 1) % S
                client, lane = next(iter(lanes.items()))
                item = lane.popleft()
                self._depth[tier] -= 1
                self._n -= 1
                if lane:
                    lanes.move_to_end(client)   # rotate within the tier
                else:
                    del lanes[client]
                return item
            return None             # unreachable while _n > 0

    def depths(self) -> dict:
        """Per-tier queued counts (the tier_queue_depth gauge feed)."""
        with self._cond:
            return dict(self._depth)

    def wake(self):
        with self._cond:
            self._cond.notify_all()

    def __len__(self):
        return self._n


class RouterRequest:
    """Client-facing handle for one routed request.  `tokens` is the
    exactly-once delivered stream (failover replays are deduped before
    reaching it or the `on_token` callback); `attempts` counts
    dispatches (1 = never failed over); `replica` names the current
    owner.  Note a failover re-baselines a relative `deadline=` — the
    replay restarts the request's clock on the new replica."""

    def __init__(self, prompt, max_new_tokens, client="", on_token=None,
                 on_done=None, **params):
        self.rid = f"rr{next(_ROUTER_RIDS)}"
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.client = client
        # SLO tier: normalised INTO params so it survives
        # the journal (replays keep their tier) and flows to the
        # replica engine's Request via `replica.submit(**params)`
        if params.get("tier") is not None:
            params["tier"] = SLOTier.check(params["tier"])
        self.tier = params.get("tier", SLOTier.STANDARD)
        # distributed tracing: minted here (or inherited
        # from a predecessor router via the journal) and carried
        # INSIDE params — the tier trick — so it survives the journal
        # round-trip and reaches the replica engine's Request via
        # `replica.submit(**params)`, stitching router-side and
        # replica-side spans into one timeline
        if not params.get("trace_id"):
            params["trace_id"] = _tr.mint()
        self.trace_id = params["trace_id"]
        self.params = params
        # router-side deadline anchor (accept time): a request whose
        # total budget expires while QUEUED is shed at dispatch,
        # before it can consume a prefill chunk on a replica
        d = params.get("deadline")
        if d is not None and float(d) <= 0:
            raise ValueError("deadline must be positive seconds")
        self._deadline_t = (None if d is None
                            else time.monotonic() + float(d))
        self.on_token = on_token
        self.on_done = on_done
        self.tokens: list[int] = []
        self.done = False
        self.error: BaseException | None = None
        self.replica = None
        self.attempts = 0
        self._attempt_seen = 0      # tokens seen from the CURRENT attempt
        self._inner = None          # the current replica-side Request
        # disaggregated serving: name of the decode replica
        # nominated (per dispatch onto the prefill pool) to adopt this
        # request's chunk-streamed prefill handoff
        self._handoff_target = None
        # bumped at every dispatch AND every detach (failover), under
        # the router lock: callbacks carrying a stale epoch are dropped
        self._epoch = 0
        # poison containment: how many replica fence events
        # this request was in flight for, with their timeline — at
        # `poison_threshold` the router convicts instead of replaying
        self.poison_strikes = 0
        self.fence_events: list[dict] = []
        # spans append + journal write + on_token so delivery order is
        # preserved across a failover (old attempt mid-delivery cannot
        # be overtaken by the replay attempt)
        self._deliver_lock = threading.Lock()
        self._done_ev = threading.Event()

    def expired(self, now=None) -> bool:
        """True once the request's total deadline (anchored at router
        accept) has passed; False when no deadline was set."""
        if self._deadline_t is None:
            return False
        return (time.monotonic() if now is None else now) >= self._deadline_t

    def result(self, timeout=None):
        """Block until the routed request finishes; returns its token
        stream.  Raises `ResultTimeout` at the deadline and re-raises
        the request's typed error when it failed terminally."""
        if not self._done_ev.wait(timeout):
            raise ResultTimeout(
                f"routed request {self.rid} still running after "
                f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.tokens


class AutoscalePolicy:
    """Threshold policy over the router's telemetry: recommend +1 when
    the fleet is saturated (router or replica queues at/above
    `queue_high`, or TTFT p50 above `ttft_high_s`), -1 when it idles
    (mean occupancy below `occupancy_low` with empty queues and more
    than `min_replicas` live), 0 otherwise.

    Tier-aware: when the signal carries per-tier queue
    depths, a pure BATCH backlog is distinguished from "interactive
    SLO at risk" — batch tolerates waiting, so its backlog alone must
    be `batch_backlog_factor` times deeper before it buys a replica,
    while any urgent (non-batch) backlog at `queue_high` scales
    immediately."""

    def __init__(self, queue_high=8, ttft_high_s=None, occupancy_low=0.25,
                 min_replicas=1, max_replicas=None,
                 batch_backlog_factor=4):
        self.queue_high = queue_high
        self.ttft_high_s = ttft_high_s
        self.occupancy_low = occupancy_low
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.batch_backlog_factor = batch_backlog_factor

    def evaluate(self, sig) -> int:
        n = sig["replicas"]
        # parked (preempted) requests count as queue pressure: they are
        # admitted work the fleet's KV pools could not hold
        total_queue = (sig["queue_depth"] + sig["replica_queue_depth"]
                       + sig.get("preempted", 0))
        if n == 0:
            return +1
        tq = sig.get("tier_queue_depth")
        if tq:
            batch = int(tq.get(SLOTier.BATCH, 0))
            urgent = max(0, total_queue - batch)
        else:       # pre-tier signal: everything is urgent (old behavior)
            batch, urgent = 0, total_queue
        saturated = (
            urgent >= self.queue_high
            or batch >= self.queue_high * self.batch_backlog_factor
            or (self.ttft_high_s is not None
                and sig["ttft_p50_s"] > self.ttft_high_s))
        if saturated:
            if self.max_replicas is not None and n >= self.max_replicas:
                return 0
            return +1
        if (n > self.min_replicas and total_queue == 0
                and sig["occupancy"] < self.occupancy_low):
            return -1
        return 0


class _AdoptionAttempt:
    """A staged fabric takeover: `epoch` stays None until
    the attempt is promoted under the router lock — by the adopter's
    first callback or by `adopt()` returning, whichever runs first —
    at which point the previous attempt is fenced and the books move.
    A take that never promotes never disturbed anything."""

    __slots__ = ("epoch",)

    def __init__(self):
        self.epoch = None


class _ReplicaState:
    """Router-side bookkeeping for one replica."""

    __slots__ = ("replica", "shadow", "inflight", "owner_rids", "dead",
                 "draining", "quarantined", "dispatch_failures",
                 "last_health", "last_queue_depth", "pool_role",
                 "probing_rid")

    def __init__(self, replica, shadow):
        self.replica = replica
        self.shadow = shadow
        self.inflight = 0
        # poison probation: while a once-struck suspect is
        # in flight here, nothing else dispatches to this replica — a
        # second crash convicts the suspect without collateral strikes
        self.probing_rid = None
        self.owner_rids = set()
        self.dead = False
        self.draining = False
        # canary verdict: no new dispatch, but NOT dead —
        # in-flight work finishes or migrates, the lease is not fenced
        self.quarantined = False
        self.dispatch_failures = 0
        self.last_health = {}
        self.last_queue_depth = 0
        # disaggregated serving: which placement pool this
        # replica serves, refreshed from /healthz on every poll
        self.pool_role = str(getattr(replica, "pool_role", None)
                             or "mixed")


class Router:
    """Front door over a fleet of replicas.  See the module docstring
    for the delivery contract; the API surface:

      * `submit(prompt, max_new_tokens, client=..., on_token=...)`
        -> `RouterRequest` (raises `QueueFull` at the admission bound)
      * `result(req, timeout=)` / `RouterRequest.result(timeout=)`
      * `drain(name)` — graceful scale-down of one replica
      * `add_replica(replica)` — scale-up attach
      * `resubmit_incomplete(journal_path)` — router-restart recovery
      * `metrics()` / `metrics_text()` — routed/failover/resubmitted/
        drain counters, affinity hit rate, queue/live gauges

    `policy` picks the dispatch strategy: ``"affinity"`` (default;
    longest shadowed prefix, least-loaded fallback),
    ``"least_loaded"``, or ``"round_robin"`` (the A/B baseline)."""

    def __init__(self, replicas=(), store=None, job_id="fleet",
                 max_queue=None, journal_path=None, journal_fsync=False,
                 journal_compact_bytes=None, policy="affinity",
                 poll_interval=0.5, autoscale=None,
                 autoscale_policy=None, default_result_timeout=600.0,
                 tier_weights=None, alert_rules=None,
                 series_window_s=30.0, stale_after_s=None,
                 debug_port=None, debug_host="127.0.0.1",
                 poison_threshold=2):
        if policy not in ("affinity", "least_loaded", "round_robin"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.job_id = job_id
        self.policy = policy
        self.poll_interval = float(poll_interval)
        self.default_result_timeout = default_result_timeout
        self._store = store
        # blast-radius containment: fence events a request
        # may be in flight for before it is convicted as poison
        self.poison_threshold = int(poison_threshold)
        # router leadership epoch: set by the HA layer when
        # this router holds the `router_leader` lease; carried on every
        # dispatch so replicas reject deposed-primary traffic
        self.router_epoch = None
        # extra /debug/fleet sections (respawn breaker state, HA role)
        self._debug_sections = {}
        # fleet observability plane: the aggregator merges
        # every replica's pushed/pulled series; windowed queries over
        # it replace the point polls in autoscale_signal and feed the
        # burn-rate alert rules (None -> per-tier defaults; pass ()
        # to disable alerting)
        self.series_window_s = float(series_window_s)
        self._agg = FleetMetricsAggregator(
            stale_after_s=(stale_after_s if stale_after_s is not None
                           else max(10.0, 6.0 * float(poll_interval))))
        rules = default_burn_rules() if alert_rules is None \
            else list(alert_rules)
        self._alerts = AlertManager(rules, on_fire=self._on_alert_fire,
                                    on_resolve=self._on_alert_resolve)
        self._autoscale_cb = autoscale
        self._autoscale_policy = autoscale_policy or AutoscalePolicy()
        self._lock = threading.RLock()
        self._replicas: dict[str, _ReplicaState] = {}
        self._requests: dict[str, RouterRequest] = {}
        self._queue = _FairQueue(max_queue, tier_weights=tier_weights)
        self._admit_lock = threading.Lock()
        self._rr_cursor = 0
        self._closing = threading.Event()
        # disaggregated serving: phase-two adoptions run on
        # this small worker pool, NEVER on a replica's callback pump —
        # a synchronous adopt RPC there would serialize every
        # completion (and every TTFT-stamping on_token) from the
        # prefill replica behind the decode replica's engine loop
        self._ho_q: deque = deque()
        self._ho_cv = threading.Condition()
        self._ho_workers: list = []
        if journal_path is None:
            fd, journal_path = tempfile.mkstemp(
                prefix="router_journal_", suffix=".jsonl")
            os.close(fd)
        self._journal = RoutingJournal(journal_path, fsync=journal_fsync,
                                       compact_bytes=journal_compact_bytes)
        self.journal_path = self._journal.path

        m = MetricsRegistry(namespace="router")
        self._metrics = m
        self._m_accepted = m.counter("requests_accepted_total")
        self._m_rejected = m.counter("requests_rejected_total")
        self._m_routed = m.counter("requests_routed_total")
        self._m_completed = m.counter("requests_completed_total")
        self._m_failed = m.counter("requests_failed_total")
        self._m_failovers = m.counter("failovers_total")
        self._m_resubmitted = m.counter("requests_resubmitted_total")
        self._m_delivered = m.counter("tokens_delivered_total")
        self._m_deduped = m.counter("tokens_deduped_total")
        self._m_mismatch = m.counter("replay_mismatch_total")
        self._m_dispatch_errors = m.counter("dispatch_errors_total")
        self._m_drains = m.counter("replicas_drained_total")
        self._m_aff_hit = m.counter("affinity_hits_total")
        self._m_aff_miss = m.counter("affinity_misses_total")
        self._m_hit_rate = m.gauge("affinity_hit_rate")
        self._m_queue = m.gauge("queue_depth")
        self._m_live = m.gauge("replicas_live")
        # -- SLO tiers -----------------------------------------------------
        self._m_expired = m.counter(
            "requests_expired_total",
            help="deadline-expired requests shed at pop/dispatch time, "
                 "before consuming replica compute")
        shed = m.counter(
            "requests_shed_total",
            help="requests rejected by a replica's overload ladder "
                 "(typed Overloaded)", labelnames=("tier",))
        tq = m.gauge("tier_queue_depth",
                     help="router-queued requests per SLO tier",
                     labelnames=("tier",))
        self._m_shed = {t: shed.labels(tier=t) for t in SLOTier.ALL}
        self._m_tier_queue = {t: tq.labels(tier=t) for t in SLOTier.ALL}
        # -- KV fabric -----------------------------------------------------
        self._m_migrations = m.counter(
            "migrations_total",
            help="sessions moved between replicas by fabric ticket "
                 "adoption (failover or drain) — zero prompt replay")
        self._m_replayed = m.counter(
            "requests_replayed_total",
            help="failover resubmissions that fell back to full prompt "
                 "replay because no fabric ticket was adoptable")
        # -- disaggregated serving -----------------------------------------
        self._m_handoffs = m.counter(
            "handoffs_total",
            help="disaggregated prefill->decode handoffs completed by "
                 "staged-ticket adoption on the decode pool")
        self._m_prefill_pool_q = m.gauge(
            "prefill_pool_queue_depth",
            help="queued work across the prefill-specialist pool (its "
                 "autoscale signal scales on TTFT/queue pressure)")
        self._m_decode_pool_occ = m.gauge(
            "decode_pool_occupancy",
            help="mean slot occupancy across the decode-specialist "
                 "pool (its autoscale signal scales on ITL/occupancy)")
        # -- fleet immune system -------------------------------------------
        self._m_quarantines = m.counter(
            "quarantines_total",
            help="replicas pulled from dispatch after a canary "
                 "mismatch — drained and retired without fencing")
        self._m_watchdog = m.counter(
            "watchdog_failovers_total",
            help="replicas declared dead because their step watchdog "
                 "tripped (work pending, heartbeat stale) — a hung "
                 "process fails over in bounded time")
        # -- control-plane HA ----------------------------------------------
        self._m_poisoned = m.counter(
            "poisoned_total",
            help="requests convicted as poison (common factor in "
                 "poison_threshold fence events) and failed typed "
                 "instead of re-dispatched")
        # -- observability plane -------------------------------------------
        self._m_alerts_fired = m.counter(
            "alerts_fired_total",
            help="burn-rate alerts that fired (each one also triggers "
                 "a flight-recorder dump)")
        self._m_alerts_resolved = m.counter(
            "alerts_resolved_total",
            help="burn-rate alerts that resolved after hysteresis")

        for rep in replicas:
            self.add_replica(rep)
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()
        self._health_thread = threading.Thread(target=self._health_loop,
                                               daemon=True)
        self._health_thread.start()
        # observability thread: series ingestion + alert
        # evaluation are local work (pushed payloads are drained from
        # in-memory buffers, no replica round-trips), so they run on
        # their own cadence — a health probe blocking on a saturated
        # replica must never starve the alerting plane.
        self._obs_interval = min(poll_interval, 0.25)
        self._obs_thread = threading.Thread(target=self._obs_loop,
                                            daemon=True)
        self._obs_thread.start()
        # operator surface: /debug/fleet JSON endpoint
        # (debug_port=0 binds an ephemeral port; None = no server)
        self._debug_http = None
        self._debug_http_thread = None
        self.debug_address = None
        if debug_port is not None:
            self._start_debug_http(debug_host, int(debug_port))

    # -- fleet membership --------------------------------------------------

    def add_replica(self, replica):
        """Attach a replica (the scale-up hook's target).  Anything
        with `.name`/`.submit()`/`.health()`/`.server` works; a
        `fleet_serving.Replica` also carries its lease for fencing."""
        bt = getattr(replica, "block_tokens", 0)
        blocks = getattr(replica, "cache_blocks", 0)
        shadow = PrefixShadow(bt, blocks) if bt > 0 else None
        with self._lock:
            st = _ReplicaState(replica, shadow)
            self._replicas[replica.name] = st
        # pool-labeled aggregates: the fleet series plane
        # scopes its windowed queries by this tag
        self._agg.set_pool(replica.name, st.pool_role)
        self._update_live_gauge()

    def _set_queue_gauges(self):
        self._m_queue.set(len(self._queue))
        for t, n in self._queue.depths().items():
            self._m_tier_queue[t].set(n)

    def _update_live_gauge(self):
        with self._lock:
            self._m_live.set(sum(
                1 for st in self._replicas.values()
                if not st.dead and not st.draining
                and not st.quarantined))

    def live_replica_names(self):
        with self._lock:
            return sorted(name for name, st in self._replicas.items()
                          if not st.dead and not st.draining
                          and not st.quarantined)

    # -- admission ---------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=16, client="",
               on_token=None, on_done=None, **params):
        """Accept one request into the fair queue.  Acceptance is
        durable: the journal records it before submit() returns, and
        from then on the zero-lost contract applies."""
        if self._closing.is_set():
            raise RuntimeError("Router has been shut down")
        rr = RouterRequest(prompt_ids, max_new_tokens, client=client,
                           on_token=on_token, on_done=on_done, **params)
        # injectable admission failure (overload tests force shed-at-
        # the-door deterministically); fires BEFORE the journal write,
        # so a tripped admit leaves no accepted-request record behind
        _faults.fire("router.admit", rid=rr.rid, client=client,
                     tier=rr.tier)
        # bound check + journal + enqueue under one lock so the bound
        # is exact and nothing enters the queue unjournaled
        with self._admit_lock:
            if (self._queue.max_queue is not None
                    and len(self._queue) >= self._queue.max_queue):
                self._m_rejected.inc()
                raise QueueFull(
                    f"router admission queue at capacity "
                    f"({self._queue.max_queue}); request rejected")
            self._journal.record(
                "accept", rr.rid, prompt=[int(t) for t in rr.prompt],
                max_new_tokens=rr.max_new_tokens, client=client,
                params=rr.params, trace_id=rr.trace_id)
            with self._lock:
                self._requests[rr.rid] = rr
            self._queue.push(rr, client, force=True)
        self._m_accepted.inc()
        self._set_queue_gauges()
        _tr.point("router/submit", trace_id=rr.trace_id, rid=rr.rid,
                  tier=str(rr.tier))
        return rr

    def result(self, rr, timeout=None):
        """Block for `rr`; `timeout=None` uses the router default so no
        wait on this path is unbounded."""
        return rr.result(self.default_result_timeout
                         if timeout is None else timeout)

    def resubmit_incomplete(self, journal_path) -> dict:
        """Router-restart recovery: replay a predecessor's journal and
        resubmit every accepted-but-unfinished request, pre-seeding the
        tokens it already delivered so the replayed prefix is deduped —
        the client-facing stream continues exactly once.  Returns
        {old_rid: RouterRequest}."""
        out = {}
        for old_rid, st in sorted(RoutingJournal.incomplete(
                journal_path).items()):
            rr = RouterRequest(st["prompt"], st["max_new_tokens"],
                               client=st.get("client", ""),
                               **st["params"])
            rr.tokens = [int(t) for t in st["delivered"]]
            self._journal.record(
                "accept", rr.rid, prompt=[int(t) for t in rr.prompt],
                max_new_tokens=rr.max_new_tokens, client=rr.client,
                params=rr.params, trace_id=rr.trace_id)
            for t in rr.tokens:    # carry the delivered prefix forward
                self._journal.record("tok", rr.rid, t=int(t),
                                     trace_id=rr.trace_id)
            with self._lock:
                self._requests[rr.rid] = rr
            self._queue.push(rr, rr.client, force=True)
            self._m_accepted.inc()
            self._m_resubmitted.inc()
            out[old_rid] = rr
        self._set_queue_gauges()
        return out

    # -- dispatch ----------------------------------------------------------

    def _dispatch_loop(self):
        while not self._closing.is_set():
            rr = self._queue.pop(timeout=0.05)
            self._set_queue_gauges()
            if rr is None or rr.done:
                continue
            self._dispatch(rr)

    def _pool_candidates_locked(self, rr, cands):
        """Two-phase pool placement: once both specialist
        pools have live members, fresh prompts go to prefill+mixed
        replicas and requests that already hold delivered tokens
        (post-handoff replays, decode-side failovers) go to
        decode+mixed.  Either pool going empty falls back to every
        live replica — a drained pool degrades to mixed-mode
        placement, never an infinite queue.

        Prefix locality overrides specialisation: a fresh prompt whose
        KV mostly lives on a decode replica already — a session
        continuation whose earlier turn was handed off and adopted
        there — prefills where its blocks are.  Routing it through the
        prefill pool would make the prefill specialist pull those
        blocks over the fabric through a busy peer, then stream them
        straight back to the decode pool."""
        have_p = any(st.pool_role == "prefill" for st in cands)
        have_d = any(st.pool_role == "decode" for st in cands)
        if not (have_p and have_d):
            return cands            # colocated fleet: no pools active
        if rr.tokens:
            pool = [st for st in cands if st.pool_role != "prefill"]
        else:
            n = int(np.asarray(rr.prompt).reshape(-1).size)
            best, best_m = None, 0
            for st in cands:
                if st.pool_role == "decode" and st.shadow is not None:
                    m = st.shadow.match_tokens(rr.prompt)
                    if m > best_m:
                        best, best_m = st, m
            pool = [st for st in cands if st.pool_role != "decode"]
            if best is not None and 2 * best_m >= n and pool:
                # locality must not build an unbounded convoy, but a
                # majority-shadowed prompt's local prefill costs at
                # most the unshadowed suffix (a chunk or two) — far
                # less than prefilling remotely and shipping the whole
                # KV back — so the decode replica may be a fan-out
                # burst deep before routing through the prefill pool
                # wins again
                lightest = min(st.inflight + st.last_queue_depth
                               for st in pool)
                if (best.inflight + best.last_queue_depth
                        <= lightest + _LOCALITY_SLACK):
                    return [best]
        return pool or cands

    def _pick_replica(self, rr):
        with self._lock:
            cands = [st for st in self._replicas.values()
                     if not st.dead and not st.draining
                     and not st.quarantined
                     and (st.probing_rid is None
                          or st.probing_rid == rr.rid)]
            # (suspects — poison_strikes > 0 — need no extra filter
            # here: the probation filter above already guarantees at
            # most one suspect per replica, because dispatching a
            # suspect sets probing_rid and a suspect's first NEW token
            # clears it.  Innocent co-tenants of a second crash thus
            # collect at most one live strike at a time.)
            if not cands:
                return None
            cands = self._pool_candidates_locked(rr, cands)
            if self.policy == "round_robin":
                st = cands[self._rr_cursor % len(cands)]
                self._rr_cursor += 1
                return st
            if self.policy == "affinity":
                best, best_m = None, 0
                for st in cands:
                    m = (st.shadow.match_tokens(rr.prompt)
                         if st.shadow is not None else 0)
                    if m > best_m:
                        best, best_m = st, m
                if best is not None:
                    self._m_aff_hit.inc()
                    self._set_hit_rate()
                    return best
                self._m_aff_miss.inc()
                self._set_hit_rate()
            # least-loaded: router-tracked in-flight plus the replica's
            # last-polled queue depth; name tie-break for determinism
            return min(cands, key=lambda st: (
                st.inflight + st.last_queue_depth, st.replica.name))

    def _set_hit_rate(self):
        hits = self._m_aff_hit.snapshot()["series"][""]["value"]
        miss = self._m_aff_miss.snapshot()["series"][""]["value"]
        if hits + miss:
            self._m_hit_rate.set(hits / (hits + miss))

    def _dispatch(self, rr):
        if rr.expired():
            # dead on arrival: shed here instead of spending a prefill
            # chunk on a replica whose answer nobody is waiting for
            with self._lock:
                if rr.done:
                    return
                rr.error = DeadlineExceeded(
                    f"{rr.rid} deadline expired before dispatch")
                rr.done = True
            self._m_expired.inc()
            self._finish(rr)
            return
        st = self._pick_replica(rr)
        if st is None:
            # no healthy replica right now: park at the front and retry
            # (accepted work is never dropped; scale-up or shutdown
            # resolves the wait)
            self._queue.push_front(rr, rr.client)
            time.sleep(self.poll_interval / 4)
            return
        name = st.replica.name
        try:
            _faults.fire("router.dispatch", rid=rr.rid, replica=name)
        except BaseException as e:  # noqa: BLE001 — injected site
            self._on_dispatch_error(rr, st, e)
            return
        # pre-register the attempt BEFORE submit: the replica's driver
        # thread may fire callbacks before submit() even returns
        with self._lock:
            # the pick released the lock: a replica fenced, drained,
            # quarantined or taken by a suspect since then is re-picked
            # (registered on a corpse, the request would wait on it
            # forever or take a strike for a fence it never saw)
            gone = (st.dead or st.draining or st.quarantined
                    or st.probing_rid not in (None, rr.rid))
            if not gone:
                attempt = rr.attempts + 1
                rr.attempts = attempt
                rr._epoch += 1
                epoch = rr._epoch
                rr.replica = name
                rr._attempt_seen = 0
                st.inflight += 1
                st.owner_rids.add(rr.rid)
                if rr.poison_strikes > 0:
                    st.probing_rid = rr.rid
        if gone:
            self._queue.push_front(rr, rr.client)
            return
        kw = dict(rr.params)
        if self.router_epoch is not None:
            # leadership fencing: the replica keeps a high-water mark
            # and rejects dispatches below it (StaleRouterEpoch)
            kw["router_epoch"] = int(self.router_epoch)
        if getattr(st.replica, "fabric_address", None) is not None:
            # KV fabric: a stable session id makes a parked
            # session's ticket addressable fleet-wide; the pull hint
            # points the target at a peer holding a longer prefix
            kw.setdefault("session_id", rr.rid)
            hint = self._prefix_hint(rr, st)
            if hint is not None:
                kw["prefix_hint"] = hint
            # disaggregated serving: a dispatch onto the
            # prefill pool nominates its decode adopter NOW, so the
            # engine chunk-streams KV at it while later chunks still
            # compute; phase two (_complete_handoff) adopts the staged
            # ticket there once the prefill retires
            ho = self._pick_handoff_target(rr, st)
            if ho is not None:
                kw["handoff"] = {
                    "addr": list(ho.replica.fabric_address)}
        try:
            inner = st.replica.submit(
                rr.prompt, rr.max_new_tokens,
                on_token=self._mk_on_token(rr, epoch),
                on_done=self._mk_on_done(rr, epoch, st),
                **kw)
        except BaseException as e:  # noqa: BLE001
            with self._lock:
                # _fail_replica may have detached+requeued rr while
                # submit() was in flight; it already bumped the epoch
                # and reset the replica's books
                detached = rr._epoch != epoch
                if not detached:
                    rr._epoch += 1  # fence anything the failed submit leaked
                    rr.replica = None
                if not st.dead:
                    st.inflight -= 1
                    st.owner_rids.discard(rr.rid)
                if st.probing_rid == rr.rid:
                    st.probing_rid = None
            if detached:
                return
            if isinstance(e, QueueFull):
                # replica saturated, not sick: try again (elsewhere —
                # its queue depth now repels the least-loaded picker)
                st.last_queue_depth += 1
                self._queue.push_front(rr, rr.client)
                time.sleep(0.002)
                return
            if isinstance(e, Overloaded):
                # typed shed at the replica's door (ladder rung 4).
                # The rejection IS the contract: surface it to the
                # client instead of retrying into the same overload,
                # and don't count it against the replica's health —
                # an overloaded engine is busy, not sick.
                with self._lock:
                    rr.error = e
                    rr.done = True
                self._m_shed[rr.tier].inc()
                self._finish(rr)
                return
            self._on_dispatch_error(rr, st, e)
            return
        stale = None
        with self._lock:
            if rr._epoch == epoch:
                rr._inner = inner
            else:
                # fenced mid-submit: the request already belongs to a
                # newer attempt — orphan this one
                stale = inner
        if stale is not None:
            stale.cancel()          # free the zombie replica's slot
            return
        st.dispatch_failures = 0
        if st.shadow is not None:
            st.shadow.observe(rr.prompt)
        self._journal.record("route", rr.rid, replica=name,
                             attempt=attempt, trace_id=rr.trace_id)
        self._m_routed.inc()
        _tr.point("router/dispatch", trace_id=rr.trace_id, rid=rr.rid,
                  replica=name, attempt=attempt)

    def prefix_holders(self, prompt):
        """Fleet-wide ``holders(prefix)`` query: which live,
        non-draining replicas hold a shadowed prefix of `prompt`,
        ranked by shadowed length.  Returns ``[(name, (host, port),
        tokens)]`` — only replicas with a fabric endpoint count, since
        a holder nobody can pull from is not a holder."""
        with self._lock:
            return self._holders_locked(np.asarray(prompt))

    def _holders_locked(self, prompt):
        out = []
        for name, st in self._replicas.items():
            if st.dead or st.draining or st.shadow is None:
                continue
            addr = getattr(st.replica, "fabric_address", None)
            if addr is None:
                continue
            m = st.shadow.match_tokens(prompt)
            if m > 0:
                out.append((name, tuple(addr), int(m)))
        out.sort(key=lambda h: -h[2])
        return out

    def _prefix_hint(self, rr, target):
        """Cross-replica pull hint: when a DIFFERENT live
        replica's shadow holds a longer prefix of this prompt than the
        chosen target does, return ``{"addr": [host, port],
        "tokens": n}`` so the target's engine pulls those KV blocks
        over the fabric instead of recomputing them.  Approximate by
        construction — a stale hint costs one refused pull, never
        correctness."""
        with self._lock:
            base = (target.shadow.match_tokens(rr.prompt)
                    if target.shadow is not None else 0)
            holders = self._holders_locked(rr.prompt)
        tname = target.replica.name
        for name, addr, m in holders:
            if name != tname and m > base:
                return {"addr": list(addr), "tokens": m}
        return None

    def _pick_handoff_target(self, rr, st):
        """Least-loaded live decode replica to receive `rr`'s
        chunk-streamed KV handoff from prefill replica `st`.  None
        unless `st` really is a prefill specialist and a decode replica with a fabric endpoint is live — in which case
        the nomination is also recorded on the request so phase two
        knows where the staged ticket landed."""
        with self._lock:
            rr._handoff_target = None
            if st.pool_role != "prefill":
                return None
            cands = [d for d in self._replicas.values()
                     if d is not st and not d.dead and not d.draining
                     and not d.quarantined and d.pool_role == "decode"
                     and getattr(d.replica, "fabric_address", None)
                     is not None and hasattr(d.replica, "adopt")]
            if not cands:
                return None
            ho = min(cands, key=lambda d: (
                d.inflight + d.last_queue_depth, d.replica.name))
            rr._handoff_target = ho.replica.name
            # seed the adopter's shadow at NOMINATION, not adoption:
            # this prompt's KV is about to chunk-stream at `ho`, and a
            # fan-out sibling arriving before the adoption completes
            # must already see the shared prefix there to redirect —
            # observing late would route the whole burst through the
            # prefill pool and pay one adoption stall per sibling.  If
            # the handoff falls through the shadow over-claims one
            # prompt; the first redirected sibling's local prefill
            # makes the claim true (its blocks land in ho's cache)
            if ho.shadow is not None:
                ho.shadow.observe(rr.prompt)
            return ho

    def _on_dispatch_error(self, rr, st, exc):
        """A dispatch that failed before the replica accepted the
        request: requeue it (nothing to dedupe), and fence the replica
        only after `_DISPATCH_FAIL_FENCE` consecutive failures — one
        connection blip is a retry, not a funeral."""
        self._m_dispatch_errors.inc()
        st.dispatch_failures += 1
        if st.dispatch_failures >= _DISPATCH_FAIL_FENCE:
            self._fail_replica(st.replica.name, exc)
        self._queue.push_front(rr, rr.client)
        time.sleep(0.002)

    def _mk_on_token(self, rr, epoch):
        def cb(_inner, tok):
            self._deliver(rr, epoch, int(tok))
        return cb

    def _deliver(self, rr, epoch, tok):
        # the per-request delivery lock spans append + journal write +
        # client callback: without it an old attempt preempted between
        # append and journal can be overtaken by the replay attempt,
        # yielding out-of-order on_token calls and a misordered
        # journal prefix (which would corrupt resubmit_incomplete's
        # dedupe seed on router restart)
        with rr._deliver_lock:
            with self._lock:
                if rr.done or rr._epoch != epoch:
                    return          # stale attempt from a fenced replica
                i = rr._attempt_seen
                rr._attempt_seen += 1
                if i < len(rr.tokens):
                    # replayed position the client already holds: dedupe.
                    # Determinism (per-request seed only) guarantees the
                    # replay agrees bitwise; count any disagreement loudly
                    # instead of double-delivering
                    self._m_deduped.inc()
                    if rr.tokens[i] != tok:
                        self._m_mismatch.inc()
                    return
                rr.tokens.append(tok)
                first = len(rr.tokens) == 1
                if rr.poison_strikes:
                    # NEW-token progress on a live replica clears
                    # suspicion (an input that kills its replica does so
                    # before producing one) and releases the probation
                    # hold so normal co-batching resumes
                    rr.poison_strikes = 0
                    pst = (self._replicas.get(rr.replica)
                           if rr.replica else None)
                    if pst is not None and pst.probing_rid == rr.rid:
                        pst.probing_rid = None
            # journal + client callback outside the router lock (a slow
            # client must not stall dispatch or failover) but inside the
            # delivery lock (per-request order holds across attempts)
            self._m_delivered.inc()
            self._journal.record("tok", rr.rid, t=tok,
                                 trace_id=rr.trace_id)
            if first:
                _tr.point("router/first_token", trace_id=rr.trace_id,
                          rid=rr.rid)
            if rr.on_token is not None:
                rr.on_token(rr, tok)

    def _mk_on_done(self, rr, epoch, st):
        def cb(inner):
            self._on_attempt_done(rr, epoch, st, inner)
        return cb

    def _on_attempt_done(self, rr, epoch, st, inner):
        failover = False
        detached = None
        migrated = False
        ho_name = None
        handoff_to = None
        with self._lock:
            if rr.done or rr._epoch != epoch:
                return              # stale attempt from a fenced replica
            st.inflight -= 1
            st.owner_rids.discard(rr.rid)
            if st.probing_rid == rr.rid:
                st.probing_rid = None
            rr._inner = None
            if getattr(inner, "migrated", False):
                # not a completion: the session was taken over the
                # fabric (drain migration / peer take / disaggregated
                # prefill handoff).  Detach — the adopter's attempt
                # owns the stream now.  No epoch bump here: promotion
                # does that, and the books we just cleared are exactly
                # what promotion skips once rr.replica is None.
                migrated = True
                rr.replica = None
                ho_name, rr._handoff_target = rr._handoff_target, None
                if ho_name is not None:
                    # handoff: nothing is staged router-side
                    # yet — phase two adopts the ticket the prefill
                    # replica shipped at the nominated decode target
                    hst = self._replicas.get(ho_name)
                    if (hst is not None and not hst.dead
                            and not hst.draining and not hst.quarantined
                            and hasattr(hst.replica, "adopt")):
                        handoff_to = hst
            else:
                err = inner.error
                if (isinstance(err, EngineUnhealthy)
                        and not self._closing.is_set()):
                    # the replica died under this request; detach and
                    # let failover replay it elsewhere.  Detach ==
                    # fence: bump the epoch so any straggler callback
                    # from this attempt is dropped
                    rr.replica = None
                    rr._epoch += 1
                    # poison attribution: this request was in flight
                    # for the fence event.  Counted HERE because the
                    # discard above removed it from owner_rids — the
                    # _fail_replica victim sweep can no longer see it
                    # (and victims it DOES see get their strike there:
                    # exactly one per fence event either way)
                    rr.poison_strikes += 1
                    rr.fence_events.append(
                        {"replica": st.replica.name, "t": time.time(),
                         "cause": type(err).__name__})
                    failover = True
                    # mark the replica dead in this critical section:
                    # released first, the lock would let the dispatcher
                    # hand a waiting suspect to the corpse, and the
                    # fence would strike it for a crash it never saw
                    detached = self._detach_replica_locked(
                        st.replica.name, err)
                elif err is not None:
                    rr.error = err  # client-visible (deadline, ...)
                    rr.done = True
                    if isinstance(err, Overloaded):
                        self._m_shed[rr.tier].inc()
                else:
                    rr.done = True
        if migrated:
            if ho_name is not None:
                self._enqueue_handoff(rr, handoff_to, st.replica.name)
            return
        if failover:
            self._journal.record("failover", rr.rid,
                                 replica=st.replica.name,
                                 trace_id=rr.trace_id)
            _tr.point("router/failover", trace_id=rr.trace_id,
                      rid=rr.rid, replica=st.replica.name)
            # the replica is dead (marked above) before the request is
            # re-queued: the dispatcher cannot hand it straight back
            if detached is not None:
                self._requeue_victims(st.replica.name, err, *detached)
            if self._poison_check(rr):
                return          # convicted: failed typed, no replay
            if (rr.poison_strikes == 0
                    and self._try_adopt(rr, exclude=st.replica.name)):
                # a suspect skips adoption: only queue replay routes it
                # through the probation picker (alone on an idle replica)
                return          # session ticket adopted: no replay
            self._m_resubmitted.inc()
            self._m_replayed.inc()
            self._queue.push_front(rr, rr.client)
            return
        self._finish(rr)

    def _poison_check(self, rr) -> bool:
        """Convict `rr` once it has been in flight for
        `poison_threshold` fence events: fail it typed
        (`PoisonedRequest`), meter it, and dump a repro bundle via the
        flight recorder — it must never be re-dispatched.  Returns True
        when the request needs no further routing action."""
        if rr.poison_strikes < self.poison_threshold:
            return False
        with self._lock:
            if rr.done:
                return True
            rr.error = PoisonedRequest(
                f"{rr.rid} was in flight for {rr.poison_strikes} "
                f"replica fence events (threshold "
                f"{self.poison_threshold}); refusing to re-dispatch")
            rr.done = True
        self._m_poisoned.inc()
        # repro bundle: everything needed to replay the kill offline —
        # prompt, sampling params, and the fence timeline — alongside
        # the trace spans the recorder already holds
        _tr.flight_record(
            f"poison-{rr.rid}",
            extra={"rid": rr.rid,
                   "prompt": [int(t) for t in rr.prompt],
                   "max_new_tokens": int(rr.max_new_tokens),
                   "params": {k: v for k, v in rr.params.items()
                              if isinstance(v, (str, int, float, bool,
                                                type(None)))},
                   "strikes": int(rr.poison_strikes),
                   "fence_events": list(rr.fence_events)})
        self._finish(rr)
        return True

    def _finish(self, rr):
        if rr.error is not None:
            self._m_failed.inc()
            self._journal.record("failed", rr.rid,
                                 error=type(rr.error).__name__,
                                 trace_id=rr.trace_id)
            _tr.point("router/done", trace_id=rr.trace_id, rid=rr.rid,
                      error=type(rr.error).__name__)
        else:
            self._m_completed.inc()
            self._journal.record("done", rr.rid, n=len(rr.tokens),
                                 trace_id=rr.trace_id)
            _tr.point("router/done", trace_id=rr.trace_id, rid=rr.rid,
                      n=len(rr.tokens))
        with self._lock:
            self._requests.pop(rr.rid, None)
        if rr.on_done is not None:
            rr.on_done(rr)
        rr._done_ev.set()

    # -- fabric adoption ---------------------------------------------------

    def _enqueue_handoff(self, rr, hst, src_name):
        """Queue phase two of a disaggregated dispatch for the handoff
        workers (started lazily — a fleet that never hands off never
        pays for the threads)."""
        with self._ho_cv:
            if not self._ho_workers:
                for i in range(4):
                    t = threading.Thread(target=self._handoff_loop,
                                         daemon=True,
                                         name=f"handoff-adopt-{i}")
                    t.start()
                    self._ho_workers.append(t)
            self._ho_q.append((rr, hst, src_name))
            self._ho_cv.notify()

    def _handoff_loop(self):
        while True:
            with self._ho_cv:
                while not self._ho_q:
                    if self._closing.is_set():
                        return
                    self._ho_cv.wait(timeout=0.5)
                item = self._ho_q.popleft()
            try:
                self._complete_handoff(*item)
            except BaseException:   # noqa: BLE001 — worker must survive
                pass

    def _complete_handoff(self, rr, hst, src_name):
        """Phase two of a disaggregated dispatch: the
        prefill replica retired `rr` as a chunk-streamed handoff, so
        adopt the staged ticket on the nominated decode replica.  Any
        failure — target dead, ticket GC'd or torn, an injected
        ``handoff.adopt`` fault — falls back to prompt replay, which
        the pool-aware picker places on the decode pool (the request
        already holds its first token); positional dedupe keeps the
        client stream seamless and bitwise either way."""
        if hst is not None:
            _tr.point("router/handoff", trace_id=rr.trace_id,
                      rid=rr.rid, src=src_name, dst=hst.replica.name)
            if self._adopt_on(rr, hst, {"kind": "handoff",
                                        "session_id": rr.rid,
                                        "trace_id": rr.trace_id}):
                self._m_handoffs.inc()
                return
        with self._lock:
            if rr.done:
                return
        self._journal.record("failover", rr.rid, replica=src_name,
                             trace_id=rr.trace_id)
        self._m_resubmitted.inc()
        self._m_replayed.inc()
        self._queue.push_front(rr, rr.client)
        self._set_queue_gauges()

    def _promote_locked(self, rr, st, att):
        """Commit a staged adoption attempt (caller holds the router
        lock): move `rr`'s books from its previous owner to `st`, bump
        the epoch (fencing the previous attempt), and assign the
        attempt its epoch.  Idempotent — the FIRST adopter callback or
        `_adopt_on`'s return, whichever runs first, commits.  Returns
        the attempt's epoch, or None when `rr` finished first."""
        if att.epoch is not None:
            return att.epoch
        if rr.done:
            return None
        old = self._replicas.get(rr.replica) if rr.replica else None
        if old is not None and old is not st:
            old.owner_rids.discard(rr.rid)
            old.inflight = max(0, old.inflight - 1)
        rr._epoch += 1
        att.epoch = rr._epoch
        rr.replica = st.replica.name
        rr.attempts += 1
        rr._attempt_seen = 0
        st.inflight += 1
        st.owner_rids.add(rr.rid)
        return att.epoch

    def _mk_adopt_cbs(self, rr, st, att):
        def on_token(_inner, tok):
            with self._lock:
                epoch = self._promote_locked(rr, st, att)
            if epoch is not None:
                self._deliver(rr, epoch, int(tok))

        def on_done(inner):
            with self._lock:
                epoch = self._promote_locked(rr, st, att)
            if epoch is not None:
                self._on_attempt_done(rr, epoch, st, inner)

        return on_token, on_done

    def _adopt_on(self, rr, st, source) -> bool:
        """Adopt `rr`'s session onto replica `st` from `source` (a
        disk-tier claim or a peer take).  The attempt is STAGED, not
        pre-registered: nothing on `rr` changes until the adoption
        demonstrably took effect — the first adopter callback (the
        adopter replays the delivered tokens, which the position
        dedupe absorbs) or `adopt()` returning — so a refused take
        leaves a still-live source attempt completely untouched.
        Returns True when `rr` needs no further action (adopted, or
        finished/fenced meanwhile); False → the caller decides between
        prompt replay and leaving it where it is."""
        att = _AdoptionAttempt()
        on_token, on_done = self._mk_adopt_cbs(rr, st, att)
        try:
            inner = st.replica.adopt(source, on_token=on_token,
                                     on_done=on_done)
        except BaseException:  # noqa: BLE001 — no ticket / fabric error
            with self._lock:
                promoted = att.epoch is not None
            # promoted despite the error (e.g. an executor timeout
            # after the engine adopted): the attempt IS live — its
            # callbacks deliver; treat as handled
            return promoted
        with self._lock:
            epoch = self._promote_locked(rr, st, att)
            current = epoch is not None and rr._epoch == epoch
            if current:
                rr._inner = inner
        if not current:
            if inner is not None:
                inner.cancel()      # rr finished/re-fenced meanwhile
            return True
        if st.shadow is not None:
            st.shadow.observe(rr.prompt)
        self._m_migrations.inc()
        self._journal.record("migrate", rr.rid, replica=st.replica.name,
                             attempt=rr.attempts, trace_id=rr.trace_id)
        self._m_routed.inc()
        return True

    def _try_adopt(self, rr, exclude=None) -> bool:
        """Failover path: try to continue `rr`'s session from its
        ticket on the shared disk tier — a survivor adopts it and the
        stream resumes mid-decode, zero prompt replay.  False → the
        caller falls back to full prompt replay (the pre-fabric
        contract, still exactly-once)."""
        with self._lock:
            cands = [st for name, st in sorted(self._replicas.items())
                     if name != exclude and not st.dead
                     and not st.draining and not st.quarantined
                     and getattr(st.replica, "fabric_address", None)
                     is not None and hasattr(st.replica, "adopt")]
        source = {"kind": "disk", "session_id": rr.rid,
                  "trace_id": rr.trace_id}
        for st in cands:
            if self._adopt_on(rr, st, source):
                return True
        return False

    def _migrate_parked(self, src, src_addr):
        """Drain path: peer-take every session `src` still owns onto
        the surviving replicas.  Only PARKED sessions hand over (an
        active one refuses the take and simply finishes its drain on
        `src`); a hand-off that fell apart mid-flight leaves the
        request detached, which we convert to a prompt replay."""
        with self._lock:
            rids = sorted(src.owner_rids)
            targets = [st for name, st in sorted(self._replicas.items())
                       if st is not src and not st.dead
                       and not st.draining and not st.quarantined
                       and getattr(st.replica, "fabric_address", None)
                       is not None and hasattr(st.replica, "adopt")]
        if not targets:
            return
        for i, rid in enumerate(rids):
            with self._lock:
                rr = self._requests.get(rid)
            if rr is None or rr.done:
                continue
            st = targets[i % len(targets)]
            if self._adopt_on(rr, st, {"kind": "peer",
                                       "addr": list(src_addr),
                                       "session_id": rid,
                                       "trace_id": rr.trace_id}):
                continue
            with self._lock:
                orphaned = (not rr.done and rr.replica is None
                            and rr._inner is None)
            if orphaned:
                self._journal.record("failover", rid,
                                     replica=src.replica.name,
                                     trace_id=rr.trace_id)
                self._m_resubmitted.inc()
                self._m_replayed.inc()
                self._queue.push_front(rr, rr.client)

    # -- failover ----------------------------------------------------------

    def _fail_replica(self, name, cause):
        """Declare `name` dead (idempotent): fence its lease generation
        in the store, cancel + detach every request it owned, and
        resubmit each at the front of the queue with prompt replay —
        the zero-lost-request core."""
        with self._lock:
            detached = self._detach_replica_locked(name, cause)
        if detached is not None:
            self._requeue_victims(name, cause, *detached)

    def _detach_replica_locked(self, name, cause):
        """The part of `_fail_replica` done under the router lock: mark
        `name` dead and detach, strike and fence every request it owns.
        Returns (state, victims, their attempts), or None when `name` is
        gone or dead already.  A caller that strikes a request under the
        lock detaches here in the same critical section, so nothing can
        be dispatched to the replica between its strike and its death."""
        st = self._replicas.get(name)
        if st is None or st.dead:
            return None
        st.dead = True
        if st.shadow is not None:
            # the replica's prefix cache died with it: drop the
            # shadow so stale entries can't keep winning affinity
            # picks or emitting pull hints at a corpse
            st.shadow.clear()
        victims = []
        for rid in sorted(st.owner_rids):
            rr = self._requests.get(rid)
            if rr is not None and not rr.done:
                victims.append(rr)
        st.owner_rids.clear()
        st.inflight = 0
        st.probing_rid = None
        inners = [rr._inner for rr in victims if rr._inner is not None]
        for rr in victims:
            rr.replica = None
            rr._inner = None
            rr._handoff_target = None
            # poison attribution: every request in flight at fence
            # time collects one strike (the common factor across
            # poison_threshold fence events is the poison)
            rr.poison_strikes += 1
            rr.fence_events.append(
                {"replica": name, "t": time.time(),
                 "cause": type(cause).__name__})
            # fence at detach time, not next-dispatch time: the
            # replica may be a zombie (lease blip on a live host)
            # whose cancelled attempt completes *cleanly* — without
            # this bump that on_done would take the success branch
            # and mark the request done with a truncated stream
            rr._epoch += 1
        # disaggregated serving: in-flight prefills that
        # nominated the DEAD replica as their handoff target lose
        # the nomination — their chunk streams are already failing,
        # so each prefill replica finishes its request colocated
        # and the router never adopts at a corpse
        for orr in self._requests.values():
            if orr._handoff_target == name:
                orr._handoff_target = None
        return st, victims, inners

    def _requeue_victims(self, name, cause, st, victims, inners):
        """The rest of `_fail_replica`, outside the lock: meter, cancel
        the attempts, fence the lease in the store, and convict or
        requeue each victim."""
        self._m_failovers.inc()
        self._update_live_gauge()
        # fleet series: mark the fenced replica's time
        # series stale so fleet-wide aggregates stop counting a corpse
        # — its tails stay visible in /debug/fleet for post-mortems
        self._agg.mark_stale(name, "fenced")
        # flight recorder: a replica was just fenced — dump
        # the router-side timelines of everything it owned (a SIGKILLed
        # process cannot dump its own)
        _tr.flight_record(f"fence-{name}")
        for inner in inners:
            inner.cancel()          # a merely-wedged replica frees slots
        lease = getattr(st.replica, "lease", None)
        if (self._store is not None and lease is not None
                and lease.generation is not None):
            try:
                fence_replica(self._store, self.job_id, name,
                              lease.generation)
            except (StoreError, ConnectionError, OSError):
                pass                # store down: in-router fencing holds
        for rr in victims:
            self._journal.record("failover", rr.rid, replica=name,
                                 trace_id=rr.trace_id)
            if self._poison_check(rr):
                continue        # convicted: failed typed, no replay
            if rr.poison_strikes == 0 and self._try_adopt(rr,
                                                          exclude=name):
                continue        # session ticket adopted: no replay
            self._m_resubmitted.inc()
            self._m_replayed.inc()
            self._queue.push_front(rr, rr.client)
        self._set_queue_gauges()

    def _note_quarantine(self, name, st):
        """A replica's silent-corruption canary tripped:
        stop dispatching to it, live-migrate its PARKED sessions to
        survivors over the fabric, then retire it once idle — all
        WITHOUT fencing its lease or cancelling in-flight work.
        Quarantine ≠ dead: active streams finish on the quarantined
        replica (their already-delivered prefixes stay valid — the
        canary distrusts *future* KV, the position dedupe and bitwise
        contract still protect delivery), parked ones migrate with
        zero prompt replay."""
        with self._lock:
            first = not st.quarantined
            st.quarantined = True
        if first:
            self._m_quarantines.inc()
            self._update_live_gauge()
            self._agg.mark_stale(name, "quarantined")
            _tr.flight_record(f"router-quarantine-{name}")
            if self._store is not None:
                # lease layer: report "quarantined" distinctly from
                # dead — the lease stays live, the fence stays put
                try:
                    set_replica_status(self._store, self.job_id, name,
                                       "quarantined")
                except (StoreError, ConnectionError, OSError):
                    pass
        # re-attempt evacuation on EVERY poll, not just the first: a
        # take refused by a still-active stream, or a fleet with no
        # adoption target yet (the peer may join seconds later), must
        # not strand a parked session on a distrusted replica — its
        # engine has frozen resumes, so the router is the only way off
        src_addr = getattr(st.replica, "fabric_address", None)
        if src_addr is not None:
            self._migrate_parked(st, src_addr)
        # incremental retire: health polls keep landing here until the
        # replica owns nothing, then it leaves the fleet cleanly
        with self._lock:
            idle = not st.owner_rids and st.inflight == 0
            if idle:
                self._replicas.pop(name, None)
        if idle:
            lease = getattr(st.replica, "lease", None)
            if lease is not None:
                try:
                    lease.release()
                except (StoreError, ConnectionError, OSError):
                    pass
            self._m_drains.inc()
            self._update_live_gauge()

    # -- health + autoscale ------------------------------------------------

    def _health_loop(self):
        while not self._closing.wait(self.poll_interval):
            self.poll_once()

    def poll_once(self):
        """One health sweep: scrape every live replica's /healthz,
        declare the unreachable/unhealthy/lease-expired ones dead, and
        feed the autoscale hook.  Called from the health thread; public
        for deterministic tests."""
        lease_view = None
        if self._store is not None:
            try:
                lease_view = live_replicas(self._store, self.job_id)
            except (StoreError, ConnectionError, OSError):
                lease_view = None   # store blip: skip lease judgement
        with self._lock:
            items = list(self._replicas.items())
        for name, st in items:
            if st.dead or st.draining:
                continue
            try:
                h = st.replica.health()
                st.last_health = h
                st.last_queue_depth = int(h.get("queue_depth", 0))
                pr = h.get("pool_role")
                if pr and pr != st.pool_role:
                    st.pool_role = str(pr)
                    self._agg.set_pool(name, st.pool_role)
                # hang watchdog: the replica answers health
                # probes (its poller thread is fine) but its step loop
                # is wedged — work pending, heartbeat stale.  That is a
                # failover, not a wait: a hung replica holds requests
                # hostage exactly like a dead one.
                if h.get("stalled"):
                    self._m_watchdog.inc()
                    _tr.flight_record(f"watchdog-{name}")
                    raise ConnectionError(
                        f"replica {name} step watchdog tripped "
                        f"(step_age {h.get('step_age_s', 0):.1f}s)")
                # canary quarantine: trusted-liveness but
                # untrusted data — handled OUT of the failure path (no
                # fencing, no cancel+replay of in-flight work)
                if (h.get("status") == "quarantined"
                        or h.get("quarantined")):
                    self._note_quarantine(name, st)
                    continue
                if h.get("status") not in ("ok", "draining"):
                    raise ConnectionError(
                        f"replica {name} reports {h.get('status')!r}")
            except BaseException as e:  # noqa: BLE001 — any probe failure
                self._fail_replica(name, e)
                continue
            if (lease_view is not None
                    and getattr(st.replica, "lease", None) is not None
                    and name not in lease_view):
                self._fail_replica(
                    name, StoreError(f"lease for {name} expired/fenced"))
                continue
        self._update_live_gauge()
        # series ingestion + burn-rate evaluation live on the dedicated
        # observability thread (_obs_loop), NOT here: a health probe
        # against a saturated replica can block for seconds, and that
        # is exactly when the alerting plane must keep its cadence
        if self._autoscale_cb is not None:
            sig = self.autoscale_signal()
            rec = self._autoscale_policy.evaluate(sig)
            if rec:
                try:
                    self._autoscale_cb(rec, sig)
                except Exception:   # noqa: BLE001 — hook must not kill polling
                    pass

    def autoscale_signal(self) -> dict:
        with self._lock:
            live = [st for st in self._replicas.values()
                    if not st.dead and not st.draining
                    and not st.quarantined]
            n_quar = sum(1 for st in self._replicas.values()
                         if st.quarantined and not st.dead)
            occ = [st.last_health.get("occupancy", 0.0) for st in live]
            ttft = [st.last_health.get("ttft_p50_s", 0.0) for st in live]
            # per-tier pressure: router queue + every replica's reported
            # tier depths, so the policy can tell "batch backlog" (more
            # replicas eventually) from "interactive at risk" (now)
            tier_q = dict(self._queue.depths())
            for st in live:
                for t, n in (st.last_health.get("tier_queue_depth")
                             or {}).items():
                    tier_q[t] = tier_q.get(t, 0) + int(n)
            sig = {
                "replicas": len(live),
                "queue_depth": len(self._queue),
                "replica_queue_depth": sum(
                    st.last_queue_depth for st in live),
                "occupancy": (sum(occ) / len(occ)) if occ else 0.0,
                "ttft_p50_s": max(ttft) if ttft else 0.0,
                # preempted requests hold no slot but DO represent load
                # the fleet failed to place — scale-up pressure
                "preempted": sum(
                    int(st.last_health.get("preempted", 0))
                    for st in live),
                "tier_queue_depth": tier_q,
                "max_overload_rung": max(
                    (int(st.last_health.get("overload_rung", 0))
                     for st in live), default=0),
                # immune-system pressure: quarantined
                # replicas serve no new work — capacity the autoscaler
                # should replace, distinct from `replicas` shrinking
                # by crash
                "quarantined": n_quar,
                "watchdog_failovers": int(self._m_watchdog.value),
            }
            # per-pool scaling signals: the prefill pool
            # scales on queue/TTFT pressure, the decode pool on
            # occupancy/ITL — one fleet-wide mean would let a starved
            # prefill pool hide behind idle decode replicas
            prefill = [st for st in live if st.pool_role == "prefill"]
            decode = [st for st in live if st.pool_role == "decode"]
            if prefill or decode:
                pq = sum(st.last_queue_depth for st in prefill)
                d_occ = [st.last_health.get("occupancy", 0.0)
                         for st in decode]
                occ_mean = (sum(d_occ) / len(d_occ)) if d_occ else 0.0
                sig["pools"] = {
                    "prefill": {
                        "replicas": len(prefill),
                        "queue_depth": pq,
                        "ttft_p50_s": max(
                            (st.last_health.get("ttft_p50_s", 0.0)
                             for st in prefill), default=0.0),
                    },
                    "decode": {
                        "replicas": len(decode),
                        "occupancy": occ_mean,
                        "itl_p50_s": max(
                            (st.last_health.get("itl_p50_s", 0.0)
                             for st in decode), default=0.0),
                    },
                }
                self._m_prefill_pool_q.set(pq)
                self._m_decode_pool_occ.set(occ_mean)
        # windowed overlay: prefer the fleet aggregator's
        # time-windowed series over the point-in-time health snapshot —
        # one noisy probe no longer whipsaws the autoscale policy.
        # Falls back to the point values when no series have landed
        # yet (cold start, series shipping disabled).
        win = self.series_window_s
        windowed = False
        w_occ = self._agg.occupancy(win)
        if w_occ is not None:
            sig["occupancy"] = w_occ
            windowed = True
        w_ttft = self._agg.ttft_p50(win)
        if w_ttft is not None:
            sig["ttft_p50_s"] = w_ttft
            windowed = True
        w_itl = self._agg.itl_p50(win)
        if w_itl is not None:
            sig["itl_p50_s"] = w_itl
            windowed = True
        gp = {}
        for t in SLOTier.ALL:
            g = self._agg.goodput(t, win)
            if g is not None:
                gp[t] = g
        if gp:
            sig["goodput"] = gp
            windowed = True
        sig["windowed"] = windowed
        return sig

    # -- fleet observability plane -----------------------------------------

    def _obs_loop(self):
        """Dedicated observability cadence: drain every live replica's
        pushed series payloads into the fleet aggregator, then evaluate
        the burn-rate rules.  Deliberately NOT part of the health sweep
        — this loop touches only in-memory buffers, so it keeps time
        even while health probes block on a saturated replica (which
        is precisely when the alerts matter)."""
        while not self._closing.wait(self._obs_interval):
            self.observe_once()

    def observe_once(self):
        """One ingest+evaluate sweep; public for deterministic tests."""
        with self._lock:
            items = [(name, st) for name, st in self._replicas.items()
                     if not st.dead]
        for name, st in items:
            self._ingest_series(name, st)
        try:
            self._alerts.evaluate(self._agg.error_rate)
        except Exception:   # noqa: BLE001 — alerting must not kill the loop
            pass

    def _ingest_series(self, name, st):
        """Fold one replica's shipped time-series tails into the fleet
        aggregator.  Prefers payloads the replica already PUSHED over
        the ctl socket (`process_fleet.ProcessReplica.pop_series`);
        replicas without a push channel (the in-process `Replica` of a
        `LocalFleet`) are PULLED via `metrics_series()`.  Any failure
        here costs freshness only — the aggregator's staleness clock
        does the rest."""
        rep = st.replica
        try:
            pop = getattr(rep, "pop_series", None)
            if pop is not None:
                payloads = pop()
                if payloads:
                    for p in payloads:
                        self._agg.ingest(name, p)
                    return
                # pushed channel exists but nothing landed this poll:
                # do NOT fall through to a pull — the pusher owns the
                # cadence, and a pull here would double-sample
                if getattr(rep, "proc", None) is not None:
                    return
            server = getattr(rep, "server", None)
            fn = getattr(server, "metrics_series", None)
            if fn is not None:
                self._agg.ingest(name, fn())
        except Exception:   # noqa: BLE001 — shipping is best-effort
            pass

    def _on_alert_fire(self, alert):
        self._m_alerts_fired.inc()
        # alert firing trips the flight recorder: the
        # dump carries the router-side request timelines from the very
        # window that burned the budget
        _tr.flight_record(f"alert-{alert.name}")

    def _on_alert_resolve(self, alert):
        self._m_alerts_resolved.inc()

    @property
    def fleet_aggregator(self):
        return self._agg

    @property
    def alert_manager(self):
        return self._alerts

    def alerts(self):
        """Currently-firing alerts (list of dicts)."""
        return [a.to_dict() for a in self._alerts.firing()]

    def debug_fleet(self, tail_n=20):
        """The `/debug/fleet` document: one JSON-serializable snapshot
        of everything an operator asks first — per-replica series
        tails + staleness, fleet-windowed SLO/latency aggregates,
        burn rates, firing + recent alerts, the autoscale signal, the
        overload rung, and per-program cost attribution."""
        now = time.time()
        win = self.series_window_s
        agg_snap = self._agg.snapshot(tail_n=tail_n)
        with self._lock:
            rep_state = {
                name: {
                    "dead": st.dead,
                    "draining": st.draining,
                    "quarantined": st.quarantined,
                    "inflight": st.inflight,
                    "queue_depth": st.last_queue_depth,
                    "overload_rung": int(
                        st.last_health.get("overload_rung", 0)),
                    "pool_role": st.pool_role,
                }
                for name, st in self._replicas.items()}
            # pool membership rollup: which live replicas
            # serve each placement pool — the first thing an operator
            # checks when TTFT burns while decode sits idle
            pools = {}
            for name, st in self._replicas.items():
                if not st.dead:
                    pools.setdefault(st.pool_role, []).append(name)
        replicas = {}
        for name in set(rep_state) | set(agg_snap):
            entry = dict(rep_state.get(name) or {})
            entry["series"] = agg_snap.get(name) or {}
            replicas[name] = entry
        tiers = {}
        for t in SLOTier.ALL:
            tiers[t] = {
                "goodput": self._agg.goodput(t, win),
                "error_rate": self._agg.error_rate(t, win),
                "ttft_p50_s": self._agg.tier_ttft(t, win, q=50),
                "ttft_p99_s": self._agg.tier_ttft(t, win, q=99),
                "itl_p50_s": self._agg.tier_itl(t, win, q=50),
            }
        doc = {
            "t": now,
            "job_id": self.job_id,
            "window_s": win,
            "replicas": replicas,
            "pools": {r: sorted(ns) for r, ns in pools.items()},
            "tiers": tiers,
            "burn_rates": self._alerts.burn_rates(),
            "alerts": self._alerts.snapshot(),
            "autoscale_signal": self.autoscale_signal(),
            "queue_depth": len(self._queue),
            "router_epoch": self.router_epoch,
            "poison_threshold": self.poison_threshold,
        }
        # pluggable sections: the respawn breaker, the HA
        # role, anything an embedder wants on the operator surface
        for name, fn in list(self._debug_sections.items()):
            try:
                doc[name] = fn()
            except Exception as e:   # noqa: BLE001 — operator surface
                doc[name] = {"error": str(e)}
        return doc

    def add_debug_section(self, name, fn):
        """Attach an extra `/debug/fleet` section: `fn()` returns a
        JSON-serializable value, evaluated per snapshot."""
        self._debug_sections[str(name)] = fn

    def _start_debug_http(self, host, port):
        import http.server
        router = self

        class _DebugHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?")[0].rstrip("/")
                if path in ("", "/debug/fleet"):
                    try:
                        doc = router.debug_fleet()
                        body = json.dumps(
                            doc, sort_keys=True).encode() + b"\n"
                    except Exception as e:  # noqa: BLE001
                        self.send_error(500, str(e))
                        return
                    self._reply(200, body)
                elif path == "/metrics":
                    self._reply(200, router.metrics_text().encode(),
                                ctype="text/plain; version=0.0.4")
                else:
                    self.send_error(404)

            def _reply(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # keep the serving log clean
                pass

        self._debug_http = http.server.ThreadingHTTPServer(
            (host, port), _DebugHandler)
        self._debug_http.daemon_threads = True
        self.debug_address = self._debug_http.server_address[:2]
        self._debug_http_thread = threading.Thread(
            target=self._debug_http.serve_forever, daemon=True)
        self._debug_http_thread.start()

    # -- drain / shutdown --------------------------------------------------

    def drain(self, name, timeout=60.0) -> bool:
        """Graceful scale-down: stop routing to `name`, let its
        in-flight requests finish (`LLMServer.shutdown(drain=True)`),
        release the lease, detach.  Returns True on a clean drain; a
        wedged drain falls back to failover so the contract still
        holds."""
        with self._lock:
            st = self._replicas.get(name)
            if st is None:
                raise KeyError(f"unknown replica {name!r}")
            st.draining = True
        self._update_live_gauge()
        # live-migrate over the fabric first: a PARKED
        # session moves to a survivor instantly by peer take instead of
        # waiting out the drain; active sessions refuse the take and
        # finish here as before
        src_addr = getattr(st.replica, "fabric_address", None)
        if src_addr is not None:
            self._migrate_parked(st, src_addr)
        st.replica.server.shutdown(drain=True, drain_timeout=timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not st.owner_rids:
                    break
            time.sleep(0.005)
        with self._lock:
            clean = not st.owner_rids
        if not clean:
            st.draining = False     # let _fail_replica see it
            self._fail_replica(name, RuntimeError(
                f"drain of {name} timed out"))
        lease = getattr(st.replica, "lease", None)
        if lease is not None:
            lease.release()
        with self._lock:
            self._replicas.pop(name, None)
        self._m_drains.inc()
        self._update_live_gauge()
        return clean

    def shutdown(self, timeout=5.0):
        """Stop the router threads and fail every outstanding request
        with `EngineUnhealthy` — WITHOUT journaling them as terminal,
        so a successor router can `resubmit_incomplete()` them.  The
        replicas themselves are not touched (shut the fleet down
        separately)."""
        if self._closing.is_set():
            return
        self._closing.set()
        if self._debug_http is not None:
            try:
                self._debug_http.shutdown()
                self._debug_http.server_close()
            except Exception:   # noqa: BLE001
                pass
        self._queue.wake()
        self._dispatcher.join(timeout)
        self._health_thread.join(timeout)
        self._obs_thread.join(timeout)
        with self._lock:
            live = [rr for rr in self._requests.values() if not rr.done]
        pending = []
        for rr in live:
            # under the request's delivery lock: a delivery already past
            # its done check journals its token before the request
            # closes (and before the journal does), and none starts
            # after — a late "tok" write must not hit a closed journal
            # on a replica's callback thread
            with rr._deliver_lock, self._lock:
                if not rr.done:
                    rr.done = True
                    rr.error = EngineUnhealthy("router shut down")
                    pending.append(rr)
        for rr in pending:
            if rr._inner is not None:
                rr._inner.cancel()
            self._m_failed.inc()
            if rr.on_done is not None:
                rr.on_done(rr)
            rr._done_ev.set()
        self._journal.close()

    close = shutdown

    # -- metrics -----------------------------------------------------------

    @property
    def metrics_registry(self):
        return self._metrics

    def metrics(self):
        return self._metrics.snapshot()

    def metrics_text(self):
        return self._metrics.prometheus_text()
