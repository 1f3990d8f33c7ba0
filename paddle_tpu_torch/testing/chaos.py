"""Chaos-sweep harness — the port of the JAX package's `testing/chaos.py`,
host only.

The fault injector (`testing.faults`) gives every recovery path a
deterministic trigger, but the sites are only exercised piecemeal by
individual tests — nothing proves the *whole* fleet holds its standing
invariants while each site fires in turn.  This module closes that gap:

  * `table_sites()` / `registered_sites()` / `armed_sites()` — the
    meta-surface.  The injector's docstring table is the contract; a
    site named there must be registered at a real ``fire(...)`` call in
    the source AND drilled by the sweep (or a test).  The meta-test
    (`tests/test_torch_chaos.py`) greps all three and fails the build
    when a new site ships without coverage.
  * `DRILLS` — how the sweep arms each site against a REAL 2-process
    fleet: where the rule lands (the parent router process or a child
    replica, via `ProcessReplica.arm_fault`), the rule's kwargs, and
    whether the drill is expected to knock the replica out of the
    fleet (crash/quarantine/watchdog -> respawn before the next round).
  * `run_sweep()` — replay one seeded trace (`testing.traces`) through
    a `ProcessFleet` + `Router` once per site with that site's drill
    armed, then assert the standing invariants after every round:

      - **zero lost**: every accepted request completes without error;
      - **zero corrupt tokens delivered**: every stream is
        bitwise-identical to an unloaded single-engine reference run
        (the engine's per-request determinism contract makes this THE
        corruption check — a silently flipped KV bit changes tokens);
      - drill-specific signals (a canary round must produce a
        quarantine-and-migrate cycle; a stall round a watchdog
        failover).

    Between rounds the sweep optionally bit-flips every disk-tier
    block (`faults.corrupt_bytes`) so at-rest corruption rides the
    whole sweep, not just its own round.

The sweep is deliberately heavier than a unit test (it boots real
processes); `tests/test_torch_chaos.py` runs a representative subset in
tier-1 and the slow-marked test runs the full table; `chip_smoke.py`'s
`serve_chaos` phase runs the full table against llama3-8b replica
processes on the card.

Where the port differs: the harness's switch is `faults.ENABLED` (the
port has no flags module); a lethal round's casualty — a fenced or
quarantined replica, still a live process — is retired by SIGKILL and
respawned under its slot name through the crash-loop breaker, as the
poison drill does, instead of being left alive beside a fresh spawn
(on the card every live child holds its own copy of the weights); and
both HA drills lead the sweep's own job (`_drill_router_failover`
says why), after which the sweep checks that its own router still has
both replicas live and neither fenced.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
import time

import numpy as np

from . import faults as _faults
from . import traces as _traces

__all__ = ["table_sites", "registered_sites", "armed_sites", "DRILLS",
           "default_engine_kw", "default_trace", "reference_streams",
           "run_sweep"]

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# meta-surface: the three views of the fault-site inventory
# ---------------------------------------------------------------------------

#: sites that can only trip on the *training* side (trainer loop,
#: checkpointing, elastic training leases) — the serving sweep arms
#: them (coverage: an armed-but-inert rule proves the plumbing), but
#: expects no trip and no fleet disturbance.  None is wired in the port
#: yet: they come with ROADMAP queue 1 item 7.
TRAINING_SITES = frozenset({
    "elastic.heartbeat", "trainer.step", "checkpoint.commit",
})


def table_sites():
    """Site names from the `testing.faults` docstring table, in table
    order — the human-facing contract the meta-test enforces."""
    doc = _faults.__doc__ or ""
    out = []
    for m in re.finditer(r"^  ([a-z_][a-z0-9_]*\.[a-z0-9_.]+)\s{2,}\S",
                         doc, re.M):
        out.append(m.group(1))
    return out


def registered_sites(root=None):
    """Every site string passed to a ``fire(...)`` call in the package
    source (the injector's *registered* call sites)."""
    root = root or _PKG_ROOT
    pat = re.compile(r"""\bfire\(\s*\n?\s*["']([a-z0-9_.]+)["']""")
    out = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py") or fn == "chaos.py":
                continue
            with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                out.update(pat.findall(f.read()))
    return out


def armed_sites(paths):
    """Every site a test or tool arms — ``inject("site"...)`` /
    ``arm_fault("site"...)`` string literals under `paths` (files or
    directories), plus everything the sweep's own drill table covers."""
    pat = re.compile(
        r"""\b(?:inject|arm_fault)\(\s*\n?\s*["']([a-z0-9_.]+)["']""")
    out = set(DRILLS)
    stack = [p for p in paths]
    while stack:
        p = stack.pop()
        if os.path.isdir(p):
            for entry in os.listdir(p):
                if entry != "__pycache__":
                    stack.append(os.path.join(p, entry))
        elif p.endswith(".py"):
            with open(p, encoding="utf-8") as f:
                out.update(pat.findall(f.read()))
    return out


# ---------------------------------------------------------------------------
# drill table: how the sweep fires each site against a live fleet
# ---------------------------------------------------------------------------

#: site -> drill spec.
#:   where    "parent"  — rule lands in the router process's injector
#:            "child0"  — armed in the first replica via arm_fault
#:            "children"— armed in every replica
#:   kw       inject() kwargs (exc crosses the process boundary by
#:            NAME; None means delay-only)
#:   lethal   the drill is expected to take the replica out of the
#:            fleet (crash, quarantine, watchdog fence) — the sweep
#:            respawns before the next round
#:   signal   router metric that must move during the round
#:
#: Five sites of the JAX table have no drill here because the port fires
#: none of them yet, each waiting for its ROADMAP item:
#:   aot.cache_load                       queue 1 item 2 (j), the AOT
#:                                        serving-program cache
#:   sp.ring_step                         queue 1 item 5, multi-GPU (sp)
#:   trainer.step, checkpoint.commit,     queue 1 item 7, the rest of
#:   elastic.heartbeat                    the API (hapi, distributed/
#:                                        resilience.py, distributed/
#:                                        fleet/elastic.py)
DRILLS = {
    "store.rpc": {"where": "parent",
                  "kw": {"times": 2, "exc": "InjectedConnectionError"}},
    "router.admit": {"where": "parent", "kw": {"times": 1}},
    "router.dispatch": {"where": "parent", "kw": {"times": 1}},
    "replica.crash": {"where": "child0", "kw": {"times": 1, "after": 2},
                      "lethal": True, "signal": "failovers_total"},
    "kv.alloc": {"where": "child0", "kw": {"times": 2}},
    "kv.swap_out": {"where": "child0", "kw": {"times": 1}},
    "kv.swap_in": {"where": "child0", "kw": {"times": 1}},
    "engine.overload": {"where": "child0", "kw": {"times": 1}},
    "fabric.pull": {"where": "children", "kw": {"times": 1}},
    "fabric.push": {"where": "children", "kw": {"times": 1}},
    "fabric.disk_io": {"where": "children", "kw": {"times": 2}},
    "engine.canary": {"where": "child0", "kw": {"times": 1},
                      "lethal": True, "signal": "quarantines_total"},
    "engine.stall": {"where": "child0",
                     "kw": {"times": 1, "exc": None, "delay": 8.0},
                     "lethal": True,
                     "signal": "watchdog_failovers_total"},
    # every replica's periodic series push: two dropped pushes per
    # child cost metrics freshness only — the next push's overlapping
    # tail re-covers the gap and the round's streams stay bitwise
    "metrics.ship": {"where": "children", "kw": {"times": 2}},
    # disaggregated-serving sites: chunk streams and handoff adoption
    # only run when the fleet has prefill/decode pools, which the
    # sweep's mixed 2-replica fleet never forms — armed-but-inert here,
    # like the training sites; the trip paths (torn stream -> colocated
    # finish on the prefill replica, torn adopt -> prompt replay on the
    # decode pool) are drilled for real by tests/test_torch_disagg.py
    # against a role-typed fleet
    "fabric.handoff_chunk": {"where": "children", "kw": {"times": 1}},
    "handoff.adopt": {"where": "children", "kw": {"times": 1}},
    # control-plane HA drills: special=True rounds run a dedicated
    # choreography (crash THEN restart THEN assert) instead of the
    # generic arm-replay-assert shape — see the _drill_* functions below
    "store.crash": {"where": "parent", "kw": {"times": 1},
                    "special": True},
    "router.crash": {"where": "parent", "kw": {"times": 1},
                     "special": True},
    "journal.tail": {"where": "parent", "kw": {"times": 1},
                     "special": True},
    "replica.poison": {"where": "children", "kw": {"times": 1},
                       "special": True},
    # tiered-KV site: the sweep's fleet runs untiered (no hot_window),
    # so the site cannot trip mid-round — armed-but-inert here, like the
    # training sites; the real trip path (skipped prefetch tick ->
    # extension rows read in place) is drilled by
    # tests/test_torch_tiered_kv.py against a tiered engine
    "kv.prefetch": {"where": "children", "kw": {"times": 1}},
}

#: fleet-wide immune-system knobs for the sweep.  The watchdog
#: deadline must clear the worst warm step by a wide margin (steps
#: are ~ms once warm; graph capture happens before a replica's hello
#: and the warmup pass below keeps first runs off the clock) while
#: staying well under the stall drill's 8 s wedge.
SWEEP_CANARY_INTERVAL = 1.0
SWEEP_WATCHDOG_DEADLINE = 5.0


def default_engine_kw():
    """The tiny-model engine shape every chaos run shares: small KV
    pool (so the preempt ladder actually engages under the trace) and
    short buckets (so first runs stay cheap on CPU)."""
    return dict(max_slots=2, max_len=64, max_prompt_len=32, min_bucket=8,
                prefill_chunk=8, kv_block_tokens=8, kv_blocks=9,
                preempt_policy="swap")


def default_trace(seed=0, n_max=8):
    """A small seeded trace sized to the tiny engine: heavy session
    reuse (prefix-cache + fabric pulls get real work), prompts and
    outputs clipped to the tiny engine's budget."""
    events = _traces.generate(_traces.TraceConfig(
        seed=seed, duration_s=8.0, base_rate=1.5,
        min_prompt_len=4, max_prompt_len=24,
        prompt_len_log_mu=2.2, prompt_len_log_sigma=0.6,
        min_out_len=2, max_out_len=8,
        out_len_log_mu=1.5, out_len_log_sigma=0.5,
        session_reuse=0.5, max_session_len=24, vocab_size=255))
    return events[:n_max]


def reference_streams(events, model_spec=None, engine_kw=None):
    """The unloaded ground truth: one fresh single-process engine, the
    trace's requests run to completion with no faults, no fleet, no
    pressure.  Returns ``[tokens...]`` aligned with `events` — the
    engine's per-request determinism contract (a stream depends only on
    its own prompt/knobs) makes this the bitwise yardstick for every
    sweep round.

    The model is the one a replica child builds from the same
    `model_spec` keys (`preset`, `overrides`, `seed`, `device` —
    default ``"cuda"``, which raises without a card — and `arrays`);
    on the card the engine captures its graphs first, as a child does
    before its hello, and the model's memory is handed back before
    this returns, so the children that follow find the card empty."""
    from ..inference.engine import LLMEngine
    from ..inference.process_fleet import _build_model

    spec = dict(model_spec or {"preset": "tiny", "seed": 0})
    model = _build_model(spec, "reference", cap_threads=False)
    eng = LLMEngine(model, **(engine_kw or default_engine_kw()))
    if eng._graphs is not None:
        eng.prepare_programs()
    out = []
    for ev in events:
        req = eng.submit(np.asarray(ev.prompt, np.int32),
                         max_new_tokens=ev.max_new_tokens)
        guard = 0
        while not req.done and guard < 20_000:
            eng.step()
            guard += 1
        if req.error is not None or not req.done:
            raise RuntimeError(f"reference run failed: {req.error!r}")
        out.append(list(req.tokens))
    if model.device.type == "cuda":
        import gc

        import torch
        del eng, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# control-plane HA drills
# ---------------------------------------------------------------------------

def _drill_store_crash(*, fleet, router, events, expected, job_id, log,
                       result_timeout, signal_timeout, warm):
    """SIGKILL the fleet store mid-trace (armed ``store.crash`` site),
    restart it from snapshot+WAL: zero requests lost, streams bitwise,
    and — because the restart grace-extends every lease by the
    measured outage — zero replicas fenced for the store's crash."""
    _faults.ENABLED = True
    _faults.get_injector().inject("store.crash",
                                  **DRILLS["store.crash"]["kw"])
    rrs = [_submit_with_retry(router, ev, i)
           for i, ev in enumerate(events)]
    # store traffic flows constantly (lease heartbeats), so the armed
    # rule trips within a beat or two of arming
    assert fleet.store.crashed.wait(15.0), \
        "store.crash drill: the armed rule never tripped"
    log("[chaos] store.crash: store down, serving continues")
    time.sleep(0.5)                 # a measurable outage to grace over
    rec = fleet.store.restart()
    assert rec is not None and rec["keys"] > 0, rec
    assert rec["graced_leases"] >= 2, (
        f"restart graced {rec['graced_leases']} leases, expected every "
        f"replica's: {rec}")
    bad = []
    for i, rr in enumerate(rrs):
        try:
            got = router.result(rr, timeout=result_timeout)
        except BaseException as e:  # noqa: BLE001 — reported below
            bad.append((i, f"lost: {e!r}"))
            continue
        if list(got) != expected[i]:
            bad.append((i, "corrupt stream"))
    assert not bad, f"store.crash broke invariants: {bad}"
    # nobody fenced: both replicas still live after the outage
    deadline = time.monotonic() + signal_timeout
    while (len(router.live_replica_names()) < 2
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert len(router.live_replica_names()) == 2, (
        "store restart fenced a replica despite the lease grace")
    return {"events": len(events), "lost": 0, "corrupt": 0,
            "recovered": {k: rec[k] for k in
                          ("snapshot", "wal_records", "keys",
                           "graced_leases", "outage_s")}}


def _drill_router_failover(*, fleet, router, events, expected, job_id,
                           log, result_timeout, signal_timeout, warm):
    """SIGKILL-equivalent the primary HARouter mid-trace (armed
    ``router.crash`` site); the hot standby detects the expired
    leader lease, promotes, resubmits from its shadow journal, and
    every stream completes bitwise through the FleetClient shim."""
    from ..inference.router_ha import (FleetClient, HARouter,
                                       StandbyRouter)
    # both HA drills lead the sweep's own job.  A router judges its
    # replicas by their leases under its job (`Router.poll_once`), and
    # the sweep's children hold theirs under `job_id`: a router leading
    # another job fences them at its first health poll.  One job is also
    # one leadership lineage, which the replicas need: each keeps one
    # high-water mark of the router epochs it has served, so the
    # journal.tail drill's primary must lead above the standby promoted
    # here
    job = job_id
    live = set(router.live_replica_names())
    reps = [r for r in fleet.replicas if r.name in live]
    primary = HARouter(store=fleet.store, job_id=job, lease_ttl=1.5,
                       poll_interval=0.25, crash_poll_s=0.1)
    standby = None
    try:
        for rep in reps:
            primary.add_replica(rep)
        standby = StandbyRouter(fleet.store, job, replicas=reps,
                                auto_promote=True, watch_interval=0.2,
                                router_kw={"poll_interval": 0.25})
        client = FleetClient(fleet.store, job)
        rids = [client.submit(ev.prompt, ev.max_new_tokens,
                              client=f"sess-{ev.session}")
                for ev in events]
        _faults.ENABLED = True
        _faults.get_injector().inject("router.crash",
                                      **DRILLS["router.crash"]["kw"])
        assert primary.crashed.wait(10.0), \
            "router.crash drill: the armed rule never tripped"
        log("[chaos] router.crash: primary down, awaiting promotion")
        assert standby.promoted.wait(signal_timeout), \
            "standby never promoted after the leader lease expired"
        r2 = standby.router
        bad = []
        for i, rid in enumerate(rids):
            try:
                _, toks = client.result(rid, timeout=result_timeout)
            except BaseException as e:  # noqa: BLE001 — reported below
                bad.append((i, f"lost: {e!r}"))
                continue
            if toks != expected[i]:
                bad.append((i, "corrupt stream"))
        assert not bad, f"router.crash broke invariants: {bad}"
        assert _metric(r2, "replay_mismatch_total") == 0, (
            "successor router saw replayed tokens diverge from the "
            "journal prefix")
        assert r2.router_epoch > primary.router_epoch
        return {"events": len(events), "lost": 0, "corrupt": 0,
                "promote_latency_s": standby.promote_latency_s,
                "resubmitted": _metric(r2, "requests_resubmitted_total")}
    finally:
        _faults.get_injector().clear()
        if standby is not None:
            try:
                standby.stop()
            except Exception:   # noqa: BLE001
                pass
            if standby.router is not None:
                try:
                    standby.router.shutdown()
                except Exception:   # noqa: BLE001
                    pass
        try:
            primary.shutdown()
        except Exception:   # noqa: BLE001
            pass


def _drill_journal_tail(*, fleet, router, events, expected, job_id,
                        log, result_timeout, signal_timeout, warm):
    """Tear one journal frame on the standby's tail (armed
    ``journal.tail`` site): the tailer drops the stream, reconnects,
    and resyncs the WHOLE shadow from a fresh snapshot — afterwards
    the shadow replays to exactly the primary's journal state."""
    from ..inference.router import RoutingJournal
    from ..inference.router_ha import HARouter, StandbyRouter
    job = job_id            # the sweep's own (see _drill_router_failover)
    live = set(router.live_replica_names())
    reps = [r for r in fleet.replicas if r.name in live]
    primary = HARouter(store=fleet.store, job_id=job, lease_ttl=5.0,
                       poll_interval=0.25)
    standby = None
    try:
        for rep in reps:
            primary.add_replica(rep)
        standby = StandbyRouter(fleet.store, job, auto_promote=False)
        deadline = time.monotonic() + signal_timeout
        while (standby.tailer.resets < 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert standby.tailer.resets >= 1, "tailer never synced"
        _faults.ENABLED = True
        _faults.get_injector().inject("journal.tail",
                                      **DRILLS["journal.tail"]["kw"])
        rrs = [_submit_with_retry(primary, ev, i)
               for i, ev in enumerate(events)]
        bad = []
        for i, rr in enumerate(rrs):
            try:
                got = primary.result(rr, timeout=result_timeout)
            except BaseException as e:  # noqa: BLE001 — reported below
                bad.append((i, f"lost: {e!r}"))
                continue
            if list(got) != expected[i]:
                bad.append((i, "corrupt stream"))
        assert not bad, f"journal.tail broke invariants: {bad}"
        # the tear must have forced a reconnect + full resync, and the
        # resynced shadow must converge to the primary's journal state
        deadline = time.monotonic() + signal_timeout
        while time.monotonic() < deadline:
            if (standby.tailer.reconnects >= 1
                    and standby.tailer.resets >= 2
                    and (standby.shadow_state()
                         == RoutingJournal.replay(primary.journal_path))):
                break
            time.sleep(0.05)
        assert standby.tailer.reconnects >= 1, \
            "torn frame did not drop the tail connection"
        assert standby.shadow_state() == RoutingJournal.replay(
            primary.journal_path), (
            "shadow journal diverged from the primary after resync")
        return {"events": len(events), "lost": 0, "corrupt": 0,
                "resets": standby.tailer.resets,
                "reconnects": standby.tailer.reconnects}
    finally:
        _faults.get_injector().clear()
        if standby is not None:
            try:
                standby.stop()
            except Exception:   # noqa: BLE001
                pass
        try:
            primary.shutdown()
        except Exception:   # noqa: BLE001
            pass


def _drill_poison(*, fleet, router, events, expected, job_id, log,
                  result_timeout, signal_timeout, warm):
    """A deterministically crash-inducing request (``chaos_mark``
    param trips the armed ``replica.poison`` site in whichever replica
    it lands on) fences at most poison_threshold replicas, is
    convicted and failed TYPED (`PoisonedRequest`), and every
    co-batched innocent completes bitwise after the slots respawn
    through the crash-loop breaker."""
    from ..inference.engine import PoisonedRequest
    live = set(router.live_replica_names())
    reps = [r for r in fleet.replicas if r.name in live]
    assert len(reps) >= 2
    for rep in reps:
        rep.arm_fault("replica.poison", times=1)
    base_poisoned = _metric(router, "poisoned_total")
    rrs = [_submit_with_retry(router, ev, i)
           for i, ev in enumerate(events)]
    poison = router.submit(
        np.asarray(events[0].prompt, np.int32),
        events[0].max_new_tokens, client="poison-drill",
        chaos_mark="chaos-sweep")
    try:
        router.result(poison, timeout=result_timeout)
        raise AssertionError(
            "poison request completed instead of failing typed")
    except PoisonedRequest:
        pass
    convicted = _metric(router, "poisoned_total") - base_poisoned
    innocents = [(rr.rid, rr.fence_events) for rr in rrs
                 if rr.done and isinstance(rr.error, PoisonedRequest)]
    assert convicted == 1, (
        f"{convicted} requests convicted, want the poison alone: the "
        f"poison's fence events {poison.fence_events}; innocents failed "
        f"typed: {innocents}")
    log("[chaos] replica.poison: convicted after "
        f"{poison.poison_strikes} strikes; respawning victims")
    # at most poison_threshold replicas were fenced for it; SIGKILL
    # the wrecks and respawn the slots THROUGH the breaker
    fenced = [r.name for r in reps
              if r.name not in set(router.live_replica_names())]
    assert 0 < len(fenced) <= router.poison_threshold, fenced
    for name in fenced:
        _retire(fleet, router, name, warm)
    deadline = time.monotonic() + signal_timeout
    while (len(router.live_replica_names()) < 2
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert len(router.live_replica_names()) >= 2, \
        "fleet never recovered after the poison round"
    bad = []
    for i, rr in enumerate(rrs):
        try:
            got = router.result(rr, timeout=result_timeout)
        except BaseException as e:  # noqa: BLE001 — reported below
            bad.append((i, f"lost: {e!r}"))
            continue
        if list(got) != expected[i]:
            bad.append((i, "corrupt stream"))
    assert not bad, \
        f"replica.poison broke co-batched innocents: {bad}"
    return {"events": len(events), "lost": 0, "corrupt": 0,
            "fenced": fenced,
            "respawn_state": fleet.respawn_state()}


_SPECIAL_DRILLS = {
    "store.crash": _drill_store_crash,
    "router.crash": _drill_router_failover,
    "journal.tail": _drill_journal_tail,
    "replica.poison": _drill_poison,
}


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _arm(site, drill, fleet, live=None):
    kw = dict(drill.get("kw") or {})
    where = drill["where"]
    if where == "parent":
        if isinstance(kw.get("exc"), str):
            kw["exc"] = getattr(_faults, kw["exc"])
        _faults.ENABLED = True
        _faults.get_injector().inject(site, **kw)
        return
    # "child0" must mean the first LIVE replica (by the router's book),
    # never replicas[0]: a respawned slot is appended at the end of
    # `fleet.replicas`, and arming a replica the router has retired
    # makes the round a silent no-op (the canary drill's quarantine
    # signal could then never move)
    reps = [r for r in fleet.replicas
            if live is None or r.name in live]
    targets = reps[:1] if where == "child0" else reps
    assert targets, f"site {site!r}: no live replica to arm"
    for rep in targets:
        rep.arm_fault(site, **kw)


def _clear_all(fleet):
    _faults.get_injector().clear()
    _faults.ENABLED = False
    for rep in list(fleet.replicas):
        try:
            rep.clear_faults()
        except Exception:   # noqa: BLE001 — a dead replica is "clear"
            pass


def _retire(fleet, router, name, warm):
    """Replace casualty `name` — fenced or quarantined by the router,
    its process still alive — by a fresh process in its slot: SIGKILL,
    respawn through the crash-loop breaker, warm, rejoin the router."""
    fleet.kill(name)
    rep = fleet.respawn(name)
    warm(rep)           # first runs before the watchdog watches
    router.add_replica(rep)
    return rep


def _metric(router, name):
    snap = router.metrics().get(f"router_{name}")
    if not snap:
        return 0
    return sum(s["value"] for s in snap["series"].values())


def _submit_with_retry(router, ev, idx, tries=4):
    from ..inference.engine import Overloaded, QueueFull
    last = None
    for _ in range(tries):
        try:
            return router.submit(
                np.asarray(ev.prompt, np.int32), ev.max_new_tokens,
                client=f"sess-{ev.session}", tier=ev.tier)
        except (_faults.InjectedFault, Overloaded, QueueFull) as e:
            # router.admit drill / transient shed: the request was
            # REJECTED before acceptance (no contract attached) — retry
            # so the round's parity set stays complete
            last = e
            time.sleep(0.05)
    raise AssertionError(
        f"event {idx} never admitted after {tries} tries: {last!r}")


def run_sweep(sites=None, *, seed=0, model_spec=None, engine_kw=None,
              job_id="chaos", corrupt_disk=True, result_timeout=120.0,
              signal_timeout=30.0, log=None):
    """Boot a 2-process fleet + router, then for each site replay the
    seeded trace with that site's drill armed and assert the standing
    invariants.  Returns a report dict (per-site rows + totals).
    Raises AssertionError on any invariant violation."""
    from ..inference.fleet_serving import fenced_generation
    from ..inference.process_fleet import ProcessFleet
    from ..inference.router import Router

    log = log or (lambda *_: None)
    sites = list(sites) if sites is not None else list(DRILLS)
    unknown = [s for s in sites if s not in DRILLS]
    if unknown:
        raise ValueError(f"no drill for sites {unknown}")
    events = default_trace(seed)
    if not events:
        raise RuntimeError("empty trace")
    kw = dict(engine_kw or default_engine_kw())
    expected = reference_streams(events, model_spec, kw)
    log(f"[chaos] trace: {len(events)} events, "
        f"reference streams captured")

    def _warm(rep):
        for i, ev in enumerate(events):
            got = rep.submit(np.asarray(ev.prompt, np.int32),
                             max_new_tokens=ev.max_new_tokens
                             ).result(timeout=result_timeout)
            assert list(got) == expected[i], (
                f"warmup stream mismatch on {rep.name} event {i}: "
                f"{got} != {expected[i]}")

    disk_root = tempfile.mkdtemp(prefix="chaos_disk_")
    fleet = None
    try:
        fleet = ProcessFleet(
            dict(model_spec or {"preset": "tiny", "seed": 0}), n=2,
            job_id=job_id, lease_ttl=5.0,
            # durable store: the store.crash drill SIGKILLs it mid-trace
            # and restarts it from this snapshot+WAL directory
            store_dir=os.path.join(disk_root, "store"),
            fabric={"disk_root": disk_root, "timeout": 20.0,
                    "persist_sessions": True},
            canary_interval=SWEEP_CANARY_INTERVAL,
            watchdog_deadline=SWEEP_WATCHDOG_DEADLINE, **kw)
        # warm every replica through the trace's shapes BEFORE the
        # router starts health-polling: a replica's first runs of each
        # prefill width are not a hang the watchdog should judge
        log("[chaos] warming replicas (first runs of the trace's shapes)")
        for rep in fleet.replicas:
            _warm(rep)
        router = Router([], store=fleet.store, job_id=job_id,
                        poll_interval=0.25, policy="affinity")
    except BaseException:
        if fleet is not None:
            fleet.shutdown()
        shutil.rmtree(disk_root, ignore_errors=True)
        raise
    router.add_debug_section("respawn", fleet.respawn_state)
    for rep in fleet.replicas:
        router.add_replica(rep)

    report = {"sites": {}, "events": len(events)}
    try:
        for site in sites:
            drill = DRILLS[site]
            if drill.get("special"):
                log(f"[chaos] round {site!r}: HA drill")
                try:
                    report["sites"][site] = _SPECIAL_DRILLS[site](
                        fleet=fleet, router=router, events=events,
                        expected=expected, warm=_warm, job_id=job_id,
                        log=log, result_timeout=result_timeout,
                        signal_timeout=signal_timeout)
                finally:
                    _clear_all(fleet)
                # the drill's own routers shared the sweep's replicas:
                # the sweep's router still has two live, none fenced
                live = set(router.live_replica_names())
                fenced = [r.name for r in fleet.replicas if r.name in live
                          and fenced_generation(fleet.store, job_id, r.name)
                          >= r.lease.generation]
                assert len(live) >= 2 and not fenced, (
                    f"site {site!r} left the sweep's router with live "
                    f"{sorted(live)}, fenced {fenced}")
                log(f"[chaos] round {site!r}: PASS "
                    f"({len(events)} streams bitwise-identical)")
                continue
            base_sig = (_metric(router, drill["signal"])
                        if "signal" in drill else None)
            _arm(site, drill, fleet,
                 live=set(router.live_replica_names()))
            log(f"[chaos] round {site!r}: armed ({drill['where']})")

            rrs = [_submit_with_retry(router, ev, i)
                   for i, ev in enumerate(events)]
            bad = []
            for i, rr in enumerate(rrs):
                try:
                    got = router.result(rr, timeout=result_timeout)
                except BaseException as e:  # noqa: BLE001 — report below
                    bad.append((i, f"lost: {e!r}"))
                    continue
                if list(got) != expected[i]:
                    bad.append((i, f"corrupt stream: {got} != "
                                   f"{expected[i]}"))
            assert not bad, f"site {site!r} broke invariants: {bad}"

            if base_sig is not None:
                deadline = time.monotonic() + signal_timeout
                while (_metric(router, drill["signal"]) <= base_sig
                       and time.monotonic() < deadline):
                    time.sleep(0.1)
                moved = _metric(router, drill["signal"]) - base_sig
                assert moved > 0, (
                    f"site {site!r}: expected {drill['signal']} to "
                    f"move, still {base_sig}")

            _clear_all(fleet)
            # back to full strength after a lethal drill so every round
            # sees the same 2-replica fleet: the casualty's slot is
            # killed and respawned (module docstring)
            if drill.get("lethal"):
                deadline = time.monotonic() + signal_timeout
                # give the router one poll to notice the casualty
                while (len(router.live_replica_names()) >= 2
                       and time.monotonic() < deadline):
                    time.sleep(0.1)
                live = set(router.live_replica_names())
                for name in [r.name for r in fleet.replicas
                             if r.name not in live]:
                    _retire(fleet, router, name, _warm)
                deadline = time.monotonic() + signal_timeout
                while (len(router.live_replica_names()) < 2
                       and time.monotonic() < deadline):
                    time.sleep(0.1)
                assert len(router.live_replica_names()) >= 2, (
                    f"site {site!r}: fleet never recovered to 2 live "
                    f"replicas")
            if corrupt_disk:
                blocks_dir = os.path.join(disk_root, "blocks")
                if os.path.isdir(blocks_dir):
                    for fn in os.listdir(blocks_dir):
                        path = os.path.join(blocks_dir, fn)
                        if os.path.isfile(path) and os.path.getsize(path):
                            _faults.corrupt_bytes(path, n=1, seed=seed)
            report["sites"][site] = {
                "events": len(events), "lost": 0, "corrupt": 0,
                "signal": drill.get("signal"),
            }
            log(f"[chaos] round {site!r}: PASS "
                f"({len(events)} streams bitwise-identical)")
        report["ok"] = True
        return report
    finally:
        _clear_all(fleet)
        try:
            router.shutdown()
        finally:
            fleet.shutdown()
            shutil.rmtree(disk_root, ignore_errors=True)
