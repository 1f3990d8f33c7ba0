"""The port's `Router` over a port `LocalFleet`, held to the JAX suite's
router cases (tests/test_fleet_router.py, tests/test_slo_overload.py's
router tests, tests/test_observability_plane.py's router tests): the
`tiny` preset in fp32 with the JAX model's weights, the JAX suite's
engine knobs.  Every routed greedy stream equals the JAX engine's and
the port's own single engine's token for token (greedy streams hold no
tolerance): plain routing, a replica crash mid-decode, affinity against
round robin, a graceful drain, a router restart from its journal, a
falsely declared dead replica and a scale-up through the autoscale
hook.  Hand-driven stub replicas pin the interleavings a real engine
thread would race: the zombie's clean cancel, the shadow of a fenced
replica, the expired-deadline shed, the admit fault site and the tier
gauges.

No assertion waits on host scheduling: failover is triggered by fault
counts, a replica that must be mid-stream at some moment is wedged
there by a blocking callback on its `replica.crash` site (released by
the test), and every poll has a deadline of at least 10 x its
interval."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (AutoscalePolicy, DeadlineExceeded,
                                        EngineUnhealthy, LLMEngine,
                                        LocalFleet, Router, RoutingJournal)
from paddle_tpu_torch.inference.fleet_serving import (fenced_generation,
                                                      live_replicas)
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.observability.alerts import BurnRateRule
from paddle_tpu_torch.observability.fleet_series import tier_key
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.testing.faults import (InjectedConnectionError,
                                             InjectedFault)

# the JAX suite's engine knobs (tests/test_fleet_router.py:42)
KW = dict(max_slots=2, max_len=64, max_prompt_len=32, min_bucket=8,
          prefill_chunk=8)
# the replicas' background threads are not under test here
QUIET = dict(series_interval=None, watchdog_deadline=None)
WAIT = 120.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX tiny model, port tiny model with its weights)."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("tiny"))
    tm = TModel(TConfig.from_preset("tiny"), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture
def harness():
    inj = faults.get_injector()
    inj.clear()
    faults.ENABLED = True
    yield inj
    inj.clear()
    faults.ENABLED = False


def _prompts(n, seed=0, base=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (base + 3 * (i % 4),)) for i in range(n)]


def _ref(models, prompts, new, **kw):
    """The greedy streams of one JAX engine, held equal to one port
    engine's at the same knobs; returned as lists."""
    from paddle_tpu.inference import LLMEngine as JEngine
    jm, tm = models
    kw = dict(KW, **kw)
    theirs = [list(t) for t in JEngine(jm, **kw).generate(prompts, new)]
    mine = [list(t) for t in LLMEngine(tm, **kw).generate(prompts, new)]
    assert mine == theirs
    return mine


def _rv(router, name):
    return router.metrics()[f"router_{name}"]["series"][""]["value"]


def _fleet(models, n, **kw):
    return LocalFleet(models[1], n, lease_interval=0.05,
                      **dict(QUIET, **dict(KW, **kw)))


def _router(fleet, **kw):
    return Router(fleet.replicas, store=fleet.store, job_id=fleet.job_id,
                  **dict(dict(poll_interval=0.1), **kw))


def _wait(pred, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


class _Gate:
    """A blocking `replica.crash` callback: replica `name`'s driver
    wedges at its `at`-th real scheduler step until `release()` (other
    replicas and other steps pass)."""

    def __init__(self, name, at):
        self.name, self.at, self.n = name, at, 0
        self.reached = threading.Event()
        self.go = threading.Event()

    def __call__(self, ctx):
        if ctx.get("name") == self.name:
            self.n += 1
            if self.n == self.at:
                self.reached.set()
                self.go.wait(WAIT)

    def release(self):
        self.go.set()


# -- routing over real replicas ---------------------------------------------------


def test_router_basic_routing_parity_and_metrics(models):
    """No faults: the routed fleet gives the JAX engine's streams, the
    counters balance, the journal ends with nothing incomplete, and the
    /healthz JSON feeds the health poller over HTTP."""
    ps = _prompts(6, seed=42)
    ref = _ref(models, ps, 8)
    fleet = _fleet(models, 2, metrics_port=0)
    router = _router(fleet)
    try:
        reqs = [router.submit(p, max_new_tokens=8, client=f"c{i % 2}")
                for i, p in enumerate(ps)]
        assert [r.result(timeout=WAIT) for r in reqs] == ref
        assert _rv(router, "requests_accepted_total") == 6
        assert _rv(router, "requests_completed_total") == 6
        assert _rv(router, "requests_routed_total") == 6
        assert _rv(router, "failovers_total") == 0
        assert _rv(router, "tokens_delivered_total") == sum(map(len, ref))
        assert all(r.attempts == 1 for r in reqs)
        router.poll_once()
        assert router.live_replica_names() == ["replica0", "replica1"]
        assert not RoutingJournal.incomplete(router.journal_path)
        assert sorted(live_replicas(fleet.store, fleet.job_id)) == [
            "replica0", "replica1"]
        assert "router_requests_routed_total 6" in router.metrics_text()
    finally:
        router.shutdown()
        fleet.shutdown()


def test_replica_crash_mid_decode_zero_lost_bitwise(models, harness):
    """replica0 is killed at its 8th scheduler step: every accepted
    request completes with the JAX engine's stream, delivered tokens are
    deduped rather than re-sent, and the dead lease is fenced."""
    ps = _prompts(8, seed=0)
    ref = _ref(models, ps, 12)
    steps = {"n": 0}

    def kill_replica0(ctx):
        if ctx.get("name") == "replica0":
            steps["n"] += 1
            if steps["n"] == 8:
                return InjectedFault

    harness.inject("replica.crash", times=None, exc=None,
                   callback=kill_replica0)
    fleet = _fleet(models, 2)
    router = _router(fleet)
    try:
        streamed = {}
        reqs = [router.submit(
            p, max_new_tokens=12,
            on_token=lambda rr, t: streamed.setdefault(rr.rid, []).append(t))
            for p in ps]
        assert [r.result(timeout=WAIT) for r in reqs] == ref
        assert [streamed[r.rid] for r in reqs] == ref
        assert _rv(router, "failovers_total") == 1
        assert _rv(router, "requests_resubmitted_total") >= 1
        assert _rv(router, "requests_completed_total") == len(ps)
        assert _rv(router, "replay_mismatch_total") == 0
        assert _rv(router, "tokens_deduped_total") >= 1
        assert _rv(router, "tokens_delivered_total") == sum(map(len, ref))
        assert max(r.attempts for r in reqs) >= 2
        assert fenced_generation(fleet.store, fleet.job_id, "replica0") >= 1
        assert "replica0" not in live_replicas(fleet.store, fleet.job_id)
        assert router.live_replica_names() == ["replica1"]
        assert not RoutingJournal.incomplete(router.journal_path)
    finally:
        router.shutdown()
        fleet.shutdown()


def test_prefix_affinity_beats_round_robin(models):
    """A shared-system-prompt stream: affinity lands repeats on the
    replica holding the prefix and saves strictly more prefill tokens
    than round robin, with its hit rate exported; the streams are the
    same under both policies and equal the JAX engine's."""
    ckw = dict(max_len=128, max_prompt_len=96, prefill_chunk=16,
               prefix_cache_blocks=16, prefix_block_tokens=16)
    rng = np.random.RandomState(0)
    sys_a, sys_b = rng.randint(0, 256, (64,)), rng.randint(0, 256, (64,))
    sfx = np.random.RandomState(1)
    seeds = [np.concatenate([sp, sfx.randint(0, 256, (4,))])
             for sp in (sys_a, sys_b)]
    mains = [np.concatenate([sp, sfx.randint(0, 256, (4,))])
             for sp in [sys_a, sys_a, sys_b, sys_b] * 2]
    ref = _ref(models, seeds + mains, 2, **ckw)

    def run(policy):
        fleet = _fleet(models, 2, **ckw)
        router = _router(fleet, policy=policy, poll_interval=0.2)
        try:
            out = [router.submit(p, max_new_tokens=2).result(timeout=WAIT)
                   for p in seeds]
            reqs = [router.submit(p, max_new_tokens=2) for p in mains]
            out += [r.result(timeout=WAIT) for r in reqs]
            saved = sum(rep.server.engine._pcache.tokens_saved
                        for rep in fleet.replicas)
            return out, saved, _rv(router, "affinity_hit_rate")
        finally:
            router.shutdown()
            fleet.shutdown()

    aff, aff_saved, aff_rate = run("affinity")
    rr, rr_saved, _ = run("round_robin")
    assert aff == rr == ref
    assert aff_saved > rr_saved, (aff_saved, rr_saved)
    assert aff_rate >= 0.5


def test_graceful_drain_scales_down_without_failover(models):
    """drain(): in-flight work on the draining replica finishes with the
    reference streams, nothing fails over, the lease is released, and
    new traffic lands on the survivor."""
    ps = _prompts(6, seed=43)
    ref = _ref(models, ps, 8)
    fleet = _fleet(models, 2)
    router = _router(fleet)
    try:
        reqs = [router.submit(p, max_new_tokens=8) for p in ps]
        assert router.drain("replica0", timeout=WAIT)
        assert [r.result(timeout=WAIT) for r in reqs] == ref
        assert _rv(router, "failovers_total") == 0
        assert _rv(router, "replicas_drained_total") == 1
        assert router.live_replica_names() == ["replica1"]
        assert "replica0" not in live_replicas(fleet.store, fleet.job_id)
        tail = router.submit(ps[0], max_new_tokens=8)
        assert tail.result(timeout=WAIT) == ref[0]
        assert tail.replica == "replica1" and tail.attempts == 1
        with pytest.raises(KeyError):
            router.drain("replica0")
    finally:
        router.shutdown()
        fleet.shutdown()


def test_router_restart_recovers_journal_exactly_once(models, tmp_path,
                                                      harness):
    """The router dies mid-stream (replica0 wedged at its 6th step, so
    both requests are unfinished at the kill): a successor replays the
    journal, resubmits both with prompt replay and dedupes the
    delivered prefix — each client stream is the reference, once."""
    ps = [_prompts(1, seed=44, base=5)[0], _prompts(1, seed=45, base=9)[0]]
    ref = _ref(models, ps, 24, max_slots=1)
    gate = _Gate("replica0", 6)
    harness.inject("replica.crash", times=None, exc=None, callback=gate)
    fleet = _fleet(models, 1, max_slots=1)
    j1 = str(tmp_path / "r1.jsonl")
    router1 = Router(fleet.replicas, store=fleet.store,
                     job_id=fleet.job_id, journal_path=j1, poll_interval=0.2)
    router2 = None
    try:
        got1 = []
        r1 = router1.submit(ps[0], max_new_tokens=24,
                            on_token=lambda rr, t: got1.append(t))
        r2 = router1.submit(ps[1], max_new_tokens=24)   # behind r1
        assert gate.reached.wait(WAIT)
        assert 1 <= len(got1) < 24 and not r2.tokens
        router1.shutdown()                   # abrupt router death
        for r in (r1, r2):
            with pytest.raises(EngineUnhealthy):
                r.result(timeout=1)
        gate.release()
        inc = RoutingJournal.incomplete(j1)
        assert len(inc) == 2
        router2 = Router(fleet.replicas, store=fleet.store,
                         job_id=fleet.job_id,
                         journal_path=str(tmp_path / "r2.jsonl"),
                         poll_interval=0.2)
        recovered = router2.resubmit_incomplete(j1)
        assert set(recovered) == set(inc)
        by_prompt = {tuple(p): t for p, t in zip(ps, ref)}
        pre_seeded = 0
        for old_rid, rr in recovered.items():
            assert rr.result(timeout=WAIT) == by_prompt[tuple(
                rr.prompt.tolist())]
            pre_seeded += len(inc[old_rid]["delivered"])
        assert pre_seeded == len(got1)
        assert _rv(router2, "tokens_deduped_total") == pre_seeded
        assert _rv(router2, "replay_mismatch_total") == 0
        assert _rv(router2, "requests_resubmitted_total") == 2
        assert _rv(router2, "tokens_delivered_total") == \
            sum(len(rr.tokens) for rr in recovered.values()) - pre_seeded
        assert not RoutingJournal.incomplete(router2.journal_path)
    finally:
        gate.release()
        router1.shutdown()
        if router2 is not None:
            router2.shutdown()
        fleet.shutdown()


def test_false_dead_replica_failover_end_to_end(models, harness):
    """replica0 is declared dead on a probe blip while it is wedged
    mid-stream (its 5th step): its cancelled attempts complete cleanly
    on a healthy replica and are replayed on the survivor; every stream
    still equals the reference, with no truncation and no duplicate."""
    ps = _prompts(6, seed=48)
    ref = _ref(models, ps, 12)
    gate = _Gate("replica0", 5)
    harness.inject("replica.crash", times=None, exc=None, callback=gate)
    fleet = _fleet(models, 2)
    router = _router(fleet)
    try:
        streamed = {}
        reqs = [router.submit(
            p, max_new_tokens=12,
            on_token=lambda rr, t: streamed.setdefault(rr.rid, []).append(t))
            for p in ps]
        assert gate.reached.wait(WAIT)
        assert any(r.replica == "replica0" and r.tokens and not r.done
                   for r in reqs)
        router._fail_replica("replica0", ConnectionError("probe blip"))
        gate.release()
        assert [r.result(timeout=WAIT) for r in reqs] == ref
        assert [streamed[r.rid] for r in reqs] == ref
        assert _rv(router, "failovers_total") == 1
        assert _rv(router, "replay_mismatch_total") == 0
        assert _rv(router, "tokens_deduped_total") >= 1
        assert fleet.replicas[0].server.healthy      # the zombie case
        assert not RoutingJournal.incomplete(router.journal_path)
    finally:
        gate.release()
        router.shutdown()
        fleet.shutdown()


def test_dispatch_fault_is_retried_not_fenced(models, harness):
    """Two injected connection errors at `router.dispatch` are retried
    (the request completes, nothing fails over); a third in a row
    declares the replica dead."""
    ps = _prompts(2, seed=46)
    ref = _ref(models, ps, 6)
    fleet = _fleet(models, 1)
    router = _router(fleet, poll_interval=0.2)
    try:
        rule = harness.inject("router.dispatch",
                              exc=InjectedConnectionError, times=2)
        req = router.submit(ps[0], max_new_tokens=6)
        assert req.result(timeout=WAIT) == ref[0]
        assert rule.fired == 2
        assert _rv(router, "dispatch_errors_total") == 2
        assert _rv(router, "failovers_total") == 0
        assert _rv(router, "requests_routed_total") == 1
        harness.inject("router.dispatch", exc=InjectedConnectionError,
                       times=3)
        doomed = router.submit(ps[1], max_new_tokens=6)
        _wait(lambda: _rv(router, "failovers_total") == 1,
              "the third dispatch error fails the replica over")
        # the router meters the failover before it writes the fence to
        # the store (both packages): wait for the fence itself
        _wait(lambda: fenced_generation(fleet.store, fleet.job_id,
                                        "replica0") == 1,
              "the third dispatch error fences the replica in the store")
        assert router.live_replica_names() == []
        assert _rv(router, "failovers_total") == 1
        assert not doomed.done          # accepted work waits, never dropped
    finally:
        router.shutdown()
        fleet.shutdown()


def test_autoscale_hook_fires_and_scale_up_attaches(models, harness):
    """A deep backlog on one single-slot replica (wedged at its 2nd step
    while the health poller runs) drives the autoscale signal to +1;
    acting on it with LocalFleet.spawn + add_replica absorbs the
    backlog with the reference streams."""
    ps = _prompts(6, seed=47)
    ref = _ref(models, ps, 8, max_slots=1)
    gate = _Gate("replica0", 2)
    harness.inject("replica.crash", times=None, exc=None, callback=gate)
    fleet = _fleet(models, 1, max_slots=1)
    calls = []
    router = _router(fleet, poll_interval=0.05,
                     autoscale=lambda rec, sig: calls.append((rec, sig)),
                     autoscale_policy=AutoscalePolicy(queue_high=2))
    try:
        reqs = [router.submit(p, max_new_tokens=8) for p in ps]
        assert gate.reached.wait(WAIT)
        _wait(lambda: calls, "an autoscale recommendation")
        rec, sig = calls[0]
        assert rec == +1
        assert sig["queue_depth"] + sig["replica_queue_depth"] >= 2
        assert sig["replicas"] == 1 and "tier_queue_depth" in sig
        router.add_replica(fleet.spawn())
        gate.release()
        assert [r.result(timeout=WAIT) for r in reqs] == ref
        assert router.live_replica_names() == ["replica0", "replica1"]
    finally:
        gate.release()
        router.shutdown()
        fleet.shutdown()


# -- hand-driven stub replicas ------------------------------------------------------


class _StubInner:
    def __init__(self, on_token, on_done):
        self.error = None
        self.on_token = on_token
        self.on_done = on_done
        self.cancelled = False

    def cancel(self):
        self.cancelled = True


class _StubReplica:
    """The test fires the router's callbacks itself, so interleavings
    that race against real engine threads become deterministic."""

    block_tokens = 0

    def __init__(self, name):
        self.name = name
        self.inners = []
        self.kw = []

    def submit(self, prompt, max_new_tokens, on_token=None, on_done=None,
               **kw):
        inner = _StubInner(on_token, on_done)
        self.inners.append(inner)
        self.kw.append(kw)
        return inner

    def health(self):
        return {"status": "ok", "queue_depth": 0}


def test_zombie_replica_clean_cancel_cannot_truncate_stream():
    """A replica falsely declared dead has its attempt cancelled, and the
    cancellation completes CLEANLY before any re-dispatch: the
    detach-time epoch fence drops that on_done (and a straggler token),
    and the replay on a new replica finishes the stream exactly once."""
    stub0 = _StubReplica("stub0")
    router = Router([stub0], poll_interval=0.05)
    got = []
    try:
        rr = router.submit([1, 2, 3], max_new_tokens=3,
                           on_token=lambda _r, t: got.append(t))
        _wait(lambda: stub0.inners, "the first dispatch")
        a1 = stub0.inners[0]
        a1.on_token(a1, 11)
        a1.on_token(a1, 12)
        router._fail_replica("stub0", ConnectionError("health blip"))
        assert a1.cancelled
        a1.on_done(a1)
        a1.on_token(a1, 99)
        assert not rr.done and rr.tokens == [11, 12]
        stub1 = _StubReplica("stub1")
        router.add_replica(stub1)
        _wait(lambda: stub1.inners, "the replay's dispatch")
        a2 = stub1.inners[0]
        for t in (11, 12, 13):
            a2.on_token(a2, t)
        a2.on_done(a2)
        assert rr.result(timeout=30) == [11, 12, 13]
        assert got == [11, 12, 13]
        assert rr.attempts == 2
        assert _rv(router, "failovers_total") == 1
        assert _rv(router, "tokens_deduped_total") == 2
        assert _rv(router, "replay_mismatch_total") == 0
        with open(router.journal_path) as f:
            toks = [rec["t"] for rec in map(json.loads, f)
                    if rec["ev"] == "tok"]
        assert toks == [11, 12, 13]
        assert not RoutingJournal.incomplete(router.journal_path)
    finally:
        router.shutdown()


def test_replay_mismatch_is_counted_not_delivered():
    """A replay that disagrees at a delivered position is counted in
    replay_mismatch_total and the client keeps its first stream."""
    stub0, stub1 = _StubReplica("stub0"), _StubReplica("stub1")
    router = Router([stub0], poll_interval=0.05)
    try:
        rr = router.submit([1, 2], max_new_tokens=2)
        _wait(lambda: stub0.inners, "the first dispatch")
        a1 = stub0.inners[0]
        a1.on_token(a1, 5)
        router._fail_replica("stub0", ConnectionError("dead"))
        router.add_replica(stub1)
        _wait(lambda: stub1.inners, "the replay")
        a2 = stub1.inners[0]
        a2.on_token(a2, 6)
        a2.on_token(a2, 7)
        a2.on_done(a2)
        assert rr.result(timeout=30) == [5, 7]
        assert _rv(router, "replay_mismatch_total") == 1
    finally:
        router.shutdown()


def test_a_waiting_suspect_takes_no_strike_for_a_crash_it_never_saw():
    """Two requests in flight on stub0 when it is fenced: one strike
    each.  The first to replay goes alone to stub1 (probation) while the
    other waits at the front of the queue; the first crashes stub1 too
    (its second strike: convicted).  The router marks stub1 dead in the
    same critical section as that strike, so the waiting suspect is
    never handed the corpse and keeps one strike: one conviction.  (With
    stub1 marked dead only after the lock was released, the dispatcher
    gave it the waiting suspect within the window held open below, and
    the fence convicted an innocent request as well.)"""
    s0, s1, s2 = (_StubReplica(n) for n in ("stub0", "stub1", "stub2"))
    router = Router([s0], poll_interval=0.05, policy="least_loaded",
                    poison_threshold=2)
    try:
        reqs = [router.submit([1, 2], max_new_tokens=2),
                router.submit([3, 4], max_new_tokens=2)]
        _wait(lambda: len(s0.inners) == 2, "both dispatches to stub0")
        router._fail_replica("stub0", ConnectionError("dead"))
        assert [r.poison_strikes for r in reqs] == [1, 1]
        router.add_replica(s1)
        _wait(lambda: len(s1.inners) == 1, "one suspect on stub1")
        on_s1 = router._replicas["stub1"].probing_rid
        first, waiting = sorted(reqs, key=lambda r: r.rid != on_s1)
        assert first.rid == on_s1 and not waiting.done

        # hold the window between the crash's strike and the fence open:
        # the failover record waits (at most 1 s) for a second dispatch
        # to stub1
        second_on_s1 = threading.Event()
        submit = s1.submit

        def s1_submit(*a, **kw):
            inner = submit(*a, **kw)
            second_on_s1.set()
            return inner
        s1.submit = s1_submit
        record = router._journal.record

        def held_record(ev, rid, **fields):
            if (ev == "failover" and rid == first.rid
                    and fields.get("replica") == "stub1"):
                second_on_s1.wait(1.0)
            return record(ev, rid, **fields)
        router._journal.record = held_record

        crashed = s1.inners[0]
        crashed.error = EngineUnhealthy("stub1's driver died")
        crashed.on_done(crashed)
        assert first.done and first.poison_strikes == 2
        assert _rv(router, "poisoned_total") == 1
        assert not second_on_s1.is_set() and len(s1.inners) == 1
        assert waiting.poison_strikes == 1 and not waiting.done
        # the waiting request still completes, on the next replica
        router.add_replica(s2)
        _wait(lambda: s2.inners, "the waiting suspect's replay")
        a = s2.inners[0]
        for t in (7, 8):
            a.on_token(a, t)
        a.on_done(a)
        assert waiting.result(timeout=30) == [7, 8]
        assert _rv(router, "poisoned_total") == 1
    finally:
        router.shutdown()


def test_fail_replica_evicts_its_prefix_shadow():
    stub = _StubReplica("stub0")
    stub.block_tokens = 4
    stub.cache_blocks = 8
    router = Router([stub], poll_interval=0.05)
    try:
        st = router._replicas["stub0"]
        st.shadow.observe(np.arange(12))
        assert st.shadow.match_tokens(np.arange(12)) == 8
        router._fail_replica("stub0", ConnectionError("dead"))
        assert st.dead and len(st.shadow) == 0
        assert st.shadow.match_tokens(np.arange(12)) == 0
    finally:
        router.shutdown()


def test_router_epoch_rides_every_dispatch():
    """router_epoch set on the router is carried on each dispatch; none
    is sent while it is None."""
    stub = _StubReplica("s0")
    router = Router([stub], poll_interval=0.05)
    try:
        router.submit([1], 1)
        _wait(lambda: len(stub.kw) == 1, "the first dispatch")
        router.router_epoch = 5
        router.submit([2], 1)
        _wait(lambda: len(stub.kw) == 2, "the second dispatch")
        assert "router_epoch" not in stub.kw[0]
        assert stub.kw[1]["router_epoch"] == 5
        assert router.debug_fleet()["router_epoch"] == 5
    finally:
        router.shutdown()


def test_router_sheds_expired_before_dispatch():
    """A request whose deadline lapses while queued is failed with
    DeadlineExceeded at dispatch, before it reaches a replica."""
    stub = _StubReplica("s0")
    router = Router([stub], poll_interval=0.05)
    try:
        router._replicas["s0"].draining = True
        rr = router.submit([1, 2, 3], max_new_tokens=4, deadline=0.05)
        time.sleep(0.15)
        router._replicas["s0"].draining = False
        with pytest.raises(DeadlineExceeded):
            rr.result(timeout=10)
        assert not stub.inners
        assert _rv(router, "requests_expired_total") == 1
    finally:
        router.shutdown()


def test_router_admit_fault_site(harness):
    """router.admit rejects at the door: no journal record, no queue
    entry, no accepted count; the next submit goes through."""
    stub = _StubReplica("s0")
    router = Router([stub], poll_interval=0.05)
    try:
        harness.inject("router.admit", times=1)
        with pytest.raises(InjectedFault):
            router.submit([1, 2, 3], max_new_tokens=4, tier="batch")
        assert len(router._queue) == 0
        assert _rv(router, "requests_accepted_total") == 0
        assert not RoutingJournal.replay(router.journal_path)
        rr = router.submit([1, 2, 3], max_new_tokens=4)
        _wait(lambda: stub.inners, "the dispatch")
        stub.inners[0].on_done(stub.inners[0])
        assert rr.result(timeout=10) == []
    finally:
        router.shutdown()


def _hold_dispatcher(harness):
    """Wedge the router's dispatch thread at its next `router.dispatch`
    site (after its pop) until the returned event is set: the queue
    then holds exactly what the test submits."""
    entered, go = threading.Event(), threading.Event()

    def hold(ctx):
        entered.set()
        go.wait(WAIT)
    harness.inject("router.dispatch", times=1, exc=None, callback=hold)
    return entered, go


def test_router_tier_queue_gauges_and_signal(harness):
    stub = _StubReplica("s0")
    router = Router([stub], poll_interval=5.0)
    entered, go = _hold_dispatcher(harness)
    try:
        router.submit([1], 4)
        assert entered.wait(WAIT)
        router.submit([1], 4, tier="interactive")
        router.submit([1], 4, tier="batch")
        router.submit([1], 4, tier="batch")
        sig = router.autoscale_signal()
        assert sig["tier_queue_depth"] == {"interactive": 1,
                                           "standard": 0, "batch": 2}
        assert sig["queue_depth"] == 3
        series = router.metrics()["router_tier_queue_depth"]["series"]
        assert series["tier=batch"]["value"] == 2
        assert series["tier=interactive"]["value"] == 1
    finally:
        go.set()
        router.shutdown()


def test_router_rejects_at_its_bound_and_after_shutdown(harness):
    from paddle_tpu_torch.inference import QueueFull
    stub = _StubReplica("s0")
    router = Router([stub], max_queue=1, poll_interval=5.0)
    entered, go = _hold_dispatcher(harness)
    try:
        router.submit([1], 1)
        assert entered.wait(WAIT)
        router.submit([2], 1)
        with pytest.raises(QueueFull):
            router.submit([3], 1)
        assert _rv(router, "requests_rejected_total") == 1
        assert _rv(router, "requests_accepted_total") == 2
        go.set()
        _wait(lambda: len(stub.inners) == 2, "both accepted dispatches")
    finally:
        go.set()
        router.shutdown()
    with pytest.raises(RuntimeError):
        router.submit([3], 1)
    with pytest.raises(ValueError):
        Router([], policy="random")


# -- the observability plane ------------------------------------------------------------


def test_router_autoscale_signal_prefers_windowed_series():
    r = Router(replicas=(), poll_interval=0.05, alert_rules=())
    try:
        now = time.time()
        assert r.autoscale_signal()["windowed"] is False
        met = tier_key("slo_met_total", "interactive")
        missed = tier_key("slo_missed_total", "interactive")
        r.fleet_aggregator.ingest("r0", {
            "t": now, "seq": 1, "interval_s": 1.0,
            "series": {
                "llm_engine_occupancy": [[now - 1.0, 0.5]],
                "llm_engine_ttft_seconds:p50": [[now - 1.0, 0.123]],
                met: [[now - 1.0, 9.0]],
                missed: [[now - 1.0, 1.0]],
            }}, now=now)
        sig = r.autoscale_signal()
        assert sig["windowed"] is True
        assert sig["occupancy"] == pytest.approx(0.5)
        assert sig["ttft_p50_s"] == pytest.approx(0.123)
        assert sig["goodput"]["interactive"] == pytest.approx(0.9)
    finally:
        r.shutdown()


def test_router_observe_once_evaluates_alerts_and_debug_http():
    """observe_once fires a burn-rate rule deterministically, and the
    /debug/fleet endpoint serves the document (and /metrics the
    router's text) over HTTP."""
    rule = BurnRateRule("burn", "interactive", target=0.5,
                        fast_window_s=60.0, slow_window_s=60.0,
                        fast_burn=1.0, slow_burn=1.0, fire_after=2,
                        resolve_after=2)
    r = Router(replicas=(), poll_interval=0.05, alert_rules=[rule],
               debug_port=0)
    try:
        now = time.time()
        met = tier_key("slo_met_total", "interactive")
        missed = tier_key("slo_missed_total", "interactive")
        r.fleet_aggregator.ingest("r0", {
            "t": now, "seq": 1, "interval_s": 1.0,
            "series": {met: [[now - 1.0, 0.0]],
                       missed: [[now - 1.0, 10.0]]}}, now=now)
        r.observe_once()
        r.observe_once()
        firing = r.alerts()
        assert firing and firing[0]["name"] == "burn"
        assert firing[0]["burn_fast"] >= 1.0
        doc = r.debug_fleet()
        assert doc["alerts"]["firing"]
        assert doc["replicas"]["r0"]["series"]["series"]
        r.add_debug_section("extra", lambda: {"k": 1})
        host, port = r.debug_address
        with urllib.request.urlopen(
                f"http://{host}:{port}/debug/fleet", timeout=30) as resp:
            got = json.loads(resp.read().decode())
        assert set(got) >= {"t", "job_id", "window_s", "replicas", "pools",
                            "tiers", "burn_rates", "alerts",
                            "autoscale_signal", "queue_depth",
                            "router_epoch", "poison_threshold", "extra"}
        assert got["extra"] == {"k": 1}
        with urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=30) as resp:
            assert b"router_alerts_fired_total 1" in resp.read()
    finally:
        r.shutdown()
