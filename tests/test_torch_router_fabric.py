"""The port's `Router` over replicas with the KV fabric and the server's
router surface, held to the JAX suite's cases
(tests/test_kv_fabric.py:399, tests/test_fleet_immune.py:147 and the
watchdog failover, tests/test_disagg_serving.py:124's tp = 1 cells
driven by the Router, tests/test_control_plane_ha.py:362 and :401) at
the `tiny` preset with the JAX model's weights:

  * drain() peer-takes a parked session onto a survivor: the continued
    stream equals the uninterrupted one, with no replay and no failover;
  * a quarantined replica's parked session migrates the same way, its
    lease is left unfenced and its status reads "quarantined", and the
    router retires it once idle;
  * a wedged step (a blocking `engine.stall` callback, released by the
    test) trips the watchdog and the router fails the request over;
  * the Router drives the prefill -> decode handoff over a "prefill"
    and a "decode" replica: every stream equals the colocated engine's
    (fp32: the JAX engine's), one handoff a request;
  * `submit(router_epoch=)` rejects a lower epoch with
    `StaleRouterEpoch`; a `chaos_mark` request is convicted
    (`PoisonedRequest`) while its co-batched innocents are replayed to
    their reference streams;
  * a driver that crashes with a step in flight (overlap on) commits it
    first: the failed requests hold the tokens the synchronous driver
    gives at the same step.

Greedy streams hold no tolerance.  No assertion waits on host
scheduling: parks are frozen at the first park by a hook on the driver
thread, stalls and crashes come from fault rules, and every poll has a
deadline of at least 10 x its interval."""

import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (EngineUnhealthy, LLMEngine,
                                        LLMServer, LocalFleet,
                                        PoisonedRequest, Router,
                                        StaleRouterEpoch)
from paddle_tpu_torch.inference.fleet_serving import (fenced_generation,
                                                      replica_status)
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.testing.faults import InjectedFault

KW = dict(max_slots=2, max_len=64, max_prompt_len=32, min_bucket=8,
          prefill_chunk=8)
# tests/test_kv_fabric.py:45: two streams oversubscribe the pool, so the
# second parks mid-decode
MIG_KW = dict(KW, kv_block_tokens=8, kv_blocks=9, preempt_policy="swap")
# tests/test_disagg_serving.py:37
HO_KW = dict(KW, kv_block_tokens=8, kv_blocks=12, preempt_policy="swap")
P_LONG = (np.arange(3, 3 + 9) % 50).astype(np.int32)
P_MIG = (np.arange(7, 7 + 9) % 50).astype(np.int32)
P_HAND = (np.arange(11, 11 + 17) % 50).astype(np.int32)
P_REP = np.array([5, 6, 7] * 6, dtype=np.int32)
QUIET = dict(series_interval=None, watchdog_deadline=None)
WAIT = 120.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(dtype, seed):
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(seed)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("tiny", dtype=dtype))
    tm = TModel(TConfig.from_preset("tiny", dtype=dtype), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return {"float32": _pair("float32", 0), "bfloat16": _pair("bfloat16", 1)}


@pytest.fixture
def harness():
    inj = faults.get_injector()
    inj.clear()
    faults.ENABLED = True
    yield inj
    inj.clear()
    faults.ENABLED = False


def _rv(router, name):
    return router.metrics()[f"router_{name}"]["series"][""]["value"]


def _wait(pred, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


def _jax_streams(jm, prompts, new, kw, **req):
    from paddle_tpu.inference import LLMEngine as JEngine
    eng = JEngine(jm, **kw)
    reqs = [eng.submit(p, max_new_tokens=new, **req) for p in prompts]
    eng.run()
    return [list(r.tokens) for r in reqs]


def _migration_refs(models):
    """The uninterrupted streams of the oversubscribing pair (P_LONG x
    55, then P_MIG x 24 at seed 5) on one port engine with full
    provisioning, held equal to the JAX engine's under pressure."""
    jm, tm = models["float32"]
    eng = LLMEngine(tm, **dict(MIG_KW, kv_blocks=None))
    r1 = eng.submit(P_LONG, 55)
    r2 = eng.submit(P_MIG, 24, seed=5)
    eng.run()
    ref = [list(r1.tokens), list(r2.tokens)]
    jax = _jax_streams(jm, [P_LONG], 55, MIG_KW)
    jax += _jax_streams(jm, [P_MIG], 24, MIG_KW, seed=5)
    assert ref == jax
    return ref


def _freeze_at_first_park(eng):
    """Freeze `eng`'s parks (no resume) on the driver thread the moment
    its first park lands, so the session stays parked until moved."""
    park = eng._park_slot

    def parked(slot, mode=None):
        park(slot, mode)
        eng.freeze_parked = True
    eng._park_slot = parked


def _parked_pair(router):
    q1 = router.submit(P_LONG, max_new_tokens=55)
    q2 = router.submit(P_MIG, max_new_tokens=24, seed=5, priority=-1)
    return q1, q2


# -- drain and quarantine migrate parked sessions ------------------------------------


def test_router_drain_migrates_parked_session(models, tmp_path):
    ref = _migration_refs(models)
    fleet = LocalFleet(models["float32"][1], 2, lease_interval=0.05,
                       fabric={"disk_root": str(tmp_path), "timeout": 10.0},
                       **QUIET, **MIG_KW)
    router = Router(fleet.replicas[:1], store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.1)
    try:
        eng0 = fleet.replicas[0].server.engine
        _freeze_at_first_park(eng0)
        q1, q2 = _parked_pair(router)
        _wait(lambda: eng0.freeze_parked and eng0.num_parked == 1,
              "the park on replica0")
        router.add_replica(fleet.replicas[1])
        assert router.drain("replica0", timeout=WAIT)
        assert q1.result(timeout=WAIT) == ref[0]
        assert q2.result(timeout=WAIT) == ref[1]
        assert q2.replica == "replica1" and q1.replica == "replica0"
        assert router.live_replica_names() == ["replica1"]
        assert _rv(router, "migrations_total") == 1
        assert _rv(router, "requests_replayed_total") == 0
        assert _rv(router, "failovers_total") == 0
        assert _rv(router, "replay_mismatch_total") == 0
        assert _rv(router, "tokens_deduped_total") >= 1
    finally:
        router.shutdown()
        fleet.shutdown()


def test_router_quarantine_migrates_parked_and_retires(models, tmp_path):
    ref = _migration_refs(models)
    fleet = LocalFleet(models["float32"][1], 2, lease_interval=0.05,
                       fabric={"disk_root": str(tmp_path), "timeout": 10.0},
                       **QUIET, **MIG_KW)
    router = Router(fleet.replicas[:1], store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.1)
    try:
        srv0 = fleet.replicas[0].server
        _freeze_at_first_park(srv0.engine)
        q1, q2 = _parked_pair(router)
        _wait(lambda: srv0.engine.num_parked == 1, "the park on replica0")
        srv0.quarantine("canary drill")
        router.add_replica(fleet.replicas[1])
        _wait(lambda: _rv(router, "quarantines_total") >= 1,
              "the router to observe the quarantine")
        assert "replica0" not in router.live_replica_names()
        assert q1.result(timeout=WAIT) == ref[0]
        assert q2.result(timeout=WAIT) == ref[1]
        assert _rv(router, "migrations_total") == 1
        assert _rv(router, "requests_replayed_total") == 0
        assert _rv(router, "failovers_total") == 0
        assert replica_status(fleet.store, fleet.job_id,
                              "replica0") == "quarantined"
        assert fenced_generation(fleet.store, fleet.job_id,
                                 "replica0") == 0
        # the retire pops the replica, then releases its lease and counts
        _wait(lambda: "replica0" not in router._replicas
              and _rv(router, "replicas_drained_total") == 1,
              "the quarantined replica retired once idle")
        sig = router.autoscale_signal()
        assert sig["quarantined"] == 0 and "watchdog_failovers" in sig
    finally:
        router.shutdown()
        fleet.shutdown()


def test_watchdog_trips_and_router_fails_over(models, harness):
    """replica0's step is wedged by a blocking `engine.stall` callback
    past its 0.4 s watchdog deadline: the poller sees `stalled`, fences
    it, and the request is replayed on replica1 with the reference
    stream; the wedge is released after the failover."""
    jm, tm = models["float32"]
    ref = _jax_streams(jm, [P_MIG], 8, KW)
    go, hits = threading.Event(), []

    def wedge(ctx):
        if ctx.get("name") == "replica0" and not hits:
            hits.append(ctx)
            go.wait(WAIT)
    harness.inject("engine.stall", times=None, exc=None, callback=wedge)
    fleet = LocalFleet(tm, 2, lease_interval=0.05, series_interval=None,
                       watchdog_deadline=0.4, **KW)
    router = Router(fleet.replicas, store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.1)
    try:
        rr = router.submit(P_MIG, max_new_tokens=8)
        _wait(lambda: _rv(router, "watchdog_failovers_total") >= 1,
              "the watchdog trip")
        go.set()
        assert rr.result(timeout=WAIT) == ref[0]
        assert _rv(router, "failovers_total") == 1
        assert router.live_replica_names() == ["replica1"]
        assert rr.replica == "replica1" and rr.attempts == 2
        assert fleet.replicas[0].server.health_snapshot()[
            "watchdog_stalls"] >= 1
    finally:
        go.set()
        router.shutdown()
        fleet.shutdown()


# -- the Router drives the prefill -> decode handoff ----------------------------------


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("spec", [None, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_handoff_equals_colocated(models, dtype, spec, kv):
    """Fresh prompts land on the "prefill" replica, each dispatch names
    the "decode" replica as its handoff target, and the staged ticket
    is adopted there: every stream equals the colocated engine's (in
    fp32 the JAX engine's too), one handoff a request, no replay."""
    jm, tm = models[dtype]
    kw = dict(HO_KW, kv_dtype=kv, speculation=spec)
    prompts = [P_HAND, P_REP]
    ref = [list(t) for t in LLMEngine(tm, **kw).generate(prompts, 12)]
    if dtype == "float32":
        assert ref == _jax_streams(jm, prompts, 12, kw)
    fleet = LocalFleet(tm, 2, roles=("prefill", "decode"),
                       lease_interval=0.05, fabric={"timeout": 10.0},
                       **QUIET, **kw)
    router = Router(fleet.replicas, store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.25)
    try:
        reqs = [router.submit(p, max_new_tokens=12, tier="interactive")
                for p in prompts]
        assert [r.result(timeout=WAIT) for r in reqs] == ref
        assert _rv(router, "handoffs_total") == len(prompts)
        assert _rv(router, "requests_replayed_total") == 0
        assert _rv(router, "replay_mismatch_total") == 0
        assert all(r.replica == "replica1" for r in reqs)
        dbg = router.debug_fleet()
        assert dbg["pools"] == {"prefill": ["replica0"],
                                "decode": ["replica1"]}
        sig = router.autoscale_signal()
        assert sig["pools"]["prefill"]["replicas"] == 1
        assert sig["pools"]["decode"]["replicas"] == 1
        fab = fleet.replicas[0].server.health_snapshot()["fabric"]
        assert fab["handoff_chunks"] >= 2
    finally:
        router.shutdown()
        fleet.shutdown()


# -- router epochs and poison -----------------------------------------------------------


def _prompts(n, seed=0, base=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (base + 3 * (i % 4),)) for i in range(n)]


def test_stale_router_epoch_rejected_by_replica(models):
    tm = models["float32"][1]
    srv = LLMServer(tm, name="epoch", **QUIET, **KW)
    try:
        p = _prompts(1, seed=52)[0]
        assert srv._router_epoch_hw is None
        srv.submit(p, 2, router_epoch=3).result(timeout=WAIT)
        srv.submit(p, 2).result(timeout=WAIT)         # epoch-less is fine
        srv.submit(p, 2, router_epoch=3).result(timeout=WAIT)
        with pytest.raises(StaleRouterEpoch):
            srv.submit(p, 2, router_epoch=2)
        srv.submit(p, 2, router_epoch=4).result(timeout=WAIT)
        assert srv._router_epoch_hw == 4
    finally:
        srv.shutdown()


def test_router_epoch_fences_a_deposed_sender(models):
    """A router at epoch 5 dispatches; a direct submit carrying epoch 4
    on that replica is refused, and the routed stream is unchanged."""
    jm, tm = models["float32"]
    p = _prompts(1, seed=54)[0]
    ref = _jax_streams(jm, [p], 6, KW)
    fleet = LocalFleet(tm, 1, lease_interval=0.05, **QUIET, **KW)
    router = Router(fleet.replicas, store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.1)
    try:
        router.router_epoch = 5
        assert router.submit(p, 6).result(timeout=WAIT) == ref[0]
        with pytest.raises(StaleRouterEpoch):
            fleet.replicas[0].submit(p, 6, router_epoch=4)
        assert fleet.replicas[0].server._router_epoch_hw == 5
    finally:
        router.shutdown()
        fleet.shutdown()


def test_poison_convicted_typed_and_innocents_survive(models, harness):
    """Threshold 2 over three replicas: the marked request, co-batched
    with innocents, crashes the replica it lands on twice and is then
    convicted; the innocents it took down are replayed to the JAX
    engine's streams."""
    jm, tm = models["float32"]
    ps = _prompts(4, seed=53)
    ref = _jax_streams(jm, ps, 8, KW)
    fleet = LocalFleet(tm, 3, lease_ttl=2.0, lease_interval=0.1, **QUIET,
                       **KW)
    router = Router(fleet.replicas, store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.1,
                    poison_threshold=2)
    try:
        rule = harness.inject("replica.poison", times=2)
        innocents = [router.submit(p, max_new_tokens=8, client=f"c{i}")
                     for i, p in enumerate(ps)]
        poison = router.submit(ps[0], max_new_tokens=8, client="attacker",
                               chaos_mark="bad-bytes")
        with pytest.raises(PoisonedRequest):
            router.result(poison, timeout=WAIT)
        assert rule.fired == 2
        assert poison.poison_strikes == router.poison_threshold == 2
        assert len(poison.fence_events) == 2
        assert [r.result(timeout=WAIT) for r in innocents] == ref
        assert _rv(router, "poisoned_total") == 1
        assert _rv(router, "failovers_total") == 2
        assert _rv(router, "replay_mismatch_total") == 0
        assert len(router.live_replica_names()) == 1
    finally:
        router.shutdown()
        fleet.shutdown()


def test_poison_threshold_one_fences_one_replica(models, harness):
    """Threshold 1 over two replicas: the marked request is convicted at
    its first crash, one replica is fenced, and four innocents sent
    once it is convicted finish on the survivor with their streams."""
    jm, tm = models["float32"]
    ps = _prompts(4, seed=55)
    ref = _jax_streams(jm, ps, 8, KW)
    fleet = LocalFleet(tm, 2, lease_interval=0.05, **QUIET, **KW)
    router = Router(fleet.replicas, store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.1,
                    poison_threshold=1)
    try:
        harness.inject("replica.poison", times=None)
        poison = router.submit(ps[0], max_new_tokens=8,
                               chaos_mark="bad-bytes")
        with pytest.raises(PoisonedRequest):
            router.result(poison, timeout=WAIT)
        innocents = [router.submit(p, max_new_tokens=8) for p in ps]
        assert [r.result(timeout=WAIT) for r in innocents] == ref
        assert _rv(router, "poisoned_total") == 1
        assert _rv(router, "failovers_total") == 1
        assert len(router.live_replica_names()) == 1
        dead = [r for r in fleet.replicas if not r.server.healthy]
        assert len(dead) == 1
        assert isinstance(dead[0].server._error, InjectedFault)
    finally:
        router.shutdown()
        fleet.shutdown()


# -- a crash with a step in flight ------------------------------------------------------


def _crashed_tokens(tm, overlap, at):
    """Two requests on one server whose driver crashes at its `at`-th
    real step: their tokens at the failure, and the server."""
    steps = {"n": 0}

    def kill(ctx):
        steps["n"] += 1
        if steps["n"] == at:
            return InjectedFault

    faults.get_injector().inject("replica.crash", times=None, exc=None,
                                 callback=kill)
    srv = LLMServer(tm, name=f"crash-{overlap}", overlap=overlap, **QUIET,
                    **KW)
    try:
        reqs = [srv.submit(p, 16) for p in _prompts(2, seed=56)]
        for r in reqs:
            with pytest.raises(EngineUnhealthy):
                srv.result(r, timeout=WAIT)
        assert srv.engine._inflight is None
        return [list(r.tokens) for r in reqs]
    finally:
        faults.get_injector().clear()
        srv.shutdown()


def test_crash_commits_the_step_in_flight(models, harness):
    """The overlap driver crashing at its 6th step holds the step it
    dispatched at its 5th: it commits it before failing the requests,
    so they hold the tokens the synchronous driver gives at the same
    step (a prefix of the reference, 5 decode steps deep)."""
    tm = models["float32"][1]
    ref = [list(t) for t in LLMEngine(tm, **KW).generate(
        _prompts(2, seed=56), 16)]
    sync = _crashed_tokens(tm, "off", 6)
    over = _crashed_tokens(tm, "on", 6)
    assert over == sync
    for got, want in zip(over, ref):
        assert 1 < len(got) < len(want) and got == want[:len(got)]


def test_router_failover_with_overlap_driver(models, harness):
    """The crash drill through the Router over overlap replicas: every
    stream equals the reference, no replay disagrees."""
    jm, tm = models["float32"]
    ps = _prompts(6, seed=57)
    ref = _jax_streams(jm, ps, 12, KW)
    steps = {"n": 0}

    def kill_replica0(ctx):
        if ctx.get("name") == "replica0":
            steps["n"] += 1
            if steps["n"] == 6:
                return InjectedFault

    harness.inject("replica.crash", times=None, exc=None,
                   callback=kill_replica0)
    fleet = LocalFleet(tm, 2, lease_interval=0.05, overlap="on", **QUIET,
                       **KW)
    router = Router(fleet.replicas, store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.1)
    try:
        reqs = [router.submit(p, max_new_tokens=12) for p in ps]
        assert [r.result(timeout=WAIT) for r in reqs] == ref
        assert _rv(router, "failovers_total") == 1
        assert _rv(router, "tokens_deduped_total") >= 1
        assert _rv(router, "replay_mismatch_total") == 0
    finally:
        router.shutdown()
        fleet.shutdown()
