"""The port's hot-standby control plane (`paddle_tpu_torch/inference/
router_ha.py`) against the JAX package's, on the CPU.  The
counterparts of tests/test_control_plane_ha.py's router cases, over a
port `LocalFleet` of the `tiny` preset in fp32 with the JAX model's
weights: the standby's shadow state, a promotion that resubmits the
shadow journal while the client shim follows, the gateway after the
router evicts a request, a stale epoch refused, the endpoint helpers,
the finished-request stub and a poison conviction.  Every greedy
stream equals the JAX engine's token for token (greedy streams hold no
tolerance).

Then across packages: a JAX `JournalTailer` follows the port's
`JournalStreamServer` and the port's follows the JAX one, each ending
with a shadow file byte-equal to the primary's journal (the port's
tailer also through a torn frame); and one `ProcessFleet(ha=True)` —
two CPU replica processes that find the leader through the store — a
port primary crashed mid-decode, a standby that promotes itself, the
replicas re-hello with no restart and no fence, and every client
stream completes exactly once and equal to the JAX engine's.

No assertion waits on host scheduling: leader expiry and catch-up are
polled with deadlines, and the replicas that must be mid-stream at the
crash are wedged there by a fault rule armed inside their
processes."""

import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.inference import (FleetClient, HARouter, LLMEngine,
                                        LLMServer, LocalFleet,
                                        PoisonedRequest, ProcessFleet,
                                        Router, RoutingJournal,
                                        StaleRouterEpoch, StandbyRouter)
from paddle_tpu_torch.inference.fleet_serving import (
    ROUTER_LEADER, fenced_generation, live_replicas,
    publish_router_endpoint, router_endpoint)
from paddle_tpu_torch.inference.router_ha import (JournalStreamServer,
                                                  JournalTailer,
                                                  _FinishedRequest)
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.testing import faults

# the JAX suite's engine knobs (tests/test_control_plane_ha.py:42)
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


def _ref(models, prompts, new):
    """The JAX engine's greedy streams, held equal to one port
    engine's at the same knobs; returned as lists."""
    from paddle_tpu.inference import LLMEngine as JEngine
    jm, tm = models
    theirs = [list(t) for t in JEngine(jm, **KW).generate(prompts, new)]
    mine = [list(t) for t in LLMEngine(tm, **KW).generate(prompts, new)]
    assert mine == theirs
    return mine


def _fleet(models, n, job, **kw):
    return LocalFleet(models[1], n, job_id=job, lease_interval=0.05,
                      **dict(QUIET, **dict(KW, **kw)))


def _wait(pred, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _rv(router, name):
    return router.metrics()[f"router_{name}"]["series"][""]["value"]


def _drain(router, reqs):
    return [list(router.result(r, timeout=WAIT)) for r in reqs]


# -- the standby over a LocalFleet ------------------------------------------------


def test_standby_shadow_state_matches_primary(models):
    ps = _prompts(4, seed=50)
    fleet = _fleet(models, 2, "ha-shadow")
    primary = HARouter(store=fleet.store, job_id="ha-shadow",
                       lease_ttl=30.0, poll_interval=0.1)
    standby = None
    try:
        for rep in fleet.replicas:
            primary.add_replica(rep)
        standby = StandbyRouter(fleet.store, "ha-shadow")
        reqs = [primary.submit(p, max_new_tokens=6) for p in ps]
        assert _drain(primary, reqs) == _ref(models, ps, 6)
        want = RoutingJournal.replay(primary.journal_path)
        assert all(st["done"] for st in want.values())
        _wait(lambda: standby.shadow_state() == want, "the shadow to catch up")
        assert standby.leader_alive()
        with open(primary.journal_path, "rb") as a, \
                open(standby.shadow_path, "rb") as b:
            assert a.read() == b.read()
        assert primary.debug_fleet()["ha"]["role"] == "primary"
    finally:
        if standby is not None:
            standby.stop()
        primary.shutdown()
        fleet.shutdown()


def test_failover_promotes_resubmits_and_client_follows(models):
    ps = _prompts(5, seed=51)
    ref = _ref(models, ps, 8)
    fleet = _fleet(models, 2, "ha-fo")
    primary = HARouter(store=fleet.store, job_id="ha-fo",
                       lease_ttl=1.0, poll_interval=0.1)
    standby = None
    try:
        for rep in fleet.replicas:
            primary.add_replica(rep)
        standby = StandbyRouter(fleet.store, "ha-fo",
                                replicas=fleet.replicas,
                                router_kw={"poll_interval": 0.1})
        client = FleetClient(fleet.store, "ha-fo")
        # one request completes entirely on the primary...
        done_rid = client.submit(ps[0], max_new_tokens=8)
        assert client.result(done_rid, timeout=WAIT)[1] == ref[0]
        # ...the rest are submitted and the primary dies mid-flight,
        # once the standby holds their accept records (the stream
        # replicates after the gateway's reply: a record still queued
        # at the crash dies with the leader)
        rids = [client.submit(p, max_new_tokens=8) for p in ps[1:]]
        _wait(lambda: set(rids) <= set(standby.shadow_state()),
              "the accepts in the standby's shadow")
        primary.crash()
        # the lease was never deleted — the standby must EARN the
        # detection by watching it expire
        _wait(lambda: not standby.leader_alive(), "the leader lease to expire")
        r2 = standby.promote()
        assert standby.promote_latency_s < 30.0
        assert r2.router_epoch > primary.router_epoch
        # exactly-once across the promotion: equal to the reference
        got = [client.result(rid, timeout=WAIT)[1] for rid in rids]
        assert got == ref[1:]
        assert _rv(r2, "replay_mismatch_total") == 0
        # a verdict that landed on the DEAD leader is still servable
        rid2, toks = client.result(done_rid, timeout=30)
        assert rid2 == done_rid and toks == ref[0]
        assert standby.promote() is r2        # idempotent
        assert r2.debug_fleet()["standby_takeover"][
            "resubmitted"] == _rv(r2, "requests_resubmitted_total")
    finally:
        if standby is not None:
            standby.stop()
            if standby.router is not None:
                standby.router.shutdown()
        primary.shutdown()
        fleet.shutdown()


def test_gateway_serves_result_after_router_evicts_request(models):
    # the router pops finished requests from `_requests` at _finish;
    # the gateway must pin what it accepted or a slow collector sees
    # "unknown rid" for a request that completed perfectly
    ps = _prompts(1, seed=53)
    ref = _ref(models, ps, 8)
    fleet = _fleet(models, 2, "ha-gc")
    primary = HARouter(store=fleet.store, job_id="ha-gc",
                       lease_ttl=5.0, poll_interval=0.1)
    try:
        for rep in fleet.replicas:
            primary.add_replica(rep)
        client = FleetClient(fleet.store, "ha-gc")
        rid = client.submit(ps[0], max_new_tokens=8)

        def evicted():
            with primary._lock:
                return rid not in primary._requests
        _wait(evicted, "the request to finish and be evicted")
        assert client.result(rid, timeout=30)[1] == ref[0]
    finally:
        primary.shutdown()
        fleet.shutdown()


def test_stale_router_epoch_rejected_by_replica(models):
    srv = LLMServer(models[1], name="epoch", **dict(QUIET, **KW))
    try:
        p = _prompts(1, seed=52)[0]
        srv.submit(p, 2, router_epoch=3).result(timeout=WAIT)
        srv.submit(p, 2).result(timeout=WAIT)          # epoch-less is fine
        srv.submit(p, 2, router_epoch=3).result(timeout=WAIT)
        with pytest.raises(StaleRouterEpoch):
            srv.submit(p, 2, router_epoch=2)          # deposed primary
        srv.submit(p, 2, router_epoch=4).result(timeout=WAIT)
    finally:
        srv.shutdown()


def test_router_endpoint_helpers_roundtrip():
    store = TCPStore("127.0.0.1", 0, is_master=True)
    try:
        assert router_endpoint(store, "j", "gateway", timeout=5.0) is None
        publish_router_endpoint(store, "j", "gateway", "10.0.0.1", 4242, 7)
        assert router_endpoint(store, "j", "gateway", timeout=5.0) == \
            ("10.0.0.1", 4242, 7)
    finally:
        store.close()


def test_finished_request_stub_replays_verdicts():
    ok = _FinishedRequest("r-1", [1, 2, 3])
    assert ok.result() == [1, 2, 3]
    assert ok.result(timeout=0.1) == [1, 2, 3]      # no waiting, it's done
    dead = _FinishedRequest("r-2", [], error_name="PoisonedRequest")
    with pytest.raises(PoisonedRequest):
        dead.result()


def test_poison_convicted_typed_and_innocents_survive(models, harness):
    ps = _prompts(4, seed=53)
    ref = _ref(models, ps, 8)
    fleet = LocalFleet(models[1], 3, lease_ttl=2.0, lease_interval=0.1,
                       **dict(QUIET, **KW))
    router = Router(fleet.replicas, store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.1,
                    poison_threshold=2)
    try:
        # the marked request trips this in whichever replica it lands
        # on; `times=2` == poison_threshold replicas, then exhausted
        harness.inject("replica.poison", times=2)
        innocents = [router.submit(p, max_new_tokens=8, client=f"c{i}")
                     for i, p in enumerate(ps)]
        poison = router.submit(ps[0], max_new_tokens=8,
                               client="attacker", chaos_mark="bad-bytes")
        with pytest.raises(PoisonedRequest):
            router.result(poison, timeout=WAIT)
        assert poison.poison_strikes >= router.poison_threshold
        assert len(poison.fence_events) >= router.poison_threshold
        # blast radius: at most poison_threshold replicas fenced
        assert len(router.live_replica_names()) >= 1
        # co-batched innocents complete on the survivor(s)
        assert _drain(router, innocents) == ref
        assert _rv(router, "poisoned_total") == 1
        # convicted means never re-dispatched: strikes stopped at the
        # threshold even though a healthy replica was still live
        assert poison.poison_strikes == router.poison_threshold
    finally:
        router.shutdown()
        fleet.shutdown()


# -- the journal stream across packages --------------------------------------


def _write(journal, rid, toks):
    journal.record("accept", rid, prompt=[1, 2, 3], max_new_tokens=len(toks),
                   client="c", params={}, trace_id=None)
    for t in toks:
        journal.record("tok", rid, t=int(t), trace_id=None)


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_journal_stream_crosses_packages(tmp_path, server_pkg, harness):
    """One package's `JournalStreamServer` over its `RoutingJournal`,
    the other package's `JournalTailer` through a store client of its
    own package: records written before the tailer connects arrive in
    the ``reset`` snapshot, later ones as ``line`` frames, and the
    shadow ends byte-equal to the journal.  The port's tailer also
    rides out a torn frame (``journal.tail``): it reconnects, resyncs
    from a fresh snapshot, and ends byte-equal all the same."""
    pytest.importorskip("jax")
    from paddle_tpu.distributed.store import TCPStore as JStore
    from paddle_tpu.inference import fleet_serving as jfs
    from paddle_tpu.inference import router as jrouter
    from paddle_tpu.inference import router_ha as jha
    from paddle_tpu_torch.inference import router as trouter
    if server_pkg == "port":
        master = TCPStore("127.0.0.1", 0, is_master=True)
        client = JStore("127.0.0.1", master.port, is_master=False)
        Journal, Server, publish = (trouter.RoutingJournal,
                                    JournalStreamServer,
                                    publish_router_endpoint)
        Tailer = jha.JournalTailer
    else:
        master = JStore("127.0.0.1", 0, is_master=True)
        client = TCPStore("127.0.0.1", master.port, is_master=False)
        Journal, Server, publish = (jrouter.RoutingJournal,
                                    jha.JournalStreamServer,
                                    jfs.publish_router_endpoint)
        Tailer = JournalTailer
        # a torn frame on the port's side: the second frame it reads
        harness.inject("journal.tail", after=1, times=1)
    journal = Journal(str(tmp_path / "primary.jsonl"))
    server = tailer = None
    try:
        _write(journal, "r-0", [5, 6, 7])
        server = Server(journal)
        publish(master, "xj", "journal", server.address[0],
                server.address[1], 1)
        tailer = Tailer(client, "xj", shadow_path=str(tmp_path / "s.jsonl"))
        _wait(lambda: tailer.resets >= 1, "the snapshot")
        _write(journal, "r-1", [8, 9])
        journal.record("done", "r-0", n=3, trace_id=None)

        def same():
            with open(journal.path, "rb") as a, \
                    open(tailer.shadow_path, "rb") as b:
                return a.read() == b.read()
        _wait(same, "the shadow to match the journal")
        want = trouter.RoutingJournal.replay(journal.path)
        assert tailer.shadow_state() == want
        assert set(want) == {"r-0", "r-1"} and want["r-0"]["done"]
        if server_pkg == "jax":
            assert tailer.resets >= 2 and tailer.reconnects >= 1
    finally:
        if tailer is not None:
            tailer.stop()
        if server is not None:
            server.close()
        journal.close()
        client.close()
        master.close()


# -- promotion over replica processes ----------------------------------------


def test_process_fleet_ha_promotion_keeps_streams(models, tmp_path):
    """`ProcessFleet(ha=True)`: two CPU children with the JAX model's
    weights find the port primary through the store; the primary is
    crashed while both children are wedged mid-stream; the standby sees
    the leader lease expire and promotes itself; the children re-hello
    to the new leader (same pids, no fence) and every client stream
    completes exactly once, equal to the JAX engine's."""
    jm, tm = models
    arrays = tmp_path / "tiny.npz"
    np.savez(arrays, **{n: np.asarray(p._data)
                        for n, p in jm.named_parameters()})
    ps = _prompts(4, seed=54)
    ref = _ref(models, ps, 8)
    job = "ha-proc"
    fleet = ProcessFleet({"preset": "tiny", "seed": 0, "device": "cpu",
                          "arrays": str(arrays)}, n=2, job_id=job,
                         ha=True, **KW)
    primary = standby = None
    try:
        primary = HARouter(store=fleet.store, job_id=job, lease_ttl=1.0,
                           poll_interval=0.1)
        _wait(lambda: primary.acceptor.join_handshakes() == 2,
              "both children to attach to the primary")
        pids = {r.name: r.pid for r in primary.acceptor.accepted}
        assert pids == {n: p.pid for n, p in fleet.procs.items()}
        # each child's driver sleeps at its third step, once: the crash
        # lands with every stream under way
        for rep in primary.acceptor.accepted:
            rep.arm_fault("replica.crash", exc=None, delay=5.0, after=2)
        standby = StandbyRouter(fleet.store, job, auto_promote=True,
                                watch_interval=0.1,
                                router_kw={"poll_interval": 0.1})
        client = FleetClient(fleet.store, job)
        rids = [client.submit(p, max_new_tokens=8) for p in ps]
        def shadowed():
            st = standby.shadow_state()
            return set(rids) <= set(st) and any(
                v["delivered"] for v in st.values())
        _wait(shadowed, "the accepts and a delivered token in the "
              "standby's shadow")
        assert _rv(primary, "requests_completed_total") == 0
        primary.crash()
        _wait(standby.promoted.is_set, "the standby to promote")
        r2 = standby.router
        assert r2.router_epoch > primary.router_epoch
        got = [client.result(rid, timeout=WAIT)[1] for rid in rids]
        assert got == ref
        assert _rv(r2, "replay_mismatch_total") == 0
        assert _rv(r2, "requests_resubmitted_total") == len(ps)
        assert _rv(r2, "tokens_deduped_total") >= 1
        # the same processes re-hello'd: no restart, nobody fenced
        _wait(lambda: r2.acceptor.join_handshakes() == 2,
              "both children to attach to the new leader")
        assert {r.name: r.pid for r in r2.acceptor.accepted} == pids
        assert all(p.is_alive() for p in fleet.procs.values())
        for name in pids:
            assert fenced_generation(fleet.store, job, name) == 0
        assert sorted(live_replicas(fleet.store, job)) == sorted(
            [ROUTER_LEADER, *pids])
        # a deposed primary's epoch is refused by the replicas
        rep = r2.acceptor.accepted[0]
        with pytest.raises(StaleRouterEpoch):
            rep.submit(ps[0], 2, router_epoch=primary.router_epoch)
    finally:
        if standby is not None:
            standby.stop()
            if standby.router is not None:
                standby.router.shutdown()
        if primary is not None:
            primary.shutdown()
        fleet.shutdown()
    assert all(not p.is_alive() for p in fleet.procs.values())
