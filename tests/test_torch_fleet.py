"""The port's fleet membership (`paddle_tpu_torch/inference/fleet_serving.py`):
the JAX suite's lease, fleet and endpoint tests mirrored on the port,
then against the JAX package: greedy streams through a port `LocalFleet`
of 2 equal a JAX `LocalFleet`'s at the `tiny` preset with the same
weights, the heartbeat jitter sequences are equal, and the two packages'
leases share one store.  Fencing, re-registration at generation + 1 and
the store's lease grace after a crash and restart are checked on a
fleet's own leases.

Every store binds an ephemeral port.  No assertion waits on host
scheduling: expiry is shown with a lease written in the past, and every
wait on a heartbeat polls under a deadline of at least 10 x its
interval."""

import socket
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import TCPStore
from paddle_tpu_torch.inference import (LLMEngine, LLMServer, LocalFleet,
                                        Replica, ReplicaLease)
from paddle_tpu_torch.inference.fleet_serving import (
    fence_replica, fenced_generation, live_replicas, publish_router_endpoint,
    replica_role, replica_status, router_endpoint, set_replica_role,
    set_replica_status)
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays

KW = dict(max_slots=2, max_len=64, max_prompt_len=32, min_bucket=8,
          prefill_chunk=8)
# the servers' background threads are not under test here
QUIET = dict(series_interval=None, watchdog_deadline=None)
WAIT_S = 300.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prompts(n, seed=0, base=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (base + 3 * (i % 4),)) for i in range(n)]


def _poll(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


@pytest.fixture(scope="module")
def models():
    """(JAX tiny model, port tiny model with the same weights)."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("tiny"))
    tm = TModel(TConfig.from_preset("tiny"), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def port_model():
    return TModel(TConfig.from_preset("tiny"), device="cpu", seed=2)


# -- leases ------------------------------------------------------------------


def test_replica_lease_fence_and_reregister():
    store = TCPStore("127.0.0.1", 0, is_master=True)
    try:
        lease = ReplicaLease(store, "job", "r0", ttl=5.0, interval=0.05)
        assert lease.register() == 1
        assert live_replicas(store, "job")["r0"][2] == 1
        # fencing is final: the heartbeat sees it and stops for good
        assert fence_replica(store, "job", "r0", 1) == 1
        assert "r0" not in live_replicas(store, "job")
        assert _poll(lambda: not lease._thread.is_alive(), 10 * 0.05 + 30)
        assert lease.fenced and "r0" not in live_replicas(store, "job")
        # a racing lower fence keeps the max
        assert fence_replica(store, "job", "r0", 0) == 1
        assert fenced_generation(store, "job", "r0") == 1
        # restart: the next generation is live at once
        lease2 = ReplicaLease(store, "job", "r0", ttl=5.0, interval=0.05)
        assert lease2.register() == 2
        assert live_replicas(store, "job")["r0"][2] == 2
        assert not lease2.fenced
        # a lease whose heartbeat died expires by its ttl: written as it
        # would stand one ttl after its last beat
        lease3 = ReplicaLease(store, "job", "r1", ttl=30.0, interval=60.0)
        lease3.register()
        assert "r1" in live_replicas(store, "job")
        store.set("fleet/job/replica/r1", (time.time() - 31.0, 30.0,
                                           lease3.generation))
        assert "r1" not in live_replicas(store, "job")
        for ls in (lease, lease2, lease3):
            ls.release()
        assert live_replicas(store, "job") == {}
    finally:
        store.close()


def test_heartbeat_refreshes_the_lease():
    store = TCPStore("127.0.0.1", 0, is_master=True)
    try:
        lease = ReplicaLease(store, "hb", "r0", ttl=5.0, interval=0.02)
        lease.register()
        first = store.get("fleet/hb/replica/r0")[0]
        assert _poll(lambda: store.get("fleet/hb/replica/r0")[0] > first,
                     10 * 0.02 + 30)
        lease.release()
        assert store.get("fleet/hb/replica/r0") is None
    finally:
        store.close()


def test_heartbeat_jitter_seeded_and_bounded():
    a1 = ReplicaLease(None, "job", "r0", ttl=3.0)
    a2 = ReplicaLease(None, "job", "r0", ttl=3.0)
    b = ReplicaLease(None, "job", "r1", ttl=3.0)
    s1 = [a1._next_interval() for _ in range(32)]
    s2 = [a2._next_interval() for _ in range(32)]
    s3 = [b._next_interval() for _ in range(32)]
    assert s1 == s2
    assert s1 != s3
    for v in s1 + s3:
        assert 0.9 * 1.0 <= v <= 1.1 * 1.0
    assert len({round(v, 9) for v in s1}) > 1


@pytest.mark.parametrize("job,name,ttl,interval", [
    ("job", "r0", 3.0, None), ("fleet", "replica1", 5.0, 0.1),
    ("j/x", "__router_leader__", 2.0, 0.5)])
def test_jitter_sequence_equal_jax(job, name, ttl, interval):
    pytest.importorskip("jax")
    from paddle_tpu.inference.fleet_serving import ReplicaLease as JLease
    mine = ReplicaLease(None, job, name, ttl=ttl, interval=interval)
    theirs = JLease(None, job, name, ttl=ttl, interval=interval)
    assert mine.interval == theirs.interval
    assert [mine._next_interval() for _ in range(64)] == \
        [theirs._next_interval() for _ in range(64)]


def test_status_role_and_router_endpoint_helpers():
    store = TCPStore("127.0.0.1", 0, is_master=True)
    try:
        assert replica_status(store, "j", "r0") == "ok"
        assert replica_role(store, "j", "r0") == "mixed"
        set_replica_status(store, "j", "r0", "quarantined")
        set_replica_role(store, "j", "r0", "decode")
        assert replica_status(store, "j", "r0") == "quarantined"
        assert replica_role(store, "j", "r0") == "decode"
        assert router_endpoint(store, "j", "gateway", timeout=5.0) is None
        publish_router_endpoint(store, "j", "gateway", "10.0.0.1", 4242, 7)
        assert router_endpoint(store, "j", "gateway", timeout=5.0) == \
            ("10.0.0.1", 4242, 7)
    finally:
        store.close()


def test_leases_of_both_packages_share_one_store():
    """A JAX replica's lease and a port replica's lease in one store (a
    port master): each package's `live_replicas` sees both, and a fence
    written by one package is honoured by the other's heartbeat."""
    pytest.importorskip("jax")
    from paddle_tpu.inference import fleet_serving as J
    store = TCPStore("127.0.0.1", 0, is_master=True)
    try:
        mine = ReplicaLease(store, "mix", "port0", interval=0.05)
        theirs = J.ReplicaLease(store, "mix", "jax0", interval=0.05)
        assert mine.register() == theirs.register() == 1
        assert live_replicas(store, "mix").keys() == \
            J.live_replicas(store, "mix").keys() == {"port0", "jax0"}
        assert J.fence_replica(store, "mix", "port0", 1) == 1
        assert _poll(lambda: not mine._thread.is_alive(), 10 * 0.05 + 30)
        assert set(live_replicas(store, "mix")) == {"jax0"}
        mine.release()
        theirs.release()
    finally:
        store.close()


# -- LocalFleet ---------------------------------------------------------------


def _fleet_streams(fleet, prompts, new):
    """Half the prompts to each replica through Replica.submit."""
    reqs = [fleet.replicas[i % len(fleet.replicas)].submit(p, new)
            for i, p in enumerate(prompts)]
    return [list(r.result(timeout=WAIT_S)) for r in reqs]


def test_local_fleet_streams_equal_jax_fleet(models):
    """A port LocalFleet of 2 and a JAX LocalFleet of 2 over the same
    weights: both replicas live at generation 1 in each fleet's store,
    and the greedy streams of the same prompts, placed alike, are
    equal (and equal a single port engine's)."""
    from paddle_tpu.inference import LocalFleet as JFleet
    jm, tm = models
    ps = _prompts(6, seed=41)
    jf = JFleet(jm, 2, lease_interval=0.05, **KW)
    tf = LocalFleet(tm, 2, lease_interval=0.05, **QUIET, **KW)
    try:
        assert {n: v[2] for n, v in tf.live().items()} == \
            {n: v[2] for n, v in jf.live().items()} == \
            {"replica0": 1, "replica1": 1}
        got = _fleet_streams(tf, ps, 8)
        assert got == _fleet_streams(jf, ps, 8)
        assert got == LLMEngine(tm, **KW).generate(ps, 8)
        for rep in tf.replicas:
            assert rep.pool_role == "mixed" and rep.block_tokens == 0
            h = rep.health()
            assert h["name"] == rep.name and h["status"] == "ok"
    finally:
        jf.shutdown()
        tf.shutdown()


def test_local_fleet_fence_reregister_and_shutdown(port_model):
    fleet = LocalFleet(port_model, 2, job_id="fj", lease_ttl=5.0,
                       lease_interval=0.05, **QUIET, **KW)
    try:
        assert set(fleet.live()) == {"replica0", "replica1"}
        rep1 = fleet.replicas[1]
        assert fence_replica(fleet.store, "fj", "replica1",
                             rep1.lease.generation) == 1
        assert _poll(lambda: not rep1.lease._thread.is_alive(),
                     10 * 0.05 + 30)
        assert set(fleet.live()) == {"replica0"}
        # spawn() names afresh; a restart under the same name builds its
        # lease directly and is live at generation 2 at once
        again = ReplicaLease(fleet.store, "fj", "replica1", ttl=5.0,
                             interval=0.05)
        assert again.register() == 2
        assert fleet.live()["replica1"][2] == 2
        again.release()
        extra = fleet.spawn(pool_role="decode")
        assert extra.name == "replica2" and extra.pool_role == "decode"
        assert replica_role(fleet.store, "fj", "replica2") == "decode"
        assert fleet.live()["replica2"][2] == 1
    finally:
        fleet.shutdown()
    assert all(not r.server.healthy for r in fleet.replicas)
    with pytest.raises(ConnectionError):
        fleet.replicas[0].health()


def test_local_fleet_distinct_metrics_ports(port_model):
    """A fixed metrics_port goes to the first spawn only; later spawns
    bind ephemeral ports, and /healthz over HTTP answers on each."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    fleet = LocalFleet(port_model, 2, metrics_port=port, **QUIET, **KW)
    try:
        addrs = [rep.server.metrics_address for rep in fleet.replicas]
        assert addrs[0][1] == port
        assert addrs[1] is not None and addrs[1][1] != port
        for rep in fleet.replicas:
            assert rep.health()["status"] == "ok"
    finally:
        fleet.shutdown()


def test_replica_reads_the_prefix_geometry(port_model):
    srv = LLMServer(port_model, prefix_cache_blocks=6, name="pc", **QUIET,
                    **KW)
    try:
        rep = Replica("pc", srv)
        assert rep.block_tokens == srv.engine.prefix_block_tokens == 16
        assert rep.cache_blocks == 6 and rep.fabric_address is None
    finally:
        srv.shutdown()


def test_fleet_leases_graced_across_store_crash(tmp_path, port_model):
    """A fleet on a durable master: the master crashes for longer than a
    lease's ttl and restarts.  The WAL recovers every key, both leases
    are graced by the outage, nobody is fenced, the heartbeats refresh
    them, and the generation counters survive (a re-registration takes
    generation 2: the retried `add` applied once)."""
    store = TCPStore("127.0.0.1", 0, is_master=True,
                     durable_dir=str(tmp_path / "wal"))
    fleet = LocalFleet(port_model, 2, store=store, job_id="cr",
                       lease_ttl=1.0, lease_interval=0.05, **QUIET, **KW)
    try:
        keys = store.list_keys()
        store.crash()
        time.sleep(1.2)                      # longer than one ttl
        rec = store.restart()
        assert rec["keys"] == len(keys) and rec["graced_leases"] == 2
        assert rec["outage_s"] > 1.0
        for rep in fleet.replicas:
            assert fenced_generation(store, "cr", rep.name) == 0
            assert not rep.lease.fenced
        names = [rep.name for rep in fleet.replicas]

        def stamp(n):
            return store.get(f"fleet/cr/replica/{n}")[0]
        graced = {n: stamp(n) for n in names}
        assert _poll(lambda: set(live_replicas(store, "cr")) == set(names)
                     and all(stamp(n) > graced[n] for n in names),
                     10 * 0.05 + 60)
        again = ReplicaLease(store, "cr", "replica0", interval=60.0)
        assert again.register() == 2
        again.release()
        ps = _prompts(2, seed=3)
        assert _fleet_streams(fleet, ps, 4) == \
            LLMEngine(port_model, **KW).generate(ps, 4)
    finally:
        fleet.shutdown()
        store.close()


@pytest.mark.gpu
def test_local_fleet_streams_on_card():
    """On the card: a two-replica LocalFleet over one model boots both
    replicas' graphs at spawn, and the serve-style mix sent half to each
    replica gives the streams of one server with the same engine
    config."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the replicas' decode graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TModel(TConfig.from_preset("debug-4l"), device="cuda", seed=1)
    kw = dict(max_slots=4, max_len=256, prefill_chunk=32, **QUIET)
    ps = _prompts(8, seed=9, base=20)
    srv = LLMServer(model, name="single", **kw)
    try:
        srv.engine.prepare_programs()
        ref = [list(r.result(timeout=WAIT_S))
               for r in [srv.submit(p, 24) for p in ps]]
    finally:
        srv.shutdown()
    fleet = LocalFleet(model, 2, lease_interval=0.1, **kw)
    try:
        for rep in fleet.replicas:
            eng = rep.server.engine
            assert eng.num_graphs == len(eng.decode_widths)
        assert _fleet_streams(fleet, ps, 24) == ref
        assert {v[2] for v in fleet.live().values()} == {1}
    finally:
        fleet.shutdown()
