"""The port's `ProcessFleet` (`paddle_tpu_torch/inference/process_fleet.py`)
against the JAX package's, on the CPU: replica processes of the `tiny`
preset in fp32 (`device="cpu"`) whose children load the JAX model's
weights from an `.npz` (`model_spec["arrays"]`).  The counterparts of
tests/test_process_fleet.py: every greedy stream of either child
equals the JAX engine's in-process stream token for token (greedy
streams hold no tolerance); typed errors cross the wire; a `Router`
over process replicas survives a SIGKILL; an overload shed crosses the
wire.  Then the wire itself against the JAX module's: the error codec
both ways, the control ops and the hello keys (read from both modules
with `ast`), the respawn breaker on one clock, and a child asked for
the card on a machine without one.

Two fleets are booted in the whole file.  No assertion waits on host
scheduling: the replica that must be mid-stream when it is killed is
wedged there by a fault rule armed inside its process, and every poll
has a deadline."""

import ast
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (EngineUnhealthy, Overloaded,
                                        OverloadConfig, PoisonedRequest,
                                        ProcessFleet, QueueFull,
                                        RespawnCircuitOpen, Router,
                                        StaleRouterEpoch)
from paddle_tpu_torch.inference import process_fleet as PF
from paddle_tpu_torch.inference.fleet_serving import fenced_generation

ROOT = Path(__file__).resolve().parents[1]
# the JAX suite's engine knobs (tests/test_process_fleet.py:22)
KW = dict(max_slots=4, max_len=64, max_prompt_len=32, min_bucket=8,
          kv_block_tokens=8)
# the shed test's ladder (tests/test_process_fleet.py:102): a protected
# backlog of 3 climbs a rung a step, and nothing climbs back down
LADDER = dict(queue_high=2, queue_low=0, up_steps=1, min_dwell=0,
              down_steps=1000)
WAIT = 120.0


def _prompts(n, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (8 + 2 * (i % 4),)) for i in range(n)]


@pytest.fixture(scope="module")
def jax_tiny(tmp_path_factory):
    """(JAX tiny model, path of an .npz of its weights)."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("tiny"))
    path = tmp_path_factory.mktemp("arrays") / "tiny.npz"
    np.savez(path, **{n: np.asarray(p._data)
                      for n, p in jm.named_parameters()})
    return jm, str(path)


def _spec(jax_tiny):
    return {"preset": "tiny", "seed": 0, "device": "cpu",
            "arrays": jax_tiny[1]}


def _jax_streams(jax_tiny, prompts, new, **kw):
    from paddle_tpu.inference import LLMEngine as JEngine
    return [list(t) for t in JEngine(jax_tiny[0], **dict(KW, **kw))
            .generate(prompts, new)]


@pytest.fixture(scope="module")
def fleet(jax_tiny):
    """Two CPU replica processes; the second carries the shed test's
    overload ladder (armed, it never climbs under the parity test's
    load: three requests on four slots queue nothing)."""
    f = ProcessFleet(_spec(jax_tiny), n=2, job_id="tpfleet",
                     role_kw={"decode": {
                         "overload": OverloadConfig(**LADDER)}},
                     roles=("mixed", "decode"), **KW)
    yield f
    f.shutdown()


def _wait(pred, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# -- a fleet of replica processes ---------------------------------------------


def test_cross_process_streams_equal_jax_engine(fleet, jax_tiny):
    """Both children, loaded with the JAX model's arrays, give the JAX
    engine's in-process greedy streams token for token (no tolerance),
    and announce themselves with the hello's geometry."""
    ps = _prompts(3)
    r0, r1 = fleet.replicas
    outs0 = [r0.submit(p, 10, tier="interactive") for p in ps]
    outs1 = [r1.submit(p, 10, tier="interactive") for p in ps]
    a = [list(h.result(timeout=WAIT)) for h in outs0]
    b = [list(h.result(timeout=WAIT)) for h in outs1]
    assert a == b == _jax_streams(jax_tiny, ps, 10)
    assert [r.name for r in fleet.replicas] == ["proc0", "proc1"]
    assert [r.pool_role for r in fleet.replicas] == ["mixed", "decode"]
    for r in fleet.replicas:
        assert r.proc.is_alive() and r.pid == r.proc.pid
        assert r.lease.generation == 1 and r.tp == 1 and r.aot is None
        assert r.kv_blocks > 0 and r.kv_block_bytes_per_chip > 0
        assert r.boot_s > 0 and r.fabric_address is None
    assert sorted(fleet.live()) == ["proc0", "proc1"]


def test_typed_errors_cross_the_wire(fleet):
    rep = fleet.replicas[0]
    with pytest.raises(ValueError):
        rep.submit(_prompts(1)[0], 4, tier="gold")
    rep.submit(_prompts(1)[0], 2, router_epoch=3).result(timeout=WAIT)
    with pytest.raises(StaleRouterEpoch):
        rep.submit(_prompts(1)[0], 2, router_epoch=2)
    h = rep.health()
    assert h["status"] == "ok" and h["name"] == "proc0"
    assert set(h["tier_queue_depth"]) == {"interactive", "standard",
                                          "batch"}
    assert "overload_rung" in h and "shed" in h
    # the ctl ops: a series pull, a clock handshake, a rule armed and
    # cleared inside the child
    payload = rep.metrics_series(n=4)
    assert payload["name"] == "proc0" and "series" in payload
    assert isinstance(rep.clock_sync(), int)
    rep.arm_fault("metrics.ship", times=1)
    rep.clear_faults()
    assert rep.pull_trace() == []


def test_overload_shed_over_the_wire(fleet):
    """REAL pressure (a deep protected backlog) walks proc1's ladder to
    the shed rung; the typed `Overloaded` rejection is reconstructed
    parent-side, interactive traffic still completes, and /healthz
    reports the rung across the process boundary."""
    rep = fleet.replicas[1]
    ps = _prompts(12, seed=21)
    handles = [rep.submit(p, 16, tier="interactive") for p in ps]
    _wait(lambda: rep.health(timeout=10)["overload_rung"] >= 4,
          "proc1's ladder at the shed rung")
    with pytest.raises(Overloaded):
        rep.submit(ps[0], 4, tier="batch")
    shed = rep.health(timeout=10)["shed"]
    assert shed["batch"] >= 1 and shed["interactive"] == 0
    # every accepted (interactive) request still completes
    for h in handles:
        assert len(h.result(timeout=WAIT)) == 16


def test_router_over_process_replicas_and_kill(jax_tiny):
    """The router cannot tell ProcessReplica from Replica: it routes,
    fails over a SIGKILLed process (a REAL crash — the socket drops,
    the lease stops beating), and every accepted request completes
    exactly once with the JAX engine's stream.  proc1 is wedged inside
    its own process at its third scheduler step, so the kill always
    lands mid-stream."""
    ps = _prompts(6, seed=9)
    ref = _jax_streams(jax_tiny, ps, 8)
    fleet = ProcessFleet(_spec(jax_tiny), n=2, job_id="tpkill", **KW)
    router = Router(fleet.replicas, store=fleet.store,
                    job_id=fleet.job_id, poll_interval=0.25)
    try:
        p0, p1 = fleet.replicas
        p1.arm_fault("replica.crash", exc=None, delay=WAIT, after=2)
        reqs = [router.submit(p, max_new_tokens=8, tier="interactive")
                for p in ps]
        _wait(lambda: any(r.replica == "proc1" and r.tokens for r in reqs),
              "a stream under way on proc1")
        fleet.kill("proc1")
        assert not p1.proc.is_alive()
        outs = [list(rr.result(timeout=WAIT)) for rr in reqs]
        assert outs == ref
        assert all(rr.error is None for rr in reqs)
        m = router.metrics()
        assert m["router_failovers_total"]["series"][""]["value"] == 1
        assert m["router_replay_mismatch_total"]["series"][""]["value"] == 0
        assert m["router_tokens_deduped_total"]["series"][""]["value"] >= 1
        assert fenced_generation(fleet.store, fleet.job_id, "proc1") >= 1
        live = fleet.live()
        assert "proc1" not in live and "proc0" in live
        with pytest.raises(EngineUnhealthy):
            p1.submit(ps[0], 2)
        # a live slot is not respawned; the attempt is on the breaker
        with pytest.raises(RuntimeError, match="still alive"):
            fleet.respawn("proc0")
        assert fleet.respawn_state()["proc0"]["respawns_in_window"] == 1
    finally:
        router.shutdown()
        fleet.shutdown()
    assert all(not r.proc.is_alive() for r in fleet.replicas)


# -- the wire against the JAX module -----------------------------------------


def _jpf():
    pytest.importorskip("jax")
    from paddle_tpu.inference import process_fleet
    return process_fleet


ERRORS = sorted(PF._ERR_TYPES)


@pytest.mark.parametrize("name", ERRORS)
def test_error_codec_crosses_packages(name):
    """An error encoded by either package decodes in the other to the
    same type name and message, and the two tables name the same
    types."""
    J = _jpf()
    assert sorted(J._ERR_TYPES) == ERRORS
    mine = PF._ERR_TYPES[name](f"port {name}")
    theirs = J._ERR_TYPES[name](f"jax {name}")
    back = J._decode_error(PF._encode_error(mine))
    assert [type(back).__name__, str(back)] == [name, f"port {name}"]
    fwd = PF._decode_error(J._encode_error(theirs))
    assert isinstance(fwd, PF._ERR_TYPES[name])
    assert PF._encode_error(fwd) == [name, f"jax {name}"]


def test_error_codec_unknown_and_none():
    J = _jpf()
    for M in (PF, J):
        assert M._decode_error(None) is None
        e = M._decode_error(["KeyError", "'x'"])
        assert type(e) is RuntimeError and str(e) == "KeyError: 'x'"
    assert PF._encode_error(PoisonedRequest("p")) == ["PoisonedRequest", "p"]
    assert isinstance(PF._decode_error(["QueueFull", "q"]), QueueFull)


def _wire(path):
    """The control wire a module speaks: every op name it sends or
    matches, and the keys of the child's hello."""
    tree = ast.parse(Path(path).read_text())
    ops, hello = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if "op" in keys:
                v = node.values[keys.index("op")]
                if isinstance(v, ast.Constant):
                    ops.add(v.value)
                if getattr(v, "value", None) == "hello":
                    hello = set(keys)
        elif isinstance(node, ast.Compare) and \
                getattr(node.left, "id", None) == "op":
            for c in node.comparators:
                for e in ([c] if isinstance(c, ast.Constant) else
                          getattr(c, "elts", [])):
                    ops.add(e.value)
    return ops, hello


def test_control_wire_matches_jax_module():
    """Op for op and key for key: the port sends and matches the JAX
    module's control ops, and its hello carries the JAX hello's keys."""
    ops, hello = _wire(ROOT / "paddle_tpu_torch/inference/process_fleet.py")
    jops, jhello = _wire(ROOT / "paddle_tpu/inference/process_fleet.py")
    assert ops == jops
    assert {"hello", "ack", "tok", "done", "health_reply", "series", "bye",
            "submit", "adopt", "cancel", "health", "fault", "fault_clear",
            "quarantine", "clock_sync", "metrics_series", "trace",
            "shutdown", "ctl_reply"} == ops
    assert hello == jhello and len(hello) == 13


def test_respawn_breaker_backoff_circuit_and_window():
    """tests/test_control_plane_ha.py:193, then the JAX breaker on the
    same clock: the same backoffs, the same open circuit, the same
    state view."""
    J = _jpf()
    clock = [0.0]
    naps = []
    brs = [M._RespawnBreaker(backoff_s=0.5, max_respawns=3, window_s=60.0,
                             clock=lambda: clock[0], sleep=naps.append)
           for M in (PF, J)]
    br = brs[0]
    assert br.admit("r0") == 0.0                 # first respawn is free
    assert br.admit("r0") == 0.5                 # then 0.5 * 2**(k-1)
    assert br.admit("r0") == 1.0
    with pytest.raises(RespawnCircuitOpen):
        br.admit("r0")
    assert br.state()["r0"]["open"]
    assert br.admit("r1") == 0.0                 # slots are independent
    clock[0] = 61.0                              # window drains: closed
    assert not br.state()["r0"]["open"]
    assert br.admit("r0") == 0.0
    br.reset("r0")
    assert "r0" not in br.state()
    assert naps == []                            # admit never sleeps

    clock[0] = 0.0
    trace = [[], []]
    for i, b in enumerate(brs):
        b.reset()
        for t, name in [(0, "a"), (1, "a"), (2, "b"), (3, "a"), (4, "a"),
                        (70, "a"), (71, "b"), (72, "a")]:
            clock[0] = float(t)
            try:
                trace[i].append(b.admit(name))
            except RuntimeError as e:
                trace[i].append(type(e).__name__)
        trace[i].append(b.state())
    assert trace[0] == trace[1]
    assert trace[0][4] == "RespawnCircuitOpen"


def test_cuda_child_without_a_card_raises():
    """A replica asked for the card on a machine without one raises
    while it builds its model: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PF._build_model({"preset": "tiny", "seed": 0}, "proc0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PF._build_model({"preset": "tiny", "device": "cuda:0"}, "proc0")
