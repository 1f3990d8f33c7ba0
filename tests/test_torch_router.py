"""The port's router host pieces (`paddle_tpu_torch/inference/router.py`)
against the JAX package's: the fair queue's pop order, the prefix
shadow's matches and LRU cap, the autoscale policy's verdicts, and the
routing journal's JSONL records, which cross both ways (a journal
written by either package's `RoutingJournal` replays in the other's
with equal `replay()` / `incomplete()`, torn tail and compacted file
included).  Then the `inference` exports: the port's `__all__` holds
every name of the JAX package's but those a ROADMAP item still owns,
read from the JAX `__init__` with `ast` (no JAX import)."""

import ast
import json
import random
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.inference as TI
from paddle_tpu_torch.inference import (AutoscalePolicy, PrefixShadow,
                                        QueueFull, RouterRequest,
                                        RoutingJournal)
from paddle_tpu_torch.inference.router import _FairQueue

ROOT = Path(__file__).resolve().parents[1]

# JAX `inference` names the port does not export yet, by the ROADMAP
# item that ports them
MISSING = {
    "Config": "7", "create_predictor": "7", "Predictor": "7",
    "PrecisionType": "7",
}
TIERS = ("interactive", "standard", "batch")


def _jax_all():
    tree = ast.parse((ROOT / "paddle_tpu/inference/__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError("no __all__ in the JAX inference package")


def _jr():
    pytest.importorskip("jax")
    from paddle_tpu.inference import router
    return router


# -- exports -----------------------------------------------------------------


def test_inference_exports_cover_jax():
    jax_names = _jax_all()
    assert len(jax_names) == len(set(jax_names)) > 30
    missing = sorted(n for n in jax_names if n not in TI.__all__)
    assert missing == sorted(MISSING)
    for name in TI.__all__:
        assert getattr(TI, name) is not None
    from paddle_tpu_torch.inference import (  # noqa: F401
        AutoscalePolicy, PoisonedRequest, PrefixShadow, RadixPrefixCache,
        Router, RouterRequest, RoutingJournal, StaleRouterEpoch)


def test_missing_exports_name_their_roadmap_item():
    """Each name still missing is named in ROADMAP.md beside its item;
    none of them is importable from the port."""
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for name, item in MISSING.items():
        assert not hasattr(TI, name), name
        assert name in roadmap, name
    assert set(MISSING.values()) == {"7"}


# -- fair queue ----------------------------------------------------------------


class _Item:
    def __init__(self, name, tier=None):
        self.name = name
        self.tier = tier


def _queue_trace(Q, QFull, ops, max_queue, weights):
    """Run `ops` on a fresh queue; the pops' names and every rejection."""
    q = Q(max_queue=max_queue, tier_weights=weights)
    out = []
    for op in ops:
        kind = op[0]
        if kind == "push":
            _, name, tier, client, force = op
            try:
                q.push(_Item(name, tier), client, force=force)
                out.append(("ok", name))
            except QFull:
                out.append(("full", name))
        elif kind == "front":
            _, name, tier, client = op
            q.push_front(_Item(name, tier), client)
        else:
            item = q.pop(0.001)
            out.append(("pop", None if item is None else item.name))
    out.append(("depths", tuple(sorted(q.depths().items())), len(q)))
    return out


def _random_ops(seed, n=120):
    rng = random.Random(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        tier = rng.choice(TIERS + (None,))
        client = rng.choice("abcd")
        if r < 0.5:
            ops.append(("push", f"i{i}", tier, client, rng.random() < 0.2))
        elif r < 0.6:
            ops.append(("front", f"f{i}", tier, client))
        else:
            ops.append(("pop",))
    return ops + [("pop",)] * 20


def test_fair_queue_round_robin_bound_and_resubmit_bypass():
    q = _FairQueue(max_queue=3)
    q.push("a1", "a")
    q.push("a2", "a")
    q.push("b1", "b")
    with pytest.raises(QueueFull):
        q.push("a3", "a")
    q.push("c1", "c", force=True)
    q.push_front("a0", "a")
    assert [q.pop(0.1) for _ in range(5)] == ["a0", "b1", "c1", "a1", "a2"]
    assert q.pop(0.01) is None and len(q) == 0


@pytest.mark.parametrize("weights", [None, {"batch": 3},
                                     {"interactive": 1, "standard": 1}])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_queue_pop_order_equals_jax(seed, weights):
    """The same pushes (tiers, clients, forced pushes past the bound,
    resubmissions at the front) and pops give the same pop order, the
    same rejections and the same depths as the JAX queue."""
    jr = _jr()
    from paddle_tpu.inference.engine import QueueFull as JQueueFull
    ops = _random_ops(seed)
    mine = _queue_trace(_FairQueue, QueueFull, ops, 6, weights)
    assert mine == _queue_trace(jr._FairQueue, JQueueFull, ops, 6, weights)
    assert any(o[0] == "full" for o in mine)


def test_fair_queue_weighted_rotation():
    """All three tiers backlogged: of each 7 pops interactive gets 4,
    standard 2, batch 1."""
    q = _FairQueue()
    for tier in TIERS:
        for i in range(8):
            q.push(_Item(f"{tier[0]}{i}", tier), "c")
    got = [q.pop(0.01).name[0] for _ in range(14)]
    assert got == list("iiiissb") * 2


# -- prefix shadow ---------------------------------------------------------------


def test_prefix_shadow_match_and_lru_cap():
    s = PrefixShadow(block_tokens=4, max_blocks=3)
    s.observe(np.arange(10))
    assert s.match_tokens(np.arange(10)) == 8
    assert s.match_tokens(np.arange(12)) == 8
    assert s.match_tokens(np.arange(8)) == 4
    assert s.match_tokens(np.arange(3)) == 0
    assert s.match_tokens(np.arange(100, 110)) == 0
    s.observe(np.arange(50, 62))
    assert s.match_tokens(np.arange(50, 62)) == 8
    assert s.match_tokens(np.arange(10)) == 0
    s.clear()
    assert len(s) == 0 and s.match_tokens(np.arange(50, 62)) == 0
    assert PrefixShadow(0, 8).match_tokens(np.arange(40)) == 0


@pytest.mark.parametrize("bt,cap", [(4, 3), (8, 16), (16, 5)])
def test_prefix_shadow_equals_jax(bt, cap):
    """Random observes and matches over a few shared stems: every match
    and every size equal the JAX shadow's (the LRU order included:
    matches refresh entries)."""
    jr = _jr()
    rng = np.random.RandomState(bt + cap)
    stems = [rng.randint(0, 50, (40,)) for _ in range(4)]
    mine, theirs = PrefixShadow(bt, cap), jr.PrefixShadow(bt, cap)
    for _ in range(150):
        p = stems[rng.randint(4)][:rng.randint(1, 41)].copy()
        if rng.rand() < 0.2 and p.size:
            p[rng.randint(p.size)] += 1
        if rng.rand() < 0.4:
            mine.observe(p)
            theirs.observe(p)
        else:
            assert mine.match_tokens(p) == theirs.match_tokens(p)
        assert len(mine) == len(theirs) <= cap


# -- autoscale policy --------------------------------------------------------------


def test_autoscale_policy_thresholds():
    p = AutoscalePolicy(queue_high=4, ttft_high_s=1.0, occupancy_low=0.25,
                        min_replicas=1, max_replicas=3)
    sig = dict(replicas=2, queue_depth=0, replica_queue_depth=0,
               occupancy=0.8, ttft_p50_s=0.1)
    assert p.evaluate(sig) == 0
    assert p.evaluate({**sig, "queue_depth": 5}) == +1
    assert p.evaluate({**sig, "ttft_p50_s": 2.0}) == +1
    assert p.evaluate({**sig, "occupancy": 0.1}) == -1
    assert p.evaluate({**sig, "occupancy": 0.1, "replicas": 1}) == 0
    assert p.evaluate({**sig, "queue_depth": 9, "replicas": 3}) == 0
    assert p.evaluate({**sig, "replicas": 0}) == +1
    # a batch backlog buys a replica only batch_backlog_factor deeper
    tq = {"interactive": 0, "standard": 0, "batch": 5}
    assert p.evaluate({**sig, "queue_depth": 5,
                       "tier_queue_depth": tq}) == 0
    assert p.evaluate({**sig, "queue_depth": 16,
                       "tier_queue_depth": dict(tq, batch=16)}) == +1


@pytest.mark.parametrize("knobs", [
    {}, dict(queue_high=3, ttft_high_s=0.5),
    dict(queue_high=2, occupancy_low=0.5, min_replicas=2, max_replicas=4),
    dict(queue_high=5, batch_backlog_factor=2, ttft_high_s=2.0)])
def test_autoscale_policy_equals_jax(knobs):
    jr = _jr()
    mine, theirs = AutoscalePolicy(**knobs), jr.AutoscalePolicy(**knobs)
    rng = random.Random(str(knobs))
    seen = set()
    for _ in range(400):
        sig = dict(replicas=rng.randint(0, 5),
                   queue_depth=rng.randint(0, 6),
                   replica_queue_depth=rng.randint(0, 6),
                   occupancy=rng.random(), ttft_p50_s=3 * rng.random())
        if rng.random() < 0.5:
            sig["preempted"] = rng.randint(0, 3)
        if rng.random() < 0.5:
            sig["tier_queue_depth"] = {t: rng.randint(0, 12) for t in TIERS}
        got = mine.evaluate(sig)
        assert got == theirs.evaluate(sig), sig
        seen.add(got)
    assert seen == {-1, 0, 1}


# -- the routing journal -------------------------------------------------------------


def _write_history(J, path, compact_bytes=None, n_done=12):
    """A mix of finished and unfinished requests, written by `J`."""
    j = J(path, compact_bytes=compact_bytes)
    for i in range(n_done):
        rid = f"done{i}"
        j.record("accept", rid, prompt=[i, i + 1], max_new_tokens=2,
                 client="", params={"tier": "batch", "trace_id": f"t{i}"},
                 trace_id=f"t{i}")
        j.record("route", rid, replica="replica0", attempt=1)
        j.record("tok", rid, t=i)
        j.record("done" if i % 3 else "failed", rid, n=1,
                 **({} if i % 3 else {"error": "PoisonedRequest"}))
    j.record("accept", "r1", prompt=[1, 2, 3], max_new_tokens=4,
             client="c", params={"seed": 7, "temperature": 0.5})
    j.record("route", "r1", replica="replica1", attempt=2)
    for t in (11, 12):
        j.record("tok", "r1", t=t)
    j.record("failover", "r1", replica="replica1")
    j.record("migrate", "r1", replica="replica0", attempt=3)
    j.record("accept", "r2", prompt=[9], max_new_tokens=2, client="",
             params={})
    j.record("tok", "nobody", t=5)      # a record with no accept: skipped
    return j


@pytest.mark.parametrize("variant", ["plain", "torn", "compacted",
                                     "auto_compacted"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_crosses_packages(tmp_path, writer, variant):
    """A journal written by one package's RoutingJournal replays in the
    other's with equal `replay()` and `incomplete()`; a torn final line
    ends both replays at the same record, and a compacted file (by
    `compact()` or by the size trigger) replays to the original's
    incomplete map in both."""
    jr = _jr()
    W = RoutingJournal if writer == "port" else jr.RoutingJournal
    path = str(tmp_path / "j.jsonl")
    j = _write_history(W, path, compact_bytes=(
        600 if variant == "auto_compacted" else None))
    before = RoutingJournal.incomplete(path)
    if variant == "compacted":
        j.compact()
    j.close()
    if variant == "torn":
        with open(path, "a") as f:
            f.write('{"ev": "tok", "rid": "r1", "t":')
    assert set(before) == {"r1", "r2"}
    assert (j.compactions >= 1) == variant.endswith("compacted")
    mine = RoutingJournal.replay(path)
    theirs = jr.RoutingJournal.replay(path)
    assert mine == theirs
    assert RoutingJournal.incomplete(path) == \
        jr.RoutingJournal.incomplete(path)
    inc = RoutingJournal.incomplete(path)
    assert set(inc) == {"r1", "r2"}
    assert inc["r1"]["delivered"] == [11, 12]
    assert inc["r1"]["params"] == {"seed": 7, "temperature": 0.5}
    assert inc == before


def test_journal_records_equal_jax_bytes(tmp_path):
    """The same record calls write the same bytes in both packages."""
    jr = _jr()
    paths = []
    for J in (RoutingJournal, jr.RoutingJournal):
        p = str(tmp_path / f"{J.__module__}.jsonl")
        _write_history(J, p).close()
        paths.append(p)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and a.count(b"\n") > 40
    compacted = []
    for J, p in zip((RoutingJournal, jr.RoutingJournal), paths):
        j = J(p)
        j.compact()
        j.close()
        compacted.append(open(p, "rb").read())
    assert compacted[0] == compacted[1]


def test_journal_replay_incomplete_and_torn_tail(tmp_path):
    path = tmp_path / "journal.jsonl"
    j = RoutingJournal(path)
    j.record("accept", "r1", prompt=[1, 2, 3], max_new_tokens=4,
             client="c", params={"seed": 7})
    j.record("route", "r1", replica="replica0", attempt=1)
    j.record("tok", "r1", t=11)
    j.record("tok", "r1", t=12)
    j.record("accept", "r2", prompt=[9], max_new_tokens=2, client="",
             params={})
    j.record("done", "r2", n=0)
    j.close()
    with open(path, "a") as f:
        f.write('{"ev": "tok", "rid": "r1", "t":')
    inc = RoutingJournal.incomplete(path)
    assert list(inc) == ["r1"]
    st = inc["r1"]
    assert st["prompt"] == [1, 2, 3] and st["delivered"] == [11, 12]
    assert st["replica"] == "replica0" and st["params"] == {"seed": 7}
    assert RoutingJournal.replay(tmp_path / "absent.jsonl") == {}


def test_journal_compaction_rearms_on_appended_bytes(tmp_path):
    path = tmp_path / "live.jsonl"
    j = RoutingJournal(path, compact_bytes=512)
    for i in range(20):
        j.record("accept", f"r{i}", prompt=list(range(10)),
                 max_new_tokens=4, client="c", params={})
    first = j.compactions
    assert first >= 1
    assert path.stat().st_size > 512
    for i in range(20):
        j.record("tok", "r0", t=i)
    assert j.compactions - first <= 1
    j.close()
    inc = RoutingJournal.incomplete(path)
    assert set(inc) == {f"r{i}" for i in range(20)}
    assert inc["r0"]["delivered"] == list(range(20))


def test_journal_subscribers_see_lines_and_resets(tmp_path):
    path = str(tmp_path / "sub.jsonl")
    j = RoutingJournal(path)
    j.record("accept", "r0", prompt=[1], max_new_tokens=1, client="",
             params={})
    seen = []
    snap = j.subscribe_with_snapshot(lambda kind, data: seen.append(kind))
    assert json.loads(snap)["rid"] == "r0"
    j.subscribe(lambda kind, data: 1 / 0)      # a sick subscriber is ignored
    j.record("done", "r0", n=0)
    j.compact()
    j.close()
    assert seen == ["line", "reset"]


# -- the request handle ----------------------------------------------------------


def test_router_request_params_survive_the_journal():
    rr = RouterRequest([1, 2, 3], 4, client="c", tier="batch", seed=3)
    assert rr.tier == "batch" and rr.params["tier"] == "batch"
    assert rr.params["trace_id"] == rr.trace_id and rr.trace_id
    assert rr.rid.startswith("rr") and rr.prompt.dtype == np.int32
    assert not rr.expired()
    assert RouterRequest([1], 1, trace_id="keep").trace_id == "keep"
    with pytest.raises(ValueError):
        RouterRequest([1], 1, deadline=0)
    with pytest.raises(ValueError):
        RouterRequest([1], 1, tier="gold")
