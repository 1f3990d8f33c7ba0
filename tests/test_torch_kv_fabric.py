"""The port's KV fabric (engine sub-slice (h): `inference/kv_fabric.py`,
`LLMEngine(fabric=)`, `Request(prefix_hint=, session_id=)`,
`LLMServer.adopt`) against the JAX package's, at the knobs of its own
suite (tests/test_kv_fabric.py, tests/test_kv_integrity.py,
tests/test_longctx_serving.py): the `tiny` preset, fp32 and bf16, the
same weights in both packages.

  * the wire: `pack_leaves`, `SessionTicket.to_bytes`,
    `prefix_block_key` and the engine's `_fabric_fp` give the JAX
    functions' bytes for the same inputs (fp32, bf16, int8 pools), and
    each package parses the other's frames, tickets and disk entries;
    torn bytes raise FabricError, one flipped byte IntegrityError;
  * every move is exact: a pulled prefix, a ticket adopted from a peer
    or the disk tier, a disk-parked or disk-warm stream, each equals
    the same engine's stream without the move token for token (greedy
    streams hold no tolerance), and the fp32 streams equal the JAX
    engine's; across the packages a port server pulls from a JAX server
    (and back) and adopts a JAX server's parked session;
  * every failure degrades: an injected pull / push fault, a torn disk
    ticket and a flipped byte in a parked host copy each give the
    stream without the move, never a lost request, and the flip is
    metered (`kv_integrity_failures_total{path="swap"}`);
  * the tiered engine's disk leg meters a blocking prefetch miss as the
    JAX engine does, and a ticket carries the tier map (`cold_idx`).
"""

import glob
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (DiskTier, FabricError, LLMEngine,
                                        LLMServer, SessionTicket)
from paddle_tpu_torch.inference import kv_fabric as TF
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.testing import faults

# the JAX suite's servers (tests/test_kv_fabric.py:40-51): prefix pull
# with the radix cache at the block size, and a tight pool where two
# streams oversubscribe it so the second parks mid-decode
KW = dict(max_slots=2, max_len=64, max_prompt_len=32, min_bucket=8,
          prefill_chunk=8, kv_block_tokens=8, prefix_cache_blocks=8,
          prefix_block_tokens=8)
MIG_KW = dict(max_slots=2, max_len=64, max_prompt_len=32, min_bucket=8,
              prefill_chunk=8, kv_block_tokens=8, kv_blocks=9,
              preempt_policy="swap")
P_LONG = (np.arange(3, 3 + 9) % 50).astype(np.int32)     # fills the pool
P_MIG = (np.arange(7, 7 + 9) % 50).astype(np.int32)      # parks, migrates
P_PULL = (np.arange(11, 11 + 17) % 50).astype(np.int32)  # two cached blocks
WAIT = 120.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(dtype, seed):
    """(JAX tiny model, port tiny model with its weights)."""
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


def _jf():
    from paddle_tpu.inference import kv_fabric as JF
    return JF


def _wait(pred, msg, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {msg}")


def _fab(server):
    return server.health_snapshot()["fabric"]


def _jax_stream(jm, prompt, max_new, kw, **req):
    from paddle_tpu.inference import LLMEngine as JEngine
    eng = JEngine(jm, **kw)
    r = eng.submit(prompt, max_new_tokens=max_new, **req)
    eng.run()
    return list(r.tokens)


# -- the wire: bytes equal to the JAX package's, both ways -------------------


def test_pack_leaves_bytes_match_jax():
    """fp32, int8, uint32 and bf16 leaves (numpy, ml_dtypes and torch
    tensors): the port's meta and payload are the JAX function's, and
    each package unpacks the other's payload to the same bytes."""
    import ml_dtypes
    JF = _jf()
    bf = np.linspace(-2, 2, 8).astype(ml_dtypes.bfloat16)
    ref = [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
           (np.arange(12) - 6).astype(np.int8).reshape(3, 4),
           np.arange(6, dtype=np.uint32), bf]
    jmeta, jpay = JF.pack_leaves(ref)
    for leaves in (ref, [torch.from_numpy(ref[0]), torch.from_numpy(ref[1]),
                         ref[2], torch.from_numpy(bf.view(np.int16)).view(
                             torch.bfloat16)]):
        meta, payload = TF.pack_leaves(leaves)
        assert meta == jmeta and payload == jpay
    out = TF.unpack_leaves(jmeta, jpay)
    assert [a.tobytes() for a in out] == [a.tobytes() for a in ref]
    assert out[3].dtype == np.uint16          # bf16 as raw 2-byte words
    assert torch.equal(torch.from_numpy(out[3].view(np.int16).copy()).view(
        torch.bfloat16).float(), torch.from_numpy(bf.astype(np.float32)))
    back = JF.unpack_leaves(*TF.pack_leaves(ref))
    assert [a.dtype for a in back] == [a.dtype for a in ref]


def test_unpack_torn_and_flipped_payload_raises():
    meta, payload = TF.pack_leaves([np.arange(64, dtype=np.float32)])
    with pytest.raises(FabricError):
        TF.unpack_leaves(meta, payload[:-4])
    with pytest.raises(FabricError):
        TF.unpack_leaves(meta, payload + b"\x00" * 4)
    flipped = bytearray(payload)
    flipped[37] ^= 0x04
    with pytest.raises(TF.IntegrityError):
        TF.unpack_leaves(meta, bytes(flipped))
    with pytest.raises(_jf().IntegrityError):     # the JAX side agrees
        _jf().unpack_leaves(meta, bytes(flipped))


def _ticket_fields(**over):
    return dict(dict(
        session_id="s1", prompt=[1, 2, 3], tokens=[9, 8],
        max_new_tokens=16, temperature=0.7, top_p=0.9, greedy=False,
        eos_token_id=None, seed=5, mode="swap", token=8, pos=4,
        keys=[1, 2], spec_k=0, spec_ema=1.0, n_blocks=1,
        fingerprint="fp", t_export=123.0,
        kv_meta=[{"dtype": "float32", "shape": [4]}],
        kv_payload=np.arange(4, dtype=np.float32).tobytes(),
        cold_idx=[2, 5]), **over)


def test_session_ticket_bytes_match_jax_and_truncation():
    JF = _jf()
    t = SessionTicket(**_ticket_fields())
    data = t.to_bytes()
    assert data == JF.SessionTicket(**_ticket_fields()).to_bytes()
    for back in (SessionTicket.from_bytes(data),
                 JF.SessionTicket.from_bytes(data)):
        for f in SessionTicket._HEAD_FIELDS + ("cold_idx",):
            assert getattr(back, f) == getattr(t, f), f
        assert back.kv_payload == t.kv_payload
    assert SessionTicket._HEAD_FIELDS == JF.SessionTicket._HEAD_FIELDS
    for cut in (10, 20, len(data) - 1):
        with pytest.raises(FabricError):
            SessionTicket.from_bytes(data[:cut])
    flipped = bytearray(data)
    flipped[len(data) // 2] ^= 0x01
    with pytest.raises(TF.IntegrityError):
        SessionTicket.from_bytes(bytes(flipped))


def test_prefix_block_key_matches_jax():
    JF = _jf()
    toks = np.arange(32)
    k1 = TF.prefix_block_key(toks, 1, 8, "fp")
    assert k1 == JF.prefix_block_key(toks, 1, 8, "fp")
    assert k1 == TF.prefix_block_key(toks.copy(), 1, 8, "fp")
    assert k1 != TF.prefix_block_key(toks, 0, 8, "fp")
    assert k1 != TF.prefix_block_key(toks, 1, 8, "other-fp")
    bumped = toks.copy()
    bumped[0] += 1          # block 1's KV depends on block 0's tokens
    assert k1 != TF.prefix_block_key(bumped, 1, 8, "fp")
    tail = toks.copy()
    tail[20] += 1           # ... but not on tokens past its own end
    assert k1 == TF.prefix_block_key(tail, 1, 8, "fp")


def test_disk_tier_claims_restart_and_jax_reads_it(tmp_path):
    """Blocks idempotent per key, exactly-once claims, the manifest
    replayed at restart past a torn tmp file, a torn block, a torn
    append and a flipped record; LRU eviction by bytes; a JAX DiskTier
    over the same root reads the port's blocks."""
    d = DiskTier(tmp_path)
    assert d.put_block("k1", {"a": 1}, b"onexyz")
    assert not d.put_block("k1", {"a": 2}, b"zzz")
    assert d.put_block("k2", {"b": 2}, b"two")
    assert d.get_block("k1") == ({"a": 1}, b"onexyz")
    d.put_session("sess", b"ticket-bytes")
    assert d.has_session("sess") and d.list_sessions()
    assert d.claim_session("sess") == b"ticket-bytes"
    assert d.claim_session("sess") is None           # exactly one claimant

    d.put_block("torn", {"n": 2}, b"B" * 64)
    with open(os.path.join(str(tmp_path), "blocks", "half.tmp"), "wb") as f:
        f.write(b"partial")
    with open(os.path.join(str(tmp_path), "blocks", "torn"), "r+b") as f:
        f.truncate(16)
    jd = _jf().DiskTier(tmp_path)       # the JAX tier replays the port's
    assert jd.get_block("k1") == ({"a": 1}, b"onexyz")
    with open(os.path.join(str(tmp_path), "manifest.jsonl"), "a") as f:
        f.write('{"key": "torn-tail", "si')
    d2 = DiskTier(tmp_path)
    assert not os.path.exists(os.path.join(str(tmp_path), "blocks",
                                           "half.tmp"))
    assert d2.torn_skipped == 1 and not d2.has_block("torn")
    assert d2.get_block("k2") == ({"b": 2}, b"two")
    assert d2.n_blocks == 2 and d2.bytes_used == 9

    root2 = tmp_path / "flip"
    d3 = DiskTier(root2, capacity_bytes=100)
    d3.put_block("a", {}, b"A" * 60)
    d3.put_block("b", {}, b"B" * 60)           # evicts "a" (LRU)
    assert d3.evictions == 1 and not d3.has_block("a")
    man = os.path.join(str(root2), "manifest.jsonl")
    lines = open(man, "rb").read().splitlines()
    lines[-2] = lines[-2].replace(b'"size": 60', b'"size": 61')
    open(man, "wb").write(b"\n".join(lines) + b"\n")
    assert DiskTier(root2).integrity_failures["manifest"] == 1


@pytest.mark.parametrize("dtype,kv", [("float32", "auto"),
                                      ("float32", "int8"),
                                      ("float32", "bfloat16"),
                                      ("bfloat16", "auto"),
                                      ("bfloat16", "int8")])
def test_fabric_fingerprint_matches_jax(models, dtype, kv):
    from paddle_tpu.inference import LLMEngine as JEngine
    jm, tm = models[dtype]
    kw = dict(MIG_KW, kv_dtype=kv)
    assert LLMEngine(tm, **kw)._fabric_fp == JEngine(jm, **kw)._fabric_fp


# -- remote prefix pull ------------------------------------------------------


def _servers(model, n=2, **kw):
    return [LLMServer(model, name=f"fab{i}", fabric={"timeout": 10.0},
                      **dict(KW, **kw)) for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remote_pull_equals_recompute_and_jax(models, dtype):
    jm, tm = models[dtype]
    a, b = _servers(tm)
    try:
        ref = a.result(a.submit(P_PULL, 8), timeout=WAIT)
        hint = {"addr": list(a.fabric_address), "tokens": 16}
        out = b.result(b.submit(P_PULL, 8, prefix_hint=hint), timeout=WAIT)
        assert out == ref
        fb = _fab(b)
        assert fb["blocks_moved"]["pull"] == 2
        assert fb["bytes_moved"]["pull"] == 2 * b.engine._kv_block_bytes
        assert fb["prefill_tokens_saved_remote"] == 16
        assert _fab(a)["blocks_moved"]["pull"] == 0
        assert fb["integrity_failures"]["pull"] == 0
    finally:
        a.shutdown()
        b.shutdown()
    assert ref == _jax_stream(jm, P_PULL, 8, KW)


@pytest.mark.parametrize("site", ["fabric.pull", "fabric.push"])
def test_pull_fault_falls_back_to_recompute(models, harness, site):
    tm = models["float32"][1]
    a, b = _servers(tm)
    try:
        ref = a.result(a.submit(P_PULL, 8), timeout=WAIT)
        rule = harness.inject(site, times=None)
        hint = {"addr": list(a.fabric_address), "tokens": 16}
        out = b.result(b.submit(P_PULL, 8, prefix_hint=hint), timeout=WAIT)
        assert out == ref and rule.fired >= 1
        assert _fab(b)["blocks_moved"]["pull"] == 0
        assert _fab(b)["prefill_tokens_saved_remote"] == 0
    finally:
        a.shutdown()
        b.shutdown()


@pytest.mark.parametrize("direction", ["port_pulls_jax", "jax_pulls_port"])
def test_cross_package_pull(models, direction):
    """A pull over TCP between a JAX LLMServer and a port LLMServer: the
    puller's stream equals the holder's, and the blocks moved."""
    from paddle_tpu.inference import LLMServer as JServer
    jm, tm = models["float32"]
    js = JServer(jm, name="jaxfab", fabric={"timeout": 10.0}, **KW)
    ts = LLMServer(tm, name="portfab", fabric={"timeout": 10.0}, **KW)
    holder, puller = (js, ts) if direction == "port_pulls_jax" else (ts, js)
    try:
        ref = holder.result(holder.submit(P_PULL, max_new_tokens=8),
                            timeout=WAIT)
        hint = {"addr": list(holder.fabric_address), "tokens": 16}
        out = puller.result(puller.submit(P_PULL, max_new_tokens=8,
                                          prefix_hint=hint), timeout=WAIT)
        assert list(out) == list(ref)
        fb = _fab(puller)
        assert fb["blocks_moved"]["pull"] == 2
        assert fb["prefill_tokens_saved_remote"] == 16
    finally:
        js.shutdown()
        ts.shutdown()


# -- live migration: park on A mid-decode, adopt on B ------------------------


def _park_then(model, kw, adopt, sid="sess-mig"):
    """The oversubscribing traffic on a fresh server until the second
    stream parks mid-decode, then `adopt(a, r2)`; returns (r1, r2)."""
    a = LLMServer(model, name="migA", **kw)
    try:
        r1 = a.submit(P_LONG, max_new_tokens=55)
        r2 = a.submit(P_MIG, max_new_tokens=24, seed=5, session_id=sid,
                      priority=-1)
        _wait(lambda: a.engine.num_parked >= 1, "a park under pressure")
        assert not r2.done
        adopt(a, r2)
        a.result(r1, timeout=WAIT)
        assert len(r1.tokens) == 55
        return r1, r2
    finally:
        a.shutdown()


@pytest.mark.parametrize("kind", ["peer", "disk"])
@pytest.mark.parametrize("dtype,kv", [("float32", "auto"),
                                      ("float32", "int8"),
                                      ("bfloat16", "auto"),
                                      ("bfloat16", "int8")])
def test_migration_equals_uninterrupted(models, tmp_path, dtype, kv, kind):
    """A parked session adopted by a peer over the wire, or by claim
    from the disk tier, continues with the uninterrupted stream; the
    disk claim happens once (a second adoption raises KeyError, the
    source's own resume sees the claim and ends `migrated`)."""
    jm, tm = models[dtype]
    fab = {"timeout": 10.0}
    if kind == "disk":
        fab["disk_root"] = str(tmp_path)
    kw = dict(MIG_KW, kv_dtype=kv, fabric=fab)
    b = LLMServer(tm, name="migB", **kw)
    try:
        ref = b.result(b.submit(P_MIG, 24, seed=5), timeout=WAIT)

        def adopt(a, r2):
            if kind == "peer":
                req = b.adopt({"kind": "peer",
                               "addr": list(a.fabric_address),
                               "session_id": "sess-mig"})
            else:
                _wait(lambda: _fab(a)["disk_sessions"] >= 1,
                      "the parked ticket on the disk tier")
                req = b.adopt({"kind": "disk", "session_id": "sess-mig"})
                with pytest.raises(KeyError):
                    b.adopt({"kind": "disk", "session_id": "sess-mig"})
            assert b.result(req, timeout=WAIT) == ref
            _wait(lambda: r2.done, "the source's hand-off")
            assert r2.migrated and r2.error is None
            fb = _fab(b)
            assert fb["blocks_moved"]["migrate"] >= 1
            assert fb["bytes_moved"]["migrate"] > 0

        _park_then(tm, kw, adopt)
        assert all(v == 0 for v in _fab(b)["integrity_failures"].values())
    finally:
        b.shutdown()
    if dtype == "float32":
        assert ref == _jax_stream(jm, P_MIG, 24, dict(MIG_KW, kv_dtype=kv),
                                  seed=5)


def test_cross_package_ticket(models):
    """A greedy session parked on a JAX server, adopted live by a port
    server: its continuation equals the JAX uninterrupted stream."""
    from paddle_tpu.inference import LLMServer as JServer
    jm, tm = models["float32"]
    kw = dict(MIG_KW, fabric={"timeout": 10.0})
    ref = _jax_stream(jm, P_MIG, 24, MIG_KW, seed=5)
    b = LLMServer(tm, name="portB", **kw)
    a = JServer(jm, name="jaxA", **kw)
    try:
        r1 = a.submit(P_LONG, max_new_tokens=55)
        r2 = a.submit(P_MIG, max_new_tokens=24, seed=5,
                      session_id="sess-x", priority=-1)
        _wait(lambda: a.engine.num_parked >= 1, "a park on the JAX server")
        req = b.adopt({"kind": "peer", "addr": list(a.fabric_address),
                       "session_id": "sess-x"})
        assert b.result(req, timeout=WAIT) == ref
        assert r2.migrated and a.result(r1, timeout=WAIT)
        assert _fab(b)["blocks_moved"]["migrate"] >= 1
    finally:
        a.shutdown()
        b.shutdown()


# -- the disk tier -----------------------------------------------------------


def test_disk_parks_and_torn_ticket_recomputes(models, tmp_path):
    """No host tier: a park spills its blocks as a ticket to the disk
    tier ("disk" mode) and resumes from it with the stream of full
    provisioning; a ticket torn while parked degrades to recompute with
    the same stream."""
    tm = models["float32"][1]
    full = LLMEngine(tm, **dict(MIG_KW, kv_blocks=None))
    r1 = full.submit(P_LONG, 55)
    r2 = full.submit(P_MIG, 24, seed=5)
    full.run()
    ref = (list(r1.tokens), list(r2.tokens))
    for tear in (False, True):
        root = tmp_path / f"tear{int(tear)}"
        kw = dict(MIG_KW, host_pool_blocks=0,
                  fabric={"disk_root": str(root), "timeout": 10.0})
        modes = []

        def adopt(a, r2, tear=tear, root=root, modes=modes):
            modes.extend(p.mode for p in list(a.engine._parked))
            assert _fab(a)["blocks_moved"]["spill"] >= 1
            if tear:
                tickets = glob.glob(os.path.join(str(root), "sessions",
                                                 "*.ticket"))
                assert tickets
                with open(tickets[0], "r+b") as f:
                    f.truncate(6)
            assert a.result(r2, timeout=WAIT) == ref[1]
            if not tear:
                assert _fab(a)["blocks_moved"]["pull"] >= 1

        r1, _ = _park_then(tm, kw, adopt)
        assert list(r1.tokens) == ref[0]
        assert "disk" in modes


def test_disk_prefix_survives_restart_and_jax_reads_it(models, tmp_path):
    """A prefill writes its fresh prefix blocks through to the disk
    tier; a new port engine over the same root serves the prompt warm,
    and so does a JAX engine: equal streams, blocks pulled from disk."""
    from paddle_tpu.inference import LLMServer as JServer
    jm, tm = models["float32"]
    kw = dict(KW, fabric={"disk_root": str(tmp_path), "timeout": 10.0})
    a = LLMServer(tm, name="bootA", **kw)
    try:
        ref = a.result(a.submit(P_PULL, 8), timeout=WAIT)
        assert _fab(a)["disk_blocks"] == 2
        assert _fab(a)["blocks_moved"]["spill"] == 2
    finally:
        a.shutdown()
    with open(os.path.join(str(tmp_path), "blocks", "crash.tmp"), "wb") as f:
        f.write(b"partial")
    for cls in (LLMServer, JServer):
        s = cls(tm if cls is LLMServer else jm, name="boot2", **kw)
        try:
            out = s.result(s.submit(P_PULL, max_new_tokens=8), timeout=WAIT)
            assert list(out) == ref
            fb = _fab(s)
            assert fb["blocks_moved"]["pull"] == 2
            assert fb["prefill_tokens_saved_remote"] == 16
        finally:
            s.shutdown()


# the JAX suite's tiered knobs (tests/test_longctx_serving.py:249-274)
TIER_KW = dict(max_len=96, max_prompt_len=48)
HEADS = dict(num_attention_heads=8, num_key_value_heads=4)


def test_prefetch_disk_leg_meters_like_jax(tmp_path):
    """A tiered engine whose admission needs a disk-tier prefix its
    prefetcher has not warmed pays the blocking load: the port meters
    `kv_prefetch_miss_total` and `prefetch_wait_seconds` as the JAX
    engine does, with the writer's stream."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.inference import LLMEngine as JEngine
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("tiny", **HEADS))
    tm = TModel(TConfig.from_preset("tiny", **HEADS), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    prompt = np.random.RandomState(17).randint(0, 256, (40,))
    got = {}
    for name, cls, m in (("jax", JEngine, jm), ("port", LLMEngine, tm)):
        kw = dict(max_slots=2, min_bucket=8, kv_block_tokens=8,
                  prefill_chunk=8, kv_blocks=24, hot_window=2,
                  host_pool_blocks=32, prefix_cache_blocks=8,
                  prefix_block_tokens=8,
                  fabric={"disk_root": str(tmp_path / name)}, **TIER_KW)
        a = cls(m, **kw)
        ra = a.submit(prompt, max_new_tokens=8, seed=0)
        a.run(max_steps=5000)
        b = cls(m, **kw)
        rb = b.submit(prompt, max_new_tokens=8, seed=0)
        b.run(max_steps=5000)
        assert ra.error is None and rb.error is None
        assert list(rb.tokens) == list(ra.tokens)
        got[name] = (list(rb.tokens), int(b._m_kv_prefetch_miss.value),
                     int(b._m_prefetch_wait.count),
                     int(b._m_fab_blocks["pull"].value))
    assert got["port"] == got["jax"]
    assert got["port"][1] >= 1 and got["port"][2] >= 1


def test_cold_idx_roundtrips_through_a_tiered_ticket():
    """A session parked on a tiered engine with blocks in its extension
    tier exports a ticket whose `cold_idx` names them; a second tiered
    engine adopts it with that map and continues the stream the first
    engine gives without the move."""
    tm = TModel(TConfig.from_preset("tiny", **HEADS), device="cpu", seed=2)
    kw = dict(max_slots=2, min_bucket=8, kv_block_tokens=8,
              prefill_chunk=8, kv_blocks=7, hot_window=2,
              host_pool_blocks=32, prefetch_depth=1, **TIER_KW)
    prompt = np.random.RandomState(5).randint(0, 256, (40,))
    ref = LLMEngine(tm, **kw).generate([prompt], 24)[0]
    a = LLMEngine(tm, **kw)
    r = a.submit(prompt, 24, session_id="tiered")
    for _ in range(200):
        a.step()
        slot = next((s for s, q in enumerate(a._slots) if q is r), None)
        if slot is not None and len(r.tokens) >= 4 and any(
                a._pager.is_ext(b) for b in a._pager.slot_blocks[slot]):
            break
    else:
        raise AssertionError("no decoding slot with a spilled block")
    a._park_slot(slot, mode="swap")
    pr = a._parked[-1]
    assert pr.mode == "swap" and pr.cold_idx
    ticket = SessionTicket.from_bytes(a._ticket_from_parked(pr).to_bytes())
    assert ticket.cold_idx == list(pr.cold_idx)
    b = LLMEngine(tm, **kw)
    req = b.adopt_ticket(ticket)
    assert tuple(b._parked[-1].cold_idx) == tuple(ticket.cold_idx)
    b.run()
    assert req.tokens == list(ref)


def test_swap_crc_flip_resumes_by_recompute(models):
    """One flipped byte in a parked host copy (after its CRC32C stamp)
    is caught at resume (`kv_integrity_failures_total{path="swap"}`)
    and the stream is the one without the flip."""
    tm = models["float32"][1]
    ref = LLMEngine(tm, **MIG_KW).generate([P_MIG], 24, seed=5)[0]
    eng = LLMEngine(tm, **MIG_KW)
    r1 = eng.submit(P_LONG, 55)
    r2 = eng.submit(P_MIG, 24, seed=5, priority=-1)
    for _ in range(20_000):
        eng.step()
        stamped = [p for p in eng._parked
                   if p.mode == "swap" and p.host_crc is not None]
        if stamped:
            break
    assert stamped, "no stamped swap park under pool pressure"
    stamped[0].host.view(-1)[13] ^= 0x20          # rot in host memory
    eng.run()
    assert r1.error is None and r2.error is None
    assert list(r2.tokens) == list(ref)
    assert int(eng._m_integrity["swap"].value) == 1
