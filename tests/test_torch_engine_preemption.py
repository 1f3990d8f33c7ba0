"""The port's engine sub-slices (b) and (c): the preempt ladder with the
host swap tier and drop-and-recompute (`kv_blocks` below full
provisioning, `host_pool_blocks`, `preempt_policy`, per-request
`priority`) and the radix prefix cache (`prefix_cache_blocks`,
`prefix_block_tokens`), against the JAX package's `LLMEngine` at the
knobs of its own suite (tests/test_workload_preemption.py) and against
the port's own contracts.

At the `tiny` preset in fp32 with the same weights, under a pool
oversubscribed ~2x (`kv_blocks=16`), the port's greedy streams are
token-exact with the JAX engine's UNPRESSURED streams under every
policy, and with the synchronous driver its ladder makes the same
decisions (preemptions, resumes, requeues, swap bytes equal).  Within
the port, overlap on gives the streams of overlap off; the bf16 and
int8 pools and sampled requests under pressure give the port's own
unpressured streams (a restore reinstates the parked generator and
never resamples).  The prefix cache gives the JAX engine's streams,
hits and saved tokens on `bench.py`'s shared-prefix mix (debug-4l
sizes).  After every run the pager's invariants hold and no block is
owned but the trie's.  The swap tier's pinned copies and the decode
graphs exist only on the card: `test_swap_round_trip_on_card` holds the
round trip to bitwise there and skips on the CPU.
"""

import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (DeadlineExceeded, LLMEngine,
                                        LLMServer)
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import llama_decode as TD
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.testing import faults, get_injector

# the JAX suite's knobs (tests/test_workload_preemption.py:34-55)
ENGINE_KW = dict(max_slots=4, max_len=64, max_prompt_len=32, min_bucket=8,
                 kv_block_tokens=8)
LENGTHS = [20, 28, 25, 30, 22, 27]
MAX_NEW = 24
PRESSURE = 16          # kv_blocks: ~2x oversubscribed (full is 33)
POLICIES = ["auto", "swap", "recompute"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prompts(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (L,)) for L in LENGTHS]


def _run(engine_cls, model, req_kw=None, **kw):
    """The JAX suite's `_run`: every prompt, 24 new tokens, run to the
    end; every request done without error."""
    eng = engine_cls(model, **dict(ENGINE_KW, **kw))
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW, **(req_kw or {}))
            for p in _prompts()]
    eng.run(max_steps=5000)
    assert all(r.done and r.error is None for r in reqs)
    return eng, [list(r.tokens) for r in reqs]


def _ladder(eng):
    return [eng._m_preempt.value, eng._m_resume.value,
            eng._m_prefill_requeued.value, eng._m_swap_bytes.value]


def _drained(eng):
    """The pager's invariants hold, and nothing owns a block but the
    prefix cache's trie (no slot, no parked host copy)."""
    eng._pager.check()
    held = 0 if eng._pcache is None else eng._pcache.blocks_used
    assert eng._pager.used_blocks == held
    assert eng._pager.host_blocks_used == 0
    assert eng.num_parked == 0 and not eng.has_work


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
def jax_runs(models):
    """The JAX engine's unpressured streams, and its ladder counters
    under pressure per policy (synchronous driver)."""
    from paddle_tpu.inference import LLMEngine as JEngine
    _, base = _run(JEngine, models[0])
    ladder = {}
    for policy in POLICIES:
        eng, outs = _run(JEngine, models[0], kv_blocks=PRESSURE,
                         preempt_policy=policy)
        assert outs == base
        ladder[policy] = _ladder(eng)
    return base, ladder


@pytest.fixture(scope="module")
def port_model():
    return TModel(TConfig.from_preset("tiny"), device="cpu", seed=3)


@pytest.fixture(scope="module")
def port_base(port_model):
    return _run(LLMEngine, port_model)[1]


@pytest.mark.parametrize("policy", POLICIES)
def test_pressured_streams_and_ladder_equal_jax(models, jax_runs, policy):
    base, ladder = jax_runs
    eng, outs = _run(LLMEngine, models[1], kv_blocks=PRESSURE,
                     preempt_policy=policy)
    assert outs == base
    assert _ladder(eng) == ladder[policy]
    assert eng._m_preempt.value >= 3
    assert eng._m_resume.value == eng._m_preempt.value
    assert (eng._m_swap_bytes.value > 0) == (policy != "recompute")
    _drained(eng)


@pytest.mark.parametrize("policy", POLICIES)
def test_overlap_on_equals_off_under_pressure(port_model, port_base, policy):
    streams = {}
    for overlap in ("off", "on"):
        eng, streams[overlap] = _run(LLMEngine, port_model,
                                     kv_blocks=PRESSURE,
                                     preempt_policy=policy, overlap=overlap)
        assert eng._m_preempt.value >= 3
        _drained(eng)
    assert streams["on"] == streams["off"] == port_base


@pytest.mark.parametrize("kv_dtype,policy", [(None, "auto"),
                                             (None, "recompute"),
                                             ("int8", "swap"),
                                             ("int8", "recompute")])
def test_bf16_and_int8_pools_under_pressure(kv_dtype, policy):
    """The serving dtype (bf16 parameters and pool), and the int8 pool:
    a swapped block returns byte for byte and a recompute re-runs the
    chunked prefill, so the pressured streams are the unpressured
    ones."""
    model = TModel(TConfig.from_preset("tiny", dtype="bfloat16"),
                   device="cpu", seed=5)
    _, base = _run(LLMEngine, model, kv_dtype=kv_dtype)
    eng, outs = _run(LLMEngine, model, kv_dtype=kv_dtype,
                     kv_blocks=PRESSURE, preempt_policy=policy)
    assert eng._m_preempt.value >= 3
    assert outs == base
    _drained(eng)


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_sampled_streams_under_pressure(port_model, policy):
    """A restore reinstates the parked generator: sampled requests
    under pressure draw exactly the unpressured streams (a throwaway
    first-token draw at a recompute would shift every later one)."""
    kw = dict(greedy=False, temperature=0.9, top_p=0.9)

    def streams(**engine_kw):
        eng = LLMEngine(port_model, **dict(ENGINE_KW, **engine_kw))
        reqs = [eng.submit(p, MAX_NEW, seed=100 + i, **kw)
                for i, p in enumerate(_prompts())]
        eng.run(max_steps=5000)
        assert all(r.done and r.error is None for r in reqs)
        return eng, [list(r.tokens) for r in reqs]

    _, base = streams()
    eng, outs = streams(kv_blocks=PRESSURE, preempt_policy=policy)
    assert eng._m_preempt.value >= 3
    assert outs == base
    _drained(eng)


def test_whole_bucket_prefill_under_recompute(models, jax_runs):
    """`prefill_chunk=None`: a recompute resume re-prefills inline, in a
    pow-2 bucket sized to prompt + generated tokens."""
    eng, outs = _run(LLMEngine, models[1], prefill_chunk=None,
                     kv_blocks=PRESSURE, preempt_policy="recompute")
    assert eng._m_preempt.value >= 3
    assert eng._m_resume.value == eng._m_preempt.value
    assert outs == jax_runs[0]
    _drained(eng)


# -- fault sites (the JAX suite's :174-208) ---------------------------------


@pytest.fixture
def fault_harness():
    inj = get_injector()
    inj.clear()
    faults.ENABLED = True
    yield inj
    inj.clear()
    faults.ENABLED = False


def test_swap_out_fault_falls_back_to_recompute(port_model, port_base,
                                                fault_harness):
    fault_harness.inject("kv.swap_out", times=None)   # every attempt
    eng, outs = _run(LLMEngine, port_model, kv_blocks=PRESSURE,
                     preempt_policy="swap")
    assert eng._m_preempt.value >= 3
    assert eng._m_swap_bytes.value == 0               # nothing swapped
    assert outs == port_base
    _drained(eng)


def test_swap_in_fault_reparks_not_corrupts(port_model, port_base,
                                            fault_harness):
    rule = fault_harness.inject("kv.swap_in", times=2)
    eng, outs = _run(LLMEngine, port_model, kv_blocks=PRESSURE,
                     preempt_policy="swap")
    assert rule.fired == 2
    assert eng._m_preempt.value >= 3
    assert eng._m_resume.value == eng._m_preempt.value
    assert outs == port_base
    _drained(eng)


def test_alloc_fault_is_schedulable(port_model, port_base, fault_harness):
    rule = fault_harness.inject("kv.alloc", times=3, after=2)
    eng, outs = _run(LLMEngine, port_model, kv_blocks=PRESSURE)
    assert rule.fired == 3 and eng._pager.alloc_failures >= 3
    assert outs == port_base
    _drained(eng)


def test_dormant_harness_fires_nothing(port_model, port_base):
    """Rules armed with the harness switched off trip nothing."""
    inj = get_injector()
    rule = inj.inject("kv.swap_out", times=None)
    try:
        eng, outs = _run(LLMEngine, port_model, kv_blocks=PRESSURE,
                         preempt_policy="swap")
    finally:
        inj.clear()
    assert rule.fired == 0 and eng._m_swap_bytes.value > 0
    assert outs == port_base


# -- deadlines & priority ---------------------------------------------------


def test_deadline_fails_a_request_only_while_parked(port_model, port_base):
    """Under pressure a request parks; its deadline expiring THERE fails
    it with a DeadlineExceeded that says so and drops its host copy;
    every other request completes with its unpressured stream."""
    eng = LLMEngine(port_model, kv_blocks=PRESSURE, preempt_policy="swap",
                    **ENGINE_KW)
    reqs = [eng.submit(p, MAX_NEW, deadline=600.0) for p in _prompts()]
    while not eng._parked:
        eng.step()
    victim = eng._parked[0].req
    held = eng._pager.host_blocks_used
    assert held > 0 and not victim.done
    victim._deadline_t = time.monotonic() - 1.0
    eng.step()
    assert isinstance(victim.error, DeadlineExceeded)
    assert "while parked" in str(victim.error)
    assert eng._pager.host_blocks_used < held
    eng.run(max_steps=5000)
    for r, want in zip(reqs, port_base):
        if r is not victim:
            assert r.error is None and r.tokens == want
    assert victim.tokens == port_base[reqs.index(victim)][
        :len(victim.tokens)]
    assert eng._m_expired.value == 1
    _drained(eng)


def test_priority_orders_victims(port_model, port_base):
    """Victims are ranked lowest priority first, then newest admission;
    the high-priority request is never parked, and every stream is the
    unpressured one."""
    eng = LLMEngine(port_model, kv_blocks=PRESSURE, **ENGINE_KW)
    rankings, parked = [], []
    victims, park = eng._preempt_victims, eng._park_slot

    def spy_victims(protect=None):
        out = victims(protect)
        rankings.append([(eng._slots[s].priority, eng._slot_seq[s])
                         for s in out])
        return out

    def spy_park(slot):
        parked.append(eng._slots[slot].rid)
        park(slot)

    eng._preempt_victims, eng._park_slot = spy_victims, spy_park
    reqs = [eng.submit(p, MAX_NEW, priority=10 if i == 0 else 0)
            for i, p in enumerate(_prompts())]
    eng.run(max_steps=5000)
    assert [list(r.tokens) for r in reqs] == port_base
    assert len(parked) >= 3 and reqs[0].rid not in parked
    assert rankings and any(len(r) > 1 for r in rankings)
    for ranking in rankings:
        assert ranking == sorted(ranking, key=lambda k: (k[0], -k[1]))
    _drained(eng)


# -- knobs, metrics, server -------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(kv_blocks=5),
    dict(prefix_cache_blocks=8, prefill_chunk=None),
    dict(prefix_cache_blocks=8, prefix_block_tokens=16, kv_block_tokens=8),
    dict(preempt_policy="sometimes")],
    ids=["kv_blocks", "prefix_needs_chunks", "block_geometry", "policy"])
def test_knob_errors_equal_jax(models, bad):
    from paddle_tpu.inference import LLMEngine as JEngine
    kw = dict(ENGINE_KW, **bad)
    with pytest.raises(ValueError) as want:
        JEngine(models[0], **kw)
    with pytest.raises(ValueError) as got:
        LLMEngine(models[1], **kw)
    assert str(got.value) == str(want.value)


def test_knob_defaults(port_model):
    eng = LLMEngine(port_model, **ENGINE_KW)
    bmax = 8                                      # 64 rows / 8 a block
    assert eng.kv_blocks == 1 + 4 * bmax and eng._pcache is None
    assert eng.host_pool_blocks == 4 * bmax and eng.preempt_policy == "auto"
    eng = LLMEngine(port_model, prefix_cache_blocks=8, prefix_block_tokens=8,
                    host_pool_blocks=0, **dict(ENGINE_KW,
                                               kv_block_tokens=None))
    assert eng.kv_block_tokens == 8 and eng.kv_blocks == 1 + 4 * bmax + 8
    assert eng._pcache.n_blocks == 8 and eng.host_pool_blocks == 0
    assert eng._kv_block_bytes == sum(
        t[0].numel() * t.element_size()
        for t in TD.pool_leaves(eng._kvpool))


def test_no_host_tier_parks_by_recompute(port_model, port_base):
    """`host_pool_blocks=0` disables the swap tier: "swap" parks fall
    back to recompute."""
    eng, outs = _run(LLMEngine, port_model, kv_blocks=PRESSURE,
                     preempt_policy="swap", host_pool_blocks=0)
    assert eng._m_preempt.value >= 3 and eng._m_swap_bytes.value == 0
    assert outs == port_base
    _drained(eng)


def test_degradation_and_cache_metrics_exposed(port_model):
    eng, _ = _run(LLMEngine, port_model, kv_blocks=PRESSURE,
                  preempt_policy="swap")
    m = eng.metrics()
    for name in ("kv_blocks_used", "kv_blocks_host", "kv_blocks_total",
                 "requests_parked", "preemptions_total", "resumes_total",
                 "prefill_requeues_total", "swap_bytes_total",
                 "kv_blocks_reclaimed_total", "park_time_seconds",
                 "prefix_cache_hits_total", "prefix_cache_misses_total",
                 "prefix_cache_evictions_total",
                 "prefill_tokens_saved_total", "prefix_cache_blocks_used"):
        assert "llm_engine_" + name in m, name

    def solo(name, field="value"):
        return m["llm_engine_" + name]["series"][""][field]

    assert solo("preemptions_total") >= 3
    assert solo("park_time_seconds", "count") == solo("resumes_total")
    assert solo("kv_blocks_total") == PRESSURE - 1
    assert eng._swap_total == solo("preemptions_total")
    assert 0 <= eng._swap_ready <= eng._swap_total
    assert "llm_engine_swap_bytes_total" in eng._metrics.prometheus_text()


def test_server_passes_knobs_and_priority(port_model, port_base):
    srv = LLMServer(port_model, kv_blocks=PRESSURE, preempt_policy="swap",
                    **ENGINE_KW)
    try:
        reqs = [srv.submit(p, MAX_NEW, priority=i % 2)
                for i, p in enumerate(_prompts())]
        got = [srv.result(r, timeout=120) for r in reqs]
    finally:
        srv.shutdown(drain=True)
    assert got == port_base
    assert srv.engine._m_preempt.value >= 3
    assert [r.priority for r in reqs] == [0, 1] * 3
    _drained(srv.engine)


# -- the radix prefix cache ---------------------------------------------------


def test_repeated_prompt_hits_and_shares_blocks(port_model):
    """A repeat aliases the trie's blocks (refcount 2 while it runs) and
    gives the first run's stream (the JAX suite's :124-141)."""
    eng = LLMEngine(port_model, max_slots=2, max_len=64, max_prompt_len=32,
                    min_bucket=8, prefix_cache_blocks=8,
                    prefix_block_tokens=8, kv_block_tokens=8)
    p = np.random.RandomState(7).randint(0, 256, (30,))
    r1 = eng.submit(p, max_new_tokens=8)
    eng.run()
    assert eng._pcache.blocks_used == 3 and eng._pcache.hits == 0
    r2 = eng.submit(p, max_new_tokens=8)
    refs = []
    while eng.has_work:
        eng.step()
        refs.append(max(eng._pager.refcount(b)
                        for b in eng._pager.slot_blocks[0]) if
                    eng._slots[0] is not None else 0)
    assert max(refs) == 2
    assert eng._pcache.hits == 1 and r2.tokens == r1.tokens
    m = eng.metrics()
    assert m["llm_engine_prefill_tokens_saved_total"]["series"][""][
        "value"] == 24
    _drained(eng)


def test_shared_prefix_mix_equals_jax():
    """`bench.py`'s shared-system-prompt stream at debug-4l sizes
    (:455-456, :738-756): request 0 alone (the honest miss), then the
    other seven at once; streams, hits, misses and tokens saved equal
    the JAX engine's, with and without overlap."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.inference import LLMEngine as JEngine
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("debug-4l"))
    tm = TModel(TConfig.from_preset("debug-4l"), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    rng = np.random.RandomState(0)
    system = rng.randint(0, 1024, (64,))
    shared = [np.concatenate([system, rng.randint(0, 1024, (8,))])
              for _ in range(8)]

    def run(engine_cls, model, **kw):
        eng = engine_cls(model, max_slots=4, max_len=96, max_prompt_len=72,
                         prefill_chunk=16, prefix_cache_blocks=32,
                         prefix_block_tokens=16, **kw)
        first = eng.submit(shared[0], max_new_tokens=4)
        eng.run()
        rest = [eng.submit(p, max_new_tokens=4) for p in shared[1:]]
        eng.run()
        return eng, [list(r.tokens) for r in [first] + rest]

    def counts(eng):
        return [eng._m_cache_hit.value, eng._m_cache_miss.value,
                eng._m_tokens_saved.value, eng._pcache.blocks_used]

    jeng, want = run(JEngine, jm)
    assert counts(jeng) == [7, 1, 7 * 64, 4]
    for overlap in ("off", "on"):
        eng, got = run(LLMEngine, tm, overlap=overlap)
        assert got == want
        assert counts(eng) == counts(jeng)
        _drained(eng)


def test_cache_reclaim_before_parking(port_model):
    """Rung 1: under pressure, unpinned trie blocks go back to the pool
    before any slot parks (the JAX suite's :144-159), and the streams
    are those of an engine without the cache."""
    kw = dict(max_slots=2, max_len=64, max_prompt_len=32, min_bucket=8,
              kv_block_tokens=8)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, 256, (28,)) for _ in range(4)]

    def run(**extra):
        eng = LLMEngine(port_model, **kw, **extra)
        reqs = [eng.submit(p, max_new_tokens=20) for p in prompts]
        eng.run(max_steps=5000)
        assert all(r.done and r.error is None for r in reqs)
        return eng, [list(r.tokens) for r in reqs]

    _, base = run()
    eng, outs = run(prefix_cache_blocks=8, prefix_block_tokens=8,
                    kv_blocks=13)
    assert eng._m_kv_reclaimed.value > 0
    assert outs == base
    _drained(eng)


# -- on the card --------------------------------------------------------------


@pytest.mark.gpu
def test_swap_round_trip_on_card():
    """On the card: a slot's blocks gathered, copied to pinned host
    memory behind an event, and scattered into OTHER blocks come back
    bitwise (bf16 and int8 pools, scales included), in place under
    decode graphs captured before the scatter: a replay over a table
    naming the new blocks gives the logits of a replay over the old."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned copies and CUDA graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TModel(TConfig.from_preset("debug-4l"), device="cuda", seed=1)
    for kv_dtype in (None, "int8"):
        eng = LLMEngine(model, max_slots=4, max_len=256, prefill_chunk=32,
                        overlap="off", kv_dtype=kv_dtype)
        eng.prepare_programs()
        leaves = [t.data_ptr() for t in TD.pool_leaves(eng._kvpool)]
        eng.submit(np.random.default_rng(2).integers(0, 1024, 100), 40)
        for _ in range(8):
            eng.step()
        slot = next(s for s, r in enumerate(eng._slots) if r is not None)
        old = list(eng._pager.slot_blocks[slot])
        host, event = eng._swap_out(slot, len(old))
        assert host.is_pinned() and event is not None
        new = eng._pager.alloc(len(old))
        assert not set(new) & set(old)
        flat = host.to("cuda", non_blocking=True)
        TD.scatter_blocks(eng._kvpool, torch.tensor(new, device="cuda"),
                          flat)
        for t in TD.pool_leaves(eng._kvpool):
            assert torch.equal(t[new], t[old])
        assert [t.data_ptr() for t in TD.pool_leaves(eng._kvpool)] == leaves
        g, w = eng._graphs, eng.max_slots
        out = {}
        for name, blocks in (("old", old), ("new", new)):
            table = eng._pager.table.copy()
            table[slot, :len(blocks)] = blocks
            host_in = np.concatenate([eng._token[:w], eng._pos[:w],
                                      table[:w].reshape(-1)])
            g.inputs(w).copy_(torch.from_numpy(host_in))
            out[name] = g.replay(w)[0][slot].clone()
        torch.cuda.synchronize()
        assert torch.equal(out["old"], out["new"])
        eng._pager.host_release(len(old))
        for b in new:
            eng._pager.decref(b)
