"""The port's tiered KV for long context (engine sub-slice (g):
`LLMEngine(hot_window=, prefetch_depth=)`) against the JAX package's,
at the knobs of its own suite (tests/test_longctx_serving.py:126-329):
the `tiny` preset with 8 heads / 4 kv heads in fp32, the same weights.

A device pool too small for the live KV (down to below one sequence)
spills the blocks behind each sequence's hot window to the host
extension tier, reads them through one device + host address space,
and promotes them back when the pool has room.  For every JAX tiered
test the port runs the same traffic greedily and its streams are
token-exact with the JAX engine's tiered streams and with the port's
own unconstrained (untiered) streams; the spill / promote / park
counters are the JAX engine's, and the integrity counter stays 0.
Within the port, sampled requests and the overlap driver give the
untiered streams too, and a corrupted extension row degrades its owner
to recompute instead of being served.

Module parity: `crc32c` / `leaves_crc` equal the JAX package's; the
paged programs with a host tier (`hpool`) equal the JAX programs within
fp32's 1e-4 and are bitwise the same programs over a pool that holds
those blocks on the device; K4's plain version with an extension tier
is bitwise its result over the concatenated pool.  K4 reading the tier
in place on the card: `test_k4_ext_tier_on_card` (skips on the CPU).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import LLMEngine, LLMServer
from paddle_tpu_torch.inference import kv_fabric as TF
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import llama_decode as TD
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.testing import faults, get_injector

HEADS = dict(num_attention_heads=8, num_key_value_heads=4)
# the JAX suite's `_run` defaults and its TIER_KW
BASE_KW = dict(max_slots=2, max_len=96, max_prompt_len=48, min_bucket=8,
               kv_block_tokens=8, prefill_chunk=8)
TIERED = dict(kv_blocks=12, hot_window=2, host_pool_blocks=32,
              prefetch_depth=2)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model with the same weights)."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("tiny", **HEADS))
    tm = TModel(TConfig.from_preset("tiny", **HEADS), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture
def fault_harness():
    inj = get_injector()
    inj.clear()
    faults.ENABLED = True
    yield inj
    inj.clear()
    faults.ENABLED = False


def _tier_prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(0, 256, (n,)) for n in (40, 29, 37)]


def _long_prompt():
    return [np.random.RandomState(11).randint(0, 256, (40,))]


def _pair_prompts():
    rng = np.random.RandomState(13)
    return [rng.randint(0, 256, (40,)), rng.randint(0, 256, (40,))]


def _park_prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, (L,)) for L in [40, 28, 35, 30]]


def _counters(eng):
    return (eng._m_kv_spilled.value, eng._m_kv_prefetched.value,
            eng._m_preempt.value, eng._m_resume.value)


def _run(engine_cls, model, prompts, max_new, greedy=True, **kw):
    """Every prompt (`max_new` tokens each, or a list), run to the end;
    every request done without error.  Sampled requests (greedy False)
    alternate with greedy ones, as the JAX suite's `_run`."""
    eng = engine_cls(model, **dict(BASE_KW, **kw))
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    reqs = [eng.submit(p, max_new_tokens=n, seed=i,
                       greedy=greedy or not i % 2, temperature=0.8,
                       top_p=0.9)
            for i, (p, n) in enumerate(zip(prompts, news))]
    eng.run(max_steps=8000)
    assert all(r.done and r.error is None for r in reqs)
    return eng, [tuple(r.tokens) for r in reqs]


def _drained(eng):
    eng._pager.check()
    assert eng._pager.used_blocks == 0
    assert eng._pager.ext_used == 0
    assert eng._pager.host_blocks_used == 0
    assert eng._m_integrity["ext"].value == 0
    assert all(c is None for c in eng._hext_crc)


def _against_jax(models, prompts, max_new, ref_kw, **kw):
    """(JAX tiered engine, port tiered engine, port streams) with the
    port's streams equal to the JAX engine's and to the port's
    untiered run at `ref_kw`."""
    from paddle_tpu.inference import LLMEngine as JEngine
    jm, tm = models
    jeng, jout = _run(JEngine, jm, prompts, max_new, **kw)
    teng, tout = _run(LLMEngine, tm, prompts, max_new, **kw)
    _, ref = _run(LLMEngine, tm, prompts, max_new, **ref_kw)
    assert tout == jout
    assert tout == ref
    assert _counters(teng) == _counters(jeng)
    return jeng, teng, tout


# -- the JAX suite's tiered tests ------------------------------------------


@pytest.mark.parametrize("kv", [None, "int8"], ids=["kvauto", "kvint8"])
def test_spill_bitwise(models, kv):
    """A 12-block device pool under three ~40-token prompts: cold
    blocks spill and every stream is the unconstrained (64-block)
    run's and the JAX engine's."""
    _, eng, _ = _against_jax(models, _tier_prompts(), 12,
                             dict(kv_dtype=kv, kv_blocks=64),
                             kv_dtype=kv, **TIERED)
    assert eng._m_kv_spilled.value >= 1
    _drained(eng)


@pytest.mark.parametrize("blocks", [6, 9])
def test_kv_exceeds_device_pool(models, blocks):
    """One sequence whose KV (80 rows = 10 blocks) exceeds the WHOLE
    device pool streams through it: lazy admission, per-chunk growth,
    frontier-window spill."""
    _, eng, _ = _against_jax(models, _long_prompt(), 40,
                             dict(kv_blocks=64), kv_blocks=blocks,
                             hot_window=2, host_pool_blocks=32)
    assert eng._m_kv_spilled.value >= 1
    assert eng.kv_blocks - 1 < 10
    _drained(eng)


def test_spill_then_prefetch_promote(models):
    """A long decode beside a bulky short one: pressure spills the
    long slot's cold tail, the partner's exit frees more than the long
    slot still grows by, and the prefetcher promotes the cold blocks
    back (the prefix cache off, so reclaim cannot absorb it)."""
    _, eng, _ = _against_jax(models, _pair_prompts(), [48, 8],
                             dict(kv_blocks=64, prefix_cache_blocks=0),
                             prefix_cache_blocks=0, **TIERED)
    assert eng._m_kv_spilled.value >= 1
    assert eng._m_kv_prefetched.value >= 1
    _drained(eng)


@pytest.mark.parametrize("case", ["jax_knobs", "cold_park"])
def test_park_resume_tiered(models, case):
    """The preempt ladder composes with tiering: an oversubscribed
    tiered pool parks through the host swap tier and resumes with the
    cold-tail placement (`cold_idx`) preserved.  "jax_knobs": the JAX
    suite's knobs; "cold_park": three slots over 12 blocks and an
    8-row host tier, where a slot with extension blocks parks."""
    kw = dict(TIERED, preempt_policy="swap", prefix_cache_blocks=0)
    if case == "cold_park":
        kw.update(max_slots=3, host_pool_blocks=8)
    parked = []
    jeng, eng, _ = _against_jax(
        models, _park_prompts(), 24,
        dict(kv_blocks=64, prefix_cache_blocks=0,
             max_slots=kw["max_slots"] if "max_slots" in kw else 2), **kw)
    assert eng._m_kv_spilled.value >= 1
    if case == "cold_park":
        # the park carried extension blocks: rerun with the park hooked
        e2 = LLMEngine(models[1], **dict(BASE_KW, **kw))
        park = e2._park_slot

        def hooked(slot, mode=None):
            parked.append(sum(e2._pager.is_ext(b)
                              for b in e2._pager.slot_blocks[slot]))
            park(slot, mode)
        e2._park_slot = hooked
        for i, p in enumerate(_park_prompts()):
            e2.submit(p, max_new_tokens=24, seed=i)
        e2.run(max_steps=8000)
        assert eng._m_preempt.value >= 1
        assert eng._m_resume.value == eng._m_preempt.value
        assert any(n > 0 for n in parked)
    _drained(eng)


def test_chaos_prefetch_tick_skipped(models, fault_harness):
    """`kv.prefetch` tripped every step: nothing is promoted, the
    extension rows are read in place, and every stream is still the
    unconstrained run's."""
    from paddle_tpu.framework.flags import set_flags
    from paddle_tpu.testing import get_injector as jax_injector
    jinj = jax_injector()
    jinj.clear()
    set_flags({"FLAGS_fault_injection": True})
    try:
        jinj.inject("kv.prefetch", times=None)
        fault_harness.inject("kv.prefetch", times=None)
        _, eng, _ = _against_jax(models, _tier_prompts(), 12,
                                 dict(kv_blocks=64), **TIERED)
    finally:
        jinj.clear()
        set_flags({"FLAGS_fault_injection": False})
    assert eng._m_kv_spilled.value >= 1
    assert eng._m_kv_prefetched.value == 0
    _drained(eng)


def test_tiered_validation_errors(models):
    """The JAX engine's checks; a mesh is not ported (multi-GPU), and
    "pallas" is no decode kernel of the port."""
    tm = models[1]
    kw = dict(max_len=96, max_prompt_len=48)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        LLMEngine(tm, tp=2, kv_blocks=12, hot_window=2,
                  host_pool_blocks=32, **kw)
    with pytest.raises(ValueError, match="pallas"):
        LLMEngine(tm, kv_blocks=12, hot_window=2, host_pool_blocks=32,
                  decode_kernel="pallas", **kw)
    with pytest.raises(ValueError, match="working set"):
        LLMEngine(tm, kv_blocks=3, hot_window=2, host_pool_blocks=32,
                  kv_block_tokens=8, prefill_chunk=8, **kw)
    with pytest.raises(ValueError, match="cannot cover one max_len"):
        LLMEngine(tm, kv_blocks=8, hot_window=2, host_pool_blocks=2,
                  kv_block_tokens=8, prefill_chunk=8, **kw)
    for bad, match in ((dict(hot_window=0), "hot_window must be"),
                       (dict(hot_window=2, prefetch_depth=0),
                        "prefetch_depth must be"),
                       (dict(hot_window=2, prefill_chunk=None),
                        "chunked prefill"),
                       (dict(hot_window=2, host_pool_blocks=0),
                        "host tier")):
        with pytest.raises(ValueError, match=match):
            LLMEngine(tm, **dict(kw, **bad))
    # below one max_len sequence, only a tiered pool is accepted
    with pytest.raises(ValueError, match="cannot cover one"):
        LLMEngine(tm, kv_blocks=9, kv_block_tokens=8, **kw)
    assert LLMEngine(tm, kv_blocks=9, hot_window=2, kv_block_tokens=8,
                     prefill_chunk=8, **kw)._tiered


# -- the port's own contracts ----------------------------------------------


def test_sampled_streams_and_overlap(models):
    """Sampled requests (a generator each) give the untiered streams
    under tiering, with the synchronous and the overlap driver."""
    tm = models[1]
    _, ref = _run(LLMEngine, tm, _tier_prompts(), 12, greedy=False,
                  kv_blocks=64)
    for overlap in ("off", "on"):
        eng, out = _run(LLMEngine, tm, _tier_prompts(), 12, greedy=False,
                        overlap=overlap, **TIERED)
        assert out == ref
        assert eng._m_kv_spilled.value >= 1
        _drained(eng)


def test_overlap_on_equals_off_tiered(models):
    """The overlap driver gives the synchronous driver's streams when a
    sequence exceeds the device pool and when blocks are promoted."""
    tm = models[1]
    for prompts, new, kw in ((_long_prompt(), 40,
                              dict(kv_blocks=6, hot_window=2,
                                   host_pool_blocks=32)),
                             (_pair_prompts(), [48, 8],
                              dict(TIERED, prefix_cache_blocks=0))):
        outs = [_run(LLMEngine, tm, prompts, new, overlap=o, **kw)
                for o in ("off", "on")]
        assert outs[0][1] == outs[1][1]
        for eng, _ in outs:
            _drained(eng)


def test_speculation_tiered(models):
    """Speculative decoding over a tiered pool: the verify step reads
    the extension tier (K4's plain version over the B x W rows), the
    streams are the unconstrained non-speculative run's and the JAX
    engine's, with its spill / promote / verify / accept counters; the
    overlap driver gives the same streams."""
    from paddle_tpu.inference import LLMEngine as JEngine
    jm, tm = models
    rng = np.random.RandomState(7)
    prompts = [np.tile(rng.randint(0, 256, (6,)), 7)[:40],
               np.tile(rng.randint(0, 256, (5,)), 8)[:37]]

    def counters(eng):
        return _counters(eng) + (eng._m_spec_steps.value,
                                 eng._m_spec_accepted.value)
    _, ref = _run(LLMEngine, tm, prompts, 24, kv_blocks=64)
    jeng, jout = _run(JEngine, jm, prompts, 24, speculation=4, **TIERED)
    eng, out = _run(LLMEngine, tm, prompts, 24, speculation=4,
                    decode_kernel="cuda", **TIERED)
    assert out == jout == ref
    assert counters(eng) == counters(jeng)
    assert eng._m_kv_spilled.value >= 1
    assert eng._m_spec_accepted.value >= 1
    _drained(eng)
    eng, out = _run(LLMEngine, tm, prompts, 24, speculation=4,
                    overlap="on", **TIERED)
    assert out == ref
    _drained(eng)


def test_corrupt_ext_row_degrades_to_recompute(models):
    """A bit flipped in a stamped extension row is caught at its
    promote: the row never reaches the pool, its owner parks in
    recompute mode, and the stream is still the unconstrained run's."""
    tm = models[1]
    _, ref = _run(LLMEngine, tm, _pair_prompts(), [48, 8], kv_blocks=64)
    eng = LLMEngine(tm, **dict(BASE_KW, **TIERED, prefix_cache_blocks=0))
    promote = eng._promote_ext
    flipped = []

    def corrupt_then_promote(budget):
        pager = eng._pager
        for blocks in pager.slot_blocks:
            for b in blocks:
                if pager.is_ext(b) and not flipped:
                    e = pager.ext_index(b)
                    eng._hext.flat[e, 7] ^= 1
                    flipped.append(e)
        return promote(budget)
    eng._promote_ext = corrupt_then_promote
    reqs = [eng.submit(p, max_new_tokens=n, seed=i)
            for i, (p, n) in enumerate(zip(_pair_prompts(), [48, 8]))]
    eng.run(max_steps=8000)
    assert [tuple(r.tokens) for r in reqs] == ref
    assert flipped and eng._m_integrity["ext"].value == 1
    assert eng._m_preempt.value >= 1
    eng._pager.check()
    assert eng._pager.used_blocks == 0 and eng._pager.ext_used == 0


def test_server_health_reports_tiering(models):
    """`health_snapshot()` reports the tiered pool's traffic."""
    srv = LLMServer(models[1], series_interval=None, watchdog_deadline=None,
                    **dict(BASE_KW, **TIERED))
    try:
        reqs = [srv.submit(p, max_new_tokens=12) for p in _tier_prompts()]
        for r in reqs:
            r.result(timeout=300)
        h = srv.health_snapshot()
    finally:
        srv.shutdown()
    assert h["kv_tiered"] is True
    assert h["kv_blocks_spilled"] == srv.engine._m_kv_spilled.value >= 1
    assert h["kv_blocks_prefetched"] == srv.engine._m_kv_prefetched.value
    assert h["kv_prefetch_misses"] == 0
    assert h["kv_ext_used"] == srv.engine._pager.ext_used
    assert h["fabric"]["integrity_failures"]["ext"] == 0


# -- module parity ---------------------------------------------------------


def test_crc32c_equals_jax():
    pytest.importorskip("jax")
    from paddle_tpu.inference import kv_fabric as JF
    assert TF.crc32c(b"123456789") == 0xE3069283      # RFC 3720
    assert TF.crc32c(b"") == 0
    assert TF.crc32c(b" world", TF.crc32c(b"hello")) == \
        TF.crc32c(b"hello world")
    rng = np.random.default_rng(5)
    for n in (1, 31, 127, 128, 4095, 65536 + 17):
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        assert TF.crc32c(buf) == JF.crc32c(buf) == TF._crc32c_py(buf)
        assert TF.crc32c(buf, 0x1234) == JF.crc32c(buf, 0x1234)
    leaves = [rng.standard_normal((3, 5)).astype(np.float32),
              rng.integers(-128, 128, (7, 2), dtype=np.int8)]
    assert TF.leaves_crc(leaves) == JF.leaves_crc(leaves)


def _pool_and_tier(tm, kv_dtype, n_blocks=13, bt=8):
    """A pool of random KV (an int8 pool quantizes it) and an empty
    4-row host tier."""
    g = torch.Generator().manual_seed(3)
    cfg = tm.config
    pool = TD.init_paged_cache(cfg, n_blocks, bt, torch.float32,
                               kv_dtype=kv_dtype, device="cpu")
    for t in TD.pool_leaves(pool):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        elif t.dim() == 3:                    # an int8 pool's scales
            t.copy_(torch.rand(t.shape, generator=g) * 0.02)
        else:
            t.copy_(torch.randn(t.shape, generator=g))
    return pool, TD.KVTier.empty(pool, 4)


def _spill(pool, tier, table, moves):
    """Copy blocks to tier rows ({table position (b, j): tier row}),
    renumber the table, and poison the device copies, so a read that
    missed the tier would show."""
    table = table.copy()
    n = TD.pool_leaves(pool)[0].shape[0]
    for (b, j), e in moves.items():
        bid = int(table[b, j])
        tier.flat[e] = TD.gather_blocks(pool, torch.tensor([bid]))
        table[b, j] = n + e
    return table


def _poison(pool, bids):
    for t in TD.pool_leaves(pool):
        t[bids] = 0 if t.dtype == torch.int8 else 7.0


@pytest.mark.parametrize("kv", [None, "int8"], ids=["kvauto", "kvint8"])
def test_k4_plain_ext_equals_concat(models, kv):
    """K4's plain version reading the extension tier is bitwise the
    plain version over a pool holding those blocks on the device, and
    its view is `tiered_entry`'s concatenation."""
    tm = models[1]
    pool, tier = _pool_and_tier(tm, kv)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [8, 9, 10, 11]], np.int32)
    pos = torch.tensor([31, 20, 27], dtype=torch.int32)
    q = torch.randn(3, 8, tm.config.head_dim,
                    generator=torch.Generator().manual_seed(4))
    layer = 1
    pk, pv = pool[layer]
    ref = PA.paged_attention_plain(q, pk, pv, torch.from_numpy(table), pos)
    view = PA.paged_view(pk, torch.from_numpy(table))
    moved = _spill(pool, tier, table, {(0, 1): 2, (0, 2): 0, (2, 3): 3})
    _poison(pool, [2, 3, 11])
    hk, hv = tier.layers[layer]
    got = PA.paged_attention(q, pk, pv, torch.from_numpy(moved), pos,
                             hk=hk, hv=hv)
    assert torch.equal(got, ref)
    cat = PA.paged_view(PA.tiered_entry(pk, hk), torch.from_numpy(moved))
    assert torch.equal(cat, view)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["kvauto", "kvint8"])
def test_paged_programs_with_host_tier_equal_jax(models, kv):
    """`paged_decode_step_batch` (gather and K4's plain version),
    `paged_verify_step` and `paged_prefill_chunk` with `hpool` against
    the JAX programs with the same host tier (fp32 within 1e-4; an
    int8 pool within 5e-2, `test_torch_llama_decode.py`'s bound: the
    two frameworks may round a new row's quantization one step apart),
    and bitwise the port's own programs over the untiered pool."""
    import jax.numpy as jnp
    from paddle_tpu.models import llama_decode as JD
    jm, tm = models
    cfg = tm.config
    pool, tier = _pool_and_tier(tm, kv)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    moved = _spill(pool, tier, table, {(0, 1): 1, (1, 0): 3})
    clean = [tuple(tuple(t.clone() for t in e) if isinstance(e, tuple)
                   else e.clone() for e in layer) for layer in pool]
    _poison(pool, [2, 5])

    def jtree(p):
        return [tuple(tuple(jnp.asarray(t.numpy()) for t in e)
                      if isinstance(e, tuple) else jnp.asarray(e.numpy())
                      for e in layer) for layer in p]
    jstate = JD.collect_decode_state(jm)
    tstate = TD.collect_decode_state(tm)
    jpool, jhext = jtree(pool), jtree(tier.layers)
    tok = np.array([3, 9], np.int32)
    pos = np.array([26, 19], np.int32)
    tol = 1e-4 if kv is None else 5e-2
    T = torch.from_numpy
    jl, _ = JD.paged_decode_step_batch(jstate, cfg, jnp.asarray(tok),
                                       jnp.asarray(pos), jpool,
                                       jnp.asarray(moved), hpool=jhext)
    for kernel in ("gather", "cuda"):
        tl, _ = TD.paged_decode_step_batch(tstate, cfg, T(tok), T(pos), pool,
                                           T(moved), kernel=kernel,
                                           hpool=tier)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
        ul, _ = TD.paged_decode_step_batch(tstate, cfg, T(tok), T(pos),
                                           clean, T(table), kernel=kernel)
        assert torch.equal(tl, ul)
    toks = np.array([[3, 4, 5], [9, 8, 7]], np.int32)
    jv, _ = JD.paged_verify_step(jstate, cfg, jnp.asarray(toks),
                                 jnp.asarray(pos), jpool,
                                 jnp.asarray(moved), hpool=jhext)
    tv, _ = TD.paged_verify_step(tstate, cfg, T(toks), T(pos), pool,
                                 T(moved), kernel="cuda", hpool=tier)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=tol)
    ids = np.arange(1, 9, dtype=np.int32)[None]
    jx, _ = JD.paged_prefill_chunk(jstate, cfg, jnp.asarray(ids), 24,
                                   jnp.asarray(moved[0]), jpool,
                                   hpool=jhext)
    tx, _ = TD.paged_prefill_chunk(tstate, cfg, T(ids), 24, T(moved[0]),
                                   pool, hpool=tier)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=tol)
    ux, _ = TD.paged_prefill_chunk(tstate, cfg, T(ids), 24, T(table[0]),
                                   clean)
    assert torch.equal(tx, ux)


def test_write_to_ext_tier_refused(models):
    """Writes stay on the device pool: a step whose write row lies in
    an extension block fails its check instead of writing there."""
    tm = models[1]
    pool, tier = _pool_and_tier(tm, None)
    table = _spill(pool, tier, np.array([[1, 2, 3, 4]], np.int32),
                   {(0, 3): 0})
    state = TD.collect_decode_state(tm)
    with pytest.raises(ValueError, match="extension tier"):
        TD.paged_decode_step_batch(state, tm.config, torch.tensor([1]),
                                   torch.tensor([26], dtype=torch.int32),
                                   pool, torch.from_numpy(table),
                                   hpool=tier)


@pytest.mark.gpu
def test_k4_ext_tier_on_card():
    """On the card: K4 reading table ids >= the pool's blocks from a
    pinned host tier in place is bitwise K4 over the pool that holds
    those blocks, for bf16 and int8 pools, eagerly and in a CUDA
    graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = TConfig.from_preset("debug-4l")
    for kv in (None, "int8"):
        pool = TD.init_paged_cache(cfg, 40, 16, torch.bfloat16,
                                   kv_dtype=kv, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        for t in TD.pool_leaves(pool):
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      device="cuda"))
            else:
                t.copy_(torch.rand(t.shape, generator=g, device="cuda"))
        tier = TD.KVTier.empty(pool, 8, pin=True)
        table = torch.arange(1, 33, dtype=torch.int32).reshape(4, 8)
        moved = table.clone()
        for e, (b, j) in enumerate([(0, 1), (0, 5), (1, 0), (3, 7)]):
            bid = int(table[b, j])
            tier.flat[e].copy_(TD.gather_blocks(
                pool, torch.tensor([bid], device="cuda")).cpu())
            moved[b, j] = 40 + e
        pos = torch.tensor([127, 90, 3, 120], dtype=torch.int32,
                           device="cuda")
        q = torch.randn(4, cfg.num_attention_heads, cfg.head_dim,
                        device="cuda", generator=g).to(torch.bfloat16)
        pk, pv = pool[0]
        hk, hv = tier.layers[0]
        ref = PA.paged_attention(q, pk, pv, table.cuda(), pos)
        got = PA.paged_attention(q, pk, pv, moved.cuda(), pos, hk=hk, hv=hv)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        graph = torch.cuda.CUDAGraph()
        mt = moved.cuda()
        with torch.cuda.graph(graph):
            out = PA.paged_attention(q, pk, pv, mt, pos, hk=hk, hv=hv)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
