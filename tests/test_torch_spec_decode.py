"""The port's engine sub-slice (d), speculative decoding: the n-gram
drafter (`inference/ngram_draft.py`), `generation.speculative_accept`,
`llama_decode.paged_verify_step` and the engine's `speculation` knob,
against the JAX package at the knobs and prompts of its own suites
(tests/test_spec_decode.py, the spec cells of tests/test_async_engine.py
and tests/test_workload_preemption.py) and against the port's own
contracts.

At the `tiny` preset in fp32 with the same weights, the port's greedy
streams with speculation are token-exact with the JAX engine's (with
and without speculation), solo, co-batched, with overlap on and off,
under pool pressure and with the prefix cache, and its `spec_*` and
ladder counters are the JAX engine's.  In bf16 the port's streams with
speculation are bitwise its streams without, and the JAX engine's
where the two frameworks' bf16 streams agree at all: where they part,
it is at a near tie of one bf16 ulp, with or without speculation.
Within the port, sampled streams with speculation are those without
(a sampled row draws one token a column from its generator and keeps
one draw per emitted token).  `paged_verify_step` is held to JAX's in
fp32 (logits and pool rows within 1e-4, the bound of
tests/test_torch_llama_decode.py) through the gather path and K4's
plain version.  The verify graphs exist only on the card:
`test_verify_graphs_on_card` skips on the CPU.
"""

import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.generation import (accept_rows, greedy_accept,
                                         speculative_accept)
from paddle_tpu_torch.inference import (DeadlineExceeded, LLMEngine,
                                        LLMServer, SpecConfig)
from paddle_tpu_torch.inference.ngram_draft import NGramIndex
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import llama_decode as TD
from paddle_tpu_torch.models import load_reference_arrays

# the JAX suite's engine knobs (tests/test_spec_decode.py:26-32)
ENGINE_KW = dict(max_slots=3, max_len=96, max_prompt_len=32, min_bucket=8,
                 prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _repetitive(period, n, seed=0):
    rng = np.random.RandomState(seed)
    cycle = rng.randint(2, 250, (period,))
    return np.tile(cycle, n // period + 1)[:n]


def _random(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n,))


SOLO = [_repetitive(4, 22)]
COBATCHED = [_repetitive(4, 22), _random(17, seed=1), _random(9, seed=2),
             _repetitive(2, 15, seed=3), _random(26, seed=4)]
BF16 = [_repetitive(4, 22), _random(13, seed=5)]


def _counters(eng):
    snap = eng.metrics()
    return [snap[f"llm_engine_{k}"]["series"][""]["value"] for k in (
        "spec_tokens_proposed_total", "spec_tokens_accepted_total",
        "spec_verify_steps_total", "spec_tokens_rolled_back_total",
        "decode_steps_total", "generated_tokens_total")]


def _run(engine_cls, model, prompts, spec, max_new=20, engine_kw=None,
         **req_kw):
    eng = engine_cls(model, speculation=spec,
                     **dict(ENGINE_KW, **(engine_kw or {})))
    reqs = [eng.submit(p, max_new_tokens=max_new, **req_kw)
            for p in prompts]
    eng.run()
    return [[int(t) for t in r.tokens] for r in reqs], eng


def _jax_models(dtype, seed):
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
    """(JAX tiny fp32 model, port model with the same weights): the JAX
    suite's `model` fixture."""
    return _jax_models("float32", 0)


@pytest.fixture(scope="module")
def port_model():
    return TModel(TConfig.from_preset("tiny"), device="cpu", seed=3)


def _jax_cls():
    from paddle_tpu.inference import LLMEngine as JEngine
    return JEngine


def _jax_spec(k):
    from paddle_tpu.inference import SpecConfig as JSpec
    return JSpec(k=k)


# -- the n-gram drafter and the knob ------------------------------------


def test_ngram_index_proposes_continuation():
    idx = NGramIndex([1, 2, 3, 4, 1, 2], max_n=3, min_n=1)
    assert idx.propose(3) == [3, 4, 1]
    idx.extend(3)
    assert idx.propose(4) == [4, 1, 2, 3]


def test_ngram_index_no_match_returns_empty():
    idx = NGramIndex([5, 6, 7, 8], max_n=3, min_n=2)
    assert idx.propose(3) == []
    assert idx.propose(0) == []
    assert NGramIndex([], max_n=2).propose(2) == []


def test_ngram_index_never_proposes_past_end():
    idx = NGramIndex([5, 5, 5, 5], max_n=3, min_n=1)
    p = idx.propose(2)
    assert p and all(t == 5 for t in p)


def test_ngram_index_equals_jax_on_a_stream():
    """The copy against the JAX index: every proposal of every length
    along a repetitive stream with noise."""
    pytest.importorskip("jax")
    from paddle_tpu.inference.ngram_draft import NGramIndex as JIndex
    rng = np.random.default_rng(0)
    stream = np.tile(rng.integers(0, 9, 5), 12)
    stream[rng.integers(0, stream.size, 8)] = 11
    ours, theirs = NGramIndex([], 3, 1), JIndex([], 3, 1)
    for t in stream.tolist():
        ours.extend(t)
        theirs.extend(t)
        for k in (1, 3, 7):
            assert ours.propose(k) == theirs.propose(k)


def test_spec_config_validation():
    with pytest.raises(ValueError):
        SpecConfig(k=0).validate()
    with pytest.raises(ValueError):
        SpecConfig(min_ngram=3, max_ngram=2).validate()
    with pytest.raises(ValueError):
        SpecConfig(backoff=0.8, recover=0.3).validate()
    assert SpecConfig(k=4).validate().k == 4


@pytest.mark.parametrize("form", [True, 1, 2, 3, 4, 7, 8, False, None,
                                  "config"])
def test_knob_forms_equal_jax(models, form):
    spec = SpecConfig(k=5, max_ngram=2) if form == "config" else form
    jspec = form
    if form == "config":
        from paddle_tpu.inference import SpecConfig as JSpec
        jspec = JSpec(k=5, max_ngram=2)
    jeng = _jax_cls()(models[0], speculation=jspec, **ENGINE_KW)
    eng = LLMEngine(models[1], speculation=spec, **ENGINE_KW)
    assert eng.verify_widths == jeng.verify_widths
    assert (eng.spec is None) == (jeng.spec is None)
    if eng.spec is not None:
        assert vars(eng.spec) == vars(jeng.spec)


@pytest.mark.parametrize("bad", [
    dict(speculation=0), dict(speculation=SpecConfig(k=0)),
    dict(speculation=SpecConfig(min_ngram=2, max_ngram=1)),
    dict(speculation=SpecConfig(ema_alpha=0.0)),
    dict(speculation=SpecConfig(backoff=0.6, recover=0.5)),
    dict(speculation=True, prefill_chunk=None)])
def test_knob_errors_equal_jax(models, bad):
    from paddle_tpu.inference import SpecConfig as JSpec
    spec = bad["speculation"]
    jbad = dict(bad, speculation=JSpec(**vars(spec))
                if isinstance(spec, SpecConfig) else spec)
    with pytest.raises(ValueError) as jerr:
        _jax_cls()(models[0], **dict(ENGINE_KW, **jbad))
    with pytest.raises(ValueError) as err:
        LLMEngine(models[1], **dict(ENGINE_KW, **bad))
    assert str(err.value) == str(jerr.value)


# -- the acceptance rule --------------------------------------------------


def test_greedy_accept_equals_jax():
    """Greedy rows on the same logits: the JAX suite's three rows
    (partial match, full match + bonus, no draft) and 64 random rows
    with random drafts and lengths: accept lengths equal, and the
    emitted tokens out[:, :acc + 1] equal."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from paddle_tpu.generation import speculative_accept as jaccept
    rng = np.random.RandomState(0)
    V, W = 5, 4
    logits = rng.randn(67, W, V).astype(np.float32)
    am = logits.argmax(-1)
    draft = rng.randint(0, V, (67, W - 1)).astype(np.int32)
    draft[0] = [am[0, 0], am[0, 1], (am[0, 2] + 1) % V]
    draft[1] = am[1, :W - 1]
    # the random rows match the argmax often enough to accept runs
    hit = rng.rand(67, W - 1) < 0.7
    draft[3:] = np.where(hit[3:], am[3:, :W - 1], draft[3:])
    tokens = np.concatenate([np.zeros((67, 1), np.int32), draft], 1)
    valid = rng.randint(1, W + 1, 67).astype(np.int32)
    valid[:3] = [W, W, 1]
    keys = jax.random.split(jax.random.PRNGKey(1), 67)
    ones = jnp.ones((67,), jnp.float32)
    jout, jacc, _ = jaccept(jnp.asarray(logits), jnp.asarray(tokens),
                            jnp.asarray(valid), keys, ones, ones,
                            jnp.ones((67,), bool))
    jout, jacc = np.asarray(jout), np.asarray(jacc)
    out, acc = speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(tokens),
        torch.from_numpy(valid), [None] * 67, np.ones(67, np.float32),
        np.ones(67, np.float32), np.ones(67, bool))
    assert acc.tolist() == jacc.tolist()
    assert list(acc[:3]) == [2, 3, 0]
    for b in range(67):
        n = int(acc[b]) + 1
        assert out[b, :n].tolist() == jout[b, :n].tolist()
    # the in-graph half alone gives the same
    am_t, acc_t = greedy_accept(torch.from_numpy(logits),
                                torch.from_numpy(tokens),
                                torch.from_numpy(valid))
    assert torch.equal(acc_t, acc) and torch.equal(am_t, out)


def test_sampled_accept_preserves_distribution():
    """The JAX suite's toy vocabulary on the port's sampled rule, each
    of 20,000 rows with its own generator: a low-probability draft is
    accepted at rate p(draft), and the first emitted token is
    distributed as p (4-sigma bins); a rejected draft is never the
    emitted token (the residual masks it)."""
    B, V, W = 20000, 4, 2
    row = torch.tensor([1.2, 0.3, -0.5, 0.1])
    p = torch.softmax(row, -1).numpy()
    logits = row.expand(B, W, V).contiguous()
    draft_tok = 2
    tokens = torch.zeros(B, W, dtype=torch.int32)
    tokens[:, 1:] = draft_tok
    gens = [torch.Generator().manual_seed(1000 + i) for i in range(B)]
    ones = np.ones(B, np.float32)
    out, acc = speculative_accept(logits, tokens, np.full(B, W, np.int32),
                                  gens, ones, ones, np.zeros(B, bool))
    out, acc = out.numpy(), acc.numpy()
    first = np.where(acc >= 1, draft_tok, out[np.arange(B), acc])
    counts = np.bincount(first, minlength=V) / B
    assert abs((acc >= 1).mean() - p[draft_tok]) < 0.02
    tol = 4 * np.sqrt(p * (1 - p) / B)
    assert np.all(np.abs(counts - p) <= tol + 1e-3), (counts, p)
    assert not np.any((acc == 0) & (out[:, 0] == draft_tok))


def test_sampled_rows_draw_as_decode_and_settle():
    """A sampled row draws the token a plain decode draw would take at
    each column (same generator state, same warped distribution), and
    `speculative_accept` leaves its generator one draw per emitted
    token; a greedy row and a row without a generator never draw."""
    from paddle_tpu_torch.generation import sample_rows
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(3, 4, 32).astype(np.float32))
    tokens = torch.from_numpy(rng.randint(0, 32, (3, 4)).astype(np.int32))
    temp = np.asarray([0.7, 1.0, 0.9], np.float32)
    topp = np.asarray([0.9, 1.0, 0.8], np.float32)
    gens = [torch.Generator().manual_seed(7), None,
            torch.Generator().manual_seed(8)]
    greedy = np.asarray([False, True, False])
    ref = [torch.Generator().manual_seed(7), None,
           torch.Generator().manual_seed(8)]
    untouched = torch.Generator().manual_seed(9).get_state()
    out, acc = speculative_accept(logits, tokens, np.asarray([4, 4, 1]),
                                  gens, temp, topp, greedy)
    for b in (0, 2):
        for j in range(int(acc[b]) + 1):
            one = sample_rows(logits[b:b + 1, j], torch.zeros(1, dtype=torch.long),
                              [ref[b]], temp[b:b + 1], topp[b:b + 1],
                              [False])
            assert int(one[0]) == int(out[b, j])
        assert torch.equal(gens[b].get_state(), ref[b].get_state())
    assert int(acc[2]) == 0
    g = torch.Generator().manual_seed(9)
    accept_rows(logits, tokens, [4, 4, 4], out.clone(), acc.clone(),
                [g, g, g], temp, topp, [True] * 3)
    assert torch.equal(g.get_state(), untouched)


# -- the verify step ------------------------------------------------------


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
def test_paged_verify_step_equals_jax(models, kernel):
    """Three slots at different depths (one past a block edge, one
    whose columns run past the table into trash) and an idle all-trash
    slot, W = 4 after a chunked prefill, twice: fp32 logits and every
    pool row within 1e-4 of JAX's `paged_verify_step`; `kernel="cuda"`
    runs K4's plain version over the B * W columns."""
    import jax.numpy as jnp
    from paddle_tpu.models import llama_decode as JD
    jm, tm = models
    cfg = jm.config
    bt, bmax, W = 8, 4, 4
    table = np.zeros((4, bmax), np.int32)
    table[0, :3] = [5, 2, 9]
    table[1, :4] = [1, 7, 3, 11]
    table[2, :2] = [4, 6]
    lengths = [13, 30, 14]
    rng = np.random.default_rng(0)
    jstate, tstate = JD.collect_decode_state(jm), TD.collect_decode_state(tm)
    jpool = JD.init_paged_cache(cfg, 13, bt, jnp.float32)
    tpool = TD.init_paged_cache(tm.config, 13, bt, torch.float32,
                                device="cpu")
    for b, L in enumerate(lengths):
        ids = np.zeros((1, 32), np.int32)
        ids[0, :L] = rng.integers(0, cfg.vocab_size, L)
        _, jpool = JD.paged_prefill_chunk(jstate, cfg, jnp.asarray(ids), 0,
                                          jnp.asarray(table[b]), jpool)
        TD.paged_prefill_chunk(tstate, tm.config, torch.from_numpy(ids), 0,
                               torch.from_numpy(table[b]), tpool)
    pos = np.asarray(lengths + [0], np.int32)
    for _ in range(2):
        tokens = rng.integers(0, cfg.vocab_size, (4, W)).astype(np.int32)
        jl, jpool = JD.paged_verify_step(jstate, cfg, jnp.asarray(tokens),
                                         jnp.asarray(pos), jpool,
                                         jnp.asarray(table))
        tl, _ = TD.paged_verify_step(tstate, tm.config,
                                     torch.from_numpy(tokens),
                                     torch.from_numpy(pos), tpool,
                                     torch.from_numpy(table), kernel=kernel)
        assert tl.shape == (4, W, cfg.vocab_size)
        assert np.abs(np.asarray(jl)[:3] - tl.numpy()[:3]).max() <= 1e-4
        pos = pos + np.asarray([2, 3, 1, 0], np.int32)
    for (jk, jv), (tk, tv) in zip(jpool, tpool):
        for j, t in ((jk, tk), (jv, tv)):
            assert np.abs(np.asarray(j)[1:] - t.numpy()[1:]).max() <= 1e-4


def test_verify_kernel_rows_equal_decode_steps(port_model):
    """K4's plain version over the B * W flattened columns computes
    what the gather verify does, and each column what a decode step at
    depth pos + j computes (bitwise on the CPU, fp32)."""
    cfg = port_model.config
    state = TD.collect_decode_state(port_model)
    rng = np.random.default_rng(1)
    bt, bmax, W = 8, 6, 4
    table = torch.zeros((3, bmax), dtype=torch.int32)
    table[0, :5] = torch.tensor([3, 8, 1, 12, 5])
    table[1, :3] = torch.tensor([2, 9, 14])
    lengths = [30, 17, 0]
    pools = {k: TD.init_paged_cache(cfg, 16, bt, torch.float32, device="cpu")
             for k in ("gather", "cuda", "steps")}
    for b, L in enumerate(lengths[:2]):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 32))
                               .astype(np.int32))
        for pool in pools.values():
            TD.paged_prefill_chunk(state, cfg, ids, 0, table[b], pool)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, W))
                              .astype(np.int32))
    pos = torch.tensor(lengths, dtype=torch.int32)
    lg, _ = TD.paged_verify_step(state, cfg, tokens, pos, pools["gather"],
                                 table)
    lk, _ = TD.paged_verify_step(state, cfg, tokens, pos, pools["cuda"],
                                 table, kernel="cuda")
    assert (lg - lk).abs().max() <= 1e-5
    for j in range(W):
        ls, _ = TD.paged_decode_step_batch(state, cfg, tokens[:, j],
                                           pos + j, pools["steps"], table,
                                           kernel="cuda")
        assert torch.equal(ls[:2], lk[:2, j]), j
    for a, b in zip(TD.pool_leaves(pools["cuda"]),
                    TD.pool_leaves(pools["steps"])):
        assert torch.equal(a[1:], b[1:])


# -- engine streams against the JAX engine --------------------------------


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's greedy streams (spec off and on, k=4) and spec
    counters for the solo and the co-batched mix."""
    out = {}
    for name, prompts in (("solo", SOLO), ("cobatched", COBATCHED)):
        off, _ = _run(_jax_cls(), models[0], prompts, None)
        on, eng = _run(_jax_cls(), models[0], prompts, _jax_spec(4))
        assert on == off
        out[name] = (off, _counters(eng))
    return out


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
@pytest.mark.parametrize("overlap", ["off", "on"])
@pytest.mark.parametrize("mix", ["solo", "cobatched"])
def test_greedy_streams_and_counters_equal_jax(models, jax_streams, mix,
                                               overlap, kernel):
    prompts = SOLO if mix == "solo" else COBATCHED
    want, counters = jax_streams[mix]
    on, eng = _run(LLMEngine, models[1], prompts, SpecConfig(k=4),
                   engine_kw=dict(overlap=overlap, decode_kernel=kernel))
    off, _ = _run(LLMEngine, models[1], prompts, None,
                  engine_kw=dict(decode_kernel=kernel))
    assert on == want and off == want
    got = _counters(eng)
    assert got[1] > 0 and got[0] >= got[1] and got[2] > 0
    if overlap == "off":
        assert got == counters
    assert eng.num_graphs == 0 and eng.verify_widths == (2, 4, 8)


@pytest.fixture(scope="module")
def bf16_runs():
    jm, tm = _jax_models("bfloat16", 3)
    joff, _ = _run(_jax_cls(), jm, BF16, None, max_new=12)
    jon, _ = _run(_jax_cls(), jm, BF16, _jax_spec(3), max_new=12)
    assert jon == joff
    return tm, joff


def test_greedy_streams_bf16(bf16_runs):
    """bf16 (the JAX suite's bf16 case): the port's streams with
    speculation are bitwise its streams without it, and the JAX
    engine's up to where the port's and JAX's bf16 streams already part
    without speculation — at a near tie of one bf16 ulp (2^-7 at
    |logit| in [1, 2)) in the port's logits."""
    tm, want = bf16_runs
    rows = {}                    # (request index, token index) -> logits
    eng = LLMEngine(tm, **ENGINE_KW)
    decode = eng._decode_logits

    def recorded(token, pos, table):
        logits = decode(token, pos, table)
        for s, req in enumerate(eng._slots):
            if req is not None:
                rows[reqs.index(req), len(req.tokens)] = logits[s].float()
        return logits

    eng._decode_logits = recorded
    reqs = [eng.submit(p, 12) for p in BF16]
    eng.run()
    off = [[int(t) for t in r.tokens] for r in reqs]
    on, spec_eng = _run(LLMEngine, tm, BF16, SpecConfig(k=3), max_new=12)
    assert on == off
    assert _counters(spec_eng)[1] > 0
    assert on[0] == want[0]                 # the repetitive prompt
    for i, (got, ref) in enumerate(zip(off, want)):
        if got == ref:
            continue
        t = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        top2 = rows[i, t].topk(2).values
        assert (top2[0] - top2[1]).item() <= 2 ** -7, (t, top2)
        assert rows[i, t][ref[t]].item() == top2[1].item()


# -- emission edges (the JAX suite's, on the port) ------------------------


def test_eos_mid_accepted_draft(models):
    prompt = _repetitive(4, 22)
    base, _ = _run(LLMEngine, models[1], [prompt], None, max_new=24)
    prompt2 = np.concatenate([prompt, base[0][:12]])
    ekw = dict(max_prompt_len=40)
    eos = next(t for j, t in enumerate(base[0][14:], start=14)
               if t in base[0][:12] and t not in base[0][12:j])
    off, _ = _run(LLMEngine, models[1], [prompt2], None, max_new=24,
                  engine_kw=ekw, eos_token_id=eos)
    on, eng = _run(LLMEngine, models[1], [prompt2], SpecConfig(k=4),
                   max_new=24, engine_kw=ekw, eos_token_id=eos)
    assert on == off
    assert on[0][-1] == eos and len(on[0]) < 24
    assert _counters(eng)[1] > 0
    assert eng._pager.used_blocks == 0 and eng.num_active == 0


@pytest.mark.parametrize("max_new", [5, 7, 11])
def test_max_new_inside_accepted_run(models, max_new):
    off, _ = _run(LLMEngine, models[1], SOLO, None, max_new=max_new)
    on, eng = _run(LLMEngine, models[1], SOLO, SpecConfig(k=4),
                   max_new=max_new)
    assert on == off and len(on[0]) == max_new
    emitted = eng.metrics()["llm_engine_tokens_emitted_per_step"][
        "series"][""]
    assert emitted["sum"] == max_new - 1     # the first is prefill's


def test_cancel_and_deadline_between_steps(models):
    eng = LLMEngine(models[1], speculation=SpecConfig(k=4), **ENGINE_KW)
    keep = eng.submit(_repetitive(4, 22), max_new_tokens=16)
    dead = eng.submit(_repetitive(4, 18, seed=1), max_new_tokens=64,
                      deadline=30.0)
    gone = eng.submit(_repetitive(2, 12, seed=2), max_new_tokens=64)
    for _ in range(3):
        eng.step()
    gone.cancel()
    dead._deadline_t = time.monotonic() - 1.0
    eng.run()
    assert keep.done and len(keep.tokens) == 16
    assert gone.done and gone.cancelled
    assert dead.done and isinstance(dead.error, DeadlineExceeded)
    assert eng.num_active == 0 and not eng._queue
    assert eng._pager.used_blocks == 0
    assert all(i is None for i in eng._spec_idx)


@pytest.mark.parametrize("overlap", ["off", "on"])
def test_sampled_streams_seeded_and_equal_without_spec(models,
                                                       overlap):
    """Sampled requests (the JAX suite's knobs, and a cooler one that
    accepts drafts) terminate with the right lengths, repeat in their
    seed, and are the streams they have without speculation."""
    prompts = [_repetitive(4, 22), _random(11, seed=7)]
    outs = {}
    for temp in (0.9, 0.05):
        kw = dict(greedy=False, temperature=temp, top_p=0.9, seed=5)
        ekw = dict(overlap=overlap)
        a, eng = _run(LLMEngine, models[1], prompts, SpecConfig(k=3),
                      max_new=14, engine_kw=ekw, **kw)
        b, _ = _run(LLMEngine, models[1], prompts, SpecConfig(k=3),
                    max_new=14, engine_kw=ekw, **kw)
        off, _ = _run(LLMEngine, models[1], prompts, None, max_new=14,
                      engine_kw=ekw, **kw)
        assert a == b == off
        assert all(len(t) == 14 for t in a)
        outs[temp] = _counters(eng)
    assert outs[0.05][1] > 0                 # drafts accepted


# -- overlap, pressure, prefix cache, server ------------------------------


@pytest.fixture(scope="module")
def models_bf16():
    return _jax_models("bfloat16", 0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_overlap_matrix_with_spec(models, models_bf16, dtype):
    """The spec cells of the JAX suite's overlap matrix
    (tests/test_async_engine.py:73-92): greedy and sampled requests,
    solo and co-batched, overlap on equal to off; the fp32 greedy
    streams equal the JAX engine's."""
    tm = models[1] if dtype == "fp32" else models_bf16[1]
    reqs = [([7, 8, 9, 7, 8, 9, 7, 8, 9, 7], 12, dict(seed=1)),
            (list(range(1, 14)), 10,
             dict(greedy=False, temperature=0.8, top_p=0.9, seed=42)),
            ([5, 6, 7], 8, dict(seed=3))]

    def run(cls, m, batch, overlap, spec):
        eng = cls(m, max_slots=4, max_len=64, max_prompt_len=32,
                  min_bucket=8, prefill_chunk=8, overlap=overlap,
                  speculation=spec)
        rs = [eng.submit(np.asarray(p, np.int32), n, **kw)
              for p, n, kw in batch]
        eng.run()
        return [[int(t) for t in r.tokens] for r in rs], eng

    for batch in ([reqs[0]], reqs):
        s, _ = run(LLMEngine, tm, batch, "off", SpecConfig(k=4))
        o, oe = run(LLMEngine, tm, batch, "on", SpecConfig(k=4))
        assert s == o
        if batch is reqs:
            assert _counters(oe)[1] > 0
        if dtype == "fp32":
            j, _ = run(_jax_cls(), models[0], batch, "off", _jax_spec(4))
            assert [x for x, (_, _, kw) in zip(s, batch)
                    if kw.get("greedy", True)] == \
                [x for x, (_, _, kw) in zip(j, batch)
                 if kw.get("greedy", True)]


PRESSURE_KW = dict(max_slots=4, max_len=64, max_prompt_len=32, min_bucket=8,
                   kv_block_tokens=8)


def _pressure_prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, (L,)) for L in [20, 28, 25, 30, 22, 27]]


def _pressure_run(cls, model, **kw):
    eng = cls(model, **dict(PRESSURE_KW, **kw))
    reqs = [eng.submit(p, max_new_tokens=24) for p in _pressure_prompts()]
    eng.run(max_steps=5000)
    assert all(r.done and r.error is None for r in reqs)
    return eng, [[int(t) for t in r.tokens] for r in reqs]


def _ladder(eng):
    return [eng._m_preempt.value, eng._m_resume.value,
            eng._m_prefill_requeued.value, eng._m_swap_bytes.value]


@pytest.fixture(scope="module")
def jax_pressure(models):
    """The JAX suite's spec-on pressure runs (tests/
    test_workload_preemption.py:76-110): unpressured streams, ladder
    and spec counters under `kv_blocks=16` per policy."""
    _, base = _pressure_run(_jax_cls(), models[0], speculation=True)
    runs = {}
    for policy in ("auto", "swap", "recompute"):
        eng, outs = _pressure_run(_jax_cls(), models[0], speculation=True,
                                  kv_blocks=16, preempt_policy=policy)
        assert outs == base
        runs[policy] = (_ladder(eng), _counters(eng))
    return base, runs


@pytest.mark.parametrize("policy", ["auto", "swap", "recompute"])
def test_spec_under_pressure_equals_jax(models, jax_pressure, policy):
    base, runs = jax_pressure
    eng, outs = _pressure_run(LLMEngine, models[1], speculation=True,
                              kv_blocks=16, preempt_policy=policy)
    assert outs == base
    assert _ladder(eng) == runs[policy][0]
    assert _counters(eng) == runs[policy][1]
    assert eng._m_preempt.value >= 3
    assert eng._m_resume.value == eng._m_preempt.value
    eng._pager.check()
    assert eng._pager.used_blocks == 0 and eng._pager.host_blocks_used == 0


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_spec_under_pressure_overlap_and_bf16(models_bf16, policy):
    """Within the port: overlap on under pressure gives the unpressured
    streams, and so does the bf16 pool (a park keeps the drafter)."""
    tm = models_bf16[1]
    _, base = _pressure_run(LLMEngine, tm, speculation=True)
    for overlap in ("off", "on"):
        eng, outs = _pressure_run(LLMEngine, tm, speculation=True,
                                  kv_blocks=16, preempt_policy=policy,
                                  overlap=overlap)
        assert outs == base and eng._m_preempt.value >= 3


def test_parked_record_keeps_the_drafter(port_model):
    """A park carries the slot's n-gram index, draft length and EMA, and
    both resumes reinstate them."""
    seen = []
    eng = LLMEngine(port_model, speculation=SpecConfig(k=4),
                    **dict(PRESSURE_KW, kv_blocks=16))
    park, install = eng._park_slot, eng._install_parked

    def parked(slot):
        seen.append((eng._spec_idx[slot], eng._spec_k[slot],
                     eng._spec_ema[slot]))
        park(slot)
        pr = eng._parked[-1]
        assert (pr.spec_idx, pr.spec_k, pr.spec_ema) == seen[-1]
        assert eng._spec_idx[slot] is None

    def installed(slot, pr):
        install(slot, pr)
        assert eng._spec_idx[slot] is pr.spec_idx is not None
        assert (eng._spec_k[slot], eng._spec_ema[slot]) == \
            (pr.spec_k, pr.spec_ema)
        seen.append(pr.mode)

    eng._park_slot, eng._install_parked = parked, installed
    reqs = [eng.submit(p, 24) for p in _pressure_prompts()]
    eng.run(max_steps=5000)
    assert all(r.done for r in reqs)
    modes = [x for x in seen if isinstance(x, str)]
    assert {"swap", "recompute"} & set(modes) and len(modes) >= 3


def test_spec_with_prefix_cache_two_passes(models):
    """The JAX suite's bounded-programs case: k=4 with 8 trie blocks,
    the mix twice (the second pass hits): streams equal the JAX
    engine's and the port's without speculation."""
    prompts = [_repetitive(4, 22), _random(17, seed=1), _random(9, seed=2),
               _repetitive(2, 15, seed=3), _random(26, seed=4),
               _repetitive(3, 19, seed=5)]

    def run(cls, m, spec):
        eng = cls(m, speculation=spec, prefix_cache_blocks=8, **ENGINE_KW)
        out = []
        for _ in range(2):
            reqs = [eng.submit(p, max_new_tokens=6 + (i % 3))
                    for i, p in enumerate(prompts)]
            eng.run()
            out.append([[int(t) for t in r.tokens] for r in reqs])
        return out, eng

    want, jeng = run(_jax_cls(), models[0], _jax_spec(4))
    got, eng = run(LLMEngine, models[1], SpecConfig(k=4))
    off, _ = run(LLMEngine, models[1], None)
    assert got == want == off
    assert _counters(eng)[:3] == _counters(jeng)[:3]
    assert _counters(eng)[1] > 0
    hits = eng.metrics()["llm_engine_prefix_cache_hits_total"]["series"][
        ""]["value"]
    assert hits > 0


def test_prepare_programs_runs_verify_widths(port_model):
    eng = LLMEngine(port_model, speculation=4, **ENGINE_KW)
    assert eng.prepare_programs() == {"decode": 1, "verify": 3,
                                      "chunk": len(eng.chunk_sizes)}
    ref, _ = _run(LLMEngine, port_model, SOLO, None)
    reqs = [eng.submit(p, 20) for p in SOLO]
    eng.run()
    assert [[int(t) for t in r.tokens] for r in reqs] == ref


def test_server_with_speculation_parks_and_wakes(models):
    """The JAX suite's server case: LLMServer passes `speculation`
    through; the idle driver parks on its hand-off queue, a later
    submit completes, and shutdown wakes it at once."""
    ref, _ = _run(LLMEngine, models[1], [_repetitive(4, 20)],
                  SpecConfig(k=3), max_new=8,
                  engine_kw=dict(max_slots=2))
    srv = LLMServer(models[1], speculation=SpecConfig(k=3),
                    **dict(ENGINE_KW, max_slots=2))
    try:
        r = srv.submit(_repetitive(4, 20), max_new_tokens=8)
        assert srv.result(r, timeout=120) == ref[0]
        time.sleep(0.3)
        r2 = srv.submit(_random(9, seed=3), max_new_tokens=4)
        assert len(srv.result(r2, timeout=120)) == 4
        assert srv.engine.spec is not None
        assert _counters(srv.engine)[2] > 0  # verify steps ran
    finally:
        t0 = time.monotonic()
        srv.shutdown()
    assert time.monotonic() - t0 < 2.0
    assert not srv._thread.is_alive()
    srv.shutdown()


# -- the card ------------------------------------------------------------


@pytest.mark.gpu
def test_verify_graphs_on_card():
    """On the card: one graph per decode and verify width and no more;
    each verify width's replay gives bitwise the eager verify step's
    logits, greedy argmax and accept length on the same inputs, and
    twice the same; K4 launches once a layer a replay; greedy streams
    with speculation equal those without, overlap on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from paddle_tpu_torch.ops import paged_attention as PA
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TModel(TConfig.from_preset("debug-4l"), device="cuda", seed=1)
    kw = dict(max_slots=4, max_len=256, prefill_chunk=32)
    eng = LLMEngine(model, overlap="off", speculation=SpecConfig(k=7), **kw)
    assert eng.verify_widths == (2, 4, 8)
    eng.prepare_programs()
    assert eng.num_graphs == 4 == len(eng.decode_widths) + len(
        eng.verify_widths)
    rng = np.random.default_rng(2)
    for L in (5, 17, 33, 64):
        eng.submit(np.tile(rng.integers(0, 1024, 3), L)[:L], 40)
    while eng.num_prefilling or eng._queue:
        eng.step()
    g = eng._vgraphs
    layers = model.config.num_hidden_layers
    for W in eng.verify_widths:
        assert g.recorded[W]["paged_attention"] == layers
        flat = g.inputs(W)
        toks = rng.integers(0, 1024, (4, W)).astype(np.int32)
        toks[:, 0] = eng._token
        host = np.concatenate([toks.reshape(-1), eng._pos,
                               np.full(4, W, np.int32),
                               eng._pager.table.reshape(-1)])
        flat.copy_(torch.from_numpy(host))
        views = [v.clone() for v in g.views(flat, W)]
        before = PA.LAUNCHES["paged_attention"]
        eager_l, eager_p = (x.clone() for x in eng._verify_logits(*views))
        logits, packed = (x.clone() for x in g.replay(W))
        logits2, packed2 = g.replay(W)
        torch.cuda.synchronize()
        assert PA.LAUNCHES["paged_attention"] - before == 3 * layers
        assert torch.equal(logits, logits2) and torch.equal(packed, packed2)
        assert torch.equal(logits, eager_l), W
        assert torch.equal(packed, eager_p), W
    streams = {}
    prompts = [np.tile(rng.integers(0, 1024, 4), 30)[:L]
               for L in (9, 40, 70, 100)]
    for overlap in ("on", "off"):
        for spec in (None, SpecConfig(k=7)):
            e = LLMEngine(model, overlap=overlap, speculation=spec, **kw)
            reqs = [e.submit(p, 24) for p in prompts]
            e.run()
            assert e.num_graphs <= len(e.decode_widths) + len(
                e.verify_widths)
            assert e.num_graph_replays == e.metrics()[
                "llm_engine_decode_steps_total"]["series"][""]["value"]
            streams[overlap, spec is None] = [list(r.tokens) for r in reqs]
    assert streams["on", False] == streams["off", False]
