"""Static KV-cache generation in the port against the JAX package: the
contiguous-cache programs of `models/llama_decode.py`,
`LlamaForCausalLM.generate` (the KV cache, and the naive full-forward
loop that MoE models take) and `generation.generate` (greedy, sampling,
beam search, the adapters).  The port's counterpart of
tests/test_llama_decode.py and the Llama half of tests/test_generation.py.

Weights cross by name (`load_reference_arrays`).  Tolerances: fp32
logits and hidden states within atol 1e-4 (the frameworks order fp32
sums differently); greedy and beam-search streams token-exact in fp32;
bf16 streams equal up to their first difference, which must be a near
tie of at most 2^-7 (one bf16 ulp at |logit| in [1, 2)) in the port's
logits.  Sampling cannot match JAX (threefry vs Philox): its draws are
held to the masked distribution (20,000 rows, 4-sigma bins) and to
their seed.
"""

import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu_torch import generation as TG
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import llama_decode as TD
from paddle_tpu_torch.models import load_reference_arrays

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(preset="tiny", seed=0, **over):
    """(JAX model, port model with its weights) at `preset` + `over`."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(seed)
    jm = LlamaForCausalLM(LlamaConfig.from_preset(preset, **over))
    tm = TModel(TConfig.from_preset(preset, **over), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module", params=["tiny", "debug-4l"])
def pair(request):
    return _pair(request.param)


def _ids(B, S, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, S))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# -- the contiguous-cache programs -----------------------------------------


def test_contiguous_programs_vs_jax(pair):
    """prefill, prefill_chunk (two chunks into slot 1 of a 2-slot
    cache, the second padded), decode_step, decode_step_batch (rows at
    their own depths) and verify_step against JAX: logits, hidden
    states and the caches within 1e-4."""
    import jax.numpy as jnp
    from paddle_tpu.models import llama_decode as JD
    jm, tm = pair
    cfg, tcfg = jm.config, tm.config
    V = cfg.vocab_size
    js, ts = JD.collect_decode_state(jm), TD.collect_decode_state(tm)
    ids = _ids(2, 10, V, 2)
    T = 24

    jc = JD.init_cache(cfg, 2, T, jnp.float32)
    tc = TD.init_cache(tcfg, 2, T, torch.float32)
    jl, jc = JD.prefill(js, cfg, jnp.asarray(ids), jc)
    tl, tc = TD.prefill(ts, tcfg, torch.from_numpy(ids), tc)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL)
    # the naive forward's last logits, and rows past the prompt zero
    full = tm(torch.from_numpy(ids))[:, -1].detach()
    np.testing.assert_allclose(_np(tl), _np(full), atol=TOL)
    assert float(tc[0][0][:, 10:].abs().max()) == 0.0

    tok = np.argmax(_np(jl), -1)
    for pos in (10, 11):
        jl, jc = JD.decode_step(js, cfg, jnp.asarray(tok),
                                jnp.asarray(pos, jnp.int32), jc)
        tl, tc = TD.decode_step(ts, tcfg, torch.from_numpy(tok), pos, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL)
        tok = np.argmax(_np(jl), -1)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(_np(tk), _np(jk), atol=TOL)
        np.testing.assert_allclose(_np(tv), _np(jv), atol=TOL)

    pos = np.asarray([12, 9], np.int32)           # rows at their own depths
    jl, jc = JD.decode_step_batch(js, cfg, jnp.asarray(tok),
                                  jnp.asarray(pos), jc)
    tl, tc = TD.decode_step_batch(ts, tcfg, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tc)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL)

    toks = _ids(2, 4, V, 5).astype(np.int32)
    pos = np.asarray([13, T - 2], np.int32)       # row 1 runs past the cache
    jv, jc = JD.verify_step(js, cfg, jnp.asarray(toks), jnp.asarray(pos), jc)
    tv, tc = TD.verify_step(ts, tcfg, torch.from_numpy(toks),
                            torch.from_numpy(pos), tc)
    assert tuple(tv.shape) == (2, 4, V)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=TOL)
    for (jk, _), (tk, _) in zip(jc, tc):
        np.testing.assert_allclose(_np(tk), _np(jk), atol=TOL)

    jcs = JD.init_cache(cfg, 2, T, jnp.float32)
    tcs = TD.init_cache(tcfg, 2, T, torch.float32)
    chunk = np.zeros((1, 16), np.int64)
    chunk[0, :2] = ids[0, 8:]                      # rows 8, 9, then padding
    for off, c in ((0, ids[:1, :8]), (8, chunk)):
        jx, jcs = JD.prefill_chunk(js, cfg, jnp.asarray(c), off, 1, jcs)
        tx, tcs = TD.prefill_chunk(ts, tcfg, torch.from_numpy(c), off, 1,
                                   tcs)
        np.testing.assert_allclose(_np(tx), _np(jx), atol=TOL)
    for (jk, _), (tk, _) in zip(jcs, tcs):
        np.testing.assert_allclose(_np(tk), _np(jk), atol=TOL)
        assert float(tk[0].abs().max()) == 0.0        # slot 0 untouched


# -- generate and the naive loop ------------------------------------------


def test_generate_vs_jax_and_naive_loop(pair):
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.models import llama_decode as JD
    jm, tm = pair
    ids = _ids(2, 12, jm.config.vocab_size, 0)
    want = np.asarray(jm.generate(paddle.to_tensor(ids, dtype="int64"),
                                  max_new_tokens=6).numpy())
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=6)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 18)
    np.testing.assert_array_equal(got.numpy(), want)
    naive = tm.generate(torch.from_numpy(ids), max_new_tokens=6,
                        use_cache=False)
    np.testing.assert_array_equal(naive.numpy(), want)
    # one new token, and a numpy prompt
    one = tm.generate(ids, max_new_tokens=1)
    np.testing.assert_array_equal(one.numpy(), want[:, :13])

    # decode_greedy from the same prefilled cache
    js, ts = JD.collect_decode_state(jm), TD.collect_decode_state(tm)
    jc = JD.init_cache(jm.config, 2, 20, jnp.float32)
    tc = TD.init_cache(tm.config, 2, 20, torch.float32)
    jl, jc = JD.prefill(js, jm.config, jnp.asarray(ids), jc)
    _, tc = TD.prefill(ts, tm.config, torch.from_numpy(ids), tc)
    first = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jt, _ = JD.decode_greedy(js, jm.config, jnp.asarray(first),
                             jnp.asarray(12, jnp.int32), jc, 5)
    tt, _ = TD.decode_greedy(ts, tm.config, torch.from_numpy(first), 12,
                             tc, 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_moe_naive_loop_vs_jax():
    """An MoE model generates through the naive full-forward loop,
    with or without use_cache, token-exact with JAX's."""
    import paddle_tpu as paddle
    jm, tm = _pair(moe_num_experts=4, moe_top_k=2, intermediate_size=96)
    ids = _ids(2, 6, 256, 1)
    want = np.asarray(jm.generate(paddle.to_tensor(ids, dtype="int64"),
                                  max_new_tokens=4).numpy())
    for use_cache in (True, False):
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=4,
                          use_cache=use_cache)
        np.testing.assert_array_equal(got.numpy(), want)


def _step_logits(tm, ids, n):
    """The port's contiguous-cache logits before each of n greedy
    tokens, along its own stream: [(B, V)] * n."""
    st = TD.collect_decode_state(tm)
    B, S = ids.shape
    cache = TD.init_cache(tm.config, B, S + n, st["embed"].dtype)
    with torch.no_grad():
        lg, cache = TD.prefill(st, tm.config, ids, cache)
        rows = [lg.float()]
        for i in range(n - 1):
            lg, cache = TD.decode_step(st, tm.config,
                                       torch.argmax(lg, -1), S + i, cache)
            rows.append(lg.float())
    return rows


def test_bf16_streams_vs_jax_and_zero_tokens():
    """bf16 (the JAX suite's bf16 case): the KV cache equals the naive
    loop within the port; against JAX each stream is equal up to its
    first difference, a near tie of at most 2^-7 in the port's logits."""
    import paddle_tpu as paddle
    jm, tm = _pair(dtype="bfloat16")
    ids = _ids(2, 9, 256, 3)
    want = np.asarray(jm.generate(paddle.to_tensor(ids, dtype="int64"),
                                  max_new_tokens=4).numpy())[:, 9:]
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=4)
    rows = _step_logits(tm, torch.from_numpy(ids), 4)
    for b in range(2):
        g = got[b, 9:].tolist()
        if g == want[b].tolist():
            continue
        t = next(j for j, (x, y) in enumerate(zip(g, want[b])) if x != y)
        top2 = rows[t][b].topk(2).values
        assert (top2[0] - top2[1]).item() <= 2 ** -7, (b, t, top2)
    # max_new_tokens=0 returns the prompt, as the naive loop would
    out = tm.generate(torch.from_numpy(ids), max_new_tokens=0)
    assert tuple(out.shape) == (2, 9)
    assert torch.equal(out, tm.generate(torch.from_numpy(ids), 0,
                                        use_cache=False))


# -- generation.generate ----------------------------------------------------


def _tiny_llama_pair():
    """tests/test_generation.py's `_tiny_llama` on both sides."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    kw = dict(vocab_size=29, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64,
              dtype="float32")
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig(**kw))
    tm = TModel(TConfig(**kw), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.mark.parametrize("strategy,kw", [
    ("greedy", {}),
    ("greedy", {"eos_token_id": "first"}),
    ("beam_search", {"num_beams": 4}),
    ("beam_search", {"num_beams": 3, "length_penalty": 1.0,
                     "eos_token_id": "first"}),
    ("beam_search", {"num_beams": 2, "max_new_tokens": 1}),
])
def test_generation_generate_vs_jax(strategy, kw):
    from paddle_tpu import generation as JG
    jm, tm = _tiny_llama_pair()
    ids = np.array([[3, 5, 7, 2], [1, 4, 9, 11]], np.int64)
    kw = dict(kw)
    new = kw.pop("max_new_tokens", 6)
    if kw.get("eos_token_id") == "first":
        # an EOS the streams really emit: the first greedy token
        kw["eos_token_id"] = int(np.asarray(JG.generate(
            jm, ids, max_new_tokens=1).numpy())[0, -1])
    want = np.asarray(JG.generate(jm, ids, max_new_tokens=new,
                                  decode_strategy=strategy, **kw).numpy())
    got = TG.generate(tm, torch.from_numpy(ids), max_new_tokens=new,
                      decode_strategy=strategy, **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if "eos_token_id" in kw and strategy == "greedy":
        assert (got[0, 4:] == kw["eos_token_id"]).all()   # EOS padding


def test_generation_greedy_matches_llama_decode_at_debug_4l():
    import paddle_tpu as paddle
    jm, tm = _pair("debug-4l")
    ids = _ids(3, 7, jm.config.vocab_size, 6)
    want = np.asarray(jm.generate(paddle.to_tensor(ids, dtype="int64"),
                                  max_new_tokens=5).numpy())
    got = TG.generate(tm, ids, max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), want)
    beam = TG.generate(tm, ids, max_new_tokens=5,
                       decode_strategy="beam_search", num_beams=3)
    from paddle_tpu import generation as JG
    jbeam = JG.generate(jm, ids, max_new_tokens=5,
                        decode_strategy="beam_search", num_beams=3)
    np.testing.assert_array_equal(beam.numpy(), np.asarray(jbeam.numpy()))


def test_top_k_mask_vs_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu import generation as JG
    rs = np.random.RandomState(2)
    logits = rs.randn(6, 11).astype(np.float32)
    for k in (1, 3, 11):
        want = np.asarray(JG.top_k_mask(jnp.asarray(logits), k))
        got = TG.top_k_mask(torch.from_numpy(logits), k).numpy()
        np.testing.assert_array_equal(got, want)


def test_sample_logits_follows_masked_distribution():
    """20,000 rows of one logits row through temperature, top-k and
    top-p: every draw inside the kept set, the frequencies within 4
    sigma of the masked softmax; the same generator seed gives the same
    tokens."""
    B = 20000
    row = torch.tensor([1.2, 0.3, -0.5, 0.1, 2.0, -1.0, 0.7, 0.0])
    logits = row.expand(B, -1).contiguous()
    temp, k, p = 0.8, 5, 0.9
    warped = row / temp
    warped = TG.top_k_mask(warped[None], k)
    warped = TG.top_p_mask(warped, p)[0]
    probs = torch.softmax(warped, -1).numpy()
    kept = probs > 0
    assert 1 < kept.sum() < k + 1
    draws = TG.sample_logits(logits, torch.Generator().manual_seed(7),
                             temperature=temp, top_k=k, top_p=p).numpy()
    assert kept[draws].all()
    freq = np.bincount(draws, minlength=row.numel()) / B
    tol = 4 * np.sqrt(probs * (1 - probs) / B)
    assert np.all(np.abs(freq - probs) <= tol + 1e-3), (freq, probs)
    again = TG.sample_logits(logits, torch.Generator().manual_seed(7),
                             temperature=temp, top_k=k, top_p=p).numpy()
    np.testing.assert_array_equal(again, draws)


def test_generate_sampling_seeded():
    _, tm = _tiny_llama_pair()
    ids = np.array([[3, 5, 7, 2]], np.int64)
    kw = dict(max_new_tokens=5, decode_strategy="sampling", top_k=5,
              temperature=0.8)
    a = TG.generate(tm, ids, seed=7, **kw)
    b = TG.generate(tm, ids, seed=7, **kw)
    assert tuple(a.shape) == (1, 9) and torch.equal(a, b)
    assert ((a >= 0) & (a < 29)).all()
    outs = {tuple(TG.generate(tm, ids, seed=s, **kw)[0].tolist())
            for s in range(8)}
    assert len(outs) > 1                       # the seed reaches the draws


class _TinyLM(nn.Module):
    """A non-Llama LM: ids -> (logits, hidden), with dropout that only
    an eval-mode forward switches off."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(1)
        self.emb = nn.Embedding(17, 16)
        self.proj = nn.Linear(16, 17)
        self.drop = nn.Dropout(0.5)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, ids):
        h = self.drop(torch.tanh(self.emb(ids)))
        return self.proj(h), h


def test_pure_forward_adapter_equals_full_forward_argmax():
    model = _TinyLM()
    ids = np.array([[4, 6, 2], [1, 0, 16]], np.int64)
    model.train()
    got = TG.generate(model, ids, max_new_tokens=4)
    assert model.training                           # mode restored
    assert isinstance(model.__dict__["_decode_adapter"],
                      TG.PureForwardAdapter)
    model.eval()
    cur = torch.from_numpy(ids)
    with torch.no_grad():
        for _ in range(4):
            nxt = torch.argmax(model(cur)[0][:, -1], -1)
            cur = torch.cat([cur, nxt[:, None]], 1)
    assert torch.equal(got, cur)
    beam1 = TG.generate(model, ids, max_new_tokens=4,
                        decode_strategy="beam_search", num_beams=1)
    assert torch.equal(beam1, cur)


def test_errors_and_zero_tokens_match_jax():
    from paddle_tpu import generation as JG
    jm, tm = _tiny_llama_pair()
    ids = np.array([[3, 5, 7]], np.int64)
    for args, kw in [((np.array([3, 5, 7]),), {}),
                     ((ids,), {"decode_strategy": "nucleus"}),
                     ((ids,), {"decode_strategy": "beam_search",
                               "num_beams": 0})]:
        with pytest.raises(ValueError) as jerr:
            JG.generate(jm, *args, max_new_tokens=3, **kw)
        with pytest.raises(ValueError) as terr:
            TG.generate(tm, *args, max_new_tokens=3, **kw)
        assert str(terr.value) == str(jerr.value)
    for new in (0, -2):
        want = np.asarray(JG.generate(jm, ids, max_new_tokens=new).numpy())
        got = TG.generate(tm, ids, max_new_tokens=new)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    t = torch.from_numpy(ids)
    assert TG.generate(tm, t, max_new_tokens=0) is t
