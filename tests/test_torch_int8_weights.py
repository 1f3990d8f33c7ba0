"""Weight-only int8 serving (`weight_dtype="int8"`) in the port against
the JAX package: the quantizer, the product, the decode state, the paged
programs and the engine's greedy streams; and kernel Q1 against its
plain version on the card.

Tolerances, each with its reason:
  * `quantize_weight` / `weight_only_int8` / the int8 decode state:
    bitwise (the same fp32 arithmetic, round half to even in both);
  * `matmul_wo_int8` (plain) vs JAX: fp32 within 1e-5 of the larger of
    the element and 1e-3 x its row's max (the two frameworks order fp32
    sums differently); bf16 within one bf16 ulp of the larger of the
    element and 2^-8 x its row's max (an fp32 sum on either side of a
    bf16 rounding boundary);
  * paged program logits and hidden states (fp32): atol 1e-4, as
    tests/test_torch_llama_decode.py holds the float weights;
  * engine streams: token-exact (greedy, fp32, `tiny`);
  * Q1 vs its plain version on the card: bf16 per element 2^-7 |plain|
    + 2^-16 x the row's max |plain|, fp32 1e-5 x the row's max |plain|
    (`ops.wo_int8_matmul.TOL_TEXT`); a graph replay bitwise the eager
    call.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import llama_decode as TD
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.ops import wo_int8_matmul as Q1
from paddle_tpu_torch.quantization import int8 as TQ

ENGINE_KW = dict(max_slots=3, max_len=64, max_prompt_len=32, min_bucket=8,
                 prefill_chunk=16)
LENGTHS = [5, 9, 17, 26, 7, 30]
MAX_NEW = 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_models(preset, seed=0, dtype="float32"):
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(seed)
    jm = LlamaForCausalLM(LlamaConfig.from_preset(preset, dtype=dtype))
    tm = TModel(TConfig.from_preset(preset, dtype=dtype), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def tiny():
    return _jax_models("tiny")


def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lengths]


# -- the quantizer and the product -------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bitwise_vs_jax(dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.quantization import int8 as JQ
    rng = np.random.default_rng(1)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    w[:, 7] = 0.0                                    # an all-zero channel
    w[3, 5] = 0.5 * np.abs(w[:, 5]).max() / 127.0 * 127.0  # a .5 tie
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    for axis in (0, 1):
        jq, js = JQ.quantize_weight(jw, axis)
        tq, ts = TQ.quantize_weight(tw, axis)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, js = JQ.weight_only_int8(jw)
    tq, ts = TQ.weight_only_int8(tw)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.shape == (96, 80) and ts.shape == (80,)


def _bf16_ulp_ok(got, want):
    """|got - want| <= one bf16 ulp of max(|want|, 2^-8 x row max)."""
    ref = np.maximum(np.abs(want),
                     np.abs(want).max(-1, keepdims=True) * 2.0 ** -8)
    ulp = 2.0 ** (np.floor(np.log2(ref)) - 7)
    return np.abs(got - want) <= ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_wo_int8_plain_vs_jax(dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.quantization import int8 as JQ
    rng = np.random.default_rng(2)
    w = rng.standard_normal((128, 48)).astype(np.float32)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jq, js = JQ.weight_only_int8(w)
    tq, ts = TQ.weight_only_int8(torch.from_numpy(w))
    jy = JQ.matmul_wo_int8(jnp.asarray(x, getattr(jnp, dtype)), jq, js)
    ty = TQ.matmul_wo_int8(torch.from_numpy(x).to(getattr(torch, dtype)),
                           tq, ts)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (2, 5, 48)
    want = np.asarray(jy.astype(jnp.float32))
    got = ty.float().numpy()
    if dtype == "float32":
        ref = np.maximum(np.abs(want),
                         1e-3 * np.abs(want).max(-1, keepdims=True))
        assert (np.abs(got - want) <= 1e-5 * ref).all()
    else:
        assert _bf16_ulp_ok(got, want).all()
    # the module-level wrapper on a CPU tensor is the plain version
    x2 = torch.from_numpy(x[0]).to(getattr(torch, dtype))
    before = Q1.LAUNCHES["wo_int8_matmul"]
    assert torch.equal(Q1.wo_int8_matmul(x2, tq, ts),
                       Q1.matmul_wo_int8_plain(x2, tq, ts))
    assert Q1.LAUNCHES["wo_int8_matmul"] == before  # CPU calls count nothing


# -- the decode state --------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "debug-4l"])
def test_decode_state_int8_bitwise_vs_jax(preset):
    from paddle_tpu.models import llama_decode as JD
    jm, tm = _jax_models(preset)
    js = JD.collect_decode_state(jm, weight_dtype="int8")
    ts = TD.collect_decode_state(tm, weight_dtype="int8")
    for key in ("embed", "final_norm", "head"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    assert len(ts["layers"]) == len(js["layers"])
    for jl, tl in zip(js["layers"], ts["layers"]):
        for key in TD._WEIGHT_KEYS:
            assert isinstance(tl[key], tuple)
            for j, t in zip(jl[key], tl[key]):
                assert t.dtype == (torch.int8 if j.dtype == np.int8
                                   else torch.float32)
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        for key in ("ln1", "ln2"):
            np.testing.assert_array_equal(tl[key].numpy(),
                                          np.asarray(jl[key]))
    # the model's parameters stay as they were (float, untouched)
    assert tm.llama.layers[0].self_attn.q_proj.weight.dtype == torch.float32
    for bad in ("int4", "bfloat16"):
        with pytest.raises(ValueError) as jerr:
            JD.collect_decode_state(jm, weight_dtype=bad)
        with pytest.raises(ValueError) as terr:
            TD.collect_decode_state(tm, weight_dtype=bad)
        assert str(terr.value) == str(jerr.value)
    assert TD.collect_decode_state(tm, weight_dtype="auto")["layers"][0][
        "wq"] is not None


# -- the paged programs ------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "debug-4l"])
def test_paged_programs_int8_weights_vs_jax(preset):
    """paged_prefill_chunk (padded tail chunks), paged_decode_step_batch
    and paged_verify_step with int8 weight state, fp32, against JAX's:
    hidden states and logits within 1e-4."""
    import jax.numpy as jnp
    from paddle_tpu.models import llama_decode as JD
    jm, tm = _jax_models(preset)
    cfg = jm.config
    bt, bmax, lengths = 8, 6, [5, 13, 20]
    B = len(lengths) + 1
    n_blocks = 1 + B * bmax
    rng = np.random.default_rng(4)
    table = np.zeros((B, bmax), np.int32)
    table[:len(lengths)] = rng.permutation(
        np.arange(1, n_blocks))[:len(lengths) * bmax].reshape(-1, bmax)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lengths]
    js = JD.collect_decode_state(jm, weight_dtype="int8")
    ts = TD.collect_decode_state(tm, weight_dtype="int8")
    jpool = JD.init_paged_cache(cfg, n_blocks, bt, jnp.float32)
    tpool = TD.init_paged_cache(tm.config, n_blocks, bt, torch.float32,
                                device="cpu")
    worst = 0.0
    for b, p in enumerate(prompts):
        for off in range(0, p.size, 8):
            ids = np.zeros((1, 8), np.int32)
            seg = p[off:off + 8]
            ids[0, :seg.size] = seg
            jx, jpool = JD.paged_prefill_chunk(
                js, cfg, jnp.asarray(ids), off, jnp.asarray(table[b]), jpool)
            tx, _ = TD.paged_prefill_chunk(
                ts, tm.config, torch.from_numpy(ids), off,
                torch.from_numpy(table[b]), tpool)
            worst = max(worst, float(np.abs(
                np.asarray(jx)[:, :seg.size] - tx[:, :seg.size].numpy()
            ).max()))
    live = len(lengths)
    pos = np.asarray(lengths + [0], np.int32)
    tok = np.zeros(B, np.int32)
    tok[:live] = [p[-1] for p in prompts]
    for _ in range(3):
        jl, jpool = JD.paged_decode_step_batch(
            js, cfg, jnp.asarray(tok), jnp.asarray(pos), jpool,
            jnp.asarray(table))
        tl, _ = TD.paged_decode_step_batch(
            ts, tm.config, torch.from_numpy(tok), torch.from_numpy(pos),
            tpool, torch.from_numpy(table))
        jl = np.asarray(jl)
        worst = max(worst, float(np.abs(jl[:live] - tl[:live].numpy()).max()))
        tok = jl.argmax(-1).astype(np.int32)
        pos = pos + np.asarray([1] * live + [0], np.int32)
    drafts = rng.integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    toks = np.concatenate([tok[:, None], drafts], 1)
    jv, _ = JD.paged_verify_step(js, cfg, jnp.asarray(toks),
                                 jnp.asarray(pos), jpool, jnp.asarray(table))
    tv, _ = TD.paged_verify_step(ts, tm.config, torch.from_numpy(toks),
                                 torch.from_numpy(pos), tpool,
                                 torch.from_numpy(table))
    assert tv.shape == (B, 4, cfg.vocab_size)
    worst = max(worst, float(np.abs(np.asarray(jv)[:live]
                                    - tv[:live].numpy()).max()))
    assert worst <= 1e-4, worst


# -- the engine --------------------------------------------------------

def _stream(eng, prompts, max_new=MAX_NEW, **kw):
    reqs = [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    eng.run(max_steps=5000)
    assert all(r.done and r.error is None for r in reqs)
    return [list(r.tokens) for r in reqs]


# the JAX engine runs at the same knobs minus those the port adds
# (overlap: the JAX engine's CPU driver is synchronous)
_SYSTEM = np.random.default_rng(9).integers(0, 256, 16).astype(np.int32)
CASES = {
    "chunked": (dict(), "mixed"),
    "whole_bucket": (dict(prefill_chunk=None), "mixed"),
    "int8_pool": (dict(kv_dtype="int8"), "mixed"),
    "overlap": (dict(overlap="on"), "mixed"),
    "int8_pool_overlap": (dict(kv_dtype="int8", overlap="on"), "mixed"),
    "speculation": (dict(speculation=3), "mixed"),
    # tests/test_workload_preemption.py's knobs: 4 slots, a pool ~2x
    # oversubscribed
    "swap_pressure": (dict(max_slots=4, kv_blocks=16, preempt_policy="swap",
                           kv_block_tokens=8), "pressure"),
    "prefix_cache": (dict(prefix_cache_blocks=8, prefix_block_tokens=8,
                          kv_block_tokens=8), "shared"),
}


def _case_prompts(kind):
    if kind == "mixed":
        return _prompts(LENGTHS)
    if kind == "pressure":
        return _prompts([20, 28, 25, 30, 22, 27], seed=3)
    return [np.concatenate([_SYSTEM, s])
            for s in _prompts([3, 6, 9, 5], seed=4)]


def _max_new(kind):
    return 24 if kind == "pressure" else MAX_NEW


@pytest.fixture(scope="module")
def jax_streams(tiny):
    from paddle_tpu.inference import LLMEngine as JEngine
    out = {}
    for name, (kw, kind) in CASES.items():
        jkw = {k: v for k, v in kw.items() if k != "overlap"}
        key = (tuple(sorted(jkw.items())), kind)
        if key not in out:
            eng = JEngine(tiny[0], weight_dtype="int8",
                          **dict(ENGINE_KW, **jkw))
            assert eng.weight_dtype == "int8"
            out[key] = _stream(eng, _case_prompts(kind),
                               max_new=_max_new(kind))
        out[name] = out[key]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_engine_streams_int8_weights_vs_jax(tiny, jax_streams, case):
    kw, kind = CASES[case]
    eng = LLMEngine(tiny[1], weight_dtype="int8", **dict(ENGINE_KW, **kw))
    assert eng.weight_dtype == "int8"
    assert isinstance(eng.state["layers"][0]["wd"], tuple)
    assert eng.state["head"].dtype == torch.float32
    assert _stream(eng, _case_prompts(kind),
                   max_new=_max_new(kind)) == jax_streams[case]
    if case == "swap_pressure":
        assert eng._m_preempt.value >= 1 and eng._m_resume.value >= 1
    if case == "prefix_cache":
        assert eng._pcache is not None and eng._pcache.hits >= 1
    if case == "speculation":
        assert eng._m_spec_proposed.value > 0
    eng._pager.check()


def test_engine_weight_dtype_default_and_errors(tiny):
    eng = LLMEngine(tiny[1], **ENGINE_KW)
    assert eng.weight_dtype == "auto"
    assert not isinstance(eng.state["layers"][0]["wq"], tuple)
    with pytest.raises(ValueError, match="unsupported weight_dtype"):
        LLMEngine(tiny[1], weight_dtype="int4", **ENGINE_KW)


def test_int8_weight_streams_equal_full_precision():
    """The port's mirror of tests/test_paged_attention_kernel.py:259:
    on `tiny`, greedy int8-weight streams equal full precision, and the
    state really is int8."""
    tm = TModel(TConfig.from_preset("tiny"), device="cpu", seed=3)
    prompts = _prompts([5, 9], seed=3)
    base = _stream(LLMEngine(tm, **ENGINE_KW), prompts, max_new=4)
    eng = LLMEngine(tm, weight_dtype="int8", **ENGINE_KW)
    assert _stream(eng, prompts, max_new=4) == base
    wq, sc = eng.state["layers"][0]["wq"]
    assert wq.dtype == torch.int8 and sc.dtype == torch.float32


# -- kernel Q1 on the card ---------------------------------------------


@pytest.mark.gpu
def test_q1_kernel_matches_plain_on_card():
    """Q1 against its plain version at Llama-3-8B's layer shapes and the
    serving row counts up to the whole-bucket prefill (bf16, packed
    weights) and at debug-4l's (fp32), each call twice bitwise, a
    CUDA-graph replay bitwise the eager call; then q, k, v back to back
    in one graph (the programmatic dependent launches overlap) bitwise
    the three eager calls, and q / k / v in one launch against the plain
    version, twice bitwise and its replay bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: Q1 has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [("bfloat16", K, N, M) for K, N in ((4096, 4096), (4096, 1024),
                                                  (4096, 14336), (14336, 4096))
             for M in (1, 8, 64, 128, 256, 300, 2048)]
    cases += [("float32", K, N, M) for K, N in ((256, 256), (256, 512),
                                                 (512, 256))
              for M in (1, 8, 33)]

    def weight(K, N, dtype):
        wq, sc = TQ.weight_only_int8(
            torch.randn(K, N, device=dev, generator=g))
        return (Q1.pack_weight(wq) if dtype == "bfloat16" else wq), sc

    for dtype, K, N, M in cases:
        dt = getattr(torch, dtype)
        wq, sc = weight(K, N, dtype)
        x = torch.randn(M, K, device=dev, generator=g).to(dt)
        y = Q1.wo_int8_matmul(x, wq, sc)
        assert torch.equal(y, Q1.wo_int8_matmul(x, wq, sc))
        want = Q1.matmul_wo_int8_plain(x, wq, sc).float()
        err = (y.float() - want).abs()
        rowmax = want.abs().amax(1, keepdim=True)
        lim = (2 ** -7 * want.abs() + 2 ** -16 * rowmax
               if dtype == "bfloat16" else 1e-5 * rowmax)
        assert bool((err <= lim).all()), (dtype, K, N, M,
                                          float(err.max()))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = Q1.wo_int8_matmul(x, wq, sc)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, y)
    qkv = [weight(4096, N, "bfloat16") for N in (4096, 1024, 1024)]
    for M in (8, 64, 2048):
        x = torch.randn(M, 4096, device=dev, generator=g).to(torch.bfloat16)
        eager = [Q1.wo_int8_matmul(x, *w) for w in qkv]
        one = Q1.wo_int8_matmul_many(x, qkv)         # q / k / v, one launch
        assert all(map(torch.equal, one, Q1.wo_int8_matmul_many(x, qkv)))
        for y, (wq, sc) in zip(one, qkv):
            want = Q1.matmul_wo_int8_plain(x, wq, sc).float()
            lim = (2 ** -7 * want.abs()
                   + 2 ** -16 * want.abs().amax(1, keepdim=True))
            assert bool(((y.float() - want).abs() <= lim).all()), M
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [Q1.wo_int8_matmul(x, *w) for w in qkv]
            outs_one = Q1.wo_int8_matmul_many(x, qkv)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, eager)), M
        assert all(torch.equal(a, b) for a, b in zip(outs_one, one)), M
