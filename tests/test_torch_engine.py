"""The port's serving path (paddle_tpu_torch.inference): `LLMEngine` and
`LLMServer` against the JAX package's `LLMEngine`, and the port's own
engine contracts.

Port vs JAX, at the `tiny` preset in fp32 with the same weights: greedy
streams of a mixed-length batch (more requests than slots, padded tail
chunks) are token-exact for both decode paths — "gather", and "cuda",
which on CPU tensors runs the kernel's plain version.  With the int8
pool an off-by-one quantization can flip a near-tie, so the port
engine's per-step decode logits are compared instead, against the JAX
package's programs replayed on the port engine's exact schedule (same
chunks, tables, tokens and depths): within 5e-2, the int8 bound of
tests/test_torch_llama_decode.py.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import default_device, seed
from paddle_tpu_torch.inference import (LLMEngine, LLMServer, QueueFull,
                                        DeadlineExceeded)
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import llama_decode as TD
from paddle_tpu_torch.models import load_reference_arrays

ENGINE_KW = dict(max_slots=3, max_len=64, max_prompt_len=32, min_bucket=8,
                 prefill_chunk=16)
LENGTHS = [5, 9, 17, 26, 7, 30]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lengths]


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
    return TModel(TConfig.from_preset("tiny"), device="cpu", seed=3)


def _stream(eng, prompts, max_new=8, **kw):
    reqs = [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    eng.run()
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def jax_greedy(models):
    from paddle_tpu.inference import LLMEngine as JEngine
    return _stream(JEngine(models[0], **ENGINE_KW), _prompts(LENGTHS))


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
def test_greedy_streams_token_exact_vs_jax(models, jax_greedy, kernel):
    eng = LLMEngine(models[1], decode_kernel=kernel, **ENGINE_KW)
    assert eng.decode_kernel == kernel
    assert _stream(eng, _prompts(LENGTHS)) == jax_greedy


def test_int8_pool_step_logits_vs_jax_replay(models, monkeypatch):
    import jax.numpy as jnp
    from paddle_tpu.models import llama_decode as JD
    jm, tm = models
    calls = []
    eng = LLMEngine(tm, kv_dtype="int8", **ENGINE_KW)
    prefill, decode = TD.paged_prefill_chunk, TD.paged_decode_step_batch

    def rec_prefill(state, cfg, ids, off, table_row, pool):
        calls.append(("prefill", ids.numpy().copy(), int(off),
                      table_row.numpy().copy()))
        return prefill(state, cfg, ids, off, table_row, pool)

    def rec_decode(state, cfg, token, pos, pool, table, kernel="gather"):
        logits, pool = decode(state, cfg, token, pos, pool, table, kernel)
        live = [s is not None for s in eng._slots]
        calls.append(("decode", token.numpy().copy(), pos.numpy().copy(),
                      table.numpy().copy(), logits.numpy().copy(), live))
        return logits, pool

    monkeypatch.setattr(TD, "paged_prefill_chunk", rec_prefill)
    monkeypatch.setattr(TD, "paged_decode_step_batch", rec_decode)
    _stream(eng, _prompts(LENGTHS, seed=1))
    monkeypatch.undo()

    jstate = JD.collect_decode_state(jm)
    jpool = JD.init_paged_cache(jm.config, eng.kv_blocks,
                                eng.kv_block_tokens, jnp.float32,
                                kv_dtype="int8")
    n_steps, worst = 0, 0.0
    for c in calls:
        if c[0] == "prefill":
            _, jpool = JD.paged_prefill_chunk(
                jstate, jm.config, jnp.asarray(c[1]), c[2],
                jnp.asarray(c[3]), jpool)
            continue
        _, tok, pos, table, logits, live = c
        jl, jpool = JD.paged_decode_step_batch(
            jstate, jm.config, jnp.asarray(tok), jnp.asarray(pos), jpool,
            jnp.asarray(table))
        err = np.abs(np.asarray(jl)[live] - logits[live]).max()
        worst = max(worst, float(err))
        n_steps += 1
    assert n_steps >= 8
    assert worst <= 5e-2, worst


def test_sampled_stream_depends_only_on_own_seed(port_model):
    """A sampled request's tokens are the same solo and co-batched with
    other sampled requests (each request owns its generator)."""
    p = _prompts([11], seed=3)[0]
    kw = dict(greedy=False, temperature=0.8, top_p=0.9, seed=42)
    solo = LLMEngine(port_model, **ENGINE_KW)
    r = solo.submit(p, 10, **kw)
    solo.run()
    mixed = LLMEngine(port_model, **ENGINE_KW)
    for i, q in enumerate(_prompts([6, 19], seed=4)):
        mixed.submit(q, 10, greedy=False, seed=100 + i)
    r2 = mixed.submit(p, 10, **kw)
    mixed.run()
    assert r.tokens == r2.tokens and len(r.tokens) == 10
    other = LLMEngine(port_model, **ENGINE_KW)
    r3 = other.submit(p, 10, **dict(kw, seed=43))
    other.run()
    assert r3.tokens != r.tokens


def test_eos_cancel_deadline_and_queue_bound(port_model):
    eng = LLMEngine(port_model, max_queue=4, **ENGINE_KW)
    probe = _stream(eng, _prompts([9], seed=5), max_new=8)[0]
    eos = probe[2]
    r_eos = eng.submit(_prompts([9], seed=5)[0], 8, eos_token_id=eos)
    r_cancel = eng.submit(_prompts([12], seed=6)[0], 20)
    r_late = eng.submit(_prompts([7], seed=7)[0], 20, deadline=1e-3)
    r_ok = eng.submit(_prompts([7], seed=8)[0], 4)
    with pytest.raises(QueueFull):
        eng.submit([1, 2], 2)
    eng.step()
    r_cancel.cancel()
    eng.run()
    assert r_eos.tokens == probe[:3] and r_eos.done
    assert r_cancel.done and len(r_cancel.tokens) < 20
    assert isinstance(r_late.error, DeadlineExceeded)
    assert len(r_ok.tokens) == 4
    assert eng.num_active == 0 and eng._pager.used_blocks == 0
    eng._pager.check()
    m = eng.metrics()

    def solo(name):
        return m["llm_engine_" + name]["series"][""]

    assert solo("requests_rejected_total")["value"] == 1
    assert solo("ttft_seconds")["count"] >= 3
    assert solo("itl_seconds")["count"] > 0
    assert solo("generated_tokens_total")["value"] > 0


@pytest.mark.parametrize("knob,value", [
    ("hot_window", 2), ("prefetch_depth", 4),
    ("mesh", "dp"), ("tp", 2), ("sp", 2),
    ("aot_cache", "cache"), ("fabric", "kvdir")])
def test_unported_knobs_raise(port_model, knob, value, tmp_path,
                              monkeypatch):
    """The JAX knobs the port lacks raise naming their ROADMAP item;
    the tiered-KV pair (engine sub-slice (g)) is ported: `hot_window`
    builds a tiered engine, `prefetch_depth` is taken as given; so is
    the KV fabric (engine sub-slice (h)): a path is the disk tier's
    root, as in the JAX engine."""
    if knob == "fabric":
        monkeypatch.chdir(tmp_path)
        eng = LLMEngine(port_model, **dict(ENGINE_KW, **{knob: value}))
        assert eng._fabric_cfg == {"disk_root": value}
        assert eng._disk is not None and (tmp_path / value).is_dir()
        assert eng._persist_prefixes and eng._persist_sessions
        return
    if knob in ("hot_window", "prefetch_depth"):
        eng = LLMEngine(port_model, **dict(ENGINE_KW, **{knob: value}))
        assert getattr(eng, knob) == value
        assert eng._tiered == (knob == "hot_window")
        assert (eng._hext is not None) == eng._tiered
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMEngine(port_model, **dict(ENGINE_KW, **{knob: value}))


def test_request_tier_raises(port_model):
    """An unknown SLO tier raises at submit and nothing is queued; the
    known tiers are admitted highest tier first, FIFO within a tier."""
    eng = LLMEngine(port_model, **dict(ENGINE_KW, max_slots=1))
    with pytest.raises(ValueError, match="SLO tier"):
        eng.submit([1, 2, 3], 2, tier="gold")
    assert len(eng._queue) == 0
    ps = _prompts([5, 6, 7, 8, 9], seed=4)
    tiers = ["batch", "standard", "interactive", "batch", "interactive"]
    reqs = [eng.submit(p, 2, tier=t) for p, t in zip(ps, tiers)]
    order = []
    while eng.has_work:
        eng.step()
        for r in reqs:
            if r not in order and (r in eng._slots or r.done):
                order.append(r)
    assert [reqs.index(r) for r in order] == [2, 4, 1, 0, 3]


def test_unknown_knob_and_server_knobs(port_model):
    with pytest.raises(TypeError):
        LLMEngine(port_model, decode_kernal="cuda", **ENGINE_KW)
    with pytest.raises(ValueError, match="pool_role"):
        LLMServer(port_model, pool_role="prefil", **ENGINE_KW)
    srv = LLMServer(port_model, pool_role="prefill", **ENGINE_KW)
    try:
        assert srv.health_snapshot()["pool_role"] == "prefill"
    finally:
        srv.shutdown()


def test_server_returns_engine_tokens(port_model):
    prompts = _prompts([5, 17, 23], seed=9)
    ref = _stream(LLMEngine(port_model, **ENGINE_KW), prompts, max_new=6)
    srv = LLMServer(port_model, **ENGINE_KW)
    try:
        reqs = [srv.submit(p, 6) for p in prompts]
        got = [srv.result(r, timeout=60) for r in reqs]
    finally:
        srv.shutdown(drain=True)
    assert got == ref
    assert not srv._thread.is_alive()
    with pytest.raises(RuntimeError):
        srv.submit(prompts[0], 2)


def test_default_device_is_the_card():
    """Entry points default to the CUDA card and raise without one —
    never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TModel(TConfig.from_preset("tiny"))
    g = seed(5, device="cpu")
    assert torch.rand(1, generator=g).item() == \
        torch.rand(1, generator=seed(5, device="cpu")).item()
