"""The port's engine sub-slice (f): the overlap driver (`overlap`), the
occupancy-bucketed decode widths (`decode_buckets`), K4's split size
(`decode_block_tile`), the whole-bucket prefill (`prefill_chunk=None`)
and the boot-time sweep (`prepare_programs`), against the JAX package's
`LLMEngine` at the same knobs and against the port's own contracts.

At the `tiny` preset in fp32 with the same weights, the port's greedy
streams of a mixed-length batch (more requests than slots) are
token-exact with the JAX engine's for every knob combination below.
Within the port, sampled streams with overlap on are bitwise those with
overlap off (a slot's draw depends only on its own generator, token,
depth and KV).  The CUDA graphs themselves exist only on the card:
`test_graph_logits_equal_eager_on_card` holds a replay's logits to the
eager step's there, bitwise, and skips on the CPU.
"""

import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (DeadlineExceeded, EngineUnhealthy,
                                        LLMEngine, LLMServer)
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays

ENGINE_KW = dict(max_slots=3, max_len=64, max_prompt_len=32, min_bucket=8)
LENGTHS = [5, 9, 17, 26, 7, 30]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
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


# (overlap, decode_buckets, prefill_chunk, decode_block_tile): every value
# of each knob appears, on and off the others; tiles 1 and 4 are splits
# of 16 and 64 rows at 16-row blocks
KNOBS = [("off", False, 16, None), ("on", False, 16, 1),
         ("on", True, None, 4), ("off", True, 16, 4),
         ("on", True, 16, None), ("off", False, None, 1)]


@pytest.mark.parametrize("overlap,buckets,chunk,tile", KNOBS)
def test_greedy_streams_token_exact_vs_jax(models, overlap, buckets, chunk,
                                           tile):
    from paddle_tpu.inference import LLMEngine as JEngine
    kw = dict(ENGINE_KW, overlap=overlap, decode_buckets=buckets,
              prefill_chunk=chunk, decode_block_tile=tile)
    want = _stream(JEngine(models[0], **kw), _prompts(LENGTHS))
    eng = LLMEngine(models[1], decode_kernel="cuda", **kw)
    assert eng.overlap == (overlap == "on")
    assert eng.decode_widths == ((1, 2, 3) if buckets else (3,))
    assert _stream(eng, _prompts(LENGTHS)) == want
    assert eng.num_graphs == 0          # the CPU runs the eager step


@pytest.mark.parametrize("buckets,chunk", [(False, 16), (True, 16),
                                           (True, None)])
def test_sampled_streams_overlap_on_equal_off(port_model, buckets, chunk):
    """Sampled and greedy requests co-batched, each sampled one with its
    own seed, temperature and top-p: bitwise the same streams with the
    overlap driver as with the synchronous one."""
    def streams(overlap):
        eng = LLMEngine(port_model, overlap=overlap, decode_buckets=buckets,
                        prefill_chunk=chunk, **ENGINE_KW)
        reqs = [eng.submit(p, 10, greedy=i % 3 == 2, temperature=0.7 + 0.1 * i,
                           top_p=0.9, seed=40 + i)
                for i, p in enumerate(_prompts(LENGTHS, seed=1))]
        eng.run()
        return [list(r.tokens) for r in reqs]

    off = streams("off")
    assert all(len(s) == 10 for s in off)
    assert streams("on") == off
    assert streams(True) == off


def _overlap_engine(model, **kw):
    return LLMEngine(model, overlap="on", prefill_chunk=16,
                     **dict(ENGINE_KW, **kw))


def test_eos_resolves_at_the_deferred_commit(port_model):
    p = _prompts([9], seed=5)[0]
    probe = _stream(LLMEngine(port_model, prefill_chunk=16, **ENGINE_KW),
                    [p], max_new=8)[0]
    seen = {}
    for overlap in ("off", "on"):
        eng = LLMEngine(port_model, overlap=overlap, prefill_chunk=16,
                        **ENGINE_KW)
        r = eng.submit(p, 8, eos_token_id=probe[2])
        seen[overlap] = []
        while eng.has_work:
            eng.step()
            seen[overlap].append(len(r.tokens))
        assert r.tokens == probe[:3] and r.done
        assert eng._pager.used_blocks == 0 and eng.num_active == 0
    # the first token comes from prefill; the synchronous driver commits
    # each decode token in the step() that dispatched it, the overlap
    # driver one step() later — and EOS stops both at the same token
    assert seen == {"off": [2, 3], "on": [1, 2, 3]}


def test_cancel_and_deadline_inside_the_window(port_model):
    """A request cancelled (or expired) while its slot's step is in
    flight keeps that step's token — the commit comes first — and is
    evicted at that boundary; co-batched requests are untouched."""
    ps = _prompts([9, 12, 7], seed=6)
    full = _stream(LLMEngine(port_model, prefill_chunk=16, **ENGINE_KW), ps,
                   max_new=12)
    eng = _overlap_engine(port_model)
    r_cancel = eng.submit(ps[0], 12)
    r_late = eng.submit(ps[1], 12, deadline=30.0)
    r_ok = eng.submit(ps[2], 12)
    while len(r_cancel.tokens) < 3 or len(r_late.tokens) < 3:
        eng.step()
    assert eng._inflight is not None
    n_cancel, n_late = len(r_cancel.tokens), len(r_late.tokens)
    r_cancel.cancel()
    r_late._deadline_t = time.monotonic() - 1.0
    eng.step()
    assert r_cancel.done and r_cancel.error is None
    assert isinstance(r_late.error, DeadlineExceeded)
    assert len(r_cancel.tokens) == n_cancel + 1
    assert len(r_late.tokens) == n_late + 1
    eng.run()
    assert r_cancel.tokens == full[0][:n_cancel + 1]
    assert r_late.tokens == full[1][:n_late + 1]
    assert r_ok.tokens == full[2]
    assert eng._pager.used_blocks == 0
    eng._pager.check()
    m = eng.metrics()
    assert m["llm_engine_requests_cancelled_total"]["series"][""][
        "value"] == 1
    assert m["llm_engine_requests_expired_total"]["series"][""][
        "value"] == 1


def test_flush_commits_the_step_in_flight(port_model):
    eng = _overlap_engine(port_model)
    r = eng.submit(_prompts([9], seed=7)[0], 6)
    eng.step()                            # prefill, first token, dispatch
    assert len(r.tokens) == 1 and eng._inflight is not None
    eng.flush()
    assert len(r.tokens) == 2 and eng._inflight is None
    eng.flush()                           # idempotent
    assert len(r.tokens) == 2
    sync = LLMEngine(port_model, prefill_chunk=16, **ENGINE_KW)
    sync.flush()                          # a no-op on the synchronous driver
    assert not sync.has_work
    eng.run()
    assert r.done and len(r.tokens) == 6


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_host_gap_and_first_token_waits_are_observed(port_model, overlap):
    eng = LLMEngine(port_model, overlap=overlap, prefill_chunk=16,
                    **ENGINE_KW)
    _stream(eng, _prompts(LENGTHS, seed=8))
    m = eng.metrics()

    def solo(name):
        return m["llm_engine_" + name]["series"][""]

    steps = solo("decode_steps_total")["value"]
    gaps = solo("host_gap_seconds")
    assert 0 < gaps["count"] < steps and gaps["sum"] >= 0
    assert solo("host_gap_last_seconds")["value"] >= 0
    waits = solo("first_token_waits_total")["value"]
    # requests admitted while a step is in flight read their first token
    # behind it: never on the synchronous driver
    assert (waits > 0) if overlap == "on" else (waits == 0)


def test_prepare_programs_refuses_work_in_flight(port_model):
    ref = _stream(LLMEngine(port_model, prefill_chunk=16, **ENGINE_KW),
                  _prompts(LENGTHS, seed=9))
    eng = _overlap_engine(port_model, decode_buckets=True)
    # the sweep writes only the trash block: the streams after it are
    # the streams without it
    assert eng.prepare_programs() == {"decode": 3, "chunk": 2}
    reqs = [eng.submit(p, 8) for p in _prompts(LENGTHS, seed=9)]
    eng.step()
    assert eng._inflight is not None
    with pytest.raises(RuntimeError, match="boot-time"):
        eng.prepare_programs()
    eng.run()
    assert [list(r.tokens) for r in reqs] == ref
    whole = LLMEngine(port_model, prefill_chunk=None, **ENGINE_KW)
    assert whole.prepare_programs() == {"decode": 1, "prefill": 3}


def test_knob_validation(port_model):
    eng = LLMEngine(port_model, prefill_chunk=16, **ENGINE_KW)
    assert eng.overlap_mode == "off" and eng.decode_widths == (3,)
    assert LLMEngine(port_model, max_slots=6, max_len=64,
                     decode_buckets=True).decode_widths == (1, 2, 4, 6)
    for bad in [dict(overlap="sometimes"), dict(decode_block_tile=3),
                dict(decode_block_tile=32), dict(decode_block_tile=0),
                dict(prefill_chunk=None, kv_dtype="int8"),
                dict(prefill_chunk=None, step_token_budget=8)]:
        with pytest.raises(ValueError):
            LLMEngine(port_model, **dict(ENGINE_KW, **bad))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMEngine(port_model, aot_cache="cache", **ENGINE_KW)


def test_server_flushes_and_drops_a_dead_step(port_model):
    prompts = _prompts([5, 17, 23], seed=10)
    ref = _stream(LLMEngine(port_model, prefill_chunk=16, **ENGINE_KW),
                  prompts, max_new=6)
    srv = LLMServer(port_model, overlap="on", prefill_chunk=16, **ENGINE_KW)
    try:
        got = [srv.result(srv.submit(p, 6), timeout=60) for p in prompts]
    finally:
        srv.shutdown(drain=True)
    assert got == ref and srv.engine._inflight is None
    assert not srv._thread.is_alive()

    srv = LLMServer(port_model, overlap="on", prefill_chunk=16, **ENGINE_KW)
    eng = srv.engine
    dispatch, calls = eng._dispatch_decode, []

    def failing():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected")
        return dispatch()

    eng._dispatch_decode = failing
    try:
        reqs = [srv.submit(p, 6) for p in prompts]
        for r in reqs:
            with pytest.raises(EngineUnhealthy):
                srv.result(r, timeout=60)
    finally:
        srv.shutdown()
    assert eng._inflight is None
    assert all(r.done and len(r.tokens) < 6 for r in reqs)


@pytest.mark.gpu
def test_graph_logits_equal_eager_on_card():
    """On the card: `prepare_programs` captures one graph per decode
    width and no more; each width's replay gives bitwise the eager
    step's logits on the same inputs; overlap on and off give the same
    greedy and sampled streams, with and without decode buckets, and
    the buckets the same greedy streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TModel(TConfig.from_preset("debug-4l"), device="cuda", seed=1)
    kw = dict(max_slots=4, max_len=256, prefill_chunk=32,
              decode_buckets=True)
    eng = LLMEngine(model, overlap="off", **kw)
    assert eng.num_graphs == 0
    assert eng.prepare_programs()["decode"] == len(eng.decode_widths) == 3
    assert eng.num_graphs == 3
    for p in _prompts([5, 17, 33, 64], seed=2, vocab=1024):
        eng.submit(p, 40)
    while eng.num_prefilling or eng._queue:
        eng.step()
    g = eng._graphs
    for _ in range(3):
        eng._ensure_decode_capacity()
        for w in eng.decode_widths:
            host = np.concatenate([eng._token[:w], eng._pos[:w],
                                   eng._pager.table[:w].reshape(-1)])
            flat = g.inputs(w)
            flat.copy_(torch.from_numpy(host))
            eager = eng._decode_logits(*(v.clone() for v in
                                         g.views(flat, w))).clone()
            logits, argmax = g.replay(w)
            torch.cuda.synchronize()
            assert torch.equal(logits, eager), w
            assert torch.equal(argmax, eager.float().argmax(-1)), w
        eng.step()
    assert eng.num_graphs == 3
    streams = {}
    for overlap in ("on", "off"):
        for buckets in (True, False):
            e = LLMEngine(model, overlap=overlap,
                          **dict(kw, decode_buckets=buckets))
            ps = _prompts([5, 17, 33, 64, 100, 7], seed=3, vocab=1024)
            reqs = [e.submit(p, 16, greedy=i % 2 == 0, temperature=0.8,
                             top_p=0.9, seed=i) for i, p in enumerate(ps)]
            e.run()
            streams[overlap, buckets] = [list(r.tokens) for r in reqs]
            assert e.num_graphs <= len(e.decode_widths)
            assert e.num_graph_replays == e.metrics()[
                "llm_engine_decode_steps_total"]["series"][""]["value"]
    # sampled rows are drawn after each replay (pad rows never): overlap
    # on and off give the same streams at each setting; across widths
    # cuBLAS may sum in another order, so only the greedy ones are held
    for buckets in (True, False):
        assert streams["on", buckets] == streams["off", buckets]
    assert streams["on", True][::2] == streams["on", False][::2]
