"""The port engine's report and benchmark surface against the JAX engine:
`raw_step`, `param_bytes`, `kv_pool_bytes_per_chip`, `prefix_pool_bytes`,
`num_compiles`, the attributes `prefix_block_tokens`,
`kv_block_bytes_per_chip` and `decode_attn_bytes_per_step`, and the seven
metrics the JAX engine's registry has (`slots_total`, `slot_steps_total`,
`prefill_bucket_tokens`, `prefill_chunks_per_step`,
`decode_attn_bytes_total`, `decode_attn_roofline_util`,
`compile_events_total`).

Both engines run the `tiny` preset in fp32 with the same weights on the
CPU, so every byte count and every scheduling counter must be EQUAL.
`num_compiles` is the port's own count (CUDA graphs captured; 0 on the
CPU) and is held to its documented bound, not to the JAX number (which
also counts XLA prefill programs).  `raw_step()` must leave every
active stream unchanged, greedy and sampled, on both drivers."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import LLMEngine, LLMServer
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays

KW = dict(max_slots=3, max_len=64, max_prompt_len=32, min_bucket=8,
          prefill_chunk=16)
LENGTHS = [5, 9, 17, 26, 7, 30]
# the JAX engine's names that come with later items: the AOT cache
# (engine sub-slice (j)) and the sp ring (multi-GPU serving)
LATER = ("llm_engine_aot_cache_", "llm_engine_sp_ring_")
SEVEN = ("slots_total", "slot_steps_total", "prefill_bucket_tokens",
         "prefill_chunks_per_step", "decode_attn_bytes_total",
         "decode_attn_roofline_util", "compile_events_total")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prompts(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, L).astype(np.int32) for L in lengths]


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
    return TModel(TConfig.from_preset("tiny"), device="cpu", seed=5)


def _jax_engine(jm, **kw):
    from paddle_tpu.inference import LLMEngine as JEngine
    return JEngine(jm, **dict(KW, **kw))


@pytest.mark.parametrize("knobs", [
    {}, {"weight_dtype": "int8"}, {"kv_dtype": "int8"},
    {"prefix_cache_blocks": 4}, {"max_slots": 4, "kv_blocks": 9}])
def test_report_values_equal_jax(models, knobs):
    """Bytes of the decode state, the pool, a block and a decode step's
    attention, and the prefix geometry: equal to the JAX engine's at the
    same knobs (both on the gather path, which moves each byte twice)."""
    jm, tm = models
    je, te = _jax_engine(jm, **knobs), LLMEngine(tm, **dict(KW, **knobs))
    assert te.decode_kernel == je.decode_kernel == "gather"
    assert te.tp == je.tp == 1
    assert te.param_bytes() == je.param_bytes()
    assert te.kv_pool_bytes() == je.kv_pool_bytes()
    assert te.kv_pool_bytes_per_chip() == je.kv_pool_bytes_per_chip()
    assert te.kv_block_bytes_per_chip == je.kv_block_bytes_per_chip
    assert te.decode_attn_bytes_per_step == je.decode_attn_bytes_per_step
    assert te.prefix_pool_bytes() == je.prefix_pool_bytes() == 0
    cached = knobs.get("prefix_cache_blocks", 0) > 0
    assert hasattr(te, "prefix_block_tokens") == cached \
        == hasattr(je, "prefix_block_tokens")
    if cached:
        assert te.prefix_block_tokens == je.prefix_block_tokens == 16


def test_param_bytes_int8_is_weights_plus_scales(port_model):
    """With int8 weights a step reads each layer product's int8 data and
    its fp32 scale a column; everything else stays fp32."""
    full = LLMEngine(port_model, **KW)
    q = LLMEngine(port_model, weight_dtype="int8", **KW)
    mats = [w for st in full.state["layers"] for k, w in st.items()
            if k.startswith("w")]
    saved = sum(w.numel() * (4 - 1) - w.shape[1] * 4 for w in mats)
    assert full.param_bytes() - q.param_bytes() == saved


def test_attention_bytes_kernel_path_counts_once(port_model):
    """K4 reads the pool in place: its engine's attention bytes a step
    are half the gather path's (the JAX rule, "pallas" read as K4)."""
    g = LLMEngine(port_model, decode_kernel="gather", **KW)
    k = LLMEngine(port_model, decode_kernel="cuda", **KW)
    bmax = -(-KW["max_len"] // k.kv_block_tokens)
    assert k.decode_attn_bytes_per_step * 2 == g.decode_attn_bytes_per_step
    assert k.decode_attn_bytes_per_step == (
        KW["max_slots"] * bmax * k.kv_block_bytes_per_chip)
    assert k.kv_block_bytes_per_chip * k.kv_blocks == k.kv_pool_bytes()


def _series(eng, name):
    return eng.metrics()["llm_engine_" + name]["series"]


@pytest.mark.parametrize("knobs", [{}, {"prefill_chunk": None},
                                   {"speculation": 3}])
def test_seven_metrics_equal_jax(models, knobs):
    """The same workload through both engines: equal streams, and equal
    slot, prefill-bucket, chunk and attention-byte series (speculation's
    verify steps count slot steps but no attention bytes)."""
    jm, tm = models
    je, te = _jax_engine(jm, **knobs), LLMEngine(tm, **dict(KW, **knobs))
    ps = _prompts()
    assert te.generate(ps, 8) == je.generate(ps, 8)
    for name in SEVEN[:5]:
        assert _series(te, name) == _series(je, name), name
    assert _series(te, "decode_steps_total") == \
        _series(je, "decode_steps_total")
    steps = _series(te, "decode_steps_total")[""]["value"]
    verify = _series(te, "spec_verify_steps_total")[""]["value"]
    bytes_ = _series(te, "decode_attn_bytes_total")
    assert list(bytes_) == ["kernel=gather,kv_dtype=auto,tp=1"]
    assert list(bytes_.values())[0]["value"] == \
        (steps - verify) * te.decode_attn_bytes_per_step
    # the CPU has no card: no graph captured, no roofline rate
    assert _series(te, "compile_events_total")[""]["value"] == \
        te.num_compiles == 0
    assert list(_series(te, "decode_attn_roofline_util").values()) == \
        [{"value": 0.0}]


def test_registry_names_superset_of_jax(models):
    """Every metric of the JAX engine's registry is in the port's, with
    the same labels, but the AOT cache's and the sp ring's (later
    items); the seven keep the JAX help text but compile_events_total's,
    which says what the port counts."""
    jm, tm = models
    je, te = _jax_engine(jm), LLMEngine(tm, **KW)
    jsnap, tsnap = je.metrics(), te.metrics()
    want = {n for n in jsnap if not n.startswith(LATER)}
    assert want <= set(tsnap), sorted(want - set(tsnap))
    for name in want:
        assert jsnap[name]["type"] == tsnap[name]["type"], name
        assert list(jsnap[name]["series"]) == list(tsnap[name]["series"]), \
            name
    for short in SEVEN[:-1]:
        name = "llm_engine_" + short
        assert jsnap[name]["help"] == tsnap[name]["help"], name
    assert "CUDA graphs" in tsnap["llm_engine_compile_events_total"]["help"]


@pytest.mark.parametrize("knobs", [{}, {"decode_buckets": True},
                                   {"speculation": 3},
                                   {"prefill_chunk": None}])
def test_num_compiles_within_documented_bound(port_model, knobs):
    """num_compiles == num_graphs <= decode widths + verify widths (0 on
    the CPU, before and after serving and the boot sweep)."""
    eng = LLMEngine(port_model, **dict(KW, **knobs))
    bound = len(eng.decode_widths) + len(eng.verify_widths)
    eng.prepare_programs()
    eng.generate(_prompts(), 6)
    eng.raw_step()
    assert eng.num_compiles == eng.num_graphs == 0 <= bound
    assert _series(eng, "compile_events_total")[""]["value"] == 0


def _interleaved(eng, prompts, raw_every, sampled):
    """Greedy requests, plus two sampled ones when `sampled`; a raw
    step after every `raw_every` scheduler steps (0: never)."""
    reqs = [eng.submit(p, 10) for p in prompts]
    if sampled:
        reqs += [eng.submit(p, 10, greedy=False, temperature=0.9,
                            top_p=0.8, seed=11 + i)
                 for i, p in enumerate(prompts[:2])]
    n = raws = 0
    while eng.has_work:
        eng.step()
        n += 1
        if raw_every and n % raw_every == 0:
            eng.raw_step()
            raws += 1
    eng.flush()
    return [list(r.tokens) for r in reqs], raws


@pytest.mark.parametrize("overlap", ["off", "on"])
@pytest.mark.parametrize("knobs", [{}, {"prefix_cache_blocks": 4},
                                   {"kv_dtype": "int8"}])
def test_raw_step_leaves_streams_unchanged(port_model, overlap, knobs):
    """A stream with raw_step() calls between scheduler steps (mid
    prefill, mid decode, with free slots) equals the stream without
    them, greedy and sampled; each raw step adds one step's attention
    bytes and moves no step counter."""
    kw = dict(KW, overlap=overlap, **knobs)
    ps = _prompts()
    ref, _ = _interleaved(LLMEngine(port_model, **kw), ps, 0, True)
    eng = LLMEngine(port_model, **kw)
    got, raws = _interleaved(eng, ps, 2, True)
    assert raws > 3
    assert got == ref
    steps = _series(eng, "decode_steps_total")[""]["value"]
    assert list(_series(eng, "decode_attn_bytes_total").values())[0][
        "value"] == (steps + raws) * eng.decode_attn_bytes_per_step
    # the hook itself: one token a slot, the slots' own device
    out = eng.raw_step()
    assert tuple(out.shape) == (KW["max_slots"],)
    assert out.device.type == "cpu"


def test_server_health_reads_the_per_chip_hooks(port_model):
    """/healthz's per-chip keys come from the engine's hooks, as the JAX
    server reads them."""
    srv = LLMServer(port_model, name="report", series_interval=None,
                    watchdog_deadline=None, **KW)
    try:
        h = srv.health_snapshot()
        eng = srv.engine
        assert h["tp"] == eng.tp == 1
        assert h["kv_pool_bytes_per_chip"] == eng.kv_pool_bytes_per_chip()
        assert h["kv_block_bytes_per_chip"] == eng.kv_block_bytes_per_chip
    finally:
        srv.shutdown()
