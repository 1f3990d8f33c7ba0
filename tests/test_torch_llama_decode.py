"""The port's paged decode programs (paddle_tpu_torch/models/llama_decode.py)
against the JAX package's: the same weights (carried across by name with
`load_reference_arrays`), the same block tables and the same tokens,
through `paged_prefill_chunk` (padded tail chunks included) and then
several `paged_decode_step_batch` steps with an idle all-trash slot.

Tolerances: fp32 hidden states and logits within atol 1e-4 (the two
frameworks order their fp32 sums differently); bf16 logits within 5e-2
(bf16 rounding of rope, norms and probabilities at other places in XLA
and PyTorch).  Int8 KV: the same expressions quantize slightly
different fp32 inputs, so a row may round one step apart (see
`test_int8_kv_rows_and_logits`); one such step moves a logit by ~1e-3,
so int8 logits are held to the bf16 bound, 5e-2."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import llama_decode as TD
from paddle_tpu_torch.models import load_reference_arrays

BT, BMAX = 8, 6
LENGTHS = [5, 13, 20]           # three live slots; slot 3 stays idle


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _models(preset, dtype, seed):
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(seed)
    jm = LlamaForCausalLM(LlamaConfig.from_preset(preset, dtype=dtype))
    tm = TModel(TConfig.from_preset(preset, dtype=dtype), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _tables(seed):
    """Distinct blocks per live slot (slot 2 with a trash tail), slot 3
    all trash."""
    rng = np.random.default_rng(seed)
    B = len(LENGTHS) + 1
    n_blocks = 1 + B * BMAX
    table = np.zeros((B, BMAX), np.int32)
    blocks = rng.permutation(np.arange(1, n_blocks))
    k = 0
    for b in range(len(LENGTHS)):
        n = BMAX - (1 if b == 2 else 0)
        table[b, :n] = blocks[k:k + n]
        k += n
    return table, n_blocks


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _run(preset, dtype, kv_dtype, seed=0, steps=3):
    """Prefill every live slot in width-8 chunks, then `steps` decode
    steps fed the JAX side's greedy tokens.  Returns per-phase
    (jax, port) pairs: chunk hidden states, decode logits, pools."""
    import jax.numpy as jnp
    from paddle_tpu.models import llama_decode as JD

    jm, tm = _models(preset, dtype, seed)
    cfg = jm.config
    table, n_blocks = _tables(seed)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in LENGTHS]
    jstate = JD.collect_decode_state(jm)
    tstate = TD.collect_decode_state(tm)
    jpool = JD.init_paged_cache(cfg, n_blocks, BT, jstate["embed"].dtype,
                                kv_dtype=kv_dtype)
    tpool = TD.init_paged_cache(tm.config, n_blocks, BT,
                                tstate["embed"].dtype, kv_dtype=kv_dtype,
                                device="cpu")
    hidden, logits = [], []
    for b, p in enumerate(prompts):
        for off in range(0, p.size, 8):
            ids = np.zeros((1, 8), np.int32)
            seg = p[off:off + 8]
            ids[0, :seg.size] = seg
            jx, jpool = JD.paged_prefill_chunk(
                jstate, cfg, jnp.asarray(ids), off, jnp.asarray(table[b]),
                jpool)
            tx, _ = TD.paged_prefill_chunk(
                tstate, tm.config, torch.from_numpy(ids), off,
                torch.from_numpy(table[b]), tpool)
            n = seg.size
            hidden.append((_f32(jx[:, :n].astype(jnp.float32)),
                           _f32(tx[:, :n])))
    pos = np.asarray(LENGTHS + [0], np.int32)
    tok = np.zeros(len(pos), np.int32)
    tok[:len(LENGTHS)] = [p[-1] for p in prompts]
    for _ in range(steps):
        jl, jpool = JD.paged_decode_step_batch(
            jstate, cfg, jnp.asarray(tok), jnp.asarray(pos), jpool,
            jnp.asarray(table))
        tl, _ = TD.paged_decode_step_batch(
            tstate, tm.config, torch.from_numpy(tok), torch.from_numpy(pos),
            tpool, torch.from_numpy(table))
        jl = _f32(jl.astype(jnp.float32))
        logits.append((jl, _f32(tl)))
        tok = jl.argmax(-1).astype(np.int32)
        pos = pos + np.asarray([1] * len(LENGTHS) + [0], np.int32)
    return hidden, logits, (jpool, tpool), table, pos


def _max_err(pairs, live=slice(0, len(LENGTHS))):
    return max(np.abs(a[live] - b[live]).max() for a, b in pairs)


@pytest.mark.parametrize("preset", ["tiny", "debug-4l"])
def test_prefill_then_decode_fp32(preset):
    hidden, logits, _, _, _ = _run(preset, "float32", None)
    assert max(np.abs(a - b).max() for a, b in hidden) <= 1e-4
    assert _max_err(logits) <= 1e-4


@pytest.mark.parametrize("preset", ["tiny", "debug-4l"])
def test_prefill_then_decode_bf16(preset):
    hidden, logits, _, _, _ = _run(preset, "bfloat16", None, seed=2)
    assert _max_err(logits) <= 5e-2


@pytest.mark.parametrize("preset", ["tiny", "debug-4l"])
def test_int8_kv_rows_and_logits(preset):
    """Int8 pool.  Layer 0 quantizes fp32 rows that differ between the
    packages only by rounding: its int8 rows may differ by one step in
    at most 1e-4 of the elements, its scales within rtol 1e-5.  Such a
    step changes that layer's output by ~1e-3, so deeper layers see
    inputs ~1e-3 apart: their rows stay within one step and their
    scales within rtol 1e-2.  Logits within 5e-2."""
    _, logits, (jpool, tpool), table, pos = _run(preset, "float32",
                                                 "int8", seed=4)
    assert _max_err(logits) <= 5e-2
    for layer, ((jk, jv), (tk, tv)) in enumerate(zip(jpool, tpool)):
        n_diff = n_all = 0
        for je, te in ((jk, tk), (jv, tv)):
            for b in range(len(LENGTHS)):
                rows = np.arange(int(pos[b]))
                blk, col = table[b, rows // BT], rows % BT
                jd = np.asarray(je[0])[blk, col].astype(np.int32)
                td = te[0].numpy()[blk, col].astype(np.int32)
                assert np.abs(jd - td).max() <= 1
                n_diff += int((jd != td).sum())
                n_all += jd.size
                np.testing.assert_allclose(
                    te[1].numpy()[blk, col], np.asarray(je[1])[blk, col],
                    rtol=1e-5 if layer == 0 else 1e-2)
        if layer == 0:
            assert n_diff <= max(1e-4 * n_all, 1), (n_diff, n_all)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_write_rows_matches_jax(kv_dtype):
    """`paged_write_rows` writes one slot's rows through its table row
    (rows past the table into the trash block) exactly as the JAX
    package does; `pool_is_quant` tells the pool kinds apart."""
    import jax.numpy as jnp
    from paddle_tpu.models import llama_decode as JD
    cfg = TConfig.from_preset("tiny")
    rng = np.random.default_rng(11)
    k = rng.normal(size=(12, 2, 16)).astype(np.float32)
    v = rng.normal(size=(12, 2, 16)).astype(np.float32)
    trow = np.asarray([4, 2], np.int32)
    rows = np.arange(6, 18, dtype=np.int32)          # 16.. past the table
    jpool = JD.init_paged_cache(cfg, 6, 8, jnp.float32, kv_dtype=kv_dtype)
    tpool = TD.init_paged_cache(cfg, 6, 8, torch.float32,
                                kv_dtype=kv_dtype, device="cpu")
    assert TD.pool_is_quant(tpool) == JD.pool_is_quant(jpool) \
        == (kv_dtype == "int8")
    jk, jv = JD.paged_write_rows(*jpool[0], jnp.asarray(trow),
                                 jnp.asarray(rows), jnp.asarray(k),
                                 jnp.asarray(v))
    tk, tv = TD.paged_write_rows(*tpool[0], torch.from_numpy(trow),
                                 torch.from_numpy(rows), torch.from_numpy(k),
                                 torch.from_numpy(v))
    for je, te in ((jk, tk), (jv, tv)):
        jparts = je if isinstance(je, tuple) else (je,)
        tparts = te if isinstance(te, tuple) else (te,)
        for ja, ta in zip(jparts, tparts):
            # the table's blocks; colliding trash writes land in any order
            live = [2, 4]
            np.testing.assert_array_equal(ta.numpy()[live],
                                          np.asarray(ja)[live])


def test_trash_guard_routes_out_of_table_rows():
    """`_paged_rows`: rows past the table (a padded tail chunk) and
    negative rows resolve to the trash block, never a clamped live
    block; in-table rows map through the table."""
    table = torch.tensor([[3, 5, 7]], dtype=torch.int32)
    rows = torch.tensor([[0, 7, 8, 23, 24, 40, -1]])
    blk, col = TD._paged_rows(table, rows, 8)
    assert blk.tolist() == [[3, 3, 5, 7, 0, 0, 0]]
    assert col.tolist() == [[0, 7, 0, 7, 0, 0, 7]]
