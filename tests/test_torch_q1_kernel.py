"""Kernel Q1's bf16 design (csrc/wo_int8_matmul.cu) held on the CPU to
what the kernel assumes: the packed weight layout (fragment order), the
int8 -> bf16 conversion by integer and bit operations, and the split
planner; the packed decode state against the JAX package's int8 data.
The kernel itself runs only on the card
(tests/test_torch_int8_weights.py::test_q1_kernel_matches_plain_on_card).

Tolerances: none; every check here is bitwise or exact (permutations,
an exact conversion, integer plans, the plain product on the same
bytes).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import llama_decode as TD
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.ops import wo_int8_matmul as Q1
from paddle_tpu_torch.quantization import int8 as TQ

SHAPES = [(64, 64), (64, 32), (128, 192), (256, 100), (4096, 1024)]


def _int8(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


# -- the packed layout -------------------------------------------------


@pytest.mark.parametrize("K,N", SHAPES)
def test_pack_unpack_bitwise(K, N):
    w = _int8((K, N), K + N)
    p = Q1.pack_weight(w)
    assert p.dtype == torch.int8 and Q1.is_packed(p)
    assert tuple(p.shape) == (-(-N // 64), K // 32, 128, 16)
    assert torch.equal(Q1.unpack_weight(p, N), w)
    # an exact permutation: the same multiset of bytes, padding zero
    pad = p.numel() - w.numel()
    assert torch.equal(torch.sort(p.flatten())[0],
                       torch.sort(torch.cat([w.flatten(), torch.zeros(
                           pad, dtype=torch.int8)]))[0])


def test_pack_rejects_what_the_kernel_cannot_read():
    with pytest.raises(ValueError, match="multiple of 64"):
        Q1.pack_weight(_int8((96, 64), 0))
    with pytest.raises(ValueError, match="int8"):
        Q1.pack_weight(torch.zeros(64, 64))


def _bf16_pair(word, half):
    """The bf16 value in half 0 (low) or 1 (high) of a 32-bit word."""
    bits = (int(word) >> (16 * half)) & 0xFFFF
    return float(np.array([bits << 16], np.uint32).view(np.float32)[0])


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7
    of the 8 bytes (y:x)."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
           [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _f32(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


def _bits(f):
    return int(np.array([f], np.float32).view(np.uint32)[0])


def _cvt4(q):
    """The kernel's cvt4 on a 32-bit word of 4 int8 weights: (lo, hi)
    bf16x2 words, each subtraction in fp32 as the card does it."""
    u = q ^ 0x80808080
    f = [_f32(_byte_perm(u, 0x4B000000, s)) - np.float32(8388736.0)
         for s in (0x7650, 0x7652, 0x7651, 0x7653)]
    return (_byte_perm(_bits(f[0]), _bits(f[1]), 0x7632),
            _byte_perm(_bits(f[2]), _bits(f[3]), 0x7632))


def test_int8_to_bf16_conversion_exact():
    """u = q ^ 0x80, 0x4B0000uu - (2^23 + 128) = q exactly, and its high
    half is q in bf16 exactly (the low half is zero), for every byte."""
    for q in range(-128, 128):
        u = (q & 0xFF) ^ 0x80
        f = _f32(0x4B000000 | u) - np.float32(8388736.0)
        assert f == q and _bits(f) & 0xFFFF == 0
        b = q & 0xFF
        lo, hi = _cvt4(b | (b << 8) | (b << 16) | (b << 24))
        assert _bf16_pair(lo, 0) == _bf16_pair(lo, 1) == q
        assert _bf16_pair(hi, 0) == _bf16_pair(hi, 1) == q


def test_packed_bytes_are_the_fragments_each_thread_needs():
    """For every 64 channels x 32 k, thread j's 16 bytes, converted as the
    kernel converts them, fill exactly its A registers of the two k16
    steps: mma's A fragment (a0: row g, k 2t / 2t + 1; a1: row g + 8;
    a2: row g, k 2t + 8 / 2t + 9; a3: row g + 8), warp w owning rows
    16 w .. 16 w + 15, the rows being the weight's output channels."""
    K, N = 64, 128
    w = _int8((K, N), 7)
    p = Q1.pack_weight(w).numpy().view(np.uint8)
    for T in range(N // 64):
        for c in range(K // 32):
            got = np.full((64, 32), np.nan)          # (channel, k)
            for j in range(128):
                wp, lane = divmod(j, 32)
                g, t = divmod(lane, 4)
                words = p[T, c, j].view(np.uint32)
                for h in range(2):                   # k16 step
                    a = []
                    for pw in range(2):
                        lo, hi = _cvt4(int(words[2 * h + pw]))
                        a += [lo, hi]
                    for r, (row, k) in enumerate(
                            ((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                             (g + 8, 2 * t + 8))):
                        for e in range(2):
                            got[16 * wp + row, 16 * h + k + e] = \
                                _bf16_pair(a[r], e)
            want = w[32 * c:32 * c + 32, 64 * T:64 * T + 64].T.numpy()
            np.testing.assert_array_equal(got, want.astype(np.float64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_on_packed_bitwise_the_plain_on_in_out(dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    for K, N in SHAPES[:4]:
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
        wq, sc = TQ.weight_only_int8(w)
        x = torch.from_numpy(
            rng.standard_normal((2, 3, K)).astype(np.float32)).to(dt)
        want = TQ.matmul_wo_int8(x, wq, sc)
        got = TQ.matmul_wo_int8(x, Q1.pack_weight(wq), sc)
        assert got.dtype == dt and got.shape == (2, 3, N)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_x_products_equal_separate_products(dtype):
    """`matmul_wo_int8_many` (q / k / v in one launch on the card) is, on
    the CPU, each product exactly as `matmul_wo_int8` computes it, for
    packed and `[in, out]` weights alike."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(6)
    pairs = [TQ.weight_only_int8(torch.from_numpy(
        rng.standard_normal((128, n)).astype(np.float32)))
        for n in (128, 64, 32)]
    x = torch.from_numpy(rng.standard_normal((2, 5, 128))
                         .astype(np.float32)).to(dt)
    want = [TQ.matmul_wo_int8(x, wq, sc) for wq, sc in pairs]
    for ws in (pairs, [(Q1.pack_weight(wq), sc) for wq, sc in pairs]):
        got = TQ.matmul_wo_int8_many(x, ws)
        assert [g.shape for g in got] == [(2, 5, 128), (2, 5, 64),
                                           (2, 5, 32)]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert TD._mm_shared(x, *pairs)[2].shape == (2, 5, 32)
    plain = [wq.to(dt) for wq, _ in pairs]       # float weights: `@` each
    assert all(torch.equal(g, x @ w)
               for g, w in zip(TD._mm_shared(x, *plain), plain))


def test_card_wrapper_takes_only_the_layout_its_kernel_reads():
    """On the card bf16 x needs the packed weight and fp32 x the [in,
    out] one: the wrapper raises instead of running another path."""
    wq, sc = TQ.weight_only_int8(torch.randn(128, 64))
    with pytest.raises(ValueError, match="packed weight"):
        Q1._check(torch.zeros(4, 128, dtype=torch.bfloat16), wq, sc)
    with pytest.raises(ValueError, match="fp32 x needs"):
        Q1._check(torch.zeros(4, 128), Q1.pack_weight(wq), sc)
    Q1._check(torch.zeros(4, 128, dtype=torch.bfloat16),
              Q1.pack_weight(wq), sc)
    Q1._check(torch.zeros(4, 128), wq, sc)


# -- the split planner -------------------------------------------------


@settings(max_examples=300, deadline=None, database=None,
          derandomize=True)
@given(M=st.integers(1, 4096), K=st.integers(1, 2048).map(lambda v: 16 * v),
       N=st.integers(1, 2048).map(lambda v: 16 * v),
       dtype=st.sampled_from([torch.bfloat16, torch.float32]))
def test_split_plan_covers_k_in_order(M, K, N, dtype):
    """Every K stage falls in exactly one split, in order (split s takes
    stages [s per, min(kt, (s + 1) per)), none empty); the plan depends
    on the shapes alone; a product whose output tiles fill the card (one
    bf16 block an SM, two fp32 ones) is not split, and a split bf16 grid
    holds at most one block an SM."""
    splits, per = Q1.split_k(M, K, N, dtype)
    assert (splits, per) == Q1.split_k(M, K, N, dtype)
    kt = -(-K // Q1._stage_k(M, dtype))
    assert splits >= 1 and per >= 1
    owner = [s for s in range(splits)
             for _ in range(s * per, min(kt, (s + 1) * per))]
    assert owner == sorted(owner) and len(owner) == kt
    assert set(owner) == set(range(splits))
    f32 = dtype == torch.float32     # CUDA-core kernel: two blocks an SM
    rows = 8 if f32 else Q1._rows(M)
    tiles = -(-N // 128) * -(-M // rows)
    if tiles >= (264 if f32 else 132) or kt == 1:
        assert splits == 1
    if dtype == torch.bfloat16 and splits > 1:
        assert tiles * splits <= 132 and tiles < Q1._ARRIVAL_SLOTS


def test_split_plan_of_one_launch_is_its_tiles_side_by_side():
    """q / k / v in one launch split as one product of their tiles' width
    (each product's channels rounded up to 128)."""
    for M in (1, 8, 64, 128, 256, 2048):
        assert Q1.split_k(M, 4096, (4096, 1024, 1024)) == \
            Q1.split_k(M, 4096, 6144)
        assert Q1.split_k(M, 64, (64, 32, 32)) == Q1.split_k(M, 64, 384)
        assert Q1.split_k(M, 4096, [1024]) == Q1.split_k(M, 4096, 1024)


def test_split_plan_at_llama3_8b_shapes():
    """The plans the serving path runs (one llama3-8b layer's products):
    a decode step and a verify split the 4096- and 1024-channel products
    to ~128 blocks; the 14336-channel ones and the 2048-row prefill
    bucket fill the card unsplit (wk / wv there: 64 tiles, 2 splits)."""
    want = {8: [(4, 8), (16, 2), (1, 32), (4, 28)],
            64: [(4, 8), (16, 2), (1, 32), (4, 28)],
            128: [(4, 8), (16, 2), (1, 32), (4, 28)],
            256: [(4, 16), (16, 4), (1, 64), (4, 56)],
            2048: [(1, 64), (2, 32), (1, 64), (1, 224)]}
    for M, plans in want.items():
        assert [Q1.split_k(M, K, N) for K, N in (
            (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))] == plans


# -- the packed decode state -------------------------------------------


def _tiny_pair():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("tiny"))
    tm = TModel(TConfig.from_preset("tiny"), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _packed(state):
    """The int8 decode state as the card holds it for a bf16 model: each
    weight in Q1's fragment order."""
    return {**state, "layers": [
        {k: (Q1.pack_weight(v[0]), v[1]) if k in TD._WEIGHT_KEYS else v
         for k, v in layer.items()} for layer in state["layers"]]}


def test_packed_decode_state_unpacks_to_jax_int8_data():
    from paddle_tpu.models import llama_decode as JD
    jm, tm = _tiny_pair()
    js = JD.collect_decode_state(jm, weight_dtype="int8")
    plain = TD.collect_decode_state(tm, weight_dtype="int8")
    for jl, pl, ul in zip(js["layers"], _packed(plain)["layers"],
                          plain["layers"]):
        for key in TD._WEIGHT_KEYS:
            (jq, jsc), (pq, psc), (uq, _) = jl[key], pl[key], ul[key]
            assert Q1.is_packed(pq) and not Q1.is_packed(uq)
            np.testing.assert_array_equal(
                Q1.unpack_weight(pq, psc.shape[0]).numpy(), np.asarray(jq))
            np.testing.assert_array_equal(psc.numpy(), np.asarray(jsc))


def test_packed_state_programs_bitwise_the_in_out_state():
    """A decode step and a verify step over the packed state give the
    logits of the `[in, out]` state bitwise (the plain product unpacks
    the same bytes)."""
    tm = TModel(TConfig.from_preset("tiny"), device="cpu", seed=2)
    cfg = tm.config
    ref = TD.collect_decode_state(tm, weight_dtype="int8")
    packed = _packed(ref)
    B, bt, bmax = 2, 8, 4
    table = torch.arange(1, 1 + B * bmax, dtype=torch.int32).reshape(B, -1)
    tok = torch.tensor([3, 7], dtype=torch.int32)
    pos = torch.tensor([5, 9], dtype=torch.int32)
    out = []
    for state in (ref, packed):
        pool = TD.init_paged_cache(cfg, 1 + B * bmax, bt, torch.float32,
                                   device="cpu")
        logits, pool = TD.paged_decode_step_batch(state, cfg, tok, pos, pool,
                                                  table)
        toks = torch.stack([tok, tok + 1, tok + 2], 1)
        vlogits, _ = TD.paged_verify_step(state, cfg, toks, pos + 1, pool,
                                          table)
        out.append((logits, vlogits))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
