"""The port's grouped matmul (`paddle_tpu_torch/ops/gmm.py`, kernels K5f
and K5b) against the JAX package's `paddle_tpu/ops/pallas_gmm.py`, run as
its own tests run it (Pallas interpret mode on the CPU).  Inputs come
from numpy seeds.

Tolerances (fp32 on the CPU, sums in another order): out, dlhs and drhs
within 1e-5 x max|JAX| of the tensor (K <= 128 terms per sum); the
routing integers (src, tile_expert, inv_pos) exactly equal; an expert
with no tiles gets drhs exactly 0.  The kernel-vs-plain tests on the
card are marked `gpu`: per row of the output (per (e, k, :) for drhs)
within 2^-7 (bf16: one ulp) / 1e-5 (fp32) x the row's max |plain|."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import gmm as G

# (M, K, N, E, bm, tile experts): the JAX tests' shape with expert 2
# absent, and K / N that are multiples of no kernel tile (d 96, ff 40)
CASES = {
    "jax_shape": (256, 64, 128, 4, 64, [0, 1, 3, 3]),
    "odd_dims": (128, 96, 40, 3, 32, [0, 0, 2, 2]),
}


def _inputs(case, seed):
    M, K, N, E, bm, te = CASES[case]
    rs = np.random.RandomState(seed)
    lhs = rs.rand(M, K).astype(np.float32) - 0.5
    rhs = (rs.rand(E, K, N).astype(np.float32) - 0.5) * 0.2
    g = rs.rand(M, N).astype(np.float32) - 0.5
    return lhs, rhs, np.asarray(te, np.int32), g, bm


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


@pytest.mark.parametrize("case", sorted(CASES))
def test_gmm_forward_matches_jax(case):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas_gmm import gmm as jgmm
    lhs, rhs, te, _, bm = _inputs(case, 0)
    want = jgmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(te), bm, 64)
    got = G.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs),
                torch.from_numpy(te), bm, 64)
    _close(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gmm_backward_matches_jax_vjp(case):
    """dlhs (K5f against rhs transposed) and drhs (K5b) against
    `jax.vjp` of the JAX gmm with the same cotangent."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas_gmm import gmm as jgmm
    lhs, rhs, te, g, bm = _inputs(case, 1)
    _, vjp = jax.vjp(lambda a, b: jgmm(a, b, jnp.asarray(te), bm, 64),
                     jnp.asarray(lhs), jnp.asarray(rhs))
    jl, jr = vjp(jnp.asarray(g))
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    G.gmm(tl, tr, torch.from_numpy(te), bm).backward(torch.from_numpy(g))
    _close(tl.grad.numpy(), jl)
    _close(tr.grad.numpy(), jr)
    absent = sorted(set(range(rhs.shape[0])) - set(te.tolist()))
    assert absent
    for e in absent:
        assert torch.all(tr.grad[e] == 0)


def test_gmm_plain_matches_a_per_tile_loop():
    """The plain versions against numpy in float64, tile by tile."""
    lhs, rhs, te, g, bm = _inputs("odd_dims", 2)
    tiles = range(len(te))
    out = G.gmm_plain(torch.from_numpy(lhs), torch.from_numpy(rhs),
                      torch.from_numpy(te), bm).numpy()
    want = np.concatenate([lhs[i*bm:(i+1)*bm].astype(np.float64) @ rhs[e]
                           for i, e in zip(tiles, te)])
    _close(out, want)
    dl = G.gmm_plain(torch.from_numpy(g), torch.from_numpy(rhs),
                     torch.from_numpy(te), bm, transpose_rhs=True).numpy()
    _close(dl, np.concatenate([g[i*bm:(i+1)*bm].astype(np.float64)
                               @ rhs[e].T for i, e in zip(tiles, te)]))
    dr = G.gmm_drhs_plain(torch.from_numpy(lhs), torch.from_numpy(g),
                          torch.from_numpy(te), rhs.shape[0], bm).numpy()
    want = np.zeros(rhs.shape)
    for i, e in zip(tiles, te):
        want[e] += lhs[i*bm:(i+1)*bm].T.astype(np.float64) @ g[i*bm:(i+1)*bm]
    _close(dr, want)
    assert np.all(dr[1] == 0)


@pytest.mark.parametrize("T,E,bm", [(100, 5, 32), (64, 8, 16)])
def test_sort_slots_by_expert_matches_jax(T, E, bm):
    """src, tile_expert and inv_pos equal the JAX ones as integers, with
    an absent expert and tiles past the last expert's span."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas_gmm import (padded_buffer_size as jpad,
                                           sort_slots_by_expert as jsort)
    eid = np.random.RandomState(T).randint(0, E - 1, T)   # E-1 absent
    M = G.padded_buffer_size(T, E, bm)
    assert M == jpad(T, E, bm)
    want = jsort(jnp.asarray(eid), E, bm, M)
    got = G.sort_slots_by_expert(torch.from_numpy(eid), E, bm, M)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1][-1] == E - 1


def test_sort_tokens_by_expert_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas_gmm import sort_tokens_by_expert as jsort
    rs = np.random.RandomState(3)
    T, H, E, bm = 100, 16, 4, 32
    x = rs.rand(T, H).astype(np.float32)
    eid = rs.randint(0, E, T)
    want = jsort(jnp.asarray(x), jnp.asarray(eid), E, bm)
    got = G.sort_tokens_by_expert(torch.from_numpy(x), torch.from_numpy(eid),
                                  E, bm)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0][got[2].long()].numpy(), x)


def test_dropless_moe_ffn_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas_gmm import dropless_moe_ffn as jffn
    rs = np.random.RandomState(4)
    T, H, Fh, E = 96, 32, 64, 4
    x = rs.rand(T, H).astype(np.float32) - 0.5
    eid = rs.randint(0, E, T)
    wu = (rs.rand(E, H, Fh).astype(np.float32) - 0.5) * 0.2
    wd = (rs.rand(E, Fh, H).astype(np.float32) - 0.5) * 0.2
    want = jffn(jnp.asarray(x), jnp.asarray(eid), jnp.asarray(wu),
                jnp.asarray(wd), block_m=32, block_n=32)
    got = G.dropless_moe_ffn(torch.from_numpy(x), torch.from_numpy(eid),
                             torch.from_numpy(wu), torch.from_numpy(wd),
                             block_m=32, block_n=32)
    _close(got.numpy(), want)


def test_gmm_rejects_a_wrong_tile_count_and_mixed_dtypes():
    lhs = torch.zeros(256, 8)
    rhs = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match="tile_expert has 3 tiles"):
        G.gmm(lhs, rhs, torch.zeros(3, dtype=torch.int32), 64)
    with pytest.raises(ValueError, match="tile_expert"):
        G.gmm_drhs(lhs, torch.zeros(256, 4), torch.zeros(2, dtype=torch.int32),
                   2, 64)
    with pytest.raises(ValueError, match="share a dtype"):
        G.gmm(lhs, rhs.to(torch.bfloat16), torch.zeros(4, dtype=torch.int32),
              64)


def test_cpu_calls_count_no_launches():
    lhs, rhs, te, g, bm = _inputs("jax_shape", 5)
    before = dict(G.LAUNCHES)
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    G.gmm(tl, tr, torch.from_numpy(te), bm).sum().backward()
    assert G.LAUNCHES == before


@pytest.mark.parametrize("T,E,bm", [(100, 5, 32), (64, 8, 16), (400, 6, 64),
                                    (1000, 12, 128)])
def test_live_tile_count_matches_the_jax_sorts_padded_span(T, E, bm):
    """live_tile_count from the port's sort is the JAX sort's padded span
    (every expert's rows padded to bm) over bm; the tiles before it hold
    routed rows of the JAX buffer and the tiles after it none."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas_gmm import sort_slots_by_expert as jsort
    eid = np.random.RandomState(T + E).randint(0, E - 1, T)   # E-1 absent
    M = G.padded_buffer_size(T, E, bm)
    jsrc = np.asarray(jsort(jnp.asarray(eid), E, bm, M)[0])
    span = int(sum(-(-c // bm) * bm for c in np.bincount(eid, minlength=E)))
    _, _, inv_pos = G.sort_slots_by_expert(torch.from_numpy(eid), E, bm, M)
    live = G.live_tile_count(inv_pos, bm)
    assert live.dtype == torch.int32 and live.dim() == 0
    assert int(live) == span // bm < M // bm
    routed = (jsrc.reshape(-1, bm) < T).any(1)
    assert routed[:int(live)].all() and not routed[int(live):].any()


def test_plain_versions_with_live_tiles_change_nothing_on_sorted_buffers():
    """On buffers sort_tokens_by_expert builds (zero rows past the last
    expert's span), the plain K5f / K5b and gmm's gradients are equal
    with and without live_tiles; on other rows live_tiles zeroes K5f's
    padding tiles and drops them from K5b."""
    rs = np.random.RandomState(8)
    T, H, Fh, E, bm = 150, 24, 40, 5, 32
    x = torch.from_numpy(rs.rand(T, H).astype(np.float32) - 0.5)
    eid = torch.from_numpy(rs.randint(0, E - 1, T))        # E-1 absent
    w = torch.from_numpy((rs.rand(E, H, Fh).astype(np.float32) - 0.5))
    buf, te, inv_pos = G.sort_tokens_by_expert(x, eid, E, bm)
    live = G.live_tile_count(inv_pos, bm)
    assert int(live) < te.shape[0]                         # padding tiles
    g = torch.from_numpy(rs.rand(buf.shape[0], Fh).astype(np.float32))
    g = torch.where((torch.arange(buf.shape[0]) < int(live) * bm)[:, None],
                    g, 0)
    assert torch.equal(G.gmm_plain(buf, w, te, bm, live_tiles=live),
                       G.gmm_plain(buf, w, te, bm))
    assert torch.equal(G.gmm_plain(g, w, te, bm, True, live),
                       G.gmm_plain(g, w, te, bm, True))
    assert torch.equal(G.gmm_drhs_plain(buf, g, te, E, bm, live),
                       G.gmm_drhs_plain(buf, g, te, E, bm))
    grads = []
    for lt in (None, live):
        a = buf.clone().requires_grad_()
        b = w.clone().requires_grad_()
        out = G.gmm(a, b, te, bm, live_tiles=lt)
        out.backward(g)
        grads.append((out, a.grad, b.grad))
    for p, q in zip(*grads):
        assert torch.equal(p, q)
    # rows that are not zero past the span: K5f writes zeros there, K5b
    # leaves them out
    ones = torch.ones_like(buf)
    cut = int(live) * bm
    assert not G.gmm_plain(ones, w, te, bm, live_tiles=live)[cut:].any()
    assert G.gmm_plain(ones, w, te, bm)[cut:].abs().sum() > 0
    gone = G.gmm_drhs_plain(ones, torch.ones_like(g), te, E, bm, live)
    assert torch.equal(gone, G.gmm_drhs_plain(
        ones[:cut], torch.ones_like(g)[:cut], te[:int(live)], E, bm))


@pytest.mark.parametrize("dtype,bm,K,N,want", [
    (torch.float32, 256, 2048, 1408, "fma"),
    (torch.float32, 16, 40, 136, "fma"),
    (torch.float32, 64, 7, 3, "fma"),
    (torch.bfloat16, 256, 2048, 1408, "wgmma"),
    (torch.bfloat16, 128, 64, 96, "wgmma"),
    (torch.bfloat16, 64, 96, 200, "wgmma"),
    (torch.bfloat16, 32, 64, 96, "fma"),
    (torch.bfloat16, 16, 40, 136, "fma"),
    (torch.bfloat16, 48, 8, 8, "fma"),
])
def test_variant_maps_fp32_to_cuda_cores_and_bf16_to_tensor_cores(
        dtype, bm, K, N, want):
    """fp32 on the CUDA cores; bf16 on the tensor cores wherever the
    64-row warpgroup tile divides bm (every buffer the port builds), on
    the CUDA cores otherwise."""
    assert G._variant(dtype, bm, K, N) == want
    assert (dtype, want) in G.KERNEL_CODES


@pytest.mark.parametrize("dtype,bm,K,N,match", [
    (torch.bfloat16, 256, 2044, 1408, "multiples of 8"),
    (torch.bfloat16, 64, 96, 201, "multiples of 8"),
    (torch.bfloat16, 8, 64, 64, "multiple of 16"),
    (torch.float32, 24, 64, 64, "multiple of 16"),
    (torch.float16, 256, 64, 64, "float32 or bfloat16"),
])
def test_variant_raises_on_what_no_kernel_takes(dtype, bm, K, N, match):
    with pytest.raises(ValueError, match=match):
        G._variant(dtype, bm, K, N)


@pytest.mark.parametrize("dtype,bm,variant,ok", [
    (torch.bfloat16, 256, "fma", True),
    (torch.bfloat16, 64, "wgmma", True),
    (torch.float32, 256, "fma", True),
    (torch.float32, 256, "wgmma", False),
    (torch.bfloat16, 32, "wgmma", False),
    (torch.bfloat16, 256, "mma", False),
])
def test_named_variant_is_taken_or_raises(dtype, bm, variant, ok):
    """A caller may name the variant; one that has no kernel for the
    dtype or row tile raises instead of running another."""
    if ok:
        assert G._variant(dtype, bm, 64, 64, variant) == variant
    else:
        with pytest.raises(ValueError, match="no .* kernel takes"):
            G._variant(dtype, bm, 64, 64, variant)


# --------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# --------------------------------------------------------------------------

TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _row_share(got, want, tol):
    """max over rows (last dim) of max|got - want| / (tol x max|want|);
    0 where both rows are exactly zero."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    ref = want.abs().amax(-1)
    share = torch.where(ref > 0, err / (tol * ref.clamp_min(1e-30)),
                        torch.where(err > 0, torch.inf, 0.0))
    return share.max().item()


def _card_case(M, K, N, E, bm, dtype, seed, absent=(1,), pad=0):
    """Sorted tiles of the experts not in `absent`, then `pad` padding
    tiles of expert E-1 whose rows are zero, as the sort leaves them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_live = M // bm - pad
    experts = [e for e in range(E) if e not in absent]
    te = torch.tensor(sorted(experts[i % len(experts)]
                             for i in range(n_live)) + [E - 1] * pad,
                      dtype=torch.int32)
    lhs = torch.randn(M, K, device="cuda", generator=g).to(dtype)
    rhs = (0.1 * torch.randn(E, K, N, device="cuda", generator=g)).to(dtype)
    dout = torch.randn(M, N, device="cuda", generator=g).to(dtype)
    lhs[n_live * bm:] = 0
    dout[n_live * bm:] = 0
    return lhs, rhs, te.cuda(), dout


# (M, K, N, E, bm): every row-tile width the kernel picks (bm 256, 64,
# 32, 16), K and N off the kernel's 16 / 128 tiles, the tiny preset's
# d 64 and ff 96
CARD = [(1024, 256, 384, 4, 256), (512, 96, 200, 3, 64), (256, 64, 96, 4, 32),
        (160, 40, 136, 3, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for M, K, N, E, bm in CARD:
        lhs, rhs, te, dout = _card_case(M, K, N, E, bm, dtype, seed=M + K)
        before = dict(G.LAUNCHES)
        out = G.gmm_fwd(lhs, rhs, te, bm)
        dl = G.gmm_fwd(dout, rhs, te, bm, transpose_rhs=True)
        dr = G.gmm_drhs(lhs, dout, te, E, bm)
        dr2 = G.gmm_drhs(lhs, dout, te, E, bm)
        torch.cuda.synchronize()
        assert G.LAUNCHES["gmm_fwd"] == before["gmm_fwd"] + 2
        assert G.LAUNCHES["gmm_drhs"] == before["gmm_drhs"] + 2
        tol = TOL[dtype]
        assert _row_share(out, G.gmm_plain(lhs, rhs, te, bm), tol) <= 1.0
        assert _row_share(dl, G.gmm_plain(dout, rhs, te, bm, True),
                          tol) <= 1.0
        assert _row_share(dr, G.gmm_drhs_plain(lhs, dout, te, E, bm),
                          tol) <= 1.0
        assert torch.equal(dr, dr2)                 # no atomics: bitwise
        assert not dr[1].any()                      # absent expert


@pytest.mark.gpu
def test_cuda_kernels_match_plain_at_train_widths_on_card():
    """bf16 at the MoE train path's widths (K 2048, N 1408, bm 256, the
    wgmma variant): expert 1 absent and 3 padding tiles past the last
    expert's span, which the kernels skip (live_tiles) and the plain
    versions read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU or interpret mode")
    M, K, N, E, bm, pad = 4096, 2048, 1408, 12, 256, 3
    assert G._variant(torch.bfloat16, bm, K, N) == "wgmma"
    lhs, rhs, te, dout = _card_case(M, K, N, E, bm, torch.bfloat16, 11,
                                    pad=pad)
    live = torch.tensor(M // bm - pad, dtype=torch.int32, device="cuda")
    out = G.gmm_fwd(lhs, rhs, te, bm, live_tiles=live)
    dl = G.gmm_fwd(dout, rhs, te, bm, True, live)
    dr = G.gmm_drhs(lhs, dout, te, E, bm, live)
    dr2 = G.gmm_drhs(lhs, dout, te, E, bm, live)
    torch.cuda.synchronize()
    tol = TOL[torch.bfloat16]
    assert _row_share(out, G.gmm_plain(lhs, rhs, te, bm), tol) <= 1.0
    assert _row_share(dl, G.gmm_plain(dout, rhs, te, bm, True), tol) <= 1.0
    assert _row_share(dr, G.gmm_drhs_plain(lhs, dout, te, E, bm), tol) <= 1.0
    assert torch.equal(dr, dr2)                     # no atomics: bitwise
    assert not dr[1].any()                          # absent expert
    cut = (M // bm - pad) * bm
    assert not out[cut:].any() and not dl[cut:].any()


@pytest.mark.gpu
def test_cuda_gmm_autograd_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    lhs, rhs, te, dout = _card_case(512, 96, 200, 3, 64, torch.float32, 7)
    grads = []
    for dev in ("cuda", "cpu"):
        a = lhs.detach().to(dev).requires_grad_()
        b = rhs.detach().to(dev).requires_grad_()
        G.gmm(a, b, te.to(dev), 64).backward(dout.to(dev))
        grads.append((a.grad.cpu(), b.grad.cpu()))
    for g, p in zip(*grads):
        assert _row_share(g, p, 1e-5) <= 1.0
