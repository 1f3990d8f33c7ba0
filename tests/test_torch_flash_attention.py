"""Kernels K1 / K2 of the PyTorch port (paddle_tpu_torch/ops/flash_attention.py):
the plain versions against the JAX package's Pallas flash kernels run in
interpret mode (forward: `_flash_fwd`; backward: `jax.grad` of
`flash_mha` under both backward variants, the resident one and the tiled
one), the dispatch (`flash_attention_xla`, `scaled_dot_product_attention_raw`)
against the JAX package's, the wrapper's checks, and — on the card only —
the CUDA kernels against the plain versions.

Inputs are made with numpy from a seed and handed to both packages in
fp32.  Tolerances: O, dQ, dK, dV within 1e-5 of max |reference| and lse
within 1e-5 absolute (fp32 sums in another order, S <= 256); on the
card, per row (O, dQ: (b, query row, head); dK, dV: (b, key row, kv
head)) relative to that row's max |plain|, fp32 1e-5 and bf16 2^-7 (both
round an fp32 result to bf16 once: at most one ulp apart), and lse per
element within 1e-5 x max(1, |lse|)."""

import itertools
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as FA


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkvd(B, S, H, Hkv, D, seed=0, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,block", [(128, 64), (256, 64), (256, 128)])
def test_plain_fwd_matches_pallas_kernel(S, block, causal):
    """flash_fwd_plain's O and lse against `_flash_fwd` (Pallas, interpret
    mode) on the (B*H, S, D) layout the kernel takes."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas_attention import _flash_fwd
    B, H, D = 1, 2, 32
    q, k, v, _ = _qkvd(B, S, H, H, D, seed=S + block)
    scale = 1.0 / math.sqrt(D)

    def bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))

    jo, jlse = _flash_fwd(bh(q), bh(k), bh(v), causal, scale, block, block)
    o, lse = FA.flash_fwd_plain(*_t(q, k, v), causal=causal)
    _close(o.numpy().transpose(0, 2, 1, 3).reshape(B * H, S, D), jo)
    _close(lse.numpy().reshape(B * H, S), np.asarray(jlse)[..., 0])


@pytest.mark.parametrize("variant", ["resident", "tiled"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(2, 2), (4, 2)])
def test_plain_bwd_matches_jax_grad(monkeypatch, variant, causal, H, Hkv):
    """flash_mha (forward + backward through the plain versions, GQA
    included) against `jax.grad` of the JAX package's `flash_mha`, whose
    backward runs the resident Pallas kernels or — with the live
    `PADDLE_TPU_FLASH_RESIDENT_BWD_MAX` set to 0 — the tiled ones."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas_attention import flash_mha
    monkeypatch.setenv("PADDLE_TPU_FLASH_RESIDENT_BWD_MAX",
                       "4096" if variant == "resident" else "0")
    q, k, v, do = _qkvd(1, 128, H, Hkv, 32, seed=H * 10 + Hkv)

    def loss(a, b, c):
        return jnp.sum(flash_mha(a, b, c, causal, None, 64, 64)
                       * jnp.asarray(do))

    jout = flash_mha(*(jnp.asarray(x) for x in (q, k, v)), causal, None,
                     64, 64)
    jg = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                             for x in (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = FA.flash_mha(tq, tk, tv, causal)
    out.backward(torch.from_numpy(do))
    _close(out.detach().numpy(), jout)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        assert got.shape == want.shape, name
        _close(got.numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_seq_matches_jax_attention(causal):
    """S = 100, not a multiple of any tile: the plain versions against the
    JAX package's `scaled_dot_product_attention_raw` (fp32, GQA)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.flash_attention import \
        scaled_dot_product_attention_raw as jsdpa
    q, k, v, do = _qkvd(2, 100, 4, 1, 64, seed=3)
    jout, vjp = jax.vjp(lambda a, b, c: jsdpa(a, b, c, is_causal=causal),
                        *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = FA.flash_attention_xla(tq, tk, tv, is_causal=causal)
    out.backward(torch.from_numpy(do))
    _close(out.detach().numpy(), jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got.numpy(), want)


def _jax_sdpa_causal(q, k, v, do=None):
    """The JAX package's `scaled_dot_product_attention_raw`, causal,
    fp32: the output, and with `do` also (dQ, dK, dV) by `jax.vjp`."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.flash_attention import \
        scaled_dot_product_attention_raw as jsdpa
    out, vjp = jax.vjp(lambda a, b, c: jsdpa(a, b, c, is_causal=True),
                       *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), (None if do is None
                             else vjp(jnp.asarray(do)))


@pytest.mark.parametrize("entry", ["flash_mha", "flash_attention_xla"])
@pytest.mark.parametrize("Sq,Sk", [(3, 7), (7, 3)])
def test_causal_unequal_lengths_fwd_matches_jax(Sq, Sk, entry):
    """Causal Sq != Sk is masked bottom-right (query r sees key c when
    r + Sk - Sq >= c), as the JAX formula's `tril(k = Sk - Sq)`.  At
    Sq > Sk the rows r < Sq - Sk see no key: NaN in both, matched by
    position; every other element within 1e-5."""
    q, k, v, _ = _qkvd(2, Sq, 4, 2, 16, seed=0, Sk=Sk)
    want, _ = _jax_sdpa_causal(q, k, v)
    fn = FA.flash_mha if entry == "flash_mha" else \
        (lambda a, b, c: FA.flash_attention_xla(a, b, c, is_causal=True))
    got = fn(*_t(q, k, v)).numpy()
    assert (np.isnan(got) == np.isnan(want)).all()
    assert np.isnan(want).any() == (Sq > Sk)
    live = ~np.isnan(want)
    assert np.abs(got[live] - want[live]).max() <= 1e-5


@pytest.mark.parametrize("Sq,Sk,H,Hkv", [(3, 7, 2, 2), (64, 128, 4, 2)])
def test_causal_unequal_lengths_grads_match_jax(Sq, Sk, H, Hkv):
    """dQ, dK, dV of causal attention at Sq < Sk (GQA in the second
    case) through `flash_mha` against `jax.vjp` of the JAX formula,
    each within 1e-5 of max(1, max |reference|).  At Sq > Sk the
    reference's gradient is NaN throughout, so only Sq <= Sk is
    compared."""
    q, k, v, do = _qkvd(1, Sq, H, Hkv, 16, seed=1, Sk=Sk)
    want, jg = _jax_sdpa_causal(q, k, v, do)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = FA.flash_mha(tq, tk, tv, True)
    out.backward(torch.from_numpy(do))
    _close(out.detach().numpy(), want)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got.numpy(), ref)


def test_blind_rows_add_nothing_to_the_gradients():
    """At Sq > Sk the rows that see no key get dQ = 0 and leave dK / dV
    as the rows that see keys make them: the same gradients as
    attention over those rows alone."""
    q, k, v, do = _t(*_qkvd(1, 9, 2, 1, 16, seed=2, Sk=5))
    o, lse = FA.flash_fwd(q, k, v, True)
    dq, dk, dv = FA.flash_bwd(q, k, v, o, lse, do, True)
    assert torch.isnan(o[:, :4]).all() and torch.isinf(lse[..., :4]).all()
    assert (dq[:, :4] == 0).all()
    o2, lse2 = FA.flash_fwd(q[:, 4:], k, v, True)
    want = FA.flash_bwd(q[:, 4:], k, v, o2, lse2, do[:, 4:], True)
    for got, ref in zip((dq[:, 4:], dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_head_dim_16_tiny_attention_matches_jax():
    """The `tiny` preset's attention (4 / 2 heads, head_dim 16, causal)
    through `flash_mha`, forward and backward, against the JAX formula
    within 1e-5 of max(1, max |reference|)."""
    q, k, v, do = _qkvd(2, 32, 4, 2, 16, seed=3)
    want, jg = _jax_sdpa_causal(q, k, v, do)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = FA.flash_mha(tq, tk, tv, True)
    out.backward(torch.from_numpy(do))
    _close(out.detach().numpy(), want)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got.numpy(), ref)


def test_masked_attention_runs_raw_on_cpu():
    """A mask on the CPU gives the JAX package's
    `scaled_dot_product_attention_raw` (bool masks select, float masks
    add); it runs K1/K2's plain versions with the mask as a bias."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.flash_attention import \
        scaled_dot_product_attention_raw as jsdpa
    q, k, v, _ = _qkvd(1, 16, 2, 2, 32, seed=4)
    rng = np.random.default_rng(5)
    bmask = rng.random((1, 2, 16, 16)) < 0.7
    bmask[..., 0] = True
    fmask = rng.normal(size=(1, 1, 16, 16)).astype(np.float32)
    for mask in (bmask, fmask):
        want = jsdpa(*(jnp.asarray(x) for x in (q, k, v)),
                     attn_mask=jnp.asarray(mask), is_causal=True)
        got = FA.flash_attention_xla(*_t(q, k, v),
                                     attn_mask=torch.from_numpy(mask),
                                     is_causal=True)
        _close(got.numpy(), want)


def test_cpu_calls_run_plain_and_count_no_launch():
    q, k, v, do = _t(*_qkvd(1, 70, 4, 2, 32, seed=6))
    before = dict(FA.LAUNCHES)
    o, lse = FA.flash_fwd(q, k, v)
    po, plse = FA.flash_fwd_plain(q, k, v)
    torch.testing.assert_close(o, po, rtol=0, atol=0)
    torch.testing.assert_close(lse, plse, rtol=0, atol=0)
    grads = FA.flash_bwd(q, k, v, o, lse, do)
    plain = FA.flash_bwd_plain(q, k, v, o, lse, do)
    for g, p in zip(grads, plain):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    assert FA.LAUNCHES == before


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "fma"),
    (torch.bfloat16, 32, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 32, "fma"),
    (torch.bfloat16, 16, "fma"), (torch.float32, 16, "fma")])
def test_variant_maps_bf16_d128_to_tensor_cores(dtype, D, want):
    """Without a bias or dropout, bf16 at head_dim 128 runs the wgmma
    kernels; fp32 and head_dim 16 / 32 / 64 the CUDA-core kernels."""
    assert FA._variant(dtype, D) == want
    assert FA._variant(dtype, D, want) == want


@pytest.mark.parametrize("dtype,D,variant", [
    (torch.float32, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 128, "mma"),
    (torch.float16, 128, "fma"), (torch.bfloat16, 48, "fma")])
def test_named_variant_that_does_not_take_the_call_raises(dtype, D, variant):
    with pytest.raises(ValueError, match="no .* kernel takes"):
        FA._variant(dtype, D, variant)


def test_named_fma_variant_on_bf16_d128_is_taken():
    assert FA._variant(torch.bfloat16, 128, "fma") == "fma"


def _emulate_tensor_cores(q, k, v, do, causal, tile=128):
    """The wgmma kernels' arithmetic in plain PyTorch: scores q . k in
    fp32 scaled in fp32, an online softmax over `tile`-key tiles whose P
    (against the running max) enters P.V as two bf16 parts, hi = bf16(P)
    and lo = bf16(P - hi), while l sums the fp32 P; in the backward
    P = exp(s - lse) and dS = P (dP - delta) enter dV = P^T dO,
    dQ = dS K scale and dK = dS^T Q scale as two bf16 parts each.
    Returns (O, lse, dQ, dK, dV), the gradients from the emulated O and
    lse, each rounded once to the inputs' dtype."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    bf = torch.bfloat16

    def two_parts(x):                # hi + lo as the kernels multiply it
        hi = x.to(bf).float()
        return hi + (x - hi).to(bf).float()
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf, vf = (x.float().repeat_interleave(rep, 2).transpose(1, 2)
              for x in (k, v))
    s = (qf @ kf.transpose(-1, -2)) * scale          # (B, H, S, Sk)
    keep = FA._keep(S, k.shape[1], causal, q.device)
    s = torch.where(keep, s, FA.NEG_INF)
    m = torch.full((B, H, S, 1), FA.NEG_INF)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    for k0 in range(0, k.shape[1], tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(keep[:, k0:k0 + tile], torch.exp(st - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + two_parts(p) @ vf[:, :, k0:k0 + tile]
        m = m_new
    l = l.clamp_min(1e-30)
    o = (acc / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    delta = (o.float() * dof).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    pb, dsb = two_parts(p), two_parts(ds)
    dq = (dsb @ kf) * scale
    dk = (dsb.transpose(-1, -2) @ qf) * scale
    dv = pb.transpose(-1, -2) @ dof

    def kv_grad(x):                  # (B, H, Sk, D) -> (B, Sk, Hkv, D)
        x = x.reshape(B, H // rep, rep, -1, D).sum(2)
        return x.transpose(1, 2).to(k.dtype)
    return (o.transpose(1, 2), lse, dq.transpose(1, 2).to(q.dtype),
            kv_grad(dk), kv_grad(dv))


@pytest.mark.parametrize("seed", [0, 1])
def test_tensor_core_rounding_stays_within_the_card_limits(seed):
    """The numeric design of the wgmma kernels, emulated on the CPU
    (`_emulate_tensor_cores`: fp32 scores scaled in fp32, P per 128-key
    tile and dS in two bf16 parts) at S 512, 4 query heads over 1 kv
    head, head_dim 128, causal, bf16 inputs: O, dQ, dK and dV within
    chip_smoke.py's per-row limit of the plain versions (one bf16 ulp,
    2^-7 of the row's max |plain|) and lse within 1e-5 relative."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _qkvd(1, 512, 4, 1, 128, seed=seed))
    o, lse, dq, dk, dv = _emulate_tensor_cores(q, k, v, do, True)
    po, plse = FA.flash_fwd_plain(q, k, v, True)
    assert _per_row_share(o, po, 2 ** -7) <= 1.0
    assert ((lse - plse).abs() <= 1e-5 * plse.abs().clamp_min(1.0)).all()
    # the backward from the emulated O and lse, as the kernels get them
    for got, want in zip((dq, dk, dv),
                         FA.flash_bwd_plain(q, k, v, o, lse, do, True)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _per_row_share(got, want, 2 ** -7) <= 1.0


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest on
    the 13 low mantissa bits, ties away from zero (the bits are sign and
    magnitude, so adding half the dropped range rounds the magnitude)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _three_tf32(a, b):
    """a @ b as the fp32 mma kernels take it: x = big + small with big =
    tf32(x) and small = tf32(x - big), then big.small + small.big +
    big.big summed in fp32 (a product of two TF32 values is exact in
    fp32)."""
    ab, bb = _tf32(a), _tf32(b)
    return (ab @ _tf32(b - bb) + _tf32(a - ab) @ bb) + ab @ bb


def _one_tf32(a, b):
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _bf16_two_parts(a, b):
    """a @ b with a as two bf16 parts, hi = bf16(a) and lo = bf16(a -
    hi), and b as it is (bf16 inputs pass exactly)."""
    hi = a.to(torch.bfloat16).float()
    return (hi + (a - hi).to(torch.bfloat16).float()) @ b.float()


def _emulate_mma(q, k, v, do, causal, bias, dropout, mm, tile=64):
    """The mma kernels' arithmetic (csrc/flash_attention_mma.cuh) in plain
    PyTorch, every product taken by `mm`: scores q . k in fp32 scaled
    after the product, plus the bias, masked to -inf; an online softmax
    over `tile`-key tiles from a row max of -inf whose P z / (1 - p)
    enters P.V while l sums P; lse as hi + lo (TwoSum).  The backward
    from the emulated O, lse and lo: P = exp((s - hi) - lo),
    dS = P (dP z / (1 - p) - delta), dQ = dS K scale, dK = dS^T Q scale,
    dV = (P z / (1 - p))^T dO, where the fp32 kernels sum dP on the CUDA
    cores as the plain version does (dP by `mm` in bf16).  Returns (O,
    lse, lse_lo, dQ, dK, dV),
    O and the gradients rounded once to the inputs' dtype."""
    B, S, H, D = q.shape
    Sk, n_kv = k.shape[1], k.shape[2]
    rep = H // n_kv
    scale = 1.0 / math.sqrt(D)
    qf, dof = (x.float().transpose(1, 2) for x in (q, do))
    kf, vf = (x.float().repeat_interleave(rep, 2).transpose(1, 2)
              for x in (k, v))
    keep = FA._keep(S, Sk, causal, q.device)
    s = mm(qf, kf.transpose(-1, -2)) * scale + bias.expand(B, H, S, Sk)
    s = torch.where(keep, s, -math.inf)
    z = FA.dropout_keep(B, H, S, Sk, *dropout, q.device)
    ks = FA._keep_scale(dropout[0])
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    for k0 in range(0, Sk, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(st - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        pz = torch.where(z[..., k0:k0 + tile], p * ks, 0.0)
        acc = acc * alpha + mm(pz, vf[:, :, k0:k0 + tile])
        m = m_new
    lc = l.clamp_min(1e-30)
    dead = torch.isneginf(m)
    ll = torch.log(lc)
    hi = m + ll
    bv = hi - m
    lse = torch.where(dead, -math.inf, hi)
    lo = torch.where(dead, 0.0, (m - (hi - bv)) + (ll - bv))
    o = torch.where(dead, math.nan, acc / lc).to(q.dtype)

    p = torch.where(keep & ~dead, torch.exp((s - torch.where(
        dead, math.inf, lse)) - lo), 0.0)
    delta = torch.where(dead, 0.0, (o.float() * dof).sum(-1, keepdim=True))
    if q.dtype == torch.float32:
        dp = torch.einsum("bqgrd,bkgd->bgrqk", FA._grouped(do, n_kv),
                          v.float()).reshape(B, H, S, Sk)
    else:
        dp = mm(dof, vf.transpose(-1, -2))
    ds = p * (torch.where(z, dp * ks, 0.0) - delta)
    pz = torch.where(z, p * ks, 0.0)
    dq = mm(ds, kf) * scale
    dk = mm(ds.transpose(-1, -2), qf) * scale
    dv = mm(pz.transpose(-1, -2), dof)

    def kv_grad(x):                  # (B, H, Sk, D) -> (B, Sk, Hkv, D)
        x = x.reshape(B, n_kv, rep, -1, D).sum(2)
        return x.transpose(1, 2).to(k.dtype)
    return (o.transpose(1, 2), lse[..., 0], lo[..., 0],
            dq.transpose(1, 2).to(q.dtype), kv_grad(dk), kv_grad(dv))


def _mma_case(B, S, H, Hkv, D, dtype, seed):
    """Inputs, a (B, 1, 1, S) -1e9 padding bias (the last sequence's
    last quarter padded, as ERNIE's) and dropout 0.1."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _qkvd(B, S, H, Hkv, D, seed=seed))
    bias = torch.from_numpy(_bias_case("pad", B, S, H, None))
    return q, k, v, do, bias, (0.1, 2 ** 33 + seed, 5)


def _mma_shares(q, k, v, do, causal, bias, drop, mm, tol):
    """The worst per-row share of `tol` of the emulated O, dQ, dK, dV
    against the plain versions (the backward on the emulated O, lse and
    lo, as K2 gets them), and whether lse is within 1e-5 relative."""
    o, lse, lo, dq, dk, dv = _emulate_mma(q, k, v, do, causal, bias, drop,
                                          mm)
    po, plse = FA.flash_fwd_plain(q, k, v, causal, bias=bias, dropout=drop)
    plain = FA.flash_bwd_plain(q, k, v, o, lse, do, causal, bias=bias,
                               dropout=drop, lse_lo=lo)
    shares = {"o": _per_row_share(o, po, tol)}
    for n, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        assert got.dtype == want.dtype and got.shape == want.shape
        shares[n] = _per_row_share(got, want, tol)
    return shares, _lse_ok(lse, plse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_three_tf32_products_stay_within_the_fp32_limit(D, causal):
    """The fp32 mma kernels' numeric design, emulated on the CPU with
    TF32 rounding done on the bits (`_emulate_mma` with `_three_tf32`;
    dP summed as the plain version sums it), at the ERNIE case's
    (B, 1, 1, S) padding bias and dropout 0.1, GQA 4 / 2: O, dQ, dK and
    dV within chip_smoke.py's per-row fp32 limit (1e-5 of the row's max
    |plain|) of the plain versions and lse within 1e-5 relative.  One
    TF32 product alone misses that limit, which is why the kernels take
    three."""
    case = _mma_case(2, 128, 4, 2, D, torch.float32, seed=D + causal)
    shares, lse_ok = _mma_shares(*case[:4], causal, *case[4:], _three_tf32,
                                 1e-5)
    assert max(shares.values()) <= 1.0, shares
    assert lse_ok
    one, _ = _mma_shares(*case[:4], causal, *case[4:], _one_tf32, 1e-5)
    assert max(one.values()) > 1.0, one


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_bf16_two_part_products_with_bias_and_dropout_stay_within_limits(
        D, causal):
    """The bf16 mma kernels' numeric design (`_emulate_mma` with P and
    dS as two bf16 parts, q, k, v and dO exact) with the padding bias and
    dropout 0.1: O, dQ, dK and dV within one bf16 ulp (2^-7 of the row's
    max |plain|) of the plain versions and lse within 1e-5 relative."""
    case = _mma_case(2, 192, 4, 2, D, torch.bfloat16, seed=D + 2 + causal)
    shares, lse_ok = _mma_shares(*case[:4], causal, *case[4:],
                                 _bf16_two_parts, 2 ** -7)
    assert max(shares.values()) <= 1.0, shares
    assert lse_ok


def _fp16_parts(n):
    """a @ b with a as `n` fp16 parts (hi = fp16(a), lo = fp16(a - hi))
    and b as it is (fp16 inputs pass exactly)."""
    def mm(a, b):
        hi = a.to(torch.float16).float()
        parts = hi if n == 1 else hi + (a - hi).to(torch.float16).float()
        return parts @ b.float()
    return mm


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_fp16_two_part_products_with_bias_and_dropout_stay_within_limits(
        D, causal):
    """The fp16 mma kernels' numeric design (`_emulate_mma` with P and
    dS as two fp16 parts) with the padding bias as amp's O1 hands it
    (cast to fp16: -1e9 is -inf) and dropout 0.1: O, dQ, dK and dV within
    one fp16 ulp (2^-10 of the row's max |plain|) of the plain versions,
    lse within 1e-5 relative, and never further from them than one fp16
    part, the design the kernels do not take."""
    q, k, v, do, bias, drop = _mma_case(2, 192, 4, 2, D, torch.float16,
                                        seed=D + 4 + causal)
    bias = bias.half().float()
    assert torch.isneginf(bias).any()
    shares, lse_ok = _mma_shares(q, k, v, do, causal, bias, drop,
                                 _fp16_parts(2), 2 ** -10)
    assert max(shares.values()) <= 1.0, shares
    assert lse_ok
    one, _ = _mma_shares(q, k, v, do, causal, bias, drop, _fp16_parts(1),
                         2 ** -10)
    assert max(one.values()) >= max(shares.values()), (one, shares)


@pytest.mark.parametrize("bad", ["head_dim", "groups", "batch",
                                 "dtype", "stride", "align", "shape"])
def test_wrapper_checks_raise(bad):
    """The CUDA wrapper's checks (run here on CPU tensors): anything the
    kernel does not take raises before a launch."""
    q = torch.zeros(1, 64, 4, 32)
    k = v = torch.zeros(1, 64, 2, 32)
    causal = True
    if bad == "head_dim":
        q, k = torch.zeros(1, 64, 4, 48), torch.zeros(1, 64, 2, 48)
        v = k
    elif bad == "groups":
        q = torch.zeros(1, 64, 3, 32)
    elif bad == "batch":
        k = v = torch.zeros(2, 64, 2, 32)
    elif bad == "dtype":        # fp16 is taken (the mma kernels): fp64
        q, k, v = (x.double() for x in (q, k, v))
    elif bad == "stride":
        q = torch.zeros(1, 64, 4, 64)[..., ::2]
    elif bad == "align":
        q = torch.zeros(64 * 4 * 32 + 1)[1:].view(1, 64, 4, 32)
    elif bad == "shape":
        v = torch.zeros(1, 64, 1, 32)
    with pytest.raises(ValueError):
        FA._check(q, k, v, causal)


@pytest.mark.parametrize("Sk,D", [(65, 32), (40, 32), (64, 16)])
def test_wrapper_takes_causal_unequal_lengths_and_head_dim_16(Sk, D):
    """Causal Sq != Sk (masked bottom-right) and head_dim 16 pass the
    CUDA wrapper's checks."""
    q = torch.zeros(1, 64, 4, D)
    k = torch.zeros(1, Sk, 2, D)
    FA._check(q, k, k, True)


def test_bias_or_dropout_routes_to_fma_and_wgmma_refuses_them():
    """A call with a bias or dropout runs the mma variant (the tensor
    cores, fp32 as three TF32 products) whatever its dtype and head_dim,
    and still takes the fma variant where a caller names it; naming
    wgmma for one raises ValueError (those kernels take neither), and so
    does naming mma for a call without either, as does a bias that
    requires a gradient (K1/K2 give it none) and dropout in training
    without a generator (the port keeps no global RNG)."""
    for dtype in (torch.float32, torch.bfloat16):
        for D in FA.HEAD_DIMS:
            assert FA._variant(dtype, D, extra=True) == "mma"
            assert FA._variant(dtype, D, "mma", extra=True) == "mma"
            assert FA._variant(dtype, D, "fma", extra=True) == "fma"
            with pytest.raises(ValueError, match="no mma kernel takes"):
                FA._variant(dtype, D, "mma")
    assert FA._variant(torch.bfloat16, 128) == "wgmma"
    with pytest.raises(ValueError, match="bias or dropout"):
        FA._variant(torch.bfloat16, 128, "wgmma", extra=True)
    q, k, v, _ = _t(*_qkvd(1, 8, 2, 2, 32))
    bias = torch.zeros(1, 1, 1, 8, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        FA.flash_attention_xla(q, k, v, attn_mask=bias)
    with pytest.raises(ValueError, match="generator"):
        FA.flash_attention_xla(q, k, v, dropout_p=0.1, training=True)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        FA.flash_mha(q, k, v, dropout=(1.0, 0, 0))


def test_dropout_outside_training_is_a_no_op():
    """training=False drops nothing (the JAX dispatch sets p to 0), and
    `scaled_dot_product_attention_raw` without a key ignores dropout as
    the JAX function does."""
    q, k, v, _ = _t(*_qkvd(1, 16, 2, 2, 32, seed=3))
    g = torch.Generator().manual_seed(0)
    want = FA.flash_attention_xla(q, k, v)
    got = FA.flash_attention_xla(q, k, v, dropout_p=0.5, training=False,
                                 generator=g)
    assert torch.equal(got, want)
    assert torch.equal(FA.scaled_dot_product_attention_raw(
        q, k, v, dropout_p=0.5), FA.scaled_dot_product_attention_raw(q, k, v))


def _bias_case(kind, B, S, H, rng):
    """An attention mask of each kind the JAX package takes: float
    biases of the three broadcast shapes (one a -1e9 padding bias, as
    ERNIE's), bool masks (True attends; key 0 always kept, so every
    row sees a key)."""
    if kind == "pad":                        # (B, 1, 1, Sk), -1e9
        keep = np.ones((B, S), np.float32)
        keep[-1, S - S // 4:] = 0
        return ((1.0 - keep) * -1e9).reshape(B, 1, 1, S)
    if kind == "float_qk":                   # (1, 1, Sq, Sk)
        return rng.normal(size=(1, 1, S, S)).astype(np.float32)
    if kind == "float_full":                 # (B, H, Sq, Sk)
        return rng.normal(size=(B, H, S, S)).astype(np.float32)
    shape = (1, 1, S, S) if kind == "bool_qk" else (B, H, S, S)
    m = rng.random(shape) < 0.7
    m[..., 0] = True
    return m


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("kind", ["pad", "float_qk", "float_full",
                                  "bool_qk", "bool_full"])
def test_bias_matches_jax_raw_forward_and_grads(kind, H, Hkv, causal):
    """flash_attention_xla with a mask (the plain K1/K2 on the CPU):
    O within 1e-5 of each row's max |reference| and dQ, dK, dV within
    1e-5 of max |reference|, against the JAX package's
    scaled_dot_product_attention_raw and jax.grad of it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.flash_attention import \
        scaled_dot_product_attention_raw as jsdpa
    B, S, D = 2, 40, 16
    q, k, v, do = _qkvd(B, S, H, Hkv, D, seed=11)
    mask = _bias_case(kind, B, S, H, np.random.default_rng(12))

    def f(q_, k_, v_):
        return jsdpa(q_, k_, v_, attn_mask=jnp.asarray(mask),
                     is_causal=causal)

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    got = FA.flash_attention_xla(tq, tk, tv, attn_mask=torch.from_numpy(
        mask), is_causal=causal)
    got.backward(torch.from_numpy(do))
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max(-1)
    assert (err <= 1e-5 * np.maximum(np.abs(want).max(-1), 1e-30)).all()
    for g, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(g.numpy(), np.asarray(ref))


def test_a_row_that_sees_no_key_is_nan_as_in_jax():
    """A bool mask that hides every key from one query row: O NaN there
    (the JAX function's softmax over nothing), lse -inf, the other rows
    as the JAX function gives them, and the backward finite, the dead
    row adding nothing."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops.flash_attention import \
        scaled_dot_product_attention_raw as jsdpa
    q, k, v, do = _qkvd(1, 16, 2, 2, 32, seed=13)
    m = np.ones((1, 1, 16, 16), bool)
    m[..., 5, :] = False
    want = np.asarray(jsdpa(*(jnp.asarray(x) for x in (q, k, v)),
                            attn_mask=jnp.asarray(m)))
    bias = FA._as_bias(torch.from_numpy(m), torch.zeros(1))
    o, lse = FA.flash_fwd_plain(*_t(q, k, v), False, bias=bias)
    assert np.isnan(want[:, 5]).all() and o[:, 5].isnan().all()
    assert torch.isneginf(lse[:, :, 5]).all()
    _close(np.delete(o.numpy(), 5, 1), np.delete(want, 5, 1))
    grads = FA.flash_bwd_plain(*_t(q, k, v), o, lse, torch.from_numpy(do),
                               False, bias=bias)
    assert all(g.isfinite().all() for g in grads)
    assert (grads[0][:, 5] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pad", [float(np.finfo(np.float32).min), -1e9])
def test_fully_padded_rows_get_the_uniform_softmax_as_in_jax(pad, causal):
    """A (B, 1, 1, Sk) padding bias that pads every key of batch 1 (a
    finite bias, so no row is dead): the JAX function adds it to the
    scores and its softmax is uniform over the padded keys.  The port
    through flash_attention_xla matches it: O within 1e-5 of each row's
    max |reference|, dQ, dK, dV within 1e-5 of max |reference|.  (With
    a max started at -1e30, finfo.min rows came out NaN; with lse kept
    as one fp32 number, the -1e9 rows' gradients came out Sk times too
    large.)"""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.flash_attention import \
        scaled_dot_product_attention_raw as jsdpa
    B, S, H, Hkv, D = 2, 40, 4, 2, 16
    q, k, v, do = _qkvd(B, S, H, Hkv, D, seed=17)
    keep = np.ones((B, S), np.float32)
    keep[0, S - S // 4:] = 0
    keep[1] = 0
    mask = np.where(keep > 0, 0.0, pad).astype(np.float32) \
        .reshape(B, 1, 1, S)

    def f(q_, k_, v_):
        return jsdpa(q_, k_, v_, attn_mask=jnp.asarray(mask),
                     is_causal=causal)

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp(jnp.asarray(do))
    want = np.asarray(want)
    assert np.isfinite(want).all()
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    got = FA.flash_attention_xla(tq, tk, tv, attn_mask=torch.from_numpy(
        mask), is_causal=causal)
    got.backward(torch.from_numpy(do))
    err = np.abs(got.detach().numpy() - want).max(-1)
    assert (err <= 1e-5 * np.maximum(np.abs(want).max(-1), 1e-30)).all()
    for g, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(g.numpy(), np.asarray(ref))


# ------------------------------------------------------ dropout and Philox


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_matches_random123_known_answers(counter, key, want):
    """philox4x32-10 against Random123's published known-answer vectors,
    on Python ints and on int64 tensors."""
    assert FA.philox4x32(*counter, *key) == want
    got = FA.philox4x32(*(torch.tensor([c]) for c in counter), *key)
    assert tuple(int(w) for w in got) == want


def test_dropout_keep_share_and_repeatability():
    """The keep mask at p 0.1 over 2 x 3 x 128 x 200 elements: the kept
    share within 5 sigma of 0.9; the same (seed, offset) twice gives the
    same bits, another offset or seed another mask; the layout's word
    (c // 16) % 4 of counter (16 (c // 64) + c % 16, i, b H + h, offset)."""
    B, H, Sq, Sk, p = 2, 3, 128, 200, 0.1
    keep = FA.dropout_keep(B, H, Sq, Sk, p, 2 ** 40 + 17, 5, "cpu")
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - p)) \
        <= 5 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(keep, FA.dropout_keep(B, H, Sq, Sk, p, 2 ** 40 + 17,
                                             5, "cpu"))
    assert not torch.equal(keep, FA.dropout_keep(B, H, Sq, Sk, p,
                                                 2 ** 40 + 17, 6, "cpu"))
    assert not torch.equal(keep, FA.dropout_keep(B, H, Sq, Sk, p, 17, 5,
                                                 "cpu"))
    seed, b, h, i, c = 2 ** 40 + 17, 1, 2, 77, 150
    words = FA.philox4x32(16 * (c // 64) + c % 16, i, b * H + h, 5,
                          seed & 0xFFFFFFFF, seed >> 32)
    assert bool(keep[b, h, i, c]) == (words[(c // 16) % 4]
                                      >= int(p * 2 ** 32))


def test_dropout_seed_is_drawn_on_the_host_and_advances():
    g = torch.Generator().manual_seed(3)
    first, second = FA.dropout_seed(g), FA.dropout_seed(g)
    assert first != second
    g.manual_seed(3)
    assert FA.dropout_seed(g) == first
    assert 0 <= first[0] < 2 ** 64 and 0 <= first[1] < 2 ** 32


@pytest.mark.parametrize("case", ["plain", "bias", "dropout",
                                  "seed_2_63"])
def test_flash_fwd_custom_op_passes_opcheck(case):
    """K1 is the operator `paddle_tpu_torch::flash_fwd` (one node of an
    exported program): `torch.library.opcheck` on the CPU (schema, fake
    kernel, autograd registration, AOT dispatch with dynamic shapes)
    without a bias or dropout, with a padding bias, with dropout, and
    with a 64-bit seed at or above 2^63, which crosses the operator's
    signed int64 arguments as two 32-bit words and keeps every bit: the
    operator's O and lse equal the plain version's with that seed, and
    lse's low part comes back (B, H, Sq) with a bias or dropout, empty
    without."""
    q, k, v, _ = _t(*_qkvd(2, 24, 4, 2, 16, seed=11))
    bias, drop = None, None
    if case == "bias":
        bias = torch.from_numpy(_bias_case("pad", 2, 24, 4, None))
    elif case == "dropout":
        drop = (0.2, 2 ** 33 + 9, 4)
    elif case == "seed_2_63":
        drop = (0.2, 2 ** 63 + 2 ** 40 + 3, 5)
    args = (q, k, v, False, 0.25, None, bias, *FA._seed_words(drop))
    torch.library.opcheck(torch.ops.paddle_tpu_torch.flash_fwd.default,
                          args)
    o, lse, lo = torch.ops.paddle_tpu_torch.flash_fwd(*args)
    po, plse = FA.flash_fwd_plain(q, k, v, False, 0.25, bias=bias,
                                  dropout=drop)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert lo.shape == ((0,) if case == "plain" else (2, 4, 24))
    if drop is not None:
        other = (drop[0], drop[1] ^ (1 << 63), drop[2])
        assert not torch.equal(o, FA.flash_fwd_plain(
            q, k, v, False, 0.25, dropout=other)[0])


def test_flash_fwd_takes_no_gradient():
    """`flash_fwd` (the operator, which has no autograd formula) refuses
    inputs that require a gradient under grad mode, where `flash_mha`
    takes them; with grad mode off, or detached, it runs."""
    q, k, v, _ = _t(*_qkvd(1, 8, 2, 2, 16, seed=12))
    qg = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="flash_mha"):
        FA.flash_fwd(qg, k, v)
    with torch.no_grad():
        o, _ = FA.flash_fwd(qg, k, v)
    assert not o.requires_grad and torch.equal(o, FA.flash_fwd(q, k, v)[0])
    FA.flash_mha(qg, k, v).sum().backward()
    assert qg.grad is not None


def _dropout_reference(q, k, v, keep, p, causal, bias):
    """O from an einsum written out with the given keep mask: softmax of
    the scaled scores plus the bias, then P * keep / (1 - p), then P.V
    (GQA by repeating the kv heads)."""
    B, Sq, H, D = q.shape
    rep = H // k.shape[2]
    kk, vv = (x.repeat_interleave(rep, 2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(D)
    if bias is not None:
        s = s + bias
    if causal:
        s = s.masked_fill(~torch.ones(Sq, k.shape[1], dtype=torch.bool)
                          .tril(k.shape[1] - Sq), -math.inf)
    pr = torch.where(keep, torch.softmax(s, -1) / (1 - p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", pr, vv)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,Hkv,masked", [(4, 4, False), (4, 2, True),
                                          (4, 4, True)])
def test_plain_dropout_matches_an_einsum_from_the_same_mask(H, Hkv, masked,
                                                            causal):
    """The plain K1/K2 with dropout (p 0.2) and a padding bias: O within
    1e-5 of max |reference| of an einsum written from `dropout_keep`'s
    mask, and dQ, dK, dV within 1e-5 of max |reference| of
    torch.autograd through that einsum; `flash_mha` on the CPU and the
    JAX-semantics function (`scaled_dot_product_attention_raw` with the
    same key) give the same O."""
    B, S, D, p = 2, 70, 32, 0.2
    q, k, v, do = _t(*_qkvd(B, S, H, Hkv, D, seed=21))
    bias = (torch.from_numpy(_bias_case("pad", B, S, H, None)) if masked
            else None)
    drop = (p, 987654321987, 42)
    keep = FA.dropout_keep(B, H, S, S, p, 987654321987, 42, "cpu")
    rq, rk, rv = (x.clone().requires_grad_() for x in (q, k, v))
    ref = _dropout_reference(rq, rk, rv, keep, p, causal, bias)
    ref.backward(do)
    o, lse = FA.flash_fwd_plain(q, k, v, causal, bias=bias, dropout=drop)
    _close(o.numpy(), ref.detach().numpy())
    grads = FA.flash_bwd_plain(q, k, v, o, lse, do, causal, bias=bias,
                               dropout=drop)
    for g, r in zip(grads, (rq.grad, rk.grad, rv.grad)):
        _close(g.numpy(), r.numpy())
    _close(FA.flash_mha(q, k, v, causal, bias=bias, dropout=drop).numpy(),
           ref.detach().numpy())
    raw = FA.scaled_dot_product_attention_raw(
        q, k, v, attn_mask=bias, dropout_p=p, is_causal=causal,
        dropout_key=drop[1:])
    _close(raw.numpy(), ref.detach().numpy())


def _per_row_share(got, want, tol):
    """max over the rows (b, s, head) of (B, S, H, D) tensors of
    max|got - want| / (tol * max|want|) over head_dim.  Rows that see
    no key (causal, Sq > Sk) must be NaN in both and count 0."""
    got, want = got.float().cpu(), want.float().cpu()
    blind = want.isnan()
    assert torch.equal(got.isnan(), blind)
    got, want = got.masked_fill(blind, 0.0), want.masked_fill(blind, 0.0)
    err = (got - want).abs().amax(-1)
    ref = want.abs().amax(-1).clamp_min(1e-30)
    return (err / (tol * ref)).max().item()


def _lse_ok(lse, plse):
    """lse per element within 1e-5 x max(1, |plain|); -inf (a row that
    sees no key) in both at the same places."""
    blind = plse.isinf()
    assert torch.equal(lse.isinf(), blind)
    lse, plse = lse.masked_fill(blind, 0.0), plse.masked_fill(blind, 0.0)
    return bool(((lse - plse).abs() <= 1e-5 * plse.abs().clamp_min(1.0))
                .all())


def _card_tol(dt):
    return 1e-5 if dt == torch.float32 else 2 ** -7


def _card_cases():
    return [  # B, S, H, Hkv, D, causal, dtype, Sk
        (2, 2048, 32, 8, 128, True, torch.bfloat16, None),
        (1, 300, 8, 2, 64, True, torch.float32, None),
        (2, 130, 4, 4, 32, False, torch.float32, 77),
        (1, 257, 8, 1, 128, True, torch.bfloat16, None),
        (1, 300, 8, 2, 128, False, torch.bfloat16, 77),
        (1, 100, 4, 2, 128, False, torch.bfloat16, 300),
        (1, 300, 8, 2, 64, True, torch.bfloat16, None),
        # causal Sq != Sk, masked bottom-right (Sq > Sk: blind rows)
        (1, 300, 8, 2, 128, True, torch.bfloat16, 512),
        (1, 512, 8, 2, 128, True, torch.bfloat16, 300),
        (1, 200, 4, 2, 64, True, torch.float32, 77),
        # head_dim 16 (the tiny presets)
        (2, 130, 4, 2, 16, True, torch.float32, None),
        (2, 130, 4, 2, 16, True, torch.bfloat16, 200),
    ]


@pytest.mark.gpu
def test_cuda_fwd_kernel_matches_plain_on_card():
    """K1 on the card against flash_fwd_plain: bf16 at the training
    shape, fp32 / bf16 at ragged S, GQA rep 1/4/8, head_dim
    16/32/64/128, causal and not, Sk != Sq; bf16 at head_dim 128 runs
    the wgmma kernel, the rest the CUDA-core one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for B, S, H, Hkv, D, causal, dt, Sk in _card_cases():
        q, k, v, _ = (torch.from_numpy(a).to("cuda", dt)
                      for a in _qkvd(B, S, H, Hkv, D, seed=S, Sk=Sk))
        before = FA.LAUNCHES["flash_attention_fwd"]
        o, lse = FA.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        assert FA.LAUNCHES["flash_attention_fwd"] == before + 1
        po, plse = FA.flash_fwd_plain(q, k, v, causal)
        assert _per_row_share(o, po, _card_tol(dt)) <= 1.0, (S, D, dt)
        assert _lse_ok(lse, plse), (S, D, dt)


@pytest.mark.gpu
def test_cuda_bwd_kernels_match_plain_on_card():
    """K2 (dQ kernel, dK/dV kernel) on the card against flash_bwd_plain
    on the same q, k, v, O, lse and dO."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for B, S, H, Hkv, D, causal, dt, Sk in _card_cases():
        q, k, v, do = (torch.from_numpy(a).to("cuda", dt)
                       for a in _qkvd(B, S, H, Hkv, D, seed=S, Sk=Sk))
        o, lse = FA.flash_fwd_plain(q, k, v, causal)
        before = dict(FA.LAUNCHES)
        dq, dk, dv = FA.flash_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        assert FA.LAUNCHES == {**before,
                               "flash_attention_dq": before[
                                   "flash_attention_dq"] + 1,
                               "flash_attention_dkv": before[
                                   "flash_attention_dkv"] + 1}
        for got, want in zip((dq, dk, dv),
                             FA.flash_bwd_plain(q, k, v, o, lse, do, causal)):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert _per_row_share(got, want, _card_tol(dt)) <= 1.0, \
                (S, D, dt)


@pytest.mark.gpu
def test_cuda_bwd_kernels_are_bitwise_repeatable_on_card():
    """K2 sums in a fixed order (no atomics): two calls on the same
    inputs give the same bits, for both variants on bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no CPU or interpret mode")
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                   for a in _qkvd(1, 640, 8, 2, 128, seed=7))
    o, lse = FA.flash_fwd_plain(q, k, v, True)
    for variant in ("wgmma", "fma"):
        first = (FA.flash_bwd_dq(q, k, v, o, lse, do, True, variant=variant),
                 *FA.flash_bwd_dkv(q, k, v, o, lse, do, True,
                                   variant=variant))
        again = (FA.flash_bwd_dq(q, k, v, o, lse, do, True, variant=variant),
                 *FA.flash_bwd_dkv(q, k, v, o, lse, do, True,
                                   variant=variant))
        for a, b in zip(first, again):
            assert torch.equal(a, b), variant


def _same_bits(a, b):
    """Bitwise equal, NaN included (the rows that see no key)."""
    return torch.equal(a.view(torch.int16 if a.element_size() == 2
                              else torch.int32),
                       b.view(torch.int16 if b.element_size() == 2
                              else torch.int32))


@pytest.mark.gpu
def test_cuda_bias_and_dropout_kernels_match_plain_on_card():
    """K1 and K2 with a bias and dropout, on the mma kernels (the route:
    the tensor cores, fp32 as three TF32 products) and on the fma kernels
    (the CUDA cores, named), against the plain versions given the same
    (seed, offset): the ERNIE-base attention (16 x 128, 12 heads of 64)
    with a -1e9 padding bias and p 0.1 in fp32 and bf16, a causal GQA
    case with a bool (1, 1, Sq, Sk) mask, head_dim 16; each kernel
    bitwise twice; one launch counted each, on its variant's count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1/K2 have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [  # B, S, H, Hkv, D, causal, dtype, mask kind
        (16, 128, 12, 12, 64, False, torch.float32, "pad"),
        (16, 128, 12, 12, 64, False, torch.bfloat16, "pad"),
        (2, 200, 8, 2, 64, True, torch.float32, "bool_qk"),
        (2, 130, 4, 2, 16, False, torch.float32, "float_full")]
    for (B, S, H, Hkv, D, causal, dt, kind), variant in itertools.product(
            cases, ("mma", "fma")):
        q, k, v, do = (torch.from_numpy(a).to("cuda", dt)
                       for a in _qkvd(B, S, H, Hkv, D, seed=S))
        mask = torch.from_numpy(_bias_case(kind, B, S, H,
                                           np.random.default_rng(S)))
        bias = FA._as_bias(mask.cuda(), q)
        drop = (0.1, 2 ** 33 + 5, 7)
        kw = dict(bias=bias, dropout=drop, variant=variant)
        before = dict(FA.VARIANT_LAUNCHES[variant])
        o, lse = FA.flash_fwd(q, k, v, causal, **kw)
        grads = (FA.flash_bwd_dq(q, k, v, o, lse, do, causal, **kw),
                 *FA.flash_bwd_dkv(q, k, v, o, lse, do, causal, **kw))
        torch.cuda.synchronize()
        assert FA.VARIANT_LAUNCHES[variant] == {n: before[n] + 1
                                                for n in before}
        po, plse = FA.flash_fwd_plain(q, k, v, causal, bias=bias,
                                      dropout=drop)
        assert _per_row_share(o, po, _card_tol(dt)) <= 1.0, \
            (S, D, dt, variant)
        assert _lse_ok(lse, plse), (S, D, dt, variant)
        plain = FA.flash_bwd_plain(q, k, v, o, lse, do, causal, bias=bias,
                                   dropout=drop)
        for got, want in zip(grads, plain):
            assert _per_row_share(got, want, _card_tol(dt)) <= 1.0, \
                (S, D, dt, variant)
        o2, _ = FA.flash_fwd(q, k, v, causal, **kw)
        dq2 = FA.flash_bwd_dq(q, k, v, o, lse, do, causal, **kw)
        assert _same_bits(o, o2) and _same_bits(grads[0], dq2)


@pytest.mark.gpu
def test_mask_on_the_card_launches_k1_k2_and_wgmma_refuses_a_bias():
    """On CUDA tensors a mask goes through K1/K2 on the mma kernels (the
    counters rise, each launch on the mma variant's count; the plain
    attention is not called); wgmma named with a bias raises, and so
    does a bias that requires a gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1/K2 have no CPU or interpret mode")
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                   .requires_grad_() for a in _qkvd(1, 256, 8, 2, 128))
    mask = torch.ones(1, 1, 256, 256, dtype=torch.bool, device="cuda")
    raw = FA.scaled_dot_product_attention_raw
    FA.scaled_dot_product_attention_raw = None       # must not be called
    try:
        before = dict(FA.LAUNCHES)
        by_variant = {n: dict(c) for n, c in FA.VARIANT_LAUNCHES.items()}
        FA.flash_attention_xla(q, k, v, attn_mask=mask,
                               is_causal=True).backward(do.detach())
        torch.cuda.synchronize()
    finally:
        FA.scaled_dot_product_attention_raw = raw
    assert FA.LAUNCHES == {n: before[n] + 1 for n in before}
    assert FA.VARIANT_LAUNCHES == {
        variant: {n: c + (variant == "mma") for n, c in counts.items()}
        for variant, counts in by_variant.items()}
    bias = FA._as_bias(mask, q)
    with pytest.raises(ValueError, match="bias or dropout"):
        FA.flash_fwd(q.detach(), k.detach(), v.detach(), True,
                     variant="wgmma", bias=bias)
    with pytest.raises(ValueError, match="no gradient"):
        FA.flash_attention_xla(q, k, v, attn_mask=torch.zeros(
            1, 1, 1, 256, device="cuda", requires_grad=True))


@pytest.mark.gpu
def test_exported_ernie_runs_k1_on_the_card(tmp_path):
    """The tiny ERNIE (2 layers, head_dim 16) saved by `jit.save` on the
    card and run by the predictor there: K1 is one `flash_fwd` node a
    layer, tracing launches nothing, a run with a padding mask launches
    K1 once a layer on the mma kernels (no K2), and the logits equal the
    eager model's on the card (per row within 1e-5 x max(1, max |row|));
    the same weights saved on the CPU run on the card through the
    predictor (the program moved), K1 launching there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU or interpret mode")
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ErnieConfig.from_preset("tiny")
    model = ErnieForSequenceClassification(cfg, device="cuda", seed=0).eval()

    class Positional(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, ids, mask):
            return self.m(ids, attention_mask=mask)

    path = str(tmp_path / "ernie")
    before = dict(FA.LAUNCHES)
    program = jit.api.export(Positional(), [jit.InputSpec([None, 32],
                                                          "int64")] * 2)
    assert sum("flash_fwd" in str(n.target)
               for n in program.graph.nodes) == cfg.num_hidden_layers
    jit.save(Positional(), path, input_spec=[jit.InputSpec([None, 32],
                                                           "int64")] * 2)
    assert FA.LAUNCHES == before
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.vocab_size, (3, 32))
    mask = np.ones((3, 32), np.int64)
    mask[1, 20:] = 0
    pred = create_predictor(Config(path))
    mma = dict(FA.VARIANT_LAUNCHES["mma"])
    got = pred.run([ids, mask])[0]
    assert FA.VARIANT_LAUNCHES["mma"] == {
        **mma, "flash_attention_fwd": mma["flash_attention_fwd"]
        + cfg.num_hidden_layers}
    with torch.no_grad():
        want = Positional()(torch.from_numpy(ids).cuda(),
                            torch.from_numpy(mask).cuda()).cpu().numpy()
    lim = 1e-5 * np.maximum(1.0, np.abs(want).max(-1))
    assert (np.abs(got - want).max(-1) <= lim).all()
    # the same weights saved on the CPU: the predictor moves the program
    # to the card, where K1 launches
    host = ErnieForSequenceClassification(cfg, device="cpu").eval()
    host.load_state_dict({n: t.cpu() for n, t in model.state_dict().items()})
    model = host
    jit.save(Positional(), str(tmp_path / "host"),
             input_spec=[jit.InputSpec([None, 32], "int64")] * 2)
    moved = create_predictor(Config(str(tmp_path / "host")))
    mma = dict(FA.VARIANT_LAUNCHES["mma"])
    got = moved.run([ids, mask])[0]
    assert FA.VARIANT_LAUNCHES["mma"]["flash_attention_fwd"] \
        == mma["flash_attention_fwd"] + cfg.num_hidden_layers
    assert (np.abs(got - want).max(-1) <= lim).all()
    # loaded by path alone, the CPU-saved program runs on the card too
    from paddle_tpu_torch.inference.serving import standalone_load
    alone = standalone_load(str(tmp_path / "host"))
    assert alone.device.type == "cuda"
    mma = dict(FA.VARIANT_LAUNCHES["mma"])
    got = alone.run(ids, mask)
    assert FA.VARIANT_LAUNCHES["mma"]["flash_attention_fwd"] \
        == mma["flash_attention_fwd"] + cfg.num_hidden_layers
    assert (np.abs(got - want).max(-1) <= lim).all()
