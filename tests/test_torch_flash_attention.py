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
    """A mask takes `scaled_dot_product_attention_raw` on the CPU, as in
    the JAX package (bool masks select, float masks add)."""
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
    """bf16 at head_dim 128 runs the wgmma kernels; fp32 (TF32 would
    fail its 1e-5 limit) and head_dim 16 / 32 / 64 the CUDA-core
    kernels."""
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
    elif bad == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
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


def test_mask_and_dropout_raise_off_the_cpu():
    """Off the CPU (a meta tensor stands in for the card here) a mask
    raises: K1/K2 take none; dropout in training raises everywhere, and
    so does dropout in `scaled_dot_product_attention_raw`."""
    q = torch.zeros(1, 8, 2, 32, device="meta")
    mask = torch.ones(8, 8, dtype=torch.bool, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FA.flash_attention_xla(q, q, q, attn_mask=mask, is_causal=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FA.flash_attention_xla(*_t(*_qkvd(1, 8, 2, 2, 32)[:3]),
                               dropout_p=0.1, training=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FA.scaled_dot_product_attention_raw(*_t(*_qkvd(1, 8, 2, 2, 32)[:3]),
                                            dropout_p=0.1)


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
