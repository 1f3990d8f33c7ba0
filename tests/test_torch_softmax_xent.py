"""Kernels K3f / K3b of the PyTorch port (paddle_tpu_torch/ops/softmax_xent.py)
and the causal-LM loss built on them (models/llama.py): the plain
versions against the JAX package's loss formula `_causal_lm_loss_raw`
and its `jax.grad` — the CPU path of the JAX package, since its Pallas
CE kernel has no interpret mode (tests/test_pallas_ce.py does the same)
— the ignored-row contract, the wrapper's checks, and on the card only
the CUDA kernels against the plain versions.

Tolerances: loss within 1e-5 relative (fp32 sums in another order; bf16
logits are widened to fp32 by both packages first); gradients within
1e-6 of max |reference| in fp32, and within 2^-8 of it in bf16 (both
round the fp32 gradient to bf16 once).  On the card: loss and lse
within 1e-5 x max(1, |lse|), dlogits per element within 2^-7 (bf16: one
ulp) / 1e-6 (fp32) of |plain|."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.llama import _causal_lm_loss_raw
from paddle_tpu_torch.ops import softmax_xent as SX


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(B, S, V, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(B, S, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S))
    labels[0, 1] = V - 1                 # the last vocab column
    return logits, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [256, 1000, 333])
def test_causal_loss_and_grad_match_jax(V, dtype):
    """V = 1000 and 333 are not multiples of 128 (the JAX kernel's lane
    tile), which the port's kernel does not need."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.models.llama import _causal_lm_loss_raw as jloss
    logits, labels = _case(2, 9, V, seed=V)
    jl = jnp.asarray(logits).astype(dtype)
    want, jg = jax.value_and_grad(
        lambda x: jloss.raw(x, jnp.asarray(labels)))(jl)
    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    got = _causal_lm_loss_raw(x, torch.from_numpy(labels))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    g, jg = x.grad.float().numpy(), np.asarray(jg.astype(jnp.float32))
    assert x.grad.dtype == x.dtype and g.shape == jg.shape
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    assert np.abs(g - jg).max() <= tol * np.abs(jg).max()
    assert not g[:, -1].any()          # the last position predicts nothing


def test_rows_match_formula_and_ignore_negative_labels():
    logits, labels = _case(1, 6, 50, seed=1)
    labels[0, 2] = -1
    x = torch.from_numpy(logits[0])
    lab = torch.from_numpy(labels[0]).to(torch.int32)
    loss, lse = SX.softmax_xent_plain(x, lab)
    want = torch.logsumexp(x, -1) - x[torch.arange(6), lab.clamp_min(0).long()]
    keep = lab >= 0
    torch.testing.assert_close(loss[keep], want[keep], rtol=1e-6, atol=0)
    assert loss[2].item() == 0.0 and lse[2].item() == 0.0
    g = torch.rand(6)
    d = SX.softmax_xent_bwd_plain(x, lab, lse, g)
    assert not d[2].any()
    p = torch.softmax(x, -1)
    p[torch.arange(6), lab.clamp_min(0).long()] -= 1
    torch.testing.assert_close(d[keep], (p * g[:, None])[keep], rtol=0,
                               atol=1e-6)


def test_cpu_calls_run_plain_and_count_no_launch():
    logits, labels = _case(2, 5, 64, seed=2)
    x = torch.from_numpy(logits).requires_grad_()
    lab = torch.from_numpy(labels).to(torch.int32)
    before = dict(SX.LAUNCHES)
    SX.softmax_xent(x, lab).sum().backward()
    assert SX.LAUNCHES == before


@pytest.mark.parametrize("bad", ["labels", "dtype", "rows"])
def test_wrapper_checks_raise(bad):
    x = torch.zeros(2, 5, 64)
    lab = torch.zeros(2, 5, dtype=torch.int32)
    if bad == "labels":
        lab = torch.zeros(2, 4, dtype=torch.int32)
    elif bad == "dtype":
        x = x.half()
    elif bad == "rows":
        x = x[:, :-1]                   # (2, 4, 64) with row stride 5 * 64
        lab = lab[:, :-1]
    with pytest.raises(ValueError):
        SX._rows(x, lab)


def test_label_past_the_vocabulary_matches_jax():
    """A label >= V: the row's loss is NaN and its gradient has no
    one-hot term, as in the JAX package's formula (its gather fills NaN
    past the vocabulary); the other rows are untouched."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.models.llama import _causal_lm_loss_raw as jloss
    logits, labels = _case(1, 6, 40, seed=7)
    labels[0, 3] = 40
    want, jg = jax.value_and_grad(
        lambda x: jloss.raw(x, jnp.asarray(labels)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = _causal_lm_loss_raw(x, torch.from_numpy(labels))
    got.backward()
    assert np.isnan(float(want)) and np.isnan(got.item())
    g, jg = x.grad.numpy(), np.asarray(jg)
    assert np.abs(g - jg).max() <= 1e-6 * np.abs(jg).max()
    row = torch.from_numpy(logits[0, 2])       # predicts labels[0, 3]
    torch.testing.assert_close(x.grad[0, 2], torch.softmax(row, -1) / 5,
                               rtol=1e-6, atol=0)


def _elt_share(got, want, tol):
    """max over elements of |got - want| / (tol * |want|)."""
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs()
            / (tol * want.abs().clamp_min(1e-30))).max().item()


def _card_inputs(B, S, V, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (3 * torch.randn(B, S, V, device="cuda", generator=g)).to(dtype)
    lab = torch.randint(0, V, (B, S), device="cuda", generator=g,
                        dtype=torch.int32)
    lab[:, -1] = -1
    return x, lab


_CARD = [(2, 2048, 128256, torch.bfloat16), (3, 17, 1003, torch.bfloat16),
         (2, 33, 1000, torch.float32), (1, 5, 999, torch.float32)]


@pytest.mark.gpu
def test_cuda_label_past_the_vocabulary_matches_plain_on_card():
    """A label >= V on the card: NaN loss on that row only, and dlogits
    without a one-hot term, as the plain versions give."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU or interpret mode")
    for dt in (torch.float32, torch.bfloat16):
        x, lab = _card_inputs(2, 9, 1000, dt, seed=11)
        lab[1, 4] = 1000
        loss, lse = SX.softmax_xent_fwd(x, lab)
        ploss, plse = SX.softmax_xent_plain(x, lab)
        assert torch.equal(loss.isnan(), ploss.isnan())
        assert loss.isnan().sum().item() == 1 and loss[1, 4].isnan()
        g = torch.full(lab.shape, 1.0 / lab.numel(), device="cuda")
        d = SX.softmax_xent_bwd(x, lab, plse, g)
        want = SX.softmax_xent_bwd_plain(x, lab, plse, g)
        tol = 1e-6 if dt == torch.float32 else 2 ** -7
        assert _elt_share(d[:, :-1], want[:, :-1], tol) <= 1.0
        assert (d[1, 4] >= 0).all()              # no one-hot term


@pytest.mark.gpu
def test_cuda_fwd_kernel_matches_plain_on_card():
    """K3f on the card: the Llama-3-8B training shape in bf16, and V not
    a multiple of the 16-byte vector (scalar path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU or interpret mode")
    for B, S, V, dt in _CARD:
        x, lab = _card_inputs(B, S, V, dt, seed=V)
        before = SX.LAUNCHES["softmax_xent_fwd"]
        loss, lse = SX.softmax_xent_fwd(x, lab)
        torch.cuda.synchronize()
        assert SX.LAUNCHES["softmax_xent_fwd"] == before + 1
        ploss, plse = SX.softmax_xent_plain(x, lab)
        lim = 1e-5 * plse.abs().clamp_min(1.0)
        assert ((loss - ploss).abs() <= lim).all(), (B, S, V, dt)
        assert ((lse - plse).abs() <= lim).all(), (B, S, V, dt)


@pytest.mark.gpu
def test_cuda_bwd_kernel_matches_plain_on_card():
    """K3b on the card against softmax_xent_bwd_plain (ignored rows
    zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU or interpret mode")
    for B, S, V, dt in _CARD:
        x, lab = _card_inputs(B, S, V, dt, seed=V + 1)
        _, lse = SX.softmax_xent_plain(x, lab)
        g = torch.full(lab.shape, 1.0 / lab.numel(), device="cuda")
        before = SX.LAUNCHES["softmax_xent_bwd"]
        d = SX.softmax_xent_bwd(x, lab, lse, g)
        torch.cuda.synchronize()
        assert SX.LAUNCHES["softmax_xent_bwd"] == before + 1
        want = SX.softmax_xent_bwd_plain(x, lab, lse, g)
        assert d.dtype == want.dtype and d.shape == want.shape
        assert not d[:, -1].any()
        tol = 1e-6 if dt == torch.float32 else 2 ** -7
        assert _elt_share(d[:, :-1], want[:, :-1], tol) <= 1.0
