"""The ERNIE encoder of the PyTorch port (paddle_tpu_torch/models/ernie.py,
nn/functional.py, nn/layer/) against the JAX package's
(paddle_tpu/models/ernie.py), weights crossed by name and value
(`load_reference_arrays`), token ids and masks made with numpy from a
seed.  Presets: `tiny` (hidden 64, 4 heads of head_dim 16, 2 layers) and
"d64" (tiny with hidden 128, 2 heads of head_dim 64, FFN 256: the base
preset's head_dim), both fp32; the attention runs the plain versions
of K1/K2 on the CPU.

Tolerances (fp32 sums in another order through two post-LN layers):
hidden states, pooled output and logits within 1e-5 x max(1, max
|reference|); the loss within 1e-5 relative; every parameter's
gradient within 1e-4 of that gradient's max |reference|, but the key
projection's bias, whose gradient is 0 in exact arithmetic (softmax
does not move when one constant is added to a row's scores): there both
packages' rounding noise within 1e-5 of the layer's query-bias
gradient; three AdamW TrainSteps at `bench_ernie`'s lr: each loss
within 1e-6 relative, every parameter element within 5e-2 x the summed
lr (Adam scales each element's step to ~lr, so an element with a small
gradient carries its relative rounding into its step), the key biases
within 2 x the summed lr (AdamW moves an element whose gradient is
rounding noise by less than lr a step, either way).  The JAX package's
own functions (`dropout` aside: its bits come from `jax.random`) within
1e-6 of max |reference|."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (ErnieConfig, ErnieForMaskedLM,
                                     ErnieForSequenceClassification,
                                     ErnieModel, load_reference_arrays)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layer import Dropout
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.optimizer import AdamW

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
PRESETS = {"tiny": ("tiny", {}),
           "d64": ("tiny", dict(hidden_size=128, num_attention_heads=2,
                                intermediate_size=256))}
B, S = 2, 24
LR = 2e-5                 # bench_ernie's AdamW


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(pkg_config, preset, **kw):
    base, over = PRESETS[preset]
    return pkg_config.from_preset(base, **{**NO_DROPOUT, **over, **kw})


def _models(preset, head="cls", seed=0):
    """(JAX model, port model on the CPU) with the JAX weights."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import ernie as J
    paddle.seed(seed)
    jcfg, tcfg = _config(J.ErnieConfig, preset), _config(ErnieConfig, preset)
    if head == "cls":
        jm = J.ErnieForSequenceClassification(jcfg, num_classes=2)
        tm = ErnieForSequenceClassification(tcfg, num_classes=2,
                                            device="cpu")
    elif head == "mlm":
        jm, tm = J.ErnieForMaskedLM(jcfg), ErnieForMaskedLM(tcfg,
                                                            device="cpu")
    else:
        jm, tm = J.ErnieModel(jcfg), ErnieModel(tcfg, device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _batch(cfg, masked, seed=1):
    """ids (B, S), token types, labels (B,) and a 1 / 0 padding mask
    (row 1's last 8 positions padded) or None."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    types = rng.integers(0, cfg.type_vocab_size, (B, S))
    labels = rng.integers(0, 2, (B,))
    mask = None
    if masked:
        mask = np.ones((B, S), np.int64)
        mask[1, S - 8:] = 0
    return ids, types, labels, mask


def _jt(x):
    import paddle_tpu as paddle
    return None if x is None else paddle.to_tensor(x)


def _tt(x):
    return None if x is None else torch.from_numpy(x)


def _close(got, want, tol=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def test_parameter_names_are_the_jax_models():
    for head in ("cls", "mlm", "model"):
        jm, tm = _models("tiny", head)
        assert [n for n, _ in tm.named_parameters()] == \
            [n for n, _ in jm.named_parameters()]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("preset", ["tiny", "d64"])
def test_encoder_hidden_and_pooled_match_jax(preset, masked):
    jm, tm = _models(preset, "model")
    ids, types, _, mask = _batch(tm.config, masked)
    jh, jp = jm(_jt(ids), token_type_ids=_jt(types),
                attention_mask=_jt(mask))
    th, tp = tm(_tt(ids), token_type_ids=_tt(types),
                attention_mask=_tt(mask))
    _close(th.detach().numpy(), np.asarray(jh._data))
    _close(tp.detach().numpy(), np.asarray(jp._data))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("head", ["cls", "mlm"])
@pytest.mark.parametrize("preset", ["tiny", "d64"])
def test_classifier_and_mlm_logits_match_jax(preset, head, masked):
    jm, tm = _models(preset, head)
    ids, _, _, mask = _batch(tm.config, masked)
    want = np.asarray(jm(_jt(ids), attention_mask=_jt(mask))._data)
    got = tm(_tt(ids), attention_mask=_tt(mask)).detach().numpy()
    assert got.shape == want.shape
    _close(got, want)


def _jax_loss_and_grads(jm, ids, labels, mask):
    """The JAX model's cross-entropy loss and every gradient, taken the
    way its TrainStep takes them (bound parameter arrays, jax.grad)."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core.tensor import Tensor, no_grad
    from paddle_tpu.jit.trainer import bind_state, collect_state
    params, _, _ = collect_state(jm)

    def f(p):
        with bind_state(params, p), no_grad():
            logits = jm(Tensor(jnp.asarray(ids)), attention_mask=_jt(mask))
            return JF.cross_entropy(logits, Tensor(jnp.asarray(labels)))._data

    loss, grads = jax.value_and_grad(f)({k: t._data
                                         for k, t in params.items()})
    return float(loss), {k: np.asarray(g, np.float32)
                         for k, g in grads.items()}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("preset", ["tiny", "d64"])
def test_loss_and_every_grad_match_jax(preset, masked):
    jm, tm = _models(preset)
    ids, _, labels, mask = _batch(tm.config, masked)
    jl, jg = _jax_loss_and_grads(jm, ids, labels, mask)
    loss = TF.cross_entropy(tm(_tt(ids), attention_mask=_tt(mask)),
                            _tt(labels))
    loss.backward()
    assert abs(loss.item() - jl) <= 1e-5 * abs(jl)
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert sorted(tg) == sorted(jg)
    for n in jg:
        err = np.abs(tg[n] - jg[n]).max()
        if n.endswith("k_proj.bias"):       # 0 in exact arithmetic
            ref = np.abs(jg[n.replace("k_proj", "q_proj")]).max()
            assert max(np.abs(tg[n]).max(), np.abs(jg[n]).max()) \
                <= 1e-5 * ref, n
        else:
            assert err <= 1e-4 * np.abs(jg[n]).max(), (n, err)


def _train(pkg, model, batch, steps):
    """`steps` TrainSteps of AdamW(lr LR, weight decay 0.01) on the
    cross-entropy of the classifier; returns (losses, {name: param})."""
    ids, _, labels, mask = batch
    if pkg == "jax":
        import paddle_tpu.nn.functional as JF
        import paddle_tpu.optimizer as jopt
        from paddle_tpu.jit.trainer import TrainStep as JStep
        opt = jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                         parameters=model.parameters())
        step = JStep(model, lambda m, x, y, *am: JF.cross_entropy(
            m(x, attention_mask=am[0] if am else None), y), opt)
        args = [_jt(ids), _jt(labels)] + ([_jt(mask)] if mask is not None
                                          else [])
    else:
        opt = AdamW(learning_rate=LR, weight_decay=0.01,
                    parameters=model.parameters())
        step = TrainStep(model, lambda m, x, y, *am: TF.cross_entropy(
            m(x, attention_mask=am[0] if am else None), y), opt)
        args = [ids, labels] + ([mask] if mask is not None else [])
    losses = []
    for _ in range(steps):
        out = step(*args)
        losses.append(float(np.asarray(out._data if pkg == "jax" else out)))
    if pkg == "jax":
        params = {k: np.asarray(v, np.float32)
                  for k, v in step.params.items()}
    else:
        params = {k: v.detach().numpy() for k, v in step.params.items()}
    return losses, params


@pytest.mark.parametrize("preset,masked", [("tiny", False), ("tiny", True),
                                           ("d64", True)])
def test_three_adamw_steps_match_jax_train_step(preset, masked):
    jm, tm = _models(preset)
    batch = _batch(tm.config, masked)
    jl, jp = _train("jax", jm, batch, 3)
    tl, tp = _train("torch", tm, batch, 3)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-6 * abs(b), (tl, jl)
    assert tl[-1] < tl[0]
    assert sorted(tp) == sorted(jp)
    for n in jp:
        limit = (2.0 if n.endswith("k_proj.bias") else 5e-2) * 3 * LR
        assert np.abs(tp[n] - jp[n]).max() <= limit, n


# ---------------------------------------------------------------- dropout


def _dropout_model(seed):
    cfg = ErnieConfig.from_preset("tiny")          # dropout 0.1 / 0.1
    return ErnieForSequenceClassification(cfg, device="cpu", seed=seed)


def _steps(model, batch, n=2):
    ids, _, labels, mask = batch
    step = TrainStep(model, lambda m, x, y, am: TF.cross_entropy(
        m(x, attention_mask=am), y), AdamW(learning_rate=LR,
                                           parameters=model.parameters()))
    return [step(ids, labels, mask) for _ in range(n)]


def test_dropout_training_is_bitwise_repeatable_from_the_seed():
    """Hidden and attention dropout on (0.1 / 0.1): two models from the
    same seed take the same two steps bit for bit; another seed takes
    others."""
    batch = _batch(ErnieConfig.from_preset("tiny"), True)
    a, b, c = _dropout_model(3), _dropout_model(3), _dropout_model(4)
    la, lb, lc = _steps(a, batch), _steps(b, batch), _steps(c, batch)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(la[1], lc[1])


def test_dropout_draws_from_the_model_generator():
    """The same generator state gives the same training loss; the next
    draw another one.  Eval mode drops nothing: its logits equal those
    of the same weights built without dropout, bitwise."""
    ids, _, labels, mask = _batch(ErnieConfig.from_preset("tiny"), True)
    m = _dropout_model(5)
    state = m.ernie.generator.get_state()

    def loss():
        return TF.cross_entropy(m(_tt(ids), attention_mask=_tt(mask)),
                                _tt(labels))
    first, second = loss(), loss()
    m.ernie.generator.set_state(state)
    assert torch.equal(loss(), first) and not torch.equal(first, second)
    m.eval()
    plain = ErnieForSequenceClassification(
        ErnieConfig.from_preset("tiny", **NO_DROPOUT), device="cpu")
    plain.load_state_dict(m.state_dict())
    with torch.no_grad():
        assert torch.equal(m(_tt(ids), attention_mask=_tt(mask)),
                           plain(_tt(ids), attention_mask=_tt(mask)))


def test_hidden_dropout_zeroes_a_share_near_p():
    """functional.dropout at p 0.1 on 2^16 elements: the zeroed share
    within 5 sigma of p, the kept ones scaled by 1 / (1 - p); and the
    embeddings' Dropout inside the model zeroes the same share of its
    input."""
    n, p = 1 << 16, 0.1
    g = torch.Generator().manual_seed(0)
    x = torch.ones(n)
    y = TF.dropout(x, p, training=True, generator=g)
    share = (y == 0).float().mean().item()
    assert abs(share - p) <= 5 * (p * (1 - p) / n) ** 0.5
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / (1 - p)))
    m = _dropout_model(6)
    seen = {}
    m.ernie.embeddings.dropout.register_forward_hook(
        lambda mod, inp, out: seen.update(x=inp[0], y=out))
    ids = np.random.default_rng(0).integers(0, 256, (8, 128))
    m(_tt(ids))
    kept = seen["y"] != 0
    share = 1.0 - kept.float().mean().item()
    assert abs(share - 0.1) <= 5 * (0.09 / kept.numel()) ** 0.5
    torch.testing.assert_close(seen["y"][kept], seen["x"][kept] / 0.9)


def test_dropout_without_a_generator_raises_in_training():
    with pytest.raises(ValueError, match="generator"):
        TF.dropout(torch.ones(4), 0.5, training=True)
    assert torch.equal(Dropout(0.5).eval()(torch.ones(4)), torch.ones(4))


# --------------------------------------------------- functions vs the JAX's


@pytest.mark.parametrize("fn", ["layer_norm", "gelu", "cross_entropy",
                                "cross_entropy_ignore"])
def test_functions_match_jax(fn):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.ops.activation import gelu as jgelu
    rng = np.random.default_rng(7)
    x = (3 * rng.normal(size=(6, 40))).astype(np.float32)
    if fn == "layer_norm":
        w = rng.normal(size=(40,)).astype(np.float32)
        b = rng.normal(size=(40,)).astype(np.float32)
        want = JF.layer_norm(Tensor(jnp.asarray(x)), 40, Tensor(jnp.asarray(
            w)), Tensor(jnp.asarray(b)), 1e-12)
        got = TF.layer_norm(_tt(x), 40, _tt(w), _tt(b), 1e-12)
    elif fn == "gelu":
        want, got = jgelu(Tensor(jnp.asarray(x))), TF.gelu(_tt(x))
    else:
        lab = rng.integers(0, 40, (6,))
        if fn == "cross_entropy_ignore":
            lab[[1, 4]] = -100
        want = JF.cross_entropy(Tensor(jnp.asarray(x)),
                                Tensor(jnp.asarray(lab)))
        got = TF.cross_entropy(_tt(x), _tt(lab))
    _close(got.numpy(), np.asarray(want._data), 1e-6)


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieForSequenceClassification(ErnieConfig.from_preset("tiny"))
    m = ErnieForMaskedLM(ErnieConfig.from_preset("tiny"), device="cpu")
    assert m.device.type == "cpu"


# ---------------------------------------------------------------- the card


@pytest.mark.gpu
def test_tiny_on_the_card_matches_the_cpu_and_launches_k1_k2():
    """`tiny` on the card at dropout 0 against the same weights on the
    CPU: the classifier logits within 1e-5 x max(1, max |cpu|) with a
    padding mask; the mask runs K1 (one launch a layer) and K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1/K2 have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ErnieConfig.from_preset("tiny", **NO_DROPOUT)
    cpu = ErnieForSequenceClassification(cfg, device="cpu")
    card = ErnieForSequenceClassification(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    ids, _, labels, mask = _batch(cfg, True)
    before = dict(FA.LAUNCHES)
    got = card(_tt(ids).cuda(), attention_mask=_tt(mask).cuda())
    TF.cross_entropy(got, _tt(labels).cuda()).backward()
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    assert FA.LAUNCHES == {k: before[k] + L for k in before}
    _close(got.detach().cpu().numpy(),
           cpu(_tt(ids), attention_mask=_tt(mask)).detach().numpy())
