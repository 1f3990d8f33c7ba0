"""AMP in the PyTorch port (paddle_tpu_torch/amp/: `auto_cast` O1 / O2 and
its per-op policy `autocast_args`, `decorate`, `GradScaler`) against the
JAX package's (paddle_tpu/amp/, the dispatcher's `_maybe_autocast`), on
the CPU, where K1/K2 run their plain versions.  Inputs are made with
numpy from a seed; weights cross by name and value.

Tolerances, each with its reason:
* every entry point's output dtype equal to the JAX op's, exactly;
* ERNIE `tiny` under O1 (dropout 0), against the JAX model under the
  same auto_cast: logits within 4e-3 (fp16, 8 ulps of 2^-11) / 2e-2
  (bf16, 5 ulps of 2^-8) x max(1, max |JAX|), every gradient within 2e-2
  (fp16) / 1e-1 (bf16) of its max |JAX| (the key bias's, 0 in exact
  arithmetic, skipped); measured on this batch: 1.2e-3 / 4.6e-3 for the
  logits, 7.1e-3 / 4.2e-2 for the gradients.  Both round
  every Linear's output to the amp dtype, but the sums run in another
  order and JAX computes the attention's P.V with P rounded to the amp
  dtype where the port keeps it in fp32: each of those roundings is up
  to one ulp of the amp dtype (2^-11 fp16, 2^-8 bf16) of a value, and two
  post-LN layers, a pooler and a classifier carry them to the logits;
  the gradients run the same chain backwards;
* `GradScaler`: scale and counters exactly equal to JAX's after every
  step, the SGD parameters within 1e-6 of max |JAX| (fp32, the same
  update written twice) up to the first finite step the caller
  unscaled (the JAX scaler divides those gradients twice), and within
  1e-6 of the max of a numpy reckoning of the single division after
  every step;
* the O2 training step bitwise the same rule applied to copies (the
  fused update's plain version is bitwise the op-by-op rule on the
  CPU).
The gpu-marked test holds the fp16 mma kernels K1 / dQ / dK/dV to their
plain versions within one fp16 ulp of each row's max (2^-10), as the
bf16 limit is one bf16 ulp."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (ErnieConfig,
                                     ErnieForSequenceClassification,
                                     load_reference_arrays)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layer import Linear
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.optimizer import SGD, AdamW

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 2, 16
MODES = {
    "O1_fp16": dict(dtype="float16"),
    "O1_bf16": dict(dtype="bfloat16"),
    "custom": dict(dtype="float16", custom_white_list={"layer_norm_op"},
                   custom_black_list={"linear_op", "flash_attention_op"}),
    "disabled": dict(enable=False, dtype="float16"),
    "O2": dict(level="O2", dtype="bfloat16"),
}
OPS = ("linear", "flash_attention", "layer_norm", "cross_entropy", "conv2d",
       "dropout", "gelu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_amp_exports():
    pytest.importorskip("jax")
    import paddle_tpu.amp as JA
    for name in ("auto_cast", "amp_guard", "decorate", "GradScaler",
                 "WHITE_LIST", "BLACK_LIST", "amp_state"):
        assert name in amp.__all__ and hasattr(amp, name)
    assert amp.WHITE_LIST == JA.WHITE_LIST and amp.BLACK_LIST == JA.BLACK_LIST
    assert amp.amp_guard is amp.auto_cast
    st = amp.amp_state()
    assert not st.enabled and st.level == "O1" and st.dtype == torch.bfloat16


def _inputs(op, low):
    """numpy inputs of one entry point in fp32 (its weights too); `low`
    names the dtype they are given in (the mask and labels excepted)."""
    rng = np.random.RandomState(OPS.index(op))
    f = np.float32
    if op == "linear":
        return dict(x=rng.randn(3, 8).astype(f), w=rng.randn(8, 5).astype(f),
                    b=rng.randn(5).astype(f))
    if op == "flash_attention":
        mask = np.zeros((B, 1, 1, S), f)
        mask[-1, ..., S - 4:] = -1e9
        return dict(q=rng.randn(B, S, 2, 16).astype(f),
                    k=rng.randn(B, S, 2, 16).astype(f),
                    v=rng.randn(B, S, 2, 16).astype(f), mask=mask)
    if op == "layer_norm":
        return dict(x=rng.randn(3, 8).astype(f), w=rng.rand(8).astype(f),
                    b=rng.randn(8).astype(f))
    if op == "cross_entropy":
        return dict(x=rng.randn(4, 6).astype(f),
                    y=rng.randint(0, 6, (4,)))
    if op == "conv2d":
        return dict(x=rng.randn(2, 3, 6, 6).astype(f),
                    w=rng.randn(4, 3, 3, 3).astype(f),
                    b=rng.randn(4).astype(f))
    return dict(x=rng.randn(3, 8).astype(f))


_FLOAT_KEYS = ("x", "w", "b", "q", "k", "v")


def _jax_out(op, a, dtype):
    import jax.numpy as jnp
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.ops.flash_attention import flash_attention_xla

    def t(key):
        v = jnp.asarray(a[key])
        return paddle.Tensor(v.astype(dtype) if key in _FLOAT_KEYS else v)

    if op == "linear":
        return JF.linear(t("x"), t("w"), t("b"))
    if op == "flash_attention":
        return flash_attention_xla(t("q"), t("k"), t("v"), attn_mask=t("mask"),
                                   training=False)
    if op == "layer_norm":
        return JF.layer_norm(t("x"), [8], t("w"), t("b"), 1e-5)
    if op == "cross_entropy":
        return JF.cross_entropy(t("x"), t("y"))
    if op == "conv2d":
        return JF.conv2d(t("x"), t("w"), t("b"), padding=1)
    if op == "dropout":
        return JF.dropout(t("x"), p=0.5, training=True)
    return JF.gelu(t("x"))


def _port_out(op, a, dtype):
    def t(key):
        v = torch.from_numpy(a[key])
        return v.to(dtype) if key in _FLOAT_KEYS else v

    if op == "linear":
        lin = Linear(8, 5, device="cpu", dtype=dtype)
        with torch.no_grad():
            lin.weight.copy_(t("w"))
            lin.bias.copy_(t("b"))
        return lin(t("x"))
    if op == "flash_attention":
        return FA.flash_attention_xla(t("q"), t("k"), t("v"),
                                      attn_mask=t("mask"), training=False)
    if op == "layer_norm":
        return TF.layer_norm(t("x"), [8], t("w"), t("b"), 1e-5)
    if op == "cross_entropy":
        return TF.cross_entropy(t("x"), t("y"))
    if op == "conv2d":
        return TF.conv2d(t("x"), t("w"), t("b"), padding=1)
    if op == "dropout":
        return TF.dropout(t("x"), 0.5, True, torch.Generator().manual_seed(0))
    return TF.gelu(t("x"))


@pytest.mark.parametrize("low", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("op", OPS)
def test_entry_point_dtypes_match_jax(op, mode, low):
    """Each entry point the port gives a JAX op name, under each mode,
    with fp32 inputs and with inputs (and weights) in the amp dtype: the
    output's dtype is the JAX op's."""
    pytest.importorskip("jax")
    import paddle_tpu.amp as JA
    kw = MODES[mode]
    name = kw["dtype"] if low else "float32"
    a = _inputs(op, low)
    with JA.auto_cast(**kw):
        want = str(_jax_out(op, a, name)._data.dtype)
    with amp.auto_cast(**kw):
        got = _port_out(op, a, getattr(torch, name))
    assert str(got.dtype).split(".")[-1] == want
    assert not amp.amp_state().enabled


def test_autocast_args_policy_and_nesting():
    """The policy itself: white fp32 / fp64 -> amp dtype, black fp16 /
    bf16 -> fp32, ints and other ops untouched, lists descended; nested
    contexts restore the outer state, also on an exception."""
    x32, x16 = torch.ones(2), torch.ones(2, dtype=torch.float16)
    i = torch.ones(2, dtype=torch.int64)
    with amp.auto_cast(dtype="float16"):
        a, b, c = amp.autocast_args("linear_op", x32, i, [x32, x16])
        assert (a.dtype, b.dtype) == (torch.float16, torch.int64)
        assert [t.dtype for t in c] == [torch.float16, torch.float16]
        (d,) = amp.autocast_args("layer_norm_op", x16)
        assert d.dtype == torch.float32
        (e,) = amp.autocast_args("add", x32)
        assert e is x32
        with pytest.raises(RuntimeError):
            with amp.auto_cast(level="O2"):
                assert amp.autocast_args("linear_op", x32)[0] is x32
                raise RuntimeError
        assert amp.amp_state().level == "O1"
        assert amp.amp_state().dtype == torch.float16
    assert not amp.amp_state().enabled


# ----------------------------------------------------------- ERNIE at O1


def _ernie(seed=0):
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import ernie as J
    paddle.seed(seed)
    jm = J.ErnieForSequenceClassification(
        J.ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2)
    tm = ErnieForSequenceClassification(
        ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2,
        device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (B, S))
    labels = rng.integers(0, 2, (B,))
    mask = np.ones((B, S), np.int64)
    mask[-1, S - 5:] = 0
    return ids, labels, mask


def _jax_logits_and_grads(jm, ids, labels, mask, kw):
    import jax
    import jax.numpy as jnp
    import paddle_tpu as paddle
    import paddle_tpu.amp as JA
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core.tensor import Tensor, no_grad
    from paddle_tpu.jit.trainer import bind_state, collect_state
    params, _, _ = collect_state(jm)

    def f(p):
        with bind_state(params, p), no_grad(), JA.auto_cast(**kw):
            logits = jm(Tensor(jnp.asarray(ids)),
                        attention_mask=paddle.to_tensor(mask))
            loss = JF.cross_entropy(logits, Tensor(jnp.asarray(labels)))
            return loss._data, logits._data

    (loss, logits), grads = jax.value_and_grad(f, has_aux=True)(
        {k: t._data for k, t in params.items()})
    return float(loss), np.asarray(logits.astype(jnp.float32)), \
        str(logits.dtype), {k: np.asarray(g, np.float32)
                            for k, g in grads.items()}


@pytest.mark.parametrize("dtype,logit_tol,grad_tol",
                         [("float16", 4e-3, 2e-2),
                          ("bfloat16", 2e-2, 1e-1)])
def test_ernie_o1_logits_and_grads_match_jax(dtype, logit_tol, grad_tol):
    jm, tm = _ernie()
    ids, labels, mask = _batch()
    kw = dict(dtype=dtype)
    jl, jlogits, jdt, jg = _jax_logits_and_grads(jm, ids, labels, mask, kw)
    with amp.auto_cast(**kw):
        logits = tm(torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask))
        loss = TF.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    assert str(logits.dtype).split(".")[-1] == jdt == dtype
    assert loss.dtype == torch.float32
    got = logits.detach().float().numpy()
    err = np.abs(got - jlogits).max()
    assert err <= logit_tol * max(1.0, np.abs(jlogits).max()), err
    assert abs(loss.item() - jl) <= logit_tol * max(1.0, abs(jl))
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        if n.endswith("k_proj.bias"):
            continue
        e = np.abs(p.grad.numpy() - jg[n]).max()
        assert e <= grad_tol * np.abs(jg[n]).max(), (n, e)


# ------------------------------------------------------------ decorate O2


def test_decorate_o2_keeps_parameters_and_matches_jax_dtypes():
    import paddle_tpu.amp as JA
    import paddle_tpu.optimizer as jopt
    jm, tm = _ernie()
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    jopt_ = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    ids_before = [id(p) for p in tm.parameters()]
    m, o = amp.decorate(tm, topt, level="O2", dtype="bfloat16")
    jmm, jo = JA.decorate(jm, jopt_, level="O2", dtype="bfloat16")
    assert m is tm and o is topt and jmm is jm and jo is jopt_
    assert [id(p) for p in tm.parameters()] == ids_before
    assert all(a is b for a, b in zip(topt._parameters, tm.parameters()))
    jd = {n: str(p._data.dtype) for n, p in jm.named_parameters()}
    td = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert td == jd and set(td.values()) == {"bfloat16"}
    assert topt._multi_precision and jo._multi_precision
    lst = amp.decorate([tm], [topt], level="O2", dtype="bfloat16")
    assert lst == ([tm], [topt])
    assert amp.decorate(tm, dtype="bfloat16") is tm


def test_o2_bf16_train_step_matches_the_rule_on_copies():
    """A TrainStep over bf16 ERNIE `tiny` decorated with fp32 moments
    (multi_precision): its one step bitwise the AdamW rule applied op by
    op (`per_param_update`) to a second model built the same way."""
    _, tm = _ernie()
    _, ref = _ernie()
    ids, labels, mask = _batch()

    def loss_fn(m, x, y, am):
        return TF.cross_entropy(m(x, attention_mask=am), y)

    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=tm.parameters())
    amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    step = TrainStep(tm, loss_fn, opt)
    assert all(st[k].dtype == torch.float32 for st in step.opt_state.values()
               for k in ("moment1", "moment2"))
    ropt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 parameters=ref.parameters())
    amp.decorate(ref, ropt, level="O2", dtype="bfloat16")
    loss = step(ids, labels, mask)
    rparams = {n: p for n, p in ref.named_parameters()}
    rloss = loss_fn(ref, *(torch.from_numpy(a) for a in (ids, labels, mask)))
    rloss.backward()
    grads = {n: p.grad for n, p in rparams.items()}
    state = ropt.functional_init(rparams)
    ropt.per_param_update(rparams, grads, state, 1e-3, 1)
    assert torch.equal(loss, rloss.detach().float())
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, rparams[n]), n
        for k in ("moment1", "moment2"):
            assert torch.equal(step.opt_state[n][k], state[n][k]), (n, k)


def test_fp16_parameter_train_step_raises():
    _, tm = _ernie()
    opt = AdamW(parameters=tm.parameters())
    amp.decorate(tm, opt, level="O2", dtype="float16")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        TrainStep(tm, lambda m, x: m(x).sum(), opt)


# ------------------------------------------------------------- GradScaler


def _scaler_kw():
    return dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
                decr_every_n_nan_or_inf=2)


# per step: the gradient's poison (None, inf or nan) and whether the
# caller unscales before step()
SCRIPT = [(None, False), (None, True), (np.inf, False), (np.nan, True),
          (None, False), (np.inf, False), (None, False), (None, False),
          (None, True)]


def test_grad_scaler_script_matches_jax():
    """`scale` / `unscale_` / `step` / `update` over finite and
    non-finite gradients on a Linear with SGD in both packages: the scale
    and good / bad counters exactly JAX's after each step (found_inf is
    decided alike), `state_dict` the same layout and values.  The
    parameters stay within the fp32 limit of JAX's up to the first step
    whose caller unscales finite gradients: there the JAX scaler divides
    them by the scale a second time in `step` and the two part for good.
    After every step they are within that limit of a numpy reckoning
    that divides each finite step's gradients by its scale once."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import paddle_tpu as paddle
    import paddle_tpu.amp as JA
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.core.tensor import Tensor
    paddle.seed(0)
    jl = jnn.Linear(6, 3)
    tl = Linear(6, 3, device="cpu")
    load_reference_arrays(tl, {n: np.asarray(p._data)
                               for n, p in jl.named_parameters()})
    jo = jopt.SGD(learning_rate=0.1, parameters=jl.parameters())
    to = SGD(learning_rate=0.1, parameters=tl.parameters())
    js, ts = JA.GradScaler(**_scaler_kw()), amp.GradScaler(**_scaler_kw())
    rng = np.random.RandomState(0)
    x = rng.randn(1).astype(np.float32)
    assert float(np.asarray(js.scale(paddle.to_tensor(x))._data)[0]) == \
        ts.scale(torch.from_numpy(x)).item()
    ref = {n: p.detach().numpy().copy() for n, p in tl.named_parameters()}
    parted = False
    for poison, pre in SCRIPT:
        grads = {n: (rng.randn(*p.shape) * 100).astype(np.float32)
                 for n, p in tl.named_parameters()}
        if poison is not None:
            grads["weight"][1, 2] = poison
        finite = all(np.isfinite(g).all() for g in grads.values())
        inv = np.float32(1.0 / ts.get_init_loss_scaling())
        if finite:
            for n, g in grads.items():
                ref[n] = ref[n] - np.float32(0.1) * (g * inv)
        parted = parted or (pre and finite)
        for n, p in jl.named_parameters():
            p.grad = Tensor(jnp.asarray(grads[n]))
        for n, p in tl.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        if pre:
            js.unscale_(jo)
            ts.unscale_(to)
        js.step(jo)
        ts.step(to)
        js.update()
        ts.update()
        assert ts.state_dict() == js.state_dict()
        jp = {n: np.asarray(p._data) for n, p in jl.named_parameters()}
        for n, p in tl.named_parameters():
            got = p.detach().numpy()
            assert np.abs(got - ref[n]).max() <= \
                1e-6 * np.abs(ref[n]).max(), n
            if not parted:
                assert np.abs(got - jp[n]).max() <= \
                    1e-6 * np.abs(jp[n]).max(), n
    assert parted
    assert sorted(ts.state_dict()) == ["bad_steps", "good_steps", "scale"]
    assert ts.get_init_loss_scaling() == js.get_init_loss_scaling() != 1024.0
    t2 = amp.GradScaler()
    t2.load_state_dict(ts.state_dict())
    assert t2.state_dict() == ts.state_dict()
    off = amp.GradScaler(enable=False)
    assert not off.is_enable() and off.get_init_loss_scaling() == 1.0
    assert off.scale(torch.ones(1)).item() == 1.0


def test_unscale_then_step_divides_once_where_jax_divides_twice():
    """`unscale_` -> `step` on finite gradients (the unscale, clip, step
    script): the port's SGD step moves each parameter by lr g / s, once
    divided; the JAX scaler's by lr g / s^2, since its `step` unscales
    again after a finite `unscale_` (a known fact of the reference,
    pinned here).  A second step without `unscale_` divides once
    again: the mark lasts one step."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import paddle_tpu as paddle
    import paddle_tpu.amp as JA
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.core.tensor import Tensor
    paddle.seed(2)
    jl = jnn.Linear(5, 4)
    tl = Linear(5, 4, device="cpu")
    load_reference_arrays(tl, {n: np.asarray(p._data)
                               for n, p in jl.named_parameters()})
    jo = jopt.SGD(learning_rate=1.0, parameters=jl.parameters())
    to = SGD(learning_rate=1.0, parameters=tl.parameters())
    kw = dict(init_loss_scaling=8.0, incr_every_n_steps=1000)
    js, ts = JA.GradScaler(**kw), amp.GradScaler(**kw)
    rng = np.random.RandomState(3)
    for pre in (True, False):
        grads = {n: rng.randn(*p.shape).astype(np.float32) * 64
                 for n, p in tl.named_parameters()}
        tb = {n: p.detach().numpy().copy() for n, p in tl.named_parameters()}
        jb = {n: np.asarray(p._data).copy() for n, p in jl.named_parameters()}
        for n, p in jl.named_parameters():
            p.grad = Tensor(jnp.asarray(grads[n]))
        for n, p in tl.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        if pre:
            js.unscale_(jo)
            ts.unscale_(to)
        js.step(jo)
        ts.step(to)
        js.update()
        ts.update()
        for n, p in tl.named_parameters():
            moved = tb[n] - p.detach().numpy()
            np.testing.assert_allclose(moved, grads[n] / 8.0, rtol=1e-5,
                                       atol=1e-5)
        for n, p in jl.named_parameters():
            moved = jb[n] - np.asarray(p._data)
            want = grads[n] / (64.0 if pre else 8.0)
            np.testing.assert_allclose(moved, want, rtol=1e-5, atol=1e-5)
        assert ts.state_dict() == js.state_dict()


def test_grad_scaler_minimize_matches_jax():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    import paddle_tpu.amp as JA
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt
    paddle.seed(1)
    jl = jnn.Linear(4, 2)
    tl = Linear(4, 2, device="cpu")
    load_reference_arrays(tl, {n: np.asarray(p._data)
                               for n, p in jl.named_parameters()})
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    jo = jopt.SGD(learning_rate=0.1, parameters=jl.parameters())
    to = SGD(learning_rate=0.1, parameters=tl.parameters())
    js, ts = JA.GradScaler(**_scaler_kw()), amp.GradScaler(**_scaler_kw())
    for _ in range(3):
        js.minimize(jo, js.scale(jl(paddle.to_tensor(x)).sum()))
        ts.minimize(to, ts.scale(tl(torch.from_numpy(x)).sum()))
        jo.clear_grad()
        to.clear_grad()
        assert ts.state_dict() == js.state_dict()
    jp = {n: np.asarray(p._data) for n, p in jl.named_parameters()}
    for n, p in tl.named_parameters():
        assert np.abs(p.detach().numpy() - jp[n]).max() <= \
            1e-6 * np.abs(jp[n]).max()


def _scaled_run(loss_scale, poisoned=(2,), steps=4):
    _, tm = _ernie()
    ids, labels, mask = _batch()
    poison = {"on": False}

    def loss_fn(m, x, y, am):
        loss = TF.cross_entropy(m(x, attention_mask=am), y)
        return loss * float("inf") if poison["on"] else loss

    step = TrainStep(tm, loss_fn, AdamW(learning_rate=1e-3,
                                        parameters=tm.parameters()),
                     loss_scale=loss_scale)
    trail = []
    for i in range(steps):
        poison["on"] = i in poisoned
        step(ids, labels, mask)
        trail.append(({k: v.item() for k, v in step.scaler_state.items()},
                      {n: p.detach().clone()
                       for n, p in tm.named_parameters()}))
    return trail


def test_port_grad_scaler_in_train_step_is_the_knob_objects_trajectory():
    """`TrainStep(loss_scale=amp.GradScaler(...))` against the same knobs
    on the JAX package's `GradScaler` object (the loss-scale tests'
    knob object): the same scaler state after every step (good, good
    -> the scale doubles, poisoned -> skipped, good) and bitwise the
    same parameters."""
    pytest.importorskip("jax")
    import paddle_tpu.amp as JA
    kw = dict(init_loss_scaling=256.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    got = _scaled_run(amp.GradScaler(**kw))
    want = _scaled_run(JA.GradScaler(**kw))
    assert [s for s, _ in got] == [s for s, _ in want]
    assert [s["scale"] for s, _ in got] == [256.0, 512.0, 256.0, 256.0]
    for (_, a), (_, b) in zip(got, want):
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(torch.equal(got[2][1][n], got[1][1][n]) for n in got[1][1])


# ------------------------------------------------------------- the card


@pytest.mark.gpu
def test_fp16_mma_kernels_match_their_plain_versions():
    """K1, dQ and dK/dV in fp16 (the mma kernels, P and dS in two fp16
    parts) at an ERNIE-like shape with an fp16 padding bias (-1e9 is
    -inf in fp16) and dropout 0.1, against their plain versions from the
    same (seed, offset): O, dQ per (b, query row, head), dK, dV per (b,
    key row, head) within 2^-10 x the row's max |plain|; bitwise twice;
    launches counted on the mma variant; no bias and no dropout raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1/K2 have no CPU or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    B_, S_, H, D = 4, 128, 12, 64
    q, k, v, do = (torch.randn(B_, S_, H, D, device="cuda", generator=g)
                   .half() for _ in range(4))
    am = torch.ones(B_, S_, device="cuda")
    am[1, 90:] = 0
    am[3, 40:] = 0
    bias = ((1 - am) * -1e9).half().float().reshape(B_, 1, 1, S_)
    assert torch.isinf(bias).any()
    drop = (0.1, 77, 3)
    lo = torch.empty(B_, H, S_, device="cuda")
    before = dict(FA.VARIANT_LAUNCHES["mma"])
    o, lse, klo = FA.flash_fwd(q, k, v, False, bias=bias, dropout=drop,
                               return_lo=True)
    po, plse = FA.flash_fwd_plain(q, k, v, False, bias=bias, dropout=drop,
                                  lse_lo=lo)
    dq = FA.flash_bwd_dq(q, k, v, po, plse, do, False, bias=bias,
                         dropout=drop, lse_lo=lo)
    dk, dv = FA.flash_bwd_dkv(q, k, v, po, plse, do, False, bias=bias,
                              dropout=drop, lse_lo=lo)
    torch.cuda.synchronize()
    pdq, pdk, pdv = FA.flash_bwd_plain(q, k, v, po, plse, do, False,
                                       bias=bias, dropout=drop, lse_lo=lo)
    for got, want in ((o, po), (dq, pdq), (dk, pdk), (dv, pdv)):
        assert got.dtype == torch.float16 and torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().amax(-1)
        ref = want.float().abs().amax(-1).clamp_min(1e-30)
        assert (err <= 2 ** -10 * ref).all()
    assert ((lse - plse).abs() <= 1e-5 * plse.abs().clamp_min(1)).all()
    again = FA.flash_fwd(q, k, v, False, bias=bias, dropout=drop)[0]
    assert torch.equal(again, o)
    after = FA.VARIANT_LAUNCHES["mma"]
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 2
    assert after["flash_attention_dq"] == before["flash_attention_dq"] + 1
    assert after["flash_attention_dkv"] == before["flash_attention_dkv"] + 1
    with pytest.raises(ValueError):
        FA.flash_fwd(q, k, v, False)


def test_train_step_reads_the_amp_state_each_call_jax_bakes_its_first():
    """A known difference: the JAX TrainStep bakes the amp state of its
    first trace into its jitted program (a step called outside auto_cast
    afterwards still runs fp16: the same program, the same loss); the
    port's eager step reads the state at every call."""
    import paddle_tpu as paddle
    import paddle_tpu.amp as JA
    import paddle_tpu.nn.functional as JF
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.jit.trainer import TrainStep as JStep
    jm, tm = _ernie()
    ids, labels, _ = _batch()
    jstep = JStep(jm, lambda m, x, y: JF.cross_entropy(m(x), y),
                  jopt.SGD(learning_rate=0.0, parameters=jm.parameters()))
    tstep = TrainStep(tm, lambda m, x, y: TF.cross_entropy(m(x), y),
                      SGD(learning_rate=0.0, parameters=tm.parameters()))
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    with JA.auto_cast(dtype="float16"):
        j16 = float(np.asarray(jstep(jx, jy)._data))
    compiled = jstep._compiled
    j_after = float(np.asarray(jstep(jx, jy)._data))
    assert jstep._compiled is compiled and j_after == j16
    with amp.auto_cast(dtype="float16"):
        t16 = tstep(ids, labels).item()
    t32 = tstep(ids, labels).item()
    assert t16 != t32
    assert t32 == TF.cross_entropy(tm(torch.from_numpy(ids)),
                                   torch.from_numpy(labels)).item()
    assert abs(t16 - j16) <= 4e-3 * max(1.0, abs(j16))
