"""The optimizers beyond Adam of the PyTorch port — SGD, Momentum,
Adagrad, Adadelta, Adamax, RMSProp, Lamb, Lookahead, ModelAverage,
LBFGS, the LR schedulers, the clips and the regularizers
(paddle_tpu_torch/optimizer/, nn/clip.py, regularizer.py) — against the
JAX package's (paddle_tpu/optimizer/, nn/clip.py, regularizer.py), on
the CPU.

Inputs are made with numpy from a seed.  Each rule runs both ways: the
training step's `functional_update` (the JAX one as its TrainStep calls
it: lr an fp32 array, the step an int32 one, 64-bit types on) and the
eager `step()` over parameters with gradients (lr a Python float), in
fp32, bf16 and, where the optimizer takes it, `multi_precision`.
Tolerances: fp32 params and state within 1e-6 x max|JAX| of each tensor
(the same expressions, fp32 rounding at the same places); bf16 within
one bf16 step (2^-7 relative) element by element (XLA may keep a bf16
chain in fp32 between ops where PyTorch rounds after each); the
training step against the eager step on the same fp32 model within
1e-6 x max|eager|; LR sequences exactly equal
(the same host arithmetic); the eager tail optimizers (Lookahead,
ModelAverage, LBFGS) on a tiny regression within 1e-5 x max|JAX| of the
weights (LBFGS: 1e-4, its line search compares losses that differ in
the last bits)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"w": (8, 16), "b": (16,), "e": (5, 4, 3)}
LRS = (1e-2, 7e-3, 3e-3)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _ok(got, want, dtype):
    """fp32: |got - want| <= 1e-6 x max|want|.  bf16: within one bf16
    step of |want|, or 2^-7 x max|want| (module docstring)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = max(np.abs(want).max(), 1e-30)
    if dtype == "float32":
        return np.abs(got - want).max() <= 1e-6 * top
    step = np.maximum(np.abs(want), 1e-30) * 2.0 ** -7
    return bool((np.abs(got - want) <= step).all())


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import paddle_tpu.nn.clip as jclip
    import paddle_tpu.optimizer as jopt
    import paddle_tpu.regularizer as jreg
    return jnp, jopt, jclip, jreg


# name -> (class name, keywords, takes multi_precision, clip)
RULES = {
    "sgd": ("SGD", {}, True, ("ClipGradByValue", 0.3)),
    "momentum": ("Momentum", {"momentum": 0.9}, True,
                 ("ClipGradByNorm", 0.5)),
    "nesterov": ("Momentum", {"momentum": 0.9, "use_nesterov": True}, True,
                 ("ClipGradByGlobalNorm", 1.0)),
    "momentum_l2": ("Momentum", {"momentum": 0.8, "weight_decay": "L2"},
                    False, None),
    "adagrad": ("Adagrad", {"epsilon": 1e-6,
                            "initial_accumulator_value": 0.1}, False,
                ("ClipGradByGlobalNorm", 1.0)),
    "adadelta": ("Adadelta", {"epsilon": 1e-6, "rho": 0.95}, False, None),
    "adamax": ("Adamax", {"beta1": 0.9, "beta2": 0.999}, False,
               ("ClipGradByNorm", 0.5)),
    "rmsprop": ("RMSProp", {"rho": 0.9}, False, None),
    "rmsprop_centered": ("RMSProp", {"rho": 0.9, "momentum": 0.9,
                                     "centered": True}, False,
                         ("ClipGradByGlobalNorm", 1.0)),
    "lamb": ("Lamb", {"lamb_weight_decay": 0.01}, False,
             ("ClipGradByGlobalNorm", 1.0)),
    "adam_eager": ("Adam", {"weight_decay": 0.05}, True, None),
    "adamw_eager": ("AdamW", {"weight_decay": 0.05}, True, None),
    # Adam / AdamW under a per-tensor clip: the rule op by op, not U1 / U2
    "adam_clip_norm": ("Adam", {}, True, ("ClipGradByNorm", 0.5)),
    "adam_clip_value": ("Adam", {"weight_decay": 0.05}, True,
                        ("ClipGradByValue", 0.3)),
    "adamw_clip_norm": ("AdamW", {"weight_decay": 0.05}, True,
                        ("ClipGradByNorm", 0.5)),
    "adamw_clip_value": ("AdamW", {"weight_decay": 0.05}, True,
                         ("ClipGradByValue", 0.3)),
}


def _build(name, pkg, multi_precision=False, parameters=None):
    """The optimizer `name` of the JAX package (pkg "jax") or the
    port's, with the same keywords."""
    cls, kw, takes_mp, clip = RULES[name]
    kw = dict(kw)
    if pkg == "jax":
        _, mod, clips, regs = _jax()
    else:
        mod, clips, regs = topt, tclip, treg
    if kw.get("weight_decay") == "L2":
        kw["weight_decay"] = regs.L2Decay(0.05)
    if clip is not None:
        kw["grad_clip"] = getattr(clips, clip[0])(clip[1])
    if takes_mp:
        kw["multi_precision"] = multi_precision
    return getattr(mod, cls)(learning_rate=LRS[0], parameters=parameters,
                             **kw)


def _cases(eager):
    out = []
    for name, (_, _, takes_mp, _) in sorted(RULES.items()):
        if name.endswith("_eager") and not eager:
            continue            # Adam / AdamW: tests/test_torch_optimizer.py
        for dtype in ("float32", "bfloat16"):
            out.append((name, dtype, False))
        if takes_mp:
            out.append((name, "bfloat16", True))
    return out


@pytest.mark.parametrize("name,dtype,mp", _cases(eager=False))
def test_functional_update_matches_jax(name, dtype, mp):
    """Three training-step updates (lr an fp32 array): params and every
    state tensor, dtype and value."""
    jnp, _, _, _ = _jax()
    jo, to = _build(name, "jax", mp), _build(name, "port", mp)
    params = _tree(0, 0.5)
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in params.items()}
    js, ts = jo.functional_init(jp), to.functional_init(tp)
    for step, lr in enumerate(LRS, start=1):
        grads = _tree(step)
        jg = {k: jnp.asarray(v).astype(dtype) for k, v in grads.items()}
        tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
              for k, v in grads.items()}
        jp, js = jo.functional_update(jp, jg, js,
                                      jnp.asarray(lr, jnp.float32),
                                      jnp.asarray(step, jnp.int32))
        to.functional_update(tp, tg, ts, lr, step)
        for k in SHAPES:
            assert tp[k].dtype == getattr(torch, dtype)
            assert _ok(tp[k].float().numpy(),
                       np.asarray(jp[k].astype(jnp.float32)), dtype), \
                (step, k)
            assert set(ts[k]) == set(js[k])
            for s, jv in js[k].items():
                tv = ts[k][s]
                assert str(tv.dtype).split(".")[-1] == str(jv.dtype), \
                    (step, k, s, tv.dtype, jv.dtype)
                sd = "float32" if tv.dtype == torch.float32 else dtype
                assert _ok(tv.float().numpy(),
                           np.asarray(jv.astype(jnp.float32)), sd), \
                    (step, k, s)


def _params(pkg, dtype, seed=0):
    """{name: parameter} of either package, from _tree(seed)."""
    init = _tree(seed, 0.5)
    if pkg == "jax":
        jnp, _, _, _ = _jax()
        from paddle_tpu.core.tensor import Parameter
        return {k: Parameter(jnp.asarray(v).astype(dtype))
                for k, v in init.items()}
    return {k: torch.nn.Parameter(torch.from_numpy(v)
                                  .to(getattr(torch, dtype)))
            for k, v in init.items()}


def _set_grads(params, pkg, step, dtype):
    grads = _tree(step)
    for k, p in params.items():
        if pkg == "jax":
            jnp, _, _, _ = _jax()
            from paddle_tpu.core.tensor import Tensor
            p.grad = Tensor(jnp.asarray(grads[k]).astype(dtype))
        else:
            p.grad = torch.from_numpy(grads[k]).to(getattr(torch, dtype))


@pytest.mark.parametrize("name,dtype,mp", _cases(eager=True))
def test_eager_step_matches_jax(name, dtype, mp):
    """Three eager steps (lr a Python float) over parameters with
    gradients, then clear_grad: the parameters and the state."""
    jnp, _, _, _ = _jax()
    jparams, tparams = _params("jax", dtype), _params("port", dtype)
    jo = _build(name, "jax", mp, list(jparams.values()))
    to = _build(name, "port", mp, list(tparams.values()))
    for step in (1, 2, 3):
        _set_grads(jparams, "jax", step, dtype)
        _set_grads(tparams, "port", step, dtype)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        assert all(p.grad is None for p in tparams.values())
        for k in SHAPES:
            want = np.asarray(jparams[k]._data.astype(jnp.float32))
            assert _ok(tparams[k].detach().float().numpy(), want, dtype), \
                (step, k)
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert tsd["_step_count"] == jsd["_step_count"] == 3
    assert sorted(k.split(".", 1)[1] for k in tsd if k != "_step_count") \
        == sorted(k.split(".", 1)[1] for k in jsd if k != "_step_count")


def test_state_dict_round_trip_and_param_names():
    """A new optimizer given the state dict continues bitwise as the
    first; states are named param_{i}; lr state rides along."""
    params = _params("port", "float32")
    sched = tlr.StepDecay(0.1, step_size=2)
    opt = topt.Momentum(learning_rate=sched, momentum=0.9,
                        parameters=list(params.values()))
    for step in (1, 2):
        _set_grads(params, "port", step, "float32")
        opt.step()
        sched.step()
    sd = opt.state_dict()
    assert sorted(sd) == sorted(["_step_count", "LR_Scheduler"] + [
        f"param_{i}.velocity" for i in range(len(params))])
    twin = {k: torch.nn.Parameter(p.detach().clone())
            for k, p in params.items()}
    sched2 = tlr.StepDecay(0.1, step_size=2)
    opt2 = topt.Momentum(learning_rate=sched2, momentum=0.9,
                         parameters=list(twin.values()))
    opt2.set_state_dict(sd)
    assert sched2.last_epoch == sched.last_epoch
    for ps, o in ((params, opt), (twin, opt2)):
        _set_grads(ps, "port", 3, "float32")
        o.step()
    for k in params:
        assert torch.equal(params[k], twin[k]), k


def test_set_lr_minimize_and_frozen_params():
    """set_lr / _learning_rate; minimize runs backward and step; a
    parameter with requires_grad False is not stepped."""
    w = torch.nn.Parameter(torch.ones(3))
    frozen = torch.nn.Parameter(torch.ones(3), requires_grad=False)
    opt = topt.SGD(learning_rate=0.5, parameters=[w, frozen])
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25 and opt._learning_rate == 0.25
    frozen.grad = torch.ones(3)
    opt.minimize((w * 2.0).sum())
    assert torch.equal(w.detach(), torch.full((3,), 0.5))
    assert torch.equal(frozen.detach(), torch.ones(3))
    with pytest.raises(RuntimeError, match="LRScheduler"):
        topt.SGD(learning_rate=tlr.StepDecay(0.1, 2)).set_lr(0.1)


def test_eager_only_optimizers_refuse_the_training_step():
    la = topt.Lookahead(topt.SGD(parameters=[torch.nn.Parameter(
        torch.ones(2))]))
    with pytest.raises(NotImplementedError, match="eagerly"):
        la.functional_update({"w": torch.ones(2)}, {"w": torch.ones(2)},
                             {"w": {}}, 0.1, 1)


def test_l2decay_is_the_float_decay():
    """weight_decay=L2Decay(c) updates as weight_decay=c, in both paths,
    as the JAX package reads its coeff."""
    runs = []
    for wd in (0.05, treg.L2Decay(0.05)):
        ps = {k: torch.from_numpy(v) for k, v in _tree(0, 0.5).items()}
        o = topt.Momentum(learning_rate=0.01, momentum=0.9, weight_decay=wd)
        st = o.functional_init(ps)
        o.functional_update(ps, {k: torch.from_numpy(v) for k, v in
                                 _tree(1).items()}, st, 0.01, 1)
        runs.append(ps)
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in SHAPES)


def test_l1decay_and_lamb_exclude_are_refused():
    """The two JAX behaviours the port refuses (ROADMAP, known facts):
    an L1Decay decays as L2 there; Lamb's exclude function is never
    read there."""
    with pytest.raises(NotImplementedError, match="L1Decay"):
        topt.SGD(weight_decay=treg.L1Decay(0.01))
    with pytest.raises(NotImplementedError,
                       match="exclude_from_weight_decay_fn"):
        topt.Lamb(exclude_from_weight_decay_fn=lambda n: "bias" in n)
    with pytest.raises(TypeError, match="L2Decay"):
        topt.SGD(weight_decay="0.1")


@pytest.mark.parametrize("kind", ["L1Decay", "L2Decay"])
def test_regularizer_terms_match_jax(kind):
    jnp, _, _, jreg = _jax()
    x = _tree(4)["w"]
    j, t = getattr(jreg, kind)(0.3), getattr(treg, kind)(0.3)
    assert t.coeff == j.coeff == 0.3 and repr(t) == repr(j)
    assert _ok(t.grad_term(torch.from_numpy(x)).numpy(),
               np.asarray(j.grad_term(jnp.asarray(x))), "float32")
    assert _ok(t.penalty(torch.from_numpy(x)).numpy(),
               np.asarray(j.penalty(jnp.asarray(x))), "float32")


# -- LR schedulers -------------------------------------------------------

SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=4,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.3),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.5),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=5,
                                                   end_lr=0.01, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=4, end_lr=0.01, cycle=True),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.8),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, milestones=[2, 5, 9]),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=3, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.9 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.95),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=3, T_mult=2, eta_min=0.001),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=10),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(
        0.1, total_steps=10, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=2, step_size_down=3, mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=2, mode="exp_range", exp_gamma=0.9),
}


def _walk(sched, n=14):
    out = []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax_and_round_trips(name):
    """The lr of each step equal to the JAX scheduler's; after 5 steps a
    fresh scheduler given the state dict continues as the JAX one does
    under the same round trip."""
    pytest.importorskip("jax")
    from paddle_tpu.optimizer import lr as jlr
    build = SCHEDULERS[name]
    assert _walk(build(tlr)) == _walk(build(jlr))
    seqs = []
    for m in (tlr, jlr):
        s = build(m)
        _walk(s, 5)
        t = build(m)
        t.set_state_dict(s.state_dict())
        seqs.append((s.state_dict(), _walk(t, 9)))
    assert seqs[0] == seqs[1]


def test_reduce_on_plateau_matches_jax():
    pytest.importorskip("jax")
    from paddle_tpu.optimizer import lr as jlr
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.98, 0.97, 1.0, 0.5, 0.6, 0.7,
               0.8, 0.9]
    runs = []
    for m in (tlr, jlr):
        for mode in ("min", "max"):
            s = m.ReduceOnPlateau(0.1, mode=mode, factor=0.5, patience=2,
                                  cooldown=1, threshold_mode="abs")
            lrs = []
            for v in metrics:
                s.step(torch.tensor(v) if m is tlr else v)
                lrs.append(s())
            runs.append((lrs, s.state_dict()))
    assert runs[:2] == runs[2:]


def test_lr_exports_cover_the_jax_module():
    pytest.importorskip("jax")
    from paddle_tpu.optimizer import lr as jlr
    want = {n for n, v in vars(jlr).items() if isinstance(v, type)
            and issubclass(v, jlr.LRScheduler)}
    assert len(want) == 17
    assert want <= set(tlr.__all__)
    assert all(issubclass(getattr(tlr, n), tlr.LRScheduler) for n in want)


# -- clips --------------------------------------------------------------

CLIPS = [("ClipGradByValue", (0.3,)), ("ClipGradByValue", (0.3, -0.1)),
         ("ClipGradByNorm", (0.5,)), ("ClipGradByGlobalNorm", (1.0,))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls,args", CLIPS)
def test_clip_matches_jax(cls, args, dtype):
    """Both forms: `_clip_arrays` and the eager [(param, grad)] one,
    with a None gradient kept."""
    jnp, _, jclip, _ = _jax()
    from paddle_tpu.core.tensor import Tensor
    grads = _tree(5, 0.4)
    jc, tc = getattr(jclip, cls)(*args), getattr(tclip, cls)(*args)
    jg = jc._clip_arrays({k: jnp.asarray(v).astype(dtype)
                          for k, v in grads.items()})
    tg = tc._clip_arrays({k: torch.from_numpy(v).to(getattr(torch, dtype))
                          for k, v in grads.items()})
    for k in SHAPES:
        assert tg[k].dtype == getattr(torch, dtype)
        assert _ok(tg[k].float().numpy(),
                   np.asarray(jg[k].astype(jnp.float32)), dtype), k
    pairs = tc([(k, torch.from_numpy(v).to(getattr(torch, dtype)))
                for k, v in grads.items()] + [("none", None)])
    jpairs = jc([(k, Tensor(jnp.asarray(v).astype(dtype)))
                 for k, v in grads.items()] + [("none", None)])
    assert pairs[-1] == ("none", None) and jpairs[-1][1] is None
    for (k, g), (_, jgt) in zip(pairs[:-1], jpairs[:-1]):
        assert _ok(g.float().numpy(),
                   np.asarray(jgt._data.astype(jnp.float32)), dtype), k


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_and_value_match_jax(norm_type):
    jnp, _, jclip, _ = _jax()
    jps, tps = _params("jax", "float32"), _params("port", "float32")
    _set_grads(jps, "jax", 6, "float32")
    _set_grads(tps, "port", 6, "float32")
    jt = jclip.clip_grad_norm_(list(jps.values()), 1.5, norm_type)
    tt = tclip.clip_grad_norm_(list(tps.values()), 1.5, norm_type)
    assert _ok(tt.numpy(), np.asarray(jt._data), "float32")
    jclip.clip_grad_value_(list(jps.values()), 0.02)
    tclip.clip_grad_value_(list(tps.values()), 0.02)
    for k in SHAPES:
        assert _ok(tps[k].grad.numpy(), np.asarray(jps[k].grad._data),
                   "float32"), k
    assert float(tclip.clip_grad_norm_([torch.nn.Parameter(
        torch.ones(2))], 1.0)) == 0.0


# -- the eager tail: tests/test_optimizer_tail.py's regression -----------


def _toy(pkg):
    """tests/test_optimizer_tail.py's Linear(4, 1) regression with the
    JAX initial weights in both packages: (params, forward-loss fn)."""
    _, _, _, _ = _jax()
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF
    paddle.seed(0)
    jm = jnn.Linear(4, 1)
    x = np.random.RandomState(0).rand(16, 4).astype(np.float32)
    y = x @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    if pkg == "jax":
        xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
        return [jm.weight, jm.bias], lambda: JF.mse_loss(jm(xt), yt)
    w = torch.nn.Parameter(torch.from_numpy(np.asarray(jm.weight._data)))
    b = torch.nn.Parameter(torch.from_numpy(np.asarray(jm.bias._data)))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    return [w, b], lambda: ((xt @ w + b - yt) ** 2).mean()


def _weights(ps):
    """Copies of the parameters' values (a numpy view of a tensor would
    follow later in-place writes)."""
    return [np.array(p._data if hasattr(p, "_data") else p.detach(),
                     np.float32) for p in ps]


def _near(got, want, tol):
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max()), (g, w)


def test_lookahead_matches_jax():
    _, jopt, _, _ = _jax()
    out = []
    for pkg, mod in (("jax", jopt), ("port", topt)):
        ps, loss_fn = _toy(pkg)
        la = mod.Lookahead(mod.SGD(learning_rate=0.1, parameters=ps),
                           alpha=0.5, k=5)
        losses = []
        for _ in range(12):
            loss = loss_fn()
            loss.backward()
            la.step()
            la.clear_grad()
            losses.append(float(loss))
        out.append((_weights(ps), losses, la.state_dict()["step"]))
    _near(out[1][0], out[0][0], 1e-5)
    assert out[1][2] == out[0][2] == 12
    assert out[1][1][-1] < out[1][1][0] * 0.5


def test_model_average_matches_jax_and_restores_bitwise():
    _, jopt, _, _ = _jax()
    out = []
    for pkg, mod in (("jax", jopt), ("port", topt)):
        ps, loss_fn = _toy(pkg)
        sgd = mod.SGD(learning_rate=0.1, parameters=ps)
        ma = mod.ModelAverage(0.5, parameters=ps, min_average_window=2,
                              max_average_window=10)
        for _ in range(10):
            loss = loss_fn()
            loss.backward()
            sgd.step()
            sgd.clear_grad()
            ma.step()
        live = _weights(ps)
        ma.apply()
        averaged = _weights(ps)
        ma.restore()
        out.append((live, averaged, _weights(ps),
                    {k: v for k, v in ma.state_dict().items()
                     if k.startswith("num")}))
    (jl, ja, _, jn), (tl, ta, tr, tn) = out
    _near(tl, jl, 1e-5)
    _near(ta, ja, 1e-5)
    assert tn == jn
    assert all(np.array_equal(a, b) for a, b in zip(tr, tl))
    assert not all(np.allclose(a, b) for a, b in zip(ta, tl))


def test_model_average_spills_as_jax():
    """The sum_1 -> sum_2 spill every kMaxNumAccumulates updates and the
    window restart into sum_3, at a reduced spill period, against the
    JAX scheme on the same parameter sequence."""
    jnp, jopt, _, _ = _jax()
    from paddle_tpu.core.tensor import Parameter
    sums = []
    for mod in (jopt, topt):
        p = Parameter(jnp.zeros(3)) if mod is jopt \
            else torch.nn.Parameter(torch.zeros(3))
        ma = mod.ModelAverage(0.5, parameters=[p], min_average_window=3,
                              max_average_window=5)
        ma._K_MAX_NUM_ACCUMULATES = 4
        for i in range(11):
            v = np.full(3, 0.1 * (i + 1), np.float32)
            if mod is jopt:
                p._set_data(jnp.asarray(v))
            else:
                with torch.no_grad():
                    p.copy_(torch.from_numpy(v))
            ma.step()
        sd = ma.state_dict()
        sums.append([np.asarray(sd[k][0]._data if hasattr(sd[k][0], "_data")
                                else sd[k][0], np.float32)
                     for k in ("sum_1", "sum_2", "sum_3")]
                    + [sd["num_accumulates"], sd["old_num_accumulates"]])
    j, t = sums
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_allclose(b, a, rtol=1e-6)
    assert j[3:] == t[3:]
    assert topt.ModelAverage._K_MAX_NUM_ACCUMULATES == 16384


def test_lbfgs_matches_jax():
    _, jopt, _, _ = _jax()
    out = []
    for pkg, mod in (("jax", jopt), ("port", topt)):
        ps, loss_fn = _toy(pkg)
        lb = mod.LBFGS(learning_rate=1.0, max_iter=8, history_size=6,
                       parameters=ps)

        def closure():
            lb.clear_grad()
            loss = loss_fn()
            loss.backward()
            return loss

        l0 = float(closure())
        losses = [float(lb.step(closure)) for _ in range(3)]
        out.append((_weights(ps), losses, l0))
    _near(out[1][0], out[0][0], 1e-4)
    assert out[1][1][-1] < out[1][2] * 1e-2


def _jax_optimizer_names():
    tree = ast.parse((ROOT / "paddle_tpu/optimizer/__init__.py")
                     .read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


def test_optimizer_exports_cover_the_jax_package():
    want = _jax_optimizer_names()
    assert len(want) == 14 and "lr" in want
    assert set(want) <= set(topt.__all__)
    assert all(hasattr(topt, n) for n in want)
    assert set(tclip.__all__) >= {"ClipGradByValue", "ClipGradByNorm",
                                  "ClipGradByGlobalNorm", "clip_grad_norm_",
                                  "clip_grad_value_"}
    assert set(treg.__all__) == {"L1Decay", "L2Decay"}


def _tiny_ernie():
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    cfg = ErnieConfig.from_preset("tiny", hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    return ErnieForSequenceClassification(cfg, num_classes=2, device="cpu",
                                          seed=3)


def _ernie_loss(m, ids, labels, mask):
    return torch.nn.functional.cross_entropy(m(ids, attention_mask=mask),
                                             labels)


@pytest.mark.parametrize("name", ["sgd", "nesterov", "rmsprop_centered",
                                  "lamb", "momentum_l2", "adam_clip_norm",
                                  "adamw_clip_value"])
def test_train_step_takes_every_rule(name):
    """TrainStep with a rule or a clip that has no fused kernel (the clip,
    then update_rule parameter by parameter) against the eager step on a
    copy of the same tiny ERNIE (fp32, where the two lr types agree)."""
    from paddle_tpu_torch.jit import TrainStep
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.randint(0, 256, (2, 16))),
             torch.from_numpy(rng.randint(0, 2, (2,))),
             torch.ones(2, 16, dtype=torch.int64))
    a, b = _tiny_ernie(), _tiny_ernie()
    step = TrainStep(a, _ernie_loss, _build(name, "port", parameters=list(
        a.parameters())))
    eager = _build(name, "port", parameters=list(b.parameters()))
    for _ in range(2):
        step(*batch)
        _ernie_loss(b, *batch).backward()
        eager.step()
        eager.clear_grad()
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert _ok(pa.detach().numpy(), pb.detach().numpy(), "float32"), n


def test_train_step_loss_scale_with_a_rule_skips_non_finite_steps():
    """A static loss scale of 2^10 gives the unscaled step (a power of
    two); a non-finite gradient leaves params and state as they were,
    and the dynamic scaler halves after two such steps, as the JAX step
    does."""
    from paddle_tpu_torch.jit import TrainStep
    rng = np.random.RandomState(1)
    batch = (torch.from_numpy(rng.randint(0, 256, (2, 16))),
             torch.from_numpy(rng.randint(0, 2, (2,))),
             torch.ones(2, 16, dtype=torch.int64))
    runs = []
    for scale in (None, 1024.0):
        m = _tiny_ernie()
        st = TrainStep(m, _ernie_loss, topt.Momentum(
            learning_rate=0.01, parameters=list(m.parameters())),
            loss_scale=scale)
        st(*batch)
        runs.append([p.detach().clone() for p in m.parameters()])
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    m = _tiny_ernie()

    def bad_loss(model, *bt):
        return _ernie_loss(model, *bt) * float("inf")

    st = TrainStep(m, bad_loss, topt.Momentum(
        learning_rate=0.01, parameters=list(m.parameters())),
        loss_scale="dynamic")
    before = [p.detach().clone() for p in m.parameters()]
    for _ in range(2):
        st(*batch)
    assert all(torch.equal(x, p) for x, p in zip(before, m.parameters()))
    assert all(float(v["velocity"].abs().sum()) == 0.0
               for v in st.opt_state.values())
    assert float(st.scaler_state["scale"]) == 2.0 ** 14
