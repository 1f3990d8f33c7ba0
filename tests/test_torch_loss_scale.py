"""Loss scaling in the PyTorch port's `TrainStep(loss_scale=...)` against
the JAX package's (`paddle_tpu/jit/trainer.py`: scale the fp32 loss,
unscale the gradients, `found_inf` over all of them, keep params and
moments on `found_inf`, grow or decay the scale), at `debug-4l` in fp32
with AdamW(LinearWarmup) and a global-norm clip; weights cross by name,
token ids are made with numpy from a seed.

Tolerances:
* a static scale of 1024 against no scale, in the port: each loss within
  1e-6 relative, every parameter within rtol 2e-5 / atol 1e-6
  (tests/test_amp_scaler.py's limits for the JAX step);
* the port against the JAX step: each loss within 1e-6 relative and
  every parameter element within 5e-2 x the summed lr
  (tests/test_torch_llama_train.py's fp32 limits);
* `scaler_state` ({"scale", "good", "bad"}) exactly equal to the JAX
  step's after the same sequence of steps, and on a skipped step every
  parameter bitwise as before."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import LlamaPretrainingCriterion
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

LRS = (2e-4, 6e-4)      # LinearWarmup(2e-4 -> 1e-3 over 2 steps)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _models(seed=0):
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(seed)
    jm = LlamaForCausalLM(LlamaConfig.from_preset("debug-4l"))
    tm = TModel(TConfig.from_preset("debug-4l"), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _ids(seed=2):
    return np.random.default_rng(seed).integers(0, 1024, (2, 32))


def _poison_loss(pkg, poison):
    """The causal-LM loss, times inf while poison["on"] (its gradients
    are then inf or NaN)."""
    if pkg == "jax":
        import paddle_tpu as paddle
        from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
        crit = JCrit()

        def fn(m, x):
            loss = crit(m(x), x)
            if poison["on"]:
                loss = loss * paddle.to_tensor(np.float32(np.inf))
            return loss
        return fn
    crit = LlamaPretrainingCriterion()

    def fn(m, x):
        loss = crit(m(x), x)
        return loss * float("inf") if poison["on"] else loss
    return fn


def _step(pkg, model, loss_scale, poison):
    if pkg == "jax":
        import paddle_tpu.optimizer as jopt
        from paddle_tpu.jit.trainer import TrainStep as JStep
        from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
        sched = jopt.lr.LinearWarmup(1e-3, warmup_steps=2, start_lr=2e-4,
                                     end_lr=1e-3)
        opt = jopt.AdamW(learning_rate=sched, weight_decay=0.01,
                         parameters=model.parameters(), grad_clip=JClip(0.5))
        step = JStep(model, _poison_loss("jax", poison), opt,
                     loss_scale=loss_scale)
    else:
        sched = tlr.LinearWarmup(1e-3, warmup_steps=2, start_lr=2e-4,
                                 end_lr=1e-3)
        opt = AdamW(learning_rate=sched, weight_decay=0.01,
                    parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(0.5))
        step = TrainStep(model, _poison_loss("torch", poison), opt,
                         loss_scale=loss_scale)
    return step, sched


def _params(pkg, step):
    if pkg == "jax":
        return {k: np.asarray(v).astype(np.float32)
                for k, v in step.params.items()}
    return {k: v.detach().float().numpy() for k, v in step.params.items()}


def _scaler(pkg, step):
    return {k: (float(np.asarray(v)) if k == "scale" else int(np.asarray(v)))
            for k, v in step.scaler_state.items()}


def _run(pkg, model, loss_scale, poisoned=(), steps=2):
    """`steps` steps, poisoning those in `poisoned` (0-based); returns
    (losses, params, [scaler state after each step], [params after each
    step])."""
    poison = {"on": False}
    step, sched = _step(pkg, model, loss_scale, poison)
    ids = _ids()
    losses, scalers, trail = [], [], []
    for i in range(steps):
        if poison["on"] != (i in poisoned):
            poison["on"] = i in poisoned
            if pkg == "jax":
                step._compiled = None        # the loss closure changed
        out = step(ids)
        losses.append(float(np.asarray(out._data if pkg == "jax" else out)))
        sched.step()
        scalers.append(_scaler(pkg, step))
        trail.append(_params(pkg, step))
    return losses, trail[-1], scalers, trail


def test_static_scale_gives_the_unscaled_trajectory():
    _, tm = _models()
    _, tm2 = _models()
    l1, p1, _, _ = _run("torch", tm, None)
    l2, p2, sc, _ = _run("torch", tm2, 1024.0)
    for a, b in zip(l2, l1):
        assert abs(a - b) <= 1e-6 * abs(b), (l2, l1)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=2e-5, atol=1e-6)
    assert sc[-1] == {"scale": 1024.0, "good": 2, "bad": 0}


def test_static_scale_matches_jax_train_step():
    jm, tm = _models()
    jl, jp, js, _ = _run("jax", jm, 1024.0)
    tl, tp, ts, _ = _run("torch", tm, 1024.0)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-6 * abs(b), (tl, jl)
    assert tl[1] < tl[0]
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert np.abs(tp[k] - jp[k]).max() <= 5e-2 * sum(LRS), k
    assert ts == js


def _grad_scaler():
    """A GradScaler's knobs, as the JAX package's `amp.GradScaler` holds
    them: the port's TrainStep reads the same attributes."""
    from paddle_tpu.amp import GradScaler
    return GradScaler(init_loss_scaling=256.0, incr_every_n_steps=2,
                      decr_every_n_nan_or_inf=1)


def test_dynamic_scale_skips_poisoned_steps_and_grows_as_jax():
    """good, good (the scale doubles), poisoned (skipped: params as
    before, the scale halves), good: scaler_state equal to the JAX
    step's after every step; params after the good steps within the fp32
    limits."""
    pytest.importorskip("jax")
    jm, tm = _models()
    jl, jp, js, jtrail = _run("jax", jm, _grad_scaler(), poisoned=(2,),
                              steps=4)
    tl, tp, ts, ttrail = _run("torch", tm, _grad_scaler(), poisoned=(2,),
                              steps=4)
    assert ts == js
    assert [s["scale"] for s in ts] == [256.0, 512.0, 256.0, 256.0]
    for k in ttrail[1]:
        assert np.array_equal(ttrail[2][k], ttrail[1][k]), k
    for i in (0, 1, 3):
        assert abs(tl[i] - jl[i]) <= 1e-6 * abs(jl[i]), (tl, jl)
    assert not np.isfinite(tl[2]) and not np.isfinite(jl[2])
    lr_sum = sum(LRS) + 1e-3          # the three good steps' lr
    for k in jp:
        assert np.abs(tp[k] - jp[k]).max() <= 5e-2 * lr_sum, k


def test_dynamic_string_and_state_dict_layout():
    """loss_scale="dynamic": the JAX step's defaults (2^15, grow after
    1000 good steps, halve after 2 bad ones); `state_dict()["scaler"]`
    laid out as the JAX step's and restored by `set_state_dict`."""
    jm, tm = _models()
    _, _, js, _ = _run("jax", jm, "dynamic", poisoned=(0,), steps=2)
    _, _, ts, _ = _run("torch", tm, "dynamic", poisoned=(0,), steps=2)
    assert ts == js == [{"scale": 2.0 ** 15, "good": 0, "bad": 1},
                        {"scale": 2.0 ** 15, "good": 1, "bad": 0}]
    step, _ = _step("torch", tm, "dynamic", {"on": False})
    sd = step.state_dict()
    assert sorted(sd["scaler"]) == ["bad", "good", "scale"]
    assert sd["scaler"]["scale"].dtype == torch.float32
    assert sd["scaler"]["good"].dtype == sd["scaler"]["bad"].dtype \
        == torch.int32
    sd["scaler"] = {"scale": 8.0, "good": 3, "bad": 1}
    step.set_state_dict(sd)
    assert _scaler("torch", step) == {"scale": 8.0, "good": 3, "bad": 1}
    assert "scaler" not in TrainStep(
        tm, lambda m, x: m(x).sum(), AdamW()).state_dict()
