"""The training path of the PyTorch port against the JAX package:
`LlamaForCausalLM.forward` -> `LlamaPretrainingCriterion` -> backward ->
`ClipGradByGlobalNorm` -> `AdamW` under `LinearWarmup`, driven by
`jit.trainer.TrainStep`.  Weights cross by name
(`load_reference_arrays`); token ids are made with numpy from a seed.

Tolerances:
* debug-4l in fp32: logits within 1e-4 absolute, the loss within 1e-5
  relative, every parameter's gradient within 1e-4 of that gradient's
  max |reference| (fp32 sums in another order through four layers);
* the two-step TrainStep trajectory.  Adam normalises every element's
  update to ~lr, so an element whose gradient is small against its
  tensor's largest carries that gradient's relative rounding error into
  its update: a 1e-6 difference in the gradients (fp32) becomes a
  percent of lr in such elements.  In fp32: each loss within 1e-6
  relative, every parameter element within 5e-2 x (the summed lr) of the
  JAX value.  In bf16 (`tiny`) the forward rounds at other places in XLA
  and PyTorch (XLA keeps some bf16 chains in fp32), the gradients differ
  by ~1 %, and small elements may step the other way: each loss within
  1e-3 relative, at least 98 % of every parameter's elements within one
  bf16 step (2^-7 relative) of the JAX value, and none further than two
  Adam steps the other way (2.5 x the summed lr, + a bf16 step).  The
  update rule's own rounding is pinned element by element in
  tests/test_torch_optimizer.py;
* recompute ("full") against none: bitwise (the same ops in the same
  order on the CPU);
* recompute "dots" (the dense products' outputs saved, the rest
  recomputed) in both packages, dense (`tiny`) and MoE
  (`qwen2-moe-tiny`), the two-step TrainStep trajectory within the fp32
  limits above; against the port's step without recompute, bitwise."""

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


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _models(preset, seed=0, **overrides):
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(seed)
    jm = LlamaForCausalLM(LlamaConfig.from_preset(preset, **overrides))
    tm = TModel(TConfig.from_preset(preset, **overrides), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _ids(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _jax_loss_and_grads(jm, ids):
    """(loss, logits, {name: grad}) of the JAX model, differentiated the
    way its TrainStep does it (bound parameter arrays, jax.grad)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor, no_grad
    from paddle_tpu.jit.trainer import bind_state, collect_state
    from paddle_tpu.models.llama import _causal_lm_loss_raw
    params, _, _ = collect_state(jm)

    def f(p):
        with bind_state(params, p), no_grad():
            logits = jm(Tensor(jnp.asarray(ids)))
            loss = _causal_lm_loss_raw(logits, Tensor(jnp.asarray(ids)))
            return loss._data, logits._data

    (loss, logits), grads = jax.value_and_grad(f, has_aux=True)(
        {k: t._data for k, t in params.items()})
    return float(loss), np.asarray(logits, np.float32), \
        {k: np.asarray(g, np.float32) for k, g in grads.items()}


def _port_loss_and_grads(tm, ids):
    tids = torch.from_numpy(ids)
    logits = tm(tids)
    loss = LlamaPretrainingCriterion()(logits, tids)
    loss.backward()
    return loss.item(), logits.detach().float().numpy(), \
        {n: p.grad.float().numpy() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("preset,tied", [("debug-4l", False),
                                         ("tiny", True)])
def test_forward_loss_and_every_grad_match_jax(preset, tied):
    """Untied head at debug-4l, tied head (logits = h . embed^T) at
    tiny, both fp32."""
    jm, tm = _models(preset, tie_word_embeddings=tied)
    ids = _ids(tm.config, 2, 64, seed=1)
    jl, jlogits, jg = _jax_loss_and_grads(jm, ids)
    tl, tlogits, tg = _port_loss_and_grads(tm, ids)
    assert np.abs(tlogits - jlogits).max() <= 1e-4
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        err = np.abs(tg[n] - jg[n]).max()
        assert err <= 1e-4 * np.abs(jg[n]).max(), (n, err)


def _train(pkg, model, cfg, ids, steps, loss_fn=None, **opt_kw):
    """`steps` TrainSteps of AdamW(LinearWarmup) + global-norm clip in
    package `pkg` ("jax" or "torch") on `loss_fn` (default: the causal-LM
    criterion), AdamW taking `opt_kw` besides; returns (losses, {name:
    param})."""
    if pkg == "jax":
        import paddle_tpu.optimizer as jopt
        from paddle_tpu.jit.trainer import TrainStep as JStep
        from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
        from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
        sched = jopt.lr.LinearWarmup(1e-3, warmup_steps=2, start_lr=2e-4,
                                     end_lr=1e-3)
        opt = jopt.AdamW(learning_rate=sched, weight_decay=0.01,
                         parameters=model.parameters(), grad_clip=JClip(0.5),
                         **opt_kw)
        crit, step_cls = JCrit(), JStep
    else:
        sched = tlr.LinearWarmup(1e-3, warmup_steps=2, start_lr=2e-4,
                                 end_lr=1e-3)
        opt = AdamW(learning_rate=sched, weight_decay=0.01,
                    parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(0.5), **opt_kw)
        crit, step_cls = LlamaPretrainingCriterion(), TrainStep
    step = step_cls(model, loss_fn or (lambda m, x: crit(m(x), x)), opt)
    losses = []
    for _ in range(steps):
        losses.append(float(np.asarray(step(ids)._data if pkg == "jax"
                                       else step(ids))))
        sched.step()
    if pkg == "jax":
        params = {k: np.asarray(v).astype(np.float32)
                  for k, v in step.params.items()}
    else:
        params = {k: v.detach().float().numpy()
                  for k, v in step.params.items()}
    return losses, params


LRS = (2e-4, 6e-4)      # LinearWarmup(2e-4 -> 1e-3 over 2 steps)


@pytest.mark.parametrize("preset,dtype", [("debug-4l", "float32"),
                                          ("tiny", "bfloat16")])
def test_two_step_trajectory_matches_jax_train_step(preset, dtype):
    jm, tm = _models(preset, dtype=dtype)
    ids = _ids(tm.config, 2, 32, seed=2)
    jl, jp = _train("jax", jm, tm.config, ids, 2)
    tl, tp = _train("torch", tm, tm.config, ids, 2)
    rel = 1e-6 if dtype == "float32" else 1e-3
    for a, b in zip(tl, jl):
        assert abs(a - b) <= rel * abs(b), (tl, jl)
    assert tl[1] < tl[0]
    assert sorted(tp) == sorted(jp)
    for n in jp:
        err = np.abs(tp[n] - jp[n])
        if dtype == "float32":
            assert err.max() <= 5e-2 * sum(LRS), (n, err.max())
        else:
            step = np.abs(jp[n]) * 2.0 ** -7
            assert (err <= step).mean() >= 0.98, n
            assert (err <= 2.5 * sum(LRS) + step).all(), n


def test_lazy_mode_trajectory_matches_jax_train_step():
    """AdamW(lazy_mode=True), accepted in both packages and running
    their dense update: the two-step debug-4l fp32 trajectory against
    the JAX TrainStep, within the fp32 limits above."""
    jm, tm = _models("debug-4l")
    ids = _ids(tm.config, 2, 32, seed=2)
    jl, jp = _train("jax", jm, tm.config, ids, 2, lazy_mode=True)
    tl, tp = _train("torch", tm, tm.config, ids, 2, lazy_mode=True)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-6 * abs(b), (tl, jl)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        assert np.abs(tp[n] - jp[n]).max() <= 5e-2 * sum(LRS), n


def test_unreached_parameter_matches_jax_train_step():
    """A loss on the decoder's hidden states (their mean squared distance
    to fixed random targets) that never reaches lm_head: the JAX step's AD
    gives lm_head a zero gradient (its moments stay 0, it adds 0 to the
    global norm, AdamW's decoupled decay still moves it); the port's
    `.grad` is None.  Two steps against the JAX TrainStep, within the
    fp32 limits above."""
    import paddle_tpu as paddle
    jm, tm = _models("debug-4l")
    ids = _ids(tm.config, 2, 32, seed=2)
    r = np.random.default_rng(3).normal(
        size=(2, 32, tm.config.hidden_size)).astype(np.float32)
    head0 = tm.lm_head.weight.detach().clone().numpy()
    jl, jp = _train("jax", jm, tm.config, ids, 2,
                    loss_fn=lambda m, x: ((m.llama(x) - paddle.to_tensor(r))
                                          ** 2).mean())
    tl, tp = _train("torch", tm, tm.config, ids, 2,
                    loss_fn=lambda m, x: ((m.llama(x) - torch.from_numpy(r))
                                          ** 2).mean())
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-6 * abs(b), (tl, jl)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        assert np.abs(tp[n] - jp[n]).max() <= 5e-2 * sum(LRS), n
    assert not np.array_equal(tp["lm_head.weight"], head0)


def test_recompute_full_gives_the_same_grads():
    torch.manual_seed(0)
    grads = []
    for remat in (False, True):
        cfg = TConfig.from_preset("debug-4l", recompute=remat)
        tm = TModel(cfg, device="cpu", seed=3)
        ids = _ids(cfg, 2, 48, seed=4)
        _, _, g = _port_loss_and_grads(tm, ids)
        grads.append(g)
    for n in grads[0]:
        np.testing.assert_array_equal(grads[0][n], grads[1][n])


def _dots_kw(preset):
    kw = {"recompute": True, "recompute_policy": "dots"}
    return dict(kw, moe_dropless=True) if "moe" in preset else kw


@pytest.mark.parametrize("preset", ["tiny", "qwen2-moe-tiny"])
def test_dots_recompute_trajectory_matches_jax_train_step(preset):
    """recompute_policy "dots" in both packages (JAX's
    dots_with_no_batch_dims_saveable; the port's selective checkpoint
    saving aten.mm / addmm): two TrainSteps, the fp32 limits above; the
    MoE model on llama_loss_fn, aux loss included."""
    from paddle_tpu.models.llama import llama_loss_fn as jloss_fn
    from paddle_tpu_torch.models.llama import llama_loss_fn
    jm, tm = _models(preset, **_dots_kw(preset))
    moe = "moe" in preset
    ids = _ids(tm.config, 2, 16, seed=2)
    jl, jp = _train("jax", jm, tm.config, ids, 2,
                    loss_fn=jloss_fn if moe else None)
    tl, tp = _train("torch", tm, tm.config, ids, 2,
                    loss_fn=llama_loss_fn if moe else None)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-6 * abs(b), (tl, jl)
    assert tl[1] < tl[0]
    assert sorted(tp) == sorted(jp)
    for n in jp:
        assert np.abs(tp[n] - jp[n]).max() <= 5e-2 * sum(LRS), n


@pytest.mark.parametrize("preset", ["tiny", "qwen2-moe-tiny"])
def test_dots_recompute_gives_bitwise_the_same_loss_and_grads(preset):
    """"dots" against no recompute on the CPU: the loss (the MoE aux loss
    crossing the checkpoint as an output) and every gradient bitwise.
    Its backward recomputes no dense product (as many aten.mm as without
    recompute, fewer than "full") and recomputes the batched ones (more
    aten.bmm)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from paddle_tpu_torch.models.llama import llama_loss_fn

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    out = {}
    for policy in (None, "full", "dots"):
        kw = _dots_kw(preset)
        kw.update(recompute=policy is not None,
                  recompute_policy=policy or "full")
        tm = TModel(TConfig.from_preset(preset, **kw), device="cpu", seed=3)
        ids = torch.from_numpy(_ids(tm.config, 2, 20, seed=4))
        loss = llama_loss_fn(tm, ids)
        with Count() as c:
            loss.backward()
        out[policy] = (loss.item(), {n: p.grad.clone()
                                     for n, p in tm.named_parameters()},
                       c.n.get(torch.ops.aten.mm.default, 0),
                       c.n.get(torch.ops.aten.bmm.default, 0))
    (l0, g0, mm0, bmm0), (l1, g1, mm1, bmm1) = out[None], out["dots"]
    assert l1 == l0
    for n, g in g0.items():
        assert torch.equal(g, g1[n]), n
    assert mm1 == mm0 < out["full"][2]
    assert bmm1 > bmm0


def test_state_dict_roundtrip_replays_a_step():
    """Snapshot after step 1, run step 2, restore, run step 2 again:
    the same parameters and the same step counter (bitwise on the CPU)."""
    cfg = TConfig.from_preset("tiny")
    tm = TModel(cfg, device="cpu", seed=5)
    crit = LlamaPretrainingCriterion()
    step = TrainStep(tm, lambda m, x: crit(m(x), x),
                     AdamW(learning_rate=1e-3,
                           grad_clip=ClipGradByGlobalNorm(1.0)))
    ids = _ids(cfg, 2, 16, seed=6)
    step(ids)
    snap = step.state_dict()
    step(ids)
    after = {k: v.clone() for k, v in step.params.items()}
    step.set_state_dict(snap)
    assert step.step_i == 1
    step(ids)
    for k in after:
        torch.testing.assert_close(step.params[k], after[k], rtol=0, atol=0)
    step.sync_to_model()               # a documented no-op
    assert step.params["lm_head.weight"] is tm.lm_head.weight


@pytest.mark.parametrize("knob", ["sequence_parallel", "mesh",
                                  "shard_rules", "dropout",
                                  "sdpa_dropout", "lr_ratio",
                                  "apply_decay_param_fun",
                                  "weight_decay_object"])
def test_unported_knobs_raise_naming_roadmap(knob):
    import paddle_tpu_torch.ops.flash_attention as FA
    cfg = TConfig.from_preset("tiny")
    with pytest.raises(NotImplementedError, match="ROADMAP|not ported"):
        if knob == "sequence_parallel":
            tm = TModel(TConfig.from_preset("tiny", sequence_parallel=True),
                        device="cpu")
            tm(torch.zeros(1, 8, dtype=torch.long))
        elif knob in ("mesh", "shard_rules"):
            tm = TModel(cfg, device="cpu")
            TrainStep(tm, lambda m, x: m(x).sum(), AdamW(),
                      **{knob: object()})
        elif knob == "dropout":
            q = torch.zeros(1, 8, 4, 16)
            FA.flash_attention_xla(q, q, q, dropout_p=0.1, training=True)
        elif knob == "sdpa_dropout":
            q = torch.zeros(1, 8, 4, 16)
            FA.scaled_dot_product_attention_raw(q, q, q, dropout_p=0.1)
        elif knob == "lr_ratio":
            AdamW(lr_ratio=lambda p: 1.0)
        elif knob == "apply_decay_param_fun":
            AdamW(apply_decay_param_fun=lambda name: True)
        elif knob == "weight_decay_object":
            AdamW(weight_decay=type("L2Decay", (), {"_coeff": 0.01})())
    with pytest.raises(ValueError):
        TModel(TConfig.from_preset("tiny", recompute=True,
                                   recompute_policy="some"), device="cpu")
