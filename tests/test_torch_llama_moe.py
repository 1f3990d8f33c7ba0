"""The MoE Llama of the port against the JAX package: `qwen2-moe-tiny`
(8 experts, top-2, a shared expert) in fp32, weights carried across by
name, through `LlamaForCausalLM.forward` -> `llama_loss_fn` (the causal
LM loss plus the layers' summed aux loss) -> backward, and two AdamW
`TrainStep`s.  The JAX side runs its grouped matmul in Pallas interpret
mode on the CPU.  Token ids come from numpy seeds.

Tolerances (fp32, sums in another order through two MoE layers):
logits within 1e-4 absolute, the loss within 1e-5 relative, every
gradient (router, stacked experts, shared expert, attention,
embeddings) within 1e-4 of that gradient's max |JAX|; after two
TrainSteps each loss within 1e-6 relative and every parameter element
within 5e-2 x the summed lr (Adam scales every element's step to ~lr,
see tests/test_torch_llama_train.py).  Recompute "full" against none
inside the port: bitwise."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig as TConfig
from paddle_tpu_torch.models import LlamaForCausalLM as TModel
from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.models.llama import llama_loss_fn
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, MoELayer
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _models(seed=0, **overrides):
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(seed)
    kw = {"moe_dropless": True, **overrides}
    jm = LlamaForCausalLM(LlamaConfig.from_preset("qwen2-moe-tiny", **kw))
    tm = TModel(TConfig.from_preset("qwen2-moe-tiny", **kw), device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _ids(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


@pytest.mark.parametrize("dropless", [True, False])
def test_moe_forward_loss_and_every_grad_match_jax(dropless):
    """Dropless (grouped matmul) and capacity routing."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor, no_grad
    from paddle_tpu.jit.trainer import bind_state, collect_state
    from paddle_tpu.models.llama import llama_loss_fn as jloss_fn
    jm, tm = _models(moe_dropless=dropless)
    ids = _ids(2, 24, seed=1)
    params, _, _ = collect_state(jm)

    def f(p):
        with bind_state(params, p), no_grad():
            logits = jm(Tensor(jnp.asarray(ids)))._data
            return jloss_fn(jm, Tensor(jnp.asarray(ids)))._data, logits

    (jl, jlogits), jg = jax.value_and_grad(f, has_aux=True)(
        {k: t._data for k, t in params.items()})
    tids = torch.from_numpy(ids)
    tlogits = tm(tids).detach()
    tl = llama_loss_fn(tm, tids)
    tl.backward()
    assert tm.llama.aux_loss() is not None
    assert np.abs(tlogits.numpy() - np.asarray(jlogits)).max() <= 1e-4
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert sorted(tg) == sorted(jg)
    assert any(n.endswith("mlp.w_gate") for n in tg)
    for n in jg:
        want = np.asarray(jg[n])
        err = np.abs(tg[n] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (n, err)


def _train(pkg, model, ids, steps):
    """`steps` TrainSteps of AdamW(LinearWarmup) + global-norm clip on
    `llama_loss_fn` in package `pkg`; returns (losses, {name: param})."""
    if pkg == "jax":
        import paddle_tpu.optimizer as jopt
        from paddle_tpu.jit.trainer import TrainStep as JStep
        from paddle_tpu.models.llama import llama_loss_fn as jloss_fn
        from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
        sched = jopt.lr.LinearWarmup(1e-3, warmup_steps=2, start_lr=2e-4,
                                     end_lr=1e-3)
        opt = jopt.AdamW(learning_rate=sched, weight_decay=0.01,
                         parameters=model.parameters(), grad_clip=JClip(0.5))
        step = JStep(model, jloss_fn, opt)
    else:
        sched = tlr.LinearWarmup(1e-3, warmup_steps=2, start_lr=2e-4,
                                 end_lr=1e-3)
        opt = AdamW(learning_rate=sched, weight_decay=0.01,
                    parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(0.5))
        step = TrainStep(model, llama_loss_fn, opt)
    losses = []
    for _ in range(steps):
        out = step(ids)
        losses.append(float(np.asarray(out._data if pkg == "jax" else out)))
        sched.step()
    if pkg == "jax":
        return losses, {k: np.asarray(v) for k, v in step.params.items()}
    return losses, {k: v.detach().numpy() for k, v in step.params.items()}


LRS = (2e-4, 6e-4)      # LinearWarmup(2e-4 -> 1e-3 over 2 steps)


@pytest.mark.parametrize("recompute", [False, True])
def test_two_step_trajectory_matches_jax_train_step(recompute):
    jm, tm = _models(recompute=recompute)
    ids = _ids(2, 16, seed=2)
    jl, jp = _train("jax", jm, ids, 2)
    tl, tp = _train("torch", tm, ids, 2)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-6 * abs(b), (tl, jl)
    assert tl[1] < tl[0]
    assert sorted(tp) == sorted(jp)
    for n in jp:
        err = np.abs(tp[n] - jp[n]).max()
        assert err <= 5e-2 * sum(LRS), (n, err)


def test_recompute_full_gives_bitwise_the_same_loss_and_grads():
    """The MoE aux loss crosses torch.utils.checkpoint as a return value:
    with recompute "full" the loss (aux included) and every gradient are
    bitwise those without it."""
    out = []
    for remat in (False, True):
        cfg = TConfig.from_preset("qwen2-moe-tiny", moe_dropless=True,
                                  recompute=remat)
        tm = TModel(cfg, device="cpu", seed=3)
        ids = torch.from_numpy(_ids(2, 20, seed=4))
        loss = llama_loss_fn(tm, ids)
        loss.backward()
        assert all(not hasattr(m, "aux_loss") or m.aux_loss is None
                   for m in tm.modules() if isinstance(m, MoELayer))
        out.append((loss.item(), {n: p.grad.clone()
                                  for n, p in tm.named_parameters()}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        assert torch.equal(g, out[1][1][n]), n


def test_switch_gate_is_top1_and_moe_serving_raises():
    from paddle_tpu_torch.inference import LLMEngine
    cfg = TConfig.from_preset("qwen2-moe-tiny", moe_gate="switch",
                              moe_top_k=2)
    tm = TModel(cfg, device="cpu")
    assert tm.llama.layers[0].mlp.top_k == 1
    with pytest.raises(NotImplementedError, match="ROADMAP: queue 1 item 2"):
        LLMEngine(tm)


def test_moe_model_defaults_to_the_card():
    """Built on the CUDA card by default; without one it raises instead
    of running on the host."""
    cfg = TConfig.from_preset("qwen2-moe-tiny", moe_dropless=True)
    if torch.cuda.is_available():
        assert TModel(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TModel(cfg)
