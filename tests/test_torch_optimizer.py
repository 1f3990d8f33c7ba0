"""The training slice's optimizer pieces of the PyTorch port
(paddle_tpu_torch/optimizer/, nn/clip.py) against the JAX package's:
Adam / AdamW updates through `functional_update` as the JAX `TrainStep`
calls it (lr an fp32 array, the step an int32 one, 64-bit types on),
with and without `multi_precision`, in fp32 and bf16; the LR schedules;
the global-norm clip.

Inputs are made with numpy from a seed.  Tolerances: fp32 params and
moments within 1e-6 relative to each tensor's max (the same expressions,
fp32 rounding at the same places); bf16 params and moments within one
bf16 step (2^-7 relative) of the JAX value, element by element — XLA may
keep a bf16 chain in fp32 between ops where PyTorch rounds after each
one; LR sequences exactly equal (the same host arithmetic)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW, lr as tlr

SHAPES = {"w": (8, 16), "b": (16,), "e": (5, 4, 3)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _ulp_ok(got, want, dtype):
    """fp32: |got - want| <= 1e-6 * max|want|.  bf16: |got - want| <=
    one bf16 step at |want| (2^-7 relative, floored at the tensor's
    smallest normal step)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if dtype == "float32":
        return np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(),
                                                      1e-30)
    step = np.maximum(np.abs(want), 1e-30) * 2.0 ** -7
    return bool((np.abs(got - want) <= step).all())


def _jax_opt(name, multi_precision, clip=None):
    pytest.importorskip("jax")
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
    kw = dict(learning_rate=1e-3, multi_precision=multi_precision,
              grad_clip=JClip(clip) if clip else None)
    if name == "adamw":
        return jopt.AdamW(weight_decay=0.05, **kw)
    return jopt.Adam(weight_decay=0.05, **kw)       # L2 decay in the grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("multi_precision", [False, True])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_update_matches_jax_functional_update(name, multi_precision, dtype):
    jo = _jax_opt(name, multi_precision, clip=0.5)
    import jax.numpy as jnp
    cls = AdamW if name == "adamw" else Adam
    to = cls(learning_rate=1e-3, weight_decay=0.05,
             multi_precision=multi_precision,
             grad_clip=ClipGradByGlobalNorm(0.5))
    params = _tree(0, 0.02)
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in params.items()}
    js, ts = jo.functional_init(jp), to.functional_init(tp)
    for step, lr in enumerate([1e-3, 7e-4, 3e-4], start=1):
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
            ok = _ulp_ok(tp[k].float().numpy(),
                         np.asarray(jp[k].astype(jnp.float32)), dtype)
            assert ok, (step, k)
            for m in ("moment1", "moment2"):
                assert ts[k][m].dtype == (torch.float32 if multi_precision
                                          else getattr(torch, dtype))
                ok = _ulp_ok(ts[k][m].float().numpy(),
                             np.asarray(js[k][m].astype(jnp.float32)),
                             "float32" if multi_precision else dtype)
                assert ok, (step, k, m)


@pytest.mark.parametrize("name,flag", [("adam", "use_multi_tensor"),
                                       ("adamw", "lazy_mode")])
def test_lazy_and_multi_tensor_flags_run_the_dense_update(name, flag):
    """`Adam(use_multi_tensor=True)` and `AdamW(lazy_mode=True)` are
    accepted, as the JAX package accepts them, and run its one dense
    per-parameter update: bitwise the parameters and moments of the
    defaults after two steps."""
    cls = AdamW if name == "adamw" else Adam
    runs = []
    for kw in ({}, {flag: True}):
        opt = cls(learning_rate=1e-3, weight_decay=0.05,
                  grad_clip=ClipGradByGlobalNorm(0.5), **kw)
        params = {k: torch.from_numpy(v) for k, v in _tree(0, 0.02).items()}
        state = opt.functional_init(params)
        for step, lr in enumerate([1e-3, 7e-4], start=1):
            grads = {k: torch.from_numpy(v) for k, v in _tree(step).items()}
            opt.functional_update(params, grads, state, lr, step)
        runs.append((params, state))
    (p0, s0), (p1, s1) = runs
    for k in SHAPES:
        assert torch.equal(p0[k], p1[k]), k
        for m in ("moment1", "moment2"):
            assert torch.equal(s0[k][m], s1[k][m]), (k, m)


def test_decay_uses_the_old_param():
    """AdamW with zero gradients and zero moments: the update is exactly
    p - lr * wd * p (the Adam part adds 0 / (0 + eps) = 0)."""
    p = {"w": torch.linspace(-1, 1, 11)}
    opt = AdamW(learning_rate=0.5, weight_decay=0.1)
    st = opt.functional_init(p)
    want = p["w"] - np.float32(0.5 * np.float32(0.1)) * p["w"]
    opt.functional_update(p, {"w": torch.zeros(11)}, st, 0.5, 1)
    torch.testing.assert_close(p["w"], want, rtol=0, atol=0)


def _sequence(sched, n=12):
    out = []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


@pytest.mark.parametrize("kind", ["warmup", "cosine", "warmup+cosine"])
def test_lr_schedules_match_jax(kind):
    pytest.importorskip("jax")
    from paddle_tpu.optimizer import lr as jlr

    def build(m):
        if kind == "cosine":
            return m.CosineAnnealingDecay(0.1, T_max=7, eta_min=0.01)
        inner = m.CosineAnnealingDecay(0.1, T_max=7) \
            if kind == "warmup+cosine" else 0.1
        return m.LinearWarmup(inner, warmup_steps=4, start_lr=0.0,
                              end_lr=0.1)

    assert _sequence(build(tlr)) == _sequence(build(jlr))


def test_lr_state_dict_roundtrip():
    s = tlr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1)
    _sequence(s, 3)
    t = tlr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1)
    t.set_state_dict(s.state_dict())
    assert _sequence(t, 5) == _sequence(s, 5)


@pytest.mark.parametrize("scale", [0.01, 10.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_clip_matches_jax(dtype, scale):
    """Below and above the clip norm (1.0)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
    grads = _tree(3, scale)
    jg = JClip(1.0)._clip_arrays({k: jnp.asarray(v).astype(dtype)
                                  for k, v in grads.items()})
    tg = ClipGradByGlobalNorm(1.0)._clip_arrays(
        {k: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in grads.items()})
    for k in SHAPES:
        assert tg[k].dtype == getattr(torch, dtype)
        assert _ulp_ok(tg[k].float().numpy(),
                       np.asarray(jg[k].astype(jnp.float32)), dtype), k
