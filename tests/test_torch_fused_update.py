"""The fused optimizer update of the PyTorch port (`ops/fused_update.py`:
U1, the clip's and the loss scaler's reduction, and U2, the Adam / AdamW
update) against the per-parameter rule it replaces and against the JAX
package.

On the CPU the wrapper runs `fused_update_plain`; it is held to:
* `Optimizer.per_param_update` (the clip over all gradients, then
  `update_rule` per parameter, op by op): bitwise, in fp32 and bf16 — the
  same operations, rounded at the same places;
* the JAX package's `Adam` / `AdamW.functional_update` with
  `ClipGradByGlobalNorm._clip_arrays`, as its `TrainStep` calls them:
  fp32 params and moments within 1e-6 of each tensor's max |JAX|; bf16
  ones within one bf16 step (2^-7 relative) of the JAX value, element by
  element (the limits of tests/test_torch_optimizer.py).

Cases: fp32, bf16 with bf16 moments and bf16 with `multi_precision`;
Adam (L2 decay in the gradient) and AdamW; the clip active, inactive and
absent; after steps 1 and 3.  A gradient of None takes a zero gradient
(the JAX step's AD); under a loss scale a non-finite gradient leaves
params and moments bitwise unchanged, and a power-of-two scale on
gradients scaled by it gives the unscaled update bitwise.  Inputs are
made with numpy from a seed.

On the card (`gpu` marker, skipped here): U1 and U2 against the plain
versions, the limits of `ops/fused_update.py` (global norm within 1e-6
relative; p, m and v within one ulp of their dtype given U1's scalars),
bitwise over two calls, and a found_inf call that writes nothing."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import fused_update as FU
from paddle_tpu_torch.optimizer import Adam, AdamW

SHAPES = {"w": (8, 16), "b": (16,), "e": (5, 4, 3), "t": (37,)}
MODES = {"fp32": ("float32", False), "bf16": ("bfloat16", False),
         "bf16_multi_precision": ("bfloat16", True)}
CLIPS = {"active": 0.5, "inactive": 1e3, "none": None}
LRS = (1e-3, 7e-4, 3e-4)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch_tree(arrays, dtype):
    return {k: torch.from_numpy(v).to(getattr(torch, dtype))
            for k, v in arrays.items()}


def _opt(name, multi_precision, clip, pkg="torch"):
    kw = dict(learning_rate=1e-3, weight_decay=0.05,
              multi_precision=multi_precision)
    if pkg == "jax":
        import paddle_tpu.optimizer as jopt
        from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
        cls = jopt.AdamW if name == "adamw" else jopt.Adam
        return cls(grad_clip=JClip(clip) if clip else None, **kw)
    cls = AdamW if name == "adamw" else Adam
    return cls(grad_clip=ClipGradByGlobalNorm(clip) if clip else None, **kw)


def _close(got, want, dtype):
    """fp32: within 1e-6 of max|want|; bf16: one bf16 step (2^-7 x
    |want|) element by element."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if dtype == "float32":
        return np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(),
                                                      1e-30)
    step = np.maximum(np.abs(want), 1e-30) * 2.0 ** -7
    return bool((np.abs(got - want) <= step).all())


def _grads(step, dtype, none=()):
    g = _torch_tree(_tree(step), dtype)
    return {k: (None if k in none else v) for k, v in g.items()}


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_the_per_parameter_rule_bitwise(mode, name, clip):
    dtype, mp = MODES[mode]
    fused, ref = (_opt(name, mp, CLIPS[clip]) for _ in range(2))
    pf = _torch_tree(_tree(0, 0.02), dtype)
    pr = {k: v.clone() for k, v in pf.items()}
    sf, sr = fused.functional_init(pf), ref.functional_init(pr)
    for step, lr in enumerate(LRS, start=1):
        out = fused.functional_update(pf, _grads(step, dtype), sf, lr, step)
        ref.per_param_update(pr, _grads(step, dtype), sr, lr, step)
        assert (out["clip_scale"] is None) == (CLIPS[clip] is None)
        if clip == "inactive":
            assert float(out["clip_scale"]) == 1.0
        if clip == "active":
            assert float(out["clip_scale"]) < 1.0
        if step in (1, 3):
            for k in SHAPES:
                assert torch.equal(pf[k], pr[k]), (step, k)
                for m in ("moment1", "moment2"):
                    assert sf[k][m].dtype == (torch.float32 if mp
                                              else pf[k].dtype)
                    assert torch.equal(sf[k][m], sr[k][m]), (step, k, m)


def _jax_run(name, mp, clip, dtype, none=()):
    """Three steps of the JAX functional update on the same arrays
    (gradients of `none` are zeros: what the JAX step's AD gives a
    parameter the loss does not reach); {step: (params, state)}."""
    import jax.numpy as jnp
    jo = _opt(name, mp, clip, pkg="jax")
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in
          _tree(0, 0.02).items()}
    js = jo.functional_init(jp)
    out = {}
    for step, lr in enumerate(LRS, start=1):
        jg = {k: jnp.zeros_like(jp[k]) if k in none
              else jnp.asarray(v).astype(dtype)
              for k, v in _tree(step).items()}
        jp, js = jo.functional_update(jp, jg, js,
                                      jnp.asarray(lr, jnp.float32),
                                      jnp.asarray(step, jnp.int32))
        out[step] = (
            {k: np.asarray(v.astype(jnp.float32)) for k, v in jp.items()},
            {k: {m: np.asarray(v.astype(jnp.float32)) for m, v in st.items()}
             for k, st in js.items()})
    return out


def _assert_close_to_jax(pf, sf, jax_step, dtype, mp, where):
    jparams, jstate = jax_step
    for k in SHAPES:
        assert _close(pf[k].float().numpy(), jparams[k], dtype), (where, k)
        for m in ("moment1", "moment2"):
            assert _close(sf[k][m].float().numpy(), jstate[k][m],
                          "float32" if mp else dtype), (where, k, m)


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_jax_functional_update(mode, name, clip):
    pytest.importorskip("jax")
    dtype, mp = MODES[mode]
    ref = _jax_run(name, mp, CLIPS[clip], dtype)
    opt = _opt(name, mp, CLIPS[clip])
    pf = _torch_tree(_tree(0, 0.02), dtype)
    sf = opt.functional_init(pf)
    for step, lr in enumerate(LRS, start=1):
        opt.functional_update(pf, _grads(step, dtype), sf, lr, step)
        if step in (1, 3):
            _assert_close_to_jax(pf, sf, ref[step], dtype, mp, step)


@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("mode", list(MODES))
def test_none_gradient_is_a_zero_gradient(mode, name):
    """A parameter without a gradient: the JAX step's zero gradient (its
    moments decay, the L2 term and the decoupled decay apply, it adds 0
    to the norm), against JAX and bitwise against the per-parameter
    rule fed explicit zeros."""
    pytest.importorskip("jax")
    dtype, mp = MODES[mode]
    none = ("b", "t")
    ref = _jax_run(name, mp, 0.5, dtype, none=none)
    fused, rule = _opt(name, mp, 0.5), _opt(name, mp, 0.5)
    pf = _torch_tree(_tree(0, 0.02), dtype)
    pr = {k: v.clone() for k, v in pf.items()}
    sf, sr = fused.functional_init(pf), rule.functional_init(pr)
    for step, lr in enumerate(LRS, start=1):
        fused.functional_update(pf, _grads(step, dtype, none), sf, lr, step)
        rule.per_param_update(
            pr, {k: torch.zeros_like(pr[k]) if v is None else v
                 for k, v in _grads(step, dtype, none).items()}, sr, lr, step)
        if step in (1, 3):
            _assert_close_to_jax(pf, sf, ref[step], dtype, mp, step)
            for k in SHAPES:
                assert torch.equal(pf[k], pr[k]), (step, k)
                for m in ("moment1", "moment2"):
                    assert torch.equal(sf[k][m], sr[k][m]), (step, k, m)


@pytest.mark.parametrize("mode", list(MODES))
def test_loss_scale_unscales_and_skips_non_finite(mode):
    """Gradients scaled by 1024 under `scale=1024`: the unscaled update,
    bitwise (a power of two scales exactly).  Then a step with one
    infinite gradient: found_inf, and every param and moment bitwise as
    before."""
    dtype, mp = MODES[mode]
    ref_opt, opt = _opt("adamw", mp, 0.5), _opt("adamw", mp, 0.5)
    pr = _torch_tree(_tree(0, 0.02), dtype)
    pf = {k: v.clone() for k, v in pr.items()}
    sr, sf = ref_opt.functional_init(pr), opt.functional_init(pf)
    scale = torch.tensor(1024.0)
    for step, lr in enumerate(LRS[:2], start=1):
        ref_opt.functional_update(pr, _grads(step, dtype), sr, lr, step)
        scaled = {k: v * 1024 for k, v in _grads(step, dtype).items()}
        out = opt.functional_update(pf, scaled, sf, lr, step, scale=scale)
        assert not bool(out["found_inf"])
        assert float(out["inv_scale"]) == 2.0 ** -10
    for k in SHAPES:
        assert torch.equal(pf[k], pr[k]), k
        for m in ("moment1", "moment2"):
            assert torch.equal(sf[k][m], sr[k][m]), (k, m)
    before = ({k: v.clone() for k, v in pf.items()},
              {k: {m: t.clone() for m, t in st.items()}
               for k, st in sf.items()})
    bad = _grads(3, dtype)
    bad["e"][1, 2, 0] = float("inf")
    out = opt.functional_update(pf, bad, sf, LRS[2], 3, scale=scale)
    assert bool(out["found_inf"])
    for k in SHAPES:
        assert torch.equal(pf[k], before[0][k]), k
        for m in ("moment1", "moment2"):
            assert torch.equal(sf[k][m], before[1][k][m]), (k, m)


def test_checks_raise_on_what_the_kernels_do_not_take():
    p = torch.zeros(4, 4)
    m = torch.zeros(4, 4)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
              decoupled=True, step=1)
    with pytest.raises(ValueError, match="contiguous"):
        FU.fused_update([p], [torch.zeros(4, 4).t()], [m], [m.clone()], **kw)
    with pytest.raises(ValueError, match="gradient"):
        FU.fused_update([p], [torch.zeros(4, 4, dtype=torch.bfloat16)],
                        [m], [m.clone()], **kw)
    with pytest.raises(ValueError, match="moments"):
        FU.fused_update([p.bfloat16()], [None],
                        [torch.zeros(4, 4, dtype=torch.float16)],
                        [torch.zeros(4, 4, dtype=torch.float16)], **kw)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        FU.fused_update([p.half()], [None], [m.half()], [m.half()], **kw)


# ---------------------------------------------------------------- card

def _ulps(got, want):
    """|got - want| in units of the last place of `want`'s dtype at
    |want| (its smallest normal step at 0)."""
    fi = torch.finfo(want.dtype)
    w = want.float().abs().clamp_min(fi.tiny)
    ulp = torch.exp2(torch.floor(torch.log2(w))) * fi.eps
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _card_case(dtype, mp, name, gen):
    """Parameters over several chunks, with ragged tails, one without a
    gradient and one contiguous but not 16-byte aligned (a view one
    element into its buffer: the element-by-element path)."""
    ps = [torch.randn(s, generator=gen, device="cuda").mul_(0.02).to(dtype)
          for s in ((512, 300), (1000,), (7, 13), (64, 64), (2001,))]
    ps[4] = ps[4][1:]
    gs = [torch.randn(p.shape, generator=gen, device="cuda").to(dtype)
          for p in ps]
    gs[2] = None
    md = torch.float32 if mp else dtype
    ms = [(0.1 * torch.randn(p.shape, generator=gen, device="cuda")).to(md)
          for p in ps]
    vs = [(0.01 * torch.randn(p.shape, generator=gen, device="cuda") ** 2)
          .to(md) for p in ps]
    hp = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.05,
              decoupled=name == "adamw", step=3)
    return ps, gs, ms, vs, hp


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("mode", list(MODES))
def test_kernels_match_plain_on_the_card(mode, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (U1 / U2 have no interpret mode)")
    dtype, mp = MODES[mode]
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ps, gs, ms, vs, hp = _card_case(dtype, mp, name, gen)
    scale = torch.tensor(1024.0, device="cuda")
    gs = [None if g is None else g * 1024 for g in gs]
    copies = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    out = FU.fused_update(ps, gs, ms, vs, clip_norm=1.0, scale=scale, **hp)
    ref = FU.reduce_plain(gs, scale, 1.0)
    assert abs(out["global_norm"].item() - ref["global_norm"].item()) \
        <= 1e-6 * ref["global_norm"].item()
    assert not out["found_inf"].item()
    pp, pm, pv = copies
    FU.update_plain(pp, gs, pm, pv, clip_scale=out["clip_scale"],
                    inv_scale=out["inv_scale"], found_inf=out["found_inf"],
                    **hp)
    for got, want in zip(ps + ms + vs, pp + pm + pv):
        assert _ulps(got, want) <= 1.0
    # bitwise over two calls on the same inputs
    again = [[t.clone() for t in ts] for ts in copies]
    for run in (copies, again):
        FU.fused_update(*run[:1], gs, *run[1:], clip_norm=1.0, scale=scale,
                        **hp)
    for a, b in zip(sum(copies, []), sum(again, [])):
        assert torch.equal(a, b)
    # a non-finite gradient: nothing written
    gs[0] = gs[0].clone()
    gs[0].view(-1)[5] = float("nan")
    before = [t.clone() for t in ps + ms + vs]
    out = FU.fused_update(ps, gs, ms, vs, clip_norm=1.0, scale=scale, **hp)
    assert out["found_inf"].item()
    for a, b in zip(ps + ms + vs, before):
        assert torch.equal(a, b)
