"""MoE routing, dispatch/combine and the MoE layer of the port
(`paddle_tpu_torch/ops/moe_ops.py`, `paddle_tpu_torch/nn/moe.py`)
against the JAX package's `paddle_tpu/ops/moe_ops.py` and
`paddle_tpu/nn/layer/moe.py` (its grouped matmul in Pallas interpret
mode on the CPU).  Inputs come from numpy seeds; layer weights cross by
name (`load_reference_arrays`).

Tolerances, all fp32: the routing integers (top-k indices, positions,
keep masks, dispatch) exactly equal; outputs, aux losses and gradients
within 1e-5 x max|JAX| of each tensor (sums of <= 64 terms in another
order; the softmax / top-k renormalisation add a few ulps)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import load_reference_arrays
from paddle_tpu_torch.nn import MoELayer, SwitchGate
from paddle_tpu_torch.ops import moe_ops as M


def _close(got, want, rel=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops import moe_ops as JM
    return jax, jnp, JM


@pytest.mark.parametrize("k", [1, 2, 4])
def test_topk_breaks_exact_ties_as_jax(k):
    """Exactly tied logits (small integers, as bf16 gate logits over 60
    experts tie): the lower expert index comes first, as jax.lax.top_k."""
    jax, jnp, JM = _jax()
    rs = np.random.RandomState(k)
    logits = rs.randint(0, 3, (64, 60)).astype(np.float32)
    logits[0] = 1.0                                    # all 60 tied
    jp, jv, ji = JM.gate_probs_and_topk(jnp.asarray(logits), k)
    tp, tv, ti = M.gate_probs_and_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == list(range(k))
    _close(tp, jp)
    _close(tv, jv)
    _close(M.load_balance_loss(tp, ti, 60),
           JM.load_balance_loss(jp, ji, 60))


def _routing(T=24, E=4, k=2, seed=0):
    logits = np.random.RandomState(seed).randn(T, E).astype(np.float32)
    return logits, torch.from_numpy(logits)


def test_position_in_expert_and_combine_tensor_match_jax():
    jax, jnp, JM = _jax()
    logits, tl = _routing()
    _, jv, ji = JM.gate_probs_and_topk(jnp.asarray(logits), 2)
    _, tv, ti = M.gate_probs_and_topk(tl, 2)
    for cap in (3, 5, 12):                   # drops at 3 and 5, none at 12
        jpos, jkeep = JM._position_in_expert(jv, ji, 4, cap)
        tpos, tkeep = M._position_in_expert(tv, ti, 4, cap)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        jc, jd = JM.build_combine_tensor(jv, ji, 4, cap)
        tc, td = M.build_combine_tensor(tv, ti, 4, cap)
        _close(tc, jc)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert not tkeep.numpy().all() or cap == 12


def _cap_setup(JM, jnp, cap=5, d=8):
    """Capacity routing with drops, and random x / buf / w / cotangents."""
    logits, tl = _routing()
    T, E, k = 24, 4, 2
    _, jv, ji = JM.gate_probs_and_topk(jnp.asarray(logits), k)
    jpos, jkeep = JM._position_in_expert(jv, ji, E, cap)
    jslot = jnp.where(jkeep, ji * cap + jpos, E * cap)
    jinv = JM._inverse_slots(jslot, E * cap)
    _, tv, ti = M.gate_probs_and_topk(tl, k)
    tpos, tkeep = M._position_in_expert(tv, ti, E, cap)
    tslot = torch.where(tkeep, ti * cap + tpos, E * cap)
    tinv = M._inverse_slots(tslot, E * cap)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    assert not bool(tkeep.all())
    rs = np.random.RandomState(1)
    arrs = {n: rs.randn(*s).astype(np.float32) for n, s in
            (("x", (T, d)), ("buf", (E * cap, d)), ("w", (T, k)),
             ("gd", (E * cap, d)), ("gc", (T, d)))}
    return (jslot, jkeep, jinv), (tslot, tkeep, tinv), arrs


def test_cap_dispatch_and_combine_with_grads_match_jax():
    """The gather-only custom backwards against the JAX custom_vjps."""
    jax, jnp, JM = _jax()
    (js, jk, ji), (ts, tk, tinv), a = _cap_setup(JM, jnp)
    jy, vjp = jax.vjp(lambda x: JM._cap_dispatch(x, js, jk, ji),
                      jnp.asarray(a["x"]))
    (jdx,) = vjp(jnp.asarray(a["gd"]))
    x = torch.from_numpy(a["x"]).requires_grad_()
    ty = M._cap_dispatch(x, ts, tk, tinv)
    ty.backward(torch.from_numpy(a["gd"]))
    _close(ty, jy)
    _close(x.grad, jdx)

    jy, vjp = jax.vjp(lambda b, w: JM._cap_combine(b, w, js, jk, ji),
                      jnp.asarray(a["buf"]), jnp.asarray(a["w"]))
    jdb, jdw = vjp(jnp.asarray(a["gc"]))
    b = torch.from_numpy(a["buf"]).requires_grad_()
    w = torch.from_numpy(a["w"]).requires_grad_()
    ty = M._cap_combine(b, w, ts, tk, tinv)
    ty.backward(torch.from_numpy(a["gc"]))
    _close(ty, jy)
    _close(b.grad, jdb)
    _close(w.grad, jdw)


def _ffn_inputs(T=32, d=16, E=4, ff=24, seed=2):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(T, d).astype(np.float32),
            "gl": rs.randn(T, E).astype(np.float32),
            "wg": (rs.randn(E, d, ff) * 0.1).astype(np.float32),
            "wu": (rs.randn(E, d, ff) * 0.1).astype(np.float32),
            "wd": (rs.randn(E, ff, d) * 0.1).astype(np.float32),
            "g": rs.randn(T, d).astype(np.float32)}


@pytest.mark.parametrize("path", ["capacity", "dropless"])
def test_expert_ffn_output_aux_and_grads_match_jax(path):
    """moe_expert_ffn (capacity factor 0.5: tokens are dropped) and
    moe_dropless_ffn: y, aux and the gradient of sum(y * g) + aux with
    respect to x, the gate logits and the three expert stacks."""
    jax, jnp, JM = _jax()
    a = _ffn_inputs()
    names = ("x", "gl", "wg", "wu", "wd")
    kw = {"top_k": 2}
    if path == "capacity":
        kw["capacity_factor"] = 0.5
        jf, tf = JM.moe_expert_ffn.__wrapped__, M.moe_expert_ffn
    else:
        jf, tf = JM.moe_dropless_ffn.__wrapped__, M.moe_dropless_ffn

    def jloss(*args):
        y, aux = jf(*args, **kw)
        return jnp.sum(y * jnp.asarray(a["g"])) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
        *[jnp.asarray(a[n]) for n in names])
    ts = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    ty, taux = tf(*ts, **kw)
    ((ty * torch.from_numpy(a["g"])).sum() + taux).backward()
    _close(ty, jy)
    _close(taux, jaux)
    for n, t, g in zip(names, ts, jg):
        _close(t.grad, g)


def test_ep_mesh_and_switch_top2_raise():
    a = {n: torch.from_numpy(v) for n, v in _ffn_inputs().items()}
    with pytest.raises(NotImplementedError, match="ROADMAP: queue 1 item 5"):
        M.moe_expert_ffn(a["x"], a["gl"], a["wg"], a["wu"], a["wd"],
                         top_k=2, capacity_factor=1.0, mesh=object())
    with pytest.raises(ValueError, match="top-1"):
        SwitchGate(8, 4, top_k=2, device="cpu")


# (gate, shared expert, dropless): every gate with and without a shared
# expert, on both routing paths
LAYERS = [("gshard", 24, True), ("gshard", 0, False), ("switch", 24, False),
          ("switch", 0, True), ("naive", 24, True), ("naive", 0, False)]


def _jax_layer_run(jl, x, g):
    """(y, aux or None, {param name: grad}, dx) of the JAX layer for the
    loss sum(y * g) + aux, differentiated over its bound parameters."""
    jax, jnp, _ = _jax()
    from paddle_tpu.core.tensor import Tensor, no_grad
    from paddle_tpu.jit.trainer import bind_state, collect_state
    params, _, _ = collect_state(jl)

    def f(p, xx):
        with bind_state(params, p), no_grad():
            y = jl(Tensor(xx))._data
            aux = None if jl.aux_loss is None else jl.aux_loss._data
            loss = jnp.sum(y * jnp.asarray(g)) + (0.0 if aux is None else aux)
            return loss, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
        {k: t._data for k, t in params.items()}, jnp.asarray(x))
    return y, aux, gp, gx


@pytest.mark.parametrize("gate,shared,dropless", LAYERS)
def test_moe_layer_matches_jax(gate, shared, dropless):
    """MoELayer forward, aux and every gradient (router, stacked experts,
    shared expert, input) against the JAX layer with the same weights;
    capacity factor 0.5 on the capacity path, so tokens are dropped."""
    _jax()
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    paddle.seed(3)
    # top-1 routing renormalises its one weight to v / v, whose
    # derivative is zero: each framework leaves its own fp32 residue
    # (~2^-24 x |<dy, o>| / v per token) in the router's gradient.
    # aux_loss_weight 1.0 makes the aux term, which the two must agree
    # on, ~100x that residue instead of ~3x at the default 0.01
    kw = dict(gate=gate, top_k=None if gate == "switch" else 2,
              capacity_factor=0.5, shared_expert_hidden=shared,
              dropless=dropless,
              aux_loss_weight=1.0 if gate == "switch" else 0.01)
    jl = jnn.MoELayer(16, 24, 4, **kw)
    tl = MoELayer(16, 24, 4, device="cpu", **kw)
    load_reference_arrays(tl, {n: np.asarray(p._data)
                               for n, p in jl.named_parameters()})
    rs = np.random.RandomState(4)
    x = rs.randn(2, 12, 16).astype(np.float32)
    g = rs.randn(2, 12, 16).astype(np.float32)
    jy, jaux, jgp, jgx = _jax_layer_run(jl, x, g)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tl(tx)
    loss = (ty * torch.from_numpy(g)).sum()
    if tl.aux_loss is not None:
        loss = loss + tl.aux_loss
    loss.backward()
    _close(ty, jy)
    assert (tl.aux_loss is None) == (jaux is None) == (gate == "naive")
    if jaux is not None:
        _close(tl.aux_loss, jaux)
    _close(tx.grad, jgx)
    tg = {n: p.grad for n, p in tl.named_parameters()}
    assert sorted(tg) == sorted(jgp)
    for n in jgp:
        _close(tg[n], jgp[n], what=n)
