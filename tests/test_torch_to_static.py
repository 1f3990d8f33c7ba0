"""Staged forwards of the PyTorch port — `jit.to_static`, `TracedLayer`,
`jit.dy2static` and `ops.control_flow` (paddle_tpu_torch/jit/api.py,
jit/dy2static.py, ops/control_flow.py) — against the JAX package's
(paddle_tpu/jit/api.py, jit/dy2static.py, ops/control_flow.py), on the
CPU.

Every case of tests/test_dy2static.py runs through both packages'
`convert_to_static_ast`, eagerly and staged (the JAX function under
`jax.jit`, the port's under `jit.to_static`: a `torch.export` program
with `torch.cond` / `while_loop` nodes), with the same inputs made with
numpy from a seed; `cond`, `while_loop`, `case` and `switch_case` take
tests/test_control_flow.py's cases.  Tolerance: fp32 results within
1e-6 x max(1, max |JAX|) (the same ops; XLA may fuse a chain), integer
and boolean results equal.  A tiny ERNIE under both packages'
`to_static`, with the JAX weights (`load_reference_arrays`): logits
within 1e-5 x max(1, max |JAX|), as the predictor tests hold them; the
port's program against its own eager forward bitwise."""

import ast
import io
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit, ops
from paddle_tpu_torch.jit import dy2static as TD
from paddle_tpu_torch.models import (ErnieConfig,
                                     ErnieForSequenceClassification,
                                     load_reference_arrays)
from paddle_tpu_torch.nn.layer import Linear

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hops(program, name):
    """Nodes of the higher-order op `name` ("cond", "while_loop") in a
    program's top graph."""
    return sum(1 for n in program.graph.nodes if n.op == "call_function"
               and str(n.target) == name)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind in "biu":
        assert np.array_equal(got, want), (got, want)
        return
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), (got, want)


def _np(out):
    if isinstance(out, torch.Tensor):
        return out.detach().numpy()
    return np.asarray(out._data if hasattr(out, "_data") else out)


def _jax():
    pytest.importorskip("jax")
    import jax
    import paddle_tpu as paddle
    from paddle_tpu.jit import dy2static as JD
    return jax, paddle, JD


def _jax_run(fn, args, staged):
    """fn under the JAX package's dy2static: eagerly on Tensors, or
    under jax.jit (every argument traced)."""
    jax, paddle, JD = _jax()
    conv = JD.convert_to_static_ast(fn)
    if not staged:
        return _np(conv(*[paddle.to_tensor(a) if isinstance(a, np.ndarray)
                          else a for a in args]))
    out = jax.jit(lambda *v: conv(*[paddle.Tensor(a) for a in v])._data)(
        *args)
    return np.asarray(out)


def _port_run(fn, args, staged):
    """fn under the port's dy2static: eagerly on tensors, or through
    `jit.to_static` (one torch.export program a signature)."""
    t = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
         for a in args]
    if staged:
        return _np(jit.to_static(fn)(*t))
    return _np(TD.convert_to_static_ast(fn)(*t))


# -- the cases of tests/test_dy2static.py, written once for both packages


def if_statement(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def if_elif_else(x):
    s = x.sum()
    if s > 10.0:
        y = x * 0.0
    elif s > 0.0:
        y = x * 2.0
    else:
        y = x - 5.0
    return y


def while_sum(n):
    i = n * 0
    s = n * 0
    while i < n:
        s = s + i
        i = i + 1
    return s


def return_in_if(x):
    if x.sum() > 0:
        return x * 2.0
    return x - 1.0


def return_chain(x):
    s = x.sum()
    if s > 10.0:
        return x * 0.0
    if s > 0.0:
        return x * 2.0
    y = x - 5.0
    return y


def return_in_loop(x, n):
    acc = x * 0.0
    for i in range(n):
        acc = acc + x
        if acc.sum() > 4.0:
            return acc * 10.0
    return acc


def return_in_while(x):
    k = x.sum() * 0
    while k < 10.0:
        k = k + 1.0
        if k > 3.0:
            return k * 100.0
    return k


def one_sided_local(x):
    if x.sum() > 0:
        noise = x * 0.5
        y = x + noise
    else:
        y = x - 1.0
    return y


def read_modify(x):
    y = x * 1.0
    if x.sum() > 0:
        y = y + 1.0
    return y


def for_range(x, n):
    total = x * 0.0
    for i in range(n):
        total = total + x
    return total


def for_break(x, n):
    total = x * 0.0
    for i in range(n):
        if (total > 10.0).all():
            break
        total = total + x
    return total


def while_break(x):
    i = 0
    while i < 100:
        if i >= 5:
            break
        x = x + 1.0
        i = i + 1
    return x


def for_rows(xs):
    s = xs[0] * 0.0
    for r in xs:
        s = s + r
    return s


def _helper_times_k(t, k):
    out = t * 0.0
    for _ in range(k):
        out = out + t
    return out


def nested_call(t, n):
    return _helper_times_k(t, n)


def nested_closure(x, n):
    acc = x * 0.0
    for i in range(n):
        if acc.sum() > 2.0:
            acc = acc + x * 0.5
        else:
            acc = acc + x
    return acc


_F = np.float32
_ONES, _NEG = np.ones(3, _F), -np.ones(3, _F)
# name -> (function, [argument tuples]); each runs eagerly and staged
STAGED = {
    "if_statement": (if_statement, [(_ONES,), (_NEG,)]),
    "if_elif_else": (if_elif_else, [(np.full(3, v, _F),)
                                    for v in (9.0, 1.0, -1.0)]),
    "while_sum": (while_sum, [(np.asarray(5, np.int64),),
                              (np.asarray(6, np.int64),)]),
    "return_in_if": (return_in_if, [(_ONES,), (_NEG,)]),
    "return_chain": (return_chain, [(np.full(3, v, _F),)
                                    for v in (9.0, 1.0, -1.0)]),
    "return_in_loop": (return_in_loop,
                       [(_ONES, np.int32(10)),
                        (np.full(3, 0.1, _F), np.int32(2))]),
    "return_in_while": (return_in_while, [(_ONES,)]),
    "one_sided_local": (one_sided_local, [(_ONES,), (_NEG,)]),
    "read_modify": (read_modify, [(_ONES,), (_NEG,)]),
    "for_range": (for_range, [(np.array([2.0], _F), np.asarray(4)),
                              (np.array([2.0], _F), np.asarray(7))]),
    "for_break": (for_break, [(np.array([3.0], _F), np.asarray(9))]),
    "while_break": (while_break, [(np.zeros(1, _F),)]),
    "for_rows": (for_rows,
                 [(np.arange(12).reshape(4, 3).astype(_F),),
                  (np.random.default_rng(0).normal(size=(5, 2))
                   .astype(_F),)]),
    "nested_call": (nested_call, [(np.array([2.0], _F), np.asarray(5))]),
    # a staged `if` in a staged loop reading the enclosing function's x
    "nested_closure": (nested_closure, [(_ONES, np.asarray(4))]),
}


@pytest.mark.parametrize("name", sorted(STAGED))
def test_dy2static_case_matches_jax_eager_and_staged(name):
    """Each case eagerly and staged in both packages: all four agree."""
    fn, arg_sets = STAGED[name]
    for args in arg_sets:
        want = _jax_run(fn, args, staged=False)
        _close(_jax_run(fn, args, staged=True), want)
        _close(_port_run(fn, args, staged=False), want)
        _close(_port_run(fn, args, staged=True), want)


def test_staged_if_is_a_cond_node_and_probes_leave_no_dead_code():
    """The program of a tensor-`if` holds one `cond` node and, after the
    probes' dead code is eliminated, no node without a user."""
    prog = jit.to_static(if_statement).lower(torch.ones(3))
    nodes = list(prog.graph.nodes)
    assert _hops(prog, "cond") == 1
    assert all(n.users or n.op in ("placeholder", "output") for n in nodes)
    prog = jit.to_static(while_sum).lower(torch.tensor(4))
    assert _hops(prog, "while_loop") == 1


_HELPER_CALLS = []


def _counted(x):
    _HELPER_CALLS.append(1)
    return x * 2.0


def counted_branch(x):
    if x.sum() > 0:
        y = _counted(x)
    else:
        y = x - 1.0
    return y


def test_staged_if_runs_each_branch_twice():
    """A staged `if` runs a branch once to probe its structure and the
    tensors it reads by closure, and once more as the op traces it."""
    _HELPER_CALLS.clear()
    out = jit.to_static(counted_branch)(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert len(_HELPER_CALLS) == 2


def _eager_both(fn, *args, **kw):
    """fn converted by both packages, run eagerly."""
    _, paddle, JD = _jax()
    j = JD.convert_to_static_ast(fn)(
        *[paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
          for a in args], **kw)
    t = TD.convert_to_static_ast(fn)(
        *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args], **kw)
    return j, t


def bare_return(x):
    if x.sum() > 0:
        return
    return


def plain_python(x, mode="a"):
    if mode == "a":
        y = x * 3.0
    else:
        y = x
    k = 0
    while k < 2:
        y = y + 1.0
        k += 1
    return y


def for_continue(x):
    s = x * 0.0
    for i in range(6):
        if i % 2 == 0:
            continue
        s = s + float(i)
    return s


def for_iterable(x, items):
    s = x
    for v in items:
        s = s + v
    return s


def for_mutating(x, n):
    acc = []
    for i in range(n):
        acc.append(i)
    return x, acc


def loop_var_after(x):
    for i in range(3):
        x = x + float(i)
    return x * float(i)


def break_in_with(x):
    while True:
        with io.StringIO() as fh:
            fh.write("x")
            break
    return x + 1.0


EAGER = {
    "plain_python": (plain_python, (np.ones(2, _F),), {}),
    "plain_python_b": (plain_python, (np.ones(2, _F),), {"mode": "b"}),
    "for_continue": (for_continue, (np.zeros(1, _F),), {}),
    "for_iterable": (for_iterable, (np.zeros(1, _F), [1.0, 2.0, 3.0]), {}),
    "loop_var_after": (loop_var_after, (np.zeros(1, _F),), {}),
    "break_in_with": (break_in_with, (np.zeros(1, _F),), {}),
    "one_sided_neg": (one_sided_local, (_NEG,), {}),
}


@pytest.mark.parametrize("name", sorted(EAGER))
def test_dy2static_python_paths_match_jax(name):
    """The cases that stay Python (concrete tests, python iterables,
    break under `with`) give the JAX package's values."""
    fn, args, kw = EAGER[name]
    j, t = _eager_both(fn, *args, **kw)
    _close(_np(t), _np(j))


def test_bare_return_and_mutating_for_stay_python():
    j, t = _eager_both(bare_return, _ONES)
    assert j is None and t is None
    (_, jacc), (_, tacc) = _eager_both(for_mutating, np.zeros(1, _F), 3)
    assert jacc == tacc == [0, 1, 2]


def unbound_after_if(x):
    if x.sum() > 0:
        z = x * 2.0
    else:
        pass
    return z


def test_unbound_branch_local_raises_name_error_at_use():
    conv = TD.convert_to_static_ast(unbound_after_if)
    _close(_np(conv(torch.ones(3))), 2.0 * _ONES)
    with pytest.raises(NameError, match="'z'"):
        conv(-torch.ones(3)) + 1.0


class _Box:
    flag = 0


def attribute_store(x, box):
    if x.sum() > 0:
        box.flag = 1
    return x


def in_place_branch(x):
    y = x * 1.0
    if x.sum() > 0:
        y.add_(1.0)
    return y


def test_effectful_branches_stay_python():
    """An attribute store, and (the port's rule) an in-place tensor
    method, keep the `if` in Python: exact eagerly, and a traced test
    raises instead of running both branches."""
    conv = TD.convert_to_static_ast(attribute_store)
    b = _Box()
    conv(-torch.ones(3), b)
    assert b.flag == 0
    conv(torch.ones(3), b)
    assert b.flag == 1
    src = ast.unparse(ast.parse(TD.inspect.getsource(in_place_branch)))
    assert "__d2s_if__" not in src
    tconv = TD.convert_to_static_ast(in_place_branch)
    _close(_np(tconv(torch.ones(3))), 2.0 * _ONES)
    _close(_np(tconv(-torch.ones(3))), -_ONES)
    aconv = TD.convert_to_static_ast(attribute_store)

    def staged_store(a):
        return aconv(a, _Box())

    for fn in (staged_store, in_place_branch):
        with pytest.raises(Exception, match="(?i)data-dependent"):
            jit.to_static(fn).lower(torch.ones(3))


def traced_break_over_list(s, items):
    for v in items:
        s = s + v
        if (s > 2.5).all():
            break
    return s


def test_traced_break_over_python_iterable_raises():
    jax, paddle, JD = _jax()
    from paddle_tpu.jit.dy2static import ConversionError as JErr
    items = [1.0] * 5
    j, t = _eager_both(traced_break_over_list, np.zeros(1, _F), items)
    _close(_np(t), _np(j))
    jconv = JD.convert_to_static_ast(traced_break_over_list)
    with pytest.raises(JErr):
        jax.jit(lambda a: jconv(paddle.Tensor(a), items)._data)(
            np.zeros(1, _F))
    tconv = TD.convert_to_static_ast(traced_break_over_list)

    def staged(a):
        return tconv(a, items)

    with pytest.raises(TD.ConversionError):
        jit.to_static(staged)(torch.zeros(1))


# -- layers: tests/test_dy2static.py's Gate and hook cases --------------


class _PortGate(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(4, 4, device="cpu")

    def forward(self, x):
        h = self.fc(x)
        if h.sum() > 0:
            out = torch.tanh(h)
        else:
            out = torch.relu(h)
        return out


class _PortHooked(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(4, 4, device="cpu")

    def forward(self, x):
        if x.sum() > 0:
            h = self.fc(x)
        else:
            h = x
        return h


def _jax_gate(hooked):
    _, paddle, _ = _jax()
    import paddle_tpu.nn as jnn

    class Gate(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.sum() > 0:
                out = paddle.tanh(h)
            else:
                out = paddle.relu(h)
            return out

    class Hooked(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(4, 4)

        def forward(self, x):
            if x.sum() > 0:
                h = self.fc(x)
            else:
                h = x
            return h

    return Hooked() if hooked else Gate()


def _port_copy(jm, tm):
    with torch.no_grad():
        for (_, jp), (_, tp) in zip(jm.named_parameters(),
                                    tm.named_parameters()):
            tp.copy_(torch.from_numpy(np.asarray(jp._data)))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_layer_with_tensor_if_matches_jax_to_static(sign):
    _, paddle, _ = _jax()
    jm, tm = _jax_gate(False), _PortGate()
    _port_copy(jm, tm)
    x = sign * np.random.RandomState(0).rand(2, 4).astype(_F)
    want = _np(paddle.jit.to_static(jm)(paddle.to_tensor(x)))
    traced = jit.to_static(tm)
    _close(_np(traced(torch.from_numpy(x))), want)
    _close(_np(tm(torch.from_numpy(x))), want)
    assert _hops(traced.lower(torch.from_numpy(x)), "cond") == 1


def test_forward_hooks_replayed_through_to_static():
    """A post-hook that doubles the output runs on the eager and the
    staged path alike, as in the JAX package."""
    _, paddle, _ = _jax()
    jm, tm = _jax_gate(True), _PortHooked()
    _port_copy(jm, tm)
    calls = []
    jm.register_forward_post_hook(lambda l, i, o: o * 2.0)
    tm.register_forward_hook(lambda l, i, o: (calls.append(1), o * 2.0)[1])
    tm.register_forward_pre_hook(lambda l, i: (i[0] * 1.0,))
    x = np.ones((2, 4), _F)
    want = _np(paddle.jit.to_static(jm)(paddle.to_tensor(x)))
    _close(_np(tm(torch.from_numpy(x))), want)
    _close(_np(jit.to_static(tm)(torch.from_numpy(x))), want)
    assert len(calls) >= 2


# -- ops.control_flow: tests/test_control_flow.py's cases ----------------


def test_cond_eager_takes_one_branch_with_grad():
    x = torch.tensor(2.0, requires_grad=True)
    hi = ops.cond(x > 1.0, lambda: x * 3.0, lambda: x * 5.0)
    assert float(hi) == 6.0
    hi.backward()
    assert float(x.grad) == 3.0
    assert float(ops.cond(x > 10.0, lambda: x * 3.0, lambda: x * 5.0)) == 10


def _cond_fn(t):
    return ops.cond(t.sum() > 0, lambda: t * 2.0, lambda: t - 1.0)


def _while_fn(n):
    i, s = ops.while_loop(lambda i, s: i < n, lambda i, s: (i + 1, s + i),
                          [n * 0, n * 0])
    return s


def _switch_fn(iv):
    return ops.switch_case(iv, {0: lambda: iv * 0 + 10.0,
                                1: lambda: iv * 0 + 20.0},
                           default=lambda: iv * 0 - 1.0)


def _case_fn(x):
    return ops.case([(x < 0, lambda: x * 0.0), (x < 10, lambda: x * 2.0)],
                    default=lambda: x)


CF = {"cond": (_cond_fn, [_ONES, _NEG]),
      "while_loop": (_while_fn, [np.asarray(5, np.int64)]),
      "switch_case": (_switch_fn, [np.asarray(1, np.int64),
                                   np.asarray(7, np.int64),
                                   np.asarray(0, np.int64)]),
      "case": (_case_fn, [np.asarray(5.0, _F), np.asarray(-3.0, _F),
                          np.asarray(30.0, _F)])}


@pytest.mark.parametrize("name", sorted(CF))
def test_control_flow_combinator_matches_jax(name):
    """Each combinator eagerly and in a program, against the JAX one
    under jax.jit, on the same inputs."""
    jax, paddle, _ = _jax()
    from paddle_tpu import ops as jops
    fn, inputs = CF[name]
    jfn = {"cond": lambda t: jops.cond(t.sum() > 0, lambda: t * 2.0,
                                       lambda: t - 1.0),
           "while_loop": lambda n: jops.while_loop(
               lambda i, s: i < n, lambda i, s: (i + 1, s + i),
               [n * 0, n * 0])[1],
           "switch_case": lambda iv: jops.switch_case(
               iv, {0: lambda: iv * 0 + 10.0, 1: lambda: iv * 0 + 20.0},
               default=lambda: iv * 0 - 1.0),
           "case": lambda x: jops.case(
               [(x < 0, lambda: x * 0.0), (x < 10, lambda: x * 2.0)],
               default=lambda: x)}[name]
    for a in inputs:
        want = np.asarray(jax.jit(lambda v: jfn(paddle.Tensor(v))._data)(a))
        _close(_np(fn(torch.from_numpy(a))), want)
        traced = jit.to_static(fn)
        _close(_np(traced(torch.from_numpy(a))), want)


def test_while_loop_eager_keeps_autograd():
    x = torch.tensor(1.0, requires_grad=True)
    iv, xv = ops.while_loop(lambda i, x: i < 3, lambda i, x: (i + 1, x * 2),
                            [torch.tensor(0), x])
    assert int(iv) == 3 and float(xv) == 8.0
    xv.backward()
    assert float(x.grad) == 8.0


class _Refiner(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(8, 8, device="cpu")

    def forward(self, x):
        def cond_fn(i, h):
            return i < 4

        def body_fn(i, h):
            return i + 1, torch.tanh(self.fc(h))

        _, h = ops.while_loop(cond_fn, body_fn,
                              [torch.zeros((), dtype=torch.int64), x])
        return h


def test_loop_bearing_model_traces():
    m = _Refiner()
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 8).astype(_F))
    _close(_np(jit.to_static(m)(x)), _np(m(x)))


def test_python_bool_on_a_traced_value_raises():
    def f(t):
        if t.sum() > 0:          # not converted: a plain python `if`
            return t
        return -t

    f.__not_to_static__ = True
    with pytest.raises(Exception):
        jit.to_static(f)(torch.ones(3))


# -- TracedLayer: ERNIE, state, the switch, save / load, refusals ---------

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


class _Positional(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.m = model

    def forward(self, ids, mask):
        return self.m(ids, attention_mask=mask)


def _ernie_batch(b, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, 16))
    mask = np.ones((b, 16), np.int64)
    mask[-1, 11:] = 0
    return ids, mask


def test_tiny_ernie_to_static_matches_jax_to_static():
    """Both packages' to_static of the tiny ERNIE with the JAX weights:
    logits within 1e-5 of JAX's; the port's program bitwise its eager
    forward; one program a signature, a second call makes none."""
    _, paddle, _ = _jax()
    import paddle_tpu.nn as jnn
    from paddle_tpu.models import ernie as J

    class JPositional(jnn.Layer):
        def __init__(self, model):
            super().__init__()
            self.m = model

        def forward(self, ids, mask):
            return self.m(ids, attention_mask=mask)

    paddle.seed(0)
    jm = J.ErnieForSequenceClassification(
        J.ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2)
    jm.eval()
    tm = ErnieForSequenceClassification(
        ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2,
        device="cpu").eval()
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    jt, tt = paddle.jit.to_static(JPositional(jm)), \
        jit.to_static(_Positional(tm))
    for b, seed in ((2, 0), (1, 1), (2, 2)):
        ids, mask = _ernie_batch(b, seed)
        want = _np(jt(paddle.to_tensor(ids), paddle.to_tensor(mask)))
        t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
        got = _np(tt(t_ids, t_mask))
        _close(got, want, 1e-5)
        with torch.no_grad():
            assert np.array_equal(got, _np(tm(t_ids,
                                              attention_mask=t_mask)))
    assert len(tt.programs) == 2
    program = next(iter(tt.programs.values()))
    assert sum("paddle_tpu_torch.flash_fwd" in str(n.target)
               for n in program.graph.nodes) == 2


def test_program_reads_parameters_changed_in_place():
    """A parameter changed in place after the first call (as an
    optimizer step changes it) is seen by the next call: the program
    holds the layer's own tensors."""
    m = _PortGate()
    traced = jit.to_static(m)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 4).astype(_F))
    first = traced(x)
    with torch.no_grad():
        m.fc.weight.mul_(-3.0)
        m.fc.bias.add_(0.5)
    second = traced(x)
    assert len(traced.programs) == 1
    assert not torch.equal(first, second)
    with torch.no_grad():
        assert torch.equal(second, m(x))


def test_enable_to_static_switch_is_read_each_call():
    m = _PortGate()
    traced = jit.to_static(m)
    x = torch.ones(2, 4)
    traced(x)
    try:
        jit.enable_to_static(False)
        assert jit.to_static(m) is m
        out = traced(torch.ones(3, 4))      # a new signature, run eagerly
        assert len(traced.programs) == 1 and out.requires_grad
    finally:
        jit.enable_to_static(True)
    traced(torch.ones(3, 4))
    assert len(traced.programs) == 2


def test_training_mode_with_dropout_is_refused():
    """The JAX TracedLayer draws a fresh dropout key a call; the port's
    dropout draws its seeds on the host, so a program would replay one
    mask: to_static of such a layer raises, as jit.save does; in eval
    mode it runs."""
    cfg = ErnieConfig.from_preset("tiny")
    model = ErnieForSequenceClassification(cfg, device="cpu").train()
    traced = jit.to_static(_Positional(model))
    ids, mask = (torch.from_numpy(a) for a in _ernie_batch(2, 0))
    with pytest.raises(ValueError, match="training mode with dropout"):
        traced(ids, mask)
    model.eval()
    assert traced(ids, mask).shape == (2, 2)


class _SaveGate(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(4, 4, device="cpu")

    def forward(self, x):
        h = self.fc(x)
        if h.sum() > 0:
            h = torch.tanh(h) * 2.0
        else:
            h = h - 1.0
        n = h.abs().sum() * 0
        while n < 3:
            h = h * 0.5
            n = n + 1
        return h


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_save_and_load_a_layer_with_tensor_control_flow(tmp_path, sign):
    """jit.save exports the converted forward (a `cond` and a
    `while_loop` node); jit.load runs it like the eager layer on inputs
    that take each branch."""
    m = _SaveGate()
    path = str(tmp_path / "gate")
    jit.save(m, path, input_spec=[jit.InputSpec([2, 4], "float32")])
    program = torch.export.load(path + ".pt2")
    assert _hops(program, "cond") == 1
    assert _hops(program, "while_loop") == 1
    loaded = jit.load(path, device="cpu")
    x = torch.from_numpy(sign * np.random.RandomState(2).rand(2, 4)
                         .astype(_F))
    with torch.no_grad():
        want = m(x)
    assert torch.equal(loaded(x), want)
    assert torch.equal(jit.to_static(m)(x), want)


def test_conversion_error_warns_and_keeps_the_forward():
    class Bad(torch.nn.Module):
        def forward(self, x):
            for i in range(3):
                if x.shape[0] > 0:
                    return x
            else:
                pass
            return x * 2.0

    with pytest.warns(UserWarning, match="UNCONVERTED"):
        traced = jit.to_static(Bad())
    _close(_np(traced(torch.ones(2))), np.ones(2, _F))


def _jax_all(path):
    """The JAX package's `__all__`, with its `+=` extensions, by ast."""
    names = []
    for node in ast.parse((ROOT / path).read_text()).body:
        targets = getattr(node, "targets", None) or \
            [getattr(node, "target", None)]
        if any(getattr(t, "id", None) == "__all__" for t in targets):
            names += [ast.literal_eval(e) for e in node.value.elts]
    return names


def test_jit_all_covers_the_jax_package():
    want = _jax_all("paddle_tpu/jit/__init__.py")
    assert len(want) == 14
    assert set(want) <= set(jit.__all__)
    assert all(hasattr(jit, n) for n in want)
    assert jit.ignore_module([io])[-1] is io
    jit.set_code_level(3)
    assert jit._VERBOSITY["level"] == 3
    jit.set_verbosity(0)


def test_collect_and_bind_state():
    m = _PortGate()
    m.fc.bias.requires_grad_(False)
    m.register_buffer("scale", torch.ones(1))
    params, frozen, buffers = jit.collect_state(m)
    assert list(params) == ["fc.weight"] and list(frozen) == ["fc.bias"]
    assert list(buffers) == ["scale"]
    before = m.fc.weight.clone()
    with pytest.raises(RuntimeError):
        with jit.bind_state(params, {"fc.weight": np.zeros((4, 4), _F)}):
            assert float(m.fc.weight.abs().sum()) == 0.0
            raise RuntimeError("inside")
    assert torch.equal(m.fc.weight, before)
