"""Structured control flow: cond / while_loop / case / switch_case — the
port of `paddle_tpu/ops/control_flow.py`.

The reference stages python control flow into ConditionalBlock/While ops
(ref: python/paddle/static/nn/control_flow.py).  As in the JAX package,
each combinator has two modes:

  * EAGER: the predicate is concrete — the chosen Python branch simply
    runs, and autograd records its ops (gradients as for a plain `if`).
  * TRACED (`jit.to_static`, `jit.save`: a `torch.export` trace) — the
    combinator emits `torch.cond` / `torch._higher_order_ops.while_loop`,
    one node of the program.  A value is traced when it is a tensor and
    `torch.compiler.is_exporting()` is true, or when it is a
    `FakeTensor` (the values a non-strict `torch.export` runs the Python
    on).

Under tracing, as XLA demands in the JAX package, both branches return
the same structure, shapes and dtypes, and every operand and carry is a
tensor: a Python scalar becomes a 0-dim tensor on the operands' device
(bool, int64 or float32), and a branch or body output is cast to the
dtype of the carry it replaces.  A branch or body output that aliases an
input (returned unchanged, or a view) is cloned: the higher-order ops
refuse aliases.  `while_loop` has no reverse-mode gradient under
tracing, as XLA's While has none (the JAX module's docstring).

The ops are called as the higher-order operators themselves
(`cond_op`, `while_loop_op`), traced by the export's own tracer: the
public `torch.cond` would first trace each branch with dynamo, which
refuses much of the Python a converted branch runs.  A branch may read
tensors of the enclosing trace by closure (a layer's parameters, an
earlier activation): a probe run under a `TorchFunctionMode` finds them,
they go to the op as extra operands, and while the branch is traced each
use of one is replaced by its operand (`_Lift`).  The probe's ops are
dead code in the trace; the caller (`jit.api`) eliminates them.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

__all__ = ["cond", "while_loop", "case", "switch_case"]


def _is_traced(*vals):
    """True when any tensor leaf of `vals` is a traced value (module
    docstring)."""
    from torch._subclasses.fake_tensor import FakeTensor
    leaves = [v for v in pytree.tree_leaves(vals)
              if isinstance(v, torch.Tensor)]
    if not leaves:
        return False
    return torch.compiler.is_exporting() or any(
        isinstance(v, FakeTensor) for v in leaves)


def _device(*vals, default=None):
    """The device of the first tensor leaf of `vals`."""
    for v in pytree.tree_leaves(vals):
        if isinstance(v, torch.Tensor):
            return v.device
    return default if default is not None else torch.device("cpu")


def _scalar_dtype(v):
    return torch.bool if isinstance(v, bool) else (
        torch.int64 if isinstance(v, int) else torch.float32)


def as_tensor(v, device, like=None):
    """`v` as a tensor on `device`: in `like`'s dtype when given, a
    Python scalar as bool / int64 / float32 otherwise."""
    if isinstance(v, torch.Tensor):
        return v if like is None or v.dtype == like.dtype \
            else v.to(like.dtype)
    if not isinstance(v, (bool, int, float)):
        raise TypeError(
            f"control flow under tracing carries tensors and Python "
            f"scalars only, not {type(v).__name__}")
    dtype = like.dtype if like is not None else _scalar_dtype(v)
    return torch.tensor(v, dtype=dtype, device=device)


def _unalias(outs, inputs):
    """Clone each output that is an input, a view, or an earlier output:
    the higher-order ops refuse aliases."""
    seen = [id(t) for t in inputs]
    res = []
    for o in outs:
        if isinstance(o, torch.Tensor) and (id(o) in seen or o._is_view()):
            o = o.clone()
        if isinstance(o, torch.Tensor):
            seen.append(id(o))
        res.append(o)
    return tuple(res)


def _pred(p, device):
    p = as_tensor(p, device)
    return p if p.dtype == torch.bool else p != 0


_LIFTS: list = []          # the {id: operand} maps of the branches being traced


def _resolve(t):
    """`t` as the branch being traced sees it: through every enclosing
    branch's map, outermost first."""
    for m in _LIFTS:
        if isinstance(t, torch.Tensor):
            t = m.get(id(t), t)
    return t


class _Seen(TorchFunctionMode):
    """Records the tensors that torch functions read and did not make."""

    def __init__(self):
        super().__init__()
        self.read, self.made = {}, set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in pytree.tree_leaves((args, kwargs)):
            if isinstance(a, torch.Tensor) and id(a) not in self.made:
                self.read.setdefault(id(a), a)
        out = func(*args, **kwargs)
        for o in pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor):
                self.made.add(id(o))
        return out

    def returned(self, out):
        """Records the tensors a probed function returned: a bare
        `return t` reads `t` through no torch function."""
        for o in pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor) and id(o) not in self.made:
                self.read.setdefault(id(o), o)


class _Lift(TorchFunctionMode):
    """Replaces each closed-over tensor by the branch's operand for it."""

    def __init__(self, mapping):
        super().__init__()
        self.mapping = mapping

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = pytree.tree_map_only(
            torch.Tensor, lambda t: self.mapping.get(id(t), t),
            (args, kwargs or {}))
        return func(*args, **kwargs)


def _free_tensors(fns, operands, seen=None):
    """The tensors `fns` read by closure (a probe run of each on
    `operands`, or `seen`, a `_Seen` over such a probe the caller ran),
    as [(the tensor, what the branch being traced sees for it)], one
    entry each of the latter."""
    if seen is None:
        seen = _Seen()
        with seen:
            for fn in fns:
                fn(*operands)
    own = {id(o) for o in operands}
    free, got = [], set()
    for i, t in seen.read.items():
        r = _resolve(t)
        if i not in own and id(r) not in own and id(r) not in got:
            got.add(id(r))
            free.append((t, r))
    return free


def _lifted(fn, n, free):
    """`fn` over its `n` operands, taking the `free` tensors as further
    operands (each found by either of its two identities)."""
    def run(*args):
        mapping = {}
        for (t, r), a in zip(free, args[n:]):
            mapping[id(t)] = mapping[id(r)] = a
        _LIFTS.append(mapping)
        try:
            with _Lift(mapping):
                return fn(*args[:n])
        finally:
            _LIFTS.pop()
    return run


def cond(pred, true_fn, false_fn, *operands):
    """ref: paddle.static.nn.cond(pred, true_fn, false_fn).

    Branch outputs must match in structure, shape and dtype under
    tracing (eager mode is unconstrained, like dygraph)."""
    return _cond(pred, true_fn, false_fn, operands)


def _cond(pred, true_fn, false_fn, operands, seen=None):
    """`cond`; `seen`: a `_Seen` over a probe of both branches on
    `operands` that the caller already ran (dy2static's structure
    probe), which then stands for cond's own."""
    if not _is_traced(pred, operands):
        return true_fn(*operands) if bool(pred) else false_fn(*operands)
    from torch._higher_order_ops.cond import cond_op
    device = _device(pred, operands)
    ops = tuple(_resolve(as_tensor(o, device)) for o in operands)
    spec = {}

    def _branch(fn):
        def run(*ops_):
            flat, spec["tree"] = pytree.tree_flatten(fn(*ops_))
            flat = [as_tensor(v, device) for v in flat]
            return _unalias(flat, ops_)
        return run

    branches = (_branch(true_fn), _branch(false_fn))
    free = _free_tensors(branches, ops, seen)
    out = cond_op(_resolve(_pred(pred, device)),
                  *(_lifted(b, len(ops), free) for b in branches),
                  ops + tuple(r for _, r in free))
    return pytree.tree_unflatten(list(out), spec["tree"])


def while_loop(cond_fn, body_fn, loop_vars):
    """ref: paddle.static.nn.while_loop(cond, body, loop_vars).

    loop_vars: a list or tuple of tensors (the carried state)."""
    is_list = isinstance(loop_vars, list)
    vars_t = tuple(loop_vars)
    if not _is_traced(vars_t):
        while bool(cond_fn(*vars_t)):
            out = body_fn(*vars_t)
            vars_t = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        return list(vars_t) if is_list else vars_t
    from torch._higher_order_ops.while_loop import while_loop_op
    device = _device(vars_t)
    carries = tuple(_resolve(as_tensor(v, device)) for v in vars_t)

    def c(*state):
        return _pred(cond_fn(*state), device)

    def b(*state):
        out = body_fn(*state)
        out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        if len(out) != len(state):
            raise TypeError(f"while_loop: the body returns {len(out)} "
                            f"values for {len(state)} carries")
        out = [as_tensor(o, device, like=s) for o, s in zip(out, state)]
        return _unalias(out, state)

    free = _free_tensors((c, b), carries)
    n = len(carries)
    out = tuple(while_loop_op(_lifted(c, n, free), _lifted(b, n, free),
                              carries, tuple(r for _, r in free)))
    return list(out) if is_list else out


def case(pred_fn_pairs, default=None):
    """ref: paddle.static.nn.case — first true predicate wins."""
    if not pred_fn_pairs:
        raise ValueError("case: need at least one (pred, fn) pair")
    (pred, fn), *rest = pred_fn_pairs
    if not rest:
        if default is None:
            return cond(pred, fn, fn)
        return cond(pred, fn, default)
    return cond(pred, fn, lambda: case(rest, default))


def switch_case(branch_index, branch_fns, default=None):
    """ref: paddle.static.nn.switch_case — integer-indexed branches."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    else:
        pairs = list(enumerate(branch_fns))
    keys = [k for k, _ in pairs]
    fns = [f for _, f in pairs]
    if not _is_traced(branch_index):
        i = int(branch_index)
        if i in keys:
            return fns[keys.index(i)]()
        if default is not None:
            return default()
        raise ValueError(f"switch_case: index {i} not in {keys} "
                         "and no default given")
    # arbitrary keys as a chain of conds; an unknown index takes the
    # default, or without one the first branch (the JAX module's argmax
    # over no match picks slot 0)
    idx = branch_index
    chain = default if default is not None else fns[0]
    for k, f in reversed(list(zip(keys, fns))):
        chain = (lambda k=k, f=f, rest=chain:
                 cond(idx == k, f, rest))
    return chain()
