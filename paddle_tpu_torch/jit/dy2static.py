"""Dy2static AST conversion — python `if`/`while`/`for` over tensor
values staged into `torch.cond` / `while_loop` — the port of
`paddle_tpu/jit/dy2static.py`.

The AST half (the early-return lowering, `_ControlFlowTransformer`, the
break/continue flags, the call conversion) is the JAX module's, copied:
it is host-only Python and emits the same code.  One rule is added: a
block that calls a PyTorch in-place method (a name ending in `_`) stays
in Python, like the JAX module's mutating methods, since `torch.cond`
refuses branches that mutate their inputs.

The runtime helpers the generated code calls are retargeted to PyTorch:

  * `if`/`elif`/`else` statements dispatch at RUN time: on a concrete
    test the original python branch runs (zero behavior change
    eagerly); on a traced tensor (`ops.control_flow`: a `torch.export`
    trace) both branches are probed and staged through `ops.cond`
    (`torch.cond`);
  * `while` loops likewise through `ops.while_loop`;
  * `for` loops over `range(tensor_n)` or over a tensor's leading axis
    stage into a while_loop with an index carry (a row is an
    `index_select` by a 0-dim index); plain-python iterables keep python
    semantics;
  * `break`/`continue` inside a staged loop become carried boolean
    predicates (0-dim bool tensors once staged);
  * calls to plain user python functions convert on first call; the
    port's own, PyTorch's, numpy's and the standard library's
    functional helpers pass through, as do `nn.Module`s (not functions);
  * branch/loop bodies are extracted as closures over the enclosing
    scope; the variables they ASSIGN become the staged outputs/carries.

Tracing contract: a tensor-`if` probes BOTH branches at trace time, so
branch bodies must be effect-free; attribute/subscript stores, known
mutating method calls and in-place tensor methods keep the `if` in
python.  The probes' ops are dead code in the traced graph: the caller
(`jit.api`) eliminates them.  A probe output that is the same non-tensor
object on both branches (None, a string, an equal Python scalar) stays
outside the staged op.

Not converted (loud NotImplementedError at conversion time, as in the
JAX module): `return` inside with/try blocks under a tensor conditional;
loop/else combined with an early return.  A function whose zero-argument
`super()` needs its class cell cannot be recompiled from source and
raises ConversionError (the caller keeps it unconverted).
"""

from __future__ import annotations

import ast
import functools
import inspect
import textwrap
import types
import weakref

import torch

__all__ = ["convert_to_static_ast", "ConversionError"]


class ConversionError(NotImplementedError):
    pass


# -- early-return lowering (ref: jit/dy2static/return_transformer.py) ------

_RETV, _RETF = "_d2s_retv", "_d2s_retf"


def _has_return(stmts):
    """True if any `return` occurs in stmts, NOT descending into nested
    function/class scopes."""
    for st in stmts:
        if isinstance(st, ast.Return):
            return True
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef, ast.Lambda)):
            continue
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(st, field, None)
            if sub and _has_return(sub):
                return True
        for h in getattr(st, "handlers", []) or []:
            if _has_return(h.body):
                return True
    return False


def _assign(name, value):
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=value)


def _truthy_test(name):
    return ast.Call(func=ast.Name(id="__d2s_truthy__", ctx=ast.Load()),
                    args=[ast.Name(id=name, ctx=ast.Load())], keywords=[])


def _lower_tail(stmts):
    """Rewrite a statement list (function-body context) so that EVERY
    execution path ends with `_d2s_retv = <value>` instead of `return` —
    for an `if` containing a return, the continuation is folded into
    both branches (so the later tensor-if staging sees both branches
    assign the same outputs); for a loop, returns inside become
    done-flag + break, and the continuation is guarded on the flag."""
    out = []
    for idx, st in enumerate(stmts):
        if isinstance(st, ast.Return):
            out.append(_assign(_RETV, st.value or ast.Constant(value=None)))
            return out          # anything after a return is dead
        if isinstance(st, (ast.If, ast.While, ast.For)) \
                and _has_return([st]):
            rest = list(stmts[idx + 1:])
            if isinstance(st, ast.If):
                out.append(ast.If(test=st.test,
                                  body=_lower_tail(list(st.body) + rest),
                                  orelse=_lower_tail(list(st.orelse)
                                                     + rest)))
            else:
                if st.orelse:
                    raise ConversionError(
                        "dy2static: loop/else with an early `return` is "
                        "not stageable — move the else body after the "
                        "loop or drop the early return")
                out.append(_assign(_RETF, ast.Constant(value=False)))
                new_loop = (ast.While(test=st.test,
                                      body=_lower_loop(st.body),
                                      orelse=[])
                            if isinstance(st, ast.While) else
                            ast.For(target=st.target, iter=st.iter,
                                    body=_lower_loop(st.body), orelse=[]))
                out.append(new_loop)
                # done → retv was set in the loop (pass it through);
                # not done → run the continuation
                out.append(ast.If(test=_truthy_test(_RETF),
                                  body=[ast.Pass()],
                                  orelse=_lower_tail(rest)))
            return out
        out.append(st)
    # fell off the end: python's implicit `return None`
    out.append(_assign(_RETV, ast.Constant(value=None)))
    return out


def _lower_loop(stmts):
    """Loop-body context: `return e` → retv/done assignments + break."""
    out = []
    for idx, st in enumerate(stmts):
        if isinstance(st, ast.Return):
            out += [_assign(_RETV, st.value or ast.Constant(value=None)),
                    _assign(_RETF, ast.Constant(value=True)),
                    ast.Break()]
            return out
        if isinstance(st, (ast.If, ast.While, ast.For)) \
                and _has_return([st]):
            rest = list(stmts[idx + 1:])
            if isinstance(st, ast.If):
                out.append(ast.If(test=st.test,
                                  body=_lower_loop(list(st.body) + rest),
                                  orelse=_lower_loop(list(st.orelse)
                                                     + rest)))
            else:               # nested loop: its returns set the SAME
                if st.orelse:
                    raise ConversionError(
                        "dy2static: loop/else with an early `return` is "
                        "not stageable — move the else body after the "
                        "loop or drop the early return")
                out.append(_assign(_RETF, ast.Constant(value=False)))
                new_loop = (ast.While(test=st.test,
                                      body=_lower_loop(st.body), orelse=[])
                            if isinstance(st, ast.While) else
                            ast.For(target=st.target, iter=st.iter,
                                    body=_lower_loop(st.body), orelse=[]))
                out.append(new_loop)
                # flag, so propagate the exit one level out
                out.append(ast.If(test=_truthy_test(_RETF),
                                  body=[ast.Break()],
                                  orelse=_lower_loop(rest)))
            return out
        out.append(st)
    return out


def _lower_returns(func_def):
    """Apply early-return lowering to `func_def` in place when any
    `return` sits inside an if/loop; ends the body with
    `return _d2s_retv`."""
    if not any(not isinstance(st, ast.Return) and _has_return([st])
               for st in func_def.body):
        return False
    func_def.body = _lower_tail(func_def.body) + [
        ast.Return(value=ast.Name(id=_RETV, ctx=ast.Load()))]
    return True


def _assigned_names(nodes):
    out = []

    class V(ast.NodeVisitor):
        def visit_Name(self, n):
            if isinstance(n.ctx, ast.Store) and n.id not in out:
                out.append(n.id)

        def visit_FunctionDef(self, n):  # don't descend into nested defs
            if n.name not in out:
                out.append(n.name)

        def visit_AugAssign(self, n):
            if isinstance(n.target, ast.Name) and n.target.id not in out:
                out.append(n.target.id)
            self.generic_visit(n)

    for nd in nodes:
        V().visit(nd)
    # generated helpers (nested elif conversion) are scaffolding, not
    # user-visible outputs of a branch
    return [n for n in out if not n.startswith("__d2s_")]


def _check_unsupported(nodes, kind, allow_break=False):
    class V(ast.NodeVisitor):
        def visit_Return(self, n):
            raise ConversionError(
                f"dy2static: `return` inside a tensor-{kind} is not "
                "stageable — restructure to assign a variable and return "
                "after the block (ref ifelse_transformer return handling)")

        def visit_Break(self, n):
            if not allow_break:
                raise ConversionError(
                    f"dy2static: `break` inside a tensor-{kind} cannot be "
                    "staged here; fold the exit into the loop condition")

        def visit_Continue(self, n):
            if not allow_break:
                raise ConversionError(
                    f"dy2static: `continue` inside a tensor-{kind} cannot "
                    "be staged here; use ops.where-style masking instead")

        def visit_FunctionDef(self, n):
            return  # nested function bodies are opaque

        def visit_While(self, n):
            return  # nested loops own their break/continue

        def visit_For(self, n):
            return

    for nd in nodes:
        V().visit(nd)


_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "clear", "update",
    "add", "discard", "setdefault", "popitem", "write", "writelines",
}


def _mutates(method):
    """A known mutating method, or a PyTorch in-place one (`add_`,
    `copy_`, `masked_fill_`: a name ending in one underscore), which
    `torch.cond` refuses in a branch (the JAX package has no in-place
    ops, so its list lacks them)."""
    return method in _MUTATING_METHODS or (
        method.endswith("_") and not method.endswith("__"))


def _has_effect_stores(nodes):
    """True if any attribute/subscript store (self.x = .., a[i] = ..) or
    known mutating METHOD CALL (list.append, dict.update, file.write...)
    appears — side effects a traced conditional cannot express: a
    tensor-`if` probes both branches at trace time (and lax.cond traces
    both anyway), so such statements would execute on the untaken
    branch.  Blocks containing them stay in python."""
    found = []

    class V(ast.NodeVisitor):
        def visit_Attribute(self, n):
            if isinstance(n.ctx, ast.Store):
                found.append(n)
            self.generic_visit(n)

        def visit_Subscript(self, n):
            if isinstance(n.ctx, ast.Store):
                found.append(n)
            self.generic_visit(n)

        def visit_Call(self, n):
            if isinstance(n.func, ast.Attribute) and \
                    _mutates(n.func.attr):
                found.append(n)
            self.generic_visit(n)

        def visit_FunctionDef(self, n):
            return

    for nd in nodes:
        V().visit(nd)
    return bool(found)


def _contains_break_continue(nodes):
    found = []

    class V(ast.NodeVisitor):
        def visit_Break(self, n):
            found.append(n)

        def visit_Continue(self, n):
            found.append(n)

        def visit_While(self, n):
            return  # inner loop owns its break/continue

        def visit_For(self, n):
            return

        def visit_FunctionDef(self, n):
            return

    for nd in nodes:
        V().visit(nd)
    return bool(found)


def _flags_rewritable(stmts):
    """True when every break/continue is reachable by the flag rewriter:
    at statement level or under ast.If chains only.  One inside with/try
    cannot become a staged predicate — the loop must stay python."""
    ok = True

    def walk(sts):
        nonlocal ok
        for st in sts:
            if isinstance(st, (ast.Break, ast.Continue)):
                continue
            if isinstance(st, ast.If):
                walk(st.body)
                walk(st.orelse)
            elif isinstance(st, (ast.While, ast.For, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                continue  # inner scope owns its break/continue
            elif _contains_break_continue([st]):
                ok = False

    walk(stmts)
    return ok


def _rewrite_break_continue(stmts, brk, cnt):
    """Turn `break`/`continue` into flag assignments and guard every
    statement that follows a potential flag-set with
    `if __d2s_alive__(brk, cnt): ...` — the staged-predicate form of the
    reference's BreakContinueTransformer (loop_transformer.py)."""

    def set_flag(name):
        return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                          value=ast.Constant(value=True))

    out = []
    for idx, st in enumerate(stmts):
        if isinstance(st, ast.Break):
            out.append(set_flag(brk))
            break  # statements after an unconditional break are dead
        if isinstance(st, ast.Continue):
            out.append(set_flag(cnt))
            break
        if isinstance(st, ast.If) and _contains_break_continue([st]):
            st = ast.If(test=st.test,
                        body=_rewrite_break_continue(st.body, brk, cnt)
                        or [ast.Pass()],
                        orelse=_rewrite_break_continue(st.orelse, brk, cnt))
            out.append(st)
            rest = _rewrite_break_continue(stmts[idx + 1:], brk, cnt)
            if rest:
                guard = ast.If(
                    test=ast.Call(
                        func=ast.Name(id="__d2s_alive__", ctx=ast.Load()),
                        args=[ast.Name(id=brk, ctx=ast.Load()),
                              ast.Name(id=cnt, ctx=ast.Load())],
                        keywords=[]),
                    body=rest, orelse=[])
                out.append(guard)
            break
        out.append(st)
    return out


def _names_used(nodes):
    used = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, n):
            used.add(n.id)

    for nd in nodes:
        V().visit(nd)
    return used


# frame/scope-sensitive builtins that must not be wrapped (zero-arg
# super() reads __class__ from the CALLING frame; locals/globals/vars
# likewise inspect the caller)
_NO_WRAP_CALLS = {"super", "locals", "globals", "vars", "eval", "exec",
                  "breakpoint"}


def _args_for(names):
    return ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=v) for v in names],
        kwonlyargs=[], kw_defaults=[], defaults=[])


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites If/While into __d2s_if__/__d2s_while__ helper calls."""

    def __init__(self):
        self._uid = 0
        # every name a converted block may output/carry: the function
        # prologue initializes them with an Undefined sentinel so a
        # branch that doesn't bind a name still returns cleanly (python
        # scoping is unchanged — these names are already function-local
        # by virtue of being assigned somewhere in the function)
        self.block_names: set = set()

    def _fresh(self, base):
        self._uid += 1
        return f"__d2s_{base}_{self._uid}"

    def _fresh_flag(self, base):
        """Flag VARIABLES (break/continue predicates) must be carried
        through staged blocks like user variables — so they must NOT use
        the __d2s_ scaffolding prefix that _assigned_names filters out."""
        self._uid += 1
        return f"_d2s_flag_{base}_{self._uid}"

    # -- if ---------------------------------------------------------------

    def visit_If(self, node):
        self.generic_visit(node)
        _check_unsupported(node.body + node.orelse, "if")
        if _has_effect_stores(node.body + node.orelse):
            # attribute/subscript stores are side effects lax.cond would
            # run on BOTH branches — leave this `if` in python (a tensor
            # pred then raises the loud Tensor.__bool__ error, never
            # silently corrupts state)
            return node
        outs = sorted(set(_assigned_names(node.body))
                      | set(_assigned_names(node.orelse)))
        self.block_names.update(outs)
        tname = self._fresh("true")
        fname = self._fresh("false")

        def mk_branch(name, body):
            # out-names come IN as parameters: a branch that reads a name
            # before (re)assigning it sees the enclosing value instead of
            # tripping UnboundLocalError in the extracted function scope
            ret = ast.Return(value=ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Load()) for v in outs],
                ctx=ast.Load()))
            fn = ast.FunctionDef(
                name=name, args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg=v) for v in outs],
                    kwonlyargs=[], kw_defaults=[], defaults=[]),
                body=(list(body) or [ast.Pass()]) + [ret],
                decorator_list=[], returns=None, type_params=[])
            return fn

        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Store()) for v in outs],
                ctx=ast.Store())] if outs else
            [ast.Name(id=self._fresh("void"), ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__d2s_if__", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=tname, ctx=ast.Load()),
                      ast.Name(id=fname, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Constant(value=v) for v in outs],
                                ctx=ast.Load())]
                + [ast.Name(id=v, ctx=ast.Load()) for v in outs],
                keywords=[]))
        return [mk_branch(tname, node.body),
                mk_branch(fname, node.orelse), call]

    # -- while / for ------------------------------------------------------

    def _flag_rewrite(self, node):
        """Break/continue → carried predicates, BEFORE inner-if staging
        (the rewriter needs raw ast.If nodes).  Returns (new body stmts,
        new test expr or None, flag-init stmts, stageable) — stageable
        False means a break/continue sits somewhere the rewriter can't
        reach (inside with/try/...), so the loop must stay python."""
        if not _contains_break_continue(node.body):
            return list(node.body), None, [], True
        if not _flags_rewritable(node.body):
            return list(node.body), None, [], False
        brk, cnt = self._fresh_flag("brk"), self._fresh_flag("cnt")
        false = lambda n: ast.Assign(
            targets=[ast.Name(id=n, ctx=ast.Store())],
            value=ast.Constant(value=False))
        body = [false(cnt)] + _rewrite_break_continue(node.body, brk, cnt)
        test = None
        if isinstance(node, ast.While):
            # loop continues while (test) and not brk
            test = ast.Call(
                func=ast.Name(id="__d2s_and_alive__", ctx=ast.Load()),
                args=[node.test, ast.Name(id=brk, ctx=ast.Load())],
                keywords=[])
        return body, test, [false(brk), false(cnt)], True

    def visit_While(self, node):
        if node.orelse:
            raise ConversionError("dy2static: while/else is not stageable")
        body, test, flag_init, stageable = self._flag_rewrite(node)
        if not stageable:
            # break/continue under with/try: keep the loop in python (a
            # tensor test then raises the loud Tensor.__bool__ error)
            self.generic_visit(node)
            return node
        node = ast.While(test=test or node.test, body=body, orelse=[])
        ast.fix_missing_locations(node)
        self.generic_visit(node)
        _check_unsupported(node.body, "while", allow_break=True)
        if _has_effect_stores(node.body):
            return flag_init + [node]
        # every name assigned in the body is a carry: the staged body fn
        # must thread them all (distinguishing true write-only temporaries
        # would need liveness analysis; correctness first)
        carries = sorted(_assigned_names(node.body))
        self.block_names.update(carries)
        cname = self._fresh("cond")
        bname = self._fresh("body")

        cond_fn = ast.FunctionDef(
            name=cname, args=_args_for(carries),
            body=[ast.Return(value=node.test)],
            decorator_list=[], returns=None, type_params=[])
        body_fn = ast.FunctionDef(
            name=bname, args=_args_for(carries),
            body=list(node.body) + [ast.Return(value=ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Load()) for v in carries],
                ctx=ast.Load()))],
            decorator_list=[], returns=None, type_params=[])
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Store()) for v in carries],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__d2s_while__", ctx=ast.Load()),
                args=[ast.Name(id=cname, ctx=ast.Load()),
                      ast.Name(id=bname, ctx=ast.Load())]
                + [ast.Name(id=v, ctx=ast.Load()) for v in carries],
                keywords=[]))
        return flag_init + [cond_fn, body_fn, call]

    def visit_For(self, node):
        """`for target in it:` → __d2s_for__(it, body_fn, carries...).
        range(tensor) / Tensor iterables stage into a while_loop with an
        index carry (ref loop_transformer.py for-handling); python
        iterables keep python semantics inside __d2s_for__."""
        if node.orelse:
            raise ConversionError("dy2static: for/else is not stageable")
        if not isinstance(node.target, ast.Name):
            self.generic_visit(node)
            return node  # tuple targets etc. stay python
        body, _, flag_init, stageable = self._flag_rewrite(node)
        if not stageable:
            self.generic_visit(node)
            return node
        brk_name = None
        if flag_init:
            brk_name = flag_init[0].targets[0].id
        node = ast.For(target=node.target, iter=node.iter, body=body,
                       orelse=[])
        ast.fix_missing_locations(node)
        self.generic_visit(node)
        _check_unsupported(node.body, "for", allow_break=True)
        if _has_effect_stores(node.body):
            return flag_init + [node]
        tgt = node.target.id
        # the target is a CARRY too: python leaves the loop variable bound
        # to its last value after the loop
        carries = sorted(set(_assigned_names(node.body)) | {tgt})
        self.block_names.update(carries)
        bname = self._fresh("forbody")
        itname = self._fresh("itval")
        body_fn = ast.FunctionDef(
            name=bname, args=_args_for([itname] + carries),
            body=[ast.Assign(targets=[ast.Name(id=tgt, ctx=ast.Store())],
                             value=ast.Name(id=itname, ctx=ast.Load()))]
            + list(node.body) + [ast.Return(value=ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Load()) for v in carries],
                ctx=ast.Load()))],
            decorator_list=[], returns=None, type_params=[])
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Store()) for v in carries],
                ctx=ast.Store())] if carries else
            [ast.Name(id=self._fresh("void"), ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__d2s_for__", ctx=ast.Load()),
                args=[node.iter,
                      ast.Name(id=bname, ctx=ast.Load()),
                      ast.Constant(value=brk_name),
                      ast.Constant(value=tgt),
                      ast.Tuple(elts=[ast.Constant(value=v)
                                      for v in carries], ctx=ast.Load())]
                + [ast.Name(id=v, ctx=ast.Load()) for v in carries],
                keywords=[]))
        return flag_init + [body_fn, call]

    # -- call conversion --------------------------------------------------

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Name):
            name = node.func.id
            if name == "range":
                # range(tensor_n) must not hit range.__index__ — route
                # through the staged-range constructor
                node.func = ast.Name(id="__d2s_range__", ctx=ast.Load())
            elif name not in _NO_WRAP_CALLS and \
                    not name.startswith("__d2s_"):
                node.func = ast.Call(
                    func=ast.Name(id="__d2s_call__", ctx=ast.Load()),
                    args=[node.func], keywords=[])
        return node



# -- runtime helpers the generated code calls -------------------------------


class _Undefined:
    """Value of a name a converted branch did not bind (python would
    raise NameError at USE; this raises the same, just at use-after-block
    instead of inside the branch — matching eager semantics closely)."""

    __slots__ = ("name",)

    def __init__(self, name="<var>"):
        self.name = name

    def _boom(self, *a, **k):
        raise NameError(
            f"dy2static: variable {self.name!r} was not assigned on the "
            "branch taken (and had no value before the block)")

    __call__ = __getattr__ = __bool__ = __iter__ = _boom
    __add__ = __radd__ = __mul__ = __rmul__ = __sub__ = _boom
    __repr__ = lambda self: f"<dy2static undefined {self.name!r}>"


def _defined(vals):
    return tuple(v for v in vals if not isinstance(v, _Undefined))


def _is_traced(*xs):
    from ..ops.control_flow import _is_traced as _ct
    return _ct(*_defined(xs))


def _device(*xs):
    from ..ops.control_flow import _device as _dv
    return _dv(*_defined(xs))


def _same_constant(a, b):
    """True when `a` and `b` are one non-tensor value: such an output
    of a tensor-`if` stays outside the staged op."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return False
    if a is b:
        return True
    return type(a) is type(b) and isinstance(a, (bool, int, float, str)) \
        and a == b


def _zeros_like(v, device):
    from ..ops.control_flow import as_tensor
    return torch.zeros_like(as_tensor(v, device))


def __d2s_if__(test, true_fn, false_fn, names, *vals):
    from ..ops import control_flow as cf
    if not _is_traced(test):
        return true_fn(*vals) if bool(test) else false_fn(*vals)
    device = _device(test, *vals)
    # probe both branch structures (their ops are dead code the caller
    # eliminates): a name assigned in only one branch cannot cross
    # torch.cond as it is.  The same probe finds the tensors the branches
    # read by closure, so cond runs none of its own.
    seen = cf._Seen()
    with seen:
        t_out = true_fn(*vals)
        f_out = false_fn(*vals)
    seen.returned((t_out, f_out))
    # names Undefined in BOTH probes stay sentinels outside the cond, as
    # do outputs that are one non-tensor value on both branches; a name
    # Undefined in exactly ONE probe had no pre-block value and is
    # assigned on one branch only — the unassigning branch contributes
    # zeros_like of the assigned value (the reference's RETURN_NO_VALUE
    # placeholder trick, return_transformer.py; the return-lowering
    # guard reads such a name only when its done-flag says the assigning
    # branch ran).  Each staged output is cast to its prototype: the
    # tensor one branch gives, else the true branch's Python scalar.
    keep, proto = [], {}
    for i in range(len(names)):
        t, f = t_out[i], f_out[i]
        tu, fu = isinstance(t, _Undefined), isinstance(f, _Undefined)
        if (tu and fu) or (not tu and not fu and _same_constant(t, f)):
            continue
        keep.append(i)
        tensors = [v for v in (t, f) if isinstance(v, torch.Tensor)]
        proto[i] = tensors[0] if tensors else \
            cf.as_tensor(f if tu else t, device)
    if not keep:
        return tuple(t_out)
    # torch.cond takes tensor operands only: the other values (Undefined
    # sentinels, Python objects) reach the branches by closure
    tpos = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)]

    def pick(fn):
        def run(*ops):
            vs = list(vals)
            for j, i in enumerate(tpos):
                vs[i] = ops[j]
            out = fn(*vs)
            # zeros of the prototype's shape and dtype, not zeros_like:
            # the prototype is a probe value, not an operand
            return tuple(torch.zeros(proto[i].shape, dtype=proto[i].dtype,
                                     device=device)
                         if isinstance(out[i], _Undefined)
                         else cf.as_tensor(out[i], device, like=proto[i])
                         for i in keep)
        return run

    staged = cf._cond(test, pick(true_fn), pick(false_fn),
                      tuple(vals[i] for i in tpos), seen)
    full = list(t_out)
    for j, i in enumerate(keep):
        full[i] = staged[j]
    return tuple(full)


def __d2s_alive__(brk, cnt):
    """True while neither break nor continue has fired (guards the tail
    of a loop body after a conditional break/continue)."""
    from ..ops.control_flow import _pred
    if _is_traced(brk, cnt):
        dev = _device(brk, cnt)
        return ~(_pred(brk, dev) | _pred(cnt, dev))
    return not (bool(brk) or bool(cnt))


def __d2s_truthy__(x):
    """bool(x) that stays traced for tensors (tests generated by the
    return-lowering guards)."""
    from ..ops.control_flow import _pred
    if _is_traced(x):
        return _pred(x, x.device)
    return bool(x)


def __d2s_and_alive__(test, brk):
    """`test and not brk` — the staged loop condition with a carried
    break predicate."""
    from ..ops.control_flow import _pred
    if _is_traced(test, brk):
        dev = _device(test, brk)
        return _pred(test, dev) & ~_pred(brk, dev)
    return bool(test) and not bool(brk)


class _StagedRange:
    """range() whose bounds may be traced tensors — constructed by the
    rewritten code so `range(tensor_n)` never hits range.__index__."""

    __slots__ = ("start", "stop", "step")

    def __init__(self, start, stop=None, step=None):
        if stop is None:
            start, stop = 0, start
        self.start, self.stop, self.step = start, stop, \
            (1 if step is None else step)

    def _parts(self):
        return (self.start, self.stop, self.step)

    @property
    def traced(self):
        return _is_traced(*self._parts())


def __d2s_range__(*args):
    r = _StagedRange(*args)
    if not r.traced:
        s, e, st = (int(v) for v in r._parts())
        return range(s, e, st)
    return r


def __d2s_for__(it, body_fn, brk_name, tgt_name, names, *vals):
    """Stage `for target in it` (ref loop_transformer.py):
      * _StagedRange with traced bounds → while_loop, index carry;
      * a tensor iterated along axis 0 under tracing → while_loop + a
        row by `index_select`;
      * anything else → plain python loop over body_fn (zero behavior
        change eagerly), honoring a concrete break flag."""
    from ..ops import control_flow as cf

    brk_idx = names.index(brk_name) if brk_name in names else -1

    def concrete_loop(seq):
        cur = tuple(vals)
        for x in seq:
            out = body_fn(x, *cur)
            cur = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            if brk_idx >= 0:
                b = cur[brk_idx]
                if _is_traced(b):
                    raise ConversionError(
                        "dy2static: break/continue predicate is a traced "
                        "tensor inside a `for` over a python iterable — "
                        "the iteration count cannot be staged.  Iterate a "
                        "tensor/range instead, or keep the predicate "
                        "concrete")
                if bool(b):
                    break
        return cur

    def staged_vals(init_tgt, device):
        """while_loop carries must be tensors: the loop target enters as
        a dummy of the right shape (it is overwritten before any read;
        an empty staged loop leaves the dummy, unlike python's unbound
        name — the price of static staging).  Other Undefined carries
        (write-before-read names like the return-lowering's retv) learn
        their type from a one-shot trace probe of the body; a carry the
        probe leaves Undefined is a read-before-assignment bug."""
        out = list(vals)
        for i, v in enumerate(out):
            if isinstance(v, _Undefined) and names[i] == tgt_name:
                out[i] = init_tgt
        still = [i for i, v in enumerate(out) if isinstance(v, _Undefined)]
        if still:
            probe = body_fn(init_tgt, *out)
            probe = tuple(probe) if isinstance(probe, (tuple, list)) \
                else (probe,)
            for i in still:
                if isinstance(probe[i], _Undefined):
                    raise NameError(
                        f"dy2static: variable {names[i]!r} is read in a "
                        "staged for-loop before any assignment")
                out[i] = _zeros_like(probe[i], device)
        return out

    any_traced = _is_traced(*vals)

    if isinstance(it, _StagedRange):
        device = _device(*it._parts(), *vals)
        start, stop, step = (cf.as_tensor(v, device) for v in it._parts())

        def cond(i, *cs):
            alive = torch.where(step > 0, i < stop, i > stop)
            if brk_idx >= 0:
                alive = alive & ~cf._pred(cs[brk_idx], device)
            return alive

        def body(i, *cs):
            out = body_fn(i, *cs)
            out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            return (i + step,) + out

        res = cf.while_loop(cond, body, [start] + staged_vals(start, device))
        return tuple(res[1:])

    if isinstance(it, torch.Tensor) and (_is_traced(it) or any_traced):
        n, device = it.shape[0], it.device

        def cond(i, *cs):
            alive = i < n
            if brk_idx >= 0:
                alive = alive & ~cf._pred(cs[brk_idx], device)
            return alive

        def body(i, *cs):
            x = it.index_select(0, i.reshape(1)).squeeze(0)
            out = body_fn(x, *cs)
            out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            return (i + 1,) + out

        init_tgt = torch.zeros(it.shape[1:], dtype=it.dtype, device=device)
        res = cf.while_loop(
            cond, body,
            [torch.zeros((), dtype=torch.int64, device=device)]
            + staged_vals(init_tgt, device))
        return tuple(res[1:])
    return concrete_loop(it)


# closure-free functions cache by (code, globals-id): stable and bounded
# by the program's code objects.  Functions WITH closures convert per
# object (their cell contents are baked into the converted globals) but
# live in a WeakKeyDictionary so per-call inner defs don't leak.
_CONVERT_CACHE_CODE: dict = {}
_CONVERT_CACHE_FN: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

# functions of these modules pass through __d2s_call__ unconverted
_PASS_THROUGH = ("paddle_tpu_torch", "torch", "numpy", "builtins",
                 "functools", "itertools")


def __d2s_call__(fn):
    """convert_call (ref dy2static/convert_call_func.py): plain user
    python functions convert on first call (cached); builtins, modules,
    the port's, PyTorch's and numpy's functions pass through untouched,
    as do functions of modules given to `jit.ignore_module`."""
    if not isinstance(fn, types.FunctionType):
        return fn
    if getattr(fn, "__not_to_static__", False) or \
            fn.__name__.startswith("__d2s_") or \
            getattr(fn, "__d2s_converted__", False):
        return fn
    mod = getattr(fn, "__module__", "") or ""
    if mod.startswith(_PASS_THROUGH) or _ignored(mod):
        return fn
    if fn.__closure__ is None:
        key = (fn.__code__, id(fn.__globals__))
        cached = _CONVERT_CACHE_CODE.get(key)
    else:
        key = None
        cached = _CONVERT_CACHE_FN.get(fn)
    if cached is None:
        try:
            cached = convert_to_static_ast(fn)
        except Exception:
            cached = fn
        if key is not None:
            _CONVERT_CACHE_CODE[key] = cached
        else:
            _CONVERT_CACHE_FN[fn] = cached
    return cached


def _ignored(mod):
    """True for a module name under one given to `jit.ignore_module`."""
    from . import _IGNORED_MODULES
    for m in _IGNORED_MODULES:
        name = getattr(m, "__name__", m)
        if isinstance(name, str) and (mod == name
                                      or mod.startswith(name + ".")):
            return True
    return False


def __d2s_while__(cond_fn, body_fn, *carries):
    from ..ops import control_flow as cf
    probe = cond_fn(*carries)
    if not _is_traced(probe, *carries):
        vals = tuple(carries)
        while bool(probe):
            out = body_fn(*vals)
            vals = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            probe = cond_fn(*vals)
        return vals
    carries = list(carries)
    still = [i for i, v in enumerate(carries) if isinstance(v, _Undefined)]
    if still:
        # type write-before-read carries (return-lowering retv) from a
        # one-shot trace probe of the body
        device = _device(probe, *carries)
        out = body_fn(*carries)
        out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        for i in still:
            if isinstance(out[i], _Undefined):
                raise NameError(
                    f"dy2static: variable {out[i].name!r} is read in a "
                    "staged while-loop before any assignment")
            carries[i] = _zeros_like(out[i], device)
    return tuple(cf.while_loop(cond_fn, body_fn, carries))


def convert_to_static_ast(fn):
    """Source-rewrite `fn` so tensor-valued `if`/`while`/`for` stage
    under a `torch.export` trace.

    Falls back to the original function (with a warning) when the source
    is unavailable (builtins, C extensions, REPL lambdas)."""
    if "__class__" in getattr(getattr(fn, "__code__", None),
                              "co_freevars", ()):
        raise ConversionError(
            f"dy2static: {fn.__qualname__} uses zero-argument super(), "
            "whose class cell a function recompiled from source lacks")
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        import warnings
        warnings.warn("dy2static: source unavailable; tensor `if`/`while` "
                      "will raise at trace time if reached")
        return fn
    tree = ast.parse(src)
    func_def = tree.body[0]
    if isinstance(func_def, ast.ClassDef):  # pragma: no cover
        return fn
    # only cosmetic/known decorators may be stripped; a behavioral
    # wrapper (no_grad, caching...) would be silently lost — fall back
    # to the unconverted function instead

    def _deco_name(d):
        t = d.func if isinstance(d, ast.Call) else d
        return t.attr if isinstance(t, ast.Attribute) else getattr(t, "id", "")
    known = {"to_static", "not_to_static", "wraps", "staticmethod"}
    if any(_deco_name(d) not in known for d in func_def.decorator_list):
        return fn
    func_def.decorator_list = []
    _lower_returns(func_def)     # early returns → value/flag assignments
    ast.fix_missing_locations(tree)
    tr = _ControlFlowTransformer()
    new_tree = tr.visit(tree)
    # prologue: sentinel-init every block-output name (args excluded) so
    # a branch that leaves a name unbound still returns a tuple; using
    # such a value later raises a NameError-equivalent at the use site
    arg_names = {a.arg for a in (func_def.args.posonlyargs
                                 + func_def.args.args
                                 + func_def.args.kwonlyargs)}
    inits = [
        ast.Assign(
            targets=[ast.Name(id=v, ctx=ast.Store())],
            value=ast.Call(func=ast.Name(id="__d2s_undef__", ctx=ast.Load()),
                           args=[ast.Constant(value=v)], keywords=[]))
        for v in sorted(tr.block_names) if v not in arg_names]
    func_def.body = inits + func_def.body
    ast.fix_missing_locations(new_tree)
    code = compile(new_tree, filename=f"<dy2static {fn.__qualname__}>",
                   mode="exec")
    glb = dict(fn.__globals__)
    glb["__d2s_if__"] = __d2s_if__
    glb["__d2s_while__"] = __d2s_while__
    glb["__d2s_for__"] = __d2s_for__
    glb["__d2s_range__"] = __d2s_range__
    glb["__d2s_alive__"] = __d2s_alive__
    glb["__d2s_and_alive__"] = __d2s_and_alive__
    glb["__d2s_truthy__"] = __d2s_truthy__
    glb["__d2s_call__"] = __d2s_call__
    glb["__d2s_undef__"] = _Undefined
    # rebuild the closure environment: converted code can't capture the
    # original cells, so freevars are injected as globals (the reference
    # does the same via function wrapping in convert_call)
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                glb[name] = cell.cell_contents
            except ValueError:
                pass
    loc: dict = {}
    exec(code, glb, loc)
    new_fn = loc[func_def.name]
    new_fn = functools.wraps(fn)(new_fn)
    new_fn.__d2s_converted__ = True
    return new_fn
