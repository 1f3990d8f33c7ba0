"""`jit.to_static`, `TracedLayer`, `jit.save` / `jit.load` and
`InputSpec` — the port of `paddle_tpu/jit/api.py`.

`TracedLayer(layer_or_fn)` (and `to_static`, which builds one) converts
the forward through `dy2static` (a tensor-valued `if` / `while` / `for`
stages as `torch.cond` / `while_loop`), with the layer's forward pre-
and post-hooks replayed around it; a `ConversionError` warns and keeps
the unconverted forward, as in the JAX package.  It holds one
`torch.export` program per signature of the positional inputs (shape,
dtype and device of each, and the layer's training flag): the JAX
cache's key, so a program has no dynamic dims.  A call runs the program
under `torch.no_grad()` and returns tensors.  The program reads the
layer's own parameters and buffers (`ExportedProgram.module()` holds the
same tensors, no copy), so a value changed in place (an optimizer step)
is seen by the next call, as the JAX `TracedLayer` reads the state on
every call.  A program that fails to export raises: the layer is never
run eagerly in its place.  `jit.enable_to_static(False)` makes every
call run the original eagerly (checked a call).  The probes of a staged
`if` leave dead code in the trace; it is eliminated before the program
runs.

`save(layer, path, input_spec)` writes three files:

* `path.pdparams` — the layer's state dict (`framework.io.save`);
* `path.pdmeta` — the JAX package's pickle of builtins,
  `{"input_spec": [(shape, dtype name), ...]}`;
* `path.pt2` — a `torch.export` program of the layer's forward as
  `TracedLayer` converts it, over the positional inputs of
  `input_spec`, weights inside (`torch.export.save`).

The JAX package writes a `jax.export` module (`.pdexport`) in the
program's place.  Here the program is an FX graph of ATen operators and
the port's own: each kernel call is one node of a custom operator (K1
is `paddle_tpu_torch::flash_fwd`), so loading the program needs the
port's operator modules but never a model class.

A dim of None or -1 in an `InputSpec` becomes a `torch.export.Dim`
(`dyn{input}_{axis}`, at least 1), traced at an example size of 2:
`torch.export` specialises a dim it sees at 1, where the JAX package
traces at 1.  The program is traced on the device of the layer's
weights (the graph records devices: ERNIE builds its bias on the ids'
device) in the layer's current mode, under `torch.no_grad()`.  A layer
in training mode with dropout is refused, by `save` and by a
`TracedLayer` call alike: the port keeps no fixed key
(`paddle_tpu/jit/api.py` traces `save` with `PRNGKey(0)` and draws a
fresh key for each `TracedLayer` call), so the program would replay the
one mask drawn on the host at trace time.

`load(path, device=None)` returns a `TranslatedLayer` over `path.pt2`
on `device`, the card unless the caller names another (its `train()`
raises), or for a params-only save the `.pdparams` state dict.  A JAX
`.pdexport` is StableHLO, which the port does not run: loading one
raises.  The native PJRT loader's `.stablehlo` / `.pdbin` pair is not
written."""

from __future__ import annotations

import os
import pickle
import types
import warnings

import torch

from ..framework import io as _io
from ..nn.layer import Dropout

__all__ = ["InputSpec", "not_to_static", "to_static", "TracedLayer", "save",
           "load", "TranslatedLayer"]

EXAMPLE_DIM = 2          # the traced size of a dynamic dim


class InputSpec:
    """ref: paddle.static.InputSpec — a shape (None or -1: any size
    there) and a dtype name."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name


def not_to_static(fn):
    fn.__not_to_static__ = True
    return fn


def _dtype(d):
    """A dtype name ("int64"), numpy dtype or torch.dtype as a torch
    dtype."""
    if isinstance(d, torch.dtype):
        return d
    return getattr(torch, getattr(d, "name", str(d)))


def _dynamic(d):
    return d is None or d <= 0


def _dropout_p(m):
    """The dropout probability a module draws with, 0.0 for none."""
    if isinstance(m, (Dropout, torch.nn.Dropout)):
        return float(m.p)
    return float(getattr(m, "dropout_p", 0.0))


def _device(layer):
    """The device of the layer's weights (the card for a layer without
    any)."""
    from .. import default_device
    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    return default_device()


def _refuse_dropout(layer, what):
    """Raises for a layer in training mode with dropout (module
    docstring)."""
    drops = sorted(n or "(the layer)" for n, m in layer.named_modules()
                   if m.training and _dropout_p(m) > 0.0)
    if drops:
        raise ValueError(
            f"{what} of a layer in training mode with dropout ({drops}): "
            f"the port keeps no fixed key, so the program would replay the "
            f"one mask (attention dropout: the one seed and offset) drawn "
            f"on the host at trace time; call .eval() or set the dropout "
            f"probability to 0")


def _export(module, args, dynamic=None):
    """`torch.export` (non-strict) of `module` over `args` under
    `no_grad`, with the dead code of staged-`if` probes eliminated (in
    every graph of the program)."""
    with torch.no_grad():
        program = torch.export.export(module, tuple(args),
                                      dynamic_shapes=dynamic, strict=False)
    for m in program.graph_module.modules():
        if isinstance(m, torch.fx.GraphModule) \
                and m.graph.eliminate_dead_code():
            m.recompile()
    return program


def export(layer, input_spec):
    """The `torch.export` program of `layer` (an nn.Module or a
    `TracedLayer` over one) over `input_spec`: the converted forward of
    `TracedLayer` (the rules of the module docstring)."""
    traced = layer if isinstance(layer, TracedLayer) else None
    if traced is None and not isinstance(layer, torch.nn.Module):
        raise TypeError(f"jit.save exports an nn.Module, got "
                        f"{type(layer).__name__}")
    if traced is None:
        traced = TracedLayer(layer)
    if traced.layer is not None:
        _refuse_dropout(traced.layer, "jit.save")
        device = _device(traced.layer)
    else:
        from .. import default_device
        device = default_device()
    args, dims = [], []
    for i, s in enumerate(input_spec):
        args.append(torch.zeros([EXAMPLE_DIM if _dynamic(d) else d
                                 for d in s.shape], dtype=_dtype(s.dtype),
                                device=device))
        dims.append({j: torch.export.Dim(f"dyn{i}_{j}", min=1)
                     for j, d in enumerate(s.shape) if _dynamic(d)} or None)
    # the program's forward takes *args: one positional group
    dynamic = (tuple(dims),) if any(dims) else None
    return _export(traced.program_module, args, dynamic)


class _Program(torch.nn.Module):
    """The traced forward as a module: it holds the layer (whose
    parameters and buffers become the program's state) and calls the
    converted forward."""

    def __init__(self, layer, fn):
        super().__init__()
        self.layer = layer
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _hooked(layer, conv):
    """`conv(layer, *inputs)` with the layer's forward pre- and
    post-hooks replayed around it, as `nn.Module.__call__` runs them."""
    def run(*inputs):
        pre_kw = layer._forward_pre_hooks_with_kwargs
        for hid, hook in list(layer._forward_pre_hooks.items()):
            if hid in pre_kw:
                res = hook(layer, inputs, {})
                if res is not None:
                    inputs = res[0]
            else:
                res = hook(layer, inputs)
                if res is not None:
                    inputs = res if isinstance(res, tuple) else (res,)
        out = conv(layer, *inputs)
        post_kw = layer._forward_hooks_with_kwargs
        for hid, hook in list(layer._forward_hooks.items()):
            res = hook(layer, inputs, {}, out) if hid in post_kw \
                else hook(layer, inputs, out)
            if res is not None:
                out = res
        return out
    return run


def _convert(fn, what):
    """dy2static of `fn`, or `fn` itself on a conversion failure (a
    ConversionError warns, as in the JAX package)."""
    from .dy2static import ConversionError, convert_to_static_ast
    try:
        return convert_to_static_ast(fn)
    except Exception as e:
        if isinstance(e, ConversionError):
            warnings.warn(f"to_static: {e} — running the UNCONVERTED "
                          f"{what} (tensor-valued control flow will raise "
                          f"at trace time)")
        return None


class TracedLayer:
    """A compiled forward over an nn.Module, or over a function (module
    docstring)."""

    def __init__(self, layer_or_fn, input_spec=None):
        if isinstance(layer_or_fn, torch.nn.Module):
            self.layer = layer = layer_or_fn
            self._eager = layer
            fwd = type(layer).forward
            conv = None if getattr(fwd, "__not_to_static__", False) \
                else _convert(fwd, "forward")
            self.fn = layer.__call__ if conv is None else _hooked(layer, conv)
        else:
            fn = layer_or_fn
            self._eager = fn
            owner = getattr(fn, "__self__", None)
            self.layer = owner if isinstance(owner, torch.nn.Module) \
                else None
            func = getattr(fn, "__func__", fn)
            conv = None if getattr(func, "__not_to_static__", False) \
                else _convert(func, "function")
            if conv is None:
                self.fn = fn
            else:
                self.fn = conv if owner is None \
                    else types.MethodType(conv, owner)
        self.input_spec = input_spec
        self.program_module = _Program(self.layer, self.fn)
        self._cache = {}            # signature -> (program, its module)
        self._drops = [] if self.layer is None else [
            (n or "(the layer)", m) for n, m in self.layer.named_modules()
            if _dropout_p(m) > 0.0]

    def _args(self, args):
        """The positional inputs as tensors: an array-like goes to the
        device of the tensor inputs, else of the layer's weights."""
        if all(isinstance(a, torch.Tensor) for a in args):
            return tuple(args)
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
        if device is None and self.layer is not None:
            device = next((t.device for t in list(self.layer.parameters())
                           + list(self.layer.buffers())), None)
        return tuple(a if isinstance(a, torch.Tensor)
                     else torch.as_tensor(a, device=device) for a in args)

    def _key(self, args):
        return tuple((tuple(a.shape), a.dtype, a.device) for a in args) \
            + (self.layer is not None and self.layer.training,)

    def _entry(self, args):
        """(program, its module) of this signature, exported on first
        use; a layer in training mode with dropout raises every call."""
        if any(m.training for _, m in self._drops):
            _refuse_dropout(self.layer, "to_static")
        key = self._key(args)
        entry = self._cache.get(key)
        if entry is None:
            program = _export(self.program_module, args)
            entry = self._cache[key] = (program, program.module())
        return entry

    @property
    def programs(self):
        """{signature: ExportedProgram} traced so far."""
        return {k: p for k, (p, _) in self._cache.items()}

    def __call__(self, *args):
        from . import _TO_STATIC_ENABLED
        if not _TO_STATIC_ENABLED["on"]:
            # enable_to_static(False) after decoration: run the original
            # eagerly (the reference's debug path), checked a call
            return self._eager(*args)
        args = self._args(args)
        _, module = self._entry(args)
        with torch.no_grad():
            return module(*args)

    def lower(self, *args):
        """The `ExportedProgram` of this signature (its printed graph
        stands where the JAX package returns StableHLO text)."""
        return self._entry(self._args(args))[0]


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator / wrapper: a `TracedLayer` over a function or a layer.
    Honors `jit.enable_to_static(False)`: returns the callable unchanged
    so it runs eagerly (ref jit/api.py::enable_to_static).
    `build_strategy` and `backend` are accepted and, as in the JAX
    package, change nothing."""
    def deco(fn):
        from . import _TO_STATIC_ENABLED
        if not _TO_STATIC_ENABLED["on"]:
            return fn
        return TracedLayer(fn, input_spec)
    if function is not None:
        return deco(function)
    return deco


def save(layer, path, input_spec=None, **config):
    """paddle.jit.save: `path.pdparams`, and with an `input_spec`
    `path.pdmeta` and the program `path.pt2` (module docstring)."""
    if isinstance(layer, TracedLayer):
        input_spec = input_spec or layer.input_spec
    if input_spec:
        program = export(layer, input_spec)   # refuses before any write
    model = layer.layer if isinstance(layer, TracedLayer) else layer
    _io.save(model.state_dict(), path + ".pdparams")
    if not input_spec:
        return
    meta = {"input_spec": [(list(s.shape), str(_dtype(s.dtype))
                            .split(".")[-1]) for s in input_spec]}
    _io.atomic_write(path + ".pdmeta", lambda f: pickle.dump(meta, f))
    _io.atomic_write(path + ".pt2",
                     lambda f: torch.export.save(program, f))


def load(path, device=None, **config):
    """paddle.jit.load: a `TranslatedLayer` over `path.pt2` on `device`
    (the card unless named), else the `.pdparams` state dict of a
    params-only save.  A path whose artifact is the JAX package's
    `.pdexport` raises."""
    if os.path.exists(path + ".pt2"):
        return TranslatedLayer(path, device)
    if os.path.exists(path + ".pdexport"):
        raise ValueError(
            f"{path}.pdexport is the JAX package's jax.export (StableHLO) "
            f"artifact, which the port does not run: save the model with "
            f"paddle_tpu_torch.jit.save (a .pt2 program), or read its "
            f"weights with paddle_tpu_torch.framework.io.load("
            f"{path!r} + '.pdparams')")
    return _io.load(path + ".pdparams")


class TranslatedLayer:
    """The callable a saved program loads back into (ref
    jit/translated_layer.py): the weights are inside the program, so no
    model class is built.  Runs on `device` (the card unless named;
    without one, it raises), taking and returning tensors there."""

    def __init__(self, path, device=None):
        from ..inference.serving import standalone_load
        self._pred = standalone_load(path, device)
        self._path = path

    def __call__(self, *args):
        return self._pred.forward(*args)

    forward = __call__

    def eval(self):
        return self

    def train(self, mode=True):
        raise RuntimeError(
            "TranslatedLayer is an inference artifact; rebuild the model "
            "and load the .pdparams to fine-tune (ref translated_layer "
            "train() requires the full program too)")
