"""`jit.save` / `jit.load` and `InputSpec` — the port of
`paddle_tpu/jit/api.py`'s deployment path.

`save(layer, path, input_spec)` writes three files:

* `path.pdparams` — the layer's state dict (`framework.io.save`);
* `path.pdmeta` — the JAX package's pickle of builtins,
  `{"input_spec": [(shape, dtype name), ...]}`;
* `path.pt2` — a `torch.export` program of `layer.forward` over the
  positional inputs of `input_spec`, weights inside (`torch.export.save`).

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
in training mode with dropout is refused: the port keeps no fixed key
(`paddle_tpu/jit/api.py` traces with `PRNGKey(0)`), so the program
would replay the one mask drawn on the host at trace time.

`load(path, device=None)` returns a `TranslatedLayer` over `path.pt2`
on `device`, the card unless the caller names another (its `train()`
raises), or for a params-only save the `.pdparams` state dict.  A JAX
`.pdexport` is StableHLO, which the port does not run: loading one
raises.  The native PJRT loader's `.stablehlo` / `.pdbin` pair is not
written."""

from __future__ import annotations

import os
import pickle

import torch

from ..framework import io as _io
from ..nn.layer import Dropout

__all__ = ["InputSpec", "not_to_static", "save", "load", "TranslatedLayer"]

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


def export(layer, input_spec):
    """The `torch.export` program of `layer` over `input_spec` (the
    rules of the module docstring)."""
    if not isinstance(layer, torch.nn.Module):
        raise TypeError(f"jit.save exports an nn.Module, got "
                        f"{type(layer).__name__}")
    drops = sorted(n or "(the layer)" for n, m in layer.named_modules()
                   if m.training and _dropout_p(m) > 0.0)
    if drops:
        raise ValueError(
            f"jit.save of a layer in training mode with dropout ({drops}): "
            f"the port keeps no fixed key, so the program would replay the "
            f"one mask (attention dropout: the one seed and offset) drawn "
            f"on the host at trace time; call .eval() or set the dropout "
            f"probability to 0")
    device = _device(layer)
    args, dims = [], []
    for i, s in enumerate(input_spec):
        args.append(torch.zeros([EXAMPLE_DIM if _dynamic(d) else d
                                 for d in s.shape], dtype=_dtype(s.dtype),
                                device=device))
        dims.append({j: torch.export.Dim(f"dyn{i}_{j}", min=1)
                     for j, d in enumerate(s.shape) if _dynamic(d)} or None)
    dynamic = tuple(dims) if any(dims) else None
    with torch.no_grad():
        return torch.export.export(layer, tuple(args),
                                   dynamic_shapes=dynamic)


def save(layer, path, input_spec=None, **config):
    """paddle.jit.save: `path.pdparams`, and with an `input_spec`
    `path.pdmeta` and the program `path.pt2` (module docstring)."""
    if input_spec:
        program = export(layer, input_spec)   # refuses before any write
    _io.save(layer.state_dict(), path + ".pdparams")
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
