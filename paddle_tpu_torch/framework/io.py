"""Checkpoint I/O — the port of `paddle_tpu/framework/io.py`
(`paddle.save` / `paddle.load` over pickled nested state).

A tensor is pickled as a `_TensorPayload` (numpy `array`,
`stop_gradient`, `name`: the JAX payload's fields); dicts, lists and
tuples nest around them.  `save` writes atomically (a tmp file,
fsync'd, then `os.replace`d over `path`), so a crash mid-write never
truncates an existing checkpoint.

`load` reads the port's files and the JAX package's `.pdparams` alike
without importing `paddle_tpu`: its unpickler maps the JAX payload
class, `paddle_tpu.framework.io._TensorPayload`, onto the local one and
refuses every other global but the builtins and what numpy needs to
rebuild an array.  A JAX bfloat16 array (Llama's weights) names
`ml_dtypes.bfloat16` as its dtype: that one name is mapped too, without
importing ml_dtypes, and the array is rebuilt from its bits as uint16.
`load` returns torch tensors (bfloat16 kept), or the numpy arrays with
`return_numpy=True`, bfloat16 widened exactly to fp32 (numpy has no
bfloat16; `models.load_reference_arrays` takes those, so the JAX
package's weights reach the port from a file)."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

# the globals a checkpoint may name besides the payload class, the
# builtins and ml_dtypes.bfloat16: numpy's array and dtype
# reconstruction (both module paths: numpy 1.x and 2.x) and OrderedDict
_MULTIARRAY = ("numpy.core.multiarray", "numpy._core.multiarray")
_NUMPY_GLOBALS = {(mod, "scalar") for mod in _MULTIARRAY} | {
    ("numpy", "ndarray"), ("collections", "OrderedDict")}
_PAYLOAD_MODULES = ("paddle_tpu.framework.io", __name__)
# builtin types a pickle of plain containers may name (never a function:
# no eval, getattr or exec)
_BUILTINS = frozenset({"set", "frozenset", "bytearray", "complex", "slice",
                       "range", "list", "dict", "tuple", "int", "float",
                       "str", "bytes", "bool"})


class _TensorPayload:
    """Pickle surrogate of a tensor: numpy `array` plus metadata.
    numpy has no bfloat16, so a bfloat16 tensor is kept as fp32 with
    `dtype` naming it."""

    def __init__(self, t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            self.dtype = "bfloat16"
            t = t.to(torch.float32)
        self.array = t.numpy()
        self.stop_gradient = not t.requires_grad
        self.name = None


class _Bfloat16Dtype:
    """`numpy.dtype(ml_dtypes.bfloat16)` as a checkpoint rebuilds it:
    a marker (numpy has no bfloat16)."""

    def __setstate__(self, state):
        pass


class _BFLOAT16:
    """Stands for `ml_dtypes.bfloat16` in a checkpoint."""


def _np_dtype(obj, align=False, copy=False):
    """`numpy.dtype` as a checkpoint calls it."""
    if obj is _BFLOAT16:
        return _Bfloat16Dtype()
    return np.dtype(obj, align, copy)


class _Array(np.ndarray):
    """An array as a checkpoint rebuilds it: a bfloat16 one keeps its
    bits as uint16 and says so in `bfloat16`."""

    bfloat16 = False

    def __setstate__(self, state):
        if isinstance(state[2], _Bfloat16Dtype):
            self.bfloat16 = True
            state = (state[0], state[1], np.dtype(np.uint16), *state[3:])
        super().__setstate__(state)


def _reconstruct(subtype, shape, dtype):
    """`numpy.core.multiarray._reconstruct` as a checkpoint calls it."""
    return np.ndarray.__new__(_Array, shape, np.uint8)


def _widen(bits):
    """bfloat16 bits (uint16) as the fp32 values they stand for."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _plain(a, return_numpy):
    """A rebuilt array as the caller takes it: a numpy array (bfloat16
    widened to fp32), or a torch tensor (bfloat16 kept)."""
    bf16 = isinstance(a, _Array) and a.bfloat16
    a = a.view(np.ndarray)
    if return_numpy:
        return _widen(a) if bf16 else a
    if bf16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return type(obj)((k, _pack(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        t = _plain(obj.array, return_numpy)
        if not return_numpy and getattr(obj, "dtype", None) == "bfloat16":
            t = t.to(torch.bfloat16)
        return t
    if isinstance(obj, np.ndarray):
        return _plain(obj, True)
    if isinstance(obj, dict):
        return type(obj)((k, _unpack(v, return_numpy))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_TensorPayload" and module in _PAYLOAD_MODULES:
            return _TensorPayload
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _BFLOAT16
        if (module, name) == ("numpy", "dtype"):
            return _np_dtype
        if module in _MULTIARRAY and name == "_reconstruct":
            return _reconstruct
        if (module == "builtins" and name in _BUILTINS) \
                or (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint names the global {module}.{name}: only tensor "
            f"payloads, plain containers and numpy arrays are loaded")


def save(obj, path, protocol=4, **configs):
    """Atomic save of `obj` (tensors nested in dicts, lists, tuples): the
    payload goes to `path + ".tmp"`, is fsync'd, then `os.replace`d over
    `path`."""
    atomic_write(path, lambda f: pickle.dump(_pack(obj), f,
                                             protocol=protocol))


def atomic_write(path, write):
    """`write(f)` into `path + ".tmp"`, fsync, then `os.replace` it over
    `path`; the tmp file is removed if anything fails."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load(path, return_numpy=False, **configs):
    """The object `save` (of either package) wrote at `path`, its tensors
    as torch tensors, or as numpy arrays with `return_numpy=True`."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy)
