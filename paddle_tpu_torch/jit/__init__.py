"""`paddle_tpu_torch.jit` — the port of `paddle_tpu/jit/`: the training
step (`jit.trainer.TrainStep`, `collect_state`, `bind_state`), staged
forwards (`to_static`, `TracedLayer`, `not_to_static`; `jit.dy2static`
converts tensor-valued control flow) and the deployment path
(`InputSpec`, `save`, `load`, `TranslatedLayer`), with the JAX
package's switches `enable_to_static`, `set_verbosity`,
`set_code_level` and `ignore_module`."""

from .api import (InputSpec, TracedLayer, TranslatedLayer, load,
                  not_to_static, save, to_static)
from .trainer import TrainStep, bind_state, collect_state

__all__ = ["to_static", "save", "load", "TracedLayer", "InputSpec",
           "TrainStep", "bind_state", "collect_state", "not_to_static",
           "TranslatedLayer", "enable_to_static", "set_verbosity",
           "set_code_level", "ignore_module"]

_TO_STATIC_ENABLED = {"on": True}
_VERBOSITY = {"level": 0}
_IGNORED_MODULES: list = []


def enable_to_static(flag: bool):
    """Globally switch to_static between compile and passthrough (ref
    jit/api.py::enable_to_static — used to debug eagerly); a
    `TracedLayer` reads it on every call."""
    _TO_STATIC_ENABLED["on"] = bool(flag)


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    """Dy2static transcription verbosity (ref jit/dy2static/logging_utils
    .py), recorded as the JAX package records it."""
    _VERBOSITY["level"] = int(level)


def set_code_level(level: int = 100, also_to_stdout: bool = False):
    """Ref prints transformed source at `level`; as in the JAX package
    this maps onto set_verbosity (a program's graph is printed by
    `TracedLayer.lower(...)`)."""
    set_verbosity(level)


def ignore_module(modules: list):
    """Mark modules whose functions dy2static must not convert (ref
    jit/api.py::ignore_module): they run as plain Python inside the
    trace.  Returns the list so far."""
    _IGNORED_MODULES.extend(modules if isinstance(modules, (list, tuple))
                            else [modules])
    return list(_IGNORED_MODULES)
