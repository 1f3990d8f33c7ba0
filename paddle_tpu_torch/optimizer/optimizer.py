"""Optimizer base — the port of `paddle_tpu/optimizer/optimizer.py`.

Each optimizer is a rule (`init_state` / `update_rule`) on tensors, as
in the JAX package; `functional_update` applies it to {name: param}
and {name: grad} for `jit.trainer.TrainStep`.  Where the JAX step returns
new arrays into donated buffers, the port writes the new values into the
parameters in place (under `no_grad`), so a step never holds two copies
of the model.

Rounding follows the JAX `TrainStep` (which runs with 64-bit types
enabled and passes lr as an fp32 array and the step as an int32 one):
a Python constant meets a tensor in the tensor's dtype (`_weak`: JAX's
weak types), lr meets a tensor as an fp32 0-dim array (so `lr * m_hat`
is fp32 even for bf16 moments), and the bias corrections are computed
in float64 on the host and rounded to the moments' dtype where they
divide.  Decoupled weight decay subtracts lr * wd times the parameter's
value before the update.
"""

from __future__ import annotations

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


def _weak(value: float, dtype) -> float:
    """A Python constant as JAX applies it to a `dtype` tensor: rounded
    to that dtype first."""
    return torch.tensor(value, dtype=dtype).item()


class Optimizer:
    """`parameters` is accepted for the JAX package's signature; the
    port's only step, `TrainStep`, hands the model's parameters to
    `functional_update` itself."""

    decoupled_weight_decay = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._lr = learning_rate
        if weight_decay is not None \
                and not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "weight_decay as a regularizer object is not ported: pass "
                "a float (ROADMAP: queue 1 item 7, the rest of the API)")
        self._wd = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision

    # -- rule interface (override in subclasses) --------------------------

    def init_state(self, param) -> dict:
        return {}

    def update_rule(self, param, grad, state: dict, lr: float, step: int):
        """-> (new param, new state); `lr` is an fp32 value."""
        raise NotImplementedError

    # -- lr ---------------------------------------------------------------

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    # -- the training step's interface ------------------------------------

    def functional_init(self, params: dict) -> dict:
        """{name: param} -> {name: state dict}."""
        return {name: self.init_state(p) for name, p in params.items()}

    @torch.no_grad()
    def functional_update(self, params: dict, grads: dict, opt_state: dict,
                          lr: float, step: int) -> None:
        """One update of every parameter, in place; `opt_state` entries
        are replaced by the new state."""
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_arrays(grads)
        lr32 = np.float32(lr)
        # lr (fp32) * wd, an fp32 0-dim value that meets the old param in
        # fp32 whatever the param's dtype
        lr_wd = float(lr32 * np.float32(self._wd))
        for name, p in params.items():
            g = grads[name]
            if self._wd and not self.decoupled_weight_decay:
                g = g + _weak(self._wd, g.dtype) * p.to(g.dtype)
            new_p, opt_state[name] = self.update_rule(
                p, g, opt_state[name], float(lr32), step)
            if self._wd and self.decoupled_weight_decay:
                new_p = new_p.to(torch.float32) - lr_wd * p.to(torch.float32)
            p.copy_(new_p.to(p.dtype))
