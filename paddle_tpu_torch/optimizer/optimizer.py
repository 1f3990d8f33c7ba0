"""Optimizer base — the port of `paddle_tpu/optimizer/optimizer.py`.

Each optimizer is a rule (`init_state` / `update_rule`) on tensors, as
in the JAX package.  `functional_update` updates {name: param} from
{name: grad} for `jit.trainer.TrainStep`: for Adam and AdamW through
`ops.fused_update`, two multi-tensor kernels on the card (U1: the
global-norm clip's and the loss scaler's reduction; U2: the update) that
apply the same rule in one pass over memory.  `per_param_update` applies
`update_rule` parameter by parameter, op by op: the documented rule, and
the reference the fused update is held to.  Where the JAX step returns
new arrays into donated buffers, the port writes the new values into the
parameters and moments in place (under `no_grad`), so a step never holds
two copies of the model.  A gradient of None (a parameter the loss does
not reach) is a zero gradient, as the JAX step's AD gives it.

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

from ..ops import fused_update as FU
from ..ops.fused_update import _weak
from .lr import LRScheduler

__all__ = ["Optimizer"]


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

    def _fused_hparams(self) -> dict:
        """The keywords of `ops.fused_update` for this rule."""
        raise NotImplementedError(
            f"{type(self).__name__} has no fused update: only Adam and "
            f"AdamW are ported")

    @torch.no_grad()
    def functional_update(self, params: dict, grads: dict, opt_state: dict,
                          lr: float, step: int, scale=None) -> dict:
        """One update of every parameter and its moments, in place, with
        the global-norm clip and, given `scale` (a 0-dim fp32 loss scale
        on the params' device), the loss scaler's unscale and skip:
        `ops.fused_update`.  Returns its {"global_norm", "clip_scale",
        "inv_scale", "found_inf"}."""
        names = list(params)
        clip = self._grad_clip.clip_norm if self._grad_clip is not None \
            else None
        return FU.fused_update(
            [params[n] for n in names], [grads.get(n) for n in names],
            [opt_state[n]["moment1"] for n in names],
            [opt_state[n]["moment2"] for n in names], lr=lr, step=step,
            clip_norm=clip, scale=scale, **self._fused_hparams())

    @torch.no_grad()
    def per_param_update(self, params: dict, grads: dict, opt_state: dict,
                         lr: float, step: int) -> None:
        """The same update as `functional_update` (without a loss scale),
        op by op: the clip over all gradients, then `update_rule` per
        parameter; `opt_state` entries are replaced by the new state."""
        grads = {n: g if g is not None else torch.zeros_like(params[n])
                 for n, g in grads.items()}
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
