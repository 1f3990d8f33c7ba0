"""Optimizer base — the port of `paddle_tpu/optimizer/optimizer.py`.

Each optimizer is a rule (`init_state` / `update_rule`) on tensors, as
in the JAX package, applied two ways:

* the eager `step()` (with `minimize`, `clear_grad`, `state_dict` /
  `set_state_dict`, `set_lr`) over the `parameters` given at
  construction: each parameter with a gradient and `requires_grad`
  (JAX: not `stop_gradient`), after the clip's eager form, its state
  keyed by the parameter and named `param_{i}` in a state dict, as the
  JAX package names a parameter without a name;
* `functional_update` for `jit.trainer.TrainStep`: {name: param} from
  {name: grad}.  Adam and AdamW, with no clip or a global-norm one, go
  through `ops.fused_update`, two multi-tensor kernels on the card (U1:
  the global-norm clip's and the loss scaler's reduction; U2: the
  update) that apply the same rule in one pass over memory.  Every other
  rule, and Adam / AdamW under a per-tensor clip, runs
  `per_param_update`: the clip over all gradients, then `update_rule`
  parameter by parameter, op by op (the documented rule, and the
  reference the fused update is held to), with the loss scaler's
  unscale and skip as the JAX step does them
  (`paddle_tpu/jit/trainer.py:278-295`).

Where the JAX step returns new arrays into donated buffers, the port
writes the new values into the parameters and the state in place (under
`no_grad`), so a step never holds two copies of the model.  A gradient
of None (a parameter the loss does not reach) is a zero gradient in the
training step, as the JAX step's AD gives it; the eager step skips it,
as the JAX one does.

Rounding follows the JAX package (64-bit types enabled; the training
step passes lr as an fp32 array and the step as an int32 one): a Python
constant meets a tensor in the tensor's dtype (`_weak`: JAX's weak
types), and bias corrections are computed in float64 on the host and
rounded where they meet a tensor.  lr differs by path: in the training
step it is an fp32 array (a `float` here), so `lr * x` is fp32 even for
bf16 `x`; in the eager step it is a Python float (`WeakLr`), so it is
rounded to `x`'s dtype (`lr_times`).  Decoupled weight decay subtracts
lr * wd times the parameter's old value after the rule.

`weight_decay` takes a float or an `L2Decay` (its coeff: L2 in the
gradient, as a float).  An `L1Decay` is refused: the JAX package reads
only `_coeff` from any regularizer (:27-31), so it decays an `L1Decay`
as L2 (`regularizer.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.clip import ClipGradByGlobalNorm
from ..ops import fused_update as FU
from ..ops.fused_update import _weak
from .lr import LRScheduler

__all__ = ["Optimizer"]

_F32 = torch.float32


class WeakLr(float):
    """lr as the JAX eager step holds it: a Python float, rounded to the
    dtype of the tensor it meets (a plain `float` lr is the training
    step's fp32 array)."""


def lr_times(lr, x):
    """`lr * x` as the JAX rule computes it (module docstring)."""
    if isinstance(lr, WeakLr):
        return x * _weak(lr, x.dtype)
    return x.to(_F32) * lr


def lr_over(lr, divisor):
    """`lr / divisor` (a host float) as the JAX rule computes it: a
    Python division for the eager step's lr, an fp32 one for the
    training step's."""
    if isinstance(lr, WeakLr):
        return WeakLr(float(lr) / divisor)
    return float(np.float32(lr) / np.float32(divisor))


def _decay(weight_decay):
    """The L2 coefficient of `weight_decay` (module docstring)."""
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    if type(weight_decay).__name__ == "L1Decay":
        raise NotImplementedError(
            "weight_decay=L1Decay is not ported: the JAX optimizer reads "
            "only its coeff and decays as L2 (coeff * w, not coeff * "
            "sign(w)), so it would not be the L1 decay it names; pass an "
            "L2Decay or a float")
    if not hasattr(weight_decay, "_coeff"):
        raise TypeError(f"weight_decay must be a float or an L2Decay, got "
                        f"{type(weight_decay).__name__}")
    return float(weight_decay._coeff)


class Optimizer:
    decoupled_weight_decay = False
    fused = False                   # Adam / AdamW: ops.fused_update

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._lr = learning_rate
        self._parameters = list(parameters) if parameters is not None \
            else None
        self._wd = _decay(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._states: dict[int, dict] = {}
        self._step_count = 0
        self._param_names: dict[int, str] = {}
        for i, p in enumerate(self._parameters or []):
            self._param_names[id(p)] = getattr(p, "name", "") or f"param_{i}"

    # -- rule interface (override in subclasses) --------------------------

    def init_state(self, param) -> dict:
        return {}

    def update_rule(self, param, grad, state: dict, lr, step: int):
        """-> (new param, new state); `lr` is a float (the training
        step's fp32) or a `WeakLr` (the eager step's)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no update rule: it runs only "
            f"eagerly (optimizer.step()), as in the JAX package")

    # -- lr ---------------------------------------------------------------

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    @property
    def _learning_rate(self):
        return self._lr

    # -- eager step -------------------------------------------------------

    @torch.no_grad()
    def step(self):
        params = self._parameters
        if params is None:
            raise ValueError("Optimizer created without parameters")
        lr = WeakLr(self.get_lr())
        self._step_count += 1
        pg = [(p, p.grad) for p in params
              if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        for p, g in pg:
            if g is None:
                continue
            g = g.to(_F32) if self._multi_precision else g
            if self._wd and not self.decoupled_weight_decay:
                g = g + _weak(self._wd, g.dtype) * p.to(g.dtype)
            st = self._states.get(id(p))
            if st is None:
                st = self.init_state(p)
            new_p, new_st = self.update_rule(p, g, st, lr,
                                             self._step_count)
            if self._wd and self.decoupled_weight_decay:
                new_p = new_p - p * _weak(lr * self._wd, p.dtype)
            p.copy_(new_p.to(p.dtype))
            self._states[id(p)] = new_st

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    @torch.no_grad()
    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameters or []:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict -------------------------------------------------------

    def state_dict(self) -> dict:
        out = {"_step_count": self._step_count}
        for p in self._parameters or []:
            st = self._states.get(id(p))
            if st is None:
                continue
            name = self._param_names.get(id(p), "")
            for k, v in st.items():
                out[f"{name}.{k}"] = v
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state_dict: dict):
        self._step_count = int(state_dict.get("_step_count", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._lr,
                                                       LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        for p in self._parameters or []:
            prefix = f"{self._param_names.get(id(p), '')}."
            st = {k[len(prefix):]: torch.as_tensor(np.asarray(v))
                  if not isinstance(v, torch.Tensor) else v
                  for k, v in state_dict.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                cur = self._states.get(id(p)) or self.init_state(p)
                cur.update({k: v.to(p.device).clone()
                            for k, v in st.items()})
                self._states[id(p)] = cur

    # -- the training step's interface ------------------------------------

    def functional_init(self, params: dict) -> dict:
        """{name: param} -> {name: state dict}."""
        return {name: self.init_state(p) for name, p in params.items()}

    def _fused_hparams(self) -> dict:
        """The keywords of `ops.fused_update` for this rule."""
        raise NotImplementedError(
            f"{type(self).__name__} has no fused update: only Adam and "
            f"AdamW are fused")

    @torch.no_grad()
    def functional_update(self, params: dict, grads: dict, opt_state: dict,
                          lr: float, step: int, scale=None) -> dict:
        """One update of every parameter and its state, in place, with
        the clip and, given `scale` (a 0-dim fp32 loss scale on the
        params' device), the loss scaler's unscale and skip.  Adam /
        AdamW with no clip or a global-norm one: `ops.fused_update`,
        returning its {"global_norm", "clip_scale", "inv_scale",
        "found_inf"}; any other rule or clip: `per_param_update`,
        returning {"found_inf"} with a scale."""
        clip = self._grad_clip
        if not self.fused or not (clip is None
                                  or isinstance(clip, ClipGradByGlobalNorm)):
            return self.per_param_update(params, grads, opt_state, lr, step,
                                         scale=scale)
        names = list(params)
        return FU.fused_update(
            [params[n] for n in names], [grads.get(n) for n in names],
            [opt_state[n]["moment1"] for n in names],
            [opt_state[n]["moment2"] for n in names], lr=lr, step=step,
            clip_norm=clip.clip_norm if clip is not None else None,
            scale=scale, **self._fused_hparams())

    @torch.no_grad()
    def per_param_update(self, params: dict, grads: dict, opt_state: dict,
                         lr: float, step: int, scale=None) -> dict:
        """The update op by op: with `scale` the gradients unscaled in
        fp32 and rounded back, and `found_inf` (a non-finite one); the
        clip over all gradients; then `update_rule` per parameter.
        `opt_state` entries are replaced by the new state; with
        `found_inf` set, params and state keep their values."""
        grads = {n: grads.get(n) if grads.get(n) is not None
                 else torch.zeros_like(p) for n, p in params.items()}
        found_inf = None
        if scale is not None:
            inv = 1.0 / scale
            grads = {k: (g.to(_F32) * inv).to(g.dtype)
                     for k, g in grads.items()}
            found_inf = torch.zeros((), dtype=torch.bool, device=scale.device)
            for g in grads.values():
                found_inf |= ~torch.all(torch.isfinite(g))
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
            old = opt_state[name]
            new_p, new_st = self.update_rule(p, g, old, float(lr32), step)
            if self._wd and self.decoupled_weight_decay:
                new_p = new_p.to(_F32) - lr_wd * p.to(_F32)
            new_p = new_p.to(p.dtype)
            if found_inf is not None:
                new_p = torch.where(found_inf, p, new_p)
                new_st = {k: torch.where(found_inf, old[k].to(v.dtype), v)
                          for k, v in new_st.items()}
            p.copy_(new_p)
            opt_state[name] = new_st
        return {} if found_inf is None else {"found_inf": found_inf}
