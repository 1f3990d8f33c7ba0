"""Adam and AdamW — the port of `paddle_tpu/optimizer/optimizers.py`'s
`Adam` / `AdamW` (paddle's decoupled decay, `p - lr * wd * p_old`)."""

from __future__ import annotations

import torch

from .optimizer import Optimizer, _weak

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    """`lazy_mode` and `use_multi_tensor` are accepted and, as in the JAX
    package, change nothing: every update is dense and per parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, use_multi_tensor=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, param):
        """Moments in the param's dtype, or fp32 with `multi_precision`."""
        dtype = torch.float32 if self._multi_precision else param.dtype
        return {"moment1": torch.zeros(param.shape, dtype=dtype,
                                       device=param.device),
                "moment2": torch.zeros(param.shape, dtype=dtype,
                                       device=param.device)}

    def update_rule(self, param, grad, state, lr, step):
        dt = state["moment1"].dtype
        b1, b2 = self._beta1, self._beta2
        g = grad.to(dt)
        m = _weak(b1, dt) * state["moment1"] + _weak(1 - b1, dt) * g
        v = _weak(b2, dt) * state["moment2"] + _weak(1 - b2, dt) \
            * torch.square(g)
        m_hat = m / _weak(1 - b1 ** step, dt)
        v_hat = v / _weak(1 - b2 ** step, dt)
        # lr is an fp32 array in the JAX step: lr * m_hat is fp32
        upd = m_hat.to(torch.float32) * lr \
            / (torch.sqrt(v_hat) + _weak(self._eps, dt)).to(torch.float32)
        return param - upd.to(param.dtype), {"moment1": m, "moment2": v}


class AdamW(Adam):
    decoupled_weight_decay = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW lr_ratio / apply_decay_param_fun are not ported "
                "(the JAX package's functional step ignores them too)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
