"""paddle.regularizer — the port of `paddle_tpu/regularizer.py` (ref
python/paddle/regularizer.py): `L1Decay` / `L2Decay` weight-decay
descriptors.

An optimizer takes an `L2Decay` as `weight_decay` (its `coeff` is the
decay, added to the gradient as `coeff * w`, as a float `weight_decay`
is).  It refuses an `L1Decay`: the JAX optimizer reads only `_coeff`
from any regularizer object (`paddle_tpu/optimizer/optimizer.py:27-31`),
so there an `L1Decay(c)` decays as L2 (`c * w`, not `c * sign(w)`) and
`grad_term` is never read."""

from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """L1 weight decay: adds coeff * sign(w) to the gradient — the
    subgradient of coeff * |w| (ref regularizer.py L1Decay)."""

    def grad_term(self, param_value):
        return self._coeff * torch.sign(param_value)

    def penalty(self, param_value):
        return self._coeff * torch.sum(torch.abs(param_value))


class L2Decay(WeightDecayRegularizer):
    """L2 weight decay: adds coeff * w to the gradient — the gradient of
    0.5 * coeff * ||w||^2 (ref regularizer.py L2Decay)."""

    def grad_term(self, param_value):
        return self._coeff * param_value

    def penalty(self, param_value):
        return 0.5 * self._coeff * torch.sum(param_value * param_value)
