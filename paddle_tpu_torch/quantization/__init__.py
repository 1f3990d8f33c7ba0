"""paddle.quantization — the port of `paddle_tpu/quantization/__init__.py`
(ref: python/paddle/quantization/ — QuantConfig + QAT wrapper; legacy
slim ImperativeQuantAware / PTQ; fake_quant ops).

Fake-quant with a straight-through gradient for QAT
(`fake_quantize_abs_max`: `x + (deq - x).detach()`, so the gradient is
exactly the identity), `QuantConfig` / `QAT` / `PTQ` over the port's
`Linear` and `Conv2D`, and real int8 execution for serving
(`quantization.int8`: `quantize_for_inference`, `Int8Linear` /
`Int8Conv2D` on kernel Q2), beside the serving engine's int8 helpers.

A quantized layer (`_QuantedLayer`) fake-quantizes its input with its
activation quanter and the inner layer's weight per output channel (8
bits), and runs the inner layer on that weight through
`torch.func.functional_call`, so the weight's gradient reaches the real
parameter through the straight-through estimator.  `QAT.convert` bakes
the fake-quantized weight into the parameter and unwraps the layer.
`FakeQuanterWithAbsMax` takes and ignores `moving_rate`, as the JAX
class does.
"""

from __future__ import annotations

import abc as _abc

import torch
from torch import nn

from ..nn.layer import Conv2D, Linear
from .int8 import (Int8Conv2D, Int8Linear, dequantize_kv, matmul_wo_int8,
                   quantize_for_inference, quantize_kv_rows, quantize_weight,
                   weight_only_int8)

__all__ = ["QuantConfig", "QAT", "PTQ", "quanter", "FakeQuanterWithAbsMax",
           "fake_quantize_abs_max", "quantize_for_inference",
           "Int8Linear", "Int8Conv2D", "BaseQuanter", "BaseObserver",
           "quantize_weight", "weight_only_int8", "matmul_wo_int8",
           "quantize_kv_rows", "dequantize_kv"]


def fake_quantize_abs_max(x, bit_length=8, channel_axis=None):
    """Quantize-dequantize with a straight-through estimator (ref:
    fake_quantize_op abs_max kernels): scale = max|x| (per channel
    along `channel_axis`), at least 1e-8; q = clip(round(x / scale *
    qmax), +-qmax), qmax = 2^(bits - 1) - 1; the value q * scale / qmax,
    the gradient the identity."""
    qmax = float(2 ** (bit_length - 1) - 1)
    if channel_axis is None:
        scale = torch.clamp_min(x.abs().amax(), 1e-8)
    else:
        axes = tuple(i for i in range(x.dim()) if i != channel_axis)
        scale = torch.clamp_min(x.abs().amax(dim=axes, keepdim=True), 1e-8)
    q = torch.round(x / scale * qmax)
    q = torch.clamp(q, -qmax, qmax)
    deq = q * scale / qmax
    return x + (deq - x).detach()


class FakeQuanterWithAbsMax(nn.Module):
    """ref: quantization/quanters/abs_max.py FakeQuanterWithAbsMaxObserver"""

    def __init__(self, bit_length=8, moving_rate=0.9, name=None):
        super().__init__()
        self.bit_length = bit_length

    def forward(self, x):
        return fake_quantize_abs_max(x, self.bit_length)


def quanter(name=None, **kwargs):
    return FakeQuanterWithAbsMax(**kwargs)


class QuantConfig:
    """ref: quantization/config.py QuantConfig — which layers get which
    quanters."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation or FakeQuanterWithAbsMax
        self.weight = weight or FakeQuanterWithAbsMax
        self._types = (Linear, Conv2D)
        self._layer_overrides = {}

    def add_layer_config(self, layer, activation=None, weight=None):
        """Per-layer quanter override; (None, None) exempts the layer."""
        self._layer_overrides[id(layer)] = (activation, weight)

    def add_type_config(self, types, activation=None, weight=None):
        self._types = tuple(types)
        if activation is not None:
            self.activation = activation
        if weight is not None:
            self.weight = weight


def _channel_axis_for(layer):
    """Output-channel axis per layer kind (ref quantizes per out-channel):
    Linear weight is [in, out] -> last; Conv weight is [out, in, kh, kw]
    -> 0."""
    return 0 if isinstance(layer, Conv2D) else layer.weight.dim() - 1


class _QuantedLayer(nn.Module):
    """Wraps a Linear / Conv2D with weight + activation fake-quant."""

    def __init__(self, inner, config: QuantConfig, act_cls=None,
                 weight_cls=None):
        super().__init__()
        self.inner = inner
        self.act_q = (act_cls or config.activation)()
        self.w_bits = 8
        self.channel_axis = _channel_axis_for(inner)

    def forward(self, x):
        x = self.act_q(x)
        w = self.inner.weight
        wq = fake_quantize_abs_max(
            w, self.w_bits,
            channel_axis=self.channel_axis if w.dim() > 1 else None)
        return torch.func.functional_call(self.inner, {"weight": wq}, (x,))


def _swap_layers(model, config: QuantConfig):
    for name, sub in list(model._modules.items()):
        if sub is None:
            continue
        if isinstance(sub, config._types):
            if id(sub) in config._layer_overrides:
                act, w = config._layer_overrides[id(sub)]
                if act is None and w is None:
                    continue  # explicitly exempted layer
                model._modules[name] = _QuantedLayer(sub, config,
                                                     act_cls=act,
                                                     weight_cls=w)
            else:
                model._modules[name] = _QuantedLayer(sub, config)
        else:
            _swap_layers(sub, config)
    return model


class QAT:
    """Quantization-aware training (ref: quantization/qat.py QAT.quantize)."""

    def __init__(self, config: QuantConfig | None = None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace=True):
        return _swap_layers(model, self.config)

    @torch.no_grad()
    def convert(self, model, inplace=True):
        """Strip quant wrappers, bake final weight quantization."""
        for name, sub in list(model._modules.items()):
            if isinstance(sub, _QuantedLayer):
                inner = sub.inner
                inner.weight.copy_(fake_quantize_abs_max(
                    inner.weight, sub.w_bits,
                    channel_axis=sub.channel_axis))
                model._modules[name] = inner
            elif sub is not None:
                self.convert(sub)
        return model


class PTQ:
    """Post-training quantization: observe activations on calibration data,
    then bake scales (ref: fluid/contrib/slim ImperativePTQ)."""

    def __init__(self, config: QuantConfig | None = None):
        self.config = config or QuantConfig()
        self._observed = {}

    def quantize(self, model, inplace=True):
        return _swap_layers(model, self.config)

    def convert(self, model, inplace=True):
        return QAT(self.config).convert(model)


class BaseQuanter(nn.Module, metaclass=_abc.ABCMeta):
    """Base for custom quanters plugged into QuantConfig (ref
    quantization/base_quanter.py:25)."""

    @_abc.abstractmethod
    def forward(self, input):
        ...

    @_abc.abstractmethod
    def scales(self):
        ...

    @_abc.abstractmethod
    def zero_points(self):
        ...

    @_abc.abstractmethod
    def quant_axis(self):
        ...

    @_abc.abstractmethod
    def bit_length(self):
        ...


class BaseObserver(BaseQuanter, metaclass=_abc.ABCMeta):
    """Calibration observer: a quanter that additionally computes
    thresholds from observed batches (ref base_observer.py:21)."""

    @_abc.abstractmethod
    def cal_thresholds(self):
        ...
