"""`Conv2D` — the port of `paddle_tpu/nn/layer/conv.py`'s `_ConvNd` and
`Conv2D`: weight `[out, in / groups, kh, kw]` (OIHW, the reference's
layout, so state dicts cross by name and value), bias `[out]`, NCHW or
NHWC, the padding as `functional.conv2d` resolves it.

The weight is drawn from Normal(0, sqrt(2 / fan_in)) (MSRA, the JAX
layer's default) from an explicit generator on the layer's device; the
bias starts at 0.  Conv1D, Conv3D and the transposed convolutions are
not ported yet (ROADMAP)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import functional as F
from .common import normal_parameter

__all__ = ["Conv2D"]


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCHW", ndim=2, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        k = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * ndim
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = tuple(k)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        shape = [out_channels, in_channels // groups] + list(k)
        fan_in = (in_channels // groups) * int(np.prod(k))
        self.weight = normal_parameter(shape, (2.0 / fan_in) ** 0.5, device,
                                       dtype, generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels, dtype=dtype,
                                              device=device))
                     if bias_attr is not False else None)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCHW", *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, bias_attr,
                         data_format, ndim=2, device=device, dtype=dtype,
                         generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)
