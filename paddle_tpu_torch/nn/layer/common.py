"""Common layers — the port of `paddle_tpu/nn/layer/common.py`'s
`Linear`, `Embedding` and `Dropout`, with the JAX layers' parameter
names (`weight`, `bias`) and layout: a Linear weight is `[in, out]` and
the layer computes `x @ W + b`, so weights cross between the packages
by name and value without a transpose.

Weights are drawn from Normal(0, std) with an explicit generator on the
layer's device (the models pass `initializer_range`); biases start at
0.  `Dropout` keeps a reference to the generator its model owns and
draws its masks from it.

`Linear` is the JAX op "linear_op" for the O1 policy of
`paddle_tpu_torch.amp`: under O1 x, weight and bias enter in the amp
dtype and `x @ W + b` runs there, as the one JAX op does."""

from __future__ import annotations

import torch
from torch import nn

from ...amp import autocast_args
from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout", "normal_parameter"]


def normal_parameter(shape, std, device, dtype, generator):
    """A parameter of `shape` drawn from Normal(0, std) on `device`."""
    w = torch.empty(shape, dtype=dtype, device=device)
    return nn.Parameter(w.normal_(0.0, std, generator=generator))


class Linear(nn.Module):
    """`y = x @ W + b` with W `[in_features, out_features]`; no bias with
    `bias=False`."""

    def __init__(self, in_features, out_features, bias=True, *, std=0.02,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = normal_parameter((in_features, out_features), std,
                                       device, dtype, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x):
        x, w, b = autocast_args("linear_op", x, self.weight, self.bias)
        y = x @ w
        return y if b is None else y + b


class Embedding(nn.Module):
    """A lookup table `[num_embeddings, embedding_dim]`."""

    def __init__(self, num_embeddings, embedding_dim, *, std=0.02,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.weight = normal_parameter((num_embeddings, embedding_dim), std,
                                       device, dtype, generator)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class Dropout(nn.Module):
    """`functional.dropout` in training mode (`self.training`), drawing
    from `generator`."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)

    def extra_repr(self):
        return f"p={self.p}"
