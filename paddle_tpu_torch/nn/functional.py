"""Functions the encoder models call — the port of the parts of
`paddle_tpu/nn/functional/__init__.py` (`dropout`, `layer_norm`,
`cross_entropy`) and `paddle_tpu/ops/activation.py` (`gelu`) that ERNIE
runs.  Plain PyTorch: the JAX package computes them in XLA, not in
Pallas.

Randomness is explicit: `dropout` draws its mask from the
`torch.Generator` it is given (on the tensor's device), never from a
global state, so the same generator state gives the same mask."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dropout", "layer_norm", "gelu", "cross_entropy"]


def dropout(x, p=0.5, training=True, generator=None):
    """Paddle's dropout in its "upscale_in_train" mode: in training each
    element is kept with probability 1 - p, drawn from `generator`, and
    kept elements are divided by 1 - p.  Outside training, or at p 0,
    `x` is returned as it is."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator=: the "
                         "port keeps no global RNG")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `normalized_shape` axes: mean and
    variance (the mean of squared deviations, as `jnp.var`) in fp32, the
    normalised value cast back to x's dtype, then * weight + bias."""
    nd = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    axes = tuple(range(x.dim() - nd, x.dim()))
    x32 = x.to(torch.float32)
    mean = x32.mean(axes, keepdim=True)
    var = (x32 - mean).square().mean(axes, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def gelu(x):
    """Exact (erf) GELU, as `jax.nn.gelu(approximate=False)`."""
    return F.gelu(x)


def cross_entropy(input, label, ignore_index=-100):
    """Softmax cross-entropy against hard labels over the last axis,
    averaged over the rows whose label is not `ignore_index` (at least
    1).  A label with a trailing axis of 1 is squeezed."""
    logp = torch.log_softmax(input, dim=-1)
    lbl = label.squeeze(-1) if label.dim() == input.dim() else label
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0).to(torch.int64)
    loss = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
