"""Functions the encoder models call — the port of the parts of
`paddle_tpu/nn/functional/__init__.py` (`dropout`, `layer_norm`,
`cross_entropy`, `conv2d`) and `paddle_tpu/ops/activation.py` (`gelu`)
that ERNIE and the quantization layers run.  Plain PyTorch: the JAX
package computes them in XLA, not in Pallas.

`layer_norm`, `cross_entropy` and `conv2d` carry the JAX op names
"layer_norm_op", "cross_entropy_op" and "conv2d_op" for the O1 policy
of `paddle_tpu_torch.amp` (`autocast_args`); `dropout` and `gelu` are on
neither list and run in their input's dtype.

Randomness is explicit: `dropout` draws its mask from the
`torch.Generator` it is given (on the tensor's device), never from a
global state, so the same generator state gives the same mask."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp import autocast_args

__all__ = ["dropout", "layer_norm", "gelu", "cross_entropy", "conv2d"]


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
    x, weight, bias = autocast_args("layer_norm_op", x, weight, bias)
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
    input, label = autocast_args("cross_entropy_op", input, label)
    logp = torch.log_softmax(input, dim=-1)
    lbl = label.squeeze(-1) if label.dim() == input.dim() else label
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0).to(torch.int64)
    loss = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_padding(padding, spatial, kernel, stride, dilation):
    """A paddle padding spec as (low, high) pairs per spatial dim, as the
    JAX package resolves it: "SAME" pads (out - 1) * stride + the
    dilated kernel - size in all, the odd one at the high end; "VALID"
    nothing; an int or one int a dim symmetric; 2 n ints (low, high) a
    dim; pairs a dim (the last n of an NCHW-style list)."""
    n = len(kernel)
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            pairs = []
            for i in range(n):
                eff_k = (kernel[i] - 1) * dilation[i] + 1
                out = -(-spatial[i] // stride[i])
                total = max(0, (out - 1) * stride[i] + eff_k - spatial[i])
                pairs.append((total // 2, total - total // 2))
            return pairs
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        raise ValueError(padding)
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding[-n:]]
    raise ValueError(f"bad padding {padding}")


def _pad_nchw(x, pairs):
    """x (N, C, H, W) padded with zeros by ((top, bottom), (left,
    right)): asymmetric pads, which `torch.nn.functional.conv2d` does
    not take."""
    (t, b), (lo, hi) = pairs
    if t == b == lo == hi == 0:
        return x
    return F.pad(x, (lo, hi, t, b))


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution with the JAX package's layout and padding: weight
    `[out, in / groups, kh, kw]`, x NCHW or NHWC, `padding` as
    `_conv_padding` resolves it (asymmetric "SAME" pads exact), `bias`
    added per output channel.  Plain `torch.nn.functional.conv2d` (the
    JAX package's convolution is XLA, not Pallas).  On the card an fp32
    convolution goes through cuDNN, which rounds its inputs to TF32
    unless `torch.backends.cudnn.allow_tf32` is False (PyTorch's
    default is True): with it off the product is fp32 throughout, as
    the JAX convolution computes it on the CPU."""
    x, weight, bias = autocast_args("conv2d_op", x, weight, bias)
    stride, dilation = _pair(stride), _pair(dilation)
    nhwc = data_format == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    pairs = _conv_padding(padding, tuple(x.shape[2:4]),
                          tuple(weight.shape[2:4]), stride, dilation)
    out = F.conv2d(_pad_nchw(x, pairs), weight, bias, stride, 0, dilation,
                   groups)
    return out.permute(0, 2, 3, 1) if nhwc else out
