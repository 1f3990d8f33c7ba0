"""Int8 serving arithmetic and int8 inference — the port of
`paddle_tpu/quantization/int8.py`: `quantize_weight`,
`weight_only_int8`, `matmul_wo_int8`, `quantize_kv_rows`,
`dequantize_kv`, and the W8A8 layers `Int8Linear` / `Int8Conv2D` with
`quantize_for_inference` (PTQ calibration -> int8 weights -> int8 x
int8 products into int32).

Weights: symmetric per-channel int8 (`quantize_weight`), per output
channel for an `[in, out]` matrix (`weight_only_int8`), computed in
torch on the weight's device with the JAX package's numpy arithmetic,
so the int8 data and fp32 scales equal its bitwise.
`matmul_wo_int8` keeps the JAX semantics (fp32 accumulation, the scale
on the fp32 result, x's dtype out) and runs kernel Q1
(`ops/wo_int8_matmul.py`) on a CUDA tensor, its plain version on a CPU
one; `matmul_wo_int8_many` runs the products that share x (q / k / v)
as one launch.

KV rows: symmetric per-row-per-head scales over the head_dim axis: one f32
scale per written KV row per kv head, stored in a pool-shaped
(n_blocks, block_tokens, n_kv) tensor beside the int8 data pool.  A
row's scale depends only on that row's values, so the engine's
incremental block writes never rescale rows already in a block.

Both functions use the JAX package's expressions: the same fp32
arithmetic, and `torch.round`, like `jnp.round`, rounds half to even.
`dequantize_kv` is also what the CUDA decode kernel computes in-kernel
(`int8 * scale` in fp32, then the working dtype).

W8A8: `Int8Linear` quantizes x with a calibrated per-tensor scale
(x_scale = max(absmax, 1e-12) / 127, a Python float) and multiplies
int8 x int8 into int32 (kernel Q2, `ops/int8_linear.py`: the operator
`paddle_tpu_torch::int8_linear`, one node a layer in a `jit.save`d
program).  `Int8Conv2D` pads the float input (the resolved padding by
`F.pad`, so asymmetric "SAME" pads stay exact), takes its im2col and
runs Q2 a group at a time: Q2 quantizes in its prologue and zero
padding quantizes to 0, so the int32 sums are the JAX int8
convolution's.  A layer holds its int8 weight once, as Q2's
K-contiguous `wt` (a buffer outside the state dict; `wq` is a view of
it).  Its state dict keeps the JAX names `wq` (in the JAX layout),
`w_scale` and `bias` (the JAX layer holds `wq` and `w_scale` as plain
attributes, outside its state dict: its `.pdparams` carries the bias):
`wq` is unpacked when one is saved and packed into `wt` when one is
loaded.  `quantize_for_inference` calibrates
on the model's own device (forward pre-hooks reading `float(x.abs()
.max())`), swaps in place and returns the model in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import functional as F
from ..ops.int8_linear import int8_linear, pack_weight, unpack_weight
from ..ops.wo_int8_matmul import wo_int8_matmul, wo_int8_matmul_many

__all__ = ["quantize_for_inference", "Int8Linear", "Int8Conv2D",
           "quantize_weight", "weight_only_int8", "matmul_wo_int8",
           "matmul_wo_int8_many", "quantize_kv_rows", "dequantize_kv"]


def quantize_weight(w, channel_axis):
    """Symmetric per-channel int8: scale = absmax / 127 over every dim
    but `channel_axis` (fp32, at least 1e-12), data = round(w / scale)
    (half to even, as `np.round`) clipped to +-127.  Returns (int8
    tensor, fp32 scale per channel) on `w`'s device."""
    w = torch.as_tensor(w).to(torch.float32)
    red = tuple(i for i in range(w.dim()) if i != channel_axis)
    scale = torch.clamp_min(w.abs().amax(dim=red) / 127.0, 1e-12)
    bshape = [1] * w.dim()
    bshape[channel_axis] = -1
    wq = torch.clamp(torch.round(w / scale.reshape(bshape)), -127, 127)
    return wq.to(torch.int8), scale


def weight_only_int8(w):
    """Weight-only int8 for the serving matmuls: per-output-channel
    `quantize_weight` of an `[in, out]` matrix -> (int8 data, fp32
    scale (out,))."""
    return quantize_weight(w, channel_axis=1)


def matmul_wo_int8(x, wq, scale):
    """x (..., in) @ int8 [in, out] (or its packed form,
    `ops.wo_int8_matmul.pack_weight`) -> (..., out) in x's dtype,
    products accumulated in fp32 and the per-channel scale applied to
    the fp32 result.  Kernel Q1 on a CUDA tensor; the plain version on a
    CPU one."""
    lead = x.shape[:-1]
    y = wo_int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), wq, scale)
    return y.reshape(*lead, scale.shape[0])


def matmul_wo_int8_many(x, pairs):
    """`matmul_wo_int8` of one x with each (wq, scale) of `pairs` (q / k
    / v): one Q1 launch on a bf16 CUDA tensor; each product exactly as
    `matmul_wo_int8` computes it on a CPU one."""
    lead = x.shape[:-1]
    ys = wo_int8_matmul_many(x.reshape(-1, x.shape[-1]).contiguous(),
                             pairs)
    return [y.reshape(*lead, scale.shape[0])
            for y, (_, scale) in zip(ys, pairs)]


def quantize_kv_rows(x, eps=1e-8):
    """x (..., n_kv, hd) float -> (int8 rows (..., n_kv, hd),
    f32 scales (..., n_kv)) with scale = absmax(hd)/127."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, eps)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(data, scale, dtype):
    """Inverse of `quantize_kv_rows`: data (..., n_kv, hd) int8 with
    scale (..., n_kv) -> `dtype`."""
    return (data.to(torch.float32)
            * scale.to(torch.float32)[..., None]).to(dtype)


def _f32(t):
    return t if t is None or t.dtype == torch.float32 else t.to(torch.float32)


class _Int8Layer(nn.Module):
    """The shared part of `Int8Linear` / `Int8Conv2D`: the int8 weight as
    Q2's packed `wt` (its only copy) and its scales `w_scale` as
    buffers, the original bias parameter, x_scale.  `wq` (the JAX
    layout) is a view of `wt`, and the state dict's `wq` entry is
    unpacked on save and packed into `wt` on load."""

    def __init__(self, weight, channel_axis, bias, x_absmax):
        super().__init__()
        wq, w_scale = quantize_weight(weight.detach(), channel_axis)
        self._wq_shape = tuple(wq.shape)
        self.register_buffer("wt", self._pack(wq), persistent=False)
        self.register_buffer("w_scale", w_scale)
        self.bias = bias
        self.x_scale = float(max(x_absmax, 1e-12)) / 127.0

    @property
    def wq(self):
        return self._unpack(self.wt)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        wq = self.wq.contiguous()
        destination[prefix + "wq"] = wq if keep_vars else wq.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        key = prefix + "wq"
        if key in state_dict:
            wq = state_dict[key]
            if tuple(wq.shape) != self._wq_shape:
                error_msgs.append(f"size mismatch for {key}: copying a "
                                  f"param with shape {tuple(wq.shape)}, "
                                  f"the shape in current model is "
                                  f"{self._wq_shape}.")
            else:
                with torch.no_grad():
                    self.wt.copy_(self._pack(wq.to(self.wt.device)))
            state_dict = {k: v for k, v in state_dict.items() if k != key}
        else:
            missing_keys.append(key)
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)


class Int8Linear(_Int8Layer):
    """Serving replacement for `nn.layer.Linear`: int8 weight + int8
    activation product (Q2).  `x_scale` comes from PTQ calibration
    (absmax / 127)."""

    def __init__(self, linear, x_absmax):
        super().__init__(linear.weight, 1, linear.bias, x_absmax)

    @staticmethod
    def _pack(wq):
        return pack_weight(wq)

    def _unpack(self, wt):
        return unpack_weight(wt, self._wq_shape[0])

    def forward(self, x):
        return int8_linear(x, None, self.w_scale, _f32(self.bias),
                           self.x_scale, self.wt)


class Int8Conv2D(_Int8Layer):
    """Serving replacement for `nn.layer.Conv2D` (NCHW, as the JAX
    layer): im2col of the padded float input, then Q2 per group."""

    def __init__(self, conv, x_absmax):
        self._groups = conv.groups
        super().__init__(conv.weight, 0, conv.bias, x_absmax)
        p = conv.padding
        self._padding = p.upper() if isinstance(p, str) else p
        self._stride = F._pair(conv.stride)
        self._dilation = F._pair(conv.dilation)

    def _pack(self, wq):
        """Per group: wq as `[K, out / groups]` (K = (in / groups) kh kw
        in im2col's order) packed; the groups' rows stacked."""
        og = wq.shape[0] // self._groups
        return torch.cat([pack_weight(wq[g * og:(g + 1) * og]
                                      .reshape(og, -1).t())
                          for g in range(self._groups)])

    def _unpack(self, wt):
        k = self._wq_shape[1] * self._wq_shape[2] * self._wq_shape[3]
        return wt[:, :k].reshape(self._wq_shape)

    def forward(self, x):
        n, c, h, w = x.shape
        kh, kw = self._wq_shape[2:]
        pairs = F._conv_padding(self._padding, (h, w), (kh, kw),
                                self._stride, self._dilation)
        xp = F._pad_nchw(x, pairs)
        ho = (xp.shape[2] - self._dilation[0] * (kh - 1) - 1) \
            // self._stride[0] + 1
        wo = (xp.shape[3] - self._dilation[1] * (kw - 1) - 1) \
            // self._stride[1] + 1
        cols = torch.nn.functional.unfold(xp, (kh, kw),
                                          dilation=self._dilation,
                                          stride=self._stride)
        G = self._groups
        k = cols.shape[1] // G
        cols = cols.reshape(n, G, k, ho * wo).permute(1, 0, 3, 2) \
            .reshape(G, n * ho * wo, k)
        out = self._wq_shape[0]
        og = out // G
        bias = _f32(self.bias)
        ys = [int8_linear(cols[g], None, self.w_scale[g * og:(g + 1) * og],
                          None if bias is None else
                          bias[g * og:(g + 1) * og], self.x_scale,
                          self.wt[g * og:(g + 1) * og])
              for g in range(G)]
        y = ys[0] if G == 1 else torch.cat(ys, -1)
        return y.reshape(n, ho * wo, out).permute(0, 2, 1) \
            .reshape(n, out, ho, wo)


def _model_device(model):
    for t in list(model.parameters()) + list(model.buffers()):
        return t.device
    return torch.device("cpu")


def _collect_absmax(model, calib_batches, targets):
    """Run the calibration batches on the model's own device, recording
    each target layer's input absmax (the mkldnn_quantizer warm-up
    pass)."""
    stats = {id(layer): 0.0 for layer in targets}

    def mk_hook(lid):
        def hook(layer, inputs):
            stats[lid] = max(stats[lid], float(inputs[0].abs().max()))
        return hook

    hooks = [layer.register_forward_pre_hook(mk_hook(id(layer)))
             for layer in targets]
    device = _model_device(model)
    try:
        with torch.no_grad():
            for batch in calib_batches:
                model(torch.as_tensor(batch, device=device))
    finally:
        for h in hooks:
            h.remove()
    return stats


def quantize_for_inference(model, calib_batches=None, layers=None):
    """PTQ: calibrate activation ranges on `calib_batches`, then swap
    every Linear / Conv2D (restrictable with `layers`, a list of those
    classes) for its int8 twin IN PLACE — `model` itself is changed and
    returned, in eval mode.  Without `calib_batches` every absmax is
    8.0 (the JAX package's conservative default)."""
    from ..nn.layer import Conv2D, Linear
    kinds = (Linear, Conv2D) if layers is None else tuple(layers)
    targets = [sub for sub in model.modules()
               if sub is not model and type(sub) in kinds]
    if calib_batches is not None:
        stats = _collect_absmax(model, calib_batches, targets)
    else:
        stats = {id(layer): 8.0 for layer in targets}

    def swap(parent):
        for name, sub in list(parent._modules.items()):
            if type(sub) is Linear and Linear in kinds:
                parent._modules[name] = Int8Linear(sub, stats[id(sub)])
            elif type(sub) is Conv2D and Conv2D in kinds:
                parent._modules[name] = Int8Conv2D(sub, stats[id(sub)])
            elif sub is not None:
                swap(sub)

    swap(model)
    model.eval()
    return model
