"""Int8 serving arithmetic — the port of `quantize_weight`,
`weight_only_int8`, `matmul_wo_int8`, `quantize_kv_rows` and
`dequantize_kv` from `paddle_tpu/quantization/int8.py`.

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
"""

from __future__ import annotations

import torch

from ..ops.wo_int8_matmul import wo_int8_matmul, wo_int8_matmul_many

__all__ = ["quantize_weight", "weight_only_int8", "matmul_wo_int8",
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
