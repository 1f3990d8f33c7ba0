"""Int8 KV-cache rows — the port of `quantize_kv_rows` / `dequantize_kv`
from `paddle_tpu/quantization/int8.py`.

Symmetric per-row-per-head scales over the head_dim axis: one f32
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

__all__ = ["quantize_kv_rows", "dequantize_kv"]


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
