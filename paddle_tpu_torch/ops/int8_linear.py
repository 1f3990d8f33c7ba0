"""Kernel Q2, the W8A8 linear: its wrapper, its plain PyTorch version, its
launch counter, and the operator `paddle_tpu_torch::int8_linear`.

What it computes is `paddle_tpu/quantization/int8.py:99`
`_int8_linear_raw` (XLA in the JAX package, no Pallas kernel):

    y = (clip(round(x / x_scale), -127, 127) @ wq) * (x_scale * w_scale)
        + bias

for x (..., K) fp32, bf16 or fp16, wq int8 `[K, N]` (`[in, out]`, the
JAX layout), w_scale fp32 (N,), bias fp32 (N,) or None, x_scale a
Python float; y (..., N) in x's dtype.  x / x_scale is an fp32 division
by fp32(x_scale), round is half to even (`torch.round`, `jnp.round`),
the int8 products are summed exactly in int32, and x_scale * w_scale is
one fp32 product, as JAX's weak-typed Python float meets an fp32 array.

On a CUDA tensor `int8_linear` launches `csrc/int8_linear.cu` (built at
first use, `_build.py`; the kernel note there) and adds one to
`LAUNCHES["int8_linear"]`, or raises; on a CPU tensor it runs the plain
version (`int8_linear_plain`) and counts nothing.  The kernel reads the
weight as `wt`, an (N, Kp) int8 copy of wq^T, K contiguous, zero-padded
to Kp (a multiple of 64): `pack_weight(wq)` builds it, and the layer
that owns wq keeps it as a buffer (`quantization.int8.Int8Linear`).

The plain version sums the integer products exactly: in int32 on the
CPU, and on the card (where PyTorch has no int32 matmul) in float64,
exact here (|acc| <= 127^2 K is far below 2^53).  The kernel equals it
bit for bit: the same fp32 division, rounding, int -> fp32 conversion,
scale product and bias add, each rounded on its own.

The operator `paddle_tpu_torch::int8_linear(x, wq, w_scale, bias,
x_scale, wt)` is registered through `torch.library`'s low-level API,
as K1's `flash_fwd` is: its CUDA kernel is the launch above, its CPU
kernel the plain version, a fake kernel gives the shape, so that a
`jit.save`d int8 program holds one node a quantized layer.  It takes no
gradient (the JAX op is `defop_nondiff`).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["int8_linear", "int8_linear_plain", "pack_weight", "LAUNCHES",
           "K_TILE"]

LAUNCHES = {"int8_linear": 0}
_COUNT_LOCK = threading.Lock()
K_TILE = 64                      # the kernel's K step: wt's Kp is a multiple
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"int8_linear": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                               _P)}


def pack_weight(wq):
    """wq int8 `[K, N]` -> wt int8 (N, Kp): wq^T with K contiguous, zero
    columns up to Kp = K rounded up to `K_TILE`."""
    K, N = wq.shape
    kp = -(-K // K_TILE) * K_TILE
    wt = torch.zeros(N, kp, dtype=torch.int8, device=wq.device)
    wt[:, :K] = wq.t()
    return wt


def _scales(w_scale, x_scale):
    """x_scale * w_scale as one fp32 product (the JAX weak-typed
    Python float meets the fp32 array in fp32)."""
    return w_scale.to(torch.float32) * torch.tensor(
        x_scale, dtype=torch.float32, device=w_scale.device)


def int8_linear_plain(x, wq, w_scale, bias, x_scale):
    """Q2 in plain PyTorch (module docstring): y (..., N) in x's
    dtype."""
    K, N = wq.shape
    lead = x.shape[:-1]
    xs = torch.tensor(x_scale, dtype=torch.float32, device=x.device)
    xq = torch.clamp(torch.round(x.reshape(-1, K).to(torch.float32) / xs),
                     -127, 127)
    if x.device.type == "cpu":
        acc = (xq.to(torch.int32) @ wq.to(torch.int32)).to(torch.float32)
    else:
        acc = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)
    y = acc * _scales(w_scale, x_scale)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype).reshape(*lead, N)


def _check(x, wt, w_scale, bias):
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_linear: x must be fp32, bf16 or fp16, got "
                         f"{x.dtype}")
    N, kp = wt.shape
    K = x.shape[-1]
    if wt.dtype != torch.int8 or kp % K_TILE or kp < K \
            or not wt.is_contiguous() or wt.data_ptr() % 16:
        raise ValueError("int8_linear: wt must be pack_weight(wq): a "
                         "contiguous, 16-byte aligned int8 (N, Kp) tensor "
                         f"with Kp >= K and a multiple of {K_TILE}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (N,)
                              or not t.is_contiguous()):
            raise ValueError(f"int8_linear: {name} must be a contiguous "
                             f"fp32 ({N},) tensor")
    for t in (wt, w_scale, bias):
        if t is not None and t.device != x.device:
            raise ValueError("int8_linear: every input must be on x's "
                             "device")


def _launch(x, wt, w_scale, bias, x_scale):
    """Launch Q2 on CUDA tensors; returns y (..., N)."""
    _check(x, wt, w_scale, bias)
    N = wt.shape[0]
    K = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    lib = _build.load("int8_linear", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.int8_linear(
            x2.data_ptr(), wt.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), M, N,
            K, wt.shape[1], float(x_scale), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_linear kernel launch failed (cudaError "
                           f"{err})")
    with _COUNT_LOCK:
        LAUNCHES["int8_linear"] += 1
    return y.reshape(*lead, N)


_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("int8_linear(Tensor x, Tensor wq, Tensor w_scale, Tensor? bias, "
            "float x_scale, Tensor wt) -> Tensor")


def _op_cpu(x, wq, w_scale, bias, x_scale, wt):
    return int8_linear_plain(x, wq, w_scale, bias, x_scale)


def _op_cuda(x, wq, w_scale, bias, x_scale, wt):
    return _launch(x, wt, w_scale, bias, x_scale)


def _op_fake(x, wq, w_scale, bias, x_scale, wt):
    return x.new_empty((*x.shape[:-1], wq.shape[1]))


_LIB.impl("int8_linear", _op_cpu, "CPU")
_LIB.impl("int8_linear", _op_cuda, "CUDA")
torch.library.register_fake("paddle_tpu_torch::int8_linear", _op_fake,
                            lib=_LIB)
_INT8_LINEAR_OP = torch.ops.paddle_tpu_torch.int8_linear.default


def int8_linear(x, wq, w_scale, bias, x_scale, wt=None):
    """Q2 through the operator: a CUDA x launches the kernel on `wt`
    (`pack_weight(wq)`, built here when not given), counted in
    `LAUNCHES`; a CPU x runs the plain version."""
    if wt is None:
        wt = pack_weight(wq) if x.device.type == "cuda" else wq.new_empty(
            (0, K_TILE))
    return _INT8_LINEAR_OP(x, wq, w_scale, bias, float(x_scale), wt)
