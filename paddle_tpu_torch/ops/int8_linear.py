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
to Kp (a multiple of 64): `pack_weight(wq)` builds it, `unpack_weight(wt,
K)` gives wq back as a view, and the layer that owns wq keeps `wt` as its
only copy (`quantization.int8.Int8Linear`).

Routes (`plan(M, N, K)`, a function of the shapes only, so graph
replays and eager calls route alike):
  * "wgmma" (M > `SMALL_M`, the default): an elementwise pass quantizes
    x once into `xq`, an (M, Kp) int8 scratch this wrapper allocates,
    then `wgmma` s8 over a TMA ring; the pass is counted in
    `LAUNCHES["int8_linear_quant"]`;
  * "split" (M <= `SMALL_M`): one launch split over K in `splits` slices,
    the int32 partial sums added into a workspace, which the last slice
    of a tile (a semaphore) reads; counted in
    `LAUNCHES["int8_linear_split"]`.  The workspace (M x N int32) and
    the semaphores (one a 128-column tile) are one buffer each call
    takes zeroed from the caching allocator (`torch.zeros` on the current
    stream: calls on other streams never share it, and a captured CUDA
    graph records the zeroing as a memset node);
  * "mma" (`variant="mma"`): the first kernel, `mma.sync` with x
    quantized as it loads, kept as the yardstick; counted in
    `LAUNCHES["int8_linear_mma"]`.
`variant=` takes None (the route by M) or "mma".

The plain version sums the integer products exactly: in int32 on the
CPU, and on the card (where PyTorch has no int32 matmul) in float64,
exact here (|acc| <= 127^2 K is far below 2^53).  The kernel equals it
bit for bit: the same fp32 division, rounding, int -> fp32 conversion,
scale product and bias add, each rounded on its own.

The operator `paddle_tpu_torch::int8_linear(x, wt, w_scale, bias,
x_scale)` is registered through `torch.library`'s low-level API, as
K1's `flash_fwd` is: its CUDA kernel is the launch above on the default
route, its CPU kernel the plain version on `unpack_weight(wt, K)`, a
fake kernel gives the shape, so that a `jit.save`d int8 program holds
one node a quantized layer and one int8 copy of its weight.  It takes
no gradient (the JAX op is `defop_nondiff`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from . import _build

__all__ = ["int8_linear", "int8_linear_plain", "pack_weight",
           "unpack_weight", "plan", "Plan", "LAUNCHES", "K_TILE",
           "SMALL_M", "VARIANTS"]

LAUNCHES = {"int8_linear": 0, "int8_linear_quant": 0,
            "int8_linear_split": 0, "int8_linear_mma": 0}
_COUNT_LOCK = threading.Lock()
K_TILE = 64                      # the kernel's K step: wt's Kp is a multiple
SMALL_M = 64                     # rows up to which the split route runs
VARIANTS = ("mma",)
_ROUTES = {"mma": 0, "wgmma": 1, "split": 2}
_BN = 128                        # column tile of every route
_SMS = 132                       # streaming multiprocessors of an H100
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"int8_linear": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _F, _I, _I, _I, _P)}


class Plan(NamedTuple):
    """How one call runs: the route, its K slices, and the shapes of its
    scratch (None where it has none)."""
    route: str
    splits: int
    xq: Optional[tuple]          # (M, Kp) int8, the wgmma route's x
    workspace: Optional[tuple]   # (M * N,) int32 sums, zeroed
    semaphores: Optional[tuple]  # (ceil(N / 128),) int32, zeroed


def _kp(K):
    return -(-K // K_TILE) * K_TILE


def plan(M, N, K, variant=None):
    """The route of a call at (M, K) -> N (`variant` None: by M), and for
    the split route the number of K slices: enough column tiles x slices
    to give each of the card's SMs a block, each slice whole k-tiles of
    64, the slices as even as whole tiles allow."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"int8_linear: variant must be None or one of "
                         f"{VARIANTS}, got {variant!r}")
    kp = _kp(K)
    if variant == "mma":
        return Plan("mma", 1, None, None, None)
    if M > SMALL_M:
        return Plan("wgmma", 1, (M, kp), None, None)
    kt, tiles = kp // K_TILE, -(-N // _BN)
    per = -(-kt // min(kt, max(1, _SMS // tiles)))
    splits = -(-kt // per)
    if splits == 1:
        return Plan("split", 1, None, None, None)
    return Plan("split", splits, None, (M * N,), (tiles,))


def pack_weight(wq):
    """wq int8 `[K, N]` -> wt int8 (N, Kp): wq^T with K contiguous, zero
    columns up to Kp = K rounded up to `K_TILE`."""
    K, N = wq.shape
    wt = torch.zeros(N, _kp(K), dtype=torch.int8, device=wq.device)
    wt[:, :K] = wq.t()
    return wt


def unpack_weight(wt, K):
    """The `[K, N]` wq that `pack_weight` packed into wt, as a view."""
    return wt[:, :K].t()


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
    if wt.dtype != torch.int8 or kp != _kp(K) \
            or not wt.is_contiguous() or wt.data_ptr() % 16:
        raise ValueError("int8_linear: wt must be pack_weight(wq): a "
                         "contiguous, 16-byte aligned int8 (N, Kp) tensor, "
                         f"Kp = K rounded up to a multiple of {K_TILE}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (N,)
                              or not t.is_contiguous()):
            raise ValueError(f"int8_linear: {name} must be a contiguous "
                             f"fp32 ({N},) tensor")
    for t in (wt, w_scale, bias):
        if t is not None and t.device != x.device:
            raise ValueError("int8_linear: every input must be on x's "
                             "device")


def _launch(x, wt, w_scale, bias, x_scale, variant=None):
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
    p = plan(M, N, K, variant)
    xq = ws = sem = None
    if p.xq is not None:
        xq = torch.empty(p.xq, dtype=torch.int8, device=x.device)
    if p.workspace is not None:
        n_ws = p.workspace[0]
        scratch = torch.zeros(n_ws + p.semaphores[0], dtype=torch.int32,
                              device=x.device)
        ws, sem = scratch[:n_ws], scratch[n_ws:]
    lib = _build.load("int8_linear", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.int8_linear(
            x2.data_ptr(), wt.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            None if xq is None else xq.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if sem is None else sem.data_ptr(), M, N, K, wt.shape[1],
            float(x_scale), _DTYPE_CODES[x.dtype], _ROUTES[p.route],
            p.splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_linear kernel launch failed (cudaError "
                           f"{err})")
    with _COUNT_LOCK:
        LAUNCHES["int8_linear"] += 1
        if p.route == "wgmma":
            LAUNCHES["int8_linear_quant"] += 1
        else:
            LAUNCHES[f"int8_linear_{p.route}"] += 1
    return y.reshape(*lead, N)


_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("int8_linear(Tensor x, Tensor wt, Tensor w_scale, Tensor? bias, "
            "float x_scale) -> Tensor")


def _op_cpu(x, wt, w_scale, bias, x_scale):
    return int8_linear_plain(x, unpack_weight(wt, x.shape[-1]), w_scale,
                             bias, x_scale)


def _op_cuda(x, wt, w_scale, bias, x_scale):
    return _launch(x, wt, w_scale, bias, x_scale)


def _op_fake(x, wt, w_scale, bias, x_scale):
    return x.new_empty((*x.shape[:-1], wt.shape[0]))


_LIB.impl("int8_linear", _op_cpu, "CPU")
_LIB.impl("int8_linear", _op_cuda, "CUDA")
torch.library.register_fake("paddle_tpu_torch::int8_linear", _op_fake,
                            lib=_LIB)
_INT8_LINEAR_OP = torch.ops.paddle_tpu_torch.int8_linear.default


def int8_linear(x, wq, w_scale, bias, x_scale, wt=None, variant=None):
    """Q2: y (..., N) in x's dtype from wq `[K, N]` or its packed form
    `wt` (`pack_weight(wq)`, built here when not given; wq may then be
    None).  Through the operator: a CUDA x launches the kernel on the
    route `plan` picks, counted in `LAUNCHES`; a CPU x runs the plain
    version.  `variant="mma"` runs the first kernel directly, outside
    the operator; on a CPU x it checks the name and runs the plain
    version."""
    if wt is None:
        wt = pack_weight(wq)
    if variant is None:
        return _INT8_LINEAR_OP(x, wt, w_scale, bias, float(x_scale))
    if x.device.type != "cuda":
        plan(x.numel() // max(x.shape[-1], 1), wt.shape[0], x.shape[-1],
             variant)
        return _op_cpu(x, wt, w_scale, bias, float(x_scale))
    return _launch(x, wt, w_scale, bias, x_scale, variant)
