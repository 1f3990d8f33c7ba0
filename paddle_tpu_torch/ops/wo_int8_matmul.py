"""Weight-only int8 matrix product, W8A16 (kernel Q1, the port's own):
the CUDA kernel's wrapper, its plain PyTorch version, and its launch
counter.

It stands in for `paddle_tpu/quantization/int8.py:88 matmul_wo_int8`,
which the JAX package leaves to XLA: x (M, K) times an int8 (K, N)
matrix in the JAX `[in, out]` layout, products accumulated in fp32, the
per-output-channel fp32 scale applied to the fp32 result, the result in
x's dtype.  XLA fuses the int8 convert into the dot's operand read, so
device memory sees int8 bytes; eager PyTorch would write the dequantised
matrix back first, so the port has a kernel of its own
(`csrc/wo_int8_matmul.cu`).  On a CUDA tensor `wo_int8_matmul` launches
it (built at first use, see `_build.py`) or raises, and adds one to
`LAUNCHES["wo_int8_matmul"]`; on a CPU tensor it runs
`matmul_wo_int8_plain`.

Bound: the larger of the bytes (W int8, the scales, x read and y
written once, at 3.35 TB/s on an H100 SXM) and the products (2 M K N at
989 TFLOP/s in bf16, 67 TFLOP/s for fp32 on the CUDA cores); at the
serving row counts (M = 8 a decode step, 8 x W a verify, 128 a prefill
chunk) the bytes of W bound it.

The split over K (`split_k`) depends on (M, K, N, dtype) only, so a
CUDA-graph replay runs exactly what the eager call ran, and the split
partials are summed in a fixed order by a second kernel: the result is
bitwise the same run to run.  The workspace is allocated here with
`torch.empty` on the current stream, so under CUDA-graph capture it
comes from the graph's own memory pool.

Tolerances (kernel vs plain, on the card; both accumulate in fp32 in
different orders): bf16, per element |err| <= 2^-7 |plain| + 2^-16 x
the row's max |plain| (one bf16 rounding step); fp32, per element
|err| <= 1e-5 x the row's max |plain|.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["wo_int8_matmul", "matmul_wo_int8_plain", "split_k",
           "LAUNCHES", "TOL_TEXT"]

# launches of the kernel on CUDA tensors; CPU calls count nothing
LAUNCHES = {"wo_int8_matmul": 0}
TOL_TEXT = {"bfloat16": "per element |err| <= 2^-7 |plain| + 2^-16 x "
                        "the row's max |plain|",
            "float32": "per element |err| <= 1e-5 x the row's max |plain|"}

_BN, _BK = 128, 64         # the kernels' column tile and K rows a stage
_F32_ROWS = 8              # rows a block of the fp32 kernel
_SMS = 132                 # an H100 SXM's streaming multiprocessors
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"wo_int8_matmul": (
    _P, _P, _P, _P, _P,            # x w scale y work
    _I, _I, _I, _I, _I,            # M K N splits tiles_per_split
    _I, _I, _P)}                   # x dtype, device, stream


def matmul_wo_int8_plain(x, wq, scale):
    """The plain PyTorch version: x (..., K) float, wq (K, N) int8, scale
    (N,) fp32 -> (..., N) in x's dtype."""
    return ((x.float() @ wq.float()) * scale).to(x.dtype)


def _row_tile(M, dtype):
    if dtype == torch.float32:
        return _F32_ROWS
    return 16 if M <= 16 else 32 if M <= 32 else 64


def split_k(M, K, N, dtype=torch.bfloat16):
    """(splits, K tiles a split) for an (M, K) x (K, N) product: enough
    splits over K that the grid puts about two blocks on each of the
    H100's 132 SMs, every split at least one 64-row tile.  A function of
    the shapes alone: graph replays and eager calls split alike."""
    tiles = -(-N // _BN) * -(-M // _row_tile(M, dtype))
    kt = -(-K // _BK)
    want = min(kt, max(1, -(-2 * _SMS // tiles)))
    per = -(-kt // want)
    return -(-kt // per), per


def _check(x, wq, scale):
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be (M, K) float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    M, K = x.shape
    if wq.dim() != 2 or wq.dtype != torch.int8 or wq.shape[0] != K:
        raise ValueError(f"wq must be ({K}, N) int8, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    N = wq.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,):
        raise ValueError(f"scale must be ({N},) float32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if x.dtype == torch.bfloat16 and (K % 16 or N % 16):
        raise ValueError(f"bf16 x needs K and N multiples of 16, got K {K}, "
                         f"N {N}")
    for t in (x, wq, scale):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("inputs must start 16-byte aligned (the "
                             "kernel copies 16-byte chunks)")


def wo_int8_matmul(x, wq, scale):
    """x (M, K) @ int8 wq (K, N), per-column `scale`, in x's dtype.  A
    CUDA `x` launches Q1 (counted once in `LAUNCHES`, the merge kernel
    included); a CPU `x` runs the plain version."""
    if x.device.type == "cpu":
        return matmul_wo_int8_plain(x, wq, scale)
    if x.device.type != "cuda":
        raise ValueError(f"wo_int8_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    _check(x, wq, scale)
    M, K = x.shape
    N = wq.shape[1]
    splits, per = split_k(M, K, N, x.dtype)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    work = (torch.empty(splits * M * N, dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    lib = _build.load("wo_int8_matmul", _SIGNATURES)
    dev = x.device.index
    err = lib.wo_int8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if work is None else work.data_ptr(), M, K, N, splits, per,
        _DTYPE_CODE[x.dtype], dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"wo_int8_matmul kernel launch failed "
                           f"(cudaError {err})")
    LAUNCHES["wo_int8_matmul"] += 1
    return y
