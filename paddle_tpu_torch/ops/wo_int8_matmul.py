"""Weight-only int8 matrix product, W8A16 (kernel Q1, the port's own):
the CUDA kernel's wrapper, its plain PyTorch version, the packed weight
layout it reads, and its launch counter.

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
chunk) the bytes of W bound it, at the whole-bucket prefill (M 2048)
the products.

bf16 x: `wgmma` with the weight as the register operand (y^T = W^T
x^T), one launch a product, or one for the products that share x
(`wo_int8_matmul_many`: q / k / v); the source note in the .cu says how
it meets each bound.  The weight is read in fragment order:
`pack_weight` turns the `[in, out]` int8 matrix (K % 64 == 0) into
(ceil(N / 64), K / 32, 128, 16), where [T, c, j] holds the 16 bytes
thread j of a warpgroup converts into its A fragments for channels
64 T .. 64 T + 63 and k 32 c .. 32 c + 31.  It is an exact permutation
(channels past N zero when N % 64 != 0); `unpack_weight` is its
inverse.  `collect_decode_state` packs the weights of a bf16 state on
the card once; the plain version takes either layout (it unpacks), so
a reference path computes from the same bytes.  fp32 x (the debug
models): a CUDA-core kernel on the `[in, out]` layout, its split
partials merged by a second kernel.

The split over K (`split_k`) depends on (M, K, N, dtype) only, so a
CUDA-graph replay runs exactly what the eager call ran, and the split
partials are summed in a fixed order (inside the launch for bf16: the
last block of a tile, picked by a per-tile arrival counter): the result
is bitwise the same run to run.  The partials are allocated here with
`torch.empty` on the current stream, so under CUDA-graph capture they
come from the graph's own memory pool.  The arrival counters are one
zeroed int32 buffer a device (`_arrivals`), allocated at the first call
(outside capture) and left zeroed by every launch; calls on one device
run one at a time on it, as every launch of the port does (the current
stream).

Tolerances (kernel vs plain, on the card; both accumulate in fp32 in
different orders): bf16, per element |err| <= 2^-7 |plain| + 2^-16 x
the row's max |plain| (one bf16 rounding step); fp32, per element
|err| <= 1e-5 x the row's max |plain|.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["wo_int8_matmul", "wo_int8_matmul_many", "matmul_wo_int8_plain",
           "matmul_wo_int8_many_plain", "split_k", "pack_weight",
           "unpack_weight", "is_packed", "LAUNCHES", "TOL_TEXT"]

# launches of the kernel on CUDA tensors; CPU calls count nothing
LAUNCHES = {"wo_int8_matmul": 0}
TOL_TEXT = {"bfloat16": "per element |err| <= 2^-7 |plain| + 2^-16 x "
                        "the row's max |plain|",
            "float32": "per element |err| <= 1e-5 x the row's max |plain|"}

_SMS = 132                 # an H100 SXM's streaming multiprocessors
_BN = 128                  # output channels a block (both kernels)
_MAX_ROWS = 256            # x rows a bf16 block: wgmma's widest N
_F32_ROWS, _F32_K = 8, 64  # the fp32 kernel's rows a block, K a stage
_ARRIVAL_SLOTS = 1024      # per-tile counters a device (split tiles < 132)
_ARRIVALS: dict = {}       # device index -> zeroed int32 counters
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_MAX_SEGS = 3              # products of one x a launch (q / k / v)
_SIGNATURES = {"wo_int8_matmul": (
    _P, _I,                        # x, products
    *(_P, _P, _P, _I) * _MAX_SEGS,  # w scale y N of each
    _P, _P,                        # work arrivals
    _I, _I, _I, _I,                # M K splits tiles_per_split
    _I, _I, _P)}                   # x dtype, device, stream

# [in, out] index k = 32 c + 16 h + 8 p + 2 t + o, n = 64 T + 16 w + 8 r
# + g, as the dims (c, h, p, t, o, T, w, r, g); packed [T, c, j, b] with
# thread j = (w, g, t) (lane 4 g + t of warp w) and byte b = (h, p, o, r):
# word 2 h + p of thread j converts to its A registers (a[2p], a[2p + 1])
# of k16 step h, bytes (0, 2) -> rows g (k 2 t, 2 t + 1), (1, 3) -> g + 8
_PACK = (5, 0, 6, 8, 3, 1, 2, 4, 7)
_UNPACK = tuple(_PACK.index(i) for i in range(9))


def pack_weight(wq):
    """`[in, out]` int8 (K, N), K a multiple of 64 -> the kernel's
    fragment order (ceil(N / 64), K / 32, 128, 16): an exact permutation
    of the bytes, the channels past N (when N % 64 != 0) zero.
    `unpack_weight(wp, N)` inverts it."""
    if wq.dim() != 2 or wq.dtype != torch.int8:
        raise ValueError(f"pack_weight takes an (in, out) int8 matrix, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    K, N = wq.shape
    if K % 64:
        raise ValueError(f"pack_weight needs in a multiple of 64, got {K}")
    T = -(-N // 64)
    if N % 64:
        wq = torch.nn.functional.pad(wq, (0, 64 * T - N))
    return (wq.reshape(K // 32, 2, 2, 4, 2, T, 4, 2, 8)
            .permute(_PACK).contiguous().reshape(T, K // 32, 128, 16))


def unpack_weight(wp, n):
    """The packed (ceil(n / 64), K / 32, 128, 16) weight back to
    `[in, out]` (K, n), bitwise."""
    T, C = wp.shape[:2]
    return (wp.reshape(T, C, 4, 8, 4, 2, 2, 2, 2).permute(_UNPACK)
            .reshape(32 * C, 64 * T)[:, :n].contiguous())


def is_packed(wq):
    """True for a weight in the kernel's fragment order."""
    return wq.dim() == 4


def matmul_wo_int8_plain(x, wq, scale):
    """The plain PyTorch version: x (..., K) float, wq (K, N) int8 or
    packed, scale (N,) fp32 -> (..., N) in x's dtype."""
    if is_packed(wq):
        wq = unpack_weight(wq, scale.shape[0])
    return ((x.float() @ wq.float()) * scale).to(x.dtype)


def matmul_wo_int8_many_plain(x, pairs):
    """`matmul_wo_int8_plain` of x with each (wq, scale) of `pairs`."""
    return [matmul_wo_int8_plain(x, wq, scale) for wq, scale in pairs]


def _rows(M):
    """x rows a bf16 block: M rounded up to 8, 16, 32, 64, 128, else 256."""
    return next((r for r in (8, 16, 32, 64, 128) if M <= r), _MAX_ROWS)


def _stage_k(M, dtype):
    """K rows a stage of the kernel (the unit of a split)."""
    if dtype == torch.float32:
        return _F32_K
    return 128 if _rows(M) <= 128 else 64


def split_k(M, K, N, dtype=torch.bfloat16):
    """(splits, K stages a split) for an (M, K) x (K, N) product, or for
    one launch of the products of one x whose widths N lists (their
    128-channel tiles side by side).  A grid with at least one output
    tile a streaming multiprocessor of the H100 (132) is not split;
    otherwise K is split so that the grid holds at most one block an SM,
    every split at least one stage.  A function of the shapes alone:
    graph replays and eager calls split alike."""
    widths = [N] if isinstance(N, int) else list(N)
    rows = _F32_ROWS if dtype == torch.float32 else _rows(M)
    tiles = sum(-(-n // _BN) for n in widths) * -(-M // rows)
    kt = -(-K // _stage_k(M, dtype))
    if dtype == torch.float32:     # the CUDA-core kernel: two blocks an SM
        want = min(kt, max(1, -(-2 * _SMS // tiles)))
    else:
        want = min(kt, max(1, _SMS // tiles))
    per = -(-kt // want)
    return -(-kt // per), per


def _arrivals(device):
    """The device's zeroed per-tile arrival counters (made at its first
    call; every launch leaves them zeroed)."""
    buf = _ARRIVALS.get(device.index)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("wo_int8_matmul: the first call on a device "
                               "must run outside CUDA-graph capture (it "
                               "allocates the arrival counters)")
        buf = torch.zeros(_ARRIVAL_SLOTS, dtype=torch.int32, device=device)
        _ARRIVALS[device.index] = buf
    return buf


def _check(x, wq, scale):
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be (M, K) float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    M, K = x.shape
    if scale.dtype != torch.float32 or scale.dim() != 1:
        raise ValueError(f"scale must be (N,) float32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    N = scale.shape[0]
    if x.dtype == torch.bfloat16:
        want = (-(-N // 64), K // 32, 128, 16)
        if K % 64 or wq.dtype != torch.int8 or tuple(wq.shape) != want:
            raise ValueError(f"bf16 x ({M}, {K}) needs K a multiple of 64 "
                             f"and the packed weight {want} int8 of "
                             f"pack_weight, got {tuple(wq.shape)} "
                             f"{wq.dtype}")
    elif wq.dtype != torch.int8 or tuple(wq.shape) != (K, N):
        raise ValueError(f"fp32 x needs wq ({K}, {N}) int8, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
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
    """x (M, K) @ int8 wq, per-column `scale`, in x's dtype.  A CUDA `x`
    launches Q1 (counted once in `LAUNCHES`): bf16 takes the packed
    weight, fp32 the `[in, out]` one.  A CPU `x` runs the plain version
    (either layout)."""
    return wo_int8_matmul_many(x, [(wq, scale)])[0]


def wo_int8_matmul_many(x, pairs):
    """x (M, K) @ each int8 (wq, scale) of `pairs` (the products that
    share x: q / k / v), a list in x's dtype.  bf16 on the card: one
    launch for up to three products (their tiles side by side in one
    grid, split over K as one product of their summed width); fp32: one
    launch each.  A CPU `x` runs the plain version of each."""
    if x.device.type == "cpu":
        return matmul_wo_int8_many_plain(x, pairs)
    if x.device.type != "cuda":
        raise ValueError(f"wo_int8_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    pairs = list(pairs)
    if x.dtype == torch.float32 and len(pairs) > 1:
        return [wo_int8_matmul(x, wq, scale) for wq, scale in pairs]
    if not 1 <= len(pairs) <= _MAX_SEGS:
        raise ValueError(f"wo_int8_matmul_many takes 1 to {_MAX_SEGS} "
                         f"products, got {len(pairs)}")
    for wq, scale in pairs:
        _check(x, wq, scale)
    M, K = x.shape
    ns = [scale.shape[0] for _, scale in pairs]
    splits, per = split_k(M, K, ns, x.dtype)
    if x.dtype == torch.bfloat16:
        rows = _rows(M)
        part = -(-M // rows) * sum(-(-n // _BN) for n in ns) * _BN * rows
    else:
        part = M * ns[0]
    ys = [torch.empty((M, n), dtype=x.dtype, device=x.device) for n in ns]
    work = (torch.empty(splits * part, dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    arrivals = _arrivals(x.device)
    lib = _build.load("wo_int8_matmul", _SIGNATURES)
    dev = x.device.index
    segs = []
    for i in range(_MAX_SEGS):
        if i < len(pairs):
            (wq, scale), y = pairs[i], ys[i]
            segs += [wq.data_ptr(), scale.data_ptr(), y.data_ptr(), ns[i]]
        else:
            segs += [None, None, None, 0]
    err = lib.wo_int8_matmul(
        x.data_ptr(), len(pairs), *segs,
        None if work is None else work.data_ptr(), arrivals.data_ptr(),
        M, K, splits, per, _DTYPE_CODE[x.dtype], dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"wo_int8_matmul kernel launch failed "
                           f"(cudaError {err})")
    LAUNCHES["wo_int8_matmul"] += 1
    return ys
