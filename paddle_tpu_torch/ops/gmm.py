"""Grouped (ragged) matmul over rows sorted by expert (kernels K5f
forward, K5b weight gradient), the CUDA kernels' wrappers, their plain
PyTorch versions, their launch counters, and the dropless dispatch
around them.

The port of `paddle_tpu/ops/pallas_gmm.py`.  Rows arrive sorted by
expert and padded per expert to a multiple of bm, so every bm-row tile
belongs to one expert, `tile_expert[i]`:

* `gmm_fwd` (K5f): out[t] = lhs[t] @ rhs[tile_expert[t // bm]], fp32
  accumulation, output in lhs's dtype.  `transpose_rhs=True` multiplies
  by rhs[e]^T, read through strides (the input gradient's product);
* `gmm_drhs` (K5b): drhs[e] = sum over e's tiles of lhs_tile^T @
  dout_tile, fp32 accumulation rounded once to lhs's dtype; an expert
  with no tiles gets exactly zero;
* `gmm` — the `torch.autograd.Function` whose forward is K5f and whose
  backward is K5f transposed (dlhs) and K5b (drhs), as `_gmm_bwd_rule`;
* the host-side routing helpers `padded_buffer_size`,
  `sort_slots_by_expert`, `sort_tokens_by_expert` and the dropless FFN
  `dropless_moe_ffn`: plain torch ops that never wait for the device.

On a CUDA tensor `gmm_fwd` / `gmm_drhs` launch `csrc/gmm.cu` (built at
first use, see `_build.py`) or raise, and add one to their entries of
`LAUNCHES`; on a CPU tensor they run `gmm_plain` / `gmm_drhs_plain` and
count nothing.  lhs and rhs must share a dtype (fp32 or bf16 on the
card); the kernel takes any K and N and a bm that is a multiple of 16.
`block_n` is accepted where the JAX package takes it: it picks the
TPU's VMEM tiles and changes no result, and the Hopper kernels tile on
their own.

Tolerances (kernel vs plain, on the card): per row of the output (for
K5b a row is each (e, k, :)), max|err| within tol x that row's max
|plain|, tol 2^-7 in bf16 (both round an fp32 sum, taken in another
order, once: at most one bf16 ulp apart) and 1e-5 in fp32; an absent
expert's drhs exactly 0.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["gmm", "gmm_fwd", "gmm_drhs", "gmm_plain", "gmm_drhs_plain",
           "padded_buffer_size", "sort_slots_by_expert",
           "sort_tokens_by_expert", "dropless_moe_ffn", "DEFAULT_BM",
           "DEFAULT_BN", "LAUNCHES"]

DEFAULT_BM = 128
DEFAULT_BN = 128
# launches of each kernel on CUDA tensors; CPU calls count nothing
LAUNCHES = {"gmm_fwd": 0, "gmm_drhs": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "gmm_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P),
    "gmm_drhs": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def _fit_block(dim, preferred):
    """Largest power-of-two divisor of `dim` that is <= preferred (dim
    itself when none is) — the row tile bm of a buffer of `dim` rows."""
    b = 1
    while b * 2 <= min(preferred, dim) and dim % (b * 2) == 0:
        b *= 2
    if dim % b:
        return dim
    return b


def padded_buffer_size(T, num_experts, block_m):
    """Worst-case per-expert-padded buffer rows — the ONE place that
    knows the formula; gmm's tile count must match it exactly."""
    M = T + num_experts * block_m
    return ((M + block_m - 1) // block_m) * block_m


def sort_slots_by_expert(expert_id, num_experts, block_m, M):
    """Routing bookkeeping only — 1-D integer ops, no row data moved, no
    wait for the device.  Returns (src (M,), tile_expert (M // bm,),
    inv_pos (T,)), int32: src maps a buffer row to its flat index in
    `expert_id` (sentinel T for padding), inv_pos[t] is row t's buffer
    row, and tile_expert[i] the expert of tile i (tiles past the last
    expert's span get expert E-1 and hold zero rows)."""
    T = expert_id.shape[0]
    E = num_experts
    dev = expert_id.device
    eid = expert_id.long()
    # a scatter-add, not bincount: bincount on the card reads the max
    # back to the host
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, eid, torch.ones_like(eid))
    padded = (counts + block_m - 1) // block_m * block_m
    ends = torch.cumsum(padded, 0)
    starts = ends - padded
    order = torch.argsort(eid, stable=True)
    sorted_e = eid[order]
    # rank of each row within its expert
    rank = torch.arange(T, device=dev) - (torch.cumsum(counts, 0)
                                          - counts)[sorted_e]
    pos = starts[sorted_e] + rank
    # rows past M are dropped (the JAX scatter's mode="drop"): they land
    # in one spare row that is sliced off
    src = torch.full((M + 1,), T, dtype=torch.int32, device=dev).scatter_(
        0, pos.clamp(max=M), order.to(torch.int32))[:M]
    inv_pos = torch.zeros(T, dtype=torch.int32, device=dev).scatter_(
        0, order, pos.to(torch.int32))
    tile_starts = torch.arange(M // block_m, device=dev) * block_m
    tile_expert = torch.searchsorted(ends, tile_starts, right=True) \
        .clamp_(max=E - 1).to(torch.int32)
    return src, tile_expert, inv_pos


def sort_tokens_by_expert(x, expert_id, num_experts, block_m=DEFAULT_BM):
    """Static-shape dropless dispatch.  x: (T, H); expert_id: (T,).
    Returns (buf (M, H), tile_expert (M // bm,), inv_pos (T,)) with M =
    padded_buffer_size(T, E, block_m): every expert's rows contiguous,
    zero-padded to a block_m multiple; buf[inv_pos[t]] is x[t]."""
    T = x.shape[0]
    M = padded_buffer_size(T, num_experts, block_m)
    src, tile_expert, inv_pos = sort_slots_by_expert(
        expert_id, num_experts, block_m, M)
    buf = torch.where((src < T)[:, None],
                      x[src.clamp(0, T - 1).long()], 0)
    return buf, tile_expert, inv_pos


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _check(lhs, rhs_or_dout, tile_expert, block_m, what):
    """bm for `lhs`'s M; raises on a tile_expert of the wrong length and
    on mixed dtypes."""
    M = lhs.shape[0]
    bm = _fit_block(M, block_m)
    if tile_expert.shape[0] != M // bm:
        raise ValueError(
            f"{what}: tile_expert has {tile_expert.shape[0]} tiles but "
            f"M={M} with block_m={bm} needs {M // bm} — pad/sort with "
            f"the same block_m (sort_tokens_by_expert) as the gmm call")
    if lhs.dtype != rhs_or_dout.dtype:
        raise ValueError(f"{what}: operands must share a dtype, got "
                         f"{lhs.dtype} and {rhs_or_dout.dtype}")
    return bm


def gmm_plain(lhs, rhs, tile_expert, block_m=DEFAULT_BM,
              transpose_rhs=False):
    """K5f in plain PyTorch: one fp32 product per tile against its
    expert's weights (gathered per tile), rounded once to lhs's dtype."""
    bm = _check(lhs, rhs, tile_expert, block_m, "gmm")
    M, K = lhs.shape
    w = rhs.transpose(1, 2) if transpose_rhs else rhs
    out = torch.bmm(lhs.reshape(M // bm, bm, K).float(),
                    w[tile_expert.long()].float())
    return out.reshape(M, w.shape[2]).to(lhs.dtype)


def gmm_drhs_plain(lhs, dout, tile_expert, num_experts,
                   block_m=DEFAULT_BM):
    """K5b in plain PyTorch: each tile's lhs^T @ dout in fp32, summed
    per expert in tile order, rounded once to lhs's dtype; experts with
    no tiles are zero."""
    bm = _check(lhs, dout, tile_expert, block_m, "gmm drhs")
    M, K = lhs.shape
    N = dout.shape[1]
    per_tile = torch.bmm(lhs.reshape(M // bm, bm, K).transpose(1, 2).float(),
                         dout.reshape(M // bm, bm, N).float())
    drhs = torch.zeros(num_experts, K, N, dtype=torch.float32,
                       device=lhs.device)
    return drhs.index_add_(0, tile_expert.long(), per_tile).to(lhs.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _call(fn, device, *args):
    lib = _build.load("gmm", _SIGNATURES)
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(
            device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed (cudaError {err})")


def _cuda_operands(lhs, other, tile_expert, bm, what):
    """Raises on what the kernels do not take; returns lhs and
    tile_expert as the kernels read them."""
    if lhs.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {lhs.device}")
    if lhs.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: unsupported dtype {lhs.dtype}")
    if other.device != lhs.device or tile_expert.device != lhs.device:
        raise ValueError(f"{what}: operands on different devices")
    if bm % 16:
        raise ValueError(f"{what}: the kernel takes a row tile bm that is "
                         f"a multiple of 16, got {bm}")
    return lhs.contiguous(), tile_expert.to(torch.int32).contiguous()


def gmm_fwd(lhs, rhs, tile_expert, block_m=DEFAULT_BM, transpose_rhs=False):
    """K5f: lhs (M, C) against rhs (E, C, W) — or (E, W, C) read
    transposed — per bm-row tile; (M, W) in lhs's dtype.  CUDA tensors
    launch the Hopper kernel (counted in `LAUNCHES`); CPU tensors run
    `gmm_plain`."""
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, tile_expert, block_m, transpose_rhs)
    bm = _check(lhs, rhs, tile_expert, block_m, "gmm")
    lhs, te = _cuda_operands(lhs, rhs, tile_expert, bm, "gmm")
    M, C = lhs.shape
    E, R, S = rhs.shape
    W = R if transpose_rhs else S
    if (S if transpose_rhs else R) != C:
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)} does not contract "
                         f"with rhs {tuple(rhs.shape)} "
                         f"(transpose_rhs={transpose_rhs})")
    if rhs.stride(2) != 1 or rhs.stride(1) != S:
        rhs = rhs.contiguous()
    out = torch.empty(M, W, dtype=lhs.dtype, device=lhs.device)
    _call("gmm_fwd", lhs.device, lhs.data_ptr(), rhs.data_ptr(),
          te.data_ptr(), out.data_ptr(), M, C, W, bm, rhs.stride(0),
          int(transpose_rhs), _DTYPE_CODE[lhs.dtype])
    LAUNCHES["gmm_fwd"] += 1
    return out


def gmm_drhs(lhs, dout, tile_expert, num_experts, block_m=DEFAULT_BM):
    """K5b: (E, K, N) weight gradient of lhs (M, K) and dout (M, N) in
    lhs's dtype.  CUDA tensors launch the Hopper kernel (counted in
    `LAUNCHES`); CPU tensors run `gmm_drhs_plain`."""
    if lhs.device.type == "cpu":
        return gmm_drhs_plain(lhs, dout, tile_expert, num_experts, block_m)
    bm = _check(lhs, dout, tile_expert, block_m, "gmm drhs")
    lhs, te = _cuda_operands(lhs, dout, tile_expert, bm, "gmm drhs")
    dout = dout.contiguous()
    M, K = lhs.shape
    N = dout.shape[1]
    if dout.shape[0] != M:
        raise ValueError(f"gmm drhs: dout {tuple(dout.shape)} vs lhs "
                         f"{tuple(lhs.shape)}")
    drhs = torch.empty(num_experts, K, N, dtype=lhs.dtype,
                       device=lhs.device)
    _call("gmm_drhs", lhs.device, lhs.data_ptr(), dout.data_ptr(),
          te.data_ptr(), drhs.data_ptr(), M, K, N, bm, num_experts,
          _DTYPE_CODE[lhs.dtype])
    LAUNCHES["gmm_drhs"] += 1
    return drhs


class _Gmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, tile_expert, block_m):
        ctx.save_for_backward(lhs, rhs, tile_expert)
        ctx.block_m = block_m
        return gmm_fwd(lhs, rhs, tile_expert, block_m)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, tile_expert = ctx.saved_tensors
        g = g.contiguous()
        dlhs = drhs = None
        # lhs, rhs and g share one dtype (_check), so both come out in it
        if ctx.needs_input_grad[0]:
            # dlhs[t] = g[t] @ rhs[e]^T — K5f reading rhs transposed
            dlhs = gmm_fwd(g, rhs, tile_expert, ctx.block_m,
                           transpose_rhs=True)
        if ctx.needs_input_grad[1]:
            drhs = gmm_drhs(lhs, g, tile_expert, rhs.shape[0], ctx.block_m)
        return dlhs, drhs, None, None


def gmm(lhs, rhs, tile_expert, block_m=DEFAULT_BM, block_n=DEFAULT_BN):
    """Ragged grouped matmul: out[t] = lhs[t] @ rhs[expert_of(t)] —
    K5f forward, K5f (transposed) and K5b backward on the card, their
    plain versions on the CPU.  `block_n` changes nothing (see the
    module docstring)."""
    return _Gmm.apply(lhs, rhs, tile_expert, block_m)


def dropless_moe_ffn(x, expert_id, w_up, w_down, activation=F.silu,
                     block_m=DEFAULT_BM, block_n=DEFAULT_BN):
    """Dropless expert FFN: every token reaches its expert.  x (T, H);
    expert_id (T,); w_up (E, H, F); w_down (E, F, H).  Returns (T, H)."""
    E = w_up.shape[0]
    buf, tile_expert, inv_pos = sort_tokens_by_expert(
        x, expert_id, E, block_m)
    h = activation(gmm(buf, w_up, tile_expert, block_m, block_n))
    out = gmm(h.to(x.dtype), w_down, tile_expert, block_m, block_n)
    return out[inv_pos.long()]
