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
count nothing.  lhs and rhs must share a dtype.  Which kernel runs is
`_variant(dtype, bm, K, N)`, from the dtype and the row tile alone:

* bf16, bm % 64 == 0 (the MoE path's bm 256) -> "wgmma": Hopper's
  warpgroup MMA fed by TMA through a ring of shared-memory stages;
* fp32, and bf16 with another bm (16, 32, 48, ...: no path of the port
  builds such a buffer, and the 64-row warpgroup tile cannot serve it)
  -> "fma": the CUDA cores, operands widened to fp32.  The fp32 limit of
  1e-5 of a row's max is beyond TF32's ~10 mantissa bits, so fp32 never
  runs on the tensor cores;

every bm a multiple of 16, and in bf16 K and N (the contraction and
output widths) multiples of 8: TMA moves 16-byte chunks.  Anything else
raises `ValueError`.  A caller may name the variant (`variant="fma"`
on bf16 times the CUDA-core kernel against the tensor-core one).  `block_n` is accepted where the JAX
package takes it: it picks the TPU's VMEM tiles and changes no result,
and the Hopper kernels tile on their own.

`live_tiles` (port-only, optional): a device int32 count of the leading
tiles that hold routed rows, `live_tile_count(inv_pos, bm)`.  The tiles
past it are the padding past the last expert's span, whose rows are zero
in every buffer `sort_tokens_by_expert` / `sort_slots_by_expert` build:
K5f writes zeros there without reading them and K5b skips them, which
changes no result on such a buffer.  None means every tile is live.

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
           "padded_buffer_size", "sort_slots_by_expert", "live_tile_count",
           "sort_tokens_by_expert", "dropless_moe_ffn", "DEFAULT_BM",
           "DEFAULT_BN", "LAUNCHES"]

DEFAULT_BM = 128
DEFAULT_BN = 128
# launches of each kernel on CUDA tensors; CPU calls count nothing
LAUNCHES = {"gmm_fwd": 0, "gmm_drhs": 0}

# the C interface's code of each kernel: (dtype, variant) -> code
KERNEL_CODES = {(torch.float32, "fma"): 0, (torch.bfloat16, "fma"): 1,
                (torch.bfloat16, "wgmma"): 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "gmm_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _P),
    "gmm_drhs": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
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


def live_tile_count(inv_pos, block_m):
    """The leading tiles that hold routed rows, as a device int32 scalar
    (no wait for the device): the tile of the last routed row, plus one.
    Every expert's span is a run of whole tiles from row 0, each holding
    a routed row, so the live tiles are a prefix; the rest is padding."""
    return (inv_pos.amax() // block_m + 1).to(torch.int32)


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


def _zero_dead_tiles(per_tile, live_tiles):
    """per_tile (n_tiles, ...) with the tiles at and past live_tiles set
    to zero (unchanged when live_tiles is None)."""
    if live_tiles is None:
        return per_tile
    live = torch.arange(per_tile.shape[0], device=per_tile.device) \
        < live_tiles.to(per_tile.device)
    return torch.where(live[:, None, None], per_tile, 0.0)


def gmm_plain(lhs, rhs, tile_expert, block_m=DEFAULT_BM,
              transpose_rhs=False, live_tiles=None):
    """K5f in plain PyTorch: one fp32 product per tile against its
    expert's weights (gathered per tile), rounded once to lhs's dtype;
    zero on the tiles at and past `live_tiles`."""
    bm = _check(lhs, rhs, tile_expert, block_m, "gmm")
    M, K = lhs.shape
    w = rhs.transpose(1, 2) if transpose_rhs else rhs
    out = _zero_dead_tiles(torch.bmm(lhs.reshape(M // bm, bm, K).float(),
                                     w[tile_expert.long()].float()),
                           live_tiles)
    return out.reshape(M, w.shape[2]).to(lhs.dtype)


def gmm_drhs_plain(lhs, dout, tile_expert, num_experts,
                   block_m=DEFAULT_BM, live_tiles=None):
    """K5b in plain PyTorch: each tile's lhs^T @ dout in fp32, summed
    per expert in tile order, rounded once to lhs's dtype; experts with
    no tiles are zero, and tiles at and past `live_tiles` add nothing."""
    bm = _check(lhs, dout, tile_expert, block_m, "gmm drhs")
    M, K = lhs.shape
    N = dout.shape[1]
    per_tile = _zero_dead_tiles(
        torch.bmm(lhs.reshape(M // bm, bm, K).transpose(1, 2).float(),
                  dout.reshape(M // bm, bm, N).float()), live_tiles)
    drhs = torch.zeros(num_experts, K, N, dtype=torch.float32,
                       device=lhs.device)
    return drhs.index_add_(0, tile_expert.long(), per_tile).to(lhs.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _variant(dtype, bm, K, N, variant=None):
    """The kernel variant a CUDA call runs, from its dtype, row tile bm,
    contraction width K and output width N (see the module docstring),
    or `variant` where the caller names one; raises ValueError on what
    no kernel takes."""
    if bm % 16:
        raise ValueError(f"gmm: the kernels take a row tile bm that is a "
                         f"multiple of 16, got {bm}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gmm: the kernels take float32 or bfloat16, "
                         f"got {dtype}")
    if dtype == torch.bfloat16 and (K % 8 or N % 8):
        raise ValueError(f"gmm: in bfloat16 the kernels take widths that "
                         f"are multiples of 8 (16-byte rows), got {K} and "
                         f"{N}")
    if variant is None:
        variant = "wgmma" if dtype == torch.bfloat16 and bm % 64 == 0 \
            else "fma"
    if (dtype, variant) not in KERNEL_CODES or (variant == "wgmma"
                                                and bm % 64):
        raise ValueError(f"gmm: no {variant} kernel takes {dtype} with "
                         f"bm {bm}")
    return variant


def _call(fn, device, *args):
    lib = _build.load("gmm", _SIGNATURES)
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(
            device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed (cudaError {err})")


def _aligned(t):
    """t contiguous and 16-byte aligned, as TMA reads it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _cuda_operands(lhs, other, tile_expert, live_tiles, what):
    """Raises on operands the kernels cannot read; returns lhs,
    tile_expert and the live-tile pointer as the kernels read them."""
    if lhs.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {lhs.device}")
    if other.device != lhs.device or tile_expert.device != lhs.device or (
            live_tiles is not None and live_tiles.device != lhs.device):
        raise ValueError(f"{what}: operands on different devices")
    live = None
    if live_tiles is not None:
        if live_tiles.numel() != 1:
            raise ValueError(f"{what}: live_tiles is one count, got shape "
                             f"{tuple(live_tiles.shape)}")
        live = live_tiles.reshape(1).to(torch.int32).contiguous()
    return (_aligned(lhs), tile_expert.to(torch.int32).contiguous(), live,
            0 if live is None else live.data_ptr())


def gmm_fwd(lhs, rhs, tile_expert, block_m=DEFAULT_BM, transpose_rhs=False,
            live_tiles=None, variant=None):
    """K5f: lhs (M, C) against rhs (E, C, W) — or (E, W, C) read
    transposed — per bm-row tile; (M, W) in lhs's dtype.  CUDA tensors
    launch the Hopper kernel `_variant` picks, or the named `variant`
    (counted in `LAUNCHES`); CPU tensors run `gmm_plain`."""
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, tile_expert, block_m, transpose_rhs,
                         live_tiles)
    bm = _check(lhs, rhs, tile_expert, block_m, "gmm")
    M, C = lhs.shape
    E, R, S = rhs.shape
    W = R if transpose_rhs else S
    if (S if transpose_rhs else R) != C:
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)} does not contract "
                         f"with rhs {tuple(rhs.shape)} "
                         f"(transpose_rhs={transpose_rhs})")
    variant = _variant(lhs.dtype, bm, C, W, variant)
    lhs, te, live, live_ptr = _cuda_operands(lhs, rhs, tile_expert,
                                             live_tiles, "gmm")
    rhs = _aligned(rhs)
    out = torch.empty(M, W, dtype=lhs.dtype, device=lhs.device)
    _call("gmm_fwd", lhs.device, lhs.data_ptr(), rhs.data_ptr(),
          te.data_ptr(), live_ptr, out.data_ptr(), M, C, W, bm, E,
          rhs.stride(0), int(transpose_rhs),
          KERNEL_CODES[(lhs.dtype, variant)])
    LAUNCHES["gmm_fwd"] += 1
    return out


def gmm_drhs(lhs, dout, tile_expert, num_experts, block_m=DEFAULT_BM,
             live_tiles=None, variant=None):
    """K5b: (E, K, N) weight gradient of lhs (M, K) and dout (M, N) in
    lhs's dtype.  CUDA tensors launch the Hopper kernel `_variant` picks,
    or the named `variant` (counted in `LAUNCHES`); CPU tensors run
    `gmm_drhs_plain`."""
    if lhs.device.type == "cpu":
        return gmm_drhs_plain(lhs, dout, tile_expert, num_experts, block_m,
                              live_tiles)
    bm = _check(lhs, dout, tile_expert, block_m, "gmm drhs")
    M, K = lhs.shape
    N = dout.shape[1]
    if dout.shape[0] != M:
        raise ValueError(f"gmm drhs: dout {tuple(dout.shape)} vs lhs "
                         f"{tuple(lhs.shape)}")
    variant = _variant(lhs.dtype, bm, K, N, variant)
    lhs, te, live, live_ptr = _cuda_operands(lhs, dout, tile_expert,
                                             live_tiles, "gmm drhs")
    dout = _aligned(dout)
    drhs = torch.empty(num_experts, K, N, dtype=lhs.dtype,
                       device=lhs.device)
    _call("gmm_drhs", lhs.device, lhs.data_ptr(), dout.data_ptr(),
          te.data_ptr(), live_ptr, drhs.data_ptr(), M, K, N, bm,
          num_experts, KERNEL_CODES[(lhs.dtype, variant)])
    LAUNCHES["gmm_drhs"] += 1
    return drhs


class _Gmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, tile_expert, block_m, live_tiles):
        ctx.save_for_backward(lhs, rhs, tile_expert, live_tiles)
        ctx.block_m = block_m
        return gmm_fwd(lhs, rhs, tile_expert, block_m, live_tiles=live_tiles)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, tile_expert, live_tiles = ctx.saved_tensors
        g = g.contiguous()
        dlhs = drhs = None
        # lhs, rhs and g share one dtype (_check), so both come out in it
        if ctx.needs_input_grad[0]:
            # dlhs[t] = g[t] @ rhs[e]^T — K5f reading rhs transposed
            dlhs = gmm_fwd(g, rhs, tile_expert, ctx.block_m,
                           transpose_rhs=True, live_tiles=live_tiles)
        if ctx.needs_input_grad[1]:
            drhs = gmm_drhs(lhs, g, tile_expert, rhs.shape[0], ctx.block_m,
                            live_tiles)
        return dlhs, drhs, None, None, None


def gmm(lhs, rhs, tile_expert, block_m=DEFAULT_BM, block_n=DEFAULT_BN,
        live_tiles=None):
    """Ragged grouped matmul: out[t] = lhs[t] @ rhs[expert_of(t)] —
    K5f forward, K5f (transposed) and K5b backward on the card, their
    plain versions on the CPU.  `block_n` changes nothing (see the
    module docstring); `live_tiles` skips the padding past the last
    expert's span."""
    return _Gmm.apply(lhs, rhs, tile_expert, block_m, live_tiles)


def dropless_moe_ffn(x, expert_id, w_up, w_down, activation=F.silu,
                     block_m=DEFAULT_BM, block_n=DEFAULT_BN):
    """Dropless expert FFN: every token reaches its expert.  x (T, H);
    expert_id (T,); w_up (E, H, F); w_down (E, F, H).  Returns (T, H)."""
    E = w_up.shape[0]
    buf, tile_expert, inv_pos = sort_tokens_by_expert(
        x, expert_id, E, block_m)
    bm = _fit_block(buf.shape[0], block_m)
    live = live_tile_count(inv_pos, bm)
    h = activation(gmm(buf, w_up, tile_expert, block_m, block_n, live))
    out = gmm(h.to(x.dtype), w_down, tile_expert, block_m, block_n, live)
    return out[inv_pos.long()]
