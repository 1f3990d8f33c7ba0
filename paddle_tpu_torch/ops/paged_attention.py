"""Paged-attention decode (kernel K4): the CUDA kernel's wrapper, its
plain PyTorch version, and its launch counter.

The port of `paddle_tpu/ops/pallas_paged_attention.py::paged_attention`:
one token per slot attends its slot's rows t <= pos[b] of the paged KV
pool, reading the pool through the slot's block table.  On a CUDA
tensor `paged_attention` launches `csrc/paged_attention.cu` (built at
first use, see `_build.py`) or raises, and adds one to
`LAUNCHES["paged_attention"]`; on a CPU tensor it runs
`paged_attention_plain`, the same function in plain PyTorch — gather
the slot's view through the table, then `_attend`'s masked fp32 softmax
and P.V.  The CPU tests compare the plain version with the JAX package;
`chip_smoke.py` compares the kernel with the plain version on the card.

With the engine's tiered pool (`hot_window`), table ids >= the pool's
block count address a second pool, the host extension tier (`hk`,
`hv`: entries shaped like the pool's, (N_ext, bt, n_kv, hd), rows of a
block contiguous, any stride between blocks): the kernel reads those
rows in place from pinned host memory; the plain version gathers from
the pool and the tier concatenated (`tiered_entry`, the JAX package's
`_tiered_entry`).

The kernel splits each slot's rows into splits of `split_rows(...)`
rows (flash-decoding): one CUDA block per (split, kv head, slot) writes
the split's unnormalised softmax (m, l, acc) in fp32 to a workspace,
and a second kernel merges the live splits in split order.  The grid
and the workspace follow from the table's shape, never from `pos`, so
the wrapper does not synchronise with the card.

Tolerances (kernel vs plain, on the card): fp32 max abs error <= 1e-5
(the kernel's split softmax sums in another order); bf16 max abs error
per slot <= 2e-2 of that slot's max |out| (the plain version rounds the
probabilities to bf16 before P.V, the kernel keeps them in fp32, and
orders differ).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..quantization.int8 import dequantize_kv
from . import _build

__all__ = ["paged_attention", "paged_attention_plain", "paged_view",
           "tiered_entry", "split_rows", "SPLIT_ROWS", "NEG_INF",
           "LAUNCHES"]

NEG_INF = -1e30          # the gather path's mask fill (`_attend`)
# launches of the kernel on CUDA tensors; CPU calls count nothing
LAUNCHES = {"paged_attention": 0}

# rows of one split: 128 (8 of the engine's 16-row blocks) puts ~360
# live blocks on the 132 SMs at the kernel phase's shape and ~150 at the
# serve depths, each with its whole split in flight; tools/k4_split_sweep.py
# times the other sizes
SPLIT_ROWS = 128
# shared memory for a split's K and V tiles: 64 KB lets 3 blocks share
# an SM; rows wider than 256 bytes get shorter splits
_KV_TILE_BYTES = 64 * 1024

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INT_MAX = 2 ** 31 - 1                   # n_dev of an untiered call
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"paged_attention_decode": (
    _P, _P, _P, _P, _P, _P, _P, _P, _P,      # q pk pv ks vs table pos out work
    _I, _I, _I, _I, _I, _I, _I,              # B n_kv rep hd bt bmax split
    _I, _I,                                  # q dtype, pool dtype
    _P, _P, _P, _P, _L, _I,                  # ek ev eks evs, stride, n_dev
    _I, _P)}                                 # device, stream


def _split(entry):
    """(data, scale) of a pool entry; scale is None for a float pool."""
    if isinstance(entry, (tuple, list)):
        return entry[0], entry[1]
    return entry, None


def paged_view(entry, table, dtype=None):
    """Gather a (B, T) contiguous KV view from a pool entry: T = Bmax *
    bt rows per slot, row t of slot b at entry[table[b, t // bt],
    t % bt].  An int8 (data, scale) entry is dequantized to `dtype`."""
    data, scale = _split(entry)
    B, nmax = table.shape
    idx = table.long()
    bt = data.shape[1]
    d = data[idx].reshape(B, nmax * bt, data.shape[2], data.shape[3])
    if scale is None:
        return d
    s = scale[idx].reshape(B, nmax * bt, scale.shape[2])
    return dequantize_kv(d, s, dtype)


def tiered_entry(entry, hentry):
    """A pool entry concatenated with its host extension tier on the
    block dim (the tier moved to the entry's device), so table ids >=
    N address the tier's rows; `hentry` None returns `entry`."""
    if hentry is None:
        return entry
    if isinstance(entry, (tuple, list)):
        return tuple(tiered_entry(e, h) for e, h in zip(entry, hentry))
    return torch.cat([entry, hentry.to(entry.device)])


def paged_attention_plain(q, pk, pv, table, pos, hk=None, hv=None):
    """The plain PyTorch version of K4: q (B, nh, hd); pk/pv a float
    pool (N, bt, n_kv, hd) or an int8 (data, f32 scale (N, bt, n_kv))
    pair; table (B, Bmax) int32; pos (B,) int32; hk/hv the extension
    tier's entries (table ids >= N), or None.  Returns (B, nh, hd) in
    promote(q, pool) (q's dtype for an int8 pool)."""
    k = paged_view(tiered_entry(pk, hk), table, q.dtype)
    v = paged_view(tiered_entry(pv, hv), table, q.dtype)
    B, nh, hd = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, n_kv, nh // n_kv, hd)
    logits = torch.einsum("bgrd,btgd->bgrt", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    t_ids = torch.arange(k.shape[1], device=q.device)
    mask = t_ids[None, :] <= pos.long()[:, None]              # (B, T)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ct = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bgrt,btgd->bgrd", probs.to(ct), v.to(ct))
    return out.reshape(B, nh, hd)


def _check(q, kd, vd, ks, vs, table, pos):
    dev = q.device
    if q.dim() != 3 or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be (B, nh, hd) float32/bfloat16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    if kd.dim() != 4 or vd.shape != kd.shape or vd.dtype != kd.dtype:
        raise ValueError("pool K/V must share one (N, bt, n_kv, hd) "
                         "shape and dtype")
    B, nh, hd = q.shape
    N, bt, n_kv, khd = kd.shape
    if khd != hd:
        raise ValueError(f"head_dim mismatch: q {hd}, pool {khd}")
    if hd % 8 or hd > 256:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 and "
                         f"at most 256")
    if nh % n_kv or nh // n_kv > 8:
        raise ValueError(f"n_heads {nh} must be a multiple of n_kv "
                         f"{n_kv} with at most 8 query heads per kv head")
    quant = ks is not None
    if quant:
        if kd.dtype != torch.int8:
            raise ValueError("an int8 pool entry must hold int8 data")
        for s in (ks, vs):
            if s.dtype != torch.float32 or s.shape != (N, bt, n_kv):
                raise ValueError("int8 pool scales must be float32 "
                                 "(N, bt, n_kv)")
    elif kd.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported pool dtype {kd.dtype}")
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[0] != B:
        raise ValueError("table must be (B, Bmax) int32")
    if pos.dtype != torch.int32 or pos.shape != (B,):
        raise ValueError("pos must be (B,) int32")
    tensors = [q, kd, vd, table, pos] + ([ks, vs] if quant else [])
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    for t in (q, kd, vd):
        if t.data_ptr() % 16:
            raise ValueError("q and the pool must start 16-byte aligned "
                             "(the kernel loads rows as vectors)")


def _ext_args(q, kd, ks, hk, hv):
    """(ek, ev, eks, evs, stride in bytes, n_dev) for the kernel: the
    extension tier's base pointers, or nulls and n_dev = INT_MAX.  Every
    ext leaf is pinned host memory (or on q's card), its blocks'
    rows contiguous, one stride in bytes between blocks for all of
    them (the engine's tier is one (N_ext, block bytes) buffer)."""
    if hk is None and hv is None:
        return None, None, None, None, 0, _INT_MAX
    (ekd, eks), (evd, evs) = _split(hk), _split(hv)
    leaves = [(ekd, kd), (evd, kd)]
    if ks is not None:
        if eks is None or evs is None:
            raise ValueError("an int8 pool's extension tier needs scales")
        leaves += [(eks, ks), (evs, ks)]
    stride = ekd.stride(0) * ekd.element_size()
    for e, p in leaves:
        if e.dtype != p.dtype or e.shape[1:] != p.shape[1:]:
            raise ValueError(f"extension tier leaf {e.dtype} "
                             f"{tuple(e.shape)} does not match the pool's "
                             f"{p.dtype} {tuple(p.shape)}")
        if not e[0].is_contiguous() or e.stride(0) * e.element_size() \
                != stride or stride % 16 or e.data_ptr() % 16:
            raise ValueError("extension tier leaves must hold contiguous, "
                             "16-byte aligned blocks at one stride")
        if not (e.device == q.device or (e.device.type == "cpu"
                                         and e.is_pinned())):
            raise ValueError(f"the extension tier must be pinned host "
                             f"memory or on {q.device}, found {e.device}")
    return (ekd.data_ptr(), evd.data_ptr(),
            None if eks is None else eks.data_ptr(),
            None if evs is None else evs.data_ptr(), stride, kd.shape[0])


def split_rows(hd, itemsize, rows=SPLIT_ROWS):
    """Rows of one split for a pool of `itemsize`-byte elements at
    head_dim `hd`: `rows`, cut until a split's K and V rows fit
    `_KV_TILE_BYTES`, rounded down to a power of two in [8, 256]."""
    fit = max(8, min(rows, 256, _KV_TILE_BYTES // (2 * hd * itemsize)))
    return 1 << (fit.bit_length() - 1)


def paged_attention(q, pk, pv, table, pos, split=None, hk=None, hv=None):
    """Decode attention for one token per slot over the paged pool
    (shapes as `paged_attention_plain`; `hk` / `hv` the host extension
    tier, read in place).  A CUDA `q` launches the Hopper kernels
    (counted once in `LAUNCHES`), with splits of `split` rows (a power of
    two in [8, 256]; default `split_rows(...)`); a CPU `q` runs the
    plain version."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, pk, pv, table, pos, hk, hv)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    kd, ks = _split(pk)
    vd, vs = _split(pv)
    _check(q, kd, vd, ks, vs, table, pos)
    B, nh, hd = q.shape
    _, bt, n_kv, _ = kd.shape
    out_dtype = q.dtype if ks is not None \
        else torch.promote_types(q.dtype, kd.dtype)
    R = split_rows(hd, kd.element_size()) if split is None else split
    if R < 8 or R > 256 or R & (R - 1):
        raise ValueError(f"split of {R} rows: must be a power of two "
                         f"in [8, 256]")
    ext = _ext_args(q, kd, ks, hk, hv)
    n_splits = -(-table.shape[1] * bt // R)
    out = torch.empty((B, nh, hd), dtype=out_dtype, device=q.device)
    work = torch.empty(B * nh * n_splits * (hd + 2), dtype=torch.float32,
                       device=q.device)
    lib = _build.load("paged_attention", _SIGNATURES)
    # K4 runs 32 times a decode step on a host-bound serve path: the raw
    # stream getter and a device switch in C cost ~0.2 us where
    # `torch.cuda.device(...)` and `current_stream(...).cuda_stream`
    # cost ~13 us on the card's host
    dev = q.device.index
    err = lib.paged_attention_decode(
        q.data_ptr(), kd.data_ptr(), vd.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        work.data_ptr(), B, n_kv, nh // n_kv, hd, bt, table.shape[1], R,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[kd.dtype], *ext, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(cudaError {err})")
    LAUNCHES["paged_attention"] += 1
    return out
