"""Paged KV-cache decoding for the Llama family — the port of the
serving half of `paddle_tpu/models/llama_decode.py`.

The engine keeps ONE shared block pool per layer, (n_blocks,
block_tokens, n_kv, hd) K and V (or int8 data + f32 per-row-per-head
scales), and a per-slot block table (B, Bmax) int32 into it.  Block 0
is the trash block: inactive slots' tables point there, and rows past
a table resolve there, so every unavoidable garbage write is harmless.

Four programs run over the pool:
  * `paged_prefill_chunk` — one slot's chunk of prompt rows
    [off, off + C) written through its table row, attention against
    the slot's gathered view masked to t <= off + j;
  * `paged_prefill` — the whole-bucket prefill: one slot's padded
    prompt through the contiguous-cache layer `_block` against a LOCAL
    (1, Sb) cache, each layer's rows then written through the slot's
    table row (the engine's `prefill_chunk=None`);
  * `paged_decode_step_batch` — one token per slot at per-slot depths
    `pos`, K/V written at (table[b, pos // bt], pos % bt), attention
    through `kernel="gather"` (gather the view, `_attend`) or
    `kernel="cuda"` (the Hopper paged-attention kernel, K4, which
    walks the table itself; on a CPU tensor it runs its plain version);
  * `paged_verify_step` — speculative decoding's verify: W consecutive
    tokens a slot at rows pos + j, all W written before any attends,
    logits at every column.  `kernel="cuda"` hands K4 the B * W columns
    as single-query rows, each with its slot's table row and depth
    pos + j: exactly what K4 computes for one decode query there.

Parking a slot moves its blocks as one flat buffer: `gather_blocks`
packs them (every layer, K and V, int8 scales) and `scatter_blocks`
writes them back in place — indexing copies, as the JAX engine leaves
its `swap_out_fn` / `swap_in_fn` to XLA.

Math mirrors the JAX package: RMSNorm in fp32 cast back to the input
dtype before the weight, rope applied in the input dtype, GQA by head
grouping, fp32 attention logits and softmax with the probabilities cast
to q's dtype before P.V, SwiGLU.  JAX's functional `.at[].set` pool
updates become in-place `index_put_` here: the pool is updated where it
lies and returned only for the callers' symmetry with the JAX API.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .llama import _rope_tables_at, _rotate_half
from ..ops.paged_attention import NEG_INF, paged_attention
from ..ops.paged_attention import paged_view as _paged_view
from ..quantization.int8 import quantize_kv_rows

__all__ = ["collect_decode_state", "init_paged_cache", "paged_write_rows",
           "paged_decode_step_batch", "paged_verify_step",
           "paged_prefill_chunk",
           "paged_prefill", "pool_is_quant", "pool_leaves",
           "gather_blocks", "scatter_blocks"]


def collect_decode_state(model):
    """{role-name -> tensor} for the decode functions, detached from
    autograd (serving never differentiates).  Dense models only."""
    if model.config.moe_num_experts > 1:
        raise NotImplementedError(
            "serving or generating with an MoE model is not ported yet "
            "(ROADMAP: queue 1 item 2 (i), MoE decode)")
    lm = model.llama
    embed = lm.embed_tokens.weight.detach()
    state = {"embed": embed,
             "final_norm": lm.norm.weight.detach(),
             "head": (embed.T if model.lm_head is None
                      else model.lm_head.weight.detach())}
    state["layers"] = [{
        "ln1": layer.input_layernorm.weight.detach(),
        "ln2": layer.post_attention_layernorm.weight.detach(),
        "wq": layer.self_attn.q_proj.weight.detach(),
        "wk": layer.self_attn.k_proj.weight.detach(),
        "wv": layer.self_attn.v_proj.weight.detach(),
        "wo": layer.self_attn.o_proj.weight.detach(),
        "wg": layer.mlp.gate_proj.weight.detach(),
        "wu": layer.mlp.up_proj.weight.detach(),
        "wd": layer.mlp.down_proj.weight.detach(),
    } for layer in lm.layers]
    return state


def _rms(x, w, eps):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return y.to(x.dtype) * w


def _rope_at(q, k, positions, theta):
    """q,k: (B, S, H, D); positions: (S,) absolute indices shared by the
    batch, or (B, S) per-slot indices.  Rotation in the input dtype."""
    if positions.dim() == 2:
        B, S = positions.shape
        cos, sin = _rope_tables_at(positions.reshape(-1), q.shape[-1],
                                   theta, q.dtype)
        cos = cos.reshape(B, S, 1, -1)
        sin = sin.reshape(B, S, 1, -1)
    else:
        cos, sin = _rope_tables_at(positions, q.shape[-1], theta, q.dtype)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]

    def rot(x):
        return x * cos + _rotate_half(x) * sin

    return rot(q), rot(k)


def _attend(q, k_cache, v_cache, valid_len, n_heads, n_kv):
    """q: (B, S, H, hd) vs cache (B, T, KV, hd); row j of slot b reads
    cache[:valid_len[b, j] + 1] (valid_len (B, S)) or cache[:valid_len[j]
    + 1] (valid_len (S,)).  GQA by head grouping; logits and softmax in
    fp32, probabilities cast to q's dtype before P.V."""
    rep = n_heads // n_kv
    B, S, _, hd = q.shape
    qg = q.reshape(B, S, n_kv, rep, hd)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg.to(torch.float32),
                          k_cache.to(torch.float32)) / math.sqrt(hd)
    t_ids = torch.arange(k_cache.shape[1], device=q.device)
    if valid_len.dim() == 2:
        mask = t_ids[None, None, :] <= valid_len[:, :, None]  # (B, S, T)
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    else:
        mask = t_ids[None, :] <= valid_len[:, None]           # (S, T)
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ct = torch.promote_types(probs.dtype, v_cache.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", probs.to(ct), v_cache.to(ct))
    return out.reshape(B, S, n_heads, hd)


def _logits_last(state, cfg, x):
    h = _rms(x[:, -1:, :], state["final_norm"], cfg.rms_norm_eps)
    return (h @ state["head"])[:, 0, :]


def init_paged_cache(cfg, n_blocks, block_tokens, dtype, kv_dtype=None,
                     device=None):
    """One shared block pool per layer: (n_blocks, block_tokens, n_kv,
    hd) K and V on `device`.  kv_dtype selects the STORAGE dtype: None /
    "auto" stores in `dtype`; "bfloat16" / "float32" in that dtype;
    "int8" makes each entry an (int8 data, f32 (n_blocks, block_tokens,
    n_kv) scale) pair.  Zero scales make trash rows dequantize to 0."""
    shape = (n_blocks, block_tokens, cfg.num_key_value_heads, cfg.head_dim)

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    if kv_dtype == "int8":
        def entry():
            return (zeros(shape, torch.int8),
                    zeros(shape[:3], torch.float32))
        return [(entry(), entry()) for _ in range(cfg.num_hidden_layers)]
    store = dtype if kv_dtype in (None, "auto") else getattr(torch, kv_dtype)
    return [(zeros(shape, store), zeros(shape, store))
            for _ in range(cfg.num_hidden_layers)]


def pool_is_quant(pool):
    """True when the pool stores int8 (data, scale) entries."""
    return isinstance(pool[0][0], tuple)


def _entry_data(entry):
    return entry[0] if isinstance(entry, tuple) else entry


def pool_leaves(pool):
    """Every tensor of the pool in a fixed order: per layer K then V,
    each its data (and, int8, its scale after it)."""
    return [t for layer in pool for entry in layer
            for t in (entry if isinstance(entry, tuple) else (entry,))]


def _block_layout(pool, n):
    """(leaf, byte offset, byte length) of each leaf's `n` blocks in a
    flat buffer; every offset 16-byte aligned."""
    out, off = [], 0
    for t in pool_leaves(pool):
        nbytes = n * (t.numel() // t.shape[0]) * t.element_size()
        out.append((t, off, nbytes))
        off += -(-nbytes // 16) * 16
    return out, off


def _leaf_view(flat, t, off, nbytes, n):
    return flat[off:off + nbytes].view(t.dtype).view(n, *t.shape[1:])


def gather_blocks(pool, table_row):
    """One slot's blocks, in table order, of every layer's K and V (and
    the int8 scales), packed into ONE flat uint8 tensor on the pool's
    device — what parking copies to the host tier in a single transfer
    (the JAX engine's `swap_out_fn`).  `table_row`: int64 block ids on
    the pool's device."""
    n = int(table_row.numel())
    layout, total = _block_layout(pool, n)
    flat = torch.empty(total, dtype=torch.uint8, device=table_row.device)
    for t, off, nbytes in layout:
        torch.index_select(t, 0, table_row,
                           out=_leaf_view(flat, t, off, nbytes, n))
    return flat


def scatter_blocks(pool, table_row, flat):
    """The inverse of `gather_blocks`: write `flat` (on the pool's
    device) into the blocks `table_row` names, IN PLACE
    (`index_copy_`), so CUDA graphs captured over the pool read the
    restored rows (the JAX engine's `swap_in_fn`)."""
    n = int(table_row.numel())
    layout, total = _block_layout(pool, n)
    if flat.numel() != total:
        raise ValueError(f"{flat.numel()} bytes for {n} blocks of this "
                         f"pool, which take {total}")
    for t, off, nbytes in layout:
        t.index_copy_(0, table_row, _leaf_view(flat, t, off, nbytes, n))
    return pool


def _entry_set(entry, blk, col, x):
    """Write KV rows `x` (..., n_kv, hd) into a pool entry at (blk, col),
    IN PLACE (`index_put_` where JAX rebuilt the array with
    `.at[].set`); an int8 entry quantizes at append time."""
    if isinstance(entry, tuple):
        data, scale = entry
        qx, s = quantize_kv_rows(x)
        data.index_put_((blk, col), qx)
        scale.index_put_((blk, col), s)
        return entry
    entry.index_put_((blk, col), x.to(entry.dtype))
    return entry


def _paged_rows(table, rows, bt):
    """Map absolute KV rows to (physical block, in-block column) int64
    index tensors through a block table: table (B, Bmax) with rows
    (B, S), or a (Bmax,) row with rows (S,).  Rows outside the table
    resolve to the trash block: a clamped table lookup would read a
    LIVE block's id and the write would corrupt it."""
    nmax = table.shape[-1]
    rows = rows.long()
    bidx = torch.div(rows, bt, rounding_mode="floor")
    oob = (bidx < 0) | (bidx >= nmax)
    bidx = torch.where(oob, 0, bidx)
    if table.dim() == 2:
        b = torch.arange(table.shape[0], device=table.device)[:, None]
        blk = table.long()[b, bidx]
    else:
        blk = table.long()[bidx]
    blk = torch.where(oob, 0, blk)
    return blk, torch.remainder(rows, bt)


def paged_write_rows(pk, pv, table_row, rows, k, v):
    """Write one slot's K/V rows into the pool through its table row,
    in place.  table_row (Bmax,) int32; rows (S,) absolute rows; k/v
    (S, n_kv, hd).  Rows past the table land in the trash block."""
    blk, col = _paged_rows(table_row, rows, _entry_data(pk).shape[1])
    return _entry_set(pk, blk, col, k), _entry_set(pv, blk, col, v)


def _block(st, cfg, x, positions, k_cache, v_cache, write_at):
    """One decoder layer over S tokens at absolute `positions` (S,)
    against a contiguous cache (B, T, n_kv, hd): this chunk's K/V are
    written at rows [write_at, write_at + S) IN PLACE (JAX's
    `dynamic_update_slice`), then row j attends rows t <= positions[j].
    Returns (x, k_cache, v_cache) as the JAX `_block` does."""
    B, S, _ = x.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    h = _rms(x, st["ln1"], cfg.rms_norm_eps)
    q = (h @ st["wq"]).reshape(B, S, nh, hd)
    k = (h @ st["wk"]).reshape(B, S, nkv, hd)
    v = (h @ st["wv"]).reshape(B, S, nkv, hd)
    q, k = _rope_at(q, k, positions, cfg.rope_theta)
    at = int(write_at)
    k_cache[:, at:at + S] = k.to(k_cache.dtype)
    v_cache[:, at:at + S] = v.to(v_cache.dtype)
    attn = _attend(q, k_cache, v_cache, positions, nh, nkv)
    x = x + attn.reshape(B, S, nh * hd) @ st["wo"]
    h = _rms(x, st["ln2"], cfg.rms_norm_eps)
    x = x + (F.silu(h @ st["wg"]) * (h @ st["wu"])) @ st["wd"]
    return x, k_cache, v_cache


def _paged_block(st, cfg, x, positions, pk, pv, table, rows,
                 kernel="gather", split=None):
    """One decoder layer over the paged pool: K/V written through the
    block table first, then attention reads the pool through it.
    kernel="gather" gathers each slot's contiguous view and runs
    `_attend`; kernel="cuda" hands q, the pool entries and the table to
    `ops.paged_attention` (K4), with splits of `split` rows (None: the
    kernel's default): the S query columns of a slot become S
    single-query rows, row (b, j) with table row b and depth
    positions[b, j] (positions (B, S) per-slot rows, as the decode and
    verify steps give).  table (B, Bmax) int32; rows (B, S) absolute
    write rows."""
    B, S, _ = x.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    h = _rms(x, st["ln1"], cfg.rms_norm_eps)
    q = (h @ st["wq"]).reshape(B, S, nh, hd)
    k = (h @ st["wk"]).reshape(B, S, nkv, hd)
    v = (h @ st["wv"]).reshape(B, S, nkv, hd)
    q, k = _rope_at(q, k, positions, cfg.rope_theta)
    blk, col = _paged_rows(table, rows, _entry_data(pk).shape[1])
    _entry_set(pk, blk, col, k)
    _entry_set(pv, blk, col, v)
    if kernel == "cuda":
        # every column written above before any attends; expand +
        # reshape copies the table rows without a host read (graph-safe)
        rows_table = table if S == 1 else \
            table[:, None, :].expand(B, S, table.shape[1]).reshape(B * S, -1)
        attn = paged_attention(q.reshape(B * S, nh, hd), pk, pv,
                               rows_table,
                               positions.reshape(B * S).to(torch.int32),
                               split=split).reshape(B, S, nh, hd)
    elif kernel == "gather":
        attn = _attend(q, _paged_view(pk, table, q.dtype),
                       _paged_view(pv, table, q.dtype), positions, nh, nkv)
    else:
        raise ValueError(f"unknown decode kernel {kernel!r} "
                         "('gather' or 'cuda')")
    x = x + attn.reshape(B, S, nh * hd) @ st["wo"]
    h = _rms(x, st["ln2"], cfg.rms_norm_eps)
    return x + (F.silu(h @ st["wg"]) * (h @ st["wu"])) @ st["wd"]


def paged_decode_step_batch(state, cfg, token, pos, pool, table,
                            kernel="gather", split=None):
    """One token per slot at per-slot depths: token (B,) ids, pos (B,)
    int32 rows, table (B, Bmax) int32.  An inactive slot's all-trash
    table row makes its garbage write harmless.  `split` is K4's split
    size (kernel="cuda" only).  Returns (logits (B, V), pool) — the
    pool updated in place.  Nothing here reads a device value on the
    host, so the step can be captured in a CUDA graph."""
    x = state["embed"][token.long()[:, None]]
    positions = pos.long()[:, None]
    for st, (pk, pv) in zip(state["layers"], pool):
        x = _paged_block(st, cfg, x, positions, pk, pv, table, positions,
                         kernel=kernel, split=split)
    return _logits_last(state, cfg, x), pool


def paged_verify_step(state, cfg, tokens, pos, pool, table,
                      kernel="gather", split=None):
    """Speculative decoding's verify over the paged pool (the JAX
    package's `paged_verify_step`): tokens (B, W) ids, column 0 each
    slot's committed token and columns 1.. its draft; pos (B,) int32,
    the row of column 0, so column j sits at row pos[b] + j.  Every
    layer writes all W rows through the table before attending, and
    column j attends rows t <= pos[b] + j: what W decode steps would
    see.  Rejected columns leave dead rows, overwritten before they
    become visible because `pos` never advances past the accepted
    length; rows past the table land in the trash block.
    kernel="gather" is the JAX path (`_attend` over the gathered view);
    kernel="cuda" runs K4 over the B * W columns (see `_paged_block`).
    Returns (logits (B, W, V), pool) — the pool updated in place, and no
    device value read on the host, so the step can be captured in a
    CUDA graph."""
    B, W = tokens.shape
    x = state["embed"][tokens.long()]
    positions = pos.long()[:, None] + torch.arange(W, device=x.device)
    for st, (pk, pv) in zip(state["layers"], pool):
        x = _paged_block(st, cfg, x, positions, pk, pv, table, positions,
                         kernel=kernel, split=split)
    h = _rms(x, state["final_norm"], cfg.rms_norm_eps)
    return h @ state["head"], pool


def paged_prefill_chunk(state, cfg, ids, off, table_row, pool):
    """One slot's chunk ids (1, C) at rows [off, off + C), written
    through its (Bmax,) table row, attention against the slot's view
    masked to t <= off + j.  A padded tail writes garbage rows past the
    prompt, which the decode step overwrites before they become
    visible; rows past the table land in the trash block.  Returns
    (chunk hidden states (1, C, D), pool) — the pool updated in place."""
    _, C = ids.shape
    x = state["embed"][ids.long()]
    positions = int(off) + torch.arange(C, device=x.device)
    table = table_row.reshape(1, -1)
    rows = positions[None, :]
    for st, (pk, pv) in zip(state["layers"], pool):
        x = _paged_block(st, cfg, x, positions, pk, pv, table, rows)
    return x, pool


def paged_prefill(state, cfg, ids, table_row, pool):
    """The whole-bucket prefill (the JAX engine's `prefill_fn`): one
    slot's bucket-padded prompt ids (1, Sb) attend a LOCAL contiguous
    (1, Sb) cache in the pool's dtype (the prompt is self-contained),
    then each layer's rows [0, Sb) are written through the slot's
    (Bmax,) table row; padded rows past the table land in the trash
    block.  A float pool only: int8 rows would be attended unquantized
    here and quantized in the pool.  Returns (hidden states (1, Sb, D),
    pool) — the pool updated in place."""
    if pool_is_quant(pool):
        raise ValueError("the whole-bucket prefill needs a float pool: "
                         "an int8 pool requires chunked prefill")
    _, Sb = ids.shape
    x = state["embed"][ids.long()]
    positions = torch.arange(Sb, device=x.device)
    shape = (1, Sb, cfg.num_key_value_heads, cfg.head_dim)
    for st, (pk, pv) in zip(state["layers"], pool):
        kc = torch.zeros(shape, dtype=pk.dtype, device=x.device)
        vc = torch.zeros(shape, dtype=pv.dtype, device=x.device)
        x, kc, vc = _block(st, cfg, x, positions, kc, vc, 0)
        paged_write_rows(pk, pv, table_row, positions, kc[0], vc[0])
    return x, pool
