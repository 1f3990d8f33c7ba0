"""KV-cache decoding for the Llama family — the port of
`paddle_tpu/models/llama_decode.py`: the engine's paged programs and
the static contiguous-cache programs behind `generate`.

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

The contiguous-cache programs serve `generate` (the JAX package's
static KV cache): `init_cache` allocates (B, max_len, n_kv, hd) K and V
per layer, `prefill` writes a whole prompt, `prefill_chunk` one chunk
into a slot of a multi-slot cache, `decode_step` / `decode_step_batch`
one token a row at a shared or per-row depth, `verify_step` W tokens a
row, and `decode_greedy` / `generate` loop greedy steps in Python where
JAX runs `lax.scan`.  Attention there is `_attend` in plain torch, as
the JAX contiguous path is XLA.

`collect_decode_state(model, weight_dtype="int8")` swaps every layer's
seven matmul weights for weight-only int8 (data, scale) pairs (on the
card a bf16 state holds the data in kernel Q1's fragment order,
`ops.wo_int8_matmul.pack_weight`); `_mm` sends a pair through
`quantization.int8.matmul_wo_int8` (kernel Q1 on the card) and a plain
matrix through `@`; q / k / v, which share their input, go through
`_mm_shared` (one Q1 launch for the three): five launches a layer.
Embedding, norms and the LM head stay full precision.

Parking a slot moves its blocks as one flat buffer: `gather_blocks`
packs them block after block (each block every layer's K and V, int8
scales, in `pool_leaves` order) and `scatter_blocks` writes them back
in place — indexing copies, as the JAX engine leaves its `swap_out_fn`
/ `swap_in_fn` to XLA.

The tiered pool (the engine's `hot_window`): a `KVTier` holds the host
extension tier, rows of that same one-block layout in one (rows, block
bytes) buffer (pinned host memory on the card), with pool-shaped views
of it per layer (`KVTier.layers`).  The paged programs take it as
`hpool` (the JAX programs' argument): table ids >= the pool's block
count address its rows.  Writes stay on the device pool (the spill
policy keeps every write frontier hot); reads go through the
concatenated view (`ops.paged_attention.tiered_entry`, the JAX
`_tiered_entry`) on the gather path, or K4 reads the tier's rows in
place (kernel="cuda").  A gather step on the card first copies the
whole tier to the device (the JAX route: it ships the tier every
call); the engine's prefill passes a tier of only the rows its table
names, already on the device (`KVTier.select`).

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
from ..ops.paged_attention import tiered_entry
from ..ops.wo_int8_matmul import pack_weight
from ..quantization.int8 import (matmul_wo_int8, matmul_wo_int8_many,
                                 quantize_kv_rows, weight_only_int8)

__all__ = ["collect_decode_state", "init_cache", "prefill",
           "prefill_chunk", "decode_step", "decode_step_batch",
           "verify_step", "decode_greedy", "generate",
           "init_paged_cache", "paged_write_rows",
           "paged_decode_step_batch", "paged_verify_step",
           "paged_prefill_chunk",
           "paged_prefill", "pool_is_quant", "pool_leaves",
           "gather_blocks", "scatter_blocks", "KVTier"]

_WEIGHT_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def collect_decode_state(model, weight_dtype=None):
    """{role-name -> tensor} for the decode functions, detached from
    autograd (serving never differentiates).  Dense models only.

    weight_dtype="int8" swaps each layer's matmul weights (q / k / v /
    o and the SwiGLU triple) for weight-only int8 (data, scale) pairs,
    quantized one matrix at a time on the weight's device; embedding,
    norms and the LM head stay full precision (the head feeds argmax
    directly).  The model's own parameters are left as they are.  A
    bf16 state on the card holds each int8 matrix in the order kernel
    Q1's bf16 kernel reads it (`ops.wo_int8_matmul.pack_weight`) instead
    of `[in, out]`."""
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
    if weight_dtype in (None, "auto"):
        return state
    if weight_dtype != "int8":
        raise ValueError(f"unsupported weight_dtype={weight_dtype!r} "
                         "(expected None or 'int8')")
    pack = embed.is_cuda and embed.dtype == torch.bfloat16
    for st in state["layers"]:
        for key in _WEIGHT_KEYS:
            wq, scale = weight_only_int8(st[key])
            st[key] = (pack_weight(wq) if pack else wq, scale)
    return state


def _mm(x, w):
    """x @ w where `w` is a plain matrix or a weight-only int8 (data,
    per-channel scale) pair."""
    if isinstance(w, tuple):
        return matmul_wo_int8(x, w[0], w[1])
    return x @ w


def _mm_shared(x, *ws):
    """[x @ w for w in ws] (q / k / v); int8 pairs go through one Q1
    launch on the card."""
    if all(isinstance(w, tuple) for w in ws):
        return matmul_wo_int8_many(x, ws)
    return [_mm(x, w) for w in ws]


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


def _block_layout(pool):
    """(leaf, byte offset, byte length) of each leaf's part of ONE
    block in the flat layout, and the block's bytes; every offset
    16-byte aligned."""
    out, off = [], 0
    for t in pool_leaves(pool):
        nbytes = (t.numel() // t.shape[0]) * t.element_size()
        out.append((t, off, nbytes))
        off += -(-nbytes // 16) * 16
    return out, off


def _leaf_rows(rows, t, off, nbytes):
    """Leaf `t`'s part of every block of `rows` ((n, block bytes)
    uint8) as an (n, *t.shape[1:]) view (strided over the blocks)."""
    n = rows.shape[0]
    return rows[:, off:off + nbytes].view(t.dtype).view(n, *t.shape[1:])


def gather_blocks(pool, table_row):
    """The blocks `table_row` names (int64 ids on the pool's device),
    in table order, each of every layer's K and V (and the int8
    scales), packed block after block into ONE flat uint8 tensor on the
    pool's device — what parking copies to the host tier in a single
    transfer (the JAX engine's `swap_out_fn`), and what a row of the
    extension tier holds."""
    n = int(table_row.numel())
    layout, bb = _block_layout(pool)
    flat = torch.empty(n * bb, dtype=torch.uint8, device=table_row.device)
    rows = flat.view(n, bb)
    for t, off, nbytes in layout:
        _leaf_rows(rows, t, off, nbytes).copy_(t.index_select(0, table_row))
    return flat


def scatter_blocks(pool, table_row, flat):
    """The inverse of `gather_blocks`: write `flat` (on the pool's
    device) into the blocks `table_row` names, IN PLACE
    (`index_copy_`), so CUDA graphs captured over the pool read the
    restored rows (the JAX engine's `swap_in_fn`)."""
    n = int(table_row.numel())
    layout, bb = _block_layout(pool)
    if flat.numel() != n * bb:
        raise ValueError(f"{flat.numel()} bytes for {n} blocks of this "
                         f"pool, which take {n * bb}")
    rows = flat.view(n, bb)
    for t, off, nbytes in layout:
        t.index_copy_(0, table_row, _leaf_rows(rows, t, off, nbytes))
    return pool


class KVTier:
    """The host extension tier of a paged pool: `flat`, (rows, block
    bytes) uint8, each row one block in `gather_blocks`' layout, and
    `layers`, per layer (K entry, V entry) views of it shaped like the
    pool's ((rows, bt, n_kv, hd), int8 (data, scale) pairs), strided by
    a row.  `KVTier.empty(pool, rows, pin=True)` allocates one (pinned
    host memory: the card reads it in place); `to` and `select` make a
    tier over a copy of all or some rows."""

    def __init__(self, pool, flat):
        self.flat = flat
        layout, bb = _block_layout(pool)
        if flat.dim() != 2 or flat.shape[1] != bb \
                or flat.dtype != torch.uint8:
            raise ValueError(f"a tier of this pool is (rows, {bb}) "
                             f"uint8, got {flat.dtype} "
                             f"{tuple(flat.shape)}")
        self._pool = pool
        views = iter([_leaf_rows(flat, t, off, nbytes)
                      for t, off, nbytes in layout])

        def entry(e):
            return (next(views), next(views)) if isinstance(e, tuple) \
                else next(views)
        self.layers = [(entry(k), entry(v)) for k, v in pool]

    @classmethod
    def empty(cls, pool, rows, pin=False):
        """A zeroed tier of `rows` rows in host memory (pinned with
        `pin`)."""
        flat = torch.zeros((int(rows), _block_layout(pool)[1]),
                           dtype=torch.uint8, pin_memory=bool(pin))
        return cls(pool, flat)

    def to(self, device, non_blocking=False):
        """The tier copied to `device` (itself when it is there)."""
        if self.flat.device == torch.device(device):
            return self
        return KVTier(self._pool, self.flat.to(device,
                                               non_blocking=non_blocking))

    def select(self, rows, device):
        """A tier of the rows `rows` (a list of ints), in that order, on
        `device`: each row copied on its own (pinned: without blocking,
        queued on the current stream)."""
        flat = torch.empty((len(rows), self.flat.shape[1]),
                           dtype=torch.uint8, device=device)
        for j, e in enumerate(rows):
            flat[j].copy_(self.flat[e], non_blocking=True)
        return KVTier(self._pool, flat)


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
    """One decoder layer over S tokens at absolute `positions` ((S,)
    shared by the batch, or (B, S) per row) against a contiguous cache
    (B, T, n_kv, hd): this chunk's K/V are written IN PLACE (JAX's
    `dynamic_update_slice` / `.at[].set`), then row j attends rows
    t <= its position.  `write_at` is a shared first row (a Python int,
    clamped to [0, T - S] as `dynamic_update_slice` clamps it), a (B,)
    row a slot (S == 1: each slot writes its token at its own depth), or
    a (B, S) row matrix (the verify step: S consecutive rows a slot);
    tensor rows outside the cache are dropped, as JAX's scatter drops
    them.  Returns (x, k_cache, v_cache) as the JAX `_block` does."""
    B, S, _ = x.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    h = _rms(x, st["ln1"], cfg.rms_norm_eps)
    q, k, v = _mm_shared(h, st["wq"], st["wk"], st["wv"])
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    q, k = _rope_at(q, k, positions, cfg.rope_theta)
    if torch.is_tensor(write_at):
        at = write_at.long().reshape(B, -1)             # (B, S) or (B, 1)
        rows = torch.arange(B, device=x.device)[:, None].expand_as(at)
        keep = (at >= 0) & (at < k_cache.shape[1])
        kk, vv = (k, v) if at.shape[1] == S else (k[:, :1], v[:, :1])
        idx = (rows[keep], at[keep])
        k_cache.index_put_(idx, kk[keep].to(k_cache.dtype))
        v_cache.index_put_(idx, vv[keep].to(v_cache.dtype))
    else:
        at = min(max(int(write_at), 0), k_cache.shape[1] - S)
        k_cache[:, at:at + S] = k.to(k_cache.dtype)
        v_cache[:, at:at + S] = v.to(v_cache.dtype)
    attn = _attend(q, k_cache, v_cache, positions, nh, nkv)
    x = x + _mm(attn.reshape(B, S, nh * hd), st["wo"])
    h = _rms(x, st["ln2"], cfg.rms_norm_eps)
    x = x + _mm(F.silu(_mm(h, st["wg"])) * _mm(h, st["wu"]), st["wd"])
    return x, k_cache, v_cache


def _paged_block(st, cfg, x, positions, pk, pv, table, rows,
                 kernel="gather", split=None, hk=None, hv=None):
    """One decoder layer over the paged pool: K/V written through the
    block table first, then attention reads the pool through it.
    kernel="gather" gathers each slot's contiguous view and runs
    `_attend`; kernel="cuda" hands q, the pool entries and the table to
    `ops.paged_attention` (K4), with splits of `split` rows (None: the
    kernel's default): the S query columns of a slot become S
    single-query rows, row (b, j) with table row b and depth
    positions[b, j] (positions (B, S) per-slot rows, as the decode and
    verify steps give).  table (B, Bmax) int32; rows (B, S) absolute
    write rows.  hk / hv: this layer's host extension tier entries
    (table ids >= the pool's blocks read there; writes never go
    there), or None."""
    B, S, _ = x.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    h = _rms(x, st["ln1"], cfg.rms_norm_eps)
    q, k, v = _mm_shared(h, st["wq"], st["wk"], st["wv"])
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    q, k = _rope_at(q, k, positions, cfg.rope_theta)
    blk, col = _paged_rows(table, rows, _entry_data(pk).shape[1])
    if hk is not None and not blk.is_cuda \
            and not bool((blk < _entry_data(pk).shape[0]).all()):
        # the card's steps are graphs (no host read); the engine checks
        # its write frontiers on the host before every dispatch
        raise ValueError("a KV write targets the host extension tier")
    _entry_set(pk, blk, col, k)
    _entry_set(pv, blk, col, v)
    if kernel == "cuda":
        # every column written above before any attends; expand +
        # reshape copies the table rows without a host read (graph-safe)
        rows_table = table if S == 1 else \
            table[:, None, :].expand(B, S, table.shape[1]).reshape(B * S, -1)
        tier = {} if hk is None else {"hk": hk, "hv": hv}
        attn = paged_attention(q.reshape(B * S, nh, hd), pk, pv,
                               rows_table,
                               positions.reshape(B * S).to(torch.int32),
                               split=split, **tier).reshape(B, S, nh, hd)
    elif kernel == "gather":
        attn = _attend(q, _paged_view(tiered_entry(pk, hk), table, q.dtype),
                       _paged_view(tiered_entry(pv, hv), table, q.dtype),
                       positions, nh, nkv)
    else:
        raise ValueError(f"unknown decode kernel {kernel!r} "
                         "('gather' or 'cuda')")
    x = x + _mm(attn.reshape(B, S, nh * hd), st["wo"])
    h = _rms(x, st["ln2"], cfg.rms_norm_eps)
    return x + _mm(F.silu(_mm(h, st["wg"])) * _mm(h, st["wu"]), st["wd"])


def _tier_layers(hpool, kernel, device, n_layers):
    """Per layer (hk, hv) of the host tier `hpool` (a `KVTier` or None)
    for a step on `device`: the gather path on another device than the
    tier's first copies the whole tier there (without blocking, so a
    CUDA graph records the copy); K4 reads it where it lies."""
    if hpool is None:
        return [(None, None)] * n_layers
    if kernel != "cuda":
        hpool = hpool.to(device, non_blocking=True)
    return hpool.layers


def paged_decode_step_batch(state, cfg, token, pos, pool, table,
                            kernel="gather", split=None, hpool=None):
    """One token per slot at per-slot depths: token (B,) ids, pos (B,)
    int32 rows, table (B, Bmax) int32.  An inactive slot's all-trash
    table row makes its garbage write harmless.  `split` is K4's split
    size (kernel="cuda" only); `hpool` the host extension tier (a
    `KVTier`: table ids >= the pool's blocks read its rows).  Returns
    (logits (B, V), pool) — the pool updated in place.  Nothing here
    reads a device value on the host, so the step can be captured in a
    CUDA graph."""
    x = state["embed"][token.long()[:, None]]
    positions = pos.long()[:, None]
    tiers = _tier_layers(hpool, kernel, x.device, len(pool))
    for st, (pk, pv), (hk, hv) in zip(state["layers"], pool, tiers):
        x = _paged_block(st, cfg, x, positions, pk, pv, table, positions,
                         kernel=kernel, split=split, hk=hk, hv=hv)
    return _logits_last(state, cfg, x), pool


def paged_verify_step(state, cfg, tokens, pos, pool, table,
                      kernel="gather", split=None, hpool=None):
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
    kernel="cuda" runs K4 over the B * W columns (see `_paged_block`);
    `hpool` as `paged_decode_step_batch`.  Returns (logits (B, W, V),
    pool) — the pool updated in place, and no device value read on the
    host, so the step can be captured in a CUDA graph."""
    B, W = tokens.shape
    x = state["embed"][tokens.long()]
    positions = pos.long()[:, None] + torch.arange(W, device=x.device)
    tiers = _tier_layers(hpool, kernel, x.device, len(pool))
    for st, (pk, pv), (hk, hv) in zip(state["layers"], pool, tiers):
        x = _paged_block(st, cfg, x, positions, pk, pv, table, positions,
                         kernel=kernel, split=split, hk=hk, hv=hv)
    h = _rms(x, state["final_norm"], cfg.rms_norm_eps)
    return h @ state["head"], pool


def paged_prefill_chunk(state, cfg, ids, off, table_row, pool,
                        hpool=None):
    """One slot's chunk ids (1, C) at rows [off, off + C), written
    through its (Bmax,) table row, attention against the slot's view
    masked to t <= off + j (through the gather path; with `hpool`, the
    host extension tier, over the concatenated view).  A padded tail
    writes garbage rows past the prompt, which the decode step
    overwrites before they become visible; rows past the table land in
    the trash block.  Returns (chunk hidden states (1, C, D), pool) —
    the pool updated in place."""
    _, C = ids.shape
    x = state["embed"][ids.long()]
    positions = int(off) + torch.arange(C, device=x.device)
    table = table_row.reshape(1, -1)
    rows = positions[None, :]
    tiers = _tier_layers(hpool, "gather", x.device, len(pool))
    for st, (pk, pv), (hk, hv) in zip(state["layers"], pool, tiers):
        x = _paged_block(st, cfg, x, positions, pk, pv, table, rows,
                         hk=hk, hv=hv)
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


# -- the static contiguous-cache programs (generate) --------------------


def init_cache(cfg, batch, max_len, dtype, device=None):
    """Per layer a zeroed (K, V) pair of (batch, max_len, n_kv, hd)."""
    shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_hidden_layers)]


def prefill(state, cfg, ids, cache):
    """The prompt ids (B, S) in one pass, written at rows [0, S);
    returns (last-token logits (B, V), cache) — the cache updated in
    place."""
    _, S = ids.shape
    x = state["embed"][ids.long()]
    positions = torch.arange(S, device=x.device)
    for st, (kc, vc) in zip(state["layers"], cache):
        x, _, _ = _block(st, cfg, x, positions, kc, vc, 0)
    return _logits_last(state, cfg, x), cache


def prefill_chunk(state, cfg, ids, off, slot, caches):
    """One chunk ids (1, C) of a prompt at positions [off, off + C) into
    slot `slot` of a multi-slot cache: rows [off, off + C) of that slot
    are written, row j attends the slot's rows t <= off + j, so a prompt
    split into chunks gives the cache and logits of one whole-prompt
    pass.  `off` and `slot` are Python ints (`slot` clamped into the
    cache, as JAX's `dynamic_slice` clamps it).  Returns (chunk hidden
    states (1, C, D), caches) — the caches updated in place."""
    _, C = ids.shape
    x = state["embed"][ids.long()]
    off = int(off)
    sl = min(max(int(slot), 0), caches[0][0].shape[0] - 1)
    positions = off + torch.arange(C, device=x.device)
    for st, (kc, vc) in zip(state["layers"], caches):
        x, _, _ = _block(st, cfg, x, positions, kc[sl:sl + 1],
                         vc[sl:sl + 1], off)
    return x, caches


def decode_step(state, cfg, token, pos, cache):
    """One token a row, token (B,), at the shared row `pos` (a Python
    int: no step reads the device on the host).  Returns (logits (B, V),
    cache)."""
    x = state["embed"][token.long()[:, None]]
    positions = torch.tensor([int(pos)], device=x.device)
    for st, (kc, vc) in zip(state["layers"], cache):
        x, _, _ = _block(st, cfg, x, positions, kc, vc, int(pos))
    return _logits_last(state, cfg, x), cache


def decode_step_batch(state, cfg, token, pos, cache):
    """One token a row at per-row depths pos (B,) — the continuous
    batching step over a contiguous cache: each row's K/V land at its
    own row, each row attends rows t <= pos[b].  Returns (logits (B, V),
    cache)."""
    x = state["embed"][token.long()[:, None]]
    pos = torch.as_tensor(pos, device=x.device).long()
    for st, (kc, vc) in zip(state["layers"], cache):
        x, _, _ = _block(st, cfg, x, pos[:, None], kc, vc, pos)
    return _logits_last(state, cfg, x), cache


def verify_step(state, cfg, tokens, pos, cache):
    """Speculative decoding's verify over a contiguous cache: tokens
    (B, W), column 0 each row's committed token and columns 1.. its
    draft, at rows pos[b] + j; every layer writes all W rows before any
    attends, so column j sees what a decode step at that depth sees.
    Rows past the cache are dropped.  Returns (logits (B, W, V), cache)."""
    _, W = tokens.shape
    x = state["embed"][tokens.long()]
    pos = torch.as_tensor(pos, device=x.device).long()
    positions = pos[:, None] + torch.arange(W, device=x.device)
    for st, (kc, vc) in zip(state["layers"], cache):
        x, _, _ = _block(st, cfg, x, positions, kc, vc, positions)
    h = _rms(x, state["final_norm"], cfg.rms_norm_eps)
    return h @ state["head"], cache


def decode_greedy(state, cfg, first_token, start_pos, cache, steps):
    """`steps` greedy decode steps from `first_token` (B,) at row
    `start_pos` (a Python int), a Python loop where JAX runs
    `lax.scan`.  Returns (tokens (B, steps) in first_token's dtype,
    cache)."""
    token, toks = first_token, []
    for i in range(int(steps)):
        logits, cache = decode_step(state, cfg, token, int(start_pos) + i,
                                    cache)
        token = torch.argmax(logits, dim=-1).to(first_token.dtype)
        toks.append(token)
    if not toks:
        return first_token.new_zeros((first_token.shape[0], 0)), cache
    return torch.stack(toks, dim=1), cache


def as_ids(input_ids, device):
    """`input_ids` as an int64 tensor on `device` (the same tensor when
    it already is one)."""
    ids = torch.as_tensor(input_ids, device=device)
    return ids if ids.dtype == torch.int64 else ids.long()


def generate(model, input_ids, max_new_tokens=8):
    """Greedy KV-cache generation (the use_cache=True path of
    `LlamaForCausalLM.generate`): prefill the prompt into a (B, S +
    max_new_tokens) cache, then greedy steps.  Returns the int64 ids
    (B, S + max_new_tokens) on the model's device, prompt included."""
    ids = as_ids(input_ids, model.device)
    if max_new_tokens <= 0:
        return ids
    cfg = model.config
    state = collect_decode_state(model)
    B, S = ids.shape
    cache = init_cache(cfg, B, S + max_new_tokens, state["embed"].dtype,
                       device=ids.device)
    logits, cache = prefill(state, cfg, ids, cache)
    first = torch.argmax(logits, dim=-1)
    rest, _ = decode_greedy(state, cfg, first, S, cache,
                            max_new_tokens - 1)
    return torch.cat([ids, first[:, None], rest], dim=1)
