"""Paged KV memory manager.

One shared device block pool replaces the engine's contiguous
per-slot KV *and* the prefix cache's reserved copy pool: every slot's
KV is a block table over the pool, so

  * admission allocates ceil((prompt+1)/block) blocks, not max_len —
    the pool oversubscribes gracefully instead of bounding slots;
  * a prefix-cache hit is zero-copy: the trie's physical blocks are
    aliased straight into the slot's table under a per-block refcount
    (the old path ran one device copy program per matched block);
  * allocation failure is a *schedulable event* the engine answers
    with its preempt ladder (reclaim cache -> requeue prefills ->
    park decoders) instead of a hard capacity bound.

This module is the pure-host bookkeeping half: free list, per-block
refcounts, per-slot block lists mirrored into a (B, Bmax) int32 table
the kernels gather through, and the host-tier accounting for parked
(swapped-out) requests.  No jax imports — unit-testable without a
device (tests/test_workload_preemption.py).

Block 0 is the TRASH block: inactive slots' table rows all point at
it, so the vectorized decode step's unavoidable garbage writes (every
batch row writes K/V every step) land somewhere harmless, and kernel-
side out-of-range row guards redirect there too.  It is never
allocated and never freed.

Tiered extension: with `ext_blocks > 0` the pager manages
a SECOND id range [n_blocks, n_blocks + ext_blocks) addressing
host-RAM extension blocks — the cold tier of the frontier-window
spill policy.  Extended ids live in the same slot tables and carry
the same refcount protocol (their counts in a parallel array); the
serving programs read them through a concatenated device+host view,
so to every consumer of this module a cold block is just a block
with a big id.  `spill_candidates` names the device blocks the
frontier-window policy lets go cold, `remap_blocks` moves a block
between tiers by rewriting every table that names it, and
`on_ext_free` tells the owner of the host bytes when an extension
slot's last reference drops.
"""

from __future__ import annotations

import numpy as np

__all__ = ["KVPager", "BlocksExhausted"]

TRASH_BLOCK = 0


class BlocksExhausted(RuntimeError):
    """The pool cannot satisfy an allocation even after the caller's
    reclaim hook ran — the engine turns this into a preemption, never
    into a failed request."""


class KVPager:
    """Host-side allocator for `n_blocks` pool blocks of `block_tokens`
    KV rows each, shared by `n_slots` slot block-tables of `max_blocks`
    entries.  Single-threaded by design (the engine's scheduler thread
    is the only caller).

    Refcount protocol: `alloc()` hands out blocks at refcount 1 owned
    by a slot; `alias()` bumps an existing block into a second owner
    (the prefix-cache trie sharing its physical blocks with a matching
    slot, or vice versa at insert); `decref()` returns a block to the
    free list when its last owner lets go.  A swap-out rescues the
    slot's ENTIRE block list to host RAM — including trie-shared
    prefix blocks, which also survive in the trie; swapping the whole
    table row keeps the transfer program shape-uniform and the resume
    path a single scatter, at the cost of over-reserving the host tier
    for cache-hit-heavy slots.
    """

    def __init__(self, n_blocks, block_tokens, n_slots, max_blocks,
                 host_pool_blocks=0, kv_dtype="auto", ext_blocks=0):
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self.n_slots = int(n_slots)
        self.max_blocks = int(max_blocks)
        self.host_pool_blocks = int(host_pool_blocks)
        # storage mode of the device pool this pager fronts:
        # "int8" blocks carry per-row-per-kv-head f32 scale tensors
        # alongside the int8 data — `block_kv_bytes` accounts for both
        self.kv_dtype = "auto" if kv_dtype is None else str(kv_dtype)
        if self.block_tokens <= 0:
            raise ValueError("block_tokens must be positive")
        if self.n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the trash "
                             "block)")
        # low ids first: keeps early traffic dense at the pool's front
        self._free = list(range(self.n_blocks - 1, TRASH_BLOCK, -1))
        self._refs = np.zeros(self.n_blocks, np.int32)
        self._refs[TRASH_BLOCK] = 1          # never allocated, never freed
        self.table = np.full((self.n_slots, self.max_blocks), TRASH_BLOCK,
                             np.int32)
        self.slot_blocks: list[list[int]] = [[] for _ in range(self.n_slots)]
        self.host_blocks_used = 0
        # tiered extension range (ids n_blocks .. n_blocks+ext_blocks)
        self.ext_blocks = int(ext_blocks)
        self._ext_refs = np.zeros(self.ext_blocks, np.int32)
        self._ext_free = list(range(self.ext_blocks - 1, -1, -1))
        # fired with the ext INDEX when an extension slot's last
        # reference drops (decref or remap-away): the owner of the
        # host bytes releases its row, CRC stamp, and host-tier claim
        self.on_ext_free = None
        # stats the engine mirrors into its metrics registry
        self.alloc_failures = 0

    # -- introspection -----------------------------------------------------

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        """Blocks with at least one owner (trash block excluded)."""
        return self.n_blocks - 1 - len(self._free)

    def refcount(self, bid):
        if self.is_ext(bid):
            return int(self._ext_refs[bid - self.n_blocks])
        return int(self._refs[bid])

    def is_ext(self, bid):
        """True when `bid` addresses the host extension tier."""
        return int(bid) >= self.n_blocks

    def ext_index(self, bid):
        """Extension-tier row index of an ext block id."""
        if not self.is_ext(bid):
            raise ValueError(f"block {bid} is device-resident")
        return int(bid) - self.n_blocks

    @property
    def ext_used(self):
        """Extension blocks currently holding cold KV."""
        return self.ext_blocks - len(self._ext_free)

    def blocks_for(self, n_rows):
        """Blocks needed to cover KV rows [0, n_rows)."""
        bt = self.block_tokens
        return (int(n_rows) + bt - 1) // bt

    def slot_rows(self, slot):
        """Rows currently covered by `slot`'s table."""
        return len(self.slot_blocks[slot]) * self.block_tokens

    def block_kv_bytes(self, n_kv, head_dim, itemsize):
        """HBM bytes ONE pool block holds for one layer's K or V
        entry under this pager's storage mode.  "int8" counts 1 byte
        per element plus the f32 per-row-per-kv-head scale; any other
        mode counts `itemsize` bytes per element.  The engine sums
        this over layers x {K, V} for swap accounting and the
        decode-attention bytes metric."""
        rows = self.block_tokens * int(n_kv)
        if self.kv_dtype == "int8":
            return rows * int(head_dim) + rows * 4
        return rows * int(head_dim) * int(itemsize)

    # -- refcounts ---------------------------------------------------------

    def incref(self, bid):
        if bid == TRASH_BLOCK:
            raise ValueError("trash block is not refcounted")
        if self.is_ext(bid):
            self._ext_refs[bid - self.n_blocks] += 1
            return
        self._refs[bid] += 1

    def decref(self, bid):
        if bid == TRASH_BLOCK:
            raise ValueError("trash block is not refcounted")
        if self.is_ext(bid):
            e = bid - self.n_blocks
            self._ext_refs[e] -= 1
            r = self._ext_refs[e]
            if r < 0:
                raise RuntimeError(f"ext kv block {bid} refcount underflow")
            if r == 0:
                self._ext_free.append(int(e))
                if self.on_ext_free is not None:
                    self.on_ext_free(e)
            return
        self._refs[bid] -= 1
        r = self._refs[bid]
        if r < 0:
            raise RuntimeError(f"kv block {bid} refcount underflow")
        if r == 0:
            self._free.append(int(bid))

    # -- allocation --------------------------------------------------------

    def alloc(self, k, count_failure=True):
        """Allocate `k` blocks at refcount 1, or None if the pool
        cannot satisfy ALL of them (no partial grants: a half-covered
        slot is useless and the blocks would just churn).  Callers that
        retry after a reclaim pass `count_failure=False` and bump
        `alloc_failures` once themselves, so one shortage event counts
        once."""
        if k > len(self._free):
            if count_failure:
                self.alloc_failures += 1
            return None
        out = [self._free.pop() for _ in range(int(k))]
        for bid in out:
            self._refs[bid] = 1
        return out

    def ext_alloc(self):
        """Allocate one extension-tier block at refcount 1, returning
        its GLOBAL id (>= n_blocks), or None when the tier is full.
        The caller owns the host bytes; this only tracks the id."""
        if not self._ext_free:
            return None
        e = self._ext_free.pop()
        self._ext_refs[e] = 1
        return self.n_blocks + e

    def remap_blocks(self, mapping):
        """Move blocks between tiers: every table entry naming an old
        id is rewritten to its new id and the refcount travels with it.
        The new ids must be freshly allocated (`alloc`/`ext_alloc`,
        refcount 1 placeholder) holding the SAME KV bytes — the caller
        copies payloads before remapping.  Old ids return to their
        tier's free list (ext frees fire `on_ext_free`: the bytes now
        live in the other tier)."""
        if not mapping:
            return
        for old, new in mapping.items():
            old, new = int(old), int(new)
            if old == TRASH_BLOCK or new == TRASH_BLOCK:
                raise ValueError("cannot remap the trash block")
            r = self.refcount(old)
            if r <= 0:
                raise RuntimeError(f"remap of unreferenced block {old}")
            if self.is_ext(new):
                self._ext_refs[new - self.n_blocks] = r
            else:
                self._refs[new] = r
            if self.is_ext(old):
                e = old - self.n_blocks
                self._ext_refs[e] = 0
                self._ext_free.append(e)
                if self.on_ext_free is not None:
                    self.on_ext_free(e)
            else:
                self._refs[old] = 0
                self._free.append(old)
        for slot, blocks in enumerate(self.slot_blocks):
            changed = False
            for j, bid in enumerate(blocks):
                if bid in mapping:
                    blocks[j] = int(mapping[bid])
                    changed = True
            if changed:
                self.table[slot, :len(blocks)] = blocks

    def spill_candidates(self, frontier_rows, hot_window, sink_blocks=1):
        """Device blocks the frontier-window policy lets go cold,
        coldest first: for each slot whose write frontier sits in block
        `fb = frontier_rows[slot] // block_tokens`, every device block
        at table index in [sink_blocks, fb - hot_window] is eligible —
        the last `hot_window` blocks stay hot (decode re-reads them
        hardest and the frontier block takes this step's writes), and
        the first `sink_blocks` stay pinned as attention sinks.
        Returns (slot, index, block_id) tuples ordered by distance
        behind the owning frontier (farthest = coldest first).  Blocks
        at or ahead of the frontier are NEVER eligible: chunk/decode/
        verify writes land there and writes only reach the device
        tier."""
        out = []
        for slot, blocks in enumerate(self.slot_blocks):
            fb = int(frontier_rows[slot]) // self.block_tokens
            hi = min(fb - int(hot_window) + 1, len(blocks))
            for idx in range(int(sink_blocks), hi):
                bid = blocks[idx]
                if bid != TRASH_BLOCK and not self.is_ext(bid):
                    out.append((slot, idx, bid, idx - fb))
        out.sort(key=lambda t: t[3])
        return [(s, i, b) for s, i, b, _ in out]

    def ensure_rows(self, slot, n_rows):
        """Grow `slot`'s table to cover rows [0, n_rows); True on
        success, False when the pool is short (caller runs the preempt
        ladder and retries)."""
        need = self.blocks_for(n_rows) - len(self.slot_blocks[slot])
        if need <= 0:
            return True
        got = self.alloc(need)
        if got is None:
            return False
        self._append_blocks(slot, got)
        return True

    def alias_prefix(self, slot, bids):
        """Zero-copy prefix-cache hit: alias trie blocks `bids` as the
        slot's leading table entries (refcount +1 each).  The slot must
        be empty (fresh admission)."""
        if self.slot_blocks[slot]:
            raise RuntimeError(f"slot {slot} already holds blocks")
        for bid in bids:
            self.incref(bid)
        self._append_blocks(slot, [int(b) for b in bids])

    def adopt(self, slot, bids):
        """Append freshly `alloc()`ed blocks (already at refcount 1) to
        the slot's table — ownership transfers to the slot."""
        if bids:
            self._append_blocks(slot, [int(b) for b in bids])

    def _append_blocks(self, slot, bids):
        blocks = self.slot_blocks[slot]
        start = len(blocks)
        blocks.extend(bids)
        if len(blocks) > self.max_blocks:
            raise RuntimeError(
                f"slot {slot} table overflow ({len(blocks)} > "
                f"{self.max_blocks} blocks)")
        self.table[slot, start:len(blocks)] = bids

    # -- release / park ----------------------------------------------------

    def release_slot(self, slot):
        """Drop every block reference the slot holds (EOS eviction,
        cancellation, park).  Shared blocks survive in the trie;
        exclusive ones return to the free list."""
        for bid in self.slot_blocks[slot]:
            self.decref(bid)
        self.slot_blocks[slot] = []
        self.table[slot, :] = TRASH_BLOCK

    def exclusive_blocks(self, slot):
        """The slot's blocks no one else holds.  Introspection only:
        the engine's swap-out rescues the slot's FULL block list (see
        the class docstring), not just these — this is the lower bound
        a sharing-aware swap could shrink the host payload to."""
        return [b for b in self.slot_blocks[slot] if self._refs[b] == 1]

    # -- host tier accounting ----------------------------------------------

    def host_reserve(self, k):
        """Claim `k` pinned host-RAM blocks for a swap-out; False when
        the host pool cap would be exceeded (the engine falls back to
        drop-and-recompute)."""
        if self.host_pool_blocks <= 0:
            return False
        if self.host_blocks_used + int(k) > self.host_pool_blocks:
            return False
        self.host_blocks_used += int(k)
        return True

    def host_release(self, k):
        self.host_blocks_used -= int(k)
        if self.host_blocks_used < 0:
            raise RuntimeError("host block accounting underflow")

    # -- invariants (tests) ------------------------------------------------

    def check(self):
        """Internal-consistency audit: every non-free block's refcount
        is positive, free blocks are unreferenced and unique, tables
        mirror slot_blocks exactly."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate block on the free list")
        for bid in free:
            if self._refs[bid] != 0:
                raise AssertionError(f"free block {bid} has refs")
        efree = set(self._ext_free)
        if len(efree) != len(self._ext_free):
            raise AssertionError("duplicate ext block on the free list")
        for e in efree:
            if self._ext_refs[e] != 0:
                raise AssertionError(f"free ext block {e} has refs")
        for slot, blocks in enumerate(self.slot_blocks):
            for j, bid in enumerate(blocks):
                if self.refcount(bid) <= 0:
                    raise AssertionError(
                        f"slot {slot} holds unreferenced block {bid}")
                if self.table[slot, j] != bid:
                    raise AssertionError(
                        f"slot {slot} table out of sync at {j}")
            if not (self.table[slot, len(blocks):] == TRASH_BLOCK).all():
                raise AssertionError(
                    f"slot {slot} table tail not trash-padded")
        return True
