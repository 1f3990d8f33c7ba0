"""Radix prefix cache bookkeeping for the continuous-batching engine —
a copy of the JAX package's `inference/prefix_cache.py` (host-only:
the port keeps its own copy rather than import the reference).  The
vLLM automatic-prefix-caching / SGLang RadixAttention role: the engine
owns the device block pool; this module owns the trie, refcounts, free
list, and LRU eviction — pure host state, unit-testable without a
device.

Prompts are keyed in fixed `block_tokens`-sized chunks of token ids: a
trie node per block, child edges keyed by the block's raw token bytes.
`match()` walks the longest cached prefix in whole blocks; in pager
mode (the engine's shared paged pool) the hit is zero-copy —
the trie's physical blocks are aliased into the admitted slot's block
table under the pool's refcounts — while standalone mode keeps the
original semantics (the caller copies the returned pool blocks).
`insert()` extends the trie with a finished prompt's full blocks,
aliasing the slot's physical blocks (pager mode) or allocating from
the private free list (standalone) and — under budget pressure —
evicting least-recently-used *leaf* nodes with no in-flight readers
(leaf-only eviction keeps every cached path intact; refcounts taken by
`acquire()` pin blocks an admitted request matched until that request
leaves its slot).  `reclaim()` lets the engine's preempt ladder pull
unpinned trie blocks back to the pool before resorting to preemption.

Match is always capped at the prompt's last token minus one: the engine
must run at least one real prefill row to produce the first-token
logits, so a fully-cached prompt still chunk-prefills its tail.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RadixPrefixCache"]


class _Node:
    __slots__ = ("key", "block", "children", "parent", "refs", "last_use")

    def __init__(self, key, block, parent):
        self.key = key            # this block's token bytes (edge label)
        self.block = block        # pool block id holding its K/V rows
        self.children = {}        # token-bytes -> _Node
        self.parent = parent
        self.refs = 0             # in-flight requests pinning this block
        self.last_use = 0


class RadixPrefixCache:
    """Host bookkeeping for `n_blocks` pool blocks of `block_tokens`
    tokens each.  Single-threaded by design (the engine's scheduler
    thread is the only caller)."""

    def __init__(self, n_blocks, block_tokens, pager=None):
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        if self.n_blocks <= 0 or self.block_tokens <= 0:
            raise ValueError("n_blocks and block_tokens must be positive")
        self._root = _Node(b"", -1, None)
        # pager mode: the trie owns no device pool of its own
        # — it holds refcounts on at most `n_blocks` blocks inside the
        # engine's shared paged pool, aliased from finishing slots
        # (zero-copy insert/hit).  Standalone mode keeps the original
        # private free list.
        self._pager = pager
        self._free = [] if pager is not None else list(range(self.n_blocks))
        self._held = 0
        self._clock = 0
        # stats (engine mirrors these into its metrics registry)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_saved = 0

    # -- introspection -----------------------------------------------------

    @property
    def blocks_used(self):
        if self._pager is not None:
            return self._held
        return self.n_blocks - len(self._free)

    def nodes(self):
        """Every live node (tests: refcount/eviction invariants)."""
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            if n is not self._root:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def _tick(self):
        self._clock += 1
        return self._clock

    @staticmethod
    def _blocks_of(tokens):
        return np.asarray(tokens, np.int32).reshape(-1)

    # -- lookup ------------------------------------------------------------

    def match(self, tokens, max_tokens=None):
        """Longest cached prefix of `tokens` in whole blocks, capped at
        min(max_tokens, len(tokens) - 1) so at least one row is left to
        prefill.  Returns (matched_tokens, [block_ids], [nodes]); the
        caller must `acquire(nodes)` before relying on the blocks and
        `release(nodes)` when its request leaves the engine."""
        toks = self._blocks_of(tokens)
        bt = self.block_tokens
        limit = toks.size - 1
        if max_tokens is not None:
            limit = min(limit, int(max_tokens))
        node, nodes, bids, j = self._root, [], [], 0
        while (j + 1) * bt <= limit:
            child = node.children.get(toks[j * bt:(j + 1) * bt].tobytes())
            if child is None:
                break
            child.last_use = self._tick()
            nodes.append(child)
            bids.append(child.block)
            node = child
            j += 1
        matched = j * bt
        if matched:
            self.hits += 1
            self.tokens_saved += matched
        else:
            self.misses += 1
        return matched, bids, nodes

    def match_undo(self, matched):
        """Reverse the stats bump of the immediately preceding
        `match()`: the engine aborted the admission (pool shortage) and
        will re-match when blocks free up — without this, every retry
        would inflate the hit/miss counters."""
        if matched:
            self.hits -= 1
            self.tokens_saved -= int(matched)
        else:
            self.misses -= 1

    def acquire(self, nodes):
        for n in nodes:
            n.refs += 1

    def release(self, nodes):
        for n in nodes:
            n.refs -= 1
            if n.refs < 0:
                raise RuntimeError("prefix-cache refcount underflow")

    # -- insertion / eviction ----------------------------------------------

    def insert(self, tokens, n_tokens, blocks=None):
        """Extend the trie with the full blocks of `tokens[:n_tokens]`.
        Returns [(block_id, token_offset)] for the NEW blocks.

        Standalone mode: the caller must copy the corresponding KV rows
        into those pool blocks immediately (before any further cache
        call).  Pager mode: `blocks` is the finishing slot's physical
        block list and new trie nodes ALIAS those blocks (pool refcount
        +1) — insert is zero-copy; a block whose content is already
        cached under a different physical id is deduped, not aliased.
        Either way insertion stops early when the budget is exhausted
        and nothing is evictable."""
        toks = self._blocks_of(tokens)
        bt = self.block_tokens
        full = min(int(n_tokens), toks.size) // bt
        node, path, new = self._root, [], []
        for j in range(full):
            key = toks[j * bt:(j + 1) * bt].tobytes()
            child = node.children.get(key)
            if child is None:
                if self._pager is not None:
                    if not self._budget_one(protect=path):
                        break
                    bid = int(blocks[j])
                    self._pager.incref(bid)
                    self._held += 1
                else:
                    bid = self._alloc(protect=path)
                    if bid is None:
                        break
                child = _Node(key, bid, node)
                node.children[key] = child
                new.append((bid, j * bt))
            child.last_use = self._tick()
            path.append(child)
            node = child
        return new

    def adopt_blocks(self, tokens, n_tokens, bids, first_block=0):
        """Pager mode, KV fabric landing path: graft
        freshly-written pool blocks into the trie.  `bids[i]` holds
        the KV of token block `first_block + i` of `tokens`; each was
        just allocated (pool refcount 1) and populated by a remote
        pull or a disk load, and the trie takes OWNERSHIP of it — no
        extra incref, mirroring how `reclaim`/eviction decref on the
        way out.  Blocks [0, first_block) must already be cached (the
        fabric only pulls past the local match).  Any block that
        cannot be attached (missing interior path, already-cached
        duplicate, budget exhausted with nothing evictable) is
        decref'd back to the pool.  Returns the number of tokens
        newly covered by the trie."""
        if self._pager is None:
            raise RuntimeError("adopt_blocks requires pager mode")
        toks = self._blocks_of(tokens)
        bt = self.block_tokens
        full = min(int(n_tokens), toks.size) // bt
        bids = list(bids)
        node, path = self._root, []
        adopted = 0
        for j in range(min(int(first_block), full)):
            child = node.children.get(toks[j * bt:(j + 1) * bt].tobytes())
            if child is None:       # interior path evicted underneath us
                for bid in bids:
                    self._pager.decref(bid)
                return 0
            path.append(child)
            node = child
        for i, j in enumerate(range(int(first_block), full)):
            if i >= len(bids):
                break
            key = toks[j * bt:(j + 1) * bt].tobytes()
            child = node.children.get(key)
            if child is None:
                if not self._budget_one(protect=path):
                    for bid in bids[i:]:
                        self._pager.decref(bid)
                    return adopted
                child = _Node(key, int(bids[i]), node)
                node.children[key] = child
                self._held += 1
                adopted += bt
            else:
                # someone cached this block while the pull was in
                # flight: keep the incumbent, return the duplicate
                self._pager.decref(int(bids[i]))
            child.last_use = self._tick()
            path.append(child)
            node = child
        return adopted

    def remap_blocks(self, mapping):
        """Pager mode, tiered spill/promote: the pager moved
        physical blocks between tiers under new ids — rewrite every trie
        node naming an old id.  Refcounts already travelled with the
        pager's own `remap_blocks`; this only keeps the trie's view of
        WHERE a cached block lives in sync."""
        if not mapping:
            return
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.block in mapping:
                n.block = int(mapping[n.block])
            stack.extend(n.children.values())

    def drop_block(self, bid):
        """Evict every subtree rooted at a node holding `bid` — the
        block's bytes failed an integrity check and every cached path
        through it is poisoned.  Pinned nodes (in-flight readers) are
        skipped: their requests already attached the block and handle
        the failure through their own repair path.  Returns the number
        of nodes dropped."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.block != bid:
                stack.extend(n.children.values())
                continue
            subtree, grab = [], [n]
            while grab:
                m = grab.pop()
                subtree.append(m)
                grab.extend(m.children.values())
            if any(m.refs for m in subtree):
                continue
            del n.parent.children[n.key]
            for m in subtree:
                self._held -= 1
                self._pager.decref(m.block)
            self.evictions += len(subtree)
            dropped += len(subtree)
        return dropped

    def _budget_one(self, protect=()):
        """Pager mode: make room for one more trie-held block within
        the `n_blocks` budget, evicting an LRU unpinned leaf if
        needed."""
        if self._held < self.n_blocks:
            return True
        bid = self._evict_lru(protect)
        if bid is None:
            return False
        self._held -= 1
        self._pager.decref(bid)
        return True

    def reclaim(self, k):
        """Pager mode, preempt-ladder rung 1: evict unpinned LRU
        leaves until `k` pool blocks have actually returned to the
        engine's free list (a trie block still shared with an active
        slot frees nothing yet).  Returns the number freed."""
        freed = 0
        while freed < int(k):
            bid = self._evict_lru()
            if bid is None:
                break
            self._held -= 1
            if self._pager.refcount(bid) == 1:
                freed += 1
            self._pager.decref(bid)
        return freed

    def _alloc(self, protect=()):
        if self._free:
            return self._free.pop()
        return self._evict_lru(protect)

    def _evict_lru(self, protect=()):
        """Free the least-recently-used evictable block: a LEAF node
        (interior nodes anchor cached paths) with no in-flight readers
        and not on the insert path currently being built."""
        keep = set(map(id, protect))
        victim = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.refs == 0 and id(n) not in keep:
                if victim is None or n.last_use < victim.last_use:
                    victim = n
        if victim is None:
            return None
        del victim.parent.children[victim.key]
        self.evictions += 1
        return victim.block
