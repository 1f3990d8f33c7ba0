"""The port's radix prefix cache (paddle_tpu_torch/inference/
prefix_cache.py, a copy of the JAX package's): the eleven cases of
tests/test_prefix_cache.py run on the port's `RadixPrefixCache` and
`KVPager` — block-aligned longest-prefix match, the one-row-left cap,
refcount pinning, leaf-only LRU eviction, pool pressure — and a
differential test: one seeded sequence of match / acquire / insert /
release / reclaim on the port's trie and on the JAX package's, each over
its own package's pager, gives the same returns, counters and block
sets.  All host state, no device."""

import numpy as np
import pytest

from paddle_tpu_torch.inference.kv_pager import KVPager
from paddle_tpu_torch.inference.prefix_cache import RadixPrefixCache


def _toks(*vals):
    return np.asarray(vals, np.int32)


def seq(n, base=0):
    return np.arange(base, base + n, dtype=np.int32)


def test_match_empty_and_insert_roundtrip():
    c = RadixPrefixCache(n_blocks=8, block_tokens=4)
    p = seq(13)
    matched, bids, nodes = c.match(p)
    assert matched == 0 and bids == [] and nodes == []
    assert c.misses == 1
    new = c.insert(p, p.size)                 # 13 // 4 = 3 full blocks
    assert [off for _, off in new] == [0, 4, 8]
    assert c.blocks_used == 3
    matched, bids, nodes = c.match(p)
    assert matched == 12                      # capped at full blocks
    assert bids == [b for b, _ in new]
    assert c.hits == 1 and c.tokens_saved == 12


def test_match_capped_below_full_prompt():
    """At least one row must remain to prefill: a prompt whose every
    token is cached still matches only len-1 worth of blocks."""
    c = RadixPrefixCache(8, 4)
    p = seq(8)
    c.insert(p, p.size)                       # blocks [0:4), [4:8)
    matched, bids, _ = c.match(p)
    assert matched == 4 and len(bids) == 1    # (8-1)//4 = 1 block
    longer = seq(9)
    matched, bids, _ = c.match(longer)
    assert matched == 8 and len(bids) == 2    # now both blocks usable


def test_divergent_suffixes_share_prefix():
    c = RadixPrefixCache(8, 4)
    a = np.concatenate([seq(8), _toks(100, 101, 102, 103)])
    b = np.concatenate([seq(8), _toks(200, 201, 202, 203)])
    c.insert(a, a.size)
    assert c.blocks_used == 3
    new = c.insert(b, b.size)
    assert len(new) == 1 and new[0][1] == 8   # only the divergent block
    assert c.blocks_used == 4
    m_a, _, _ = c.match(np.concatenate([a, _toks(1)]))
    m_b, _, _ = c.match(np.concatenate([b, _toks(1)]))
    assert m_a == 12 and m_b == 12


def test_partial_block_not_inserted():
    c = RadixPrefixCache(8, 4)
    c.insert(seq(6), 6)                       # one full block only
    assert c.blocks_used == 1
    matched, _, _ = c.match(seq(7))
    assert matched == 4


def test_refcount_blocks_eviction():
    c = RadixPrefixCache(2, 4)
    a, b = seq(4), seq(4, base=50)
    c.insert(a, 4)
    c.insert(b, 4)
    assert c.blocks_used == 2 and not c._free
    _, _, nodes_a = c.match(np.concatenate([a, _toks(9)]))
    c.acquire(nodes_a)
    # pool full; inserting a third prefix must evict the UNPINNED lru
    new = c.insert(seq(4, base=90), 4)
    assert len(new) == 1 and c.evictions == 1
    assert c.match(np.concatenate([a, _toks(9)]))[0] == 4   # a survived
    assert c.match(np.concatenate([b, _toks(9)]))[0] == 0   # b evicted
    c.release(nodes_a)
    with pytest.raises(RuntimeError):
        c.release(nodes_a)                    # underflow guarded


def test_everything_pinned_insert_degrades():
    c = RadixPrefixCache(1, 4)
    a = seq(4)
    c.insert(a, 4)
    _, _, nodes = c.match(np.concatenate([a, _toks(9)]))
    c.acquire(nodes)
    assert c.insert(seq(4, base=70), 4) == []   # nothing evictable
    c.release(nodes)
    assert len(c.insert(seq(4, base=70), 4)) == 1
    assert c.evictions == 1


def test_leaf_only_eviction_keeps_paths_intact():
    """Interior nodes anchor cached paths: under pressure the LRU LEAF
    goes first, never a block in the middle of a longer cached chain."""
    c = RadixPrefixCache(3, 4)
    chain = seq(12)
    c.insert(chain, 12)                       # 3 chained blocks
    assert c.blocks_used == 3
    c.match(np.concatenate([chain, _toks(1)]))  # chain is recent
    new = c.insert(seq(4, base=80), 4)          # needs one block
    assert len(new) == 1 and c.evictions == 1
    # the chain lost only its TAIL block; prefix [0:8) still matches
    m, _, _ = c.match(np.concatenate([chain, _toks(1)]))
    assert m == 8


def test_lru_order():
    c = RadixPrefixCache(2, 4)
    a, b = seq(4), seq(4, base=50)
    c.insert(a, 4)
    c.insert(b, 4)
    c.match(np.concatenate([a, _toks(9)]))    # a most-recent
    c.insert(seq(4, base=90), 4)              # evicts b, the LRU
    assert c.match(np.concatenate([a, _toks(9)]))[0] == 4
    assert c.match(np.concatenate([b, _toks(9)]))[0] == 0


def test_insert_path_protected_from_self_eviction():
    """A multi-block insert under pool pressure must not evict its own
    just-created parent blocks to feed later ones."""
    c = RadixPrefixCache(2, 4)
    new = c.insert(seq(12), 12)               # wants 3, pool holds 2
    assert [off for _, off in new] == [0, 4]
    m, _, _ = c.match(np.concatenate([seq(12), _toks(1)]))
    assert m == 8                             # the built prefix is intact


def test_acquired_match_survives_reclaim():
    """The engine pins a matched path (acquire) BEFORE running the
    allocator's cache-reclaim rung: a pinned leaf must be invisible to
    reclaim(), so its pool block can never be freed and re-issued to
    the very slot that matched it (the stale-alias race)."""
    pager = KVPager(n_blocks=4, block_tokens=4, n_slots=2, max_blocks=4)
    c = RadixPrefixCache(3, 4, pager=pager)
    a = seq(4)
    blocks = pager.alloc(1)                   # the finishing slot's block
    c.insert(a, 4, blocks=blocks)             # trie aliases it (ref 2)
    pager.decref(blocks[0])                   # slot leaves: trie-only ref
    assert pager.refcount(blocks[0]) == 1
    matched, bids, nodes = c.match(np.concatenate([a, _toks(9)]))
    assert matched == 4 and bids == blocks
    c.acquire(nodes)                          # admission pin, pre-alloc
    # shortage: reclaim must NOT evict the pinned leaf...
    assert c.reclaim(3) == 0
    assert pager.refcount(bids[0]) == 1
    # ...so a subsequent alloc can never hand its block back out
    got = pager.alloc(pager.free_blocks)
    assert bids[0] not in got
    c.release(nodes)
    assert c.reclaim(1) == 1                  # unpinned: reclaimable again


def test_validation():
    with pytest.raises(ValueError):
        RadixPrefixCache(0, 4)
    with pytest.raises(ValueError):
        RadixPrefixCache(4, 0)


def _drive(cache_cls, pager_cls, seed, steps=400):
    """A seeded workload over a pager-mode trie: admissions match and
    pin a prefix, alias it, allocate the rest, and later finish (insert
    the prompt's full blocks, then unpin and drop the slot's blocks);
    the allocator reclaims cache blocks on a shortage, as the engine's
    first ladder rung does.  Returns everything observable, step by
    step."""
    bt = 4
    pager = pager_cls(n_blocks=14, block_tokens=bt, n_slots=4,
                      max_blocks=8)
    cache = cache_cls(10, bt, pager=pager)
    rng = np.random.RandomState(seed)
    stems = [rng.randint(0, 50, 24) for _ in range(3)]
    live, trace = [], []

    def alloc(k):
        got = pager.alloc(k)
        if got is None:
            freed = cache.reclaim(k - pager.free_blocks)
            trace.append(("reclaim", freed))
            got = pager.alloc(k)
        return got

    for _ in range(steps):
        if live and (len(live) == 4 or rng.rand() < 0.45):
            prompt, n, nodes, blocks = live.pop(rng.randint(len(live)))
            if rng.rand() < 0.8:
                new = cache.insert(prompt, n, blocks=blocks)
                trace.append(("insert", [tuple(map(int, x)) for x in new]))
            cache.release(nodes)
            for b in blocks:
                pager.decref(b)
        elif rng.rand() < 0.1:
            trace.append(("reclaim", cache.reclaim(int(rng.randint(1, 4)))))
        else:
            stem = stems[rng.randint(len(stems))]
            n = int(rng.randint(5, 24))
            prompt = np.concatenate([stem[:int(rng.randint(0, n))],
                                     rng.randint(0, 50, 24)])[:n]
            matched, bids, nodes = cache.match(prompt)
            cache.acquire(nodes)
            got = alloc(-(-(n + 1) // bt) - len(bids))
            trace.append(("match", matched, list(map(int, bids)),
                          got is not None))
            if got is None:
                cache.release(nodes)
                cache.match_undo(matched)
                continue
            for b in bids:
                pager.incref(b)
            live.append((prompt, n, nodes, list(map(int, bids)) + got))
        trace.append(("state", cache.hits, cache.misses, cache.evictions,
                      cache.tokens_saved, cache.blocks_used,
                      sorted(int(x.block) for x in cache.nodes()),
                      sorted(int(x.refs) for x in cache.nodes()),
                      pager.free_blocks, pager.used_blocks))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_differential_vs_jax_trie(seed):
    pytest.importorskip("jax")
    from paddle_tpu.inference.kv_pager import KVPager as JPager
    from paddle_tpu.inference.prefix_cache import RadixPrefixCache as JCache
    port = _drive(RadixPrefixCache, KVPager, seed)
    ref = _drive(JCache, JPager, seed)
    kinds = {t[0] for t in port}
    assert {"match", "insert", "reclaim", "state"} <= kinds
    assert any(t[0] == "match" and t[1] > 0 for t in port)    # hits
    assert any(t[0] == "match" and not t[3] for t in port)    # shortages
    assert port == ref
