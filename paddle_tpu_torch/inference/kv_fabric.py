"""KV integrity for the host tiers: CRC32C (Castagnoli) over numpy
buffers — the port of the checksum half of
`paddle_tpu/inference/kv_fabric.py` (host-only numpy, no torch).

`crc32c(data, crc=0)` is chainable; `leaves_crc(leaves)` chains it over
a list of arrays in order.  The engine's tiered KV pool stamps every
row it spills to the host extension tier and verifies the stamp before
the row is promoted back to the device (`inference/engine.py`).

The rest of the JAX module — the KV fabric's wire format and transfer
verbs, `SessionTicket` and the disk tier — comes with engine sub-slice
(h) (ROADMAP); so does the CRC stamp on parked swap copies.
"""

from __future__ import annotations

import numpy as np

__all__ = ["crc32c", "leaves_crc"]


def _crc32c_table():
    poly = 0x82F63B78           # reflected Castagnoli polynomial
    tbl = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tbl.append(c)
    return tuple(tbl)


_CRC32C_TABLE = _crc32c_table()
_CRC_T0 = np.asarray(_CRC32C_TABLE, np.uint32)


def _crc32c_py(data, crc=0):
    """The original pure-Python table walk (~8 MB/s) — kept as the
    reference the vectorized path is tested and benched against."""
    if not isinstance(data, (bytes, bytearray)):
        data = bytes(data)
    c = (~crc) & 0xFFFFFFFF
    tbl = _CRC32C_TABLE
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return (~c) & 0xFFFFFFFF


def _crc_shift_tables(nbytes):
    """4 x 256 uint32 lookup tables for the linear operator "advance a
    CRC state over `nbytes` zero bytes": shifted = t[0][s & 0xFF] ^
    t[1][(s >> 8) & 0xFF] ^ t[2][(s >> 16) & 0xFF] ^ t[3][s >> 24].
    Built once per power-of-two distance by operator composition
    (S_2D = S_D . S_D) and cached — construction is O(log D) table
    applications, never a byte walk."""
    tabs = _CRC_SHIFT_CACHE.get(nbytes)
    if tabs is not None:
        return tabs
    if nbytes == 1:
        base = np.arange(256, dtype=np.uint32)
        # one zero byte: s -> (s >> 8) ^ T0[s & 0xFF], per state byte
        tabs = []
        for k in range(4):
            s = base << np.uint32(8 * k)
            tabs.append(_CRC_T0[s & np.uint32(0xFF)] ^ (s >> np.uint32(8)))
        tabs = tuple(tabs)
    else:
        half = _crc_shift_tables(nbytes // 2)
        tabs = tuple(_crc_shift_apply(half, t) for t in half)
    _CRC_SHIFT_CACHE[nbytes] = tabs
    return tabs


_CRC_SHIFT_CACHE: dict = {}


def _crc_shift_apply(tabs, s):
    """Apply a 4-table shift operator to uint32 state(s) `s`."""
    s = np.asarray(s, np.uint32)
    return (tabs[0][s & np.uint32(0xFF)]
            ^ tabs[1][(s >> np.uint32(8)) & np.uint32(0xFF)]
            ^ tabs[2][(s >> np.uint32(16)) & np.uint32(0xFF)]
            ^ tabs[3][s >> np.uint32(24)])


def _crc_shift(s, nbytes):
    """Advance CRC state(s) `s` over `nbytes` zero bytes (any count),
    decomposing the distance over cached power-of-two operators."""
    bit = 1
    while nbytes:
        if nbytes & bit:
            s = _crc_shift_apply(_crc_shift_tables(bit), s)
            nbytes ^= bit
        bit <<= 1
    return s


_CRC_WORD = 32                       # bulk stride: 32-byte words
_CRC_PAIR_TABS = None                # 16 x 65536 uint32, built lazily
_CRC_CHUNK = 1 << 16                 # words per cache-friendly batch


def _crc_pair_tables():
    """16 slice tables indexed by a little-endian uint16 byte PAIR:
    ``U[j][v]`` is the raw (zero-state) CRC register after a 32-byte
    word whose bytes are all zero except pair j holding ``v`` — so a
    whole word folds to ``XOR_j U[j][v_j]``, one gather per TWO bytes
    (CRC over one word is linear in its bytes, and leading zeros are a
    fixed point of the zero-state recurrence)."""
    global _CRC_PAIR_TABS
    if _CRC_PAIR_TABS is None:
        v = np.arange(65536, dtype=np.uint32)
        lo, hi = v & np.uint32(0xFF), v >> np.uint32(8)
        s = _CRC_T0[lo]
        s = (s >> np.uint32(8)) ^ _CRC_T0[(s ^ hi) & np.uint32(0xFF)]
        tabs = []
        for j in range(_CRC_WORD // 2):
            trailing = _CRC_WORD - 2 * j - 2
            tabs.append(_crc_shift(s, trailing) if trailing else s.copy())
        _CRC_PAIR_TABS = tabs
    return _CRC_PAIR_TABS


def _crc_word_crcs(pairs):
    """Raw per-word CRCs for a (nw, 16) uint16 pair matrix, gathered
    column-at-a-time over cache-sized batches (the transposed copy
    makes every `np.take` read a contiguous index vector)."""
    tabs = _crc_pair_tables()
    nw, npairs = pairs.shape
    acc = np.empty(nw, np.uint32)
    tmp = np.empty(min(nw, _CRC_CHUNK), np.uint32)
    for st in range(0, nw, _CRC_CHUNK):
        en = min(st + _CRC_CHUNK, nw)
        cols = np.ascontiguousarray(pairs[st:en].T)
        a = np.take(tabs[0], cols[0])
        for j in range(1, npairs):
            t = tmp[:en - st]
            np.take(tabs[j], cols[j], out=t)
            np.bitwise_xor(a, t, out=a)
        acc[st:en] = a
    return acc


def crc32c(data, crc=0):
    """CRC32C of `data`, chainable via `crc` (pass a previous return
    value to extend).  Table-sliced numpy implementation: the buffer
    is cut into 32-byte words whose raw CRCs are computed VECTORIZED
    (16 uint16 slice-table gathers per word — one lookup per byte
    pair), then tree-reduced pairwise with cached shift-by-2^k-byte
    operators.  Spill/prefetch traffic stamps a CRC per moved KV
    block, so this sits on the tiered-pool data path."""
    if not isinstance(data, (bytes, bytearray, memoryview, np.ndarray)):
        data = bytes(data)
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    n = buf.size
    if n < 128:                      # tiny payloads: scalar walk is faster
        c = (~crc) & 0xFFFFFFFF
        tbl = _CRC32C_TABLE
        for b in buf.tobytes():
            c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
        return (~c) & 0xFFFFFFFF
    W = _CRC_WORD
    nw = n // W
    head_len = nw * W
    pairs = buf[:head_len].view("<u2").reshape(nw, W // 2)
    s = _crc_word_crcs(pairs)
    # pairwise tree reduce per power-of-two SEGMENT of the word list
    # (combine(cL, cR) = shift(cL, |R|) ^ cR needs every element at a
    # level to span the same byte count, so nw decomposes into its
    # binary segments, largest first), then the handful of segment
    # CRCs chain left-to-right with exact shifts
    # each segment CRC folds in at its distance from the END of the bulk
    state = np.uint32((~crc) & 0xFFFFFFFF)
    state = _crc_shift(state, head_len)
    off = 0
    for k in range(nw.bit_length() - 1, -1, -1):
        m = 1 << k
        if not nw & m:
            continue
        seg = s[off:off + m]
        span = W
        while seg.size > 1:
            left = _crc_shift_apply(_crc_shift_tables(span), seg[0::2])
            seg = left ^ seg[1::2]
            span *= 2
        state ^= _crc_shift(seg[0], (nw - off - m) * W)
        off += m
    c = int(state)
    tbl = _CRC32C_TABLE
    for b in buf[head_len:].tobytes():
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return (~c) & 0xFFFFFFFF


def leaves_crc(leaves):
    """One chained CRC32C over a flat list of array leaves, in order —
    the host extension tier's integrity tag (the engine stamps a row
    when its device->host copy has landed, and verifies it before the
    row is promoted back into the pool)."""
    c = 0
    for a in leaves:
        c = crc32c(np.ascontiguousarray(a).tobytes(), c)
    return c
