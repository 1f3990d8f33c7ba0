"""The KV fabric — the port of `paddle_tpu/inference/kv_fabric.py`: one
wire protocol, three moves, and the integrity layer under them.

  * **Remote prefix pull** — an engine that misses its local radix cache
    but holds a hint that a peer has the prefix opens a length-framed TCP
    pull of the prefix's KV blocks and lands them in its pool in place
    (int8 pools move about half the bytes: the format is dtype-agnostic).
  * **Live session migration** — a parked request's resume state (its KV
    blocks, stream position, sampling and drafter state) travels as a
    :class:`SessionTicket` a peer adopts and continues.
  * **Disk tier** — :class:`DiskTier` persists prefix blocks and parked
    tickets as one file each (tmp + fsync + rename, a manifest replayed
    at boot), so shared prefixes survive restarts and a full host tier
    spills parks to disk before dropping them to recompute.

Wire format (every verb, both directions)::

    4-byte BE header length | JSON header | 8-byte BE payload length
    | raw payload bytes

The payload is the concatenation of leaf buffers described by the
header's ``kv_meta`` (dtype name, shape and CRC32C per leaf), in the
JAX engine's ``tree_leaves`` order of the pool: per layer K then V, each
an int8 (data, scale) pair on an int8 pool.  The bytes, the fingerprint
(`pool_fingerprint`) and the content address (`prefix_block_key`) are
the JAX package's, so either package parses the other's frames,
tickets and disk entries.  bfloat16 leaves travel as raw 2-byte words
under the dtype name ``"bfloat16"``, as the JAX package writes them;
`unpack_leaves` returns them as ``np.uint16`` words (numpy has no
bfloat16, and this module never imports ``ml_dtypes``): reinterpret
them with ``torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)``.

A ticket's ``keys`` hold the request's sampling RNG: the JAX package
writes its threefry key words, the port a sampled request's
`torch.Generator` state as a list of byte values (and, for a greedy
one, the words of the JAX engine's ``PRNGKey(seed)``).  Threefry and
the torch generators cannot agree, so a ticket crosses between the
packages only for a greedy request, whose stream ignores its keys.

Deadlock note: engine-state-touching verbs run on the owning replica's
driver thread (`LLMServer._fabric_exec`).  Two replicas pulling from
each other at the same instant would each block their driver on the
other; the socket timeout breaks the tie and the loser falls back to
recompute — a latency blip, never a hang.

Integrity: every serialized KV movement carries CRC32C checksums — per
leaf in `pack_leaves`' meta, a whole-ticket trailer on `SessionTicket`,
per payload and per manifest record in `DiskTier` — checked at every
unpack / adopt / replay boundary.  A mismatch raises `IntegrityError`
(a `FabricError`, so every fall-back-to-recompute path absorbs it):
corrupted bytes are detected, metered and never served.  The engine's
tiered pool stamps every row it spills to the host extension tier and
each parked host copy with the same CRC (`crc32c`, `leaves_crc`).

Fault sites: ``fabric.pull`` (client side, before a transfer),
``fabric.push`` (server side, before serving one) and ``fabric.disk_io``
(DiskTier, before each read / write).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import struct
import threading

import numpy as np
import torch

from ..observability import tracing as _tr
from ..testing import faults as _faults

__all__ = ["pack_leaves", "unpack_leaves", "pool_fingerprint",
           "prefix_block_key", "SessionTicket", "DiskTier",
           "FabricServer", "fabric_request", "FabricError",
           "IntegrityError", "crc32c", "leaves_crc",
           "dtype_name", "numpy_dtype"]


class FabricError(RuntimeError):
    """A fabric transfer failed or was refused (the caller falls back
    to local recompute: this error never reaches a request)."""


class IntegrityError(FabricError):
    """A payload's checksum disagreed with its bytes: corruption caught
    at a transfer boundary.  A `FabricError`, so every recompute
    fallback absorbs it; callers that can tell meter it
    (``kv_integrity_failures_total{path=...}``)."""


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — vectorized numpy implementation
# ---------------------------------------------------------------------------

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
    """One chained CRC32C over a list of array leaves, in order — the
    host tiers' integrity tag (the engine stamps a parked host copy or an
    extension row once its device->host copy has landed, and verifies it
    before the bytes return to the pool or leave in a ticket)."""
    c = 0
    for a in leaves:
        c = crc32c(np.ascontiguousarray(a).tobytes(), c)
    return c


# ---------------------------------------------------------------------------
# leaf (de)serialization
# ---------------------------------------------------------------------------

def dtype_name(a):
    """The wire name of a leaf's dtype: numpy's name (``"float32"``,
    ``"int8"``, ``"bfloat16"`` for an ml_dtypes array), or a torch
    dtype's without its ``torch.`` prefix."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return str(a.dtype)


def _leaf_bytes(a):
    """A leaf's raw bytes in C order as a flat uint8 array (a view where
    the leaf is contiguous; a torch tensor must be on the host)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def numpy_dtype(name):
    """The numpy dtype a leaf of wire dtype `name` unpacks to:
    ``"bfloat16"`` (which numpy cannot name) as raw ``np.uint16``
    words."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    try:
        return np.dtype(name)
    except TypeError as e:
        raise FabricError(f"unknown leaf dtype {name!r}") from e


def pack_leaves(leaves):
    """Serialize a list of leaves (numpy arrays, or torch tensors on the
    host) -> (meta, payload bytes).  `meta` is JSON-safe (dtype name,
    shape and CRC32C a leaf); the payload is the leaves' raw buffers
    concatenated in order."""
    meta, chunks = [], []
    for a in leaves:
        buf = _leaf_bytes(a)
        meta.append({"dtype": dtype_name(a), "shape": list(a.shape),
                     "crc": crc32c(buf)})
        chunks.append(buf.data)
    return meta, b"".join(chunks)


def unpack_leaves(meta, payload):
    """Inverse of `pack_leaves` -> numpy arrays (bfloat16 leaves as
    uint16 words).  Raises FabricError on any size mismatch (a torn
    payload must never land in a pool) and IntegrityError when a leaf's
    bytes disagree with its CRC32C."""
    out, off = [], 0
    view = memoryview(payload)      # CRC slices without copying them
    for i, m in enumerate(meta):
        dt = numpy_dtype(m["dtype"])
        shape = tuple(int(s) for s in m["shape"])
        n = int(np.prod(shape)) if shape else 1
        nbytes = n * dt.itemsize
        if off + nbytes > len(payload):
            raise FabricError(
                f"payload truncated: leaf {m} needs {nbytes} bytes at "
                f"offset {off}, have {len(payload)}")
        want = m.get("crc")
        if want is not None \
                and crc32c(view[off:off + nbytes]) != int(want):
            raise IntegrityError(
                f"leaf {i} checksum mismatch ({nbytes} bytes at "
                f"offset {off}): payload corrupted in flight or at rest")
        arr = np.frombuffer(payload, dt, count=n, offset=off)
        out.append(arr.reshape(shape))
        off += nbytes
    if off != len(payload):
        raise FabricError(
            f"payload overrun: {len(payload) - off} trailing bytes")
    return out


def pool_fingerprint(leaves, block_tokens):
    """Compatibility guard of every transfer: the block geometry and
    each pool leaf's dtype name and per-block shape.  Two engines agree
    iff their blocks are bit-interchangeable (the JAX engine's hash at
    the same config)."""
    sig = [int(block_tokens)]
    for a in leaves:
        sig.append([dtype_name(a), list(a.shape[1:])])
    return hashlib.sha1(
        json.dumps(sig, sort_keys=True).encode()).hexdigest()


def prefix_block_key(tokens, block_idx, block_tokens, fingerprint):
    """Content address of one cached prefix block: a block's KV depends
    on its ENTIRE preceding prefix, so the key hashes
    tokens[: (block_idx + 1) * block_tokens] (int32) and the pool
    fingerprint."""
    toks = np.asarray(tokens, np.int32)
    end = (int(block_idx) + 1) * int(block_tokens)
    h = hashlib.sha1(fingerprint.encode())
    h.update(toks[:end].tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

_MAX_HEADER = 16 << 20          # headers carry token lists
_MAX_PAYLOAD = 8 << 30


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise FabricError("fabric peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def send_frame(sock, header, payload=b""):
    hb = json.dumps(header).encode()
    sock.sendall(struct.pack(">I", len(hb)) + hb
                 + struct.pack(">Q", len(payload)))
    if payload:
        sock.sendall(payload)


def recv_frame(sock):
    (hlen,) = struct.unpack(">I", _recv_exact(sock, 4))
    if hlen > _MAX_HEADER:
        raise FabricError(f"oversized fabric header ({hlen} bytes)")
    header = json.loads(_recv_exact(sock, hlen).decode())
    (plen,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if plen > _MAX_PAYLOAD:
        raise FabricError(f"oversized fabric payload ({plen} bytes)")
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


def fabric_request(addr, header, payload=b"", timeout=30.0):
    """One round trip to a peer's FabricServer: connect, send one frame,
    read one reply frame.  Raises FabricError (or OSError) on any
    transport failure or refusal; callers treat both as "fall back".
    The span carries the header's ``trace_id`` when it has one."""
    t0 = _tr.t0()
    tid = header.get("trace_id")
    verb = header.get("verb")
    try:
        with socket.create_connection(
                (addr[0], int(addr[1])), timeout=timeout) as s:
            s.settimeout(timeout)
            send_frame(s, header, payload)
            reply, data = recv_frame(s)
    except socket.timeout as e:
        _tr.end(f"fabric/{verb}", t0, trace_id=tid, error=True,
                args={"addr": list(addr)})
        raise FabricError(f"fabric request to {addr} timed out") from e
    _tr.end(f"fabric/{verb}", t0, trace_id=tid,
            args={"addr": list(addr), "ok": bool(reply.get("ok", False)),
                  "bytes": len(data)})
    if not reply.get("ok", False):
        raise FabricError(
            f"peer {addr} refused {verb!r}: "
            f"{reply.get('error', 'unknown')}")
    return reply, data


# ---------------------------------------------------------------------------
# session tickets
# ---------------------------------------------------------------------------

class SessionTicket:
    """A parked request, portable: everything a peer engine needs to
    continue the stream.  A JSON head (identity, sampling parameters,
    stream position, RNG state in `keys`, drafter state, pool
    fingerprint) and the packed KV blocks (empty for a recompute-mode
    park: the adopter re-prefills).  The head fields are the JAX
    package's exactly: its `from_bytes` refuses unknown ones."""

    _HEAD_FIELDS = ("session_id", "prompt", "tokens", "max_new_tokens",
                    "temperature", "top_p", "greedy", "eos_token_id",
                    "seed", "mode", "token", "pos", "keys", "spec_k",
                    "spec_ema", "n_blocks", "fingerprint", "t_export")

    def __init__(self, **kw):
        for f in self._HEAD_FIELDS:
            setattr(self, f, kw.pop(f))
        self.kv_meta = kw.pop("kv_meta", [])
        self.kv_payload = kw.pop("kv_payload", b"")
        # the tiered pool's map: table indices that were in the host
        # extension tier at park time (optional: older tickets parse)
        self.cold_idx = [int(j) for j in kw.pop("cold_idx", [])]
        if kw:
            raise TypeError(f"unknown ticket fields {sorted(kw)}")

    def to_bytes(self):
        head = {f: getattr(self, f) for f in self._HEAD_FIELDS}
        head["kv_meta"] = self.kv_meta
        head["cold_idx"] = self.cold_idx
        hb = json.dumps(head).encode()
        body = (struct.pack(">I", len(hb)) + hb
                + struct.pack(">Q", len(self.kv_payload))
                + self.kv_payload)
        # whole-ticket CRC32C trailer, checked at every parse
        return body + struct.pack(">I", crc32c(body))

    @classmethod
    def from_bytes(cls, data):
        if len(data) < 16:
            raise FabricError("truncated session ticket")
        (hlen,) = struct.unpack(">I", data[:4])
        if 4 + hlen + 8 + 4 > len(data):
            raise FabricError("truncated session ticket header")
        (plen,) = struct.unpack(">Q", data[4 + hlen:12 + hlen])
        if 12 + hlen + plen + 4 != len(data):
            raise FabricError("truncated session ticket payload")
        (want,) = struct.unpack(">I", data[-4:])
        if crc32c(memoryview(data)[:-4]) != want:
            raise IntegrityError(
                "session ticket checksum mismatch: ticket corrupted "
                "in flight or at rest")
        head = json.loads(data[4:4 + hlen].decode())
        payload = data[12 + hlen:12 + hlen + plen]
        meta = head.pop("kv_meta", [])
        return cls(kv_meta=meta, kv_payload=payload, **head)


# ---------------------------------------------------------------------------
# disk tier
# ---------------------------------------------------------------------------

class DiskTier:
    """SSD spill / persist layer under the host tier, one root, two
    areas:

      * ``blocks/`` — content-addressed prefix blocks (one file a block,
        named by `prefix_block_key`), committed tmp + fsync + rename and
        recorded in an append-only ``manifest.jsonl`` (fsynced a
        record).  Boot replays the manifest, drops records whose file is
        missing or of another size (a torn write) and deletes stray
        ``*.tmp`` files of a crashed writer.
      * ``sessions/`` — parked-session tickets by session id.
        `claim_session` takes one with an atomic rename, so exactly one
        adopter (the local resume or a peer) continues a stream.

    `capacity_bytes` bounds the blocks area: crossing it evicts the
    least recently used blocks (a `get_block` hit refreshes recency),
    each with an ``{"evict": key}`` manifest record.  Tickets are outside
    the bound: a parked request's only copy of its KV is never evicted.

    Each manifest record carries a CRC32C of its canonical JSON
    (``"c"``) and each block record one of its payload (``"crc"``): a
    flipped record is skipped at replay, a flipped block dropped at
    read; both count in `integrity_failures` and degrade to
    recompute."""

    def __init__(self, root, capacity_bytes=None):
        self.root = str(root)
        self._blocks_dir = os.path.join(self.root, "blocks")
        self._sess_dir = os.path.join(self.root, "sessions")
        os.makedirs(self._blocks_dir, exist_ok=True)
        os.makedirs(self._sess_dir, exist_ok=True)
        self._manifest_path = os.path.join(self.root, "manifest.jsonl")
        self._capacity = (None if capacity_bytes is None
                          else int(capacity_bytes))
        self._lock = threading.Lock()
        self._index: dict[str, dict] = {}    # insertion order == LRU
        self.bytes_used = 0
        self.torn_skipped = 0       # torn blocks dropped (boot or read)
        self.evictions = 0          # capacity evictions (blocks only)
        self.integrity_failures = {"disk": 0, "manifest": 0}
        self._replay()

    # -- boot --------------------------------------------------------------

    @staticmethod
    def _rec_crc(rec):
        """CRC32C of a manifest record's canonical JSON (without its
        own ``"c"``)."""
        return crc32c(json.dumps(rec, sort_keys=True).encode())

    def _append_manifest_locked(self, rec):
        rec = dict(rec)
        rec["c"] = self._rec_crc(rec)
        with open(self._manifest_path, "ab") as f:
            f.write(json.dumps(rec, sort_keys=True).encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())

    def _replay(self):
        for d in (self._blocks_dir, self._sess_dir):
            for fn in os.listdir(d):
                if fn.endswith(".tmp"):
                    try:
                        os.unlink(os.path.join(d, fn))
                    except OSError:
                        pass
        if not os.path.exists(self._manifest_path):
            return
        with open(self._manifest_path, "rb") as f:
            for line in f:
                try:
                    rec = json.loads(line.decode())
                except (ValueError, UnicodeDecodeError):
                    break               # torn tail of a crashed append
                want = rec.pop("c", None)
                if want is not None and self._rec_crc(rec) != int(want):
                    # a flipped record that still parses: only its
                    # checksum tells, so trust nothing it claims
                    self.integrity_failures["manifest"] += 1
                    continue
                ev = rec.get("evict")
                if ev:
                    old = self._index.pop(ev, None)
                    if old is not None:
                        self.bytes_used -= old["size"]
                    continue
                key = rec.get("key")
                if not key:
                    continue
                path = os.path.join(self._blocks_dir, key)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue            # published record, missing file
                if size != int(rec.get("size", -1)):
                    self.torn_skipped += 1
                    continue
                self._index[key] = {"size": size,
                                    "meta": rec.get("meta", {}),
                                    "crc": rec.get("crc")}
        self.bytes_used = sum(r["size"] for r in self._index.values())

    # -- prefix blocks -----------------------------------------------------

    def has_block(self, key):
        with self._lock:
            return key in self._index

    def put_block(self, key, meta, payload):
        """Commit one prefix block: tmp + fsync + rename, then an
        fsynced manifest record.  Idempotent per key; crossing
        `capacity_bytes` evicts LRU blocks (never tickets)."""
        _faults.fire("fabric.disk_io", op="write", key=key)
        with self._lock:
            if key in self._index:
                return False
        path = os.path.join(self._blocks_dir, key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        pcrc = crc32c(payload)
        rec = {"key": key, "size": len(payload), "meta": meta,
               "crc": pcrc}
        with self._lock:
            self._append_manifest_locked(rec)
            self._index[key] = {"size": len(payload), "meta": meta,
                                "crc": pcrc}
            self.bytes_used += len(payload)
            self._evict_lru_locked(keep=key)
        return True

    def _evict_lru_locked(self, keep=None):
        """Evict LRU blocks until under capacity (the caller holds the
        lock); `keep`, the block being committed, is never evicted."""
        if self._capacity is None:
            return
        while self.bytes_used > self._capacity:
            victim = next((k for k in self._index if k != keep), None)
            if victim is None:
                break
            rec = self._index.pop(victim)
            self.bytes_used -= rec["size"]
            self.evictions += 1
            try:
                os.unlink(os.path.join(self._blocks_dir, victim))
            except OSError:
                pass
            self._append_manifest_locked({"evict": victim})

    def get_block(self, key):
        """One committed block -> (meta, payload), or None.  A size
        mismatch (torn) or a payload-CRC mismatch (flipped at rest)
        drops the entry and returns None: the caller recomputes.  A hit
        refreshes LRU recency."""
        _faults.fire("fabric.disk_io", op="read", key=key)
        with self._lock:
            rec = self._index.get(key)
            if rec is not None:
                self._index[key] = self._index.pop(key)   # LRU bump
        if rec is None:
            return None
        try:
            with open(os.path.join(self._blocks_dir, key), "rb") as f:
                payload = f.read()
        except OSError:
            payload = None
        if payload is None or len(payload) != rec["size"]:
            with self._lock:
                if self._index.pop(key, None) is not None:
                    self.bytes_used -= rec["size"]
                self.torn_skipped += 1
            return None
        if rec.get("crc") is not None \
                and crc32c(payload) != int(rec["crc"]):
            with self._lock:
                if self._index.pop(key, None) is not None:
                    self.bytes_used -= rec["size"]
                self.integrity_failures["disk"] += 1
            try:
                os.unlink(os.path.join(self._blocks_dir, key))
            except OSError:
                pass
            return None
        return rec["meta"], payload

    @property
    def n_blocks(self):
        with self._lock:
            return len(self._index)

    # -- session tickets ---------------------------------------------------

    def _sess_path(self, sid):
        safe = hashlib.sha1(str(sid).encode()).hexdigest()
        return os.path.join(self._sess_dir, safe + ".ticket")

    def put_session(self, sid, data):
        _faults.fire("fabric.disk_io", op="write", key=str(sid))
        path = self._sess_path(sid)
        tmp = path + f".{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def claim_session(self, sid):
        """Atomically take a session ticket (the rename arbitrates:
        exactly one claimant wins).  The ticket's bytes, or None when it
        is absent or already claimed."""
        _faults.fire("fabric.disk_io", op="read", key=str(sid))
        path = self._sess_path(sid)
        claimed = path + f".{os.getpid()}.claimed"
        try:
            os.rename(path, claimed)
        except OSError:
            return None
        try:
            with open(claimed, "rb") as f:
                data = f.read()
        finally:
            try:
                os.unlink(claimed)
            except OSError:
                pass
        return data

    def drop_session(self, sid):
        try:
            os.unlink(self._sess_path(sid))
        except OSError:
            pass

    def has_session(self, sid):
        return os.path.exists(self._sess_path(sid))

    def list_sessions(self):
        return [fn[:-len(".ticket")] for fn in os.listdir(self._sess_dir)
                if fn.endswith(".ticket")]


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class FabricServer:
    """Length-framed TCP endpoint serving a replica's KV to peers.

    ``handler(verb, header, payload) -> (reply_header, payload)`` is the
    engine's `fabric_handler`; ``executor(fn, verb)`` runs it: the
    identity executor for engine-only use, or the serving driver's job
    queue so engine state is touched only on the driver thread (the
    handoff rx verbs, host memory only, run on the connection thread).
    One thread a connection; a handler error becomes an ``{"ok":
    False}`` reply, never a socket dropped mid-frame.  These threads
    move bytes and never touch the card."""

    def __init__(self, handler, executor=None, host="127.0.0.1",
                 port=0, conn_timeout=30.0):
        self._handler = handler
        self._executor = executor if executor is not None \
            else (lambda fn, verb=None: fn())
        self._conn_timeout = float(conn_timeout)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.address = self._sock.getsockname()
        self._closing = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="kv-fabric-accept",
            daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _peer = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="kv-fabric-conn", daemon=True)
            t.start()

    def _serve_conn(self, conn):
        conn.settimeout(self._conn_timeout)
        try:
            while not self._closing:
                try:
                    header, payload = recv_frame(conn)
                except (FabricError, OSError, ValueError):
                    return
                verb = header.get("verb")
                try:
                    reply, data = self._executor(
                        lambda: self._handler(verb, header, payload),
                        verb)
                except Exception as e:     # noqa: BLE001 — a wire reply
                    reply, data = ({"ok": False,
                                    "error": f"{type(e).__name__}: {e}"},
                                   b"")
                try:
                    send_frame(conn, reply, data)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._closing = True
        try:
            # unblock accept() on every platform before closing
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5)
