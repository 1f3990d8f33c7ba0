"""TCPStore — the host-side key-value rendezvous of the fleet's control
plane: a copy of the JAX package's `distributed/store.py`, imported by
nothing of it.  The wire bytes, the WAL records and the snapshot file
are that module's, byte for byte, so a client of either package talks
to a master of the other and each package recovers the other's WAL.
The port keeps this store rather than `torch.distributed.TCPStore`:
the WAL, the lease grace and the fencing epochs are this project's own.

The master binds the port and serves; every client sets / gets / adds /
waits under a per-op deadline.  The protocol is a length-prefixed
restricted binary codec over TCP: only None, bools, ints, floats, str,
bytes and list / tuple / dict compounds decode, so a hostile peer on
the port cannot make the master execute anything (as `pickle.loads`
would).  The store carries control metadata only (leases, addresses,
counters), never tensor data.

Resilience:

  * the client RPC path reconnects with exponential backoff + jitter;
    every op runs under an explicit deadline and raises the typed
    `StoreTimeout` on expiry;
  * mutating ops carry a client-unique op id the master deduplicates,
    so a retry after an ambiguous failure (request applied, reply
    lost) applies exactly once: `add` stays a correct barrier and
    generation counter under reconnects;
  * frames are capped at `_MAX_FRAME` bytes in both directions: a
    corrupt or hostile length prefix fails its connection cleanly;
  * `compare_and_set` is the atomic read-modify-write leases and
    fences use;
  * `fence_epoch` / `bump_fence_epoch` keep a job's restart generation
    at ``elastic/<job>/epoch``; `barrier(..., epoch=n)` counts on an
    epoch-scoped key, so a straggler of an earlier generation never
    completes a later barrier.

Durability: `durable_dir=` makes the master survive its own crash.
Every applied mutation is appended to a write-ahead log (records framed
by length and CRC-32 in the store's codec; `wal_fsync=` trades latency
for power-loss safety) before its reply leaves, and the whole map is
snapshotted every `snapshot_every` records (tmp + fsync + rename).  A
restarted master replays snapshot + WAL to recover keys, leases, fence
epochs and the retry-dedup cache, and moves every replica lease's
timestamp forward by the measured outage, so a fast restart fences
nobody.  Clients ride their reconnect path.  `crash()` / `restart()`
expose the failure for drills (a SIGKILL: the listener and every live
connection dropped, nothing flushed beyond what the WAL holds).

Fault sites (`testing/faults.py`): ``store.rpc`` before each client
attempt, ``store.crash`` in the master's handler before an op applies.
"""

from __future__ import annotations

import itertools
import os
import random
import socket
import socketserver
import struct
import threading
import time
import zlib

from ..observability.metrics import get_registry
from ..testing import faults as _faults

__all__ = ["TCPStore", "StoreError", "StoreTimeout"]

# A corrupt (or hostile) length prefix must not drive the receiver into
# a multi-GB allocation: the store carries bootstrap metadata only, so
# 64 MiB is generous by orders of magnitude.
_MAX_FRAME = 64 << 20


class StoreError(RuntimeError):
    """Base class for TCPStore failures (server-side op errors,
    connection loss that outlived every retry)."""


class StoreTimeout(StoreError, TimeoutError):
    """A store op/wait/barrier exceeded its explicit deadline.
    Subclasses TimeoutError so pre-existing callers keep working."""


def _pack(obj, out):
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, int):
        raw = str(obj).encode()
        out.append(b"i" + struct.pack("!I", len(raw)) + raw)
    elif isinstance(obj, float):
        out.append(b"f" + struct.pack("!d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(b"s" + struct.pack("!I", len(raw)) + raw)
    elif isinstance(obj, bytes):
        out.append(b"b" + struct.pack("!I", len(obj)) + obj)
    elif isinstance(obj, (list, tuple)):
        out.append((b"l" if isinstance(obj, list) else b"t")
                   + struct.pack("!I", len(obj)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(b"d" + struct.pack("!I", len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(
            f"TCPStore values must be scalars/str/bytes/list/dict, "
            f"got {type(obj).__name__}")


_MAX_DEPTH = 32  # hostile frames must not drive the decoder into deep recursion


def _take(buf, pos, k):
    if pos + k > len(buf):
        raise ValueError("TCPStore codec: truncated frame")
    return buf[pos:pos + k], pos + k


def _unpack(buf, pos, depth=0):
    if depth > _MAX_DEPTH:
        raise ValueError("TCPStore codec: nesting too deep")
    tag, pos = _take(buf, pos, 1)
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"f":
        raw, pos = _take(buf, pos, 8)
        return struct.unpack("!d", raw)[0], pos
    if tag in (b"i", b"s", b"b"):
        hdr, pos = _take(buf, pos, 4)
        n = struct.unpack("!I", hdr)[0]
        raw, pos = _take(buf, pos, n)
        if tag == b"i":
            return int(raw), pos
        if tag == b"s":
            return raw.decode("utf-8"), pos
        return bytes(raw), pos
    if tag in (b"l", b"t"):
        hdr, pos = _take(buf, pos, 4)
        n = struct.unpack("!I", hdr)[0]
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos, depth + 1)
            items.append(item)
        return (items if tag == b"l" else tuple(items)), pos
    if tag == b"d":
        hdr, pos = _take(buf, pos, 4)
        n = struct.unpack("!I", hdr)[0]
        d = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos, depth + 1)
            v, pos = _unpack(buf, pos, depth + 1)
            d[k] = v
        return d, pos
    raise ValueError(f"TCPStore codec: bad tag {tag!r}")


def _send_msg(sock, obj):
    parts = []
    _pack(obj, parts)
    data = b"".join(parts)
    if len(data) > _MAX_FRAME:
        raise ValueError(
            f"TCPStore codec: frame of {len(data)} bytes exceeds the "
            f"{_MAX_FRAME}-byte cap")
    sock.sendall(struct.pack("!I", len(data)) + data)


def _recv_msg(sock):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("store connection closed")
        hdr += chunk
    n = struct.unpack("!I", hdr)[0]
    if n > _MAX_FRAME:
        # fail the connection cleanly — never allocate what a corrupt
        # or hostile header claims
        raise ValueError(
            f"TCPStore codec: frame header claims {n} bytes "
            f"(cap {_MAX_FRAME})")
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            raise ConnectionError("store connection closed")
        buf += chunk
    obj, end = _unpack(buf, 0)
    if end != n:
        raise ValueError("TCPStore codec: trailing bytes in frame")
    return obj


def _pack_bytes(obj):
    parts = []
    _pack(obj, parts)
    return b"".join(parts)


class _Durable:
    """Write-ahead log + periodic snapshot for the master's KV map.

    WAL record = `!I` payload length, `!I` crc32(payload), payload —
    where payload is a codec-packed tuple ``(seq, t_wall, op, key, val,
    opid, reply)``.  ``seq`` is a monotone apply counter: ``add`` is
    not idempotent, so replay is gated on ``seq > snapshot.seq`` rather
    than on op identity.  Recovery semantics: a torn trailing frame
    ENDS replay (nothing after a partial write can be trusted); a
    CRC-bad record mid-file is SKIPPED (length framing lets us resync
    on the next frame).  Snapshot = codec-packed ``{kv, applied, seq,
    t}`` written tmp + fsync + rename; the WAL is truncated only after
    the rename lands, so a crash between the two replays harmlessly
    (seq-gated)."""

    SNAP = "store.snap"
    WAL = "store.wal"

    def __init__(self, root, fsync=False, snapshot_every=512):
        self.root = root
        self.fsync = bool(fsync)
        self.snapshot_every = int(snapshot_every)
        os.makedirs(root, exist_ok=True)
        self._since_snap = 0
        self._f = open(os.path.join(root, self.WAL), "ab")

    def append(self, seq, op, key, val, opid, reply):
        payload = _pack_bytes((int(seq), time.time(), op, key, val,
                               opid, reply))
        self._f.write(struct.pack("!II", len(payload),
                                  zlib.crc32(payload)) + payload)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._since_snap += 1
        return self._since_snap >= self.snapshot_every

    def snapshot(self, kv, applied, seq):
        path = os.path.join(self.root, self.SNAP)
        tmp = path + ".tmp"
        blob = _pack_bytes({"kv": dict(kv), "applied": dict(applied),
                            "seq": int(seq), "t": time.time()})
        with open(tmp, "wb") as f:
            f.write(struct.pack("!I", zlib.crc32(blob)) + blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # WAL truncation is safe only now: the snapshot covers `seq`,
        # and replay skips records at or below it either way
        self._f.close()
        self._f = open(os.path.join(self.root, self.WAL), "wb")
        if self.fsync:
            os.fsync(self._f.fileno())
        self._since_snap = 0

    def close(self):
        try:
            self._f.close()
        except OSError:
            pass

    @staticmethod
    def recover(root):
        """Replay snapshot+WAL.  Returns ``(kv, applied, seq, last_t,
        stats)`` where ``last_t`` is the wall time of the newest
        surviving record (None if the log is empty) — the restart grace
        window is measured against it."""
        kv, applied, seq, last_t = {}, {}, 0, None
        stats = {"snapshot": False, "wal_records": 0, "wal_skipped": 0,
                 "wal_torn": False}
        snap_path = os.path.join(root, _Durable.SNAP)
        if os.path.exists(snap_path):
            with open(snap_path, "rb") as f:
                raw = f.read()
            if len(raw) >= 4:
                want = struct.unpack("!I", raw[:4])[0]
                if zlib.crc32(raw[4:]) == want:
                    snap, end = _unpack(raw, 4)
                    if end == len(raw):
                        kv = dict(snap["kv"])
                        applied = dict(snap["applied"])
                        seq = int(snap["seq"])
                        last_t = float(snap["t"])
                        stats["snapshot"] = True
        wal_path = os.path.join(root, _Durable.WAL)
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as f:
                raw = f.read()
            pos = 0
            while pos < len(raw):
                if pos + 8 > len(raw):
                    stats["wal_torn"] = True
                    break  # torn header: end of trustworthy log
                n, want = struct.unpack("!II", raw[pos:pos + 8])
                if pos + 8 + n > len(raw):
                    stats["wal_torn"] = True
                    break  # torn body
                payload = raw[pos + 8:pos + 8 + n]
                pos += 8 + n
                if zlib.crc32(payload) != want:
                    stats["wal_skipped"] += 1
                    continue  # corrupt record: skip, resync on framing
                try:
                    rec, end = _unpack(payload, 0)
                except ValueError:
                    stats["wal_skipped"] += 1
                    continue
                if end != n or not isinstance(rec, tuple) or len(rec) != 7:
                    stats["wal_skipped"] += 1
                    continue
                rseq, t, op, key, val, opid, reply = rec
                if rseq <= seq:
                    continue  # already covered by the snapshot
                seq = rseq
                last_t = t
                stats["wal_records"] += 1
                if op == "set":
                    kv[key] = val
                elif op == "add":
                    kv[key] = int(kv.get(key, 0)) + int(val)
                elif op == "cas":
                    expected, desired = val
                    if kv.get(key) == expected:
                        kv[key] = desired
                elif op == "delete":
                    kv.pop(key, None)
                if opid is not None and reply is not None:
                    applied[opid] = (tuple(reply) if isinstance(reply, list)
                                     else reply)
                    while len(applied) > 4096:
                        applied.pop(next(iter(applied)))
        return kv, applied, seq, last_t, stats


def _grace_leases(kv, outage):
    """Shift every replica-lease timestamp forward by the measured
    store outage: a lease that was live when the store died stays live
    after a fast restart — nobody gets fenced for the store's crash.
    Lease values are the ``(ts, ttl, generation)`` 3-tuples written by
    `fleet_serving.ReplicaLease` under ``fleet/<job>/replica/<name>``."""
    if outage <= 0:
        return 0
    graced = 0
    for k, v in list(kv.items()):
        if ("/replica/" in str(k) and isinstance(v, (tuple, list))
                and len(v) == 3
                and isinstance(v[0], (int, float))
                and isinstance(v[1], (int, float))):
            kv[k] = type(v)((float(v[0]) + outage, v[1], v[2]))
            graced += 1
    return graced


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        conns = getattr(self.server, "kv_conns", None)
        if conns is not None:
            conns.add(self.request)

    def finish(self):
        conns = getattr(self.server, "kv_conns", None)
        if conns is not None:
            conns.discard(self.request)

    def handle(self):
        store = self.server.kv
        try:
            while True:
                msg = _recv_msg(self.request)
                if not isinstance(msg, tuple) or len(msg) not in (3, 4):
                    raise ValueError("TCPStore: malformed request tuple")
                op, key, val = msg[0], msg[1], msg[2]
                opid = msg[3] if len(msg) == 4 else None
                try:
                    _faults.fire("store.crash", op=op, key=key)
                except _faults.InjectedFault:
                    # SIGKILL-equivalent: the crash hook tears down the
                    # listener and every live connection.  It runs on
                    # its own thread — shutdown() from a handler thread
                    # would deadlock the serve loop joining itself.
                    hook = getattr(self.server, "kv_crash_hook", None)
                    if hook is not None:
                        threading.Thread(target=hook, daemon=True).start()
                    return
                with self.server.kv_lock:
                    # exactly-once for retried mutations: a client retry
                    # after an ambiguous failure (request applied, reply
                    # lost) replays the recorded reply instead of
                    # re-applying (the `add`-based barrier depends on it)
                    if opid is not None and opid in self.server.kv_applied:
                        _send_msg(self.request,
                                  self.server.kv_applied[opid])
                        continue
                    if op == "set":
                        store[key] = val
                        self.server.kv_event.set()
                        self.server.kv_event.clear()
                        reply = ("ok", None)
                    elif op == "get":
                        reply = ("ok", store.get(key))
                    elif op == "add":
                        store[key] = int(store.get(key, 0)) + int(val)
                        reply = ("ok", store[key])
                    elif op == "cas":
                        expected, desired = val
                        cur = store.get(key)
                        okc = cur == expected
                        if okc:
                            store[key] = desired
                            cur = desired
                        reply = ("ok", (okc, cur))
                    elif op == "delete":
                        existed = key in store
                        store.pop(key, None)
                        reply = ("ok", existed)
                    elif op == "list":
                        reply = ("ok", dict(store))
                    elif op == "ping":
                        reply = ("ok", "pong")
                    else:
                        reply = ("err", f"bad op {op}")
                    if opid is not None and reply[0] == "ok":
                        self.server.kv_applied[opid] = reply
                        while len(self.server.kv_applied) > 4096:
                            self.server.kv_applied.pop(
                                next(iter(self.server.kv_applied)))
                    dur = getattr(self.server, "kv_durable", None)
                    if (dur is not None and reply[0] == "ok"
                            and op in ("set", "add", "cas", "delete")):
                        # log BEFORE the reply leaves: a mutation the
                        # client saw acknowledged is always recoverable
                        self.server.kv_seq += 1
                        want_snap = dur.append(
                            self.server.kv_seq, op, key, val, opid, reply)
                        if want_snap:
                            dur.snapshot(self.server.kv,
                                         self.server.kv_applied,
                                         self.server.kv_seq)
                    _send_msg(self.request, reply)
        except (ConnectionError, OSError, ValueError, UnicodeDecodeError,
                TypeError, struct.error):
            # malformed/hostile frames or a dropped peer fail only THIS
            # connection: the handler returns, its thread exits, and the
            # KV lock (released with the `with` block) stays serviceable
            # for every other client
            pass


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class TCPStore:
    """is_master=True binds and serves; everyone connects as a client.

    `timeout` is the default per-op deadline; every public op also
    accepts an explicit `timeout=` and raises `StoreTimeout` when it
    expires (no unbounded waits on this path).  Transient connection
    loss is retried under the op deadline with exponential backoff +
    jitter; retries of mutating ops are deduplicated server-side.
    `port=0` binds an ephemeral port on the master — read `.port` after
    construction.

    `durable_dir=` (master only) arms the WAL+snapshot layer: applied
    mutations are logged before their reply leaves, and a master
    constructed over a non-empty `durable_dir` recovers the prior
    incarnation's state (`.recovered` carries the replay stats; lease
    timestamps are grace-extended by the measured outage).
    `wal_fsync=True` fsyncs every WAL append; `snapshot_every=` caps
    WAL growth between snapshots."""

    def __init__(self, host="127.0.0.1", port=6170, is_master=False,
                 world_size=1, timeout=120.0, durable_dir=None,
                 wal_fsync=False, snapshot_every=512):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.is_master = bool(is_master)
        self.durable_dir = durable_dir if is_master else None
        self.wal_fsync = bool(wal_fsync)
        self.snapshot_every = int(snapshot_every)
        self.crashed = threading.Event()
        self.recovered = None
        self._server = None
        if is_master:
            self._start_server(port)
        self._sock = None
        self._rpc_lock = threading.Lock()  # one socket, serialized RPCs
        self._opids = itertools.count()
        self._client_id = f"{os.getpid()}-{id(self):x}-{os.urandom(4).hex()}"
        reg = get_registry()
        self._m_reconnects = reg.counter(
            "store_reconnects_total",
            help="TCPStore client reconnects after a dropped socket")
        self._m_retries = reg.counter(
            "store_rpc_retries_total",
            help="TCPStore RPC attempts retried after a transient error")
        self._m_timeouts = reg.counter(
            "store_rpc_timeouts_total",
            help="TCPStore ops that exhausted their deadline")
        self._connect(time.monotonic() + self.timeout)

    # -- master-side serving / durability ----------------------------------

    def _start_server(self, port):
        kv, applied, seq = {}, {}, 0
        dur = None
        if self.durable_dir is not None:
            kv, applied, seq, last_t, stats = _Durable.recover(
                self.durable_dir)
            outage = (max(0.0, time.time() - last_t)
                      if last_t is not None else 0.0)
            graced = _grace_leases(kv, outage)
            self.recovered = dict(stats, keys=len(kv), seq=seq,
                                  outage_s=outage, graced_leases=graced)
            dur = _Durable(self.durable_dir, fsync=self.wal_fsync,
                           snapshot_every=self.snapshot_every)
        srv = _Server((self.host, port), _Handler)
        srv.kv = kv
        srv.kv_lock = threading.RLock()
        srv.kv_event = threading.Event()
        srv.kv_applied = applied
        srv.kv_seq = seq
        srv.kv_durable = dur
        srv.kv_conns = set()
        srv.kv_crash_hook = self.crash
        self._server = srv
        self.port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()

    def crash(self):
        """SIGKILL-equivalent for the serving side (master only): drop
        the listener and every live connection without any graceful
        goodbye.  In-RAM state is abandoned — `restart()` must recover
        from `durable_dir` like a fresh process would.  Clients ride
        their reconnect/backoff path until the restart lands."""
        srv, self._server = self._server, None
        if srv is None:
            return
        self.crashed.set()
        srv.shutdown()
        srv.server_close()
        for conn in list(srv.kv_conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if srv.kv_durable is not None:
            srv.kv_durable.close()

    def restart(self):
        """Bring a crashed master back on the SAME port, recovering
        state from `durable_dir` (RAM state from before the crash is
        deliberately discarded — this models a process restart).
        Returns the recovery stats dict."""
        if self._server is not None:
            raise StoreError("restart() on a live store — crash() first")
        self._start_server(self.port)
        self.crashed.clear()
        return self.recovered

    # -- connection management ---------------------------------------------

    def _connect(self, deadline):
        last = None
        delay = 0.05
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection(
                    (self.host, self.port),
                    timeout=max(0.1, deadline - time.monotonic()))
                self._sock = s
                return
            except OSError as e:
                last = e
                time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
                delay = min(delay * 2, 2.0) * (1.0 + random.random() * 0.25)
        self._m_timeouts.inc()
        raise StoreTimeout(f"cannot reach TCPStore at "
                           f"{self.host}:{self.port}: {last}")

    def _drop_socket(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _rpc(self, op, key=None, val=None, timeout=None):
        """One store op under an explicit deadline.  Connection loss
        (including injected drops) reconnects with exponential backoff
        + jitter and retries; mutating ops carry a dedup id so a retry
        can never double-apply."""
        deadline = time.monotonic() + (self.timeout if timeout is None
                                       else timeout)
        opid = (f"{self._client_id}:{next(self._opids)}"
                if op in ("set", "add", "delete", "cas") else None)
        msg = (op, key, val) if opid is None else (op, key, val, opid)
        delay = 0.02
        attempt = 0
        last = None
        with self._rpc_lock:
            while True:
                try:
                    _faults.fire("store.rpc", op=op, key=key,
                                 attempt=attempt)
                    if self._sock is None:
                        self._connect(deadline)
                        self._m_reconnects.inc()
                    self._sock.settimeout(
                        max(0.1, deadline - time.monotonic()))
                    _send_msg(self._sock, msg)
                    status, out = _recv_msg(self._sock)
                    break
                except (ConnectionError, OSError, socket.timeout) as e:
                    last = e
                    self._drop_socket()
                    attempt += 1
                    if time.monotonic() >= deadline:
                        self._m_timeouts.inc()
                        raise StoreTimeout(
                            f"store op {op!r} on {key!r} exceeded its "
                            f"deadline after {attempt} attempts: "
                            f"{last}") from last
                    self._m_retries.inc()
                    time.sleep(min(delay,
                                   max(0.0,
                                       deadline - time.monotonic())))
                    delay = min(delay * 2, 1.0) * (
                        1.0 + random.random() * 0.25)
        if status != "ok":
            raise StoreError(out)
        return out

    # -- ops ---------------------------------------------------------------

    def set(self, key, value, timeout=None):
        self._rpc("set", key, value, timeout=timeout)

    def get(self, key, timeout=None):
        return self._rpc("get", key, timeout=timeout)

    def add(self, key, amount=1, timeout=None) -> int:
        return self._rpc("add", key, amount, timeout=timeout)

    def compare_and_set(self, key, expected, desired, timeout=None):
        """Atomic read-modify-write: store `desired` iff the current
        value equals `expected` (`None` = key absent).  Returns
        (success, current_value_after_the_op)."""
        ok, cur = self._rpc("cas", key, (expected, desired),
                            timeout=timeout)
        return bool(ok), cur

    def delete_key(self, key, timeout=None) -> bool:
        return self._rpc("delete", key, timeout=timeout)

    def list_keys(self, timeout=None):
        return self._rpc("list", timeout=timeout)

    def ping(self, timeout=None):
        return self._rpc("ping", timeout=timeout)

    def wait(self, keys, timeout=None):
        """Block until all keys exist (ref TCPStore::wait); raises
        StoreTimeout at the deadline."""
        if isinstance(keys, str):
            keys = [keys]
        budget = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            per_op = max(0.1, deadline - time.monotonic())
            if all(self.get(k, timeout=per_op) is not None for k in keys):
                return
            time.sleep(0.05)
        self._m_timeouts.inc()
        raise StoreTimeout(f"timeout waiting for keys {keys}")

    # -- fencing epochs ----------------------------------------------------

    @staticmethod
    def _epoch_key(job_id):
        return f"elastic/{job_id}/epoch"

    def fence_epoch(self, job_id, timeout=None) -> int:
        """Current restart generation of `job_id` (0 before any bump)."""
        return int(self.get(self._epoch_key(job_id), timeout=timeout) or 0)

    def bump_fence_epoch(self, job_id, timeout=None) -> int:
        """Advance the job's fencing epoch (a relaunch does this before
        re-registering): barriers and leases tagged with the old epoch
        can never satisfy post-restart participants."""
        return int(self.add(self._epoch_key(job_id), 1, timeout=timeout))

    def barrier(self, name, world_size, timeout=None, epoch=None):
        """Counter barrier on top of add/wait.  `epoch` scopes the
        counter key to one restart generation — a pre-restart
        straggler's increment lands on a different key and can never
        complete a post-restart barrier."""
        key = (f"__barrier/{name}" if epoch is None
               else f"__barrier/e{int(epoch)}/{name}")
        budget = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + budget
        n = self.add(key, 1, timeout=budget)
        while time.monotonic() < deadline:
            per_op = max(0.1, deadline - time.monotonic())
            if int(self.get(key, timeout=per_op) or 0) >= world_size:
                return
            time.sleep(0.05)
        self._m_timeouts.inc()
        raise StoreTimeout(f"barrier {name} timed out ({n}/{world_size})")

    def close(self):
        if self._sock is not None:
            self._drop_socket()
        if self._server is not None:
            self._server.shutdown()
            # shutdown() only stops the serve loop; without
            # server_close() the listening socket fd leaks
            self._server.server_close()
            if self._server.kv_durable is not None:
                self._server.kv_durable.close()
