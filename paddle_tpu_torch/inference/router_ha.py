"""Hot-standby router failover — the port of the JAX package's
`inference/router_ha.py`, host only: its journal stream frames
(``reset`` / ``line``), store keys, gateway verbs and fault sites are
the JAX module's, so a tailer of either package follows a stream
server of the other.

The router is the control plane's single point of failure: its journal
makes a *restart* lossless (`resubmit_incomplete`), but a restart
still costs a full process boot plus journal replay from disk —
seconds of dead air.  This module keeps a warm successor:

  * `JournalStreamServer` fans the primary's `RoutingJournal` out to
    followers over a length-framed socket — one atomic full-file
    snapshot at connect (``reset``), then every appended record in
    write order (``line``), so a follower's shadow journal is always a
    byte-exact prefix-consistent copy;
  * `JournalTailer` maintains that shadow file on the standby.  Its
    failure contract is the ``journal.tail`` fault site: a torn frame
    drops the connection and the reconnect resyncs from a fresh
    snapshot — the shadow is never left half-applied;
  * leadership is an epoch-fenced store lease under the reserved
    replica name `fleet_serving.ROUTER_LEADER`: the lease GENERATION
    is the router epoch, every dispatch carries it, and
    `LLMServer.submit` rejects epochs below its high-water mark
    (`StaleRouterEpoch`) — a deposed primary that is merely wedged,
    not dead, cannot double-dispatch behind its successor's back;
  * `StandbyRouter.promote()` fences the dead leader's generation,
    registers the next one (epoch bump), attaches the fleet, and
    `resubmit_incomplete()`s the shadow journal — every accepted-but-
    unfinished request continues with its delivered prefix deduped,
    so client streams stay exactly-once and token-for-token the same;
  * replicas in `ha` mode (`ProcessFleet(ha=True)`) discover the
    leader's `ReplicaAcceptor` through the store and re-hello to every
    new leader, so promotion needs no replica restarts and fences no
    replicas;
  * `ClientGateway`/`FleetClient` are the client-side shim: submit and
    result re-resolve the advertised gateway endpoint and retry across
    the promotion gap, following the request under its successor rid.

The ``router.crash`` fault site (fired from the primary's HA loop)
gives chaos drills an in-process SIGKILL-equivalent: `HARouter.crash`
stops the lease heartbeat *without* releasing the key — the standby
must detect expiry, exactly as with a real dead process.  Nothing here
makes a CUDA call: the routers, the stream and the gateway move host
bytes.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import tempfile
import threading
import time

from ..testing import faults as _faults
from .fleet_serving import (ROUTER_LEADER, ReplicaLease, _lease_key,
                            fence_replica, fenced_generation,
                            publish_router_endpoint, router_endpoint)
from .kv_fabric import FabricError, fabric_request, recv_frame, send_frame
from .process_fleet import (ProcessReplica, _decode_error, _encode_error,
                            _LineChannel)
from .router import Router, RoutingJournal

__all__ = ["HARouter", "StandbyRouter", "JournalStreamServer",
           "JournalTailer", "ReplicaAcceptor", "ClientGateway",
           "FleetClient"]


def _close_listener(srv):
    """Close a listening socket so that it accepts nobody afterwards.
    A close from another thread does not wake an ``accept()`` already
    blocked on the socket, and that call would go on handing out
    connections to a closed endpoint — a crashed leader's journal
    stream snapshotting records written after its crash, its acceptor
    taking back the replicas it just severed.  ``shutdown`` wakes the
    blocked call first (EINVAL on Linux)."""
    try:
        srv.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        srv.close()
    except OSError:
        pass


# ---------------------------------------------------------------------------
# journal streaming
# ---------------------------------------------------------------------------

class JournalStreamServer:
    """Fan the primary's routing journal out to followers.  Each client
    gets one ``reset`` frame carrying an atomic snapshot of the file,
    then a ``line`` frame per appended record; after a compaction
    rewrites the file, a fresh ``reset`` re-bases every follower.
    Frames use the KV-fabric length-framed wire (header JSON +
    payload), so a torn stream is detected by framing, never replayed
    half-parsed."""

    def __init__(self, journal, host="127.0.0.1", port=0):
        self._journal = journal
        self._closing = threading.Event()
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port)))
        self._srv.listen(8)
        self.address = self._srv.getsockname()
        self._conns = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="journal-stream-accept")
        self._thread.start()

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            if self._closing.is_set():
                conn.close()
                return
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_client, args=(conn,),
                             daemon=True,
                             name="journal-stream-client").start()

    def _serve_client(self, conn):
        q: queue.Queue = queue.Queue()

        def fn(kind, data):
            q.put((kind, data))

        snap = self._journal.subscribe_with_snapshot(fn)
        try:
            send_frame(conn, {"kind": "reset"}, snap.encode())
            while not self._closing.is_set():
                try:
                    kind, data = q.get(timeout=0.25)
                except queue.Empty:
                    continue
                send_frame(conn, {"kind": kind}, data.encode())
        except OSError:
            pass                    # follower gone: its problem
        finally:
            self._journal.unsubscribe(fn)
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._closing.set()
        _close_listener(self._srv)
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class JournalTailer:
    """Maintain a shadow copy of the leader's journal on the standby.

    Reconnects forever (the advertised ``journal`` endpoint is re-read
    from the store each attempt, so it follows leadership changes), and
    every frame passes the ``journal.tail`` fault site first: a tripped
    frame drops the connection, and the reconnect's ``reset`` snapshot
    resyncs the shadow wholesale — the recovery path IS the normal
    connect path, so chaos cannot find a half-applied state."""

    def __init__(self, store, job_id, shadow_path=None,
                 reconnect_s=0.25):
        self._store = store
        self._job = job_id
        if shadow_path is None:
            fd, shadow_path = tempfile.mkstemp(
                prefix="router_shadow_", suffix=".jsonl")
            os.close(fd)
        self.shadow_path = str(shadow_path)
        self._reconnect_s = float(reconnect_s)
        self._stop = threading.Event()
        self._sock = None
        self.lines = 0
        self.resets = 0
        self.reconnects = 0
        self._f = open(self.shadow_path, "a", encoding="utf-8")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"journal-tail-{job_id}")
        self._thread.start()

    def _apply_reset(self, text):
        """Replace the shadow atomically (tmp + fsync + rename): a
        crash mid-reset leaves the previous consistent shadow."""
        tmp = self.shadow_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as out:
            out.write(text)
            out.flush()
            os.fsync(out.fileno())
        self._f.close()
        os.replace(tmp, self.shadow_path)
        self._f = open(self.shadow_path, "a", encoding="utf-8")
        self.resets += 1

    def _run(self):
        while not self._stop.is_set():
            ep = None
            try:
                ep = router_endpoint(self._store, self._job, "journal",
                                     timeout=5.0)
            except Exception:   # noqa: BLE001 — store blip: retry
                pass
            if ep is None:
                if self._stop.wait(self._reconnect_s):
                    return
                continue
            try:
                s = socket.create_connection((ep[0], ep[1]),
                                             timeout=5.0)
            except OSError:
                self.reconnects += 1
                if self._stop.wait(self._reconnect_s):
                    return
                continue
            self._sock = s
            try:
                while not self._stop.is_set():
                    header, payload = recv_frame(s)
                    _faults.fire("journal.tail", job=self._job,
                                 kind=header.get("kind"))
                    if header.get("kind") == "reset":
                        self._apply_reset(payload.decode())
                    else:
                        self._f.write(payload.decode() + "\n")
                        self._f.flush()
                        self.lines += 1
            except _faults.InjectedFault:
                self.reconnects += 1    # torn stream: resync fresh
            except (OSError, FabricError, ValueError):
                if self._stop.is_set():
                    return
                self.reconnects += 1
            finally:
                self._sock = None
                try:
                    s.close()
                except OSError:
                    pass
            if self._stop.wait(self._reconnect_s):
                return

    def shadow_state(self) -> dict:
        """Replay of the shadow journal ({rid: state}) — what this
        standby would recover if promoted right now."""
        if not self._f.closed:
            self._f.flush()
        return RoutingJournal.replay(self.shadow_path)

    def stop(self):
        self._stop.set()
        s = self._sock
        if s is not None:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        self._thread.join(timeout=5.0)
        try:
            if not self._f.closed:
                self._f.flush()
                self._f.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# replica attach
# ---------------------------------------------------------------------------

class ReplicaAcceptor:
    """The leader side of HA replica attach: listens for replica
    control connections, reads the hello, wraps each in a
    `ProcessReplica` handle (``proc=None`` — the process belongs to
    whoever spawned it) and hands it to `on_replica` (the router's
    `add_replica`).  HA-mode children re-hello to every new leader, so
    promotion repopulates the fleet view through this same path."""

    def __init__(self, store, job_id, on_replica, host="127.0.0.1",
                 port=0):
        self._store = store
        self._job = job_id
        self._on_replica = on_replica
        self._closing = threading.Event()
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port)))
        self._srv.listen(64)
        self.address = self._srv.getsockname()
        self.accepted = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name=f"replica-accept-{job_id}")
        self._thread.start()

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            if self._closing.is_set():
                conn.close()
                return
            threading.Thread(target=self._handshake, args=(conn,),
                             daemon=True,
                             name="replica-hello").start()

    def _handshake(self, conn):
        chan = _LineChannel(conn)
        try:
            line = chan.readline()
            hello = json.loads(line) if line else None
        except (OSError, ValueError, socket.timeout):
            hello = None
        if not hello or hello.get("op") != "hello":
            try:
                conn.close()
            except OSError:
                pass
            return
        rep = ProcessReplica(hello["name"], None, conn, chan, hello,
                             self._store, self._job)
        with self._lock:
            self.accepted.append(rep)
        try:
            self._on_replica(rep)
        except Exception:   # noqa: BLE001 — a sick callback must not
            pass            # kill the accept plane

    def close(self):
        """Stop accepting AND sever every accepted control channel —
        the children see EOF and go rediscover the leader."""
        self._closing.set()
        _close_listener(self._srv)
        with self._lock:
            reps, self.accepted = self.accepted, []
        for rep in reps:
            try:
                rep._conn.close()
            except OSError:
                pass

    def join_handshakes(self, timeout=0.0):
        """Number of replicas attached so far (poll helper for tests)."""
        with self._lock:
            return len(self.accepted)


# ---------------------------------------------------------------------------
# client gateway + shim
# ---------------------------------------------------------------------------

class ClientGateway:
    """Fabric-framed submit/result endpoint on the leading router.

    After a promotion the successor's gateway absorbs the
    ``{predecessor_rid: RouterRequest}`` map from
    `resubmit_incomplete`, so a client holding a rid minted by the
    dead leader finds its request (and its successor rid) here —
    the shim's failover needs no client-side journal."""

    ALIAS_CAP = 65536

    def __init__(self, router, host="127.0.0.1", port=0):
        self.router = router
        self._alias = {}            # insertion-ordered; oldest evicted
        self._closing = threading.Event()
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port)))
        self._srv.listen(32)
        self.address = self._srv.getsockname()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="client-gateway")
        self._thread.start()

    def absorb_aliases(self, mapping):
        self._alias.update(mapping)
        while len(self._alias) > self.ALIAS_CAP:
            self._alias.pop(next(iter(self._alias)))

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            if self._closing.is_set():
                conn.close()
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True,
                             name="gateway-conn").start()

    def _lookup(self, rid):
        with self.router._lock:
            rr = self.router._requests.get(rid)
        return rr if rr is not None else self._alias.get(rid)

    def _serve(self, conn):
        try:
            with conn:
                conn.settimeout(120.0)
                header, _ = recv_frame(conn)
                verb = header.get("verb")
                if verb == "submit":
                    rr = self.router.submit(
                        header["prompt"],
                        int(header.get("max_new_tokens", 16)),
                        client=str(header.get("client", "")),
                        **dict(header.get("params") or {}))
                    # pin the accepted request: the router evicts it
                    # from `_requests` at _finish, and a terminal
                    # verdict must stay collectable after that
                    self.absorb_aliases({rr.rid: rr})
                    send_frame(conn, {"ok": True, "rid": rr.rid})
                elif verb == "result":
                    rr = self._lookup(header["rid"])
                    if rr is None:
                        send_frame(conn, {
                            "ok": False,
                            "error": f"unknown rid {header['rid']!r}"})
                        return
                    reply = {"ok": True, "rid": rr.rid}
                    try:
                        toks = rr.result(
                            float(header.get("timeout", 60.0)))
                        reply["tokens"] = [int(t) for t in toks]
                    except BaseException as e:  # noqa: BLE001 — wire
                        reply["error_typed"] = _encode_error(e)
                    send_frame(conn, reply)
                else:
                    send_frame(conn, {"ok": False,
                                      "error": f"unknown verb {verb!r}"})
        except (OSError, FabricError, ValueError):
            pass
        except BaseException as e:  # noqa: BLE001 — cross the wire
            try:
                send_frame(conn, {"ok": False, "error": str(e)})
            except OSError:
                pass

    def close(self):
        self._closing.set()
        _close_listener(self._srv)


class FleetClient:
    """Client shim that survives router failover: every call re-reads
    the advertised ``gateway`` endpoint from the store and retries
    across the promotion gap.  `result()` follows the request under
    its successor rid (the gateway's alias map) and returns the FULL
    token list — the exactly-once prefix dedup already happened inside
    the routers, so the stream a client assembles is bitwise identical
    whether or not a failover happened mid-decode.  Typed verdicts
    (`PoisonedRequest`, `StaleRouterEpoch`, engine errors) surface as
    their real exception types, never as retries."""

    def __init__(self, store, job_id, failover_timeout=60.0,
                 retry_s=0.25):
        self._store = store
        self._job = job_id
        self._failover_timeout = float(failover_timeout)
        self._retry_s = float(retry_s)

    def _call(self, header, timeout=None):
        deadline = time.monotonic() + (self._failover_timeout
                                       if timeout is None else timeout)
        last = None
        while True:
            try:
                ep = router_endpoint(self._store, self._job, "gateway",
                                     timeout=5.0)
                if ep is None:
                    raise FabricError("no gateway advertised")
                reply, _ = fabric_request(
                    (ep[0], ep[1]), header,
                    timeout=float(header.get("timeout", 30.0)) + 30.0)
                return reply
            except (FabricError, OSError, ConnectionError) as e:
                last = e
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no leading router answered {header.get('verb')!r} "
                    f"within the failover window") from last
            time.sleep(self._retry_s)

    def submit(self, prompt_ids, max_new_tokens=16, client="",
               **params) -> str:
        reply = self._call({"verb": "submit",
                            "prompt": [int(t) for t in prompt_ids],
                            "max_new_tokens": int(max_new_tokens),
                            "client": client, "params": params})
        return reply["rid"]

    def result(self, rid, timeout=60.0):
        """Block for `rid`'s final token list; returns
        ``(rid, tokens)`` where `rid` is the CURRENT rid (it changes
        when a successor router resubmits the request)."""
        deadline = time.monotonic() + float(timeout)
        while True:
            remaining = max(1.0, deadline - time.monotonic())
            reply = self._call({"verb": "result", "rid": rid,
                                "timeout": min(30.0, remaining)},
                               timeout=remaining)
            rid = reply.get("rid", rid)
            err = reply.get("error_typed")
            if err is not None:
                name = err[0] if isinstance(err, (list, tuple)) else ""
                if name == "ResultTimeout":
                    if time.monotonic() >= deadline:
                        raise _decode_error(err)
                    continue        # still decoding: keep following
                raise _decode_error(err)
            return rid, [int(t) for t in reply["tokens"]]


# ---------------------------------------------------------------------------
# leader + standby
# ---------------------------------------------------------------------------

class HARouter(Router):
    """A `Router` that holds the ``router_leader`` lease and serves the
    HA surfaces: replica acceptor, journal stream, client gateway —
    each advertised in the store as ``[host, port, epoch]``.  The
    router EPOCH is the lease generation; it rides every dispatch so
    replicas reject a deposed leader's traffic (`StaleRouterEpoch`).

    `crash()` is the drill hook (also reachable by arming the
    ``router.crash`` fault site): it stops the lease heartbeat WITHOUT
    deleting the key, stops dispatching, and severs only the sockets
    this router owns — exactly the observable footprint of SIGKILL,
    so the standby's detection path is the one production needs."""

    def __init__(self, store=None, job_id="fleet", lease_ttl=2.0,
                 ha_host="127.0.0.1", crash_poll_s=0.25, **router_kw):
        if store is None:
            raise ValueError("HARouter needs the fleet store "
                             "(leadership lives there)")
        super().__init__(store=store, job_id=job_id, **router_kw)
        self.crashed = threading.Event()
        self.lease = ReplicaLease(store, job_id, ROUTER_LEADER,
                                  ttl=lease_ttl)
        self.router_epoch = int(self.lease.register())
        self.acceptor = ReplicaAcceptor(store, job_id, self.add_replica,
                                        host=ha_host)
        self.journal_server = JournalStreamServer(self._journal,
                                                  host=ha_host)
        self.gateway = ClientGateway(self, host=ha_host)
        for kind, srv in (("ctrl", self.acceptor),
                          ("journal", self.journal_server),
                          ("gateway", self.gateway)):
            publish_router_endpoint(store, job_id, kind,
                                    srv.address[0], srv.address[1],
                                    self.router_epoch)
        self.add_debug_section("ha", lambda: {
            "role": "primary", "epoch": self.router_epoch,
            "crashed": self.crashed.is_set(),
            "ctrl": list(self.acceptor.address),
            "gateway": list(self.gateway.address)})
        self._ha_stop = threading.Event()
        self._crash_poll_s = float(crash_poll_s)
        self._ha_thread = threading.Thread(target=self._ha_loop,
                                           daemon=True,
                                           name=f"ha-loop-{job_id}")
        self._ha_thread.start()

    def _ha_loop(self):
        """Chaos hook: the armed ``router.crash`` site turns into an
        in-process SIGKILL-equivalent in bounded time."""
        while not self._ha_stop.wait(self._crash_poll_s):
            try:
                _faults.fire("router.crash", job=self.job_id,
                             epoch=self.router_epoch)
            except _faults.InjectedFault:
                self.crash()
                return

    def crash(self):
        """SIGKILL-equivalent: heartbeat stops (key left to EXPIRE —
        the standby must earn the detection), dispatch stops, owned
        sockets close.  Pending requests are NOT failed: a real dead
        process fails nobody, the successor recovers them from the
        journal stream.

        The journal stream and the gateway close BEFORE the replica
        channels: severing an `ha` replica's channel finishes its
        handles here with `EngineUnhealthy`, and what this router's
        callbacks make of that must reach neither the standby's shadow
        nor the store (`_fail_replica` below) — a dead process writes
        nothing."""
        if self.crashed.is_set():
            return
        self.crashed.set()
        self._ha_stop.set()
        self.lease._stop.set()      # stop beating; never delete the key
        self._closing.set()         # dispatcher/health/obs loops exit
        self._queue.wake()
        self.journal_server.close()
        self.gateway.close()
        self.acceptor.close()       # children EOF -> rediscover leader

    def _fail_replica(self, name, cause):
        """A crashed leader fences nobody: the replicas it dispatched
        to live on under its successor."""
        if self.crashed.is_set():
            return
        super()._fail_replica(name, cause)

    def shutdown(self, timeout=5.0):
        self._ha_stop.set()
        self.acceptor.close()
        self.journal_server.close()
        self.gateway.close()
        if not self.crashed.is_set():
            self.lease.release()
        super().shutdown(timeout)

    close = shutdown


class _FinishedRequest:
    """Gateway alias stub for a request that reached its TERMINAL state
    on the deposed leader: the shadow journal holds its full delivered
    stream (or its typed failure), so the successor answers `result()`
    from the replay without re-dispatching anything.  Without these, a
    client that submitted before the crash but collected after the
    promotion would retry "unknown rid" forever — a completed request
    is not allowed to become a lost one."""

    __slots__ = ("rid", "tokens", "_error")

    def __init__(self, rid, tokens, error_name=None):
        self.rid = rid
        self.tokens = [int(t) for t in tokens]
        self._error = (None if error_name is None else _decode_error(
            [error_name,
             f"request {rid} failed on the deposed leader"]))

    def result(self, timeout=None):
        if self._error is not None:
            raise self._error
        return list(self.tokens)


class StandbyRouter:
    """Warm successor: tails the leader's journal into a shadow file
    and (optionally) watches the leader lease, promoting itself the
    moment the lease expires or is fenced.  Promotion = fence the dead
    generation, register the next (epoch bump), attach the known
    replicas, resubmit every incomplete request from the shadow, and
    hand the old-rid alias map to the new gateway."""

    def __init__(self, store, job_id="fleet", shadow_path=None,
                 replicas=(), auto_promote=False, watch_interval=0.25,
                 router_kw=None):
        self._store = store
        self._job = job_id
        self._replicas = list(replicas)
        self._router_kw = dict(router_kw or {})
        self.tailer = JournalTailer(store, job_id,
                                    shadow_path=shadow_path)
        self.shadow_path = self.tailer.shadow_path
        self.router = None
        self.promoted = threading.Event()
        self.promote_latency_s = None
        self._plock = threading.Lock()
        self._stop = threading.Event()
        self._watch_interval = float(watch_interval)
        self._watcher = None
        if auto_promote:
            self._watcher = threading.Thread(
                target=self._watch, daemon=True,
                name=f"standby-watch-{job_id}")
            self._watcher.start()

    def leader_alive(self) -> bool:
        try:
            lease = self._store.get(_lease_key(self._job, ROUTER_LEADER),
                                    timeout=5.0)
        except Exception:   # noqa: BLE001 — store down != leader dead
            return True     # (never promote on a store blip alone)
        if not isinstance(lease, (tuple, list)) or len(lease) != 3:
            return False
        ts, ttl, gen = float(lease[0]), float(lease[1]), int(lease[2])
        try:
            if gen <= fenced_generation(self._store, self._job,
                                        ROUTER_LEADER, timeout=5.0):
                return False
        except Exception:   # noqa: BLE001
            return True
        return time.time() - ts <= ttl

    def shadow_state(self) -> dict:
        """{rid: state} replay of the shadow journal (what promotion
        would recover right now)."""
        return self.tailer.shadow_state()

    def _watch(self):
        while not self._stop.wait(self._watch_interval):
            if self.promoted.is_set():
                return
            if not self.leader_alive():
                try:
                    self.promote()
                except Exception:   # noqa: BLE001 — next tick retries
                    continue
                return

    def promote(self):
        """Take leadership; returns the promoted `HARouter` (idempotent
        — a second call returns the same instance)."""
        with self._plock:
            if self.router is not None:
                return self.router
            t0 = time.monotonic()
            # fence the dead generation FIRST: its heartbeat can never
            # resurrect it, even if the process is wedged, not dead
            try:
                lease = self._store.get(
                    _lease_key(self._job, ROUTER_LEADER), timeout=5.0)
                if isinstance(lease, (tuple, list)) and len(lease) == 3:
                    fence_replica(self._store, self._job, ROUTER_LEADER,
                                  int(lease[2]))
            except Exception:   # noqa: BLE001 — no lease left to fence
                pass
            self.tailer.stop()
            r = HARouter(store=self._store, job_id=self._job,
                         **self._router_kw)
            for rep in self._replicas:
                r.add_replica(rep)
            mapping = r.resubmit_incomplete(self.shadow_path)
            r.gateway.absorb_aliases(mapping)
            # pin the successor rids as well: a client that already
            # followed old->new keeps polling the NEW rid, which the
            # router evicts from `_requests` once it finishes
            r.gateway.absorb_aliases(
                {rr.rid: rr for rr in mapping.values()})
            # terminal requests never re-dispatch, but their verdicts
            # (full stream or typed failure) must survive the leader
            r.gateway.absorb_aliases({
                rid: _FinishedRequest(rid, st["delivered"],
                                      st.get("error"))
                for rid, st in RoutingJournal.replay(
                    self.shadow_path).items() if st["done"]})
            r.add_debug_section("standby_takeover", lambda: {
                "resubmitted": len(mapping),
                "promote_latency_s": self.promote_latency_s})
            self.promote_latency_s = time.monotonic() - t0
            self.router = r
            self.promoted.set()
            return r

    def stop(self):
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=5.0)
        self.tailer.stop()
