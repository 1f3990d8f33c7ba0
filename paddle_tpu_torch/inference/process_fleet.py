"""A real multi-process serving fleet — the port of the JAX package's
`inference/process_fleet.py`, host only: its wire, op names and keys,
error codec, respawn breaker and metric name are the JAX module's.

`LocalFleet` replicas are threads in one process — fine for scheduler
tests, but they share a heap, a GIL, and a fate: a "crashed" replica
is a flag, not a dead process, and overload on one replica steals CPU
from its siblings in ways production never sees.  `ProcessFleet` spawns
each replica as a genuine OS process (``multiprocessing`` spawn
context) so overload and failover drills run against real isolation:
`kill()` is ``SIGKILL``, lease expiry is a process actually gone, and a
replica's graph capture cannot stall the router's clock.  On the card
each process has its own CUDA context, so a replica captures its
graphs while another process replays its own.

Wire protocol — newline-delimited JSON over one TCP connection per
replica, parent side listening:

  child -> parent   hello {name, pid, generation, block_tokens,
                    cache_blocks, fabric_addr, pool_role, tp, kv_blocks,
                    kv_block_bytes_per_chip, boot_s, aot}  then
                    ack {rid, ok, error?} /
                    tok {rid, t} / done {rid, error?, n, migrated} /
                    health_reply {seq, ok, data|error} /
                    ctl_reply {seq, ok, ...} /
                    series {name, payload} (periodic metrics push) / bye
  parent -> child   submit {rid, prompt, max_new_tokens, params} /
                    adopt {rid, source} / cancel {rid} /
                    health {seq} / fault {seq, site, kw} /
                    fault_clear {seq} / quarantine {seq, reason} /
                    clock_sync {seq} / metrics_series {seq, n} /
                    trace {seq, clear} / shutdown {drain, drain_timeout}

The KV fabric itself does NOT ride this channel: replicas pull
prefixes and take session tickets from each other directly over their
fabric endpoints (`fabric_addr` in the hello); the control channel
only carries the router's `adopt` verb and the `migrated` hand-off
marker on `done`.

Typed errors cross the wire as ``[type_name, message]`` and are
reconstructed on the parent so the router's isinstance dispatch
(`QueueFull` -> retry elsewhere, `Overloaded` -> count a shed,
`EngineUnhealthy` -> failover) works unchanged.  The parent registers a
request's handle *before* sending the submit op, so a token racing
ahead of its ack is delivered, not dropped.

Each child registers its own `ReplicaLease` against the fleet's master
store from inside the process — when the process dies, the heartbeat
dies with it and the router's lease sweep sees a real expiry, not a
simulated one.  `ProcessReplica` duck-types `fleet_serving.Replica`
(name / submit / health / server.shutdown / lease / block_tokens /
cache_blocks), so `Router.add_replica` cannot tell the difference.

The child builds its model from `model_spec` —
``{"preset", "seed", "overrides", "device", "arrays"}`` — with
`LlamaForCausalLM(config, device=, seed=)`, so the same spec gives every
process the same weights without shipping them across the spawn;
``"arrays"`` names an ``.npz`` of ``{parameter name: array}`` loaded over
them (`load_reference_arrays`), how a test hands the children another
model's weights.  ``"device"`` defaults to ``"cuda"``: a child asked for
the card on a machine without one raises during startup (nothing falls
back to the CPU), and a CPU child caps its torch threads.  On the card
the child captures its decode graphs before it says hello, so a replica
that joins the fleet is ready to replay.
"""

from __future__ import annotations

import itertools
import json
import multiprocessing
import os
import socket
import threading
import time

import numpy as np

from ..distributed.store import TCPStore
from .engine import (DeadlineExceeded, EngineUnhealthy, Overloaded,
                     PoisonedRequest, QueueFull, ResultTimeout,
                     StaleRouterEpoch)
from .fleet_serving import (ReplicaLease, _lease_key, live_replicas,
                            set_replica_role)
from .kv_fabric import FabricError, IntegrityError

__all__ = ["ProcessFleet", "ProcessReplica", "RespawnCircuitOpen"]

# every control-channel socket op (connect aside) is bounded by this:
# a frozen peer (SIGSTOP, wedged interpreter) turns into a typed error
# in bounded time instead of a forever-hung control thread
_CTRL_TIMEOUT = 30.0

# torch threads of a CPU child: a test host runs several fleets at once
_CPU_THREADS = 1

_ERR_TYPES = {
    "QueueFull": QueueFull,
    "Overloaded": Overloaded,
    "DeadlineExceeded": DeadlineExceeded,
    "EngineUnhealthy": EngineUnhealthy,
    "ResultTimeout": ResultTimeout,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
    # KV-integrity errors keep their type across the wire so the
    # router's isinstance dispatch can tell "corrupt ticket, fall back
    # to replay" (FabricError family) from a crashed engine
    "FabricError": FabricError,
    "IntegrityError": IntegrityError,
    "ConnectionError": ConnectionError,
    # control-plane HA: a replica refusing a stale leader's dispatch,
    # and the router's poison verdict, both stay typed across the wire
    # — the client shim must not retry either as a crash
    "PoisonedRequest": PoisonedRequest,
    "StaleRouterEpoch": StaleRouterEpoch,
}


class RespawnCircuitOpen(RuntimeError):
    """The crash-loop breaker refused a respawn: this replica slot
    burned through `max_respawns` respawns inside the rolling window,
    so something systemic (bad host, poisoned traffic reaching it, a
    corrupt cache dir) is killing it faster than restarts help.  The
    slot stays down until the window drains or an operator calls
    `ProcessFleet.reset_breaker`."""


def _decode_error(err):
    """[type_name, message] -> a typed exception instance (unknown
    types degrade to RuntimeError with the name preserved)."""
    if err is None:
        return None
    name, msg = err
    cls = _ERR_TYPES.get(name)
    if cls is None:
        return RuntimeError(f"{name}: {msg}")
    return cls(msg)


def _encode_error(e):
    return [type(e).__name__, str(e)]


def _send(sock, lock, msg):
    data = (json.dumps(msg) + "\n").encode()
    with lock:
        sock.sendall(data)


class _LineChannel:
    """Newline-delimited reads over a socket that carries a PERSISTENT
    timeout.  The timeout bounds every recv AND sendall on the socket —
    a frozen peer becomes a typed OSError in bounded time — while
    `lines()` tolerates *idle* timeouts on the read side: a quiet peer
    is not a dead peer, so the read loop just keeps waiting."""

    def __init__(self, sock, timeout=_CTRL_TIMEOUT):
        self.sock = sock
        sock.settimeout(timeout)
        self._buf = bytearray()

    def readline(self):
        """One decoded line (newline stripped), or None on EOF.  A
        socket timeout PROPAGATES — single-shot callers (the hello
        handshake) treat silence as failure."""
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                line = bytes(self._buf[:nl])
                del self._buf[:nl + 1]
                return line.decode()
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self._buf += chunk

    def lines(self):
        """Iterate lines until EOF or a hard socket error; idle
        timeouts are absorbed (keep listening forever)."""
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                line = bytes(self._buf[:nl])
                del self._buf[:nl + 1]
                yield line.decode()
                continue
            try:
                chunk = self.sock.recv(65536)
            except socket.timeout:
                continue            # idle, not dead: keep waiting
            except OSError:
                return
            if not chunk:
                return              # EOF: peer is gone
            self._buf += chunk


# ---------------------------------------------------------------------------
# child process
# ---------------------------------------------------------------------------

def _build_model(spec, name):
    """The child's model from `model_spec` (see the module docstring)."""
    import torch
    from ..models import (LlamaConfig, LlamaForCausalLM,
                          load_reference_arrays)
    device = torch.device(spec.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"replica {name}: model_spec asks for "
                           f"{device} and no CUDA device is available")
    if device.type == "cpu":
        torch.set_num_threads(_CPU_THREADS)
    model = LlamaForCausalLM(
        LlamaConfig.from_preset(spec.get("preset", "tiny"),
                                **spec.get("overrides", {})),
        device=device, seed=int(spec.get("seed", 0)))
    if spec.get("arrays"):
        with np.load(spec["arrays"]) as z:
            load_reference_arrays(model, {k: z[k] for k in z.files})
    return model


def _replica_main(cfg):
    """Entry point of one replica process (top-level for spawn
    pickling).  Builds the model from `model_spec` — same seed + preset
    as every sibling, so all replicas hold the same weights without
    shipping arrays across the spawn."""
    # late imports: this runs in a fresh interpreter
    from ..observability import tracing as _tracing
    from ..testing import faults as _faults
    from .serving import LLMServer

    # distributed tracing: the parent's trace config rides the spawn
    # cfg (env vars also work — spawn children inherit them — but the
    # explicit key lets one fleet trace while siblings don't)
    trace_cfg = cfg.get("trace")
    if trace_cfg:
        _tracing.configure(enabled=True,
                           capacity=trace_cfg.get("capacity"),
                           flight_dir=trace_cfg.get("flight_dir"))

    # control-plane HA: in `ha` mode the control endpoint is whichever
    # router currently leads (advertised in the store), and a dropped
    # connection means "find the new leader", not "die".  The socket
    # therefore lives in a mutable holder so every sender — serve loop,
    # token callbacks, series pusher — writes to the CURRENT leader's
    # connection.  A request's own traffic (its ack, tokens and done)
    # goes only to the connection that dispatched it (`gen`, one per
    # connection): a cancelled request of a dead leader finishes on the
    # driver thread after the re-hello, and its late `tok` / `done`
    # would otherwise reach the successor under a rid the successor
    # mints afresh for its own resubmission ("pr-<name>-0" onwards).
    ha = bool(cfg.get("ha"))
    conn = {"sock": None, "lock": threading.Lock(), "epoch": 0, "gen": 0}

    def _ctl_send(msg, gen=None):
        sock = conn["sock"]
        if sock is None:
            raise OSError("control channel down")
        if gen is not None and gen != conn["gen"]:
            raise OSError("control channel of a deposed leader")
        _send(sock, conn["lock"], msg)

    model = _build_model(cfg["model_spec"], cfg["name"])
    server = LLMServer(model, metrics_port=None, name=cfg["name"],
                       pool_role=cfg.get("pool_role", "mixed"),
                       **cfg["engine_kw"])
    eng = server.engine
    # on the card: every decode width captured before the replica is
    # announced, so it joins the fleet ready to replay
    t_cap = time.perf_counter()
    if eng._graphs is not None:
        eng.prepare_programs()
    boot_s = float(server.boot_s) + (time.perf_counter() - t_cap)
    store = TCPStore(cfg["store_host"], cfg["store_port"],
                     is_master=False)
    lease = ReplicaLease(store, cfg["job_id"], cfg["name"],
                         ttl=cfg["lease_ttl"])
    generation = lease.register()
    try:
        # pool advertisement next to the lease — advisory, so a store
        # blip here never blocks the replica coming up
        set_replica_role(store, cfg["job_id"], cfg["name"],
                         server.pool_role)
    except Exception:   # noqa: BLE001
        pass
    has_cache = getattr(eng, "_pcache", None) is not None
    # built once, sent per connection: an HA replica re-introduces
    # itself (same name, same lease generation) to every new leader
    hello_msg = {
        "op": "hello", "name": cfg["name"], "pid": os.getpid(),
        "generation": generation,
        "block_tokens": (int(eng.prefix_block_tokens)
                         if has_cache else 0),
        "cache_blocks": (int(eng._pcache.n_blocks)
                         if has_cache else 0),
        "fabric_addr": (list(server.fabric_address)
                        if server.fabric_address is not None else None),
        # disaggregated serving: placement pool this replica serves
        "pool_role": server.pool_role,
        # mesh advertisement: tp + per-chip KV geometry so the router
        # can weigh replicas of different shard counts (one card: tp 1)
        "tp": int(eng.tp),
        "kv_blocks": int(eng.kv_blocks - 1),
        "kv_block_bytes_per_chip": int(eng.kv_block_bytes_per_chip),
        # how long this replica took to come up (the server's boot and
        # its graph capture) — the autoscaler's actual lead time
        "boot_s": boot_s,
        # the engine has no AOT program cache: the JAX replica's value
        # without one
        "aot": None,
    }

    # fleet shipping: periodic push of the server's time-series tails
    # up the ctl socket.  The failure contract is the `metrics.ship`
    # fault site: a dropped or torn push costs the aggregator freshness
    # ONLY — it never fences, quarantines, or stalls the replica, and
    # the overlapping tails mean the next successful push re-covers the
    # gap.
    push_stop = threading.Event()
    push_s = cfg.get("series_push_s")
    if push_s and server.series_store is not None:

        def _series_pusher():
            while not push_stop.wait(push_s):
                try:
                    _faults.fire("metrics.ship", name=cfg["name"])
                    payload = server.metrics_series()
                    if payload is not None:
                        _ctl_send(
                              {"op": "series", "name": cfg["name"],
                               "payload": payload})
                except _faults.InjectedFault:
                    continue        # this push is dropped, not the replica
                except (OSError, ValueError):
                    continue        # torn socket: freshness only
                except Exception:
                    continue        # shipping must never kill serving

        threading.Thread(target=_series_pusher, daemon=True,
                         name=f"series-push-{cfg['name']}").start()

    requests = {}
    req_lock = threading.Lock()

    def mk_on_token(rid, gen):
        def cb(req, tok):
            try:
                _ctl_send({"op": "tok", "rid": rid, "t": int(tok)}, gen)
            except OSError:
                pass    # router gone mid-stream: the successor replays
        return cb

    def mk_on_done(rid, gen):
        def cb(req):
            with req_lock:
                requests.pop(rid, None)
            err = None if req.error is None else _encode_error(req.error)
            try:
                _ctl_send({"op": "done", "rid": rid,
                           "error": err,
                           "n": len(req.tokens),
                           "migrated": bool(getattr(
                               req, "migrated", False))}, gen)
            except OSError:
                pass    # router gone: its successor owns the request
        return cb

    def _cancel_all():
        """Leader died: cancel what it dispatched here — the promoted
        standby re-dispatches every incomplete request from its tailed
        journal, and a duplicate computation would only waste slots
        (position dedupe keeps even that harmless)."""
        with req_lock:
            reqs = list(requests.values())
            requests.clear()
        for req in reqs:
            try:
                req.cancel()
            except Exception:   # noqa: BLE001
                pass

    def _connect_ctl():
        """One control connection: static parent address in fleet mode,
        the advertised `router/ctrl` leader endpoint in HA mode (polled
        until a leader shows up — promotion re-publishes it)."""
        if not ha:
            return socket.create_connection(
                (cfg["host"], cfg["port"]), timeout=60.0)
        deadline = time.monotonic() + float(cfg.get("ctl_wait_s", 120.0))
        while True:
            addr = None
            try:
                addr = store.get(
                    f"fleet/{cfg['job_id']}/router/ctrl", timeout=10.0)
            except Exception:   # noqa: BLE001 — store blip: keep polling
                pass
            if addr:
                try:
                    s = socket.create_connection(
                        (addr[0], int(addr[1])), timeout=10.0)
                    conn["epoch"] = int(addr[2]) if len(addr) > 2 else 0
                    return s
                except OSError:
                    pass        # stale advertisement: poll again
            if time.monotonic() >= deadline:
                raise OSError("no live router leader advertised")
            time.sleep(0.25)

    if ha:
        # a live-zombie ex-primary holds our connection open while the
        # promoted standby advertises a higher epoch: watch for the
        # bump and sever the stale connection ourselves
        def _epoch_watch():
            while True:
                time.sleep(float(cfg.get("epoch_poll_s", 1.0)))
                try:
                    addr = store.get(
                        f"fleet/{cfg['job_id']}/router/ctrl", timeout=5.0)
                except Exception:   # noqa: BLE001
                    continue
                s = conn["sock"]
                if (addr and len(addr) > 2 and s is not None
                        and int(addr[2]) > conn["epoch"]):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        s.close()
                    except OSError:
                        pass

        threading.Thread(target=_epoch_watch, daemon=True,
                         name=f"epoch-watch-{cfg['name']}").start()

    def _line_stream():
        """Control lines across leader changes: yields exactly what
        `chan.lines()` does, but in HA mode an EOF (dead leader) means
        cancel in-flight work, rediscover the leader, re-hello, and
        keep serving.  Exhausts only on a real shutdown path: non-HA
        EOF, or no leader within the discovery window."""
        while True:
            try:
                s = _connect_ctl()
            except OSError:
                return
            conn["gen"] += 1
            conn["sock"] = s
            chan = _LineChannel(s)
            try:
                _ctl_send(hello_msg)
            except OSError:
                conn["sock"] = None
                if ha:
                    continue
                return
            yield from chan.lines()
            conn["sock"] = None
            if not ha:
                return
            _cancel_all()

    def _ctl_reply(msg, fn):
        """Answer one ctl op: ``fn()``'s dict (or None) merged into an
        ok reply, or its exception encoded for the wire."""
        try:
            reply = {"op": "ctl_reply", "seq": msg["seq"], "ok": True,
                     **(fn() or {})}
        except BaseException as e:  # noqa: BLE001 — crosses the wire
            reply = {"op": "ctl_reply", "seq": msg["seq"],
                     "ok": False, "error": _encode_error(e)}
        _ctl_send(reply)

    def _arm(msg):
        # chaos-sweep remote trigger: arm / clear a rule in THIS
        # process's fault injector — the harness drives a real
        # multi-process fleet, so rules must land across the process
        # boundary, not in the parent's injector
        if msg["op"] == "fault":
            kw = dict(msg.get("kw") or {})
            if isinstance(kw.get("exc"), str):
                # exception classes can't ride JSON: named lookup
                # against the faults module
                kw["exc"] = getattr(_faults, kw["exc"])
            _faults.ENABLED = True
            _faults.get_injector().inject(msg["site"], **kw)
        else:
            _faults.get_injector().clear()

    def _trace(msg):
        # drain this process's span ring buffer to the parent (merged
        # Chrome export + cross-process request timelines)
        spans = _tracing.snapshot_spans()
        if msg.get("clear"):
            _tracing.clear()
        return {"spans": spans}

    for line in _line_stream():
        try:
            msg = json.loads(line)
            op = msg["op"]
            if op == "submit":
                rid, gen = msg["rid"], conn["gen"]
                try:
                    req = server.submit(
                        np.asarray(msg["prompt"], np.int32),
                        msg["max_new_tokens"],
                        on_token=mk_on_token(rid, gen),
                        on_done=mk_on_done(rid, gen),
                        **msg.get("params", {}))
                except BaseException as e:  # noqa: BLE001 — crosses the wire
                    _ctl_send({"op": "ack", "rid": rid, "ok": False,
                               "error": _encode_error(e)})
                    continue
                with req_lock:
                    if not req.done:    # already-finished: on_done popped it
                        requests[rid] = req
                _ctl_send({"op": "ack", "rid": rid, "ok": True})
            elif op == "adopt":
                # off the control thread: an adoption claims + CRC-checks
                # + lands a staged KV ticket (tens of ms), and a fan-out
                # burst lands several on one decode replica at once —
                # inline they'd serialize here and the tail would surface
                # as first-token ITL stalls on every handed-off stream.
                # The parent matches acks by rid, so ordering is free.
                def _adopt(rid=msg["rid"], source=msg["source"],
                           gen=conn["gen"]):
                    try:
                        req = server.adopt(source,
                                           on_token=mk_on_token(rid, gen),
                                           on_done=mk_on_done(rid, gen))
                    except BaseException as e:  # noqa: BLE001 — crosses the wire
                        _ctl_send({"op": "ack", "rid": rid, "ok": False,
                                   "error": _encode_error(e)}, gen)
                        return
                    with req_lock:
                        if not req.done:
                            requests[rid] = req
                    _ctl_send({"op": "ack", "rid": rid, "ok": True}, gen)

                threading.Thread(target=_adopt, daemon=True,
                                 name=f"adopt-{msg['rid']}").start()
            elif op == "cancel":
                with req_lock:
                    req = requests.get(msg["rid"])
                if req is not None:
                    req.cancel()
            elif op == "health":
                try:
                    data = server.health_snapshot()
                    if not server.healthy:
                        raise ConnectionError(
                            f"replica {cfg['name']} {data['status']}")
                    reply = {"op": "health_reply", "seq": msg["seq"],
                             "ok": True, "data": data}
                except BaseException as e:  # noqa: BLE001
                    reply = {"op": "health_reply", "seq": msg["seq"],
                             "ok": False, "error": _encode_error(e)}
                _ctl_send(reply)
            elif op in ("fault", "fault_clear"):
                _ctl_reply(msg, lambda: _arm(msg))
            elif op == "quarantine":
                # operator hook across the process boundary — flips the
                # same sticky state a canary mismatch sets (drills, CI)
                _ctl_reply(msg, lambda: server.quarantine(
                    msg.get("reason", "operator request")))
            elif op == "clock_sync":
                # trace clock handshake: the parent brackets this
                # round-trip with its own clock stamps and aligns this
                # process's span clock by the NTP midpoint — the reply
                # is just "what time is it for you, right now"
                _ctl_send({"op": "ctl_reply", "seq": msg["seq"],
                           "ok": True, "t_ns": _tracing.clock_ns()})
            elif op == "metrics_series":
                # on-demand pull of the windowed series tails (the push
                # thread is the steady-state path; this is the router's
                # catch-up / ops hook)
                _ctl_reply(msg, lambda: {"payload": server.metrics_series(
                    n=int(msg.get("n", 15)))})
            elif op == "trace":
                _ctl_reply(msg, lambda: _trace(msg))
            elif op == "shutdown":
                push_stop.set()
                try:
                    server.shutdown(drain=msg.get("drain", False),
                                    drain_timeout=msg.get("drain_timeout",
                                                          30.0))
                finally:
                    lease.release()
                    try:
                        _ctl_send({"op": "bye"})
                    except OSError:
                        pass
                return
        except OSError:
            # reply raced the leader's death: in HA mode the successor
            # re-drives this op; never die over it
            if not ha:
                raise
    # parent went away (EOF): die quietly; the lease will expire
    os._exit(0)


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class _RemoteHandle:
    """Parent-side stand-in for the replica's engine `Request` — just
    enough surface for the router (tokens/error/done/cancel) and for a
    direct `result()` wait."""

    def __init__(self, rid, replica, on_token, on_done):
        self.rid = rid
        self._replica = replica
        self.on_token = on_token
        self.on_done = on_done
        self.tokens = []
        self.error = None
        self.done = False
        self.migrated = False   # hand-off marker, mirrored off the wire
        self._ack = threading.Event()
        self._ack_err = None
        self._done_ev = threading.Event()

    def cancel(self):
        # best-effort, like Request.cancel(): the router cancels a
        # dead replica's attempts during failover cleanup — a raise
        # here would kill the very thread doing that cleanup
        try:
            self._replica._send_op({"op": "cancel", "rid": self.rid})
        except EngineUnhealthy:
            pass

    def result(self, timeout=30.0):
        if not self._done_ev.wait(timeout):
            raise ResultTimeout(
                f"remote request {self.rid} still running after "
                f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.tokens

    def _finish(self, error):
        if self.done:
            return
        self.error = error
        self.done = True
        if self.on_done is not None:
            self.on_done(self)
        self._done_ev.set()


class _LeaseView:
    """Read-only view of a lease held by the CHILD process: exposes the
    generation for router-side fencing and a `release()` that deletes
    the lease key directly (used at clean detach; the child's heartbeat
    thread is already gone by then)."""

    def __init__(self, store, job_id, name, generation):
        self._store = store
        self._job = job_id
        self._name = name
        self.generation = generation

    def release(self):
        try:
            self._store.delete_key(_lease_key(self._job, self._name))
        except (ConnectionError, OSError):
            pass


class _ServerProxy:
    """`replica.server` for the router's drain path: `shutdown()`
    forwards over the control channel and waits for the child's bye."""

    def __init__(self, replica):
        self._replica = replica

    def shutdown(self, drain=False, drain_timeout=30.0):
        self._replica._shutdown(drain=drain, drain_timeout=drain_timeout)


class ProcessReplica:
    """One spawned replica: the OS process, its control socket, and the
    reader thread that turns wire messages back into callbacks."""

    def __init__(self, name, proc, conn, chan, hello, store, job_id,
                 submit_ack_timeout=60.0):
        self.name = name
        self.proc = proc
        self._chan = chan           # the ONE reader for conn (a second
                                    # reader would drop bytes this one
                                    # already buffered)
        self.pid = hello["pid"]
        self.block_tokens = int(hello["block_tokens"])
        self.cache_blocks = int(hello["cache_blocks"])
        # mesh advertisement — .get defaults keep a newer parent
        # compatible with an older replica image mid-rollout
        self.tp = int(hello.get("tp", 1))
        self.kv_blocks = int(hello.get("kv_blocks", 0))
        self.kv_block_bytes_per_chip = int(
            hello.get("kv_block_bytes_per_chip", 0))
        fab = hello.get("fabric_addr")
        self.fabric_address = None if fab is None else tuple(fab)
        # disaggregated serving — .get default keeps a newer parent
        # compatible with an older replica image
        self.pool_role = str(hello.get("pool_role") or "mixed")
        # replica-reported boot latency + program-cache tallies, for
        # autoscale lead-time accounting
        self.boot_s = float(hello.get("boot_s", 0.0))
        self.aot = hello.get("aot")
        self.lease = _LeaseView(store, job_id, name,
                                int(hello["generation"]))
        self.server = _ServerProxy(self)
        self._conn = conn
        self._send_lock = threading.Lock()
        self._ack_timeout = float(submit_ack_timeout)
        self._handles = {}
        self.clock_offset_ns = 0    # set by clock_sync()
        # fleet shipping: payloads the child pushed since the router
        # last drained them.  Bounded — an idle router must not
        # accumulate history the aggregator already carries — but deep
        # enough to ride out a multi-second router poll stall without
        # dropping a spike-bearing payload (the aggregator dedups
        # overlapping tails by timestamp, so depth is cheap).
        self._series_q = []
        self._series_cap = 32
        self._health_waits = {}     # seq -> [event, reply]
        self._hseq = itertools.count()
        self._lock = threading.Lock()
        self._dead = False
        self._bye = threading.Event()
        self._rids = (f"pr-{name}-{i}" for i in itertools.count())
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True,
                                        name=f"fleet-read-{name}")
        self._reader.start()

    # -- wire ---------------------------------------------------------------

    def _send_op(self, msg):
        if self._dead:
            raise EngineUnhealthy(f"replica {self.name} process is dead")
        try:
            _send(self._conn, self._send_lock, msg)
        except OSError as e:
            self._mark_dead(e)
            raise EngineUnhealthy(
                f"replica {self.name} connection lost: {e!r}") from e

    def _read_loop(self):
        try:
            for line in self._chan.lines():
                self._on_msg(json.loads(line))
        except (OSError, ValueError) as e:
            self._mark_dead(e)
            return
        self._mark_dead(EOFError("control channel closed"))

    def _on_msg(self, msg):
        op = msg["op"]
        if op == "tok":
            with self._lock:
                h = self._handles.get(msg["rid"])
            if h is not None and not h.done:
                h.tokens.append(msg["t"])
                if h.on_token is not None:
                    h.on_token(h, msg["t"])
        elif op == "done":
            with self._lock:
                h = self._handles.pop(msg["rid"], None)
            if h is not None:
                h.migrated = bool(msg.get("migrated", False))
                h._finish(_decode_error(msg.get("error")))
        elif op == "ack":
            with self._lock:
                h = self._handles.get(msg["rid"])
            if h is not None:
                if not msg["ok"]:
                    h._ack_err = _decode_error(msg["error"])
                    with self._lock:
                        self._handles.pop(msg["rid"], None)
                h._ack.set()
        elif op in ("health_reply", "ctl_reply"):
            with self._lock:
                w = self._health_waits.pop(msg["seq"], None)
            if w is not None:
                w[1] = msg
                w[0].set()
        elif op == "series":
            # unsolicited metrics push; overlapping tails make dropping
            # the oldest under backlog harmless
            with self._lock:
                self._series_q.append(msg.get("payload"))
                if len(self._series_q) > self._series_cap:
                    del self._series_q[0]
        elif op == "bye":
            self._bye.set()

    def _mark_dead(self, cause):
        with self._lock:
            if self._dead:
                return
            self._dead = True
            pending = list(self._handles.values())
            self._handles.clear()
            waits = list(self._health_waits.values())
            self._health_waits.clear()
        self._bye.set()             # a dead child can't say goodbye
        err = EngineUnhealthy(
            f"replica {self.name} process died: {cause!r}")
        for h in pending:
            h._ack_err = err
            h._ack.set()
            h._finish(err)
        for w in waits:
            w[1] = {"ok": False, "error": _encode_error(err)}
            w[0].set()

    # -- Replica duck type --------------------------------------------------

    def _request(self, msg, on_token, on_done):
        """Register a handle, send `msg` (a submit or an adopt) under
        its rid, and wait for the child's ack.  The handle is registered
        BEFORE sending: the child may stream a token before its ack
        crosses back."""
        rid = next(self._rids)
        h = _RemoteHandle(rid, self, on_token, on_done)
        with self._lock:
            if self._dead:
                raise EngineUnhealthy(
                    f"replica {self.name} process is dead")
            self._handles[rid] = h
        try:
            self._send_op(dict(msg, rid=rid))
        except BaseException:
            with self._lock:
                self._handles.pop(rid, None)
            raise
        if not h._ack.wait(self._ack_timeout):
            with self._lock:
                self._handles.pop(rid, None)
            raise EngineUnhealthy(
                f"replica {self.name} did not ack {msg['op']} within "
                f"{self._ack_timeout}s")
        if h._ack_err is not None:
            raise h._ack_err
        return h

    def submit(self, prompt_ids, max_new_tokens=16, on_token=None,
               on_done=None, **params):
        return self._request({
            "op": "submit",
            "prompt": np.asarray(prompt_ids).reshape(-1).tolist(),
            "max_new_tokens": int(max_new_tokens),
            "params": params}, on_token, on_done)

    def adopt(self, source, on_token=None, on_done=None):
        """Adopt a migrated session ticket in the child — the same
        register-before-send / ack-wait shape as `submit`, because the
        child streams the replayed tokens before its ack."""
        return self._request({"op": "adopt", "source": source},
                             on_token, on_done)

    def health(self, timeout=2.0) -> dict:
        if self._dead:
            raise ConnectionError(
                f"replica {self.name} process is dead")
        seq = next(self._hseq)
        w = [threading.Event(), None]
        with self._lock:
            self._health_waits[seq] = w
        self._send_op({"op": "health", "seq": seq})
        if not w[0].wait(timeout):
            with self._lock:
                self._health_waits.pop(seq, None)
            raise ConnectionError(
                f"replica {self.name} health probe timed out "
                f"({timeout}s)")
        msg = w[1]
        if not msg["ok"]:
            raise ConnectionError(
                f"replica {self.name} unhealthy: {msg['error']}")
        return msg["data"]

    def arm_fault(self, site, timeout=10.0, **kw):
        """Arm one fault-injector rule INSIDE the child process (the
        chaos sweep's remote trigger — rules must land across the
        process boundary, not in the parent's injector).  `kw` rides
        JSON, so pass `exc` by name ("InjectedFault",
        "InjectedConnectionError") or as None for delay-only wedges.
        Blocks until the child acks the rule is live."""
        self._ctl({"op": "fault", "site": site, "kw": kw}, timeout)

    def clear_faults(self, timeout=10.0):
        """Drop every armed rule in the child (sweep teardown)."""
        self._ctl({"op": "fault_clear"}, timeout)

    def quarantine(self, reason="operator request", timeout=10.0):
        """Flip the child into the sticky ``quarantined`` state — the
        same state a canary mismatch sets: new submits and adoptions
        are refused, liveness and the lease stay green, and the router
        migrates its parked sessions and retires it.  Operator hook
        for drills and the CI chaos rung."""
        self._ctl({"op": "quarantine", "reason": reason}, timeout)

    def clock_sync(self, timeout=10.0) -> int:
        """NTP-style clock handshake: bracket one ctl round-trip with
        parent clock stamps, take the midpoint against the child's
        reply.  Returns (and stores on `clock_offset_ns`) the ns to ADD
        to the child's span timestamps to land them on the parent's
        clock — half the RTT of error, microseconds on loopback."""
        from ..observability import tracing as _trc
        t0 = _trc.clock_ns()
        reply = self._ctl({"op": "clock_sync"}, timeout)
        t1 = _trc.clock_ns()
        self.clock_offset_ns = (t0 + t1) // 2 - int(reply["t_ns"])
        return self.clock_offset_ns

    def pop_series(self):
        """Drain the payloads the child pushed since the last drain
        (oldest first) — the router's poll loop feeds these into its
        `FleetMetricsAggregator`."""
        with self._lock:
            out, self._series_q = self._series_q, []
        return [p for p in out if p]

    def metrics_series(self, n=15, timeout=10.0):
        """On-demand pull of the child's windowed series tails (the
        ``metrics_series`` ctl op); the periodic push is the
        steady-state path."""
        reply = self._ctl({"op": "metrics_series", "n": int(n)}, timeout)
        return reply.get("payload")

    def pull_trace(self, clear=False, timeout=10.0) -> list:
        """Drain the child's span ring buffer; pair with `clock_sync()`
        to merge into the parent's timeline."""
        reply = self._ctl({"op": "trace", "clear": bool(clear)}, timeout)
        return reply.get("spans", [])

    def _ctl(self, msg, timeout):
        seq = next(self._hseq)
        w = [threading.Event(), None]
        with self._lock:
            self._health_waits[seq] = w
        msg["seq"] = seq
        self._send_op(msg)
        if not w[0].wait(timeout):
            with self._lock:
                self._health_waits.pop(seq, None)
            raise ConnectionError(
                f"replica {self.name} control op {msg['op']!r} timed "
                f"out ({timeout}s)")
        if not w[1]["ok"]:
            raise RuntimeError(
                f"replica {self.name} {msg['op']} failed: "
                f"{w[1]['error']}")
        return w[1]

    # -- lifecycle ----------------------------------------------------------

    def _shutdown(self, drain=False, drain_timeout=30.0):
        try:
            self._send_op({"op": "shutdown", "drain": drain,
                           "drain_timeout": drain_timeout})
        except EngineUnhealthy:
            pass                    # already dead is shut down enough
        self._bye.wait(drain_timeout + 10.0)
        # proc is None for acceptor-attached replicas (HA mode): the
        # process belongs to whoever spawned it, not to this router
        if self.proc is not None:
            self.proc.join(timeout=10.0)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(timeout=5.0)
        self._mark_dead(RuntimeError("shut down"))
        try:
            self._conn.close()
        except OSError:
            pass

    def kill(self):
        """SIGKILL the replica process — the crash the failover drills
        recover from.  No cleanup runs in the child: its lease simply
        stops beating, exactly like a real host loss."""
        if self.proc is not None:
            self.proc.kill()
            self.proc.join(timeout=10.0)
        self._mark_dead(RuntimeError("killed by test harness"))


class _RespawnBreaker:
    """Crash-loop containment for replica respawns.  Each respawn of a
    slot inside the rolling window pays exponential backoff
    (`backoff_s * 2**(k-1)` after k prior respawns); at `max_respawns`
    inside the window the circuit opens and further respawns raise
    `RespawnCircuitOpen` until the window drains.  Clock and sleep are
    injectable so the unit tests drive hours of breaker history in
    microseconds."""

    def __init__(self, backoff_s=0.5, max_respawns=5, window_s=60.0,
                 clock=time.monotonic, sleep=time.sleep):
        self.backoff_s = float(backoff_s)
        self.max_respawns = int(max_respawns)
        self.window_s = float(window_s)
        self.clock = clock
        self.sleep = sleep
        self._hist = {}             # name -> respawn stamps in window
        self._lock = threading.Lock()

    def admit(self, name) -> float:
        """Record one respawn attempt for `name`; returns the backoff
        to apply (0.0 for the first in a fresh window) or raises
        `RespawnCircuitOpen`."""
        with self._lock:
            now = self.clock()
            hist = [t for t in self._hist.get(name, ())
                    if now - t < self.window_s]
            if len(hist) >= self.max_respawns:
                self._hist[name] = hist
                raise RespawnCircuitOpen(
                    f"replica slot {name!r}: {len(hist)} respawns in "
                    f"the last {self.window_s:.0f}s — circuit open")
            delay = (self.backoff_s * (2.0 ** (len(hist) - 1))
                     if hist else 0.0)
            hist.append(now)
            self._hist[name] = hist
            return delay

    def state(self) -> dict:
        """Per-slot breaker view for `/debug/fleet`."""
        with self._lock:
            now = self.clock()
            out = {}
            for name, hist in self._hist.items():
                live = [t for t in hist if now - t < self.window_s]
                out[name] = {
                    "respawns_in_window": len(live),
                    "open": len(live) >= self.max_respawns,
                    "window_s": self.window_s,
                    "next_backoff_s": (
                        self.backoff_s * (2.0 ** (len(live) - 1))
                        if live else 0.0),
                }
            return out

    def reset(self, name=None):
        with self._lock:
            if name is None:
                self._hist.clear()
            else:
                self._hist.pop(name, None)


class ProcessFleet:
    """N replica *processes* over one model spec, leases in a master
    store the fleet owns.  API mirrors `LocalFleet` (spawn / live /
    shutdown, `.replicas`) plus `kill(name)` for crash drills.

    `model_spec` is ``{"preset", "seed", "overrides", "device",
    "arrays"}`` (module docstring) — each child rebuilds the model
    itself from the seed, so the same spec means the same weights in
    every process (the basis for comparing fleet streams token for
    token against a single-process reference)."""

    def __init__(self, model_spec, n=2, job_id="pfleet", lease_ttl=5.0,
                 name_prefix="proc", spawn_timeout=240.0, trace=None,
                 series_push_s=2.0, roles=None, role_kw=None,
                 store_dir=None, wal_fsync=False, store_addr=None,
                 ha=False, respawn_backoff_s=0.5, max_respawns=5,
                 respawn_window_s=60.0, **engine_kw):
        self.model_spec = dict(model_spec)
        self.job_id = job_id
        self._lease_ttl = float(lease_ttl)
        self._name_prefix = name_prefix
        # disaggregated serving: per-spawn pool roles, e.g.
        # roles=("prefill", "decode", "decode"); spawns past the end
        # of the list default to "mixed"
        self._roles = list(roles) if roles is not None else []
        # specialist engine tuning: per-role engine_kw overlays, e.g.
        # role_kw={"decode": {"max_slots": 4}} — a decode specialist
        # wants batch depth, a prefill specialist wants slot turnover
        self._role_kw = {k: dict(v) for k, v in (role_kw or {}).items()}
        # tracing config shipped to every child:
        # {"flight_dir": ..., "capacity": ...}; truthy = enabled
        self._trace = trace
        # fleet shipping cadence; None disables the push (the
        # metrics_series ctl pull still works)
        self._series_push_s = series_push_s
        self._engine_kw = dict(engine_kw)
        self._spawn_timeout = float(spawn_timeout)
        self._ctx = multiprocessing.get_context("spawn")
        # control-plane HA: the store may be durable (WAL + snapshots
        # under `store_dir`, restart-recoverable) or external
        # (`store_addr` — owned by another process)
        if store_addr is not None:
            self.store = TCPStore(store_addr[0], int(store_addr[1]),
                                  is_master=False)
            self._owns_store = False
        else:
            self.store = TCPStore("127.0.0.1", 0, is_master=True,
                                  world_size=1, durable_dir=store_dir,
                                  wal_fsync=wal_fsync)
            self._owns_store = True
        # HA mode: children discover the leading router through the
        # store and connect to ITS acceptor — this parent only owns the
        # processes (spawn/kill), never a control channel
        self._ha = bool(ha)
        self.procs = {}             # HA mode: name -> Process
        # crash-loop breaker behind `respawn()`
        self.breaker = _RespawnBreaker(backoff_s=respawn_backoff_s,
                                       max_respawns=max_respawns,
                                       window_s=respawn_window_s)
        from ..observability.metrics import get_registry
        self._m_respawn_backoff = get_registry().counter(
            "fleet_respawn_backoff_total",
            help="respawns delayed by the crash-loop breaker's "
                 "exponential backoff")
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(64)
        self._ctrl_port = self._listener.getsockname()[1]
        self._next_idx = 0
        self.replicas = []
        try:
            for _ in range(int(n)):
                self.spawn()
        except BaseException:
            self.shutdown()
            raise

    def spawn(self, pool_role=None, name=None):
        """Start one more replica process; blocks until its hello
        (model built, engine up, graphs captured, lease registered).
        `pool_role` overrides the constructor's `roles` assignment for
        this spawn; `name` reuses a slot (respawn path — the lease
        protocol hands the newcomer generation+1, so the router fences
        the dead incarnation, never the fresh one).  In HA mode the
        child introduces itself to the *leading router* instead of
        this parent, so spawn returns the bare `Process` without
        waiting for a hello."""
        if name is None:
            name = f"{self._name_prefix}{self._next_idx}"
        if pool_role is None:
            pool_role = (self._roles[self._next_idx]
                         if self._next_idx < len(self._roles)
                         else "mixed")
        self._next_idx += 1
        ekw = dict(self._engine_kw)
        ekw.update(self._role_kw.get(pool_role, {}))
        cfg = {
            "name": name,
            "pool_role": pool_role,
            "host": "127.0.0.1", "port": self._ctrl_port,
            "store_host": self.store.host,
            "store_port": self.store.port,
            "job_id": self.job_id, "lease_ttl": self._lease_ttl,
            "model_spec": self.model_spec,
            "engine_kw": ekw,
            "trace": self._trace,
            "series_push_s": self._series_push_s,
            "ha": self._ha,
        }
        proc = self._ctx.Process(target=_replica_main, args=(cfg,),
                                 daemon=True, name=f"replica-{name}")
        proc.start()
        if self._ha:
            self.procs[name] = proc
            return proc
        deadline = time.monotonic() + self._spawn_timeout
        self._listener.settimeout(5.0)
        conn = chan = hello = None
        while time.monotonic() < deadline:
            if not proc.is_alive():
                raise RuntimeError(
                    f"replica {name} exited during startup "
                    f"(code {proc.exitcode})")
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            # the channel's persistent timeout bounds the hello read
            # too: a child that connects but never speaks fails the
            # spawn instead of hanging it
            chan = _LineChannel(conn)
            try:
                line = chan.readline()
                hello = json.loads(line) if line else None
            except socket.timeout:
                pass
            break
        if hello is None:
            proc.kill()
            raise RuntimeError(
                f"replica {name} did not hello within "
                f"{self._spawn_timeout}s")
        assert hello["op"] == "hello" and hello["name"] == name, hello
        rep = ProcessReplica(name, proc, conn, chan, hello, self.store,
                             self.job_id)
        self.replicas.append(rep)
        return rep

    def trace_buffers(self, clear=False):
        """One `tracing.chrome_trace`-ready buffer per live replica:
        clock-sync each child, then drain its span ring — child spans
        land on THIS process's clock after the offset is applied.  Dead
        replicas are skipped (their last timelines are in the
        flight-recorder dumps, not the ring)."""
        bufs = []
        for rep in self.replicas:
            if rep._dead:
                continue
            try:
                off = rep.clock_sync()
                spans = rep.pull_trace(clear=clear)
            except (ConnectionError, RuntimeError, EngineUnhealthy):
                continue
            bufs.append({"label": rep.name, "offset_ns": off,
                         "spans": spans})
        return bufs

    def kill(self, name):
        """SIGKILL replica `name` (crash drill)."""
        if name in self.procs:      # HA mode: raw process handle
            self.procs[name].kill()
            self.procs[name].join(timeout=10.0)
            return
        for rep in self.replicas:
            if rep.name == name:
                rep.kill()
                return
        raise KeyError(f"unknown replica {name!r}")

    def respawn(self, name):
        """Replace dead replica `name` with a fresh process under the
        SAME slot name, through the crash-loop breaker: consecutive
        respawns inside the window pay exponential backoff (counted by
        ``fleet_respawn_backoff_total``), and past `max_respawns` the
        breaker opens and this raises `RespawnCircuitOpen` — a slot
        that keeps dying is a symptom, and hammering restarts at it
        only spreads the damage."""
        delay = self.breaker.admit(name)    # may raise circuit-open
        if delay > 0:
            self._m_respawn_backoff.inc()
            self.breaker.sleep(delay)
        if self._ha or name in self.procs:
            old = self.procs.get(name)
            if old is not None and old.is_alive():
                raise RuntimeError(
                    f"replica {name} is still alive; kill it first")
            return self.spawn(name=name)
        old = None
        for rep in self.replicas:
            if rep.name == name:
                old = rep
        if old is None:
            raise KeyError(f"unknown replica {name!r}")
        if not old._dead:
            raise RuntimeError(
                f"replica {name} is still alive; kill it first")
        self.replicas.remove(old)
        return self.spawn(pool_role=old.pool_role, name=name)

    def respawn_state(self) -> dict:
        """Breaker state per slot — registered on the router's
        `/debug/fleet` via `add_debug_section("respawn", ...)`."""
        return self.breaker.state()

    def reset_breaker(self, name=None):
        """Operator override: forget respawn history for one slot (or
        all) so a circuit-open slot may be revived deliberately."""
        self.breaker.reset(name)

    def live(self) -> dict:
        return live_replicas(self.store, self.job_id)

    def shutdown(self):
        for rep in self.replicas:
            try:
                rep._shutdown()
            except Exception:       # noqa: BLE001 — best-effort teardown
                pass
        # HA-mode children belong to no control channel here: SIGKILL
        # is the only teardown (their leases just expire)
        for proc in self.procs.values():
            try:
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5.0)
            except Exception:       # noqa: BLE001 — best-effort teardown
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        self.store.close()
