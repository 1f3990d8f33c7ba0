"""Serving-fleet membership over the store: the port of the JAX
package's `inference/fleet_serving.py`, with its key layout, lease
tuples and jitter, so a fleet of either package reads the other's
store.

Three pieces turn N independent `LLMServer`s into a fleet a router can
manage:

  * the **lease protocol** — each replica registers an epoch-fenced
    lease `(timestamp, ttl, generation)` under
    ``fleet/<job>/replica/<name>`` and refreshes it from a heartbeat
    thread.  The *generation* comes from a store-side `add` on
    ``fleet/<job>/gen/<name>`` (exactly once under retries, so two
    racing registrations never share one), and a monotonic fence key
    ``fleet/<job>/fence/<name>`` (advanced by CAS) records the highest
    generation declared dead: a fenced generation's heartbeat never
    makes it live again, while a *restarted* replica re-registers at
    generation + 1 and is live at once.  Heartbeats are spaced by the
    interval with a ±10 % jitter drawn from
    ``random.Random(f"{job}/{name}")``, the JAX sequence exactly;
  * `Replica` — one routable unit: an `LLMServer`, its lease, and a
    health probe (the /healthz JSON over HTTP when the metrics daemon
    is up — what a remote router would see — or the in-process
    snapshot otherwise);
  * `LocalFleet` — N in-process replicas over one model (parameters
    shared; each replica has its own engine, KV pool, prefix cache and
    scheduler), registered in a store the fleet owns unless one is
    passed.  On the card each spawn captures its replica's CUDA graphs
    (`prepare_programs`) before its lease registers, so the replicas
    built by the constructor are booted before any takes traffic (a
    capture must not run beside another thread's CUDA work).

The router that places requests over these replicas is
`inference/router.py::Router`; the router-endpoint helpers are here
because they are plain store keys.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.request

from ..distributed.store import StoreError, TCPStore
from .serving import LLMServer

__all__ = ["ReplicaLease", "Replica", "LocalFleet", "fence_replica",
           "fenced_generation", "live_replicas", "set_replica_status",
           "replica_status", "set_replica_role", "replica_role",
           "router_endpoint_key", "publish_router_endpoint",
           "router_endpoint", "ROUTER_LEADER"]

_RETRIABLE = (StoreError, ConnectionError, OSError)


def _lease_key(job, name):
    return f"fleet/{job}/replica/{name}"


def _gen_key(job, name):
    return f"fleet/{job}/gen/{name}"


def _fence_key(job, name):
    return f"fleet/{job}/fence/{name}"


def _status_key(job, name):
    return f"fleet/{job}/status/{name}"


def _role_key(job, name):
    return f"fleet/{job}/role/{name}"


# control-plane HA: the reserved replica-namespace name the
# router leader's own lease registers under — `/replica/` keying means
# the durable store's restart grace covers it like any other lease,
# and the generation counter doubles as the router EPOCH.
ROUTER_LEADER = "__router_leader__"


def router_endpoint_key(job, kind):
    """Store key advertising one of the leader's endpoints (`kind` in
    {"ctrl", "journal", "gateway"})."""
    return f"fleet/{job}/router/{kind}"


def publish_router_endpoint(store, job, kind, host, port, epoch,
                            timeout=None):
    """Advertise a leader endpoint as ``[host, port, epoch]``.  The
    epoch rides along so a consumer holding a connection into a
    live-zombie ex-leader can recognise the advertisement moved on."""
    store.set(router_endpoint_key(job, kind),
              [str(host), int(port), int(epoch)], timeout=timeout)


def router_endpoint(store, job, kind, timeout=None):
    """``(host, port, epoch)`` last advertised for `kind`, or None."""
    v = store.get(router_endpoint_key(job, kind), timeout=timeout)
    if not isinstance(v, (tuple, list)) or len(v) < 2:
        return None
    epoch = int(v[2]) if len(v) > 2 else 0
    return (str(v[0]), int(v[1]), epoch)


def set_replica_role(store, job, name, role, timeout=None):
    """Advertise `name`'s placement pool next to its lease:
    "prefill" | "decode" | "mixed".  Advisory like the status key —
    the lease tuple itself stays (timestamp, ttl, generation) so older
    fleet members keep parsing it — but it makes pool membership
    discoverable from the store alone (a successor router rebuilding
    the fleet view learns the pools before its first health sweep)."""
    store.set(_role_key(job, name), str(role), timeout=timeout)


def replica_role(store, job, name, timeout=None) -> str:
    """The placement pool last advertised for `name` ("mixed"
    default)."""
    return str(store.get(_role_key(job, name), timeout=timeout)
               or "mixed")


def set_replica_status(store, job, name, status, timeout=None):
    """Publish an advisory health status for `name` —
    distinct from the fence: a ``"quarantined"`` replica still holds a
    LIVE lease (it is up and draining its in-flight work), while
    fencing declares a generation dead.  The router writes this when a
    canary trips so operators and peer routers can tell "don't trust
    its data" apart from "it crashed"."""
    store.set(_status_key(job, name), str(status), timeout=timeout)


def replica_status(store, job, name, timeout=None) -> str:
    """The advisory status last published for `name` ("ok" default)."""
    return str(store.get(_status_key(job, name), timeout=timeout)
               or "ok")


def fence_replica(store, job, name, generation, timeout=None) -> int:
    """Declare every lease of `name` up to and including `generation`
    dead.  Monotonic under races (concurrent fencers keep the max, via
    CAS); returns the fence value after the call."""
    generation = int(generation)
    while True:
        cur = store.get(_fence_key(job, name), timeout=timeout)
        if cur is not None and int(cur) >= generation:
            return int(cur)
        ok, _ = store.compare_and_set(_fence_key(job, name), cur,
                                      generation, timeout=timeout)
        if ok:
            return generation


def fenced_generation(store, job, name, timeout=None) -> int:
    """Highest generation of `name` declared dead (0 = none)."""
    return int(store.get(_fence_key(job, name), timeout=timeout) or 0)


def live_replicas(store, job, timeout=None) -> dict:
    """{name: (timestamp, ttl, generation)} for every replica holding
    an unexpired lease whose generation is above the fence."""
    now = time.time()
    prefix = f"fleet/{job}/replica/"
    keys = store.list_keys(timeout=timeout)
    out = {}
    for k, v in keys.items():
        if not k.startswith(prefix):
            continue
        if not isinstance(v, (tuple, list)) or len(v) != 3:
            continue
        ts, ttl, gen = float(v[0]), float(v[1]), int(v[2])
        name = k[len(prefix):]
        if gen <= int(keys.get(_fence_key(job, name)) or 0):
            continue
        if now - ts <= ttl:
            out[name] = (ts, ttl, gen)
    return out


class ReplicaLease:
    """One replica's epoch-fenced lease: `register()` takes the next
    generation for this name and starts the heartbeat thread;
    `release()` stops refreshing and deletes the lease (graceful
    drain).  A heartbeat that observes its own generation fenced stops
    refreshing permanently — the router's verdict is final even if the
    replica process is merely wedged, not dead."""

    def __init__(self, store, job_id, name, ttl=5.0, interval=None):
        self.store = store
        self.job_id = job_id
        self.name = name
        self.ttl = float(ttl)
        self.interval = (float(interval) if interval is not None
                         else self.ttl / 3.0)
        self.generation = None
        self._stop = threading.Event()
        self._thread = None
        # per-name seeded jitter de-synchronizes the fleet's heartbeat
        # schedules: after a store restart every replica would otherwise
        # reconnect+beat on the same metronome tick (thundering herd);
        # seeding by identity keeps each schedule reproducible
        self._jitter_rng = random.Random(f"{job_id}/{name}")

    def _next_interval(self) -> float:
        """Heartbeat spacing with deterministic ±10% jitter."""
        return self.interval * (
            1.0 + 0.1 * (2.0 * self._jitter_rng.random() - 1.0))

    def register(self) -> int:
        self.generation = int(self.store.add(
            _gen_key(self.job_id, self.name), 1))
        self.store.set(_lease_key(self.job_id, self.name), self._lease())
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()
        return self.generation

    def _lease(self):
        return (time.time(), self.ttl, self.generation)

    @property
    def fenced(self) -> bool:
        try:
            return (self.generation is not None
                    and fenced_generation(self.store, self.job_id,
                                          self.name) >= self.generation)
        except _RETRIABLE:
            return False

    def _beat(self):
        while not self._stop.wait(self._next_interval()):
            try:
                if self.fenced:
                    return          # declared dead: stay dead
                self.store.set(_lease_key(self.job_id, self.name),
                               self._lease(),
                               timeout=self.interval + self.ttl)
            except _RETRIABLE:
                continue            # store client already retried; next beat

    def release(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        try:
            self.store.delete_key(_lease_key(self.job_id, self.name))
        except _RETRIABLE:
            pass


class Replica:
    """One routable serving unit: `submit()` proxies to the server,
    `health()` raises when the replica is unreachable or 503 (the
    router treats either as a crash signal)."""

    def __init__(self, name, server, lease=None):
        self.name = name
        self.server = server
        self.lease = lease
        eng = server.engine
        has_cache = getattr(eng, "_pcache", None) is not None
        # the router's PrefixShadow mirrors this replica's radix cache
        # at the same block granularity and capacity
        self.block_tokens = (int(eng.prefix_block_tokens)
                             if has_cache else 0)
        self.cache_blocks = int(eng._pcache.n_blocks) if has_cache else 0
        # disaggregated serving: surfaced so the router's
        # pool registry seeds correctly before the first health poll
        self.pool_role = str(getattr(server, "pool_role", None)
                             or "mixed")

    def submit(self, prompt_ids, max_new_tokens=16, **kw):
        return self.server.submit(prompt_ids, max_new_tokens, **kw)

    @property
    def fabric_address(self):
        """(host, port) of the server's KV-fabric endpoint, or None
        when the fabric is not configured."""
        return getattr(self.server, "fabric_address", None)

    def adopt(self, source, on_token=None, on_done=None):
        """Adopt a migrated session ticket — see
        `LLMServer.adopt`."""
        return self.server.adopt(source, on_token=on_token,
                                 on_done=on_done)

    def health(self, timeout=2.0) -> dict:
        """The /healthz JSON — over HTTP when the metrics daemon is on
        (what a remote router sees; raises HTTPError on 503), the
        in-process snapshot otherwise (raises ConnectionError when the
        driver crashed or was shut down)."""
        if self.server.metrics_address is not None:
            host, port = self.server.metrics_address
            url = f"http://{host}:{port}/healthz"
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return json.loads(r.read().decode())
        snap = self.server.health_snapshot()
        if not self.server.healthy:
            raise ConnectionError(
                f"replica {self.name} {snap['status']}: "
                f"{self.server._error!r}")
        return snap


class LocalFleet:
    """N in-process replicas over one model — each with its own engine
    (KV pool, prefix cache, scheduler), parameters shared — with leases
    registered in `store` (the fleet owns an ephemeral master store
    when none is passed)."""

    def __init__(self, model, n=2, store=None, job_id="fleet",
                 metrics_port=None, lease_ttl=5.0, lease_interval=None,
                 name_prefix="replica", roles=None, role_kw=None,
                 **engine_kw):
        self._own_store = store is None
        self.store = store if store is not None else TCPStore(
            "127.0.0.1", 0, is_master=True, world_size=1)
        self.job_id = job_id
        self._model = model
        self._metrics_port = metrics_port
        self._lease_ttl = lease_ttl
        self._lease_interval = lease_interval
        self._name_prefix = name_prefix
        # disaggregated serving: per-spawn pool roles, e.g.
        # roles=("prefill", "decode", "decode"); spawns past the end
        # of the list (autoscale scale-ups) default to "mixed"
        self._roles = list(roles) if roles is not None else []
        # specialist engine tuning: per-role engine_kw
        # overlays, e.g. role_kw={"decode": {"max_slots": 4}}
        self._role_kw = {k: dict(v) for k, v in (role_kw or {}).items()}
        self._engine_kw = dict(engine_kw)
        self._next_idx = 0
        self.replicas = []
        for _ in range(int(n)):
            self.spawn()

    def spawn(self, pool_role=None) -> Replica:
        """Start one more replica and register its lease (the scale-up
        primitive the router's autoscale hook calls).  `pool_role`
        overrides the constructor's `roles` assignment for this
        spawn."""
        name = f"{self._name_prefix}{self._next_idx}"
        if pool_role is None:
            pool_role = (self._roles[self._next_idx]
                         if self._next_idx < len(self._roles)
                         else "mixed")
        # one HTTP daemon per replica: the configured port goes to the
        # first spawn only; later replicas bind an ephemeral port (the
        # actual address lands in server.metrics_address) — reusing a
        # fixed nonzero port would fail to bind from the second spawn
        port = self._metrics_port
        if port is not None and self._next_idx > 0:
            port = 0
        self._next_idx += 1
        ekw = dict(self._engine_kw)
        ekw.update(self._role_kw.get(pool_role, {}))
        server = LLMServer(self._model, metrics_port=port,
                           name=name, pool_role=pool_role,
                           **ekw)
        if server.engine._graphs is not None:
            server.engine.prepare_programs()
        lease = ReplicaLease(self.store, self.job_id, name,
                             ttl=self._lease_ttl,
                             interval=self._lease_interval)
        lease.register()
        try:
            set_replica_role(self.store, self.job_id, name, pool_role)
        except _RETRIABLE:
            pass                    # advisory: /healthz still carries it
        rep = Replica(name, server, lease)
        self.replicas.append(rep)
        return rep

    def live(self) -> dict:
        return live_replicas(self.store, self.job_id)

    def shutdown(self):
        for rep in self.replicas:
            try:
                rep.server.shutdown()
            finally:
                if rep.lease is not None:
                    rep.lease.release()
        if self._own_store:
            self.store.close()
