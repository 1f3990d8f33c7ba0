"""Thread-safe serving front over the port's `LLMEngine` — the port of
`paddle_tpu/inference/serving.py::LLMServer`.

Any thread `submit()`s; one driver thread runs the engine's
iteration-level scheduler, so requests batch onto the same vectorised
decode step.  `submit()` returns the live `Request` — poll `.done` /
`.tokens`, or block on `result()`.  An exception escaping the driver
thread fails every pending request with `EngineUnhealthy` and flips
`submit()` into raising, so no waiter hangs.  Under the engine's
overlap driver the driver thread commits the step in flight
(`LLMEngine.flush`) before it stops.

Beside the driver, as in the JAX server:

  * `metrics_port` (0 = ephemeral) starts a daemon HTTP thread serving
    the Prometheus text at /metrics (the engine's registry plus the
    process-global one), the JSON `health_snapshot()` at /healthz (200
    while the driver serves, 503 after a crash or shutdown) and one
    request's span timeline at /debug/trace; the bound address is
    `metrics_address`;
  * the canary (`canary_interval`): a seeded golden prompt whose greedy
    tokens are captured at boot and re-generated every interval as a
    normal lowest-priority request; a mismatch quarantines the server
    (alive and draining, `submit()` refused with `EngineUnhealthy`);
  * the hang watchdog (`watchdog_deadline`): work pending and the
    engine's step heartbeat older than the deadline reads `stalled` in
    `health_snapshot()`;
  * the metrics series (`series_interval`): a `TimeSeriesStore`
    sampling the engine's registry on its own thread, whose windowed
    ITL p50 feeds the overload ladder;
  * the KV fabric endpoint (an engine `fabric` config): a
    `kv_fabric.FabricServer` on 127.0.0.1 (`fabric_address`) serving
    the engine's cached prefixes, parked sessions and handoff frames to
    peers; every verb that touches the engine runs on the driver thread
    (`_fabric_exec`), the handoff rx verbs (host memory only) on the
    connection thread.  `adopt()` continues a session from the disk
    tier, a peer or a staged handoff; `pool_role` ("prefill", "decode",
    "mixed") is advertised in `health_snapshot()` (placement is a
    router's job: the engine serves either way);
  * the surface `inference/router.py::Router` dispatches into:
    `submit(router_epoch=)` keeps a high-water mark of the router
    leadership epochs it has served (None until the first) and raises
    `StaleRouterEpoch` for a lower one (a submit without an epoch is
    always accepted); `submit(chaos_mark=)` fires the `replica.poison`
    fault site once the request is queued, and an armed rule makes the
    driver raise that fault at its next real step, right after the
    `replica.crash` site, so the marked request and every co-batched one
    fail with `EngineUnhealthy` (the poison drill).

`health_snapshot()` reports each feature the port lacks at its "off"
value.  A driver that dies with a decode step in flight (overlap)
commits that step first (`_settle_inflight`), so no graph replay or
token copy of a crashed replica still runs when its requests fail and
its buffers are later dropped.

On the card, capture every server's graphs (the engine's
`prepare_programs()`) before any traffic reaches any of them: a CUDA
graph is captured in the default "global" mode, and a CUDA call from
another thread during a capture would break it.  The fabric's threads
make none (they move host bytes); the driver threads do.
"""

from __future__ import annotations

import http.server
import json
import queue as _queue
import threading
import time
import urllib.parse

import numpy as np

from ..observability import get_registry
from ..observability import tracing as _tr
from ..observability.slo import SLOTier
from ..observability.timeseries import TimeSeriesStore
from ..testing import faults as _faults
from . import kv_fabric as _kvf
from .engine import (EngineUnhealthy, LLMEngine, QueueFull, Request,
                     ResultTimeout, StaleRouterEpoch)
from .kv_fabric import FabricServer

__all__ = ["LLMServer"]


class LLMServer:
    """Thread-safe front over `LLMEngine(model, **engine_kw)` (every
    knob the engine takes).  The parameters before `engine_kw` are the
    JAX server's, in its order: `metrics_port` / `metrics_host` (the
    HTTP thread), `default_result_timeout` (bounds every `result()`
    wait), `name`, `canary_interval` / `canary_prompt_len` /
    `canary_max_new`, `watchdog_deadline` (seconds; None disables it),
    `series_interval` (seconds; None or 0 disables the sampler) /
    `series_tiers` / `series_max_bytes`, and `pool_role` ("prefill",
    "decode" or "mixed"; any other raises ValueError).  With a `fabric`
    config (not empty, and no ``"serve": False`` in it) the server
    listens on ``fabric_host`` (127.0.0.1) / ``fabric_port`` (0:
    ephemeral)."""

    def __init__(self, model, metrics_port=None, metrics_host="127.0.0.1",
                 default_result_timeout=600.0, name=None,
                 canary_interval=None, canary_prompt_len=8,
                 canary_max_new=4, watchdog_deadline=120.0,
                 series_interval=1.0, series_tiers=None,
                 series_max_bytes=None, pool_role="mixed", **engine_kw):
        if pool_role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"unknown pool_role {pool_role!r} "
                             "('prefill', 'decode', or 'mixed')")
        self.pool_role = pool_role
        t_boot = time.perf_counter()
        self._t_boot_anchor = t_boot
        self.engine = LLMEngine(model, **engine_kw)
        self.boot_engine_s = time.perf_counter() - t_boot
        self.boot_first_token_s = None
        self.name = name if name is not None else f"llm-server-{id(self):x}"
        self.default_result_timeout = default_result_timeout
        self._pending: _queue.Queue = _queue.Queue()
        self._events = {}
        self._events_lock = threading.Lock()
        self._closing = threading.Event()
        self._draining = threading.Event()
        self._n_unfinished = 0       # accepted, on_done not yet fired
        self._error = None           # the driver thread's fatal exception
        self._http = None
        self.metrics_address = None
        # canary, quarantine and watchdog state
        self._canary_interval = (None if canary_interval is None
                                 else float(canary_interval))
        self._canary_prompt = None
        self._canary_expected = None
        self._canary_inflight = False
        self._canary_last = float("-inf")
        self._canary_waiters = []
        self._quarantined = threading.Event()
        self.quarantine_reason = None
        # the router leadership epoch's high-water mark (None until a
        # dispatch carries one), and the fault a `chaos_mark` armed for
        # the driver's next real step
        self._router_epoch_hw = None
        self._poison_pending = None
        self.watchdog_deadline = (None if watchdog_deadline is None
                                  else float(watchdog_deadline))
        self._stall_flagged = False
        reg = self.engine.metrics_registry
        self._m_canary_probes = reg.counter(
            "canary_probes_total", "Golden self-probes launched")
        self._m_canary_fail = reg.counter(
            "canary_failures_total",
            "Self-probes whose greedy tokens diverged from the "
            "boot-time capture (each one quarantines the replica)")
        self._m_quar = reg.gauge(
            "quarantined",
            "1 once this replica quarantined itself (canary mismatch)")
        self._m_stalls = reg.counter(
            "watchdog_stalls_total",
            "Step-watchdog trips: work pending but the scheduler "
            "heartbeat older than watchdog_deadline")
        if metrics_port is not None:
            self._start_metrics_http(metrics_host, metrics_port)
        # the KV fabric endpoint: its handler closes over the engine, so
        # drop the server with `shutdown()` (and, on the card, run
        # gc.collect() before the next capture)
        self._fabric = None
        fcfg = self.engine._fabric_cfg
        if fcfg and fcfg.get("serve", True):
            self._fabric = FabricServer(
                self.engine.fabric_handler, executor=self._fabric_exec,
                host=fcfg.get("fabric_host", "127.0.0.1"),
                port=int(fcfg.get("fabric_port", 0)),
                conn_timeout=self.engine._fabric_timeout)
            self.engine._fabric_self_addr = tuple(self._fabric.address)
        if self._canary_interval is not None:
            self._canary_capture(int(canary_prompt_len),
                                 int(canary_max_new))
        # the series sampler runs on its own daemon thread, never on
        # the driver thread
        self.series_store = None
        self._series_stop = threading.Event()
        self._series_thread = None
        if series_interval is not None and series_interval > 0:
            self.series_store = TimeSeriesStore(
                reg, interval_s=float(series_interval), tiers=series_tiers,
                **({} if series_max_bytes is None
                   else {"max_bytes": series_max_bytes}),
                extra=self._series_extra)
            self._series_thread = threading.Thread(
                target=self._series_loop, name=f"series-{self.name}",
                daemon=True)
            self._series_thread.start()
        self.boot_s = time.perf_counter() - t_boot
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"driver-{self.name}")
        self._thread.start()

    # -- the KV fabric -------------------------------------------------------

    @property
    def fabric_address(self):
        """(host, port) of this server's fabric endpoint, or None."""
        return None if self._fabric is None else self._fabric.address

    def _fabric_exec(self, fn, verb=None):
        """Run `fn` on the driver thread (the engine is single-threaded):
        queue a job, wake an idle driver, wait.  The handoff rx verbs
        touch only host staging behind their own lock and run here, on
        the connection thread, so a prefill peer's frame costs wire time,
        not a decode step."""
        if self._error is not None or self._closing.is_set():
            raise RuntimeError(f"LLMServer {self.name} is not serving")
        if verb in ("handoff_chunk", "handoff_commit"):
            return fn()
        done = threading.Event()
        box = {}

        def job():
            try:
                box["out"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["err"] = e
            finally:
                done.set()

        self.engine._fabric_jobs.append(job)
        self._pending.put(None)         # wake the driver if parked idle
        if not done.wait(self.engine._fabric_timeout):
            raise TimeoutError(
                f"fabric job timed out after "
                f"{self.engine._fabric_timeout}s on {self.name}")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def adopt(self, source, on_token=None, on_done=None):
        """Adopt a migrated session.  `source`: ``{"kind": "disk",
        "session_id": sid}`` (claim its ticket from the disk tier),
        ``{"kind": "peer", "addr": [host, port], "session_id": sid}``
        (take it live from a peer over the fabric) or ``{"kind":
        "handoff", "session_id": sid}`` (claim the ticket a prefill peer
        staged here).  The session's delivered tokens replay through
        `on_token` before this returns; the resume path then continues
        the stream.  Returns the new Request; raises KeyError or
        FabricError when the session cannot be adopted (the caller
        replays the prompt)."""
        if self._error is not None:
            raise EngineUnhealthy(
                f"LLMServer driver thread crashed: {self._error!r}")
        if self._closing.is_set() or self._draining.is_set() \
                or self._quarantined.is_set():
            raise RuntimeError(
                f"LLMServer {self.name} is not accepting adoptions")
        eng = self.engine
        sid = source["session_id"]
        kind = source.get("kind", "disk")
        if kind == "handoff":
            # a tripped adopt loses the staged ticket's shortcut, never
            # the request: the caller replays the prompt
            _faults.fire("handoff.adopt", sid=sid, name=self.name)
            data = eng.claim_handoff(sid)
            if data is None:
                raise KeyError(f"no staged handoff ticket for session "
                               f"{sid!r} on {self.name}")
        elif kind == "peer":
            try:
                _faults.fire("fabric.pull", addr=tuple(source["addr"]),
                             op="take")
                _reply, data = _kvf.fabric_request(
                    tuple(source["addr"]),
                    {"verb": "take", "session_id": sid,
                     "trace_id": source.get("trace_id")},
                    timeout=eng._fabric_timeout)
            except (_faults.InjectedFault, OSError) as e:
                raise _kvf.FabricError(
                    f"peer take of {sid!r} failed: {e}") from e
        else:
            if eng._disk is None:
                raise _kvf.FabricError(
                    f"{self.name}: no disk tier to adopt {sid!r} from")
            data = eng._disk.claim_session(sid)
            if data is None:
                raise KeyError(f"no ticket for session {sid!r}")
        try:
            ticket = _kvf.SessionTicket.from_bytes(data)
        except _kvf.IntegrityError:
            # corrupt in flight or at rest: metered and consumed (the
            # same bytes can never succeed); the caller replays
            eng._m_integrity["ticket"].inc()
            raise
        # CRC and unpacking here, on the calling thread, not the driver
        prepared = eng.prepare_ticket_kv(ticket)
        done = threading.Event()

        def wrapped_done(req):
            if on_done is not None:
                on_done(req)
            with self._events_lock:
                self._n_unfinished -= 1
            done.set()

        def job():
            req = eng.adopt_ticket(ticket, on_token=on_token,
                                   on_done=wrapped_done,
                                   trace_id=source.get("trace_id"),
                                   prepared_kv=prepared)
            # registered before the driver steps it again: a drain
            # waits for adopted sessions too
            with self._events_lock:
                self._events[req.rid] = done
                self._n_unfinished += 1
            return req

        try:
            return self._fabric_exec(job)
        except Exception:
            if kind == "disk":
                # the claim consumed the ticket: put it back, so the
                # session stays adoptable
                try:
                    eng._disk.put_session(sid, data)
                except OSError:
                    pass
            raise

    # -- liveness, quarantine and the canary -------------------------------

    @property
    def healthy(self) -> bool:
        """True while the driver thread is alive and serving.  A
        quarantined server is still healthy: quarantine is a verdict on
        data trust, not liveness."""
        return self._error is None and not self._closing.is_set()

    @property
    def quarantined(self) -> bool:
        return self._quarantined.is_set()

    def quarantine(self, reason="operator request"):
        """Flip into the quarantined state: alive, still stepping the
        work in flight to completion, but `submit()` refuses new work.
        Parked requests freeze (the engine never resumes one here: its
        future KV is what the canary stopped trusting).  Idempotent."""
        if self._quarantined.is_set():
            return
        self.quarantine_reason = str(reason)
        self._quarantined.set()
        _tr.flight_record(f"quarantine-{self.name}")
        self.engine.freeze_parked = True
        self._m_quar.set(1)

    def _canary_capture(self, prompt_len, max_new):
        """Boot-time golden run on the constructor's thread (the driver
        has not started, so stepping the engine here is safe)."""
        eng = self.engine
        rng = np.random.default_rng(0x13C0FFEE)
        vocab = int(getattr(eng.cfg, "vocab_size", 256))
        n = max(1, min(int(prompt_len), eng.max_prompt_len))
        self._canary_prompt = rng.integers(1, max(2, vocab), size=n,
                                           dtype=np.int32)

        def first_tok(_req, _tok):
            if self.boot_first_token_s is None:
                self.boot_first_token_s = (time.perf_counter()
                                           - self._t_boot_anchor)
        req = eng.submit(self._canary_prompt,
                         max_new_tokens=max(1, int(max_new)),
                         greedy=True, priority=-(10 ** 6),
                         on_token=first_tok)
        guard = 0
        while not req.done and guard < 10_000:
            eng.step()
            guard += 1
        eng.flush()                 # overlap: commit the tail step
        if req.error is not None or not req.done:
            raise RuntimeError(
                f"canary capture failed on {self.name}: {req.error!r}")
        self._canary_expected = list(req.tokens)

    def _canary_tick(self):
        """Driver thread only: launch the periodic golden self-probe, a
        normal lowest-priority request riding the same scheduler."""
        if (self._canary_expected is None or self._canary_inflight
                or self._closing.is_set()):
            return
        now = time.monotonic()
        if now - self._canary_last < self._canary_interval:
            return
        self._canary_last = now
        self._canary_inflight = True
        self._m_canary_probes.inc()
        req = Request(self._canary_prompt, len(self._canary_expected),
                      greedy=True, priority=-(10 ** 6),
                      on_done=self._canary_done)
        self.engine._queue.append(req)

    def _canary_done(self, req):
        self._canary_inflight = False
        expected = self._canary_expected
        got = list(req.tokens)
        # conclusive only when the probe ran to full length without a
        # typed error: a shed or truncated probe is inconclusive
        verdict = None
        if req.error is None and len(got) == len(expected):
            verdict = (got == expected)
        try:
            _faults.fire("engine.canary", name=self.name)
        except _faults.InjectedFault:
            verdict = False       # an injected fault IS a mismatch
        if verdict is False:
            self._m_canary_fail.inc()
            self.quarantine(f"canary mismatch on {self.name}: "
                            f"got {got} expected {expected}")
        waiters, self._canary_waiters = self._canary_waiters, []
        for ev in waiters:
            ev.set()

    def probe_canary(self, timeout=30.0):
        """Force one canary probe now; blocks until it completes and
        returns True while the server is still trusted (not
        quarantined)."""
        if self._canary_expected is None:
            raise RuntimeError(
                "canary is disabled (canary_interval=None)")
        ev = threading.Event()
        self._canary_waiters.append(ev)
        self._canary_last = float("-inf")
        self._pending.put(None)     # wake an idle driver
        if not ev.wait(timeout):
            raise TimeoutError(
                f"canary probe still running after {timeout}s")
        return not self._quarantined.is_set()

    # -- /metrics, /healthz, /debug/trace ----------------------------------

    def _start_metrics_http(self, host, port):
        engine = self.engine
        server = self

        class _MetricsHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?")[0].rstrip("/")
                if path in ("", "/metrics"):
                    body = (engine.metrics_text()
                            + get_registry().prometheus_text()).encode()
                    self._reply(200, body)
                elif path == "/healthz":
                    body = json.dumps(server.health_snapshot(),
                                      sort_keys=True).encode() + b"\n"
                    self._reply(200 if server.healthy else 503, body,
                                ctype="application/json")
                elif path == "/debug/trace":
                    # one request's timeline: ?tid=<hex>, or ?rid=N
                    # resolved by scanning span args
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)
                    tid = (q.get("tid") or [None])[0]
                    rid = (q.get("rid") or [None])[0]
                    spans = _tr.snapshot_spans()
                    if tid is None and rid is not None:
                        try:
                            rid_n = int(rid)
                        except ValueError:
                            rid_n = rid
                        for sp in spans:
                            if (sp.get("args") or {}).get("rid") == rid_n:
                                tid = sp.get("trace_id")
                                break
                    if tid is None:
                        self.send_error(
                            404, "unknown rid/tid (or tracing disabled)")
                        return
                    tl = _tr.request_timeline(spans, tid)
                    body = json.dumps(
                        {"trace_id": tid, "n_spans": len(tl),
                         **_tr.chrome_trace(tl)}).encode() + b"\n"
                    self._reply(200, body, ctype="application/json")
                else:
                    self.send_error(404)

            def _reply(self, code, body,
                       ctype="text/plain; version=0.0.4"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # keep the serving log clean
                pass

        self._http = http.server.ThreadingHTTPServer(
            (host, port), _MetricsHandler)
        self._http.daemon_threads = True
        self.metrics_address = self._http.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True,
            name=f"metrics-{self.name}")
        self._http_thread.start()

    def metrics(self):
        """The engine's metrics snapshot (`LLMEngine.metrics()`)."""
        return self.engine.metrics()

    # -- the metrics series ------------------------------------------------

    def _series_extra(self):
        """Derived gauges sampled beside the registry."""
        eng = self.engine
        active = eng.num_active + eng.num_prefilling
        return {"llm_engine_occupancy":
                (active / eng.max_slots) if eng.max_slots else 0.0}

    def _series_loop(self):
        store = self.series_store
        # the overload ladder's ITL window: wide enough to smooth step
        # jitter, narrow enough to track a real shift
        itl_win = max(5.0, 5.0 * store.interval_s)
        while not self._series_stop.wait(store.interval_s):
            try:
                store.sample()
                # None while idle: the engine falls back to its EMA
                self.engine._itl_window_s = store.window_mean(
                    "llm_engine_itl_seconds:p50", itl_win)
            except Exception:  # noqa: BLE001 — sampling never stops serving
                pass

    def metrics_series(self, n=15):
        """The series store's recent tails plus this server's program
        cost rows; None when sampling is disabled."""
        if self.series_store is None:
            return None
        payload = self.series_store.export(n=n)
        payload["name"] = self.name
        payload["costs"] = self.program_costs()
        return payload

    def program_costs(self):
        """Achieved-vs-roofline rows of the serving programs the engine
        holds as AOT handles: none here, as the JAX server reports for
        an engine without AOT programs (the rows come with engine
        sub-slice (j))."""
        return []

    # -- health ------------------------------------------------------------

    def health_snapshot(self):
        """The small JSON-able liveness / load summary served at
        /healthz, with the JAX server's keys.  The watchdog is judged
        here, on the poller's thread: work pending and a step heartbeat
        older than `watchdog_deadline` reads `stalled`."""
        eng = self.engine
        active = eng.num_active + eng.num_prefilling
        now = time.monotonic()
        step_age = now - eng.last_step_t
        stalled = bool(self.watchdog_deadline is not None
                       and eng.has_work
                       and step_age > self.watchdog_deadline
                       and self._error is None
                       and not self._closing.is_set())
        if stalled and not self._stall_flagged:
            self._stall_flagged = True
            self._m_stalls.inc()
            _tr.flight_record(f"watchdog-{self.name}")
        elif not stalled:
            self._stall_flagged = False
        status = ("unhealthy" if self._error is not None
                  else "shutdown" if self._closing.is_set()
                  else "draining" if self._draining.is_set()
                  else "quarantined" if self._quarantined.is_set()
                  else "ok")
        reg = eng.metrics_registry
        ttft = reg.get("ttft_seconds")
        hg = reg.get("host_gap_seconds")
        return {
            "status": status,
            "name": self.name,
            "pool_role": self.pool_role,
            "quarantined": self._quarantined.is_set(),
            "quarantine_reason": self.quarantine_reason,
            "canary_probes": int(self._m_canary_probes.value),
            "canary_failures": int(self._m_canary_fail.value),
            "step_age_s": step_age,
            "stalled": stalled,
            "watchdog_stalls": int(self._m_stalls.value),
            "queue_depth": len(eng._queue) + self._pending.qsize(),
            "slots_active": active,
            "slots_total": eng.max_slots,
            "occupancy": (active / eng.max_slots) if eng.max_slots else 0.0,
            "unfinished": self._n_unfinished,
            "draining": self._draining.is_set(),
            "ttft_p50_s": ttft.quantile(0.5) if ttft is not None else 0.0,
            "host_gap_p50_s": hg.quantile(0.5) if hg is not None else 0.0,
            "host_gap_p99_s": hg.quantile(0.99) if hg is not None else 0.0,
            "host_gap_last_s": float(eng._m_host_gap_last.value),
            "preempted": eng.num_parked,
            "kv_blocks_free": eng._pager.free_blocks,
            "kv_blocks_total": eng.kv_blocks - 1,
            # tiered KV: spill / promote traffic, extension-tier
            # occupancy, the disk leg's blocking loads
            "kv_tiered": eng._tiered,
            "kv_ext_used": int(eng._pager.ext_used) if eng._tiered else 0,
            "kv_blocks_spilled": int(eng._m_kv_spilled.value),
            "kv_blocks_prefetched": int(eng._m_kv_prefetched.value),
            "kv_prefetch_misses": int(eng._m_kv_prefetch_miss.value),
            # one card: every block's bytes live here
            "tp": eng.tp,
            "kv_block_bytes_per_chip": int(eng.kv_block_bytes_per_chip),
            "kv_pool_bytes_per_chip": int(eng.kv_pool_bytes_per_chip()),
            "tier_queue_depth": self._tier_depths(),
            "overload_rung": eng.overload_rung,
            "overload_escalations": int(eng._m_escal.value),
            "shed": {t: int(c.value) for t, c in eng._m_shed.items()},
            "degraded": eng.overload_rung > 0,
            # the KV fabric: what moved instead of being recomputed, and
            # where this server's endpoint listens
            "fabric_address": (None if self.fabric_address is None
                               else list(self.fabric_address)),
            "fabric": {
                "blocks_moved": {op: int(c.value)
                                 for op, c in eng._m_fab_blocks.items()},
                "bytes_moved": {op: int(c.value)
                                for op, c in eng._m_fab_bytes.items()},
                "prefill_tokens_saved_remote":
                    int(eng._m_remote_saved.value),
                "disk_blocks": (0 if eng._disk is None
                                else eng._disk.n_blocks),
                "disk_sessions": (0 if eng._disk is None
                                  else len(eng._disk.list_sessions())),
                "integrity_failures": {
                    p: int(c.value) for p, c in eng._m_integrity.items()},
                "disk_evictions": int(eng._m_disk_evict.value),
                "handoff_chunks": int(eng._m_handoff_chunks.value),
                "handoff_bytes": int(eng._m_handoff_bytes.value),
                "handoff_staged": len(eng._handoff_tickets),
            },
            "overlap": eng.overlap_mode,
            "step_inflight": eng._inflight is not None,
            # the AOT cache (engine sub-slice (j)) is off
            "aot": None,
            "boot_s": getattr(self, "boot_s", None),
            "boot_engine_s": self.boot_engine_s,
            "boot_first_token_s": self.boot_first_token_s,
        }

    def _tier_depths(self):
        """Queued requests per tier, the hand-off queue's included."""
        depths = dict(self.engine.tier_queue_depths())
        for req in list(self._pending.queue):
            if req is not None:
                t = SLOTier.check(req.tier)
                depths[t] = depths.get(t, 0) + 1
        return depths

    # -- requests ----------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=16, **kw):
        """Hand a request to the driver thread; `kw` are `Request`'s
        (sampling, `seed`, `deadline`, `priority`, `tier`, callbacks).
        `router_epoch` and `chaos_mark` are the router's (see the module
        docstring).  Raises `StaleRouterEpoch` for an epoch below one
        already served, `EngineUnhealthy` after a crash or once
        quarantined, `QueueFull` at the queue bound and `Overloaded` for
        the lowest tier at rung 4 (before a `Request` is built)."""
        epoch = kw.pop("router_epoch", None)
        if epoch is not None:
            epoch = int(epoch)
            hw = self._router_epoch_hw
            if hw is not None and epoch < hw:
                raise StaleRouterEpoch(
                    f"dispatch carries router epoch {epoch} but this "
                    f"replica has served epoch {hw}")
            self._router_epoch_hw = epoch if hw is None else max(hw, epoch)
        mark = kw.pop("chaos_mark", None)
        if self._error is not None:
            raise EngineUnhealthy(
                f"LLMServer driver thread crashed: {self._error!r}")
        if self._closing.is_set() or self._draining.is_set():
            raise RuntimeError(
                f"LLMServer {self.name} is shut down or draining; "
                "submit() no longer accepts requests")
        if self._quarantined.is_set():
            # typed as a crash, so callers take their failover path
            raise EngineUnhealthy(
                f"LLMServer {self.name} is quarantined: "
                f"{self.quarantine_reason}")
        # load shedding covers the whole path to a slot: requests in the
        # hand-off queue count against the engine's bound too
        eng = self.engine
        if eng.max_queue is not None and (
                len(eng._queue) + self._pending.qsize() >= eng.max_queue):
            eng._m_rejected.inc()
            raise QueueFull(
                f"admission queue at capacity ({eng.max_queue}); request "
                f"rejected (load shedding)")
        eng._overload_check(kw.get("tier"))
        done = threading.Event()
        user_done = kw.pop("on_done", None)

        def on_done(req):
            # fires on ANY completion (cancellation and expiry too), so
            # result() cannot hang and drain cannot wait forever
            if user_done is not None:
                user_done(req)
            with self._events_lock:
                self._n_unfinished -= 1
            done.set()

        req = Request(prompt_ids, max_new_tokens, on_done=on_done, **kw)
        if req.trace_id is None:
            req.trace_id = _tr.mint()
        _tr.point("engine/submit", trace_id=req.trace_id, rid=req.rid)
        eng._check(req)
        with self._events_lock:
            self._events[req.rid] = done
            self._n_unfinished += 1
        self._pending.put(req)
        if mark is not None:
            # fired once the request is queued: the step that raises the
            # armed fault always finds it in the engine
            try:
                _faults.fire("replica.poison", name=self.name, mark=mark)
            except _faults.InjectedFault as e:
                self._poison_pending = e
        return req

    def result(self, req, timeout=None):
        """Block until `req` finishes; returns its generated tokens.
        `timeout=None` uses `default_result_timeout`.  Raises the
        request's typed error when it failed."""
        if timeout is None:
            timeout = self.default_result_timeout
        ev = self._events.get(req.rid)
        if ev is not None and not ev.wait(timeout):
            raise ResultTimeout(f"request {req.rid} still running "
                                f"after {timeout}s")
        with self._events_lock:
            self._events.pop(req.rid, None)
        if req.error is not None:
            raise req.error
        return req.tokens

    def _serve(self):
        # the single driver thread: all device work happens here.  An
        # escaping exception must not strand waiters: _fail_all marks
        # the server unhealthy and completes every pending request.
        eng = self.engine
        try:
            while not self._closing.is_set():
                self._canary_tick()
                try:
                    while True:
                        req = self._pending.get_nowait()
                        if req is not None:
                            eng._queue.append(req)
                except _queue.Empty:
                    pass
                if eng.has_work:
                    # fault sites fired once per real scheduler step
                    # (never on idle wakeups), so count rules hit a
                    # deterministic step
                    _faults.fire("replica.crash", name=self.name)
                    if self._poison_pending is not None:
                        # a marked request armed the poison site at
                        # submit: the crash lands here, at a real step,
                        # and takes every co-batched request down
                        e, self._poison_pending = self._poison_pending, None
                        raise e
                    _faults.fire("engine.stall", name=self.name)
                    eng.step()
                else:
                    # idle: park until submit() hands over a request or
                    # shutdown() drops the None sentinel; with a canary
                    # armed, wake at interval / 4 to self-probe
                    timeout = (None if self._canary_interval is None
                               else max(0.05, self._canary_interval / 4))
                    try:
                        req = self._pending.get(timeout=timeout)
                    except _queue.Empty:
                        req = None
                    if req is not None:
                        eng._queue.append(req)
                    # an idle park is liveness, not a hang; and an idle
                    # wait is not host overhead between device steps
                    eng.last_step_t = time.monotonic()
                    eng._t_retire = None
            # overlap: commit the tail step, so its tokens reach their
            # requests before the driver stops
            eng.flush()
        except BaseException as e:  # noqa: BLE001 — containment point
            self._error = e
            self._settle_inflight()
            self._fail_all(e)

    def _settle_inflight(self):
        """The driver dies with a step in flight (overlap): commit it
        (`flush`), so its graph replay and the copy of its tokens have
        finished before `_fail_all` fails its requests and a later
        `shutdown()` drops the replica's buffers.  Should the commit
        fail in turn, wait for the step's event instead."""
        eng = self.engine
        inf = eng._inflight
        if inf is None:
            return
        try:
            eng.flush()
        except BaseException:  # noqa: BLE001 — the driver is dying anyway
            eng._inflight = None
            if inf.event is not None:
                inf.event.synchronize()

    def _fail_all(self, cause):
        """Driver crashed: fail every request still in flight."""
        eng = self.engine
        _tr.flight_record(f"driver-crash-{self.name}")
        dead = []
        try:
            while True:
                req = self._pending.get_nowait()
                if req is not None:
                    dead.append(req)
        except _queue.Empty:
            pass
        dead.extend(eng._queue)
        eng._queue.clear()
        dead.extend(r for r in eng._slots if r is not None)
        eng._slots = [None] * eng.max_slots
        dead.extend(ps.req for ps in eng._prefill.values())
        eng._prefill.clear()
        dead.extend(pr.req for pr in eng._parked)
        eng._parked.clear()
        # overlap: the step in flight holds the requests failed above;
        # drop it so no late commit revives a dead stream
        eng._inflight = None
        for req in dead:
            if not req.done:
                req._finish_error(EngineUnhealthy(
                    f"serving driver crashed: {cause!r}"))
        with self._events_lock:
            for ev in self._events.values():
                ev.set()

    def shutdown(self, timeout=5, drain=False, drain_timeout=60.0):
        """Stop serving: join the driver thread, stop the series
        sampler and the HTTP thread; submit() raises afterwards.
        Idempotent.  `drain=True` first stops admitting and keeps
        stepping until every accepted request finished (or
        `drain_timeout` passes, or the driver crashed)."""
        if drain:
            self._draining.set()
            deadline = time.monotonic() + drain_timeout
            while (self._error is None and not self._closing.is_set()
                   and time.monotonic() < deadline):
                with self._events_lock:
                    if self._n_unfinished == 0:
                        break
                time.sleep(0.005)
        self._closing.set()
        self._series_stop.set()
        if self._series_thread is not None:
            self._series_thread.join(timeout)
            self._series_thread = None
        # the fabric endpoint stops before the driver: its executor
        # hands jobs to the driver thread, which is exiting
        if self._fabric is not None:
            self._fabric.close()
            self._fabric = None
        self._pending.put(None)   # wake the driver if it is parked idle
        self._thread.join(timeout)
        self.engine.close_fabric(timeout)
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http_thread.join(timeout)
            self._http = None

    close = shutdown
