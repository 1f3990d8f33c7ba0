"""Thread-safe serving front over the port's `LLMEngine` — the port of
`paddle_tpu/inference/serving.py::LLMServer`.

Any thread `submit()`s; one driver thread runs the engine's
iteration-level scheduler, so requests batch onto the same vectorised
decode step.  `submit()` returns the live `Request` — poll `.done` /
`.tokens`, or block on `result()`.  An exception escaping the driver
thread fails every pending request with `EngineUnhealthy` and flips
`submit()` into raising, so no waiter hangs.

Not ported yet (each raises `NotImplementedError` naming its ROADMAP
item): the `/metrics` HTTP thread, the canary self-probe, the step
watchdog, the metrics time series, the KV fabric endpoint and the
disaggregated pool roles.
"""

from __future__ import annotations

import queue as _queue
import threading
import time

from ..observability import tracing as _tr
from .engine import (EngineUnhealthy, LLMEngine, QueueFull, Request,
                     ResultTimeout)

__all__ = ["LLMServer"]

_SERVER_SLO = "engine sub-slice (e): SLO tiers and the overload ladder"
# server knobs of the JAX package this slice does not port: name ->
# (the values that mean "off", the ROADMAP item that ports it)
_UNPORTED = {
    "metrics_port": ((None,), _SERVER_SLO),
    "metrics_host": (("127.0.0.1",), _SERVER_SLO),
    "canary_interval": ((None,), _SERVER_SLO),
    "canary_prompt_len": ((8,), _SERVER_SLO),
    "canary_max_new": ((4,), _SERVER_SLO),
    "watchdog_deadline": ((None,), _SERVER_SLO),
    "series_interval": ((None,), _SERVER_SLO),
    "series_tiers": ((None,), _SERVER_SLO),
    "series_max_bytes": ((None,), _SERVER_SLO),
    "pool_role": (("mixed",), "engine sub-slice (h): KV fabric and "
                              "disaggregated serving"),
}


class LLMServer:
    """Thread-safe front over `LLMEngine(model, **engine_kw)`.
    `default_result_timeout` bounds every `result()` wait."""

    def __init__(self, model, default_result_timeout=600.0, name=None,
                 **engine_kw):
        for knob in [k for k in engine_kw if k in _UNPORTED]:
            value = engine_kw.pop(knob)
            offs, item = _UNPORTED[knob]
            if value not in offs:
                raise NotImplementedError(
                    f"{knob}={value!r} is not ported to paddle_tpu_torch "
                    f"yet (ROADMAP: {item})")
        self.engine = LLMEngine(model, **engine_kw)
        self.name = name if name is not None else f"llm-server-{id(self):x}"
        self.default_result_timeout = default_result_timeout
        self._pending: _queue.Queue = _queue.Queue()
        self._events = {}
        self._events_lock = threading.Lock()
        self._closing = threading.Event()
        self._draining = threading.Event()
        self._n_unfinished = 0       # accepted, on_done not yet fired
        self._error = None           # the driver thread's fatal exception
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"driver-{self.name}")
        self._thread.start()

    def submit(self, prompt_ids, max_new_tokens=16, **kw):
        if self._error is not None:
            raise EngineUnhealthy(
                f"LLMServer driver thread crashed: {self._error!r}")
        if self._closing.is_set() or self._draining.is_set():
            raise RuntimeError(
                f"LLMServer {self.name} is shut down or draining; "
                "submit() no longer accepts requests")
        # load shedding covers the whole path to a slot: requests in the
        # hand-off queue count against the engine's bound too
        eng = self.engine
        if eng.max_queue is not None and (
                len(eng._queue) + self._pending.qsize() >= eng.max_queue):
            eng._m_rejected.inc()
            raise QueueFull(
                f"admission queue at capacity ({eng.max_queue}); request "
                f"rejected (load shedding)")
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
        try:
            while not self._closing.is_set():
                try:
                    while True:
                        req = self._pending.get_nowait()
                        if req is not None:
                            self.engine._queue.append(req)
                except _queue.Empty:
                    pass
                if self.engine.has_work:
                    self.engine.step()
                else:
                    # idle: park until submit() hands over a request or
                    # shutdown() drops the None sentinel
                    req = self._pending.get()
                    if req is not None:
                        self.engine._queue.append(req)
        except BaseException as e:  # noqa: BLE001 — containment point
            self._error = e
            self._fail_all(e)

    def _fail_all(self, cause):
        """Driver crashed: fail every request still in flight."""
        eng = self.engine
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
        for req in dead:
            if not req.done:
                req._finish_error(EngineUnhealthy(
                    f"serving driver crashed: {cause!r}"))
        with self._events_lock:
            for ev in self._events.values():
                ev.set()

    def shutdown(self, timeout=5, drain=False, drain_timeout=60.0):
        """Stop serving and join the driver thread; submit() raises
        afterwards.  Idempotent.  `drain=True` first stops admitting and
        keeps stepping until every accepted request finished (or
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
        self._pending.put(None)   # wake the driver if it is parked idle
        self._thread.join(timeout)
