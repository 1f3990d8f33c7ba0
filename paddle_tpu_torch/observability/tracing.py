"""Fleet-wide distributed request tracing.

A thread-safe, bounded ring-buffer span recorder over monotonic clocks
(`time.perf_counter_ns`), plus the glue that stitches one request's
spans into a single timeline across real OS processes:

  * every request carries a `trace_id` minted at `Router.submit` /
    `LLMEngine.submit` and propagated through `RouterRequest.params`,
    the routing journal, the process-fleet JSONL frames, and KV-fabric
    frame headers — so the router's dispatch span and a replica's
    prefill-chunk span agree on identity without any shared state;
  * `perf_counter_ns` epochs differ arbitrarily between processes, so
    merging buffers needs a clock-offset handshake: the parent stamps
    t0/t1 around a `clock_sync` ctl round-trip, the child replies with
    its own clock, and `offset = (t0 + t1) // 2 - t_child` aligns the
    child's span timestamps to the parent's clock at merge time
    (`chrome_trace` applies it; NTP's symmetric-delay assumption, fine
    at localhost RTTs);
  * exporters: Chrome `trace_event` JSON (`chrome_trace`, load in
    `chrome://tracing` / Perfetto), a per-request timeline filter
    (`request_timeline`, served by LLMServer's `/debug/trace?rid=`),
    and a crash/quarantine flight recorder (`flight_record`) that
    dumps the last N request timelines when a replica is fenced,
    quarantined, or watchdog-failed.

Cost model: `enabled()` is a module-global bool check; the disabled
path of `t0()` / `end()` / `point()` / `span()` does no clock read, no
allocation, and no locking, so production code brackets hot paths
unconditionally.  Enabled, one span is one clock read at each edge
plus one lock+append into a `deque(maxlen=capacity)` — bounded memory
by construction, oldest spans fall off first.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

__all__ = [
    "TraceRecorder", "recorder", "configure", "enabled", "mint",
    "clock_ns", "t0", "end", "point", "span", "snapshot_spans", "clear",
    "chrome_trace", "request_timeline", "flight_record",
]

_ENABLED = os.environ.get("PADDLE_TPU_TRACE", "") not in ("", "0")
_FLIGHT_DIR = os.environ.get("PADDLE_TPU_TRACE_FLIGHT", "") or None
_DEFAULT_CAPACITY = 8192
_FLIGHT_SEQ = itertools.count()


class TraceRecorder:
    """Bounded ring of span dicts.  One process-global instance
    (`recorder()`) backs the module-level helpers; private instances
    exist only for tests."""

    def __init__(self, capacity=_DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=int(capacity))

    @property
    def capacity(self):
        return self._spans.maxlen

    def set_capacity(self, capacity):
        with self._lock:
            self._spans = deque(self._spans, maxlen=int(capacity))

    def record(self, name, ts_ns, dur_ns, trace_id=None, error=False,
               args=None):
        span = {"name": name, "ts": int(ts_ns), "dur": int(dur_ns),
                "pid": os.getpid(), "tid": threading.get_ident()}
        if trace_id is not None:
            span["trace_id"] = trace_id
        if error:
            span["error"] = True
        if args:
            span["args"] = args
        with self._lock:
            self._spans.append(span)
        return span

    def snapshot(self) -> list:
        """Copy of the ring, oldest first (spans are JSON-safe dicts —
        they ride ctl frames unmodified)."""
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()

    def __len__(self):
        return len(self._spans)


_RECORDER = TraceRecorder()


def recorder() -> TraceRecorder:
    """The process-global recorder."""
    return _RECORDER


def configure(enabled=None, capacity=None, flight_dir=None):
    """Flip tracing on/off, resize the ring, set the flight-recorder
    output directory.  `None` leaves a setting untouched."""
    global _ENABLED, _FLIGHT_DIR
    if enabled is not None:
        _ENABLED = bool(enabled)
    if capacity is not None:
        _RECORDER.set_capacity(capacity)
    if flight_dir is not None:
        _FLIGHT_DIR = str(flight_dir) or None


def enabled() -> bool:
    return _ENABLED


def mint() -> str:
    """A fleet-unique trace id.  Minted unconditionally at submit time
    (even with recording off) so journal records always correlate."""
    return uuid.uuid4().hex[:16]


def clock_ns() -> int:
    """The clock every span uses — per-process monotonic, arbitrary
    epoch (hence the clock_sync handshake before cross-process merge)."""
    return time.perf_counter_ns()


def t0():
    """Open a span bracket: returns a start stamp, or None when
    disabled (the matching `end()` is then a no-op).  The explicit
    t0/end pair is the hot-path form — no generator, no frame."""
    return time.perf_counter_ns() if _ENABLED else None


def end(name, t0_ns, trace_id=None, error=False, args=None):
    """Close a span bracket opened by `t0()`."""
    if t0_ns is None:
        return None
    now = time.perf_counter_ns()
    return _RECORDER.record(name, t0_ns, now - t0_ns, trace_id=trace_id,
                            error=error, args=args)


def point(name, trace_id=None, **args):
    """Zero-duration instant event."""
    if not _ENABLED:
        return None
    return _RECORDER.record(name, time.perf_counter_ns(), 0,
                            trace_id=trace_id, args=args or None)


@contextmanager
def span(name, trace_id=None, **args):
    """Context-manager bracket; records `error=True` when an exception
    escapes the body (and re-raises it)."""
    if not _ENABLED:
        yield
        return
    start = time.perf_counter_ns()
    err = False
    try:
        yield
    except BaseException:
        err = True
        raise
    finally:
        _RECORDER.record(name, start, time.perf_counter_ns() - start,
                         trace_id=trace_id, error=err, args=args or None)


def snapshot_spans() -> list:
    return _RECORDER.snapshot()


def clear():
    _RECORDER.clear()


# -- merge & export -----------------------------------------------------------

def chrome_trace(buffers) -> dict:
    """Merge per-process span buffers into one Chrome `trace_event`
    JSON dict (load in chrome://tracing or Perfetto).

    `buffers`: iterable of {"label": str, "offset_ns": int,
    "spans": [...]} — `offset_ns` is the clock_sync-derived correction
    ADDED to that buffer's timestamps to land them on the reference
    (parent) clock.  A plain span list is accepted as a single buffer
    at offset 0."""
    if isinstance(buffers, dict) or (buffers and isinstance(
            next(iter(buffers), None), dict) and "name" in buffers[0]):
        buffers = [{"label": None, "offset_ns": 0, "spans": buffers}]
    events = []
    for buf in buffers:
        off = int(buf.get("offset_ns", 0))
        label = buf.get("label")
        for s in buf.get("spans", ()):
            args = dict(s.get("args") or {})
            if "trace_id" in s:
                args["trace_id"] = s["trace_id"]
            if s.get("error"):
                args["error"] = True
            events.append({
                "name": s["name"], "ph": "X", "cat": "trace",
                "ts": (s["ts"] + off) / 1e3,       # chrome wants µs
                "dur": s["dur"] / 1e3,
                "pid": label if label is not None else s.get("pid", 0),
                "tid": s.get("tid", 0),
                "args": args,
            })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def request_timeline(spans, trace_id) -> list:
    """One request's spans out of a merged or raw buffer: spans tagged
    with its trace_id directly, plus engine step-anatomy spans whose
    `args.tids` names it (a decode step serves many requests at once)."""
    out = []
    for s in spans:
        if s.get("trace_id") == trace_id:
            out.append(s)
        elif trace_id in (s.get("args") or {}).get("tids", ()):
            out.append(s)
    return out


# -- flight recorder ----------------------------------------------------------

def flight_record(reason, spans=None, flight_dir=None, last_n=8,
                  extra=None):
    """Dump the last `last_n` request timelines (plus the trailing
    untagged spans for context) to a JSON file in the flight dir.
    Fired when a replica is fenced, quarantined, or watchdog-failed —
    every chaos failure comes with its own evidence.  `extra` rides
    along verbatim in the dump (the poison-request repro bundle).
    No-op (returns None) unless a flight dir is configured; never
    raises."""
    fdir = flight_dir or _FLIGHT_DIR
    if fdir is None:
        return None
    if spans is None:
        spans = _RECORDER.snapshot()
    last_end = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid is not None:
            last_end[tid] = max(last_end.get(tid, 0),
                                s["ts"] + s["dur"])
    keep = sorted(last_end, key=last_end.get)[-int(last_n):]
    traces = {tid: request_timeline(spans, tid) for tid in keep}
    tail = [s for s in spans if s.get("trace_id") is None][-64:]
    safe = "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in str(reason))[:64]
    path = os.path.join(
        fdir, f"flight-{safe}-{os.getpid()}-{next(_FLIGHT_SEQ)}.json")
    try:
        os.makedirs(fdir, exist_ok=True)
        doc = {"reason": str(reason), "t_wall": time.time(),
               "pid": os.getpid(), "traces": traces,
               "untraced_tail": tail}
        if extra is not None:
            doc["extra"] = extra
        with open(path, "w") as f:
            json.dump(doc, f)
    except (OSError, TypeError, ValueError):
        return None
    return path
