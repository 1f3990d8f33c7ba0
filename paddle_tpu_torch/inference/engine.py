"""Continuous-batching paged-KV decode engine — the synchronous core of
`paddle_tpu/inference/engine.py`, in PyTorch.

    engine = LLMEngine(model, max_slots=8, max_len=1024, prefill_chunk=128)
    req = engine.submit([1, 2, 3], max_new_tokens=32)
    engine.run()               # drive until every request finishes
    req.tokens                 # generated ids (prompt excluded)

What this slice keeps of the JAX engine:

  * ONE paged KV pool (`kv_blocks` blocks of `kv_block_tokens` rows per
    layer, block 0 the trash block) shared by every slot through a
    per-slot block table (`kv_pager.KVPager`, copied as is).  The pool
    is provisioned in full — every slot can reach `max_len` — so
    admission never waits on blocks and preemption never fires;
  * a TOKEN-BUDGET iteration scheduler: each `step()` spends
    `step_token_budget` tokens, one decode token per active slot first,
    the remainder on prefill in pow-2 chunks (`prefill_chunk`); the
    oldest mid-prefill slot always gets one chunk per step;
  * ONE vectorised decode step over every slot at per-slot depths, its
    attention through the Hopper paged-attention kernel
    (`decode_kernel="cuda"`) or the gather path (`"gather"`);
  * per-slot sampling (`generation.sample_logits_per_slot`) with one
    `torch.Generator` per request, so a request's tokens depend only on
    its own seed;
  * EOS, `max_new_tokens`, cancellation and deadline handling at step
    boundaries, a bounded admission queue (`max_queue` -> `QueueFull`),
    and the `llm_engine_*` TTFT / ITL / token metrics.

The JAX engine's other knobs (speculation, prefix cache, preemption and
the host swap tier, tiered KV, weight-only int8, meshes, the overlap
driver, the AOT cache, the KV fabric, SLO targets and per-request SLO
tiers, the overload ladder, the legacy whole-bucket prefill) raise
`NotImplementedError` naming their ROADMAP item — never silently
ignored; the admission queue is plain FIFO.  Its bounded compile count
has no counterpart in an eager engine.

Padding correctness: a prompt's padded tail chunk writes garbage K/V at
rows >= its true length, and the decode step writes each slot's token
at `pos` before attending with mask t <= pos, so a garbage row is
always overwritten before it becomes visible — as are rows a slot's
previous occupant left, and the garbage row the decode step writes at a
mid-prefill slot's frontier.
"""

from __future__ import annotations

import itertools
import time
from collections import deque

import numpy as np
import torch

from ..generation import sample_logits_per_slot
from ..models import llama_decode as D
from ..observability import tracing as _tr
from ..observability.metrics import MetricsRegistry, log_buckets
from .kv_pager import KVPager

__all__ = ["Request", "LLMEngine", "DeadlineExceeded", "QueueFull",
           "EngineUnhealthy", "ResultTimeout"]

_REQ_IDS = itertools.count()

# knobs of the JAX engine this slice does not port: name -> (the values
# that mean "off", the ROADMAP item that ports it)
_PREEMPT = "engine sub-slice (b): preemption and the host swap tier"
_PREFIX = "engine sub-slice (c): radix prefix cache"
_OVERLAP = "engine sub-slice (f): overlap driver and CUDA graphs"
_SLO = "engine sub-slice (e): SLO tiers and the overload ladder"
_TIERED = "engine sub-slice (g): tiered KV and long context"
_MULTI = "multi-GPU serving"
_UNPORTED = {
    "speculation": ((None, False),
                    "engine sub-slice (d): speculative decoding"),
    "prefix_cache_blocks": ((0,), _PREFIX),
    "prefix_block_tokens": ((16,), _PREFIX),
    "host_pool_blocks": ((None,), _PREEMPT),
    "preempt_policy": (("auto",), _PREEMPT),
    "hot_window": ((None,), _TIERED),
    "prefetch_depth": ((2,), _TIERED),
    "weight_dtype": ((None, "auto"), "weight-only int8 decode path"),
    "decode_block_tile": ((None,), _OVERLAP),
    "decode_buckets": ((False,), _OVERLAP),
    "overlap": (("auto", "off", False), _OVERLAP),
    "aot_cache": ((None,), _OVERLAP),
    "slo_targets": ((None,), _SLO),
    "overload": ((None,), _SLO),
    "fabric": ((None,),
               "engine sub-slice (h): KV fabric and disaggregated serving"),
    "mesh": ((None,), _MULTI),
    "tp": ((None, 1), _MULTI),
    "sp": ((None, 1), _MULTI),
}


def _reject_unported(knobs: dict):
    """Raise for a JAX-engine knob set to anything but "off"."""
    for name, value in knobs.items():
        if name not in _UNPORTED:
            raise TypeError(f"LLMEngine got an unexpected keyword "
                            f"argument {name!r}")
        offs, item = _UNPORTED[name]
        if not any(value is o or (type(value) is type(o) and value == o)
                   for o in offs):
            raise NotImplementedError(
                f"{name}={value!r} is not ported to paddle_tpu_torch yet "
                f"(ROADMAP: {item})")


class DeadlineExceeded(TimeoutError):
    """A request's per-request deadline expired: shed from the queue
    before admission, or evicted from its slot at a step boundary."""


class QueueFull(RuntimeError):
    """Load shedding: the bounded admission queue is at capacity, the
    request was rejected at submit() rather than queued to time out."""


class EngineUnhealthy(RuntimeError):
    """The serving driver thread crashed; the engine accepts no new
    work and every pending request has been failed."""


class ResultTimeout(TimeoutError):
    """`result(timeout=)` expired before the request finished (the
    request itself keeps running)."""


class Request:
    """One generation request: prompt-in, tokens-out.

    `tokens` accumulates generated ids (the prompt is not echoed);
    `on_token(request, token)` streams each token as it is produced;
    `on_done(request)` fires exactly once when the request finishes for
    ANY reason (EOS, max_new_tokens, cancellation, deadline, engine
    failure); `done` flips when the request leaves the engine.
    `cancel()` is cooperative: a queued request is dropped at admit, an
    in-flight one evicted at the next step boundary.  `deadline`
    (seconds from submit) bounds the request's whole life; expiry
    finishes it with `error` set to a `DeadlineExceeded`.  `seed` seeds
    the request's own sampling generator."""

    def __init__(self, prompt_ids, max_new_tokens, temperature=1.0,
                 top_p=1.0, greedy=True, eos_token_id=None, seed=0,
                 on_token=None, on_done=None, deadline=None, tier=None,
                 trace_id=None):
        self.rid = next(_REQ_IDS)
        self.trace_id = None if trace_id is None else str(trace_id)
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.greedy = bool(greedy)
        self.eos_token_id = eos_token_id
        self.seed = int(seed)
        if tier is not None:
            raise NotImplementedError(
                f"tier={tier!r} is not ported to paddle_tpu_torch yet "
                f"(ROADMAP: {_SLO})")
        self.on_token = on_token
        self.on_done = on_done
        self.tokens: list[int] = []
        self.done = False
        self.cancelled = False
        self.error: BaseException | None = None
        self._done_fired = False
        if deadline is not None and float(deadline) <= 0:
            raise ValueError("deadline must be positive seconds")
        self._deadline_t = (None if deadline is None
                            else time.monotonic() + float(deadline))
        # TTFT counts from construction (queue wait included), ITL from
        # the previous token's host-visible time
        self._t_submit = time.perf_counter()
        self._t_last: float | None = None
        self._ttft: float | None = None

    def expired(self, now=None) -> bool:
        if self._deadline_t is None:
            return False
        return (time.monotonic() if now is None else now) >= self._deadline_t

    def cancel(self):
        """Request cooperative cancellation (safe from any thread)."""
        self.cancelled = True

    def _emit(self, tok: int) -> bool:
        """Record one generated token; returns True when finished.
        `done` flips BEFORE the streaming callback fires."""
        self.tokens.append(tok)
        if (self.eos_token_id is not None and tok == self.eos_token_id) \
                or len(self.tokens) >= self.max_new_tokens:
            self.done = True
        if self.on_token is not None:
            self.on_token(self, tok)
        if self.done:
            self._fire_done()
        return self.done

    def _fire_done(self):
        if self._done_fired:
            return
        self._done_fired = True
        self.done = True
        if self.on_done is not None:
            self.on_done(self)

    def _finish_cancelled(self):
        self._fire_done()

    def _finish_error(self, exc: BaseException):
        if self.error is None:
            self.error = exc
        self._fire_done()


class _PrefillState:
    """A slot mid-chunked-prefill: the request and its write frontier
    `off` (rows [0, off) of the slot's cache are valid)."""

    __slots__ = ("req", "off")

    def __init__(self, req, off=0):
        self.req = req
        self.off = off


class LLMEngine:
    """Request-in / tokens-out continuous-batching engine over a
    `LlamaForCausalLM`, on the model's device.

    Knobs: `max_slots`, `max_len`, `max_prompt_len` (default max_len //
    2), `min_bucket`, `prefill_chunk` (pow-2 chunk width; required),
    `step_token_budget` (default prefill_chunk + max_slots),
    `kv_block_tokens` (default 16), `kv_blocks` (default and minimum:
    full provisioning, 1 + max_slots * ceil(max_len / kv_block_tokens)),
    `kv_dtype` (None/"auto", "bfloat16", "float32", "int8"),
    `decode_kernel` ("auto" = "cuda" on a CUDA model, "gather" on the
    CPU; "cuda" on a CPU model runs the kernel's plain version),
    `max_queue` (None = unbounded).  Single-threaded by design; see
    `serving.LLMServer` for the thread-safe front."""

    def __init__(self, model, max_slots=4, max_len=256,
                 max_prompt_len=None, min_bucket=16, prefill_chunk=64,
                 step_token_budget=None, kv_block_tokens=16,
                 kv_blocks=None, kv_dtype=None, decode_kernel="auto",
                 max_queue=None, **unported):
        _reject_unported(unported)
        if prefill_chunk is None:
            raise NotImplementedError(
                "prefill_chunk=None (the legacy whole-bucket prefill) is "
                f"not ported to paddle_tpu_torch yet (ROADMAP: {_OVERLAP})")
        self.cfg = model.config
        self.device = model.device
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.max_prompt_len = int(max_prompt_len or max_len // 2)
        if self.max_prompt_len >= self.max_len:
            raise ValueError("max_prompt_len must leave decode headroom "
                             "below max_len")

        c = int(prefill_chunk)
        if c <= 0 or (c & (c - 1)):
            raise ValueError("prefill_chunk must be a power of two")
        self.prefill_chunk = c
        lo = min(int(min_bucket), c)
        self.chunk_sizes = tuple(lo << i for i in
                                 range((c // lo).bit_length())
                                 if lo << i <= c)
        self.step_token_budget = int(step_token_budget
                                     if step_token_budget is not None
                                     else c + self.max_slots)
        if self.step_token_budget <= 0:
            raise ValueError("step_token_budget must be positive")

        if kv_dtype not in (None, "auto", "int8", "bfloat16", "float32"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} (None/'auto', "
                             f"'bfloat16', 'float32', or 'int8')")
        if decode_kernel not in ("auto", "cuda", "gather"):
            raise ValueError(f"unknown decode_kernel {decode_kernel!r} "
                             "('auto', 'cuda', or 'gather')")
        self.kv_dtype = "auto" if kv_dtype is None else str(kv_dtype)
        self.decode_kernel = decode_kernel if decode_kernel != "auto" \
            else ("cuda" if self.device.type == "cuda" else "gather")

        self.state = D.collect_decode_state(model)
        dtype = self.state["embed"].dtype

        bt = int(kv_block_tokens)
        if bt <= 0:
            raise ValueError("kv_block_tokens must be positive")
        self.kv_block_tokens = bt
        bmax = -(-self.max_len // bt)            # blocks per full slot
        full = 1 + self.max_slots * bmax
        self.kv_blocks = full if kv_blocks is None else int(kv_blocks)
        if self.kv_blocks < full:
            raise NotImplementedError(
                f"kv_blocks={self.kv_blocks} below full provisioning "
                f"({full}) needs preemption, which is not ported to "
                f"paddle_tpu_torch yet (ROADMAP: {_PREEMPT})")
        self._pager = KVPager(self.kv_blocks, bt, self.max_slots, bmax,
                              kv_dtype=self.kv_dtype)
        self._kvpool = D.init_paged_cache(self.cfg, self.kv_blocks, bt,
                                          dtype, kv_dtype=kv_dtype,
                                          device=self.device)

        # host-side mirrors pushed to the device each step (tiny arrays)
        B = self.max_slots
        self._token = np.zeros(B, np.int32)
        self._pos = np.zeros(B, np.int32)
        self._temp = np.ones(B, np.float32)
        self._topp = np.ones(B, np.float32)
        self._greedy = np.ones(B, bool)
        self._gens: list = [None] * B               # per-slot sampler
        self._slots: list = [None] * B              # decoding requests
        self._prefill: dict = {}                    # slot -> _PrefillState
        self._queue: deque = deque()
        self._init_metrics()

    # -- telemetry ---------------------------------------------------------

    def _init_metrics(self):
        """Per-engine registry (concurrent engines in one process must
        not sum their slot gauges)."""
        reg = MetricsRegistry(namespace="llm_engine")
        self._metrics = reg
        self._m_admitted = reg.counter(
            "requests_admitted_total", help="requests moved queue -> slot")
        self._m_completed = reg.counter(
            "requests_completed_total",
            help="requests finished (EOS or max_new_tokens)")
        self._m_evicted = reg.counter(
            "requests_evicted_total",
            help="slot evictions (completions that occupied a slot)")
        self._m_cancelled = reg.counter(
            "requests_cancelled_total",
            help="requests cancelled (dropped at admit or evicted "
                 "mid-flight)")
        self._m_expired = reg.counter(
            "requests_expired_total",
            help="requests failed by their per-request deadline")
        self._m_rejected = reg.counter(
            "requests_rejected_total",
            help="submits rejected by the bounded admission queue")
        self._m_queue = reg.gauge("queue_depth",
                                  help="requests waiting for a slot")
        self._m_active = reg.gauge("slots_active",
                                   help="slots generating right now")
        self._m_steps = reg.counter("decode_steps_total",
                                    help="vectorized decode steps run")
        self._m_ttft = reg.histogram(
            "ttft_seconds", help="submit -> first token (queue wait "
            "+ prefill + first sample)",
            buckets=log_buckets(1e-3, 600.0, per_decade=3))
        self._m_itl = reg.histogram(
            "itl_seconds", help="inter-token latency per request",
            buckets=log_buckets(1e-4, 60.0, per_decade=3))
        self._m_tput = reg.gauge(
            "tokens_per_sec",
            help="EMA of generated tokens/s across all slots")
        self._m_gen = reg.counter("generated_tokens_total",
                                  help="tokens sampled (all requests)")
        self._m_prompt = reg.counter("prompt_tokens_total",
                                     help="true prompt tokens admitted")
        self._t_prev_step = None
        self._tput_ema = None

    def metrics(self) -> dict:
        """Snapshot of this engine's metrics registry."""
        return self._metrics.snapshot()

    # -- admission ---------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=16, **kw) -> Request:
        """Enqueue a request (list / ndarray / tensor prompt).  Raises
        `QueueFull` when the bounded admission queue is at capacity."""
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        req = Request(np.asarray(prompt_ids), max_new_tokens, **kw)
        if req.trace_id is None:
            req.trace_id = _tr.mint()
        self._check(req)
        self._admission_check()
        _tr.point("engine/submit", trace_id=req.trace_id, rid=req.rid)
        self._queue.append(req)
        self._m_queue.set(len(self._queue))
        return req

    def _admission_check(self):
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._m_rejected.inc()
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue}); "
                f"request rejected (load shedding)")

    def _check(self, req: Request):
        if req.prompt.size > self.max_prompt_len:
            raise ValueError(
                f"prompt length {req.prompt.size} exceeds max_prompt_len "
                f"{self.max_prompt_len}")
        if req.prompt.size + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {req.prompt.size} + max_new {req.max_new_tokens} "
                f"exceeds max_len {self.max_len}")

    def _chunk_for(self, remaining):
        """Largest chunk width <= remaining (so only a prompt's tail
        chunk ever pads), else the smallest width, padded."""
        for c in reversed(self.chunk_sizes):
            if c <= remaining:
                return c
        return self.chunk_sizes[0]

    def _next_queued(self):
        """Pop the oldest live queued request (FIFO).  Cancelled entries
        are dropped and expired ones shed with a DeadlineExceeded."""
        now = time.monotonic()
        while self._queue:
            req = self._queue.popleft()
            if req.cancelled:
                self._m_cancelled.inc()
                req._finish_cancelled()
                continue
            if req.expired(now):
                self._m_expired.inc()
                req._finish_error(DeadlineExceeded(
                    f"request {req.rid} expired in queue before "
                    f"admission"))
                continue
            return req
        return None

    def _reap_cancelled(self):
        """Step-boundary cancellation and deadline expiry: evict dead
        in-flight requests, decoding or mid-prefill.  Co-batched
        survivors never observe the eviction."""
        now = time.monotonic()
        for slot, req in enumerate(self._slots):
            if req is None or not (req.cancelled or req.expired(now)):
                continue
            self._free_slot(slot)
            self._m_evicted.inc()
            self._finish_dead(req, f"after {len(req.tokens)} tokens")
        for slot in [s for s, ps in self._prefill.items()
                     if ps.req.cancelled or ps.req.expired(now)]:
            ps = self._prefill.pop(slot)
            self._pager.release_slot(slot)
            self._finish_dead(ps.req, "mid-prefill")

    def _finish_dead(self, req, where):
        if req.cancelled:
            self._m_cancelled.inc()
            req._finish_cancelled()
        else:
            self._m_expired.inc()
            req._finish_error(DeadlineExceeded(
                f"request {req.rid} exceeded its deadline {where}; "
                f"evicted at step boundary"))

    def _free_slot(self, slot):
        """Evict a DECODING slot: return its blocks, reset its table row
        to trash so the vectorised step's garbage writes stay
        harmless."""
        self._pager.release_slot(slot)
        self._slots[slot] = None
        self._pos[slot] = 0
        self._token[slot] = 0
        self._greedy[slot] = True
        self._gens[slot] = None

    def _free_slots(self):
        return [s for s in range(self.max_slots)
                if self._slots[s] is None and s not in self._prefill]

    def _admit(self):
        """Move queued requests into free slots: allocate the blocks
        covering prompt + first decode row (the pool is fully
        provisioned, so allocation cannot fail) and start chunked
        prefill at row 0."""
        for slot in self._free_slots():
            req = self._next_queued()
            if req is None:
                break
            L = req.prompt.size
            got = self._pager.alloc(self._pager.blocks_for(L + 1))
            if got is None:
                raise RuntimeError("KV pool exhausted despite full "
                                   "provisioning")
            self._pager.adopt(slot, got)
            self._prefill[slot] = _PrefillState(req)
            _tr.point("req/admit", trace_id=req.trace_id, rid=req.rid,
                      slot=slot)
            # frontier row: the decode step's garbage write for this
            # mid-prefill slot lands where the next chunk overwrites
            self._pos[slot] = 0
            self._token[slot] = 0
            self._m_admitted.inc()
            self._m_prompt.inc(L)
        self._m_queue.set(len(self._queue))

    # -- prefill -----------------------------------------------------------

    def _run_chunks(self, budget):
        """Spend the step's prefill token budget on chunks, oldest
        admission first.  The first chunk always runs regardless of the
        remaining budget (bounded overspend of one chunk), so prefill
        progresses under full decode load."""
        chunks = 0
        for slot in list(self._prefill.keys()):
            ps = self._prefill[slot]
            req = ps.req
            L = req.prompt.size
            while ps.off < L:
                C = self._chunk_for(L - ps.off)
                if chunks > 0 and C > budget:
                    return
                ids = np.zeros((1, C), np.int32)
                seg = req.prompt[ps.off:ps.off + C]
                ids[0, :seg.size] = seg
                final = ps.off + C >= L
                tc = _tr.t0()
                x, _ = D.paged_prefill_chunk(
                    self.state, self.cfg,
                    torch.from_numpy(ids).to(self.device), ps.off,
                    torch.from_numpy(self._pager.table[slot]).to(
                        self.device), self._kvpool)
                tok = self._first_token(slot, req, x[:, L - 1 - ps.off]) \
                    if final else None
                _tr.end("req/prefill_chunk", tc, trace_id=req.trace_id,
                        args={"off": ps.off, "width": C})
                budget -= C
                chunks += 1
                ps.off += C
                self._pos[slot] = min(ps.off, L)
                if final:
                    self._finish_prefill(slot, ps, tok)
                    break
            if budget <= 0:
                break

    def _first_token(self, slot, req, h_last):
        """Sample the first generated token from the prompt's last row
        hidden state (1, D), seeding the request's own generator."""
        h = D._rms(h_last[:, None], self.state["final_norm"],
                   self.cfg.rms_norm_eps)
        logits = (h @ self.state["head"])[:, 0, :]
        gen = None
        if not req.greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(req.seed)
        self._gens[slot] = gen
        tok = sample_logits_per_slot(logits, [gen], [req.temperature],
                                     [req.top_p], [req.greedy])
        return int(tok[0])

    def _finish_prefill(self, slot, ps, tok):
        """The final chunk sampled the first token: emit it and either
        move the slot to decoding or release it."""
        req = ps.req
        L = req.prompt.size
        del self._prefill[slot]
        now = time.perf_counter()
        req._ttft = now - req._t_submit
        self._m_ttft.observe(req._ttft)
        self._m_gen.inc()
        req._t_last = now
        _tr.point("req/first_token", trace_id=req.trace_id, rid=req.rid,
                  ttft_s=req._ttft)
        if not req._emit(tok):
            self._slots[slot] = req
            self._token[slot] = tok
            self._pos[slot] = L
            self._temp[slot] = req.temperature
            self._topp[slot] = req.top_p
            self._greedy[slot] = req.greedy
        else:
            # finished at prefill (max_new_tokens=1 or instant EOS)
            self._gens[slot] = None
            self._pager.release_slot(slot)
            self._m_completed.inc()

    # -- the scheduler -----------------------------------------------------

    @property
    def num_active(self):
        """Slots in the decode phase."""
        return sum(r is not None for r in self._slots)

    @property
    def num_prefilling(self):
        return len(self._prefill)

    @property
    def has_work(self):
        return bool(self._queue or self._prefill or self.num_active)

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: reap cancellations and expiries,
        admit queued requests into free slots, spend the token budget
        left after one decode token per active slot on prefill chunks,
        then one vectorised decode step over every slot.  Returns True
        while there is (or was) work."""
        t = _tr.t0()
        self._reap_cancelled()
        _tr.end("step/schedule", t)
        t = _tr.t0()
        self._admit()
        _tr.end("step/admit", t)
        if self._prefill:
            self._run_chunks(self.step_token_budget - self.num_active)
        self._m_active.set(self.num_active)
        if self.num_active == 0:
            self._t_prev_step = None        # idle gap: disarm the EMA clock
            return self.has_work
        self._ensure_decode_capacity()
        self._commit_decode(*self._dispatch_decode())
        self._m_active.set(self.num_active)
        return True

    def _ensure_decode_capacity(self):
        """Every decoding slot must own the block its write row lands in
        before the step: grow tables one block at a time as decode
        crosses block edges.  The pool is fully provisioned, so growth
        cannot fail."""
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            rows = min(int(self._pos[slot]) + 1, self.max_len)
            if not self._pager.ensure_rows(slot, rows):
                raise RuntimeError("KV pool exhausted despite full "
                                   "provisioning")

    def _dispatch_decode(self):
        """Run one vectorised single-token decode step over every slot
        and sample each row; returns (host tokens, active count)."""
        active = self.num_active
        t = _tr.t0()
        dev = self.device
        logits, _ = D.paged_decode_step_batch(
            self.state, self.cfg, torch.from_numpy(self._token).to(dev),
            torch.from_numpy(self._pos).to(dev), self._kvpool,
            torch.from_numpy(self._pager.table).to(dev),
            kernel=self.decode_kernel)
        nxt = sample_logits_per_slot(logits, self._gens, self._temp,
                                     self._topp, self._greedy)
        _tr.end("step/dispatch", t, args={"slots": active})
        t = _tr.t0()
        nxt = nxt.cpu().numpy()             # host sync: EOS + streaming
        _tr.end("step/sample_readback", t)
        return nxt, active

    def _commit_decode(self, nxt, active):
        """Per-slot token emission, EOS / max_new resolution and slot
        frees for the decode step just run."""
        now = time.perf_counter()
        self._m_steps.inc()
        self._m_gen.inc(active)
        self._tput_tick(now, active)
        for slot, req in enumerate(list(self._slots)):
            if req is None:
                continue
            tok = int(nxt[slot])
            self._pos[slot] += 1
            self._token[slot] = tok
            if req._t_last is not None:
                self._m_itl.observe(now - req._t_last)
            req._t_last = now
            if req._emit(tok):
                self._free_slot(slot)       # freed for the next admit
                self._m_completed.inc()
                self._m_evicted.inc()

    def _tput_tick(self, now, tokens):
        if self._t_prev_step is not None:
            dt = now - self._t_prev_step
            if dt > 0:
                tput = tokens / dt
                self._tput_ema = tput if self._tput_ema is None else \
                    0.8 * self._tput_ema + 0.2 * tput
                self._m_tput.set(self._tput_ema)
        self._t_prev_step = now

    def run(self, max_steps=None):
        """Drive until the queue and every slot drain; returns the
        number of scheduler steps taken."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    def kv_pool_bytes(self):
        """Total bytes of the paged KV pool (all layers, K+V, int8
        scale tensors included)."""
        return sum(x.numel() * x.element_size()
                   for entry in self._kvpool for part in entry
                   for x in (part if isinstance(part, tuple) else (part,)))
