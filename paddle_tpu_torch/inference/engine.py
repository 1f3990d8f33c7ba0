"""Continuous-batching paged-KV decode engine — the port of
`paddle_tpu/inference/engine.py`'s single-replica core, in PyTorch.

    engine = LLMEngine(model, max_slots=8, max_len=1024, prefill_chunk=128)
    req = engine.submit([1, 2, 3], max_new_tokens=32)
    engine.run()               # drive until every request finishes
    req.tokens                 # generated ids (prompt excluded)

What this slice keeps of the JAX engine:

  * ONE paged KV pool (`kv_blocks` blocks of `kv_block_tokens` rows per
    layer, block 0 the trash block) shared by every slot through a
    per-slot block table (`kv_pager.KVPager`, copied as is), refcounted
    so several tables may name one block.  By default the pool is
    provisioned in full; below that (`kv_blocks >= 1 + blocks a slot`)
    a shortage climbs the PREEMPT LADDER: reclaim unpinned prefix-cache
    blocks, requeue the newest mid-prefill slot, then park a decoding
    slot (lowest `priority`, newest admission first) — its blocks
    swapped to a pinned host tier (`host_pool_blocks`, one non-blocking
    copy behind a CUDA event) or dropped for recompute
    (`preempt_policy` "auto" / "swap" / "recompute").  A parked request
    resumes before any new admission with the stream it would have had
    unpreempted (its token, depth and generator restored, never
    resampled); a failed swap is a counted fallback to recompute;
  * the RADIX PREFIX CACHE (`prefix_cache_blocks`, chunked prefill
    only): a finished prompt's full blocks are aliased into a trie
    (`prefix_cache.RadixPrefixCache`), and an admission whose prompt
    starts with cached blocks aliases them into its table and prefills
    only the rest;
  * a TOKEN-BUDGET iteration scheduler: each `step()` spends
    `step_token_budget` tokens, one decode token per active slot first,
    the remainder on prefill in pow-2 chunks (`prefill_chunk`); the
    oldest mid-prefill slot always gets one chunk per step.
    `prefill_chunk=None` is the legacy whole-bucket prefill instead:
    each admitted prompt runs whole, padded to a pow-2 bucket, at
    admission (float pools only);
  * ONE vectorised decode step over every slot at per-slot depths, its
    attention through the Hopper paged-attention kernel
    (`decode_kernel="cuda"`, K4, with `decode_block_tile` table blocks
    per split) or the gather path (`"gather"`).  On a CUDA model the
    step is a CUDA graph per decode width (`programs.DecodeGraphs`, the
    JAX engine's jitted `_step_fn`): every decode step is a replay,
    none runs eagerly on the card, and a failed capture or replay
    raises.  `decode_buckets=True` compacts the live slots into the
    smallest pow-2 width that holds them (pad rows clone a live slot;
    their duplicate K/V writes rewrite the same values);
  * per-slot sampling with one `torch.Generator` per request, so a
    request's tokens depend only on its own seed: greedy rows take the
    graph's argmax, sampled rows are drawn after the replay from the
    graph's logits (`generation.sample_rows`); a pad row never draws;
  * the overlap driver (`overlap`): the host work of step N+1
    (reaping, admission, prefill chunks) runs while the card computes
    step N, whose tokens commit one `step()` later — streams are
    bitwise those of the synchronous driver;
  * SPECULATIVE DECODING (`speculation`: a `SpecConfig`, True, an int
    k, or False / None; chunked prefill only): each decoding slot keeps
    a rolling n-gram index over its prompt + tokens
    (`ngram_draft.NGramIndex`) and proposes up to its adaptive k draft
    tokens; when any slot drafted, the step is ONE batched verify over
    every slot at the pow-2 width W >= 1 + the longest draft
    (`verify_widths`; `llama_decode.paged_verify_step`, K4 over all
    B * W columns on the card), a CUDA graph per verify width beside
    the decode graphs (`programs.VerifyGraphs`).  Greedy slots accept
    the longest argmax-matching draft prefix (in the graph), sampled
    slots draw one token per column after the replay
    (`generation.accept_rows`): every stream is the one it has without
    speculation.  Drafts are charged against `step_token_budget` before
    the prefill chunks (the overlap driver budgets chunks against
    active slots only and proposes after its deferred commit); EOS or
    `max_new_tokens` inside an accepted run truncates the emission; a
    per-slot acceptance EMA halves or doubles the draft length; a
    parked slot keeps its drafter;
  * SLO TIERS and the OVERLOAD LADDER: every request carries a tier
    (`Request(tier=)`: "interactive", "standard" (default) or "batch",
    `observability.slo.SLOTier`).  The queue admits the highest tier
    first (FIFO within a tier); the preempt ladder parks, and resumes,
    by tier before `priority`.  With `overload` armed
    (`overload.OverloadController`) a host-side tick at every step
    boundary walks a reversible four-rung ladder from the protected
    queue depth, parked count, preemptions, host-tier occupancy and
    decode ITL: rung 1 drafts nothing for the lowest tier, rung 2
    shrinks its prefill share, rung 3 holds it in the queue, rung 4
    sheds it (`Overloaded`, at submit and from the queue).  Each
    finished request is met / missed against its tier's
    `slo_targets` (goodput);
  * EOS, `max_new_tokens`, cancellation and deadline handling at step
    boundaries, a bounded admission queue (`max_queue` -> `QueueFull`),
    `Request.result(timeout=)`, and the `llm_engine_*` TTFT / ITL /
    token / host-gap / `spec_*` / tier / overload metrics.

The JAX engine's other knobs (tiered KV, weight-only int8, meshes, the
AOT cache, the KV fabric) raise `NotImplementedError` naming their
ROADMAP item — never silently ignored; so do the `Request` fields of
the fabric (`prefix_hint`, `session_id`, `handoff`).  Of the ladder,
the port leaves out the CRC32C stamp on parked host copies (with the
fabric, (h)), the tiered spill rung ((g)) and the disk tier (a parked
request is always claimable here).  Its bounded compile count becomes
a bound on captured graphs: `num_graphs` <= `len(decode_widths) +
len(verify_widths)`.

The graphs hold the pool by address: everything that writes it
(prefill, the steps, a swap-in's `scatter_blocks`) writes in place, and
every write is queued on the one stream, behind the step in flight.
A verify writes W rows a slot; rows of rejected drafts stay dead in
place, because `pos` never advances past the accepted length.

Padding correctness: a prompt's padded tail chunk writes garbage K/V at
rows >= its true length, and the decode step writes each slot's token
at `pos` before attending with mask t <= pos, so a garbage row is
always overwritten before it becomes visible — as are rows a slot's
previous occupant left, and the garbage row the decode step writes at a
mid-prefill slot's frontier.  Under overlap the same holds in stream
order: every chunk is queued behind the step in flight.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from ..generation import (accept_rows, greedy_accept,
                          sample_logits_per_slot, sample_rows,
                          settle_generators)
from ..models import llama_decode as D
from ..observability import tracing as _tr
from ..observability.metrics import MetricsRegistry, log_buckets
from ..observability.slo import SLOTargets, SLOTier
from ..testing import faults as _faults
from .kv_pager import KVPager
from .ngram_draft import NGramIndex, SpecConfig
from .overload import OverloadConfig, OverloadController
from .prefix_cache import RadixPrefixCache
from .programs import DecodeGraphs, VerifyGraphs, unpack_verify

__all__ = ["Request", "LLMEngine", "DeadlineExceeded", "QueueFull",
           "EngineUnhealthy", "ResultTimeout", "Overloaded"]

_REQ_IDS = itertools.count()

# knobs of the JAX engine this slice does not port: name -> (the values
# that mean "off", the ROADMAP item that ports it)
_TIERED = "engine sub-slice (g): tiered KV and long context"
_FABRIC = "engine sub-slice (h): KV fabric and disaggregated serving"
_MULTI = "multi-GPU serving"
_UNPORTED = {
    "hot_window": ((None,), _TIERED),
    "prefetch_depth": ((2,), _TIERED),
    "aot_cache": ((None,),
                  "engine sub-slice (j): the AOT serving-program cache"),
    "fabric": ((None,), _FABRIC),
    "mesh": ((None,), _MULTI),
    "tp": ((None, 1), _MULTI),
    "sp": ((None, 1), _MULTI),
    # the Request fields of the KV fabric
    "prefix_hint": ((None,), _FABRIC),
    "session_id": ((None,), _FABRIC),
    "handoff": ((None,), _FABRIC),
}


def _reject_unported(**knobs):
    """Raise for an unported JAX knob set to anything but "off"."""
    for name, value in knobs.items():
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
    """The serving driver thread crashed (or the server quarantined
    itself); the engine accepts no new work."""


class Overloaded(RuntimeError):
    """The overload ladder reached its shed rung (4): the lowest SLO
    tier is rejected / failed so the protected tiers keep their SLOs.
    A typed, retryable rejection."""


class ResultTimeout(TimeoutError):
    """`result(timeout=)` expired before the request finished (the
    request itself keeps running)."""


class Request:
    """One generation request: prompt-in, tokens-out.

    `tokens` accumulates generated ids (the prompt is not echoed);
    `on_token(request, token)` streams each token as it is produced;
    `on_done(request)` fires exactly once when the request finishes for
    ANY reason (EOS, max_new_tokens, cancellation, deadline, shedding,
    engine failure); `done` flips when the request leaves the engine,
    and `result(timeout=)` blocks for it.  `cancel()` is cooperative: a
    queued request is dropped at admit, an in-flight one evicted at the
    next step boundary.  `deadline` (seconds from submit) bounds the
    request's whole life; expiry finishes it with `error` set to a
    `DeadlineExceeded`.  `seed` seeds the request's own sampling
    generator.  `tier` (`SLOTier`, default "standard") is the primary
    scheduling class: admission, park and resume order and the overload
    ladder key on it; `priority` breaks ties within a tier (under pool
    pressure the lowest priority, then the most recently admitted,
    decoding slot parks first).  `prefix_hint`, `session_id` and
    `handoff` belong to the KV fabric and raise unless None."""

    def __init__(self, prompt_ids, max_new_tokens, temperature=1.0,
                 top_p=1.0, greedy=True, eos_token_id=None, seed=0,
                 on_token=None, on_done=None, deadline=None, priority=0,
                 tier=None, prefix_hint=None, session_id=None,
                 trace_id=None, handoff=None):
        _reject_unported(prefix_hint=prefix_hint, session_id=session_id,
                         handoff=handoff)
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
        self.priority = int(priority)
        self.tier = SLOTier.check(tier)
        self.on_token = on_token
        self.on_done = on_done
        self.tokens: list[int] = []
        self.done = False
        self.cancelled = False
        self.error: BaseException | None = None
        self._done_fired = False
        self._done_ev = threading.Event()
        if deadline is not None and float(deadline) <= 0:
            raise ValueError("deadline must be positive seconds")
        self._deadline_t = (None if deadline is None
                            else time.monotonic() + float(deadline))
        # TTFT counts from construction (queue wait included), ITL from
        # the previous token's host-visible time; the ITL sum and count
        # feed the met / missed decision at completion
        self._t_submit = time.perf_counter()
        self._t_last: float | None = None
        self._ttft: float | None = None
        self._itl_sum = 0.0
        self._itl_n = 0

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
        # set AFTER on_done: once result() returns, the callbacks ran
        self._done_ev.set()

    def result(self, timeout=None):
        """Block until this request finishes; returns its generated
        tokens.  Raises `ResultTimeout` once `timeout` seconds pass with
        the request still live (it keeps running), and re-raises the
        request's typed error (DeadlineExceeded, Overloaded,
        EngineUnhealthy, ...) when it failed.  `timeout=None` waits
        without bound."""
        if not self._done_ev.wait(timeout):
            raise ResultTimeout(
                f"request {self.rid} still running after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.tokens

    def _finish_cancelled(self):
        self._fire_done()

    def _finish_error(self, exc: BaseException):
        if self.error is None:
            self.error = exc
        self._fire_done()


class _PrefillState:
    """A slot mid-chunked-prefill: the request, the token ids being
    prefilled (`ids`: the prompt, or prompt + generated tokens for a
    drop-and-recompute resume), its write frontier `off` (rows [0, off)
    of the slot's cache are valid, cache-hit rows included), the
    prefix-cache nodes pinned on its behalf, and the parked record
    being restored (None for a fresh admission)."""

    __slots__ = ("req", "ids", "off", "nodes", "restore")

    def __init__(self, req, off, nodes, ids=None, restore=None):
        self.req = req
        self.ids = req.prompt if ids is None else ids
        self.off = off
        self.nodes = nodes
        self.restore = restore


class _ParkedRequest:
    """A preempted decode slot's host-side state, enough to resume it
    with the stream it would have had unpreempted: its last token,
    depth, sampling generator (the JAX engine's RNG key), drafter state
    (n-gram index, draft length, acceptance EMA) and admission
    order.  `mode` "swap": `host` holds its blocks (`n_blocks`, packed
    by `llama_decode.gather_blocks`) in pinned host memory, `event` the
    CUDA event after their copy (None on the CPU); "recompute": the KV
    was dropped and resume re-prefills prompt + tokens[:-1]."""

    __slots__ = ("req", "mode", "token", "pos", "gen", "spec_idx",
                 "spec_k", "spec_ema", "host", "event", "n_blocks",
                 "admit_seq", "t_parked")

    def __init__(self, req, mode, token, pos, gen, spec_idx, spec_k,
                 spec_ema, host, event, n_blocks, admit_seq):
        self.req = req
        self.mode = mode
        self.token = int(token)
        self.pos = int(pos)
        self.gen = gen
        self.spec_idx = spec_idx
        self.spec_k = spec_k
        self.spec_ema = spec_ema
        self.host = host
        self.event = event
        self.n_blocks = int(n_blocks)
        self.admit_seq = admit_seq
        self.t_parked = time.perf_counter()


class _InflightStep:
    """A dispatched device step whose tokens are not committed yet:
    `kind` "decode" or "verify", its readback `tokens` (a pinned host
    buffer and the CUDA event after its copy, or the eager step's
    tensor and None: a decode step's tokens, a verify step's packed
    [out (B * W) | accept length (B)]), the per-slot request snapshot
    taken at dispatch (phase-A work never touches decoding slots, so
    the snapshot stays the truth until commit), the active count, and
    `rows`: the slot behind each compacted decode row (None: the full
    width, row i is slot i).  A verify also carries its width, each
    slot's `valid` (1 + draft length), and the sampled rows'
    generators with their states after each draw (settled at
    commit)."""

    __slots__ = ("kind", "tokens", "event", "reqs", "active", "rows",
                 "width", "valid", "gens", "states")

    def __init__(self, tokens, event, reqs, active, rows=None,
                 kind="decode", width=1, valid=None, gens=None,
                 states=None):
        self.kind = kind
        self.tokens = tokens
        self.event = event
        self.reqs = reqs
        self.active = active
        self.rows = rows
        self.width = width
        self.valid = valid
        self.gens = gens
        self.states = states or {}


def _decode_fn(state, cfg, pool, kernel, kw):
    """The decode step over device inputs (token, pos, table) -> logits,
    the pool written in place: what each CUDA graph records.  A closure
    over the engine's state, not the engine, so the graphs that hold it
    form no reference cycle with the engine."""
    def decode_logits(token, pos, table):
        logits, _ = D.paged_decode_step_batch(state, cfg, token, pos, pool,
                                              table, kernel=kernel, **kw)
        return logits
    return decode_logits


def _verify_fn(state, cfg, pool, kernel, kw):
    """The verify step over device inputs (tokens (B, W), pos, valid,
    table) -> (logits (B, W, V), packed int64 [greedy argmax (B * W) |
    greedy accept length (B)]), the pool written in place: what each
    verify graph records (a closure over the state, as `_decode_fn`)."""
    def verify(tokens, pos, valid, table):
        logits, _ = D.paged_verify_step(state, cfg, tokens, pos, pool,
                                        table, kernel=kernel, **kw)
        am, acc = greedy_accept(logits, tokens, valid)
        return logits, torch.cat([am.reshape(-1), acc])
    return verify


def _bucket_sizes(max_prompt_len, min_bucket=16):
    """Power-of-two prefill buckets covering [1, max_prompt_len]."""
    sizes, b = [], min_bucket
    while b < max_prompt_len:
        sizes.append(b)
        b *= 2
    sizes.append(b)
    return tuple(sizes)


class LLMEngine:
    """Request-in / tokens-out continuous-batching engine over a
    `LlamaForCausalLM`, on the model's device.

    Knobs: `max_slots`, `max_len`, `max_prompt_len` (default max_len //
    2), `min_bucket`, `prefill_chunk` (pow-2 chunk width, or None for
    the whole-bucket prefill at admission), `step_token_budget`
    (default prefill_chunk + max_slots; chunked prefill only),
    `kv_block_tokens` (default `prefix_block_tokens`, 16), `kv_blocks`
    (default: full provisioning, 1 + max_slots * ceil(max_len /
    kv_block_tokens) + prefix_cache_blocks; minimum 1 + one slot's
    blocks: below full provisioning the preempt ladder absorbs a
    shortage), `host_pool_blocks` (the pinned host swap tier, default
    max_slots * blocks a slot; 0 disables it), `preempt_policy`
    ("auto": swap a parked slot deeper than 2 blocks, recompute a
    shallower one; "swap"; "recompute"), `prefix_cache_blocks` (the
    trie's budget of pool blocks, 0 = off; chunked prefill only) and
    `prefix_block_tokens` (== kv_block_tokens), `kv_dtype` (None /
    "auto", "bfloat16", "float32", "int8"), `weight_dtype` (None /
    "auto"; "int8" swaps each layer's matmul weights for weight-only
    int8 pairs, kernel Q1 on the card; embedding, norms and head stay
    full precision),
    `decode_kernel` ("auto" = "cuda" on a CUDA model, "gather" on the
    CPU; "cuda" on a CPU model runs the kernel's plain version),
    `speculation` (None / False: off; a `SpecConfig`, True for
    `SpecConfig()`, or an int k for `SpecConfig(k=k)`; chunked prefill
    only), `decode_block_tile` (table blocks per K4 split: split =
    decode_block_tile * kv_block_tokens rows, a power of two in
    [8, 256]; None = `ops.paged_attention.split_rows`),
    `decode_buckets` (False: one decode width, max_slots; True: the
    pow-2 widths below max_slots, plus max_slots), `overlap` ("auto" =
    "on" on a CUDA model and "off" on the CPU, "on", "off", True,
    False), `max_queue` (None = unbounded), `slo_targets` (an
    `SLOTargets`, or a {tier: (ttft_s, itl_s)} dict over the defaults),
    `overload` (None: the ladder disarmed; True, an `OverloadConfig` or
    an `OverloadController`).  The parameters are in the JAX engine's
    order; `hot_window`, `prefetch_depth`, `fabric`,
    `mesh`, `tp`, `sp` and `aot_cache` raise `NotImplementedError`
    naming their ROADMAP item unless "off".  Single-threaded by design;
    see `serving.LLMServer` for the thread-safe front."""

    def __init__(self, model, max_slots=4, max_len=256,
                 max_prompt_len=None, min_bucket=16, prefill_chunk=64,
                 step_token_budget=None, prefix_cache_blocks=0,
                 prefix_block_tokens=16, max_queue=None, speculation=None,
                 kv_blocks=None, kv_block_tokens=None,
                 host_pool_blocks=None, preempt_policy="auto",
                 hot_window=None, prefetch_depth=2,
                 kv_dtype=None, weight_dtype=None, decode_kernel="auto",
                 decode_block_tile=None, decode_buckets=False,
                 slo_targets=None, overload=None,
                 fabric=None, mesh=None, tp=None, sp=None,
                 overlap="auto", aot_cache=None):
        _reject_unported(hot_window=hot_window,
                         prefetch_depth=prefetch_depth, fabric=fabric,
                         mesh=mesh, tp=tp, sp=sp, aot_cache=aot_cache)
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
        self.buckets = _bucket_sizes(self.max_prompt_len, min_bucket)

        if kv_dtype not in (None, "auto", "int8", "bfloat16", "float32"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} (None/'auto', "
                             f"'bfloat16', 'float32', or 'int8')")
        self.prefill_chunk = None if prefill_chunk is None \
            else int(prefill_chunk)
        if self.prefill_chunk is not None:
            c = self.prefill_chunk
            if c <= 0 or (c & (c - 1)):
                raise ValueError("prefill_chunk must be a power of two")
            lo = min(int(min_bucket), c)
            self.chunk_sizes = tuple(lo << i for i in
                                     range((c // lo).bit_length())
                                     if lo << i <= c)
            self.step_token_budget = int(step_token_budget
                                         if step_token_budget is not None
                                         else c + self.max_slots)
            if self.step_token_budget <= 0:
                raise ValueError("step_token_budget must be positive")
        else:
            self.chunk_sizes = ()
            if step_token_budget is not None:
                raise ValueError("step_token_budget requires chunked "
                                 "prefill (prefill_chunk)")
            if kv_dtype == "int8":
                raise ValueError(
                    "kv_dtype='int8' requires chunked prefill "
                    "(prefill_chunk): the whole-bucket prefill attends a "
                    "local float cache whose rows were never quantized")
            self.step_token_budget = None

        if speculation is True:
            speculation = SpecConfig()
        elif isinstance(speculation, int) and not isinstance(
                speculation, bool):
            speculation = SpecConfig(k=speculation)
        elif speculation is False:
            speculation = None
        self.spec = speculation.validate() if speculation is not None \
            else None
        self.verify_widths = ()
        if self.spec is not None:
            if self.prefill_chunk is None:
                raise ValueError("speculation requires chunked prefill "
                                 "(prefill_chunk)")
            # pow-2 verify widths {2, 4, ..., next_pow2(k + 1)}: one
            # verify graph per width bounds the graph count
            widths, w = [], 2
            while w < self.spec.k + 1:
                widths.append(w)
                w *= 2
            self.verify_widths = tuple(widths) + (w,)

        if decode_kernel not in ("auto", "cuda", "gather"):
            raise ValueError(f"unknown decode_kernel {decode_kernel!r} "
                             "('auto', 'cuda', or 'gather')")
        self.kv_dtype = "auto" if kv_dtype is None else str(kv_dtype)
        on_cuda = self.device.type == "cuda"
        self.decode_kernel = decode_kernel if decode_kernel != "auto" \
            else ("cuda" if on_cuda else "gather")

        bt = int(kv_block_tokens) if kv_block_tokens is not None \
            else int(prefix_block_tokens)
        if bt <= 0:
            raise ValueError("kv_block_tokens must be positive")
        if int(prefix_cache_blocks) > 0 and bt != int(prefix_block_tokens):
            raise ValueError(
                "kv_block_tokens must equal prefix_block_tokens: the "
                "prefix cache aliases pool blocks, so slot tables and "
                "the trie must share one block geometry")
        self.kv_block_tokens = bt
        # K4's split keyword, passed only when set: None keeps the
        # kernel's own `split_rows(...)` (the JAX engine's autotune tile)
        self._decode_kw = {}
        if decode_block_tile is not None:
            split = int(decode_block_tile) * bt
            if split < 8 or split > 256 or split & (split - 1):
                raise ValueError(
                    f"decode_block_tile={decode_block_tile!r} x "
                    f"kv_block_tokens={bt} = {split} rows a split: must "
                    f"be a power of two in [8, 256]")
            self._decode_kw = {"split": split}

        self.decode_buckets = bool(decode_buckets)
        widths, w = [], 1
        while self.decode_buckets and w < self.max_slots:
            widths.append(w)
            w *= 2
        self.decode_widths = tuple(widths) + (self.max_slots,)

        if overlap not in ("auto", "on", "off", True, False):
            raise ValueError(f"unknown overlap {overlap!r} "
                             "('auto', 'on', 'off', True or False)")
        if overlap == "auto":
            overlap = "on" if on_cuda else "off"
        self.overlap_mode = {True: "on", False: "off"}.get(overlap, overlap)
        self.overlap = self.overlap_mode == "on"

        # "int8": each layer's seven matmul weights as weight-only int8
        # (data, scale) pairs, run by kernel Q1 in every serving
        # program; the model's float parameters stay held, as the JAX
        # engine holds them
        self.weight_dtype = "auto" if weight_dtype is None \
            else str(weight_dtype)
        self.state = D.collect_decode_state(model,
                                            weight_dtype=weight_dtype)
        dtype = self.state["embed"].dtype
        bmax = -(-self.max_len // bt)            # blocks per full slot
        full = 1 + self.max_slots * bmax + int(prefix_cache_blocks)
        self.kv_blocks = full if kv_blocks is None else int(kv_blocks)
        self.host_pool_blocks = (self.max_slots * bmax
                                 if host_pool_blocks is None
                                 else int(host_pool_blocks))
        if preempt_policy not in ("auto", "swap", "recompute"):
            raise ValueError(f"unknown preempt_policy {preempt_policy!r}")
        self.preempt_policy = preempt_policy
        if self.kv_blocks < 1 + bmax:
            raise ValueError(
                f"kv_blocks={self.kv_blocks} cannot cover one "
                f"max_len sequence (+trash block): need >= "
                f"{1 + bmax}")
        self._pager = KVPager(self.kv_blocks, bt, self.max_slots, bmax,
                              host_pool_blocks=self.host_pool_blocks,
                              kv_dtype=self.kv_dtype)
        self._kvpool = D.init_paged_cache(self.cfg, self.kv_blocks, bt,
                                          dtype, kv_dtype=kv_dtype,
                                          device=self.device)
        # bytes of one block over every layer, K and V (int8 scales
        # included): the unit of swap accounting
        self._kv_block_bytes = sum(t.numel() // self.kv_blocks
                                   * t.element_size()
                                   for t in D.pool_leaves(self._kvpool))
        self._pcache = None
        if int(prefix_cache_blocks) > 0:
            if self.prefill_chunk is None:
                raise ValueError("prefix_cache_blocks requires chunked "
                                 "prefill (prefill_chunk)")
            # the trie's budget of blocks inside the shared pool: a hit
            # aliases its blocks into the slot's table (refcount + 1)
            self._pcache = RadixPrefixCache(int(prefix_cache_blocks), bt,
                                            pager=self._pager)

        # host-side mirrors of the per-slot decode inputs (tiny arrays)
        B = self.max_slots
        self._token = np.zeros(B, np.int32)
        self._pos = np.zeros(B, np.int32)
        self._temp = np.ones(B, np.float32)
        self._topp = np.ones(B, np.float32)
        self._greedy = np.ones(B, bool)
        self._gens: list = [None] * B               # per-slot sampler
        # per-slot speculation state: the rolling n-gram index, the
        # adaptive draft length and its acceptance EMA
        self._spec_idx: list = [None] * B
        self._spec_k = [0] * B
        self._spec_ema = [1.0] * B
        self._slots: list = [None] * B              # decoding requests
        self._slot_nodes: list = [[] for _ in range(B)]  # trie pins
        self._prefill: dict = {}                    # slot -> _PrefillState
        self._queue: deque = deque()
        # preempt / resume: per-slot admission order (the victim key)
        # and the parked requests in park order
        self._admit_counter = itertools.count()
        self._slot_seq = [0] * B
        self._parked: list = []
        self._swap_total = 0        # swap-ins begun
        self._swap_ready = 0        # ... whose copy to the host had landed
        # quarantine: parked requests stay parked, never resumed here
        # (deadline expiry still bounds them)
        self.freeze_parked = False
        self._inflight = None          # dispatched, uncommitted step
        self._t_retire = None          # host-gap anchor (see metrics)
        # the watchdog's heartbeat: monotonic stamp of the last step
        # begun (the server compares it against its deadline)
        self.last_step_t = time.monotonic()

        # SLO tiers and the overload ladder
        self.slo_targets = (slo_targets if isinstance(slo_targets,
                                                      SLOTargets)
                            else SLOTargets(slo_targets))
        if overload is True:
            overload = OverloadConfig()
        if isinstance(overload, OverloadConfig):
            overload = OverloadController(overload)
        if overload is not None and not isinstance(overload,
                                                   OverloadController):
            raise ValueError(
                f"overload must be None/True/OverloadConfig/"
                f"OverloadController, got {overload!r}")
        self._overload = overload           # None = ladder disarmed
        self._op_last_preempt = 0           # preempt-rate window anchor
        self._itl_ema: float | None = None  # decode ITL EMA (signal)
        # the server's windowed ITL p50 (its series sampler sets it);
        # the ladder reads it before the EMA
        self._itl_window_s: float | None = None

        # the decode step as CUDA graphs (one per width) on a CUDA
        # model; the CPU runs the same step eagerly
        self._decode_logits = _decode_fn(self.state, self.cfg, self._kvpool,
                                         self.decode_kernel, self._decode_kw)
        self._verify_logits = _verify_fn(self.state, self.cfg, self._kvpool,
                                         self.decode_kernel, self._decode_kw)
        self._graphs = self._vgraphs = None
        if on_cuda:
            self._graphs = DecodeGraphs(self._decode_logits,
                                        self.decode_widths, bmax,
                                        self.device)
            n, m = self._graphs.flat_len(B), B
            if self.spec is not None:
                self._vgraphs = VerifyGraphs(
                    self._verify_logits, self.verify_widths, B, bmax,
                    self.device, pool=self._graphs.pool)
                wmax = self.verify_widths[-1]
                n = max(n, self._vgraphs.flat_len(wmax))
                m = B * wmax + B
            # pinned staging, one set per step in flight (overlap keeps
            # one in flight while the next is dispatched): the inputs in
            # the graphs' flat layout, and the tokens (a verify: the
            # packed output) read back
            self._staging = [
                (torch.empty(n, dtype=torch.int32, pin_memory=True),
                 torch.empty(m, dtype=torch.int64, pin_memory=True))
                for _ in range(2)]
            self._n_dispatched = 0
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
        self._m_steps = reg.counter(
            "decode_steps_total",
            help="vectorized device steps run (decode or verify)")
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
        # the host-side headline: time between a decode step's tokens
        # reaching the host and the next decode dispatch, the window
        # the card waits on the scheduler (idle queue waits excluded)
        self._m_host_gap = reg.histogram(
            "host_gap_seconds",
            help="host time between a decode step retiring (tokens on "
                 "the host) and the next decode dispatch (idle queue "
                 "waits excluded)",
            buckets=log_buckets(1e-6, 10.0, per_decade=3))
        self._m_host_gap_last = reg.gauge(
            "host_gap_last_seconds",
            help="most recent host gap (instant view of the histogram)")
        self._m_first_wait = reg.counter(
            "first_token_waits_total",
            help="first tokens read back while a decode step was in "
                 "flight (overlap): on the card the read waits for that "
                 "step")
        # the radix prefix cache
        self._m_cache_hit = reg.counter(
            "prefix_cache_hits_total",
            help="admissions that matched a cached prefix")
        self._m_cache_miss = reg.counter(
            "prefix_cache_misses_total",
            help="admissions with no cached prefix")
        self._m_cache_evict = reg.counter(
            "prefix_cache_evictions_total",
            help="LRU block evictions under pool pressure")
        self._m_tokens_saved = reg.counter(
            "prefill_tokens_saved_total",
            help="prompt tokens served from the prefix cache instead "
                 "of prefill compute")
        self._m_cache_blocks = reg.gauge(
            "prefix_cache_blocks_used",
            help="pool blocks currently holding cached prefixes")
        # the preempt ladder
        self._m_kv_used = reg.gauge(
            "kv_blocks_used",
            help="device pool blocks with at least one owner (slot "
                 "tables + prefix-cache trie; trash block excluded)")
        self._m_kv_host = reg.gauge(
            "kv_blocks_host",
            help="pinned host-RAM tier blocks holding swapped-out "
                 "(parked) KV")
        reg.gauge("kv_blocks_total",
                  help="configured device pool size in blocks") \
            .set(self.kv_blocks - 1)
        self._m_parked = reg.gauge(
            "requests_parked",
            help="preempted requests waiting to resume (swap or "
                 "recompute tier)")
        self._m_preempt = reg.counter(
            "preemptions_total",
            help="decode slots parked under pool pressure (swap-out or "
                 "drop-and-recompute; mid-prefill requeues excluded)")
        self._m_resume = reg.counter(
            "resumes_total",
            help="parked requests resumed into a slot")
        self._m_prefill_requeued = reg.counter(
            "prefill_requeues_total",
            help="mid-prefill slots requeued under pool pressure (the "
                 "cheap rung of the preempt ladder: nothing emitted "
                 "yet)")
        self._m_swap_bytes = reg.counter(
            "swap_bytes_total",
            help="KV payload bytes moved device->host by swap-outs "
                 "(the resume path moves the same bytes back)")
        self._m_kv_reclaimed = reg.counter(
            "kv_blocks_reclaimed_total",
            help="prefix-cache blocks reclaimed by the preempt "
                 "ladder's first rung")
        self._m_park_time = reg.histogram(
            "park_time_seconds",
            help="park -> resume wall time per preemption",
            buckets=log_buckets(1e-4, 600.0, per_decade=3))
        # speculative decoding
        self._m_spec_steps = reg.counter(
            "spec_verify_steps_total",
            help="batched verify steps run (scheduler steps where at "
                 "least one slot had a draft)")
        self._m_spec_proposed = reg.counter(
            "spec_tokens_proposed_total",
            help="draft tokens proposed by the n-gram drafter")
        self._m_spec_accepted = reg.counter(
            "spec_tokens_accepted_total",
            help="draft tokens accepted by the batched verify")
        self._m_spec_rolled = reg.counter(
            "spec_tokens_rolled_back_total",
            help="draft tokens rejected by verify (their KV rows are "
                 "left dead in place — no copy rollback)")
        self._m_accept_rate = reg.histogram(
            "spec_acceptance_rate",
            help="per-slot fraction of its proposed draft accepted by "
                 "one verify step",
            buckets=[0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                     1.0])
        self._m_step_tokens = reg.histogram(
            "tokens_emitted_per_step",
            help="tokens emitted by one scheduler step across all slots "
                 "(speculation multiplies this; plain decode emits one "
                 "per active slot)",
            buckets=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0])
        # SLO tiers, goodput and the overload ladder: tier-labelled
        # children resolved once here
        t_ttft = reg.histogram(
            "tier_ttft_seconds",
            help="submit -> first token, per SLO tier",
            labelnames=("tier",),
            buckets=log_buckets(1e-3, 600.0, per_decade=3))
        t_itl = reg.histogram(
            "tier_itl_seconds",
            help="inter-token latency per SLO tier",
            labelnames=("tier",),
            buckets=log_buckets(1e-4, 60.0, per_decade=3))
        met = reg.counter(
            "slo_met_total",
            help="finished requests that met their tier's TTFT + mean-"
                 "ITL targets", labelnames=("tier",))
        missed = reg.counter(
            "slo_missed_total",
            help="finished requests that missed their tier's targets",
            labelnames=("tier",))
        gp = reg.gauge(
            "slo_goodput",
            help="fraction of finished requests meeting their tier's "
                 "SLO (the headline serving metric)",
            labelnames=("tier",))
        shed = reg.counter(
            "requests_shed_total",
            help="requests rejected/failed by the overload ladder's "
                 "shed rung (typed Overloaded — distinct from the "
                 "bounded-queue QueueFull rejections)",
            labelnames=("tier",))
        tq = reg.gauge(
            "tier_queue_depth",
            help="queued (unadmitted) requests per SLO tier",
            labelnames=("tier",))
        self._m_tier_ttft = {t: t_ttft.labels(tier=t) for t in SLOTier.ALL}
        self._m_tier_itl = {t: t_itl.labels(tier=t) for t in SLOTier.ALL}
        self._m_slo_met = {t: met.labels(tier=t) for t in SLOTier.ALL}
        self._m_slo_missed = {t: missed.labels(tier=t)
                              for t in SLOTier.ALL}
        self._m_goodput = {t: gp.labels(tier=t) for t in SLOTier.ALL}
        self._m_shed = {t: shed.labels(tier=t) for t in SLOTier.ALL}
        self._m_tier_queue = {t: tq.labels(tier=t) for t in SLOTier.ALL}
        self._m_rung = reg.gauge(
            "overload_rung",
            help="current degradation-ladder rung (0 = healthy; 1 no "
                 "speculation for the lowest tier, 2 shrunken prefill "
                 "share, 3 admission hold, 4 shed)")
        self._m_escal = reg.counter(
            "overload_escalations_total",
            help="ladder steps UP (toward shedding)")
        self._m_deesc = reg.counter(
            "overload_deescalations_total",
            help="ladder steps DOWN (recovery, gated by hysteresis)")
        self._seen_evictions = 0
        self._t_prev_step = None
        self._tput_ema = None

    def _note_cache(self):
        pc = self._pcache
        if pc is None:
            return
        if pc.evictions > self._seen_evictions:
            self._m_cache_evict.inc(pc.evictions - self._seen_evictions)
            self._seen_evictions = pc.evictions
        self._m_cache_blocks.set(pc.blocks_used)

    def _note_kv(self):
        self._m_kv_used.set(self._pager.used_blocks)
        self._m_kv_host.set(self._pager.host_blocks_used)
        self._m_parked.set(len(self._parked))

    def metrics(self) -> dict:
        """Snapshot of this engine's metrics registry."""
        return self._metrics.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of this engine's metrics (what
        `LLMServer`'s /metrics serves)."""
        return self._metrics.prometheus_text()

    @property
    def metrics_registry(self) -> MetricsRegistry:
        return self._metrics

    # -- programs ----------------------------------------------------------

    @property
    def num_graphs(self):
        """CUDA graphs captured (one per decode and verify width used;
        0 on the CPU): never more than `len(decode_widths) +
        len(verify_widths)`."""
        return sum(len(g) for g in (self._graphs, self._vgraphs)
                   if g is not None)

    @property
    def num_graph_replays(self):
        """Device steps (decode and verify) run as graph replays (0 on
        the CPU)."""
        return sum(g.replays for g in (self._graphs, self._vgraphs)
                   if g is not None)

    @property
    def num_verify_replays(self):
        """Verify steps run as graph replays (0 on the CPU)."""
        return 0 if self._vgraphs is None else self._vgraphs.replays

    @torch.no_grad()
    def prepare_programs(self):
        """The boot-time sweep: capture every decode and verify width
        (on the CPU, run each once eagerly), and run every prefill chunk
        width (or whole-prefill bucket) once, all against all-trash
        tables and pos 0, so every write lands in the trash block.
        Refuses to run with work in flight.  Returns {program: widths
        resolved}."""
        if self.has_work:
            raise RuntimeError("prepare_programs is a boot-time sweep; "
                               "the engine already has work in flight")
        trash = np.zeros(self._pager.max_blocks, np.int32)
        for w in self.decode_widths:
            if self._graphs is not None:
                self._graphs.capture(w)
            else:
                z = torch.zeros(w, dtype=torch.int32, device=self.device)
                self._decode_logits(z, z, torch.zeros(
                    (w, trash.size), dtype=torch.int32, device=self.device))
        resolved = {"decode": len(self.decode_widths)}
        for W in self.verify_widths:
            if self._vgraphs is not None:
                self._vgraphs.capture(W)
            else:
                B = self.max_slots
                z = torch.zeros(B, dtype=torch.int32, device=self.device)
                self._verify_logits(
                    torch.zeros((B, W), dtype=torch.int32,
                                device=self.device), z, z,
                    torch.zeros((B, trash.size), dtype=torch.int32,
                                device=self.device))
        if self.verify_widths:
            resolved["verify"] = len(self.verify_widths)
        if self.prefill_chunk is not None:
            for C in self.chunk_sizes:
                D.paged_prefill_chunk(
                    self.state, self.cfg,
                    self._upload(np.zeros((1, C), np.int32)), 0,
                    self._upload(trash), self._kvpool)
            resolved["chunk"] = len(self.chunk_sizes)
        else:
            for Sb in self.buckets:
                D.paged_prefill(
                    self.state, self.cfg,
                    self._upload(np.zeros((1, Sb), np.int32)),
                    self._upload(trash), self._kvpool)
            resolved["prefill"] = len(self.buckets)
        return resolved

    def _upload(self, a):
        """A host array as a device tensor.  On the card: a pinned copy
        sent without blocking, so an upload queues behind the step in
        flight instead of waiting for it (the pinned block is not
        reused before its copy ran)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

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
        self._overload_check(req.tier)
        _tr.point("engine/submit", trace_id=req.trace_id, rid=req.rid)
        self._queue.append(req)
        self._m_queue.set(len(self._queue))
        self._note_tier_queue()
        return req

    def _admission_check(self):
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._m_rejected.inc()
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue}); "
                f"request rejected (load shedding)")

    def _overload_check(self, tier):
        """Rung 4 at submit: the lowest tier is rejected with a typed
        `Overloaded` (shared with `LLMServer.submit`)."""
        tier = SLOTier.check(tier)
        if (self._overload is not None and self._overload.rung >= 4
                and tier == SLOTier.lowest()):
            self._m_shed[tier].inc()
            raise Overloaded(
                f"overload ladder at rung {self._overload.rung}: "
                f"shedding tier {tier!r} (retryable)")

    @property
    def overload_rung(self):
        """The ladder's current rung; 0 when disarmed or healthy."""
        return 0 if self._overload is None else self._overload.rung

    def tier_queue_depths(self) -> dict:
        """Queued (unadmitted) requests per SLO tier."""
        d = {t: 0 for t in SLOTier.ALL}
        for req in list(self._queue):
            d[req.tier] += 1
        return d

    def _note_tier_queue(self):
        for t, n in self.tier_queue_depths().items():
            self._m_tier_queue[t].set(n)

    def _check(self, req: Request):
        if req.prompt.size > self.max_prompt_len:
            raise ValueError(
                f"prompt length {req.prompt.size} exceeds max_prompt_len "
                f"{self.max_prompt_len}")
        if req.prompt.size + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {req.prompt.size} + max_new {req.max_new_tokens} "
                f"exceeds max_len {self.max_len}")

    def _bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    def _chunk_for(self, remaining):
        """Largest chunk width <= remaining (so only a prompt's tail
        chunk ever pads), else the smallest width, padded."""
        for c in reversed(self.chunk_sizes):
            if c <= remaining:
                return c
        return self.chunk_sizes[0]

    def _next_queued(self):
        """Pop the next live queued request, highest SLO tier first
        (FIFO within a tier).  Cancelled entries met on the way are
        dropped and expired ones shed with a DeadlineExceeded.  At
        overload rung >= 3 the lowest tier is HELD in the queue."""
        now = time.monotonic()
        hold_low = self.overload_rung >= 3
        top = SLOTier.rank(SLOTier.ALL[0])
        best, best_rank = None, -1
        for req in list(self._queue):
            if req.cancelled:
                self._queue.remove(req)
                self._m_cancelled.inc()
                req._finish_cancelled()
                continue
            if req.expired(now):
                self._queue.remove(req)
                self._m_expired.inc()
                req._finish_error(DeadlineExceeded(
                    f"request {req.rid} expired in queue before "
                    f"admission"))
                continue
            if hold_low and req.tier == SLOTier.lowest():
                continue
            rank = SLOTier.rank(req.tier)
            if rank > best_rank:
                best, best_rank = req, rank
                if rank == top:
                    break       # nothing outranks the top tier
        if best is not None:
            self._queue.remove(best)
        return best

    def _reap_cancelled(self, decoding=True):
        """Step-boundary cancellation and deadline expiry: evict dead
        in-flight requests, mid-prefill, parked and (with `decoding`)
        decoding.  Co-batched survivors never observe the eviction.
        Under overlap the decoding half waits while a step is in
        flight: its slots commit first and are reaped at that boundary
        (`_reap_decoding`).  A parked request holds no device block, so
        its reap only drops the host record: the one place memory
        pressure can surface as a failure, because the caller's own
        deadline ran out while the request waited its turn."""
        if decoding:
            self._reap_decoding()
        now = time.monotonic()
        for slot in [s for s, ps in self._prefill.items()
                     if ps.req.cancelled or ps.req.expired(now)]:
            ps = self._prefill.pop(slot)
            if self._pcache is not None and ps.nodes:
                self._pcache.release(ps.nodes)
            self._pager.release_slot(slot)
            self._finish_dead(ps.req, "mid-prefill")
        for pr in [p for p in self._parked
                   if p.req.cancelled or p.req.expired(now)]:
            self._unpark(pr)
            self._finish_dead(pr.req, f"while parked after "
                                      f"{len(pr.req.tokens)} tokens")

    def _reap_decoding(self):
        """The decoding-slot half of `_reap_cancelled`."""
        now = time.monotonic()
        for slot, req in enumerate(self._slots):
            if req is None or not (req.cancelled or req.expired(now)):
                continue
            self._free_slot(slot)
            self._m_evicted.inc()
            self._finish_dead(req, f"after {len(req.tokens)} tokens")

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
        """Evict a DECODING slot: release its trie pins and every block
        it holds (shared blocks survive in the trie), reset its table
        row to trash so the vectorised step's garbage writes stay
        harmless."""
        if self._pcache is not None and self._slot_nodes[slot]:
            self._pcache.release(self._slot_nodes[slot])
        self._slot_nodes[slot] = []
        self._pager.release_slot(slot)
        self._slots[slot] = None
        self._pos[slot] = 0
        self._token[slot] = 0
        self._greedy[slot] = True
        self._gens[slot] = None
        self._spec_idx[slot] = None         # drop the request's drafter

    def _free_slots(self):
        return [s for s in range(self.max_slots)
                if self._slots[s] is None and s not in self._prefill]

    def _alloc_blocks(self, k):
        """Pool allocation with the preempt ladder's first rung built
        in: on shortage, reclaim unpinned prefix-cache blocks before
        giving up.  The `kv.alloc` fault site makes a shortage testable:
        an injected fault is a FAILED allocation (a schedulable event),
        never an error."""
        try:
            _faults.fire("kv.alloc", need=k, free=self._pager.free_blocks)
        except _faults.InjectedFault:
            self._pager.alloc_failures += 1
            return None
        got = self._pager.alloc(k, count_failure=False)
        if got is None and self._reclaim_cache(k - self._pager.free_blocks):
            got = self._pager.alloc(k, count_failure=False)
        if got is None:
            # one shortage counts once, however many attempts it took
            self._pager.alloc_failures += 1
        return got

    def _reclaim_cache(self, k):
        """Rung 1 of the preempt ladder: drop up to `k` unpinned LRU
        prefix-cache blocks back to the pool.  Returns the number
        freed."""
        if self._pcache is None or k <= 0:
            return 0
        freed = self._pcache.reclaim(k)
        if freed:
            self._m_kv_reclaimed.inc(freed)
            self._note_cache()
        return freed

    def _admit(self):
        """Move queued requests into free slots, after every parked
        request has resumed (they are older, and new admissions must not
        starve their resume).  A prefix-cache match is pinned BEFORE the
        allocation (the reclaim rung must not evict a just-matched leaf
        whose block the same allocation could hand out again), then
        aliased into the slot's table; the rest of prompt + first decode
        row is allocated.  On a shortage the request goes back to the
        queue's front and admission pauses.  Chunked prefill then starts
        at the first uncached row; with `prefill_chunk=None` the whole
        prompt runs now (`_prefill_whole`)."""
        for slot in self._free_slots():
            # frozen parks (quarantine) never resume here, so they do
            # not hold the queue back either
            if self._parked and not self.freeze_parked:
                break
            req = self._next_queued()
            if req is None:
                break
            L = req.prompt.size
            matched, nodes, bids = 0, [], []
            if self._pcache is not None:
                matched, bids, nodes = self._pcache.match(req.prompt)
                self._pcache.acquire(nodes)
            need = self._pager.blocks_for(L + 1) - len(bids)
            got = self._alloc_blocks(need) if need > 0 else []
            if got is None:
                if self._pcache is not None:
                    self._pcache.release(nodes)
                    self._pcache.match_undo(matched)
                self._queue.appendleft(req)
                break
            if matched:
                self._pager.alias_prefix(slot, bids)
                self._m_cache_hit.inc()
                self._m_tokens_saved.inc(matched)
            elif self._pcache is not None:
                self._m_cache_miss.inc()
            self._pager.adopt(slot, got)
            _tr.point("req/admit", trace_id=req.trace_id, rid=req.rid,
                      slot=slot, cached_tokens=matched)
            self._slot_seq[slot] = next(self._admit_counter)
            # frontier row: the decode step's garbage write for this
            # mid-prefill slot lands where the next chunk overwrites
            self._pos[slot] = matched
            self._token[slot] = 0
            self._m_admitted.inc()
            self._m_prompt.inc(L)
            if self.prefill_chunk is None:
                self._prefill_whole(slot, req)
            else:
                self._prefill[slot] = _PrefillState(req, matched, nodes)
        self._m_queue.set(len(self._queue))
        self._note_tier_queue()

    # -- prefill -----------------------------------------------------------

    def _prefill_whole(self, slot, req):
        """The whole-bucket prefill (`prefill_chunk=None`): the prompt
        padded to its pow-2 bucket in one pass, then the first token."""
        L = req.prompt.size
        Sb = self._bucket_for(L)
        ids = np.zeros((1, Sb), np.int32)
        ids[0, :L] = req.prompt
        tc = _tr.t0()
        x, _ = D.paged_prefill(self.state, self.cfg, self._upload(ids),
                               self._upload(self._pager.table[slot]),
                               self._kvpool)
        tok = self._first_token(slot, req, x[:, L - 1])
        _tr.end("req/prefill", tc, trace_id=req.trace_id,
                args={"bucket": Sb})
        self._finish_prefill(slot, _PrefillState(req, L, []), tok)

    def _run_chunks(self, budget):
        """Spend the step's prefill token budget on chunks, oldest
        admission first.  The first chunk always runs regardless of the
        remaining budget (bounded overspend of one chunk), so prefill
        progresses under full decode load.  Overload rung 2 revokes
        that guarantee for the LOWEST tier and caps its chunks to a
        shrunken share of the budget.  A slot prefills `ps.ids` from
        its frontier `ps.off` (past any cache hit); a
        drop-and-recompute restore samples nothing at its final chunk."""
        rung = self.overload_rung
        low_budget = budget if rung < 2 else int(
            budget * self._overload.cfg.degraded_prefill_frac)
        chunks = 0
        for slot in list(self._prefill.keys()):
            ps = self._prefill[slot]
            req = ps.req
            degraded = rung >= 2 and req.tier == SLOTier.lowest()
            L = ps.ids.size
            while ps.off < L:
                C = self._chunk_for(L - ps.off)
                if degraded:
                    if C > low_budget:
                        break       # out of the degraded share: next slot
                elif chunks > 0 and C > budget:
                    return
                ids = np.zeros((1, C), np.int32)
                seg = ps.ids[ps.off:ps.off + C]
                ids[0, :seg.size] = seg
                final = ps.off + C >= L
                tc = _tr.t0()
                x, _ = D.paged_prefill_chunk(
                    self.state, self.cfg, self._upload(ids), ps.off,
                    self._upload(self._pager.table[slot]), self._kvpool)
                tok = None
                if final and ps.restore is None:
                    tok = self._first_token(slot, req, x[:, L - 1 - ps.off])
                _tr.end("req/prefill_chunk", tc, trace_id=req.trace_id,
                        args={"off": ps.off, "width": C})
                budget -= C
                if degraded:
                    low_budget -= C
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
        hidden state (1, D), seeding the request's own generator.  The
        read of the token waits for everything queued before it — under
        overlap, the decode step in flight (`first_token_waits_total`
        counts those)."""
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
        if self._inflight is not None:
            self._m_first_wait.inc()
        return int(tok[0])

    def _finish_prefill(self, slot, ps, tok):
        """The prompt's last row sampled the first token: publish the
        prompt's full blocks to the prefix cache (zero-copy: the trie
        aliases the slot's blocks), emit the token, and either move the
        slot to decoding (with speculation: a drafter over prompt +
        token at the full draft length) or release it.  A drop-and-recompute RESTORE
        samples nothing: it reinstates the parked token, depth and
        generator, so the stream continues as if never preempted."""
        req = ps.req
        self._prefill.pop(slot, None)
        if ps.restore is not None:
            self._install_parked(slot, ps.restore)
            self._slot_nodes[slot] = ps.nodes
            return
        L = req.prompt.size
        if self._pcache is not None:
            self._pcache.insert(req.prompt, L,
                                blocks=self._pager.slot_blocks[slot])
            self._note_cache()
        now = time.perf_counter()
        req._ttft = now - req._t_submit
        self._m_ttft.observe(req._ttft)
        self._m_tier_ttft[req.tier].observe(req._ttft)
        self._m_gen.inc()
        req._t_last = now
        _tr.point("req/first_token", trace_id=req.trace_id, rid=req.rid,
                  ttft_s=req._ttft)
        if not req._emit(tok):
            self._slots[slot] = req
            self._slot_nodes[slot] = ps.nodes
            self._token[slot] = tok
            self._pos[slot] = L
            self._temp[slot] = req.temperature
            self._topp[slot] = req.top_p
            self._greedy[slot] = req.greedy
            if self.spec is not None:
                idx = NGramIndex(req.prompt, self.spec.max_ngram,
                                 self.spec.min_ngram)
                idx.extend(tok)
                self._spec_idx[slot] = idx
                self._spec_k[slot] = self.spec.k
                self._spec_ema[slot] = 1.0
        else:
            # finished at prefill (max_new_tokens=1 or instant EOS)
            self._gens[slot] = None
            if self._pcache is not None and ps.nodes:
                self._pcache.release(ps.nodes)
            self._pager.release_slot(slot)
            self._m_completed.inc()
            self._slo_account(req)

    def _slo_account(self, req):
        """Goodput accounting, once per finished request: did it meet
        its tier's TTFT + mean-ITL targets?"""
        t = req.tier
        mean_itl = req._itl_sum / req._itl_n if req._itl_n else 0.0
        ttft = req._ttft if req._ttft is not None else float("inf")
        if self.slo_targets.met(t, ttft, mean_itl):
            self._m_slo_met[t].inc()
        else:
            self._m_slo_missed[t].inc()
        m = self._m_slo_met[t].value
        x = self._m_slo_missed[t].value
        self._m_goodput[t].set(m / (m + x))

    # -- preempt / park / resume -------------------------------------------

    @property
    def num_parked(self):
        """Preempted requests waiting to resume (swap or recompute)."""
        return len(self._parked)

    def _ensure_rows(self, slot, rows):
        """Grow the slot's table to cover rows [0, rows); False on a
        pool shortage (the caller climbs the ladder)."""
        need = (self._pager.blocks_for(rows)
                - len(self._pager.slot_blocks[slot]))
        if need <= 0:
            return True
        got = self._alloc_blocks(need)
        if got is None:
            return False
        self._pager.adopt(slot, got)
        return True

    def _ensure_decode_capacity(self, widths=None):
        """Before the decode / verify dispatch every decoding slot must
        own the blocks of the rows it may COMMIT: `widths[slot]` rows
        from its depth (1 + its draft length; default 1 — the rows of a
        verify's padded columns land in trash when unowned).  Slots are
        served highest SLO tier / highest priority / oldest admission
        first; a shortage climbs the preempt ladder (reclaim cache ->
        requeue the lowest-tier newest mid-prefill slot -> park the
        lowest-tier lowest-priority newest decoder), and when nothing
        else is left the needing slot parks ITSELF: pressure is
        absorbed, never turned into a failure.  Returns True when a
        slot is left to step."""
        order = sorted((s for s, r in enumerate(self._slots)
                        if r is not None),
                       key=lambda s: (-SLOTier.rank(self._slots[s].tier),
                                      -self._slots[s].priority,
                                      self._slot_seq[s]))
        for slot in order:
            if self._slots[slot] is None:    # parked by an earlier turn
                continue
            rows = min(int(self._pos[slot])
                       + (1 if widths is None else widths[slot]),
                       self.max_len)
            while not self._ensure_rows(slot, rows):
                if not self._preempt_one(protect=slot):
                    self._park_slot(slot)
                    break
        return self.num_active > 0

    def _preempt_victims(self, protect=None):
        """Decode-slot park order under pool pressure: lowest SLO tier,
        then lowest priority, then newest admission — batch parks
        before standard before interactive (`protect`, the slot the
        ladder makes room for, is never a victim)."""
        victims = [s for s, r in enumerate(self._slots)
                   if r is not None and s != protect]
        victims.sort(key=lambda s: (SLOTier.rank(self._slots[s].tier),
                                    self._slots[s].priority,
                                    -self._slot_seq[s]))
        return victims

    def _preempt_one(self, protect=None):
        """Free blocks by preempting ONE victim (beyond the cache
        reclaim `_alloc_blocks` already tried): requeue the lowest-tier
        lowest-priority newest mid-prefill slot if any (nothing emitted
        yet: the cheap rung), else park the first `_preempt_victims`
        slot.  Returns False when no victim is left."""
        if self._prefill:
            def key(s):
                req = self._prefill[s].req
                return (SLOTier.rank(req.tier), req.priority,
                        -self._slot_seq[s])
            slot = min(self._prefill, key=key)
            self._requeue_prefill(slot)
            return True
        victims = self._preempt_victims(protect)
        if not victims:
            return False
        self._park_slot(victims[0])
        return True

    def _requeue_prefill(self, slot):
        """A mid-prefill slot goes back to the front of the queue (a
        drop-and-recompute restore back to the parked list) and
        prefills again later, reusing what the prefix cache still
        holds."""
        ps = self._prefill.pop(slot)
        if self._pcache is not None and ps.nodes:
            self._pcache.release(ps.nodes)
        self._pager.release_slot(slot)
        self._pos[slot] = 0
        self._token[slot] = 0
        if ps.restore is not None:
            self._parked.append(ps.restore)
        else:
            self._queue.appendleft(ps.req)
            self._m_queue.set(len(self._queue))
        self._m_prefill_requeued.inc()

    def _park_slot(self, slot):
        """Park a decoding slot: swap its blocks to the pinned host tier
        or — for a shallow slot under "auto", a full host tier or an
        injected swap fault — drop them and recompute at resume.  The
        record keeps the last token, depth and generator, so the resumed
        stream is the unpreempted one.  No step is in flight here (the
        ladder runs after the commit), and the blocks are freed only
        after their gather was queued: every later write to them is
        queued behind it on the same stream."""
        req = self._slots[slot]
        pos = int(self._pos[slot])
        nb = len(self._pager.slot_blocks[slot])
        mode = self.preempt_policy
        if mode == "auto":
            mode = ("swap" if pos > 2 * self.kv_block_tokens
                    else "recompute")
        swapped = self._swap_out(slot, nb) if mode == "swap" else None
        host, event = swapped or (None, None)
        if swapped is None:
            mode = "recompute"
        pr = _ParkedRequest(req, mode, self._token[slot], pos,
                            self._gens[slot], self._spec_idx[slot],
                            self._spec_k[slot], self._spec_ema[slot],
                            host, event, nb if mode == "swap" else 0,
                            self._slot_seq[slot])
        self._parked.append(pr)
        _tr.point("req/park", trace_id=req.trace_id, rid=req.rid,
                  mode=mode, pos=pos)
        self._free_slot(slot)
        self._m_preempt.inc()
        self._note_kv()

    def _swap_out(self, slot, nb):
        """Gather the slot's `nb` blocks into one device buffer and
        start its copy into pinned host memory (non-blocking, a CUDA
        event after it; on the CPU the gather is the host copy).
        Returns (host, event), or None to fall back to recompute."""
        req = self._slots[slot]
        try:
            _faults.fire("kv.swap_out", slot=slot, rid=req.rid)
        except _faults.InjectedFault:
            return None
        if not self._pager.host_reserve(nb):
            return None
        ids = np.asarray(self._pager.slot_blocks[slot][:nb], np.int64)
        flat = D.gather_blocks(self._kvpool, self._upload(ids))
        event = None
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            flat = host
        self._m_swap_bytes.inc(nb * self._kv_block_bytes)
        return flat, event

    def _unpark(self, pr):
        """Drop a parked record (resume, cancel or expiry): return its
        host-tier reservation."""
        self._parked.remove(pr)
        if pr.mode == "swap":
            self._pager.host_release(pr.n_blocks)
        pr.host = pr.event = None

    def _try_resume(self):
        """Parked requests resume highest tier first, then oldest
        admission, before any new admission, as soon as a slot and
        blocks are free (never while `freeze_parked`).  A failed
        swap-in (an injected fault) leaves the request parked with its
        host copy intact."""
        if not self._parked or self.freeze_parked:
            return
        free = self._free_slots()
        for pr in sorted(self._parked,
                         key=lambda p: (-SLOTier.rank(p.req.tier),
                                        p.admit_seq)):
            if not free:
                break
            slot = free[0]
            ok = (self._resume_swap(slot, pr) if pr.mode == "swap"
                  else self._resume_recompute(slot, pr))
            if not ok:
                break    # pool still short: keep order, retry next step
            free.pop(0)
            self._m_resume.inc()
            self._m_park_time.observe(time.perf_counter() - pr.t_parked)
        self._note_kv()

    def _resume_swap(self, slot, pr):
        """Allocate the slot's blocks and scatter the host copy back in
        place.  Queued on the stream behind the copy to the host (and,
        under overlap, behind the step in flight), so nothing waits
        here; the resumed slot first decodes in the next dispatch."""
        need = max(pr.n_blocks, self._pager.blocks_for(pr.pos + 1))
        got = self._alloc_blocks(need)
        if got is None:
            return False
        try:
            _faults.fire("kv.swap_in", slot=slot, rid=pr.req.rid)
        except _faults.InjectedFault:
            for bid in got:
                self._pager.decref(bid)
            return False
        self._swap_total += 1
        if pr.event is None or pr.event.query():
            self._swap_ready += 1
        flat = pr.host if pr.event is None else \
            pr.host.to(self.device, non_blocking=True)
        ids = np.asarray(got[:pr.n_blocks], np.int64)
        D.scatter_blocks(self._kvpool, self._upload(ids), flat)
        self._pager.adopt(slot, got)
        self._unpark(pr)
        self._install_parked(slot, pr)
        if self._pcache is not None:
            # the swapped-in prompt rows are the prefill's own output:
            # cache them as a local prefill would
            self._pcache.insert(pr.req.prompt, pr.req.prompt.size,
                                blocks=self._pager.slot_blocks[slot])
            self._note_cache()
        return True

    def _install_parked(self, slot, pr):
        """Reinstate a parked request into `slot`: last token, depth,
        generator, drafter, sampling parameters and admission order."""
        req = pr.req
        _tr.point("req/resume", trace_id=req.trace_id, rid=req.rid,
                  mode=pr.mode, slot=slot)
        self._slots[slot] = req
        self._slot_seq[slot] = pr.admit_seq
        self._token[slot] = pr.token
        self._pos[slot] = pr.pos
        self._temp[slot] = req.temperature
        self._topp[slot] = req.top_p
        self._greedy[slot] = req.greedy
        self._gens[slot] = pr.gen
        self._spec_idx[slot] = pr.spec_idx
        self._spec_k[slot] = pr.spec_k
        self._spec_ema[slot] = pr.spec_ema

    def _resume_recompute(self, slot, pr):
        """Drop-and-recompute resume: re-prefill prompt + generated
        tokens[:-1] as a synthetic prompt (reusing what the prefix cache
        holds), then reinstate the parked token and generator instead of
        sampling.  Chunked engines re-enter the chunk scheduler; the
        whole-bucket path re-prefills inline, in a pow-2 bucket sized to
        the synthetic prompt (float pools only, as that path is)."""
        req = pr.req
        synth = np.concatenate(
            [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        matched, nodes, bids = 0, [], []
        if self._pcache is not None:
            matched, bids, nodes = self._pcache.match(synth)
            self._pcache.acquire(nodes)      # pin before allocating
        need = self._pager.blocks_for(pr.pos + 1) - len(bids)
        got = self._alloc_blocks(need) if need > 0 else []
        if got is None:
            if self._pcache is not None:
                self._pcache.release(nodes)
                self._pcache.match_undo(matched)
            return False
        if matched:
            self._pager.alias_prefix(slot, bids)
        self._pager.adopt(slot, got)
        self._unpark(pr)
        if self.prefill_chunk is None:
            Sb = 1 << max(int(synth.size) - 1, 0).bit_length()
            ids = np.zeros((1, Sb), np.int32)
            ids[0, :synth.size] = synth
            D.paged_prefill(self.state, self.cfg, self._upload(ids),
                            self._upload(self._pager.table[slot]),
                            self._kvpool)
            self._install_parked(slot, pr)
            return True
        self._prefill[slot] = _PrefillState(req, matched, nodes, ids=synth,
                                            restore=pr)
        self._slot_seq[slot] = pr.admit_seq
        self._pos[slot] = matched
        self._token[slot] = 0
        return True

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
        return bool(self._queue or self._prefill or self._parked
                    or self.num_active or self._inflight is not None)

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: reap cancellations and expiries,
        resume parked requests, admit queued requests into free slots,
        propose speculative drafts (charged against the token budget
        BEFORE prefill spends it), spend the token budget left after
        one decode token per active slot and the drafts on prefill
        chunks, make sure every decoding slot owns the blocks its rows
        land in (climbing the preempt ladder on a shortage), then one
        vectorised decode step over every slot — or, when any slot
        drafted, one batched verify step.  Returns True while there is
        (or was) work.

        With overlap on, the same phases run as a pipeline
        (`_step_overlap`): the decode step is dispatched without
        waiting for its tokens, which commit at the next call, after
        that call's reap / resume / admit / chunk host work already ran
        against the step in flight.  Streams are bitwise identical
        either way."""
        if self.overlap:
            return self._step_overlap()
        self.last_step_t = time.monotonic()   # the watchdog's heartbeat
        t = _tr.t0()
        self._reap_cancelled()
        self._overload_tick()
        self._try_resume()
        _tr.end("step/schedule", t)
        t = _tr.t0()
        self._admit()
        _tr.end("step/admit", t)
        drafts, cost = self._draft()
        if self._prefill:
            self._run_chunks(self.step_token_budget - self.num_active
                             - cost)
        return self._decode(lambda: self._commit_step(
            self._dispatch(drafts)), drafts)

    def _draft(self):
        """The drafts of this step when speculating with a slot decoding
        (`_propose_drafts`), else (None, 0)."""
        if self.spec is None or not self.num_active:
            return None, 0
        t = _tr.t0()
        drafts, cost = self._propose_drafts()
        _tr.end("step/draft", t, args={"tokens": cost})
        return drafts, cost

    def _decode(self, run, drafts=None):
        """The shared tail of both drivers: with a slot decoding and
        every decoding slot's blocks in hand (the ladder may park some;
        a drafting slot needs rows for 1 + its draft), `run` the
        dispatch; else disarm the idle clocks."""
        self._m_active.set(self.num_active)
        self._note_kv()
        widths = None if drafts is None else \
            [1 + len(d) if d else 1 for d in drafts]
        if self.num_active == 0 or \
                not self._ensure_decode_capacity(widths):
            self._t_prev_step = None        # idle gap: disarm the EMA clock
            self._t_retire = None           # ... and the host-gap anchor
            return self.has_work
        run()
        self._m_active.set(self.num_active)
        return True

    def _step_overlap(self) -> bool:
        """The overlap driver, the port of the JAX engine's
        `_step_overlap`.  Phase A: host work that touches no decoding
        slot (mid-prefill and parked reaps, resumes, admission, prefill
        chunks: all queued behind step N on the stream) while step N
        runs.  Phase B: the DEFERRED COMMIT of step N (wait for its
        tokens, emit, EOS / max_new, accepted drafts, slot frees), the
        decoding-slot reap, and a second resume / admission pass so
        freed slots turn around at once.  Phase C: draft proposals from
        the just-committed tokens (the chunks above were budgeted
        against active slots only: the drafts are unknown before the
        commit), the preempt ladder (parks run here, with no step in
        flight) and the dispatch of step N+1.  A slot's
        token depends only on its own token, depth, generator and KV,
        all fixed at dispatch, so deferring the read changes no stream;
        only WHEN host work runs differs.  The overload tick runs in
        phase A, before the deferred commit, as in the synchronous
        driver before admission: the rung it sets shapes this call's
        admissions (both passes), chunks and drafts."""
        self.last_step_t = time.monotonic()   # the watchdog's heartbeat
        t = _tr.t0()
        self._reap_cancelled(decoding=self._inflight is None)
        self._overload_tick()
        self._try_resume()
        _tr.end("step/schedule", t)
        t = _tr.t0()
        self._admit()
        _tr.end("step/admit", t)
        if self._prefill:
            self._run_chunks(self.step_token_budget - self.num_active)
        if self._inflight is not None:
            self._commit_inflight()
            self._reap_decoding()
            self._try_resume()
            self._admit()
        drafts, _ = self._draft()

        def dispatch():
            self._inflight = self._dispatch(drafts)
        return self._decode(dispatch, drafts)

    def _overload_tick(self):
        """One overload-controller tick from live engine signals, at
        every step boundary before admission (so a rung change shapes
        THIS step's admission, chunks and drafts).  Signals: the
        protected (non-lowest-tier) queue depth, the parked count,
        preemptions since the last tick, host-tier occupancy, and the
        server's windowed ITL p50 or else the decode ITL EMA.  The
        `engine.overload` fault site forces one escalation."""
        oc = self._overload
        if oc is None:
            return
        forced = False
        try:
            _faults.fire("engine.overload", rung=oc.rung)
        except _faults.InjectedFault:
            forced = True
        p = int(self._m_preempt.value)
        dp = p - self._op_last_preempt
        self._op_last_preempt = p
        low = SLOTier.lowest()
        protected = sum(1 for r in self._queue if r.tier != low)
        host = (self._pager.host_blocks_used / self.host_pool_blocks
                if self.host_pool_blocks else 0.0)
        prev = oc.rung
        rung = oc.update({
            "queue_depth": protected,
            "parked": len(self._parked),
            "preempt_rate": dp,
            "host_frac": host,
            "itl_ema": (self._itl_window_s
                        if self._itl_window_s is not None
                        else self._itl_ema) or 0.0,
        }, force_up=forced)
        if rung != prev:
            (self._m_escal if rung > prev else self._m_deesc).inc()
            self._m_rung.set(rung)
        if rung >= 4:
            self._shed_queued_lowest()

    def _shed_queued_lowest(self):
        """Rung 4's queue half: fail every queued lowest-tier request
        with a typed `Overloaded` (the submit half is
        `_overload_check`).  Admitted and parked requests are never
        shed."""
        low = SLOTier.lowest()
        doomed = [r for r in self._queue if r.tier == low]
        if not doomed:
            return
        self._queue = deque(r for r in self._queue if r.tier != low)
        for req in doomed:
            self._m_shed[low].inc()
            req._finish_error(Overloaded(
                f"request {req.rid} shed from queue at overload rung 4"))
        self._m_queue.set(len(self._queue))
        self._note_tier_queue()

    def _dispatch(self, drafts):
        return self._dispatch_decode() if drafts is None \
            else self._dispatch_verify(drafts)

    def _commit_step(self, inf):
        if inf.kind == "verify":
            self._commit_verify(inf)
        else:
            self._commit_decode(inf)

    def _commit_inflight(self):
        inf, self._inflight = self._inflight, None
        self._commit_step(inf)

    def flush(self):
        """Commit the decode step in flight, if any, and reap decoding
        slots at that boundary.  Idempotent; a no-op on the synchronous
        driver.  Callers that read request state between `step()` calls
        (drains, tests) use it to force the one-step-deferred commit."""
        if self._inflight is not None:
            self._commit_inflight()
            self._reap_decoding()
            self._m_active.set(self.num_active)

    def _observe_host_gap(self):
        """Close the host-gap window the previous step's commit opened:
        the host seconds the card waited between that step's tokens
        reaching the host and this dispatch."""
        if self._t_retire is None:
            return
        gap = time.perf_counter() - self._t_retire
        self._t_retire = None
        self._m_host_gap.observe(gap)
        self._m_host_gap_last.set(gap)

    def _dispatch_decode(self):
        """Dispatch one vectorised single-token decode step over every
        decoding slot, without waiting for its tokens.  Its inputs are
        copied at dispatch (phase-A work mutates the host mirrors while
        it runs).  On a CUDA model: the inputs cross in one
        non-blocking copy from pinned staging into the width's graph,
        the graph replays, sampled rows draw from its logits, and the
        tokens return by a non-blocking copy into pinned memory followed
        by an event.  On the CPU: the eager step."""
        active = self.num_active
        self._observe_host_gap()
        t = _tr.t0()
        B = self.max_slots
        rows = None
        live = [s for s in range(B) if self._slots[s] is not None]
        w = next(x for x in self.decode_widths if x >= len(live))
        if w < B:
            # compact the live slots into the width-w step; pad rows
            # clone a live slot (same per-row compute, dropped at commit)
            rows = live + [live[0]] * (w - len(live))
        sel = np.arange(B) if rows is None else np.asarray(rows)
        # per batch row: a draw only for the first row of a live,
        # sampled slot (a pad row must not advance its generator)
        drawn = set()
        gens, greedy = [], []
        for s in sel.tolist():
            draws = (self._slots[s] is not None and s not in drawn
                     and not self._greedy[s])
            drawn.add(s)
            gens.append(self._gens[s] if draws else None)
            greedy.append(not draws)
        temp, topp = self._temp[sel], self._topp[sel]
        if self._graphs is None:
            logits = self._decode_logits(
                self._upload(self._token[sel]), self._upload(self._pos[sel]),
                self._upload(self._pager.table[sel]))
            tokens, event = sample_logits_per_slot(
                logits, gens, temp, topp, greedy), None
        else:
            g = self._graphs
            stage, back = self._staging[self._n_dispatched % 2]
            self._n_dispatched += 1
            n = g.flat_len(w)
            tok_v, pos_v, tab_v = g.views(stage.numpy()[:n], w)
            tok_v[:] = self._token[sel]
            pos_v[:] = self._pos[sel]
            tab_v[:] = self._pager.table[sel]
            g.inputs(w).copy_(stage[:n], non_blocking=True)
            logits, argmax = g.replay(w)
            nxt = argmax
            if not all(greedy):
                # drawn here, before the next replay overwrites logits
                nxt = sample_rows(logits, argmax.clone(), gens, temp,
                                  topp, greedy)
            tokens = back[:w]
            tokens.copy_(nxt, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        _tr.end("step/dispatch", t, args={"slots": active, "width": w})
        return _InflightStep(tokens, event, list(self._slots), active, rows)

    def _commit_decode(self, inf):
        """Per-slot token emission, EOS / max_new resolution and slot
        frees for a dispatched decode step: at once on the synchronous
        driver, one `step()` later under overlap (against the
        dispatch-time slot snapshot)."""
        t = _tr.t0()
        if inf.event is not None:
            inf.event.synchronize()
        nxt = inf.tokens.cpu().numpy()      # host sync: EOS + streaming
        _tr.end("step/sample_readback", t)
        now = time.perf_counter()
        self._t_retire = now                # host-gap anchor
        self._m_steps.inc()
        self._m_gen.inc(inf.active)
        self._m_step_tokens.observe(inf.active)
        self._tput_tick(now, inf.active)
        row_of = None
        if inf.rows is not None:
            row_of = {}
            for i, s in enumerate(inf.rows):
                row_of.setdefault(s, i)     # pad rows duplicate a row
        for slot, req in enumerate(inf.reqs):
            if req is None:
                continue
            tok = int(nxt[slot if row_of is None else row_of[slot]])
            self._pos[slot] += 1
            self._token[slot] = tok
            if self._spec_idx[slot] is not None:
                self._spec_idx[slot].extend(tok)
            if req._t_last is not None:
                d = now - req._t_last
                self._m_itl.observe(d)
                self._m_tier_itl[req.tier].observe(d)
                req._itl_sum += d
                req._itl_n += 1
                self._itl_ema = d if self._itl_ema is None else \
                    0.9 * self._itl_ema + 0.1 * d
            req._t_last = now
            if req._emit(tok):
                self._free_slot(slot)       # freed for the next admit
                self._m_completed.inc()
                self._m_evicted.inc()
                self._slo_account(req)

    # -- speculative decoding ----------------------------------------------

    def _propose_drafts(self):
        """Host-side n-gram proposals for every decoding slot: up to its
        adaptive draft length, never past `max_new_tokens` (the +1
        verify emission must fit) nor the widest verify.  Returns
        (per-slot draft lists, total draft tokens), or (None, 0) when no
        slot drafted."""
        drafts = [None] * self.max_slots
        cost = 0
        wmax = self.verify_widths[-1]
        skip_low = self.overload_rung >= 1
        for slot, req in enumerate(self._slots):
            idx = self._spec_idx[slot]
            if req is None or idx is None:
                continue
            if skip_low and req.tier == SLOTier.lowest():
                continue    # rung 1: no speculation for the lowest tier
            remaining = req.max_new_tokens - len(req.tokens)
            kb = min(self._spec_k[slot], remaining - 1, wmax - 1)
            if kb <= 0:
                continue
            d = idx.propose(kb)
            if d:
                drafts[slot] = d
                cost += len(d)
        return (drafts, cost) if cost else (None, 0)

    def _width_for(self, n):
        for w in self.verify_widths:
            if n <= w:
                return w
        return self.verify_widths[-1]

    def _dispatch_verify(self, drafts):
        """Dispatch one batched verify step over every slot at the
        engine's full width: column 0 each slot's token, columns 1.. its
        draft (a slot the ladder parked after drafting keeps its draft
        in the width and writes trash rows; it is skipped at commit).
        On a CUDA model the inputs cross in one non-blocking copy into
        the width's verify graph, the graph replays (greedy acceptance
        inside), sampled rows draw after it from its logits, and the
        packed result returns by a non-blocking copy into pinned memory
        followed by an event.  On the CPU: the eager step."""
        active = self.num_active
        self._observe_host_gap()
        t = _tr.t0()
        B = self.max_slots
        W = self._width_for(max(len(d) for d in drafts if d) + 1)
        valid = np.ones(B, np.int32)
        for slot, d in enumerate(drafts):
            if d:
                valid[slot] = 1 + min(len(d), W - 1)
        gens = [self._gens[s] if self._slots[s] is not None
                and not self._greedy[s] else None for s in range(B)]
        greedy = [g is None for g in gens]
        g = self._vgraphs
        if g is None:
            flat = (np.zeros((B, W), np.int32), self._pos.copy(), valid,
                    self._pager.table.copy())
        else:
            stage, back = self._staging[self._n_dispatched % 2]
            self._n_dispatched += 1
            n = g.flat_len(W)
            flat = g.views(stage.numpy()[:n], W)
            flat[0][:] = 0
            flat[1][:] = self._pos
            flat[2][:] = valid
            flat[3][:] = self._pager.table
        tokens = flat[0]
        tokens[:, 0] = self._token
        for slot, d in enumerate(drafts):
            if d:
                tokens[slot, 1:valid[slot]] = d[:valid[slot] - 1]
        if g is None:
            dev = [self._upload(a) for a in flat]
            logits, packed = self._verify_logits(*dev)
        else:
            g.inputs(W).copy_(stage[:n], non_blocking=True)
            logits, packed = g.replay(W)
            dev = g.views(g.inputs(W), W)
        states = {}
        if not all(greedy):
            # drawn here, before the next replay overwrites the logits
            packed = packed.clone()
            out, acc = unpack_verify(packed, B, W)
            states = accept_rows(logits, dev[0], valid, out, acc, gens,
                                 self._upload(self._temp.copy()),
                                 self._upload(self._topp.copy()), greedy)
        event = None
        if g is not None:
            host = back[:packed.numel()]
            host.copy_(packed, non_blocking=True)
            packed = host
            event = torch.cuda.Event()
            event.record()
        _tr.end("step/dispatch", t, args={"slots": active, "width": W,
                                          "verify": True})
        return _InflightStep(packed, event, list(self._slots), active,
                             kind="verify", width=W, valid=valid,
                             gens=gens, states=states)

    def _commit_verify(self, inf):
        """Commit a dispatched verify step: each slot emits its accepted
        drafts and the corrected / bonus token, in order — EOS or
        `max_new_tokens` inside the run truncates it (the rest is
        dropped) — and its depth advances by what it emitted, so the
        rows of rejected drafts stay dead in place.  A sampled slot's
        generator is settled to its state after the emitted tokens'
        draws.  ITL is observed once a token, at the step's time over
        the tokens emitted."""
        t = _tr.t0()
        if inf.event is not None:
            inf.event.synchronize()
        out, acc = unpack_verify(inf.tokens.cpu().numpy(), self.max_slots,
                                 inf.width)
        _tr.end("step/sample_readback", t)
        now = time.perf_counter()
        self._t_retire = now                # host-gap anchor
        self._m_steps.inc()
        self._m_spec_steps.inc()
        step_tokens, emitted_of = 0, {}
        for slot, req in enumerate(inf.reqs):
            if req is None:
                continue
            kb = int(inf.valid[slot]) - 1
            m = min(int(acc[slot]), kb)
            if kb > 0:
                self._m_spec_proposed.inc(kb)
                self._m_spec_accepted.inc(m)
                self._m_spec_rolled.inc(kb - m)
                self._m_accept_rate.observe(m / kb)
                self._adapt_k(slot, m / kb)
            idx = self._spec_idx[slot]
            emitted, done = 0, False
            for j in range(m + 1):
                tok = int(out[slot, j])
                emitted += 1
                if idx is not None:
                    idx.extend(tok)
                if req._emit(tok):
                    done = True
                    break
            emitted_of[slot] = emitted
            step_tokens += emitted
            self._m_gen.inc(emitted)
            if req._t_last is not None:
                per = (now - req._t_last) / emitted
                for _ in range(emitted):
                    self._m_itl.observe(per)
                    self._m_tier_itl[req.tier].observe(per)
                req._itl_sum += now - req._t_last
                req._itl_n += emitted
                self._itl_ema = per if self._itl_ema is None else \
                    0.9 * self._itl_ema + 0.1 * per
            req._t_last = now
            if done:
                self._free_slot(slot)       # freed for the next admit
                self._m_completed.inc()
                self._m_evicted.inc()
                self._slo_account(req)
            else:
                # rows pos .. pos + m hold the committed tokens' KV;
                # out[m] is the new token, written at pos + m + 1 by the
                # next step before it becomes visible
                self._pos[slot] += emitted
                self._token[slot] = int(out[slot, m])
        settle_generators(inf.gens, {s: st for s, st in inf.states.items()
                                     if s in emitted_of}, emitted_of)
        self._m_step_tokens.observe(step_tokens)
        self._tput_tick(now, step_tokens)

    def _adapt_k(self, slot, rate):
        """Acceptance-EMA draft-length control: halve on sustained
        rejection (floor 1), double back toward the configured k on
        recovery."""
        sp = self.spec
        ema = sp.ema_alpha * rate + (1 - sp.ema_alpha) * \
            self._spec_ema[slot]
        self._spec_ema[slot] = ema
        if not sp.adaptive:
            return
        k = self._spec_k[slot]
        if ema < sp.backoff and k > 1:
            self._spec_k[slot] = max(1, k // 2)
        elif ema >= sp.recover and k < sp.k:
            self._spec_k[slot] = min(sp.k, k * 2)

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
        """Drive until the queue and every slot drain (the step in
        flight included); returns the number of scheduler steps
        taken."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    def generate(self, prompts, max_new_tokens=16, **kw):
        """Submit every prompt, run to completion, and return the
        per-prompt generated token lists."""
        reqs = [self.submit(p, max_new_tokens, **kw) for p in prompts]
        self.run()
        return [r.tokens for r in reqs]

    def kv_pool_bytes(self):
        """Total bytes of the paged KV pool (all layers, K+V, int8
        scale tensors included)."""
        return sum(x.numel() * x.element_size()
                   for entry in self._kvpool for part in entry
                   for x in (part if isinstance(part, tuple) else (part,)))
