"""Model-free n-gram drafting for speculative decoding — a copy of
`paddle_tpu/inference/ngram_draft.py` (host-only Python, copied so the
port imports nothing of the JAX package).

Prompt-lookup decoding: the drafter is the request's own token history,
no draft model, no extra weights.  Decode is memory-bound — every
accepted token normally costs one full pass over the parameters plus
the KV pool.  On self-similar text (code, extraction over the prompt,
RAG answers quoting their context) the next tokens often already
appear verbatim earlier in prompt + generated; a suffix lookup guesses
them on the host, and one batched verify pass
(`llama_decode.paged_verify_step`) either confirms K of them for the
price of one step or falls back to normal decode with nothing lost
(the acceptance rule in `generation.speculative_accept` is lossless).

`NGramIndex` is the per-slot rolling suffix index: for every n in
[min_n, max_n] it maps the n-gram ending at each position to that
position (keeping the most recent EARLIER occurrence so matching the
context's own tail never proposes past the end).  `propose(k)` tries
the longest n first and returns the continuation that followed the
previous occurrence.  Update and lookup are O(max_n) dict ops per
token: host-side noise next to a device step.

`SpecConfig` carries the engine-facing knobs, including the adaptive-K
backoff: a per-slot acceptance EMA drives the draft length down on
non-repetitive streams, so a request that never accepts stops paying
verify-width compute, and back up when acceptance recovers.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SpecConfig", "NGramIndex"]


@dataclass
class SpecConfig:
    """Knobs for `LLMEngine(speculation=SpecConfig(...))`.

    k            — max draft tokens proposed per slot per step (the
                   verify program scores k+1 positions; widths are
                   pow-2 bucketed, so the engine captures one verify
                   graph per width in {2, 4, ..., next_pow2(k+1)}).
    max_ngram /  — suffix lengths tried by the proposer, longest
    min_ngram      first.
    adaptive     — per-slot draft-length backoff on the acceptance EMA:
                   below `backoff` the slot's k halves (floor 1), at or
                   above `recover` it doubles back toward `k`.
    ema_alpha    — EMA weight of the newest verify's acceptance rate.
    """

    k: int = 3
    max_ngram: int = 3
    min_ngram: int = 1
    adaptive: bool = True
    ema_alpha: float = 0.4
    backoff: float = 0.2
    recover: float = 0.5

    def validate(self):
        if self.k < 1:
            raise ValueError("SpecConfig.k must be >= 1")
        if not (1 <= self.min_ngram <= self.max_ngram):
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ValueError("ema_alpha must be in (0, 1]")
        if not (0.0 <= self.backoff <= self.recover <= 1.0):
            raise ValueError("need 0 <= backoff <= recover <= 1")
        return self


class NGramIndex:
    """Rolling suffix index over one request's prompt + generated
    tokens.

    For each n-gram length it keeps the END index (exclusive) of the
    most recent occurrence AND of the most recent occurrence before
    that: the context's own tail is always the most recent match of
    itself, so proposing needs the previous one.  `extend()` appends
    one token (the engine calls it for every emitted token); `propose`
    returns up to k tokens that followed the best earlier match, or []
    when no suffix of length >= min_n recurs."""

    __slots__ = ("_ctx", "_min_n", "_max_n", "_last", "_prev")

    def __init__(self, tokens, max_n=3, min_n=1):
        if not (1 <= min_n <= max_n):
            raise ValueError("need 1 <= min_n <= max_n")
        self._ctx: list[int] = []
        self._min_n = min_n
        self._max_n = max_n
        self._last: list[dict] = [dict() for _ in range(max_n + 1)]
        self._prev: list[dict] = [dict() for _ in range(max_n + 1)]
        for t in tokens:
            self.extend(int(t))

    def __len__(self):
        return len(self._ctx)

    def extend(self, token: int):
        """Append one token and register every n-gram ending at it."""
        ctx = self._ctx
        ctx.append(int(token))
        end = len(ctx)
        for n in range(self._min_n, self._max_n + 1):
            if end < n:
                break
            gram = tuple(ctx[end - n:end])
            last = self._last[n]
            old = last.get(gram)
            if old is not None:
                self._prev[n][gram] = old
            last[gram] = end

    def propose(self, k: int) -> list[int]:
        """k continuation tokens after the best earlier occurrence of
        the context's tail (longest n-gram first), [] when no suffix of
        length >= min_n recurs.  A match close to the end (overlapping
        the tail — the signature of short-period repetition) is
        extended periodically: copying from the match IS the
        prediction, so once the copy window runs past the end it keeps
        copying from its own output (period = end - match)."""
        ctx = self._ctx
        end = len(ctx)
        if k <= 0 or end < self._min_n:
            return []
        for n in range(min(self._max_n, end), self._min_n - 1, -1):
            gram = tuple(ctx[end - n:end])
            cand = self._last[n].get(gram)
            if cand == end:                    # the tail matched itself
                cand = self._prev[n].get(gram)
            if cand is not None and cand < end:
                period = end - cand
                out = []
                for i in range(k):
                    j = cand + i
                    out.append(ctx[j] if j < end else out[i - period])
                return out
        return []
