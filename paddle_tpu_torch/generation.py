"""Per-slot token selection for the continuous-batching engine — the
port of `top_p_mask`, `sample_logits_per_slot` and `speculative_accept`
from `paddle_tpu/generation.py`.

Greedy rows take the argmax of the raw logits.  Sampled rows draw from
their own `torch.Generator` (one per request, seeded from
`Request.seed`), so a request's tokens depend only on its own seed and
step count, never on which neighbours share the batch.  The draws do
not reproduce JAX's threefry streams; only the port's own contract is
pinned by its tests.  `sample_rows` is the second half alone: the
engine's decode graphs compute the greedy argmax on the card and the
sampled rows are drawn after the replay.

`speculative_accept` is split the same way: `greedy_accept` (argmax,
then the longest argmax-matching draft prefix) runs inside the verify
graphs with no host read, and `accept_rows` draws the sampled rows
after the replay.  A sampled row draws ONE token per verify column from
its generator, in column order — the draw a plain decode step would
make at that depth — and accepts draft d_j iff the draw x_j equals it:
P(accept) = p_j(d_j), and on a rejection x_j is distributed as p_j with
d_j masked out, the JAX rule's residual resample.  `accept_rows`
returns the generator's state after each draw and `settle_generators`
rewinds each generator to the state after its emitted tokens once the
accept length is on the host, so a request's generator advances one
draw per token: its sampled stream is the one it has without
speculation.
"""

from __future__ import annotations

import torch

__all__ = ["top_p_mask", "sample_logits_per_slot", "sample_rows",
           "speculative_accept", "greedy_accept", "accept_rows",
           "settle_generators"]

_NEG = -1e30


def top_p_mask(logits, p):
    """Nucleus mask (sort-based): keep the smallest prefix of the
    descending-sorted distribution whose cumulative probability reaches
    p (the top token always survives).  `p` is a scalar or a (B,)
    per-row tensor; rows with p >= 1 pass through unmasked."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p = torch.as_tensor(p, dtype=torch.float32, device=logits.device)
    if p.dim():
        p = p[..., None]                  # per-row threshold over vocab
    # a sorted position is kept while the mass BEFORE it is < p
    keep_sorted = (cum - probs) < p
    kth = torch.clamp_min(keep_sorted.sum(dim=-1, keepdim=True), 1)
    cutoff = torch.gather(sorted_logits, -1, kth - 1)
    return torch.where(logits < cutoff, _NEG, logits)


def sample_logits_per_slot(logits, generators, temperature, top_p, greedy):
    """One token per row: logits (B, V); generators a length-B list of
    `torch.Generator`s on the logits' device (None for a greedy or idle
    row); temperature / top_p (B,) float; greedy (B,) bool.  Returns
    (B,) int64.  The all-greedy batch — the common serving case — pays
    a single argmax, no vocab sort."""
    lg = logits.to(torch.float32)
    return sample_rows(lg, torch.argmax(lg, dim=-1), generators,
                       temperature, top_p, greedy)


def sample_rows(logits, out, generators, temperature, top_p, greedy):
    """Draw the sampled rows of `out` in place and return it: `out`
    (B,) int64 holds the greedy argmax of `logits` (B, V) — computed
    here by `sample_logits_per_slot`, inside the decode graph by the
    engine — and each row that is not greedy and has a generator takes
    one draw from its own generator.  The host branches on `greedy`
    and `generators`, never on a device value."""
    lg = logits.to(torch.float32)
    greedy = torch.as_tensor(greedy, dtype=torch.bool)
    rows = [i for i in range(lg.shape[0])
            if not bool(greedy[i]) and generators[i] is not None]
    if not rows:
        return out
    sel = torch.as_tensor(rows, device=lg.device)
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=lg.device)[sel]
    warped = lg[sel] / torch.clamp_min(temp, 1e-6)[:, None]
    warped = top_p_mask(warped, torch.as_tensor(
        top_p, dtype=torch.float32, device=lg.device)[sel])
    probs = torch.softmax(warped, dim=-1)
    for j, i in enumerate(rows):
        out[i] = torch.multinomial(probs[j], 1,
                                   generator=generators[i])[0]
    return out


def greedy_accept(logits, tokens, valid_len):
    """The greedy half of `speculative_accept`, with no host read (the
    verify graphs record it): logits (B, W, V) at W consecutive
    positions; tokens (B, W), column 0 each slot's committed token and
    columns 1.. its draft; valid_len (B,) 1 + the slot's true draft
    length.  Returns (argmax (B, W) int64, accept_len (B,) int64): a
    greedy slot emits argmax[b, :accept_len[b] + 1] — its accepted
    drafts (equal to the argmax there), then the argmax at the first
    mismatch or the bonus token."""
    am = torch.argmax(logits.to(torch.float32), dim=-1)
    W = tokens.shape[1]
    ok = torch.as_tensor(tokens, device=am.device)[:, 1:].long() \
        == am[:, :-1]
    j = torch.arange(W - 1, device=am.device)
    valid_len = torch.as_tensor(valid_len, device=am.device)
    ok = ok & (j[None, :] < (valid_len.long() - 1)[:, None])
    # the longest accepted prefix: cumprod keeps 1 until the first miss
    return am, torch.cumprod(ok.long(), dim=1).sum(dim=1)


def accept_rows(logits, tokens, valid_len, out, acc, generators,
                temperature, top_p, greedy):
    """Decide the sampled rows of a verify step in place and return the
    generator states to settle: `out` (B, W) / `acc` (B,) int64 hold
    `greedy_accept`'s result; each row that is not greedy and has a
    generator draws x_j ~ p_j (temperature + top-p warped, one
    multinomial per column j <= its draft length, in order) and accepts
    the longest prefix of drafts equal to their draws.  `valid_len` is
    read on the host (a sequence or a CPU tensor); `tokens`,
    `temperature` and `top_p` are best on the logits' device (host
    values are copied there).  Returns {row: [generator state after
    each of its draws]}."""
    lg = logits.to(torch.float32)
    greedy = torch.as_tensor(greedy, dtype=torch.bool)
    valid = [int(v) for v in torch.as_tensor(valid_len).tolist()]
    rows = [i for i, g in enumerate(generators)
            if g is not None and not bool(greedy[i])]
    if not rows:
        return {}
    # the warp's operands as sample_rows has them (a device tensor, not
    # a Python scalar, divides: the same rounding as a decode step)
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=lg.device)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=lg.device)
    states = {}
    for i in rows:
        g, kb = generators[i], valid[i] - 1
        warped = lg[i, :kb + 1] / torch.clamp_min(
            temperature[i:i + 1], 1e-6)[:, None]
        warped = top_p_mask(warped, top_p[i:i + 1].expand(kb + 1))
        probs = torch.softmax(warped, dim=-1)
        draws, states[i] = [], []
        for j in range(kb + 1):
            draws.append(torch.multinomial(probs[j], 1, generator=g))
            states[i].append(g.get_state())
        x = torch.cat(draws)
        ok = x[:kb] == tokens[i, 1:kb + 1].long()
        out[i, :kb + 1] = x
        acc[i] = torch.cumprod(ok.long(), dim=0).sum()
    return states


def settle_generators(generators, states, emitted):
    """Rewind each drawn row's generator to its state after its
    `emitted[row]` tokens' draws (accepted drafts + the final token),
    so the draws past them are not consumed."""
    for i, sts in states.items():
        generators[i].set_state(sts[int(emitted[i]) - 1])


def speculative_accept(logits, tokens, valid_len, generators, temperature,
                       top_p, greedy):
    """Lossless accept / correct for speculative decoding, per slot:
    logits (B, W, V); tokens (B, W) (column 0 the committed token,
    columns 1.. the draft); valid_len (B,) 1 + the true draft length;
    generators a length-B list (None for greedy or idle rows);
    temperature / top_p (B,) float; greedy (B,) bool.  Greedy rows
    accept the longest argmax-matching draft prefix and emit the argmax
    at the first mismatch (or the bonus argmax); sampled rows run
    `accept_rows`.  Returns (out (B, W) int64, accept_len (B,) int64):
    slot b emits out[b, :accept_len[b] + 1]; each generator is left
    after the draws of its emitted tokens (this reads the accept
    lengths on the host)."""
    out, acc = greedy_accept(logits, tokens, valid_len)
    states = accept_rows(logits, tokens, valid_len, out, acc, generators,
                         temperature, top_p, greedy)
    if states:
        settle_generators(generators, states, (acc + 1).tolist())
    return out, acc
