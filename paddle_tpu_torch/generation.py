"""Generation strategies and per-slot token selection — the port of
`paddle_tpu/generation.py`.

`generate(model, input_ids, ...)` is the model-agnostic entry point:
greedy, sampling or beam search over a `DecodeAdapter` (`prefill` then
one `step` a token).  `LlamaAdapter` runs the static KV-cache programs
of `models/llama_decode.py`; `PureForwardAdapter` serves any
`nn.Module` whose forward maps (B, S) ids to logits by re-running the
forward over a padded id buffer.  JAX runs each strategy as one jitted
`lax.scan`; here it is a Python loop (the step is a Python int, so no
step reads the device on the host).  Beam search flattens the beams
into the batch, reorders the cache by parent with `index_select` each
step, and backtraces the parents at the end.  Sampling draws from one
`torch.Generator` seeded with `seed` (JAX: a threefry key), so sampled
tokens are the port's own; greedy and beam search are deterministic
and held to the JAX package.

The engine's per-slot selection is the port of `top_p_mask`,
`sample_logits_per_slot` and `speculative_accept`.

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

__all__ = ["top_k_mask", "top_p_mask", "sample_logits",
           "sample_logits_per_slot", "sample_rows",
           "speculative_accept", "greedy_accept", "accept_rows",
           "settle_generators", "DecodeAdapter", "LlamaAdapter",
           "PureForwardAdapter", "generate"]

_NEG = -1e30


def top_k_mask(logits, k):
    """Keep the k largest logits per row, mask the rest to -1e30."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG, logits)


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


def sample_logits(logits, generator, temperature=1.0, top_k=0, top_p=1.0):
    """One categorical draw per row of logits (B, V) after temperature /
    top-k / top-p, from `generator` (a `torch.Generator` on the logits'
    device; JAX takes a key).  Returns (B,) int64."""
    logits = logits.to(torch.float32)
    if temperature != 1.0:
        logits = logits / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        logits = top_k_mask(logits, int(top_k))
    if top_p is not None and top_p < 1.0:
        logits = top_p_mask(logits, float(top_p))
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


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


# -- adapters ------------------------------------------------------------


class DecodeAdapter:
    """A decode program over explicit params and cache:
    `init_cache(batch, max_len)`, `prefill(params, ids, cache)` ->
    (last logits (B, V), cache), `step(params, token, pos, cache)` ->
    (logits (B, V), cache) with `pos` a Python int; `device` is where
    the ids live."""

    device = None

    def params(self):
        raise NotImplementedError

    def init_cache(self, batch, max_len):
        raise NotImplementedError

    def prefill(self, params, ids, cache):
        raise NotImplementedError

    def step(self, params, token, pos, cache):
        raise NotImplementedError


class LlamaAdapter(DecodeAdapter):
    """The Llama family's static KV-cache programs
    (`models/llama_decode.py`: a preallocated cache, one-token steps)."""

    def __init__(self, model):
        from .models import llama_decode as D
        self._D = D
        self.model = model
        self.cfg = model.config
        self.device = model.device

    def params(self):
        return self._D.collect_decode_state(self.model)

    def init_cache(self, batch, max_len):
        dtype = self.model.llama.embed_tokens.weight.dtype
        return self._D.init_cache(self.cfg, batch, max_len, dtype,
                                  device=self.device)

    def prefill(self, params, ids, cache):
        return self._D.prefill(params, self.cfg, ids, cache)

    def step(self, params, token, pos, cache):
        return self._D.decode_step(params, self.cfg, token, pos, cache)


class PureForwardAdapter(DecodeAdapter):
    """Any causal-LM `nn.Module` whose forward maps (B, S) ids to logits
    (or to a tuple that starts with them): the running ids sit in a
    padded (B, max_len) buffer — the "cache" — and every step re-runs
    the full forward, reading the logits at the current position.  The
    forward runs in eval mode under `no_grad`, and the module's mode is
    restored afterwards."""

    def __init__(self, model, pad_id=0):
        self.model = model
        self.pad_id = pad_id
        p = next(model.parameters(), None)
        self.device = p.device if p is not None else torch.device("cpu")

    def params(self):
        return None            # the module holds its parameters

    def init_cache(self, batch, max_len):
        return torch.full((batch, max_len), self.pad_id, dtype=torch.int64,
                          device=self.device)

    def prefill(self, params, ids, cache):
        cache[:, :ids.shape[1]] = ids
        return self._logits(cache)[:, ids.shape[1] - 1, :], cache

    def step(self, params, token, pos, cache):
        cache[:, pos] = token
        return self._logits(cache)[:, pos, :], cache

    def _logits(self, buf):
        was = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                out = self.model(buf)
        finally:
            self.model.train(was)
        return out[0] if isinstance(out, (tuple, list)) else out


def _adapter_for(model):
    """One adapter per model instance, kept on the model."""
    ad = model.__dict__.get("_decode_adapter")
    if ad is None:
        if hasattr(model, "llama") and hasattr(model, "config"):
            ad = LlamaAdapter(model)
        else:
            ad = PureForwardAdapter(model)
        model.__dict__["_decode_adapter"] = ad
    return ad


# -- strategies ----------------------------------------------------------


def _greedy_or_sample(adapter, params, ids, max_new, generator, temperature,
                      top_k, top_p, greedy, eos_id):
    B, S = ids.shape
    cache = adapter.init_cache(B, S + max_new)
    logits, cache = adapter.prefill(params, ids, cache)

    def pick(lg):
        if greedy:
            return torch.argmax(lg, dim=-1)
        return sample_logits(lg, generator, temperature, top_k, top_p)

    token = pick(logits)
    done = (token == eos_id) if eos_id is not None else None
    toks = [token]
    for i in range(max_new - 1):
        lg, cache = adapter.step(params, token, S + i, cache)
        token = pick(lg)
        if eos_id is not None:
            # a finished row pads with EOS
            token = torch.where(done, eos_id, token)
            done = done | (token == eos_id)
        toks.append(token)
    return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)


def _top_k(x, k):
    """(values, indices) of the k largest per row, ties to the lower
    index (as `lax.top_k`)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _reorder(cache, rows):
    """`index_select` every tensor of a (nested) cache along its batch
    dim."""
    if isinstance(cache, (list, tuple)):
        return type(cache)(_reorder(c, rows) for c in cache)
    return cache.index_select(0, rows)


def _beam_search(adapter, params, ids, max_new, num_beams, eos_id,
                 length_penalty):
    """Beams flattened into the batch (row b * K + k); each step the cache
    is reordered by beam parent; a finished beam propagates EOS with its
    score frozen; the best beam by length-penalised score is traced back
    through the parents."""
    B, S = ids.shape
    K = num_beams
    eos = -1 if eos_id is None else int(eos_id)
    dev = ids.device

    cache = adapter.init_cache(B, S + max_new)
    logits, cache = adapter.prefill(params, ids, cache)     # (B, V)
    V = logits.shape[-1]
    cache = _reorder(cache, torch.arange(B, device=dev).repeat_interleave(K))
    lp0 = torch.log_softmax(logits.to(torch.float32), dim=-1)
    log_probs, first_tok = _top_k(lp0, K)                    # (B, K)
    token = first_tok.reshape(B * K)
    finished = first_tok == eos
    lengths = torch.ones((B, K), dtype=torch.int32, device=dev)
    noend = torch.full((V,), _NEG, dtype=torch.float32, device=dev)
    noend[eos] = 0.0
    toks, parents = [], []
    for i in range(max_new - 1):
        lg, cache = adapter.step(params, token, S + i, cache)  # (B*K, V)
        step_lp = torch.log_softmax(lg.to(torch.float32),
                                    dim=-1).reshape(B, K, V)
        step_lp = torch.where(finished[:, :, None], noend, step_lp)
        total = step_lp + log_probs[:, :, None]
        log_probs, idx = _top_k(total.reshape(B, K * V), K)
        parent = torch.div(idx, V, rounding_mode="floor")
        tok = idx % V
        rows = (torch.arange(B, device=dev)[:, None] * K + parent).reshape(-1)
        cache = _reorder(cache, rows)
        fin = torch.gather(finished, 1, parent)
        lengths = torch.gather(lengths, 1, parent) + (~fin).to(torch.int32)
        finished = fin | (tok == eos)
        token = tok.reshape(B * K)
        toks.append(tok)
        parents.append(parent)
    if max_new > 1:
        norm = torch.where(
            lengths > 0,
            log_probs / lengths.to(torch.float32) ** length_penalty,
            log_probs)
        beam = torch.argmax(norm, dim=-1)                     # (B,)
        seq = []
        for tok, parent in zip(reversed(toks), reversed(parents)):
            seq.append(torch.gather(tok, 1, beam[:, None])[:, 0])
            beam = torch.gather(parent, 1, beam[:, None])[:, 0]
        first = torch.gather(first_tok, 1, beam[:, None])
        seq = torch.cat([first, torch.stack(seq[::-1], dim=1)], dim=1)
    else:
        best = torch.argmax(log_probs, dim=-1)
        seq = torch.gather(first_tok, 1, best[:, None])
    return torch.cat([ids, seq], dim=1)


# -- entry point ---------------------------------------------------------


def generate(model, input_ids, max_new_tokens=8, decode_strategy="greedy",
             temperature=1.0, top_k=0, top_p=1.0, num_beams=1,
             eos_token_id=None, length_penalty=0.0, seed=0):
    """Model-agnostic generation: "greedy" | "sampling" | "beam_search"
    over the model's adapter (the Llama KV cache, or the padded
    re-forward for any other module).  Returns the int64 ids (B, S +
    max_new_tokens) on the model's device, prompt included; sampling
    draws from a `torch.Generator` seeded with `seed`."""
    from .models.llama_decode import as_ids
    adapter = _adapter_for(model)
    ids = as_ids(input_ids, adapter.device)
    if ids.dim() != 2:
        raise ValueError(f"input_ids must be (batch, seq), got "
                         f"{tuple(ids.shape)}")
    if max_new_tokens <= 0:
        return ids
    if decode_strategy not in ("greedy", "sampling", "beam_search"):
        raise ValueError(f"unknown decode_strategy {decode_strategy!r}")
    with torch.no_grad():
        params = adapter.params()
        if decode_strategy == "beam_search":
            if num_beams < 1:
                raise ValueError("num_beams must be >= 1")
            return _beam_search(adapter, params, ids, max_new_tokens,
                                num_beams, eos_token_id, length_penalty)
        generator = torch.Generator(device=adapter.device)
        generator.manual_seed(int(seed))
        return _greedy_or_sample(adapter, params, ids, max_new_tokens,
                                 generator, temperature, top_k, top_p,
                                 decode_strategy == "greedy", eos_token_id)
