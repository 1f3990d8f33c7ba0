"""Per-slot token selection for the continuous-batching engine — the
port of `top_p_mask` and `sample_logits_per_slot` from
`paddle_tpu/generation.py`.

Greedy rows take the argmax of the raw logits.  Sampled rows draw from
their own `torch.Generator` (one per request, seeded from
`Request.seed`), so a request's tokens depend only on its own seed and
step count, never on which neighbours share the batch.  The draws do
not reproduce JAX's threefry streams; only the port's own contract is
pinned by its tests.
"""

from __future__ import annotations

import torch

__all__ = ["top_p_mask", "sample_logits_per_slot"]

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
    out = torch.argmax(lg, dim=-1)
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
