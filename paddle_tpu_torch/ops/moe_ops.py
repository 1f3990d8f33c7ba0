"""MoE routing, dispatch/combine and the expert FFNs — the port of
`paddle_tpu/ops/moe_ops.py` on one device.

* `gate_probs_and_topk`: fp32 softmax, then the top k with ties broken
  toward the lower expert index, as `jax.lax.top_k` breaks them (a
  stable descending sort: bf16 gate logits over 60 experts tie often);
* `load_balance_loss`: the GShard aux loss on each token's first choice;
* `_position_in_expert` / `build_combine_tensor`: slot-major capacity
  positions and the (T, E, C) combine tensor;
* `_inverse_slots`, `_cap_dispatch`, `_cap_combine`: the gather-only
  dispatch and combine.  Both backwards are gathers too (no
  `index_add_`), which on the card keeps them free of atomics and so
  deterministic; the combine accumulates in fp32;
* `moe_expert_ffn`: the capacity path (tokens past an expert's capacity
  are dropped), its expert products as `torch.einsum`;
* `moe_dropless_ffn`: every token reaches its k experts; the routing is
  a sort (`ops/gmm.py`) and the expert products run on kernels K5f/K5b.

Every op here is a plain torch op on the device that never reads a
value back to the host, so a layer's kernel grid is fixed by its shapes
(`padded_buffer_size`).  The JAX package's expert-parallel formulation
(one-hot einsums that GSPMD lowers to an all-to-all over an "ep" mesh)
is not ported: a `mesh` raises (ROADMAP: queue 1 item 5, multi-GPU).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .gmm import (gmm, live_tile_count, padded_buffer_size,
                  sort_slots_by_expert)

__all__ = ["moe_expert_ffn", "moe_dropless_ffn", "gate_probs_and_topk",
           "build_combine_tensor", "load_balance_loss"]


def gate_probs_and_topk(logits, top_k, *, normalize=True):
    """fp32 softmax → (probs, top_vals, top_idx); equal probabilities
    keep the lower expert index first."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[..., :top_k], idx[..., :top_k]
    if normalize:
        top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_vals, top_idx


def load_balance_loss(probs, top_idx, num_experts):
    """GShard aux loss: E * Σ_e mean_prob_e * frac_tokens_e (first
    choice only)."""
    me = probs.mean(dim=0)
    ce = F.one_hot(top_idx[:, 0], num_experts).to(torch.float32).mean(dim=0)
    return num_experts * torch.sum(me * ce)


def _position_in_expert(top_vals, top_idx, num_experts, capacity):
    """(T, k) routing → (pos (T, k), keep (T, k)) — slot-major GShard
    priority: slot 0 of every token queues before any slot 1."""
    T, k = top_idx.shape
    oh = F.one_hot(top_idx.long(), num_experts)                  # (T, k, E)
    flat = oh.transpose(0, 1).reshape(T * k, num_experts)
    pos = (torch.cumsum(flat, dim=0) - 1).reshape(k, T, num_experts) \
        .transpose(0, 1)
    pos = (pos * oh).sum(-1)                                    # (T, k)
    keep = (pos < capacity) & (top_vals > 0)
    return pos, keep


def build_combine_tensor(top_vals, top_idx, num_experts, capacity):
    """(T, k) routing → combine (T, E, C) fp32, dispatch (T, E, C) bool;
    tokens past an expert's capacity are dropped."""
    T, k = top_idx.shape
    pos, keep = _position_in_expert(top_vals, top_idx, num_experts,
                                    capacity)
    pos = pos.clamp(0, capacity - 1)
    combine = torch.zeros(T, num_experts, capacity, dtype=torch.float32,
                          device=top_vals.device)
    t_ids = torch.arange(T, device=top_vals.device)[:, None].expand(T, k)
    combine.index_put_(
        (t_ids.reshape(-1), top_idx.reshape(-1).long(), pos.reshape(-1)),
        torch.where(keep, top_vals, 0.0).reshape(-1).to(torch.float32),
        accumulate=True)
    return combine, combine > 0


def _inverse_slots(slot, n_slots):
    """slot (T, k), n_slots for a dropped pair → inv (n_slots,): the flat
    (token * k + j) index in each slot, sentinel T * k for empty slots.
    Dropped pairs land in one spare slot that is sliced off (the JAX
    scatter's mode="drop")."""
    Tk = slot.numel()
    inv = torch.full((n_slots + 1,), Tk, dtype=torch.int32,
                     device=slot.device)
    inv.scatter_(0, slot.reshape(-1).long().clamp(0, n_slots),
                 torch.arange(Tk, dtype=torch.int32, device=slot.device))
    return inv[:n_slots]


class _CapDispatch(torch.autograd.Function):
    """x (T, d) → slot buffer (S, d), empty slots zero; the backward
    gathers each token's k slots: d_x(t) = Σ_j keep(t, j) g[slot(t, j)]."""

    @staticmethod
    def forward(ctx, x, slot, keep, inv):
        T, k = x.shape[0], slot.shape[1]
        tok = (inv.long() // k).clamp(0, T - 1)
        ctx.save_for_backward(slot, keep)
        return torch.where((inv < T * k)[:, None], x[tok], 0)

    @staticmethod
    def backward(ctx, g):
        slot, keep = ctx.saved_tensors
        sc = slot.long().clamp(0, g.shape[0] - 1)
        dx = None
        for j in range(slot.shape[1]):
            term = torch.where(keep[:, j, None], g[sc[:, j]], 0)
            dx = term if dx is None else dx + term
        return dx, None, None, None


class _CapCombine(torch.autograd.Function):
    """y(t) = Σ_j keep(t, j) w(t, j) buf[slot(t, j)], accumulated in fp32
    and rounded to buf's dtype.  The backward is gathers: d_buf by the
    inverse map, d_w as each pair's dot product with dy."""

    @staticmethod
    def forward(ctx, buf, w, slot, keep, inv):
        sc = slot.long().clamp(0, buf.shape[0] - 1)
        y = None
        for j in range(slot.shape[1]):
            wj = torch.where(keep[:, j], w[:, j], 0).to(torch.float32)
            term = wj[:, None] * buf[sc[:, j]].to(torch.float32)
            y = term if y is None else y + term
        ctx.save_for_backward(buf, w, slot, keep, inv)
        return y.to(buf.dtype)

    @staticmethod
    def backward(ctx, dy):
        buf, w, slot, keep, inv = ctx.saved_tensors
        T, k = slot.shape
        fl = inv.long().clamp(0, T * k - 1)
        valid = (inv < T * k)[:, None]
        wv = torch.where(valid[:, 0], w.reshape(-1)[fl], 0).to(buf.dtype)
        d_buf = torch.where(valid, wv[:, None] * dy[fl // k], 0)
        sc = slot.long().clamp(0, buf.shape[0] - 1)
        dyf = dy.to(torch.float32)
        d_w = torch.stack(
            [torch.where(keep[:, j],
                         (buf[sc[:, j]].to(torch.float32) * dyf).sum(-1), 0)
             for j in range(k)], dim=1).to(w.dtype)
        return d_buf, d_w, None, None, None


def _cap_dispatch(x, slot, keep, inv):
    return _CapDispatch.apply(x, slot, keep, inv)


def _cap_combine(buf, w, slot, keep, inv):
    return _CapCombine.apply(buf, w, slot, keep, inv)


def moe_expert_ffn(x, gate_logits, w_gate, w_up, w_down, *, top_k,
                   capacity_factor, mesh=None):
    """x: (T, d) tokens; gate_logits: (T, E); experts stacked
    w_gate/w_up: (E, d, ff), w_down: (E, ff, d). Returns (y, aux_loss).
    SwiGLU experts behind capacity-bounded routing (the single-device
    scatter/gather formulation)."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE dispatch over an 'ep' mesh is not ported "
            "yet (ROADMAP: queue 1 item 5, multi-GPU)")
    T, d = x.shape
    E = gate_logits.shape[-1]
    capacity = max(1, int(math.ceil(top_k * T / E * capacity_factor)))
    probs, top_vals, top_idx = gate_probs_and_topk(gate_logits, top_k)
    aux = load_balance_loss(probs, top_idx, E)
    pos, keep = _position_in_expert(top_vals, top_idx, E, capacity)
    # each surviving (token, slot) owns a unique (expert, position)
    # cell; dropped pairs get the out-of-range slot id E * C
    slot = torch.where(keep, top_idx * capacity + pos, E * capacity)
    inv = _inverse_slots(slot, E * capacity)
    expert_in = _cap_dispatch(x, slot, keep, inv).reshape(E, capacity, d)
    h = torch.einsum("ecd,edf->ecf", expert_in, w_gate)
    u = torch.einsum("ecd,edf->ecf", expert_in, w_up)
    expert_out = torch.einsum("ecf,efd->ecd", F.silu(h) * u, w_down)
    y = _cap_combine(expert_out.reshape(E * capacity, d), top_vals, slot,
                     keep, inv)
    return y, aux.to(x.dtype)


def moe_dropless_ffn(x, gate_logits, w_gate, w_up, w_down, *, top_k,
                     block_m=256, block_n=128):
    """Dropless expert FFN: every token reaches all its top-k experts.
    The (token, expert) pairs are sorted by expert into a per-expert
    padded buffer of padded_buffer_size(T * k, E, block_m) rows, and the
    three expert products run on the grouped matmul (K5f; K5f and K5b in
    the backward).  Same contract as moe_expert_ffn: (y, aux_loss)."""
    T, d = x.shape
    E = gate_logits.shape[-1]
    probs, top_vals, top_idx = gate_probs_and_topk(gate_logits, top_k)
    aux = load_balance_loss(probs, top_idx, E)
    # one buffer row per (token, chosen expert) pair, token-major; the
    # dispatch and combine (and their backwards) are the gather-only
    # pair of the capacity path, fed by the sort's inverse map
    Tk = T * top_k
    M = padded_buffer_size(Tk, E, block_m)
    src, tile_expert, inv_pos = sort_slots_by_expert(
        top_idx.reshape(-1), E, block_m, M)
    slot = inv_pos.reshape(T, top_k)
    keep = torch.ones(T, top_k, dtype=torch.bool, device=x.device)
    buf = _cap_dispatch(x, slot, keep, src)                 # (M, d)
    # the tiles past the last expert's span hold only padding rows (zero
    # here, and zero in every gradient the backward feeds the kernels)
    live = live_tile_count(inv_pos, block_m)
    g = gmm(buf, w_gate, tile_expert, block_m, block_n, live)
    u = gmm(buf, w_up, tile_expert, block_m, block_n, live)
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    o = gmm(h, w_down, tile_expert, block_m, block_n, live)
    y = _cap_combine(o, top_vals, slot, keep, src)
    return y, aux.to(x.dtype)
