"""Mixture-of-Experts layer and gates — the port of
`paddle_tpu/nn/layer/moe.py` (`NaiveGate`, `GShardGate`, `SwitchGate`,
`MoELayer`).

Experts are one stacked parameter set: `w_gate`, `w_up` (E, d, ff) and
`w_down` (E, ff, d), Normal(0, 0.02); the router is `gate.gate.weight`
(d, E), Xavier-uniform; the optional always-on shared expert is
`shared_gate`, `shared_up` (d, h) and `shared_down` (h, d).  Names and
the paddle `[in, out]` layout are the JAX layer's, so weights cross by
name (`models.llama.load_reference_arrays`).  Parameters are drawn on
`device` (the CUDA card unless the caller passes `device="cpu"`) in
`dtype` from `generator` (seeded 0 on `device` when None).

`forward(x)` returns the output and keeps the weighted aux loss on
`aux_loss`, as the JAX layer does; `forward_with_aux(x)` returns both
and keeps nothing, for callers that must not leave state on the layer
(a decoder layer under `torch.utils.checkpoint`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.moe_ops import moe_dropless_ffn, moe_expert_ffn

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate"]


class _Linear(nn.Module):
    """Bias-free Linear in paddle's `[in, out]` layout (`y = x @ W`)."""

    def __init__(self, weight):
        super().__init__()
        self.weight = nn.Parameter(weight)

    def forward(self, x):
        return x @ self.weight


def _normal(shape, device, dtype, generator, std=0.02):
    w = torch.empty(shape, dtype=dtype, device=device)
    return w.normal_(0.0, std, generator=generator)


class _BaseGate(nn.Module):
    top_k = 2
    has_aux = True

    def __init__(self, d_model, num_experts, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.num_experts = num_experts
        limit = math.sqrt(6.0 / (d_model + num_experts))
        w = torch.empty(d_model, num_experts, dtype=dtype, device=device)
        self.gate = _Linear(w.uniform_(-limit, limit, generator=generator))

    def forward(self, x):
        return self.gate(x)


class NaiveGate(_BaseGate):
    """top-k softmax routing, no aux loss."""
    has_aux = False

    def __init__(self, d_model, num_experts, top_k=2, **kw):
        super().__init__(d_model, num_experts, **kw)
        self.top_k = top_k


class GShardGate(_BaseGate):
    """top-k (2 by default) + load-balance aux."""

    def __init__(self, d_model, num_experts, top_k=2, **kw):
        super().__init__(d_model, num_experts, **kw)
        self.top_k = top_k


class SwitchGate(_BaseGate):
    """top-1 + load-balance aux."""
    top_k = 1

    def __init__(self, d_model, num_experts, top_k=1, **kw):
        if top_k not in (None, 1):
            raise ValueError(
                f"SwitchGate is top-1 routing by definition, got top_k={top_k}")
        super().__init__(d_model, num_experts, **kw)
        self.top_k = 1


_GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


class MoELayer(nn.Module):
    """SwiGLU expert MLPs behind a router: capacity-bounded routing
    (`moe_expert_ffn`), or with `dropless=True` every token reaches its
    experts through the grouped matmul (`moe_dropless_ffn`, kernels
    K5f/K5b)."""

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 top_k=None, capacity_factor=1.25, aux_loss_weight=0.01,
                 shared_expert_hidden=0, dropless=False, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.dropless = dropless
        kw = dict(device=device, dtype=dtype, generator=generator)
        if isinstance(gate, str):
            self.gate = _GATES[gate](d_model, num_experts,
                                     **({"top_k": top_k} if top_k else {}),
                                     **kw)
        else:
            self.gate = gate
        self.top_k = self.gate.top_k
        self.w_gate = nn.Parameter(
            _normal((num_experts, d_model, d_hidden), **kw))
        self.w_up = nn.Parameter(
            _normal((num_experts, d_model, d_hidden), **kw))
        self.w_down = nn.Parameter(
            _normal((num_experts, d_hidden, d_model), **kw))
        if shared_expert_hidden:
            h = shared_expert_hidden
            self.shared_gate = _Linear(_normal((d_model, h), **kw))
            self.shared_up = _Linear(_normal((d_model, h), **kw))
            self.shared_down = _Linear(_normal((h, d_model), **kw))
        else:
            self.shared_gate = None
        self.aux_loss = None

    def forward_with_aux(self, x):
        """(output shaped like x, weighted aux loss or None for a gate
        without one)."""
        x2d = x.reshape(-1, self.d_model)
        logits = self.gate(x2d)
        ffn = moe_dropless_ffn if self.dropless else moe_expert_ffn
        kw = {} if self.dropless else {"capacity_factor":
                                       self.capacity_factor}
        y, aux = ffn(x2d, logits, self.w_gate, self.w_up, self.w_down,
                     top_k=self.top_k, **kw)
        if self.shared_gate is not None:
            y = y + self.shared_down(
                F.silu(self.shared_gate(x2d)) * self.shared_up(x2d))
        aux = aux * self.aux_loss_weight if self.gate.has_aux else None
        return y.reshape(x.shape), aux

    def forward(self, x):
        y, self.aux_loss = self.forward_with_aux(x)
        return y
