"""Gradient clipping — the port of `paddle_tpu/nn/clip.py` (ref:
python/paddle/nn/clip.py): `ClipGradByValue`, `ClipGradByNorm`,
`ClipGradByGlobalNorm`, `clip_grad_norm_` and `clip_grad_value_`.

Each clip has the JAX package's two forms: `_clip_arrays({name: grad})`
for the training step and `clip(params_grads)` (`__call__`, `_clip`)
over [(param, grad)] for the eager `optimizer.step()`.  Rounding follows
the JAX module: the global norm in fp32, each gradient scaled in fp32
and rounded back to its dtype; the per-tensor clips in the gradient's
own dtype, a Python constant rounded to that dtype first (`_weak`: JAX's
weak types)."""

from __future__ import annotations

import torch

from ..ops.fused_update import _weak

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)

    def _clip(self, params_grads):
        """[(param, grad)] -> [(param, clipped grad)] (None stays None)."""
        names = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        clipped = self._clip_arrays({i: params_grads[i][1] for i in names})
        return [(p, clipped[i] if g is not None else None)
                for i, (p, g) in enumerate(params_grads)]

    def _clip_arrays(self, grads: dict) -> dict:
        """{name: gradient} -> {name: clipped gradient} (new tensors)."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip_arrays(self, grads):
        return {k: torch.clamp(g, _weak(self.min, g.dtype),
                               _weak(self.max, g.dtype))
                for k, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    """Each gradient by its own norm: g * min(clip_norm / max(|g|, 1e-12),
    1), in the gradient's dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_arrays(self, grads):
        out = {}
        for k, g in grads.items():
            dt = g.dtype
            norm = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.clamp_max(
                _weak(self.clip_norm, dt)
                / torch.clamp_min(norm, _weak(1e-12, dt)), 1.0)
            out[k] = g * scale
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by clip_norm / max(global_norm, clip_norm),
    with the global norm sqrt(sum_g sum(g^2)) taken in fp32 and each
    gradient scaled in fp32 and rounded back to its dtype, as the JAX
    package does."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads: dict):
        """The fp32 global norm of {name: gradient} (a 0-dim tensor)."""
        sq = [torch.sum(torch.square(g.to(torch.float32)))
              for g in grads.values()]
        return torch.sqrt(sum(sq))

    def _clip_arrays(self, grads: dict) -> dict:
        if not grads:
            return grads
        gnorm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp_min(gnorm, self.clip_norm)
        return {k: (g.to(torch.float32) * scale).to(g.dtype)
                for k, g in grads.items()}


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every `p.grad` by min(max_norm / max(total, 1e-6), 1), the
    total norm of order `norm_type` taken in the gradients' dtype;
    returns the total norm."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(p.grad))
                                       for p in params]))
    else:
        total = torch.pow(
            sum(torch.sum(torch.pow(torch.abs(p.grad), norm_type))
                for p in params), 1.0 / norm_type)
    dt = total.dtype
    scale = torch.clamp_max(_weak(max_norm, dt)
                            / torch.clamp_min(total, _weak(1e-6, dt)), 1.0)
    for p in params:
        p.grad = p.grad * scale
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every `p.grad` to [-clip_value, clip_value]."""
    for p in parameters:
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, _weak(-clip_value, p.grad.dtype),
                                 _weak(clip_value, p.grad.dtype))
