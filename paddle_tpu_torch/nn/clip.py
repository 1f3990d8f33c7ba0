"""Gradient clipping — the port of `paddle_tpu/nn/clip.py`'s
`ClipGradByGlobalNorm`, the clip the training step uses."""

from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
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
        """{name: gradient} -> {name: clipped gradient} (new tensors)."""
        if not grads:
            return grads
        gnorm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp_min(gnorm, self.clip_norm)
        return {k: (g.to(torch.float32) * scale).to(g.dtype)
                for k, g in grads.items()}
