"""The training step — the port of `paddle_tpu/jit/trainer.py::TrainStep`
on one device.

Where the JAX package traces (model, loss_fn, optimizer) into one jitted
step that donates the parameter and optimizer buffers, the port runs the
same step eagerly: the forward and the loss, `loss.backward()`, the
global-norm clip and the optimizer rule, whose new values are written
into the model's own parameters in place (the counterpart of donation:
no second copy of the model is held).  The step counter is incremented
before the update (bias correction starts at 1) and lr is read from
`optimizer.get_lr()` on the host before each step, as in the JAX step.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["TrainStep"]


class TrainStep:
    """One training step over (model, loss_fn, optimizer).

    loss_fn(model, *batch) -> scalar loss tensor.  Batch items that are
    not tensors (numpy arrays, lists) are moved to the model's device."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 shard_rules=None, batch_spec=None, loss_scale=None,
                 opt_shard_rules=None):
        if any(x is not None for x in (mesh, shard_rules, batch_spec,
                                       opt_shard_rules)):
            raise NotImplementedError(
                "sharded training (mesh, shard_rules, batch_spec, "
                "opt_shard_rules) is not ported yet (ROADMAP: queue 1 "
                "item 5, multi-GPU)")
        if loss_scale is not None:
            raise NotImplementedError(
                "fp16 loss scaling is not ported yet (ROADMAP: queue 1 "
                "item 7, amp)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.buffers = dict(model.named_buffers())
        self.opt_state = optimizer.functional_init(self.params)
        self.step_i = 0

    def _device(self):
        return next(iter(self.params.values())).device

    def __call__(self, *batch):
        """One training step; returns the loss (detached)."""
        dev = self._device()
        batch = [b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
                 for b in batch]
        batch = [b.to(dev) for b in batch]
        lr = self.optimizer.get_lr()
        self.step_i += 1
        for p in self.params.values():
            p.grad = None
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        grads = {n: p.grad for n, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        self.optimizer.functional_update(self.params, grads, self.opt_state,
                                         lr, self.step_i)
        return loss.detach().to(torch.float32)

    def sync_to_model(self):
        """A no-op: the step updates the model's parameters in place, so
        the model is always current (the JAX step keeps its state apart
        from the eager Layer and copies it back here)."""

    @torch.no_grad()
    def state_dict(self):
        """A snapshot (copies: later steps update the model in place)."""
        return {"params": {k: t.clone() for k, t in self.params.items()},
                "buffers": {k: t.clone() for k, t in self.buffers.items()},
                "opt_state": {k: {n: v.clone() for n, v in st.items()}
                              for k, st in self.opt_state.items()},
                "step": self.step_i}

    @torch.no_grad()
    def set_state_dict(self, sd):
        """Copy params, buffers and optimizer state in (values, not
        aliases: the model keeps its own tensors)."""
        for group, src in ((self.params, sd["params"]),
                           (self.buffers, sd["buffers"])):
            for k, t in group.items():
                t.copy_(torch.as_tensor(src[k]))
        self.opt_state = {
            k: {n: torch.as_tensor(v).to(device=self.params[k].device,
                                         dtype=self.opt_state[k][n].dtype)
                for n, v in st.items()}
            for k, st in sd["opt_state"].items()}
        self.step_i = int(sd["step"])
