"""The training step — the port of `paddle_tpu/jit/trainer.py::TrainStep`
on one device.

Where the JAX package traces (model, loss_fn, optimizer) into one jitted
step that donates the parameter and optimizer buffers, the port runs the
same step eagerly: the forward and the loss, `loss.backward()`, then the
clip and the optimizer rule (`optimizer.functional_update`: for Adam and
AdamW with no clip or a global-norm one, one fused update, on the card
two multi-tensor kernels; for every other rule or clip `update_rule`
parameter by parameter, op by op), which writes
the new values into the model's own parameters and the optimizer state
in place (the counterpart of donation: no second copy of the model is
held).  The step counter is incremented before the update (bias
correction starts at 1) and lr is read from `optimizer.get_lr()` on the
host before each step, as in the JAX step.

fp16 parameters (O2 at fp16) raise `NotImplementedError`: the fused
update has no fp16 build yet.  fp16-style loss scaling (`loss_scale=`:
a float, "dynamic", or an `amp.GradScaler` whose knobs it copies)
follows the JAX step (`paddle_tpu/jit/trainer.py:163-182`,
`:278-309`): the fp32 loss is
scaled before `backward()`; the update unscales the gradients,
reduces `found_inf` over all of them and, when it is set, leaves params
and state as they were; then `scaler_state` ({"scale": fp32, "good",
"bad": int32}, 0-dim tensors on the device) is updated by the JAX
formulas.  Nothing in the step reads a value back to the host.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

__all__ = ["TrainStep", "collect_state", "bind_state"]


def collect_state(layer):
    """-> (trainable, frozen, buffers): the layer's parameters that take
    a gradient, those that do not (JAX: `stop_gradient`), and its
    buffers, each {name: tensor}."""
    params = {name: p for name, p in layer.named_parameters()
              if p.requires_grad}
    frozen = {name: p for name, p in layer.named_parameters()
              if not p.requires_grad}
    buffers = {name: b for name, b in layer.named_buffers()}
    return params, frozen, buffers


@contextlib.contextmanager
def bind_state(tensors: dict, arrays: dict):
    """Swap the values of `arrays` (by name; a non-tensor is made one on
    the tensor's device) into the named `tensors` for the block, and
    restore them after, also on an exception."""
    saved = {k: t.data for k, t in tensors.items()}
    try:
        for k, t in tensors.items():
            if k in arrays:
                a = arrays[k]
                t.data = a if isinstance(a, torch.Tensor) else \
                    torch.as_tensor(a, device=t.device)
        yield
    finally:
        for k, t in tensors.items():
            t.data = saved[k]


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
        if any(p.dtype == torch.float16 for p in model.parameters()):
            raise NotImplementedError(
                "a TrainStep over fp16 parameters (amp.decorate(level="
                "'O2', dtype='float16')) is not ported yet (ROADMAP: queue "
                "1 item 7 (amp: fp16 U1/U2)); the eager optimizer.step() "
                "runs it op by op")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.buffers = dict(model.named_buffers())
        self.opt_state = optimizer.functional_init(self.params)
        self.step_i = 0
        self._scaler_cfg = self._parse_loss_scale(loss_scale)
        self.scaler_state = {}
        if self._scaler_cfg is not None:
            dev = self._device()
            self.scaler_state = {
                "scale": torch.tensor(self._scaler_cfg["init"],
                                      dtype=torch.float32, device=dev),
                "good": torch.zeros((), dtype=torch.int32, device=dev),
                "bad": torch.zeros((), dtype=torch.int32, device=dev)}

    @staticmethod
    def _parse_loss_scale(loss_scale):
        """None | float (static) | 'dynamic' | GradScaler -> cfg dict."""
        if loss_scale is None:
            return None
        if isinstance(loss_scale, (int, float)):
            return {"init": float(loss_scale), "dynamic": False,
                    "incr_ratio": 2.0, "decr_ratio": 0.5,
                    "incr_every": 1000, "decr_every": 2}
        if loss_scale == "dynamic":
            return {"init": 2.0 ** 15, "dynamic": True, "incr_ratio": 2.0,
                    "decr_ratio": 0.5, "incr_every": 1000, "decr_every": 2}
        # an object carrying a GradScaler's knobs
        return {"init": float(loss_scale._scale),
                "dynamic": bool(loss_scale._dynamic),
                "incr_ratio": float(loss_scale._incr_ratio),
                "decr_ratio": float(loss_scale._decr_ratio),
                "incr_every": int(loss_scale._incr_every),
                "decr_every": int(loss_scale._decr_every)}

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
        loss = self.loss_fn(self.model, *batch).to(torch.float32)
        scale = self.scaler_state.get("scale")
        (loss if scale is None else loss * scale).backward()
        grads = {n: p.grad for n, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        out = self.optimizer.functional_update(
            self.params, grads, self.opt_state, lr, self.step_i, scale=scale)
        if scale is not None:
            self._update_scaler(out["found_inf"])
        return loss.detach()

    @torch.no_grad()
    def _update_scaler(self, found_inf):
        """The JAX step's scaler update, on the device."""
        cfg, st = self._scaler_cfg, self.scaler_state
        zero = torch.zeros_like(st["good"])
        good = torch.where(found_inf, zero, st["good"] + 1)
        bad = torch.where(found_inf, st["bad"] + 1, zero)
        s = st["scale"]
        if cfg["dynamic"]:
            grow = good >= cfg["incr_every"]
            shrink = bad >= cfg["decr_every"]
            s = torch.where(grow, s * cfg["incr_ratio"], s)
            s = torch.where(shrink, torch.clamp_min(s * cfg["decr_ratio"],
                                                    1.0), s)
            good = torch.where(grow, zero, good)
            bad = torch.where(shrink, zero, bad)
        self.scaler_state = {"scale": s, "good": good, "bad": bad}

    def sync_to_model(self):
        """A no-op: the step updates the model's parameters in place, so
        the model is always current (the JAX step keeps its state apart
        from the eager Layer and copies it back here)."""

    @torch.no_grad()
    def state_dict(self):
        """A snapshot (copies: later steps update the model in place);
        with a loss scale also "scaler", as the JAX step lays it out."""
        sd = {"params": {k: t.clone() for k, t in self.params.items()},
              "buffers": {k: t.clone() for k, t in self.buffers.items()},
              "opt_state": {k: {n: v.clone() for n, v in st.items()}
                            for k, st in self.opt_state.items()},
              "step": self.step_i}
        if self.scaler_state:
            sd["scaler"] = {k: t.clone() for k, t in self.scaler_state.items()}
        return sd

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
        if "scaler" in sd and self._scaler_cfg is not None:
            self.scaler_state = {
                k: torch.as_tensor(v).to(device=self._device(),
                                         dtype=self.scaler_state[k].dtype)
                for k, v in sd["scaler"].items()}
