"""AMP — the port of `paddle_tpu/amp/__init__.py` (`auto_cast` O1 / O2
with the white and black lists, `decorate`, `GradScaler`).

O1 is a per-op dtype policy, as in the JAX package, where the op
dispatcher applies it to every op by name
(`paddle_tpu/core/dispatch.py::_maybe_autocast`).  The port has no op
registry: the policy is `autocast_args`, called at the port's entry
points that carry a JAX op name (`nn.layer.Linear` as "linear_op",
`nn.functional.layer_norm` / `cross_entropy` / `conv2d` as
"layer_norm_op" / "cross_entropy_op" / "conv2d_op",
`ops.flash_attention.flash_attention_xla` as "flash_attention_op").
Under O1 a white-listed op gets its fp32 / fp64 inputs in the amp
dtype, a black-listed one its fp16 / bf16 inputs in fp32; every other
op, and every op at O2 or outside `auto_cast`, is left alone.  The
lists are the JAX package's, not `torch.autocast`'s (which the port
does not use: its op lists are PyTorch's own).

`decorate` (O2) converts every floating parameter and buffer of the
models in place, keeping each `Parameter` object (an optimizer built
before the call still holds them), and sets `_multi_precision` on the
optimizers (fp32 moments for the training step).  `GradScaler` is the
JAX package's dynamic loss scaler, eagerly over an optimizer's
`_parameters`; `jit.TrainStep(loss_scale=GradScaler(...))` takes its
knobs and runs the same rule on the device.

The state is thread-local (`amp_state()`), as in the JAX package.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "WHITE_LIST", "BLACK_LIST", "amp_state", "autocast_args"]

# ops computed in low precision under O1 (ref: fp16_lists.py white_list)
WHITE_LIST = {
    "matmul", "mm", "bmm", "linear_op", "conv2d_op", "conv1d_op", "conv3d_op",
    "conv2d_transpose_op", "einsum_op", "flash_attention_op",
}
# ops forced to fp32 (ref black_list: softmax w/ CE, norms, exp/log...)
BLACK_LIST = {
    "cross_entropy_op", "nll_loss_op", "log_softmax_op", "softmax_op",
    "layer_norm_op", "batch_norm_stats", "batch_norm_infer", "group_norm_op",
    "log", "exp", "logsumexp", "p_norm", "mse_loss_op", "bce_op",
    "bce_logits_op", "sum", "mean",
}

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def _dtype(d):
    """A dtype name or torch dtype as a torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    try:
        return _DTYPES[str(d)]
    except KeyError:
        raise ValueError(f"amp: unsupported dtype {d!r}") from None


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    return _state


class auto_cast:
    """Context manager (ref: amp/auto_cast.py:668 amp_guard)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        self.enable = enable
        self.level = level
        self.dtype = _dtype(dtype)
        self.white = set(custom_white_list or ())
        self.black = set(custom_black_list or ())

    def __enter__(self):
        self._saved = (_state.enabled, _state.dtype, _state.level,
                       _state.custom_white, _state.custom_black)
        _state.enabled = self.enable
        _state.dtype = self.dtype
        _state.level = self.level
        _state.custom_white = self.white
        _state.custom_black = self.black
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = self._saved
        return False


amp_guard = auto_cast


def autocast_args(op_name, *args):
    """The O1 policy of op `op_name` applied to its inputs (the JAX
    dispatcher's `_maybe_autocast`): `args` as they are outside O1 or
    for an op on neither list; else each floating tensor cast (white:
    fp32 / fp64 -> the amp dtype; black: fp16 / bf16 -> fp32), lists
    and tuples descended one level.  Returns a tuple."""
    st = _state
    if not st.enabled or st.level != "O1":
        return args
    in_white = (op_name in WHITE_LIST or op_name in st.custom_white) and \
        op_name not in st.custom_black
    in_black = op_name in BLACK_LIST or op_name in st.custom_black
    if not in_white and not in_black:
        return args
    if in_white:
        src, dst = (torch.float32, torch.float64), st.dtype
    else:
        src, dst = (torch.float16, torch.bfloat16), torch.float32

    def cast(a):
        return a.to(dst) if isinstance(a, torch.Tensor) and \
            a.dtype in src else a

    return tuple(type(a)(cast(x) for x in a) if isinstance(a, (list, tuple))
                 else cast(a) for a in args)


@torch.no_grad()
def _convert_dtype(model, dtype):
    """Every floating parameter and buffer of `model` to `dtype`, in
    place: the same `Parameter` objects (JAX `_set_data`)."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    for b in model.buffers():
        if b.is_floating_point():
            b.data = b.data.to(dtype)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast model params to low precision (ref: auto_cast.py:730).
    Optimizers keep fp32 master state via multi_precision."""
    dt = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        _convert_dtype(m, dt)
    if optimizers is not None:
        opt_single = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if opt_single else list(optimizers)
        for o in opt_list:
            o._multi_precision = True
        if single and opt_single:
            return models, optimizers
        return model_list, opt_list
    return models if single else model_list


class GradScaler:
    """Dynamic loss scaling (ref: amp/grad_scaler.py:602): the JAX
    package's eager rule over `optimizer._parameters`, with host floats
    and counters (`unscale_` reads found_inf back to the host once a
    step).  `jit.TrainStep(loss_scale=scaler)` copies its knobs and runs
    the rule on the device instead.

    The gradients are unscaled at most once a step, as in Paddle's
    scaler (`OptimizerState.UNSCALED`): `unscale_` marks the step,
    `step` unscales only where the caller did not and takes the mark
    down, as `update` does.  The JAX package's scaler unscales again in
    `step` after a finite `unscale_` (g / s^2 for the usual unscale_ ->
    clip -> step script); the port does not copy that."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        found = False
        for p in optimizer._parameters or []:
            if p.grad is not None:
                g = p.grad * inv
                found = found or not bool(torch.isfinite(g).all())
                p.grad = g
        self._found_inf = found
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        self._unscaled = False
        if self._found_inf:
            self._cache_founds_step()
        else:
            optimizer.step()
            self._good_steps += 1
            if self._dynamic and self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def _cache_founds_step(self):
        self._bad_steps += 1
        self._good_steps = 0
        if self._dynamic and self._bad_steps >= self._decr_every:
            self._scale = max(self._scale * self._decr_ratio, 1.0)
            self._bad_steps = 0

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd["good_steps"]
        self._bad_steps = sd["bad_steps"]
