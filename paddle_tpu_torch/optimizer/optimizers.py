"""The optimizers — the port of `paddle_tpu/optimizer/optimizers.py`
(ref: python/paddle/optimizer/{sgd,momentum,adam,adamw,adagrad,adadelta,
adamax,rmsprop,lamb}.py, incubate/optimizer/{lookahead,modelaverage}.py,
optimizer/lbfgs.py).

Each `update_rule` is the JAX rule, op by op, each term rounded where
the JAX rule rounds it (the base module's docstring: `_weak` constants,
`lr_times` / `lr_over` for lr, and JAX's promotion where an fp32 value
meets a bf16 tensor, which PyTorch would keep in bf16 for a 0-dim
operand: `_mul`).  Adam and AdamW keep the fused kernels U1 / U2 in the
training step.  `Lookahead`, `ModelAverage` and `LBFGS` run only
eagerly, as in the JAX package."""

from __future__ import annotations

import torch

from .optimizer import Optimizer, _weak, lr_over, lr_times

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Adadelta",
           "Adamax", "RMSProp", "Lamb", "Lookahead", "ModelAverage", "LBFGS"]

_F32 = torch.float32


def _w(c, x):
    """A Python constant times `x`, in `x`'s dtype (JAX's weak type)."""
    return _weak(c, x.dtype) * x


def _plus(x, c):
    return x + _weak(c, x.dtype)


def _mul(a, b):
    """a * b in the dtype JAX promotes the two to (PyTorch keeps a 0-dim
    operand's wider dtype out of the result)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) * b.to(dt)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def update_rule(self, param, grad, state, lr, step):
        return param - lr_times(lr, grad.to(param.dtype)), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, param):
        return {"velocity": torch.zeros_like(param)}

    def update_rule(self, param, grad, state, lr, step):
        g = grad.to(param.dtype)
        v = _w(self._momentum, state["velocity"]) + g
        upd = g + _w(self._momentum, v) if self._nesterov else v
        return param - lr_times(lr, upd), {"velocity": v}


class Adam(Optimizer):
    """`lazy_mode` and `use_multi_tensor` are accepted and, as in the JAX
    package, change nothing: every update is dense (and, in the training
    step on the card, always the multi-tensor kernels of
    `ops.fused_update`)."""

    fused = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, use_multi_tensor=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, param):
        """Moments in the param's dtype, or fp32 with `multi_precision`."""
        dtype = _F32 if self._multi_precision else param.dtype
        return {"moment1": torch.zeros(param.shape, dtype=dtype,
                                       device=param.device),
                "moment2": torch.zeros(param.shape, dtype=dtype,
                                       device=param.device)}

    def _fused_hparams(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "eps": self._eps, "weight_decay": self._wd,
                "decoupled": self.decoupled_weight_decay}

    def update_rule(self, param, grad, state, lr, step):
        dt = state["moment1"].dtype
        b1, b2 = self._beta1, self._beta2
        g = grad.to(dt)
        m = _w(b1, state["moment1"]) + _w(1 - b1, g)
        v = _w(b2, state["moment2"]) + _w(1 - b2, torch.square(g))
        m_hat = m / _weak(1 - b1 ** step, dt)
        v_hat = v / _weak(1 - b2 ** step, dt)
        upd = lr_times(lr, m_hat) / _plus(torch.sqrt(v_hat), self._eps)
        return param - upd.to(param.dtype), {"moment1": m, "moment2": v}


class AdamW(Adam):
    decoupled_weight_decay = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW lr_ratio / apply_decay_param_fun are not ported "
                "(the JAX package's functional step ignores them too)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, param):
        return {"moment": torch.full(param.shape, self._init_acc,
                                     dtype=param.dtype, device=param.device)}

    def update_rule(self, param, grad, state, lr, step):
        g = grad.to(param.dtype)
        acc = state["moment"] + torch.square(g)
        new_p = param - lr_times(lr, g) / _plus(torch.sqrt(acc), self._eps)
        return new_p, {"moment": acc}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def init_state(self, param):
        return {"avg_squared_grad": torch.zeros_like(param),
                "avg_squared_update": torch.zeros_like(param)}

    def update_rule(self, param, grad, state, lr, step):
        g = grad.to(param.dtype)
        rho, eps = self._rho, self._eps
        asg = _w(rho, state["avg_squared_grad"]) + _w(1 - rho,
                                                      torch.square(g))
        upd = g * torch.sqrt(_plus(state["avg_squared_update"], eps)) \
            / torch.sqrt(_plus(asg, eps))
        asu = _w(rho, state["avg_squared_update"]) + _w(1 - rho,
                                                        torch.square(upd))
        return param - lr_times(lr, upd), {"avg_squared_grad": asg,
                                           "avg_squared_update": asu}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, param):
        return {"moment": torch.zeros_like(param),
                "inf_norm": torch.zeros_like(param)}

    def update_rule(self, param, grad, state, lr, step):
        g = grad.to(param.dtype)
        m = _w(self._beta1, state["moment"]) + _w(1 - self._beta1, g)
        u = torch.maximum(_w(self._beta2, state["inf_norm"]), torch.abs(g))
        lr_bc = lr_over(lr, 1 - self._beta1 ** step)
        new_p = param - lr_times(lr_bc, m) / _plus(u, self._eps)
        return new_p, {"moment": m, "inf_norm": u}


class RMSProp(Optimizer):
    """With a training step's fp32 lr and a bf16 parameter the JAX rule's
    momentum comes out fp32 (`lr * g` promotes it), and so does the
    port's."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, param):
        st = {"mean_square": torch.zeros_like(param),
              "momentum": torch.zeros_like(param)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(param)
        return st

    def update_rule(self, param, grad, state, lr, step):
        g = grad.to(param.dtype)
        rho = self._rho
        ms = _w(rho, state["mean_square"]) + _w(1 - rho, torch.square(g))
        if self._centered:
            mg = _w(rho, state["mean_grad"]) + _w(1 - rho, g)
            denom = torch.sqrt(_plus(ms - torch.square(mg), self._eps))
        else:
            denom = torch.sqrt(_plus(ms, self._eps))
        mom = _w(self._momentum, state["momentum"]) + lr_times(lr, g) / denom
        new_st = {"mean_square": ms, "momentum": mom}
        if self._centered:
            new_st["mean_grad"] = mg
        return param - mom, new_st


class Lamb(Optimizer):
    """LAMB (ref: python/paddle/optimizer/lamb.py) — layerwise-adaptive
    Adam for large batches; the decay is part of the update.  The trust
    ratio's norms are taken in the parameter's dtype, as in the JAX rule.
    `exclude_from_weight_decay_fn` is refused: the JAX optimizer stores
    it and never reads it (`paddle_tpu/optimizer/optimizers.py:192`), so
    every parameter is decayed there."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        if exclude_from_weight_decay_fn is not None:
            raise NotImplementedError(
                "Lamb exclude_from_weight_decay_fn is not ported: the JAX "
                "optimizer stores it and never reads it, decaying every "
                "parameter")
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lamb_wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, param):
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param)}

    def update_rule(self, param, grad, state, lr, step):
        dt = param.dtype
        b1, b2 = self._beta1, self._beta2
        g = grad.to(dt)
        m = _w(b1, state["moment1"]) + _w(1 - b1, g)
        v = _w(b2, state["moment2"]) + _w(1 - b2, torch.square(g))
        m_hat = m / _weak(1 - b1 ** step, m.dtype)
        v_hat = v / _weak(1 - b2 ** step, v.dtype)
        r = m_hat / _plus(torch.sqrt(v_hat), self._eps) \
            + _w(self._lamb_wd, param)
        w_norm = torch.sqrt(torch.sum(torch.square(param)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return param - _mul(lr_times(lr, trust), r), \
            {"moment1": m, "moment2": v}


class Lookahead(Optimizer):
    """ref: python/paddle/incubate/optimizer/lookahead.py LookAhead — a
    wrapper: the inner optimizer takes k fast steps, then the slow
    weights move alpha of the way toward the fast weights (in fp32) and
    the fast weights reset to them.  Eager only."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        super().__init__(learning_rate=inner_optimizer._lr,
                         parameters=inner_optimizer._parameters, name=name)
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._parameter_list = inner_optimizer._parameters
        self._slow = None

    def state_dict(self):
        sd = {"inner": self.inner.state_dict(), "step": self._step_count}
        if self._slow is not None:
            sd["slow"] = list(self._slow)
        return sd

    def set_state_dict(self, sd):
        self.inner.set_state_dict(sd["inner"])
        self._step_count = sd.get("step", 0)
        self._slow = [s.clone() for s in sd["slow"]] if "slow" in sd \
            else None

    def get_lr(self):
        return self.inner.get_lr()

    def set_lr(self, lr):
        return self.inner.set_lr(lr)

    def clear_grad(self, set_to_zero=False):
        self.inner.clear_grad(set_to_zero)

    @torch.no_grad()
    def step(self):
        if self._slow is None:
            self._slow = [p.detach().clone() for p in self._parameter_list]
        self.inner.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for i, p in enumerate(self._parameter_list):
                s32 = self._slow[i].to(_F32)
                slow = (s32 + self.alpha * (p.to(_F32) - s32)).to(p.dtype)
                self._slow[i] = slow
                p.copy_(slow)


class ModelAverage(Optimizer):
    """ref: python/paddle/incubate/optimizer/modelaverage.py — a windowed
    running average of the parameters; `apply()` swaps it in for eval,
    `restore()` swaps the parameters back bitwise.

    The reference's sum_1/sum_2/sum_3 + num_accumulates scheme
    (paddle/phi/kernels/impl/average_accumulates_kernel_impl.h:45-137),
    exactly as the JAX package keeps it: sum_1 (fp32) accumulates every
    step; every kMaxNumAccumulates (16384) updates sum_1 spills into
    sum_2 (precision); when the window outgrows min(max_average_window,
    num_updates * average_window_rate) the old sums collapse into sum_3
    and the window restarts.  apply() yields (sum_1 + sum_2 + sum_3) /
    (num_accumulates + old_num_accumulates).  Eager only."""

    _K_MAX_NUM_ACCUMULATES = 16384

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(learning_rate=0.0, parameters=list(parameters or []),
                         name=name)
        self._parameter_list = self._parameters
        self.rate = average_window_rate
        self.min_w = min_average_window
        self.max_w = max_average_window

        def zeros():
            return [torch.zeros_like(p, dtype=_F32)
                    for p in self._parameter_list]
        self._sum_1, self._sum_2, self._sum_3 = zeros(), zeros(), zeros()
        self._num_accumulates = 0
        self._old_num_accumulates = 0
        self._num_updates = 0
        self._backup = None

    def state_dict(self):
        return {"sum_1": list(self._sum_1), "sum_2": list(self._sum_2),
                "sum_3": list(self._sum_3),
                "num_accumulates": self._num_accumulates,
                "old_num_accumulates": self._old_num_accumulates,
                "num_updates": self._num_updates}

    def set_state_dict(self, sd):
        if "sum" in sd and "sum_1" not in sd:
            raise ValueError(
                "ModelAverage checkpoint uses the pre-r3 EMA format "
                "('sum'/'norm'/'count'); it cannot be converted to the "
                "reference windowed scheme — re-accumulate from training")
        self._sum_1 = [torch.as_tensor(s).clone() for s in sd["sum_1"]]
        self._sum_2 = [torch.as_tensor(s).clone() for s in sd["sum_2"]]
        self._sum_3 = [torch.as_tensor(s).clone() for s in sd["sum_3"]]
        self._num_accumulates = int(sd.get("num_accumulates", 0))
        self._old_num_accumulates = int(sd.get("old_num_accumulates", 0))
        self._num_updates = int(sd.get("num_updates", 0))

    def get_lr(self):
        return 0.0

    def clear_grad(self, set_to_zero=False):
        pass

    @torch.no_grad()
    def step(self):
        """Accumulate after the TRAINING optimizer stepped (call order in
        the reference: optimizer.step(); model_average.step())."""
        self._num_updates += 1
        self._num_accumulates += 1
        for i, p in enumerate(self._parameter_list):
            self._sum_1[i] += p.to(_F32)
        if self._num_updates % self._K_MAX_NUM_ACCUMULATES == 0:
            for i in range(len(self._sum_1)):
                self._sum_2[i] += self._sum_1[i]
                self._sum_1[i].zero_()
        # the reference kernel truncates the product to int64
        # (std::min<int64_t>(max_average_window, num_updates * rate))
        if (self._num_accumulates >= self.min_w
                and self._num_accumulates >= min(
                    self.max_w, int(self._num_updates * self.rate))):
            for i in range(len(self._sum_1)):
                self._sum_3[i] = self._sum_1[i] + self._sum_2[i]
                self._sum_1[i].zero_()
                self._sum_2[i].zero_()
            self._old_num_accumulates = self._num_accumulates
            self._num_accumulates = 0

    @torch.no_grad()
    def apply(self, need_restore=True):
        total = self._num_accumulates + self._old_num_accumulates
        if total <= 0:
            raise RuntimeError(
                "ModelAverage.apply() before any step(): the average is "
                "empty — it would zero every parameter")
        if need_restore:
            self._backup = [p.detach().clone() for p in self._parameter_list]
        for i, p in enumerate(self._parameter_list):
            avg = (self._sum_1[i] + self._sum_2[i] + self._sum_3[i]) / total
            p.copy_(avg.to(p.dtype))

    @torch.no_grad()
    def restore(self):
        if self._backup is None:
            return
        for p, b in zip(self._parameter_list, self._backup):
            p.copy_(b)
        self._backup = None


class LBFGS(Optimizer):
    """ref: python/paddle/optimizer/lbfgs.py — limited-memory BFGS with
    the two-loop recursion over flat fp32 vectors of every parameter
    (`history_size` pairs of them).  Eager only (`step(closure)`, the
    closure re-evaluating the loss and its gradients); the strong-Wolfe
    line search is a backtracking Armijo one, as in the JAX package
    (the reference's fallback for line_search_fn=None)."""

    def __init__(self, learning_rate=1.0, max_iter=20, history_size=10,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 parameters=None, line_search_fn=None, name=None):
        super().__init__(learning_rate=learning_rate,
                         parameters=list(parameters or []), name=name)
        self._parameter_list = self._parameters
        self.lr = learning_rate
        self.max_iter = max_iter
        self.m = history_size
        self.tol_g = tolerance_grad
        self.tol_x = tolerance_change
        self._s, self._y = [], []

    def get_lr(self):
        return self.lr

    def _flat(self, tensors):
        return torch.cat([t.reshape(-1).to(_F32) for t in tensors])

    @torch.no_grad()
    def _assign(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def step(self, closure):
        """closure() -> loss tensor, re-evaluating the model + backward."""
        loss = closure()
        with torch.no_grad():
            g = self._flat([p.grad for p in self._parameter_list])
            x = self._flat([p for p in self._parameter_list])
        for _ in range(self.max_iter):
            if float(torch.max(torch.abs(g))) <= self.tol_g:
                break
            with torch.no_grad():
                # two-loop recursion over the (s, y) history
                q = g
                alphas = []
                for s, y in zip(reversed(self._s), reversed(self._y)):
                    rho = 1.0 / (torch.dot(y, s) + 1e-10)
                    a = rho * torch.dot(s, q)
                    alphas.append((a, rho, s, y))
                    q = q - a * y
                if self._y:
                    y_last, s_last = self._y[-1], self._s[-1]
                    gamma = torch.dot(s_last, y_last) / (
                        torch.dot(y_last, y_last) + 1e-10)
                    q = q * gamma
                for a, rho, s, y in reversed(alphas):
                    b = rho * torch.dot(y, q)
                    q = q + s * (a - b)
                d = -q
                del q, alphas
            # backtracking Armijo line search
            t = self.lr
            f0 = float(loss.detach())
            gd = float(torch.dot(g, d))
            for _ls in range(20):
                self._assign(x + t * d)
                loss_new = closure()
                if float(loss_new.detach()) <= f0 + 1e-4 * t * gd:
                    break
                t *= 0.5
            with torch.no_grad():
                g_new = self._flat([p.grad for p in self._parameter_list])
                s_vec, y_vec = t * d, g_new - g
                if float(torch.dot(s_vec, y_vec)) > 1e-10:
                    self._s.append(s_vec)
                    self._y.append(y_vec)
                    if len(self._s) > self.m:
                        self._s.pop(0)
                        self._y.pop(0)
                x_new = x + t * d
                done = float(torch.max(torch.abs(x_new - x))) < self.tol_x
            x, g, loss = x_new, g_new, loss_new
            if done:
                break
        return loss
