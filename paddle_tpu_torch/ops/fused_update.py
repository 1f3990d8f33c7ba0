"""The optimizer update as two multi-tensor kernels (U1 reduce, U2
update): their wrapper, their plain PyTorch versions and their launch
counters.

The port's counterpart of the update inside the JAX step's jitted,
donated program (`paddle_tpu/jit/trainer.py:327-328`), where XLA fuses
`paddle_tpu/optimizer/optimizer.py::functional_update` (Adam / AdamW),
`paddle_tpu/nn/clip.py::ClipGradByGlobalNorm._clip_arrays` and the loss
scaler's unscale and `found_inf` reduction (`trainer.py:278-309`).  No
Pallas kernel computes it; `csrc/optimizer_update.cu` says what the two
kernels do and what bounds them.

`fused_update(params, grads, moment1, moment2, ...)` takes lists of
tensors, one entry per parameter, and updates params and moments in
place:

* U1 (only with a clip or a loss scale): global_norm = sqrt(sum over
  every gradient of (g * inv_scale)^2), summed in fp64 and rounded to
  fp32 before the sqrt, clip_scale = clip_norm /
  max(global_norm, clip_norm), inv_scale = 1 / scale and found_inf (a
  non-finite unscaled gradient), all on the device;
* U2: per element, g <- g * inv_scale, g <- g * clip_scale, Adam's L2
  term g + wd * p (when the decay is not decoupled), the moments, the
  bias corrections, p - lr * m_hat / (sqrt(v_hat) + eps), and AdamW's
  decoupled decay - lr * wd * p_old.  With a loss scale and found_inf
  set, params and moments stay bitwise unchanged.

Every term is rounded to the dtype the JAX rule computes it in (the
gradient's at the unscale, the clip and the L2 term; the moments' at
each Adam term; the parameter's at the update), as the per-parameter
rule `Adam.update_rule` does op by op: the kernel keeps the values in
fp32 registers and rounds them there, so the rounding moves no bytes.  A
gradient of None (a parameter the loss does not reach) is a zero
gradient, as the JAX step's AD gives it: its moments decay, the L2 term
and the decoupled decay still apply, it adds 0 to the norm, and the
kernels read no gradient memory for it.

On CUDA tensors `fused_update` launches U1 and U2 (built at first use,
see `_build.py`) or raises, and adds one to their entries of `LAUNCHES`
per launch; on CPU tensors it runs `fused_update_plain` (`reduce_plain`
then `update_plain`, the same arithmetic in torch ops) and counts
nothing.  Params fp32 or bf16; each gradient in its param's dtype;
moments in the param's dtype or fp32 (`multi_precision`); every tensor
contiguous (a non-contiguous one raises: nothing is copied).

Tolerances (kernel vs plain, on the card): U1's global norm within 1e-6
relative (the plain version sums in fp32 in another order); U2 given U1's scalars
within one ulp of the plain value's dtype per element of p, m and v, in
fp32 and bf16 (bitwise expected: the same rounded operations in the same
order).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["fused_update", "fused_update_plain", "reduce_plain",
           "update_plain", "adam_constants", "CHUNK", "LAUNCHES"]

CHUNK = 16384             # elements per chunk (kChunk in the .cu)
REDUCE_BLOCKS = 1024      # U1's partials (kReduceBlocks in the .cu)
# launches of each kernel on CUDA tensors; CPU calls count nothing
LAUNCHES = {"optimizer_reduce": 0, "optimizer_update": 0}

_F32, _BF16 = torch.float32, torch.bfloat16
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "optim_u1_reduce": (_P, _L, _P, _F, _I, _P, _P, _P, _P, _P),
    "optim_u2_update": (_P, _L, _P, _I, _P, _P, _I, _I, _P),
}
_TERMS = ("b1", "omb1", "b2", "omb2", "bc1", "bc2", "eps", "wd")


def _weak(value: float, dtype) -> float:
    """A Python constant as JAX applies it to a `dtype` tensor: rounded
    to that dtype first."""
    return torch.tensor(value, dtype=dtype).item()


def adam_constants(beta1, beta2, eps, weight_decay, step):
    """{dtype: {term: value}} for fp32 and bf16: each Adam constant
    rounded to the dtype it meets in the JAX rule (`wd` for Adam's L2
    term meets the gradient, the others the moments); the bias
    corrections computed in float64 on the host first."""
    raw = {"b1": beta1, "omb1": 1 - beta1, "b2": beta2, "omb2": 1 - beta2,
           "bc1": 1 - beta1 ** step, "bc2": 1 - beta2 ** step, "eps": eps,
           "wd": weight_decay}
    return {dt: {k: _weak(v, dt) for k, v in raw.items()}
            for dt in (_F32, _BF16)}


def _rnd(x, dtype):
    """fp32 `x` rounded to `dtype` and back: where the JAX rule stores a
    term in `dtype`."""
    return x if dtype == _F32 else x.to(dtype).to(_F32)


def _check(params, grads, moment1, moment2):
    """Raises on what the kernels do not take (on either device)."""
    if not len(params) == len(grads) == len(moment1) == len(moment2):
        raise ValueError("fused_update: params, grads and moments must "
                         "have one entry per parameter")
    for i, (p, g, m, v) in enumerate(zip(params, grads, moment1, moment2)):
        if p.dtype not in (_F32, _BF16):
            raise ValueError(f"fused_update: parameter {i} is {p.dtype}; "
                             f"the update takes fp32 or bf16")
        if g is not None and (g.dtype != p.dtype or g.shape != p.shape):
            raise ValueError(f"fused_update: gradient {i} is {g.dtype} "
                             f"{tuple(g.shape)}, its parameter {p.dtype} "
                             f"{tuple(p.shape)}")
        if m.dtype != v.dtype or m.dtype not in (p.dtype, _F32) \
                or m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"fused_update: moments {i} are {m.dtype} / "
                             f"{v.dtype}; they take the parameter's shape "
                             f"and its dtype or fp32")
        for t in (p, g, m, v):
            if t is not None and not t.is_contiguous():
                raise ValueError(f"fused_update: tensor {i} is not "
                                 f"contiguous (the update writes in place "
                                 f"and copies nothing)")


def reduce_plain(grads, scale=None, clip_norm=None):
    """U1 in plain PyTorch: {"global_norm", "clip_scale", "inv_scale",
    "found_inf"} as 0-dim tensors; clip_scale None without `clip_norm`,
    inv_scale and found_inf None without `scale` (a 0-dim fp32 loss
    scale)."""
    inv = found = None
    if scale is not None:
        inv = 1.0 / scale.to(_F32)
        found = torch.zeros((), dtype=torch.bool, device=scale.device)
    sq = []
    for g in grads:
        if g is None:
            continue
        x = g.to(_F32)
        if inv is not None:
            x = _rnd(x * inv, g.dtype)
            found = found | ~torch.isfinite(x).all()
        sq.append(torch.sum(torch.square(x)))
    norm = torch.sqrt(sum(sq)) if sq else torch.zeros(())
    clip = None
    if clip_norm is not None:
        clip = float(clip_norm) / torch.clamp_min(norm, float(clip_norm))
    return {"global_norm": norm, "clip_scale": clip, "inv_scale": inv,
            "found_inf": found}


def update_plain(params, grads, moment1, moment2, *, lr, beta1, beta2, eps,
                 weight_decay, decoupled, step, clip_scale=None,
                 inv_scale=None, found_inf=None):
    """U2 in plain PyTorch, in place: every term in fp32 torch ops,
    rounded to its JAX dtype (`_rnd`) where the JAX rule stores it;
    `clip_scale`, `inv_scale` (0-dim fp32) and `found_inf` (0-dim bool:
    keep every tensor as it is) as U1 gives them."""
    consts = adam_constants(beta1, beta2, eps, weight_decay, step)
    lr32 = float(np.float32(lr))
    lr_wd = float(np.float32(lr) * np.float32(weight_decay)) \
        if decoupled else 0.0
    l2 = bool(weight_decay) and not decoupled
    for p, g, m, v in zip(params, grads, moment1, moment2):
        pd, md = p.dtype, m.dtype
        c = consts[md]
        # divisors as device tensors: a CUDA division by a host scalar
        # multiplies by its reciprocal instead
        bc1, bc2 = (torch.tensor(c[k], device=p.device) for k in ("bc1",
                                                                 "bc2"))
        pf = p.to(_F32)
        x = g.to(_F32) if g is not None else torch.zeros_like(pf)
        if inv_scale is not None:
            x = _rnd(x * inv_scale, pd)
        if clip_scale is not None:
            x = _rnd(x * clip_scale, pd)
        if l2:
            x = _rnd(x + _rnd(consts[pd]["wd"] * pf, pd), pd)
        mf = _rnd(_rnd(c["b1"] * m.to(_F32), md) + _rnd(c["omb1"] * x, md),
                  md)
        vf = _rnd(_rnd(c["b2"] * v.to(_F32), md)
                  + _rnd(c["omb2"] * _rnd(x * x, md), md), md)
        del x
        den = _rnd(_rnd(torch.sqrt(_rnd(vf / bc2, md)), md) + c["eps"], md)
        upd = _rnd(mf / bc1, md) * lr32 / den
        del den
        new = _rnd(pf - _rnd(upd, pd), pd)
        del upd
        if lr_wd:
            new = new - lr_wd * pf
        del pf
        if found_inf is not None:
            new = torch.where(found_inf, p, new.to(pd))
            mf = torch.where(found_inf, m, mf.to(md))
            vf = torch.where(found_inf, v, vf.to(md))
        p.copy_(new)
        m.copy_(mf)
        v.copy_(vf)


def fused_update_plain(params, grads, moment1, moment2, *, lr, beta1,
                       beta2, eps, weight_decay, decoupled, step,
                       clip_norm=None, scale=None):
    """`fused_update` in plain PyTorch: `reduce_plain` (when there is a
    clip or a loss scale), then `update_plain`."""
    _check(params, grads, moment1, moment2)
    out = dict.fromkeys(("global_norm", "clip_scale", "inv_scale",
                         "found_inf"))
    if clip_norm is not None or scale is not None:
        out = reduce_plain(grads, scale, clip_norm)
    update_plain(params, grads, moment1, moment2, lr=lr, beta1=beta1,
                 beta2=beta2, eps=eps, weight_decay=weight_decay,
                 decoupled=decoupled, step=step,
                 **{k: out[k] for k in ("clip_scale", "inv_scale",
                                        "found_inf")})
    return out


def _table(params, grads, moment1, moment2):
    """The record table on the device (one small copy on the current
    stream from pinned memory, which the caching host allocator keeps
    until the copy has run), the chunk count and U1's need of it."""
    rows, chunk = [], 0
    dev = params[0].device
    for p, g, m, v in zip(params, grads, moment1, moment2):
        ts = [t for t in (p, g, m, v) if t is not None]
        if any(t.device != dev for t in ts):
            raise ValueError("fused_update: tensors on different devices")
        vec = all(t.data_ptr() % 16 == 0 for t in ts)
        flags = (int(p.dtype == _BF16) | int(m.dtype == _BF16) << 1
                 | int(g is not None) << 2 | int(vec) << 3)
        rows.append((p.data_ptr(), 0 if g is None else g.data_ptr(),
                     m.data_ptr(), v.data_ptr(), p.numel(), chunk, flags, 0))
        chunk += -(-p.numel() // CHUNK)
    rows.append((0, 0, 0, 0, 0, chunk, 0, 0))        # sentinel
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(dev, non_blocking=True), chunk


def _call(fn, device, *args):
    lib = _build.load("optimizer_update", _SIGNATURES)
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(
            device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed (cudaError {err})")


def _reduce(dev, table, chunks, scale, clip_norm):
    """U1 over the record table: {"global_norm", "clip_scale",
    "inv_scale", "found_inf"}, 0-dim views of its outputs on the
    device."""
    partial = torch.empty(REDUCE_BLOCKS, dtype=torch.float64, device=dev)
    nonfinite = torch.empty(REDUCE_BLOCKS, dtype=torch.int32, device=dev)
    state = torch.empty(3, dtype=_F32, device=dev)
    found = torch.empty((), dtype=torch.bool, device=dev)
    _call("optim_u1_reduce", dev, table.data_ptr(), chunks,
          None if scale is None else scale.data_ptr(),
          float(clip_norm or 0.0), int(clip_norm is not None),
          partial.data_ptr(), nonfinite.data_ptr(), state.data_ptr(),
          found.data_ptr())
    LAUNCHES["optimizer_reduce"] += 1
    return {"global_norm": state[0], "clip_scale": state[1],
            "inv_scale": state[2], "found_inf": found}


def _update(dev, table, chunks, reduced, *, lr, beta1, beta2, eps,
            weight_decay, decoupled, step, use_clip, use_scale):
    """U2 over the record table, reading U1's outputs (`reduced`, None
    without a clip and a loss scale)."""
    consts = adam_constants(beta1, beta2, eps, weight_decay, step)
    lr_wd = float(np.float32(lr) * np.float32(weight_decay)) \
        if decoupled else 0.0
    flat = [consts[dt][k] for k in _TERMS for dt in (_F32, _BF16)]
    host = (ctypes.c_float * 18)(*flat, float(np.float32(lr)), lr_wd)
    _call("optim_u2_update", dev, table.data_ptr(), chunks, host,
          int(bool(weight_decay) and not decoupled),
          None if reduced is None else reduced["global_norm"].data_ptr(),
          None if reduced is None else reduced["found_inf"].data_ptr(),
          int(use_scale), int(use_clip))
    LAUNCHES["optimizer_update"] += 1


def fused_update(params, grads, moment1, moment2, *, lr, beta1, beta2, eps,
                 weight_decay, decoupled, step, clip_norm=None, scale=None):
    """Adam (`decoupled=False`: L2 decay in the gradient) or AdamW
    (`decoupled=True`) over lists of tensors, in place, with an optional
    global-norm clip (`clip_norm`) and loss scale (`scale`, a 0-dim fp32
    tensor on the params' device); lr and step are host numbers.
    Returns {"global_norm", "clip_scale", "inv_scale", "found_inf"}:
    0-dim tensors on the device, None where not computed.  CUDA tensors
    launch U1 (with a clip or a scale) and U2, counted in `LAUNCHES`;
    CPU tensors run `fused_update_plain`."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, decoupled=decoupled, step=step)
    out = dict.fromkeys(("global_norm", "clip_scale", "inv_scale",
                         "found_inf"))
    if not params:
        return out
    dev = params[0].device
    if dev.type == "cpu":
        return fused_update_plain(params, grads, moment1, moment2,
                                  clip_norm=clip_norm, scale=scale, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_update runs on cuda or cpu, not {dev}")
    _check(params, grads, moment1, moment2)
    if scale is not None and (scale.device != dev or scale.dtype != _F32
                              or scale.numel() != 1):
        raise ValueError("fused_update: the loss scale must be one fp32 "
                         "value on the params' device")
    table, chunks = _table(params, grads, moment1, moment2)
    if not chunks:
        raise ValueError("fused_update: the parameters hold no elements")
    reduced = None
    if clip_norm is not None or scale is not None:
        reduced = _reduce(dev, table, chunks, scale, clip_norm)
        out = {"global_norm": reduced["global_norm"],
               "clip_scale": reduced["clip_scale"] if clip_norm is not None
               else None,
               "inv_scale": reduced["inv_scale"] if scale is not None
               else None,
               "found_inf": reduced["found_inf"] if scale is not None
               else None}
    _update(dev, table, chunks, reduced, use_clip=clip_norm is not None,
            use_scale=scale is not None, **kw)
    return out
