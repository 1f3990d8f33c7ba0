"""Fused softmax cross-entropy (kernels K3f forward, K3b backward): the
CUDA kernels' wrappers, their plain PyTorch versions and their launch
counters.

The port of `paddle_tpu/ops/pallas_ce.py` (`softmax_xent_pallas`, the
Pallas kernels `_run_fwd` and `_run_bwd`): per row of logits (..., V)
and an int label, loss = logsumexp(row) - row[label] in fp32, and on the
way back dlogits = (softmax(row) - onehot(label)) * g in the logits'
dtype, recomputed from the saved per-row lse.  A negative label marks a
row to ignore: loss 0, gradient 0 (the causal-LM loss drops each
sequence's last position that way, see `models/llama.py`).

On a CUDA tensor `softmax_xent_fwd` / `softmax_xent_bwd` launch
`csrc/softmax_xent.cu` (built at first use, see `_build.py`) or raise,
and add one to their entries of `LAUNCHES`; on a CPU tensor they run
`softmax_xent_plain` / `softmax_xent_bwd_plain` and count nothing.
A label >= V gives its row a NaN loss and no one-hot term in the
gradient, on either device, as the JAX package's formula does (its
gather fills NaN past the vocabulary).  `softmax_xent` is the
`torch.autograd.Function` over the two.

Tolerances (kernel vs plain, on the card): loss and lse within 1e-5 x
max(1, |lse|) per row (fp32 sums in another order); dlogits per
element within tol x |plain|, tol 2^-7 in bf16 (both round the same
fp32 value once: at most one bf16 ulp apart) and 1e-6 in fp32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["softmax_xent", "softmax_xent_fwd", "softmax_xent_bwd",
           "softmax_xent_plain", "softmax_xent_bwd_plain", "LAUNCHES"]

# launches of each kernel on CUDA tensors; CPU calls count nothing
LAUNCHES = {"softmax_xent_fwd": 0, "softmax_xent_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "softmax_xent_fwd": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    "softmax_xent_bwd": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
}


def _label_index(labels, V):
    """(labels clamped into [0, V) as a gather index, whether each label
    is < V)."""
    return labels.clamp(0, V - 1).long()[..., None], labels < V


def softmax_xent_plain(logits, labels):
    """K3f in plain PyTorch: (loss, lse), fp32, shaped like `labels`;
    both 0 on rows whose label is negative, loss NaN where it is >= V."""
    x = logits.to(torch.float32)
    lse = torch.logsumexp(x, dim=-1)
    keep = labels >= 0
    idx, inside = _label_index(labels, x.shape[-1])
    picked = torch.where(inside, torch.gather(x, -1, idx)[..., 0],
                         float("nan"))
    return (torch.where(keep, lse - picked, 0.0),
            torch.where(keep, lse, 0.0))


def softmax_xent_bwd_plain(logits, labels, lse, g):
    """K3b in plain PyTorch: (exp(logits - lse) - onehot(label)) * g in
    the logits' dtype, zero rows where the label is negative (no
    one-hot term where it is >= V)."""
    keep = (labels >= 0)[..., None]
    d = torch.exp(logits.to(torch.float32) - lse[..., None])
    idx, inside = _label_index(labels, d.shape[-1])
    d.scatter_add_(-1, idx, torch.where(inside, -1.0, 0.0)[..., None])
    d = d * g.to(torch.float32)[..., None]
    return torch.where(keep, d, 0.0).to(logits.dtype)


def _rows(logits, labels):
    """(R, V) view of the logits and (R,) int32 labels; raises on what
    the kernel does not take."""
    if logits.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported logits dtype {logits.dtype}")
    if labels.shape != logits.shape[:-1] or labels.device != logits.device:
        raise ValueError(f"labels {tuple(labels.shape)} must be the "
                         f"logits' {tuple(logits.shape)} without the last "
                         f"dim, on the same device")
    V = logits.shape[-1]
    try:
        x = logits.view(-1, V)
    except RuntimeError as e:
        raise ValueError("the logits' rows must be one strided (R, V) "
                         "view") from e
    if x.stride(1) != 1:
        raise ValueError("the vocabulary dim must be contiguous")
    return x, labels.reshape(-1).to(torch.int32)


def _vec(x, *others):
    """16-byte vectors when V, the row stride and every pointer allow."""
    vec = 16 // x.element_size()
    ok = x.shape[1] % vec == 0 and x.stride(0) % vec == 0 \
        and all(t.data_ptr() % 16 == 0 for t in (x,) + others)
    return vec if ok else 1


def _call(fn, device, *args):
    lib = _build.load("softmax_xent", _SIGNATURES)
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(
            device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed (cudaError {err})")


def softmax_xent_fwd(logits, labels):
    """K3f: (loss, lse) as `softmax_xent_plain`.  CUDA logits launch
    the Hopper kernel (counted in `LAUNCHES`); CPU logits run the plain
    version."""
    if logits.device.type == "cpu":
        return softmax_xent_plain(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(f"softmax_xent runs on cuda or cpu, not "
                         f"{logits.device}")
    x, lab = _rows(logits, labels)
    R, V = x.shape
    loss = torch.empty(R, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    _call("softmax_xent_fwd", x.device, x.data_ptr(), lab.data_ptr(),
          loss.data_ptr(), lse.data_ptr(), x.stride(0), R, V,
          _DTYPE_CODE[x.dtype], _vec(x))
    LAUNCHES["softmax_xent_fwd"] += 1
    return loss.view(labels.shape), lse.view(labels.shape)


def softmax_xent_bwd(logits, labels, lse, g):
    """K3b: dlogits as `softmax_xent_bwd_plain`, contiguous in the
    logits' shape.  CUDA logits launch the Hopper kernel (counted in
    `LAUNCHES`); CPU logits run the plain version."""
    if logits.device.type == "cpu":
        return softmax_xent_bwd_plain(logits, labels, lse, g)
    if logits.device.type != "cuda":
        raise ValueError(f"softmax_xent runs on cuda or cpu, not "
                         f"{logits.device}")
    x, lab = _rows(logits, labels)
    R, V = x.shape
    lse = lse.reshape(R).to(torch.float32).contiguous()
    g = g.reshape(R).to(torch.float32).contiguous()
    dx = torch.empty(logits.shape, dtype=logits.dtype, device=x.device)
    _call("softmax_xent_bwd", x.device, x.data_ptr(), lab.data_ptr(),
          lse.data_ptr(), g.data_ptr(), dx.data_ptr(), x.stride(0), R, V,
          _DTYPE_CODE[x.dtype], _vec(x, dx))
    LAUNCHES["softmax_xent_bwd"] += 1
    return dx


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = softmax_xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return softmax_xent_bwd(logits, labels, lse, g), None


def softmax_xent(logits, labels):
    """Per-row softmax cross-entropy (fp32, shaped like `labels`) of
    logits (..., V): K3f forward and K3b backward on the card, their
    plain versions on the CPU.  Rows with a negative label are ignored."""
    return _SoftmaxXent.apply(logits, labels)
