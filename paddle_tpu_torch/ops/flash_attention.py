"""Flash attention (kernels K1 forward, K2 backward): the CUDA kernels'
wrappers, their plain PyTorch versions, their launch counters, and the
attention dispatch of the JAX package.

The port of `paddle_tpu/ops/pallas_attention.py` (`flash_mha`, the
Pallas kernels `_flash_fwd`, `_flash_bwd_resident` and `_flash_bwd`)
and `paddle_tpu/ops/flash_attention.py` (`flash_attention_xla`,
`scaled_dot_product_attention_raw`), on the JAX layout (B, S, H, D) with
GQA (H a multiple of the kv heads Hkv):

* `flash_fwd` (K1) -> (O, lse): O in q's dtype, lse (B, H, Sq) fp32;
* `flash_bwd_dq` / `flash_bwd_dkv` (K2) -> dQ / (dK, dV), the kv
  gradients summed over each kv head's group of query heads;
* `flash_mha` — the `torch.autograd.Function` whose forward is K1 and
  whose backward is K2.

On a CUDA tensor each wrapper launches `csrc/flash_attention.cu` (built
at first use, see `_build.py`) or raises, and adds one to its entry of
`LAUNCHES`; on a CPU tensor it runs the plain version
(`flash_fwd_plain`, `flash_bwd_plain`: the same arithmetic in fp32
einsums — q scaled before the product, masked entries -1e30, P kept in
fp32) and counts nothing.  The kernels take every S (they mask the
ragged last tile) and head_dim 32, 64 or 128; anything else raises.
Causal calls need Sq == Sk (both packages' kernels mask key c for query
r when r >= c, which is only the usual causal mask then).

Which kernel runs is `_variant(dtype, D)`, from the dtype and head_dim
alone:

* bf16 at head_dim 128 (every ported model: llama3-8b, Qwen-MoE) ->
  "wgmma": Hopper's warpgroup MMA fed by TMA, the scores in fp32, P and
  dS entering their products as two bf16 parts each (~16 mantissa bits);
* fp32, and bf16 at head_dim 32 or 64 -> "fma": the CUDA cores, all
  arithmetic in fp32.  TF32 would fail fp32's 1e-5 limit, so fp32 never
  runs on the tensor cores.

A caller may name the variant (`variant="fma"` on bf16 times the
CUDA-core kernel against the tensor-core one); a variant that does not
take the call raises `ValueError`.

Tolerances (kernel vs plain, on the card): O and dQ per (b, query row,
head), dK and dV per (b, key row, kv head), max|err| over head_dim
within tol x that row's max |plain|, with tol 2^-7 in bf16 (both round
an fp32 result, whose sums run in another order, to bf16 once: at most
one bf16 ulp apart) and 1e-5 in fp32; lse per element within 1e-5 x
max(1, |lse|) (fp32 in both).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_mha", "flash_fwd", "flash_bwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_fwd_plain", "flash_bwd_plain",
           "flash_attention_xla", "scaled_dot_product_attention_raw",
           "HEAD_DIMS", "NEG_INF", "LAUNCHES"]

NEG_INF = -1e30          # the Pallas kernels' mask fill
HEAD_DIMS = (32, 64, 128)
# launches of each kernel on CUDA tensors; CPU calls count nothing
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}

# the C interface's code of each kernel: (dtype, variant) -> code
KERNEL_CODES = {(torch.float32, "fma"): 0, (torch.bfloat16, "fma"): 1,
                (torch.bfloat16, "wgmma"): 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = (_I, _I, _I, _I, _I, _I, _I, _F, _I, _P)  # B H Hkv Sq Sk D causal scale kernel stream
_SIGNATURES = {
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _P) + _SHAPE,
    "flash_attention_dq": (_P, _P, _P, _P, _P, _P, _P, _P) + _SHAPE,
    "flash_attention_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P) + _SHAPE,
}


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _keep(Sq, Sk, causal, device):
    """(Sq, Sk) bool: which (query, key) pairs attend."""
    if not causal:
        return torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    r = torch.arange(Sq, device=device)[:, None]
    return r >= torch.arange(Sk, device=device)[None, :]


def _grouped(x, n_kv):
    """(B, S, H, D) -> fp32 (B, S, Hkv, rep, D): head h = g * rep + r."""
    B, S, H, D = x.shape
    return x.to(torch.float32).reshape(B, S, n_kv, H // n_kv, D)


def _probs(q, k, causal, scale, lse=None):
    """Scores (B, Hkv, rep, Sq, Sk) in fp32 of the scaled q against k,
    masked to NEG_INF, and the keep mask; with `lse` (B, H, Sq) the
    probabilities exp(s - lse) instead (masked -> 0)."""
    B, Sq, H, D = q.shape
    n_kv = k.shape[2]
    qs = _grouped(q, n_kv) * scale
    s = torch.einsum("bqgrd,bkgd->bgrqk", qs, k.to(torch.float32))
    keep = _keep(Sq, k.shape[1], causal, q.device)
    if lse is None:
        return torch.where(keep, s, NEG_INF), keep, qs
    lse = lse.reshape(B, n_kv, H // n_kv, Sq, 1)
    return torch.where(keep, torch.exp(s - lse), 0.0), keep, qs


def flash_fwd_plain(q, k, v, causal=True, scale=None):
    """K1 in plain PyTorch: (O (B, Sq, H, D) in q's dtype, lse (B, H, Sq)
    fp32) for q (B, Sq, H, D), k / v (B, Sk, Hkv, D)."""
    scale = _scale(q, scale)
    B, Sq, H, D = q.shape
    s, keep, _ = _probs(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(torch.float32))
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    return o.reshape(B, Sq, H, D).to(q.dtype), lse


def flash_bwd_plain(q, k, v, o, lse, do, causal=True, scale=None):
    """K2 in plain PyTorch: (dQ, dK, dV) in the dtypes of q, k, v from
    q, k, v, O, lse (B, H, Sq) and dO; dK / dV summed over each kv
    head's query heads."""
    scale = _scale(q, scale)
    B, Sq, H, D = q.shape
    n_kv = k.shape[2]
    p, _, qs = _probs(q, k, causal, scale, lse)
    dog = _grouped(do, n_kv)
    delta = (o.to(torch.float32) * do.to(torch.float32)).sum(-1)  # (B, Sq, H)
    delta = delta.reshape(B, Sq, n_kv, H // n_kv).permute(0, 2, 3, 1)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.to(torch.float32))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qs)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check(q, k, v, causal, extra=()):
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v one (B, Sk, "
                         f"Hkv, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q, k and v must share batch and head_dim")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of {HEAD_DIMS}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if causal and Sq != k.shape[1]:
        raise ValueError(f"causal attention needs Sq == Sk, got {Sq} "
                         f"and {k.shape[1]}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype}")
    vec = 16 // q.element_size()
    for t in (q, k, v) + tuple(extra):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("all inputs must share q's dtype and device")
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("the kernel reads rows as 16-byte vectors: "
                             "head_dim must be contiguous, the other "
                             f"strides multiples of {vec} elements and "
                             "the data 16-byte aligned")


def _variant(dtype, D, variant=None):
    """The kernel variant a CUDA call runs, from its dtype and head_dim
    D (see the module docstring), or `variant` where the caller names
    one; raises ValueError on a variant that does not take the call."""
    if variant is None:
        variant = "wgmma" if dtype == torch.bfloat16 and D == 128 else "fma"
    if (dtype, variant) not in KERNEL_CODES or D not in HEAD_DIMS or (
            variant == "wgmma" and D != 128):
        raise ValueError(f"flash attention: no {variant} kernel takes "
                         f"{dtype} at head_dim {D}")
    return variant


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _call(fn, tensors, strided, q, k, causal, scale, variant):
    B, Sq, H, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    code = KERNEL_CODES[(q.dtype, _variant(q.dtype, D, variant))]
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            *[t.data_ptr() for t in tensors], _strides(*strided),
            B, H, k.shape[2], Sq, k.shape[1], D, int(causal), float(scale),
            code, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed (cudaError {err})")


def flash_fwd(q, k, v, causal=True, scale=None, variant=None):
    """K1: (O, lse) as `flash_fwd_plain`.  A CUDA `q` launches the
    Hopper kernel `_variant` picks, or the named `variant` (counted in
    `LAUNCHES`); a CPU `q` runs the plain version."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    scale = _scale(q, scale)
    _check(q, k, v, causal)
    B, Sq, H, _ = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    _call("flash_attention_fwd", (q, k, v, o, lse), (q, k, v), q, k,
          causal, scale, variant)
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def _delta(o, do):
    """rowsum(O * dO) in fp32 as (B, H, Sq): the JAX package computes it
    outside the Pallas kernels too."""
    return (o.to(torch.float32) * do.to(torch.float32)).sum(-1) \
        .transpose(1, 2).contiguous()


def flash_bwd_dq(q, k, v, o, lse, do, causal=True, scale=None, delta=None,
                 variant=None):
    """K2, dQ.  A CUDA `q` launches the dQ kernel `_variant` picks, or
    the named `variant` (counted in `LAUNCHES`; `delta` is computed when
    not given); a CPU `q` runs the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale)[0]
    scale = _scale(q, scale)
    _check(q, k, v, causal, (do,))
    delta = _delta(o, do) if delta is None else delta
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _call("flash_attention_dq", (q, k, v, do, lse.contiguous(), delta, dq),
          (q, k, v, do), q, k, causal, scale, variant)
    LAUNCHES["flash_attention_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, o, lse, do, causal=True, scale=None, delta=None,
                  variant=None):
    """K2, (dK, dV).  A CUDA `q` launches the dK/dV kernel `_variant`
    picks, or the named `variant` (counted in `LAUNCHES`); a CPU `q` runs
    the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale)[1:]
    scale = _scale(q, scale)
    _check(q, k, v, causal, (do,))
    delta = _delta(o, do) if delta is None else delta
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _call("flash_attention_dkv",
          (q, k, v, do, lse.contiguous(), delta, dk, dv), (q, k, v, do),
          q, k, causal, scale, variant)
    LAUNCHES["flash_attention_dkv"] += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal=True, scale=None):
    """K2: (dQ, dK, dV) — the dQ and the dK/dV kernel on a CUDA `q`, one
    plain backward on a CPU `q`."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
    do = do.contiguous()
    delta = _delta(o, do)
    dq = flash_bwd_dq(q, k, v, o, lse, do, causal, scale, delta)
    dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, causal, scale, delta)
    return dq, dk, dv


class _FlashMHA(torch.autograd.Function):
    """Forward K1, backward K2; saves q, k, v (unexpanded), O and lse —
    the residuals of the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_mha(q, k, v, causal=True, scale=None):
    """Flash attention on (B, S, H, D) with GQA: K1 forward, K2
    backward on the card, their plain versions on the CPU."""
    return _FlashMHA.apply(q, k, v, causal, scale)


# --------------------------------------------------------------------------
# dispatch (ops/flash_attention.py of the JAX package)
# --------------------------------------------------------------------------

_DROPOUT = ("attention dropout is not ported yet (ROADMAP: queue 2, flash "
            "attention with mask and dropout)")


def scaled_dot_product_attention_raw(q, k, v, attn_mask=None,
                                     dropout_p=0.0, is_causal=False,
                                     scale=None):
    """Attention on (B, S, H, D) in plain PyTorch, as the JAX package
    writes it: fp32 logits and softmax, a bool mask selects and any
    other mask adds, the causal mask is aligned bottom-right.
    Probabilities are cast to v's dtype before P.V.  Dropout raises:
    the port has no RNG key to draw its mask from."""
    if dropout_p > 0.0:
        raise NotImplementedError(_DROPOUT)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = _scale(q, scale)
    qT, kT, vT = (x.transpose(1, 2) for x in (q, k, v))
    if kT.shape[1] != H:
        kT = kT.repeat_interleave(H // kT.shape[1], dim=1)
        vT = vT.repeat_interleave(H // vT.shape[1], dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qT.to(torch.float32),
                          kT.to(torch.float32)) * scale
    if is_causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device) \
            .tril(Sk - Sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(vT.dtype), vT)
    return out.transpose(1, 2)


def flash_attention_xla(query, key, value, attn_mask=None, dropout_p=0.0,
                        is_causal=False, training=True, scale=None):
    """The JAX package's attention dispatch: without a mask or dropout,
    `flash_mha` (K1/K2 on the card, their plain versions on the CPU);
    a mask runs `scaled_dot_product_attention_raw` on the CPU and raises
    on any other device, since K1/K2 take no mask; dropout in training
    raises, since the port has no global RNG to draw its key from."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(_DROPOUT)
    if attn_mask is None:
        return flash_mha(query, key, value, is_causal, scale)
    if query.device.type != "cpu":
        raise NotImplementedError(
            "attention with a mask runs only on the CPU: the flash kernels "
            "K1/K2 take no mask yet (ROADMAP: queue 2, flash attention "
            "with mask and dropout)")
    return scaled_dot_product_attention_raw(query, key, value, attn_mask,
                                            is_causal=is_causal, scale=scale)
