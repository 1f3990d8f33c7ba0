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

On a CUDA tensor each wrapper launches `csrc/flash_attention.cu`, or
with a bias or dropout `csrc/flash_attention_mma.cu` (bf16:
`flash_attention_mma_bf16.cu`, fp16: `flash_attention_mma_fp16.cu`; the
kernels in `flash_attention_mma.cuh`;
`variant="fma"` there: `csrc/flash_attention_extra.cu`; each built at
first use, see `_build.py`), or raises, and adds one to its entry of
`LAUNCHES` and of `VARIANT_LAUNCHES[variant]` (under a lock: predictors
on several threads launch K1 at once); on a CPU tensor it runs the plain
version (`flash_fwd_plain`, `flash_bwd_plain`: the same arithmetic in
fp32 einsums — q scaled before the product, masked entries -inf, P kept
in fp32) and counts nothing.  The kernels take every S (they mask the
ragged last tile) and head_dim 16, 32, 64 or 128; anything else raises.

K1 is the operator `paddle_tpu_torch::flash_fwd` (`torch.library`):
its CUDA kernel is the launch above, its CPU kernel the plain version,
and a fake kernel gives the shapes, so that `torch.export` (the port's
`jit.save`) keeps K1 as one node of the program and eager training,
prefill and a saved program run the same path.  The operator returns
O, lse and lse's low part (empty without a bias or dropout), and takes
dropout's 64-bit seed as two 32-bit words (an operator's int is a signed
int64).  K2 stays a direct launch: a saved inference program has no
backward.

The causal mask is aligned bottom-right, as the JAX package's
`scaled_dot_product_attention_raw` aligns it (`tril(k = Sk - Sq)`):
query r sees key c when r + Sk - Sq >= c, which is the usual mask when
Sq == Sk.  When Sq > Sk, the rows r < Sq - Sk see no key: there the
reference's softmax over nothing gives NaN, and the forward returns
O = NaN and lse = -inf.  The backward treats such rows as contributing
nothing (dQ = 0 there, dK / dV untouched), where the reference's
gradient is NaN throughout.

An additive bias and dropout (`bias=`, `dropout=`), the semantics of
`scaled_dot_product_attention_raw` with a mask and dropout:

* the bias is fp32 whatever q's dtype (the JAX package adds it to the
  fp32 scores), any shape that broadcasts to (B, H, Sq, Sk), read
  through its strides (0 on a broadcast axis: (B, 1, 1, Sk) is never
  expanded); it is added to the scaled scores before the row maximum;
  `flash_mha` turns a bool mask into 0 / -inf.  A finite bias is a
  score like any other, however negative: a row whose every key is
  padded with finfo.min gets the reference's uniform softmax.  A row
  whose every score is -inf gives O = NaN and lse = -inf, and nothing
  to the gradients, as the causal rows above.  lse goes out as hi + lo
  (TwoSum; lo comes back third from `flash_fwd(..., return_lo=True)`,
  and `flash_mha` keeps it for the backward's `lse_lo`): where a bias
  puts a row's max far below 0, hi = m + log l has lost log l, and the
  backward recomputes P = exp((s - hi) - lo).  The bias takes no
  gradient: one that requires it raises `ValueError`;
* dropout `(p, seed, offset)` keeps the softmax's lse and row sum
  without dropout and accumulates P * z / (1 - p) into O, z the keep
  bit (the JAX order: softmax, then mask and rescale, then P.V); the
  backward recomputes P from lse and the bias, regenerates z, and takes
  dV = (P z / (1 - p))^T dO, dP = (dO V^T) z / (1 - p),
  dS = P (dP - delta) with delta = rowsum(dO * O).

The keep bits come from Philox4x32-10 (Random123), written once into
the .cu file and once here (`philox4x32`), so that the plain versions
draw the kernels' mask bit for bit.  For the element (b, h, i, c)
(query head h, query row i, key column c):

    key      (seed & 0xffffffff, seed >> 32)
    counter  (16 * (c // 64) + c % 16, i, b * H + h, offset)
    word     (c // 16) % 4 of the four the counter gives
    kept     word >= floor(p * 2^32)

so one Philox call gives one kernel thread the four columns c % 16 +
16 j (j = 0..3) of a 64-key tile it owns (`dropout_keep`).
`dropout_seed` draws (seed, offset) from a `torch.Generator` on the
host, reading nothing from the card.

Which kernel runs is `_variant(dtype, D, variant, extra)`, from the
dtype, the head_dim and whether the call has a bias or dropout:

* every call with a bias or dropout -> "mma", whatever the dtype and
  head_dim: `mma.sync` on the tensor cores, fp32 as three TF32 products
  (x = big + small, a.b = big.small + small.big + big.big, where one
  TF32 product would fail fp32's 1e-5 limit; dP summed on the CUDA cores
  in the plain version's order), bf16 with P and dS as two bf16 parts,
  fp16 likewise with two fp16 parts (fp16 exists only here: an fp16 call
  without a bias or dropout raises, as no other variant takes it);
  naming `variant="wgmma"` for such a call raises `ValueError`, and
  `variant="fma"` runs the CUDA-core kernels built with the bias /
  dropout code (the earlier route, kept as a yardstick);
* without either, bf16 at head_dim 128 (every ported model: llama3-8b,
  Qwen-MoE) -> "wgmma": Hopper's warpgroup MMA fed by TMA, the scores in
  fp32, P and dS entering their products as two bf16 parts each (~16
  mantissa bits);
* without either, fp32, and bf16 at head_dim 16, 32 or 64 -> "fma": the
  CUDA cores, all arithmetic in fp32.  Naming "mma" for such a call
  raises `ValueError`: those calls keep the kernels built without the
  bias / dropout code.

A caller may name the variant (`variant="fma"` on bf16 times the
CUDA-core kernel against the tensor-core one); a variant that does not
take the call raises `ValueError`.

Tolerances (kernel vs plain, on the card): O and dQ per (b, query row,
head), dK and dV per (b, key row, kv head), max|err| over head_dim
within tol x that row's max |plain|, with tol 2^-7 in bf16 (both round
an fp32 result, whose sums run in another order, to bf16 once: at most
one bf16 ulp apart), 2^-10 in fp16 (one fp16 ulp) and 1e-5 in fp32;
lse per element within 1e-5 x max(1, |lse|) (fp32 in both).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..amp import autocast_args
from . import _build

__all__ = ["flash_mha", "flash_fwd", "flash_bwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_fwd_plain", "flash_bwd_plain",
           "flash_attention_xla", "scaled_dot_product_attention_raw",
           "philox4x32", "dropout_keep", "dropout_seed", "HEAD_DIMS",
           "NEG_INF", "LAUNCHES", "VARIANT_LAUNCHES"]

NEG_INF = -1e30          # the Pallas kernels' mask fill (K1/K2 without a bias)
HEAD_DIMS = (16, 32, 64, 128)
# launches of each kernel on CUDA tensors; CPU calls count nothing
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}
# the same launches by the variant that ran them
VARIANT_LAUNCHES = {variant: dict.fromkeys(LAUNCHES, 0)
                    for variant in ("wgmma", "fma", "mma")}
# guards both counts: predictors on several threads launch K1 at once
_COUNT_LOCK = threading.Lock()

# the C interface's code of each kernel: (dtype, variant) -> code
KERNEL_CODES = {(torch.float32, "fma"): 0, (torch.bfloat16, "fma"): 1,
                (torch.bfloat16, "wgmma"): 2, (torch.float32, "mma"): 3,
                (torch.bfloat16, "mma"): 4, (torch.float16, "mma"): 5}
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint32
_SHAPE = (_I, _I, _I, _I, _I, _I, _I, _F, _I, _P)  # B H Hkv Sq Sk D causal scale kernel stream
# bias, its 4 strides, seed low / high words, offset, threshold, 1 / (1 - p),
# lse_lo
_EXTRA = (_P, _P, _U, _U, _U, _U, _F, _P)
_SIGNATURES = {
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _P) + _SHAPE + _EXTRA,
    "flash_attention_dq": (_P, _P, _P, _P, _P, _P, _P, _P) + _SHAPE + _EXTRA,
    "flash_attention_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P) + _SHAPE
    + _EXTRA,
}

# --------------------------------------------------------------------------
# the random bits of dropout: Philox4x32-10
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and uint32
    values x held in int64 (or Python ints): x is split in 16-bit halves
    so no product leaves int64."""
    pl, ph = m * (x & 0xFFFF), m * (x >> 16)
    return (ph + (pl >> 16)) >> 16, (pl + ((ph & 0xFFFF) << 16)) & _M32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key
    (k0, k1): uint32 words as int64 tensors (broadcast together) or
    Python ints; returns the four output words the same way."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _threshold(p):
    """floor(p * 2^32): a word below it drops its element."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout probability must be in [0, 1), got {p}")
    return int(p * 2.0 ** 32)


def _keep_scale(p):
    """1 / (1 - p) in fp32, as the kernels multiply by it."""
    return float(torch.tensor(1.0 / (1.0 - p), dtype=torch.float32))


def dropout_keep(B, H, Sq, Sk, p, seed, offset, device):
    """The keep mask (B, H, Sq, Sk) bool of attention dropout at
    probability p from (seed, offset), bit for bit the kernels' (the
    layout in the module docstring)."""
    thr = _threshold(p)
    i64 = dict(dtype=torch.int64, device=device)
    n0 = 16 * ((Sk + 63) // 64)
    words = philox4x32(torch.arange(n0, **i64)[None, None, :],
                       torch.arange(Sq, **i64)[None, :, None],
                       torch.arange(B * H, **i64)[:, None, None],
                       int(offset) & _M32, int(seed) & _M32,
                       (int(seed) >> 32) & _M32)
    w = torch.stack(torch.broadcast_tensors(*words), -1)   # (BH, Sq, n0, 4)
    c = torch.arange(Sk, **i64)
    bits = w[:, :, 16 * (c >> 6) + (c & 15), (c >> 4) & 3]
    return (bits >= thr).reshape(B, H, Sq, Sk)


def dropout_seed(generator):
    """(seed, offset) of one attention-dropout draw from `generator`,
    read and advanced on the host (nothing is read from the card).  A
    CUDA generator gives its seed and offset = its Philox offset / 4 + 1
    (never 0, so these counters never meet the ones torch's own kernels
    draw from the same generator, whose fourth word is 0), and its
    offset moves on by 4; a CPU generator draws both words with
    `torch.randint`."""
    if generator.device.type == "cpu":
        lo, hi, off = torch.randint(0, 2 ** 32, (3,),
                                    generator=generator).tolist()
        return lo | (hi << 32), off
    off = generator.get_offset()
    generator.set_offset(off + 4)
    return generator.initial_seed(), ((off >> 2) + 1) & _M32


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _keep(Sq, Sk, causal, device):
    """(Sq, Sk) bool: which (query, key) pairs attend; causal aligned
    bottom-right (query r sees key c when r + Sk - Sq >= c)."""
    if not causal:
        return torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    r = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    return r >= torch.arange(Sk, device=device)[None, :]


def _grouped(x, n_kv):
    """(B, S, H, D) -> fp32 (B, S, Hkv, rep, D): head h = g * rep + r."""
    B, S, H, D = x.shape
    return x.to(torch.float32).reshape(B, S, n_kv, H // n_kv, D)


def _bias4(bias, q, k):
    """The fp32 bias as a (B, H, Sq, Sk) view (stride 0 on the axes it
    broadcasts), or None."""
    if bias is None:
        return None
    if bias.dtype != torch.float32:
        raise ValueError(f"the attention bias must be fp32, got "
                         f"{bias.dtype} (flash_mha turns a bool mask into "
                         f"one)")
    B, Sq, H, _ = q.shape
    return bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape)) \
        .expand(B, H, Sq, k.shape[1])


def _dropout(dropout):
    """(p, seed, offset), or None for no dropout."""
    if dropout is None or dropout[0] == 0.0:
        return None
    _threshold(dropout[0])
    return tuple(dropout)


def _z(q, k, dropout):
    """The keep mask grouped as (B, Hkv, rep, Sq, Sk), or None."""
    if dropout is None:
        return None
    B, Sq, H, _ = q.shape
    n_kv = k.shape[2]
    z = dropout_keep(B, H, Sq, k.shape[1], *dropout, q.device)
    return z.reshape(B, n_kv, H // n_kv, Sq, k.shape[1])


def _probs(q, k, causal, scale, lse=None, bias=None, lse_lo=None):
    """Scores (B, Hkv, rep, Sq, Sk) in fp32 of the scaled q against k,
    plus the bias, masked to -inf, and the keep mask; with `lse`
    (B, H, Sq) the probabilities exp((s - lse) - lse_lo) instead
    (masked, and rows with lse -inf, -> 0)."""
    B, Sq, H, D = q.shape
    n_kv = k.shape[2]
    qs = _grouped(q, n_kv) * scale
    s = torch.einsum("bqgrd,bkgd->bgrqk", qs, k.to(torch.float32))
    if bias is not None:
        s = s + _bias4(bias, q, k).reshape(B, n_kv, H // n_kv, Sq, -1)
    keep = _keep(Sq, k.shape[1], causal, q.device)
    if lse is None:
        return torch.where(keep, s, -math.inf), keep, qs
    lse = lse.reshape(B, n_kv, H // n_kv, Sq, 1)
    live = keep & ~torch.isneginf(lse)
    e = s - lse
    if lse_lo is not None:
        e = e - lse_lo.reshape(lse.shape)
    return torch.where(live, torch.exp(e), 0.0), keep, qs


def flash_fwd_plain(q, k, v, causal=True, scale=None, bias=None,
                    dropout=None, lse_lo=None):
    """K1 in plain PyTorch: (O (B, Sq, H, D) in q's dtype, lse (B, H, Sq)
    fp32) for q (B, Sq, H, D), k / v (B, Sk, Hkv, D), with an optional
    fp32 `bias` and `dropout` (p, seed, offset); lse's low part (TwoSum)
    goes into `lse_lo` (B, H, Sq) fp32 where one is given."""
    scale = _scale(q, scale)
    dropout = _dropout(dropout)
    B, Sq, H, D = q.shape
    s, keep, _ = _probs(q, k, causal, scale, bias=bias)
    m = s.amax(-1, keepdim=True)
    # rows that see no key (causal Sq > Sk, or every score -inf): the
    # reference's NaN; they shift by 0
    dead = torch.isneginf(m)
    p = torch.where(keep, torch.exp(s - torch.where(dead, 0.0, m)), 0.0)
    l = p.sum(-1, keepdim=True)
    z = _z(q, k, dropout)
    if z is not None:
        p = torch.where(z, p * _keep_scale(dropout[0]), 0.0)
    lc = l.clamp_min(1e-30)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(torch.float32))
    o = o / lc.permute(0, 3, 1, 2, 4)
    ll = torch.log(lc)
    hi = m + ll
    dead = dead.reshape(B, H, Sq)
    o = torch.where(dead.transpose(1, 2)[..., None], math.nan,
                    o.reshape(B, Sq, H, D))
    lse = torch.where(dead, -math.inf, hi.reshape(B, H, Sq))
    if lse_lo is not None:
        bv = hi - m
        lo = ((m - (hi - bv)) + (ll - bv)).reshape(B, H, Sq)
        lse_lo.copy_(torch.where(dead, 0.0, lo))
    return o.to(q.dtype), lse


def flash_bwd_plain(q, k, v, o, lse, do, causal=True, scale=None, bias=None,
                    dropout=None, lse_lo=None):
    """K2 in plain PyTorch: (dQ, dK, dV) in the dtypes of q, k, v from
    q, k, v, O, lse (B, H, Sq) (plus its low part `lse_lo`, where given)
    and dO; dK / dV summed over each kv head's query heads."""
    scale = _scale(q, scale)
    dropout = _dropout(dropout)
    B, Sq, H, D = q.shape
    n_kv = k.shape[2]
    p, keep, qs = _probs(q, k, causal, scale, lse, bias, lse_lo)
    dog = _grouped(do, n_kv)
    delta = (o.to(torch.float32) * do.to(torch.float32)).sum(-1)  # (B, Sq, H)
    delta = delta.reshape(B, Sq, n_kv, H // n_kv).permute(0, 2, 3, 1)
    # a row with lse -inf sees no key: its O (NaN) adds nothing
    delta = torch.where(torch.isneginf(lse.reshape(delta.shape)), 0.0, delta)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.to(torch.float32))
    pz = p
    z = _z(q, k, dropout)
    if z is not None:
        ks = _keep_scale(dropout[0])
        pz = torch.where(z, p * ks, 0.0)
        dp = torch.where(z, dp * ks, 0.0)
    ds = torch.where(keep, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qs)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", pz, dog)
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
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
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


def _variant(dtype, D, variant=None, extra=False):
    """The kernel variant a CUDA call runs, from its dtype and head_dim
    D (see the module docstring), or `variant` where the caller names
    one; a call with a bias or dropout (`extra`) runs "mma", at every
    head_dim, also where the fma kernels with that code time faster
    (fp32 K1 and dK/dV at head_dim 16 and 128, shapes no main path
    runs: PERF.md section 6); those stay the yardstick a caller names.
    Raises ValueError on a variant that does not take the call."""
    if variant is None:
        variant = "mma" if extra else (
            "wgmma" if dtype == torch.bfloat16 and D == 128 else "fma")
    if extra and variant == "wgmma":
        raise ValueError("flash attention: the wgmma kernels take no bias "
                         "or dropout (the mma and fma variants do)")
    if (dtype, variant) not in KERNEL_CODES or D not in HEAD_DIMS or (
            variant == "wgmma" and D != 128):
        raise ValueError(f"flash attention: no {variant} kernel takes "
                         f"{dtype} at head_dim {D}")
    if variant == "mma" and not extra:
        raise ValueError("flash attention: no mma kernel takes a call "
                         "without a bias or dropout (those run the "
                         "wgmma or fma kernels)")
    return variant


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _extra_args(bias, dropout, q, k, lse_lo):
    """The C interface's trailing arguments: the bias pointer and its
    four strides (NULL for none), the seed's two words, the offset, the
    drop threshold (0: no dropout), 1 / (1 - p) and the lse_lo pointer
    (NULL for none)."""
    b4 = _bias4(bias, q, k)
    if b4 is not None and b4.device != q.device:
        raise ValueError("the bias must be on q's device")
    ptr = None if b4 is None else b4.data_ptr()
    st = (ctypes.c_longlong * 4)(*(b4.stride() if b4 is not None
                                   else (0, 0, 0, 0)))
    lo = None if lse_lo is None else lse_lo.data_ptr()
    if dropout is None:
        return ptr, st, 0, 0, 0, 0, 1.0, lo
    p, seed, offset = dropout
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (ptr, st, seed & _M32, seed >> 32, int(offset) & _M32,
            _threshold(p), _keep_scale(p), lo)


def _library(variant, extra, dtype):
    """The library that holds the kernels of `variant` for a call without
    or with (`extra`) a bias or dropout: the fma kernels built with that
    code are a library of their own, and so are the mma kernels of each
    dtype, all built side by side (`_build.build`)."""
    if variant == "mma":
        return "flash_attention_mma" + {torch.bfloat16: "_bf16",
                                        torch.float16: "_fp16"}.get(dtype, "")
    return "flash_attention_extra" if extra else "flash_attention"


def _call(fn, tensors, strided, q, k, causal, scale, variant, bias,
          dropout, lse_lo):
    """Launch kernel `fn` of the variant that takes the call; returns
    the variant."""
    B, Sq, H, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    extra = bias is not None or dropout is not None
    if lse_lo is not None and (not extra or lse_lo.dtype != torch.float32
                               or lse_lo.shape != (B, H, Sq)
                               or not lse_lo.is_contiguous()
                               or lse_lo.device != q.device):
        raise ValueError("lse_lo must be a contiguous (B, H, Sq) fp32 "
                         "tensor on q's device, given with a bias or "
                         "dropout")
    variant = _variant(q.dtype, D, variant, extra)
    code = KERNEL_CODES[(q.dtype, variant)]
    lib = _build.load(_library(variant, extra, q.dtype), _SIGNATURES)
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            *[t.data_ptr() for t in tensors], _strides(*strided),
            B, H, k.shape[2], Sq, k.shape[1], D, int(causal), float(scale),
            code, torch.cuda.current_stream(q.device).cuda_stream,
            *_extra_args(bias, dropout, q, k, lse_lo))
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed (cudaError {err})")
    return variant


def _count(fn, variant):
    with _COUNT_LOCK:
        LAUNCHES[fn] += 1
        VARIANT_LAUNCHES[variant][fn] += 1


def _lo_out(q, extra):
    """lse's low part as K1 gives it: (B, H, Sq) fp32 for a call with a
    bias or dropout, else an empty tensor."""
    B, Sq, H, _ = q.shape
    return q.new_empty((B, H, Sq) if extra else (0,), dtype=torch.float32)


def _seed_words(dropout):
    """Dropout (p, seed, offset) as the operator's arguments: p (0.0
    for none), the 64-bit seed's low and high 32-bit words (an op's int
    is a signed int64, and a CPU generator's seed takes all 64 bits) and
    the offset."""
    if dropout is None:
        return 0.0, 0, 0, 0
    p, seed, offset = dropout
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return float(p), seed & _M32, seed >> 32, int(offset) & _M32


def _op_dropout(p, seed_lo, seed_hi, offset):
    return None if p == 0.0 else (p, seed_lo | (seed_hi << 32), offset)


# K1 as the operator paddle_tpu_torch::flash_fwd, registered through
# torch.library's low-level API: torch.library.custom_op adds a Python
# autograd kernel to every call (on an H100's host, 49-77 us a K1 call
# over the direct launch against 16-31 here: tools/op_cost_ab.py)
_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float scale, str? variant, Tensor? bias, float p, "
            "int seed_lo, int seed_hi, int offset) "
            "-> (Tensor, Tensor, Tensor)")


def _flash_fwd_cpu(q, k, v, causal, scale, variant, bias, p, seed_lo,
                   seed_hi, offset):
    """The CPU kernel: the plain version, in fresh tensors (an operator
    returns no view of an input)."""
    extra = bias is not None or p != 0.0
    lo = _lo_out(q, extra)
    o, lse = flash_fwd_plain(q, k, v, causal, scale, bias,
                             _op_dropout(p, seed_lo, seed_hi, offset),
                             lse_lo=lo if extra else None)
    return o.contiguous(), lse, lo


def _flash_fwd_cuda(q, k, v, causal, scale, variant, bias, p, seed_lo,
                    seed_hi, offset):
    """The CUDA kernel: the launch, counted in `LAUNCHES` and
    `VARIANT_LAUNCHES`."""
    dropout = _op_dropout(p, seed_lo, seed_hi, offset)
    _check(q, k, v, causal)
    B, Sq, H, _ = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    extra = bias is not None or dropout is not None
    lo = _lo_out(q, extra)
    _count("flash_attention_fwd", _call(
        "flash_attention_fwd", (q, k, v, o, lse), (q, k, v), q, k, causal,
        scale, variant, bias, dropout, lo if extra else None))
    return o, lse, lo


def _flash_fwd_fake(q, k, v, causal, scale, variant, bias, p, seed_lo,
                    seed_hi, offset):
    """The shapes, for `torch.export`; a variant the card refuses is
    refused here, before the program is traced."""
    extra = bias is not None or p != 0.0
    if q.device.type == "cuda":
        _variant(q.dtype, q.shape[-1], variant, extra)
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, Sq), dtype=torch.float32),
            _lo_out(q, extra))


_LIB.impl("flash_fwd", _flash_fwd_cpu, "CPU")
_LIB.impl("flash_fwd", _flash_fwd_cuda, "CUDA")
torch.library.register_fake("paddle_tpu_torch::flash_fwd", _flash_fwd_fake,
                            lib=_LIB)
_FLASH_FWD_OP = torch.ops.paddle_tpu_torch.flash_fwd.default


def flash_fwd(q, k, v, causal=True, scale=None, variant=None, bias=None,
              dropout=None, return_lo=False):
    """K1: (O, lse) as `flash_fwd_plain`, and with `return_lo` lse's low
    part third ((B, H, Sq) fp32 with a bias or dropout, else empty), all
    from the operator `paddle_tpu_torch::flash_fwd`.  A CUDA `q`
    launches the Hopper kernel `_variant` picks, or the named `variant`
    (counted in `LAUNCHES`); a CPU `q` runs the plain version.  The
    operator takes no gradient (`flash_mha` does): inputs that require
    one under grad mode raise."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError("flash_fwd takes no gradient: call flash_mha, "
                         "or detach the inputs")
    out = _FLASH_FWD_OP(q, k, v, bool(causal), float(_scale(q, scale)),
                        variant, bias, *_seed_words(_dropout(dropout)))
    return out if return_lo else out[:2]


def _delta(o, do):
    """rowsum(O * dO) in fp32 as (B, H, Sq): the JAX package computes it
    outside the Pallas kernels too."""
    return (o.to(torch.float32) * do.to(torch.float32)).sum(-1) \
        .transpose(1, 2).contiguous()


def flash_bwd_dq(q, k, v, o, lse, do, causal=True, scale=None, delta=None,
                 variant=None, bias=None, dropout=None, lse_lo=None):
    """K2, dQ.  A CUDA `q` launches the dQ kernel `_variant` picks, or
    the named `variant` (counted in `LAUNCHES`; `delta` is computed when
    not given); a CPU `q` runs the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale, bias,
                               dropout, lse_lo)[0]
    scale = _scale(q, scale)
    _check(q, k, v, causal, (do,))
    delta = _delta(o, do) if delta is None else delta
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _count("flash_attention_dq", _call(
        "flash_attention_dq", (q, k, v, do, lse.contiguous(), delta, dq),
        (q, k, v, do), q, k, causal, scale, variant, bias, _dropout(dropout),
        lse_lo))
    return dq


def flash_bwd_dkv(q, k, v, o, lse, do, causal=True, scale=None, delta=None,
                  variant=None, bias=None, dropout=None, lse_lo=None):
    """K2, (dK, dV).  A CUDA `q` launches the dK/dV kernel `_variant`
    picks, or the named `variant` (counted in `LAUNCHES`); a CPU `q` runs
    the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale, bias,
                               dropout, lse_lo)[1:]
    scale = _scale(q, scale)
    _check(q, k, v, causal, (do,))
    delta = _delta(o, do) if delta is None else delta
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _count("flash_attention_dkv", _call(
        "flash_attention_dkv", (q, k, v, do, lse.contiguous(), delta, dk, dv),
        (q, k, v, do), q, k, causal, scale, variant, bias, _dropout(dropout),
        lse_lo))
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal=True, scale=None, bias=None,
              dropout=None, lse_lo=None):
    """K2: (dQ, dK, dV) — the dQ and the dK/dV kernel on a CUDA `q`, one
    plain backward on a CPU `q`."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale, bias,
                               dropout, lse_lo)
    do = do.contiguous()
    delta = _delta(o, do)
    dq = flash_bwd_dq(q, k, v, o, lse, do, causal, scale, delta,
                      bias=bias, dropout=dropout, lse_lo=lse_lo)
    dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, causal, scale, delta,
                           bias=bias, dropout=dropout, lse_lo=lse_lo)
    return dq, dk, dv


class _FlashMHA(torch.autograd.Function):
    """Forward K1, backward K2; saves q, k, v (unexpanded), O and lse —
    the residuals of the JAX package's custom VJP — and, with a bias or
    dropout, lse's low part, the bias and the dropout's (p, seed,
    offset), from which K2 regenerates the forward's keep mask."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bias, dropout):
        extra = bias is not None or dropout is not None
        o, lse, lo = flash_fwd(q, k, v, causal, scale, bias=bias,
                               dropout=dropout, return_lo=True)
        ctx.save_for_backward(q, k, v, o, lse, bias, lo if extra else None)
        ctx.causal, ctx.scale, ctx.dropout = causal, scale, dropout
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias, lse_lo = ctx.saved_tensors
        extra = ({} if lse_lo is None else
                 {"bias": bias, "dropout": ctx.dropout, "lse_lo": lse_lo})
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale,
                               **extra)
        return dq, dk, dv, None, None, None, None


def _as_bias(attn_mask, q):
    """An attention mask as the kernels' additive fp32 bias: a bool mask
    (True: attend) -> 0 / -inf, any other dtype cast to fp32."""
    if attn_mask.requires_grad:
        raise ValueError("the attention bias takes no gradient: K1/K2 "
                         "give none; pass a mask that does not require "
                         "grad")
    if attn_mask.dtype == torch.bool:
        return torch.zeros(attn_mask.shape, dtype=torch.float32,
                           device=q.device).masked_fill(~attn_mask,
                                                        -math.inf)
    return attn_mask.to(device=q.device, dtype=torch.float32)


def flash_mha(q, k, v, causal=True, scale=None, bias=None, dropout=None):
    """Flash attention on (B, S, H, D) with GQA: K1 forward, K2
    backward on the card, their plain versions on the CPU.  `bias`: an
    attention mask (bool: True attends) or an additive bias that
    broadcasts to (B, H, Sq, Sk); `dropout`: (p, seed, offset)."""
    if bias is not None:
        bias = _as_bias(bias, q)
    return _FlashMHA.apply(q, k, v, causal, scale, bias, _dropout(dropout))


# --------------------------------------------------------------------------
# dispatch (ops/flash_attention.py of the JAX package)
# --------------------------------------------------------------------------


def scaled_dot_product_attention_raw(q, k, v, attn_mask=None,
                                     dropout_p=0.0, is_causal=False,
                                     dropout_key=None, scale=None):
    """Attention on (B, S, H, D) in plain PyTorch, as the JAX package
    writes it: fp32 logits and softmax, a bool mask selects and any
    other mask adds, the causal mask is aligned bottom-right; dropout,
    when `dropout_key` = (seed, offset) is given, keeps the kernels'
    Philox mask (`dropout_keep`) and divides by 1 - p.  Probabilities
    are cast to v's dtype before P.V."""
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
    if dropout_p > 0.0 and dropout_key is not None:
        keep = dropout_keep(B, H, Sq, Sk, dropout_p, *dropout_key, q.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(vT.dtype), vT)
    return out.transpose(1, 2)


def flash_attention_xla(query, key, value, attn_mask=None, dropout_p=0.0,
                        is_causal=False, training=True, scale=None,
                        generator=None):
    """The JAX package's attention dispatch, every call through
    `flash_mha` (K1/K2 on the card, their plain versions on the CPU),
    with the mask as an additive bias.  Dropout runs in training only
    (`training=False` drops nothing, as in the JAX dispatch) and draws
    its (seed, offset) from `generator` on the host (`dropout_seed`): the
    port keeps no global RNG, so dropout in training without one
    raises.  It is the JAX op "flash_attention_op" for the O1 policy of
    `paddle_tpu_torch.amp`: under O1 q, k, v and the mask enter in the
    amp dtype (an fp16 mask turns -1e9 into -inf, as in the JAX
    package; the kernels give those keys weight 0)."""
    query, key, value, attn_mask = autocast_args(
        "flash_attention_op", query, key, value, attn_mask)
    dropout = None
    if dropout_p > 0.0 and training:
        if generator is None:
            raise ValueError("attention dropout in training needs a "
                             "generator=: the port keeps no global RNG")
        dropout = (float(dropout_p), *dropout_seed(generator))
    return flash_mha(query, key, value, is_causal, scale, bias=attn_mask,
                     dropout=dropout)
