"""Kernel K4 of the PyTorch port (paddle_tpu_torch/ops/paged_attention.py):
its plain version against the JAX package's Pallas kernel (interpret
mode) and the gather path's `_attend`, the CUDA kernel's split-K
arithmetic (emulated here in plain PyTorch) against both, the int8 row
quantization against the JAX expressions, the wrapper's input checks,
and — on the card only — the CUDA kernel against the plain version.

Inputs are made once with numpy at explicit dtypes and handed to both
packages.  Tolerances: fp32 max abs error <= 1e-5 (the two frameworks
sum in another order); bf16 outputs compared in fp32, per slot, max abs
error <= 2e-2 of that slot's max |reference| (bf16 rounding of the
probabilities and of the output, at other places in XLA and PyTorch)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.quantization.int8 import (dequantize_kv,
                                                quantize_kv_rows)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tol_ok(out, ref, dtype):
    """fp32: max abs error <= 1e-5.  bf16: per slot b, max |out_b -
    ref_b| <= 2e-2 * max |ref_b| — per slot, because a slot at depth 0
    returns one V row (|out| ~ 3) while a deep slot averages to |out|
    ~ 0.05, and one limit over the batch would not see a deep slot's
    error at all.  Returns (ok, the worst error as a share of its
    limit)."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(out - ref).reshape(len(ref), -1).max(axis=1)
    if dtype == "float32":
        limit = np.full_like(err, 1e-5)
    else:
        limit = 2e-2 * np.abs(ref).reshape(len(ref), -1).max(axis=1)
    share = float((err / limit).max())
    return share <= 1.0, share


def _case(B=3, bmax=4, N=16, bt=8, n_kv=2, rep=2, hd=16, seed=0,
          pos=None):
    """Pool, table and depths: distinct blocks per slot, slot 1 with a
    trash tail (its last table entry is block 0), depths on and off
    block edges."""
    rng = np.random.default_rng(seed)
    nh = n_kv * rep
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    pk = rng.normal(size=(N, bt, n_kv, hd)).astype(np.float32)
    pv = rng.normal(size=(N, bt, n_kv, hd)).astype(np.float32)
    table = np.zeros((B, bmax), np.int32)
    blocks = rng.permutation(np.arange(1, N))[:B * bmax]
    k = 0
    for b in range(B):
        for c in range(bmax - (1 if b == 1 else 0)):
            table[b, c] = blocks[k]
            k += 1
    if pos is None:
        pos = [5, 2 * bt - 1, bmax * bt - 1][:B]
    return q, pk, pv, table, np.asarray(pos, np.int32)


def _to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _jax_refs(q, pk, pv, table, pos, dtype, tile, quant):
    """(JAX Pallas kernel in interpret mode, JAX gather + _attend)."""
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.models import llama_decode as JD
    from paddle_tpu.ops.pallas_paged_attention import paged_attention
    from paddle_tpu.quantization import int8 as JQ

    B, nh, hd = q.shape
    bt, n_kv = pk.shape[1], pk.shape[2]
    bmax = table.shape[1]
    jq = jnp.asarray(q).astype(dtype)
    if quant:
        kq, ks = JQ.quantize_kv_rows(jnp.asarray(pk))
        vq, vs = JQ.quantize_kv_rows(jnp.asarray(pv))
        jk, jv = (kq, ks), (vq, vs)
        kview = JQ.dequantize_kv(kq[table].reshape(B, bmax * bt, n_kv, hd),
                                 ks[table].reshape(B, bmax * bt, n_kv), dtype)
        vview = JQ.dequantize_kv(vq[table].reshape(B, bmax * bt, n_kv, hd),
                                 vs[table].reshape(B, bmax * bt, n_kv), dtype)
    else:
        jk = jnp.asarray(pk).astype(dtype)
        jv = jnp.asarray(pv).astype(dtype)
        kview = jk[table].reshape(B, bmax * bt, n_kv, hd)
        vview = jv[table].reshape(B, bmax * bt, n_kv, hd)
    jtable = jnp.asarray(table)
    jpos = jnp.asarray(pos)
    kern = paged_attention(jq, jk, jv, jtable, jpos, block_tile=tile)
    ref = JD._attend(jq[:, None], kview, vview, jpos[:, None], nh,
                     n_kv)[:, 0]
    to32 = (lambda a: np.asarray(a.astype(jnp.float32)))
    pools = (tuple(np.asarray(x) for x in jk),
             tuple(np.asarray(x) for x in jv)) if quant else None
    return to32(kern), to32(ref), pools


def _port_plain(q, pk, pv, table, pos, dtype, pools=None):
    tq = _to_torch(q, dtype)
    if pools is not None:           # the JAX package's int8 rows + scales
        (kq, ks), (vq, vs) = pools
        tk = (torch.tensor(kq), torch.tensor(ks))
        tv = (torch.tensor(vq), torch.tensor(vs))
    else:
        tk, tv = _to_torch(pk, dtype), _to_torch(pv, dtype)
    out = PA.paged_attention(tq, tk, tv, torch.from_numpy(table),
                             torch.from_numpy(pos))
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [1, 2, 4])
def test_plain_matches_jax_kernel_and_attend(dtype, tile):
    q, pk, pv, table, pos = _case()
    kern, ref, _ = _jax_refs(q, pk, pv, table, pos, dtype, tile, False)
    out = _port_plain(q, pk, pv, table, pos, dtype)
    for name, r in (("pallas", kern), ("attend", ref)):
        ok, err = _tol_ok(out, r, dtype)
        assert ok, f"{dtype} tile={tile} vs {name}: err / limit {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_int8_pool(dtype):
    """Int8 pool: both packages read the SAME int8 rows and scales
    (quantized once by the JAX package) and dequantize in-path."""
    q, pk, pv, table, pos = _case(seed=3)
    kern, ref, pools = _jax_refs(q, pk, pv, table, pos, dtype, 2, True)
    out = _port_plain(q, pk, pv, table, pos, dtype, pools=pools)
    for name, r in (("pallas", kern), ("attend", ref)):
        ok, err = _tol_ok(out, r, dtype)
        assert ok, f"int8/{dtype} vs {name}: err / limit {err}"


@pytest.mark.parametrize("pos", [[0, 7, 8], [15, 16, 31], [1, 23, 24]])
def test_block_edges_and_trash_tails(pos):
    """Depths at the first row, on both sides of block edges, and up to
    slot 1's trash tail (its rows 24.. map to block 0): rows past pos
    (trash included) are exact zeros, so garbage in the trash block
    cannot leak in."""
    q, pk, pv, table, _ = _case(seed=5)
    pos = np.asarray(pos, np.int32)
    kern, ref, _ = _jax_refs(q, pk, pv, table, pos, "float32", 2, False)
    out = _port_plain(q, pk, pv, table, pos, "float32")
    assert _tol_ok(out, kern, "float32")[0]
    assert _tol_ok(out, ref, "float32")[0]
    poisoned = pk.copy(), pv.copy()
    for p in poisoned:
        p[0] = 1e4                  # trash block
    out2 = _port_plain(q, *poisoned, table, pos, "float32")
    np.testing.assert_array_equal(out, out2)


def _split_k(q, pk, pv, table, pos, R):
    """The CUDA kernel's arithmetic in plain PyTorch: each slot's rows
    t <= pos cut into splits of R rows; per split and query head the
    unnormalised softmax (m, l, acc) in fp32 (scores q . k / sqrt(hd),
    probabilities kept in fp32; an int8 row dequantized as the kernel
    does it: int8 * scale in fp32, rounded to q's dtype), then the live
    splits merged in split order."""
    kd = PA._split(pk)[0]
    B, nh, hd = q.shape
    n_kv = kd.shape[2]
    rep = nh // n_kv
    T = table.shape[1] * kd.shape[1]
    k = PA.paged_view(pk, table, q.dtype).float()      # (B, T, n_kv, hd)
    v = PA.paged_view(pv, table, q.dtype).float()
    qg = q.float().reshape(B, n_kv, rep, hd)
    out = torch.zeros(B, n_kv, rep, hd)
    for b in range(B):
        n = min(int(pos[b]) + 1, T)
        parts = []
        for t0 in range(0, n, R):
            ks, vs = k[b, t0:min(t0 + R, n)], v[b, t0:min(t0 + R, n)]
            s = torch.einsum("grd,tgd->grt", qg[b], ks) / np.float32(
                np.sqrt(hd))
            m = s.amax(-1)
            e = torch.exp(s - m[..., None])
            parts.append((m, e.sum(-1), torch.einsum("grt,tgd->grd", e, vs)))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        den = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        num = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
        out[b] = num / den[..., None]
    dt = q.dtype if isinstance(pk, tuple) else \
        torch.promote_types(q.dtype, kd.dtype)
    return out.reshape(B, nh, hd).to(dt)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("R", [16, 128])
def test_split_k_arithmetic_matches_plain_and_jax_kernel(R, pool):
    """The kernel's design — splits of R rows, fp32 partials, merged in
    order — at depths 0, on both sides of split edges and at the
    table's last row, against `paged_attention_plain` and the JAX
    Pallas kernel (interpret mode), within the module's tolerances.
    The trash block holds 1e4: a row past pos read by a split would
    show."""
    bt, bmax = 16, 20
    T = bt * bmax
    pos = [0, R - 1, R, R + 1, 2 * R - 1, T - 1]
    q, pk, pv, table, pos = _case(B=len(pos), bmax=bmax, N=1 + len(pos) * bmax,
                                  bt=bt, n_kv=2, rep=4, hd=16, seed=R,
                                  pos=pos)
    table[3, -1] = 0                     # slot 3's last entry is trash
    pk[0] = pv[0] = 1e4
    dtype = "bfloat16" if pool == "int8" else pool
    quant = pool == "int8"
    kern, _, pools = _jax_refs(q, pk, pv, table, pos, dtype, 4, quant)
    tq = _to_torch(q, dtype)
    if quant:
        (kq, ksc), (vq, vsc) = pools
        tk = (torch.tensor(kq), torch.tensor(ksc))
        tv = (torch.tensor(vq), torch.tensor(vsc))
    else:
        tk, tv = _to_torch(pk, dtype), _to_torch(pv, dtype)
    tt, tp = torch.from_numpy(table), torch.from_numpy(pos)
    got = _split_k(tq, tk, tv, tt, tp, R)
    plain = PA.paged_attention_plain(tq, tk, tv, tt, tp)
    assert got.dtype == plain.dtype
    for name, ref in (("plain", plain.float().numpy()), ("pallas", kern)):
        ok, err = _tol_ok(got.float().numpy(), ref, dtype)
        assert ok, f"{pool} R={R} vs {name}: err / limit {err}"


def test_split_rows_fit_shared_memory():
    """Splits default to 128 rows, are cut so a split's K and V rows fit
    64 KB (fp32 at head_dim 128: 64 rows), and are powers of two."""
    assert PA.split_rows(128, 2) == 128
    assert PA.split_rows(128, 1) == 128
    assert PA.split_rows(128, 4) == 64
    assert PA.split_rows(256, 4) == 32
    assert PA.split_rows(96, 2, rows=100) == 64
    assert PA.split_rows(16, 1, rows=1000) == 256


def test_quantize_rows_match_jax():
    """quantize_kv_rows / dequantize_kv: the same fp32 expression and
    round-half-to-even on both sides, so equal inputs give equal int8
    rows and scales."""
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.quantization import int8 as JQ
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 8, 2, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, -1.5, 2.5, 127.0]     # exact halves
    jq, js = JQ.quantize_kv_rows(jnp.asarray(x))
    tq, ts = quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = JQ.dequantize_kv(jq, js, jnp.float32)
    td = dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_cpu_call_runs_plain_and_counts_no_launch():
    q, pk, pv, table, pos = _case()
    before = PA.LAUNCHES["paged_attention"]
    out = PA.paged_attention(*(torch.from_numpy(a) for a in
                               (q, pk, pv, table, pos)))
    plain = PA.paged_attention_plain(*(torch.from_numpy(a) for a in
                                       (q, pk, pv, table, pos)))
    assert PA.LAUNCHES["paged_attention"] == before
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["hd", "rep", "group", "contig", "table",
                                 "pos", "scale", "align"])
def test_wrapper_checks_raise(bad):
    """The CUDA wrapper's checks (run here on CPU tensors): anything the
    kernel does not take raises before a launch."""
    B, nh, hd, N, bt, n_kv = 2, 4, 16, 6, 8, 2
    q = torch.zeros(B, nh, hd)
    kd = torch.zeros(N, bt, n_kv, hd)
    ks = vs = None
    table = torch.zeros(B, 3, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    if bad == "hd":
        q, kd = torch.zeros(B, nh, 12), torch.zeros(N, bt, n_kv, 12)
    elif bad == "rep":
        q = torch.zeros(B, 3, hd)
    elif bad == "group":
        q, kd = torch.zeros(B, 18, hd), torch.zeros(N, bt, 2, hd)
    elif bad == "contig":
        q = torch.zeros(B, hd, nh).transpose(1, 2)
    elif bad == "table":
        table = table.long()
    elif bad == "pos":
        pos = torch.zeros(B + 1, dtype=torch.int32)
    elif bad == "scale":
        kd = kd.to(torch.int8)
        ks = vs = torch.zeros(N, bt, n_kv, dtype=torch.float64)
    elif bad == "align":
        q = torch.zeros(B * nh * hd + 1)[1:].view(B, nh, hd)
    with pytest.raises(ValueError):
        PA._check(q, kd, kd, ks, vs, table, pos)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_card():
    """K4 on the card against its plain version: fp32 (TF32 off),
    bf16 and int8 pools, GQA rep 1/4/8, head_dim 64/128/256, the
    default split and splits of 16 and 32 rows with depths on both
    sides of their edges; each call twice, bitwise the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for dtype, quant, n_kv, rep, hd in [
            ("float32", False, 2, 4, 128), ("bfloat16", False, 8, 4, 128),
            ("bfloat16", True, 8, 4, 128), ("float32", True, 4, 1, 64),
            ("bfloat16", False, 2, 8, 256)]:
        q, pk, pv, table, pos = _case(B=8, bmax=6, N=60, bt=16,
                                      n_kv=n_kv, rep=rep, hd=hd,
                                      pos=[0, 15, 16, 17, 31, 32, 47, 95])
        tq = _to_torch(q, dtype).to(dev)
        if quant:
            tk = quantize_kv_rows(torch.from_numpy(pk).to(dev))
            tv = quantize_kv_rows(torch.from_numpy(pv).to(dev))
        else:
            tk = _to_torch(pk, dtype).to(dev)
            tv = _to_torch(pv, dtype).to(dev)
        tt, tp = torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev)
        ref = PA.paged_attention_plain(tq, tk, tv, tt, tp)
        for split in (None, 16, 32):
            before = PA.LAUNCHES["paged_attention"]
            out = PA.paged_attention(tq, tk, tv, tt, tp, split=split)
            again = PA.paged_attention(tq, tk, tv, tt, tp, split=split)
            torch.cuda.synchronize()
            assert PA.LAUNCHES["paged_attention"] == before + 2
            assert torch.equal(out, again), (dtype, quant, split)
            assert out.dtype == ref.dtype
            ok, err = _tol_ok(out.float().cpu(), ref.float().cpu(), dtype)
            assert ok, (f"{dtype} quant={quant} rep={rep} hd={hd} "
                        f"split={split}: err / limit {err}")
