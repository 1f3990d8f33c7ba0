#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the result line:

  1. env      torch / CUDA / nvcc versions, the card's name and power limit;
  2. build    every kernel of the port compiled from paddle_tpu_torch/csrc
              (one nvcc per source, all started together) into
              build/paddle_tpu_torch/;
  3. kernels  the paged-attention kernel (K4) against its plain PyTorch
              version at the engine's decode shapes (8 slots, 32 query /
              8 kv heads, head_dim 128, 16-row blocks, 128-block tables,
              ragged depths with block edges and trash tails) for bf16,
              fp32 and int8 pools, then timed in turns (plain, kernel,
              kernel, plain) with CUDA events, beside its bound and one
              PyTorch call that computes the same function
              (scaled_dot_product_attention on the pre-gathered view —
              a yardstick the port never calls);
  4. serve    Llama-3-8B (random weights from a seed, bf16, all 32
              layers) served through LLMEngine: 8 greedy requests of the
              prompt-length mix [37 .. 512] x 32 new tokens, once with a
              bf16 and once with an int8 KV pool; each run must launch
              the kernel exactly 32 x (decode steps) times; then a
              profile of steady decode steps (all 8 slots decoding): host
              step time, and device time by kernel with the idle share;
              then, at the same serve shape for each pool, every decode
              step run through the gather path and through the kernel
              on the same pool and tables (which grow during the run),
              logits held within a stated bound per live slot;
  5. parity   debug-4l in fp32: greedy streams through the kernel and
              through the gather path are token-exact;
  6. server   LLMServer answers three requests with the engine's tokens.

Then one line {"kernels": [...]} (every ported kernel with its launches
on the paths above, error, tolerance and times), the card's name and
power limit as nvidia-smi gives them, and last the result line
{"ok": true, "device": {...}}.  Without a CUDA card, or run from a
directory without the rest of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SHAPE = dict(B=8, nh=32, n_kv=8, hd=128, bt=16, bmax=128)
# ragged depths: first row, both sides of a block edge, mid-block, a
# 1024-row edge, and one slot at the table's last row
KERNEL_POS = [0, 15, 16, 100, 511, 1024, 1500, 2047]
SERVE_LENGTHS = [37, 64, 101, 150, 211, 313, 420, 512]
SERVE_NEW = 32
_PER_SLOT = "per slot b: max|out_b - plain_b| <= 2e-2 * max|plain_b|"
TOL = {"bfloat16": _PER_SLOT,
       "float32": "max abs err <= 1e-5",
       "int8": _PER_SLOT + " (bf16 q, int8 pool)"}
# serve-shape check of the engine's K4 wiring (phase_serve_parity):
#  * per layer and live slot b, the kernel's output against the gather
#    path's attention on the same q, pool, table and depths:
#    max|out_b - gather_b| <= 2e-2 * max|gather_b|, K4's own tolerance;
#  * end to end, the logits of the kernel path against those of the
#    gather path.  They differ by the kernel's fp32 probabilities
#    against the gather path's bf16 ones, and 32 layers of random
#    weights amplify that, so the bound is measured on the same steps:
#    the gather path with fp32 probabilities (the kernel's arithmetic
#    in plain PyTorch) against the gather path.  The kernel may stray
#    at most SERVE_LOGITS_FACTOR times as far.  A kernel that reads the
#    wrong slot, head, block or layer changes the attention output by
#    O(1), and the logits by their own scale.
SERVE_LOGITS_FACTOR = 2.0
SERVE_PARITY_STEPS = 16       # >= kv_block_tokens: every slot's table grows


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_env(torch):
    from paddle_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvcc": nvcc[-1], "card": nvidia_smi_line(),
          "device_count": torch.cuda.device_count()})


def phase_build():
    import re
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build()
    secs = time.perf_counter() - t0
    regs, spills = [], []
    for name, path in libs.items():
        log = path.with_suffix(".log").read_text() \
            if path.with_suffix(".log").exists() else ""
        regs += [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills += [int(x) for x in
                   re.findall(r"(\d+) bytes spill stores", log)]
    emit({"phase": "build", "seconds": secs, "kernels": sorted(libs),
          "max_registers": max(regs, default=None),
          "max_spill_store_bytes": max(spills, default=None)})


def _kernel_inputs(torch, mode, copies, gen):
    """`copies` independent pools (so timed launches find the 50 MB L2
    cold, as a decode step's per-layer pools do) + one q, table, pos."""
    from paddle_tpu_torch.quantization.int8 import quantize_kv_rows
    s = KERNEL_SHAPE
    dev = torch.device("cuda")
    n_blocks = 1 + s["B"] * s["bmax"]
    qdt = torch.float32 if mode == "float32" else torch.bfloat16
    q = torch.randn(s["B"], s["nh"], s["hd"], device=dev, generator=gen,
                    dtype=torch.float32).to(qdt)
    pools = []
    for _ in range(copies):
        kv = []
        for _ in range(2):
            x = torch.randn(n_blocks, s["bt"], s["n_kv"], s["hd"],
                            device=dev, generator=gen)
            kv.append(quantize_kv_rows(x) if mode == "int8" else x.to(qdt))
        pools.append(tuple(kv))
    # slot b owns ceil((pos+1)/bt) + (b % 3) blocks (rows past pos are
    # live garbage), the rest of its table row is trash
    table = torch.zeros(s["B"], s["bmax"], dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator()
                          .manual_seed(1)) + 1
    k = 0
    for b, p in enumerate(KERNEL_POS):
        n = min(p // s["bt"] + 1 + b % 3, s["bmax"])
        table[b, :n] = perm[k:k + n].to(torch.int32)
        k += n
    pos = torch.tensor(KERNEL_POS, dtype=torch.int32)
    return q, pools, table.to(dev), pos.to(dev)


def _time_ms(torch, fn, copies, iters):
    for i in range(3):
        fn(i % copies)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % copies)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(mode, q, out, table, pos, kind):
    """Least time for the function on this card: bytes it must move
    (K/V rows t <= pos once, int8 scales, q, out, table, pos) over the
    memory rate vs. its QK and PV flops over the peak for their type."""
    from paddle_tpu_torch.observability import roofline
    s = KERNEL_SHAPE
    rows = sum(p + 1 for p in KERNEL_POS)
    elt = {"bfloat16": 2, "float32": 4, "int8": 1}[mode]
    kv = rows * s["n_kv"] * s["hd"] * 2 * elt
    if mode == "int8":
        kv += rows * s["n_kv"] * 4 * 2
    nbytes = kv + sum(t.numel() * t.element_size()
                      for t in (q, out, table, pos))
    flops = 4.0 * rows * s["nh"] * s["hd"]
    t_bytes = nbytes / roofline.peak_hbm_bw(kind)
    t_ops = flops / roofline.peak_flops(
        kind, "float32" if mode == "float32" else "bfloat16")
    return 1e3 * max(t_bytes, t_ops), \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_attention as PA
    kind = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for mode in ("bfloat16", "float32", "int8"):
        copies = 4
        q, pools, table, pos = _kernel_inputs(torch, mode, copies, gen)
        out = PA.paged_attention(q, *pools[0], table, pos)
        torch.cuda.synchronize()
        ref = PA.paged_attention_plain(q, *pools[0], table, pos)
        require(out.dtype == ref.dtype and out.shape == ref.shape,
                f"K4 {mode}: output {out.dtype} {tuple(out.shape)} vs "
                f"plain {ref.dtype} {tuple(ref.shape)}")
        # per slot: a depth-0 slot returns one V row (|out| ~ 3), a
        # 2048-row slot averages to |out| ~ 0.05; one limit over the
        # batch would let the deep slots' errors through
        B = KERNEL_SHAPE["B"]
        err_b = (out.float() - ref.float()).abs().reshape(B, -1).amax(1)
        ref_b = ref.float().abs().reshape(B, -1).amax(1)
        limit_b = torch.full_like(ref_b, 1e-5) if mode == "float32" \
            else 2e-2 * ref_b
        share = (err_b / limit_b).max().item()
        err = err_b.max().item()
        require(share <= 1.0,
                f"K4 {mode}: per-slot err {err_b.tolist()} over limits "
                f"{limit_b.tolist()}")
        # library yardstick: SDPA over views gathered beforehand
        s = KERNEL_SHAPE
        T = s["bmax"] * s["bt"]
        views = [tuple(PA.paged_view(e, table, q.dtype).transpose(1, 2)
                       .contiguous() for e in pool) for pool in pools]
        mask = (torch.arange(T, device="cuda")[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]

        def kern(i):
            PA.paged_attention(q, *pools[i], table, pos)

        def plain(i):
            PA.paged_attention_plain(q, *pools[i], table, pos)

        def lib(i):
            F.scaled_dot_product_attention(q4, views[i][0], views[i][1],
                                           attn_mask=mask, enable_gqa=True)

        launches = PA.paged_attention.launches
        p1 = _time_ms(torch, plain, copies, 20)
        k1 = _time_ms(torch, kern, copies, 50)
        k2 = _time_ms(torch, kern, copies, 50)
        p2 = _time_ms(torch, plain, copies, 20)
        lib_ms = _time_ms(torch, lib, copies, 50)
        PA.paged_attention.launches = launches   # timing launches don't count
        bound_ms, bound_by = _bound(mode, q, out, table, pos, kind)
        results[mode] = {"max_abs_err": err,
                         "err_per_slot": err_b.tolist(),
                         "max_abs_plain_per_slot": ref_b.tolist(),
                         "worst_err_over_limit": share,
                         "tolerance": TOL[mode], "ms": (k1 + k2) / 2,
                         "kernel_ms_turns": [k1, k2],
                         "plain_ms": (p1 + p2) / 2,
                         "plain_ms_turns": [p1, p2], "library_ms": lib_ms,
                         "bound_ms": bound_ms,
                         "bound_by": bound_by}
        emit({"phase": "kernels", "kernel": "paged_attention",
              "mode": mode, **results[mode]})
        del q, pools, views, out, ref
        torch.cuda.empty_cache()
    return results


def _percentile(xs, p):
    xs = sorted(xs)
    if not xs:
        return None
    k = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def _serve_once(torch, model, kv_dtype):
    """One engine run of the serve mix; returns its report and tokens."""
    import numpy as np
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.ops import paged_attention as PA
    eng = LLMEngine(model, max_slots=8, max_len=2048, prefill_chunk=128,
                    kv_block_tokens=16, kv_dtype=kv_dtype)
    require(eng.decode_kernel == "cuda", eng.decode_kernel)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab_size, L)
               for L in SERVE_LENGTHS]
    stamps = {}

    def on_token(req, tok):
        stamps.setdefault(req.rid, []).append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.paged_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, SERVE_NEW, on_token=on_token) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.paged_attention.launches
    steps = int(eng.metrics()["llm_engine_decode_steps_total"]["series"]
                [""]["value"])
    layers = model.config.num_hidden_layers
    for r in reqs:
        require(r.done and r.error is None and len(r.tokens) == SERVE_NEW,
                f"request {r.rid}: {len(r.tokens)} tokens, {r.error!r}")
        require(all(0 <= t < model.config.vocab_size for t in r.tokens),
                f"request {r.rid}: token id out of the vocabulary")
    require(launches == layers * steps,
            f"kernel launches {launches} != {layers} layers x {steps} "
            f"decode steps")
    itl = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
    ttft = [stamps[r.rid][0] - t0 for r in reqs]
    report = {"kv_dtype": kv_dtype or "bfloat16", "requests": len(reqs),
              "generated_tokens": sum(len(r.tokens) for r in reqs),
              "wall_s": wall,
              "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall,
              "decode_steps": steps, "kernel_launches": launches,
              "itl_p50_ms": 1e3 * _percentile(itl, 50),
              "itl_p99_ms": 1e3 * _percentile(itl, 99),
              "ttft_p50_ms": 1e3 * _percentile(ttft, 50),
              "ttft_max_ms": 1e3 * max(ttft),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "kv_pool_gib": eng.kv_pool_bytes() / 2**30}
    tokens = [list(r.tokens) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return report, tokens, launches


def _device_times(prof):
    """{kernel name: device µs} from a profiler's key averages (None
    when the profiler recorded no device activity)."""
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            out[evt.key] = out.get(evt.key, 0.0) + us
    return out or None


def phase_profile(torch, model, steps=6):
    """Where a steady decode step's time goes at the serve shape: all 8
    slots decoding (bf16 pool).  Host-clock step time unprofiled, then
    device time by kernel under torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import LLMEngine
    eng = LLMEngine(model, max_slots=8, max_len=2048, prefill_chunk=128,
                    kv_block_tokens=16)
    rng = np.random.default_rng(0)
    for L in SERVE_LENGTHS:
        eng.submit(rng.integers(0, model.config.vocab_size, L), 4 * steps
                   + SERVE_NEW)
    while eng.num_prefilling or eng._queue:
        eng.step()
    require(eng.num_active == len(SERVE_LENGTHS), "profile: slots idle")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev = _device_times(prof)
    prof_step_ms = 1e3 * prof_wall / steps
    report = {"phase": "profile", "model": "llama3-8b", "slots": 8,
              "decode_step_ms": step_ms, "profiled_steps": steps,
              "profiled_step_ms": prof_step_ms}
    if dev is None:
        report["device_time"] = "not measured (no device events)"
    else:
        busy = sum(dev.values()) / 1e3 / steps           # ms per step
        # one stream: the card cannot be busy longer than the wall time
        # of the same steps, nor (device times move ~1 % between runs)
        # than an unprofiled step; more means events were counted twice
        require(busy <= prof_step_ms and busy <= step_ms,
                f"profile: device busy {busy} ms per step exceeds the "
                f"step ({prof_step_ms} ms profiled, {step_ms} ms not)")
        k4 = sum(v for k, v in dev.items()
                 if "paged_decode_kernel" in k) / 1e3 / steps
        gemm = sum(v for k, v in dev.items()
                   if any(w in k.lower() for w in ("gemm", "gemv", "cutlass",
                                                   "sm90_xmma", "nvjet")))
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
        report.update({
            "device_busy_ms_per_step": busy,
            # against the unprofiled step: the profiler slows the host
            "device_idle_share": 1 - busy / step_ms,
            "k4_ms_per_step": k4, "gemm_ms_per_step": gemm / 1e3 / steps,
            "other_ms_per_step": busy - k4 - gemm / 1e3 / steps,
            "top_kernels_ms_per_step": [[k[:80], v / 1e3 / steps]
                                        for k, v in top]})
    emit(report)
    del eng
    torch.cuda.empty_cache()


def phase_serve_parity(torch, model, kv_dtype):
    """The engine's K4 wiring at the serve shape: 8 slots, 128-block
    tables that grow during decode, the given pool.  Every decode step
    runs three times on the same pool, tables and tokens: the gather
    path, the gather path with fp32 probabilities, and last the kernel
    (whose K/V rows are the ones kept).  See SERVE_LOGITS_FACTOR."""
    import numpy as np
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models import llama_decode as D
    from paddle_tpu_torch.ops import paged_attention as PA
    cfg = model.config
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    eng = LLMEngine(model, max_slots=8, max_len=2048, prefill_chunk=128,
                    kv_block_tokens=16, kv_dtype=kv_dtype)
    require(eng.decode_kernel == "cuda", eng.decode_kernel)
    rng = np.random.default_rng(0)
    for L in SERVE_LENGTHS:
        # long enough that no request ends before the compared steps
        eng.submit(rng.integers(0, cfg.vocab_size, L),
                   2 * SERVE_NEW + SERVE_PARITY_STEPS)
    step, attend, kernel_fn = (D.paged_decode_step_batch, D._attend,
                               D.paged_attention)
    worst = {"layer_share": 0.0, "cuda_vs_gather": 0.0,
             "fp32probs_vs_gather": 0.0, "cuda_vs_fp32probs": 0.0}
    counts = {"steps": 0, "full_steps": 0, "argmax_same": 0, "rows": 0}
    live = None

    def per_slot(x):
        return x.float().abs().reshape(x.shape[0], -1).amax(1)[live]

    def attend_fp32_probs(q, k_view, v_view, valid_len, n_heads, n_kv):
        out = attend(q.float(), k_view, v_view, valid_len, n_heads, n_kv)
        return out.to(torch.promote_types(q.dtype, v_view.dtype))

    def kernel_checked(q, pk, pv, table, pos):
        out = kernel_fn(q, pk, pv, table, pos)
        ref = attend(q[:, None], D._paged_view(pk, table, q.dtype),
                     D._paged_view(pv, table, q.dtype), pos.long()[:, None],
                     nh, nkv)[:, 0]
        share = (per_slot(out.float() - ref.float())
                 / (2e-2 * per_slot(ref))).max().item()
        worst["layer_share"] = max(worst["layer_share"], share)
        return out

    def three(state, cfg, token, pos, pool, table, kernel="gather"):
        nonlocal live
        live = torch.tensor([r is not None for r in eng._slots],
                            device=token.device)
        args = (state, cfg, token, pos, pool, table)
        ref, _ = step(*args, kernel="gather")
        D._attend = attend_fp32_probs
        try:
            alt, _ = step(*args, kernel="gather")
        finally:
            D._attend = attend
        before = PA.paged_attention.launches
        D.paged_attention = kernel_checked
        try:
            logits, pool = step(*args, kernel=kernel)
        finally:
            D.paged_attention = kernel_fn
        require(PA.paged_attention.launches - before
                == cfg.num_hidden_layers, "serve parity: kernel not run")
        for key, x, y in (("cuda_vs_gather", logits, ref),
                          ("fp32probs_vs_gather", alt, ref),
                          ("cuda_vs_fp32probs", logits, alt)):
            worst[key] = max(worst[key], per_slot(x.float() - y.float())
                             .max().item())
        counts["steps"] += 1
        counts["full_steps"] += int(live.all().item())
        counts["argmax_same"] += int((logits[live].argmax(1)
                                      == ref[live].argmax(1)).sum())
        counts["rows"] += int(live.sum())
        return logits, pool

    D.paged_decode_step_batch = three
    try:
        while eng.num_prefilling or eng._queue:
            eng.step()
        tables_before = eng._pager.table.copy()
        for _ in range(SERVE_PARITY_STEPS):
            eng.step()
        grew = int((eng._pager.table != tables_before).any(1).sum())
    finally:
        D.paged_decode_step_batch = step
    pool = kv_dtype or "bfloat16"
    limit = SERVE_LOGITS_FACTOR * worst["fp32probs_vs_gather"]
    emit({"phase": "serve_parity", "model": "llama3-8b", "kv_dtype": pool,
          "decode_steps_compared": counts["steps"],
          "steps_all_slots_live": counts["full_steps"],
          "tables_grown": grew,
          "layer_tolerance": "per layer and live slot b: max|cuda_b - "
                             "gather_b| <= 2e-2 * max|gather_b|",
          "layer_worst_err_over_limit": worst["layer_share"],
          "logits_tolerance": f"max|cuda - gather| <= "
                              f"{SERVE_LOGITS_FACTOR} x max|gather with "
                              f"fp32 probs - gather|",
          "logits_max_abs_err": {k: v for k, v in worst.items()
                                 if k != "layer_share"},
          "logits_limit": limit,
          "argmax_agreement": counts["argmax_same"] / counts["rows"]})
    require(counts["full_steps"] >= SERVE_PARITY_STEPS,
            f"serve parity: {counts['full_steps']} steps with all slots")
    require(grew == len(SERVE_LENGTHS),
            f"serve parity: only {grew} tables grew during decode")
    require(worst["layer_share"] <= 1.0,
            f"serve parity ({pool} pool): a layer's kernel output is "
            f"{worst['layer_share']} x its limit from the gather path's")
    require(worst["cuda_vs_gather"] <= limit,
            f"serve parity ({pool} pool): kernel vs gather logits err "
            f"{worst['cuda_vs_gather']} > {limit}")
    del eng
    torch.cuda.empty_cache()


def phase_serve(torch):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    t0 = time.perf_counter()
    model = LlamaForCausalLM(LlamaConfig.from_preset("llama3-8b"),
                             device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    launches = {}
    streams = {}
    for kv in (None, "int8"):
        report, streams[kv], launches[kv] = _serve_once(torch, model, kv)
        emit({"phase": "serve", "model": "llama3-8b", "dtype": "bfloat16",
              "layers": model.config.num_hidden_layers,
              "params": n_params, "init_s": init_s, **report})
    same = sum(a == b for sa, sb in zip(streams[None], streams["int8"])
               for a, b in zip(sa, sb))
    emit({"phase": "serve", "int8_vs_bf16_pool_token_agreement":
          same / (len(SERVE_LENGTHS) * SERVE_NEW)})
    phase_profile(torch, model)
    for kv in (None, "int8"):
        phase_serve_parity(torch, model, kv)
    del model
    torch.cuda.empty_cache()
    return {"bfloat16": launches[None], "int8": launches["int8"]}


def _debug_model():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    return LlamaForCausalLM(LlamaConfig.from_preset("debug-4l"),
                            device="cuda", seed=1)


DEBUG_KW = dict(max_slots=4, max_len=256, prefill_chunk=32)
DEBUG_LENGTHS = [5, 17, 33, 64, 100, 7]


def _debug_prompts():
    import numpy as np
    rng = np.random.default_rng(2)
    return [rng.integers(0, 1024, L) for L in DEBUG_LENGTHS]


def phase_parity(torch, model):
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.ops import paged_attention as PA
    streams = {}
    launches = 0
    for kernel in ("gather", "cuda"):
        eng = LLMEngine(model, decode_kernel=kernel, **DEBUG_KW)
        PA.paged_attention.launches = 0
        reqs = [eng.submit(p, 24) for p in _debug_prompts()]
        eng.run()
        streams[kernel] = [list(r.tokens) for r in reqs]
        if kernel == "cuda":
            launches = PA.paged_attention.launches
            steps = eng.metrics()["llm_engine_decode_steps_total"][
                "series"][""]["value"]
            require(launches == model.config.num_hidden_layers * steps,
                    f"parity: {launches} launches for {steps} steps")
    require(streams["cuda"] == streams["gather"],
            f"debug-4l fp32: kernel and gather streams differ: "
            f"{streams['cuda']} vs {streams['gather']}")
    emit({"phase": "parity", "model": "debug-4l", "dtype": "float32",
          "requests": len(DEBUG_LENGTHS), "tokens_each": 24,
          "token_exact": True, "kernel_launches": launches})
    return streams["cuda"], launches


def phase_server(torch, model, engine_tokens):
    from paddle_tpu_torch.inference import LLMServer
    srv = LLMServer(model, decode_kernel="cuda", **DEBUG_KW)
    try:
        reqs = [srv.submit(p, 24) for p in _debug_prompts()[:3]]
        got = [list(srv.result(r, timeout=300)) for r in reqs]
    finally:
        srv.shutdown(drain=True)
    require(got == engine_tokens[:3],
            "LLMServer tokens differ from the engine's")
    emit({"phase": "server", "requests": 3, "same_as_engine": True,
          "driver_stopped": not srv._thread.is_alive()})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no paddle_tpu_torch package",
              file=sys.stderr)
        return 2
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase_env(torch)
    phase_build()
    kernels = phase_kernels(torch)
    serve_launches = phase_serve(torch)
    debug = _debug_model()
    tokens, parity_launches = phase_parity(torch, debug)
    phase_server(torch, debug, tokens)

    launches = {"bfloat16": serve_launches["bfloat16"],
                "int8": serve_launches["int8"], "float32": parity_launches}
    path = {"bfloat16": "serve llama3-8b, bf16 pool",
            "int8": "serve llama3-8b, int8 pool",
            "float32": "parity debug-4l fp32"}
    entries = []
    for mode, r in kernels.items():
        entries.append({
            "name": f"paged_attention[{mode}]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_paged_attention.py:93",
            "launches": launches[mode], "launches_path": path[mode],
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    for e in entries:
        require(e["launches"] > 0, f"{e['name']} never launched on its path")
    emit({"kernels": entries})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
