#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the result line:

  1. env      torch / CUDA / nvcc versions, the card's name and power limit;
  2. build    every kernel of the port compiled from paddle_tpu_torch/csrc
              (one nvcc per source, all started together) into
              build/paddle_tpu_torch/, with ptxas's report (registers,
              spills, static shared memory) of the tensor-core kernels of
              K5 and of K1/K2;
  3. kernels  the paged-attention kernel (K4: split-K, a split kernel
              and a merge kernel) against its plain PyTorch version at
              the engine's decode shapes (8 slots, 32 query / 8 kv
              heads, head_dim 128, 16-row blocks, 128-block tables,
              ragged depths with block edges and trash tails, and again
              at the serve phase's own depths) for bf16, fp32 and int8
              pools, twice on the same inputs (bitwise equal), then
              timed in turns (plain, kernel, kernel, plain) by CUDA-graph
              replay (eager back-to-back calls time the host wrapper, not
              the ~20 us kernels; reported beside as eager_ms), beside
              its bound and one PyTorch call that computes the same
              function (scaled_dot_product_attention on the pre-gathered
              view — a yardstick the port never calls);
  3b. train_kernels
              flash attention forward (K1) and backward (K2: dQ, dK/dV)
              and the fused softmax cross-entropy forward and backward
              (K3) against their plain versions at the trainer shape
              (q (2, 2048, 32, 128), k/v (2, 2048, 8, 128) bf16, causal:
              the wgmma variant; logits (2, 2048, 128256) bf16), in bf16
              at head_dim 128 with ragged, unequal Sq / Sk and no causal
              mask, causal with Sq 300 / Sk 512 and Sq 512 / Sk 300
              (masked bottom-right), and in fp32 at smaller shapes and
              fp32 / bf16 at head_dim 16 (the fma variant); K2 bitwise
              repeatable; then timed in turns beside their
              bounds, the CUDA-core kernels bf16 ran on before its
              tensor-core ones (the fma variant, checked and timed in
              this run) and one PyTorch call each
              (scaled_dot_product_attention, cross_entropy: yardsticks
              the port never calls);
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
  6. server   LLMServer answers three requests with the engine's tokens;
  7. train    Llama-3-8B at full width, 4 layers, bf16, random weights:
              6 TrainSteps (AdamW, global-norm clip) on one 2 x 2048
              batch with finite, falling loss and exactly 4 K1, 4 dQ,
              4 dK/dV, 1 K3f and 1 K3b launches per step; step time,
              tokens/s, MFU, peak memory; one profiled step (device
              time by kernel family, idle share); one step with
              recompute "full" against the same step without it; and
              per layer, K1 / K2 against their plain versions on the
              layer's own inputs;
  8. train_parity
              debug-4l in fp32, kernels against plain versions on the
              card: loss, every gradient, and the parameters after two
              TrainSteps;
  9. moe_kernels
              the grouped matmul (K5f: forward, and transposed for the
              input gradient) and its weight gradient (K5b) against
              their plain versions at the MoE train path's first-layer
              shapes (4096 tokens routed top-4 of 60 experts by a gate on
              random tokens into 31744 buffer rows, d 2048, ff 1408,
              bf16: the wgmma variant), at the same widths with an
              absent expert and many padding tiles past the last
              expert's span, and in fp32 at a smaller shape with an
              expert that has no tiles (the fma variant); every absent
              expert's gradient exactly 0, K5b bitwise repeatable, the
              kernels skipping the padding tiles the plain versions
              read; then timed in turns beside their bounds, the
              CUDA-core kernels bf16 ran on before its tensor-core ones
              (the fma variant reading every tile, checked and timed in
              this run) and one PyTorch call each (torch._grouped_mm: a
              yardstick the port never calls);
 10. moe_train
              the JAX package's MoE Llama at Qwen1.5-MoE-A2.7B widths
              (vocab 151936, hidden 2048, 16 / 16 heads, 60 experts of
              ff 1408, top-4, shared expert 5632, dropless), 4 layers,
              bf16, random weights: 6 TrainSteps of llama_loss_fn (aux
              included) with finite, falling loss and exactly 4 K1, 4 dQ,
              4 dK/dV, 1 K3f, 1 K3b, 24 K5f and 12 K5b launches per step;
              step time, tokens/s, MFU (active parameters), peak memory;
              one profiled step; the loss and every gradient with
              recompute "full" against those without it; and per layer,
              K5f / K5b, K1 / K2 and K3 against their plain versions on
              the layer's own inputs;
 11. moe_parity
              qwen2-moe-tiny (dropless, 4 / 2 heads: head_dim 16) in fp32,
              kernels against plain versions on the card: loss, every
              gradient, and the parameters after two TrainSteps.

Then one line {"kernels": [...]} (every ported kernel with its launches
on the paths above, error, tolerance and times), the card's name and
power limit as nvidia-smi gives them, and last the result line
{"ok": true, "device": {...}}.  Without a CUDA card, or run from a
directory without the rest of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
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
          "max_spill_store_bytes": max(spills, default=None),
          "gmm_tensor_core_kernels": _ptxas_report(
              libs["gmm"].with_suffix(".log").read_text(), "wgmma"),
          "flash_tensor_core_kernels": _ptxas_report(
              libs["flash_attention"].with_suffix(".log").read_text(),
              "wgmma")})


def _ptxas_report(log, word):
    """ptxas's registers, spill stores and static shared memory of each
    kernel in `log` whose name holds `word` (the tensor-core kernels'
    rings are dynamic shared memory, sized at launch)."""
    import re
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        m = re.search(r"\d+((?:gmm|flash)_\w*?kernel)((?:IL|L)[^v]*)?",
                      block.split("'", 1)[0])
        if m is None or word not in m.group(1):
            continue
        args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
        find = [re.search(pat, block) for pat in (
            r"Used (\d+) registers", r"(\d+) bytes spill stores",
            r"(\d+) bytes smem")]
        out.append({"kernel": m.group(1) + (f"<{', '.join(args)}>"
                                            if args else ""),
                    **{key: int(f.group(1)) if f else 0 for key, f in zip(
                        ("registers", "spill_store_bytes",
                         "static_smem_bytes"), find)}})
    return out


def _kernel_inputs(torch, mode, copies, gen, depths=KERNEL_POS):
    """`copies` independent pools (so timed launches find the 50 MB L2
    cold, as a decode step's per-layer pools do) + one q, table and
    pos = `depths`."""
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
    for b, p in enumerate(depths):
        n = min(p // s["bt"] + 1 + b % 3, s["bmax"])
        table[b, :n] = perm[k:k + n].to(torch.int32)
        k += n
    pos = torch.tensor(depths, dtype=torch.int32)
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


def _bound(mode, q, out, table, pos, kind, depths=KERNEL_POS):
    """Least time for the function on this card: bytes it must move
    (K/V rows t <= pos once, int8 scales, q, out, table, pos) over the
    memory rate vs. its QK and PV flops over the peak for their type."""
    from paddle_tpu_torch.observability import roofline
    s = KERNEL_SHAPE
    rows = sum(p + 1 for p in depths)
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


def _graph_ms(torch, fn, copies, calls=20, reps=20):
    """Device time of one call of `fn(i)`, cycling `copies` inputs: the
    calls captured in a CUDA graph, the graph replayed `reps` times
    between CUDA events.  K4 is a ~20 us pair of kernels behind a ~40 us
    Python wrapper: launched eagerly back to back, the card waits for
    the host and the events time the wrapper.  Warm-up runs on the
    current stream: every new stream that runs a matmul keeps a cuBLAS
    workspace for the life of the process."""
    for i in range(3):
        fn(i % copies)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % copies)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


def _k4_case(torch, mode, gen, depths, kind):
    """K4 at `depths` for one pool: the kernel against its plain version
    per slot, twice for bitwise repeatability; then in turns (plain,
    kernel, kernel, plain) by graph replay, beside the bound and one
    PyTorch call (scaled_dot_product_attention on the pre-gathered view,
    a yardstick the port never calls).  Kernel launches made here are
    not counted."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_attention as PA
    copies = 4
    launches = PA.LAUNCHES["paged_attention"]
    q, pools, table, pos = _kernel_inputs(torch, mode, copies, gen, depths)
    out = PA.paged_attention(q, *pools[0], table, pos)
    again = PA.paged_attention(q, *pools[0], table, pos)
    torch.cuda.synchronize()
    ref = PA.paged_attention_plain(q, *pools[0], table, pos)
    require(out.dtype == ref.dtype and out.shape == ref.shape,
            f"K4 {mode}: output {out.dtype} {tuple(out.shape)} vs "
            f"plain {ref.dtype} {tuple(ref.shape)}")
    # per slot: a depth-0 slot returns one V row (|out| ~ 3), a
    # 2048-row slot averages to |out| ~ 0.05; one limit over the
    # batch would let the deep slots' errors through
    B = len(depths)
    err_b = (out.float() - ref.float()).abs().reshape(B, -1).amax(1)
    ref_b = ref.float().abs().reshape(B, -1).amax(1)
    limit_b = torch.full_like(ref_b, 1e-5) if mode == "float32" \
        else 2e-2 * ref_b
    share = (err_b / limit_b).max().item()
    require(share <= 1.0,
            f"K4 {mode} at {depths}: per-slot err {err_b.tolist()} over "
            f"limits {limit_b.tolist()}")
    bitwise = torch.equal(out, again)
    require(bitwise, f"K4 {mode}: two calls on the same inputs differ")
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

    p1 = _graph_ms(torch, plain, copies, calls=5)
    k1 = _graph_ms(torch, kern, copies)
    k2 = _graph_ms(torch, kern, copies)
    p2 = _graph_ms(torch, plain, copies, calls=5)
    lib_ms = _graph_ms(torch, lib, copies)
    eager_ms = _time_ms(torch, kern, copies, 50)
    PA.LAUNCHES["paged_attention"] = launches   # checks and timing
    bound_ms, bound_by = _bound(mode, q, out, table, pos, kind, depths)
    res = {"depths": list(depths), "max_abs_err": err_b.max().item(),
           "err_per_slot": err_b.tolist(),
           "max_abs_plain_per_slot": ref_b.tolist(),
           "worst_err_over_limit": share, "bitwise_twice": bitwise,
           "tolerance": TOL[mode], "ms": (k1 + k2) / 2,
           "kernel_ms_turns": [k1, k2], "plain_ms": (p1 + p2) / 2,
           "plain_ms_turns": [p1, p2], "library_ms": lib_ms,
           "eager_ms": eager_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "split_rows": PA.split_rows(
               s["hd"], {"bfloat16": 2, "float32": 4, "int8": 1}[mode])}
    del q, pools, views, out, again, ref
    torch.cuda.empty_cache()
    return res


def phase_kernels(torch):
    kind = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    serve_depths = [L + 16 for L in SERVE_LENGTHS]
    results = {}
    for mode in ("bfloat16", "float32", "int8"):
        results[mode] = _k4_case(torch, mode, gen, KERNEL_POS, kind)
        results[mode]["serve_depths"] = _k4_case(torch, mode, gen,
                                                 serve_depths, kind)
        emit({"phase": "kernels", "kernel": "paged_attention",
              "mode": mode, "timing": "CUDA-graph replay, per call",
              **results[mode]})
    # the graphs' capture stream keeps a cuBLAS workspace (the plain
    # version and SDPA run matmuls): release it, so later phases' peak
    # memory counts only their own work
    torch._C._cuda_clearCublasWorkspaces()
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
    PA.LAUNCHES["paged_attention"] = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, SERVE_NEW, on_token=on_token) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.LAUNCHES["paged_attention"]
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


def _device_spans(prof):
    """[(name, start µs, end µs)] of the activities the profiler saw on
    the card."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and e.time_range.end > e.time_range.start]


def _union_us(spans):
    """Length of the union of (start, end) spans: K4's merge kernel is
    launched as a programmatic dependent and is resident (waiting) while
    the split kernel runs, so the two overlap and a sum would count the
    overlap twice."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


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
        spans = _device_spans(prof)
        require(spans, "profile: device times without device spans")
        # ms per step: the union of the card's busy spans
        busy = _union_us([(a, b) for _, a, b in spans]) / 1e3 / steps
        # one stream: the card cannot be busy longer than the wall time
        # of the same steps, nor (device times move ~1 % between runs)
        # than an unprofiled step; more means events were counted twice
        require(busy <= prof_step_ms and busy <= step_ms,
                f"profile: device busy {busy} ms per step exceeds the "
                f"step ({prof_step_ms} ms profiled, {step_ms} ms not)")
        k4 = _union_us([(a, b) for n, a, b in spans   # split + merge
                        if "paged_split_kernel" in n
                        or "paged_merge_kernel" in n]) / 1e3 / steps
        gemm = sum(v for k, v in dev.items()
                   if any(w in k.lower() for w in ("gemm", "gemv", "cutlass",
                                                   "sm90_xmma", "nvjet")))
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
        report.update({
            "device_busy_ms_per_step": busy,
            "device_kernel_sum_ms_per_step": sum(dev.values()) / 1e3 / steps,
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
        before = PA.LAUNCHES["paged_attention"]
        D.paged_attention = kernel_checked
        try:
            logits, pool = step(*args, kernel=kernel)
        finally:
            D.paged_attention = kernel_fn
        require(PA.LAUNCHES["paged_attention"] - before
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
        PA.LAUNCHES["paged_attention"] = 0
        reqs = [eng.submit(p, 24) for p in _debug_prompts()]
        eng.run()
        streams[kernel] = [list(r.tokens) for r in reqs]
        if kernel == "cuda":
            launches = PA.LAUNCHES["paged_attention"]
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


# --------------------------------------------------------------------------
# training slice: kernels K1 (flash forward), K2 (flash backward: dQ and
# dK/dV) and K3 (fused softmax cross-entropy, forward and backward)
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 2048
TRAIN_LAYERS = 4          # full width; 32 layers need ~64 GB of state
TRAIN_STEPS = 6
FLASH_SHAPE = dict(H=32, Hkv=8, D=128)          # llama3-8b attention
# the other cases: (B, Sq, H, Hkv, D, dtype, Sk, causal); Sq = 300 has a
# ragged last tile, D = 32 is debug-4l's head_dim, D = 16 the tiny
# presets'; the bf16 cases at D 128 run the wgmma variant, one with
# Sk = 77 < one kv tile and no causal mask, two causal with Sq != Sk
# (masked bottom-right; at Sq > Sk the first Sq - Sk rows see no key:
# O NaN and lse -inf in both), the rest the fma variant
FLASH_CASES = [(1, 300, 8, 2, 128, "bfloat16", 77, False),
               (1, 300, 8, 2, 128, "bfloat16", 512, True),
               (1, 512, 8, 2, 128, "bfloat16", 300, True),
               (1, 512, 8, 2, 128, "float32", 512, True),
               (2, 300, 8, 4, 32, "float32", 300, True),
               (2, 256, 4, 2, 16, "float32", 256, True),
               (2, 256, 4, 2, 16, "bfloat16", 256, True)]
XENT_FP32_ROWS = (2, 256)
# kernel vs plain on the same inputs.  O, dQ: per (b, query row, head);
# dK, dV: per (b, key row, kv head): max|err| over head_dim <= tol x
# that row's max |plain|.  Rows deep in a causal sequence average ~1000
# keys and are ~100x smaller than the first rows, so a limit per head
# or per tensor would not see them.  bf16: both round an fp32 result
# whose sums run in another order to bf16 once, so they are at most
# one bf16 ulp (<= 2^-7 x the value) apart.
FLASH_TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
LSE_TOL = 1e-5            # per element, x max(1, |lse|), fp32 in both
# dlogits per element: |err| <= tol x |plain| (a typical non-label
# entry is ~1e-5 of its row's max, so a per-row limit would not see it)
XENT_GRAD_TOL = {"bfloat16": 2 ** -7, "float32": 1e-6}
FLASH_TOL_TEXT = ("O, dQ per (b, query row, head), dK, dV per (b, key "
                  "row, kv head): max|err| <= {tol} x max|plain| of the "
                  "row; lse per element |err| <= 1e-05 x max(1, |lse|)")
XENT_TOL_TEXT = ("loss, lse per row |err| <= 1e-05 x max(1, |lse|); "
                 "dlogits per element |err| <= {tol} x |plain|")
TRAIN_KERNELS = {         # name (its key in the module's LAUNCHES) ->
    #                         (module, replaces)
    "flash_attention_fwd": ("flash_attention",
                            "paddle_tpu/ops/pallas_attention.py:62"),
    "flash_attention_dq": ("flash_attention",
                           "paddle_tpu/ops/pallas_attention.py:147"),
    "flash_attention_dkv": ("flash_attention",
                            "paddle_tpu/ops/pallas_attention.py:185"),
    "softmax_xent_fwd": ("softmax_xent", "paddle_tpu/ops/pallas_ce.py:47"),
    "softmax_xent_bwd": ("softmax_xent", "paddle_tpu/ops/pallas_ce.py:89"),
}
ALSO_REPLACES = {         # the tiled K2 variant (S > 4096 on the TPU)
    "flash_attention_dq": "paddle_tpu/ops/pallas_attention.py:283",
    "flash_attention_dkv": "paddle_tpu/ops/pallas_attention.py:330",
}


def _launches(name):
    """The LAUNCHES dict of the module that holds kernel `name`."""
    import importlib
    mod = TRAIN_KERNELS[name][0]
    return importlib.import_module(f"paddle_tpu_torch.ops.{mod}").LAUNCHES


def _set_train_counts(counts):
    for name, n in counts.items():
        _launches(name)[name] = n


def _zero_train_counts():
    _set_train_counts(dict.fromkeys(TRAIN_KERNELS, 0))


def _train_counts():
    return {name: _launches(name)[name] for name in TRAIN_KERNELS}


def _seen(got, want, blind):
    """`got` and `want` in fp32 with the rows that see no key (`blind`:
    NaN, or lse -inf, in the plain version; causal Sq > Sk) set to 0,
    after requiring the kernel to mark exactly those rows."""
    got, want = got.float(), want.float()
    mark = blind(want)
    require(bool((blind(got) == mark).all()),
            "flash: rows that see no key differ between kernel and plain")
    return got.masked_fill(mark, 0.0), want.masked_fill(mark, 0.0)


def _per_row_share(got, want, tol):
    """max over the rows (b, s, head) of (B, S, H, D) tensors of
    max|got - want| / (tol * max|want|) over head_dim."""
    got, want = _seen(got, want, lambda x: x.isnan())
    err = (got - want).abs().amax(-1)
    ref = want.abs().amax(-1).clamp_min(1e-30)
    return (err / (tol * ref)).max().item()


def _lse_share(lse, plse):
    """max over elements of |lse - plse| / (LSE_TOL * max(1, |plse|))."""
    lse, plse = _seen(lse, plse, lambda x: x.isinf())
    return ((lse - plse).abs() / (LSE_TOL * plse.abs().clamp_min(1.0))) \
        .max().item()


def _flash_compare(torch, q, k, v, do, causal=True, variant=None):
    """K1 and K2 (the given variant, else the one the wrapper picks)
    against their plain versions on the same inputs (K2 on the plain O
    and lse).  Returns {output: (max abs err, worst share of its
    limit)}."""
    from paddle_tpu_torch.ops import flash_attention as FA
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    o, lse = FA.flash_fwd(q, k, v, causal, variant=variant)
    po, plse = FA.flash_fwd_plain(q, k, v, causal)
    grads = (FA.flash_bwd_dq(q, k, v, po, plse, do, causal, variant=variant),
             *FA.flash_bwd_dkv(q, k, v, po, plse, do, causal,
                               variant=variant))
    torch.cuda.synchronize()
    plain = FA.flash_bwd_plain(q, k, v, po, plse, do, causal)
    o_s, po_s = _seen(o, po, lambda x: x.isnan())
    lse_s, plse_s = _seen(lse, plse, lambda x: x.isinf())
    out = {"o": ((o_s - po_s).abs().max().item(),
                 _per_row_share(o, po, tol)),
           "lse": ((lse_s - plse_s).abs().max().item(),
                   _lse_share(lse, plse))}
    for n, g, p in zip(("dq", "dk", "dv"), grads, plain):
        require(g.dtype == p.dtype and g.shape == p.shape,
                f"K2 {n}: {g.dtype} {tuple(g.shape)} vs plain {p.dtype} "
                f"{tuple(p.shape)}")
        out[n] = ((g.float() - p.float()).abs().max().item(),
                  _per_row_share(g, p, tol))
    return out


def _flash_inputs(torch, B, S, H, Hkv, D, dtype, gen, Sk=None):
    def rnd(s, h):
        return torch.randn(B, s, h, D, device="cuda", generator=gen) \
            .to(dtype)
    Sk = S if Sk is None else Sk
    return rnd(S, H), rnd(Sk, Hkv), rnd(Sk, Hkv), rnd(S, H)


def _xent_inputs(torch, B, S, V, dtype, gen):
    """Logits ~ N(0, 9) and labels in the causal loss's layout: the last
    position of each sequence carries label -1 (ignored)."""
    x = (3 * torch.randn(B, S, V, device="cuda", generator=gen)).to(dtype)
    lab = torch.randint(0, V, (B, S), device="cuda", generator=gen,
                        dtype=torch.int32)
    lab[:, -1] = -1
    return x, lab


def _xent_compare(torch, x, lab):
    from paddle_tpu_torch.ops import softmax_xent as SX
    dt = str(x.dtype).split(".")[-1]
    loss, lse = SX.softmax_xent_fwd(x, lab)
    ploss, plse = SX.softmax_xent_plain(x, lab)
    g = torch.full(lab.shape, 1.0 / (lab >= 0).sum().item(), device="cuda")
    d = SX.softmax_xent_bwd(x, lab, plse, g)
    torch.cuda.synchronize()
    pd = SX.softmax_xent_bwd_plain(x, lab, plse, g)
    lim = LSE_TOL * plse.abs().clamp_min(1.0)
    require(d.dtype == pd.dtype and d.shape == pd.shape, "K3b dtype/shape")
    require(not d[:, -1].any(), "K3b: ignored rows must be zero")
    keep = lab >= 0
    err = (d[keep].float() - pd[keep].float()).abs()
    lim_d = XENT_GRAD_TOL[dt] * pd[keep].float().abs().clamp_min(1e-30)
    return {"loss": ((loss - ploss).abs().max().item(),
                     ((loss - ploss).abs() / lim).max().item()),
            "lse": ((lse - plse).abs().max().item(),
                    ((lse - plse).abs() / lim).max().item()),
            "dlogits": (err.max().item(), (err / lim_d).max().item())}


def _pairs(S):
    return S * (S + 1) // 2           # (query, key) pairs a causal row set keeps


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _bound_ms(kind, flops, nbytes, flops_dtype="bfloat16"):
    """The least time for the work on this card: bytes over the memory
    rate vs operations over the peak for their type."""
    from paddle_tpu_torch.observability import roofline
    t_ops = flops / roofline.peak_flops(kind, flops_dtype)
    t_bytes = nbytes / roofline.peak_hbm_bw(kind)
    return 1e3 * max(t_ops, t_bytes), \
        ("bytes" if t_bytes >= t_ops else "operations")


def _in_turns(torch, plain, kern, iters):
    """Plain, kernel, kernel, plain, each a CUDA-event mean over
    `iters` launches after warm-up; returns (kernel ms, plain ms, the
    four turns)."""
    p1 = _time_ms(torch, lambda i: plain(), 1, iters)
    k1 = _time_ms(torch, lambda i: kern(), 1, iters)
    k2 = _time_ms(torch, lambda i: kern(), 1, iters)
    p2 = _time_ms(torch, lambda i: plain(), 1, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, [p1, k1, k2, p2]


def phase_train_kernels(torch):
    """K1, K2 and K3 against their plain versions at the trainer shape
    in bf16 and at smaller shapes in fp32; then timed in turns beside
    their bounds and one PyTorch call each (scaled_dot_product_attention
    forward / backward, cross_entropy forward / backward: yardsticks the
    port never calls)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import softmax_xent as SX
    kind = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    saved = _train_counts()
    res = {}

    # ---- flash attention: correctness
    fs = FLASH_SHAPE
    q, k, v, do = _flash_inputs(torch, TRAIN_B, TRAIN_S, fs["H"],
                                fs["Hkv"], fs["D"], torch.bfloat16, gen)
    train_variant = FA._variant(q.dtype, fs["D"])
    cmp = {f"bfloat16 {train_variant}": _flash_compare(torch, q, k, v, do)}
    for B, S, H, Hkv, D, dt, Sk, causal in FLASH_CASES:
        dtype = getattr(torch, dt)
        key = (f"{dt} {FA._variant(dtype, D)} (B {B}, Sq {S}, Sk {Sk}, "
               f"{H} / {Hkv} heads, D {D}, "
               f"{'causal' if causal else 'no mask'})")
        cmp[key] = _flash_compare(
            torch, *_flash_inputs(torch, B, S, H, Hkv, D, dtype, gen, Sk),
            causal)
    # the CUDA-core kernels on the train shape's bf16 (timed below)
    cmp["bfloat16 fma"] = _flash_compare(torch, q, k, v, do, variant="fma")
    for key, c in cmp.items():
        emit({"phase": "train_kernels", "kernel": "flash_attention",
              "case": key,
              "tolerance": FLASH_TOL_TEXT.format(tol=FLASH_TOL[
                  key.split()[0]]),
              **{f"{n}_max_abs_err": e for n, (e, _) in c.items()},
              **{f"{n}_worst_err_over_limit": s for n, (_, s) in c.items()}})
        for n, (_, s) in c.items():
            require(s <= 1.0, f"flash {key} {n}: {s} x its limit")

    # ---- K2: no atomics, so two calls on the same inputs give the same
    # bits
    o, lse = FA.flash_fwd(q, k, v, True)
    delta = FA._delta(o, do)
    first = (FA.flash_bwd_dq(q, k, v, o, lse, do, True, delta=delta),
             *FA.flash_bwd_dkv(q, k, v, o, lse, do, True, delta=delta))
    again = (FA.flash_bwd_dq(q, k, v, o, lse, do, True, delta=delta),
             *FA.flash_bwd_dkv(q, k, v, o, lse, do, True, delta=delta))
    bitwise = {n: torch.equal(x, y)
               for n, x, y in zip(("dq", "dk", "dv"), first, again)}
    emit({"phase": "train_kernels", "kernel": "flash_attention",
          "case": f"bfloat16 {train_variant}, twice on the same inputs",
          "bitwise_equal": bitwise})
    require(all(bitwise.values()), f"K2 not bitwise repeatable: {bitwise}")
    del first, again

    # ---- flash attention: times at the trainer shape (bf16, causal)
    qT, kT, vT, doT = (x.transpose(1, 2) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qT, kT, vT))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             enable_gqa=True)

    def lib_fwd():
        F.scaled_dot_product_attention(qT, kT, vT, is_causal=True,
                                       enable_gqa=True)

    def lib_bwd():
        torch.autograd.grad(lib_out, (qg, kg, vg), doT, retain_graph=True)

    fwd_ms, fwd_plain, fwd_turns = _in_turns(
        torch, lambda: FA.flash_fwd_plain(q, k, v, True),
        lambda: FA.flash_fwd(q, k, v, True), 5)
    dq_ms, bwd_plain, dq_turns = _in_turns(
        torch, lambda: FA.flash_bwd_plain(q, k, v, o, lse, do, True),
        lambda: FA.flash_bwd_dq(q, k, v, o, lse, do, True, delta=delta), 5)
    dkv_ms, bwd_plain2, dkv_turns = _in_turns(
        torch, lambda: FA.flash_bwd_plain(q, k, v, o, lse, do, True),
        lambda: FA.flash_bwd_dkv(q, k, v, o, lse, do, True, delta=delta), 5)
    bwd_plain_turns = [dq_turns[0], dq_turns[3], dkv_turns[0],
                       dkv_turns[3]]
    lib_fwd_ms = _time_ms(torch, lambda i: lib_fwd(), 1, 10)
    lib_bwd_ms = _time_ms(torch, lambda i: lib_bwd(), 1, 10)
    # the CUDA-core kernels bf16 ran on before the tensor-core ones
    core_ms = {
        "flash_attention_fwd": _time_ms(torch, lambda i: FA.flash_fwd(
            q, k, v, True, variant="fma"), 1, 3),
        "flash_attention_dq": _time_ms(torch, lambda i: FA.flash_bwd_dq(
            q, k, v, o, lse, do, True, delta=delta, variant="fma"), 1, 3),
        "flash_attention_dkv": _time_ms(torch, lambda i: FA.flash_bwd_dkv(
            q, k, v, o, lse, do, True, delta=delta, variant="fma"), 1, 3)}
    B, S, H, D = q.shape
    mm = 2.0 * B * H * D * _pairs(S)      # flops of one causal product
    io = _nbytes(q, k, v)
    rows = _nbytes(lse, delta)
    bounds = {"flash_attention_fwd": _bound_ms(kind, 2 * mm,
                                               io + _nbytes(o, lse)),
              # S = QK^T, dP = dO V^T, dQ = dS K
              "flash_attention_dq": _bound_ms(kind, 3 * mm,
                                              io + _nbytes(do, q) + rows),
              # S, dP, dV = P^T dO, dK = dS^T Q
              "flash_attention_dkv": _bound_ms(kind, 4 * mm,
                                               io + _nbytes(do, k, v) + rows)}
    b16 = cmp[f"bfloat16 {train_variant}"]
    res["flash_attention_fwd"] = {
        "max_abs_err": b16["o"][0], "lse_max_abs_err": b16["lse"][0],
        "ms": fwd_ms, "plain_ms": fwd_plain, "turns_ms": fwd_turns,
        "library_ms": lib_fwd_ms,
        "library": "scaled_dot_product_attention(is_causal, enable_gqa)",
        "cuda_core_ms": core_ms["flash_attention_fwd"]}
    for name, ms, turns, n in (("flash_attention_dq", dq_ms, dq_turns,
                                ("dq",)),
                               ("flash_attention_dkv", dkv_ms, dkv_turns,
                                ("dk", "dv"))):
        res[name] = {"max_abs_err": max(b16[x][0] for x in n), "ms": ms,
                     "plain_ms": (bwd_plain + bwd_plain2) / 2,
                     "plain_computes": "dQ, dK and dV together",
                     "turns_ms": turns, "plain_turns_ms": bwd_plain_turns,
                     "library_ms": lib_bwd_ms,
                     "library": "backward of scaled_dot_product_attention "
                                "(dQ, dK, dV together)",
                     "cuda_core_ms": core_ms[name]}
    del q, k, v, do, o, lse, delta, qT, kT, vT, doT, qg, kg, vg, lib_out
    torch.cuda.empty_cache()

    # ---- cross-entropy: correctness at the trainer shape (bf16) and
    # an fp32 case, the full vocabulary
    V = 128256
    x, lab = _xent_inputs(torch, TRAIN_B, TRAIN_S, V, torch.bfloat16, gen)
    xcmp = {"bfloat16": _xent_compare(torch, x, lab)}
    xcmp["float32"] = _xent_compare(
        torch, *_xent_inputs(torch, *XENT_FP32_ROWS, V, torch.float32, gen))
    for key, c in xcmp.items():
        emit({"phase": "train_kernels", "kernel": "softmax_xent",
              "case": f"{key} V={V}",
              "tolerance": XENT_TOL_TEXT.format(tol=XENT_GRAD_TOL[key]),
              **{f"{n}_max_abs_err": e for n, (e, _) in c.items()},
              **{f"{n}_worst_err_over_limit": s for n, (_, s) in c.items()}})
        for n, (_, s) in c.items():
            require(s <= 1.0, f"softmax_xent {key} {n}: {s} x its limit")
    torch.cuda.empty_cache()

    # ---- cross-entropy: times at the trainer shape (bf16)
    loss, lse = SX.softmax_xent_fwd(x, lab)
    g = torch.full(lab.shape, 1.0 / (lab >= 0).sum().item(), device="cuda")
    x2, lab2 = x.view(-1, V), lab.view(-1).long()
    xg = x2.detach().requires_grad_()
    lib_loss = F.cross_entropy(xg, lab2, ignore_index=-1, reduction="none")

    def lib_xent_bwd():
        torch.autograd.grad(lib_loss, xg, g.view(-1), retain_graph=True)

    xf_ms, xf_plain, xf_turns = _in_turns(
        torch, lambda: SX.softmax_xent_plain(x, lab),
        lambda: SX.softmax_xent_fwd(x, lab), 5)
    xb_ms, xb_plain, xb_turns = _in_turns(
        torch, lambda: SX.softmax_xent_bwd_plain(x, lab, lse, g),
        lambda: SX.softmax_xent_bwd(x, lab, lse, g), 5)
    lib_xf = _time_ms(torch, lambda i: F.cross_entropy(
        x2, lab2, ignore_index=-1, reduction="none"), 1, 10)
    lib_xb = _time_ms(torch, lambda i: lib_xent_bwd(), 1, 10)
    kept = int((lab >= 0).sum().item())
    row_bytes = V * x.element_size()
    small = _nbytes(lab) + 2 * 4 * lab.numel()       # labels; loss + lse or lse + g
    # ~4 fp32 operations per logit (max, subtract, exp, add), CUDA cores
    bounds["softmax_xent_fwd"] = _bound_ms(
        kind, 4.0 * kept * V, kept * row_bytes + small, "float32")
    bounds["softmax_xent_bwd"] = _bound_ms(
        kind, 4.0 * kept * V, kept * row_bytes + _nbytes(x) + small,
        "float32")
    res["softmax_xent_fwd"] = {
        "max_abs_err": xcmp["bfloat16"]["loss"][0], "ms": xf_ms,
        "plain_ms": xf_plain, "turns_ms": xf_turns, "library_ms": lib_xf,
        "library": "cross_entropy(reduction='none', ignore_index=-1)"}
    res["softmax_xent_bwd"] = {
        "max_abs_err": xcmp["bfloat16"]["dlogits"][0], "ms": xb_ms,
        "plain_ms": xb_plain, "turns_ms": xb_turns, "library_ms": lib_xb,
        "library": "backward of cross_entropy"}
    del x, lab, x2, lab2, xg, lib_loss, loss, lse, g
    torch.cuda.empty_cache()

    for name, r in res.items():
        r["bound_ms"], r["bound_by"] = bounds[name]
        text, tol = ((FLASH_TOL_TEXT, FLASH_TOL) if name.startswith("flash")
                     else (XENT_TOL_TEXT, XENT_GRAD_TOL))
        r["tolerance"] = text.format(tol=f"{tol['bfloat16']} (bf16)")
        if name.startswith("flash"):
            r["variant"] = (f"{train_variant} (bf16, head_dim 128); fp32 "
                            f"and head_dim 16 / 32 / 64 run fma")
            r["cuda_core"] = ("cuda_core_ms: the fma variant on bf16, the "
                              "kernel bf16 ran on before wgmma, timed in "
                              "this run")
        emit({"phase": "train_kernels", "kernel": name,
              "shape": "q (2, 2048, 32, 128), k/v (2, 2048, 8, 128) bf16, "
                       "causal" if name.startswith("flash") else
                       "logits (2, 2048, 128256) bf16, 2 x 2047 rows kept",
              **r})
    _set_train_counts(saved)             # timing launches do not count
    return res


def _train_setup(torch, cfg, lr, clip, seed, loss_fn=None):
    """(model, TrainStep) with AdamW and a global-norm clip; the loss is
    the causal-LM criterion unless `loss_fn` is given."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    crit = LlamaPretrainingCriterion()
    opt = AdamW(learning_rate=lr, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(clip))
    return model, TrainStep(model, loss_fn or (lambda m, ids: crit(m(ids),
                                                                   ids)), opt)


def _train_ids(torch, cfg, B, S, seed):
    import numpy as np
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return torch.from_numpy(ids).to("cuda")


def _train_profile(torch, step, ids, step_ms):
    """Device time of one training step by kernel family, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    dev = _device_times(prof)
    if dev is None:
        return {"device_time": "not measured (no device events)"}
    families = {"k1_flash_fwd": ("flash_fwd_kernel", "flash_fwd_wgmma"),
                "k2_flash_bwd": ("flash_dq_kernel", "flash_dkv_kernel",
                                 "flash_dq_wgmma", "flash_dkv_wgmma"),
                "k3_softmax_xent": ("xent_fwd_kernel", "xent_bwd_kernel"),
                "k5_gmm": ("gmm_fwd", "gmm_drhs"),
                "gemm": ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")}
    split = {f: 0.0 for f in families}
    split["other"] = 0.0
    for key, us in dev.items():
        low = key.lower()
        fam = next((f for f, words in families.items()
                    if any(w.lower() in low for w in words)), "other")
        split[fam] += us / 1e3
    busy = sum(split.values())
    # one stream: the card cannot be busy longer than the wall time of
    # the same step; more means events were counted twice
    require(busy <= prof_ms, f"train profile: device busy {busy} ms exceeds "
            f"the profiled step's {prof_ms} ms")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_step_ms": prof_ms, "device_busy_ms": busy,
            **{f"{f}_ms": v for f, v in split.items()},
            "device_idle_share": 1 - busy / step_ms,
            "device_idle_share_of_profiled_step": 1 - busy / prof_ms,
            "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]}


@contextlib.contextmanager
def _checked_flash():
    """Every flash_fwd / flash_bwd call inside the block also runs the
    plain version on the same inputs; yields the worst per-row share of
    the limit (K1: O and lse; K2: dQ, dK, dV) and the calls."""
    from paddle_tpu_torch.ops import flash_attention as FA
    worst = {"calls_fwd": 0, "calls_bwd": 0, "o": 0.0, "lse": 0.0,
             "dq": 0.0, "dk": 0.0, "dv": 0.0}
    fwd, bwd = FA.flash_fwd, FA.flash_bwd

    def fwd_checked(q, k, v, causal=True, scale=None):
        o, lse = fwd(q, k, v, causal, scale)
        po, plse = FA.flash_fwd_plain(q, k, v, causal, scale)
        tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
        worst["o"] = max(worst["o"], _per_row_share(o, po, tol))
        worst["lse"] = max(worst["lse"], _lse_share(lse, plse))
        worst["calls_fwd"] += 1
        return o, lse

    def bwd_checked(q, k, v, o, lse, do, causal=True, scale=None):
        got = bwd(q, k, v, o, lse, do, causal, scale)
        plain = FA.flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
        tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
        for n, g, p in zip(("dq", "dk", "dv"), got, plain):
            worst[n] = max(worst[n], _per_row_share(g, p, tol))
        worst["calls_bwd"] += 1
        return got

    FA.flash_fwd, FA.flash_bwd = fwd_checked, bwd_checked
    try:
        yield worst
    finally:
        FA.flash_fwd, FA.flash_bwd = fwd, bwd


def phase_train(torch):
    """Llama-3-8B at full width, TRAIN_LAYERS layers, bf16, random
    weights from a seed: TRAIN_STEPS TrainSteps (AdamW lr 1e-4, wd 0.01,
    global-norm clip 1.0, as bench.py) on one fixed 2 x 2048 batch; one
    profiled step; one step with recompute "full" against the same step
    without it; then, per layer, K1 and K2 against their plain versions
    on that layer's own inputs."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.observability import roofline
    kind = torch.cuda.get_device_name(0)
    cfg = LlamaConfig.from_preset("llama3-8b",
                                  num_hidden_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    model, step = _train_setup(torch, cfg, 1e-4, 1.0, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ids = _train_ids(torch, cfg, TRAIN_B, TRAIN_S, seed=0)
    # the initial state, kept on the host for the recompute check below
    def host(t):
        return t.detach().to("cpu", copy=True)
    init = {"params": {n: host(p) for n, p in step.params.items()},
            "buffers": {}, "step": 0,
            "opt_state": {n: {k: host(v) for k, v in st.items()}
                          for n, st in step.opt_state.items()}}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(step(ids).item())          # .item() synchronises
        secs.append(time.perf_counter() - t)
    launches = _train_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    L = TRAIN_LAYERS
    want = {"flash_attention_fwd": L * TRAIN_STEPS,
            "flash_attention_dq": L * TRAIN_STEPS,
            "flash_attention_dkv": L * TRAIN_STEPS,
            "softmax_xent_fwd": TRAIN_STEPS, "softmax_xent_bwd": TRAIN_STEPS}
    require(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    require(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    require(launches == want, f"train launches {launches} != {want}")
    # step 1 pays one-time set-up (cuBLAS handles, library loads)
    step_ms = 1e3 * sorted(secs[1:])[len(secs[1:]) // 2]
    tokens = TRAIN_B * TRAIN_S
    tok_s = tokens / (step_ms / 1e3)
    # bench.py's formula: 6 N per token + causal attention 6 L h S
    flops_per_token = 6.0 * n_params + 6.0 * L * cfg.hidden_size * TRAIN_S
    mfu = tok_s * flops_per_token / roofline.peak_flops(kind, "bfloat16")
    report = {"phase": "train", "model": f"llama3-8b, {L} layers",
              "dtype": "bfloat16", "params": n_params, "batch": TRAIN_B,
              "seq": TRAIN_S, "steps": TRAIN_STEPS, "init_s": init_s,
              "losses": losses, "step_ms_each": [1e3 * s for s in secs],
              "step_ms": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
              "peak_mem_gib": peak_gib, "launches": launches}
    report.update(_train_profile(torch, step, ids, step_ms))
    emit(report)

    # recompute "full": the first step again from the initial state,
    # without and with recompute; the loss is the forward of the same
    # weights
    step.set_state_dict(init)
    _zero_train_counts()
    loss_plain = step(ids).item()
    n_plain = _train_counts()
    after = {n: p.detach().clone() for n, p in step.params.items()}
    step.set_state_dict(init)
    del init
    cfg.recompute = True
    _zero_train_counts()
    try:
        loss_remat = step(ids).item()
    finally:
        cfg.recompute = False
    n_remat = _train_counts()
    dparam = max((p.float() - after[n].float()).abs().max().item()
                 for n, p in step.params.items())
    del after
    torch.cuda.empty_cache()
    emit({"phase": "train_recompute", "policy": "full",
          "loss_first_step": losses[0], "loss": loss_plain,
          "loss_recompute": loss_remat,
          "tolerance": "|loss_recompute - loss| <= 2^-8 x |loss|",
          "max_abs_param_diff_after_step": dparam,
          "launches": n_plain, "launches_recompute": n_remat})
    require(n_plain["flash_attention_fwd"] == L
            and n_remat["flash_attention_fwd"] == 2 * L
            and n_remat["flash_attention_dq"] == L,
            f"recompute launches {n_plain} / {n_remat}")
    require(abs(loss_remat - loss_plain) <= 2 ** -8 * abs(loss_plain),
            f"recompute loss {loss_remat} vs {loss_plain}")

    # per layer at full width: K1 / K2 on each layer's own inputs
    with _checked_flash() as worst:
        loss = step.loss_fn(model, ids)
        loss.backward()
    torch.cuda.synchronize()
    for p in model.parameters():
        p.grad = None
    emit({"phase": "train_parity", "model": f"llama3-8b, {L} layers",
          "dtype": "bfloat16", "check": "per layer: kernel vs plain on "
          "the layer's own q, k, v (K1) and O, lse, dO (K2)",
          "tolerance": FLASH_TOL_TEXT.format(tol=FLASH_TOL["bfloat16"]),
          "worst_err_over_limit": {k: v for k, v in worst.items()
                                   if not k.startswith("calls")},
          "layers_checked_fwd": worst["calls_fwd"],
          "layers_checked_bwd": worst["calls_bwd"]})
    require(worst["calls_fwd"] == L and worst["calls_bwd"] == L,
            f"train parity: {worst['calls_fwd']} / {worst['calls_bwd']} "
            f"layers checked")
    require(all(v <= 1.0 for k, v in worst.items()
                if not k.startswith("calls")),
            f"train parity: a layer's kernel output over its limit {worst}")
    del model, step, loss
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _plain_kernels():
    """The flash, cross-entropy and grouped-matmul wrappers run their
    plain PyTorch versions on the card inside the block."""
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import gmm as G
    from paddle_tpu_torch.ops import softmax_xent as SX
    saved = (FA.flash_fwd, FA.flash_bwd, SX.softmax_xent_fwd,
             SX.softmax_xent_bwd, G.gmm_fwd, G.gmm_drhs)
    FA.flash_fwd, FA.flash_bwd = FA.flash_fwd_plain, FA.flash_bwd_plain
    SX.softmax_xent_fwd = SX.softmax_xent_plain
    SX.softmax_xent_bwd = SX.softmax_xent_bwd_plain
    G.gmm_fwd, G.gmm_drhs = G.gmm_plain, G.gmm_drhs_plain
    try:
        yield
    finally:
        (FA.flash_fwd, FA.flash_bwd, SX.softmax_xent_fwd,
         SX.softmax_xent_bwd, G.gmm_fwd, G.gmm_drhs) = saved


PARITY_LRS = (2e-4, 6e-4)       # LinearWarmup(2e-4 -> 1e-3 over 2 steps)


def phase_train_parity(torch):
    """debug-4l in fp32 on the card, the kernels against their plain
    versions: the loss and every parameter's gradient, then the losses
    and parameters of two TrainSteps (AdamW under LinearWarmup, global-
    norm clip 0.5).  Tolerances: loss 1e-5 relative; each gradient
    within 1e-4 x its max |plain|; each parameter within 5e-2 x the
    summed lr (Adam scales every element's step to ~lr, so a small
    gradient's relative rounding shows there)."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.optimizer import lr as tlr
    cfg = LlamaConfig.from_preset("debug-4l")
    ids = _train_ids(torch, cfg, 2, 128, seed=4)
    out = {}
    for mode in ("plain", "cuda"):
        sched = tlr.LinearWarmup(1e-3, warmup_steps=2, start_lr=2e-4,
                                 end_lr=1e-3)
        model, step = _train_setup(torch, cfg, sched, 0.5, seed=1)
        _zero_train_counts()
        with (_plain_kernels() if mode == "plain"
              else contextlib.nullcontext()):
            loss = step.loss_fn(model, ids)
            loss.backward()
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            for p in model.parameters():
                p.grad = None
            losses = []
            for _ in range(2):
                losses.append(step(ids).item())
                sched.step()
        out[mode] = (loss.item(), grads, losses,
                     {n: p.detach().clone() for n, p in step.params.items()},
                     _train_counts())
        del model, step
    (lp, gp, lsp, pp, cp), (lk, gk, lsk, pk, ck) = out["plain"], out["cuda"]
    require(all(v == 0 for v in cp.values()), f"plain run launched {cp}")
    require(all(v > 0 for v in ck.values()), f"kernel run launches {ck}")
    g_share = max((gk[n] - gp[n]).abs().max().item()
                  / (1e-4 * gp[n].abs().max().clamp_min(1e-30).item())
                  for n in gp)
    p_err = max((pk[n] - pp[n]).abs().max().item() for n in pp)
    p_limit = 5e-2 * sum(PARITY_LRS)
    emit({"phase": "train_parity", "model": "debug-4l", "dtype": "float32",
          "loss_plain": lp, "loss_cuda": lk, "losses_plain": lsp,
          "losses_cuda": lsk, "grads_compared": len(gp),
          "grad_worst_err_over_limit": g_share,
          "param_max_abs_err_after_2_steps": p_err,
          "param_limit": p_limit, "launches": ck,
          "tolerance": "loss 1e-5 rel; grad per param 1e-4 x max|plain|; "
                       "params 5e-2 x summed lr"})
    for a, b in zip([lk] + lsk, [lp] + lsp):
        require(abs(a - b) <= 1e-5 * abs(b),
                f"debug-4l loss {a} vs plain {b}")
    require(g_share <= 1.0, f"debug-4l grads: {g_share} x the limit")
    require(p_err <= p_limit, f"debug-4l params after 2 steps: {p_err}")


# --------------------------------------------------------------------------
# MoE slice: kernels K5f (grouped matmul; also the input gradient, reading
# the weights transposed) and K5b (its weight gradient)
# --------------------------------------------------------------------------

MOE_LAYERS = 4            # full width; 24 layers hold 14.3 B parameters
MOE_BM = 256              # moe_dropless_ffn's block_m
MOE_KERNELS = {           # name (its key in ops/gmm.py's LAUNCHES) -> replaces
    "gmm_fwd": "paddle_tpu/ops/pallas_gmm.py:40",
    "gmm_drhs": "paddle_tpu/ops/pallas_gmm.py:94",
}
# kernel vs plain on the same inputs, per row of the output (for K5b a
# row is each (e, k, :)): max|err| <= tol x that row's max |plain|.
# bf16: both round an fp32 sum, taken in another order, once: at most
# one bf16 ulp (2^-7 of the value) apart.
GMM_TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
GMM_TOL_TEXT = ("per row of the output (per (e, k, :) for drhs): max|err| "
                "<= {tol} x max|plain| of the row; experts with no tiles "
                "exactly 0")
# the fp32 case: (tokens, experts, top_k, K, N, the expert left without
# tiles); K and N are multiples of no kernel tile
GMM_FP32_CASE = (512, 8, 4, 320, 200, 3)
# the bf16 case at the train widths with an absent expert and many
# padding tiles past the last expert's span: (tokens, the absent expert)
GMM_PAD_CASE = (2048, 7)


def _moe_cfg():
    """The JAX package's MoE Llama at the published widths of
    Qwen1.5-MoE-A2.7B (Qwen/Qwen1.5-MoE-A2.7B config.json), cut to
    MOE_LAYERS layers, dropless routing, built as bench.py builds its
    MoE config (from the qwen2-moe-tiny preset)."""
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig.from_preset(
        "qwen2-moe-tiny", vocab_size=151936, hidden_size=2048,
        intermediate_size=1408, num_hidden_layers=MOE_LAYERS,
        num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=8192, rope_theta=1e6, rms_norm_eps=1e-6,
        tie_word_embeddings=False, dtype="bfloat16", moe_num_experts=60,
        moe_top_k=4, moe_shared_expert_intermediate=5632,
        moe_dropless=True)


def _moe_counts():
    from paddle_tpu_torch.ops import gmm as G
    return {n: G.LAUNCHES[n] for n in MOE_KERNELS}


def _set_moe_counts(counts):
    from paddle_tpu_torch.ops import gmm as G
    G.LAUNCHES.update(counts)


def _zero_all_counts():
    _zero_train_counts()
    _set_moe_counts(dict.fromkeys(MOE_KERNELS, 0))


def _all_counts():
    return {**_train_counts(), **_moe_counts()}


def _gmm_layer(torch, x, eid, E, k, F, dtype, gen):
    """One MoE layer's grouped products, routed by `eid` (T * k,): the
    dispatched buffer, the tiles' experts, the live-tile count, the
    per-expert row counts, the stacked weights (E, d, F) and (E, F, d),
    and the activations and gradients the layer's backward feeds K5f /
    K5b (zero on padding rows, as in the model)."""
    from paddle_tpu_torch.ops import gmm as G
    from paddle_tpu_torch.ops import moe_ops
    T, d = x.shape
    M = G.padded_buffer_size(T * k, E, MOE_BM)
    src, te, inv_pos = G.sort_slots_by_expert(eid, E, MOE_BM, M)
    buf = moe_ops._cap_dispatch(x, inv_pos.reshape(T, k),
                                torch.ones(T, k, dtype=torch.bool,
                                           device=x.device), src)
    live = (src < T * k)[:, None]

    def rows(n):
        return torch.where(live, torch.randn(M, n, device="cuda",
                                             generator=gen), 0).to(dtype)

    def weights(a, b):
        return (0.02 * torch.randn(E, a, b, device="cuda", generator=gen)) \
            .to(dtype)
    counts = torch.zeros(E, dtype=torch.long, device="cuda").scatter_add_(
        0, eid.long(), torch.ones_like(eid.long()))
    return {"buf": buf, "te": te, "live": G.live_tile_count(inv_pos, MOE_BM),
            "counts": counts, "w_up": weights(d, F),
            "w_down": weights(F, d), "h": rows(F), "g_up": rows(F),
            "g_down": rows(d)}


def _gmm_products(G, L, E, variant=None):
    """name -> (kernel call, plain call, is a weight gradient): the five
    products of one layer (K5f gate/up and down, K5f transposed for the
    gate/up input gradient, K5b for both weight stacks).  The kernels
    skip the padding tiles past the live ones, as the model's calls do;
    the plain versions read every tile.  With `variant` named, the
    kernels are that variant reading every tile."""
    te = L["te"]
    lt = None if variant else L["live"]
    kw = {"live_tiles": lt, "variant": variant}
    return {
        "fwd_gate_up": (
            lambda: G.gmm_fwd(L["buf"], L["w_up"], te, MOE_BM, **kw),
            lambda: G.gmm_plain(L["buf"], L["w_up"], te, MOE_BM), False),
        "fwd_down": (
            lambda: G.gmm_fwd(L["h"], L["w_down"], te, MOE_BM, **kw),
            lambda: G.gmm_plain(L["h"], L["w_down"], te, MOE_BM), False),
        "dlhs_gate_up": (
            lambda: G.gmm_fwd(L["g_up"], L["w_up"], te, MOE_BM, True, **kw),
            lambda: G.gmm_plain(L["g_up"], L["w_up"], te, MOE_BM, True),
            False),
        "drhs_gate_up": (
            lambda: G.gmm_drhs(L["buf"], L["g_up"], te, E, MOE_BM, **kw),
            lambda: G.gmm_drhs_plain(L["buf"], L["g_up"], te, E, MOE_BM),
            True),
        "drhs_down": (
            lambda: G.gmm_drhs(L["h"], L["g_down"], te, E, MOE_BM, **kw),
            lambda: G.gmm_drhs_plain(L["h"], L["g_down"], te, E, MOE_BM),
            True),
    }


def _gmm_check(torch, G, L, E, dtype_name):
    """Every product of the layer against its plain version; K5b twice
    (bitwise); experts with no tiles exactly zero.  Returns {product:
    (max abs err, worst share of its limit)}."""
    tol = GMM_TOL[dtype_name]
    absent = L["counts"] == 0
    out = {}
    for name, (kern, plain, is_drhs) in _gmm_products(G, L, E).items():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        require(got.dtype == want.dtype and got.shape == want.shape,
                f"K5 {name}: {got.dtype} {tuple(got.shape)} vs plain "
                f"{want.dtype} {tuple(want.shape)}")
        if is_drhs:
            require(not got[absent].any(),
                    f"K5b {name}: an expert with no tiles is not zero")
            require(torch.equal(got, kern()),
                    f"K5b {name}: two runs on the same inputs differ")
        out[name] = ((got.float() - want.float()).abs().max().item(),
                     _per_row_share(got, want, tol))
    return out


def _grouped_library(torch, counts, E):
    """One PyTorch call over the experts' padded row spans (a yardstick
    the port never calls): torch._grouped_mm where this PyTorch has it,
    else one torch.matmul per expert (spans read to the host)."""
    padded = (counts + MOE_BM - 1) // MOE_BM * MOE_BM
    offs = torch.cumsum(padded, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        return ("torch._grouped_mm(offs = the experts' padded row ends)",
                lambda a, b: torch._grouped_mm(a, b, offs=offs))
    ends = offs.tolist()
    spans = list(zip([0] + ends[:-1], ends))

    def per_expert(a, b):
        if b.dim() == 3:                      # (M, K) x (E, K, N)
            out = a.new_zeros(a.shape[0], b.shape[2])
            for e, (s, t) in enumerate(spans):
                out[s:t] = torch.matmul(a[s:t], b[e])
        else:                                 # (K, M) x (M, N) -> (E, K, N)
            out = a.new_zeros(E, a.shape[0], b.shape[1])
            for e, (s, t) in enumerate(spans):
                out[e] = torch.matmul(a[:, s:t], b[s:t])
        return out
    return "one torch.matmul per expert over its padded rows", per_expert


def phase_moe_kernels(torch):
    """K5f and K5b against their plain versions at the shapes of the MoE
    train path's first layer (4096 tokens routed top-4 of 60 by a gate on
    random tokens into 31744 buffer rows, d 2048, ff 1408, bf16), at the
    same widths in bf16 with an absent expert and many padding tiles, and
    in fp32 at a smaller shape with an expert that has no tiles; then
    timed in turns beside their bounds, the CUDA-core kernels bf16 ran
    on before its tensor-core ones (the fma variant reading every tile,
    checked and timed here) and one PyTorch call each."""
    from paddle_tpu_torch.ops import gmm as G
    from paddle_tpu_torch.ops import moe_ops
    kind = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    saved = _moe_counts()
    cfg = _moe_cfg()
    T, d, F = TRAIN_B * TRAIN_S, cfg.hidden_size, cfg.intermediate_size
    E, k = cfg.moe_num_experts, cfg.moe_top_k

    # ---- fp32, smaller, one expert without tiles
    Tf, Ef, kf, Kf, Nf, gone = GMM_FP32_CASE
    pick = torch.tensor([e for e in range(Ef) if e != gone], device="cuda")
    eid = pick[torch.randint(0, Ef - 1, (Tf * kf,), device="cuda",
                             generator=gen)]
    xf = torch.randn(Tf, Kf, device="cuda", generator=gen)
    Lf = _gmm_layer(torch, xf, eid, Ef, kf, Nf, torch.float32, gen)
    cmp = {"float32": _gmm_check(torch, G, Lf, Ef, "float32")}
    require(int(Lf["counts"][gone]) == 0, "fp32 case: no absent expert")
    del Lf, xf

    # ---- bf16 at the train shape, routed by a gate on random tokens
    x = torch.randn(T, d, device="cuda", generator=gen).to(torch.bfloat16)
    lim = math.sqrt(6.0 / (d + E))           # the gate's Xavier init
    wg = (torch.rand(d, E, device="cuda", generator=gen) * 2 * lim - lim) \
        .to(torch.bfloat16)
    _, _, top_idx = moe_ops.gate_probs_and_topk(x @ wg, k)
    L = _gmm_layer(torch, x, top_idx.reshape(-1), E, k, F, torch.bfloat16,
                   gen)
    cmp["bfloat16"] = _gmm_check(torch, G, L, E, "bfloat16")

    # ---- bf16 at the train widths: an absent expert, padding tiles
    Tp, gone = GMM_PAD_CASE
    pick = torch.tensor([e for e in range(E) if e != gone], device="cuda")
    eid = pick[torch.randint(0, E - 1, (Tp * k,), device="cuda",
                             generator=gen)]
    xp = torch.randn(Tp, d, device="cuda", generator=gen).to(torch.bfloat16)
    Lp = _gmm_layer(torch, xp, eid, E, k, F, torch.bfloat16, gen)
    n_live, n_tiles = int(Lp["live"]), Lp["te"].numel()
    require(int(Lp["counts"][gone]) == 0 and n_live < n_tiles,
            f"padding case: absent expert {int(Lp['counts'][gone])} rows, "
            f"{n_live} live tiles of {n_tiles}")
    cmp["bfloat16_padding"] = _gmm_check(torch, G, Lp, E, "bfloat16")
    del Lp, xp
    cases = {"float32": "", "bfloat16": "",
             "bfloat16_padding": f"{Tp * k} routed rows, expert {gone} "
                                 f"absent, {n_live} live tiles of {n_tiles}"}
    for key, c in cmp.items():
        dt = key.split("_")[0]
        emit({"phase": "moe_kernels", "case": key,
              **({"shape": cases[key]} if cases[key] else {}),
              "variant": G._variant(getattr(torch, dt), MOE_BM, d, F),
              "tolerance": GMM_TOL_TEXT.format(tol=GMM_TOL[dt]),
              **{f"{n}_max_abs_err": e for n, (e, _) in c.items()},
              **{f"{n}_worst_err_over_limit": s for n, (_, s) in c.items()}})
        for n, (_, s) in c.items():
            require(s <= 1.0, f"K5 {key} {n}: {s} x its limit")

    # ---- times at the train shape, in turns, beside bound and library
    lib_name, lib = _grouped_library(torch, L["counts"], E)
    rows = T * k                               # the useful (routed) rows
    mm = 2.0 * rows * d * F                    # flops of one product
    te = L["te"]
    live_rows = int(L["live"]) * MOE_BM      # rows the kernels read
    lib_calls = {"fwd_gate_up": lambda: lib(L["buf"], L["w_up"]),
                 "fwd_down": lambda: lib(L["h"], L["w_down"]),
                 "dlhs_gate_up": lambda: lib(L["g_up"],
                                             L["w_up"].transpose(1, 2)),
                 "drhs_gate_up": lambda: lib(L["buf"].t(), L["g_up"]),
                 "drhs_down": lambda: lib(L["h"].t(), L["g_down"])}
    # bytes: the inputs' rows in the live tiles (the padding past them
    # is neither read nor needed), every expert's weights, the whole
    # output (K5f writes zeros past the live tiles)
    live = {n: L[n][:live_rows] for n in ("buf", "h", "g_up", "g_down")}
    io = {"fwd_gate_up": (live["buf"], L["w_up"], L["g_up"], te),
          "fwd_down": (live["h"], L["w_down"], L["buf"], te),
          "dlhs_gate_up": (live["g_up"], L["w_up"], L["buf"], te),
          "drhs_gate_up": (live["buf"], live["g_up"], L["w_up"], te),
          "drhs_down": (live["h"], live["g_down"], L["w_down"], te)}
    cuda_core = _gmm_products(G, L, E, variant="fma")
    times = {}
    for name, (kern, plain, _) in _gmm_products(G, L, E).items():
        ms, plain_ms, turns = _in_turns(torch, plain, kern, 5)
        old = cuda_core[name][0]
        share = _per_row_share(old(), plain(), GMM_TOL["bfloat16"])
        require(share <= 1.0, f"K5 {name} on the CUDA cores: {share} x "
                              f"its limit")
        nbytes = _nbytes(*io[name])
        bound_ms, bound_by = _bound_ms(kind, mm, nbytes)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "turns_ms": turns,
                       "cuda_core_ms": _time_ms(torch, lambda i: old(), 1,
                                                3),
                       "library_ms": _time_ms(torch, lambda i:
                                              lib_calls[name](), 1, 10),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_bytes": nbytes}
        emit({"phase": "moe_kernels", "product": name,
              "shape": f"{rows} routed rows in {te.numel() * MOE_BM} "
                       f"buffer rows ({int(L['live'])} live tiles of "
                       f"{te.numel()}), d {d}, ff {F}, {E} experts, bm "
                       f"{MOE_BM}, bf16", "library": lib_name,
              **times[name]})
    _set_moe_counts(saved)                 # timing launches do not count
    b16 = cmp["bfloat16"]
    res = {"gmm_fwd": {**times["fwd_gate_up"],
                       "max_abs_err": max(b16[n][0] for n in
                                          ("fwd_gate_up", "fwd_down",
                                           "dlhs_gate_up")),
                       "also_used_for": "dlhs: K5f reading the weights "
                                        "transposed (transpose_rhs)",
                       "dlhs_ms": times["dlhs_gate_up"]["ms"],
                       "dlhs_bound_ms": times["dlhs_gate_up"]["bound_ms"],
                       "dlhs_library_ms": times["dlhs_gate_up"]["library_ms"],
                       "cuda_core_dlhs_ms":
                           times["dlhs_gate_up"]["cuda_core_ms"],
                       "down_ms": times["fwd_down"]["ms"],
                       "cuda_core_down_ms": times["fwd_down"]["cuda_core_ms"]},
           "gmm_drhs": {**times["drhs_gate_up"],
                        "max_abs_err": max(b16[n][0] for n in
                                           ("drhs_gate_up", "drhs_down")),
                        "down_ms": times["drhs_down"]["ms"],
                        "cuda_core_down_ms":
                            times["drhs_down"]["cuda_core_ms"]}}
    variant = G._variant(torch.bfloat16, MOE_BM, d, F)
    for name, r in res.items():
        r["tolerance"] = GMM_TOL_TEXT.format(tol=f"{GMM_TOL['bfloat16']} "
                                             f"(bf16)")
        r["library"] = lib_name
        r["shape"] = "gate/up of the MoE train path's first layer"
        r["variant"] = f"{variant} (bf16, bm {MOE_BM}); fp32 runs fma"
        r["cuda_core"] = ("cuda_core_*: the fma variant on bf16 reading "
                          "every tile, the kernel bf16 ran on before "
                          "wgmma, timed in this run")
    del L, x, cmp
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def _checked_gmm():
    """Every gmm_fwd / gmm_drhs call inside the block also runs the plain
    version on the same inputs; yields the worst per-row share of the
    limit (K5f forward, K5f transposed, K5b) and the calls."""
    from paddle_tpu_torch.ops import gmm as G
    worst = {"calls_fwd": 0, "calls_dlhs": 0, "calls_drhs": 0, "fwd": 0.0,
             "dlhs": 0.0, "drhs": 0.0}
    fwd, drhs = G.gmm_fwd, G.gmm_drhs

    def fwd_checked(lhs, rhs, tile_expert, block_m=G.DEFAULT_BM,
                    transpose_rhs=False, live_tiles=None):
        out = fwd(lhs, rhs, tile_expert, block_m, transpose_rhs, live_tiles)
        ref = G.gmm_plain(lhs, rhs, tile_expert, block_m, transpose_rhs)
        key = "dlhs" if transpose_rhs else "fwd"
        tol = GMM_TOL[str(lhs.dtype).split(".")[-1]]
        worst[key] = max(worst[key], _per_row_share(out, ref, tol))
        worst[f"calls_{key}"] += 1
        return out

    def drhs_checked(lhs, dout, tile_expert, num_experts,
                     block_m=G.DEFAULT_BM, live_tiles=None):
        out = drhs(lhs, dout, tile_expert, num_experts, block_m, live_tiles)
        ref = G.gmm_drhs_plain(lhs, dout, tile_expert, num_experts, block_m)
        tol = GMM_TOL[str(lhs.dtype).split(".")[-1]]
        worst["drhs"] = max(worst["drhs"], _per_row_share(out, ref, tol))
        worst["calls_drhs"] += 1
        return out

    G.gmm_fwd, G.gmm_drhs = fwd_checked, drhs_checked
    try:
        yield worst
    finally:
        G.gmm_fwd, G.gmm_drhs = fwd, drhs


@contextlib.contextmanager
def _checked_xent():
    """Every softmax_xent_fwd / _bwd call inside the block also runs the
    plain version on the same inputs; yields the worst shares of the
    limits (loss, lse, dlogits) and the calls."""
    from paddle_tpu_torch.ops import softmax_xent as SX
    worst = {"calls": 0, "loss": 0.0, "lse": 0.0, "dlogits": 0.0}
    fwd, bwd = SX.softmax_xent_fwd, SX.softmax_xent_bwd

    def fwd_checked(logits, labels):
        loss, lse = fwd(logits, labels)
        ploss, plse = SX.softmax_xent_plain(logits, labels)
        lim = LSE_TOL * plse.abs().clamp_min(1.0)
        worst["loss"] = max(worst["loss"],
                            ((loss - ploss).abs() / lim).max().item())
        worst["lse"] = max(worst["lse"],
                           ((lse - plse).abs() / lim).max().item())
        worst["calls"] += 1
        return loss, lse

    def bwd_checked(logits, labels, lse, g):
        d = bwd(logits, labels, lse, g)
        pd = SX.softmax_xent_bwd_plain(logits, labels, lse, g)
        keep = labels >= 0
        err = (d[keep].float() - pd[keep].float()).abs()
        lim = XENT_GRAD_TOL[str(logits.dtype).split(".")[-1]] \
            * pd[keep].float().abs().clamp_min(1e-30)
        worst["dlogits"] = max(worst["dlogits"], (err / lim).max().item())
        return d

    SX.softmax_xent_fwd, SX.softmax_xent_bwd = fwd_checked, bwd_checked
    try:
        yield worst
    finally:
        SX.softmax_xent_fwd, SX.softmax_xent_bwd = fwd, bwd


def _moe_active_params(model, cfg):
    """bench.py's active-parameter count: routed-expert weights count
    top_k / E of their size, everything else in full."""
    total = expert = 0
    for name, p in model.named_parameters():
        total += p.numel()
        if name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down"):
            expert += p.numel()
    return total, total - expert * (1.0 - cfg.moe_top_k
                                    / cfg.moe_num_experts)


def phase_moe_train(torch):
    """The MoE Llama at Qwen1.5-MoE-A2.7B widths, MOE_LAYERS layers,
    bf16, random weights from a seed: TRAIN_STEPS TrainSteps of
    llama_loss_fn (aux included; AdamW lr 1e-4, wd 0.01, global-norm
    clip 1.0) on one 2 x 2048 batch; one profiled step; the loss and
    every gradient with recompute "full" against those without it; then,
    per layer, K5f / K5b, K1 / K2 and K3 against their plain versions on
    that layer's own inputs."""
    from paddle_tpu_torch.models.llama import llama_loss_fn
    from paddle_tpu_torch.observability import roofline
    kind = torch.cuda.get_device_name(0)
    cfg = _moe_cfg()
    t0 = time.perf_counter()
    model, step = _train_setup(torch, cfg, 1e-4, 1.0, seed=0,
                               loss_fn=llama_loss_fn)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, active = _moe_active_params(model, cfg)
    ids = _train_ids(torch, cfg, TRAIN_B, TRAIN_S, seed=0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_all_counts()
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(step(ids).item())          # .item() synchronises
        secs.append(time.perf_counter() - t)
    launches = _all_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    L, n = MOE_LAYERS, TRAIN_STEPS
    # per layer and step: K1, dQ, dK/dV once; K5f 3x forward (gate, up,
    # down) + 3x dlhs; K5b 3x (w_gate, w_up, w_down); K3 once per step
    want = {"flash_attention_fwd": L * n, "flash_attention_dq": L * n,
            "flash_attention_dkv": L * n, "softmax_xent_fwd": n,
            "softmax_xent_bwd": n, "gmm_fwd": 6 * L * n,
            "gmm_drhs": 3 * L * n}
    require(all(math.isfinite(x) for x in losses), f"moe losses {losses}")
    require(losses[-1] < losses[0], f"moe loss did not fall: {losses}")
    require(launches == want, f"moe launches {launches} != {want}")
    step_ms = 1e3 * sorted(secs[1:])[len(secs[1:]) // 2]
    tokens = TRAIN_B * TRAIN_S
    tok_s = tokens / (step_ms / 1e3)
    # bench.py:391-403: 6 x active params per token + attention 6 L h S
    flops_per_token = 6.0 * active + 6.0 * L * cfg.hidden_size * TRAIN_S
    mfu = tok_s * flops_per_token / roofline.peak_flops(kind, "bfloat16")
    report = {"phase": "moe_train",
              "model": f"Qwen1.5-MoE-A2.7B widths, {L} layers, dropless",
              "dtype": "bfloat16", "params": n_params,
              "active_params": active, "batch": TRAIN_B, "seq": TRAIN_S,
              "steps": n, "init_s": init_s, "losses": losses,
              "step_ms_each": [1e3 * s for s in secs], "step_ms": step_ms,
              "tokens_per_s": tok_s, "mfu": mfu, "peak_mem_gib": peak_gib,
              "launches": launches}
    report.update(_train_profile(torch, step, ids, step_ms))
    emit(report)

    # recompute "full": the loss and every gradient of the current
    # weights, without and with recompute
    def loss_and_grads(remat):
        cfg.recompute = remat
        _zero_all_counts()
        try:
            loss = step.loss_fn(model, ids)
            loss.backward()
        finally:
            cfg.recompute = False
        grads = {k: p.grad for k, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads, _all_counts()

    loss_plain, g_plain, n_plain = loss_and_grads(False)
    loss_remat, g_remat, n_remat = loss_and_grads(True)
    bitwise = loss_plain == loss_remat and all(
        torch.equal(g_plain[k], g_remat[k]) for k in g_plain)
    g_share = max((g_remat[k].float() - g_plain[k].float()).abs().max()
                  .item() / (2 ** -8 * g_plain[k].float().abs().max()
                             .clamp_min(1e-30).item()) for k in g_plain)
    del g_plain, g_remat
    torch.cuda.empty_cache()
    emit({"phase": "moe_recompute", "policy": "full", "loss": loss_plain,
          "loss_recompute": loss_remat, "bitwise": bitwise,
          "tolerance": "bitwise expected (deterministic routing and K5b); "
                       "held to: loss within 2^-8 relative, each gradient "
                       "within 2^-8 x its max |value|",
          "grad_worst_err_over_limit": g_share,
          "launches": n_plain, "launches_recompute": n_remat})
    require(n_plain["gmm_fwd"] == 6 * L and n_remat["gmm_fwd"] == 9 * L
            and n_remat["gmm_drhs"] == 3 * L
            and n_remat["flash_attention_fwd"] == 2 * L,
            f"moe recompute launches {n_plain} / {n_remat}")
    require(abs(loss_remat - loss_plain) <= 2 ** -8 * abs(loss_plain),
            f"moe recompute loss {loss_remat} vs {loss_plain}")
    require(g_share <= 1.0, f"moe recompute grads: {g_share} x the limit")

    # per layer at full width: every kernel on the layer's own inputs
    with _checked_gmm() as wg, _checked_flash() as wf, \
            _checked_xent() as wx:
        loss = step.loss_fn(model, ids)
        loss.backward()
    torch.cuda.synchronize()
    for p in model.parameters():
        p.grad = None
    shares = {**{f"k5_{k}": v for k, v in wg.items()
                 if not k.startswith("calls")},
              **{f"k1k2_{k}": v for k, v in wf.items()
                 if not k.startswith("calls")},
              **{f"k3_{k}": v for k, v in wx.items() if k != "calls"}}
    emit({"phase": "moe_train_parity",
          "model": f"Qwen1.5-MoE-A2.7B widths, {L} layers",
          "dtype": "bfloat16",
          "check": "per layer: K5f (forward, transposed), K5b, K1, K2 "
                   "and K3 (V 151936) against their plain versions on "
                   "the layer's own inputs",
          "tolerance": {"k5": GMM_TOL_TEXT.format(tol=GMM_TOL["bfloat16"]),
                        "k1k2": FLASH_TOL_TEXT.format(
                            tol=FLASH_TOL["bfloat16"]),
                        "k3": XENT_TOL_TEXT.format(
                            tol=XENT_GRAD_TOL["bfloat16"])},
          "worst_err_over_limit": shares,
          "calls": {"gmm_fwd": wg["calls_fwd"], "gmm_dlhs": wg["calls_dlhs"],
                    "gmm_drhs": wg["calls_drhs"], "flash_fwd": wf["calls_fwd"],
                    "flash_bwd": wf["calls_bwd"], "xent": wx["calls"]}})
    require(wg["calls_fwd"] == 3 * L and wg["calls_dlhs"] == 3 * L
            and wg["calls_drhs"] == 3 * L and wf["calls_fwd"] == L
            and wf["calls_bwd"] == L and wx["calls"] == 1,
            f"moe train parity: calls {wg} {wf} {wx}")
    require(all(v <= 1.0 for v in shares.values()),
            f"moe train parity: a kernel over its limit {shares}")
    del model, step, loss
    torch.cuda.empty_cache()
    return launches


def phase_moe_parity(torch):
    """qwen2-moe-tiny (dropless, 4 / 2 heads: head_dim 16) in fp32 on
    the card, the kernels against their plain versions: the
    loss (aux included), every gradient (router and stacked experts
    too), then the losses and parameters of two TrainSteps (AdamW under
    LinearWarmup, global-norm clip 0.5).  Tolerances as train_parity:
    loss 1e-5 relative; each gradient within 1e-4 x its max |plain|;
    each parameter within 5e-2 x the summed lr."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import llama_loss_fn
    from paddle_tpu_torch.optimizer import lr as tlr
    cfg = LlamaConfig.from_preset("qwen2-moe-tiny", moe_dropless=True)
    ids = _train_ids(torch, cfg, 2, 128, seed=6)
    out = {}
    for mode in ("plain", "cuda"):
        sched = tlr.LinearWarmup(1e-3, warmup_steps=2, start_lr=2e-4,
                                 end_lr=1e-3)
        model, step = _train_setup(torch, cfg, sched, 0.5, seed=1,
                                   loss_fn=llama_loss_fn)
        _zero_all_counts()
        with (_plain_kernels() if mode == "plain"
              else contextlib.nullcontext()):
            loss = step.loss_fn(model, ids)
            loss.backward()
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            for p in model.parameters():
                p.grad = None
            losses = []
            for _ in range(2):
                losses.append(step(ids).item())
                sched.step()
        out[mode] = (loss.item(), grads, losses,
                     {n: p.detach().clone() for n, p in step.params.items()},
                     _all_counts())
        del model, step
    (lp, gp, lsp, pp, cp), (lk, gk, lsk, pk, ck) = out["plain"], out["cuda"]
    require(all(v == 0 for v in cp.values()), f"plain run launched {cp}")
    require(all(v > 0 for v in ck.values()), f"kernel run launches {ck}")
    g_share = max((gk[n] - gp[n]).abs().max().item()
                  / (1e-4 * gp[n].abs().max().clamp_min(1e-30).item())
                  for n in gp)
    p_err = max((pk[n] - pp[n]).abs().max().item() for n in pp)
    p_limit = 5e-2 * sum(PARITY_LRS)
    emit({"phase": "moe_parity",
          "model": "qwen2-moe-tiny, dropless, 4 / 2 heads (head_dim 16)",
          "dtype": "float32", "loss_plain": lp, "loss_cuda": lk,
          "losses_plain": lsp, "losses_cuda": lsk, "grads_compared": len(gp),
          "grad_worst_err_over_limit": g_share,
          "param_max_abs_err_after_2_steps": p_err,
          "param_limit": p_limit, "launches": ck,
          "tolerance": "loss 1e-5 rel; grad per param 1e-4 x max|plain|; "
                       "params 5e-2 x summed lr"})
    for a, b in zip([lk] + lsk, [lp] + lsp):
        require(abs(a - b) <= 1e-5 * abs(b),
                f"qwen2-moe-tiny loss {a} vs plain {b}")
    require(g_share <= 1.0, f"qwen2-moe-tiny grads: {g_share} x the limit")
    require(p_err <= p_limit, f"qwen2-moe-tiny params after 2 steps: {p_err}")


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
    train_kernels = phase_train_kernels(torch)
    serve_launches = phase_serve(torch)
    debug = _debug_model()
    tokens, parity_launches = phase_parity(torch, debug)
    phase_server(torch, debug, tokens)
    del debug
    train_launches = phase_train(torch)
    phase_train_parity(torch)
    moe_kernels = phase_moe_kernels(torch)
    moe_launches = phase_moe_train(torch)
    phase_moe_parity(torch)

    launches = {"bfloat16": serve_launches["bfloat16"],
                "int8": serve_launches["int8"], "float32": parity_launches}
    path = {"bfloat16": "serve llama3-8b, bf16 pool",
            "int8": "serve llama3-8b, int8 pool",
            "float32": "parity debug-4l fp32"}
    entries = []
    for mode, r in kernels.items():
        sd = r["serve_depths"]
        entries.append({
            "name": f"paged_attention[{mode}]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_paged_attention.py:93",
            "launches": launches[mode], "launches_path": path[mode],
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "timing": "CUDA-graph replay, per call (eager_ms: back to "
                      "back eager calls, bounded by the host)",
            "eager_ms": r["eager_ms"], "split_rows": r["split_rows"],
            "serve_depths": {k: sd[k] for k in (
                "depths", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}})
    for name, r in train_kernels.items():
        mod, replaces = TRAIN_KERNELS[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{mod}.cu",
            "replaces": replaces,
            **({"also_replaces": ALSO_REPLACES[name]}
               if name in ALSO_REPLACES else {}),
            "launches": train_launches[name],
            "launches_path": f"train llama3-8b, {TRAIN_LAYERS} layers, "
                             f"{TRAIN_STEPS} steps",
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{key: r[key] for key in ("variant", "cuda_core_ms")
               if key in r}})
    for name, r in moe_kernels.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/gmm.cu",
            "replaces": MOE_KERNELS[name],
            "launches": moe_launches[name],
            "launches_path": f"moe_train, Qwen1.5-MoE-A2.7B widths, "
                             f"{MOE_LAYERS} layers, {TRAIN_STEPS} steps",
            **r})
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
