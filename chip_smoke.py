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
              K5 and of K1/K2 and of Q1's kernels;
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
              view — a yardstick the port never calls); and at a verify
              step's shape (8 slots x 8 columns = 64 rows, each slot's
              table row and depth + j; the bound counts each slot's rows
              once); and with the tiered pool's table at the serve
              depths (every block behind each slot's last 8, block 0
              kept, read in place from a pinned host tier, the device
              copies poisoned): against its plain version, bitwise the
              call over the device pool and twice, both timed in turns;
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
  3c. q1_kernels
              the weight-only int8 product (Q1, csrc/wo_int8_matmul.cu,
              the port's own: XLA fuses it in the JAX package) against its
              plain version at llama3-8b's seven layer shapes (4096 x
              4096, 4096 x 1024 twice, 4096 x 4096, 4096 x 14336 twice,
              14336 x 4096) at M 1, 8, 16, 32, 64, 128, 256 and 2048 rows
              in bf16 (the weight packed in fragment order), and at
              debug-4l's shapes in fp32 (M 1, 8, 33): per element within
              its stated tolerance, bitwise over two calls, a CUDA-graph
              replay bitwise the eager call, and q / k / v in one
              launch the same way; then each distinct shape at
              M 8, 64, 128 and 2048 timed in turns (plain, kernel,
              kernel, plain) by CUDA-graph replay over weight copies past
              the L2, beside its bound, torch.matmul on the bf16 weight,
              dequantise-then-matmul and torch._weight_int8pack_mm where
              the card has it (yardsticks the port never calls; the last,
              30-900x Q1's time, by two replays of two calls); and one
              layer's products back to back in one graph as the model
              launches them (q / k / v in one launch, then o, gate, up,
              down: the launch gaps and the programmatic dependent
              launches' overlap);
  4. serve    Llama-3-8B (random weights from a seed, bf16, all 32
              layers) served through LLMEngine with the card's defaults
              (the decode step as a CUDA graph, the overlap driver):
              8 greedy requests of the prompt-length mix [37 .. 512] x
              32 new tokens, once with a bf16 and once with an int8 KV
              pool, after the engine's boot-time sweep
              (prepare_programs); every decode step must be a graph
              replay and the kernel must launch exactly 32 x (decode
              steps) times, counted through the replays (each adds the
              launches its capture recorded);
              profile, three ways (the eager step before graphs, run
              by the harness; graphs with the synchronous driver;
              graphs with the overlap driver): steady decode steps (all
              8 slots decoding) — host step time, device time by kernel
              with the idle share, the host's kernel launches outside
              graphs and graph launches per step, one replay by CUDA
              events — and the serve mix again (tokens/s, ITL, TTFT,
              peak memory with the graph pool);
              serve_graphs: the same streams with overlap on and off
              (both pools) and with the bucketed widths;
              then, for each pool, every decode step of the serve mix
              with the engine on its four widths (1, 2, 4, 8): before
              each replay, on the same pool, inputs and tables, the
              gather path and the eager kernel path (K4 held to the
              gather attention per layer; the logits within a stated
              bound: serve_parity) and the other widths; the replay's
              logits against the eager step's and each width's
              (serve_graphs: bitwise, or within the stated bound with
              the reason printed);
              serve_pressure: 16 requests (the mix twice) x 256 new
              tokens fully provisioned, then through 158 KV blocks (half
              the peak demand, `bench.py`'s overload rung) under the
              preempt policies "swap", "recompute" and "auto", and with
              the int8 pool fully provisioned and under "swap" (on the
              first 8 layers, `_shallow`): every request done, >= 3
              preemptions each resumed, the pager consistent and empty;
              swap streams equal the full run's and one parked slot's
              blocks (every layer, K and V, int8 scales) come back
              bitwise; recompute streams equal it, or
              only parked requests differ and, rerun with their logits
              recorded, stay within the serve_parity bound up to each
              first flip (its step and top-2 margin printed);
              serve_prefix: a 384-token system prompt + 16 suffixes x 32
              tokens, request 0 alone then 15 at once, with 64 radix
              prefix-cache blocks and without: 15 hits, 15 x 384 tokens
              saved, a block shared (refcount >= 2) while the decode
              graphs replay, streams equal; K4's launches counted
              through the replays of every run;
              serve_spec_verify: for each pool, one verify step of width
              8 on the 8 serve slots (speculation k 7): K4 over the 64
              columns held to the gather attention per layer and row,
              the logits to the gather path's by the serve_parity rule,
              the verify graph replayed twice (bitwise) and against the
              eager verify step; K4 on rows deeper than the table;
              serve_spec: `bench.py:517-613`'s extraction stream (40
              cyclic seeds harvested, the 8 most draftable re-fed as
              144-token prompts, 96 new tokens, k 7, verify widths 2 / 4
              / 8, prefill_chunk 64) with speculation off and on: per-
              request ITL, tokens a step, acceptance, verify replays,
              graphs, peak memory, K4 launches = 32 x (decode + verify
              replays); spec-on streams equal the spec-off ones, or the
              logits up to each first flip stay within the serve_parity
              limit (top-2 margin at the flip printed); then the int8
              pool with speculation on against off through per-step
              logits;
              serve_slo (on the model's first 8 layers, `_shallow`:
              each run holds itself to its own references):
              serve_pressure's 16 requests x 256 tokens
              through LLMServer (158 blocks, "swap", the overload ladder,
              default SLO targets, /metrics on an ephemeral port, the
              watchdog, the series sampler, a canary), tiers round-robin
              over the lengths (4 interactive, 4 standard, 8 batch), all
              submitted at once from client threads and collected with
              Request.result(timeout=): interactive and standard
              requests done, batch done or shed with Overloaded only, no
              slot parked while a lower tier decodes (besides the one
              the ladder makes room for), the pager consistent and empty;
              per tier TTFT / ITL p50 / p99, goodput, sheds and parks,
              the rung history; then the same 16 requests all
              "standard" (FIFO), the same figures; /metrics (tier series,
              the rung) and /healthz (HEALTHZ_KEYS) over HTTP, the canary
              probe, then an injected canary mismatch quarantines the
              server (submit refused, /healthz 200 "quarantined"); the
              forced ladder (engine.overload times=4: [1, 2, 3, 4], a
              batch submit refused, 4 interactive streams from rung 4
              equal an unloaded engine's, then back to 0); K4 launches =
              32 x (decode + verify replays) in every run;
              serve_int8w: the serve mix with weight_dtype="int8" (every
              layer product through Q1; graphs + overlap), bf16 and int8
              pools: before each decode replay, the same step through
              the gather path with Q1's plain version (the replay's
              logits within the serve_parity limit) and the eager kernel
              step (bitwise); every decode step a replay, K4 launches =
              32 x replays, Q1 launches = 5 x 32 x (replays + prefill
              forwards: q / k / v share one launch); the profile row
              (graphs + overlap: device ms a step split into Q1 /
              cuBLAS GEMMs / K4 / other, idle
              share, tokens/s, ITL, TTFT, peak memory) beside the
              bf16-weight row of this run; serve_pressure at 158 blocks
              under "swap" on the first 8 layers (streams equal full
              provisioning, a park's blocks bitwise); serve_spec (k 7, verify width 8) against
              speculation off through per-step logits;
              generate: `LlamaForCausalLM.generate` (the static KV
              cache) on the same llama3-8b, 4 prompts x 128 tokens x 32
              new, greedy: tokens/s, ms a step, peak memory, bitwise
              twice; prompt 0 against the bf16 engine's stream (equal, or
              the first difference a near tie within the serve_parity
              limit); `generation.generate` beam search (4 beams x 16)
              bitwise twice, sampling (top_k 50, top_p 0.9, seed 7)
              equal twice, every id in the vocabulary;
              serve_tiered (on the first 8 layers, `_shallow`): four
              prompts of 3000 / 2400 / 1800 / 1200 tokens (256 / 64 /
              64 / 64 new; `longctx_config`'s clip, max_len 4096, 4
              slots) through the full pool (1,025
              blocks) and a tiered one of half their peak demand (282
              blocks, hot_window 8, prefetch_depth 2, 1,024 pinned host
              rows), bf16 and int8 pools, then the 3000-token prompt
              alone through 96 blocks (its KV takes 204), without
              and with speculation (32 tokens, k 7 forced drafts: a
              verify of width 8 every step reading the tier):
              streams equal
              the full pool's, the logits of the first 8 decode replays
              after the first spill bitwise the full run's for the same
              request and token, blocks spilled (and promoted, bf16
              mixed run), no extension row failing its CRC, the pager
              empty after; tokens/s and ITL, replay device ms with and
              without extension rows, extension bytes a step, host ms
              a spill / CRC / promote, peak and pinned GiB; K4 counted
              through the replays;
              serve_fabric: two LLMServers over the one model, each
              booted (graphs captured) before either takes traffic, the
              KV crossing a TCP socket on 127.0.0.1: (a) serve_prefix's
              16 requests on A, then on B (an empty trie) with a hint
              naming A: 24 blocks pulled, B's streams equal A's and
              serve_prefix's, bf16 and int8 pools (int8 on the first 8
              layers, B equal to A); (b) serve_pressure's
              traffic on A (158 blocks, swap), a parked session taken
              live by B: its stream and A's others equal full
              provisioning's; (c) the same traffic with a 24-block host
              tier and a temporary disk root: parks spilled to disk
              ("disk" mode), one adopted by B from the root exactly once
              (the source's resume sees the claim), streams equal full
              provisioning's, then a disk-warm prefix served by a fresh
              engine; (d) on the first 8 layers, the serve mix
              prefilled on P (pool_role "prefill") and handed off chunk
              by chunk to D ("decode"):
              adopted streams equal D's colocated ones, two or more
              frames for every prompt of two or more chunks, bf16 and
              int8 pools; every move's counters required (a silent
              recompute fails), integrity failures 0; host ms to export,
              CRC, send / receive and land a pull (and a block), MB a
              move, migration seconds, disk ms a block, TTFT pulled vs
              recomputed vs a trie hit, TTFT at P and ITL at D vs
              colocated; K4 = layers x the replays of both servers while
              a move ran;
              serve_fleet: a TCPStore master with a WAL in a temp dir and
              a LocalFleet of two LLMServers over the one llama3-8b (all
              32 layers; each booted, graphs captured, before either
              takes traffic; lease ttl 5 s): (a) both leases live at
              generation 1, the serve mix half to each replica through
              Replica.submit, streams equal the serve phase's; (b)
              replica 1's generation fenced: its heartbeat stops and its
              lease never beats again; a new lease under its name is
              live at once at generation 2; (c) the store crashed once
              the mix is in flight, down for a ttl + 0.5 s, restarted:
              every key recovered from the WAL, both leases graced by
              the outage, no replica fenced, the streams equal (a)'s;
              (d) serve_slo's pressure traffic over both replicas under
              SLO targets every request misses: both replicas'
              metrics_series() pulled into one FleetMetricsAggregator
              every 0.25 s, a BurnRateRule (1 s / 3 s windows) fires and
              resolves after the traffic stops, fleet_sum of the token
              rate within 10 % of the replicas' own rates; (e)
              raw_step() with all 8 slots decoding the serve mix, bf16
              and int8 weights: ms by CUDA events, (param_bytes +
              kv_pool_bytes) / ms and decode_attn_bytes_per_step / ms
              against the card's memory rate, the streams after it equal
              the ones without, num_compiles within its bound; heartbeat
              RPC ms, store recovery ms, WAL ms per append with fsync
              off and on; K4 = layers x the replicas' replays a drill;
              serve_router: the Router (paddle_tpu_torch/inference/
              router.py) over replicas of one durable store, every one
              booted before any traffic (fleet "replica": two at the
              serve shape with the fabric's disk root in a temp dir;
              "prefix": two with the radix cache; "tight": one whose
              pool holds one max_len sequence; "pool": a "prefill" and a
              "decode" replica on the first 8 layers): (a) the serve
              mix through Router.submit (affinity), streams equal the
              serve phase's; TTFT / ITL beside serve_fleet (a)'s direct
              submits, host ms Router.submit -> Replica.submit and a
              journal "tok" append, autoscale_signal(), /debug/fleet's
              keys over HTTP; (b) serve_prefix's stream under affinity,
              then round robin (tries cleared between): streams equal
              serve_prefix's, affinity hits >= round robin's; (c) two
              1000-token prompts outgrow the tight pool, the second
              parks and is frozen; drain() peer-takes it onto a full
              replica: streams equal the undisturbed ones, one
              migration, no replay, no failover; (d) the router shut
              down with the mix in flight, a successor resubmits its
              journal: every stream complete, the delivered prefix
              deduped exactly once; (e) replica 0 crashed at its 16th
              step mid-mix: streams equal, one failover, tokens deduped,
              no replay mismatch; the dead replica dropped and a fresh
              one spawned while idle; (f) a dispatch at router epoch 5,
              then a direct submit at epoch 4 refused
              (StaleRouterEpoch); a chaos_mark request convicted
              (PoisonedRequest) at poison_threshold 1 with one replica
              fenced, four innocents then finish with the serve
              streams; (g) the serve mix handed off prefill -> decode by
              the Router: streams equal the 8-layer colocated run, one
              handoff a request, TTFT at P, ITL at D; K4 = layers x the
              replays of the drill's replicas;
  4b. serve_process
              after the serve phase frees its model: replica processes
              (paddle_tpu_torch/inference/process_fleet.py), each child
              building llama3-8b from the serve phase's seed and
              capturing its own graphs, with the routers in this
              process: (a) two children behind a Router, the serve mix:
              streams equal the serve phase's; each child's spawn s,
              hello boot_s and card memory; tokens/s against one
              engine's; TTFT / ITL; host ms Router.submit ->
              ProcessReplica.submit and a journal "tok" append; (b) one
              child SIGKILLed mid-decode: one failover, tokens deduped,
              no replay mismatch, streams equal, the dead lease seen
              expired, the card memory it gave back; (c) a respawn under
              the same slot while the survivor serves the mix round
              after round: every round's streams equal, the respawn s,
              then the mix over both; (d) a ProcessFleet(ha=True), a
              primary HARouter and a StandbyRouter, the mix through
              FleetClient: the primary crashed with every stream under
              way, the standby promotes within 15 s, the children
              re-hello (same pids, nobody fenced), every client stream
              equal and exactly once; (e) QueueFull from a child's
              admission bound over the wire, and the deposed primary's
              epoch refused (StaleRouterEpoch); K4 in each child =
              layers x the decode steps it reports in its metrics
              series (the attention bytes labelled kernel=cuda); no
              child builds a kernel library; every child stopped
              before the phase ends;
  5. parity   debug-4l in fp32: greedy streams through the kernel and
              through the gather path (each step a graph replay) are
              token-exact, and `generate` (the contiguous cache) gives
              the same streams;
  6. server   LLMServer answers three requests with the engine's tokens;
              then serve_spec on debug-4l (fp32), whose random weights
              loop: drafts accepted (required), streams equal; then
              serve_slo on debug-4l: rung 1 held with speculation on
              (batch slots draft nothing, interactive slots draft and
              accept, verify graphs replay) and the watchdog (an
              engine.stall of 3 s against watchdog_deadline=1 flagged
              once, cleared after), K4 counted through the replays;
  6b. optimizer_kernels
              the optimizer update's two multi-tensor kernels (U1: the
              global-norm clip's and the loss scaler's reduction; U2: the
              Adam / AdamW update in place) against their plain versions
              on the dense train path's own parameters (llama3-8b, 4
              layers, 1.92 B bf16 parameters with bf16 moments, AdamW,
              clip 1.0, one parameter without a gradient) and at
              debug-4l in fp32 (AdamW; Adam with L2 decay under a loss
              scale) and bf16 with fp32 moments: the global norm, every
              element of p, m and v, bitwise over two calls, and a NaN
              gradient under a loss scale that writes nothing; then
              timed beside their bounds, the eager per-parameter update
              the port ran before, and torch._fused_adamw_ /
              torch.nn.utils.get_total_norm (yardsticks the port never
              calls);
  7. train    Llama-3-8B at full width, 4 layers, bf16, random weights:
              6 TrainSteps (AdamW, global-norm clip) on one 2 x 2048
              batch with finite, falling loss and exactly 4 K1, 4 dQ,
              4 dK/dV, 1 K3f, 1 K3b, 1 U1 and 1 U2 launches per step;
              step time, tokens/s, MFU, peak memory; one profiled step
              (device time by kernel family, the update's range, idle
              share); one step without recompute, with "full" and with
              "dots" from the same state (loss, step ms, peak memory,
              launches); and per layer, K1 / K2 against their
              plain versions on the layer's own inputs;
  8. train_parity
              debug-4l in fp32, kernels (the update's too) against plain
              versions on the card: loss, every gradient, and the
              parameters after two TrainSteps;
  8b. loss_scale
              debug-4l in fp32: two TrainSteps with a static loss scale
              of 1024 against two without, and a dynamic scale whose
              poisoned step writes nothing and halves it;
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
              4 dK/dV, 1 K3f, 1 K3b, 24 K5f, 12 K5b, 1 U1 and 1 U2
              launches per step;
              step time, tokens/s, MFU (active parameters), peak memory;
              one profiled step; the loss and every gradient with
              recompute "full" and "dots" against those without it
              (both re-run K5f and K1); and per layer,
              K5f / K5b, K1 / K2 and K3 against their plain versions on
              the layer's own inputs;
 11. moe_parity
              qwen2-moe-tiny (dropless, 4 / 2 heads: head_dim 16) in fp32,
              kernels against plain versions on the card: loss, every
              gradient, and the parameters after two TrainSteps;
 12. generate (MoE)
              the MoE Llama at moe_train's widths and depth generating
              through the naive full-forward loop (2 prompts x 64 tokens
              x 8 new): K1 and K5f launches = 8 forwards x one forward's,
              the stream the same on a second run.

Then one line {"kernels": [...]} (every ported kernel with its launches
on the paths above, error, tolerance and times), the card's name and
power limit as nvidia-smi gives them, and last the result line
{"ok": true, "device": {...}}.  Without a CUDA card, or run from a
directory without the rest of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import gc
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
# serve_spec (`bench.py:517-613` at its card sizes): seed prompts of
# SPEC_SEED tokens, SPEC_KEEP harvested tokens re-fed as prompt,
# SPEC_NEW tokens generated, SPEC_N streams, draft length SPEC_K (verify
# widths 2, 4, 8)
SPEC_SEED, SPEC_KEEP, SPEC_NEW, SPEC_N, SPEC_K = 48, 96, 96, 8, 7
SPEC_CHUNK = 64
SPEC_W = 8                    # the widest verify: next_pow2(SPEC_K + 1)
# K4 at a verify step's shape: depths from a 144-token prompt through
# the stream's first 84 tokens
SPEC_DEPTHS = [SPEC_SEED + SPEC_KEEP + 12 * i for i in range(SPEC_N)]
SERVE_PARITY_STEPS = 16       # >= kv_block_tokens: every slot's table grows
# LLMServer.health_snapshot()'s keys (/healthz): the JAX server's set
HEALTHZ_KEYS = (
    "status", "name", "pool_role", "quarantined", "quarantine_reason",
    "canary_probes", "canary_failures", "step_age_s", "stalled",
    "watchdog_stalls", "queue_depth", "slots_active", "slots_total",
    "occupancy", "unfinished", "draining", "ttft_p50_s", "host_gap_p50_s",
    "host_gap_p99_s", "host_gap_last_s", "preempted", "kv_blocks_free",
    "kv_blocks_total", "kv_tiered", "kv_ext_used", "kv_blocks_spilled",
    "kv_blocks_prefetched", "kv_prefetch_misses", "tp",
    "kv_block_bytes_per_chip", "kv_pool_bytes_per_chip",
    "tier_queue_depth", "overload_rung", "overload_escalations", "shed",
    "degraded", "fabric_address", "fabric", "overlap", "step_inflight",
    "aot", "boot_s", "boot_engine_s", "boot_first_token_s")


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


@contextlib.contextmanager
def _clock_samples():
    """Samples the card's SM clock (MHz) and power draw (W) every 100 ms
    while the block runs; yields a dict filled on exit with their
    min / median / max."""
    import tempfile
    out = {}
    with tempfile.TemporaryFile("w+") as log:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=log, stderr=subprocess.DEVNULL)
        try:
            yield out
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.seek(0)
            rows = []
            for line in log.read().splitlines():
                try:
                    rows.append([float(x) for x in line.split(",")])
                except ValueError:          # "[N/A]" and the like
                    continue
    rows = [r for r in rows if len(r) == 2]
    for k, col in (("sm_mhz", 0), ("power_w", 1)):
        xs = sorted(r[col] for r in rows)
        if xs:
            out[k] = [xs[0], xs[len(xs) // 2], xs[-1]]
    out["samples"] = len(rows)


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
              "wgmma"),
          "q1_kernels": _ptxas_report(
              libs["wo_int8_matmul"].with_suffix(".log").read_text(),
              "q1"),
          # ptxas's C7512: wgmma issued one at a time (registers short)
          "wgmma_serialized": sorted({
              f"{m[0]}<{m[1]}>" if m[1] else m[0]
              for name, path in libs.items()
              for m in re.findall(
                  r"C7512[^\n]*?((?:gmm|flash|q1)_\w*?kernel)"
                  r"(?:IL[ib](\d+)E)?",
                  path.with_suffix(".log").read_text()
                  if path.with_suffix(".log").exists() else "")})})


def _ptxas_report(log, word):
    """ptxas's registers, spill stores and static shared memory of each
    kernel in `log` whose name holds `word` (the tensor-core kernels'
    rings are dynamic shared memory, sized at launch)."""
    import re
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        m = re.search(r"\d+((?:gmm|flash|q1)_\w*?kernel)((?:IL|L)[^v]*)?",
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


def _kernel_inputs(torch, mode, copies, gen, depths=KERNEL_POS, cols=1):
    """`copies` independent pools (so timed launches find the 50 MB L2
    cold, as a decode step's per-layer pools do) + one q, table and
    pos = `depths`.  With `cols` > 1, a verify step's K4 call: each
    slot's `cols` columns are rows of their own (slot-major), with the
    slot's table row and depths depth + j."""
    from paddle_tpu_torch.quantization.int8 import quantize_kv_rows
    s = KERNEL_SHAPE
    dev = torch.device("cuda")
    n_blocks = 1 + s["B"] * s["bmax"]
    qdt = torch.float32 if mode == "float32" else torch.bfloat16
    q = torch.randn(s["B"] * cols, s["nh"], s["hd"], device=dev,
                    generator=gen, dtype=torch.float32).to(qdt)
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
        n = min((p + cols - 1) // s["bt"] + 1 + b % 3, s["bmax"])
        table[b, :n] = perm[k:k + n].to(torch.int32)
        k += n
    pos = torch.tensor([p + j for p in depths for j in range(cols)],
                       dtype=torch.int32)
    table = table.repeat_interleave(cols, 0)
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


def _bound(mode, q, out, table, pos, kind, depths=KERNEL_POS, cols=1):
    """Least time for the function on this card: bytes it must move
    (each slot's K/V rows t <= its deepest query once — with `cols`
    verify columns, depth + cols - 1 — int8 scales, q, out, table, pos)
    over the memory rate vs. its QK and PV flops (every query row
    against its own rows) over the peak for their type."""
    from paddle_tpu_torch.observability import roofline
    s = KERNEL_SHAPE
    rows = sum(p + cols for p in depths)
    elt = {"bfloat16": 2, "float32": 4, "int8": 1}[mode]
    kv = rows * s["n_kv"] * s["hd"] * 2 * elt
    if mode == "int8":
        kv += rows * s["n_kv"] * 4 * 2
    nbytes = kv + sum(t.numel() * t.element_size()
                      for t in (q, out, table, pos))
    flops = 4.0 * sum(p + j + 1 for p in depths for j in range(cols)) \
        * s["nh"] * s["hd"]
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


def _k4_case(torch, mode, gen, depths, kind, cols=1):
    """K4 at `depths` for one pool: the kernel against its plain version
    per slot (per query row), twice for bitwise repeatability; then in
    turns (plain, kernel, kernel, plain) by graph replay, beside the
    bound and one PyTorch call (scaled_dot_product_attention on the
    pre-gathered view, a yardstick the port never calls; with `cols`
    verify columns, the slots' `cols` queries against one view each,
    masked t <= depth + j).  Kernel launches made here are not
    counted."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_attention as PA
    copies = 4
    launches = PA.LAUNCHES["paged_attention"]
    q, pools, table, pos = _kernel_inputs(torch, mode, copies, gen, depths,
                                          cols)
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
    B = len(depths) * cols
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
    slot_table = table[::cols]
    views = [tuple(PA.paged_view(e, slot_table, q.dtype).transpose(1, 2)
                   .contiguous() for e in pool) for pool in pools]
    # (slot, 1, col, T): column j of slot b sees t <= depth_b + j
    mask = (torch.arange(T, device="cuda")[None, :]
            <= pos.long()[:, None]).reshape(len(depths), 1, cols, T)
    q4 = q.reshape(len(depths), cols, s["nh"], s["hd"]).transpose(1, 2)

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
    bound_ms, bound_by = _bound(mode, q, out, table, pos, kind, depths,
                                cols)
    res = {"depths": list(depths), "cols": cols,
           "max_abs_err": err_b.max().item(),
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


def _k4_ext_case(torch, mode, gen, depths, hot=8):
    """K4 with extension-tier blocks in its table: `_kernel_inputs` at
    `depths`, every table block of each slot behind its last `hot`
    live blocks (never block 0: the sink) copied to a pinned host tier
    (`KVTier`, one per input copy) and renumbered past the pool; the
    pool's copies poisoned.  The kernel against its plain version over
    the same tier per slot (the K4 tolerance), bitwise the kernel over
    the unmoved table (the same bytes) and over two calls; then both
    timed in turns by graph replay.  Launches made here are not
    counted."""
    from paddle_tpu_torch.models import llama_decode as D
    from paddle_tpu_torch.ops import paged_attention as PA
    copies = 4
    launches = PA.LAUNCHES["paged_attention"]
    q, pools, table, pos = _kernel_inputs(torch, mode, copies, gen, depths)
    n_dev = D.pool_leaves([pools[0]])[0].shape[0]
    bt = KERNEL_SHAPE["bt"]
    moved, cold = table.clone(), []
    for b, p in enumerate(depths):
        live = p // bt + 1
        for j in range(1, max(1, live - hot)):
            cold.append((b, j))
    tiers = []
    for pool in pools:
        tier = D.KVTier.empty([pool], len(cold), pin=True)
        ids = torch.stack([table[b, j] for b, j in cold]).long()
        tier.flat.copy_(D.gather_blocks([pool], ids).view(len(cold), -1))
        tiers.append(tier)
    for e, (b, j) in enumerate(cold):
        moved[b, j] = n_dev + e
    ref = PA.paged_attention(q, *pools[0], table, pos)
    plain = PA.paged_attention_plain(q, *pools[0], moved, pos,
                                     *tiers[0].layers[0])
    # poison the moved blocks' device copies in the first pool (the
    # tiered calls must not read them), restored after
    gone = table[moved >= n_dev].long()
    leaves = D.pool_leaves([pools[0]])
    saved = [t[gone].clone() for t in leaves]
    for t in leaves:
        t[gone] = 0
    hk, hv = tiers[0].layers[0]
    out = PA.paged_attention(q, *pools[0], moved, pos, hk=hk, hv=hv)
    again = PA.paged_attention(q, *pools[0], moved, pos, hk=hk, hv=hv)
    torch.cuda.synchronize()
    for t, x in zip(leaves, saved):
        t[gone] = x
    B = len(depths)
    err_b = (out.float() - plain.float()).abs().reshape(B, -1).amax(1)
    ref_b = plain.float().abs().reshape(B, -1).amax(1)
    limit_b = torch.full_like(ref_b, 1e-5) if mode == "float32" \
        else 2e-2 * ref_b
    share = (err_b / limit_b).max().item()
    require(share <= 1.0, f"K4 {mode} with an extension tier: per-slot "
            f"err {err_b.tolist()} over {limit_b.tolist()}")
    require(torch.equal(out, ref) and torch.equal(out, again),
            f"K4 {mode} with an extension tier: not bitwise the call on "
            f"the device pool (or two calls differ)")

    def kern_ext(i):
        hk_i, hv_i = tiers[i].layers[0]
        PA.paged_attention(q, *pools[i], moved, pos, hk=hk_i, hv=hv_i)

    def kern_dev(i):
        PA.paged_attention(q, *pools[i], table, pos)

    d1 = _graph_ms(torch, kern_dev, copies)
    x1 = _graph_ms(torch, kern_ext, copies)
    x2 = _graph_ms(torch, kern_ext, copies)
    d2 = _graph_ms(torch, kern_dev, copies)
    PA.LAUNCHES["paged_attention"] = launches
    ext_bytes = len(cold) * tiers[0].flat.shape[1]
    res = {"depths": list(depths), "hot_blocks": hot,
           "ext_blocks": len(cold), "ext_bytes_per_call": ext_bytes,
           "max_abs_err": err_b.max().item(),
           "worst_err_over_limit": share,
           "bitwise_vs_device_pool_and_twice": True,
           "ms": (x1 + x2) / 2, "ms_turns": [x1, x2],
           "device_pool_ms": (d1 + d2) / 2, "device_pool_ms_turns": [d1, d2],
           "ext_gb_per_s": ext_bytes / ((x1 + x2) / 2 * 1e-3) / 1e9}
    del q, pools, tiers, out, again, ref, plain, saved
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
        # a verify step's call: 8 slots x 8 columns at the spec depths
        results[mode]["verify_shape"] = _k4_case(
            torch, mode, gen, SPEC_DEPTHS, kind, cols=SPEC_W)
        # the tiered pool's call: blocks behind a hot window of 8 read
        # from the pinned host tier
        results[mode]["ext_tier"] = _k4_ext_case(torch, mode, gen,
                                                 serve_depths)
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


SERVE_KW = dict(max_slots=8, max_len=2048, prefill_chunk=128,
                kv_block_tokens=16)
# how the profile phase drives the serve shape: "eager" is the port's
# decode step before CUDA graphs (the harness removes the engine's
# graphs, so the engine runs the eager step the CPU runs, synchronous
# driver) — a baseline measured here, never a path of the port on the
# card; "graphs" replays the decode graph with the synchronous driver;
# "graphs_overlap" with the overlap driver (the default on the card)
SERVE_MODES = {"eager": dict(overlap="off"), "graphs": dict(overlap="off"),
               "graphs_overlap": dict(overlap="on")}


def _serve_engine(model, mode="graphs_overlap", **kw):
    """An engine at the serve shape in `mode`, booted: every decode
    width captured (`prepare_programs`) before the caller counts
    launches."""
    from paddle_tpu_torch.inference import LLMEngine
    eng = LLMEngine(model, **SERVE_KW, **SERVE_MODES[mode], **kw)
    require(eng.decode_kernel == "cuda", eng.decode_kernel)
    require(eng._graphs is not None, "a CUDA engine without decode graphs")
    require(eng.overlap == (mode == "graphs_overlap"), eng.overlap_mode)
    if mode == "eager":
        eng._graphs = None
    eng.prepare_programs()
    return eng


def _metric(eng, name, field="value", series=""):
    return eng.metrics()["llm_engine_" + name]["series"][series][field]


def _serve_once(torch, model, kv_dtype, mode="graphs_overlap", **kw):
    """One engine run of the serve mix; returns its report, its tokens
    and the K4 launches it made (each graph replay counts the launches
    its capture recorded).  With weight_dtype="int8" in `kw`, Q1 must
    launch 5 x layers a decode step and a prefill forward."""
    import numpy as np
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops import wo_int8_matmul as Q1
    eng = _serve_engine(model, mode, kv_dtype=kv_dtype, **kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab_size, L)
               for L in SERVE_LENGTHS]
    stamps = {}

    def on_token(req, tok):
        stamps.setdefault(req.rid, []).append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.LAUNCHES["paged_attention"] = 0
    Q1.LAUNCHES["wo_int8_matmul"] = 0
    with _prefill_calls() as prefills:
        t0 = time.perf_counter()
        reqs = [eng.submit(p, SERVE_NEW, on_token=on_token)
                for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = PA.LAUNCHES["paged_attention"]
    steps = int(_metric(eng, "decode_steps_total"))
    layers = model.config.num_hidden_layers
    q1 = _q1_expected(eng, layers, steps, prefills[0], "serve")
    for r in reqs:
        require(r.done and r.error is None and len(r.tokens) == SERVE_NEW,
                f"request {r.rid}: {len(r.tokens)} tokens, {r.error!r}")
        require(all(0 <= t < model.config.vocab_size for t in r.tokens),
                f"request {r.rid}: token id out of the vocabulary")
    require(launches == layers * steps,
            f"kernel launches {launches} != {layers} layers x {steps} "
            f"decode steps")
    recorded = {} if eng._graphs is None else {
        w: r["paged_attention"] for w, r in eng._graphs.recorded.items()}
    if mode != "eager":
        # every decode step a replay, none eager; each graph recorded
        # one K4 launch per layer
        require(eng.num_graph_replays == steps,
                f"{eng.num_graph_replays} graph replays for {steps} steps")
        require(set(recorded.values()) == {layers},
                f"K4 launches recorded per graph: {recorded}")
        require(eng.num_graphs <= len(eng.decode_widths),
                f"{eng.num_graphs} graphs for widths {eng.decode_widths}")
    itl = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
    ttft = [stamps[r.rid][0] - t0 for r in reqs]
    gaps = eng.metrics()["llm_engine_host_gap_seconds"]["series"][""]
    report = {"kv_dtype": kv_dtype or "bfloat16", "mode": mode,
              "overlap": eng.overlap_mode,
              "decode_widths": list(eng.decode_widths),
              "requests": len(reqs),
              "generated_tokens": sum(len(r.tokens) for r in reqs),
              "wall_s": wall,
              "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall,
              "decode_steps": steps, "kernel_launches": launches,
              "weight_dtype": eng.weight_dtype, "q1_launches": q1,
              "prefill_forwards": prefills[0],
              "graph_replays": eng.num_graph_replays,
              "k4_launches_recorded_per_graph": recorded,
              "num_graphs": eng.num_graphs,
              "first_token_waits": _metric(eng, "first_token_waits_total"),
              "host_gap_mean_ms": 1e3 * gaps["sum"] / max(gaps["count"], 1),
              "itl_p50_ms": 1e3 * _percentile(itl, 50),
              "itl_p99_ms": 1e3 * _percentile(itl, 99),
              "ttft_p50_ms": 1e3 * _percentile(ttft, 50),
              "ttft_max_ms": 1e3 * max(ttft),
              # the graph pool's memory is allocated from the same
              # caching allocator: both peaks include it
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
              "kv_pool_gib": eng.kv_pool_bytes() / 2**30}
    tokens = [list(r.tokens) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return report, tokens, launches


UPDATE_RANGE = "optimizer_update"     # record_function around the update


def _device_times(prof):
    """{kernel name: device µs} from a profiler's key averages (None
    when the profiler recorded no device activity)."""
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type) \
                and evt.key != UPDATE_RANGE:     # a span, not a kernel
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


def _runtime_calls(prof, steps):
    """Host runtime calls per step by kind: kernels launched one by one
    (outside any graph), graph launches, async copies."""
    kinds = {"kernel_launches_outside_graphs": ("cudaLaunchKernel",
                                                "cudaLaunchKernelExC",
                                                "cuLaunchKernel",
                                                "cuLaunchKernelEx"),
             "graph_launches": ("cudaGraphLaunch", "cuGraphLaunch"),
             "memcpy_async": ("cudaMemcpyAsync",)}
    out = {k: 0 for k in kinds}
    for e in prof.events():
        for k, names in kinds.items():
            if e.name in names:
                out[k] += 1
    return {f"{k}_per_step": v / steps for k, v in out.items()}


def _replay_times(torch, graphs, w, reps=10):
    """The whole decode step on the card with no host in it: width `w`'s
    graph replayed on its last inputs (it rewrites the same K/V rows),
    by CUDA events; and the host's time to launch one replay."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    marks[0].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        graphs.replay(w)
    host = time.perf_counter() - t0
    marks[1].record()
    torch.cuda.synchronize()
    return {"graph_replay_ms_events": marks[0].elapsed_time(marks[1]) / reps,
            "graph_launch_host_ms": 1e3 * host / reps}


def phase_profile(torch, model, mode, steps=6, **kw):
    """Where a steady decode step's time goes at the serve shape, all 8
    slots decoding (bf16 pool), in `mode` (SERVE_MODES): host-clock
    step time unprofiled, then device time by kernel and the host's
    runtime calls under torch.profiler; for the graph modes also the
    device time of one replay by CUDA events.  Then the serve mix in
    the same mode (`_serve_once`).  `kw`: engine knobs (weight_dtype).
    Returns the row and its tokens."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    eng = _serve_engine(model, mode, **kw)
    rng = np.random.default_rng(0)
    for L in SERVE_LENGTHS:
        eng.submit(rng.integers(0, model.config.vocab_size, L), 4 * steps
                   + SERVE_NEW)
    while eng.num_prefilling or eng._queue:
        eng.step()
    require(eng.num_active == len(SERVE_LENGTHS), "profile: slots idle")
    eng.step()                       # overlap: one step in flight from here
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
    eng.flush()
    dev = _device_times(prof)
    prof_step_ms = 1e3 * prof_wall / steps
    report = {"phase": "profile", "mode": mode, "model": "llama3-8b",
              "slots": 8, "overlap": eng.overlap_mode,
              "weight_dtype": eng.weight_dtype,
              "decode_step_ms": step_ms, "profiled_steps": steps,
              "profiled_step_ms": prof_step_ms,
              **_runtime_calls(prof, steps)}
    if eng._graphs is not None:
        report.update(_replay_times(torch, eng._graphs, eng.max_slots))
    if dev is None:
        report["device_time"] = "not measured (no device events)"
    else:
        spans = _device_spans(prof)
        require(spans, "profile: device times without device spans")
        # ms per step: the union of the card's busy spans
        busy = _union_us([(a, b) for _, a, b in spans]) / 1e3 / steps
        # one stream: the card cannot be busy longer than the wall time
        # of the same steps, nor (device times move ~1 % between runs)
        # much longer than an unprofiled step; more means events were
        # counted twice
        require(busy <= prof_step_ms and busy <= 1.02 * step_ms,
                f"profile: device busy {busy} ms per step exceeds the "
                f"step ({prof_step_ms} ms profiled, {step_ms} ms not)")
        k4 = _union_us([(a, b) for n, a, b in spans   # split + merge
                        if "paged_split_kernel" in n
                        or "paged_merge_kernel" in n]) / 1e3 / steps
        q1 = _union_us([(a, b) for n, a, b in spans   # Q1's kernels
                        if "q1_" in n]) / 1e3 / steps
        gemm = sum(v for k, v in dev.items()
                   if any(w in k.lower() for w in ("gemm", "gemv", "cutlass",
                                                   "sm90_xmma", "nvjet")))
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
        report.update({
            "device_busy_ms_per_step": busy,
            "device_kernel_sum_ms_per_step": sum(dev.values()) / 1e3 / steps,
            # against the unprofiled step: the profiler slows the host
            "device_idle_share": max(0.0, 1 - busy / step_ms),
            "k4_ms_per_step": k4, "q1_ms_per_step": q1,
            # cuBLAS: every product with bf16 weights, the LM head alone
            # with int8 weights
            "gemm_ms_per_step": gemm / 1e3 / steps,
            "other_ms_per_step": busy - k4 - q1 - gemm / 1e3 / steps,
            "top_kernels_ms_per_step": [[k[:80], v / 1e3 / steps]
                                        for k, v in top]})
    del eng
    torch.cuda.empty_cache()
    serve, tokens, _ = _serve_once(torch, model, None, mode, **kw)
    report["serve"] = {k: serve[k] for k in (
        "tokens_per_s", "itl_p50_ms", "itl_p99_ms", "ttft_p50_ms",
        "ttft_max_ms", "peak_mem_gib", "peak_reserved_gib", "wall_s",
        "decode_steps", "graph_replays", "first_token_waits",
        "host_gap_mean_ms", "q1_launches")}
    emit(report)
    return report, tokens


def phase_serve_parity(torch, model, kv_dtype):
    """The engine's K4 wiring and its decode graphs at the serve shape,
    for one pool: 8 slots, 128-block tables that grow during decode,
    every decode step of the serve mix (SERVE_NEW + SERVE_PARITY_STEPS
    tokens a request), the engine on its four widths (decode_buckets:
    1, 2, 4, 8) with the synchronous driver.  Before each of the
    engine's replays, on the same pool, inputs and tables: the gather
    path, the gather path with fp32 probabilities, the eager kernel
    path (each K4 call held to the gather attention per layer), and the
    step's inputs replayed through every other width (rows past the
    step's own as trash rows).  Then the engine's replay, whose K/V rows
    are the ones kept.  Emits serve_parity (kernel vs gather, see
    SERVE_LOGITS_FACTOR) and serve_graphs (replay vs the eager step,
    and each width against the step's width).  Returns the logits
    limit."""
    from paddle_tpu_torch.models import llama_decode as D
    from paddle_tpu_torch.ops import paged_attention as PA
    import numpy as np
    cfg = model.config
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    eng = _serve_engine(model, "graphs", kv_dtype=kv_dtype,
                        decode_buckets=True)
    require(eng.num_graphs == len(eng.decode_widths) == 4,
            f"{eng.num_graphs} graphs for widths {eng.decode_widths}")
    g = eng._graphs
    replay = g.replay
    B = eng.max_slots
    step, attend, kernel_fn = (D.paged_decode_step_batch, D._attend,
                               D.paged_attention)
    worst = {"layer_share": 0.0, "cuda_vs_gather": 0.0,
             "fp32probs_vs_gather": 0.0, "cuda_vs_fp32probs": 0.0,
             "graph_vs_eager": 0.0}
    widths = {v: {"rows": 0, "bitwise_rows": 0, "max_abs_err": 0.0}
              for v in eng.decode_widths}
    counts = {"steps": 0, "full_steps": 0, "argmax_same": 0, "rows": 0,
              "graph_bitwise_steps": 0}
    used = set()
    blocks = {}                      # rid -> (blocks first seen, last)
    live = None

    def per_slot(x):
        return x.float().abs().reshape(x.shape[0], -1).amax(1)[live]

    def attend_fp32_probs(q, k_view, v_view, valid_len, n_heads, n_kv):
        out = attend(q.float(), k_view, v_view, valid_len, n_heads, n_kv)
        return out.to(torch.promote_types(q.dtype, v_view.dtype))

    def kernel_checked(q, pk, pv, table, pos, split=None):
        out = kernel_fn(q, pk, pv, table, pos, split=split)
        ref = attend(q[:, None], D._paged_view(pk, table, q.dtype),
                     D._paged_view(pv, table, q.dtype), pos.long()[:, None],
                     nh, nkv)[:, 0]
        share = (per_slot(out.float() - ref.float())
                 / (2e-2 * per_slot(ref))).max().item()
        worst["layer_share"] = max(worst["layer_share"], share)
        return out

    def hooked(w):
        nonlocal live
        slots = [s for s in range(B) if eng._slots[s] is not None]
        # full width: row i is slot i; a compacted width: every row is a
        # live slot or a copy of one
        live = torch.tensor([eng._slots[s] is not None for s in range(w)]
                            if w == B else [True] * w, device="cuda")
        for s in slots:
            req, n = eng._slots[s], int((eng._pager.table[s] != 0).sum())
            blocks[req.rid] = (blocks.get(req.rid, (n, n))[0], n)
        token, pos, table = (v.clone() for v in g.views(g.inputs(w), w))
        saved = PA.LAUNCHES["paged_attention"], g.replays
        args = (eng.state, cfg, token, pos, eng._kvpool, table)
        ref, _ = step(*args, kernel="gather")
        D._attend = attend_fp32_probs
        try:
            alt, _ = step(*args, kernel="gather")
        finally:
            D._attend = attend
        D.paged_attention = kernel_checked
        try:
            eager, _ = step(*args, kernel="cuda", **eng._decode_kw)
        finally:
            D.paged_attention = kernel_fn
        require(PA.LAUNCHES["paged_attention"] - saved[0] == cfg.num_hidden_layers,
                "serve parity: kernel not run")
        others = {}
        for v in eng.decode_widths:
            if v == w:
                continue
            n = min(v, w)
            tv, pv, bv = g.views(g.inputs(v), v)
            for dst, src in ((tv, token), (pv, pos), (bv, table)):
                dst.zero_()                         # trash rows past n
                dst[:n] = src[:n]
            others[v] = (n, replay(v)[0].clone())
        PA.LAUNCHES["paged_attention"], g.replays = saved
        logits, argmax = replay(w)         # the engine's step, counted
        for key, x, y in (("cuda_vs_gather", logits, ref),
                          ("fp32probs_vs_gather", alt, ref),
                          ("cuda_vs_fp32probs", logits, alt),
                          ("graph_vs_eager", logits, eager)):
            worst[key] = max(worst[key], per_slot(x.float() - y.float())
                             .max().item())
        counts["graph_bitwise_steps"] += int(torch.equal(logits[live],
                                                         eager[live]))
        for v, (n, lv) in others.items():
            d = (lv[:n].float() - logits[:n].float()).abs().amax(1)
            widths[v]["rows"] += n
            widths[v]["bitwise_rows"] += int((d == 0).sum())
            widths[v]["max_abs_err"] = max(widths[v]["max_abs_err"],
                                           d.max().item())
        widths[w]["rows"] += w
        widths[w]["bitwise_rows"] += w
        used.add(w)
        counts["steps"] += 1
        counts["full_steps"] += int(w == B and bool(live.all()))
        counts["argmax_same"] += int((logits[live].argmax(1)
                                      == ref[live].argmax(1)).sum())
        counts["rows"] += int(live.sum())
        return logits, argmax

    rng = np.random.default_rng(0)
    for L in SERVE_LENGTHS:
        eng.submit(rng.integers(0, cfg.vocab_size, L),
                   SERVE_NEW + SERVE_PARITY_STEPS)
    g.replay = hooked
    try:
        eng.run()
    finally:
        del g.replay
    steps = int(_metric(eng, "decode_steps_total"))
    grew = sum(b > a for a, b in blocks.values())
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
          "logits_max_abs_err": {k: worst[k] for k in (
              "cuda_vs_gather", "fp32probs_vs_gather",
              "cuda_vs_fp32probs")},
          "logits_limit": limit,
          "argmax_agreement": counts["argmax_same"] / counts["rows"]})
    bitwise = counts["graph_bitwise_steps"] == counts["steps"]
    emit({"phase": "serve_graphs", "model": "llama3-8b", "kv_dtype": pool,
          "decode_steps": steps, "decode_steps_compared": counts["steps"],
          "widths_used_by_engine": sorted(used),
          "num_graphs": eng.num_graphs,
          "graph_vs_eager": {"bitwise_steps": counts["graph_bitwise_steps"],
                             "max_abs_err": worst["graph_vs_eager"]},
          "widths_vs_step_width": {str(v): d for v, d in widths.items()},
          "tolerance": "bitwise expected; held to max|x - y| per live "
                       "row <= the serve_parity logits limit "
                       f"({limit})",
          **({} if bitwise and all(
              d["bitwise_rows"] == d["rows"] for d in widths.values())
             else {"not_bitwise_because": "cuBLAS chose another "
                   "algorithm under capture or at another batch width "
                   "(M): the same products summed in another order"})})
    require(counts["steps"] == steps, f"serve parity: {counts['steps']} "
            f"of {steps} decode steps compared")
    require(counts["full_steps"] >= SERVE_PARITY_STEPS,
            f"serve parity: {counts['full_steps']} steps with all slots")
    require(grew == len(SERVE_LENGTHS),
            f"serve parity: only {grew} tables grew during decode")
    require(used == set(eng.decode_widths),
            f"serve graphs: the engine used widths {sorted(used)}")
    require(eng.num_graphs <= 4, f"{eng.num_graphs} graphs")
    require(worst["layer_share"] <= 1.0,
            f"serve parity ({pool} pool): a layer's kernel output is "
            f"{worst['layer_share']} x its limit from the gather path's")
    require(worst["cuda_vs_gather"] <= limit,
            f"serve parity ({pool} pool): kernel vs gather logits err "
            f"{worst['cuda_vs_gather']} > {limit}")
    require(worst["graph_vs_eager"] <= limit,
            f"serve graphs ({pool} pool): graph vs eager logits err "
            f"{worst['graph_vs_eager']} > {limit}")
    for v, d in widths.items():
        require(d["max_abs_err"] <= limit,
                f"serve graphs ({pool} pool): width {v} vs the step's "
                f"width: err {d['max_abs_err']} > {limit}")
    del eng
    torch.cuda.empty_cache()
    return limit


# --------------------------------------------------------------------------
# serving under KV memory pressure (engine sub-slice (b)) and with a shared
# system prompt (engine sub-slice (c)), at the serve shape
# --------------------------------------------------------------------------

PRESSURE_LENGTHS = SERVE_LENGTHS * 2      # 16 requests
# the depth of the phases run on `_shallow(model, SHALLOW_LAYERS)`: each
# holds itself to references run at its own depth, and the run keeps
# inside its time budget
SHALLOW_LAYERS = 8
PRESSURE_NEW = 256
PREFIX_SYSTEM, PREFIX_SUFFIX, PREFIX_N, PREFIX_NEW = 384, 16, 16, 32
PREFIX_KW = dict(max_prompt_len=400, prefix_cache_blocks=64,
                 prefix_block_tokens=16)


def pressure_blocks(lengths=PRESSURE_LENGTHS, new=PRESSURE_NEW):
    """`bench.py`'s overload pool (:916-919): about half the peak
    concurrent demand of the `max_slots` largest requests, never below
    one full sequence plus the trash block."""
    bt, slots = SERVE_KW["kv_block_tokens"], SERVE_KW["max_slots"]
    need = sorted((-(-(L + new) // bt) for L in lengths),
                  reverse=True)[:slots]
    return max(1 + -(-SERVE_KW["max_len"] // bt), 1 + sum(need) // 2)


def _unhook(torch, eng):
    """Drop an engine the phases below hooked.  A hook closes over its
    engine (a reference cycle): left to the cyclic GC, the engine's
    CUDA graphs could be freed inside a later capture, which
    invalidates that capture.  Remove the hooks, free it now."""
    for name in ("_park_slot", "_resume_swap", "_resume_recompute",
                 "_preempt_one", "_propose_drafts", "_export_blocks",
                 "_host_rows", "_serve_pull", "_pull_remote_prefix",
                 "_land_prefix_blocks", "_ho_send"):
        vars(eng).pop(name, None)
    for graphs in (eng._graphs, eng._vgraphs):
        if graphs is not None:
            vars(graphs).pop("replay", None)
    gc.collect()
    torch.cuda.empty_cache()


def _hook_ladder(torch, eng, times, roundtrip):
    """Time each park and each resume on the host clock, and each
    request's wait while parked.  With `roundtrip` (a dict): the first
    slot parked to the host tier has its blocks (every layer, K and V,
    int8 scales) gathered before the park and held, bitwise, against
    the blocks after its resume."""
    from paddle_tpu_torch.models import llama_decode as D
    park = eng._park_slot

    def blocks_of(slot, n=None):
        ids = eng._pager.slot_blocks[slot][:n]
        return D.gather_blocks(eng._kvpool,
                               torch.tensor(ids, device=eng.device))

    def parked(slot):
        times["rids"].append(eng._slots[slot].rid)
        if roundtrip is not None and "rid" not in roundtrip \
                and eng.preempt_policy == "swap":
            roundtrip.update(rid=eng._slots[slot].rid,
                             n=len(eng._pager.slot_blocks[slot]),
                             before=blocks_of(slot))
        t0 = time.perf_counter()
        park(slot)
        times["park"].append(time.perf_counter() - t0)

    def resumed(fn):
        def call(slot, pr):
            t0 = time.perf_counter()
            ok = fn(slot, pr)
            if ok:
                now = time.perf_counter()
                times["resume"].append(now - t0)
                times["parked"].append(now - pr.t_parked)
                if roundtrip is not None and "before" in roundtrip \
                        and roundtrip["rid"] == pr.req.rid:
                    roundtrip["equal"] = torch.equal(
                        roundtrip.pop("before"),
                        blocks_of(slot, roundtrip["n"]))
            return ok
        return call

    eng._park_slot = parked
    eng._resume_swap = resumed(eng._resume_swap)
    eng._resume_recompute = resumed(eng._resume_recompute)


def _logit_rows(eng, want):
    """Hook `eng`'s decode replays (full width: row s is slot s) and
    verify replays: the logits row of request `rid` for each token index
    t <= want[rid] that a step produces, cloned on the card, into the
    dict returned, keyed (rid, t).  A verify's column j predicts
    token len(tokens) + j (the engine dispatches after it committed);
    a later step's row for the same index replaces it, so each index
    keeps the row of the step that committed it."""
    rows = {}
    g, v = eng._graphs, eng._vgraphs
    d_replay = g.replay

    def decode(w):
        logits, argmax = d_replay(w)
        for s, req in enumerate(eng._slots[:w]):
            if req is not None and len(req.tokens) <= want.get(req.rid, -1):
                rows[req.rid, len(req.tokens)] = logits[s].clone()
        return logits, argmax

    g.replay = decode
    if v is not None:
        v_replay = v.replay

        def verify(W):
            logits, packed = v_replay(W)
            valid = v.views(v.inputs(W), W)[2].tolist()
            for s, req in enumerate(eng._slots):
                if req is None:
                    continue
                for j in range(valid[s]):
                    t = len(req.tokens) + j
                    if t <= want.get(req.rid, -1):
                        rows[req.rid, t] = logits[s, j].clone()
            return logits, packed

        v.replay = verify
    return rows


def _pressure_run(torch, model, kv_dtype, policy, prompts, roundtrip=None,
                  rows_of=None, **eng_kw):
    """One run of the pressure traffic (PRESSURE_NEW tokens a prompt)
    with graphs and the overlap driver: full provisioning when `policy`
    is None, else `pressure_blocks()` under that policy.  `roundtrip`:
    see `_hook_ladder`.  `rows_of` ({request index: last token index})
    records those requests' decode logits (`_logit_rows`, keyed by
    request index).  `eng_kw`: more engine knobs (weight_dtype).
    Returns (report, streams, rows)."""
    from paddle_tpu_torch.ops import paged_attention as PA
    kw = {} if policy is None else dict(kv_blocks=pressure_blocks(),
                                        preempt_policy=policy)
    eng = _serve_engine(model, kv_dtype=kv_dtype, **kw, **eng_kw)
    times = {"park": [], "resume": [], "parked": [], "rids": []}
    if policy is not None:
        _hook_ladder(torch, eng, times, roundtrip)
    stamps = {}

    def on_token(req, tok):
        stamps.setdefault(req.rid, []).append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.LAUNCHES["paged_attention"] = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, PRESSURE_NEW, on_token=on_token) for p in prompts]
    rows = None
    if rows_of is not None:
        rows = _logit_rows(eng, {reqs[i].rid: t for i, t in rows_of.items()})
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.LAUNCHES["paged_attention"]
    steps = int(_metric(eng, "decode_steps_total"))
    layers = model.config.num_hidden_layers
    name = f"serve_pressure ({kv_dtype or 'bfloat16'}, {policy})"
    for r in reqs:
        require(r.done and r.error is None
                and len(r.tokens) == PRESSURE_NEW,
                f"{name}: request {r.rid}: {len(r.tokens)} tokens, "
                f"{r.error!r}")
    require(launches == layers * steps == layers * eng.num_graph_replays,
            f"{name}: {launches} K4 launches, {steps} steps, "
            f"{eng.num_graph_replays} replays")
    eng._pager.check()
    require(eng._pager.used_blocks == 0 and eng._pager.host_blocks_used == 0
            and eng.num_parked == 0,
            f"{name}: {eng._pager.used_blocks} device and "
            f"{eng._pager.host_blocks_used} host blocks still held")
    ladder = {k: int(_metric(eng, k + "_total")) for k in (
        "preemptions", "resumes", "prefill_requeues", "swap_bytes")}
    if policy is not None:
        require(ladder["preemptions"] >= 3
                and ladder["resumes"] == ladder["preemptions"],
                f"{name}: ladder {ladder}")
        if policy != "auto":
            require((ladder["swap_bytes"] > 0) == (policy == "swap"),
                    f"{name}: {ladder['swap_bytes']} bytes swapped")
    itl = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
    ttft = [stamps[r.rid][0] - t0 for r in reqs]
    gen = sum(len(r.tokens) for r in reqs)
    index = {r.rid: i for i, r in enumerate(reqs)}

    def ms(xs, p=None):
        if not xs:
            return None
        return 1e3 * (max(xs) if p is None else _percentile(xs, p))

    report = {"kv_dtype": kv_dtype or "bfloat16",
              "weight_dtype": eng.weight_dtype,
              "policy": policy or "full provisioning",
              "kv_blocks": eng.kv_blocks,
              "kv_pool_gib": eng.kv_pool_bytes() / 2**30,
              "host_pool_blocks": eng.host_pool_blocks, **ladder,
              "parked_requests": sorted({index[r] for r in times["rids"]}),
              "swaps_landed_at_resume": (eng._swap_ready / eng._swap_total
                                         if eng._swap_total else None),
              "park_time_p50_ms": ms(times["parked"], 50),
              "park_time_max_ms": ms(times["parked"]),
              "park_host_ms_p50": ms(times["park"], 50),
              "park_host_ms_max": ms(times["park"]),
              "resume_host_ms_p50": ms(times["resume"], 50),
              "resume_host_ms_max": ms(times["resume"]),
              "requests": len(reqs), "generated_tokens": gen,
              "wall_s": wall, "tokens_per_s": gen / wall,
              "decode_steps": steps, "k4_launches": launches,
              "itl_p50_ms": ms(itl, 50), "itl_p99_ms": ms(itl, 99),
              "ttft_p50_ms": ms(ttft, 50), "ttft_max_ms": ms(ttft),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    streams = [list(r.tokens) for r in reqs]
    if rows is not None:
        rows = {(index[rid], t): x for (rid, t), x in rows.items()}
    _unhook(torch, eng)
    return report, streams, rows


def _flips(torch, model, kv_dtype, policy, prompts, ref, got, parked,
           limit):
    """`policy`'s streams against the full run's.  Only a request that
    was parked may differ (its KV was rebuilt by prefill).  Where a
    token differs, both runs again with the differing requests' decode
    logits recorded up to each one's first flip: every compared step
    within `limit` (max |logits - full run's|), or the phase fails.
    Returns the token agreement and, with flips, the first flip's step,
    its top-2 margin in the full run and the worst logits error."""
    agree = sum(a == b for x, y in zip(ref, got) for a, b in zip(x, y))
    out = {"token_agreement": agree / sum(map(len, ref))}
    flips = {i: next(t for t, (a, b) in enumerate(zip(x, y)) if a != b)
             for i, (x, y) in enumerate(zip(ref, got)) if x != y}
    require(set(flips) <= set(parked),
            f"serve_pressure ({policy}): requests {sorted(flips)} differ, "
            f"only {parked} were parked")
    if not flips:
        return out
    _, ref2, want = _pressure_run(torch, model, kv_dtype, None, prompts,
                                  rows_of=flips)
    _, got2, have = _pressure_run(torch, model, kv_dtype, policy, prompts,
                                  rows_of=flips)
    require(ref2 == ref and got2 == got,
            f"serve_pressure ({policy}): a rerun gave other streams")
    worst, first = 0.0, min(flips.items(), key=lambda kv: kv[1])
    for key, x in want.items():
        require(key in have, f"serve_pressure ({policy}): no logits for "
                f"request {key[0]} token {key[1]}")
        worst = max(worst, (have[key].float() - x.float()).abs().max()
                    .item())
    top2 = want[first].float().topk(2).values
    out.update({"requests_flipped": len(flips),
                "first_flip": {"request": first[0], "token": first[1],
                               "top2_margin": (top2[0] - top2[1]).item()},
                "steps_compared": len(want), "logits_max_abs_err": worst,
                "logits_limit": limit})
    require(worst <= limit,
            f"serve_pressure ({policy}): logits err {worst} > {limit}")
    return out


def phase_serve_pressure(torch, model, limits, shallow):
    """The pressure traffic (16 requests, SERVE_LENGTHS twice, 256 new
    tokens each) fully provisioned and at `pressure_blocks()` (2x
    oversubscribed) under "swap", "recompute" and "auto"; with the int8
    pool fully provisioned and under "swap", on `shallow` (the model's
    first layers: the int8 runs hold themselves to their own full run).
    Swap streams equal the full run's token for token and one parked
    slot's blocks return bitwise; recompute streams equal them, or stay
    within the serve_parity logits bound up to each flip (`limits` by
    pool).  Returns the K4 launches of each run and the
    full-provisioning streams by pool."""
    import numpy as np
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.config.vocab_size, L)
               for L in PRESSURE_LENGTHS]
    launches, full_streams = {}, {}
    for m, kv, policies in ((model, None, ("swap", "recompute", "auto")),
                            (shallow, "int8", ("swap",))):
        pool = kv or "bfloat16"
        full, ref, _ = _pressure_run(torch, m, kv, None, prompts)
        full_streams[pool] = ref
        layers = m.config.num_hidden_layers
        emit({"phase": "serve_pressure", "model": "llama3-8b",
              "layers": layers, **full})
        launches[pool, "full"] = full["k4_launches"]
        for policy in policies:
            roundtrip = {} if policy == "swap" else None
            report, got, _ = _pressure_run(torch, m, kv, policy,
                                           prompts, roundtrip)
            launches[pool, policy] = report["k4_launches"]
            if policy == "swap":
                require(got == ref, f"serve_pressure ({pool}, swap): "
                        f"streams differ from full provisioning")
                require(roundtrip.get("equal") is True,
                        f"serve_pressure ({pool}, swap): parked blocks "
                        f"after resume: {roundtrip}")
                check = {"streams_equal_full": True,
                         "park_roundtrip_bitwise_blocks": roundtrip["n"]}
            else:
                check = _flips(torch, m, kv, policy, prompts, ref, got,
                               report["parked_requests"], limits[pool])
            emit({"phase": "serve_pressure", "model": "llama3-8b",
                  "layers": layers, **report, **check})
    return launches, full_streams


def phase_serve_prefix(torch, model):
    """`bench.py`'s shared-system-prompt stream at the serve shape: a
    384-token system prompt + 16 distinct 16-token suffixes, 32 new
    tokens each, request 0 alone (the miss), then the other 15 at once,
    with the radix prefix cache (64 blocks) and without it.  Every
    later request must hit (384 tokens saved each), a trie block must
    be shared (refcount >= 2) while the decode graphs replay, and the
    streams must equal the uncached run's token for token.  Returns
    the K4 launches of each run and the cached run's streams."""
    import numpy as np
    from paddle_tpu_torch.ops import paged_attention as PA
    rng = np.random.default_rng(4)
    vocab = model.config.vocab_size
    system = rng.integers(0, vocab, PREFIX_SYSTEM)
    prompts = [np.concatenate([system, rng.integers(0, vocab,
                                                     PREFIX_SUFFIX)])
               for _ in range(PREFIX_N)]
    streams, launches = {}, {}
    for blocks in (0, PREFIX_KW["prefix_cache_blocks"]):
        eng = _serve_engine(model, **dict(PREFIX_KW,
                                          prefix_cache_blocks=blocks))
        shared = {"refcount": 0}
        if blocks:
            g = eng._graphs
            replay = g.replay

            def hooked(w, eng=eng, replay=replay):
                if shared["refcount"] < 2:
                    tab = eng._pager.table[[s for s in range(w)
                                            if eng._slots[s] is not None]]
                    shared["refcount"] = max([shared["refcount"]] + [
                        eng._pager.refcount(int(b)) for b in set(
                            tab[tab != 0].tolist())])
                return replay(w)
            g.replay = hooked
        stamps = {}

        def on_token(req, tok):
            stamps.setdefault(req.rid, []).append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        PA.LAUNCHES["paged_attention"] = 0
        first = eng.submit(prompts[0], PREFIX_NEW, on_token=on_token)
        eng.run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rest = [eng.submit(p, PREFIX_NEW, on_token=on_token)
                for p in prompts[1:]]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reqs = [first] + rest
        for r in reqs:
            require(r.done and r.error is None
                    and len(r.tokens) == PREFIX_NEW,
                    f"serve_prefix: request {r.rid}: {r.error!r}")
        steps = int(_metric(eng, "decode_steps_total"))
        launches[blocks] = PA.LAUNCHES["paged_attention"]
        require(launches[blocks] == model.config.num_hidden_layers * steps,
                f"serve_prefix: {launches[blocks]} launches, {steps} steps")
        ttft = [stamps[r.rid][0] - t0 for r in rest]
        hits = int(_metric(eng, "prefix_cache_hits_total"))
        saved = int(_metric(eng, "prefill_tokens_saved_total"))
        streams[blocks] = [list(r.tokens) for r in reqs]
        emit({"phase": "serve_prefix", "model": "llama3-8b",
              "prefix_cache_blocks": blocks, "requests": len(reqs),
              "prefix_cache_hits": hits, "prefill_tokens_saved": saved,
              "prefill_tokens_computed": int(_metric(
                  eng, "prompt_tokens_total")) - saved,
              "max_refcount_seen_in_replays": shared["refcount"]
              if blocks else None,
              "ttft_p50_ms_of_15": 1e3 * _percentile(ttft, 50),
              "ttft_max_ms_of_15": 1e3 * max(ttft),
              "tokens_per_s_of_15": sum(len(r.tokens) for r in rest) / wall,
              "wall_s_of_15": wall, "decode_steps": steps,
              "k4_launches": launches[blocks],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        if blocks:
            require(hits == PREFIX_N - 1, f"serve_prefix: {hits} hits")
            require(saved == (PREFIX_N - 1) * PREFIX_SYSTEM,
                    f"serve_prefix: {saved} tokens saved")
            require(shared["refcount"] >= 2,
                    "serve_prefix: no block shared during decode")
            eng._pager.check()
            require(eng._pager.used_blocks == eng._pcache.blocks_used,
                    "serve_prefix: blocks held past the trie's")
        _unhook(torch, eng)
    require(streams[0] == streams[PREFIX_KW["prefix_cache_blocks"]],
            "serve_prefix: streams with the prefix cache differ from "
            "those without it")
    emit({"phase": "serve_prefix", "streams_equal_uncached": True})
    return launches, streams[PREFIX_KW["prefix_cache_blocks"]]


# --------------------------------------------------------------------------
# speculative decoding (engine sub-slice (d)): K4 inside the verify step at
# the serve shape, and `bench.py`'s extraction stream with speculation off
# and on
# --------------------------------------------------------------------------

def _verify_parity(torch, model, kv_dtype, limit):
    """K4 inside one verify step at the serve shape, for one pool: the 8
    serve prompts prefilled into an engine with speculation (k 7,
    graphs, synchronous driver), every slot decoding, then one verify
    step of width 8 (each slot's token and 7 random drafts) on the same
    pool, inputs and tables through the gather path, the gather path
    with fp32 probabilities, the eager kernel path (each K4 call over
    the 64 columns held to the gather attention per row, K4's own
    tolerance) and the engine's verify graph, replayed twice.  The
    kernel path's logits are held to the gather path's by the
    serve_parity rule (SERVE_LOGITS_FACTOR x the fp32-probabilities
    gap of this step), the replays to each other bitwise and to the
    eager step bitwise or within that limit.  Then K4 alone on rows
    whose depth runs past the table (a padded column near max_len):
    the kernel attends the table's own rows, as its plain version.
    Last, each verify width's replay and the decode step's on these
    slots, timed by CUDA events."""
    import numpy as np
    from paddle_tpu_torch.inference import LLMEngine, SpecConfig
    from paddle_tpu_torch.models import llama_decode as D
    from paddle_tpu_torch.ops import paged_attention as PA
    cfg = model.config
    nh, nkv, layers = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.num_hidden_layers)
    eng = LLMEngine(model, overlap="off", kv_dtype=kv_dtype,
                    speculation=SpecConfig(k=SPEC_K), **SERVE_KW)
    eng.prepare_programs()
    require(eng.verify_widths == (2, 4, SPEC_W), eng.verify_widths)
    rng = np.random.default_rng(0)
    for L in SERVE_LENGTHS:
        eng.submit(rng.integers(0, cfg.vocab_size, L), SERVE_NEW)
    while eng.num_prefilling or eng._queue:
        eng.step()
    B, W = eng.max_slots, SPEC_W
    require(eng.num_active == B, f"{eng.num_active} slots decoding")
    require(eng._ensure_decode_capacity([W] * B), "no slot left")
    tokens = rng.integers(0, cfg.vocab_size, (B, W)).astype(np.int32)
    tokens[:, 0] = eng._token
    host = np.concatenate([tokens.reshape(-1), eng._pos,
                           np.full(B, W, np.int32),
                           eng._pager.table.reshape(-1)])
    g = eng._vgraphs
    flat = g.inputs(W)
    flat.copy_(torch.from_numpy(host).to(flat.device))
    args = [v.clone() for v in g.views(flat, W)]
    step, attend, kernel_fn = D.paged_verify_step, D._attend, \
        D.paged_attention
    worst = {"layer_share": 0.0}

    def per_row(x):
        return x.float().abs().reshape(x.shape[0], -1).amax(1)

    def attend_fp32_probs(q, k_view, v_view, valid_len, n_heads, n_kv):
        out = attend(q.float(), k_view, v_view, valid_len, n_heads, n_kv)
        return out.to(torch.promote_types(q.dtype, v_view.dtype))

    def kernel_checked(q, pk, pv, table, pos, split=None):
        out = kernel_fn(q, pk, pv, table, pos, split=split)
        ref = attend(q[:, None], D._paged_view(pk, table, q.dtype),
                     D._paged_view(pv, table, q.dtype), pos.long()[:, None],
                     nh, nkv)[:, 0]
        share = (per_row(out.float() - ref.float())
                 / (2e-2 * per_row(ref))).max().item()
        worst["layer_share"] = max(worst["layer_share"], share)
        return out

    state, pool = eng.state, eng._kvpool
    tok, pos, _, table = args
    ref, _ = step(state, cfg, tok, pos, pool, table, kernel="gather")
    D._attend = attend_fp32_probs
    try:
        alt, _ = step(state, cfg, tok, pos, pool, table, kernel="gather")
    finally:
        D._attend = attend
    launches = PA.LAUNCHES["paged_attention"]
    D.paged_attention = kernel_checked
    try:
        kern, _ = step(state, cfg, tok, pos, pool, table, kernel="cuda",
                       **eng._decode_kw)
    finally:
        D.paged_attention = kernel_fn
    require(PA.LAUNCHES["paged_attention"] - launches == layers,
            "verify parity: K4 not run once a layer")
    eager = [x.clone() for x in eng._verify_logits(*args)]
    replays = g.replays
    first = [x.clone() for x in g.replay(W)]
    second = g.replay(W)
    torch.cuda.synchronize()
    PA.LAUNCHES["paged_attention"] = launches      # checks, not the path
    g.replays = replays

    def rows_err(x, y):
        return per_row(x.reshape(B * W, -1).float()
                       - y.reshape(B * W, -1).float()).max().item()

    step_limit = SERVE_LOGITS_FACTOR * rows_err(alt, ref)
    errs = {"cuda_vs_gather": rows_err(kern, ref),
            "fp32probs_vs_gather": rows_err(alt, ref),
            "graph_vs_eager": rows_err(first[0], eager[0])}
    bitwise_twice = all(torch.equal(a, b) for a, b in zip(first, second))
    graph_bitwise = all(torch.equal(a, b) for a, b in zip(first, eager))
    argmax_same = (kern.float().argmax(-1) == ref.float().argmax(-1)) \
        .float().mean().item()
    # K4 on rows deeper than the table: 8 queries at depths past its
    # last row, against the last layer's pool and the slots' tables
    T = eng._pager.max_blocks * eng.kv_block_tokens
    pk, pv = pool[-1]
    q = torch.randn(B, nh, cfg.head_dim, device="cuda",
                    dtype=state["embed"].dtype)
    past = torch.arange(T, T + B, dtype=torch.int32, device="cuda")
    tab = torch.from_numpy(eng._pager.table).to("cuda")
    over = kernel_fn(q, pk, pv, tab, past, **eng._decode_kw)
    plain = PA.paged_attention_plain(q, pk, pv, tab, past)
    # the whole step on the card, by CUDA events: each verify width and
    # the decode step on these slots' inputs (live depths and tables)
    times = {}
    for v in eng.verify_widths:
        flat = g.inputs(v)
        flat.copy_(torch.from_numpy(np.concatenate([
            tokens[:, :v].reshape(-1), eng._pos, np.full(B, v, np.int32),
            eng._pager.table.reshape(-1)])).to(flat.device))
        times[f"verify_w{v}"] = _replay_times(torch, g, v)
    flat = eng._graphs.inputs(B)
    flat.copy_(torch.from_numpy(np.concatenate([
        eng._token, eng._pos, eng._pager.table.reshape(-1)]))
        .to(flat.device))
    times["decode"] = _replay_times(torch, eng._graphs, B)
    PA.LAUNCHES["paged_attention"] = launches
    over_share = (per_row(over.float() - plain.float())
                  / (2e-2 * per_row(plain))).max().item()
    pool_name = kv_dtype or "bfloat16"
    report = {"phase": "serve_spec_verify", "model": "llama3-8b",
              "kv_dtype": pool_name, "slots": B, "width": W,
              "depths": eng._pos.tolist(),
              "k4_rows_a_launch": B * W,
              "layer_tolerance": "per layer and column row r: max|cuda_r "
                                 "- gather_r| <= 2e-2 * max|gather_r|",
              "layer_worst_err_over_limit": worst["layer_share"],
              "logits_tolerance": f"max|cuda - gather| per column <= "
                                  f"{SERVE_LOGITS_FACTOR} x max|gather "
                                  f"with fp32 probs - gather|",
              "logits_max_abs_err": errs, "logits_limit": step_limit,
              "decode_serve_parity_limit": limit,
              "argmax_agreement": argmax_same,
              "graph_replays_bitwise_twice": bitwise_twice,
              "graph_vs_eager_bitwise": graph_bitwise,
              "k4_past_table_rows_err_over_limit": over_share,
              "step_replay_times": times}
    emit(report)
    require(worst["layer_share"] <= 1.0,
            f"verify parity ({pool_name}): a layer's kernel output is "
            f"{worst['layer_share']} x its limit")
    require(errs["cuda_vs_gather"] <= step_limit,
            f"verify parity ({pool_name}): kernel vs gather logits "
            f"{errs['cuda_vs_gather']} > {step_limit}")
    require(bitwise_twice, f"verify graph ({pool_name}): two replays "
            f"differ")
    require(graph_bitwise or errs["graph_vs_eager"] <= step_limit,
            f"verify graph ({pool_name}): replay vs eager "
            f"{errs['graph_vs_eager']} > {step_limit}")
    require(over_share <= 1.0, f"K4 past the table ({pool_name}): "
            f"{over_share} x its limit")
    _unhook(torch, eng)
    return report


def _spec_prompts(torch, model):
    """`bench.py:524-579`'s extraction workload on the card: greedy
    continuations of 40 cyclic seed prompts (period 1-4, SPEC_SEED
    tokens), harvested through the engine; each stream's seed + first
    SPEC_KEEP tokens re-fed as a prompt, whose continuation is then
    predictable from it; the SPEC_N streams a host-side dry run of the
    n-gram drafter scores most draftable.  Returns (prompts, report)."""
    import numpy as np
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.inference.ngram_draft import NGramIndex
    rng = np.random.RandomState(0)
    vocab = model.config.vocab_size
    seeds = [np.tile(rng.randint(2, vocab, (1 + i % 4,)), SPEC_SEED)
             [:SPEC_SEED] for i in range(5 * SPEC_N)]
    t0 = time.perf_counter()
    harvest = LLMEngine(model, max_slots=8,
                        max_len=SPEC_SEED + SPEC_KEEP + SPEC_NEW + 8,
                        max_prompt_len=SPEC_SEED, prefill_chunk=SPEC_CHUNK)
    reqs = [harvest.submit(p, SPEC_KEEP + SPEC_NEW) for p in seeds]
    harvest.run()
    secs = time.perf_counter() - t0
    del harvest
    torch.cuda.empty_cache()

    def sim_accept(ctx, cont, k):
        idx = NGramIndex([int(t) for t in ctx], 3, 1)
        i = prop = acc = 0
        while i < len(cont):
            d = idx.propose(k)
            m = 0
            for j, t in enumerate(d):
                if i + j < len(cont) and t == cont[i + j]:
                    m += 1
                else:
                    break
            prop += len(d)
            acc += m
            for j in range(min(m + 1, len(cont) - i)):
                idx.extend(cont[i + j])
            i += m + 1
        return acc / max(prop, 1)

    scored = sorted(((sim_accept(np.concatenate(
        [s, np.asarray(r.tokens[:SPEC_KEEP])]), r.tokens[SPEC_KEEP:],
        SPEC_K), i) for i, (s, r) in enumerate(zip(seeds, reqs))),
        key=lambda t: -t[0])
    keep = [i for _, i in scored[:SPEC_N]]
    prompts = [np.concatenate([seeds[i], np.asarray(reqs[i].tokens
                                                    [:SPEC_KEEP])])
               for i in keep]
    return prompts, {"harvest_requests": len(seeds), "harvest_s": secs,
                     "dry_run_acceptance_kept": [s for s, _ in
                                                 scored[:SPEC_N]]}


def _spec_run(torch, model, spec, prompts, kv_dtype=None, rows_of=None,
              warm=True, **eng_kw):
    """The extraction stream through one engine (graphs + overlap,
    `bench.py:581-613`'s knobs): with `warm`, a warm-up pass, then the
    pass measured (launch counts from 0, peak memory reset).  ITL per
    request, the engine's convention: a step that emits e of its tokens
    e samples of (time since its previous token) / e; beside it
    `bench.py`'s step-loop figure (each step's host time over all the
    tokens it emitted).  `rows_of` ({request index: last token index})
    records decode / verify logits (`_logit_rows`).  `eng_kw`: more
    engine knobs (weight_dtype).  Returns (report, streams, rows)."""
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops import wo_int8_matmul as Q1
    eng = LLMEngine(model, max_slots=8,
                    max_len=SPEC_SEED + SPEC_KEEP + SPEC_NEW + 8,
                    max_prompt_len=SPEC_SEED + SPEC_KEEP,
                    prefill_chunk=SPEC_CHUNK,
                    step_token_budget=8 * SPEC_CHUNK, speculation=spec,
                    kv_dtype=kv_dtype, **eng_kw)
    require(eng.overlap and eng._graphs is not None, "not graphs + overlap")
    eng.prepare_programs()

    def run_once(hook=None):
        reqs = [eng.submit(p, SPEC_NEW) for p in prompts]
        rows = None if hook is None else hook(reqs)
        samples, itl, steps, last = [], [], 0, {}
        while eng.has_work:
            before = [len(r.tokens) for r in reqs]
            t0 = time.perf_counter()
            eng.step()
            now = time.perf_counter()
            dt = now - t0
            emitted = sum(len(r.tokens) for r in reqs) - sum(before)
            if emitted:
                steps += 1
                samples.extend([dt / emitted] * emitted)
            for r, n in zip(reqs, before):
                e = len(r.tokens) - n
                if e and r.rid in last:
                    itl.extend([(now - last[r.rid]) / e] * e)
                if e:
                    last[r.rid] = now
        for r in reqs:
            require(r.done and r.error is None
                    and len(r.tokens) == SPEC_NEW,
                    f"serve_spec: request {r.rid}: {len(r.tokens)} "
                    f"tokens, {r.error!r}")
        return reqs, samples, itl, steps, rows

    if warm:
        run_once()
    snap = eng.metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.LAUNCHES["paged_attention"] = 0
    Q1.LAUNCHES["wo_int8_matmul"] = 0
    replays = (eng._graphs.replays, eng.num_verify_replays)
    hook = None if rows_of is None else (lambda reqs: _logit_rows(
        eng, {reqs[i].rid: t for i, t in rows_of.items()}))
    with _prefill_calls() as prefills:
        t0 = time.perf_counter()
        reqs, samples, itl, steps, rows = run_once(hook)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = PA.LAUNCHES["paged_attention"]
    decode_replays = eng._graphs.replays - replays[0]
    verify_replays = eng.num_verify_replays - replays[1]
    after = eng.metrics()
    layers = model.config.num_hidden_layers

    def delta(name, field="value"):
        key = "llm_engine_" + name
        return after[key]["series"][""][field] - \
            snap[key]["series"][""][field]

    device_steps = int(delta("decode_steps_total"))
    q1 = _q1_expected(eng, layers, decode_replays + verify_replays,
                      prefills[0], "serve_spec")
    require(launches == layers * (decode_replays + verify_replays),
            f"serve_spec: {launches} K4 launches for {decode_replays} "
            f"decode and {verify_replays} verify replays")
    require(decode_replays + verify_replays == device_steps,
            f"serve_spec: {device_steps} device steps, "
            f"{decode_replays + verify_replays} replays")
    require(eng.num_graphs <= len(eng.decode_widths)
            + len(eng.verify_widths), f"serve_spec: {eng.num_graphs} graphs")
    proposed = delta("spec_tokens_proposed_total")
    accepted = delta("spec_tokens_accepted_total")
    gen = sum(len(r.tokens) for r in reqs)
    report = {"kv_dtype": kv_dtype or str(model.config.dtype),
              "speculation": None if spec is None else vars(spec),
              "verify_widths": list(eng.verify_widths),
              "requests": len(reqs), "generated_tokens": gen,
              "wall_s": wall, "tokens_per_s": gen / wall,
              "itl_p50_ms": 1e3 * _percentile(itl, 50),
              "itl_p99_ms": 1e3 * _percentile(itl, 99),
              "step_loop_ms_per_token_p50": 1e3 * _percentile(samples, 50),
              "step_loop_ms_per_token_p99": 1e3 * _percentile(samples, 99),
              "tokens_per_step": len(samples) / steps,
              "scheduler_steps_emitting": steps,
              "device_steps": device_steps,
              "tokens_per_device_step": delta("tokens_emitted_per_step",
                                              "sum")
              / max(delta("tokens_emitted_per_step", "count"), 1),
              "decode_replays": decode_replays,
              "verify_replays": verify_replays,
              "spec_verify_steps": int(delta("spec_verify_steps_total")),
              "spec_proposed": int(proposed),
              "spec_accepted": int(accepted),
              "acceptance_rate": accepted / proposed if proposed else 0.0,
              "k4_launches": launches, "num_graphs": eng.num_graphs,
              "weight_dtype": eng.weight_dtype, "q1_launches": q1,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    streams = [[int(t) for t in r.tokens] for r in reqs]
    if rows is not None:
        index = {r.rid: i for i, r in enumerate(reqs)}
        rows = {(index[rid], t): x for (rid, t), x in rows.items()}
    _unhook(torch, eng)
    return report, streams, rows


def _spec_flips(torch, model, prompts, ref, got, limit, kv_dtype=None,
                rows=None):
    """Spec-on streams `got` against spec-off `ref`: token agreement;
    where they differ, each request's logits up to its first flip in
    both runs (recorded now, or given as `rows` = (off, on)) within
    `limit`, and the first flip's top-2 margin in the spec-off run."""
    from paddle_tpu_torch.inference import SpecConfig
    agree = sum(a == b for x, y in zip(ref, got) for a, b in zip(x, y))
    out = {"token_agreement": agree / sum(map(len, ref)),
           "streams_equal": ref == got}
    flips = {i: next(t for t, (a, b) in enumerate(zip(x, y)) if a != b)
             for i, (x, y) in enumerate(zip(ref, got)) if x != y}
    if not flips and rows is None:
        return out
    if rows is None:
        _, ref2, want = _spec_run(torch, model, None, prompts, kv_dtype,
                                  rows_of=flips, warm=False)
        _, got2, have = _spec_run(torch, model, SpecConfig(k=SPEC_K),
                                  prompts, kv_dtype, rows_of=flips,
                                  warm=False)
        require(ref2 == ref and got2 == got,
                "serve_spec: a rerun gave other streams")
    else:
        want, have = rows
    worst, compared = 0.0, 0
    for (i, t), x in want.items():
        if t > flips.get(i, -1 if rows is None else len(ref[i])):
            continue
        require((i, t) in have, f"serve_spec: no spec-on logits for "
                f"request {i} token {t}")
        worst = max(worst, (have[i, t].float() - x.float()).abs().max()
                    .item())
        compared += 1
    out.update({"requests_flipped": len(flips),
                "steps_compared": compared, "logits_max_abs_err": worst,
                "logits_limit": limit})
    if flips:
        first = min(flips.items(), key=lambda kv: kv[1])
        top2 = want[first].float().topk(2).values
        out["first_flip"] = {"request": first[0], "token": first[1],
                             "top2_margin": (top2[0] - top2[1]).item()}
    require(worst <= limit,
            f"serve_spec: logits up to the first flips {worst} > {limit}")
    return out


def phase_serve_spec(torch, model, limits, name="llama3-8b"):
    """`bench.py:517-613`'s extraction stream at its card sizes (8
    streams of 144-token prompts x 96 tokens, k 7, verify widths 2, 4,
    8, prefill_chunk 64, step_token_budget 512; graphs + overlap) with
    speculation off and on, in the model's dtype: ITL, tokens a step,
    acceptance, verify steps, graphs, peak memory, K4 launches =
    layers x (decode + verify replays); the spec-on streams against the
    spec-off ones (equal, or near-ties flipped with the logits up to
    each first flip within `limits[pool]`).  llama3-8b's random weights
    write no text a drafter can predict (its greedy continuations do
    not repeat), so there speculation runs its verify steps and adapts
    its draft length down, and only the int8 pool is added (spec on
    against spec off through per-step logits); debug-4l's loop, so
    there drafts are accepted (required).  Returns the K4 launches of
    the measured spec-on runs by pool."""
    from paddle_tpu_torch.inference import SpecConfig
    prompts, prep = _spec_prompts(torch, model)
    pool = str(model.config.dtype)
    emit({"phase": "serve_spec", "model": name, **prep})
    off, ref, _ = _spec_run(torch, model, None, prompts)
    emit({"phase": "serve_spec", "model": name, **off})
    on, got, _ = _spec_run(torch, model, SpecConfig(k=SPEC_K), prompts)
    require(on["spec_verify_steps"] > 0 and on["spec_proposed"] > 0,
            f"serve_spec ({name}): no verify step ran")
    check = _spec_flips(torch, model, prompts, ref, got, limits[pool])
    emit({"phase": "serve_spec", "model": name, **on, **check,
          "itl_p50_off_over_on": off["itl_p50_ms"] / on["itl_p50_ms"],
          "tokens_per_device_step_off": off["tokens_per_device_step"]})
    if name != "llama3-8b":
        require(on["spec_accepted"] > 0,
                f"serve_spec ({name}): no draft accepted")
        return {pool: on["k4_launches"]}
    every = {i: SPEC_NEW - 1 for i in range(SPEC_N)}
    _, ref8, want = _spec_run(torch, model, None, prompts, "int8",
                              rows_of=every, warm=False)
    on8, got8, have = _spec_run(torch, model, SpecConfig(k=SPEC_K),
                                prompts, "int8", rows_of=every, warm=False)
    require(on8["spec_verify_steps"] > 0, "serve_spec int8: no verify")
    check8 = _spec_flips(torch, model, prompts, ref8, got8,
                         limits["int8"], "int8", rows=(want, have))
    emit({"phase": "serve_spec", "model": "llama3-8b", **on8, **check8,
          "note": "one pass with logits recorded (no warm-up): times "
                  "include the recording"})
    return {pool: on["k4_launches"], "int8": on8["k4_launches"]}


# --------------------------------------------------------------------------
# SLO tiers and the overload ladder through LLMServer (engine sub-slice
# (e)), at the serve shape under KV pressure
# --------------------------------------------------------------------------

# request i of the pressure traffic gets SLO_TIERS[i % 4]: 4 interactive,
# 4 standard and 8 batch over the lengths
SLO_TIERS = ("interactive", "standard", "batch", "batch")
SLO_LADDER_NEW = 64           # tokens a request in the forced-ladder runs
SLO_WAIT_S = 600.0            # every result(timeout=) and bounded wait


def _bounded(pred, what, timeout=SLO_WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        require(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.01)


def _replays(eng):
    """(decode, verify) graph replays so far."""
    return (eng._graphs.replays,
            0 if eng._vgraphs is None else eng._vgraphs.replays)


def _k4_count(torch, eng, since, what):
    """K4's launches since they were zeroed, held to layers x the decode
    + verify replays since `since` (`_replays` then); returns them."""
    from paddle_tpu_torch.ops import paged_attention as PA
    launches = PA.LAUNCHES["paged_attention"]
    now = _replays(eng)
    d, v = now[0] - since[0], now[1] - since[1]
    layers = eng.cfg.num_hidden_layers
    require(d + v > 0 and launches == layers * (d + v),
            f"{what}: {launches} K4 launches for {d} decode and {v} "
            f"verify replays x {layers} layers")
    return {"k4_launches": launches, "decode_replays": d,
            "verify_replays": v}


def _hook_tiers(eng, parks):
    """Record each park's tier in `parks` and hold the tier invariant
    there: the slot parked has the lowest tier of the decoding slots
    other than the one the ladder is making room for (its `protect`),
    so no higher tier parks while a lower one holds a slot."""
    from paddle_tpu_torch.inference import SLOTier
    park, preempt = eng._park_slot, eng._preempt_one
    making_room = []

    def preempt_one(protect=None):
        making_room.append(protect)
        try:
            return preempt(protect=protect)
        finally:
            making_room.pop()

    def parked(slot):
        tier = eng._slots[slot].tier
        spared = making_room[-1] if making_room else None
        others = [SLOTier.rank(r.tier) for s, r in enumerate(eng._slots)
                  if r is not None and s not in (slot, spared)]
        require(not others or SLOTier.rank(tier) <= min(others),
                f"serve_slo: a {tier} slot parked while a lower tier "
                f"decodes: {[r.tier for r in eng._slots if r]}")
        parks.append(tier)
        park(slot)

    eng._preempt_one = preempt_one
    eng._park_slot = parked


def _slo_run(torch, model, prompts, tiers, http=False):
    """The pressure traffic through one `LLMServer` (158 blocks, swap,
    the overload ladder, default SLO targets, /metrics on an ephemeral
    port, the watchdog, the series sampler, a canary), every request
    submitted at once from its own client thread and collected with
    `Request.result(timeout=)`.  With `http`, the server surface is then
    checked over HTTP, and the canary quarantines it.  Returns the
    report (per tier: TTFT / ITL p50 / p99, goodput, shed, parks; by
    the tier each request has in the mixed run: TTFT / ITL)."""
    import threading
    from paddle_tpu_torch.inference import (LLMServer, Overloaded,
                                            SLOTier)
    from paddle_tpu_torch.ops import paged_attention as PA
    srv = LLMServer(model, metrics_port=0, canary_interval=3600.0,
                    watchdog_deadline=120.0, series_interval=1.0,
                    overload=True, kv_blocks=pressure_blocks(),
                    preempt_policy="swap", **SERVE_KW)
    eng = srv.engine
    name = "serve_slo (" + ("mixed tiers" if http else "one tier") + ")"
    # the driver's first tick sends a canary probe: let it land before
    # the counts start
    _bounded(lambda: srv._m_canary_probes.value >= 1
             and not srv._canary_inflight and not eng.has_work,
             "the first canary probe")
    parks = []
    _hook_tiers(eng, parks)
    stamps = [[] for _ in prompts]
    outcome = [None] * len(prompts)
    t_sub = [None] * len(prompts)
    barrier = threading.Barrier(len(prompts))

    def client(i):
        barrier.wait()
        t_sub[i] = time.perf_counter()
        try:
            req = srv.submit(prompts[i], PRESSURE_NEW, tier=tiers[i],
                             on_token=lambda r, t: stamps[i].append(
                                 time.perf_counter()))
        except Overloaded as e:
            outcome[i] = ("rejected", e)
            return
        try:
            req.result(timeout=SLO_WAIT_S)
            outcome[i] = ("done", req)
        except Exception as e:  # noqa: BLE001 — classified below
            outcome[i] = ("failed", e)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.LAUNCHES["paged_attention"] = 0
    since = _replays(eng)
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SLO_WAIT_S)
        require(not t.is_alive(), f"{name}: a client never returned")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (kind, x) in enumerate(outcome):
        # the lowest tier may be shed (at submit or from the queue),
        # with `Overloaded` and nothing else
        require(kind == "done" or (tiers[i] == SLOTier.lowest()
                                   and isinstance(x, Overloaded)),
                f"{name}: {tiers[i]} request {i}: {kind} {x!r}")
        if kind == "done":
            require(len(x.tokens) == PRESSURE_NEW,
                    f"{name}: request {i}: {len(x.tokens)} tokens")
    surface = _slo_http(srv) if http else None
    srv.shutdown(drain=True, drain_timeout=SLO_WAIT_S)
    require(not srv._thread.is_alive(), f"{name}: the driver still runs")
    eng.run()               # a canary probe left in flight, if any
    counts = _k4_count(torch, eng, since, name)
    eng._pager.check()
    require(eng._pager.used_blocks == 0 and eng._pager.host_blocks_used == 0
            and eng.num_parked == 0,
            f"{name}: {eng._pager.used_blocks} device, "
            f"{eng._pager.host_blocks_used} host blocks still held")
    m = eng.metrics()

    def tier_metric(metric, tier, field="value"):
        return m["llm_engine_" + metric]["series"][f"tier={tier}"][field]

    def lat(idx):
        ttft = [stamps[i][0] - t_sub[i] for i in idx if stamps[i]]
        itl = [b - a for i in idx for a, b in zip(stamps[i], stamps[i][1:])]
        return {"requests": len(idx),
                "finished": sum(outcome[i][0] == "done" for i in idx),
                "ttft_p50_ms": 1e3 * _percentile(ttft, 50) if ttft else None,
                "ttft_p99_ms": 1e3 * _percentile(ttft, 99) if ttft else None,
                "itl_p50_ms": 1e3 * _percentile(itl, 50) if itl else None,
                "itl_p99_ms": 1e3 * _percentile(itl, 99) if itl else None}

    gen = sum(len(x.tokens) for kind, x in outcome if kind == "done")
    report = {"tiers": "mixed" if http else "all standard (FIFO)",
              "kv_blocks": eng.kv_blocks, "policy": eng.preempt_policy,
              # by the tier each request has in the mixed run, so the
              # two runs line up request for request
              "latency_by_mixed_tier": {
                  t: lat([i for i in range(len(prompts))
                          if SLO_TIERS[i % 4] == t]) for t in SLOTier.ALL},
              # the engine's own tier counters (canary probes count as
              # "standard")
              "tier_counters": {t: {
                  "slo_met": tier_metric("slo_met_total", t),
                  "slo_missed": tier_metric("slo_missed_total", t),
                  "goodput": tier_metric("slo_goodput", t),
                  "shed": tier_metric("requests_shed_total", t),
                  "parks": parks.count(t)} for t in SLOTier.ALL},
              # who got a slot first (I / S / B, the mixed-run tier, in
              # first-token order): the tier order acts on the queue
              # only, so early arrivals keep the slots they took
              "first_tokens_in_order": "".join(
                  SLO_TIERS[i % 4][0].upper() for _, i in sorted(
                      (stamps[i][0], i) for i in range(len(prompts))
                      if stamps[i])),
              "rung_history": list(eng._overload.history),
              "preemptions": int(_metric(eng, "preemptions_total")),
              "generated_tokens": gen, "wall_s": wall,
              "tokens_per_s": gen / wall, "peak_mem_gib": peak,
              "canary_probes": int(srv._m_canary_probes.value), **counts}
    if surface is not None:
        report["server_surface"] = surface
    _unhook(torch, eng)
    return report


def _slo_http(srv):
    """/metrics and /healthz over HTTP; the canary probe, then an
    injected `engine.canary` mismatch quarantines the server: submit
    refused, /healthz still 200 with status "quarantined"."""
    import urllib.request
    from paddle_tpu_torch.inference import EngineUnhealthy
    from paddle_tpu_torch.testing import faults
    host, port = srv.metrics_address

    def get(path):
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read().decode()

    code, text = get("/metrics")
    require(code == 200 and "llm_engine_overload_rung " in text
            and 'llm_engine_tier_ttft_seconds_count{tier="interactive"}'
            in text and 'llm_engine_slo_goodput{tier="batch"}' in text,
            "serve_slo: /metrics lacks the tier series or the rung")
    code, body = get("/healthz")
    h = json.loads(body)
    require(code == 200 and h["status"] == "ok"
            and set(h) == set(HEALTHZ_KEYS),
            f"serve_slo: /healthz {code}: {sorted(h)}")
    require(srv.probe_canary(timeout=SLO_WAIT_S) is True,
            "serve_slo: the canary probe failed on a clean server")
    faults.ENABLED = True
    try:
        faults.get_injector().inject("engine.canary", times=1)
        require(srv.probe_canary(timeout=SLO_WAIT_S) is False,
                "serve_slo: an injected canary mismatch did not quarantine")
    finally:
        faults.get_injector().clear()
        faults.ENABLED = False
    try:
        srv.submit([1, 2, 3], 4)
        refused = False
    except EngineUnhealthy:
        refused = True
    require(refused, "serve_slo: a quarantined server accepted a request")
    code, body = get("/healthz")
    q = json.loads(body)
    require(code == 200 and q["status"] == "quarantined"
            and q["canary_failures"] == 1,
            f"serve_slo: /healthz when quarantined: {code} {q['status']}")
    return {"metrics_bytes": len(text), "healthz_keys": len(h),
            "canary_probes": q["canary_probes"],
            "quarantined_healthz": [code, q["status"]],
            "submit_refused": "EngineUnhealthy"}


def _ladder_run(torch, model, prompts, overload, rows_of=None):
    """`prompts` (interactive) through an engine at the serve shape
    (graphs + overlap, full provisioning): with `overload`, the ladder
    first forced to rung 4 by `engine.overload` times=4 on idle steps,
    a batch submit refused with `Overloaded`, the requests served from
    rung 4, and the ladder left to walk back once the fault is cleared.
    `rows_of`: see `_logit_rows`.  Returns (report, streams, rows)."""
    from paddle_tpu_torch.inference import Overloaded
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.testing import faults
    eng = _serve_engine(model, overload=True if overload else None)
    report = {}
    if overload:
        faults.ENABLED = True
        try:
            faults.get_injector().inject("engine.overload", times=4)
            for _ in range(5):
                eng.step()
        finally:
            faults.get_injector().clear()
            faults.ENABLED = False
        forced = list(eng._overload.history)
        require(forced == [1, 2, 3, 4],
                f"serve_slo ladder: forced history {forced}")
        try:
            eng.submit(prompts[0], SLO_LADDER_NEW, tier="batch")
            shed = None
        except Overloaded as e:
            shed = type(e).__name__
        require(shed == "Overloaded",
                "serve_slo ladder: a batch submit at rung 4 was accepted")
        report.update(forced_history=forced, batch_submit=shed,
                      rung_at_submit=eng.overload_rung)
    PA.LAUNCHES["paged_attention"] = 0
    since = _replays(eng)
    reqs = [eng.submit(p, SLO_LADDER_NEW, tier="interactive")
            for p in prompts]
    rows = None
    if rows_of is not None:
        rows = _logit_rows(eng, {reqs[i].rid: t for i, t in rows_of.items()})
    eng.run()
    report.update(_k4_count(torch, eng, since, "serve_slo ladder"))
    for r in reqs:
        require(r.done and r.error is None
                and len(r.tokens) == SLO_LADDER_NEW,
                f"serve_slo ladder: request {r.rid}: {r.error!r}")
    if overload:
        for _ in range(200):
            if eng.overload_rung == 0:
                break
            eng.step()
        hist = list(eng._overload.history)
        require(eng.overload_rung == 0 and hist[:4] == [1, 2, 3, 4]
                and hist[-4:] == [3, 2, 1, 0],
                f"serve_slo ladder: history after the fault {hist}")
        report["history"] = hist
    streams = [list(r.tokens) for r in reqs]
    if rows is not None:
        index = {r.rid: i for i, r in enumerate(reqs)}
        rows = {(index[rid], t): x for (rid, t), x in rows.items()}
    _unhook(torch, eng)
    return report, streams, rows


def phase_serve_slo(torch, model, limits):
    """Engine sub-slice (e) at the serve shape on llama3-8b: the
    pressure traffic with mixed tiers through `LLMServer` (and the
    server's HTTP surface, canary and quarantine), the same requests
    all standard (FIFO), and the forced overload ladder against an
    unloaded engine.  Returns K4's launches of each run."""
    import numpy as np
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.config.vocab_size, L)
               for L in PRESSURE_LENGTHS]
    tiers = [SLO_TIERS[i % 4] for i in range(len(prompts))]
    reports = []
    for mixed in (True, False):
        reports.append(_slo_run(torch, model, prompts, tiers if mixed
                                else ["standard"] * len(prompts), mixed))
        # the server's HTTP handler class closes over it (a reference
        # cycle): free its graphs now, not inside a later capture
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "serve_slo", "model": "llama3-8b",
              "layers": model.config.num_hidden_layers, **reports[-1]})
    mixed, fifo = reports
    inter = [p for p, t in zip(prompts, tiers) if t == "interactive"]
    ladder, got, _ = _ladder_run(torch, model, inter, overload=True)
    calm, ref, _ = _ladder_run(torch, model, inter, overload=False)
    check = {"streams_equal_unloaded": got == ref}
    if got != ref:
        flips = {i: next(t for t, (a, b) in enumerate(zip(x, y)) if a != b)
                 for i, (x, y) in enumerate(zip(ref, got)) if x != y}
        _, ref2, want = _ladder_run(torch, model, inter, False, flips)
        _, got2, have = _ladder_run(torch, model, inter, True, flips)
        require(ref2 == ref and got2 == got,
                "serve_slo ladder: a rerun gave other streams")
        worst = max((have[k].float() - x.float()).abs().max().item()
                    for k, x in want.items())
        first = min(flips.items(), key=lambda kv: kv[1])
        top2 = want[first].float().topk(2).values
        check.update(requests_flipped=len(flips),
                     first_flip={"request": first[0], "token": first[1],
                                 "top2_margin": (top2[0] - top2[1]).item()},
                     logits_max_abs_err=worst,
                     logits_limit=limits["bfloat16"])
        require(worst <= limits["bfloat16"],
                f"serve_slo ladder: logits err {worst} > "
                f"{limits['bfloat16']}")
    emit({"phase": "serve_slo", "model": "llama3-8b",
          "layers": model.config.num_hidden_layers, "run": "forced ladder",
          **ladder, **check, "unloaded_k4_launches": calm["k4_launches"]})
    return {"mixed tiers": mixed["k4_launches"],
            "one tier (FIFO)": fifo["k4_launches"],
            "forced ladder": ladder["k4_launches"],
            "unloaded": calm["k4_launches"]}


def phase_serve_slo_debug(torch, model):
    """Engine sub-slice (e) on debug-4l (fp32): rung 1 with speculation
    on (the extraction stream, half the requests batch: batch slots
    draft nothing, interactive ones draft and accept, the verify graphs
    replay), and the hang watchdog on an `LLMServer` wedged by
    `engine.stall` (exc=None, delay=3) past `watchdog_deadline=1`.
    Returns K4's launches of each run."""
    from paddle_tpu_torch.inference import (LLMEngine, LLMServer,
                                            OverloadConfig, SpecConfig)
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.testing import faults
    prompts, _ = _spec_prompts(torch, model)
    tiers = ["interactive" if i % 2 == 0 else "batch"
             for i in range(len(prompts))]
    eng = LLMEngine(model, max_slots=8,
                    max_len=SPEC_SEED + SPEC_KEEP + SPEC_NEW + 8,
                    max_prompt_len=SPEC_SEED + SPEC_KEEP,
                    prefill_chunk=SPEC_CHUNK,
                    step_token_budget=8 * SPEC_CHUNK,
                    speculation=SpecConfig(k=SPEC_K),
                    overload=OverloadConfig(max_rung=1))
    eng.prepare_programs()
    drafted = {"interactive": 0, "batch": 0}
    propose = eng._propose_drafts

    def counted():
        drafts, cost = propose()
        for slot, d in enumerate(drafts or []):
            if d:
                drafted[eng._slots[slot].tier] += len(d)
        return drafts, cost

    eng._propose_drafts = counted
    faults.ENABLED = True
    try:
        faults.get_injector().inject("engine.overload", times=None)
        PA.LAUNCHES["paged_attention"] = 0
        since = _replays(eng)
        reqs = [eng.submit(p, SPEC_NEW, tier=t)
                for p, t in zip(prompts, tiers)]
        eng.run()
        rung = eng.overload_rung
    finally:
        faults.get_injector().clear()
        faults.ENABLED = False
    spec = _k4_count(torch, eng, since, "serve_slo rung 1")
    for r in reqs:
        require(r.done and r.error is None and len(r.tokens) == SPEC_NEW,
                f"serve_slo rung 1: request {r.rid}: {r.error!r}")
    accepted = int(_metric(eng, "spec_tokens_accepted_total"))
    require(rung == 1 and drafted["batch"] == 0
            and drafted["interactive"] > 0 and accepted > 0
            and spec["verify_replays"] > 0,
            f"serve_slo rung 1: rung {rung}, drafted {drafted}, accepted "
            f"{accepted}, {spec['verify_replays']} verify replays")
    _unhook(torch, eng)
    del eng
    emit({"phase": "serve_slo", "model": "debug-4l", "run": "rung 1 + spec",
          "rung": rung, "drafted_by_tier": drafted,
          "spec_accepted": accepted, **spec})

    srv = LLMServer(model, watchdog_deadline=1.0, **DEBUG_KW)
    srv.engine.prepare_programs()       # capture before counting
    seen = []
    try:
        faults.ENABLED = True
        faults.get_injector().inject("engine.stall", times=1, exc=None,
                                     delay=3.0)
        PA.LAUNCHES["paged_attention"] = 0
        since = _replays(srv.engine)
        req = srv.submit(_debug_prompts()[0], 24)
        # poll through the stall: flagged once it outlives the deadline,
        # cleared once the step runs
        _bounded(lambda: seen.append(srv.health_snapshot()) or
                 seen[-1]["stalled"], "the watchdog", timeout=30)
        _bounded(lambda: seen.append(srv.health_snapshot()) or
                 not seen[-1]["stalled"], "the stall's end", timeout=30)
        stalls = max(h["watchdog_stalls"] for h in seen)
        req.result(timeout=SLO_WAIT_S)
        after = srv.health_snapshot()
    finally:
        faults.get_injector().clear()
        faults.ENABLED = False
        srv.shutdown(drain=True)
    flagged = sum(h["stalled"] for h in seen)
    require(stalls == 1 and after["watchdog_stalls"] == 1
            and not after["stalled"],
            f"serve_slo watchdog: stalls {stalls} -> "
            f"{after['watchdog_stalls']}, stalled {after['stalled']}")
    watchdog = _k4_count(torch, srv.engine, since, "serve_slo watchdog")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_slo", "model": "debug-4l", "run": "watchdog",
          "watchdog_deadline_s": 1.0, "stall_s": 3.0,
          "polls": len(seen), "polls_stalled": flagged,
          "watchdog_stalls": after["watchdog_stalls"],
          "stalled_after": after["stalled"],
          "max_step_age_s": max(h["step_age_s"] for h in seen), **watchdog})
    return {"rung 1 + spec": spec["k4_launches"],
            "watchdog": watchdog["k4_launches"]}


# --------------------------------------------------------------------------
# weight-only int8 serving: kernel Q1 (W8A16) alone, then the serve path
# with weight_dtype="int8"; static KV-cache generation
# --------------------------------------------------------------------------

# one llama3-8b layer's seven products, (role, K = in, N = out)
Q1_SHAPES = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
             ("wo", 4096, 4096), ("wg", 4096, 14336), ("wu", 4096, 14336),
             ("wd", 14336, 4096))
# rows: a decode step (8 slots), a verify of width 2 / 4 / 8, a prefill
# chunk, the whole-bucket prefill; M 1 for a lone slot
Q1_M = (1, 8, 16, 32, 64, 128, 256, 2048)
# the model's launches a layer: q / k / v together (`_mm_shared`), o,
# gate, up, down
Q1_LAUNCHES_A_LAYER = 5
Q1_TIMED_M = (8, 64, 128, 2048)
# debug-4l's shapes (hidden 256, 4 kv heads of 32, ff 512), fp32 x
Q1_F32_SHAPES = (("wq", 256, 256), ("wk", 256, 128), ("wg", 256, 512),
                 ("wd", 512, 256))
Q1_F32_M = (1, 8, 33)
# per element: |err| <= rel x |plain| + row x the row's max |plain|
Q1_TOL = {"bfloat16": (2 ** -7, 2 ** -16), "float32": (0.0, 1e-5)}
Q1_COLD_BYTES = 64 << 20      # weight copies cycled past the 50 MB L2
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW = 4, 128, 32
GEN_BEAM_NEW, GEN_BEAMS = 16, 4
GEN_SAMPLE = dict(top_k=50, top_p=0.9, seed=7)
MOE_GEN = (2, 64, 8)          # prompts, prompt length, new tokens


@contextlib.contextmanager
def _prefill_calls():
    """Counts the engine's prefill forwards (chunks, whole buckets,
    re-prefills) while the block runs: each runs every layer's seven
    products once."""
    from paddle_tpu_torch.models import llama_decode as D
    calls = [0]
    saved = D.paged_prefill_chunk, D.paged_prefill

    def counted(fn):
        def run(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return run

    D.paged_prefill_chunk, D.paged_prefill = map(counted, saved)
    try:
        yield calls
    finally:
        D.paged_prefill_chunk, D.paged_prefill = saved


def _q1_expected(eng, layers, steps, prefills, what):
    """Q1's launches since its count was zeroed, held to what the
    engine's weights make it launch: 5 x layers a device step (decode or
    verify; a replay adds what its capture recorded) and a prefill
    forward with int8 weights (q / k / v one launch, o, gate, up, down
    one each), none with float ones."""
    from paddle_tpu_torch.ops import wo_int8_matmul as Q1
    n = Q1.LAUNCHES["wo_int8_matmul"]
    per = Q1_LAUNCHES_A_LAYER * layers if eng.weight_dtype == "int8" else 0
    require(n == per * (steps + prefills),
            f"{what}: {n} Q1 launches, expected {per} x ({steps} device "
            f"steps + {prefills} prefill forwards)")
    for graphs in (eng._graphs, eng._vgraphs):
        if graphs is not None:
            rec = {r["wo_int8_matmul"] for r in graphs.recorded.values()}
            require(rec <= {per}, f"{what}: Q1 launches recorded per "
                    f"{graphs.kind} graph {rec}, expected {per}")
    return n


def _q1_check(torch, x, pairs):
    """Q1 (one launch for `pairs`, the products of one x) against its
    plain version: (bitwise over two calls, a graph replay bitwise the
    eager call, max abs err, worst err over its limit)."""
    from paddle_tpu_torch.ops import wo_int8_matmul as Q1
    ys = Q1.wo_int8_matmul_many(x, pairs)
    same = all(map(torch.equal, ys, Q1.wo_int8_matmul_many(x, pairs)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = Q1.wo_int8_matmul_many(x, pairs)
    graph.replay()
    torch.cuda.synchronize()
    replay = all(map(torch.equal, outs, ys))
    del graph, outs
    rel, row = Q1_TOL[str(x.dtype).split(".")[-1]]
    err = share = 0.0
    for y, want in zip(ys, Q1.matmul_wo_int8_many_plain(x, pairs)):
        want = want.float()
        e = (y.float() - want).abs()
        lim = rel * want.abs() + row * want.abs().amax(1, keepdim=True)
        err = max(err, e.max().item())
        share = max(share, (e / lim.clamp_min(1e-30)).max().item())
    return same, replay, err, share


def _int8pack_mm(torch):
    """torch._weight_int8pack_mm where this torch has a CUDA kernel for
    it (a yardstick: its scale is rounded to x's dtype), else None."""
    if not torch._C._dispatch_has_kernel_for_dispatch_key(
            "aten::_weight_int8pack_mm", "CUDA"):
        return None
    return torch._weight_int8pack_mm


def phase_q1_kernels(torch):
    """Kernel Q1 (weight-only int8 W8A16, csrc/wo_int8_matmul.cu) against
    its plain version at llama3-8b's seven layer shapes at every serving
    row count in bf16 (the weight packed, as the decode state holds it
    on the card), q / k / v in one launch likewise, and at debug-4l's
    shapes in fp32: per element within Q1_TOL, bitwise over two calls,
    a graph replay bitwise the eager call.  Then each distinct shape at
    Q1_TIMED_M rows, timed in turns (plain, kernel, kernel, plain) by
    CUDA-graph replay over weight copies that together pass the L2 (a
    decode step reads each layer's weights cold), beside its bound,
    torch.matmul on the bf16 weight (the product int8 is meant to
    beat), dequantise-then-matmul and torch._weight_int8pack_mm (one
    call of the same function, where the card has it): yardsticks the
    port never calls.  Last, one layer's products in one graph as the
    model launches them (q / k / v in one launch,
    `llama_decode._mm_shared`) at each timed M.  Returns the
    kernels-line entry."""
    from paddle_tpu_torch.ops import wo_int8_matmul as Q1
    from paddle_tpu_torch.quantization.int8 import weight_only_int8
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    checks, worst = [], {"bfloat16": [0.0, 0.0], "float32": [0.0, 0.0]}

    def weights(K, N, dtype):
        wq, sc = weight_only_int8(torch.randn(K, N, device=dev,
                                              generator=gen) * 0.02)
        return (Q1.pack_weight(wq) if dtype == "bfloat16" else wq), sc

    # each product alone, then q / k / v in one launch as the model runs
    # them (`llama_decode._mm_shared`)
    cases = [("bfloat16", Q1_SHAPES, Q1_M), ("float32", Q1_F32_SHAPES,
                                             Q1_F32_M),
             ("bfloat16", [("qkv", 4096, (4096, 1024, 1024))], Q1_M)]
    for dtype, shapes, ms in cases:
        dt = getattr(torch, dtype)
        for role, K, N in shapes:
            pairs = [weights(K, n, dtype)
                     for n in (N if isinstance(N, tuple) else (N,))]
            for M in ms:
                x = torch.randn(M, K, device=dev, generator=gen).to(dt)
                same, replay, err, share = _q1_check(torch, x, pairs)
                checks.append({"dtype": dtype, "role": role, "K": K,
                               "N": N, "M": M, "bitwise_twice": same,
                               "replay_bitwise_eager": replay,
                               "max_abs_err": err, "err_over_limit": share,
                               "split": Q1.split_k(M, K, N, dt)})
                w = worst[dtype]
                w[0], w[1] = max(w[0], err), max(w[1], share)
                require(same, f"q1 ({dtype} {role} M {M}): two calls "
                        f"differ")
                require(replay, f"q1 ({dtype} {role} M {M}): a graph "
                        f"replay differs from the eager call")
                require(share <= 1.0, f"q1 ({dtype} {role} M {M}): err "
                        f"{err} is {share} x its limit")
            del pairs
    emit({"phase": "q1_kernels", "checks": len(checks),
          "tolerance": Q1.TOL_TEXT, "worst_max_abs_err":
          {k: v[0] for k, v in worst.items()},
          "worst_err_over_limit": {k: v[1] for k, v in worst.items()},
          "all_bitwise_twice": all(c["bitwise_twice"] for c in checks),
          "all_replays_bitwise_eager": all(c["replay_bitwise_eager"]
                                           for c in checks),
          "cases": checks})
    torch.cuda.empty_cache()

    timed = {}
    bf = torch.bfloat16
    lib_fn, lib_errors = _int8pack_mm(torch), []
    for K, N in sorted({(K, N) for _, K, N in Q1_SHAPES}):
        n_q = 1 + -(-Q1_COLD_BYTES // (K * N))
        n_b = 1 + -(-Q1_COLD_BYTES // (2 * K * N))
        ws = [torch.randn(K, N, device=dev, generator=gen) * 0.02
              for _ in range(max(n_q, n_b))]
        wqs = [weight_only_int8(w) for w in ws[:n_q]]
        wps = [(Q1.pack_weight(q), s) for q, s in wqs]
        wbs = [w.to(bf) for w in ws[:n_b]]
        # the library call's operands: int8 (N, K), the scale in x's dtype
        wls = ([(q.t().contiguous(), s.to(bf)) for q, s in wqs]
               if lib_fn is not None else None)
        del ws
        for M in Q1_TIMED_M:
            xs = [torch.randn(M, K, device=dev, generator=gen).to(bf)
                  for _ in range(n_q)]
            calls, reps = (20, 20) if M <= 128 else (4, 4)

            def t(fn, n):
                return _graph_ms(torch, fn, n, calls, reps)

            def kern(i):
                return Q1.wo_int8_matmul(xs[i], *wps[i])

            def plain(i):
                return Q1.matmul_wo_int8_plain(xs[i], *wqs[i])

            turns = [t(plain, n_q), t(kern, n_q), t(kern, n_q),
                     t(plain, n_q)]
            lib = t(lambda i: torch.matmul(xs[i], wbs[i]), n_b)
            deq = t(lambda i: torch.matmul(
                xs[i], (wqs[i][0].float() * wqs[i][1]).to(bf)), n_q)
            pack_mm = None
            if lib_fn is not None:
                try:        # a yardstick that refuses a shape is noted
                    # 30-900x Q1's time: two calls a graph, two replays
                    pack_mm = _graph_ms(torch, lambda i: lib_fn(xs[i],
                                                                *wls[i]),
                                        n_q, 2, 2)
                except RuntimeError as e:
                    lib_errors.append(f"K {K} N {N} M {M}: {e}"[:300])
            nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
            bound, by = _bound_ms(kind, 2.0 * M * K * N, nbytes)
            timed[K, N, M] = {
                "K": K, "N": N, "M": M, "split": Q1.split_k(M, K, N, bf),
                "ms": (turns[1] + turns[2]) / 2,
                "plain_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns,
                "bound_ms": bound, "bound_by": by,
                "library_ms": pack_mm,
                "bf16_matmul_ms": lib, "dequantize_matmul_ms": deq,
                "bf16_matmul_bound_ms": _bound_ms(
                    kind, 2.0 * M * K * N,
                    2 * K * N + 2 * M * K + 2 * M * N)[0],
                "weight_copies": n_q}
            emit({"phase": "q1_kernels", "timing": "CUDA-graph replay, "
                  "per call", **timed[K, N, M]})
            del xs
        del wqs, wps, wbs, wls
        torch.cuda.empty_cache()

    # one layer's products back to back in one graph as the model runs
    # them: q / k / v in one launch, then o, gate, up, down (weights read
    # once a replay: 218 M of them, past the L2); q / k / v's launch also
    # timed alone
    def packed(K, N):
        q, sc = weight_only_int8(torch.randn(K, N, device=dev,
                                             generator=gen) * 0.02)
        return Q1.pack_weight(q), sc

    layer_w = [packed(K, N) for _, K, N in Q1_SHAPES]
    # q / k / v alone: 25 MB a set, three sets past the L2
    qkv_w = [layer_w[:3]] + [[packed(K, N) for _, K, N in Q1_SHAPES[:3]]
                             for _ in range(2)]
    layer_graph, qkv_ms = {}, {}
    for M in Q1_TIMED_M:
        xs = [torch.randn(M, K, device=dev, generator=gen).to(bf)
              for _, K, _ in Q1_SHAPES[2:]]
        calls, reps = (20, 20) if M <= 128 else (4, 4)

        def model_layer(i):
            return Q1.wo_int8_matmul_many(xs[0], layer_w[:3]) + [
                Q1.wo_int8_matmul(x, *w) for x, w in zip(xs[1:], layer_w[3:])]

        layer_graph[str(M)] = _graph_ms(torch, model_layer, 1, 4,
                                        10 if M <= 128 else 4)
        qkv_ms[str(M)] = _graph_ms(
            torch, lambda i: Q1.wo_int8_matmul_many(xs[0], qkv_w[i]),
            len(qkv_w), calls, reps)
        del xs
    del layer_w, qkv_w
    torch.cuda.empty_cache()

    def layer(M, key):
        vals = [timed[K, N, M][key] for _, K, N in Q1_SHAPES]
        return None if None in vals else sum(vals)

    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bf16_matmul_ms",
            "dequantize_matmul_ms", "bf16_matmul_bound_ms")
    head = {key: layer(8, key) for key in keys}
    per_m = {str(M): {**{key: layer(M, key) for key in keys},
                      "layer_graph_ms": layer_graph[str(M)],
                      "qkv_one_launch_ms": qkv_ms[str(M)],
                      "qkv_three_launches_ms": sum(
                          timed[K, N, M]["ms"] for _, K, N in Q1_SHAPES[:3])}
             for M in Q1_TIMED_M}
    library = ("torch._weight_int8pack_mm (its scale rounded to bf16)"
               if lib_fn is not None else
               "none: this torch has no CUDA kernel for "
               "aten::_weight_int8pack_mm")
    emit({"phase": "q1_kernels", "layer_at_m8": head,
          "layer_by_m": per_m, "library": library,
          "library_errors": lib_errors})
    return {"max_abs_err": worst["bfloat16"][0],
            "max_abs_err_float32": worst["float32"][0],
            "tolerance": Q1.TOL_TEXT, **head,
            "bound_by": timed[4096, 14336, 8]["bound_by"],
            "library": library,
            "timing": "CUDA-graph replay; ms, plain_ms, bound_ms, "
                      "library_ms, bf16_matmul_ms: one llama3-8b layer's "
                      "seven products at M 8 (a decode step), each timed "
                      "alone and summed; layer_graph_ms: the layer's "
                      "five launches (q / k / v in one) in one graph",
            "layer_graph_ms": layer_graph["8"],
            "by_m": per_m,
            "shapes": [timed[k] for k in sorted(timed)]}


def _int8w_parity_run(torch, model, kv_dtype, limit):
    """The serve mix with weight_dtype="int8" (graphs + overlap) for one
    pool.  Before each replay of the decode graph, on the same pool,
    inputs and tables: the step through the gather path with Q1's plain
    version (the reference), and the eager kernel step (K4 and Q1).  The
    replay's logits must be within `limit` of the reference's (the
    serve_parity rule) and bitwise the eager kernel step's.  K4 and Q1
    launches counted through the replays (the extra steps' launches
    taken back).  Returns (report, streams)."""
    import numpy as np
    from paddle_tpu_torch.models import llama_decode as D
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops import wo_int8_matmul as Q1
    from paddle_tpu_torch.quantization import int8 as TQ
    cfg = model.config
    layers = cfg.num_hidden_layers
    eng = _serve_engine(model, kv_dtype=kv_dtype, weight_dtype="int8")
    require(eng.weight_dtype == "int8" and isinstance(
        eng.state["layers"][0]["wq"], tuple), "int8 weights not in use")
    g = eng._graphs
    replay = g.replay
    B = eng.max_slots
    worst = {"replay_vs_gather_plain": 0.0, "replay_vs_eager": 0.0}
    counts = {"steps": 0, "bitwise": 0, "argmax_same": 0, "rows": 0}

    def hooked(w):
        live = torch.tensor([eng._slots[s] is not None for s in range(w)]
                            if w == B else [True] * w, device="cuda")
        token, pos, table = (v.clone() for v in g.views(g.inputs(w), w))
        saved = PA.LAUNCHES["paged_attention"], Q1.LAUNCHES["wo_int8_matmul"]
        args = (eng.state, cfg, token, pos, eng._kvpool, table)
        TQ.wo_int8_matmul = Q1.matmul_wo_int8_plain
        TQ.wo_int8_matmul_many = Q1.matmul_wo_int8_many_plain
        try:
            ref, _ = D.paged_decode_step_batch(*args, kernel="gather")
        finally:
            TQ.wo_int8_matmul = Q1.wo_int8_matmul
            TQ.wo_int8_matmul_many = Q1.wo_int8_matmul_many
        eager, _ = D.paged_decode_step_batch(*args, kernel="cuda",
                                             **eng._decode_kw)
        PA.LAUNCHES["paged_attention"], Q1.LAUNCHES["wo_int8_matmul"] = saved
        logits, argmax = replay(w)
        d = (logits.float() - ref.float()).abs().amax(1)[live].max().item()
        worst["replay_vs_gather_plain"] = max(
            worst["replay_vs_gather_plain"], d)
        worst["replay_vs_eager"] = max(
            worst["replay_vs_eager"], (logits.float() - eager.float()).abs()
            .amax(1)[live].max().item())
        counts["steps"] += 1
        counts["bitwise"] += int(torch.equal(logits[live], eager[live]))
        counts["argmax_same"] += int((logits[live].argmax(1)
                                      == ref[live].argmax(1)).sum())
        counts["rows"] += int(live.sum())
        return logits, argmax

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, L) for L in SERVE_LENGTHS]
    PA.LAUNCHES["paged_attention"] = 0
    Q1.LAUNCHES["wo_int8_matmul"] = 0
    g.replay = hooked
    try:
        with _prefill_calls() as prefills:
            reqs = [eng.submit(p, SERVE_NEW) for p in prompts]
            eng.run()
        torch.cuda.synchronize()
    finally:
        del g.replay
    steps = int(_metric(eng, "decode_steps_total"))
    k4 = PA.LAUNCHES["paged_attention"]
    q1 = _q1_expected(eng, layers, steps, prefills[0], "serve_int8w")
    pool = kv_dtype or "bfloat16"
    for r in reqs:
        require(r.done and r.error is None and len(r.tokens) == SERVE_NEW,
                f"serve_int8w ({pool}): request {r.rid}: "
                f"{len(r.tokens)} tokens, {r.error!r}")
    require(eng.num_graph_replays == steps == counts["steps"],
            f"serve_int8w ({pool}): {eng.num_graph_replays} replays, "
            f"{steps} decode steps, {counts['steps']} compared")
    require(k4 == layers * steps,
            f"serve_int8w ({pool}): {k4} K4 launches for {steps} replays")
    require(worst["replay_vs_gather_plain"] <= limit,
            f"serve_int8w ({pool}): replay vs gather + plain Q1 logits "
            f"err {worst['replay_vs_gather_plain']} > {limit}")
    require(counts["bitwise"] == counts["steps"],
            f"serve_int8w ({pool}): {counts['steps'] - counts['bitwise']} "
            f"replays not bitwise the eager kernel step "
            f"(max err {worst['replay_vs_eager']})")
    report = {"phase": "serve_int8w", "model": "llama3-8b",
              "weight_dtype": "int8", "kv_dtype": pool,
              "overlap": eng.overlap_mode, "decode_steps": steps,
              "graph_replays": eng.num_graph_replays,
              "prefill_forwards": prefills[0], "k4_launches": k4,
              "q1_launches": q1,
              "q1_launches_rule": "5 x 32 x (decode replays + prefill "
                                  "forwards)",
              "steps_compared": counts["steps"],
              "replay_vs_gather_plain_q1_max_abs_err":
                  worst["replay_vs_gather_plain"],
              "logits_limit": limit,
              "replay_bitwise_eager_steps": counts["bitwise"],
              "argmax_agreement_vs_reference":
                  counts["argmax_same"] / counts["rows"],
              "int8_weight_bytes_gib": sum(
                  t.numel() * t.element_size() for st in eng.state["layers"]
                  for k in D._WEIGHT_KEYS for t in st[k]) / 2**30}
    streams = [list(r.tokens) for r in reqs]
    del eng, hooked
    gc.collect()
    torch.cuda.empty_cache()
    return report, streams


def phase_serve_int8w(torch, model, shallow, limits, bf16_streams,
                      bf16_row):
    """llama3-8b served with weight_dtype="int8" (every layer product
    through Q1), graphs + overlap, the serve mix: once with the bf16
    pool and once with the int8 pool, each decode step held to the
    gather path with Q1's plain version (`_int8w_parity_run`); the
    profile row (graphs + overlap, bf16 pool) beside the bf16-weight
    row `bf16_row` of this run; one serve_pressure run at
    `pressure_blocks()` under "swap" against full provisioning, on
    `shallow` (its own reference); one serve_spec run (k 7: verify width 8) against speculation off, both
    through per-step logits.  Returns the K4 and Q1 launches by run, and
    the bf16 pool's serve-mix streams ("streams")."""
    import numpy as np
    from paddle_tpu_torch.inference import SpecConfig
    launches = {}
    for kv in (None, "int8"):
        pool = kv or "bfloat16"
        report, streams = _int8w_parity_run(torch, model, kv, limits[pool])
        if kv is None:
            report["token_agreement_vs_bf16_weights"] = sum(
                a == b for x, y in zip(streams, bf16_streams)
                for a, b in zip(x, y)) / (len(SERVE_LENGTHS) * SERVE_NEW)
            launches["streams"] = streams
        emit(report)
        launches[pool] = {"k4": report["k4_launches"],
                          "q1": report["q1_launches"]}
    row, _ = phase_profile(torch, model, "graphs_overlap",
                           weight_dtype="int8")
    keys = ("decode_step_ms", "device_busy_ms_per_step", "q1_ms_per_step",
            "gemm_ms_per_step", "k4_ms_per_step", "other_ms_per_step",
            "device_idle_share")
    emit({"phase": "serve_int8w", "profile": "graphs_overlap, bf16 pool",
          "int8_weights": {**{k: row.get(k) for k in keys},
                           **row["serve"]},
          "bf16_weights": {**{k: bf16_row.get(k) for k in keys},
                           **bf16_row["serve"]}})
    launches["profile"] = row["serve"]["q1_launches"]

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.config.vocab_size, L)
               for L in PRESSURE_LENGTHS]
    full, ref, _ = _pressure_run(torch, shallow, None, None, prompts,
                                 weight_dtype="int8")
    roundtrip = {}
    swap, got, _ = _pressure_run(torch, shallow, None, "swap", prompts,
                                 roundtrip, weight_dtype="int8")
    require(got == ref, "serve_int8w pressure (swap): streams differ from "
            "full provisioning")
    require(roundtrip.get("equal") is True,
            f"serve_int8w pressure (swap): parked blocks after resume: "
            f"{roundtrip}")
    emit({"phase": "serve_int8w", "run": "serve_pressure",
          "layers": shallow.config.num_hidden_layers, **swap,
          "streams_equal_full": True,
          "park_roundtrip_bitwise_blocks": roundtrip["n"],
          "full_provisioning": {k: full[k] for k in (
              "tokens_per_s", "itl_p50_ms", "decode_steps", "k4_launches",
              "peak_mem_gib")}})
    launches["pressure"] = {"full": full["k4_launches"],
                            "swap": swap["k4_launches"]}

    sp_prompts = _spec_prompts(torch, model)[0]
    every = {i: SPEC_NEW - 1 for i in range(SPEC_N)}
    _, off, want = _spec_run(torch, model, None, sp_prompts, rows_of=every,
                             warm=False, weight_dtype="int8")
    on, got, have = _spec_run(torch, model, SpecConfig(k=SPEC_K),
                              sp_prompts, rows_of=every, warm=False,
                              weight_dtype="int8")
    require(on["spec_verify_steps"] > 0 and SPEC_W in on["verify_widths"],
            "serve_int8w spec: no verify step of width 8 ran")
    check = _spec_flips(torch, model, sp_prompts, off, got,
                        limits["bfloat16"], rows=(want, have))
    emit({"phase": "serve_int8w", "run": "serve_spec", **on, **check,
          "note": "one pass with logits recorded (no warm-up): times "
                  "include the recording"})
    launches["spec"] = {"k4": on["k4_launches"], "q1": on["q1_launches"]}
    return launches


def _gen_logits(torch, model, ids, n, max_new):
    """The logits before each of the first `n` greedy tokens of
    `generate(ids, max_new)`, along its own stream, recomputed with its
    programs and its (B, S + max_new) cache: [(B, V) fp32] * n."""
    from paddle_tpu_torch.models import llama_decode as D
    st = D.collect_decode_state(model)
    B, S = ids.shape
    cache = D.init_cache(model.config, B, S + max_new, st["embed"].dtype,
                         device=ids.device)
    with torch.no_grad():
        lg, cache = D.prefill(st, model.config, ids, cache)
        rows = [lg.float()]
        for i in range(n - 1):
            lg, cache = D.decode_step(st, model.config,
                                      torch.argmax(lg, -1), S + i, cache)
            rows.append(lg.float())
    return rows


def phase_generate(torch, model, limit):
    """Static KV-cache generation on the serve phase's llama3-8b (bf16,
    32 layers): `LlamaForCausalLM.generate`, GEN_PROMPTS prompts of
    GEN_PROMPT_LEN tokens x GEN_NEW new tokens, greedy (tokens/s,
    per-token ms, peak memory); prompt 0's stream against the bf16
    engine's greedy stream (graphs + overlap, K4) for that prompt:
    equal, or the first difference a near tie within `limit` in
    generate's logits.  `generation.generate`: beam search (GEN_BEAMS
    beams x GEN_BEAM_NEW tokens) bitwise over two runs; sampling
    (top_k 50, top_p 0.9, seed 7) equal over two runs, every id in the
    vocabulary.  Returns the K4 / Q1 launches (none expected: the
    contiguous path attends in plain torch)."""
    import numpy as np
    from paddle_tpu_torch import generation as TG
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops import wo_int8_matmul as Q1
    V = model.config.vocab_size
    rng = np.random.default_rng(5)
    prompts = torch.as_tensor(rng.integers(0, V, (GEN_PROMPTS,
                                                  GEN_PROMPT_LEN)),
                              device="cuda")
    model.generate(prompts[:, :16], max_new_tokens=2)      # warm-up
    PA.LAUNCHES["paged_attention"] = 0
    Q1.LAUNCHES["wo_int8_matmul"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(out.dtype == torch.int64 and tuple(out.shape)
            == (GEN_PROMPTS, GEN_PROMPT_LEN + GEN_NEW)
            and torch.equal(out[:, :GEN_PROMPT_LEN], prompts)
            and bool(((out >= 0) & (out < V)).all()),
            f"generate: output {tuple(out.shape)} {out.dtype}")
    require(torch.equal(model.generate(prompts, max_new_tokens=GEN_NEW),
                        out), "generate: a second run differs")
    b1 = TG.generate(model, prompts, max_new_tokens=GEN_BEAM_NEW,
                     decode_strategy="beam_search", num_beams=GEN_BEAMS)
    b2 = TG.generate(model, prompts, max_new_tokens=GEN_BEAM_NEW,
                     decode_strategy="beam_search", num_beams=GEN_BEAMS)
    require(torch.equal(b1, b2) and tuple(b1.shape)
            == (GEN_PROMPTS, GEN_PROMPT_LEN + GEN_BEAM_NEW),
            "generate: beam search differs between two runs")
    s1 = TG.generate(model, prompts, max_new_tokens=GEN_NEW,
                     decode_strategy="sampling", **GEN_SAMPLE)
    s2 = TG.generate(model, prompts, max_new_tokens=GEN_NEW,
                     decode_strategy="sampling", **GEN_SAMPLE)
    require(torch.equal(s1, s2) and bool(((s1 >= 0) & (s1 < V)).all()),
            "generate: sampling differs between two runs of one seed")
    launches = {"k4": PA.LAUNCHES["paged_attention"],
                "q1": Q1.LAUNCHES["wo_int8_matmul"]}
    eng = _serve_engine(model)
    req = eng.submit(prompts[0].cpu().numpy(), GEN_NEW)
    eng.run()
    ref = [int(t) for t in req.tokens]
    del eng, req
    torch.cuda.empty_cache()
    got = out[0, GEN_PROMPT_LEN:].tolist()
    flip = None
    if got != ref:
        t = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        rows = _gen_logits(torch, model, prompts, t + 1, GEN_NEW)
        require([int(r[0].argmax()) for r in rows] == got[:t + 1],
                "generate: its logits recomputed give another stream")
        row = rows[t][0]
        flip = {"token": t, "generate_minus_engine_choice":
                (row[got[t]] - row[ref[t]]).item(), "limit": limit}
        require(flip["generate_minus_engine_choice"] <= limit,
                f"generate vs engine: first difference at token {t} is no "
                f"near tie: {flip}")
    emit({"phase": "generate", "model": "llama3-8b", "dtype": "bfloat16",
          "prompts": GEN_PROMPTS, "prompt_len": GEN_PROMPT_LEN,
          "new_tokens": GEN_NEW, "wall_s": wall,
          "tokens_per_s": GEN_PROMPTS * GEN_NEW / wall,
          "ms_per_token_step": 1e3 * wall / GEN_NEW, "peak_mem_gib": peak,
          "repeat_bitwise": True,
          "prompt0_equals_engine": got == ref, "first_difference": flip,
          "beam_search": {"beams": GEN_BEAMS, "new_tokens": GEN_BEAM_NEW,
                          "bitwise_twice": True},
          "sampling": {**GEN_SAMPLE, "equal_twice": True,
                       "ids_in_vocab": True},
          "launches": launches})
    return launches


def phase_generate_debug(torch, model, engine_tokens):
    """debug-4l in fp32: `LlamaForCausalLM.generate` on each parity
    prompt (24 new tokens) token-exact with the engine's streams
    (gather path and kernel path, equal in phase_parity)."""
    got = []
    for p in _debug_prompts():
        out = model.generate(p[None], max_new_tokens=24)
        got.append(out[0, len(p):].tolist())
    require(got == engine_tokens, f"generate (debug-4l): streams differ "
            f"from the engine's: {got} vs {engine_tokens}")
    emit({"phase": "generate", "model": "debug-4l", "dtype": "float32",
          "requests": len(got), "tokens_each": 24,
          "token_exact_vs_engine": True})


def phase_generate_moe(torch):
    """The MoE Llama (moe_train's Qwen1.5-MoE-A2.7B widths, MOE_LAYERS
    layers, bf16, random weights) generating through the naive
    full-forward loop: MOE_GEN prompts x new tokens, greedy.  K1 and
    K5f launches of the loop = new tokens x the launches one forward
    makes (K1 one a layer); the stream the same on a second run.
    Returns the launches."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import gmm as G
    cfg = _moe_cfg()
    model = LlamaForCausalLM(cfg, device="cuda", seed=4)
    model.eval()
    n, S, new = MOE_GEN
    gen = torch.Generator(device="cuda").manual_seed(6)
    ids = torch.randint(0, cfg.vocab_size, (n, S), device="cuda",
                        generator=gen)

    def counts():
        return (FA.LAUNCHES["flash_attention_fwd"], G.LAUNCHES["gmm_fwd"])

    _zero_all_counts()
    with torch.no_grad():
        model(ids)
    per_fwd = counts()
    require(per_fwd[0] == cfg.num_hidden_layers and per_fwd[1] > 0
            and per_fwd[1] % cfg.num_hidden_layers == 0,
            f"generate (moe): one forward launched K1 / K5f {per_fwd}")
    _zero_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    require(got == (new * per_fwd[0], new * per_fwd[1]),
            f"generate (moe): K1 / K5f launches {got}, expected {new} "
            f"forwards x {per_fwd}")
    require(torch.equal(model.generate(ids, max_new_tokens=new), out),
            "generate (moe): a second run differs")
    require(tuple(out.shape) == (n, S + new)
            and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            f"generate (moe): output {tuple(out.shape)}")
    emit({"phase": "generate", "model": "moe (Qwen1.5-MoE-A2.7B widths)",
          "layers": cfg.num_hidden_layers, "prompts": n, "prompt_len": S,
          "new_tokens": new, "forwards": new, "wall_s": wall,
          "launches_per_forward": {"flash_attention_fwd": per_fwd[0],
                                   "gmm_fwd": per_fwd[1]},
          "launches": {"flash_attention_fwd": got[0], "gmm_fwd": got[1]},
          "repeat_equal": True})
    del model
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": got[0], "gmm_fwd": got[1]}


# the tiered-KV phase (engine sub-slice (g)): `paddle_tpu/testing/
# traces.py:218 longctx_config`'s prompt clip at scale 1
TIERED_LENGTHS = [3000, 2400, 1800, 1200]
TIERED_NEW = [256, 64, 64, 64]      # the long one outlives its partners
TIERED_KW = dict(max_slots=4, max_len=4096, max_prompt_len=3072,
                 prefill_chunk=128, kv_block_tokens=16,
                 prefix_cache_blocks=0)
TIERED_KNOBS = dict(hot_window=8, prefetch_depth=2, host_pool_blocks=1024)
TIERED_SOLO_BLOCKS = 96             # below the long sequence's own KV
TIERED_LOGIT_STEPS = 8              # decode steps after the first spill
TIERED_SPEC_K, TIERED_SPEC_NEW = 7, 32  # the speculative run (verify W 8)


def tiered_blocks():
    """`bench.py:1224-1233`'s tiered pool: half the peak demand of the
    `max_slots` largest sequences (+ trash), plus max_slots + 1 blocks
    of slack above the prefetcher's headroom guard."""
    bt, slots = TIERED_KW["kv_block_tokens"], TIERED_KW["max_slots"]
    demand = sorted((-(-(L + n) // bt)
                     for L, n in zip(TIERED_LENGTHS, TIERED_NEW)),
                    reverse=True)
    peak = 1 + sum(demand[:slots])
    return peak, max(8, peak // 2 + slots + 1)


def _hook_tiered(torch, eng, times, logits, want):
    """Host-clock wrappers on the tiered engine's spill, promote and
    CRC; CUDA events around every decode replay, each tagged with the
    extension blocks its table reads (positions up to each live slot's
    depth) and the slots decoding; and the logits rows of decode
    replays: with `want` None, every live slot's row of the first
    TIERED_LOGIT_STEPS replays after the first spill, keyed (request
    index, token index); else the rows of the keys in `want`.  Verify
    replays are timed the same way, with the extension blocks they read
    (`times["verify"]`).  Without tiering only the replays and logits
    are hooked."""
    g = eng._graphs
    replay = g.replay
    index = times["index"]
    state = {"after_spill": 0}

    def ext_live(w):
        ext, live = 0, 0
        for s, req in enumerate(eng._slots[:w]):
            if req is None:
                continue
            live += 1
            n = eng._pager.blocks_for(int(eng._pos[s]) + 1)
            ext += sum(eng._pager.is_ext(b)
                       for b in eng._pager.slot_blocks[s][:n])
        return ext, live

    def timed(fn, w, key):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ext, live = ext_live(eng.max_slots if key == "verify" else w)
        start.record()
        out = fn(w)
        end.record()
        times[key].append((start, end, live, ext))
        return out

    def timed_replay(w):
        logits_w, argmax = timed(replay, w, "replays")
        spilled = eng._tiered and eng._m_kv_spilled.value >= 1
        record = (want is None and spilled
                  and state["after_spill"] < TIERED_LOGIT_STEPS)
        if record:
            state["after_spill"] += 1
        for s, req in enumerate(eng._slots[:w]):
            if req is None or req.rid not in index:
                continue
            key = (index[req.rid], len(req.tokens))
            if record or (want is not None and key in want):
                logits[key] = logits_w[s].clone()
        return logits_w, argmax

    g.replay = timed_replay
    if eng._vgraphs is not None:
        v_replay = eng._vgraphs.replay
        eng._vgraphs.replay = lambda W: timed(v_replay, W, "verify")
    if not eng._tiered:
        return
    spill, promote, crc = eng._spill_blocks, eng._promote_ext, eng._ext_crc

    def host_timed(fn, key):
        def call(*a):
            t0 = time.perf_counter()
            n = fn(*a)
            times[key].append((time.perf_counter() - t0, n))
            return n
        return call

    def timed_crc(e):
        t0 = time.perf_counter()
        c = crc(e)
        times["crc"].append(time.perf_counter() - t0)
        return c

    eng._spill_blocks = host_timed(spill, "spill")
    eng._promote_ext = host_timed(promote, "promote")
    eng._ext_crc = timed_crc


def _tiered_run(torch, model, kv_dtype, prompts, news, kv_blocks=None,
                want=None, spec=None):
    """One run of the long-context traffic through LLMEngine (graphs +
    overlap): the full pool when `kv_blocks` is None, else a tiered pool
    of `kv_blocks` blocks (TIERED_KNOBS); `spec`: speculation's k, with
    every live slot drafting k copies of its token each step (random
    weights repeat no n-gram, so the drafter alone proposes almost
    nothing): every step is a verify replay.  Every request done, K4
    counted exactly through the replays, the pager consistent and empty
    after it (no device block, no extension block, no host block held)
    and no extension row failing its CRC.  Returns (report, streams,
    logits rows: see `_hook_tiered`)."""
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.ops import paged_attention as PA
    tiered = kv_blocks is not None
    kw = dict(kv_blocks=kv_blocks, **TIERED_KNOBS) if tiered else {}
    eng = LLMEngine(model, **TIERED_KW, kv_dtype=kv_dtype, speculation=spec,
                    **kw)
    require(eng.decode_kernel == "cuda" and eng._graphs is not None
            and eng.overlap, "the tiered engine is not on K4 in graphs")
    eng.prepare_programs()
    times = {"spill": [], "promote": [], "crc": [], "replays": [],
             "verify": [], "index": {}}
    logits = {}
    _hook_tiered(torch, eng, times, logits, want)
    if spec is not None:
        def forced_drafts():
            drafts, cost = [None] * eng.max_slots, 0
            for s, req in enumerate(eng._slots):
                kb = 0 if req is None else min(
                    spec, req.max_new_tokens - len(req.tokens) - 1)
                if kb > 0:
                    drafts[s] = [int(eng._token[s])] * kb
                    cost += kb
            return (drafts, cost) if cost else (None, 0)
        eng._propose_drafts = forced_drafts
    stamps = {}

    def on_token(req, tok):
        stamps.setdefault(req.rid, []).append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.LAUNCHES["paged_attention"] = 0
    t0 = time.perf_counter()
    reqs = []
    for i, (p, n) in enumerate(zip(prompts, news)):
        reqs.append(eng.submit(p, n, on_token=on_token))
        times["index"][reqs[-1].rid] = i
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.LAUNCHES["paged_attention"]
    layers = model.config.num_hidden_layers
    name = (f"serve_tiered ({kv_dtype or 'bfloat16'}, "
            f"{kv_blocks or eng.kv_blocks} blocks)")
    for r, n in zip(reqs, news):
        require(r.done and r.error is None and len(r.tokens) == n,
                f"{name}: request {r.rid}: {len(r.tokens)} tokens, "
                f"{r.error!r}")
    steps = int(_metric(eng, "decode_steps_total"))
    require(launches == layers * steps == layers * eng.num_graph_replays,
            f"{name}: {launches} K4 launches, {steps} steps, "
            f"{eng.num_graph_replays} replays")
    eng._pager.check()
    require(eng._pager.used_blocks == 0 and eng._pager.ext_used == 0
            and eng._pager.host_blocks_used == 0,
            f"{name}: {eng._pager.used_blocks} device, "
            f"{eng._pager.ext_used} ext, {eng._pager.host_blocks_used} "
            f"host blocks still held")
    integ = int(eng._m_integrity["ext"].value)
    require(integ == 0, f"{name}: {integ} extension rows failed their CRC")
    itl = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
    gen = sum(len(r.tokens) for r in reqs)
    replays = [(s.elapsed_time(e), live, ext)
               for s, e, live, ext in times["replays"]]
    verify = [(s.elapsed_time(e), ext) for s, e, _, ext in times["verify"]]

    def med(xs):
        return _percentile(xs, 50) if xs else None

    def per_block(key):
        n = sum(k for _, k in times[key])
        return 1e3 * sum(t for t, _ in times[key]) / n if n else None

    ext_steps = [(ms, x) for ms, live, x in replays if x]
    report = {
        "kv_dtype": kv_dtype or "bfloat16",
        "pool": ("tiered" if tiered else "full provisioning"),
        "kv_blocks": eng.kv_blocks, "kv_pool_gib": eng.kv_pool_bytes() / 2**30,
        **({"hot_window": eng.hot_window,
            "prefetch_depth": eng.prefetch_depth,
            "host_pool_blocks": eng.host_pool_blocks,
            "pinned_tier_gib": eng._hext.flat.numel() / 2**30}
           if tiered else {}),
        "requests": len(reqs), "prompt_tokens": [len(p) for p in prompts],
        "generated_tokens": gen, "wall_s": wall, "tokens_per_s": gen / wall,
        "itl_p50_ms": 1e3 * _percentile(itl, 50),
        "itl_p99_ms": 1e3 * _percentile(itl, 99),
        "decode_steps": steps, "k4_launches": launches,
        "verify_replays": eng.num_verify_replays,
        "verify_replays_with_ext_blocks": sum(x > 0 for _, x in verify),
        "verify_replay_device_ms_p50": {
            "ext" if ext else "device": med([ms for ms, x in verify
                                             if bool(x) == ext])
            for ext in (False, True)
            if any(bool(x) == ext for _, x in verify)},
        "spec_tokens_accepted": int(_metric(eng,
                                            "spec_tokens_accepted_total")),
        "kv_blocks_spilled": int(_metric(eng, "kv_blocks_spilled_total")),
        "kv_blocks_prefetched": int(_metric(eng,
                                            "kv_blocks_prefetched_total")),
        "preemptions": int(_metric(eng, "preemptions_total")),
        "ext_integrity_failures": integ,
        "spill_host_ms_per_block": per_block("spill"),
        "promote_host_ms_per_block": per_block("promote"),
        "crc_host_ms_per_block": (1e3 * sum(times["crc"]) / len(times["crc"])
                                  if times["crc"] else None),
        "kv_block_bytes": eng._kv_block_bytes,
        "replay_device_ms_p50": {
            f"{live} slots, {'ext' if ext else 'device'}": med(
                [ms for ms, lv, x in replays if lv == live and bool(x) == ext])
            for live in sorted({lv for _, lv, _ in replays})
            for ext in (False, True)
            if any(lv == live and bool(x) == ext for _, lv, x in replays)},
        "replays_with_ext_blocks": len(ext_steps),
        "ext_bytes_per_ext_step_mean": (
            sum(x for _, x in ext_steps) * eng._kv_block_bytes
            / len(ext_steps) if ext_steps else 0),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    streams = [list(r.tokens) for r in reqs]
    for name_ in ("_spill_blocks", "_promote_ext", "_ext_crc"):
        vars(eng).pop(name_, None)
    _unhook(torch, eng)
    return report, streams, logits


def phase_serve_tiered(torch, model):
    """Tiered KV for long context on llama3-8b (engine sub-slice (g)):
    four prompts of TIERED_LENGTHS (256 / 64 / 64 / 64 new tokens),
    max_len 4096, 4 slots, fully provisioned (1 + 4 x 256 blocks) and
    through `tiered_blocks()` device blocks with hot_window 8,
    prefetch_depth 2 and a 1024-row pinned host tier, for the bf16 and
    the int8 pool; then the 3000-token prompt alone in 96 blocks (its
    KV takes ~204) with speculation (TIERED_SPEC_NEW tokens, a verify
    of width 8 every step reading the tier), against the full pool with
    speculation.  Streams
    token-exact to the full pool's, the decode logits of the first
    TIERED_LOGIT_STEPS replays after the first spill bitwise the full
    pool's for the same request and token, at least one block spilled,
    one promoted in the bf16 mixed run, no extension row failing its
    CRC.  Returns the K4 launches of each run."""
    import numpy as np
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, model.config.vocab_size, L)
               for L in TIERED_LENGTHS]
    peak, blocks = tiered_blocks()
    launches, refs = {}, {}
    for kv in (None, "int8"):
        pool = kv or "bfloat16"
        tiered, got, rows = _tiered_run(torch, model, kv, prompts,
                                        TIERED_NEW, kv_blocks=blocks)
        full, ref, ref_rows = _tiered_run(torch, model, kv, prompts,
                                          TIERED_NEW, want=set(rows))
        launches[pool, "full"] = full["k4_launches"]
        launches[pool, "tiered"] = tiered["k4_launches"]
        refs[pool] = ref
        require(got == ref, f"serve_tiered ({pool}): tiered streams differ "
                f"from full provisioning")
        require(rows and set(rows) == set(ref_rows),
                f"serve_tiered ({pool}): logits rows {sorted(rows)} vs "
                f"{sorted(ref_rows)}")
        same = sum(torch.equal(rows[k], ref_rows[k]) for k in rows)
        require(same == len(rows), f"serve_tiered ({pool}): {same} of "
                f"{len(rows)} post-spill logits rows bitwise")
        require(tiered["kv_blocks_spilled"] >= 1,
                f"serve_tiered ({pool}): nothing spilled")
        if kv is None:
            require(tiered["kv_blocks_prefetched"] >= 1,
                    f"serve_tiered ({pool}): nothing promoted")
        emit({"phase": "serve_tiered", "model": "llama3-8b",
              "layers": model.config.num_hidden_layers,
              "peak_demand_blocks": peak, "full": full, "tiered": tiered,
              "streams_equal_full": True,
              "post_spill_logits_rows_bitwise": same,
              "tiered_over_full_tokens_per_s":
                  tiered["tokens_per_s"] / full["tokens_per_s"]})
        del rows, ref_rows
    solo, solo_got, _ = _tiered_run(torch, model, None, prompts[:1],
                                    TIERED_NEW[:1],
                                    kv_blocks=TIERED_SOLO_BLOCKS)
    solo_full, solo_ref, _ = _tiered_run(torch, model, None, prompts[:1],
                                         TIERED_NEW[:1], want=set())
    launches["bfloat16", "solo"] = solo["k4_launches"]
    bt = TIERED_KW["kv_block_tokens"]
    own = -(-(TIERED_LENGTHS[0] + TIERED_NEW[0]) // bt)
    require(solo_got == solo_ref, "serve_tiered (one sequence in "
            f"{TIERED_SOLO_BLOCKS} blocks): stream differs")
    require(solo["kv_blocks_spilled"] >= 1 and own > TIERED_SOLO_BLOCKS - 1,
            f"serve_tiered (one sequence): {solo['kv_blocks_spilled']} "
            f"spilled, {own} blocks of KV")
    emit({"phase": "serve_tiered", "model": "llama3-8b",
          "layers": model.config.num_hidden_layers,
          "one_sequence_kv_blocks": own, "full": solo_full, "tiered": solo,
          "streams_equal_full": True,
          "equal_to_its_stream_in_the_mix": solo_got[0] == refs["bfloat16"][0],
          "tiered_over_full_tokens_per_s":
              solo["tokens_per_s"] / solo_full["tokens_per_s"]})
    # the verify graphs over the tier: the 3000-token prompt again, a
    # verify of width 8 every step on both sides
    spec, spec_got, _ = _tiered_run(torch, model, None, prompts[:1],
                                    [TIERED_SPEC_NEW],
                                    kv_blocks=TIERED_SOLO_BLOCKS,
                                    spec=TIERED_SPEC_K)
    spec_full, spec_ref, _ = _tiered_run(torch, model, None, prompts[:1],
                                         [TIERED_SPEC_NEW], want=set(),
                                         spec=TIERED_SPEC_K)
    launches["bfloat16", "spec"] = spec["k4_launches"]
    require(spec_got == spec_ref, "serve_tiered (speculation): the tiered "
            "stream differs from the full pool's")
    require(spec["verify_replays_with_ext_blocks"]
            >= TIERED_SPEC_NEW // 2,
            f"serve_tiered (speculation): {spec['verify_replays']} verify "
            f"replays, {spec['verify_replays_with_ext_blocks']} reading "
            f"the extension tier")
    emit({"phase": "serve_tiered", "model": "llama3-8b",
          "layers": model.config.num_hidden_layers,
          "speculation_k": TIERED_SPEC_K,
          "drafts": "k copies of each slot's token, every step",
          "full": spec_full, "tiered": spec,
          "streams_equal_full": True,
          "tiered_over_full_tokens_per_s":
              spec["tokens_per_s"] / spec_full["tokens_per_s"]})
    return launches


# --------------------------------------------------------------------------
# the KV fabric (engine sub-slice (h)): two LLMServers over one model on
# one card, every move across a real TCP socket on 127.0.0.1
# --------------------------------------------------------------------------

FABRIC_TIMEOUT = 120.0        # s: a socket round trip and a driver job
FABRIC_HOST_BLOCKS = 24       # (c): a host tier smaller than the deeper parks


def _fabric_server(model, name, **kw):
    """One `LLMServer` at the serve shape with a fabric endpoint, booted:
    its graphs captured here, before any server takes traffic (a capture
    is "global": a CUDA call of another thread would break it; the
    fabric's own threads make none)."""
    from paddle_tpu_torch.inference import LLMServer
    fabric = dict({"timeout": FABRIC_TIMEOUT}, **kw.pop("fabric", {}))
    srv = LLMServer(model, name=name, series_interval=None,
                    watchdog_deadline=None, fabric=fabric,
                    **dict(SERVE_KW, **kw))
    eng = srv.engine
    require(eng._graphs is not None and eng.overlap
            and eng.decode_kernel == "cuda",
            f"serve_fabric: server {name} off the card's path")
    eng.prepare_programs()
    return srv


def _drop_servers(torch, *servers):
    """Shut servers down and free them before the next capture (each
    fabric endpoint's handler closes over its engine)."""
    for s in servers:
        s.shutdown(timeout=60)
        require(not s._thread.is_alive(),
                f"serve_fabric: {s.name}'s driver still runs")
    for s in servers:
        _unhook(torch, s.engine)


def _fab_counts(srv):
    return srv.health_snapshot()["fabric"]


def _total_replays(*servers):
    return sum(sum(_replays(s.engine)) for s in servers)


def _k4_servers(torch, what, since, *servers):
    """K4's launches since they were zeroed, held to layers x every
    decode / verify replay of `servers` since `since` (their summed
    `_replays` then); returns them."""
    from paddle_tpu_torch.ops import paged_attention as PA
    launches = PA.LAUNCHES["paged_attention"]
    replays = _total_replays(*servers) - since
    layers = servers[0].engine.cfg.num_hidden_layers
    require(replays > 0 and launches == layers * replays,
            f"{what}: {launches} K4 launches for {replays} replays x "
            f"{layers} layers")
    return launches


@contextlib.contextmanager
def _fabric_clock():
    """Host-clock timers on the fabric's module functions for the block:
    `crc32c` by thread, `pack_leaves`, `unpack_leaves` and
    `fabric_request` (ms, summed).  Restored on exit."""
    import threading
    from paddle_tpu_torch.inference import kv_fabric as KF
    times = {}

    def timed(name, fn, by_thread=False):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                key = (name, threading.current_thread().name) \
                    if by_thread else name
                times[key] = times.get(key, 0.0) + 1e3 * (
                    time.perf_counter() - t0)
        return call

    saved = {n: getattr(KF, n) for n in ("crc32c", "pack_leaves",
                                         "unpack_leaves", "fabric_request")}
    KF.crc32c = timed("crc", saved["crc32c"], by_thread=True)
    for n in ("pack_leaves", "unpack_leaves", "fabric_request"):
        setattr(KF, n, timed(n, saved[n]))
    try:
        yield times
    finally:
        for n, fn in saved.items():
            setattr(KF, n, fn)


def _time_method(eng, name, into):
    """Accumulate the host ms of `eng.name` calls in `into[name]` (an
    instance attribute: `_unhook` takes it off)."""
    fn = getattr(eng, name)

    def call(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            into[name] = into.get(name, 0.0) + 1e3 * (time.perf_counter()
                                                      - t0)
            into[name + "_calls"] = into.get(name + "_calls", 0) + 1
    setattr(eng, name, call)


def _freeze_at_park(eng, mode):
    """Freeze `eng`'s parks (its quarantine flag: no resume, admissions
    go on) on the driver thread the first time a park of `mode` lands,
    so the harness can move that session before it resumes."""
    park, armed = eng._park_slot, [True]

    def parked(slot, mode_=None):
        park(slot, mode_)
        if armed[0] and eng._parked and eng._parked[-1].mode == mode:
            armed[0] = False
            eng.freeze_parked = True
    eng._park_slot = parked


def _stamped(stamps, key):
    def on_token(req, tok):
        stamps.setdefault(key, []).append(time.perf_counter())
    return on_token


def _fabric_pull(torch, model, kv, prefix_streams):
    """(a) A holds serve_prefix's 384-token system prompt in its trie
    (request 0 alone: local recompute; request 1 alone: a trie hit;
    then the other 14); B, an empty trie, serves the same 16 requests
    with a hint naming A: request 0 pulls the 24 prompt blocks over the
    socket, the other 15 hit B's trie.  B's streams equal A's (bf16:
    and serve_prefix's cached run); 24 blocks, 24 blocks' bytes and 384
    tokens moved; no integrity failure.  K4 = 32 x B's replays."""
    import numpy as np
    from paddle_tpu_torch.ops import paged_attention as PA
    rng = np.random.default_rng(4)
    vocab = model.config.vocab_size
    system = rng.integers(0, vocab, PREFIX_SYSTEM)
    prompts = [np.concatenate([system, rng.integers(0, vocab,
                                                     PREFIX_SUFFIX)])
               for _ in range(PREFIX_N)]
    pool = kv or "bfloat16"
    name = f"serve_fabric pull ({pool})"
    a = _fabric_server(model, "fabA", kv_dtype=kv, **PREFIX_KW)
    b = _fabric_server(model, "fabB", kv_dtype=kv, **PREFIX_KW)
    try:
        stamps, t_sub = {}, {}

        def run(srv, idx, hint=None):
            reqs = []
            for i in idx:
                t_sub[srv.name, i] = time.perf_counter()
                reqs.append(srv.submit(
                    prompts[i], PREFIX_NEW,
                    on_token=_stamped(stamps, (srv.name, i)),
                    **({} if hint is None else {"prefix_hint": hint})))
            for r in reqs:
                srv.result(r, timeout=SLO_WAIT_S)
                require(r.error is None and len(r.tokens) == PREFIX_NEW,
                        f"{name}: request {r.rid}: {r.error!r}")
            return [list(r.tokens) for r in reqs]

        def ttft(srv, i):
            return 1e3 * (stamps[srv.name, i][0] - t_sub[srv.name, i])

        ref = run(a, [0]) + run(a, [1]) + run(a, range(2, PREFIX_N))
        if prefix_streams is not None:
            require(ref == prefix_streams,
                    f"{name}: the holder's streams differ from "
                    f"serve_prefix's cached run")
        hint = {"addr": list(a.fabric_address), "tokens": PREFIX_SYSTEM}
        times = {}
        _time_method(a.engine, "_export_blocks", times)
        _time_method(a.engine, "_host_rows", times)
        _time_method(a.engine, "_serve_pull", times)
        _time_method(b.engine, "_pull_remote_prefix", times)
        _time_method(b.engine, "_land_prefix_blocks", times)
        torch.cuda.synchronize()
        PA.LAUNCHES["paged_attention"] = 0
        since = _total_replays(a, b)
        with _fabric_clock() as clock:
            out = run(b, [0], hint)
        out += run(b, range(1, PREFIX_N), hint)
        torch.cuda.synchronize()
        launches = _k4_servers(torch, name, since, a, b)
        require(out == ref, f"{name}: the puller's streams differ from "
                f"the holder's")
        fb = _fab_counts(b)
        nb = PREFIX_SYSTEM // SERVE_KW["kv_block_tokens"]
        block = b.engine._kv_block_bytes
        require(fb["blocks_moved"]["pull"] == nb
                and fb["bytes_moved"]["pull"] == nb * block
                and fb["prefill_tokens_saved_remote"] == PREFIX_SYSTEM,
                f"{name}: moved {fb}")
        for s in (a, b):
            require(not any(_fab_counts(s)["integrity_failures"].values()),
                    f"{name}: integrity failures on {s.name}")
        # CRC ms by the thread that ran it: A's driver packs, B's unpacks
        crc = {k[1]: ms for k, ms in clock.items() if isinstance(k, tuple)}
        crc_send = sum(ms for t, ms in crc.items() if t.endswith("fabA"))
        crc_recv = sum(ms for t, ms in crc.items() if t.endswith("fabB"))
        rt = clock["fabric_request"]
        report = {
            "phase": "serve_fabric", "move": "pull", "pool": pool,
            "model": "llama3-8b", "requests": PREFIX_N,
            "blocks": nb, "mb_moved": nb * block / 1e6,
            "tokens_saved_remote": fb["prefill_tokens_saved_remote"],
            "streams_equal_holder": True,
            "streams_equal_serve_prefix": prefix_streams is not None,
            "host_ms": {
                "pull_total": times["_pull_remote_prefix"],
                "export_gather_copy_wait": times["_host_rows"],
                "export_total": times["_export_blocks"],
                "export_pack": clock["pack_leaves"],
                "crc_sender": crc_send, "crc_receiver": crc_recv,
                "serve_on_holder": times["_serve_pull"],
                "round_trip": rt,
                "send_receive": rt - times["_serve_pull"],
                "receive_unpack": clock["unpack_leaves"],
                "land": times["_land_prefix_blocks"]},
            "host_ms_per_block": {
                "export": times["_export_blocks"] / nb,
                "crc_sender": crc_send / nb, "crc_receiver": crc_recv / nb,
                "send_receive": (rt - times["_serve_pull"]) / nb,
                "land": times["_land_prefix_blocks"] / nb},
            "ttft_ms": {"pulled": ttft(b, 0),
                        "local_recompute": ttft(a, 0),
                        "local_trie_hit": ttft(a, 1)},
            "export_waits": int(_metric(a.engine,
                                        "fabric_export_waits_total")),
            "k4_launches": launches,
            "decode_replays": {s.name: sum(_replays(s.engine))
                               for s in (a, b)}}
        emit(report)
        return launches
    finally:
        _drop_servers(torch, a, b)


def _pressure_prompts(model):
    import numpy as np
    rng = np.random.default_rng(3)
    return [rng.integers(0, model.config.vocab_size, L)
            for L in PRESSURE_LENGTHS]


def _fabric_migrate(torch, model, ref):
    """(b) serve_pressure's traffic (bf16, 158 blocks, swap) on A with a
    session id a request; once sessions park, A's parks freeze and B
    (full provisioning) takes one over the socket and continues it; B's
    stream of it equals serve_pressure's full-provisioning stream, as do
    A's other 15 (the rule serve_pressure holds swap streams to: token
    for token).  K4 = 32 x (A's + B's replays)."""
    from paddle_tpu_torch.ops import paged_attention as PA
    prompts = _pressure_prompts(model)
    name = "serve_fabric migrate (bfloat16)"
    a = _fabric_server(model, "migA", kv_blocks=pressure_blocks(),
                       preempt_policy="swap")
    b = _fabric_server(model, "migB")
    try:
        torch.cuda.synchronize()
        PA.LAUNCHES["paged_attention"] = 0
        since = _total_replays(a, b)
        t0 = time.perf_counter()
        _freeze_at_park(a.engine, "swap")
        reqs = [a.submit(p, PRESSURE_NEW, session_id=f"p{i}")
                for i, p in enumerate(prompts)]
        _bounded(lambda: a.engine.freeze_parked
                 or all(r.done for r in reqs), f"{name}: a park on A")
        require(a.engine.freeze_parked, f"{name}: no session parked on A")
        sid = next(p.sid for p in list(a.engine._parked)
                   if p.mode == "swap")
        t_adopt = time.perf_counter()
        adopted = b.adopt({"kind": "peer", "addr": list(a.fabric_address),
                           "session_id": sid})
        adopt_ms = 1e3 * (time.perf_counter() - t_adopt)
        a.engine.freeze_parked = False
        a._pending.put(None)            # wake A's driver for its resumes
        i = int(sid[1:])
        for r in reqs:
            a.result(r, timeout=SLO_WAIT_S)
        b.result(adopted, timeout=SLO_WAIT_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _k4_servers(torch, name, since, a, b)
        src = reqs[i]
        require(src.migrated and src.error is None
                and len(src.tokens) < PRESSURE_NEW,
                f"{name}: the source request: migrated {src.migrated}, "
                f"{len(src.tokens)} tokens, {src.error!r}")
        require(list(adopted.tokens) == ref[i],
                f"{name}: the adopted stream differs from full "
                f"provisioning's")
        for j, r in enumerate(reqs):
            if j != i:
                require(list(r.tokens) == ref[j],
                        f"{name}: request {j} differs from full "
                        f"provisioning's")
        fb = _fab_counts(b)
        require(fb["blocks_moved"]["migrate"] >= 1
                and fb["bytes_moved"]["migrate"] > 0,
                f"{name}: moved {fb}")
        for s in (a, b):
            require(not any(_fab_counts(s)["integrity_failures"].values()),
                    f"{name}: integrity failures on {s.name}")
        mig = b.engine.metrics()["llm_engine_fabric_migration_seconds"][
            "series"][""]
        report = {
            "phase": "serve_fabric", "move": "migrate", "pool": "bfloat16",
            "model": "llama3-8b", "requests": len(reqs),
            "kv_blocks": a.engine.kv_blocks,
            "adopted_request": i, "tokens_before_move": len(src.tokens),
            "blocks": fb["blocks_moved"]["migrate"],
            "mb_moved": fb["bytes_moved"]["migrate"] / 1e6,
            "fabric_migration_ms": 1e3 * mig["sum"] / max(mig["count"], 1),
            "adopt_call_ms": adopt_ms,
            "streams_equal_full_provisioning": True,
            "preemptions_on_A": int(_metric(a.engine, "preemptions_total")),
            "swap_crc_failures": int(
                _fab_counts(a)["integrity_failures"]["swap"]),
            "export_waits_on_A": int(_metric(
                a.engine, "fabric_export_waits_total")),
            "wall_s": wall, "k4_launches": launches,
            "decode_replays": {s.name: sum(_replays(s.engine))
                               for s in (a, b)}}
        emit(report)
        return launches
    finally:
        _drop_servers(torch, a, b)


def _fabric_disk(torch, model, ref, prefix_streams, root):
    """(c) the pressure traffic on A with a disk tier under `root` and a
    host tier of FABRIC_HOST_BLOCKS rows: the parks it cannot hold take
    the "disk" mode (their blocks in a ticket on disk, resumed from
    it); streams equal full provisioning; blocks and bytes spilled, no
    integrity failure.  One disk-parked session is adopted by a second
    server over the same root while A's parks are frozen: its stream
    equals full provisioning, a second claim finds nothing, and A's own
    resume then sees the claim (the request ends `migrated`).  Then a
    prefix engine writes serve_prefix's request 0 through to the disk
    tier and a fresh engine over the root serves it warm (24 blocks from
    disk) with the same stream.  K4 = 32 x every replay."""
    from paddle_tpu_torch.ops import paged_attention as PA
    prompts = _pressure_prompts(model)
    name = "serve_fabric disk (bfloat16)"
    sess = str(root / "pressure")
    a = _fabric_server(model, "diskA", kv_blocks=pressure_blocks(),
                       preempt_policy="swap",
                       host_pool_blocks=FABRIC_HOST_BLOCKS,
                       fabric={"disk_root": sess,
                               "persist_sessions": False})
    b = _fabric_server(model, "diskB", fabric={"disk_root": sess,
                                               "persist_sessions": False})
    try:
        io = {}
        for eng in (a.engine, b.engine):
            _time_method(eng._disk, "put_session", io)
            _time_method(eng._disk, "claim_session", io)
        torch.cuda.synchronize()
        PA.LAUNCHES["paged_attention"] = 0
        since = _total_replays(a, b)
        _freeze_at_park(a.engine, "disk")
        reqs = [a.submit(p, PRESSURE_NEW, session_id=f"d{i}")
                for i, p in enumerate(prompts)]
        _bounded(lambda: a.engine.freeze_parked
                 or all(r.done for r in reqs), f"{name}: a disk park on A")
        require(a.engine.freeze_parked, f"{name}: no disk-mode park on A")
        sid = next(p.sid for p in list(a.engine._parked)
                   if p.mode == "disk")
        adopted = b.adopt({"kind": "disk", "session_id": sid})
        try:
            b.adopt({"kind": "disk", "session_id": sid})
            require(False, f"{name}: a disk ticket claimed twice")
        except KeyError:
            pass
        a.engine.freeze_parked = False
        a._pending.put(None)
        i = int(sid[1:])
        for r in reqs:
            a.result(r, timeout=SLO_WAIT_S)
        b.result(adopted, timeout=SLO_WAIT_S)
        torch.cuda.synchronize()
        launches = _k4_servers(torch, name, since, a, b)
        src = reqs[i]
        require(src.migrated and src.error is None,
                f"{name}: the source's resume did not see the claim: "
                f"migrated {src.migrated}, {src.error!r}")
        require(list(adopted.tokens) == ref[i],
                f"{name}: the adopted stream differs from full "
                f"provisioning's")
        for j, r in enumerate(reqs):
            if j != i:
                require(list(r.tokens) == ref[j],
                        f"{name}: request {j} differs from full "
                        f"provisioning's")
        fa, fb = _fab_counts(a), _fab_counts(b)
        require(fa["blocks_moved"]["spill"] > 0
                and fa["bytes_moved"]["spill"] > 0,
                f"{name}: nothing spilled to disk: {fa}")
        for f in (fa, fb):
            require(not any(f["integrity_failures"].values()),
                    f"{name}: integrity failures {f['integrity_failures']}")
        spilled = fa["blocks_moved"]["spill"]
        report = {
            "phase": "serve_fabric", "move": "disk park", "pool": "bfloat16",
            "model": "llama3-8b", "host_pool_blocks": FABRIC_HOST_BLOCKS,
            "preemptions": int(_metric(a.engine, "preemptions_total")),
            "spilled_blocks": spilled,
            "spilled_mb": fa["bytes_moved"]["spill"] / 1e6,
            "resumed_from_disk_blocks": fa["blocks_moved"]["pull"],
            "adopted_request": i, "adopted_blocks":
                fb["blocks_moved"]["migrate"],
            "disk_write_ms_per_block": io.get("put_session", 0.0)
            / max(spilled, 1),
            "disk_claim_read_ms_per_block": io.get("claim_session", 0.0)
            / max(fa["blocks_moved"]["pull"] + fb["blocks_moved"]
                  ["migrate"], 1),
            "streams_equal_full_provisioning": True,
            "claimed_once": True, "source_saw_claim": True,
            "k4_launches": launches}
        emit(report)
    finally:
        _drop_servers(torch, a, b)
    # the prefix half: write through, then a fresh engine reads it warm
    import numpy as np
    rng = np.random.default_rng(4)
    vocab = model.config.vocab_size
    prompt = np.concatenate([rng.integers(0, vocab, PREFIX_SYSTEM),
                             rng.integers(0, vocab, PREFIX_SUFFIX)])
    pref = str(root / "prefix")
    streams, io2, prefix_launches = [], {}, 0
    layers = model.config.num_hidden_layers
    report = {"phase": "serve_fabric", "move": "disk prefix",
              "pool": "bfloat16", "model": "llama3-8b"}
    for step in ("write", "read"):
        eng = _serve_engine(model, **PREFIX_KW,
                            fabric={"disk_root": pref})
        _time_method(eng._disk, "put_block", io2)
        _time_method(eng._disk, "get_block", io2)
        torch.cuda.synchronize()
        PA.LAUNCHES["paged_attention"] = 0
        since = sum(_replays(eng))
        r = eng.submit(prompt, PREFIX_NEW)
        eng.run()
        torch.cuda.synchronize()
        require(r.error is None and len(r.tokens) == PREFIX_NEW,
                f"{name}: prefix {step}: {r.error!r}")
        replays = sum(_replays(eng)) - since
        require(PA.LAUNCHES["paged_attention"] == layers * replays > 0,
                f"{name}: prefix {step}: {PA.LAUNCHES['paged_attention']} "
                f"K4 launches for {replays} replays")
        prefix_launches += PA.LAUNCHES["paged_attention"]
        streams.append(list(r.tokens))
        report[f"prefix_{step}_blocks"] = {
            k: int(eng.metrics()["llm_engine_fabric_blocks_moved_total"]
                   ["series"][f"op={k}"]["value"]) for k in ("pull", "spill")}
        _unhook(torch, eng)
    nb = PREFIX_SYSTEM // SERVE_KW["kv_block_tokens"]
    require(report["prefix_read_blocks"]["pull"] == nb,
            f"{name}: the fresh engine read {report['prefix_read_blocks']} "
            f"blocks from disk, want {nb}")
    require(streams[0] == streams[1] and (prefix_streams is None
                                          or streams[0] == prefix_streams[0]),
            f"{name}: the disk-warm stream differs")
    report.update({
        "prefix_streams_equal": True,
        "disk_put_block_ms": io2.get("put_block", 0.0)
        / max(io2.get("put_block_calls", 1), 1),
        "disk_get_block_ms": io2.get("get_block", 0.0)
        / max(io2.get("get_block_calls", 1), 1),
        "k4_launches": prefix_launches})
    emit(report)
    return launches + prefix_launches


def _fabric_handoff(torch, model, kv):
    """(d) P (pool_role "prefill") and D ("decode"): the serve mix (8
    requests x 32 tokens) colocated on D, then prefilled on P with D as
    the handoff target and adopted on D ({"kind": "handoff"}): every
    adopted stream equals D's colocated one; every request of two or
    more prefill chunks shipped two or more frames.  TTFT at P, ITL at
    D against colocated.  K4 = 32 x (P's + D's replays)."""
    import numpy as np
    from paddle_tpu_torch.ops import paged_attention as PA
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab_size, L)
               for L in SERVE_LENGTHS]
    pool = kv or "bfloat16"
    name = f"serve_fabric handoff ({pool})"
    P = _fabric_server(model, "P", kv_dtype=kv, pool_role="prefill")
    Dd = _fabric_server(model, "D", kv_dtype=kv, pool_role="decode")
    try:
        torch.cuda.synchronize()
        PA.LAUNCHES["paged_attention"] = 0
        since = _total_replays(P, Dd)
        stamps, t_sub = {}, {}
        t0 = time.perf_counter()
        colo = [Dd.submit(p, SERVE_NEW, on_token=_stamped(stamps, ("c", i)))
                for i, p in enumerate(prompts)]
        for r in colo:
            Dd.result(r, timeout=SLO_WAIT_S)
        ref = [list(r.tokens) for r in colo]
        frames = {}
        send = P.engine._ho_send

        def counted(hs, header, payload, rec=None):
            frames[hs["sid"]] = frames.get(hs["sid"], 0) + 1
            return send(hs, header, payload, rec)
        P.engine._ho_send = counted
        t1 = time.perf_counter()
        reqs = []
        for i, p in enumerate(prompts):
            t_sub[i] = time.perf_counter()
            reqs.append(P.submit(p, SERVE_NEW, session_id=f"h{i}",
                                 handoff={"addr": list(Dd.fabric_address)},
                                 on_token=_stamped(stamps, ("p", i))))
        adopted, adopt_ms = [None] * len(reqs), []
        deadline = time.monotonic() + SLO_WAIT_S
        while any(a is None for a in adopted):
            require(time.monotonic() < deadline,
                    f"{name}: handoffs never completed")
            for i, r in enumerate(reqs):
                if adopted[i] is None and r.done:
                    require(r.migrated and r.error is None,
                            f"{name}: request {i} not handed off "
                            f"({r.error!r})")
                    ta = time.perf_counter()
                    adopted[i] = Dd.adopt(
                        {"kind": "handoff", "session_id": f"h{i}"},
                        on_token=_stamped(stamps, ("d", i)))
                    adopt_ms.append(1e3 * (time.perf_counter() - ta))
            time.sleep(0.002)
        for r in adopted:
            Dd.result(r, timeout=SLO_WAIT_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = _k4_servers(torch, name, since, P, Dd)
        out = [list(r.tokens) for r in adopted]
        require(out == ref, f"{name}: adopted streams differ from D's "
                f"colocated streams")
        require(all(list(r.tokens) == x[:1] for r, x in zip(reqs, ref)),
                f"{name}: the prefill side emitted more than the first "
                f"token")
        for i, p in enumerate(prompts):
            off, chunks = 0, 0
            while off < len(p):
                off += P.engine._chunk_for(len(p) - off)
                chunks += 1
            require(chunks < 2 or frames.get(f"h{i}", 0) >= 2,
                    f"{name}: request {i} ({len(p)} tokens, {chunks} "
                    f"chunks) shipped {frames.get(f'h{i}', 0)} frames")
        fp, fd = _fab_counts(P), _fab_counts(Dd)
        for f in (fp, fd):
            require(not any(f["integrity_failures"].values()),
                    f"{name}: integrity failures {f['integrity_failures']}")
        # the adopted stream's first stamp is the replayed first token:
        # D's ITL starts at its first decoded token
        itl = {k: [b - a for i in range(len(prompts))
                   for a, b in zip(stamps[k, i][skip:],
                                   stamps[k, i][skip + 1:])]
               for k, skip in (("c", 0), ("d", 1))}
        ttft_p = [stamps["p", i][0] - t_sub[i] for i in range(len(reqs))]
        ttft_c = [stamps["c", i][0] - t0 for i in range(len(colo))]
        report = {
            "phase": "serve_fabric", "move": "handoff", "pool": pool,
            "model": "llama3-8b", "layers": model.config.num_hidden_layers,
            "requests": len(prompts),
            "frames_per_request": [frames.get(f"h{i}", 0)
                                   for i in range(len(prompts))],
            "handoff_chunks": fp["handoff_chunks"],
            "mb_moved": fp["handoff_bytes"] / 1e6,
            "streams_equal_colocated": True,
            "ttft_p50_ms": {"at_P": 1e3 * _percentile(ttft_p, 50),
                            "colocated": 1e3 * _percentile(ttft_c, 50)},
            "itl_ms": {"at_D_p50": 1e3 * _percentile(itl["d"], 50),
                       "at_D_p99": 1e3 * _percentile(itl["d"], 99),
                       "colocated_p50": 1e3 * _percentile(itl["c"], 50),
                       "colocated_p99": 1e3 * _percentile(itl["c"], 99)},
            "adopt_call_ms_p50": _percentile(adopt_ms, 50),
            "handoff_wall_s": wall, "k4_launches": launches,
            "decode_replays": {s.name: sum(_replays(s.engine))
                               for s in (P, Dd)}}
        emit(report)
        return launches
    finally:
        _drop_servers(torch, P, Dd)


def phase_serve_fabric(torch, model, prefix_streams, pressure_streams,
                       shallow):
    """The KV fabric between two servers on one card (llama3-8b, bf16,
    the serve shape): (a) a prefix pull, bf16 and int8 pools (int8 on
    `shallow`, against its own recompute); (b) a live session
    migration; (c) disk parks, a disk adoption claimed once, a disk-warm
    prefix after a restart, all on all 32 layers (their references are
    the earlier phases' streams); (d) the chunk-streamed prefill ->
    decode handoff, bf16 and int8 pools, on `shallow` (its own
    colocated reference).  Every move must have moved blocks (a
    silent fallback to recompute fails the phase).  Returns K4's
    launches by (pool, move)."""
    import tempfile
    t0 = time.perf_counter()
    launches = {}
    for kv in (None, "int8"):
        launches[kv or "bfloat16", "pull"] = _fabric_pull(
            torch, model if kv is None else shallow, kv,
            prefix_streams if kv is None else None)
    launches["bfloat16", "migrate"] = _fabric_migrate(
        torch, model, pressure_streams)
    with tempfile.TemporaryDirectory(prefix="fabric-disk-") as d:
        launches["bfloat16", "disk"] = _fabric_disk(
            torch, model, pressure_streams, prefix_streams, Path(d))
    for kv in (None, "int8"):
        launches[kv or "bfloat16", "handoff"] = _fabric_handoff(
            torch, shallow, kv)
    emit({"phase": "serve_fabric", "seconds": time.perf_counter() - t0})
    return launches


FLEET_JOB = "serve-fleet"
FLEET_TTL = 5.0               # s: the JAX lease default (a beat every ttl / 3)
FLEET_SERIES_S = 0.25         # s: each replica's series sampler (tier 0)
FLEET_SERIES_TIERS = ((FLEET_SERIES_S, 480), (5.0, 120))
# (d): engine SLO targets below the card's decode step (TTFT 50 ms, ITL
# 5 ms), so every request of the traffic misses; the rule's windows are
# short enough to fire and resolve inside the phase
FLEET_SLO = {"standard": (0.05, 0.005)}
FLEET_RULE = dict(target=0.9, fast_window_s=1.0, slow_window_s=3.0,
                  fast_burn=2.0, slow_burn=1.0, fire_after=2,
                  resolve_after=2)
FLEET_POLL_S = 0.25           # (d): the harness's ingest + evaluate cadence
FLEET_ALERT_WAIT_S = 180.0    # (d): the traffic, the fire and the resolve
# (d): |fleet_sum(token rate) - sum of the replicas' own rates| <= this x
# the sum: fleet_sum is a mean of per-interval rates sampled on a host
# thread, the reference each replica's tokens over the traffic's span
FLEET_RATE_TOL = 0.10
FLEET_RAW_CALLS = 10          # (e): raw_step calls between CUDA events
FLEET_WAL_APPENDS = 200       # WAL ms per append, fsync on and off


def _shallow(torch, model, layers):
    """`model`'s first `layers` decoder layers as a model of their own:
    the same parameter tensors (nothing copied), the config's depth cut.
    The phases that hold themselves to their own references run on it
    to keep the run inside its time budget."""
    import copy
    import dataclasses
    cfg = dataclasses.replace(model.config, num_hidden_layers=layers)
    lm = copy.copy(model.llama)
    lm._modules = dict(model.llama._modules)
    lm.layers = torch.nn.ModuleList(list(model.llama.layers)[:layers])
    lm.config = cfg
    out = copy.copy(model)
    out._modules = dict(model._modules)
    out.llama = lm
    out.config = cfg
    return out


def _wal_append_ms(root):
    """ms per WAL append of a durable master, fsync off and on:
    FLEET_WAL_APPENDS sets of a lease-sized value each, timed around
    `_Durable.append` on this machine's disk (the run's temp dir)."""
    from paddle_tpu_torch.distributed import TCPStore
    out = {}
    for fsync in (False, True):
        s = TCPStore("127.0.0.1", 0, is_master=True, wal_fsync=fsync,
                     durable_dir=str(root / f"wal-fsync-{fsync}"))
        try:
            dur, times = s._server.kv_durable, []
            append = dur.append

            def timed(*a, **k):
                t = time.perf_counter()
                try:
                    return append(*a, **k)
                finally:
                    times.append(1e3 * (time.perf_counter() - t))
            dur.append = timed
            for i in range(FLEET_WAL_APPENDS):
                s.set(f"fleet/wal/replica/r{i % 4}",
                      (time.time(), FLEET_TTL, i))
        finally:
            s.close()
        require(len(times) == FLEET_WAL_APPENDS,
                f"serve_fleet WAL: {len(times)} appends timed")
        out["fsync_on" if fsync else "fsync_off"] = {
            "p50": _percentile(times, 50), "p99": _percentile(times, 99),
            "n": len(times)}
    return out


def _time_heartbeats(store):
    """Host ms of every store RPC made off the main thread (the leases'
    heartbeats: the fence read and the lease write), as (start, end,
    ms) — an instance attribute over `store._rpc`, which serialises the
    client's RPCs, so a beat's time includes waiting for the socket."""
    import threading
    rpc, main, out = store._rpc, threading.main_thread(), []

    def timed(*a, **k):
        if threading.current_thread() is main:
            return rpc(*a, **k)
        t = time.perf_counter()
        try:
            return rpc(*a, **k)
        finally:
            e = time.perf_counter()
            out.append((t, e, 1e3 * (e - t)))
    store._rpc = timed
    return out


def _fleet_mix(torch, fleet, prompts, new, what, during=None):
    """`prompts` sent alternately to the fleet's replicas through
    `Replica.submit` (request i to replica i % n); `during()` runs once
    every request has its first token; then every result.  K4 is held
    to layers x the replicas' replays.  Returns (streams, report)."""
    from paddle_tpu_torch.ops import paged_attention as PA
    servers = [r.server for r in fleet.replicas]
    torch.cuda.synchronize()
    PA.LAUNCHES["paged_attention"] = 0
    since = _total_replays(*servers)
    stamps = {}
    t0 = time.perf_counter()
    reqs = [fleet.replicas[i % len(servers)].submit(
        p, new, on_token=_stamped(stamps, i)) for i, p in enumerate(prompts)]
    if during is not None:
        _bounded(lambda: all(r.tokens or r.done for r in reqs),
                 f"{what}: first tokens")
        during()
    for r in reqs:
        r.result(timeout=SLO_WAIT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _k4_servers(torch, what, since, *servers)
    for r in reqs:
        require(r.done and r.error is None and len(r.tokens) == new,
                f"{what}: request {r.rid}: {len(r.tokens)} tokens, "
                f"{r.error!r}")
    ttft = [stamps[i][0] - t0 for i in range(len(reqs))]
    itl = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
    gen = sum(len(r.tokens) for r in reqs)
    return [list(r.tokens) for r in reqs], {
        "requests": len(reqs), "wall_s": wall, "tokens_per_s": gen / wall,
        "ttft_p50_ms": 1e3 * _percentile(ttft, 50),
        "itl_p50_ms": 1e3 * _percentile(itl, 50),
        "itl_p99_ms": 1e3 * _percentile(itl, 99),
        "k4_launches": launches,
        "placed": {r.name: sum(1 for i in range(len(reqs))
                               if i % len(servers) == j)
                   for j, r in enumerate(fleet.replicas)}}


def _fleet_alerts(torch, fleet, prompts):
    """(d) serve_slo's pressure traffic (16 x PRESSURE_NEW tokens) over
    both replicas, every request missing FLEET_SLO: the harness pulls
    each replica's `metrics_series()` into one FleetMetricsAggregator
    and evaluates a BurnRateRule every FLEET_POLL_S, until the alert has
    fired and, after the traffic stopped, resolved.  fleet_sum of the
    token rate over the traffic's span against each replica's own
    tokens over it.  Returns the report."""
    from paddle_tpu_torch.observability import (AlertManager, BurnRateRule,
                                                FleetMetricsAggregator)
    from paddle_tpu_torch.ops import paged_attention as PA
    what = "serve_fleet (d)"
    servers = [r.server for r in fleet.replicas]
    agg = FleetMetricsAggregator(stale_after_s=10.0)
    mgr = AlertManager([BurnRateRule("fleet-standard-burn", "standard",
                                     **FLEET_RULE)])
    key = "llm_engine_generated_tokens_total"

    def made():
        return [int(_metric(s.engine, "generated_tokens_total"))
                for s in servers]

    torch.cuda.synchronize()
    PA.LAUNCHES["paged_attention"] = 0
    since = _total_replays(*servers)
    before = made()
    t_sub = time.time()
    reqs = [fleet.replicas[i % len(servers)].submit(p, PRESSURE_NEW)
            for i, p in enumerate(prompts)]
    fired = resolved = t_done = span = None
    early = 0                   # resolutions while the traffic still ran
    deadline = time.monotonic() + FLEET_ALERT_WAIT_S
    while resolved is None:
        require(t_done is None or fired is None or mgr.firing(),
                f"{what}: the alert resolved before the traffic stopped")
        require(time.monotonic() < deadline,
                f"{what}: the alert never fired and resolved")
        time.sleep(FLEET_POLL_S)
        now = time.time()
        for rep in fleet.replicas:
            agg.ingest(rep.name, rep.server.metrics_series(n=64), now=now)
        for a in mgr.evaluate(agg.error_rate, now=now):
            if a.state == "firing":
                fired = fired or a
            elif t_done is None:
                early += 1
            else:
                resolved = a
        if t_done is None and all(r.done for r in reqs):
            t_done = now
            after = made()
            # the sampler's points over the traffic: from the submit to
            # the poll that saw it end
            span = t_done - t_sub
            rates = [(b - a) / span for a, b in zip(before, after)]
            fleet_rate = agg.fleet_sum(key, span, now=t_done)
    for r in reqs:
        require(r.done and r.error is None
                and len(r.tokens) == PRESSURE_NEW,
                f"{what}: request {r.rid}: {len(r.tokens)} tokens, "
                f"{r.error!r}")
    require(fired is not None and fired.fired_t < resolved.resolved_t,
            f"{what}: the alert did not fire before it resolved")
    launches = _k4_servers(torch, what, since, *servers)
    require(fleet_rate is not None and abs(fleet_rate - sum(rates))
            <= FLEET_RATE_TOL * sum(rates),
            f"{what}: fleet_sum of the token rate {fleet_rate} vs the "
            f"replicas' {sum(rates)}")
    missed = sum(int(_metric(s.engine, "slo_missed_total",
                             series="tier=standard")) for s in servers)
    require(missed >= len(reqs),
            f"{what}: {missed} requests missed their SLO of {len(reqs)}")
    return {"drill": "d_series_alerts", "requests": len(reqs),
            "new_tokens": PRESSURE_NEW, "slo_targets": FLEET_SLO,
            "rule": FLEET_RULE, "poll_s": FLEET_POLL_S,
            "series_interval_s": FLEET_SERIES_S,
            "fired_s_after_submit": fired.fired_t - t_sub,
            "fired_s_after_traffic": fired.fired_t - t_done,
            "resolved_while_traffic_ran": early,
            "burn_at_fire": {"fast": fired.burn_fast,
                             "slow": fired.burn_slow},
            "traffic_s": span,
            "resolved_s_after_traffic": resolved.resolved_t - t_done,
            "slo_missed": missed,
            "token_rate": {"fleet_sum": fleet_rate,
                           "replicas": dict(zip(
                               [r.name for r in fleet.replicas], rates)),
                           "tolerance": f"|fleet_sum - sum| <= "
                                        f"{FLEET_RATE_TOL} x sum"},
            "series_ingested": agg.ingests,
            "aggregator": {n: {k: v for k, v in r.items() if k != "series"}
                           for n, r in agg.replicas().items()},
            "k4_launches": launches}


def _raw_step_run(torch, model, weight_dtype, prompts, ref):
    """(e) `raw_step()` on a serve-shape engine (graphs + overlap) with
    every slot decoding the serve mix: FLEET_RAW_CALLS calls between
    CUDA events after two warm-up calls, K4 = layers x calls, the
    attention-byte counter moved by a step's bytes a call; then the
    mix runs to its end, its streams equal to `ref` (raw steps change
    no stream).  The two byte figures over the measured ms, each against
    the card's memory rate; num_compiles against its bound."""
    from paddle_tpu_torch.observability.roofline import peak_hbm_bw
    from paddle_tpu_torch.ops import paged_attention as PA
    what = f"serve_fleet (e) raw_step ({weight_dtype or 'bf16'} weights)"
    eng = _serve_engine(model, weight_dtype=weight_dtype)
    reqs = [eng.submit(p, SERVE_NEW) for p in prompts]
    steps = 0
    while eng.num_active < eng.max_slots or eng.num_prefilling:
        require(eng.has_work and steps < 1000,
                f"{what}: the slots never all decoded")
        eng.step()
        steps += 1
    eng.flush()
    active = eng.num_active
    roof = f"kernel=cuda,kv_dtype=auto,tp={eng.tp}"
    bytes0 = _metric(eng, "decode_attn_bytes_total", series=roof)
    torch.cuda.synchronize()
    PA.LAUNCHES["paged_attention"] = 0
    for _ in range(2):
        eng.raw_step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FLEET_RAW_CALLS):
        eng.raw_step()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / FLEET_RAW_CALLS
    calls = 2 + FLEET_RAW_CALLS
    layers = model.config.num_hidden_layers
    k4 = PA.LAUNCHES["paged_attention"]
    require(k4 == layers * calls,
            f"{what}: {k4} K4 launches for {calls} calls x {layers} layers")
    moved = _metric(eng, "decode_attn_bytes_total", series=roof) - bytes0
    require(moved == calls * eng.decode_attn_bytes_per_step,
            f"{what}: decode_attn_bytes_total moved {moved}")
    eng.run()
    got = [list(r.tokens) for r in reqs]
    require(got == ref, f"{what}: streams differ from the run without "
            f"raw steps")
    bound = len(eng.decode_widths) + len(eng.verify_widths)
    require(eng.num_compiles == eng.num_graphs <= bound
            and _metric(eng, "compile_events_total") == eng.num_compiles,
            f"{what}: num_compiles {eng.num_compiles}, graphs "
            f"{eng.num_graphs}, bound {bound}")
    peak = peak_hbm_bw(torch.cuda.get_device_name(0))
    pb, kp = eng.param_bytes(), eng.kv_pool_bytes()
    attn = eng.decode_attn_bytes_per_step
    report = {
        "drill": "e_raw_step", "weight_dtype": weight_dtype or "bfloat16",
        "width": eng.max_slots, "slots_decoding": active,
        "steps_before": steps, "calls_timed": FLEET_RAW_CALLS,
        "raw_step_ms": ms, "timing": "CUDA events around the calls",
        "param_bytes": pb, "kv_pool_bytes": kp,
        "kv_pool_bytes_per_chip": eng.kv_pool_bytes_per_chip(),
        "decode_attn_bytes_per_step": attn,
        "param_and_pool_bytes_per_s": (pb + kp) / (ms / 1e3),
        "param_and_pool_share_of_peak": (pb + kp) / (ms / 1e3) / peak,
        "attn_bytes_per_s": attn / (ms / 1e3),
        "attn_share_of_peak": attn / (ms / 1e3) / peak,
        "peak_hbm_bytes_per_s": peak,
        "roofline_gauge": _metric(eng, "decode_attn_roofline_util",
                                  series=roof),
        "num_compiles": eng.num_compiles, "num_compiles_bound": bound,
        "k4_launches": k4, "streams_equal_without_raw_steps": True}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return report


def phase_serve_fleet(torch, model, serve_streams, serve_tps,
                      int8w_streams):
    """The fleet substrate on one card (llama3-8b, all 32 layers, bf16,
    the serve shape): a TCPStore master with a WAL under a temp dir,
    two replicas of one LocalFleet (each booted, its graphs captured,
    before either takes traffic; lease ttl FLEET_TTL).  (a) both leases
    live at generation 1; the serve mix half to each replica, streams
    equal the serve phase's; (b) replica 1's generation fenced: its
    heartbeat stops and never makes it live; a new lease under its name
    is live at once at generation 2; (c) the store crashes once the mix
    is in flight, stays down longer than a ttl and restarts: every key
    recovered from the WAL, both leases graced, nobody fenced, the
    streams equal (a)'s; (d) fleet series and a burn-rate alert
    (`_fleet_alerts`); (e) `raw_step` at full width with bf16 and int8
    weights (`_raw_step_run`).  Heartbeat RPC ms, WAL ms per append
    (fsync off / on), store recovery ms.  Returns K4's launches by
    drill and (a)'s report."""
    import tempfile
    import numpy as np
    from paddle_tpu_torch.distributed import TCPStore
    from paddle_tpu_torch.inference import LocalFleet, ReplicaLease
    from paddle_tpu_torch.inference import fleet_serving as FS
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab_size, L)
               for L in SERVE_LENGTHS]
    launches = {}
    with tempfile.TemporaryDirectory(prefix="serve-fleet-") as d:
        wal = _wal_append_ms(Path(d))
        store = TCPStore("127.0.0.1", 0, is_master=True,
                         durable_dir=str(Path(d) / "store"))
        beats = _time_heartbeats(store)
        fleet = None
        try:
            t_boot = time.perf_counter()
            fleet = LocalFleet(model, 2, store=store, job_id=FLEET_JOB,
                               lease_ttl=FLEET_TTL,
                               series_interval=FLEET_SERIES_S,
                               series_tiers=FLEET_SERIES_TIERS,
                               watchdog_deadline=None, slo_targets=FLEET_SLO,
                               **SERVE_KW)
            boot_s = time.perf_counter() - t_boot
            names = [r.name for r in fleet.replicas]
            for r in fleet.replicas:
                e = r.server.engine
                require(e._graphs is not None and e.overlap
                        and e.decode_kernel == "cuda"
                        and e.num_graphs == len(e.decode_widths),
                        f"serve_fleet: {r.name} not booted on the card's "
                        f"path")
            # (a) membership and traffic
            live = fleet.live()
            require(sorted(live) == names
                    and all(v[2] == 1 for v in live.values()),
                    f"serve_fleet (a): live {live}")
            a_streams, a = _fleet_mix(torch, fleet, prompts, SERVE_NEW,
                                      "serve_fleet (a)")
            require(a_streams == serve_streams, "serve_fleet (a): streams "
                    "differ from the serve phase's single engine")
            launches["a membership"] = a["k4_launches"]
            emit({"phase": "serve_fleet", "model": "llama3-8b",
                  "drill": "a_membership", "replicas": names,
                  "generations": {n: v[2] for n, v in live.items()},
                  "boot_s": boot_s, **a,
                  "single_engine_tokens_per_s": serve_tps,
                  "streams_equal_single_engine": True})
            # (b) fence and re-register
            rep1 = fleet.replicas[1]
            gen1 = rep1.lease.generation
            lkey = f"fleet/{FLEET_JOB}/replica/{rep1.name}"
            require(FS.fence_replica(store, FLEET_JOB, rep1.name, gen1)
                    == gen1, "serve_fleet (b): fence")
            stamp = store.get(lkey)
            _bounded(lambda: not rep1.lease._thread.is_alive(),
                     "serve_fleet (b): the fenced heartbeat to stop",
                     timeout=10 * rep1.lease.interval + 30)
            require(rep1.name not in fleet.live()
                    and tuple(store.get(lkey)) == tuple(stamp),
                    "serve_fleet (b): a fenced generation beat again")
            again = ReplicaLease(store, FLEET_JOB, rep1.name, ttl=FLEET_TTL)
            gen2 = again.register()
            live = fleet.live()
            require(gen2 == gen1 + 1 and live.get(rep1.name, (0,) * 3)[2]
                    == gen2, f"serve_fleet (b): re-registered at {gen2}, "
                    f"live {live}")
            rep1.lease = again          # released by fleet.shutdown()
            emit({"phase": "serve_fleet", "drill": "b_fence",
                  "fenced_generation": gen1, "reregistered_generation": gen2,
                  "live_after": {n: v[2] for n, v in live.items()}})
            # (c) store crash and restart during traffic
            keys = store.list_keys()
            crash = {}

            def outage():
                crash["t"] = time.perf_counter()
                store.crash()
                time.sleep(FLEET_TTL + 0.5)     # longer than one ttl
                t = time.perf_counter()
                crash["rec"] = store.restart()
                crash["end"] = time.perf_counter()
                crash["restart_ms"] = 1e3 * (crash["end"] - t)

            c_streams, c = _fleet_mix(torch, fleet, prompts, SERVE_NEW,
                                      "serve_fleet (c)", during=outage)
            rec = crash["rec"]
            require(c_streams == a_streams, "serve_fleet (c): streams "
                    "differ from (a)'s")
            require(rec["keys"] == len(keys)
                    and set(store.list_keys()) == set(keys),
                    f"serve_fleet (c): {rec['keys']} keys recovered of "
                    f"{len(keys)}")
            require(rec["graced_leases"] == 2 and rec["outage_s"] > FLEET_TTL,
                    f"serve_fleet (c): recovery {rec}")
            fences = {n: FS.fenced_generation(store, FLEET_JOB, n)
                      for n in names}
            require(fences == {names[0]: 0, names[1]: gen1},
                    f"serve_fleet (c): fences {fences}")
            _bounded(lambda: sorted(fleet.live()) == names,
                     "serve_fleet (c): both leases live after the restart",
                     timeout=10 * rep1.lease.interval + 30)
            launches["c store crash"] = c["k4_launches"]
            ok = [ms for t, e, ms in beats
                  if e < crash["t"] or t > crash["end"]]
            emit({"phase": "serve_fleet", "drill": "c_store_crash", **c,
                  "streams_equal_a": True, "outage_s": rec["outage_s"],
                  "store_recovery_ms": crash["restart_ms"],
                  "keys_recovered": rec["keys"],
                  "wal_records_replayed": rec["wal_records"],
                  "snapshot": rec["snapshot"],
                  "leases_graced": rec["graced_leases"],
                  "fences_after": fences,
                  "heartbeat_rpc_ms": {
                      "p50": _percentile(ok, 50), "p99": _percentile(ok, 99),
                      "n": len(ok), "interval_ms": 1e3 * rep1.lease.interval,
                      "outside_the_outage": True}})
            # (d) fleet series and burn-rate alerts
            prng = np.random.default_rng(3)
            press = [prng.integers(0, model.config.vocab_size, L)
                     for L in PRESSURE_LENGTHS]
            report = _fleet_alerts(torch, fleet, press)
            launches["d series and alerts"] = report["k4_launches"]
            emit({"phase": "serve_fleet", **report})
        finally:
            if fleet is not None:
                fleet.shutdown()
                for r in fleet.replicas:
                    require(not r.server._thread.is_alive(),
                            f"serve_fleet: {r.name}'s driver still runs")
                    _unhook(torch, r.server.engine)
            store.close()
    emit({"phase": "serve_fleet", "wal_append_ms": wal,
          "heartbeat_rpc_ms_all": {"p50": _percentile([b[2] for b in beats],
                                                      50),
                                   "p99": _percentile([b[2] for b in beats],
                                                      99),
                                   "n": len(beats)}})
    # (e) item 3 on the card
    for wd, ref in ((None, serve_streams), ("int8", int8w_streams)):
        report = _raw_step_run(torch, model, wd, prompts, ref)
        launches[f"e raw_step {report['weight_dtype']} weights"] = \
            report["k4_launches"]
        emit({"phase": "serve_fleet", "model": "llama3-8b", **report})
    emit({"phase": "serve_fleet", "seconds": time.perf_counter() - t0})
    return launches, a


ROUTER_JOB = "serve-router"
ROUTER_POLL_S = 0.25          # every router's health-poll interval
ROUTER_CRASH_STEP = 16        # (e): replica 0 dies at its 16th real step
ROUTER_EPOCH = 5              # (f): the leadership epoch the router carries
ROUTER_DRAIN = (1000, 96)     # (c): two prompts of 1000 tokens, 96 new each
# (c): the least pool one max_len sequence allows: the two sequences
# outgrow it at 1024 tokens each, and the second (priority -1) parks
ROUTER_DRAIN_BLOCKS = 1 + SERVE_KW["max_len"] // SERVE_KW["kv_block_tokens"]


def _rv(router, name):
    return router.metrics()[f"router_{name}"]["series"][""]["value"]


def _router_counts(router, names):
    return {n: _rv(router, n) for n in names}


def _router_mix(torch, router, prompts, new, what, servers, itl_from=0):
    """`prompts` through `router.submit`, every result; K4 held to
    layers x the replays of `servers`.  ITL over each stream's intervals
    from token `itl_from` on.  Returns (streams, report)."""
    from paddle_tpu_torch.ops import paged_attention as PA
    torch.cuda.synchronize()
    PA.LAUNCHES["paged_attention"] = 0
    since = _total_replays(*servers)
    stamps = {}
    t0 = time.perf_counter()
    reqs = [router.submit(p, new, on_token=_stamped(stamps, i))
            for i, p in enumerate(prompts)]
    for r in reqs:
        r.result(timeout=SLO_WAIT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _k4_servers(torch, what, since, *servers)
    for r in reqs:
        require(r.done and r.error is None and len(r.tokens) == new,
                f"{what}: request {r.rid}: {len(r.tokens)} tokens, "
                f"{r.error!r}")
    ttft = [stamps[i][0] - t0 for i in range(len(reqs))]
    itl = [b - a for ts in stamps.values()
           for a, b in zip(ts[itl_from:], ts[itl_from + 1:])]
    return [list(r.tokens) for r in reqs], {
        "requests": len(reqs), "wall_s": wall,
        "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall,
        "ttft_p50_ms": 1e3 * _percentile(ttft, 50),
        "itl_p50_ms": 1e3 * _percentile(itl, 50),
        "itl_p99_ms": 1e3 * _percentile(itl, 99),
        "placed": {n: sum(r.replica == n for r in reqs)
                   for n in sorted({r.replica for r in reqs})},
        "k4_launches": launches}


def _time_router(router, replicas):
    """Host-clock wrappers (instance attributes) on `router.submit`, on
    each replica's `submit` (matched by the trace id the router passes
    in every request's params) and on the journal's `record` ("tok"
    appends).  Returns (entry times by trace id, dispatch times by
    trace id, tok append ms, each replica `submit` call's ms, a function
    that takes the wrappers off)."""
    t_in, t_out, tok_ms, call_ms = {}, {}, [], []
    submit, journal = router.submit, router._journal
    record = journal.record

    def timed_submit(*a, **k):
        t = time.perf_counter()
        rr = submit(*a, **k)
        t_in[rr.trace_id] = t
        return rr

    def timed_record(ev, rid, **f):
        if ev != "tok":
            return record(ev, rid, **f)
        t = time.perf_counter()
        try:
            return record(ev, rid, **f)
        finally:
            tok_ms.append(1e3 * (time.perf_counter() - t))

    def replica_submit(fn):
        def timed(prompt, new=16, **k):
            t = time.perf_counter()
            t_out.setdefault(k.get("trace_id"), t)
            try:
                return fn(prompt, new, **k)
            finally:
                call_ms.append(1e3 * (time.perf_counter() - t))
        return timed

    router.submit = timed_submit
    journal.record = timed_record
    for rep in replicas:
        rep.submit = replica_submit(rep.submit)

    def undo():
        vars(router).pop("submit", None)
        vars(journal).pop("record", None)
        for rep in replicas:
            vars(rep).pop("submit", None)
    return t_in, t_out, tok_ms, call_ms, undo


def _idle(servers, what):
    _bounded(lambda: all(not s.engine.has_work for s in servers
                         if s.healthy), f"{what}: the replicas idle")


def _drop_replica(torch, rep, what):
    """A dead or poisoned replica off the card before any later capture:
    its server shut down, the cyclic GC run, the stream drained."""
    rep.server.shutdown(timeout=60)
    require(not rep.server._thread.is_alive(),
            f"{what}: {rep.name}'s driver still runs")
    _unhook(torch, rep.server.engine)
    torch.cuda.synchronize()


def _router_prefix(torch, fleet, prompts, ref):
    """(b) serve_prefix's stream (request 0 alone, then the other 15 at
    once) through a Router under `affinity`, then `round_robin`, on the
    same two replicas with radix caches, tries cleared before each run.
    Streams equal serve_prefix's cached run under both; affinity has at
    least as many trie hits.  TTFT and ITL are the 15's; K4 counts all
    16."""
    from paddle_tpu_torch.inference import Router
    servers = [r.server for r in fleet.replicas]
    out = {}
    for policy in ("affinity", "round_robin"):
        for s in servers:
            eng = s.engine
            s._fabric_exec(lambda eng=eng: eng._reclaim_cache(1 << 30))
            require(eng._pcache.blocks_used == 0,
                    f"serve_router (b): {s.name}'s trie not cleared")

        def counts():
            return {k: sum(int(_metric(s.engine, k)) for s in servers)
                    for k in ("prefix_cache_hits_total",
                              "prefill_tokens_saved_total",
                              "prefill_tokens_saved_remote_total")}
        before = counts()
        router = Router(fleet.replicas, store=fleet.store,
                        job_id=fleet.job_id, policy=policy,
                        poll_interval=ROUTER_POLL_S)
        try:
            what = f"serve_router (b) {policy}"
            first, rep0 = _router_mix(torch, router, prompts[:1],
                                      PREFIX_NEW, what + " request 0",
                                      servers)
            rest, rep = _router_mix(torch, router, prompts[1:], PREFIX_NEW,
                                    what, servers)
            rep["k4_launches"] += rep0["k4_launches"]
            after = counts()
            got = {k: after[k] - before[k] for k in after}
            require(first + rest == ref, f"{what}: streams differ from "
                    "serve_prefix's cached run")
            out[policy] = dict(rep, **{
                "trie_hits": got["prefix_cache_hits_total"],
                "prefill_tokens_saved": got["prefill_tokens_saved_total"],
                "prefill_tokens_saved_remote":
                    got["prefill_tokens_saved_remote_total"],
                "affinity_hit_rate": _rv(router, "affinity_hit_rate"),
                "affinity_hits": _rv(router, "affinity_hits_total")})
        finally:
            router.shutdown()
        _idle(servers, "serve_router (b)")
    require(out["affinity"]["trie_hits"] >= out["round_robin"]["trie_hits"],
            f"serve_router (b): affinity {out['affinity']['trie_hits']} "
            f"trie hits < round robin's {out['round_robin']['trie_hits']}")
    return out


def phase_serve_router(torch, model, shallow, serve_streams,
                       prefix_streams, fleet_a):
    """The Router on one card (llama3-8b, bf16, graphs + overlap, the
    serve shape): the fleets of one durable TCPStore, every replica
    booted (graphs captured) before any takes traffic, the fabric's disk
    root in the run's temp dir.  Drills (a)–(g) as the module docstring
    lists them; every gate a `require`.  Returns K4's launches by drill."""
    import tempfile
    import types
    import urllib.request
    import numpy as np
    from paddle_tpu_torch.distributed import TCPStore
    from paddle_tpu_torch.inference import (LocalFleet, PoisonedRequest,
                                            Router, RoutingJournal,
                                            StaleRouterEpoch)
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.testing import faults
    t0 = time.perf_counter()
    vocab = model.config.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, L) for L in SERVE_LENGTHS]
    prng = np.random.default_rng(4)
    system = prng.integers(0, vocab, PREFIX_SYSTEM)
    pprompts = [np.concatenate([system, prng.integers(0, vocab,
                                                      PREFIX_SUFFIX)])
                for _ in range(PREFIX_N)]
    drng = np.random.default_rng(7)
    dprompts = [drng.integers(0, vocab, ROUTER_DRAIN[0]) for _ in range(2)]
    launches, seconds = {}, {}
    routers, fleets = [], []

    def router(reps, **kw):
        r = Router(reps, store=store, job_id=ROUTER_JOB,
                   poll_interval=ROUTER_POLL_S, **kw)
        routers.append(r)
        return r

    with tempfile.TemporaryDirectory(prefix="serve-router-") as d:
        root = Path(d)
        store = TCPStore("127.0.0.1", 0, is_master=True,
                         durable_dir=str(root / "store"))
        common = dict(store=store, job_id=ROUTER_JOB, lease_ttl=FLEET_TTL,
                      watchdog_deadline=None)
        disk = {"timeout": FABRIC_TIMEOUT, "disk_root": str(root / "disk")}
        peers = {"timeout": FABRIC_TIMEOUT}
        try:
            t = time.perf_counter()
            A = LocalFleet(model, 2, series_interval=FLEET_SERIES_S,
                           series_tiers=FLEET_SERIES_TIERS, fabric=disk,
                           **common, **SERVE_KW)
            fleets.append(A)
            B = LocalFleet(model, 2, name_prefix="prefix",
                           series_interval=None, fabric=peers, **common,
                           **SERVE_KW, **PREFIX_KW)
            fleets.append(B)
            C = LocalFleet(model, 1, name_prefix="tight",
                           series_interval=None, fabric=disk,
                           kv_blocks=ROUTER_DRAIN_BLOCKS,
                           preempt_policy="swap", **common, **SERVE_KW)
            fleets.append(C)
            G = LocalFleet(shallow, 2, name_prefix="pool",
                           roles=("prefill", "decode"), series_interval=None,
                           fabric=peers, **common, **SERVE_KW)
            fleets.append(G)
            boot_s = time.perf_counter() - t
            for f in fleets:
                for r in f.replicas:
                    e = r.server.engine
                    require(e._graphs is not None and e.overlap
                            and e.decode_kernel == "cuda"
                            and e.num_graphs == len(e.decode_widths)
                            and r.fabric_address is not None,
                            f"serve_router: {r.name} not booted on the "
                            f"card's path")
            a0, a1 = A.replicas
            sa = [a0.server, a1.server]
            j1 = str(root / "router-1.jsonl")

            # (a) parity and overhead
            t = time.perf_counter()
            r1 = router(A.replicas, journal_path=j1, policy="affinity",
                        debug_port=0)
            t_in, t_out, tok_ms, _, undo = _time_router(r1, A.replicas)
            a_streams, a = _router_mix(torch, r1, prompts, SERVE_NEW,
                                       "serve_router (a)", sa)
            undo()
            require(a_streams == serve_streams, "serve_router (a): streams "
                    "differ from the serve phase's single engine")
            dispatch_ms = [1e3 * (t_out[tid] - t_in[tid]) for tid in t_in]
            require(len(dispatch_ms) == len(prompts)
                    and len(tok_ms) == len(prompts) * SERVE_NEW,
                    f"serve_router (a): {len(dispatch_ms)} dispatches, "
                    f"{len(tok_ms)} tok appends timed")
            c = _router_counts(r1, ("requests_routed_total",
                                    "failovers_total",
                                    "tokens_delivered_total"))
            require(c == {"requests_routed_total": len(prompts),
                          "failovers_total": 0,
                          "tokens_delivered_total": len(prompts) * SERVE_NEW}
                    and not RoutingJournal.incomplete(j1),
                    f"serve_router (a): counters {c}")
            sig = r1.autoscale_signal()
            host, port = r1.debug_address
            with urllib.request.urlopen(f"http://{host}:{port}/debug/fleet",
                                        timeout=30) as resp:
                doc = json.loads(resp.read().decode())
            require(sorted(doc["replicas"]) == ["replica0", "replica1"]
                    and doc["queue_depth"] == 0,
                    f"serve_router (a): /debug/fleet {sorted(doc)}")
            launches["a routed mix"] = a["k4_launches"]
            seconds["a"] = time.perf_counter() - t
            emit({"phase": "serve_router", "model": "llama3-8b",
                  "drill": "a_parity", "boot_s": boot_s,
                  "replicas": {f.replicas[0].name[:-1]: len(f.replicas)
                               for f in fleets}, **a,
                  "streams_equal_single_engine": True,
                  "direct_replica_submit": {
                      k: fleet_a[k] for k in ("ttft_p50_ms", "itl_p50_ms",
                                              "itl_p99_ms", "tokens_per_s")},
                  "router_to_replica_submit_ms": {
                      "p50": _percentile(dispatch_ms, 50),
                      "p99": _percentile(dispatch_ms, 99),
                      "n": len(dispatch_ms)},
                  "journal_tok_append_ms": {
                      "p50": _percentile(tok_ms, 50),
                      "p99": _percentile(tok_ms, 99), "n": len(tok_ms)},
                  "autoscale_signal": sig,
                  "debug_fleet_keys": sorted(doc)})

            # (b) placement by prefix
            t = time.perf_counter()
            b = _router_prefix(torch, B, pprompts, prefix_streams)
            launches["b affinity"] = b["affinity"]["k4_launches"]
            launches["b round_robin"] = b["round_robin"]["k4_launches"]
            seconds["b"] = time.perf_counter() - t
            emit({"phase": "serve_router", "drill": "b_prefix", **b,
                  "streams_equal_serve_prefix": True})

            # (c) drain migration
            t = time.perf_counter()
            c0 = C.replicas[0]
            sc = [c0.server, a1.server]
            undisturbed = [a1.submit(p, ROUTER_DRAIN[1]) for p in dprompts]
            ref_c = [list(a1.server.result(q, timeout=SLO_WAIT_S))
                     for q in undisturbed]
            eng_c = c0.server.engine
            _freeze_at_park(eng_c, "swap")
            fab0 = _fab_counts(a1.server)
            adopt, adopt_s = a1.adopt, []

            def timed_adopt(*args, **kw):
                t1 = time.perf_counter()
                try:
                    return adopt(*args, **kw)
                finally:
                    adopt_s.append(time.perf_counter() - t1)
            a1.adopt = timed_adopt
            rc = router([c0], journal_path=str(root / "router-c.jsonl"))
            torch.cuda.synchronize()
            PA.LAUNCHES["paged_attention"] = 0
            since = _total_replays(*sc)
            q1 = rc.submit(dprompts[0], ROUTER_DRAIN[1])
            q2 = rc.submit(dprompts[1], ROUTER_DRAIN[1], priority=-1)
            _bounded(lambda: eng_c.freeze_parked and eng_c.num_parked == 1,
                     "serve_router (c): the park on the tight replica")
            rc.add_replica(a1)
            td = time.perf_counter()
            clean = rc.drain(c0.name, timeout=SLO_WAIT_S)
            drain_s = time.perf_counter() - td
            got = [q.result(timeout=SLO_WAIT_S) for q in (q1, q2)]
            torch.cuda.synchronize()
            del a1.adopt
            launches["c drain migration"] = _k4_servers(
                torch, "serve_router (c)", since, *sc)
            fab1 = _fab_counts(a1.server)
            blocks = (fab1["blocks_moved"]["migrate"]
                      - fab0["blocks_moved"]["migrate"])
            mb = 1e-6 * (fab1["bytes_moved"]["migrate"]
                         - fab0["bytes_moved"]["migrate"])
            cc = _router_counts(rc, ("migrations_total",
                                     "requests_replayed_total",
                                     "failovers_total",
                                     "replay_mismatch_total",
                                     "replicas_drained_total"))
            require(clean and got == ref_c and q2.replica == a1.name
                    and q1.replica == c0.name,
                    f"serve_router (c): clean {clean}, streams equal "
                    f"{got == ref_c}, placed {q1.replica} / {q2.replica}")
            require(cc["migrations_total"] >= 1 and blocks > 0
                    and cc["requests_replayed_total"] == 0
                    and cc["failovers_total"] == 0
                    and cc["replay_mismatch_total"] == 0,
                    f"serve_router (c): counters {cc}")
            rc.shutdown()
            _unhook(torch, eng_c)
            seconds["c"] = time.perf_counter() - t
            emit({"phase": "serve_router", "drill": "c_drain",
                  "prompt_tokens": ROUTER_DRAIN[0],
                  "new_tokens": ROUTER_DRAIN[1],
                  "kv_blocks": ROUTER_DRAIN_BLOCKS, **cc,
                  "drain_s": drain_s, "blocks_migrated": blocks,
                  "mb_migrated": mb,
                  # the refused take of the active stream, then the
                  # parked session's
                  "adopt_calls_s": adopt_s,
                  "streams_equal_undisturbed": True,
                  "k4_launches": launches["c drain migration"]})

            # (d) router restart
            t = time.perf_counter()
            _idle(sa, "serve_router (d)")
            torch.cuda.synchronize()
            PA.LAUNCHES["paged_attention"] = 0
            since = _total_replays(*sa)
            reqs1 = [r1.submit(p, SERVE_NEW) for p in prompts]
            _bounded(lambda: any(len(r.tokens) >= 4 for r in reqs1),
                     "serve_router (d): a stream 4 tokens deep")
            r1.shutdown()
            delivered = {tuple(p.tolist()): list(r.tokens)
                         for p, r in zip(prompts, reqs1)}
            inc = RoutingJournal.incomplete(j1)
            by_prompt = {tuple(p.tolist()): s
                         for p, s in zip(prompts, a_streams)}
            require(all(r.error is not None for r in reqs1 if r.done
                        and len(r.tokens) < SERVE_NEW)
                    and all(tuple(st["prompt"]) in by_prompt
                            for st in inc.values()),
                    "serve_router (d): the journal after the kill")
            r2 = router(A.replicas, journal_path=str(root / "router-2.jsonl"),
                        policy="affinity")
            tr = time.perf_counter()
            recovered = r2.resubmit_incomplete(j1)
            resubmit_ms = 1e3 * (time.perf_counter() - tr)
            pre_seeded = 0
            for old, rr in recovered.items():
                key = tuple(rr.prompt.tolist())
                require(rr.result(timeout=SLO_WAIT_S) == by_prompt[key]
                        and inc[old]["delivered"] == delivered[key],
                        f"serve_router (d): {old}'s stream after the "
                        f"restart")
                pre_seeded += len(inc[old]["delivered"])
            recover_s = time.perf_counter() - tr
            done_before = [k for k in delivered if k not in
                           {tuple(st["prompt"]) for st in inc.values()}]
            require(all(delivered[k] == by_prompt[k] for k in done_before),
                    "serve_router (d): a stream finished before the kill "
                    "differs")
            torch.cuda.synchronize()
            launches["d router restart"] = _k4_servers(
                torch, "serve_router (d)", since, *sa)
            dc = _router_counts(r2, ("tokens_deduped_total",
                                     "replay_mismatch_total",
                                     "tokens_delivered_total",
                                     "requests_resubmitted_total"))
            require(pre_seeded > 0 and recovered
                    and dc["tokens_deduped_total"] == pre_seeded
                    and dc["replay_mismatch_total"] == 0
                    and dc["requests_resubmitted_total"] == len(recovered)
                    and dc["tokens_delivered_total"] == sum(
                        len(rr.tokens) for rr in recovered.values())
                    - pre_seeded
                    and not RoutingJournal.incomplete(r2.journal_path),
                    f"serve_router (d): counters {dc}, pre-seeded "
                    f"{pre_seeded}")
            seconds["d"] = time.perf_counter() - t
            emit({"phase": "serve_router", "drill": "d_restart",
                  "requests_resubmitted": len(recovered),
                  "finished_before_the_kill": len(done_before),
                  "delivered_before_the_kill": pre_seeded,
                  "resubmit_incomplete_ms": resubmit_ms,
                  "recovery_s": recover_s, **dc,
                  "streams_equal_a": True,
                  "k4_launches": launches["d router restart"]})

            # (e) crash failover
            t = time.perf_counter()
            _idle(sa, "serve_router (e)")
            crash, steps = {}, {"n": 0}

            def kill(ctx):
                if ctx.get("name") == a0.name:
                    steps["n"] += 1
                    if steps["n"] == ROUTER_CRASH_STEP:
                        crash["t"] = time.perf_counter()
                        return faults.InjectedFault

            names = ("failovers_total", "tokens_deduped_total",
                     "replay_mismatch_total", "migrations_total",
                     "requests_replayed_total")
            before = _router_counts(r2, names)
            faults.get_injector().clear()
            faults.get_injector().inject("replica.crash", times=None,
                                         exc=None, callback=kill)
            faults.ENABLED = True
            stamps = {}

            def stamp(i):
                def on_token(rr, tok):
                    stamps.setdefault(i, []).append(
                        (time.perf_counter(), rr.replica))
                return on_token
            try:
                torch.cuda.synchronize()
                PA.LAUNCHES["paged_attention"] = 0
                since = _total_replays(*sa)
                reqs = [r2.submit(p, SERVE_NEW, on_token=stamp(i))
                        for i, p in enumerate(prompts)]
                e_streams = [r.result(timeout=SLO_WAIT_S) for r in reqs]
            finally:
                faults.ENABLED = False
                faults.get_injector().clear()
            torch.cuda.synchronize()
            launches["e crash failover"] = _k4_servers(
                torch, "serve_router (e)", since, *sa)
            after = _router_counts(r2, names)
            ec = {k: after[k] - before[k] for k in names}
            victims = [i for i, r in enumerate(reqs) if r.attempts > 1]
            # the survivor's first token of a victim (the crashed
            # driver's commit of its step in flight delivers a few more
            # from replica 0 first)
            first_new = min(ts for i in victims for ts, rep in stamps[i]
                            if rep == a1.name and ts > crash["t"])
            require(e_streams == a_streams, "serve_router (e): streams "
                    "differ from (a)'s")
            require(ec["failovers_total"] == 1
                    and ec["tokens_deduped_total"] > 0
                    and ec["replay_mismatch_total"] == 0 and victims
                    and not a0.server.healthy
                    and r2.live_replica_names() == [a1.name],
                    f"serve_router (e): counters {ec}, victims {victims}")
            _drop_replica(torch, a0, "serve_router (e)")
            _idle([a1.server], "serve_router (e)")
            ts = time.perf_counter()
            a2 = A.spawn()
            spawn_s = time.perf_counter() - ts
            r2.add_replica(a2)
            seconds["e"] = time.perf_counter() - t
            emit({"phase": "serve_router", "drill": "e_crash",
                  "crash_step": ROUTER_CRASH_STEP, **ec,
                  "victims": len(victims),
                  "crash_to_first_new_token_s": first_new - crash["t"],
                  "respawn_s": spawn_s, "streams_equal_a": True,
                  "k4_launches": launches["e crash failover"]})

            # (f) router epochs and poison
            t = time.perf_counter()
            sf = [a1.server, a2.server]
            torch.cuda.synchronize()
            PA.LAUNCHES["paged_attention"] = 0
            since = _total_replays(*sf)
            r2.router_epoch = ROUTER_EPOCH
            er = r2.submit(prompts[0], 4)
            require(er.result(timeout=SLO_WAIT_S) == a_streams[0][:4],
                    "serve_router (f): the epoch dispatch's stream")
            target = next(r for r in (a1, a2) if r.name == er.replica)
            require(target.server._router_epoch_hw == ROUTER_EPOCH,
                    "serve_router (f): the epoch mark")
            try:
                target.submit(prompts[0], 4, router_epoch=ROUTER_EPOCH - 1)
                stale = False
            except StaleRouterEpoch:
                stale = True
            require(stale, "serve_router (f): a lower epoch accepted")
            r2.poison_threshold = 1
            before = _router_counts(r2, ("failovers_total",
                                         "poisoned_total"))
            faults.get_injector().clear()
            rule = faults.get_injector().inject("replica.poison", times=1)
            faults.ENABLED = True
            try:
                poison = r2.submit(prompts[1], SERVE_NEW,
                                   chaos_mark="serve_router drill")
                try:
                    poison.result(timeout=SLO_WAIT_S)
                    convicted = False
                except PoisonedRequest:
                    convicted = True
            finally:
                faults.ENABLED = False
                faults.get_injector().clear()
            innocents = [r2.submit(p, SERVE_NEW) for p in prompts[:4]]
            i_streams = [r.result(timeout=SLO_WAIT_S) for r in innocents]
            torch.cuda.synchronize()
            launches["f epochs and poison"] = _k4_servers(
                torch, "serve_router (f)", since, *sf)
            after = _router_counts(r2, ("failovers_total", "poisoned_total"))
            fc = {k: after[k] - before[k] for k in after}
            dead = [r for r in (a1, a2) if not r.server.healthy]
            require(convicted and rule.fired == 1
                    and fc == {"failovers_total": 1, "poisoned_total": 1}
                    and len(dead) == 1
                    and i_streams == a_streams[:4],
                    f"serve_router (f): convicted {convicted}, counters "
                    f"{fc}, dead {[r.name for r in dead]}, innocents equal "
                    f"{i_streams == a_streams[:4]}")
            _drop_replica(torch, dead[0], "serve_router (f)")
            seconds["f"] = time.perf_counter() - t
            emit({"phase": "serve_router", "drill": "f_epoch_poison",
                  "router_epoch": ROUTER_EPOCH,
                  "stale_epoch_refused": True,
                  "poison_threshold": 1, "poisoned": fc["poisoned_total"],
                  "replicas_fenced": fc["failovers_total"],
                  "poison_strikes": poison.poison_strikes,
                  "innocents_equal_single_engine": True,
                  "k4_launches": launches["f epochs and poison"]})

            # (g) placement by pool and the handoff (SHALLOW_LAYERS)
            t = time.perf_counter()
            g0, g1 = G.replicas
            sg = [g0.server, g1.server]
            colo, colo_rep = _fleet_mix(
                torch, types.SimpleNamespace(replicas=[g1]), prompts,
                SERVE_NEW, "serve_router (g) colocated")
            rg = router(G.replicas, journal_path=str(root / "router-g.jsonl"),
                        policy="affinity")
            # D's intervals: from the adopted stream's first token on
            g_streams, g = _router_mix(torch, rg, prompts, SERVE_NEW,
                                       "serve_router (g)", sg, itl_from=1)
            hc = _router_counts(rg, ("handoffs_total",
                                      "requests_replayed_total",
                                      "replay_mismatch_total"))
            require(g_streams == colo, "serve_router (g): streams differ "
                    "from the colocated run")
            require(hc["handoffs_total"] == len(prompts)
                    and hc["requests_replayed_total"] == 0
                    and hc["replay_mismatch_total"] == 0
                    and g["placed"] == {g1.name: len(prompts)},
                    f"serve_router (g): counters {hc}, placed "
                    f"{g['placed']}")
            launches[f"g pool handoff ({SHALLOW_LAYERS} layers)"] = \
                g["k4_launches"]
            seconds["g"] = time.perf_counter() - t
            emit({"phase": "serve_router", "drill": "g_pools",
                  "layers": shallow.config.num_hidden_layers, **hc,
                  "ttft_p50_ms": {"at_P": g["ttft_p50_ms"],
                                  "colocated": colo_rep["ttft_p50_ms"]},
                  "itl_ms": {"at_D_p50": g["itl_p50_ms"],
                             "at_D_p99": g["itl_p99_ms"],
                             "colocated_p50": colo_rep["itl_p50_ms"],
                             "colocated_p99": colo_rep["itl_p99_ms"]},
                  "wall_s": g["wall_s"],
                  "streams_equal_colocated": True,
                  "k4_launches": g["k4_launches"]})
        finally:
            for r in routers:
                r.shutdown()
            for f in fleets:
                f.shutdown()
                for r in f.replicas:
                    require(not r.server._thread.is_alive(),
                            f"serve_router: {r.name}'s driver still runs")
                    _unhook(torch, r.server.engine)
            store.close()
    emit({"phase": "serve_router", "drill_seconds": seconds,
          "seconds": time.perf_counter() - t0})
    return launches


PROC_JOB = "serve-process"
# the children's model: phase_serve's llama3-8b from the same seed, so
# streams equal to the serve phase's also show that every process
# holds the same weights
PROC_SPEC = {"preset": "llama3-8b", "seed": 0, "device": "cuda"}
# the children's server: the serve shape, an admission bound of one
# queue per slot pool (the serve mix never queues: (e) fills it), the
# series sampler the K4 counts are read from (240 s of tier 0)
PROC_KW = dict(SERVE_KW, max_queue=SERVE_KW["max_slots"],
               watchdog_deadline=None, series_interval=FLEET_SERIES_S,
               series_tiers=((FLEET_SERIES_S, 960), (5.0, 120)))
PROC_TTL = 5.0                # s: replica leases (tools/ci_ha_rung.py:64)
PROC_LEADER_TTL = 1.5         # s: the primary's lease (ci_ha_rung.py:79)
PROC_WATCH_S = 0.2            # s: the standby's lease watch (ci_ha_rung.py)
PROC_PROMOTE_BOUND_S = 15.0   # crash -> promoted (ci_ha_rung.py:37's bound)
PROC_BURST = 3 * SERVE_KW["max_slots"]   # (e): slots + queue + 8 more
PROC_WAIT_S = 300.0           # every bounded wait on a child


def _free_gb(torch):
    """The card's free memory (GB), as the driver reports it: the
    children's allocations included."""
    return torch.cuda.mem_get_info()[0] / 1e9


def _child_counts(rep, what):
    """(decode steps, decode-attention bytes, the bytes' series key) a
    replica process has run since it booted, read from what the child
    reports over the control wire: its `metrics_series` tails (each
    counter a rate per tier-0 sample; rate x the sample interval,
    summed).  The tail must start idle (a zero rate) and the ring must
    not have wrapped, or the sum misses steps."""
    cap = PROC_KW["series_tiers"][0][1]
    series = rep.metrics_series(n=cap, timeout=60)["series"]
    attn = [k for k in series
            if k.startswith("llm_engine_decode_attn_bytes_total{")]
    require(len(attn) == 1, f"{what}: {rep.name}'s attention series {attn}")

    def total(key):
        pts = series[key]
        require(1 < len(pts) < cap and pts[0][1] == 0.0,
                f"{what}: {rep.name}'s {key} tail ({len(pts)} points) "
                f"does not reach back to its idle boot")
        return round(sum(v * (t - t0) for (t0, _), (t, v)
                         in zip(pts, pts[1:])))
    return total("llm_engine_decode_steps_total"), total(attn[0]), attn[0]


def _series_armed(reps, what):
    """Wait (bounded) until each replica process's series sampler holds
    two idle points of its step counter: the rates `_child_counts` sums
    start before the child's first step."""
    def armed(rep):
        pts = rep.metrics_series(n=4, timeout=60)["series"].get(
            "llm_engine_decode_steps_total", [])
        return len(pts) >= 2 and pts[0][1] == 0.0
    _bounded(lambda: all(armed(r) for r in reps),
             f"{what}: the children's series samplers", timeout=PROC_WAIT_S)


def _k4_children(reps, layers, what):
    """K4's launches in each replica process: layers x its decode steps
    (every decode step on the card is a graph replay with one K4 launch
    a layer), once every series has sampled its last step (two equal
    reads two samples apart).  The attention bytes must carry K4's
    label (kernel=cuda) and equal steps x one step's bytes (8 slots x
    128 blocks x the hello's block bytes).  Returns {name: launches}."""
    prev, deadline = None, time.monotonic() + 60
    while True:
        now = [_child_counts(r, what) for r in reps]
        if now == prev:
            break
        require(time.monotonic() < deadline,
                f"{what}: the children's series never settled")
        prev = now
        time.sleep(2 * FLEET_SERIES_S)
    out = {}
    for rep, (steps, nbytes, key) in zip(reps, now):
        per_step = (SERVE_KW["max_slots"] * PROC_KW["max_len"]
                    // PROC_KW["kv_block_tokens"]
                    * rep.kv_block_bytes_per_chip)
        require(steps > 0 and "kernel=cuda" in key
                and nbytes == steps * per_step,
                f"{what}: {rep.name}: {steps} decode steps, {nbytes} "
                f"attention bytes ({key}), {per_step} a step")
        out[rep.name] = layers * steps
    return out


def _proc_mix(router, prompts, new, what):
    """`prompts` through `router.submit`, every result; per-token host
    stamps.  Returns (streams, report)."""
    stamps = {}
    t0 = time.perf_counter()
    reqs = [router.submit(p, new, on_token=_stamped(stamps, i))
            for i, p in enumerate(prompts)]
    for r in reqs:
        r.result(timeout=PROC_WAIT_S)
    wall = time.perf_counter() - t0
    for r in reqs:
        require(r.done and r.error is None and len(r.tokens) == new,
                f"{what}: request {r.rid}: {len(r.tokens)} tokens, "
                f"{r.error!r}")
    ttft = [stamps[i][0] - t0 for i in range(len(reqs))]
    itl = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
    return [list(r.tokens) for r in reqs], {
        "requests": len(reqs), "t0": t0, "t1": t0 + wall, "wall_s": wall,
        "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall,
        "ttft_p50_ms": 1e3 * _percentile(ttft, 50),
        "itl_p50_ms": 1e3 * _percentile(itl, 50),
        "itl_p99_ms": 1e3 * _percentile(itl, 99),
        "placed": {n: sum(r.replica == n for r in reqs)
                   for n in sorted({r.replica for r in reqs})}}


def _mem_back(torch, floor_gb, what):
    """Wait (bounded) until the card's free memory is back to
    `floor_gb`: a killed or shut down process returns its memory
    asynchronously.  Returns the seconds waited."""
    t = time.perf_counter()
    _bounded(lambda: _free_gb(torch) >= floor_gb,
             f"{what}: free memory back to {floor_gb:.1f} GB",
             timeout=PROC_WAIT_S)
    return time.perf_counter() - t


def phase_serve_process(torch, serve_streams, serve_tps):
    """Replica processes on one card (llama3-8b bf16, all 32 layers, the
    serve shape): ProcessFleet children each build the model from
    PROC_SPEC, capture their graphs and serve; the Router and the HA
    routers run in this process, which holds no model.  Drills (a)–(e)
    as the module docstring lists them; every gate a `require`.  Returns
    K4's launches inside the children by drill."""
    import tempfile
    import threading
    import numpy as np
    from paddle_tpu_torch.inference import (FleetClient, HARouter,
                                            ProcessFleet, QueueFull, Router,
                                            StaleRouterEpoch, StandbyRouter)
    from paddle_tpu_torch.inference.fleet_serving import (
        ROUTER_LEADER, _lease_key, fenced_generation, live_replicas)
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.ops import _build
    t_phase = time.perf_counter()
    # the serve phase's model and engines are garbage by now; a cycle
    # among them would keep 16 GB of weights on the card
    gc.collect()
    torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_reserved() / 1e9
    cfg = LlamaConfig.from_preset(PROC_SPEC["preset"])
    layers = cfg.num_hidden_layers
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, L) for L in SERVE_LENGTHS]
    libs = sorted(p.name for p in _build.BUILD_DIR.iterdir())
    launches, seconds = {}, {}
    fleets, routers, standbys = [], [], []
    with tempfile.TemporaryDirectory(prefix="serve-process-") as d:
        root = Path(d)
        try:
            # (a) two replica processes behind a Router
            t = time.perf_counter()
            mem = [_free_gb(torch)]
            fleet = ProcessFleet(PROC_SPEC, n=0, job_id=PROC_JOB,
                                 lease_ttl=PROC_TTL,
                                 store_dir=str(root / "store"), **PROC_KW)
            fleets.append(fleet)
            spawn_s = []
            for _ in range(2):
                ts = time.perf_counter()
                fleet.spawn()
                spawn_s.append(time.perf_counter() - ts)
                mem.append(_free_gb(torch))
            p0, p1 = fleet.replicas
            child_gb = [mem[0] - mem[1], mem[1] - mem[2]]
            require(all(r.proc.is_alive() and r.tp == 1 and r.aot is None
                        and r.lease.generation == 1 for r in fleet.replicas)
                    and min(child_gb) > 16.0,
                    f"serve_process (a): children {fleet.live()}, "
                    f"card memory each {child_gb} GB")
            router = Router(fleet.replicas, store=fleet.store,
                            job_id=PROC_JOB, poll_interval=ROUTER_POLL_S,
                            journal_path=str(root / "router.jsonl"))
            routers.append(router)
            _series_armed(fleet.replicas, "serve_process (a)")
            t_in, t_out, tok_ms, call_ms, undo = _time_router(
                router, fleet.replicas)
            a_streams, a = _proc_mix(router, prompts, SERVE_NEW,
                                     "serve_process (a)")
            undo()
            require(a_streams == serve_streams, "serve_process (a): streams "
                    "differ from the serve phase's single engine")
            dispatch_ms = [1e3 * (t_out[tid] - t_in[tid]) for tid in t_in]
            require(len(dispatch_ms) == len(prompts)
                    and len(tok_ms) == len(prompts) * SERVE_NEW,
                    f"serve_process (a): {len(dispatch_ms)} dispatches, "
                    f"{len(tok_ms)} tok appends timed")
            k4_a = _k4_children(fleet.replicas, layers, "serve_process (a)")
            launches["a two processes"] = sum(k4_a.values())
            seconds["a"] = time.perf_counter() - t
            emit({"phase": "serve_process", "model": PROC_SPEC["preset"],
                  "drill": "a_two_processes", "layers": layers,
                  "spawn_s": spawn_s,
                  "boot_s": [r.boot_s for r in fleet.replicas],
                  "parent_reserved_gb": parent_gb,
                  "free_gb_before_after_each_boot": mem,
                  "card_gb_per_child": child_gb,
                  **{k: v for k, v in a.items() if k not in ("t0", "t1")},
                  "one_engine_tokens_per_s": serve_tps,
                  "tokens_per_s_vs_one_engine": a["tokens_per_s"] / serve_tps,
                  "streams_equal_single_engine": True,
                  "router_to_replica_submit_ms": {
                      "p50": _percentile(dispatch_ms, 50),
                      "p99": _percentile(dispatch_ms, 99),
                      "n": len(dispatch_ms)},
                  # one ProcessReplica.submit: the op out, the child's
                  # LLMServer.submit, its ack back (the dispatcher
                  # waits for each before the next request)
                  "replica_submit_call_ms": {
                      "p50": _percentile(call_ms, 50),
                      "p99": _percentile(call_ms, 99), "n": len(call_ms)},
                  "journal_tok_append_ms": {
                      "p50": _percentile(tok_ms, 50),
                      "p99": _percentile(tok_ms, 99), "n": len(tok_ms)},
                  "k4_launches_per_child": k4_a})

            # (b) SIGKILL mid-decode
            t = time.perf_counter()
            names = ("failovers_total", "tokens_deduped_total",
                     "replay_mismatch_total", "requests_replayed_total")
            before = _router_counts(router, names)
            stamps = {}

            def stamp(i):
                def on_token(rr, tok):
                    stamps.setdefault(i, []).append(
                        (time.perf_counter(), rr.replica))
                return on_token
            reqs = [router.submit(p, SERVE_NEW, on_token=stamp(i))
                    for i, p in enumerate(prompts)]
            _bounded(lambda: any(r.replica == p0.name and len(r.tokens) >= 4
                                 for r in reqs),
                     "serve_process (b): a stream 4 tokens deep on "
                     f"{p0.name}", timeout=PROC_WAIT_S)
            free_b = _free_gb(torch)
            key = _lease_key(PROC_JOB, p0.name)
            tk, wall_k = time.perf_counter(), time.time()
            fleet.kill(p0.name)
            require(not p0.proc.is_alive(), "serve_process (b): the child "
                    "survived SIGKILL")
            b_streams = [r.result(timeout=PROC_WAIT_S) for r in reqs]
            require(b_streams == serve_streams, "serve_process (b): streams "
                    "differ from the serve phase's")
            after = _router_counts(router, names)
            bc = {k: after[k] - before[k] for k in names}
            victims = [i for i, r in enumerate(reqs) if r.attempts > 1]
            first_new = min(ts for i in victims for ts, rep in stamps[i]
                            if rep == p1.name and ts > tk)
            require(bc["failovers_total"] == 1 and victims
                    and bc["tokens_deduped_total"] > 0
                    and bc["replay_mismatch_total"] == 0
                    and router.live_replica_names() == [p1.name]
                    and fenced_generation(fleet.store, PROC_JOB, p0.name) >= 1
                    and p0.name not in fleet.live(),
                    f"serve_process (b): counters {bc}, victims {victims}, "
                    f"live {router.live_replica_names()}")
            # the lease itself runs out: its last beat older than its ttl
            _bounded(lambda: time.time() - float(
                fleet.store.get(key, timeout=10)[0]) > PROC_TTL,
                "serve_process (b): the killed child's lease to expire",
                timeout=4 * PROC_TTL)
            expired_s = time.time() - wall_k
            back_s = _mem_back(torch, free_b + 0.9 * child_gb[0],
                               "serve_process (b)")
            gave_back = _free_gb(torch) - free_b
            seconds["b"] = time.perf_counter() - t
            emit({"phase": "serve_process", "drill": "b_sigkill",
                  "lease_ttl_s": PROC_TTL, **bc, "victims": len(victims),
                  "kill_to_first_new_token_s": first_new - tk,
                  "kill_to_lease_expiry_observed_s": expired_s,
                  "card_gb_given_back": gave_back,
                  "memory_back_s": back_s, "streams_equal_serve": True})

            # (c) respawn while the survivor serves
            t = time.perf_counter()
            rounds, errors, stop = [], [], threading.Event()

            def traffic():
                try:
                    while not stop.is_set():
                        s, rep = _proc_mix(router, prompts, SERVE_NEW,
                                           "serve_process (c) traffic")
                        rounds.append((s == serve_streams, rep))
                except BaseException as e:      # noqa: BLE001 — reported
                    errors.append(e)
            delivered = _rv(router, "tokens_delivered_total")
            worker = threading.Thread(target=traffic, name="c-traffic")
            worker.start()
            _bounded(lambda: _rv(router, "tokens_delivered_total")
                     >= delivered + len(prompts),
                     "serve_process (c): traffic under way",
                     timeout=PROC_WAIT_S)
            free_c = _free_gb(torch)
            ts = time.perf_counter()
            p2 = fleet.respawn(p0.name)
            te = time.perf_counter()
            stop.set()
            worker.join(PROC_WAIT_S)
            require(not worker.is_alive() and not errors and rounds
                    and all(eq for eq, _ in rounds),
                    f"serve_process (c): traffic {len(rounds)} rounds, "
                    f"equal {[eq for eq, _ in rounds]}, errors {errors!r}")
            during = [rep for _, rep in rounds
                      if rep["t0"] < te and rep["t1"] > ts]
            require(rounds[0][1]["t0"] < ts and rounds[-1][1]["t1"] > te
                    and p2.lease.generation == 2 and p2.name == p0.name,
                    f"serve_process (c): the respawn ({ts:.2f}-{te:.2f}) "
                    f"outside the traffic ({rounds[0][1]['t0']:.2f}-"
                    f"{rounds[-1][1]['t1']:.2f}) or generation "
                    f"{p2.lease.generation}")
            _series_armed([p2], "serve_process (c)")
            router.add_replica(p2)
            c_streams, c = _proc_mix(router, prompts, SERVE_NEW,
                                     "serve_process (c) both")
            require(c_streams == serve_streams and len(c["placed"]) == 2,
                    f"serve_process (c): the mix over both processes, "
                    f"placed {c['placed']}")
            k4_c = _k4_children([p2], layers, "serve_process (c)")[p2.name]
            launches["c respawned child"] = k4_c
            seconds["c"] = time.perf_counter() - t
            emit({"phase": "serve_process", "drill": "c_respawn",
                  "respawn_s": te - ts, "respawned_boot_s": p2.boot_s,
                  "card_gb_taken": free_c - _free_gb(torch),
                  "rounds_during_respawn": len(during),
                  "tokens_per_s_during_respawn": [
                      r["tokens_per_s"] for r in during],
                  "itl_p99_ms_during_respawn": [
                      r["itl_p99_ms"] for r in during],
                  "streams_equal_serve": True,
                  "after_respawn": {k: c[k] for k in (
                      "tokens_per_s", "ttft_p50_ms", "itl_p50_ms",
                      "itl_p99_ms", "placed")},
                  "k4_launches_respawned_child": k4_c})

            # (e, first half) QueueFull from a child over the wire
            t = time.perf_counter()
            handles, refused = [], 0
            for i in range(PROC_BURST):
                try:
                    handles.append((i % len(prompts), p1.submit(
                        prompts[i % len(prompts)], SERVE_NEW)))
                except QueueFull:
                    refused += 1
            burst = [list(h.result(timeout=PROC_WAIT_S)) == serve_streams[i]
                     for i, h in handles]
            require(refused > 0 and all(burst)
                    and len(handles) >= SERVE_KW["max_slots"],
                    f"serve_process (e): {refused} QueueFull of "
                    f"{PROC_BURST}, {len(handles)} accepted, equal {burst}")
            seconds["e queue"] = time.perf_counter() - t
            router.shutdown()
            floor = mem[0] - 1.0
            fleet.shutdown()
            require(not any(r.proc.is_alive() for r in fleet.replicas),
                    "serve_process: a child outlived its shutdown")
            down_s = _mem_back(torch, floor, "serve_process (a)-(c) down")

            # (d) promotion: ProcessFleet(ha=True), primary, standby
            t = time.perf_counter()
            job = PROC_JOB + "-ha"
            hfleet = ProcessFleet(PROC_SPEC, n=2, job_id=job, ha=True,
                                  lease_ttl=PROC_TTL,
                                  store_dir=str(root / "ha-store"),
                                  **PROC_KW)
            fleets.append(hfleet)
            primary = HARouter(store=hfleet.store, job_id=job,
                               lease_ttl=PROC_LEADER_TTL,
                               poll_interval=ROUTER_POLL_S,
                               journal_path=str(root / "primary.jsonl"))
            routers.append(primary)
            _bounded(lambda: primary.acceptor.join_handshakes() == 2,
                     "serve_process (d): both children at the primary",
                     timeout=PROC_WAIT_S)
            ha_boot_s = time.perf_counter() - t
            pids = {r.name: r.pid for r in primary.acceptor.accepted}
            require(pids == {n: p.pid for n, p in hfleet.procs.items()},
                    f"serve_process (d): attached {pids}")
            _series_armed(primary.acceptor.accepted, "serve_process (d)")
            standby = StandbyRouter(
                hfleet.store, job, shadow_path=str(root / "shadow.jsonl"),
                auto_promote=True, watch_interval=PROC_WATCH_S,
                router_kw={"poll_interval": ROUTER_POLL_S,
                           "journal_path": str(root / "successor.jsonl")})
            standbys.append(standby)
            client = FleetClient(hfleet.store, job)
            rids = [client.submit(p, SERVE_NEW) for p in prompts]

            def mid_decode():
                st = standby.shadow_state()
                return (set(rids) <= set(st)
                        and all(st[r]["delivered"] for r in rids))
            _bounded(mid_decode, "serve_process (d): every stream under "
                     "way in the standby's shadow", timeout=PROC_WAIT_S)
            tc = time.perf_counter()
            primary.crash()
            shadow = standby.shadow_state()
            require(not any(st["done"] for st in shadow.values()),
                    "serve_process (d): a stream finished before the crash")
            _bounded(standby.promoted.is_set, "serve_process (d): the "
                     "standby's promotion", timeout=4 * PROC_PROMOTE_BOUND_S)
            promoted_s = time.perf_counter() - tc
            r2 = standby.router
            routers.append(r2)
            got = [client.result(rid, timeout=PROC_WAIT_S) for rid in rids]
            done_s = time.perf_counter() - tc
            require([toks for _, toks in got] == serve_streams,
                    "serve_process (d): client streams differ from the "
                    "serve phase's")
            dc = _router_counts(r2, ("requests_resubmitted_total",
                                     "tokens_deduped_total",
                                     "replay_mismatch_total",
                                     "tokens_delivered_total"))
            _bounded(lambda: r2.acceptor.join_handshakes() == 2,
                     "serve_process (d): both children at the successor",
                     timeout=PROC_WAIT_S)
            require(promoted_s <= PROC_PROMOTE_BOUND_S
                    and r2.router_epoch > primary.router_epoch
                    and dc["requests_resubmitted_total"] == len(rids)
                    and dc["tokens_deduped_total"] > 0
                    and dc["replay_mismatch_total"] == 0
                    and {r.name: r.pid for r in r2.acceptor.accepted} == pids
                    and all(p.is_alive() for p in hfleet.procs.values())
                    and all(fenced_generation(hfleet.store, job, n) == 0
                            for n in pids)
                    and sorted(live_replicas(hfleet.store, job))
                    == sorted([ROUTER_LEADER, *pids]),
                    f"serve_process (d): promoted in {promoted_s:.2f} s, "
                    f"epochs {primary.router_epoch} -> {r2.router_epoch}, "
                    f"counters {dc}, attached "
                    f"{[r.name for r in r2.acceptor.accepted]}")
            k4_d = _k4_children(r2.acceptor.accepted, layers,
                                "serve_process (d)")
            launches["d promotion"] = sum(k4_d.values())

            # (e, second half) the deposed primary's epoch refused
            rep = r2.acceptor.accepted[0]
            try:
                rep.submit(prompts[0], 4, router_epoch=primary.router_epoch)
                stale = False
            except StaleRouterEpoch:
                stale = True
            require(stale, "serve_process (e): a deposed epoch accepted")
            seconds["d"] = time.perf_counter() - t
            emit({"phase": "serve_process", "drill": "d_promotion",
                  "layers": layers, "leader_lease_ttl_s": PROC_LEADER_TTL,
                  "standby_watch_s": PROC_WATCH_S, "boot_s": ha_boot_s,
                  "crash_to_promoted_s": promoted_s,
                  "promote_latency_s": standby.promote_latency_s,
                  "bound_s": PROC_PROMOTE_BOUND_S,
                  "crash_to_all_streams_s": done_s,
                  "epochs": [primary.router_epoch, r2.router_epoch],
                  "requests_resubmitted": dc["requests_resubmitted_total"],
                  "tokens_deduped": dc["tokens_deduped_total"],
                  "delivered_before_crash": sum(
                      len(st["delivered"]) for st in shadow.values()),
                  "replay_mismatch": dc["replay_mismatch_total"],
                  "replicas_fenced": 0, "rehello_same_pids": True,
                  "streams_equal_serve": True,
                  "k4_launches_per_child": k4_d})
            emit({"phase": "serve_process", "drill": "e_typed_errors",
                  "queue_full": refused, "burst": PROC_BURST,
                  "accepted_streams_equal_serve": len(handles),
                  "stale_router_epoch": {
                      "refused_epoch": primary.router_epoch,
                      "replica_epoch": r2.router_epoch}})
        finally:
            for s in standbys:
                s.stop()
            for r in routers:
                r.shutdown()
            for f in fleets:
                f.shutdown()
    procs = [r.proc for f in fleets for r in f.replicas] + [
        p for f in fleets for p in f.procs.values()]
    require(not any(p.is_alive() for p in procs),
            "serve_process: a child process outlived the phase")
    down_s += _mem_back(torch, mem[0] - 1.0, "serve_process (d) down")
    require(sorted(p.name for p in _build.BUILD_DIR.iterdir()) == libs,
            "serve_process: a child built a kernel library")
    emit({"phase": "serve_process", "drill_seconds": seconds,
          "memory_back_s": down_s, "children_built_nothing": True,
          "seconds": time.perf_counter() - t_phase})
    return launches


def phase_serve(torch):
    """The serve phase (graphs and the overlap driver, the defaults on
    the card) for both pools; the profile three ways; the parity and
    graph checks for both pools; the same streams from the
    synchronous driver, the eager step and the bucketed widths; then
    serving under KV pressure, with a shared system prompt, with
    speculation and SLO tiers; then with int8 weights (serve_int8w);
    then static KV-cache generation on the same model; then tiered KV
    and the KV fabric between two servers; then the fleet substrate
    (serve_fleet) and the Router over it (serve_router).  serve_slo,
    the int8 runs under pressure and the int8 pull, serve_tiered and the
    two handoffs run on the model's first SHALLOW_LAYERS layers
    (`_shallow`): each holds itself to its own references, and the run
    keeps inside its time budget."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    t0 = time.perf_counter()
    model = LlamaForCausalLM(LlamaConfig.from_preset("llama3-8b"),
                             device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    launches, streams, reports = {}, {}, {}
    for kv in (None, "int8"):
        reports[kv], streams[kv], launches[kv] = _serve_once(torch, model,
                                                             kv)
        emit({"phase": "serve", "model": "llama3-8b", "dtype": "bfloat16",
              "layers": model.config.num_hidden_layers,
              "params": n_params, "init_s": init_s, **reports[kv]})
    same = sum(a == b for sa, sb in zip(streams[None], streams["int8"])
               for a, b in zip(sa, sb))
    emit({"phase": "serve", "int8_vs_bf16_pool_token_agreement":
          same / (len(SERVE_LENGTHS) * SERVE_NEW)})
    rows, profile = {}, {}
    for mode in ("eager", "graphs", "graphs_overlap"):
        profile[mode], rows[mode] = phase_profile(torch, model, mode)
    _, sync_int8, _ = _serve_once(torch, model, "int8", "graphs")
    _, bucketed, _ = _serve_once(torch, model, None, decode_buckets=True)
    emit({"phase": "serve_graphs", "streams": {
        "overlap_on_vs_off_bf16": rows["graphs"] == streams[None]
        and rows["graphs_overlap"] == streams[None],
        "overlap_on_vs_off_int8": sync_int8 == streams["int8"],
        "decode_buckets_vs_full_width": bucketed == streams[None],
        "graphs_vs_eager_step": rows["eager"] == streams[None]}})
    require(rows["graphs"] == streams[None] == rows["graphs_overlap"],
            "overlap on and off (bf16 pool) give different streams")
    require(sync_int8 == streams["int8"],
            "overlap on and off (int8 pool) give different streams")
    require(bucketed == streams[None],
            "decode_buckets streams differ from the full width's")
    limits = {kv or "bfloat16": phase_serve_parity(torch, model, kv)
              for kv in (None, "int8")}
    for kv in (None, "int8"):
        _verify_parity(torch, model, kv, limits[kv or "bfloat16"])
    shallow = _shallow(torch, model, SHALLOW_LAYERS)
    pressure, pressure_streams = phase_serve_pressure(torch, model, limits,
                                                      shallow)
    prefix, prefix_streams = phase_serve_prefix(torch, model)
    spec = phase_serve_spec(torch, model, limits)
    slo = phase_serve_slo(torch, shallow, limits)
    int8w = phase_serve_int8w(torch, model, shallow, limits, streams[None],
                              profile["graphs_overlap"])
    int8w_streams = int8w.pop("streams")
    generate = phase_generate(torch, model, limits["bfloat16"])
    tiered = phase_serve_tiered(torch, shallow)
    fabric = phase_serve_fabric(torch, model, prefix_streams,
                                pressure_streams["bfloat16"], shallow)
    fleet, fleet_a = phase_serve_fleet(torch, model, streams[None],
                                       reports[None]["tokens_per_s"],
                                       int8w_streams)
    router = phase_serve_router(torch, model, shallow, streams[None],
                                prefix_streams, fleet_a)
    del model, shallow
    torch.cuda.empty_cache()
    return {"bfloat16": launches[None], "int8": launches["int8"],
            "pressure": pressure, "prefix": prefix, "spec": spec,
            "slo": {"bfloat16": slo}, "int8w": int8w,
            "generate": generate, "tiered": tiered, "fabric": fabric,
            "fleet": fleet, "router": router, "streams": streams[None],
            "tokens_per_s": reports[None]["tokens_per_s"]}


def _debug_model():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    return LlamaForCausalLM(LlamaConfig.from_preset("debug-4l"),
                            device="cuda", seed=1)


DEBUG_KW = dict(max_slots=4, max_len=256, prefill_chunk=32)
# serve_spec on debug-4l (fp32): the spec-on logits up to a flipped
# token may differ from the spec-off run's by at most this (fp32 GEMMs
# at M = 8 x W rows against M = 8; ~1e-6 expected)
DEBUG_SPEC_LIMIT = 1e-4
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
        eng.prepare_programs()
        PA.LAUNCHES["paged_attention"] = 0
        reqs = [eng.submit(p, 24) for p in _debug_prompts()]
        eng.run()
        streams[kernel] = [list(r.tokens) for r in reqs]
        steps = _metric(eng, "decode_steps_total")
        require(eng.num_graph_replays == steps,
                f"parity ({kernel}): {eng.num_graph_replays} replays for "
                f"{steps} steps")
        if kernel == "cuda":
            launches = PA.LAUNCHES["paged_attention"]
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
    # no Pallas kernel: the update inside the JAX step's jitted, donated
    # program (paddle_tpu/jit/trainer.py:327-328)
    "optimizer_reduce": ("fused_update",
                         "paddle_tpu/nn/clip.py:82 (global norm) and "
                         "paddle_tpu/jit/trainer.py:283-289 (unscale, "
                         "found_inf), inside the jitted step; no Pallas "
                         "kernel"),
    "optimizer_update": ("fused_update",
                         "paddle_tpu/optimizer/optimizer.py:148 "
                         "(functional_update: Adam / AdamW) inside the "
                         "jitted, donated step; no Pallas kernel"),
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


def _train_setup(torch, cfg, lr, clip, seed, loss_fn=None, loss_scale=None):
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
                                                                   ids)),
                            opt, loss_scale=loss_scale)


def _train_ids(torch, cfg, B, S, seed):
    import numpy as np
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return torch.from_numpy(ids).to("cuda")


def _train_profile(torch, step, ids, step_ms):
    """Device time of one training step by kernel family, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function
    update = step.optimizer.functional_update
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def ranged(*args, **kw):
        with record_function(UPDATE_RANGE):
            marks[0].record()
            out = update(*args, **kw)
            marks[1].record()
            return out

    torch.cuda.synchronize()
    step.optimizer.functional_update = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(ids)
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        del step.optimizer.functional_update      # the class's method again
    dev = _device_times(prof)
    if dev is None:
        return {"device_time": "not measured (no device events)"}
    # the update on the card, table copy to U2's end: CUDA events on the
    # stream around functional_update (the profiler does not tie the
    # ctypes launches to the record_function range)
    range_ms = marks[0].elapsed_time(marks[1])
    families = {"k1_flash_fwd": ("flash_fwd_kernel", "flash_fwd_wgmma"),
                "k2_flash_bwd": ("flash_dq_kernel", "flash_dkv_kernel",
                                 "flash_dq_wgmma", "flash_dkv_wgmma"),
                "k3_softmax_xent": ("xent_fwd_kernel", "xent_bwd_kernel"),
                "k5_gmm": ("gmm_fwd", "gmm_drhs"),
                "optimizer_update": ("optim_u1", "optim_u2"),
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
            "update_events_ms": range_ms,
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


def _forward_backward(torch, step, model, ids, cfg, policy):
    """The loss forward and backward alone under `policy` (None: no
    recompute): host-clock ms of each (synchronised) and the memory the
    forward leaves for the backward (what recompute trades)."""
    cfg.recompute = policy is not None
    cfg.recompute_policy = policy or "full"
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss = step.loss_fn(model, ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        saved = torch.cuda.memory_allocated() - base
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        cfg.recompute, cfg.recompute_policy = False, "full"
    for p in model.parameters():
        p.grad = None
    return {"forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
            "saved_for_backward_gib": saved / 2**30}


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
    with _clock_samples() as clocks:
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
            "softmax_xent_fwd": TRAIN_STEPS, "softmax_xent_bwd": TRAIN_STEPS,
            "optimizer_reduce": TRAIN_STEPS, "optimizer_update": TRAIN_STEPS}
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
              "peak_mem_gib": peak_gib, "launches": launches,
              "clocks_during_steps": clocks}
    report.update(_train_profile(torch, step, ids, step_ms))
    emit(report)

    # recompute: the first step again from the initial state, without
    # recompute, with "full" and with "dots" (the dense products'
    # outputs saved, the rest recomputed); the loss is the forward of
    # the same weights.  The parameters after the plain step stay on the
    # host, so they take no part in the others' peak memory.
    rows, after = {}, None
    for policy in (None, "full", "dots"):
        step.set_state_dict(init)
        cfg.recompute = policy is not None
        cfg.recompute_policy = policy or "full"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_train_counts()
        t = time.perf_counter()
        try:
            loss = step(ids).item()
        finally:
            cfg.recompute, cfg.recompute_policy = False, "full"
        row = {"loss": loss, "step_ms": 1e3 * (time.perf_counter() - t),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": _train_counts()}
        row.update(_forward_backward(torch, step, model, ids, cfg, policy))
        if after is None:
            after = {n: p.detach().to("cpu", copy=True)
                     for n, p in step.params.items()}
        else:
            row["max_abs_param_diff_after_step"] = max(
                (p.float() - after[n].to(p.device).float()).abs().max()
                .item() for n, p in step.params.items())
        rows[policy or "none"] = row
    del init, after
    torch.cuda.empty_cache()
    loss_plain = rows["none"]["loss"]
    emit({"phase": "train_recompute", "policies": ["full", "dots"],
          "loss_first_step": losses[0], "one_step_each": rows,
          "tolerance": "|loss_recompute - loss| <= 2^-8 x |loss|"})
    for policy in ("full", "dots"):
        n = rows[policy]["launches"]
        require(n["flash_attention_fwd"] == 2 * L
                and n["flash_attention_dq"] == L,
                f"recompute {policy} launches {n}")
        require(abs(rows[policy]["loss"] - loss_plain)
                <= 2 ** -8 * abs(loss_plain),
                f"recompute {policy} loss {rows[policy]['loss']} vs "
                f"{loss_plain}")
    require(rows["none"]["launches"]["flash_attention_fwd"] == L,
            f"launches without recompute {rows['none']['launches']}")

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
    """The flash, cross-entropy, grouped-matmul and optimizer-update
    wrappers run their plain PyTorch versions on the card inside the
    block."""
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import fused_update as FU
    from paddle_tpu_torch.ops import gmm as G
    from paddle_tpu_torch.ops import softmax_xent as SX
    saved = (FA.flash_fwd, FA.flash_bwd, SX.softmax_xent_fwd,
             SX.softmax_xent_bwd, G.gmm_fwd, G.gmm_drhs, FU.fused_update)
    FA.flash_fwd, FA.flash_bwd = FA.flash_fwd_plain, FA.flash_bwd_plain
    SX.softmax_xent_fwd = SX.softmax_xent_plain
    SX.softmax_xent_bwd = SX.softmax_xent_bwd_plain
    G.gmm_fwd, G.gmm_drhs = G.gmm_plain, G.gmm_drhs_plain
    FU.fused_update = FU.fused_update_plain
    try:
        yield
    finally:
        (FA.flash_fwd, FA.flash_bwd, SX.softmax_xent_fwd,
         SX.softmax_xent_bwd, G.gmm_fwd, G.gmm_drhs, FU.fused_update) = saved


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


def phase_loss_scale(torch):
    """debug-4l in fp32 on the card, the kernels on: two TrainSteps with
    a static loss scale of 1024 against two without (each loss within
    1e-6 relative, every parameter within rtol 2e-5 / atol 1e-6, the
    limits of tests/test_amp_scaler.py); then a dynamic scale (256, x2
    after 2 good steps, /2 after 1 bad one): two good steps double it, a
    poisoned step (loss x inf) leaves every parameter and moment bitwise
    as it was and halves it."""
    from types import SimpleNamespace
    from paddle_tpu_torch.models import (LlamaConfig,
                                         LlamaPretrainingCriterion)
    cfg = LlamaConfig.from_preset("debug-4l")
    ids = _train_ids(torch, cfg, 2, 128, seed=7)
    _zero_train_counts()
    runs = {}
    for ls in (None, 1024.0):
        model, step = _train_setup(torch, cfg, 1e-3, 0.5, seed=1,
                                   loss_scale=ls)
        losses = [step(ids).item() for _ in range(2)]
        runs[ls] = (losses, {n: p.detach().clone()
                             for n, p in step.params.items()})
        del model, step
    (l0, p0), (l1, p1) = runs[None], runs[1024.0]
    loss_ok = all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(l1, l0))
    param_ok = all(torch.allclose(p1[n], p0[n], rtol=2e-5, atol=1e-6)
                   for n in p0)
    p_err = max((p1[n] - p0[n]).abs().max().item() for n in p0)

    poison = {"on": False}
    crit = LlamaPretrainingCriterion()

    def loss_fn(m, x):
        loss = crit(m(x), x)
        return loss * float("inf") if poison["on"] else loss
    scaler = SimpleNamespace(_scale=256.0, _dynamic=True, _incr_ratio=2.0,
                             _decr_ratio=0.5, _incr_every=2, _decr_every=1)
    model, step = _train_setup(torch, cfg, 1e-3, 0.5, seed=1,
                               loss_fn=loss_fn, loss_scale=scaler)
    scales = []
    for _ in range(2):
        step(ids)
        scales.append(step.scaler_state["scale"].item())
    before = step.state_dict()
    poison["on"] = True
    bad_loss = step(ids).item()
    scales.append(step.scaler_state["scale"].item())
    kept = all(torch.equal(p, before["params"][n])
               for n, p in step.params.items()) and all(
        torch.equal(t, before["opt_state"][n][k])
        for n, st in step.opt_state.items() for k, t in st.items())
    counts = _train_counts()
    del model, step, before
    torch.cuda.empty_cache()
    emit({"phase": "loss_scale", "model": "debug-4l", "dtype": "float32",
          "losses_unscaled": l0, "losses_static_1024": l1,
          "param_max_abs_diff_static_vs_unscaled": p_err,
          "dynamic_scales": scales, "poisoned_loss": bad_loss,
          "poisoned_step_writes_nothing": kept,
          "launches": {k: counts[k] for k in OPT_KERNELS},
          "tolerance": "static vs none: loss 1e-6 rel, params rtol 2e-5 / "
                       "atol 1e-6; poisoned step: params and moments "
                       "bitwise; scales 256 -> 512 -> 256"})
    require(loss_ok and param_ok,
            f"static loss scale: losses {l1} vs {l0}, params {p_err}")
    require(scales == [256.0, 512.0, 256.0], f"dynamic scales {scales}")
    require(kept and not math.isfinite(bad_loss),
            "a poisoned step changed the parameters or moments")
    require(counts["optimizer_reduce"] == counts["optimizer_update"] == 7,
            f"loss_scale launches {counts}")


# --------------------------------------------------------------------------
# the optimizer update: U1 (the clip's and the loss scaler's reduction)
# and U2 (the Adam / AdamW update), two multi-tensor kernels
# --------------------------------------------------------------------------

OPT_KERNELS = ("optimizer_reduce", "optimizer_update")
OPT_HP = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              step=3)
OPT_TOL_TEXT = ("U1: global norm |err| <= 1e-06 x the plain norm, found_inf "
                "equal; U2 given U1's clip scale, inv scale and found_inf: "
                "every element of p, m and v within 1 ulp of the plain "
                "value's dtype (bitwise expected: the same rounded "
                "operations in the same order)")
# U2's operations per element (unscale, clip, the moments, bias
# corrections, sqrt, the update, the decay); U1's (unscale, square-add)
OPT_FLOPS = {"optimizer_reduce": 2, "optimizer_update": 20}


def _ulp_share(torch, got, want):
    """max over elements of |got - want| in ulps of `want`'s dtype at
    |want| (its smallest normal step at 0)."""
    fi = torch.finfo(want.dtype)
    w = want.float().abs().clamp_min(fi.tiny)
    ulp = torch.exp2(torch.floor(torch.log2(w))) * fi.eps
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _opt_inputs(torch, model, moment_dtype, gen, none=()):
    """The model's own parameters (updated in place) with gradients and
    moments from `gen`; parameters named in `none` get no gradient."""
    names = [n for n, _ in model.named_parameters()]
    ps = [p.detach() for p in model.parameters()]

    def rnd(p, scale, dtype):
        return torch.randn(p.shape, generator=gen, device="cuda",
                           dtype=dtype).mul_(scale)
    gs = [None if n in none else rnd(p, 1e-2, p.dtype)
          for n, p in zip(names, ps)]
    ms = [rnd(p, 1e-3, moment_dtype or p.dtype) for p in ps]
    vs = [rnd(p, 1e-3, moment_dtype or p.dtype).square_() for p in ps]
    return names, ps, gs, ms, vs


def _opt_check(torch, ps, gs, ms, vs, decoupled, clip, scale):
    """U1 and U2 against their plain versions on the same inputs, twice
    for bitwise repeatability, then a call with a NaN gradient under a
    loss scale that must write nothing.  Leaves ps, ms, vs updated."""
    from paddle_tpu_torch.ops import fused_update as FU
    hp = dict(OPT_HP, decoupled=decoupled)
    orig = [t.clone() for t in ps + ms + vs]
    n = len(ps)
    out = FU.fused_update(ps, gs, ms, vs, clip_norm=clip, scale=scale, **hp)
    ref = FU.reduce_plain(gs, scale, clip)
    norm, pnorm = out["global_norm"].item(), ref["global_norm"].item()
    inv = 1.0 if scale is None else 1.0 / scale.item()
    norm64 = math.sqrt(sum((g.double() * inv).square().sum().item()
                           for g in gs if g is not None))
    found = None if scale is None else bool(out["found_inf"].item())
    plain = [t.clone() for t in orig]
    FU.update_plain(plain[:n], gs, plain[n:2 * n], plain[2 * n:],
                    clip_scale=out["clip_scale"], inv_scale=out["inv_scale"],
                    found_inf=out["found_inf"], **hp)
    torch.cuda.synchronize()
    ulps = max(_ulp_share(torch, a, b) for a, b in zip(ps + ms + vs, plain))
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(ps + ms + vs, plain))
    del plain
    again = [t.clone() for t in orig]
    del orig
    FU.fused_update(again[:n], gs, again[n:2 * n], again[2 * n:],
                    clip_norm=clip, scale=scale, **hp)
    bitwise = all(torch.equal(a, b) for a, b in zip(ps + ms + vs, again))
    # a NaN gradient under a loss scale (1.0 where the case has none)
    i = next(k for k, g in enumerate(gs) if g is not None)
    bad = list(gs)
    bad[i] = gs[i].clone()
    bad[i].view(-1)[bad[i].numel() // 2] = float("nan")
    one = scale if scale is not None else torch.ones((), device="cuda")
    skip = FU.fused_update(ps, bad, ms, vs, clip_norm=clip, scale=one, **hp)
    skipped = bool(skip["found_inf"].item())
    kept = all(torch.equal(a, b) for a, b in zip(ps + ms + vs, again))
    del again, bad
    torch.cuda.empty_cache()
    return {"global_norm": norm, "global_norm_plain": pnorm,
            "global_norm_rel_err": abs(norm - pnorm) / pnorm,
            "global_norm_fp64": norm64,
            "global_norm_rel_err_fp64": abs(norm - norm64) / norm64,
            "global_norm_plain_rel_err_fp64": abs(pnorm - norm64) / norm64,
            "found_inf": found, "u2_max_abs_err": err,
            "u2_max_err_ulps": ulps, "bitwise_twice": bitwise,
            "nan_gradient_found_inf": skipped,
            "nan_gradient_writes_nothing": kept}


def _opt_require(case, r):
    require(r["global_norm_rel_err"] <= 1e-6,
            f"U1 {case}: global norm {r['global_norm']} vs plain "
            f"{r['global_norm_plain']}")
    require(r["found_inf"] in (None, False), f"U1 {case}: found_inf set")
    require(r["u2_max_err_ulps"] <= 1.0,
            f"U2 {case}: {r['u2_max_err_ulps']} ulps from plain")
    require(r["bitwise_twice"], f"U1 / U2 {case}: two calls differ")
    require(r["nan_gradient_found_inf"] and r["nan_gradient_writes_nothing"],
            f"U2 {case}: a NaN gradient under a loss scale wrote")


def phase_optimizer_kernels(torch):
    """U1 and U2 against their plain versions: the dense train path's
    own parameters (llama3-8b, TRAIN_LAYERS layers, bf16, bf16 moments,
    AdamW, clip 1.0; one parameter without a gradient), and at debug-4l
    fp32 (AdamW; Adam with L2 decay, a loss scale and a parameter
    without a gradient) and bf16 with fp32 moments (multi_precision);
    then, at the dense shapes, U1 + U2 timed in turns with the plain
    version, each kernel alone, the eager per-parameter update
    the port ran before (the clip, then update_rule op by op),
    torch._fused_adamw_ (a yardstick the port never calls; no clip) and
    torch.nn.utils.get_total_norm (U1's), beside the bounds."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import fused_update as FU
    from paddle_tpu_torch.optimizer import AdamW
    kind = torch.cuda.get_device_name(0)
    saved = _train_counts()
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = {}
    for label, preset, dtype, mdt, decoupled, scale in (
            ("debug-4l fp32 AdamW", "debug-4l", "float32", None, True,
             None),
            ("debug-4l fp32 Adam (L2), loss scale 1024", "debug-4l",
             "float32", None, False, 1024.0),
            ("debug-4l bf16, fp32 moments (multi_precision), loss scale "
             "1024", "debug-4l", "bfloat16", torch.float32, True, 1024.0)):
        model = LlamaForCausalLM(LlamaConfig.from_preset(preset,
                                                         dtype=dtype),
                                 device="cuda", seed=2)
        _, ps, gs, ms, vs = _opt_inputs(torch, model, mdt, gen,
                                        none=("llama.norm.weight",))
        st = None
        if scale is not None:
            st = torch.tensor(scale, device="cuda")
            gs = [None if g is None else g * scale for g in gs]
        cases[label] = _opt_check(torch, ps, gs, ms, vs, decoupled, 1.0, st)
        del model, ps, gs, ms, vs

    cfg = LlamaConfig.from_preset("llama3-8b",
                                  num_hidden_layers=TRAIN_LAYERS)
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    names, ps, gs, ms, vs = _opt_inputs(torch, model, None, gen,
                                        none=("llama.norm.weight",))
    label = (f"llama3-8b {TRAIN_LAYERS} layers bf16, bf16 moments, AdamW, "
             f"clip 1.0")
    cases[label] = _opt_check(torch, ps, gs, ms, vs, True, 1.0, None)
    for key, r in cases.items():
        emit({"phase": "optimizer_kernels", "case": key,
              "tolerance": OPT_TOL_TEXT, **r})
        _opt_require(key, r)

    # ---- times at the dense train path's shapes
    hp = dict(OPT_HP, decoupled=True)
    fused_ms, plain_ms, turns = _in_turns(
        torch, lambda: FU.fused_update_plain(ps, gs, ms, vs, clip_norm=1.0,
                                             **hp),
        lambda: FU.fused_update(ps, gs, ms, vs, clip_norm=1.0, **hp), 3)
    table, chunks = FU._table(ps, gs, ms, vs)
    dev = ps[0].device
    red = FU._reduce(dev, table, chunks, None, 1.0)
    with _clock_samples() as clocks:
        kern_ms = {
            "optimizer_reduce": _time_ms(torch, lambda i: FU._reduce(
                dev, table, chunks, None, 1.0), 1, 10),
            "optimizer_update": _time_ms(torch, lambda i: FU._update(
                dev, table, chunks, red, use_clip=True, use_scale=False,
                **hp), 1, 10)}
    u1 = FU.reduce_plain(gs, None, 1.0)
    plain_part = {
        "optimizer_reduce": _time_ms(torch, lambda i: FU.reduce_plain(
            gs, None, 1.0), 1, 3),
        "optimizer_update": _time_ms(torch, lambda i: FU.update_plain(
            ps, gs, ms, vs, clip_scale=u1["clip_scale"], **hp), 1, 3)}
    opt = AdamW(learning_rate=OPT_HP["lr"],
                weight_decay=OPT_HP["weight_decay"],
                grad_clip=ClipGradByGlobalNorm(1.0))
    params = dict(zip(names, ps))
    grads = dict(zip(names, gs))
    state = {n: {"moment1": m, "moment2": v}
             for n, m, v in zip(names, ms, vs)}
    eager_ms = _time_ms(torch, lambda i: opt.per_param_update(
        params, grads, state, OPT_HP["lr"], OPT_HP["step"]), 1, 3)
    del opt, params, grads, state
    torch.cuda.empty_cache()
    live = [k for k, g in enumerate(gs) if g is not None]
    lib = {}
    try:
        steps = [torch.tensor(float(OPT_HP["step"]), device="cuda")
                 for _ in live]
        lib["optimizer_update"] = _time_ms(torch, lambda i: (
            torch._fused_adamw_(
                [ps[k] for k in live], [gs[k] for k in live],
                [ms[k] for k in live], [vs[k] for k in live], [], steps,
                lr=OPT_HP["lr"], beta1=OPT_HP["beta1"],
                beta2=OPT_HP["beta2"],
                weight_decay=OPT_HP["weight_decay"], eps=OPT_HP["eps"],
                amsgrad=False, maximize=False)), 1, 5)
    except Exception as e:          # a yardstick: report, do not fail
        lib["optimizer_update"] = None
        lib["optimizer_update_error"] = repr(e)[:200]
    total_norm = getattr(torch.nn.utils, "get_total_norm", None)
    lib["optimizer_reduce"] = None if total_norm is None else _time_ms(
        torch, lambda i: total_norm([gs[k] for k in live]), 1, 5)

    n_params = sum(p.numel() for p in ps)
    g_bytes = _nbytes(*(gs[k] for k in live))
    u2_bytes = 2 * _nbytes(*ps, *ms, *vs) + g_bytes
    bounds = {"optimizer_reduce": _bound_ms(
                  kind, OPT_FLOPS["optimizer_reduce"] * n_params, g_bytes,
                  "float32"),
              "optimizer_update": _bound_ms(
                  kind, OPT_FLOPS["optimizer_update"] * n_params, u2_bytes,
                  "float32")}
    dense = cases[label]
    res = {}
    for name in OPT_KERNELS:
        res[name] = {
            "max_abs_err": (abs(dense["global_norm"]
                                - dense["global_norm_plain"])
                            if name == "optimizer_reduce"
                            else dense["u2_max_abs_err"]),
            "tolerance": OPT_TOL_TEXT, "ms": kern_ms[name],
            "timing": "CUDA events over 10 launches of the kernel alone",
            "plain_ms": plain_part[name],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": lib[name],
            "library": ("torch._fused_adamw_ (bf16 states, no clip)"
                        if name == "optimizer_update" else
                        "torch.nn.utils.get_total_norm")}
    emit({"phase": "optimizer_kernels",
          "shape": f"llama3-8b {TRAIN_LAYERS} layers: {len(ps)} tensors, "
                   f"{n_params} parameters, bf16 p / g / m / v",
          "fused_ms": fused_ms, "fused_plain_ms": plain_ms,
          "fused_turns_ms": turns, "eager_per_param_ms": eager_ms,
          "clocks_during_kernel_timing": clocks,
          "bound_ms": bounds["optimizer_reduce"][0]
          + bounds["optimizer_update"][0],
          **{f"{k}_library_error": v for k, v in lib.items()
             if k.endswith("_error")},
          "kernels": res})
    del model, ps, gs, ms, vs, u1, table, red
    torch.cuda.empty_cache()
    _set_train_counts(saved)          # checks and timings do not count
    return res


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
    with _clock_samples() as clocks:
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            losses.append(step(ids).item())          # .item() synchronises
            secs.append(time.perf_counter() - t)
    launches = _all_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    L, n = MOE_LAYERS, TRAIN_STEPS
    # per layer and step: K1, dQ, dK/dV once; K5f 3x forward (gate, up,
    # down) + 3x dlhs; K5b 3x (w_gate, w_up, w_down); K3, U1 and U2 once
    # per step
    want = {"flash_attention_fwd": L * n, "flash_attention_dq": L * n,
            "flash_attention_dkv": L * n, "softmax_xent_fwd": n,
            "softmax_xent_bwd": n, "optimizer_reduce": n,
            "optimizer_update": n, "gmm_fwd": 6 * L * n,
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
              "launches": launches, "clocks_during_steps": clocks}
    report.update(_train_profile(torch, step, ids, step_ms))
    emit(report)

    # recompute "full": the loss and every gradient of the current
    # weights, without and with recompute
    def loss_and_grads(remat, policy="full"):
        cfg.recompute, cfg.recompute_policy = remat, policy
        _zero_all_counts()
        try:
            loss = step.loss_fn(model, ids)
            loss.backward()
        finally:
            cfg.recompute, cfg.recompute_policy = False, "full"
        grads = {k: p.grad for k, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads, _all_counts()

    loss_plain, g_plain, n_plain = loss_and_grads(False)
    require(n_plain["gmm_fwd"] == 6 * L,
            f"moe launches without recompute {n_plain}")
    for policy in ("full", "dots"):
        loss_remat, g_remat, n_remat = loss_and_grads(True, policy)
        bitwise = loss_plain == loss_remat and all(
            torch.equal(g_plain[k], g_remat[k]) for k in g_plain)
        g_share = max((g_remat[k].float() - g_plain[k].float()).abs().max()
                      .item() / (2 ** -8 * g_plain[k].float().abs().max()
                                 .clamp_min(1e-30).item()) for k in g_plain)
        del g_remat
        torch.cuda.empty_cache()
        emit({"phase": "moe_recompute", "policy": policy,
              "loss": loss_plain, "loss_recompute": loss_remat,
              "bitwise": bitwise,
              "tolerance": "bitwise expected (deterministic routing and "
                           "K5b); held to: loss within 2^-8 relative, each "
                           "gradient within 2^-8 x its max |value|",
              "grad_worst_err_over_limit": g_share,
              "launches": n_plain, "launches_recompute": n_remat})
        # both policies re-run the forward's K5f and K1: neither is a
        # dense product without a batch dimension
        require(n_remat["gmm_fwd"] == 9 * L and n_remat["gmm_drhs"] == 3 * L
                and n_remat["flash_attention_fwd"] == 2 * L,
                f"moe recompute {policy} launches {n_plain} / {n_remat}")
        require(abs(loss_remat - loss_plain) <= 2 ** -8 * abs(loss_plain),
                f"moe recompute {policy} loss {loss_remat} vs {loss_plain}")
        require(g_share <= 1.0,
                f"moe recompute {policy} grads: {g_share} x the limit")
    del g_plain
    torch.cuda.empty_cache()

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
    q1 = phase_q1_kernels(torch)
    serve_launches = phase_serve(torch)
    # the parent's llama3-8b is freed: the children hold their own
    serve_launches["process"] = phase_serve_process(
        torch, serve_launches.pop("streams"),
        serve_launches.pop("tokens_per_s"))
    debug = _debug_model()
    tokens, parity_launches = phase_parity(torch, debug)
    phase_generate_debug(torch, debug, tokens)
    phase_server(torch, debug, tokens)
    serve_launches["spec"].update(phase_serve_spec(
        torch, debug, {"float32": DEBUG_SPEC_LIMIT}, name="debug-4l"))
    serve_launches["slo"]["float32"] = phase_serve_slo_debug(torch, debug)
    del debug
    opt_kernels = phase_optimizer_kernels(torch)
    train_launches = phase_train(torch)
    phase_train_parity(torch)
    phase_loss_scale(torch)
    moe_kernels = phase_moe_kernels(torch)
    moe_launches = phase_moe_train(torch)
    phase_moe_parity(torch)
    moe_generate = phase_generate_moe(torch)

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
                "bound_by", "max_abs_err")},
            "verify_shape": {k: r["verify_shape"][k] for k in (
                "depths", "cols", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "max_abs_err")},
            "ext_tier": r["ext_tier"]})
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
    for name, r in opt_kernels.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/optimizer_update.cu",
            "replaces": TRAIN_KERNELS[name][1],
            "launches": train_launches[name],
            "launches_path": f"train llama3-8b, {TRAIN_LAYERS} layers, "
                             f"{TRAIN_STEPS} steps (one a step)",
            "launches_moe_train": moe_launches[name], **r})
    for name, r in moe_kernels.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/gmm.cu",
            "replaces": MOE_KERNELS[name],
            "launches": moe_launches[name],
            "launches_path": f"moe_train, Qwen1.5-MoE-A2.7B widths, "
                             f"{MOE_LAYERS} layers, {TRAIN_STEPS} steps",
            **r})
    int8w, gen = serve_launches["int8w"], serve_launches["generate"]
    entries.append({
        "name": "wo_int8_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/wo_int8_matmul.cu",
        "replaces": "paddle_tpu/quantization/int8.py:88 matmul_wo_int8 "
                    "(no Pallas kernel: XLA fuses the int8 convert into "
                    "the dot's operand read)",
        "launches": int8w["bfloat16"]["q1"],
        "launches_path": "serve_int8w llama3-8b, int8 weights, bf16 pool: "
                         "5 x 32 x (decode replays + prefill forwards), "
                         "counted from 0",
        "launches_serve_int8w": {
            "bf16 pool": int8w["bfloat16"]["q1"],
            "int8 pool": int8w["int8"]["q1"],
            "profile serve mix": int8w["profile"],
            "serve_spec (decode + verify replays)": int8w["spec"]["q1"]},
        "launches_generate": gen["q1"], **q1})
    gen_path = ("generate llama3-8b (bf16 weights; the contiguous cache "
                "attends in plain torch) and the MoE naive loop, counted "
                "from 0")
    for e in entries:
        if e["name"].startswith("paged_attention["):
            pool = e["name"][len("paged_attention["):-1]
            e["launches_generate"] = gen["k4"]
            if pool in int8w:
                e["launches_serve_int8w"] = int8w[pool]["k4"]
                require(int8w[pool]["k4"] > 0,
                        f"{e['name']}: no launch in serve_int8w")
            if pool == "bfloat16":      # the pressure and spec runs' pool
                e["launches_serve_int8w_pressure"] = int8w["pressure"]
                e["launches_path_serve_int8w_pressure"] = (
                    f"serve_int8w's pressure runs, first {SHALLOW_LAYERS} "
                    f"layers, each from 0")
                e["launches_serve_int8w_spec"] = int8w["spec"]["k4"]
        elif e["name"] in moe_generate:
            e["launches_generate"] = moe_generate[e["name"]]
            e["launches_serve_int8w"] = 0
            require(e["launches_generate"] > 0,
                    f"{e['name']}: no launch in the MoE generate loop")
        else:
            continue
        e["launches_path_generate"] = gen_path
    for e in entries[:len(kernels)]:
        pool = e["name"][len("paged_attention["):-1]
        pressure = {policy: n for (p, policy), n in
                    serve_launches["pressure"].items() if p == pool}
        if pressure:
            e["launches_serve_pressure"] = pressure
            depth = (f", first {SHALLOW_LAYERS} layers" if pool == "int8"
                     else "")
            e["launches_path_serve_pressure"] = (
                f"serve_pressure llama3-8b{depth}, {pool} pool: each run "
                f"from 0 "
                f"(full provisioning, then {pressure_blocks()} blocks)")
        if pool in serve_launches["spec"]:
            e["launches_serve_spec"] = serve_launches["spec"][pool]
            e["launches_path_serve_spec"] = (
                f"serve_spec {'debug-4l' if pool == 'float32' else 'llama3-8b'}"
                f", {pool} pool, speculation on: layers x (decode + verify "
                f"replays), counted from 0")
            require(e["launches_serve_spec"] > 0,
                    f"{e['name']}: no launch in serve_spec")
        if pool in serve_launches["slo"]:
            e["launches_serve_slo"] = serve_launches["slo"][pool]
            model_name = ("debug-4l" if pool == "float32" else
                          f"llama3-8b, first {SHALLOW_LAYERS} layers")
            e["launches_path_serve_slo"] = (
                f"serve_slo {model_name}, {pool} pool: each run from 0, "
                f"layers x (decode + verify replays)")
            require(all(n > 0 for n in e["launches_serve_slo"].values()),
                    f"{e['name']}: no launch in a serve_slo run")
        if pool == "bfloat16":
            e["launches_serve_prefix"] = {
                "without cache": serve_launches["prefix"][0],
                "with cache": serve_launches["prefix"][
                    PREFIX_KW["prefix_cache_blocks"]]}
        require(all(n > 0 for n in pressure.values()),
                f"{e['name']}: no launch in a serve_pressure run")
        tiered = {run: n for (p, run), n in
                  serve_launches["tiered"].items() if p == pool}
        fabric = {move: n for (p, move), n in
                  serve_launches["fabric"].items() if p == pool}
        if fabric:
            e["launches_serve_fabric"] = fabric
            e["launches_path_serve_fabric"] = (
                f"serve_fabric llama3-8b, {pool} pool, two servers on one "
                f"card: each move from 0, layers x the replays of both "
                f"servers while it ran (pull: the puller's only; the "
                f"int8 pull and the handoffs: the first {SHALLOW_LAYERS} "
                f"layers)")
            require(all(n > 0 for n in fabric.values()),
                    f"{e['name']}: no launch in a serve_fabric move")
        if pool == "bfloat16":
            e["launches_serve_fleet"] = serve_launches["fleet"]
            e["launches_path_serve_fleet"] = (
                "serve_fleet llama3-8b, bf16 pool, two LocalFleet "
                "replicas on one card: each drill from 0, layers x the "
                "replicas' replays; raw_step: layers x its calls")
            require(all(n > 0 for n in serve_launches["fleet"].values()),
                    f"{e['name']}: no launch in a serve_fleet drill")
            e["launches_serve_router"] = serve_launches["router"]
            e["launches_path_serve_router"] = (
                "serve_router llama3-8b, bf16 pool, replicas of one "
                "LocalFleet store behind the Router on one card: each "
                "drill from 0, layers x the replays of its replicas "
                f"(g: the first {SHALLOW_LAYERS} layers)")
            require(all(n > 0 for n in serve_launches["router"].values()),
                    f"{e['name']}: no launch in a serve_router drill")
            e["launches_serve_process"] = serve_launches["process"]
            e["launches_path_serve_process"] = (
                "serve_process llama3-8b, bf16 pool, replica processes on "
                "one card: each drill, layers x the decode steps its "
                "children report in their metrics series (a: both "
                "children, c: the respawned one, d: both HA children)")
            require(all(n > 0 for n in serve_launches["process"].values()),
                    f"{e['name']}: no launch in a serve_process child")
        if tiered:
            e["launches_serve_tiered"] = tiered
            e["launches_path_serve_tiered"] = (
                f"serve_tiered llama3-8b, first {SHALLOW_LAYERS} layers, "
                f"{pool} pool: each run from 0 "
                f"(full provisioning; {tiered_blocks()[1]} blocks tiered, "
                f"extension rows read in place; one sequence in "
                f"{TIERED_SOLO_BLOCKS} blocks, without and with "
                f"speculation)")
            require(all(n > 0 for n in tiered.values()),
                    f"{e['name']}: no launch in a serve_tiered run")
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
