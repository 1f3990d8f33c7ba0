#!/usr/bin/env python3
"""What K1's custom-operator layer costs, two checkouts on one CUDA card:
in each checkout, one process a run, in the order A, B, B, A (`--rounds N`
times over),

* K1's host time a call: `flash_fwd` called back to back (no sync
  between calls) at the ERNIE-3.0-base attention (fp32, 16 x 128, 12
  heads of 64, a (16, 1, 1, 128) -1e9 padding bias: the mma kernels)
  and at the Llama-3-8B trainer's (bf16, 2 x 2048, 32 / 8 heads of 128,
  causal: the wgmma kernels), median of 7 rounds of 200 calls;
* `bench_ernie`'s training step (chip_smoke.py's ernie_train: ERNIE-3.0-
  base fp32, 16 x 128 with a padding mask, dropout 0.1, AdamW 2e-5):
  host ms a step, median of steps 2 - 20, and K1 / dQ / dK/dV launches
  a step.

    python3 tools/op_cost_ab.py [--rounds N] OTHER [OTHER ...]

A is each OTHER checkout (a `git archive` of the parent commit unpacked
into `build/`, say), B this one.  Each run builds the kernels it needs
in its checkout's `build/`.  Prints one JSON line a run, then the card's
name and power limit.
"""

import json
import sys
import time

import _ab

ROUNDS, CALLS, STEPS = 7, 200, 20


def _host_us(torch, fn):
    """Median host µs a call of `fn` over ROUNDS rounds of CALLS calls
    (the card drains between rounds)."""
    rounds = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CALLS):
            fn()
        rounds.append(1e6 * (time.perf_counter() - t) / CALLS)
        torch.cuda.synchronize()
    return sorted(rounds)[ROUNDS // 2]


def one_run(root: str) -> int:
    import numpy as np
    import torch
    sys.path.insert(0, root)
    import chip_smoke as C
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention", "flash_attention_mma",
                  "optimizer_update"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(16, 128, 12, 64, device="cuda", generator=gen)
               for _ in range(3))
    bias = C._ernie_bias(torch, 16, 128)
    lq = torch.randn(2, 2048, 32, 128, device="cuda", generator=gen,
                     dtype=torch.bfloat16)
    lk, lv = (torch.randn(2, 2048, 8, 128, device="cuda", generator=gen,
                          dtype=torch.bfloat16) for _ in range(2))
    out = {"checkout": root,
           "k1_host_us_ernie_mma": _host_us(
               torch, lambda: FA.flash_fwd(q, k, v, False, bias=bias)),
           "k1_host_us_trainer_wgmma": _host_us(
               torch, lambda: FA.flash_fwd(lq, lk, lv, True))}
    cfg = ErnieConfig.from_preset("ernie-3.0-base")
    model = ErnieForSequenceClassification(cfg, num_classes=2,
                                           device="cuda", seed=0)
    step = C._ernie_step(torch, model, C.ERNIE_LR)
    rng = np.random.RandomState(0)
    batch = [torch.from_numpy(x).cuda() for x in (
        rng.randint(0, cfg.vocab_size, (16, 128)), rng.randint(0, 2, (16,)),
        C._ernie_mask(16, 128))]
    secs = []
    before = dict(FA.LAUNCHES)
    for _ in range(STEPS):
        t = time.perf_counter()
        step(*batch).item()
        secs.append(1e3 * (time.perf_counter() - t))
    out["ernie_step_ms"] = sorted(secs[1:])[len(secs[1:]) // 2]
    out["ernie_step_ms_each"] = secs
    out["k1_k2_launches_a_step"] = {n: (FA.LAUNCHES[n] - before[n]) / STEPS
                                    for n in before}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, one_run))
