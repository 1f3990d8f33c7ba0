#!/usr/bin/env python3
"""Time the paged-attention kernel K4 of paddle_tpu_torch at each split
size, for each pool dtype, at chip_smoke.py's kernel-phase depths and at
its serve phase's depths, on one CUDA card.

    python3 tools/k4_split_sweep.py

One JSON line per (depths, pool): for each split of R rows (a power of
two whose K and V tiles fit the kernel's shared memory) the time of one
call by CUDA-graph replay and the worst per-slot error as a share of
K4's limit; then the card's name and power limit.  The default split
(`ops.paged_attention.SPLIT_ROWS`) is chosen from these numbers.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k4_split_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from paddle_tpu_torch.ops import paged_attention as PA
    gen = torch.Generator(device="cuda").manual_seed(0)
    depth_sets = {"kernel": C.KERNEL_POS,
                  "serve": [L + 16 for L in C.SERVE_LENGTHS]}
    for tag, depths in depth_sets.items():
        for mode, elt in (("bfloat16", 2), ("int8", 1), ("float32", 4)):
            q, pools, table, pos = C._kernel_inputs(torch, mode, 4, gen,
                                                    depths)
            ref = PA.paged_attention_plain(q, *pools[0], table, pos)
            B = len(depths)
            lim = (torch.full((B,), 1e-5, device="cuda")
                   if mode == "float32"
                   else 2e-2 * ref.float().abs().reshape(B, -1).amax(1))
            res = {}
            for R in (32, 64, 128, 256):
                if PA.split_rows(C.KERNEL_SHAPE["hd"], elt, R) != R:
                    continue                 # K and V do not fit
                out = PA.paged_attention(q, *pools[0], table, pos, split=R)
                err = (out.float() - ref.float()).abs().reshape(B, -1) \
                    .amax(1)
                res[R] = {"ms": C._graph_ms(torch, lambda i: PA.paged_attention(
                              q, *pools[i], table, pos, split=R), 4),
                          "worst_err_over_limit": (err / lim).max().item()}
            print(json.dumps({"depths": tag, "pool": mode, "splits": res,
                              "default": PA.split_rows(
                                  C.KERNEL_SHAPE["hd"], elt)}), flush=True)
            del q, pools
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
