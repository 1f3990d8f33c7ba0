#!/usr/bin/env python3
"""Time variants of the W8A16 kernel Q1 (paddle_tpu_torch/csrc/
wo_int8_matmul.cu) against the shipped one at llama3-8b's four distinct
layer shapes, on one CUDA card.

    python3 tools/q1_sweep.py

Each variant is the shipped source with one change, built beside it
with the same nvcc flags into build/q1_sweep/:

  trigger_after_loop  `griddepcontrol.launch_dependents` after the main
                      loop instead of at the block's start;
  no_conversion       the int8 -> bf16 conversion replaced by a copy of
                      the bytes (wrong results: the cost of the
                      conversion);
  no_weight_stream    no weight bytes copied (wrong results: the cost of
                      the rest, the conversion and the tensor cores);
  no_tensor_cores     no wgmma issued (wrong results: the weight stream
                      and the conversion);
  conversion_only     neither weight bytes nor wgmma (wrong results).

One JSON line per (M, variant): the time of one call by CUDA-graph
replay over weight copies past the L2, per shape and as one layer's sum
(wq, wk, wv, wo, wg, wu, wd), in turns (the variants, then again in
reverse); then the card's name and power limit.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
LAYER = (0, 1, 1, 0, 2, 2, 3)           # the seven products' shapes


def _variants(src):
    start = "  __syncthreads();\n  // the next product may launch now"
    trigger = "  griddep_launch_dependents();\n"
    late = "  griddep_wait();          // y, the partials"
    cvt = src[src.index("  const uint32_t u = q ^ 0x80808080u;"):
              src.index("hi = __byte_perm(__float_as_uint(f2")]
    cvt_end = src.index(
        ";", src.index("hi = __byte_perm(__float_as_uint(f2")) + 1
    w_copy = "        for (int c = 0; c < n_live; ++c)\n          bulk_g2s("
    w_bytes = "mbar_expect_tx(full + slot, n_live * (span(s) / 32) * kChunk +"
    mma = "    Wgmma<NW>::rs(acc, a + 4 * u, wg_desc(box + 32 * u, 16, 1024));"
    for piece in (start, trigger, late, cvt, w_copy, w_bytes, mma):
        assert piece in src, piece
    after = src.replace(trigger, "", 1).replace(late, trigger + late)
    no_w = src.replace(w_copy, w_copy.replace("c < n_live", "c < 0")) \
        .replace(w_bytes, w_bytes.replace("n_live *", "0 *"))
    return {
        "shipped": src,
        "trigger_after_loop": after,
        "no_conversion": src[:src.index(cvt)] + "  lo = q;\n  hi = q ^ 1u;"
        + src[cvt_end:],
        "no_weight_stream": no_w,
        "no_tensor_cores": src.replace(mma, "    (void)box;"),
        "conversion_only": no_w.replace(mma, "    (void)box;"),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("q1_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import wo_int8_matmul as Q1
    from paddle_tpu_torch.quantization.int8 import weight_only_int8
    src = (_build.CSRC_DIR / "wo_int8_matmul.cu").read_text()
    out_dir = ROOT / "build" / "q1_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in _variants(src).items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        jobs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].wo_int8_matmul
        fn.argtypes = list(Q1._SIGNATURES["wo_int8_matmul"])
        fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    weights = []
    for K, N in SHAPES:
        copies = 1 + -(-C.Q1_COLD_BYTES // (K * N))
        weights.append([(Q1.pack_weight(q), s) for q, s in (
            weight_only_int8(torch.randn(K, N, device=dev, generator=gen)
                             * 0.02) for _ in range(copies))])
    for M in (8, 64, 128):
        xs = [torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
              for K, _ in SHAPES]
        runs = {}
        for name in list(libs) + list(libs)[::-1]:
            _build._LOADED["wo_int8_matmul"] = libs[name]
            per = [C._graph_ms(torch, lambda i: Q1.wo_int8_matmul(
                xs[j], *weights[j][i % len(weights[j])]), len(weights[j]))
                for j in range(len(SHAPES))]
            runs.setdefault(name, []).append(per)
        for name, (a, b) in runs.items():
            per = [(x + y) / 2 for x, y in zip(a, b)]
            print(json.dumps({"M": M, "variant": name, "shapes": [
                {"K": K, "N": N, "ms": t} for (K, N), t in zip(SHAPES, per)],
                "layer_ms": sum(per[j] for j in LAYER)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
