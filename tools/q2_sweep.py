#!/usr/bin/env python3
"""Where the time of kernel Q2's wgmma route goes (paddle_tpu_torch/csrc/
int8_linear.cu, M > 64), on one CUDA card.

    python3 tools/q2_sweep.py

Each variant is the shipped source with one change, built beside it with
the same nvcc flags into build/q2_sweep/:

  no_pdl       the product launched without programmatic serialization
               (it starts when the quantization pass has ended);
  no_product   the wgmma kernel is not launched (the quantization pass
               alone);
  no_quant     the quantization pass is not launched (the product alone,
               on a stale xq: wrong results);
  no_stores    the epilogue computes but stores nothing (wrong results:
               the cost of writing y);
  no_wgmma     no wgmma issued (wrong results: the TMA ring and the
               epilogue);

One JSON line a (shape, variant): the time of one call of the default
route by CUDA-graph replay, in turns (the variants, then again in
reverse); then the card's name and power limit.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [("ffn in", 2048, 768, 3072), ("ffn out", 2048, 3072, 768),
          ("q / k / v / out", 2048, 768, 768),
          ("ffn in M 128", 128, 768, 3072),
          ("conv1 im2col", 32 * 112 * 112, 3 * 7 * 7, 64)]


def _variants(src):
    product = "  return static_cast<int>(cudaLaunchKernelEx("
    pdl = "attr.val.programmaticStreamSerializationAllowed = 1;"
    quant = "  if (vec_in)\n    int8_linear_quant_kernel<T, 16>"
    store = "        if (row < M && col < N) {"
    at = src.index("wgmma_m64n128_s8(acc, wg_desc(")
    mma = src[at:src.index(";", at) + 1]
    for piece in (product, pdl, quant, store, mma):
        assert piece in src, piece
    return {
        "shipped": src,
        "no_pdl": src.replace(pdl, pdl.replace("= 1", "= 0")),
        "no_product": src.replace(product, "  if (M > 0) return 0;\n"
                                  + product),
        "no_quant": src.replace(quant, "  if (M < 0)\n" + quant),
        "no_stores": src.replace(store,
                                 "        if (row < M && col < N && M < 0) {"),
        "no_wgmma": src.replace(mma, "(void)a, (void)b;"),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("q2_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import int8_linear as Q2
    from paddle_tpu_torch.quantization import int8 as TI
    src = (_build.CSRC_DIR / "int8_linear.cu").read_text()
    out_dir = ROOT / "build" / "q2_sweep"
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
        fn = libs[name].int8_linear
        fn.argtypes = list(Q2._SIGNATURES["int8_linear"])
        fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(26)
    for label, M, K, N in SHAPES:
        x = torch.randn(M, K, device="cuda", generator=gen)
        wq, ws = TI.quantize_weight(
            0.02 * torch.randn(K, N, device="cuda", generator=gen), 1)
        wt = Q2.pack_weight(wq)
        b = 0.1 * torch.randn(N, device="cuda", generator=gen)
        xs = float(x.abs().max()) / 127.0 * 0.9
        runs = {}
        for name in list(libs) + list(libs)[::-1]:
            _build._LOADED["int8_linear"] = libs[name]
            runs.setdefault(name, []).append(C._graph_ms(
                torch, lambda i: Q2.int8_linear(x, None, ws, b, xs, wt), 1))
        for name, t in runs.items():
            print(json.dumps({"shape": label, "M": M, "K": K, "N": N,
                              "variant": name, "ms": sum(t) / len(t),
                              "turns_ms": t}), flush=True)
        del x, wq, ws, wt, b
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
