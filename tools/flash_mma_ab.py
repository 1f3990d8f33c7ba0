#!/usr/bin/env python3
"""Compare K1/K2's bias + dropout kernels of two checkouts on one CUDA
card: chip_smoke.py's ernie_kernels phase (every case on the mma and the
fma kernels against the plain versions, bitwise twice; then the mma and
fma kernels timed in turns by CUDA-graph replay at five shapes) run in
each checkout, one process a run, in the order A, B, B, A
(`--rounds N` times over).

    python3 tools/flash_mma_ab.py [--rounds N] OTHER [OTHER ...]

A is each OTHER checkout (for example a `git archive` of the parent
commit unpacked into `build/`), B this one.  Each run builds its own
kernels in its checkout's `build/`.  Prints one JSON line a run (the
checkout, whether every check passed, the fp32 mma kernels' registers
and spill bytes from ptxas, and per timed shape {kernel: [mma ms, fma
ms]}), then the card's name and power limit.
"""

import json
import re
import sys

import _ab


def one_run(root: str) -> int:
    """ernie_kernels in checkout `root`; prints its JSON line."""
    import torch
    sys.path.insert(0, root)
    import chip_smoke as C
    from paddle_tpu_torch.ops import _build
    libs = _build.build(["flash_attention_mma", "flash_attention_mma_bf16",
                         "flash_attention_extra", "flash_attention"])
    log = libs["flash_attention_mma"].with_suffix(".log").read_text()
    regs = {}
    for m in re.finditer(r"Compiling entry function '\w*?flash_(\w+?)_mma_"
                         r"kernelIfLi(\d+)E\w*'(.*?)(?=Compiling|\Z)", log,
                         re.S):
        r = re.search(r"Used (\d+) registers", m.group(3))
        s = re.search(r"(\d+) bytes spill stores", m.group(3))
        regs[f"{m.group(1)} D{m.group(2)}"] = [
            int(r.group(1)) if r else None, int(s.group(1)) if s else None]
    timed = {}
    emit = C.emit

    def keep(obj):
        if "timed" in obj:
            timed[obj["timed"]] = {
                k: [v["ms"], v["fma_ms"]] for k, v in obj.items()
                if k.startswith("flash_attention")}
    C.emit = keep
    ok = True
    try:
        C.phase_ernie_kernels(torch)
    except AssertionError as e:
        ok = False
        print(f"check failed in {root}: {e}", file=sys.stderr)
    finally:
        C.emit = emit
    print(json.dumps({"checkout": root, "checks_passed": ok,
                      "fp32_mma_registers_spills": regs, "timed": timed}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, one_run))
