"""Build and load the port's CUDA kernels.

Each `paddle_tpu_torch/csrc/<name>.cu` is compiled at first use by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/paddle_tpu_torch/lib<name>-<hash>.so

into a shared library with a plain C interface, loaded with `ctypes`.
The file name carries a hash of the sources and flags, so an edited
source never loads a stale library, and a finished build is reused by
later processes of the same checkout.  `build()` starts one `nvcc` per
source, all at once, and waits for all of them; ptxas's register and
shared-memory report is kept beside each library (`.log`).

A failed build raises: there is no fallback to the plain versions on a
CUDA tensor.  Nothing here runs at import time — the CPU test suite
imports every module, and only a launch on the card builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "build",
           "load", "nvcc_path"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}           # name -> ctypes.CDLL, one load per process


def sources() -> list:
    """Kernel names: one per `csrc/*.cu`."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): cannot build the CUDA "
                       "kernels")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")) + sorted(CSRC_DIR.glob("*.h")):
        if p.suffix != ".cu" or p.stem == name:   # own source + headers
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile `names` (default: every source) in parallel; returns
    {name: path of the library}.  Raises with nvcc's output when any
    build fails."""
    names = sources() if names is None else list(names)
    jobs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT,
                                       text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)        # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, building it first if
    needed.  `signatures` maps each C function to its argtypes; every
    function returns an int (a cudaError_t)."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
