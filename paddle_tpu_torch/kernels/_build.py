"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled on its own by nvcc for
Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared library
with a plain C interface under ``build/paddle_tpu_torch/`` beside the
package, and loaded with ctypes. No PyTorch header is included, so a build
takes seconds, not minutes. The library's file name carries a hash of its
source and flags, so an edited source never loads a stale build. Builds
happen at first use (or all at once through `build_all`, one nvcc process
per source, all started together), never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load"]

SOURCES = ("flash_attention_fwd", "paged_decode")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

# name -> loaded library; filled once per process by `load`
_LIBS = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the paddle_tpu_torch kernels")


def _lib_path(name, extra):
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_FLAGS + extra).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES, ptxas_info=False):
    """Compile every source in `names` that has no current build, one nvcc
    process each, all running at once. Returns ``(seconds, logs)`` where
    `logs` maps each name built now to nvcc's output (with
    ``ptxas_info=True``: registers, shared memory and spills per kernel).
    Raises with nvcc's output when a build fails."""
    extra = ("-Xptxas=-v",) if ptxas_info else ()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _lib_path(name, ())
        if out.exists() and not ptxas_info:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, *extra, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0, logs


def load(name):
    """The loaded library for source `name`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _, out = _lib_path(name, ())
        if not out.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib
