"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain `extern "C"` entry and is compiled by
nvcc into a shared library at first use, then loaded with ctypes. The library
lands in `build/kernels/` at the repository root, named by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited source
rebuilds and an unchanged one is reused. `build` compiles several sources at
once, one nvcc process each, and keeps each build's ptxas report beside its
library (`ptxas_log`). Nothing here runs at import: the CPU-only test
environment imports every module and has no nvcc.

A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

# -fmad=false: the kernels round like their plain torch versions (no
# contraction into FMA), so a mismatch between the two is a logic error.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(*names: str) -> None:
    """Compile every `csrc/<name>.cu` that has no library yet, all at once."""
    todo = [n for n in names if not os.path.exists(_so_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = f"{_so_path(name)}.tmp{os.getpid()}"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            err += "\nnvcc timed out after 600 s"
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{err}")
            continue
        with open(f"{_so_path(name)}.ptxas", "w") as f:
            f.write(err)
        os.replace(tmp, _so_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if needed and return the loaded library."""
    build(name)
    return ctypes.CDLL(_so_path(name))


def ptxas_log(name: str) -> str:
    """The ptxas report (-Xptxas -v) of the library of `csrc/<name>.cu`,
    written when it was built."""
    with open(f"{_so_path(name)}.ptxas") as f:
        return f.read()


def ptxas_lines(log: str) -> list:
    """The entry, register, stack-frame and spill lines of a ptxas report."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def spill_bytes(log: str) -> int:
    """Bytes of spill stores and spill loads over every entry of a ptxas
    report; raises when the report states none (not a -Xptxas -v log)."""
    found = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
    if not found:
        raise ValueError("the ptxas report has no spill lines")
    return sum(int(n) for n in found)
