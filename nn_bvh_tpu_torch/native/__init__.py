"""The C++ binned-SAH BVH builder (port of nn_bvh_tpu/native/), loaded with
ctypes.

`bvh_builder.cpp` is a copy of the JAX package's source. It is compiled with
the system g++ at first use into `build/native/` at the repository root,
named by a hash of the source, the platform and the compiler (a library
that fails to load is rebuilt), and gives the same BVH and `prim_order` as
the JAX package's native build. Without a toolchain (the failed build or load
is reported on stderr) or with NN_BVH_NO_NATIVE set, `build_sah_native`
returns None and callers fall back to the numpy builder, as the JAX
package does. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")

_lib = None
_lib_tried = False


def _so_path() -> str:
    """The library's path, named by a hash of the source, the platform and
    the compiler, so a library built elsewhere is never taken for current."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(f"{sys.platform} {platform.machine()} {platform.libc_ver()}".encode())
    try:
        h.update(subprocess.run(["g++", "--version"], capture_output=True, timeout=30).stdout)
    except (OSError, subprocess.SubprocessError):
        pass
    return os.path.join(BUILD_DIR, f"bvh_builder_{h.hexdigest()[:16]}.so")


def _compile(so_path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        print(f"nn_bvh_tpu_torch.native: build failed ({e}); numpy fallback", file=sys.stderr)
        return False


def _build_lib() -> "ctypes.CDLL | None":
    so_path = _so_path()
    if not os.path.exists(so_path) and not _compile(so_path):
        return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as e:
        print(f"nn_bvh_tpu_torch.native: cannot load {so_path} ({e}); rebuilding",
              file=sys.stderr)
        if not _compile(so_path):
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            print(f"nn_bvh_tpu_torch.native: cannot load the rebuilt library ({e}); "
                  "numpy fallback", file=sys.stderr)
            return None
    lib.nn_bvh_build_sah.restype = ctypes.c_int64
    lib.nn_bvh_build_sah.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def get_lib():
    """The native library, or None if it is unavailable."""
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        _lib = None if os.environ.get("NN_BVH_NO_NATIVE") else _build_lib()
    return _lib


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def build_sah_native(prim_lo: np.ndarray, prim_hi: np.ndarray, max_leaf: int | None = None):
    """Native binned-SAH build -> accel.build.BVH, or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    from ..accel.build import BVH, MAX_LEAF_PRIMS

    if max_leaf is None:
        max_leaf = MAX_LEAF_PRIMS
    n = len(prim_lo)
    prim_lo = np.ascontiguousarray(prim_lo, np.float32)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32)
    cap = max(2 * n, 16)
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_meta = np.empty((cap, 3), np.int32)
    order = np.empty(n, np.int64)
    n_nodes = lib.nn_bvh_build_sah(
        _fptr(prim_lo), _fptr(prim_hi), n, int(max_leaf), _fptr(node_lo), _fptr(node_hi),
        node_meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if n_nodes <= 0:
        return None
    return BVH(node_lo=node_lo[:n_nodes].copy(), node_hi=node_hi[:n_nodes].copy(),
               node_meta=node_meta[:n_nodes].copy(), prim_order=order, n_nodes=int(n_nodes))

