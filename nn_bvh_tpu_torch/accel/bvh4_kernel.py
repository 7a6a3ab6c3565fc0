"""Wrapper of the hand-written CUDA BVH4 traversal (csrc/bvh4_traverse.cu),
the counterpart of nn_bvh_tpu/accel/pallas_bvh4.py.

`traverse` launches the kernel for CUDA tensors and raises on anything it
cannot take; for CPU tensors it runs the plain version
(`traverse.traverse_bvh4_plain`), because the tensors lie on the CPU. There is
no fallback from a failed build or launch.

`n_launches` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from .traverse import Hit, traverse_bvh4_plain

n_launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load("bvh4_traverse")
    vp = ctypes.c_void_p
    lib.bvh4_traverse.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                                  vp, vp, vp, vp, vp]
    lib.bvh4_traverse.restype = ctypes.c_int
    return lib


def _check(name, x, shape, dev):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != len(shape) or any(s is not None and a != s
                                    for a, s in zip(x.shape, shape)):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def traverse(nodes: torch.Tensor, tris: torch.Tensor, o: torch.Tensor,
             d: torch.Tensor, t_max: torch.Tensor, any_hit: bool = False):
    """nodes (W,4,8) f32 (bvh4.pack_bvh4_cuda), tris (N,3,3) f32, o/d (R,3)
    f32, t_max (R,) f32. Closest-hit -> Hit; any-hit -> (R,) bool occluded."""
    global n_launches
    if o.device.type == "cpu":
        return traverse_bvh4_plain(nodes, tris, o, d, t_max, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"no BVH4 traversal for device {o.device}")
    dev = o.device
    R = o.shape[0]
    _check("nodes", nodes, (None, 4, 8), dev)
    _check("tris", tris, (None, 3, 3), dev)
    _check("o", o, (R, 3), dev)
    _check("d", d, (R, 3), dev)
    _check("t_max", t_max, (R,), dev)
    if R >= 2 ** 31:
        raise ValueError(f"{R} rays exceed the kernel's int32 ray count")

    prim = torch.empty(R, dtype=torch.int32, device=dev)
    if any_hit:
        t = b1 = b2 = None
    else:
        t = torch.empty(R, dtype=torch.float32, device=dev)
        b1 = torch.empty(R, dtype=torch.float32, device=dev)
        b2 = torch.empty(R, dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().bvh4_traverse(
            nodes.data_ptr(), tris.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), R, int(any_hit), ptr(t), prim.data_ptr(), ptr(b1),
            ptr(b2), stream)
    if rc != 0:
        raise RuntimeError(f"bvh4_traverse launch failed: cudaError {rc}")
    if R:
        n_launches += 1
    if any_hit:
        return prim >= 0
    return Hit(t=t, prim=prim, b1=b1, b2=b2)
