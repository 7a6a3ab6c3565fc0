"""Wrapper of the hand-written CUDA BVH4 traversal (csrc/bvh4_traverse.cu),
the counterpart of nn_bvh_tpu/accel/pallas_bvh4.py.

`traverse` launches the kernel for CUDA tensors and raises on anything it
cannot take, among them an (N, 3, 3) triangle table: the kernel reads the
16-byte records of `bvh4.pack_tris_cuda`. For CPU tensors it runs the plain
version (`traverse.traverse_bvh4_plain`, which takes either table), because
the tensors lie on the CPU. There is no fallback from a failed build or
launch. `kernel_launch.n_launches[NAME]` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from . import kernel_launch
from .traverse import traverse_bvh4_plain

NAME = "bvh4_traverse"
TRI_SHAPE = (None, 3, 4)


@functools.cache
def _entry():
    fn = kernels.load(NAME).bvh4_traverse
    fn.argtypes = kernel_launch.ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def traverse(nodes: torch.Tensor, tris: torch.Tensor, o: torch.Tensor,
             d: torch.Tensor, t_max: torch.Tensor, any_hit: bool = False):
    """nodes (W,4,8) f32 (bvh4.pack_bvh4_cuda), tris (N,3,4) f32
    (bvh4.pack_tris_cuda), o/d (R,3) f32, t_max (R,) f32. Closest-hit -> Hit;
    any-hit -> (R,) bool occluded."""
    if o.device.type == "cpu":
        return traverse_bvh4_plain(nodes, tris, o, d, t_max, any_hit)
    return kernel_launch.launch(_entry(), NAME, nodes, (None, 4, 8), tris, TRI_SHAPE,
                                o, d, t_max, any_hit)
