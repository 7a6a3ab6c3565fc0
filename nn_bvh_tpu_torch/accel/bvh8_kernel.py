"""Wrapper of the hand-written CUDA BVH8 traversal (csrc/bvh8_traverse.cu),
the counterpart of nn_bvh_tpu/accel/pallas_bvh8.py.

`traverse` launches the kernel for CUDA tensors and raises on anything it
cannot take; for CPU tensors it runs the plain version
(`traverse.traverse_bvh8_plain`), because the tensors lie on the CPU. There is
no fallback from a failed build or launch.
`kernel_launch.n_launches[NAME]` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from . import kernel_launch
from .traverse import traverse_bvh8_plain

NAME = "bvh8_traverse"


@functools.cache
def _entry():
    fn = kernels.load(NAME).bvh8_traverse
    fn.argtypes = kernel_launch.ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def traverse(nodes: torch.Tensor, tris: torch.Tensor, o: torch.Tensor,
             d: torch.Tensor, t_max: torch.Tensor, any_hit: bool = False):
    """nodes (W,8,8) f32 (bvh8.pack_bvh8_cuda), tris (N,3,4) f32 records
    (bvh4.pack_tris_cuda), o/d (R,3) f32, t_max (R,) f32. Closest-hit ->
    Hit; any-hit -> (R,) bool occluded."""
    if o.device.type == "cpu":
        return traverse_bvh8_plain(nodes, tris, o, d, t_max, any_hit)
    return kernel_launch.launch(_entry(), NAME, nodes, (None, 8, 8), tris,
                                (None, 3, 4), o, d, t_max, any_hit)
