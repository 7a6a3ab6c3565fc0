"""Wrapper of the hand-written CUDA binary-BVH traversal
(csrc/binary_traverse.cu), the counterpart of
nn_bvh_tpu/accel/pallas_traverse.py (stack 64, entry `binary_traverse`) and
nn_bvh_tpu/accel/hbm_traverse.py (stack 128 for deep trees, entry
`binary_traverse_deep`).

`traverse` launches the kernel for CUDA tensors and raises on anything it
cannot take; for CPU tensors it runs the plain version
(`traverse.traverse_binary_plain`), because the tensors lie on the CPU. There
is no fallback from a failed build or launch. The node table must come from
`binary.pack_binary_pairs(..., stack_depth=stack)`, which checks the depth;
the triangles are 16-byte records (`bvh4.pack_tris_cuda`).
`kernel_launch.n_launches` counts the launches of each entry by its name.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from . import kernel_launch
from .traverse import traverse_binary_plain

SOURCE = "binary_traverse"
ENTRIES = {64: "binary_traverse", 128: "binary_traverse_deep"}  # by stack depth
NODE_SHAPE = (None, 16)
TRI_SHAPE = (None, 3, 4)


@functools.cache
def _entry(name: str):
    fn = getattr(kernels.load(SOURCE), name)
    fn.argtypes = kernel_launch.ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def traverse(nodes: torch.Tensor, tris: torch.Tensor, o: torch.Tensor,
             d: torch.Tensor, t_max: torch.Tensor, any_hit: bool = False,
             stack: int = 64):
    """nodes (1+Ni,16) f32 (binary.pack_binary_pairs), tris (N,3,4) f32
    records (bvh4.pack_tris_cuda), o/d (R,3) f32, t_max (R,) f32; stack 64
    or 128 entries per ray.
    Closest-hit -> Hit; any-hit -> (R,) bool occluded."""
    if stack not in ENTRIES:
        raise ValueError(f"no binary traversal with a {stack}-entry stack")
    if o.device.type == "cpu":
        return traverse_binary_plain(nodes, tris, o, d, t_max, any_hit, stack)
    name = ENTRIES[stack]
    return kernel_launch.launch(_entry(name), name, nodes, NODE_SHAPE, tris, TRI_SHAPE,
                                o, d, t_max, any_hit)
