"""What the traversal kernel wrappers share: the input checks and the call
of a kernel's C entry (`csrc/*_traverse.cu`, all with one signature, see
`trav::launch` in csrc/traverse_common.cuh).

A kernel launches on PyTorch's current stream and allocates nothing; the
outputs are allocated here. A launch the runtime refuses raises.

`n_launches` counts the launches of each kernel by name (and nothing else),
so a run can show that its main path went through the kernels; `clear()`
resets it.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .traverse import Hit

n_launches: collections.Counter = collections.Counter()

_VP = ctypes.c_void_p
ARGTYPES = [_VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int,
            _VP, _VP, _VP, _VP, _VP]


def check(name, x, shape, dev):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != len(shape) or any(s is not None and a != s
                                    for a, s in zip(x.shape, shape)):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name, x):
    """The kernels read node and triangle records as float4."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def launch(entry, name: str, nodes: torch.Tensor, node_shape: tuple,
           tris: torch.Tensor, tri_shape: tuple, o: torch.Tensor, d: torch.Tensor,
           t_max: torch.Tensor, any_hit: bool):
    """Check the inputs of CUDA tensors, run the C entry `entry` (ctypes) of
    kernel `name` on them. `tri_shape` is the triangle table the kernel
    reads: (None, 3, 3) vertices or (None, 3, 4) records. Closest-hit -> Hit;
    any-hit -> (R,) bool occluded."""
    if o.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {o.device}")
    dev = o.device
    R = o.shape[0]
    check("nodes", nodes, node_shape, dev)
    check("tris", tris, tri_shape, dev)
    check_aligned("nodes", nodes)
    check_aligned("tris", tris)
    check("o", o, (R, 3), dev)
    check("d", d, (R, 3), dev)
    check("t_max", t_max, (R,), dev)
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
        rc = entry(nodes.data_ptr(), tris.data_ptr(), o.data_ptr(), d.data_ptr(),
                   t_max.data_ptr(), R, int(any_hit), ptr(t), prim.data_ptr(),
                   ptr(b1), ptr(b2), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    if R:
        n_launches[name] += 1
    if any_hit:
        return prim >= 0
    return Hit(t=t, prim=prim, b1=b1, b2=b2)
