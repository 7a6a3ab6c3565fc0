"""The per-lane gather of material records, and its gradient on CUDA by the
hand-written segment sum of csrc/material_grad.cu.

`gather(table, ids)` is `table[clamp(ids, 0)]`, the row of the (M, C)
material table (bxdf.material_records) each lane's material id names; a
missed lane (id -1) reads row 0. Made with a graph (the table requires grad)
on a CUDA device, it goes through `_GatherRows`, whose forward is the same
aten gather and whose backward is the kernel: PyTorch's own backward of the
gather (index_put_ with accumulate) gives one warp to each distinct id, and
a wave's lanes share a handful of ids. On the CPU, and without a graph, it is
the plain gather and its aten backward, which is the plain version the
kernel is held against. There is no fallback from a failed build or launch.

`kernel_launch.n_launches[NAME]` counts the kernel's launches, two a call
(the blocks' partial sums, then their sum); the counter
"grad/material lanes" (utils/stats.py) counts the lanes of every gather
made with a graph, on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..accel import kernel_launch
from ..utils import stats

NAME = "material_grad"
MAX_COLUMNS = 256  # a block's threads: one column each at least
BLOCKS_PER_SM = 2  # pass 1's blocks a SM: kBlocksPerSM of the .cu file

_VP = ctypes.c_void_p


@functools.cache
def _entry():
    lib = kernels.load(NAME)
    fn = lib.material_grad
    fn.argtypes = [_VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP,
                   _VP]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def segment_sum(grad: torch.Tensor, ids: torch.Tensor, M: int) -> torch.Tensor:
    """(M, C) float32: out[m] = the sum of grad's rows whose id, clamped to
    >= 0, is m, by the kernel. grad (..., C) float32, contiguous and 16-byte
    aligned, ids (...) int32 contiguous, both on one CUDA device; raises on
    anything else before any launch."""
    if grad.dtype != torch.float32:
        raise TypeError(f"grad must be float32, got {grad.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if grad.dim() < 1 or grad.shape[:-1] != ids.shape:
        raise ValueError(f"grad {tuple(grad.shape)} is not (*ids.shape, C) for ids "
                         f"{tuple(ids.shape)}")
    if not grad.is_contiguous() or not ids.is_contiguous():
        raise ValueError("grad and ids must be contiguous")
    if ids.device != grad.device:
        raise ValueError(f"ids are on {ids.device}, grad on {grad.device}")
    if grad.device.type != "cuda":
        raise ValueError(f"{NAME} runs on CUDA tensors, got {grad.device}")
    if grad.data_ptr() % 16:
        raise ValueError("grad must start on a 16-byte boundary")
    C, R = grad.shape[-1], ids.numel()
    if not 1 <= C <= MAX_COLUMNS:
        raise ValueError(f"{C} columns: the kernel takes 1 to {MAX_COLUMNS}")
    if M < 1 or R >= 2 ** 31:
        raise ValueError(f"{M} rows and {R} lanes: the kernel takes M >= 1 and R < 2**31")
    entry = _entry()
    dev = grad.device
    n_blocks = BLOCKS_PER_SM * _sm_count(dev.index if dev.index is not None else
                                  torch.cuda.current_device())
    part = torch.empty(n_blocks, M, C, dtype=torch.float32, device=dev)
    out = torch.empty(M, C, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(grad.data_ptr(), ids.data_ptr(), R, C, M, n_blocks, part.data_ptr(),
                   out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    kernel_launch.n_launches[NAME] += 2
    return out


def segment_sum_plain(grad: torch.Tensor, ids: torch.Tensor, M: int) -> torch.Tensor:
    """(M, C) float64: the same sum by index_add_ in float64, the reference
    the kernel is held against."""
    idx = torch.clamp(ids.reshape(-1), min=0).long()
    flat = grad.reshape(-1, grad.shape[-1]).to(torch.float64)
    return torch.zeros(M, grad.shape[-1], dtype=torch.float64,
                       device=grad.device).index_add_(0, idx, flat)


class _GatherRows(torch.autograd.Function):
    """table[clamp(ids, 0)] with the segment-sum backward (CUDA)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids.to(torch.int32).contiguous())
        ctx.rows = table.shape[0]
        return table[torch.clamp(ids, min=0).long()]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return segment_sum(grad, ids, ctx.rows), None


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(..., C) rows table[clamp(ids, 0)] of the (M, C) table for ids (...)."""
    if table.requires_grad and torch.is_grad_enabled():
        stats.count("grad/material lanes", ids.numel())
        if table.is_cuda:
            return _GatherRows.apply(table, ids)
    return table[torch.clamp(ids, min=0).long()]
