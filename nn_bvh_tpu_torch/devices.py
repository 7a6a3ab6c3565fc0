"""The device an entry point of the port runs on.

Entry points run on the CUDA card unless the caller asks for the CPU: by a
`device=` argument, or by handing in a scene whose tables are already
tensors on the CPU (that scene keeps its own device). Without a card and
without such a request they raise; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, scene=None) -> torch.device:
    """`device` when given, else the device of a scene made of tensors, else
    the current CUDA card."""
    if device is not None:
        return torch.device(device)
    tri_p = getattr(scene, "tri_p", None)
    if isinstance(tri_p, torch.Tensor):
        return tri_p.device
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device is available: pass device='cpu' (or a "
                         "scene of CPU tensors) to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def full_float32() -> None:
    """Float32 products and convolutions on the card in full float32 (TF32
    off) for the rest of the process, so that a learner's step on the card
    can be held against the CPU's. Process-wide: only an entry point that
    owns its process (the learner's CLIs, chip_smoke's learner phase) calls
    it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
