"""The card a run uses (or the CPU, for the harness's own tests), and the
result line's `device` block."""

from __future__ import annotations

from types import SimpleNamespace


def open_device(torch, ctx) -> SimpleNamespace:
    """This rank's CUDA card, made current, or ctx.device when a test
    passes one -> (dev, cuda, sync)."""
    cuda = ctx.device is None
    dev = torch.device("cuda", ctx.rank) if cuda else torch.device(ctx.device)
    if cuda:
        torch.cuda.set_device(dev)
    return SimpleNamespace(dev=dev, cuda=cuda,
                           sync=torch.cuda.synchronize if cuda else (lambda: None))


def peak_bytes(torch, d) -> int:
    return int(torch.cuda.max_memory_allocated(d.dev)) if d.cuda else 0


def info(torch, d, count: int, peak: int) -> dict:
    return {"platform": "gpu" if d.cuda else "cpu",
            "kind": torch.cuda.get_device_name(d.dev) if d.cuda else "cpu",
            "count": count, "memory_peak_bytes": int(peak)}
