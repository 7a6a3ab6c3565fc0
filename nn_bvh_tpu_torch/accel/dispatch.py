"""Traversal-backend dispatch (port of nn_bvh_tpu/accel/dispatch.py) and
the ray re-sort key (nn_bvh_tpu/accel/pallas_traverse.py:431-458).

`make_intersectors` packs the BVH4 tables once on the host and uploads them
to `device`. The backend follows the device:

- CUDA -> "cuda_bvh4": the hand-written kernel (accel/bvh4_kernel.py); the
  integrator re-sorts its lane state once per bounce;
- CPU  -> "plain": the plain torch traversal, no re-sort (the counterpart of
  the JAX package's XLA backend).

`backend="plain"` on CUDA exists so tests and chip_smoke.py can compare the
kernel with its plain version; it is never chosen automatically.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bvh4, bvh4_kernel
from .traverse import traverse_bvh4_plain
from ..core.rng import M32
from ..geometry.scene import host

BACKENDS = ("cuda_bvh4", "plain")


class Intersectors:
    """Closest-hit and any-hit callables over one scene's device tables.
    `n_calls` counts the traversal calls made through it."""

    def __init__(self, backend: str, nodes: torch.Tensor, tris: torch.Tensor):
        self.backend = backend
        self.nodes = nodes
        self.tris = tris
        self.n_calls = 0
        self._fn = (bvh4_kernel.traverse if backend == "cuda_bvh4"
                    else traverse_bvh4_plain)

    def closest(self, o, d, t_max):
        self.n_calls += 1
        return self._fn(self.nodes, self.tris, o, d, t_max, False)

    def any_hit(self, o, d, t_max):
        self.n_calls += 1
        return self._fn(self.nodes, self.tris, o, d, t_max, True)


def make_intersectors(scene, dbvh, device, backend: str | None = None) -> Intersectors:
    device = torch.device(device)
    if backend is None:
        backend = "cuda_bvh4" if device.type == "cuda" else "plain"
    if backend not in BACKENDS:
        raise ValueError(f"unknown traversal backend {backend!r}")
    if backend == "cuda_bvh4" and device.type != "cuda":
        raise ValueError("the cuda_bvh4 backend needs a CUDA device")
    n = dbvh.n_nodes
    wide = bvh4.collapse_bvh4(host(dbvh.node_lo)[:n], host(dbvh.node_hi)[:n],
                              host(dbvh.node_meta)[:n])
    tris = np.ascontiguousarray(host(scene.tri_p), dtype=np.float32)
    return Intersectors(backend, torch.as_tensor(bvh4.pack_bvh4_cuda(*wide), device=device),
                        torch.as_tensor(tris, device=device))


def _expand_bits6(v: torch.Tensor) -> torch.Tensor:
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def ray_sort_key(o, d, blo, bext, t_max=None) -> torch.Tensor:
    """Sort key (int64 holding the JAX uint32 key): dead bit (21) | 3-bit
    direction octant (18-20) | 18-bit Morton code of the origin cell."""
    octant = (((d[..., 0] < 0).long() << 2) | ((d[..., 1] < 0).long() << 1)
              | (d[..., 2] < 0).long())
    q = torch.clamp((o - blo) / bext * 64.0, 0, 63).long()
    m = ((_expand_bits6(q[..., 2]) << 2) | (_expand_bits6(q[..., 1]) << 1)
         | _expand_bits6(q[..., 0])) & M32
    k = (octant << 18) | (m & 0x3FFFF)
    if t_max is not None:
        k = k | ((t_max < 0).long() << 21)
    return k
