"""Traversal-backend dispatch (port of nn_bvh_tpu/accel/dispatch.py) and
the ray re-sort key and sorted intersector
(nn_bvh_tpu/accel/pallas_traverse.py:431-481).

`make_intersectors` packs one backend's tables once on the host and uploads
them to the device: its node table, and the triangles as 16-byte records
(`bvh4.pack_tris_cuda`) for every backend but "plain", which reads the
(N, 3, 3) vertices as the JAX package's XLA backend does.
Every traversal backend of the JAX package has a hand-written CUDA kernel
here, and each kernel a plain torch version:

| backend (CUDA)     | plain twin          | JAX backend (TPU kernel)                   |
| cuda_bvh4          | plain               | bvh4 (pallas_bvh4._traverse_bvh4)          |
| cuda_binary        | plain_binary        | pallas_vmem (pallas_traverse, stack 64)    |
| cuda_binary_deep   | plain_binary_deep   | pallas_hbm (hbm_traverse, stack 128)       |
| cuda_bvh8          | plain_bvh8          | pallas_bvh8 (pallas_bvh8._traverse_bvh8)   |

With `backend=None` the backend follows the device: the plain BVH4
traversal ("plain", the counterpart of the JAX package's XLA backend) on the
CPU, "cuda_bvh4" on CUDA, or the kernel that `BVH_BACKEND=bvh4|binary|hbm|
bvh8` names, as the JAX package's `BVH_BACKEND` does on a non-CPU backend
(dispatch.py:194-225). The TPU picks among its kernels by VMEM budgets
(pallas_bvh4.py:51-54, pallas_traverse.py:52) and falls back to the HBM
kernel when a scene does not fit; an H100 reads every table from device
memory through its caches, so those budgets have no counterpart and the
automatic choice on CUDA is always "cuda_bvh4". Asking for a CUDA backend on
the CPU raises.

The plain backends on CUDA exist so tests and chip_smoke.py can compare each
kernel with its plain version; they are never chosen automatically. The
wavefront integrator re-sorts its lane state once per bounce for every CUDA
backend; `sort=True` wraps the callables in the same key's sort -> traverse
-> unsort instead, for standalone batches.

Analytic quadrics (geometry/quadrics.py) stay out of the BVH: after the
triangle traversal (and its unsort) every ray is tested against every
quadric as an (R, Q) broadcast and the nearer hit wins, on every backend;
quadric prim ids are quad_base + q. Object motion blur lerps the vertices
once a wave (wavefront/integrator.make_wave_fn); `set_triangles` then
rebuilds the triangle table on the device from them, with the subtraction
`bvh4.pack_tris_cuda` makes, while the node table, built over the union of
both keyframes' bounds, stays as it is.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import binary, binary_kernel, bvh4, bvh4_kernel, bvh8, bvh8_kernel
from ..geometry import quadrics as quadrics_mod
from .traverse import Hit, traverse_binary_plain, traverse_bvh4_plain, traverse_bvh8_plain
from ..core.rng import M32
from ..devices import resolve_device
from ..geometry.scene import host

# backend -> (node layout, traversal function)
_BACKENDS = {
    "cuda_bvh4": ("bvh4", bvh4_kernel.traverse),
    "cuda_binary": ("binary", functools.partial(binary_kernel.traverse, stack=64)),
    "cuda_binary_deep": ("binary_deep", functools.partial(binary_kernel.traverse, stack=128)),
    "cuda_bvh8": ("bvh8", bvh8_kernel.traverse),
    "plain": ("bvh4", traverse_bvh4_plain),
    "plain_binary": ("binary", functools.partial(traverse_binary_plain, stack_depth=64)),
    "plain_binary_deep": ("binary_deep",
                          functools.partial(traverse_binary_plain, stack_depth=128)),
    "plain_bvh8": ("bvh8", traverse_bvh8_plain),
}
BACKENDS = tuple(_BACKENDS)
CUDA_BACKENDS = tuple(b for b in BACKENDS if b.startswith("cuda_"))
# BVH_BACKEND values (the JAX package's names) -> CUDA backend
ENV_BACKENDS = {"bvh4": "cuda_bvh4", "binary": "cuda_binary",
                "hbm": "cuda_binary_deep", "bvh8": "cuda_bvh8"}


class Intersectors:
    """Closest-hit and any-hit callables over one scene's device tables
    (`tables`: node table, triangle table; `quads`: (quad_type,
    quad_params) or None). `n_calls` counts the traversal calls made
    through it."""

    def __init__(self, backend: str, tables: tuple, device: torch.device,
                 sort_bounds=None, quads=None, quad_base: int = 0):
        self.backend = backend
        self.tables = tables
        self.device = device
        self.sort_bounds = sort_bounds
        self.quads = quads
        self.quad_base = quad_base
        self.n_calls = 0
        self.fn = _BACKENDS[backend][1]

    def like(self):
        """The constructor arguments of this bundle, for a wrapper's
        super().__init__."""
        return dict(backend=self.backend, tables=self.tables, device=self.device,
                    sort_bounds=self.sort_bounds, quads=self.quads,
                    quad_base=self.quad_base)

    def set_triangles(self, tri_p: torch.Tensor) -> None:
        """Rebuild the triangle table from (N, 3, 3) vertices on the device
        (a motion-blurred scene's vertices at a wave's shutter time)."""
        self.tables = (self.tables[0], tri_table_device(self.backend, tri_p))

    def _traverse(self, o, d, t_max, any_hit):
        if self.sort_bounds is None:
            return self.fn(*self.tables, o, d, t_max, any_hit)
        blo, bext = self.sort_bounds
        order = torch.argsort(ray_sort_key(o, d, blo, bext, t_max), stable=True)
        out = self.fn(*self.tables, o[order].contiguous(), d[order].contiguous(),
                      t_max[order].contiguous(), any_hit)
        unsort = lambda x: torch.empty_like(x).index_copy_(0, order, x)
        return unsort(out) if any_hit else Hit(*map(unsort, out))

    def _call(self, o, d, t_max, any_hit):
        self.n_calls += 1
        out = self._traverse(o, d, t_max, any_hit)
        if self.quads is None:
            return out
        qtype, qparams = self.quads
        if any_hit:
            return out | quadrics_mod.intersect_any(qtype, qparams, o, d, t_max)
        eff = torch.where(torch.isfinite(out.t), out.t, t_max)
        tq, qi, u, v = quadrics_mod.intersect(qtype, qparams, o, d, eff)
        take = qi >= 0  # tq < eff already
        return Hit(t=torch.where(take, tq, out.t),
                   prim=torch.where(take, self.quad_base + qi, out.prim).to(torch.int32),
                   b1=torch.where(take, u, out.b1), b2=torch.where(take, v, out.b2))

    def closest(self, o, d, t_max):
        return self._call(o, d, t_max, False)

    def any_hit(self, o, d, t_max):
        return self._call(o, d, t_max, True)


def _tri_table(backend: str, scene) -> np.ndarray:
    """Every backend but "plain" reads 16-byte records, "plain" (N, 3, 3)."""
    tri_p = np.ascontiguousarray(host(scene.tri_p), dtype=np.float32)
    return tri_p if backend == "plain" else bvh4.pack_tris_cuda(tri_p)


def tri_table_device(backend: str, tri_p: torch.Tensor) -> torch.Tensor:
    """_tri_table of (N, 3, 3) float32 vertices already on the device: the
    16-byte records [v0, 0 | v1 - v0, 0 | v2 - v0, 0] subtracted in float32
    as bvh4.pack_tris_cuda subtracts them, or the vertices for "plain"."""
    tri_p = tri_p.contiguous()
    if backend == "plain":
        return tri_p
    out = torch.zeros(tri_p.shape[0], 3, 4, dtype=torch.float32, device=tri_p.device)
    out[:, 0, :3] = tri_p[:, 0]
    out[:, 1, :3] = tri_p[:, 1] - tri_p[:, 0]
    out[:, 2, :3] = tri_p[:, 2] - tri_p[:, 0]
    return out


def _node_table(layout: str, dbvh) -> np.ndarray:
    n = dbvh.n_nodes
    lo, hi, meta = (host(x)[:n] for x in (dbvh.node_lo, dbvh.node_hi, dbvh.node_meta))
    if layout == "bvh4":
        return bvh4.pack_bvh4_cuda(*bvh4.collapse_bvh4(lo, hi, meta))
    if layout == "bvh8":
        return bvh8.pack_bvh8_cuda(*bvh8.collapse_bvh8(lo, hi, meta))
    return binary.pack_binary_pairs(lo, hi, meta, 128 if layout == "binary_deep" else 64)


def default_backend(device: torch.device) -> str:
    """The backend of backend=None: "plain" on the CPU; on CUDA the kernel
    that BVH_BACKEND names, cuda_bvh4 when it is unset or names no kernel
    (as the JAX package falls back to bvh4 for any other value)."""
    if device.type != "cuda":
        return "plain"
    return ENV_BACKENDS.get(os.environ.get("BVH_BACKEND", ""), "cuda_bvh4")


def make_intersectors(scene, dbvh, device=None, backend: str | None = None,
                      sort: bool = False) -> Intersectors:
    """Pack and upload the tables of `backend` (default_backend when None)
    on `device` (devices.resolve_device)."""
    device = resolve_device(device, scene)
    if backend is None:
        backend = default_backend(device)
    if backend not in _BACKENDS:
        raise ValueError(f"unknown traversal backend {backend!r}")
    if backend in CUDA_BACKENDS and device.type != "cuda":
        raise ValueError(f"the {backend} backend needs a CUDA device")
    nodes = _node_table(_BACKENDS[backend][0], dbvh)
    tris = _tri_table(backend, scene)
    sort_bounds = None
    if sort:
        b = np.asarray(host(scene.bounds), np.float32)
        blo = torch.as_tensor(b[0], device=device)
        sort_bounds = (blo, torch.clamp(torch.as_tensor(b[1], device=device) - blo, min=1e-9))
    quads = None
    if int(getattr(scene, "n_quadrics", 0) or 0):
        quads = (torch.as_tensor(host(scene.quad_type), device=device).to(torch.int32),
                 torch.as_tensor(host(scene.quad_params), device=device).to(torch.float32))
    # quadric prim ids start at the padded triangle count (tri_shade's
    # appended rows)
    return Intersectors(backend, (torch.as_tensor(nodes, device=device),
                                  torch.as_tensor(tris, device=device)),
                        device, sort_bounds, quads=quads, quad_base=int(scene.tri_p.shape[0]))


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
