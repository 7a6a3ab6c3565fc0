"""Shared tensor ops for the neural spatial-split (treeNet) learner (port of
nn_bvh_tpu/learn/common.py).

- SAH/point variant: clouds are (B, N, 3) point clouds.
- EPO/primitive variant: clouds are (B, N, 9) primitive clouds
  (x1 x2 x3 | y1 y2 y3 | z1 z2 z3 vertex layout).
- Node axes are batched: a level's K = 6^level nodes are one tensor axis.
- Bounds are (..., 6) = [min_xyz | max_xyz].

Masked reductions fill with +-BIG. The masks carry no gradient
(`.detach()`, JAX's stop_gradient).
"""

from __future__ import annotations

import torch

BIG = 1e9


def build_mask_points(points: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Points-in-box mask: points (..., N, 3), bounds (..., 6) -> (..., N)
    float 0/1, without gradient."""
    bmin = bounds[..., None, 0:3]
    bmax = bounds[..., None, 3:6]
    inside = ((points >= bmin) & (points <= bmax)).all(-1)
    return inside.to(torch.float32).detach()


def prim_axis_points(prims: torch.Tensor, axis: int) -> torch.Tensor:
    """(..., N, 9) primitive cloud -> (..., N, 3) per-vertex coords along axis."""
    return prims[..., 3 * axis:3 * axis + 3]


def prim_vertices(prims: torch.Tensor) -> torch.Tensor:
    """(..., N, 9) -> (..., N, 3 verts, 3 xyz)."""
    return torch.stack([prims[..., 0:3], prims[..., 3:6], prims[..., 6:9]], dim=-1)


def prim_mids(prims: torch.Tensor, axis: int) -> torch.Tensor:
    """Primitive midpoint along axis: (min + max) / 2 over the 3 vertices."""
    ap = prim_axis_points(prims, axis)
    return 0.5 * (torch.amin(ap, -1) + torch.amax(ap, -1))


def build_mask_epo(prims: torch.Tensor, offset: torch.Tensor, axis: int,
                   parent_mask: torch.Tensor, is_right: bool) -> torch.Tensor:
    """Primitive-midpoint classification: the left child keeps prims with
    offset >= mid, the right child those with offset < mid."""
    mids = prim_mids(prims, axis)
    side = (offset < mids) if is_right else (offset >= mids)
    return (parent_mask * side.to(torch.float32)).detach()


def surface_area_bounds(bounds: torch.Tensor) -> torch.Tensor:
    """SAH area of (..., 6) bounds."""
    d = bounds[..., 3:6] - bounds[..., 0:3]
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def prim_areas(prims: torch.Tensor) -> torch.Tensor:
    """(..., N, 9) -> (..., N) triangle surface areas."""
    v = prim_vertices(prims)
    p1, p2, p3 = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    u = torch.linalg.cross(p2 - p1, p3 - p1)
    return 0.5 * torch.linalg.vector_norm(u, dim=-1)


def masked_min(x: torch.Tensor, mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.amin(torch.where(mask > 0, x, BIG), axis)


def masked_max(x: torch.Tensor, mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.amax(torch.where(mask > 0, x, -BIG), axis)


def cloud_bounds(cloud: torch.Tensor) -> torch.Tensor:
    """Root bounds of a cloud: (..., N, 3) points or (..., N, 9) prims -> (..., 6)."""
    if cloud.shape[-1] == 3:
        bmin = torch.amin(cloud, -2)
        bmax = torch.amax(cloud, -2)
    else:
        v = prim_vertices(cloud)
        bmin = torch.amin(v, (-3, -2))
        bmax = torch.amax(v, (-3, -2))
    return torch.cat([bmin, bmax], -1)


def clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """jnp.clip's gradient rule: min(hi, max(lo, x)), so a tie with a bound
    halves the gradient between x and the bound (torch.clamp gives it all to
    x)."""
    return torch.minimum(hi, torch.maximum(lo, x))
