"""Triangle helpers the light code needs (port of
nn_bvh_tpu/geometry/triangle.py:108-121). Ray-triangle intersection lives
with the traversal (accel/traverse.py), as Moller-Trumbore like the kernel."""

from __future__ import annotations

import torch

from ..core import vecmath as vm


def geometric_normal(p0, p1, p2) -> torch.Tensor:
    return vm.normalize(vm.cross(p1 - p0, p2 - p0))


def area(p0, p1, p2) -> torch.Tensor:
    return 0.5 * vm.length(vm.cross(p1 - p0, p2 - p0))


def solid_angle(p0, p1, p2, p) -> torch.Tensor:
    """Solid angle subtended from p (Triangle::SolidAngle)."""
    return vm.spherical_triangle_area(
        vm.normalize(p0 - p), vm.normalize(p1 - p), vm.normalize(p2 - p))
