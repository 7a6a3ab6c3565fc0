"""Acceleration structures: host build + device traversal (port of the host
part of nn_bvh_tpu/accel/__init__.py)."""

from __future__ import annotations

import numpy as np

from . import build as _build
from .build import BVH, build_median, build_sah, sah_cost, triangle_bounds
from .traverse import DeviceBVH, Hit


def build_scene_bvh(scene, method: str = "sah"):
    """BVH over a host CompiledScene, triangles reordered so every leaf is a
    contiguous range -> (scene_reordered, DeviceBVH, BVH). method: "sah" or
    "sah_native" (the native C++ binned SAH, the numpy one without a
    toolchain), "sah_numpy", "median" or "lbvh" (both the Morton median
    split, as in the JAX package). An animated scene gets one tree over the
    union of both shutter keyframes' triangle bounds, conservative at every
    shutter time."""
    builders = {"sah_numpy": build_sah, "median": build_median, "lbvh": build_median}
    if method not in builders and method not in ("sah", "sah_native"):
        raise ValueError(f"unknown BVH builder {method!r}")
    n = scene.n_tris
    lo, hi = triangle_bounds(np.asarray(scene.tri_p)[:n])
    if scene.tri_p_end is not None:
        lo2, hi2 = triangle_bounds(np.asarray(scene.tri_p_end)[:n])
        lo, hi = np.minimum(lo, lo2), np.maximum(hi, hi2)
    if method in builders:
        return apply_bvh_to_scene(scene, builders[method](lo, hi))
    from .. import native

    bvh = native.build_sah_native(lo, hi, max_leaf=_build.MAX_LEAF_PRIMS)
    return apply_bvh_to_scene(scene, bvh if bvh is not None else build_sah(lo, hi))


def apply_bvh_to_scene(scene, bvh: BVH):
    """Reorder a host CompiledScene's triangles to a BVH's leaf layout ->
    (scene_reordered, host DeviceBVH, bvh)."""
    from ..geometry import scene as scene_mod

    n = scene.n_tris
    if len(bvh.prim_order) != n:
        raise ValueError(f"BVH orders {len(bvh.prim_order)} prims, scene has {n}")
    order = bvh.prim_order
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)

    def perm(x):
        x = np.asarray(x)
        out = x.copy()
        out[:n] = x[:n][order]
        return out

    light_params = np.asarray(scene.light_params).copy()
    if len(light_params):
        area = np.asarray(scene.light_type) == scene_mod.LIGHT_AREA_TRI
        light_params[area, 0] = inv[light_params[area, 0].astype(np.int64)].astype(np.float32)
    scene2 = scene.replace(tri_p=perm(scene.tri_p), tri_n=perm(scene.tri_n),
                           tri_uv=perm(scene.tri_uv), tri_mat=perm(scene.tri_mat),
                           tri_light=perm(scene.tri_light), light_params=light_params)
    if scene.tri_med_inside is not None:
        scene2 = scene2.replace(tri_med_inside=perm(scene.tri_med_inside),
                                tri_med_outside=perm(scene.tri_med_outside))
    if scene.tri_p_end is not None:
        scene2 = scene2.replace(tri_p_end=perm(scene.tri_p_end),
                                tri_n_end=perm(scene.tri_n_end))
    scene2 = scene2.replace(tri_shade=scene_mod.make_tri_shade(scene2))
    if scene.tri_p_end is not None:
        scene2 = scene2.replace(tri_shade_end=scene_mod.make_tri_shade(scene2, use_end=True))
    dbvh = DeviceBVH(node_lo=bvh.node_lo, node_hi=bvh.node_hi,
                     node_meta=bvh.node_meta, n_nodes=int(bvh.n_nodes))
    return scene2, dbvh, bvh
