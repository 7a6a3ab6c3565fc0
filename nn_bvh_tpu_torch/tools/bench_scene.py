"""What chip_smoke.py and the tools share: the bench scene, a synthetic
deep tree for the deep-stack traversal, a synthetic widening tree for the
lab's stack check, and CUDA-event timing."""

from __future__ import annotations

import numpy as np
import torch

from .. import accel
from ..accel.traverse import DeviceBVH
from ..geometry import scene as scene_mod, transform as xf
from ..wavefront import camera as camera_mod

BENCH_SIZE = 400  # bench.py renders 400x400


def build_bench_scene():
    """bench.py:45-70 with the port's modules (the same RandomState(42)
    draws): 24 spheres, a floor and an emissive quad, 52,996 triangles, SAH
    BVH, 400x400 camera -> (host scene, DeviceBVH, camera)."""
    rs = np.random.RandomState(42)
    b = scene_mod.SceneBuilder()
    diffuse = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    for i in range(24):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        r = 0.25 + 0.45 * rs.rand()
        b.add_sphere(c, r, metal if i % 3 == 0 else diffuse, n_theta=24, n_phi=48)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), floor)
    b.add_quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2), floor,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=20.0, two_sided=True)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    cam = camera_mod.make_perspective(
        xf.look_at((0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0)), fov=50.0,
        width=BENCH_SIZE, height=BENCH_SIZE)
    return sc, dbvh, cam


def build_deep_tree(levels: int = 100, seed: int = 0):
    """A "caterpillar" binary BVH of depth `levels`: interior node 2k has the
    leaf 2k+1 (triangle k) and the interior node 2k+2; node 2*levels is the
    leaf of the last triangle. The levels+1 small tilted triangles sit along
    the x axis, 0.1 apart. -> (tri_p (levels+1, 3, 3) f32, DeviceBVH)."""
    rs = np.random.RandomState(seed)
    n = levels + 1
    x = 0.1 * np.arange(n)[:, None] + rs.uniform(-0.02, 0.02, (n, 3))
    y0, z0 = rs.uniform(0.0, 0.2, (2, n))
    tri = np.zeros((n, 3, 3), np.float32)
    tri[:, :, 0] = x
    tri[:, :, 1] = np.stack([y0, y0 + 1.0, y0], 1)
    tri[:, :, 2] = np.stack([z0, z0, z0 + 1.0], 1)
    t_lo, t_hi = tri.min(1), tri.max(1)
    # suffix boxes: triangles k..levels
    s_lo = np.minimum.accumulate(t_lo[::-1], 0)[::-1]
    s_hi = np.maximum.accumulate(t_hi[::-1], 0)[::-1]
    nn = 2 * levels + 1
    lo = np.zeros((nn, 3), np.float32)
    hi = np.zeros((nn, 3), np.float32)
    meta = np.zeros((nn, 3), np.int32)
    k = np.arange(levels)
    lo[2 * k], hi[2 * k] = s_lo[k], s_hi[k]
    meta[2 * k, 0] = 2 * k + 2                      # interior, split on x
    lo[2 * k + 1], hi[2 * k + 1] = t_lo[k], t_hi[k]
    meta[2 * k + 1, 0:2] = np.stack([k, np.ones_like(k)], 1)  # one-triangle leaf
    lo[-1], hi[-1] = t_lo[-1], t_hi[-1]
    meta[-1, 0:2] = (levels, 1)
    return tri, DeviceBVH(node_lo=lo, node_hi=hi, node_meta=meta, n_nodes=nn)


def deep_tree_rays(levels: int, R: int, seed: int = 1):
    """Rays for build_deep_tree(levels): a third come from +x down the whole
    chain (the deepest walks), a third from -x, a third from random points
    in random directions; 20% dead lanes. -> o, d, t_max (numpy f32)."""
    rs = np.random.RandomState(seed)
    span = 0.1 * levels
    o = np.empty((R, 3), np.float32)
    d = np.empty((R, 3), np.float32)
    third = R // 3
    yz = rs.uniform(-0.2, 1.4, (R, 2))
    o[:third] = np.c_[np.full(third, span + 5.0), yz[:third]]
    d[:third] = np.c_[-np.ones(third), rs.uniform(-0.02, 0.02, (third, 2))]
    o[third:2 * third] = np.c_[np.full(third, -5.0), yz[third:2 * third]]
    d[third:2 * third] = np.c_[np.ones(third), rs.uniform(-0.02, 0.02, (third, 2))]
    rest = R - 2 * third
    o[2 * third:] = rs.uniform([-1, -0.5, -0.5], [span + 1, 1.5, 1.5], (rest, 3))
    d[2 * third:] = rs.randn(rest, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.rand(R) < 0.2, -1.0, 1e30).astype(np.float32)
    return o, d, t_max


def build_widening_tree(levels: int = 20):
    """A binary BVH (DFS layout, split axis x, every box [-1, 1]^3) on which
    a packet heading +x visits every node and a walk popping 4 entries per
    iteration keeps 4 more entries per level: the near child of each
    P-node is a P-node, its far child a Q-node; a Q-node has two
    leaf-parents, a leaf-parent two one-triangle leaves; below `levels` a
    P-node is a leaf-parent. Depth levels + 2.
    -> (tri_p (Nn, 3, 3) f32, triangle i in front of leaf i, DeviceBVH)."""
    meta = []

    def node(kind, depth):
        i = len(meta)
        meta.append([i, 1, 0])  # a leaf of triangle i until it gets children
        if kind == "leaf":
            return
        if kind == "P" and depth >= levels:
            kind = "LP"
        near, far = {"P": ("P", "Q"), "Q": ("LP", "LP"), "LP": ("leaf", "leaf")}[kind]
        node(near, depth + 1)  # child i + 1
        meta[i] = [len(meta), 0, 0]
        node(far, depth + 1)

    node("P", 0)
    n = len(meta)
    tri = np.zeros((n, 3, 3), np.float32)
    tri[:, :, 0] = 0.5 + 1e-3 * np.arange(n)[:, None]
    tri[:, 0, 1:] = -0.5
    tri[:, 1, 1] = tri[:, 2, 2] = 1.0
    return tri, DeviceBVH(node_lo=np.full((n, 3), -1.0, np.float32),
                          node_hi=np.full((n, 3), 1.0, np.float32),
                          node_meta=np.array(meta, np.int32), n_nodes=n)


def widening_tree_rays(R: int, seed: int = 0):
    """Rays for build_widening_tree: from near (-0.5, -0.5, -0.5) heading
    +x, all live. -> o, d, t_max (numpy f32)."""
    rs = np.random.RandomState(seed)
    o = (rs.rand(R, 3) * 0.1 - 0.5).astype(np.float32)
    d = np.tile(np.float32([1.0, 0.05, 0.05]), (R, 1))
    return o, d, np.full((R,), 1e30, np.float32)


def median_ms(fn, n: int = 5) -> float:
    """Median of n calls of fn on the current CUDA stream, each between two
    CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))
