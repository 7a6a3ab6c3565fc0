"""Hit records and the plain PyTorch BVH4 traversal.

`traverse_bvh4_plain` computes what `csrc/bvh4_traverse.cu` computes, with
the same tables, constants and rounding (every operation is one float32
rounding, like the kernel built with -fmad=false), vectorized over lanes:
each ray keeps its own stack in an (R, 64) tensor and one loop iteration pops
one entry for every live ray. It is the CPU path of the port and the
reference the kernel is checked against on the card.

Semantics (those of nn_bvh_tpu/accel/pallas_bvh4.py::_traverse_bvh4):
- closest-hit: a lane with t_max <= 0 visits nothing; misses return
  t = inf, prim = -1, b1 = b2 = 0;
- any-hit: a lane with t_max < 0 reports occluded; a live lane stops at its
  first hit;
- children are visited front to back by this ray's entry t (stable on ties:
  the lower child index first), leaves test their triangles in order with
  Moller-Trumbore (pallas_traverse._tri_isect_tile).

`intersect_brute` is a chunked O(R*N) oracle with the same triangle test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .bvh4 import STACK_DEPTH, MAX_LEAF, WIDTH

TINY = 1e-20       # inverse-direction guard


class Hit(NamedTuple):
    t: torch.Tensor      # (R,) f32, inf on a miss
    prim: torch.Tensor   # (R,) i32 triangle id (post-reorder), -1 on a miss
    b1: torch.Tensor     # (R,) f32 barycentrics of the hit
    b2: torch.Tensor


class DeviceBVH(NamedTuple):
    """Flat binary BVH (accel.build.BVH without prim_order)."""

    node_lo: object    # (Nn, 3) f32
    node_hi: object    # (Nn, 3) f32
    node_meta: object  # (Nn, 3) i32 [offset, count, axis]
    n_nodes: int


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    small = d.abs() < TINY
    return 1.0 / torch.where(small, torch.where(d < 0, -TINY, TINY), d)


def tri_isect(o, d, p, t_best):
    """Moller-Trumbore; o, d (..., 3), p (..., 3, 3) [vertex, axis],
    t_best (...). -> (hit, t, b1, b2)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    x0, y0, z0 = p[..., 0, 0], p[..., 0, 1], p[..., 0, 2]
    e1x, e1y, e1z = p[..., 1, 0] - x0, p[..., 1, 1] - y0, p[..., 1, 2] - z0
    e2x, e2y, e2z = p[..., 2, 0] - x0, p[..., 2, 1] - y0, p[..., 2, 2] - z0
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = det.abs() > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    sx, sy, sz = ox - x0, oy - y0, oz - z0
    b1 = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    b2 = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok_det & (b1 >= -1e-7) & (b2 >= -1e-7) & (b1 + b2 <= 1.0 + 1e-7)
           & (t > 0.0) & (t < t_best))
    return hit, t, b1, b2


def traverse_bvh4_plain(nodes: torch.Tensor, tris: torch.Tensor, o: torch.Tensor,
                        d: torch.Tensor, t_max: torch.Tensor, any_hit: bool):
    """nodes (W,4,8) f32, tris (N,3,3) f32, o/d (R,3) f32, t_max (R,) f32.
    Closest-hit -> Hit; any-hit -> (R,) bool occluded."""
    R = o.shape[0]
    dev = o.device
    lo_all = nodes[..., 0:3]
    hi_all = nodes[..., 3:6]
    meta_all = nodes[..., 6].contiguous().view(torch.int32)
    inv = safe_inv(d)

    t_best = t_max.clone()
    prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    if any_hit:
        prim = torch.where(t_max < 0.0, 0, prim).to(torch.int32)
    b1 = torch.zeros(R, dtype=torch.float32, device=dev)
    b2 = torch.zeros(R, dtype=torch.float32, device=dev)
    live = t_max >= 0.0 if any_hit else t_max > 0.0
    stack = torch.zeros((R, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.where(live, 0, -1).to(torch.int64)
    slot = torch.arange(WIDTH, device=dev)
    jj = torch.arange(MAX_LEAF, device=dev)

    while True:
        idx = torch.nonzero(sp >= 0).squeeze(1)
        if idx.numel() == 0:
            break
        spi = sp[idx]
        entry = stack[idx, spi]
        spi = spi - 1

        # interior: slab-test the 4 children, push hits far to near
        inner = entry >= 0
        ii = idx[inner]
        if ii.numel():
            e = entry[inner].long()
            oi, invi = o[ii][:, None, :], inv[ii][:, None, :]
            t0 = (lo_all[e] - oi) * invi
            t1 = (hi_all[e] - oi) * invi
            tmin = torch.minimum(t0, t1)
            tmax = torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
            tf = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]),
                               tmax[..., 2]) * 1.0000004
            ok = (tn <= tf) & (tf > 0.0) & (tn < t_best[ii][:, None])
            key = torch.where(ok, torch.clamp(tn, min=0.0), -1.0)
            _, order = torch.sort(key, dim=1, descending=True, stable=True)
            smeta = meta_all[e].gather(1, order)
            nhit = ok.sum(1)
            base = spi[inner]
            push = slot[None, :] < nhit[:, None]
            rows = ii[:, None].expand(-1, WIDTH)[push]
            cols = (base[:, None] + 1 + slot[None, :])[push]
            stack[rows, cols] = smeta[push]
            spi[inner] = base + nhit

        # leaf: test up to 8 triangles; keep the first smallest t
        leaf = ~inner
        li = idx[leaf]
        if li.numel():
            u = -entry[leaf].long() - 1
            off = u >> 4
            cnt = (u & 15) + 1
            tj = off[:, None] + torch.minimum(jj[None, :], cnt[:, None] - 1)
            tb = t_best[li]
            h, t, bb1, bb2 = tri_isect(o[li][:, None, :], d[li][:, None, :],
                                       tris[tj], tb[:, None])
            h = h & (jj[None, :] < cnt[:, None])
            if any_hit:
                k = torch.argmax(h.to(torch.int32), dim=1)
                got = h.any(1)
            else:
                tm = torch.where(h, t, torch.inf)
                k = torch.argmin(tm, dim=1)
                got = h.any(1)
                t_best[li] = torch.where(got, tm.gather(1, k[:, None])[:, 0], tb)
            sel = lambda x: x.gather(1, k[:, None])[:, 0]
            prim[li] = torch.where(got, sel(tj).to(torch.int32), prim[li])
            b1[li] = torch.where(got, sel(bb1), b1[li])
            b2[li] = torch.where(got, sel(bb2), b2[li])
            if any_hit:
                spi[leaf] = torch.where(got, -1, spi[leaf])
        sp[idx] = spi

    if any_hit:
        return prim >= 0
    miss = prim < 0
    return Hit(t=torch.where(miss, torch.inf, t_best), prim=prim, b1=b1, b2=b2)


def intersect_brute(tri_p: torch.Tensor, o, d, t_max, chunk: int = 4096) -> Hit:
    """O(R*N) closest-hit oracle for tests, chunked over triangles; same
    Moller-Trumbore test as the traversal, first smallest t wins."""
    R = o.shape[0]
    t_best = torch.where(t_max > 0, t_max, -1.0).clone()
    prim = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    b1 = torch.zeros(R, device=o.device)
    b2 = torch.zeros(R, device=o.device)
    for s in range(0, tri_p.shape[0], chunk):
        p = tri_p[s:s + chunk][None]
        h, t, bb1, bb2 = tri_isect(o[:, None, :], d[:, None, :], p, t_best[:, None])
        tm = torch.where(h, t, torch.inf)
        k = torch.argmin(tm, dim=1)
        tk = tm.gather(1, k[:, None])[:, 0]
        got = torch.isfinite(tk)
        t_best = torch.where(got, tk, t_best)
        prim = torch.where(got, (k + s).to(torch.int32), prim)
        b1 = torch.where(got, bb1.gather(1, k[:, None])[:, 0], b1)
        b2 = torch.where(got, bb2.gather(1, k[:, None])[:, 0], b2)
    miss = prim < 0
    return Hit(t=torch.where(miss, torch.inf, t_best), prim=prim, b1=b1, b2=b2)
