"""Hit records and the plain PyTorch traversals.

Each plain traversal computes what its CUDA kernel computes, with the same
tables, constants and rounding (every operation is one float32 rounding,
like the kernels built with -fmad=false), vectorized over lanes: each ray
keeps its own stack in an (R, depth) tensor and one loop iteration pops one
entry for every live ray. They are the CPU path of the port and the
references the kernels are checked against on the card.

- `traverse_bvh4_plain`: csrc/bvh4_traverse.cu (pallas_bvh4._traverse_bvh4);
- `traverse_binary_plain`: csrc/binary_traverse.cu, stack 64
  (pallas_traverse._traverse_packed) or 128 (hbm_traverse._traverse_hbm),
  over the kernel's pair records (binary.pack_binary_pairs);
- `traverse_bvh8_plain`: csrc/bvh8_traverse.cu (pallas_bvh8._traverse_bvh8).

Semantics (those of the TPU kernels):
- closest-hit: a lane with t_max <= 0 visits nothing; misses return
  t = inf, prim = -1, b1 = b2 = 0;
- any-hit: a lane with t_max < 0 reports occluded; a live lane stops at its
  first hit;
- leaves test their triangles in order with Moller-Trumbore
  (pallas_traverse._tri_isect_tile); the first smallest t wins;
- child order, per ray: BVH4 pushes hit children far to near by entry t
  (a stable descending sort, so on equal keys the higher slot is visited
  first); BVH8 visits them near to far by packed keys (entry t's float32
  bits with the slot in the low 3 bits: the lower slot first where the
  keys agree above those bits); the binary walk visits the nearer child by
  entry t first, the right child on equal keys (BVH4's rule for two
  children). The TPU kernels order by the packet's direction sign or
  minimum entry t; the hits are the same but on exact t ties.

`counts`, a dict, receives per-ray int64 counts of box (slab) tests under
"slab" and of triangle tests under "tri", and how many distinct node records
and triangles the walk read under "node_records" and "tri_records" (ints):
the work and the table bytes the kernel needs on these inputs, which
tools/bench_scene.traversal_bound turns into a bound.

`intersect_brute` is a chunked O(R*N) oracle with the same triangle test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import binary, bvh4, bvh8

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
    """Moller-Trumbore; o, d (..., 3), p (..., 3, 3) [vertex, axis] or
    (..., 3, 4) records [v0, 0 | e1, 0 | e2, 0] (bvh4.pack_tris_cuda: the
    edges as given, the same single rounding as the subtraction here),
    t_best (...). -> (hit, t, b1, b2)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    x0, y0, z0 = p[..., 0, 0], p[..., 0, 1], p[..., 0, 2]
    if p.shape[-1] == 4:
        e1x, e1y, e1z = p[..., 1, 0], p[..., 1, 1], p[..., 1, 2]
        e2x, e2y, e2z = p[..., 2, 0], p[..., 2, 1], p[..., 2, 2]
    else:
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


def _init_lanes(t_max: torch.Tensor, any_hit: bool, stack_depth: int):
    """-> t_best, prim, b1, b2, stack, sp (-1 on dead lanes)."""
    R = t_max.shape[0]
    dev = t_max.device
    prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    if any_hit:
        prim = torch.where(t_max < 0.0, 0, prim).to(torch.int32)
    live = t_max >= 0.0 if any_hit else t_max > 0.0
    return (t_max.clone(), prim, torch.zeros(R, dtype=torch.float32, device=dev),
            torch.zeros(R, dtype=torch.float32, device=dev),
            torch.zeros((R, stack_depth), dtype=torch.int32, device=dev),
            torch.where(live, 0, -1).to(torch.int64))


def _slab(lo, hi, o, inv, t_best):
    """Slab test of boxes lo/hi (..., 3) -> (hit, entry t)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
    tf = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2]) * 1.0000004
    return (tn <= tf) & (tf > 0.0) & (tn < t_best), tn


def _leaf(li, off, cnt, tris, o, d, t_best, prim, b1, b2, any_hit):
    """Test the leaves (off, cnt) of lanes li in place -> (found a hit,
    triangles tested) per lane."""
    jj = torch.arange(bvh4.MAX_LEAF, device=o.device)  # the packers check the leaf size
    tj = off[:, None] + torch.minimum(jj[None, :], cnt[:, None] - 1)
    tb = t_best[li]
    h, t, bb1, bb2 = tri_isect(o[li][:, None, :], d[li][:, None, :], tris[tj], tb[:, None])
    h = h & (jj[None, :] < cnt[:, None])
    got = h.any(1)
    if any_hit:
        k = torch.argmax(h.to(torch.int32), dim=1)
        tested = torch.where(got, k + 1, cnt)
    else:
        tm = torch.where(h, t, torch.inf)
        k = torch.argmin(tm, dim=1)
        t_best[li] = torch.where(got, tm.gather(1, k[:, None])[:, 0], tb)
        tested = cnt
    sel = lambda x: x.gather(1, k[:, None])[:, 0]
    prim[li] = torch.where(got, sel(tj).to(torch.int32), prim[li])
    b1[li] = torch.where(got, sel(bb1), b1[li])
    b2[li] = torch.where(got, sel(bb2), b2[li])
    return got, tested


def _mark_tris(seen, off, tested):
    """Marks triangles off .. off+tested-1 of each lane in `seen` (bool)."""
    jj = torch.arange(bvh4.MAX_LEAF, device=off.device)
    seen[(off[:, None] + jj[None, :])[jj[None, :] < tested[:, None]]] = True


def _finish(t_best, prim, b1, b2, any_hit, counts, n_slab, n_tri, seen_node, seen_tri):
    if counts is not None:
        counts["slab"], counts["tri"] = n_slab, n_tri
        counts["node_records"] = int(seen_node.sum())
        counts["tri_records"] = int(seen_tri.sum())
    if any_hit:
        return prim >= 0
    return Hit(t=torch.where(prim < 0, torch.inf, t_best), prim=prim, b1=b1, b2=b2)


def _traverse_wide_plain(nodes, tris, o, d, t_max, any_hit, stack_depth, near_first, counts):
    """Wide-BVH walk over (W, width, 8) records [lo.xyz, hi.xyz, meta, pad];
    leaf meta -(1 + offset*16 + count-1). near_first (BVH8's rule): push the
    hit children so that the nearest is popped next, by packed keys (the
    float32 bits of max(entry t, 0) with the slot in the low 3 bits); else
    push them in a stable descending sort of entry t (BVH4's rule)."""
    R = o.shape[0]
    width = nodes.shape[1]
    lo_all = nodes[..., 0:3]
    hi_all = nodes[..., 3:6]
    meta_all = nodes[..., 6].contiguous().view(torch.int32)
    inv = safe_inv(d)
    t_best, prim, b1, b2, stack, sp = _init_lanes(t_max, any_hit, stack_depth)
    n_slab = torch.zeros(R, dtype=torch.int64, device=o.device)
    n_tri = torch.zeros(R, dtype=torch.int64, device=o.device)
    seen_node = torch.zeros(nodes.shape[0], dtype=torch.bool, device=o.device)
    seen_tri = torch.zeros(tris.shape[0], dtype=torch.bool, device=o.device)
    slot = torch.arange(width, device=o.device)

    while True:
        idx = torch.nonzero(sp >= 0).squeeze(1)
        if idx.numel() == 0:
            break
        spi = sp[idx]
        entry = stack[idx, spi]
        spi = spi - 1

        # interior: slab-test the children, push the hit ones
        inner = entry >= 0
        ii = idx[inner]
        if ii.numel():
            e = entry[inner].long()
            ok, tn = _slab(lo_all[e], hi_all[e], o[ii][:, None, :], inv[ii][:, None, :],
                           t_best[ii][:, None])
            nhit = ok.sum(1)
            if near_first:
                bits = (torch.clamp(tn.view(torch.int32), min=0) & ~7) | slot[None, :]
                _, order = torch.sort(torch.where(ok, bits.long(), 0xFFFFFFFF), dim=1)
                # push slot j takes the (nhit-1-j)-th nearest: far to near
                order = order.gather(1, torch.clamp(nhit[:, None] - 1 - slot[None, :], min=0))
            else:
                key = torch.where(ok, torch.clamp(tn, min=0.0), -1.0)
                _, order = torch.sort(key, dim=1, descending=True, stable=True)
            smeta = meta_all[e].gather(1, order)
            base = spi[inner]
            push = slot[None, :] < nhit[:, None]
            rows = ii[:, None].expand(-1, width)[push]
            cols = (base[:, None] + 1 + slot[None, :])[push]
            stack[rows, cols] = smeta[push]
            spi[inner] = base + nhit
            n_slab[ii] += width
            seen_node[e] = True

        # leaf: test up to 8 triangles
        leaf = ~inner
        li = idx[leaf]
        if li.numel():
            u = -entry[leaf].long() - 1
            off = u >> 4
            got, tested = _leaf(li, off, (u & 15) + 1, tris, o, d, t_best, prim, b1, b2, any_hit)
            n_tri[li] += tested
            _mark_tris(seen_tri, off, tested)
            if any_hit:
                spi[leaf] = torch.where(got, -1, spi[leaf])
        sp[idx] = spi

    return _finish(t_best, prim, b1, b2, any_hit, counts, n_slab, n_tri, seen_node, seen_tri)


def traverse_bvh4_plain(nodes: torch.Tensor, tris: torch.Tensor, o: torch.Tensor,
                        d: torch.Tensor, t_max: torch.Tensor, any_hit: bool,
                        counts: dict | None = None):
    """nodes (W,4,8) f32 (bvh4.pack_bvh4_cuda), tris (N,3,3) f32 or the
    kernel's (N,3,4) records (bvh4.pack_tris_cuda; same bits), o/d (R,3)
    f32, t_max (R,) f32. Closest-hit -> Hit; any-hit -> (R,) bool occluded."""
    return _traverse_wide_plain(nodes, tris, o, d, t_max, any_hit, bvh4.STACK_DEPTH, False,
                                counts)


def traverse_bvh8_plain(nodes: torch.Tensor, tris: torch.Tensor, o: torch.Tensor,
                        d: torch.Tensor, t_max: torch.Tensor, any_hit: bool,
                        counts: dict | None = None):
    """nodes (W,8,8) f32 (bvh8.pack_bvh8_cuda), tris (N,3,4) records
    (bvh4.pack_tris_cuda) or (N,3,3) f32 (same bits), o/d (R,3) f32,
    t_max (R,) f32. Closest-hit -> Hit; any-hit -> (R,) bool occluded."""
    return _traverse_wide_plain(nodes, tris, o, d, t_max, any_hit, bvh8.STACK_DEPTH, True,
                                counts)


def traverse_binary_plain(nodes: torch.Tensor, tris: torch.Tensor, o: torch.Tensor,
                          d: torch.Tensor, t_max: torch.Tensor, any_hit: bool,
                          stack_depth: int = 64, counts: dict | None = None):
    """nodes (1+Ni,16) f32 pair records (binary.pack_binary_pairs), tris
    (N,3,3) f32 or (N,3,4) records (bvh4.pack_tris_cuda), o/d (R,3) f32,
    t_max (R,) f32; a stack of `stack_depth` entries per ray. The walk starts
    at the header's entry; a record's two children are slab-tested and the
    hit ones pushed far to near by entry t (child 1 first on equal keys).
    Closest-hit -> Hit; any-hit -> (R,) bool occluded."""
    R = o.shape[0]
    lo = torch.stack([nodes[:, 0:3], nodes[:, 6:9]], 1)   # (Nr, 2, 3)
    hi = torch.stack([nodes[:, 3:6], nodes[:, 9:12]], 1)
    entries = nodes[:, 12:14].contiguous().view(torch.int32)  # (Nr, 2)
    start = int(entries[0, 0])
    inv = safe_inv(d)
    t_best, prim, b1, b2, stack, sp = _init_lanes(t_max, any_hit, stack_depth)
    stack[:, 0] = start
    if start == binary.NO_ENTRY:
        sp.fill_(-1)
    n_slab = torch.zeros(R, dtype=torch.int64, device=o.device)
    n_tri = torch.zeros(R, dtype=torch.int64, device=o.device)
    seen_node = torch.zeros(nodes.shape[0], dtype=torch.bool, device=o.device)
    seen_tri = torch.zeros(tris.shape[0], dtype=torch.bool, device=o.device)

    while True:
        idx = torch.nonzero(sp >= 0).squeeze(1)
        if idx.numel() == 0:
            break
        spi = sp[idx]
        entry = stack[idx, spi]
        spi = spi - 1

        # interior: slab-test both children, push the hit ones far to near
        inner = entry >= 0
        ii = idx[inner]
        if ii.numel():
            e = entry[inner].long()
            ok, tn = _slab(lo[e], hi[e], o[ii][:, None, :], inv[ii][:, None, :],
                           t_best[ii][:, None])
            key = torch.clamp(tn, min=0.0)
            first0 = key[:, 0] < key[:, 1]
            ent = entries[e]
            near = torch.where(first0, ent[:, 0], ent[:, 1])
            far = torch.where(first0, ent[:, 1], ent[:, 0])
            both = ok[:, 0] & ok[:, 1]
            one = torch.where(ok[:, 0], ent[:, 0], ent[:, 1])
            base = spi[inner]
            stack[ii, base + 1] = torch.where(both, far, one)
            stack[ii, base + 2] = near
            spi[inner] = base + ok.sum(1)
            n_slab[ii] += 2
            seen_node[e] = True

        # leaf: test up to 8 triangles
        leaf = ~inner
        li = idx[leaf]
        if li.numel():
            u = -entry[leaf].long() - 1
            off = u >> 4
            got, tested = _leaf(li, off, (u & 15) + 1, tris, o, d, t_best, prim, b1, b2,
                                any_hit)
            n_tri[li] += tested
            _mark_tris(seen_tri, off, tested)
            if any_hit:
                spi[leaf] = torch.where(got, -1, spi[leaf])
        sp[idx] = spi

    return _finish(t_best, prim, b1, b2, any_hit, counts, n_slab, n_tri, seen_node, seen_tri)


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
