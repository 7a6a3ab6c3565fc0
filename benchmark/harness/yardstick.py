"""The benchmark's own arithmetic, frozen so that later changes to the
program cannot move it: the published peaks of one H100, the bound of a
traversal batch from a plain walk's counts, and the model FLOPs of a
treeNet step.

Traversal bound (the rule of the repository's traversal measurements): a
box (slab) test costs 26 float operations and a Moller-Trumbore test 58;
the bytes are the live rays' origin and direction, every ray's t_max, the
outputs (t, prim, b1, b2 for closest hit, prim for any hit), and, once
each, the node records and the triangles (36 bytes, three float32
vertices) that the walk read. The least time is the larger of operations
over the float32 peak and bytes over the memory peak.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM, HBM3
FLOPS_SLAB = 26
FLOPS_TRI = 58
TRI_BYTES = 36
NODE_BYTES = 24        # a binary node's box: lo and hi, float32
BOUND_STRIDE = 16      # the plain walk takes every 16th lane; its operations scale by 16


def bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def _safe_inv(d):
    small = d.abs() < 1e-20
    return 1.0 / torch.where(small, torch.where(d < 0, -1e-20, 1e-20), d)


def plain_walk_counts(node_lo, node_hi, node_meta, tri_p, o, d, t_max, any_hit: bool,
                      stack_depth: int = 64) -> dict:
    """A plain near-first walk of a flat binary BVH (node_meta [offset,
    count, axis]: count > 0 a leaf of `count` triangles from `offset`, else
    the first child at i + 1 and the second at `offset`), tri_p (N, 3, 3)
    in leaf order. Closest hit keeps the first smallest t, any hit stops at
    its first hit; a lane with t_max <= 0 (closest) or < 0 (any) walks
    nothing. -> {"slab": box tests, "tri": triangle tests, "nodes": distinct
    nodes read, "tris": distinct triangles read} summed over the lanes."""
    dev = o.device
    R = o.shape[0]
    inv = _safe_inv(d)
    live = (t_max >= 0) if any_hit else (t_max > 0)
    t_best = torch.where(live, t_max, -1.0)
    stack = torch.zeros(R, stack_depth, dtype=torch.int64, device=dev)
    sp = torch.where(live, 0, -1)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    seen_node = torch.zeros(node_lo.shape[0], dtype=torch.bool, device=dev)
    seen_tri = torch.zeros(tri_p.shape[0], dtype=torch.bool, device=dev)
    n_slab = n_tri = 0
    meta = node_meta.long()
    e1 = tri_p[:, 1] - tri_p[:, 0]
    e2 = tri_p[:, 2] - tri_p[:, 0]
    while True:
        idx = torch.nonzero((sp >= 0) & ~done).squeeze(1)
        if idx.numel() == 0:
            break
        node = stack[idx, sp[idx]]
        sp[idx] -= 1
        seen_node[node] = True
        cnt = meta[node, 1]
        leaf = cnt > 0
        # leaves: test the triangles in order
        li, ln = idx[leaf], node[leaf]
        if li.numel():
            off, c = meta[ln, 0], cnt[leaf]
            for j in range(int(c.max())):
                take = j < c
                lj, tj = li[take], (off + j)[take]
                seen_tri[tj] = True
                n_tri += int(take.sum())
                oj, dj = o[lj], d[lj]
                v0, a, b = tri_p[tj, 0], e1[tj], e2[tj]
                p = torch.linalg.cross(dj, b)
                det = (a * p).sum(-1)
                ok = det.abs() > 1e-12
                idt = torch.where(ok, 1.0 / det, 0.0)
                s = oj - v0
                u1 = (s * p).sum(-1) * idt
                q = torch.linalg.cross(s, a)
                u2 = (dj * q).sum(-1) * idt
                t = (b * q).sum(-1) * idt
                hit = (ok & (u1 >= -1e-7) & (u2 >= -1e-7) & (u1 + u2 <= 1.0 + 1e-7)
                       & (t > 0) & (t < t_best[lj]))
                if any_hit:
                    done[lj[hit]] = True
                else:
                    t_best[lj[hit]] = t[hit]
        # interior: test both children, push the hit ones far to near
        ii, inn = idx[~leaf], node[~leaf]
        if ii.numel():
            kids = torch.stack([inn + 1, meta[inn, 0]], 1)
            lo, hi = node_lo[kids], node_hi[kids]
            oo, iv = o[ii][:, None], inv[ii][:, None]
            t0, t1 = (lo - oo) * iv, (hi - oo) * iv
            tn = torch.minimum(t0, t1).amax(-1)
            tf = torch.maximum(t0, t1).amin(-1) * 1.0000004
            ok = (tn <= tf) & (tf > 0) & (tn < t_best[ii][:, None])
            n_slab += 2 * ii.numel()
            near0 = torch.clamp(tn[:, 0], min=0) < torch.clamp(tn[:, 1], min=0)
            near = torch.where(near0, kids[:, 0], kids[:, 1])
            far = torch.where(near0, kids[:, 1], kids[:, 0])
            both = ok[:, 0] & ok[:, 1]
            one = torch.where(ok[:, 0], kids[:, 0], kids[:, 1])
            base = sp[ii]
            stack[ii, base + 1] = torch.where(both, far, one)
            stack[ii, torch.clamp(base + 2, max=stack_depth - 1)] = torch.where(
                both, near, stack[ii, torch.clamp(base + 2, max=stack_depth - 1)])
            sp[ii] = base + ok.sum(1)
    return {"slab": n_slab, "tri": n_tri, "nodes": int(seen_node.sum()),
            "tris": int(seen_tri.sum())}


def batch_bound(counts: dict, R: int, live: int, any_hit: bool, scale: float = 1.0):
    """-> (ms, flops, bytes) of one traversal batch of R rays, `live` of
    them walking, from a walk's `counts` over 1/scale of its lanes."""
    flops = (counts["slab"] * FLOPS_SLAB + counts["tri"] * FLOPS_TRI) * scale
    nbytes = (live * 24 + R * 4 + R * (4 if any_hit else 16)
              + counts["nodes"] * NODE_BYTES + counts["tris"] * TRI_BYTES)
    return bound_ms(flops, nbytes), flops, nbytes


def treenet_step_flops(levels: int, capacity: int, pc_size: int, batch: int,
                       epo: bool = True) -> float:
    """Model FLOPs of one training step: the encoders' products forward
    (two FLOPs a multiply-add), times 3 for forward and backward. Level l
    of the static 6-wide tree has 6^l nodes, each encoding the whole cloud
    (N points or prims): the first layer (EPO: 3 vertex coords -> C per
    axis; SAH: a 1x1 of one channel), two C x C layers per axis, the
    masked mean pool, and the regressor C -> C -> C/2 -> 1 per axis."""
    C, N = capacity, pc_size
    first = 2 * N * 3 * 3 * C + 2 * N * 3 * C * C if epo else N * 3 * C
    per_node = (first + 2 * (2 * N * 3 * C * C) + 2 * N * 3 * C
                + 2 * 3 * C * C + 2 * 3 * C * (C // 2) + 2 * 3 * (C // 2))
    nodes = sum(6 ** l for l in range(levels - 1))
    return 3.0 * batch * nodes * per_node
