"""A plain BVH for the references' visibility when a brute-force test of
every ray against every triangle would take too long: a median split on
the longest centroid axis down to leaves of a few triangles, built in
numpy, and a near-first stack walk vectorized over the rays in torch with
the same Moller-Trumbore test as `path.intersect` (the smallest t wins,
the lower triangle id on equal t, as in the brute-force scan).

Boxes are widened by a relative 1e-5 so that rounding in the slab test
never hides a triangle the ray hits.
"""

from __future__ import annotations

import numpy as np
import torch

LEAF = 4


class BVH:
    def __init__(self, tri_p: np.ndarray, device):
        tri_p = np.asarray(tri_p, np.float32)
        n = len(tri_p)
        cent = tri_p.mean(1)
        tlo, thi = tri_p.min(1), tri_p.max(1)
        order = np.arange(n)
        lo, hi, kid, off, cnt = [], [], [], [], []
        stack = [(0, n, -1, 0)]  # start, end, parent, slot
        while stack:
            s, e, parent, slot = stack.pop()
            idx = order[s:e]
            i = len(lo)
            b0, b1 = tlo[idx].min(0), thi[idx].max(0)
            pad = 1e-5 * (b1 - b0).max() + 1e-6
            lo.append(b0 - pad)
            hi.append(b1 + pad)
            kid.append([-1, -1])
            off.append(s)
            cnt.append(e - s)
            if parent >= 0:
                kid[parent][slot] = i
            if e - s > LEAF:
                c = cent[idx]
                axis = int(np.argmax(c.max(0) - c.min(0)))
                m = (e - s) // 2
                order[s:e] = idx[np.argsort(c[:, axis], kind="stable")]
                cnt[i] = 0
                stack.append((s + m, e, i, 1))
                stack.append((s, s + m, i, 0))
        t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=device).to(dt)
        self.lo, self.hi = t(lo), t(hi)
        self.kid = t(kid, torch.int64)
        self.off, self.cnt = t(off, torch.int64), t(cnt, torch.int64)
        self.prim = t(order, torch.int64)   # leaf slot -> triangle id


def _boxes(bvh: BVH, nodes, o, inv):
    t0, t1 = (bvh.lo[nodes] - o) * inv, (bvh.hi[nodes] - o) * inv
    return torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1)


def walk(bvh: BVH, tri, o, d, t_max, any_hit: bool, depth: int = 64):
    """Closest hit -> (t, prim, b1, b2) with t = inf and prim = -1 on a
    miss; any hit -> (R,) bool. Lanes with t_max <= 0 hit nothing. Near
    child first; a popped node whose entry lies beyond the best hit is
    skipped; on equal t the lower triangle id wins, as in a brute-force
    scan."""
    dev, R = o.device, o.shape[0]
    small = d.abs() < 1e-20
    inv = 1.0 / torch.where(small, torch.where(d < 0, -1e-20, 1e-20), d)
    t_best = torch.where(t_max > 0, t_max, -1.0)
    prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros_like(t_best)
    b2 = torch.zeros_like(t_best)
    hit_any = torch.zeros(R, dtype=torch.bool, device=dev)
    stack = torch.zeros(R, depth, dtype=torch.int64, device=dev)
    stack_t = torch.zeros(R, depth, dtype=t_best.dtype, device=dev)
    root = torch.zeros(R, dtype=torch.int64, device=dev)
    tn, tf = _boxes(bvh, root, o, inv)
    sp = torch.where((t_max > 0) & (tn <= tf) & (tf > 0) & (tn < t_best), 0, -1)
    stack_t[:, 0] = tn
    v0 = tri[:, 0]
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    slots = torch.arange(LEAF, device=dev)
    while True:
        idx = torch.nonzero(sp >= 0).squeeze(1)
        if idx.numel() == 0:
            break
        top = sp[idx]
        node, t_in = stack[idx, top], stack_t[idx, top]
        sp[idx] = top - 1
        keep = t_in <= t_best[idx]
        idx, node = idx[keep], node[keep]
        leaf = bvh.cnt[node] > 0
        li, ln = idx[leaf], node[leaf]
        if li.numel():
            cnt = bvh.cnt[ln]
            valid = slots[None] < cnt[:, None]
            k = bvh.prim[torch.where(valid, bvh.off[ln][:, None] + slots[None], 0)]
            oo, dd = o[li][:, None], d[li][:, None]
            ox, oy, oz = oo.unbind(-1)
            dx, dy, dz = dd.unbind(-1)
            x0, y0, z0 = v0[k].unbind(-1)
            e1x, e1y, e1z = e1[k].unbind(-1)
            e2x, e2y, e2z = e2[k].unbind(-1)
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            okd = det.abs() > 1e-12
            idet = torch.where(okd, 1.0 / det, 0.0)
            sx, sy, sz = ox - x0, oy - y0, oz - z0
            u1 = (sx * px + sy * py + sz * pz) * idet
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            u2 = (dx * qx + dy * qy + dz * qz) * idet
            t = (e2x * qx + e2y * qy + e2z * qz) * idet
            tb = t_best[li][:, None]
            h = (valid & okd & (u1 >= -1e-7) & (u2 >= -1e-7) & (u1 + u2 <= 1.0 + 1e-7)
                 & (t > 0.0) & ((t < tb) if any_hit else (t <= tb)))
            if any_hit:
                got = h.any(1)
                hit_any[li[got]] = True
                sp[li[got]] = -1
            else:
                th = torch.where(h, t, torch.inf)
                tmin = th.amin(1, keepdim=True)
                kk = torch.where(h & (th == tmin), k, torch.iinfo(torch.int64).max)
                j = torch.argmin(kk, 1)[:, None]
                kmin = k.gather(1, j)[:, 0]
                got = h.any(1) & ((tmin[:, 0] < tb[:, 0]) | (kmin < prim[li])
                                  | (prim[li] < 0))
                lg = li[got]
                t_best[lg] = t.gather(1, j)[got, 0]
                prim[lg] = k.gather(1, j)[got, 0]
                b1[lg] = u1.gather(1, j)[got, 0]
                b2[lg] = u2.gather(1, j)[got, 0]
        ii, inn = idx[~leaf], node[~leaf]
        if ii.numel():
            kids = bvh.kid[inn]
            oo, iv, tb = o[ii][:, None], inv[ii][:, None], t_best[ii][:, None]
            tn, tf = _boxes(bvh, kids, oo, iv)
            ok = (tn <= tf) & (tf > 0) & (tn <= tb)
            near0 = tn[:, 0] <= tn[:, 1]
            near = torch.where(near0, 0, 1)[:, None]
            far = 1 - near
            base = sp[ii]
            both = ok.all(1)
            first = torch.where(both[:, None], far, torch.where(ok[:, 0:1], 0, 1))
            stack[ii, base + 1] = kids.gather(1, first)[:, 0]
            stack_t[ii, base + 1] = tn.gather(1, first)[:, 0]
            stack[ii, base + 2] = torch.where(both, kids.gather(1, near)[:, 0],
                                              stack[ii, base + 2])
            stack_t[ii, base + 2] = torch.where(both, tn.gather(1, near)[:, 0],
                                                stack_t[ii, base + 2])
            sp[ii] = base + ok.sum(1)
    if any_hit:
        return hit_any
    return torch.where(prim < 0, torch.inf, t_best), prim, b1, b2
