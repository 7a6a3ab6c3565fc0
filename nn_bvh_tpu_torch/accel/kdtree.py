"""SAH kd-tree aggregate: host build + lockstep traversal (port of
nn_bvh_tpu/accel/kdtree.py).

The build is the JAX package's numpy SAH build with the reference's cost
model (isectCost 5, traversalCost 1, emptyBonus 0.5): on the same prim
bounds it gives the same node_data, prim_idx, bounds, n_nodes and
max_leaf. Leaves hold index lists, so a primitive can live in several
leaves and nothing is reordered.

The traversal is the interval-stack walk of KdTreeAggregate::Intersect,
which the JAX package runs as a vmapped lax.while_loop (not a Pallas
kernel): here plain torch ops over all rays in lockstep, one node a ray a
step. It has no kernel of its own; the BVH and its CUDA kernels stay the
production path, and this aggregate exists for parity and comparison.

- Lanes that finished keep their state (every update is masked by
  `done`), so the loop checks `done` on the host only every CHECK_EVERY
  steps and drops the finished lanes then; extra steps change nothing.
- Leaves test their prims with Moller-Trumbore (traverse.tri_isect, the
  port's triangle test), in a fixed scan of max_leaf rounded up to 8
  entries that starts at the leaf's first index. Mirrored fault of the
  JAX package: its scan is `dynamic_slice_in_dim(prims, first, scan)`,
  which clamps the start to M - scan, so a leaf whose first + scan passes
  the end of prim_idx (M entries) tests the entries [M - scan, M - scan +
  count) of another leaf instead of its own (ROADMAP queue 3).
- The stack holds STACK = 48 entries; a push past it raises
  StackOverflow (the JAX walk clamps the write and goes on).
- Dead lanes as the JAX walk has them: a ray whose clipped interval is
  empty visits nothing; any-hit reports a lane with t_max < 0 free.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from .traverse import Hit, tri_isect

ISECT_COST = 5.0
TRAV_COST = 1.0
EMPTY_BONUS = 0.5
MAX_PRIMS_LEAF = 8
MAX_DEPTH_CAP = 28
STACK = 48
CHECK_EVERY = 8   # lockstep steps between two host reads of `done`


class StackOverflow(ValueError):
    """A ray's walk pushed past the STACK-entry stack."""


class KdTree(NamedTuple):
    """Flattened kd-tree.

    node_data: (Nn, 4) f32 [split_pos | axis | above_child | n_prims]:
      axis in {0,1,2} -> interior (below child = self+1, above = above_child)
      axis == 3      -> leaf: above_child = first index into prim_idx,
                        n_prims entries
    prim_idx: (M,) i32 triangle indices (leaves may repeat prims).
    """

    node_data: np.ndarray
    prim_idx: np.ndarray
    bounds: np.ndarray  # (2,3)
    n_nodes: int
    max_leaf: int  # largest leaf prim count (static traversal scan bound)


def build_kdtree(prim_lo: np.ndarray, prim_hi: np.ndarray,
                 max_prims: int = MAX_PRIMS_LEAF) -> KdTree:
    """The JAX package's SAH kd-tree build (aggregates.cpp buildTree), in
    numpy on the host."""
    n = len(prim_lo)
    max_depth = min(int(8 + 1.3 * np.log2(max(n, 2))), MAX_DEPTH_CAP)
    root_lo = prim_lo.min(0).astype(np.float32)
    root_hi = prim_hi.max(0).astype(np.float32)

    nodes: list = []
    prim_out: list = []

    def leaf(idx):
        me = len(nodes)
        nodes.append([0.0, 3.0, float(len(prim_out)), float(len(idx))])
        prim_out.extend(int(i) for i in idx)
        return me

    def build(idx, lo, hi, depth, bad_refines):
        if len(idx) <= max_prims or depth >= max_depth:
            return leaf(idx)
        # SAH over bound-edge candidates (aggregates.cpp buildTree :91)
        d = np.maximum(hi - lo, 0)
        inv_total = 1.0 / max(2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]), 1e-20)
        old_cost = ISECT_COST * len(idx)
        best = (None, None, np.inf)
        for axis in np.argsort(-d):
            axis = int(axis)
            o = [a for a in range(3) if a != axis]
            edges = np.concatenate([prim_lo[idx, axis], prim_hi[idx, axis]])
            kinds = np.concatenate([np.zeros(len(idx)), np.ones(len(idx))])
            order = np.lexsort((kinds, edges))
            edges, kinds = edges[order], kinds[order]
            n_below, n_above = 0, len(idx)
            for e, kind in zip(edges, kinds):
                if kind == 1:
                    n_above -= 1
                if lo[axis] < e < hi[axis]:
                    b_lo = e - lo[axis]
                    b_hi = hi[axis] - e
                    sa_b = 2 * (d[o[0]] * d[o[1]] + b_lo * (d[o[0]] + d[o[1]]))
                    sa_a = 2 * (d[o[0]] * d[o[1]] + b_hi * (d[o[0]] + d[o[1]]))
                    pb = sa_b * inv_total
                    pa = sa_a * inv_total
                    eb = EMPTY_BONUS if (n_below == 0 or n_above == 0) else 0.0
                    cost = (TRAV_COST + ISECT_COST * (1 - eb)
                            * (pb * n_below + pa * n_above))
                    if cost < best[2]:
                        best = (axis, float(e), cost)
                if kind == 0:
                    n_below += 1
            if best[0] is not None:
                break  # the reference retries other axes only when no split
        axis, pos, cost = best
        if axis is None or (cost > 4 * old_cost and len(idx) < 16):
            return leaf(idx)
        if cost > old_cost:
            bad_refines += 1
        if bad_refines == 3:
            return leaf(idx)
        below = idx[prim_lo[idx, axis] < pos]
        above = idx[prim_hi[idx, axis] > pos]
        me = len(nodes)
        nodes.append([pos, float(axis), 0.0, 0.0])
        lo_a = lo.copy()
        lo_a[axis] = pos
        hi_b = hi.copy()
        hi_b[axis] = pos
        build(below, lo, hi_b, depth + 1, bad_refines)
        nodes[me][2] = float(len(nodes))
        build(above, lo_a, hi, depth + 1, bad_refines)
        return me

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        build(np.arange(n), root_lo.copy(), root_hi.copy(), 0, 0)
    finally:
        sys.setrecursionlimit(old)
    node_arr = np.asarray(nodes, np.float32)
    leaf_rows = node_arr[:, 1] == 3.0
    max_leaf = int(node_arr[leaf_rows, 3].max()) if leaf_rows.any() else 1
    return KdTree(
        node_data=node_arr,
        prim_idx=np.asarray(prim_out if prim_out else [0], np.int32),
        bounds=np.stack([root_lo, root_hi]),
        n_nodes=len(nodes),
        max_leaf=max(max_leaf, 1),
    )


def scan_width(kt: KdTree) -> int:
    """The leaf scan: max_leaf rounded up to a multiple of 8."""
    return -(-kt.max_leaf // 8) * 8


def clamped_leaves(kt: KdTree) -> np.ndarray:
    """Node ids of the leaves whose scan passes the end of prim_idx: the
    walk tests another leaf's entries for them (the mirrored clamp)."""
    nd = kt.node_data
    first, count = nd[:, 2].astype(np.int64), nd[:, 3].astype(np.int64)
    return np.nonzero((nd[:, 1] == 3.0) & (count > 0)
                      & (first + scan_width(kt) > len(kt.prim_idx)))[0]


def _walk(kt: KdTree, tri_p: torch.Tensor, o, d, t_max, any_hit: bool,
          stats: dict | None):
    dev = o.device
    nodes = torch.as_tensor(kt.node_data, device=dev)
    prims = torch.as_tensor(kt.prim_idx, device=dev).long()
    bnds = torch.as_tensor(kt.bounds, device=dev)
    scan = scan_width(kt)
    M, N = prims.shape[0], tri_p.shape[0]
    start_max = M - scan  # dynamic_slice_in_dim's clamp of the scan's start
    if start_max < 0:
        raise ValueError(f"prim_idx holds {M} entries, fewer than the {scan}-entry leaf "
                         "scan (the JAX walk cannot slice it either)")
    jj = torch.arange(scan, device=dev)
    R = o.shape[0]

    inv_d = 1.0 / torch.where(d.abs() < 1e-20,
                              torch.where(d < 0, -1e-20, 1e-20), d)
    t0s = (bnds[0] - o) * inv_d
    t1s = (bnds[1] - o) * inv_d
    g_tmin = torch.clamp(torch.minimum(t0s, t1s).amax(-1), min=0.0)
    g_tmax = torch.minimum(torch.maximum(t0s, t1s).amin(-1), t_max)

    # outputs, full width; the lanes still walking are `lane`
    out_t = t_max.clone()
    out_prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    out_b1 = torch.zeros(R, device=dev)
    out_b2 = torch.zeros(R, device=dev)
    lane = torch.nonzero(~(g_tmin > g_tmax)).squeeze(1)
    t, prim, b1, b2 = out_t[lane], out_prim[lane], out_b1[lane], out_b2[lane]
    node = torch.zeros(lane.shape[0], dtype=torch.long, device=dev)
    tmin, tmax = g_tmin[lane], g_tmax[lane]
    sp = torch.zeros(lane.shape[0], dtype=torch.long, device=dev)
    stack = torch.zeros((lane.shape[0], STACK, 3), device=dev)
    done = torch.zeros(lane.shape[0], dtype=torch.bool, device=dev)
    lo_, do_, inv_ = o[lane], d[lane], inv_d[lane]
    steps = lane_steps = 0

    while lane.numel():
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        ar = torch.arange(lane.shape[0], device=dev)
        for _ in range(CHECK_EVERY):
            nd = nodes[node]
            pos, axis, above = nd[:, 0], nd[:, 1].long(), nd[:, 2].long()
            is_leaf = axis == 3

            # leaf: test the bounded scan of prim_idx from its first entry
            start = torch.clamp(above, 0, start_max)
            pidx = prims[start[:, None] + jj[None, :]]
            tris = tri_p[torch.clamp(pidx, 0, N - 1)]
            h, th, hb1, hb2 = tri_isect(lo_[:, None, :], do_[:, None, :], tris, t[:, None])
            ok = h & (jj[None, :] < nd[:, 3].long()[:, None])
            tb = torch.where(ok, th, torch.inf)
            k = torch.argmin(tb, dim=1)[:, None]
            tk = tb.gather(1, k)[:, 0]
            better = is_leaf & (tk < t) & ~done
            t = torch.where(better, tk, t)
            prim = torch.where(better, pidx.gather(1, k)[:, 0].to(torch.int32), prim)
            b1 = torch.where(better, hb1.gather(1, k)[:, 0], b1)
            b2 = torch.where(better, hb2.gather(1, k)[:, 0], b2)

            # interior: split the interval at the plane
            ax = torch.clamp(axis, max=2)[:, None]
            oa = lo_.gather(1, ax)[:, 0]
            da = inv_.gather(1, ax)[:, 0]
            t_plane = (pos - oa) * da
            below_first = (oa < pos) | ((oa == pos) & (da <= 0))
            first_child = torch.where(below_first, node + 1, above)
            second_child = torch.where(below_first, above, node + 1)
            only_first = (t_plane > tmax) | (t_plane <= 0)
            # the reference's else-if: only_first wins when both hold
            only_second = (t_plane < tmin) & ~only_first
            push = ~is_leaf & ~only_first & ~only_second & ~done
            overflow |= (push & (sp >= STACK)).any()
            row = torch.stack([second_child.to(torch.float32),
                               torch.maximum(t_plane, tmin), tmax], -1)
            spc = torch.clamp(sp, max=STACK - 1)
            stack[ar, spc] = torch.where(push[:, None], row, stack[ar, spc])
            sp = torch.where(push, sp + 1, sp)
            node_next = torch.where(only_second, second_child, first_child)
            tmin_next = torch.where(only_second, torch.maximum(t_plane, tmin), tmin)
            tmax_next = torch.where(push, torch.minimum(t_plane, tmax), tmax)

            # a leaf (or an any-hit lane with its hit) pops the next interval
            got = prim >= 0 if any_hit else torch.zeros_like(done)
            pop = is_leaf | got
            empty = sp == 0
            sp2 = torch.where(pop & ~empty, sp - 1, sp)
            popped = stack[ar, sp2.clamp(0, STACK - 1)]
            live = ~done
            node = torch.where(live, torch.where(pop, popped[:, 0].long(), node_next), node)
            tmin = torch.where(live, torch.where(pop, popped[:, 1], tmin_next), tmin)
            tmax = torch.where(live, torch.where(pop, popped[:, 2], tmax_next), tmax)
            sp = torch.where(live, sp2, sp)
            # early out where the best hit precedes the popped interval
            skip = pop & ~empty & (t < tmin)
            done = done | (live & ((pop & empty) | got | skip))
            lane_steps += lane.shape[0]
            steps += 1
        if bool(overflow):
            raise StackOverflow(f"a kd-tree walk pushed past its {STACK}-entry stack")
        fin = torch.nonzero(done).squeeze(1)
        keep = torch.nonzero(~done).squeeze(1)
        ln = lane[fin]
        out_t[ln], out_prim[ln], out_b1[ln], out_b2[ln] = t[fin], prim[fin], b1[fin], b2[fin]
        lane, t, prim, b1, b2 = lane[keep], t[keep], prim[keep], b1[keep], b2[keep]
        node, tmin, tmax, sp, stack = node[keep], tmin[keep], tmax[keep], sp[keep], stack[keep]
        done, lo_, do_, inv_ = done[keep], lo_[keep], do_[keep], inv_[keep]
    if stats is not None:
        stats["steps"] = steps
        stats["lane_steps"] = lane_steps
    return Hit(t=torch.where(out_prim >= 0, out_t, torch.inf), prim=out_prim, b1=out_b1,
               b2=out_b2)


def intersect_closest(kt: KdTree, tri_p: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                      t_max: torch.Tensor, stats: dict | None = None) -> Hit:
    """Closest hit of each ray (o, d (R, 3), t_max (R,)) among the triangles
    tri_p (N, 3, 3) through the kd-tree, on the rays' device. `stats`, a
    dict, receives the lockstep steps ("steps") and the lane-steps walked
    ("lane_steps")."""
    return _walk(kt, tri_p, o, d, t_max, False, stats)


def intersect_any(kt: KdTree, tri_p: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                  t_max: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
    """Occlusion of each ray: (R,) bool, a lane stops at its first hit."""
    return _walk(kt, tri_p, o, d, t_max, True, stats).prim >= 0
