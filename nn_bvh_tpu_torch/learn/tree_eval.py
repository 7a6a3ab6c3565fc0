"""Plane-tree evaluation: build a BVH from predicted split planes and score it.

A numpy copy of nn_bvh_tpu/learn/tree_eval.py, so that the port imports nothing of
the JAX package; its outputs are bit-identical to the JAX package's.

Rebuild of the fork's offline evaluation path (SURVEY.md §3.5):
- `nn_tree_bench.build_tree_from_nn_prediction` (:44) — rebuild a binary tree
  from the level-order plane list, classify prims per plane, refit tight AABBs
  (nn_BVH.BVHNode.split :32-71 + refit :73-75).
- `nn_loss.SAH` (:165) — full-tree SAH cost, C_inn = 1.2, C_tri = 1.0
  (:113-116).
- `nn_loss.EPO` (:119) — Aila et al. EPO: for every node, the surface area of
  *external* primitives (not belonging to the node's subtree) that overlap
  the node, weighted by the node's cost constant, normalized by total
  primitive area.
- greedy SAH plane-tree builder (nss_kd_tree.__build_greedy_tree analog) as
  the classical baseline the network is compared against.

Reference bugs NOT replicated (SURVEY.md §7.3): nn_AABB z-accessors returning
y, nn_tree_bench indentation breakage.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

C_INN = 1.2  # traversal cost (nn_loss.py:113)
C_TRI = 1.0  # intersection cost (:116)


def _tris(prims: np.ndarray) -> np.ndarray:
    return prims.reshape(-1, 3, 3).transpose(0, 2, 1)  # (F, verts, xyz)


def _prim_bounds(prims: np.ndarray):
    t = _tris(prims)
    return t.min(1), t.max(1)


def _prim_mids(prims: np.ndarray) -> np.ndarray:
    lo, hi = _prim_bounds(prims)
    return 0.5 * (lo + hi)


def _area(lo: np.ndarray, hi: np.ndarray) -> float:
    d = np.maximum(hi - lo, 0)
    return float(2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def _prim_areas(prims: np.ndarray) -> np.ndarray:
    t = _tris(prims)
    u = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    return 0.5 * np.linalg.norm(u, axis=-1)


@dataclass
class PlaneNode:
    lo: np.ndarray
    hi: np.ndarray
    prims: np.ndarray  # indices
    left: "PlaneNode | None" = None
    right: "PlaneNode | None" = None

    @property
    def is_leaf(self):
        return self.left is None


def build_tree_from_planes(prims: np.ndarray, planes: np.ndarray) -> PlaneNode:
    """planes: (2^L - 1, 4) level-order [nx, ny, nz, offset]; prims (F, 9).

    Prims are classified to children by midpoint (the EPO-variant rule); node
    AABBs are tightly refit to member prims.
    """
    mids = _prim_mids(prims)
    lo_all, hi_all = _prim_bounds(prims)

    def refit(idx):
        if len(idx) == 0:
            z = np.zeros(3, np.float32)
            return z, z
        return lo_all[idx].min(0), hi_all[idx].max(0)

    n_planes = len(planes)
    root_lo, root_hi = refit(np.arange(len(prims)))
    root = PlaneNode(root_lo, root_hi, np.arange(len(prims)))
    frontier = [root]
    pi = 0
    while pi < n_planes and frontier:
        next_frontier = []
        for node in frontier:
            if pi >= n_planes:
                break
            nx, ny, nz, off = planes[pi]
            pi += 1
            axis = int(np.argmax([nx, ny, nz]))
            left_idx = node.prims[mids[node.prims, axis] <= off]
            right_idx = node.prims[mids[node.prims, axis] > off]
            llo, lhi = refit(left_idx)
            rlo, rhi = refit(right_idx)
            node.left = PlaneNode(llo, lhi, left_idx)
            node.right = PlaneNode(rlo, rhi, right_idx)
            next_frontier += [node.left, node.right]
        frontier = next_frontier
    return root


def greedy_tree(prims: np.ndarray, levels: int, n_bins: int = 32) -> np.ndarray:
    """Greedy binned-SAH plane tree -> (2^(levels-1) - 1, 4) level-order planes
    (the classical baseline, nss_kd_tree.__build_greedy_tree semantics with
    binned offsets :275)."""
    mids = _prim_mids(prims)
    lo_all, hi_all = _prim_bounds(prims)
    planes = []
    frontier = [np.arange(len(prims))]
    for _ in range(levels - 1):
        nxt = []
        for idx in frontier:
            if len(idx) == 0:
                planes.append([1.0, 0.0, 0.0, 0.0])
                nxt += [idx, idx]
                continue
            best = None
            lo = lo_all[idx].min(0)
            hi = hi_all[idx].max(0)
            for axis in range(3):
                if hi[axis] - lo[axis] <= 0:
                    continue
                cand = np.linspace(lo[axis], hi[axis], n_bins + 2)[1:-1]
                m = mids[idx, axis]
                for off in cand:
                    lmask = m <= off
                    if not lmask.any() or lmask.all():
                        continue
                    li, ri = idx[lmask], idx[~lmask]
                    c = _area(lo_all[li].min(0), hi_all[li].max(0)) * len(li) + _area(
                        lo_all[ri].min(0), hi_all[ri].max(0)
                    ) * len(ri)
                    if best is None or c < best[0]:
                        best = (c, axis, off)
            if best is None:
                planes.append([1.0, 0.0, 0.0, float(mids[idx, 0].mean())])
                half = len(idx) // 2
                nxt += [idx[:half], idx[half:]]
                continue
            _, axis, off = best
            n = [0.0, 0.0, 0.0]
            n[axis] = 1.0
            planes.append(n + [float(off)])
            lmask = mids[idx, axis] <= off
            nxt += [idx[lmask], idx[~lmask]]
        frontier = nxt
    return np.asarray(planes, np.float32)


def sah_cost(root: PlaneNode, c_inn: float = C_INN, c_tri: float = C_TRI) -> float:
    """Full-tree SAH (nn_loss.SAH :165)."""
    root_area = max(_area(root.lo, root.hi), 1e-12)
    total = 0.0
    stack = [root]
    while stack:
        n = stack.pop()
        a = _area(n.lo, n.hi)
        if n.is_leaf:
            total += c_tri * len(n.prims) * a
        else:
            total += c_inn * a
            stack += [n.left, n.right]
    return total / root_area


def epo_cost(root: PlaneNode, prims: np.ndarray,
             c_inn: float = C_INN, c_tri: float = C_TRI) -> float:
    """Full-tree EPO (nn_loss.EPO :119, Aila et al. 2013): per node, the
    surface area of primitives NOT in the node's subtree that overlap the
    node's AABB, weighted by the node's cost, over total primitive area."""
    lo_all, hi_all = _prim_bounds(prims)
    areas = _prim_areas(prims)
    total_area = max(float(areas.sum()), 1e-12)
    n_prims = len(prims)
    total = 0.0
    stack = [root]
    while stack:
        n = stack.pop()
        member = np.zeros(n_prims, bool)
        member[n.prims] = True
        overlap = np.all(hi_all >= n.lo, axis=1) & np.all(lo_all <= n.hi, axis=1)
        external = overlap & ~member
        # approximation: half the surface of each overlapping external prim
        # (the reference clips prims to the node; 0.5x is its own approximation
        # factor, nss_tree_modules.py:1109)
        sa_ext = 0.5 * float(areas[external].sum())
        w = c_tri * len(n.prims) if n.is_leaf else c_inn
        total += w * sa_ext
        if not n.is_leaf:
            stack += [n.left, n.right]
    return total / total_area


def tree_stats(root: PlaneNode) -> dict:
    n_nodes = n_leaves = max_d = 0
    empty = 0
    stack = [(root, 0)]
    while stack:
        n, d = stack.pop()
        n_nodes += 1
        max_d = max(max_d, d)
        if n.is_leaf:
            n_leaves += 1
            if len(n.prims) == 0:
                empty += 1
        else:
            stack += [(n.left, d + 1), (n.right, d + 1)]
    return {"nodes": n_nodes, "leaves": n_leaves, "depth": max_d, "empty_leaves": empty}
