"""Greedy kd-tree reference builders + predicted-tree evaluation.

A numpy copy of nn_bvh_tpu/learn/kd_tree.py, so that the port imports nothing of
the JAX package; its outputs are bit-identical to the JAX package's.

Rebuild of the reference's `machine_learning/nss_kd_tree.py` (kd_tree class):
- greedy top-down builders over primitive midpoints with SAH / VH strategies
  (`__build_greedy_tree:392`), binned candidate offsets
  (`__get_binned_offsets:275`),
- fixed-depth trees exported as level-order plane lists [nx,ny,nz,offset]
  (the binary artifact format of `nss_model_test.py:37`),
- preorder <-> level-order conversion (`preOrder_to_lvlOrder:873`),
- cost of a *predicted* tree vs the greedy tree (`abs_diff_pre_order:750`).

Numpy host code (tree build is scene-compile work, like the renderer BVH);
the differentiable path lives in learn.treenet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SAH = "sah"
VH = "vh"  # volume heuristic

C_INN = 1.2  # traversal cost  (nn_loss.py:113)
C_TRI = 1.0  # intersection cost (nn_loss.py:116)


class KdTree(NamedTuple):
    """Fixed-depth level-order split-plane tree: planes[l] has 2^l rows of
    [axis (0..2), offset]; leaves implied at depth `levels`."""

    planes: list  # list of (2^l, 2) arrays [axis, offset]
    levels: int


def _bounds_of(prims: np.ndarray):
    """prims (N, 9) = 3 verts x xyz -> (lo, hi) of the set."""
    p = prims.reshape(-1, 3, 3)
    return p.min((0, 1)), p.max((0, 1))


def _midpoints(prims: np.ndarray) -> np.ndarray:
    p = prims.reshape(-1, 3, 3)
    return 0.5 * (p.min(1) + p.max(1))


def _sa(lo, hi):
    d = np.maximum(hi - lo, 0)
    return 2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def _vol(lo, hi):
    d = np.maximum(hi - lo, 0)
    return d[0] * d[1] * d[2]


def binned_offsets(lo: float, hi: float, n_bins: int = 32) -> np.ndarray:
    """Candidate split offsets: bin edges inside (lo, hi)
    (nss_kd_tree.__get_binned_offsets:275)."""
    return np.linspace(lo, hi, n_bins + 2)[1:-1]


def _split_cost(strategy, lo, hi, axis, off, mids):
    left = mids[:, axis] <= off
    nl, nr = int(left.sum()), int((~left).sum())
    lo_l, hi_l = lo.copy(), hi.copy()
    hi_l[axis] = off
    lo_r, hi_r = lo.copy(), hi.copy()
    lo_r[axis] = off
    if strategy == SAH:
        parent = max(_sa(lo, hi), 1e-20)
        return C_INN + C_TRI * (_sa(lo_l, hi_l) * nl + _sa(lo_r, hi_r) * nr) / parent
    parent = max(_vol(lo, hi), 1e-20)
    return C_INN + C_TRI * (_vol(lo_l, hi_l) * nl + _vol(lo_r, hi_r) * nr) / parent


def build_greedy(prims: np.ndarray, levels: int = 4, strategy: str = SAH,
                 n_bins: int = 32) -> KdTree:
    """Greedy fixed-depth kd-tree: per node, best (axis, binned offset) by the
    strategy cost (nss_kd_tree.__build_greedy_tree:392). prims: (N, 9)."""
    root_lo, root_hi = _bounds_of(prims)
    mids_all = _midpoints(prims)

    # (node bounds, member mask) per node, level by level
    cur = [(root_lo, root_hi, np.ones(len(prims), bool))]
    planes = []
    for _ in range(levels):
        rows = np.zeros((len(cur), 2), np.float32)
        nxt = []
        for i, (lo, hi, mask) in enumerate(cur):
            mids = mids_all[mask]
            best = (0, 0.5 * (lo[0] + hi[0]), np.inf)
            if len(mids):
                for axis in range(3):
                    for off in binned_offsets(lo[axis], hi[axis], n_bins):
                        c = _split_cost(strategy, lo, hi, axis, off, mids)
                        if c < best[2]:
                            best = (axis, float(off), c)
            axis, off, _ = best
            rows[i] = (axis, off)
            lo_l, hi_l = lo.copy(), hi.copy()
            hi_l[axis] = off
            lo_r, hi_r = lo.copy(), hi.copy()
            lo_r[axis] = off
            side = mids_all[:, axis] <= off
            nxt.append((lo_l, hi_l, mask & side))
            nxt.append((lo_r, hi_r, mask & ~side))
        planes.append(rows)
        cur = nxt
    return KdTree(planes=planes, levels=levels)


def tree_cost(tree: KdTree, prims: np.ndarray, strategy: str = SAH) -> float:
    """Cost of a fixed-depth plane tree over the primitive midpoints
    (the ML side's tree-quality metric, nn_loss.py SAH:165)."""
    root_lo, root_hi = _bounds_of(prims)
    mids = _midpoints(prims)
    parent_norm = max((_sa if strategy == SAH else _vol)(root_lo, root_hi), 1e-20)
    measure = _sa if strategy == SAH else _vol
    total = 0.0
    cur = [(root_lo, root_hi, np.ones(len(prims), bool))]
    for rows in tree.planes:
        nxt = []
        for i, (lo, hi, mask) in enumerate(cur):
            total += C_INN * measure(lo, hi) / parent_norm
            axis = int(rows[i, 0])
            off = float(rows[i, 1])
            lo_l, hi_l = lo.copy(), hi.copy()
            hi_l[axis] = off
            lo_r, hi_r = lo.copy(), hi.copy()
            lo_r[axis] = off
            side = mids[:, axis] <= off
            nxt.append((lo_l, hi_l, mask & side))
            nxt.append((lo_r, hi_r, mask & ~side))
        cur = nxt
    for lo, hi, mask in cur:  # leaves
        total += C_TRI * int(mask.sum()) * measure(lo, hi) / parent_norm
    return float(total)


# ---------------------------------------------------------------------------
# plane-list artifact IO (nss_model_test.export_structure_sah:13-37)
# ---------------------------------------------------------------------------

def to_level_order(tree: KdTree) -> np.ndarray:
    """-> (M, 4) float32 rows [nx, ny, nz, offset] in level order (the binary
    artifact format consumed by nn_tree_bench.py:44)."""
    rows = []
    for lv in tree.planes:
        for axis, off in lv:
            n = np.zeros(3, np.float32)
            n[int(axis)] = 1.0
            rows.append(np.concatenate([n, [off]]))
    return np.asarray(rows, np.float32)


def from_level_order(flat: np.ndarray) -> KdTree:
    flat = np.asarray(flat, np.float32).reshape(-1, 4)
    planes, i, width, levels = [], 0, 1, 0
    while i < len(flat):
        rows = np.zeros((width, 2), np.float32)
        for j in range(width):
            rows[j, 0] = int(np.argmax(np.abs(flat[i + j, :3])))
            rows[j, 1] = flat[i + j, 3]
        planes.append(rows)
        i += width
        width *= 2
        levels += 1
    return KdTree(planes=planes, levels=levels)


def preorder_to_levelorder(flat_pre: np.ndarray, levels: int) -> np.ndarray:
    """Reorder a preorder plane list to level order
    (nss_kd_tree.preOrder_to_lvlOrder:873)."""
    flat_pre = np.asarray(flat_pre).reshape(-1, 4)
    out = np.zeros_like(flat_pre)
    pos = [0]

    def walk(level, index_in_level):
        if level >= levels:
            return
        lvl_base = (1 << level) - 1
        out[lvl_base + index_in_level] = flat_pre[pos[0]]
        pos[0] += 1
        walk(level + 1, 2 * index_in_level)
        walk(level + 1, 2 * index_in_level + 1)

    walk(0, 0)
    return out


def abs_diff(tree_a: KdTree, tree_b: KdTree) -> float:
    """Mean |offset| difference between two same-shape trees
    (nss_kd_tree.abs_diff_pre_order:750 analog on level-order trees)."""
    total, n = 0.0, 0
    for a, b in zip(tree_a.planes, tree_b.planes):
        total += float(np.abs(a[:, 1] - b[:, 1]).sum())
        n += len(a)
    return total / max(n, 1)
