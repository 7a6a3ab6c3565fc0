"""Host-side binned-SAH BVH construction -> flattened SoA node arrays.

Numpy copy of the binned-SAH builder of nn_bvh_tpu/accel/build.py (the JAX
package prefers its native C++ builder when a toolchain exists; the two give
the same node topology and bounds but a different `prim_order`, so tests
carry a JAX-built BVH across with `geometry.scene.scene_from_numpy` instead of
rebuilding it). Binned SAH with 12 buckets and forward/backward cost scans,
an explicit work stack, depth-first flattening with second-child offsets,
leaves capped at MAX_LEAF_PRIMS and primitives reordered so every leaf is a
contiguous range.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

MAX_LEAF_PRIMS = 8  # the BVH4 traversal tests at most 8 triangles per leaf
N_BUCKETS = 12
TRAV_COST = 0.5  # relative traversal cost (aggregates.cpp uses 1/2 per prim isect)


class BVH(NamedTuple):
    """Flattened depth-first BVH (LinearBVHNode analog, aggregates.h).

    node_lo/node_hi: (Nn, 3) f32 child bounds.
    node_meta: (Nn, 3) i32 = [offset, count, axis]:
      count > 0  -> leaf; offset = first primitive (post-reorder), count prims
      count == 0 -> interior; first child = self+1, offset = second child index,
                    axis = split axis (for front-to-back ordered descent)
    prim_order: (N,) i64 — original triangle index per post-reorder slot.
    """

    node_lo: np.ndarray
    node_hi: np.ndarray
    node_meta: np.ndarray
    prim_order: np.ndarray
    n_nodes: int


def build_sah(prim_lo: np.ndarray, prim_hi: np.ndarray, max_leaf: int = MAX_LEAF_PRIMS) -> BVH:
    """Binned-SAH build over primitive bounds (prim_lo/hi: (N,3) f32)."""
    n = len(prim_lo)
    assert n > 0
    centroids = 0.5 * (prim_lo + prim_hi)

    order_out = np.empty(n, np.int64)
    # node storage, grown dynamically
    cap = max(2 * n, 16)
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_meta = np.empty((cap, 3), np.int32)
    n_nodes = 0
    prims_written = 0

    def alloc():
        nonlocal n_nodes, cap, node_lo, node_hi, node_meta
        if n_nodes == cap:
            cap *= 2
            node_lo = np.resize(node_lo, (cap, 3))
            node_hi = np.resize(node_hi, (cap, 3))
            node_meta = np.resize(node_meta, (cap, 3))
        n_nodes += 1
        return n_nodes - 1

    # explicit DFS stack producing depth-first node order directly.
    # entries: (indices, parent_node_id_to_patch or -1)
    root_idx = np.arange(n, dtype=np.int64)
    stack = [(root_idx, -1)]
    while stack:
        idx, patch = stack.pop()
        me = alloc()
        if patch >= 0:
            node_meta[patch, 0] = me  # parent's second-child offset
        lo = prim_lo[idx].min(0)
        hi = prim_hi[idx].max(0)
        node_lo[me] = lo
        node_hi[me] = hi

        make_leaf = len(idx) <= max_leaf
        if not make_leaf:
            c = centroids[idx]
            clo, chi = c.min(0), c.max(0)
            ext = chi - clo
            axis = int(np.argmax(ext))
            if ext[axis] <= 1e-12:
                # degenerate: equal-counts split (aggregates.h Middle fallback)
                mid = len(idx) // 2
                part = np.argsort(c[:, axis], kind="stable")
                left, right = idx[part[:mid]], idx[part[mid:]]
            else:
                # 12-bucket binned SAH (aggregates.cpp:278)
                b = np.minimum(
                    (N_BUCKETS * (c[:, axis] - clo[axis]) / ext[axis]).astype(np.int32),
                    N_BUCKETS - 1,
                )
                counts = np.bincount(b, minlength=N_BUCKETS)
                blo = np.full((N_BUCKETS, 3), np.inf, np.float32)
                bhi = np.full((N_BUCKETS, 3), -np.inf, np.float32)
                np.minimum.at(blo, b, prim_lo[idx])
                np.maximum.at(bhi, b, prim_hi[idx])
                # prefix/suffix scans of counts and bounds
                cum_lo_f = np.minimum.accumulate(blo, axis=0)
                cum_hi_f = np.maximum.accumulate(bhi, axis=0)
                cum_lo_b = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
                cum_hi_b = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
                cnt_f = np.cumsum(counts)
                cnt_b = np.cumsum(counts[::-1])[::-1]

                def area(lo_, hi_):
                    d = np.maximum(hi_ - lo_, 0)
                    return 2 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

                a_l = area(cum_lo_f[:-1], cum_hi_f[:-1])
                a_r = area(cum_lo_b[1:], cum_hi_b[1:])
                costs = a_l * cnt_f[:-1] + a_r * cnt_b[1:]
                valid = (cnt_f[:-1] > 0) & (cnt_b[1:] > 0)
                costs = np.where(valid, costs, np.inf)
                split = int(np.argmin(costs))
                parent_area = max(area(lo[None], hi[None])[0], 1e-20)
                split_cost = TRAV_COST + costs[split] / parent_area
                leaf_cost = float(len(idx))
                if len(idx) <= max_leaf and leaf_cost <= split_cost:
                    make_leaf = True
                else:
                    mask = b <= split
                    if not mask.any() or mask.all():
                        mid = len(idx) // 2
                        part = np.argsort(c[:, axis], kind="stable")
                        left, right = idx[part[:mid]], idx[part[mid:]]
                    else:
                        left, right = idx[mask], idx[~mask]
            if not make_leaf:
                node_meta[me] = (0, 0, axis)  # offset patched when right child pops
                # push right first so left is processed next (depth-first order)
                stack.append((right, me))
                stack.append((left, -2))
                continue

        # leaf
        count = len(idx)
        order_out[prims_written : prims_written + count] = idx
        node_meta[me] = (prims_written, count, 0)
        prims_written += count

    assert prims_written == n
    return BVH(
        node_lo=node_lo[:n_nodes].copy(),
        node_hi=node_hi[:n_nodes].copy(),
        node_meta=node_meta[:n_nodes].copy(),
        prim_order=order_out,
        n_nodes=n_nodes,
    )


def triangle_bounds(tri_p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N,3,3) triangle vertices -> (lo, hi) each (N,3)."""
    return tri_p.min(1).astype(np.float32), tri_p.max(1).astype(np.float32)
