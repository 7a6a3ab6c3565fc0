"""Binary BVH tables: numpy port of nn_bvh_tpu/accel/pallas_traverse.py's
host packing (`tree_depth`, `pack_nodes`, `pack_tris`, :60-107), plus the
CUDA kernel's own node layout.

`pack_nodes` and `pack_tris` build the TPU kernels' lane-major tables (kept
so the tests can hold them byte for byte against the JAX package).
`pack_binary_cuda` lays the flat BVH out for `csrc/binary_traverse.cu`: one
32-byte record per node, [lo.xyz, hi.xyz, offset, count + 32*axis] float32,
(Nn, 8), the last two fields as int32 bits (the TPU table stores them as
f32 values, exact only below 2^24).
"""

from __future__ import annotations

import numpy as np

from .bvh4 import MAX_LEAF

LANES = 128


def tree_depth(node_meta) -> int:
    """Depth of the flattened DFS tree (root 0). Both children of node i
    (i+1 and offset) have larger indices, so one increasing pass is exact."""
    meta = np.asarray(node_meta)
    n = len(meta)
    depth = np.zeros(n, np.int32)
    for i in range(n):
        if meta[i, 1] == 0:
            d = depth[i] + 1
            if depth[i + 1] < d:
                depth[i + 1] = d
            off = int(meta[i, 0])
            if depth[off] < d:
                depth[off] = d
    return int(depth.max()) if n else 0


def pack_nodes(node_lo, node_hi, node_meta) -> np.ndarray:
    """(Nn,3)x2 + (Nn,3)i32 -> (nblocks*8, 128) f32 lane-major TPU table."""
    node_lo = np.asarray(node_lo, np.float32)
    node_hi = np.asarray(node_hi, np.float32)
    node_meta = np.asarray(node_meta)
    n = len(node_lo)
    nb = -(-n // LANES)
    tab = np.zeros((nb, 8, LANES), np.float32)
    idx = np.arange(n)
    blk, lane = idx // LANES, idx % LANES
    for f in range(3):
        tab[blk, f, lane] = node_lo[:, f]
        tab[blk, 3 + f, lane] = node_hi[:, f]
    tab[blk, 6, lane] = node_meta[:, 0].astype(np.float32)
    tab[blk, 7, lane] = (node_meta[:, 1] + 32 * node_meta[:, 2]).astype(np.float32)
    return tab.reshape(nb * 8, LANES)


def pack_tris(tri_p) -> np.ndarray:
    """(Nt,3,3) -> (ntb*9, 128) f32 TPU table: rows [x1 x2 x3 y1 y2 y3 z1 z2 z3]."""
    tri_p = np.asarray(tri_p, np.float32)
    n = len(tri_p)
    nb = -(-n // LANES)
    tab = np.zeros((nb, 9, LANES), np.float32)
    idx = np.arange(n)
    blk, lane = idx // LANES, idx % LANES
    for axis in range(3):
        for v in range(3):
            tab[blk, 3 * axis + v, lane] = tri_p[:, v, axis]
    return tab.reshape(nb * 9, LANES)


def pack_binary_cuda(node_lo, node_hi, node_meta, stack_depth: int = 64) -> np.ndarray:
    """-> (Nn, 8) f32 node records of the CUDA kernel. Raises when the tree
    is too deep for a `stack_depth`-entry stack (the bound of
    pallas_traverse.py:114-118 and hbm_traverse.py:51-55) or holds a leaf of
    more than MAX_LEAF triangles (the kernel would skip the rest)."""
    meta = np.asarray(node_meta).astype(np.int64)
    depth = tree_depth(meta)
    if depth >= stack_depth - 1:
        raise ValueError(f"BVH depth {depth} overflows the kernel's "
                         f"{stack_depth}-entry stack")
    if meta[:, 1].max(initial=0) > MAX_LEAF:
        raise ValueError(f"a leaf holds {int(meta[:, 1].max())} triangles; the "
                         f"kernel tests at most {MAX_LEAF}")
    out = np.zeros((len(meta), 8), np.float32)
    out[:, 0:3] = np.asarray(node_lo, np.float32)
    out[:, 3:6] = np.asarray(node_hi, np.float32)
    out[:, 6] = meta[:, 0].astype(np.int32).view(np.float32)
    out[:, 7] = (meta[:, 1] + 32 * meta[:, 2]).astype(np.int32).view(np.float32)
    return out
