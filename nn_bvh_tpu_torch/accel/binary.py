"""Binary BVH tables: numpy port of nn_bvh_tpu/accel/pallas_traverse.py's
host packing (`tree_depth`, `pack_nodes`, `pack_tris`, :60-107), plus the
CUDA kernels' own node layouts.

`pack_nodes` and `pack_tris` build the TPU kernels' lane-major tables (kept
so the tests can hold them byte for byte against the JAX package).

`pack_binary_pairs` lays the flat BVH out for `csrc/binary_traverse.cu`:
one 64-byte record per interior node holding both children, (1 + Ni, 16)
float32:

    [lo0.xyz, hi0.xyz, lo1.xyz, hi1.xyz, entry0, entry1, 0, 0]

child 0 is the left child (node + 1 of the flat tree), child 1 the right
one (its offset); an entry >= 1 is the record of an interior child, an
entry < 0 a leaf -(1 + offset*16 + count-1), both as int32 bits. Records
1 .. Ni are the interior nodes in the flat tree's (depth-first) order.
Record 0 is a header: child 0 is the root's box and entry (the walk starts
at that entry: the root's record, or the leaf of a tree that is one leaf,
or NO_ENTRY for an empty tree), child 1 an empty box (3e38) with NO_ENTRY.

`pack_binary_cuda` is the 32-byte layout of the kernel lab
(`csrc/kernel_lab.cu`): one record per node, [lo.xyz, hi.xyz, offset,
count + 32*axis] float32, (Nn, 8), the last two fields as int32 bits (the
TPU table stores them as f32 values, exact only below 2^24).
"""

from __future__ import annotations

import numpy as np

from .bvh4 import MAX_LEAF

LANES = 128
NO_ENTRY = 0x7FFFFFFF  # an entry slot that leads nowhere
EMPTY = 3e38           # the bounds of the header's empty child: never hit


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


def _check_tree(meta: np.ndarray, stack_depth: int) -> None:
    """Raises when the tree is too deep for a `stack_depth`-entry stack (the
    bound of pallas_traverse.py:114-118 and hbm_traverse.py:51-55) or holds
    a leaf of more than MAX_LEAF triangles (the kernels would skip the
    rest)."""
    depth = tree_depth(meta)
    if depth >= stack_depth - 1:
        raise ValueError(f"BVH depth {depth} overflows the kernel's "
                         f"{stack_depth}-entry stack")
    if meta[:, 1].max(initial=0) > MAX_LEAF:
        raise ValueError(f"a leaf holds {int(meta[:, 1].max())} triangles; the "
                         f"kernel tests at most {MAX_LEAF}")


def pack_binary_pairs(node_lo, node_hi, node_meta, stack_depth: int = 64) -> np.ndarray:
    """-> (1 + Ni, 16) f32 pair records of csrc/binary_traverse.cu (module
    docstring). Raises as `pack_binary_cuda` does (`_check_tree`)."""
    lo = np.asarray(node_lo, np.float32)
    hi = np.asarray(node_hi, np.float32)
    meta = np.asarray(node_meta).astype(np.int64)
    _check_tree(meta, stack_depth)
    off, cnt = meta[:, 0], meta[:, 1]
    inner = np.nonzero(cnt == 0)[0]
    if len(meta) and (off[cnt > 0].max(initial=0) + 1) * 16 >= 2 ** 31:
        raise ValueError("a leaf's triangle offset does not fit its int32 entry")
    entry = -(1 + off * 16 + (cnt - 1))
    entry[inner] = 1 + np.arange(len(inner))
    out = np.zeros((1 + len(inner), 16), np.float32)
    out[0, 6:12] = EMPTY
    out[0, 12:14] = np.int32(NO_ENTRY).view(np.float32)
    if len(meta):
        out[0, 0:3], out[0, 3:6] = lo[0], hi[0]
        out[0, 12] = np.int32(entry[0]).view(np.float32)
    for c, child in enumerate((inner + 1, off[inner])):
        out[1:, 6 * c:6 * c + 3] = lo[child]
        out[1:, 6 * c + 3:6 * c + 6] = hi[child]
        out[1:, 12 + c] = entry[child].astype(np.int32).view(np.float32)
    return out


def pack_binary_cuda(node_lo, node_hi, node_meta, stack_depth: int = 64) -> np.ndarray:
    """-> (Nn, 8) f32 node records of the kernel lab. Raises as
    `_check_tree` says."""
    meta = np.asarray(node_meta).astype(np.int64)
    _check_tree(meta, stack_depth)
    out = np.zeros((len(meta), 8), np.float32)
    out[:, 0:3] = np.asarray(node_lo, np.float32)
    out[:, 3:6] = np.asarray(node_hi, np.float32)
    out[:, 6] = meta[:, 0].astype(np.int32).view(np.float32)
    out[:, 7] = (meta[:, 1] + 32 * meta[:, 2]).astype(np.int32).view(np.float32)
    return out
