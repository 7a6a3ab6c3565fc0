"""BVH8 wide nodes: host-side collapse + packing (numpy port of
nn_bvh_tpu/accel/bvh8.py:27-107, plus the CUDA kernel's own node layout).

`collapse_bvh8` and `pack_wide` are copies of the JAX package's functions
(the packed TPU tables are array-equal); their child meta is >= 0 for a
wide-node index, < 0 for a leaf -(1 + offset*8 + (count-1)), and an empty
child has lo = hi = 3e38 (missed for every ray, whatever its direction),
meta 0.

`pack_bvh8_cuda` lays the same wide nodes out for `csrc/bvh8_traverse.cu`:
one 256-byte record per wide node, 8 children x [lo.xyz, hi.xyz, entry
(i32 bits), pad] float32, (W, 8, 8), with the f32 bounds of the collapse
(the TPU BVH8 table is f32 too). The entry of a wide node is its index, of
a leaf -(1 + offset*16 + (count-1)), the encoding `trav::walk` decodes; an
empty child keeps meta 0 and its 3e38 box.
"""

from __future__ import annotations

import numpy as np

from .bvh4 import wide_depth

LANES = 128
WIDTH = 8
NODES_PER_TILE = 16  # 16 nodes x 8 fields = 128 lanes
STACK_DEPTH = 192    # per-ray stack entries of the CUDA kernel


def collapse_bvh8(node_lo: np.ndarray, node_hi: np.ndarray,
                  node_meta: np.ndarray):
    """Binary flat BVH (interior -> children (self+1, offset)) -> wide arrays
    (W,8,3) lo/hi + (W,8) i64 child meta. Greedy: each wide node absorbs the
    largest-area interior descendant until it holds 8 subtree roots."""
    node_lo = np.asarray(node_lo, np.float32)
    node_hi = np.asarray(node_hi, np.float32)
    meta = np.asarray(node_meta)
    offs, cnts = meta[:, 0], meta[:, 1]

    def area(i):
        d = node_hi[i] - node_lo[i]
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    wide_lo, wide_hi, wide_meta = [], [], []

    def alloc_wide():
        wide_lo.append(np.full((WIDTH, 3), 3e38, np.float32))
        wide_hi.append(np.full((WIDTH, 3), 3e38, np.float32))
        wide_meta.append(np.zeros(WIDTH, np.int64))
        return len(wide_lo) - 1

    root_w = alloc_wide()
    stack = [(0, root_w)]
    while stack:
        b, w = stack.pop()
        if cnts[b] > 0:
            children = [b]
        else:
            children = [b + 1, int(offs[b])]
            while len(children) < WIDTH:
                best, best_a = -1, -1.0
                for k, c in enumerate(children):
                    if cnts[c] == 0:
                        a = area(c)
                        if a > best_a:
                            best, best_a = k, a
                if best < 0:
                    break
                c = children.pop(best)
                children.extend([c + 1, int(offs[c])])
        for k, c in enumerate(children):
            wide_lo[w][k] = node_lo[c]
            wide_hi[w][k] = node_hi[c]
            if cnts[c] > 0:
                wide_meta[w][k] = -(1 + int(offs[c]) * 8 + (int(cnts[c]) - 1))
            else:
                cw = alloc_wide()
                wide_meta[w][k] = cw
                stack.append((c, cw))
    return (np.stack(wide_lo), np.stack(wide_hi),
            np.stack(wide_meta).astype(np.int64))


def pack_wide(wide_lo: np.ndarray, wide_hi: np.ndarray, wide_meta: np.ndarray):
    """-> (bounds_tab (Wb*8, 128) f32, meta_tab (Wb*8, 128) i32), the TPU
    kernel's tables: tile t holds 16 wide nodes; sublane r = child r; bounds
    lanes = node_in_tile*8 + field (lox loy loz hix hiy hiz, 2 pad); meta
    lane = node_in_tile."""
    W = len(wide_lo)
    nb = -(-W // NODES_PER_TILE)
    bt = np.zeros((nb, WIDTH, LANES), np.float32)
    mt = np.zeros((nb, WIDTH, LANES), np.int32)
    idx = np.arange(W)
    blk, slot = idx // NODES_PER_TILE, idx % NODES_PER_TILE
    for f in range(3):
        bt[blk, :, slot * 8 + f] = wide_lo[:, :, f]
        bt[blk, :, slot * 8 + 3 + f] = wide_hi[:, :, f]
    mt[blk, :, slot] = wide_meta.astype(np.int32)
    return bt.reshape(nb * WIDTH, LANES), mt.reshape(nb * WIDTH, LANES)


def pack_bvh8_cuda(wide_lo: np.ndarray, wide_hi: np.ndarray,
                   wide_meta: np.ndarray) -> np.ndarray:
    """-> (W, 8, 8) f32 node records of the CUDA kernel (module docstring).
    Raises when the tree could overflow the kernel's per-ray stack: a node
    step keeps the nearest hit child in a register and pushes at most the
    other 7, so a walk holds at most 7*depth entries. The TPU packer
    (pallas_bvh8.PackedSceneW) has no such check."""
    depth = wide_depth(wide_meta)
    if 7 * depth > STACK_DEPTH:
        raise ValueError(f"BVH8 depth {depth} overflows the kernel's "
                         f"{STACK_DEPTH}-entry stack")
    meta = np.asarray(wide_meta, np.int64)
    u = -meta - 1
    off, cnt = u >> 3, (u & 7) + 1
    leaf = meta < 0
    if leaf.any() and (off[leaf].max() + 1) * 16 >= 2 ** 31:
        raise ValueError("a leaf's triangle offset does not fit its int32 entry")
    W = len(wide_lo)
    out = np.zeros((W, WIDTH, 8), np.float32)
    out[..., 0:3] = wide_lo
    out[..., 3:6] = wide_hi
    out[..., 6] = np.where(leaf, -(1 + off * 16 + cnt - 1), meta).astype(np.int32).view(np.float32)
    return out
