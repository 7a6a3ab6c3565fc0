"""BVH4 wide nodes: host-side collapse + packing (numpy port of
nn_bvh_tpu/accel/bvh4.py:43-152, plus the CUDA kernel's own node layout).

`collapse_bvh4`, `wide_depth` and `pack_bvh4` are copies of the JAX package's
functions (the packed TPU table is bit-identical). `pack_bvh4_cuda` lays the
same wide nodes out for `csrc/bvh4_traverse.cu`: one 128-byte record per wide
node, 4 children x [lo.xyz, hi.xyz, meta (i32 bits), pad] float32, (W, 4, 8).
Its bounds are the TPU table's bf16 bounds (lo rounded down, hi rounded up)
decoded to float32, so the kernel tests the same conservative boxes and
returns the same hits.

Child meta: >= 0 -> wide-node index; < 0 -> leaf
-(1 + tri_offset*16 + (count-1)). Empty children: lo = hi = 3e38, meta 0.
"""

from __future__ import annotations

import numpy as np

LANES = 128
WIDTH = 4
NODES_PER_BLOCK = 64
STACK_DEPTH = 64   # per-ray stack entries of the CUDA kernel
MAX_LEAF = 8       # triangles the kernel tests per leaf


def _bf16_down(x: np.ndarray) -> np.ndarray:
    """Largest bf16 <= x, as u32 bits (low 16 bits zero)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    tail = (u & np.uint32(0xFFFF)) != 0
    t = u & np.uint32(0xFFFF0000)
    adj = (tail & (np.asarray(x) < 0)).astype(np.uint32) << 16
    return t + adj


def _bf16_up(x: np.ndarray) -> np.ndarray:
    """Smallest bf16 >= x, as u32 bits (low 16 bits zero)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    tail = (u & np.uint32(0xFFFF)) != 0
    t = u & np.uint32(0xFFFF0000)
    adj = (tail & (np.asarray(x) >= 0)).astype(np.uint32) << 16
    return t + adj


def collapse_bvh4(node_lo: np.ndarray, node_hi: np.ndarray,
                  node_meta: np.ndarray):
    """Binary flat BVH (interior -> children (self+1, offset)) ->
    (wide_lo (W,4,3), wide_hi (W,4,3), wide_meta (W,4) i64). Greedy: each
    wide node starts from a binary node's two children and expands the
    largest-area interior child until it holds 4 subtree roots."""
    node_lo = np.asarray(node_lo, np.float32)
    node_hi = np.asarray(node_hi, np.float32)
    meta = np.asarray(node_meta)
    offs, cnts = meta[:, 0].astype(np.int64), meta[:, 1].astype(np.int64)
    ext = node_hi - node_lo
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    n_bin = len(node_lo)
    cap = max(4, n_bin)
    wide_lo = np.full((cap, WIDTH, 3), 3e38, np.float32)
    wide_hi = np.full((cap, WIDTH, 3), 3e38, np.float32)
    wide_meta = np.zeros((cap, WIDTH), np.int64)
    n_wide = 1

    def leaf_entry(c):
        if not 1 <= cnts[c] <= 16:
            raise ValueError(f"leaf of {cnts[c]} triangles cannot be encoded")
        return -(1 + offs[c] * 16 + (cnts[c] - 1))

    stack = [(0, 0)]
    while stack:
        b, w = stack.pop()
        if cnts[b] > 0:
            children = [b]
        else:
            children = [b + 1, int(offs[b])]
            while len(children) < WIDTH:
                best, best_a = -1, -1.0
                for k, c in enumerate(children):
                    if cnts[c] == 0 and area[c] > best_a:
                        best, best_a = k, float(area[c])
                if best < 0:
                    break
                c = children.pop(best)
                children.extend([c + 1, int(offs[c])])
        for k, c in enumerate(children):
            wide_lo[w, k] = node_lo[c]
            wide_hi[w, k] = node_hi[c]
            if cnts[c] > 0:
                wide_meta[w, k] = leaf_entry(c)
            else:
                cw = n_wide
                n_wide += 1
                wide_meta[w, k] = cw
                stack.append((c, cw))
    return wide_lo[:n_wide], wide_hi[:n_wide], wide_meta[:n_wide]


def wide_depth(wide_meta: np.ndarray) -> int:
    """Depth of the wide tree (children have larger indices than parents)."""
    W = len(wide_meta)
    depth = np.zeros(W, np.int32)
    for w in range(W):
        for k in range(WIDTH):
            m = wide_meta[w, k]
            if m > 0 and depth[m] < depth[w] + 1:
                depth[m] = depth[w] + 1
    return int(depth.max()) + 1 if W else 1


def pack_bvh4(wide_lo: np.ndarray, wide_hi: np.ndarray,
              wide_meta: np.ndarray) -> np.ndarray:
    """-> (nb*8, 128) f32 TPU table (64 nodes per (8,128) block, bf16-pair
    bounds), bit-identical to the JAX package's."""
    W = len(wide_lo)
    nb = -(-W // NODES_PER_BLOCK)
    tab = np.zeros((nb, 8, LANES), np.float32)
    n = np.arange(W)
    blk = n // NODES_PER_BLOCK
    lane = (n % NODES_PER_BLOCK) * 2
    for c in range(WIDTH):
        rows = 4 * (c // 2)
        col = lane + (c % 2)
        for ax in range(3):
            lo_b = _bf16_down(wide_lo[:, c, ax])
            hi_b = _bf16_up(wide_hi[:, c, ax])
            packed = lo_b | (hi_b >> np.uint32(16))
            tab[blk, rows + ax, col] = packed.view(np.float32)
        tab[blk, rows + 3, col] = wide_meta[:, c].astype(np.int32).view(np.float32)
    return tab.reshape(nb * 8, LANES)


def pack_bvh4_cuda(wide_lo: np.ndarray, wide_hi: np.ndarray,
                   wide_meta: np.ndarray) -> np.ndarray:
    """-> (W, 4, 8) f32 node records of the CUDA kernel. Raises when the
    tree would overflow the kernel's per-ray stack or holds a leaf of more
    than MAX_LEAF triangles (the kernel would skip the rest)."""
    depth = wide_depth(wide_meta)
    if 3 * depth + 4 >= STACK_DEPTH:
        raise ValueError(f"BVH4 depth {depth} overflows the kernel's "
                         f"{STACK_DEPTH}-entry stack")
    meta = np.asarray(wide_meta, np.int64)
    leaf = meta < 0
    counts = (-meta[leaf] - 1) % 16 + 1
    if counts.size and counts.max() > MAX_LEAF:
        raise ValueError(f"a leaf holds {int(counts.max())} triangles; the "
                         f"kernel tests at most {MAX_LEAF}")
    W = len(wide_lo)
    out = np.zeros((W, WIDTH, 8), np.float32)
    out[..., 0:3] = _bf16_down(wide_lo.reshape(-1)).view(np.float32).reshape(W, WIDTH, 3)
    out[..., 3:6] = _bf16_up(wide_hi.reshape(-1)).view(np.float32).reshape(W, WIDTH, 3)
    out[..., 6] = meta.astype(np.int32).view(np.float32)
    return out
