"""Loop subdivision surfaces (host-side, vectorized numpy).

Counterpart of the reference's `util/loopsubdiv.cpp` (Shape "loopsubdiv"):
standard Loop scheme — interior edge vertices 3/8·(v0+v1) + 1/8·(o0+o1),
boundary edges 1/2·(v0+v1); even vertices by Loop's beta valence weights,
boundary evens by the 1/8,3/4,1/8 rule. Limit-surface projection and tangent
computation are omitted (the reference applies limit positions; the
difference after >=2 levels is visually minor — noted for parity tracking).

A copy of nn_bvh_tpu/geometry/loopsubdiv.py, unchanged: the port keeps its
own, since importing anything of that package loads JAX.
"""

from __future__ import annotations

import numpy as np


def _beta(n: np.ndarray) -> np.ndarray:
    # Loop's valence weight (loopsubdiv.cpp beta())
    return np.where(
        n == 3, 3.0 / 16.0, 3.0 / (8.0 * np.maximum(n, 1))
    )


def subdivide(vertices: np.ndarray, faces: np.ndarray, levels: int = 1):
    """-> (vertices, faces) after `levels` rounds of Loop subdivision."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    for _ in range(max(levels, 0)):
        v, f = _subdivide_once(v, f)
    return v.astype(np.float32), f


def _subdivide_once(v: np.ndarray, f: np.ndarray):
    nv = len(v)
    # edges: (a,b) sorted, with the two opposite vertices
    e0 = f[:, [0, 1]]
    e1 = f[:, [1, 2]]
    e2 = f[:, [2, 0]]
    opp = np.concatenate([f[:, 2], f[:, 0], f[:, 1]])
    edges = np.concatenate([e0, e1, e2])
    ekey = np.ascontiguousarray(np.sort(edges, axis=1))
    packed = ekey[:, 0] * np.int64(len(v) + 1) + ekey[:, 1]
    uniq, first_idx, inv, counts = np.unique(
        packed, return_index=True, return_inverse=True, return_counts=True
    )
    n_edges = len(uniq)
    ua = ekey[first_idx, 0]
    ub = ekey[first_idx, 1]

    # opposite-vertex accumulation per unique edge
    opp_sum = np.zeros(n_edges)
    opp_sum3 = np.zeros((n_edges, 3))
    np.add.at(opp_sum3, inv, v[opp])
    boundary = counts == 1

    # odd (edge) vertices
    edge_pts = np.where(
        boundary[:, None],
        0.5 * (v[ua] + v[ub]),
        0.375 * (v[ua] + v[ub]) + 0.125 * opp_sum3,
    )

    # even (original) vertices: one-ring sums
    ring_sum = np.zeros((nv, 3))
    valence = np.zeros(nv)
    # each unique edge contributes each endpoint to the other's ring once
    np.add.at(ring_sum, ua, v[ub])
    np.add.at(ring_sum, ub, v[ua])
    np.add.at(valence, ua, 1)
    np.add.at(valence, ub, 1)
    # boundary ring (only boundary neighbors)
    bring = np.zeros((nv, 3))
    bval = np.zeros(nv)
    np.add.at(bring, ua[boundary], v[ub[boundary]])
    np.add.at(bring, ub[boundary], v[ua[boundary]])
    np.add.at(bval, ua[boundary], 1)
    np.add.at(bval, ub[boundary], 1)
    is_boundary_v = bval > 0

    beta = _beta(valence)
    even_interior = v * (1.0 - valence * beta)[:, None] + ring_sum * beta[:, None]
    even_boundary = 0.75 * v + 0.125 * bring  # (1/8, 3/4, 1/8)
    new_even = np.where(is_boundary_v[:, None], even_boundary, even_interior)

    new_v = np.concatenate([new_even, edge_pts])
    # faces: each old face -> 4
    nf = len(f)
    me = inv.reshape(3, nf).T + nv  # midpoint ids per face edge [01, 12, 20]
    a, b, c = f[:, 0], f[:, 1], f[:, 2]
    m01, m12, m20 = me[:, 0], me[:, 1], me[:, 2]
    new_f = np.concatenate(
        [
            np.stack([a, m01, m20], 1),
            np.stack([m01, b, m12], 1),
            np.stack([m20, m12, c], 1),
            np.stack([m01, m12, m20], 1),
        ]
    )
    return new_v, new_f
