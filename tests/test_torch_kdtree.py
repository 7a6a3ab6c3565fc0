"""The port's kd-tree aggregate (nn_bvh_tpu_torch/accel/kdtree.py) against
the JAX package's (nn_bvh_tpu/accel/kdtree.py) on the CPU.

The scenes are tests/test_accel.py:142's random triangles (n = 300, seeded
numpy). Tolerances:
- the build: node_data, prim_idx, bounds, n_nodes and max_leaf equal bit
  for bit;
- the walk: the same prim ids as JAX's intersect_closest / intersect_any
  on every ray, t within rtol 2e-4 (tests/test_accel.py:165; JAX tests
  leaves with the watertight test, the port with Moller-Trumbore);
- brute force (traverse.intersect_brute): the same prim and t on every
  ray where no clamped leaf is in the way (seed 5's rays meet none);
- the mirrored scan clamp (ROADMAP queue 3): a ray aimed at a prim that
  only the clamped leaf holds misses it in both packages alike.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.accel import kdtree as j_kdtree, build as j_build
from nn_bvh_tpu_torch.accel import build, kdtree, traverse

torch.set_num_threads(1)


def random_tris(seed: int, n: int = 300):
    """tests/test_accel.py:142's triangles (float64 as there)."""
    rs = np.random.RandomState(seed)
    v0 = rs.rand(n, 3).astype(np.float32) * 6
    return np.stack([v0, v0 + rs.rand(n, 3) * 0.7, v0 + rs.rand(n, 3) * 0.7], 1), rs


def random_rays(rs, R: int = 256):
    o = (rs.rand(R, 3) * 6).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def both(kt, jkt, tri, o, d, tm):
    """(port closest, JAX closest, port any, JAX any) on the same rays."""
    tp, jtp = torch.as_tensor(tri, dtype=torch.float32), jnp.asarray(tri, jnp.float32)
    args = [torch.as_tensor(x) for x in (o, d, tm)]
    jargs = [jnp.asarray(x) for x in (o, d, tm)]
    return (kdtree.intersect_closest(kt, tp, *args), j_kdtree.intersect_closest(jkt, jtp, *jargs),
            kdtree.intersect_any(kt, tp, *args), j_kdtree.intersect_any(jkt, jtp, *jargs))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5])
def test_build_is_bit_identical(seed):
    tri, _ = random_tris(seed)
    lo, hi = build.triangle_bounds(tri)
    jlo, jhi = j_build.triangle_bounds(tri)
    np.testing.assert_array_equal(lo, jlo)
    kt, jkt = kdtree.build_kdtree(lo, hi), j_kdtree.build_kdtree(jlo, jhi)
    for f in ("node_data", "prim_idx", "bounds"):
        a, b = getattr(kt, f), getattr(jkt, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (kt.n_nodes, kt.max_leaf) == (jkt.n_nodes, jkt.max_leaf)
    # one clamped leaf but for seed 3
    assert len(kdtree.clamped_leaves(kt)) == (0 if seed == 3 else 1)


def test_walk_matches_jax_and_brute_force(monkeypatch):
    tri, rs = random_tris(5)
    kt = kdtree.build_kdtree(*build.triangle_bounds(tri))
    jkt = j_kdtree.build_kdtree(*j_build.triangle_bounds(tri))
    o, d = random_rays(rs)
    R = len(o)
    for tmax in (1e30, 1.5):
        tm = np.full((R,), tmax, np.float32)
        hc, jhc, ha, jha = both(kt, jkt, tri, o, d, tm)
        np.testing.assert_array_equal(hc.prim.numpy(), np.asarray(jhc.prim))
        np.testing.assert_allclose(hc.t.numpy(), np.asarray(jhc.t), rtol=2e-4)
        np.testing.assert_array_equal(ha.numpy(), np.asarray(jha))
        hb = traverse.intersect_brute(torch.as_tensor(tri, dtype=torch.float32),
                                      torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tm))
        assert torch.equal(hc.prim, hb.prim) and torch.equal(hc.t, hb.t)
        assert torch.equal(ha, hb.prim >= 0)
        assert 0 < int((hc.prim >= 0).sum()) < R
    # CHECK_EVERY changes when finished lanes leave, not what they hold
    tp = torch.as_tensor(tri, dtype=torch.float32)
    tm = torch.full((R,), 1e30)
    st1, st3 = {}, {}
    monkeypatch.setattr(kdtree, "CHECK_EVERY", 1)
    a = kdtree.intersect_closest(kt, tp, torch.as_tensor(o), torch.as_tensor(d), tm, st1)
    monkeypatch.setattr(kdtree, "CHECK_EVERY", 3)
    b = kdtree.intersect_closest(kt, tp, torch.as_tensor(o), torch.as_tensor(d), tm, st3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert st1["lane_steps"] <= st3["lane_steps"] and st1["steps"] <= st3["steps"]


def test_dead_lanes_and_stack():
    tri, rs = random_tris(5)
    kt = kdtree.build_kdtree(*build.triangle_bounds(tri))
    o, d = random_rays(rs, 8)
    tp = torch.as_tensor(tri, dtype=torch.float32)
    tm = torch.full((8,), -1.0)
    assert not kdtree.intersect_any(kt, tp, torch.as_tensor(o), torch.as_tensor(d), tm).any()
    h = kdtree.intersect_closest(kt, tp, torch.as_tensor(o), torch.as_tensor(d), tm)
    assert (h.prim == -1).all() and torch.isinf(h.t).all()
    # nested splits deeper than the stack, nearer and nearer: each pushes its far side
    depth = kdtree.STACK + 2
    nodes = [[float(depth - i), 0.0, float(2 * depth - i), 0.0] for i in range(depth)]
    nodes += [[0.0, 3.0, 0.0, 0.0] for _ in range(depth + 1)]
    deep = kdtree.KdTree(np.asarray(nodes, np.float32), np.zeros(8, np.int32),
                         np.asarray([[0, -1, -1], [depth + 2, 1, 1]], np.float32),
                         len(nodes), 1)
    ray = lambda: (torch.tensor([[-0.5, 0.0, 0.0]]), torch.tensor([[1.0, 0.0, 0.0]]),
                   torch.tensor([1e30]))
    with pytest.raises(kdtree.StackOverflow):
        kdtree.intersect_closest(deep, tp, *ray())


def test_clamped_leaf_scan_is_mirrored():
    """ROADMAP queue 3: JAX's dynamic_slice clamps the scan of a leaf whose
    first + scan passes the end of prim_idx, so such a leaf tests another
    leaf's prims. Rays aimed at the prims only that leaf holds: brute force
    hits them, and both packages give the same wrong answer on at least one."""
    tri, rs = random_tris(0)
    kt = kdtree.build_kdtree(*build.triangle_bounds(tri))
    jkt = j_kdtree.build_kdtree(*j_build.triangle_bounds(tri))
    (leaf,) = kdtree.clamped_leaves(kt)
    first, count = int(kt.node_data[leaf, 2]), int(kt.node_data[leaf, 3])
    M, scan = len(kt.prim_idx), kdtree.scan_width(kt)
    own = kt.prim_idx[first:first + count]
    tested = kt.prim_idx[M - scan:M - scan + count]
    others = np.concatenate([kt.prim_idx[:first], kt.prim_idx[first + count:]])
    lonely = [p for p in own if p not in tested and p not in others]
    assert lonely, (own, tested)
    # from 2 units off each lonely prim's centroid, along its normal, to it
    c = tri[lonely].mean(1).astype(np.float32)
    nrm = np.cross(tri[lonely, 1] - tri[lonely, 0], tri[lonely, 2] - tri[lonely, 0])
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    o = np.concatenate([c + 2 * nrm, c - 2 * nrm]).astype(np.float32)
    d = np.concatenate([-nrm, nrm]).astype(np.float32)
    tm = np.full((len(o),), 1e30, np.float32)
    hc, jhc, ha, jha = both(kt, jkt, tri, o, d, tm)
    np.testing.assert_array_equal(hc.prim.numpy(), np.asarray(jhc.prim))
    np.testing.assert_allclose(hc.t.numpy(), np.asarray(jhc.t), rtol=2e-4)
    np.testing.assert_array_equal(ha.numpy(), np.asarray(jha))
    hb = traverse.intersect_brute(torch.as_tensor(tri, dtype=torch.float32),
                                  torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tm))
    wrong = (hb.prim != hc.prim).numpy()
    assert wrong.any(), "no ray shows the clamped scan"
    assert np.isin(hb.prim.numpy()[wrong], lonely).all()
