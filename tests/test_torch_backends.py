"""Parity of the port's binary, deep-stack binary and BVH8 traversal
backends against the JAX package on the CPU (the kernels themselves need a
card: tests/test_torch_cuda.py and chip_smoke.py hold them against these
plain versions).

Scene and rays are tests/test_torch_accel.py's. The JAX side runs as its own
tests run it: the XLA anchor (`traverse.intersect_*`) and the Pallas kernels
`pallas_traverse._traverse_packed`, `hbm_traverse._traverse_hbm` and
`pallas_bvh8._traverse_bvh8` in interpret mode.

Tolerance (tests/test_torch_accel.py:87-101): prim equal on every live lane
except a tie, where both found a hit, with t within 1e-6, on two triangles
that share an edge: the TPU kernels order children by packet, the port per
ray, so a tie may go the other way; at most 3 ties. t within atol 1e-4 +
rtol 1e-5; occlusion equal on live lanes; dead lanes miss (closest) or
report occluded (any-hit). The packers match the JAX packers byte for byte
(binary) or array for array (BVH8), and the CUDA layouts decode back to the
same bounds and meta.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.accel import (traverse as j_traverse, pallas_traverse as j_ptrav,
                              hbm_traverse as j_hbm, pallas_bvh8 as j_pbvh8,
                              bvh8 as j_bvh8)
from nn_bvh_tpu.geometry import scene as j_scene
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.accel import (binary, binary_kernel, build, bvh4, bvh8, bvh8_kernel,
                                    dispatch, kernel_launch, traverse)
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.tools import bench_scene, trav_prof

torch.set_num_threads(1)

PLAIN = ("plain_binary", "plain_binary_deep", "plain_bvh8")
MAX_TIES = 3


@pytest.fixture(scope="module")
def small_scene():
    """tests/test_pallas_interpret.py's scene, built by the JAX package."""
    rs = np.random.RandomState(3)
    b = j_scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    for i in range(6):
        c = (rs.rand(3) - 0.5) * 4 + np.array([0, 1.0, 0])
        b.add_sphere(c, 0.3 + 0.3 * rs.rand(), m, n_theta=10, n_phi=20)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    return sc, dbvh


@pytest.fixture(scope="module")
def ray_batch():
    rs = np.random.RandomState(11)
    R = 2048
    o = (rs.rand(R, 3).astype(np.float32) - 0.5) * 6
    o[:, 1] += 1.5
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((R,), 1e30, np.float32)
    t_max[::5] = -1.0  # dead lanes
    return o, d, t_max


@pytest.fixture(scope="module")
def port_scene(small_scene):
    sc, dbvh = small_scene
    return scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")


@pytest.fixture(scope="module")
def port_hits(port_scene, ray_batch):
    """backend -> (closest Hit, any-hit occlusion numpy) of the plain backends."""
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    out = {}
    for backend in PLAIN:
        isect = dispatch.make_intersectors(*port_scene, "cpu", backend=backend)
        out[backend] = isect.closest(o, d, t_max), isect.any_hit(o, d, t_max).numpy()
    return out


@pytest.fixture(scope="module")
def host_tables(small_scene):
    sc, dbvh = small_scene
    n = dbvh.n_nodes
    lo, hi, meta = (np.asarray(x)[:n] for x in (dbvh.node_lo, dbvh.node_hi, dbvh.node_meta))
    return lo, hi, meta, np.asarray(sc.tri_p)


def _shares_edge(tri_p, a, b):
    va, vb = tri_p[a].reshape(3, 3), tri_p[b].reshape(3, 3)
    return sum(bool((np.abs(vb - v).max(1) <= 1e-6).any()) for v in va) >= 2


def _check_closest(prim_ref, t_ref, hit, t_max, tri_p):
    live = t_max > 0
    prim, t = hit.prim.numpy(), hit.t.numpy()
    prim_ref, t_ref = np.asarray(prim_ref), np.asarray(t_ref)
    assert hit.prim.dtype == torch.int32 and hit.t.dtype == torch.float32
    differ = np.nonzero(live & (prim != prim_ref))[0]
    for r in differ:  # ties only
        assert prim[r] >= 0 and prim_ref[r] >= 0, r
        assert abs(float(t[r]) - float(t_ref[r])) <= 1e-6, r
        assert _shares_edge(tri_p, prim[r], prim_ref[r]), r
    assert len(differ) <= MAX_TIES, len(differ)
    assert (prim[~live] == -1).all() and np.isinf(t[~live]).all()
    tn, tr = np.nan_to_num(t, posinf=0.0), np.nan_to_num(t_ref, posinf=0.0)
    np.testing.assert_allclose(tn[live], tr[live], atol=1e-4, rtol=1e-5)


def _check_any(occ, occ_ref, t_max):
    live = t_max > 0
    assert (occ[live] == np.asarray(occ_ref)[live]).all()
    assert occ[t_max < 0].all()


def _jax_rays(ray_batch):
    return tuple(map(jnp.asarray, ray_batch))


def _tpu_tables(host_tables, backend):
    """The JAX package's packed tables for the TPU kernel of `backend`."""
    lo, hi, meta, tri_p = host_tables
    tri_tab = j_ptrav.pack_tris(tri_p)
    if backend == "plain_bvh8":
        bt, mt = j_bvh8.pack_wide(*j_bvh8.collapse_bvh8(lo, hi, meta))
        return jnp.asarray(bt), jnp.asarray(mt), jnp.asarray(tri_tab)
    node_tab = j_ptrav.pack_nodes(lo, hi, meta)
    if backend == "plain_binary_deep":
        return (jnp.asarray(node_tab.reshape(-1, 8, 128)),
                jnp.asarray(tri_tab.reshape(-1, 9, 128)))
    return jnp.asarray(node_tab), jnp.asarray(tri_tab)


_TPU_KERNELS = {"plain_binary": j_ptrav._traverse_packed,
                "plain_binary_deep": j_hbm._traverse_hbm,
                "plain_bvh8": j_pbvh8._traverse_bvh8}


@pytest.fixture(scope="module")
def xla_anchor(small_scene, ray_batch):
    sc, dbvh = small_scene
    args = (jax.tree.map(jnp.asarray, dbvh), jnp.asarray(sc.tri_p), *_jax_rays(ray_batch))
    return j_traverse.intersect_closest(*args), j_traverse.intersect_any(*args)


@pytest.mark.parametrize("backend", PLAIN)
def test_plain_closest_matches_xla_anchor(backend, xla_anchor, port_hits, ray_batch,
                                          host_tables):
    h = xla_anchor[0]
    _check_closest(h.prim, h.t, port_hits[backend][0], ray_batch[2], host_tables[3])


@pytest.mark.parametrize("backend", PLAIN)
def test_plain_any_matches_xla_anchor(backend, xla_anchor, port_hits, ray_batch):
    _check_any(port_hits[backend][1], xla_anchor[1], ray_batch[2])


@pytest.mark.parametrize("backend", PLAIN)
def test_plain_closest_matches_pallas_interpret(backend, host_tables, port_hits, ray_batch):
    h = _TPU_KERNELS[backend](*_tpu_tables(host_tables, backend), *_jax_rays(ray_batch),
                              any_hit=False, interpret=True)
    _check_closest(h.prim, h.t, port_hits[backend][0], ray_batch[2], host_tables[3])


@pytest.mark.parametrize("backend", PLAIN)
def test_plain_any_matches_pallas_interpret(backend, host_tables, port_hits, ray_batch):
    h = _TPU_KERNELS[backend](*_tpu_tables(host_tables, backend), *_jax_rays(ray_batch),
                              any_hit=True, interpret=True)
    _check_any(port_hits[backend][1], np.asarray(h.prim) >= 0, ray_batch[2])


@pytest.mark.parametrize("backend", PLAIN)
def test_plain_backends_match_brute_force(backend, small_scene, port_hits, ray_batch):
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    hb = traverse.intersect_brute(torch.as_tensor(np.asarray(small_scene[0].tri_p)),
                                  o, d, t_max, chunk=512)
    h = port_hits[backend][0]
    assert torch.equal(hb.prim, h.prim) and torch.equal(hb.t, h.t)


@pytest.mark.parametrize("backend", PLAIN + ("plain",))
def test_sorted_intersector_matches_unsorted(backend, port_scene, port_hits, ray_batch):
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    s = dispatch.make_intersectors(*port_scene, "cpu", backend=backend, sort=True)
    u = dispatch.make_intersectors(*port_scene, "cpu", backend=backend)
    for a, b in zip(s.closest(o, d, t_max), u.closest(o, d, t_max)):
        assert torch.equal(a, b)
    assert torch.equal(s.any_hit(o, d, t_max), u.any_hit(o, d, t_max))
    assert s.n_calls == 2


@pytest.mark.parametrize("backend", PLAIN + ("plain",))
def test_plain_counts_the_work(backend, port_scene, ray_batch):
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    isect = dispatch.make_intersectors(*port_scene, "cpu", backend=backend)
    counts = {}
    hit = isect.fn(*isect.tables, o, d, t_max, False, counts=counts)
    assert torch.equal(hit.prim, isect.closest(o, d, t_max).prim)  # counting changes nothing
    live = t_max > 0
    slab, tri = counts["slab"], counts["tri"]
    assert (slab[~live] == 0).all() and (tri[~live] == 0).all()
    assert (slab[live] > 0).all()
    assert (tri[hit.prim >= 0] > 0).all()
    width = bench_scene.record_width(isect.tables[0])  # boxes a record holds
    assert width > 1 and (slab % width == 0).all()
    occ_counts = {}
    isect.fn(*isect.tables, o, d, t_max, True, counts=occ_counts)
    assert (occ_counts["tri"] <= tri).all() and (occ_counts["slab"] <= slab).all()


def test_binary_and_deep_walk_alike(port_scene, ray_batch):
    """The two stack depths run one traversal: same hits, same work."""
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    nodes = dispatch.make_intersectors(*port_scene, "cpu", backend="plain_binary").tables[0]
    tris = torch.as_tensor(np.asarray(port_scene[0].tri_p))
    c64, c128 = {}, {}
    h64 = traverse.traverse_binary_plain(nodes, tris, o, d, t_max, False, 64, counts=c64)
    h128 = traverse.traverse_binary_plain(nodes, tris, o, d, t_max, False, 128, counts=c128)
    assert all(torch.equal(a, b) for a, b in zip(h64, h128))
    assert torch.equal(c64["slab"], c128["slab"]) and torch.equal(c64["tri"], c128["tri"])


def test_wrappers_run_plain_for_cpu_tensors(port_scene, port_hits, ray_batch):
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    before = dict(kernel_launch.n_launches)
    for backend, stack in (("plain_binary", 64), ("plain_binary_deep", 128)):
        tables = dispatch.make_intersectors(*port_scene, "cpu", backend=backend).tables
        h = binary_kernel.traverse(*tables, o, d, t_max, False, stack=stack)
        assert torch.equal(h.prim, port_hits[backend][0].prim)
    tables = dispatch.make_intersectors(*port_scene, "cpu", backend="plain_bvh8").tables
    h = bvh8_kernel.traverse(*tables, o, d, t_max, False)
    assert torch.equal(h.prim, port_hits["plain_bvh8"][0].prim)
    assert dict(kernel_launch.n_launches) == before  # no kernel launch on the CPU
    with pytest.raises(ValueError, match="stack"):
        binary_kernel.traverse(*tables, o, d, t_max, False, stack=96)


def test_binary_packers_byte_identical(host_tables):
    lo, hi, meta, tri_p = host_tables
    np.testing.assert_array_equal(binary.pack_nodes(lo, hi, meta).view(np.uint32),
                                  j_ptrav.pack_nodes(lo, hi, meta).view(np.uint32))
    np.testing.assert_array_equal(binary.pack_tris(tri_p).view(np.uint32),
                                  j_ptrav.pack_tris(tri_p).view(np.uint32))
    assert binary.tree_depth(meta) == j_ptrav.tree_depth(meta)


def _decode_pairs(rec):
    """Pair records -> {record: [(lo, hi, entry) of child 0, of child 1]}
    and the header's (lo, hi, start entry)."""
    ent = rec[:, 12:14].view(np.int32)
    kids = {r: [(rec[r, 6 * c:6 * c + 3], rec[r, 6 * c + 3:6 * c + 6], int(ent[r, c]))
                for c in range(2)] for r in range(1, len(rec))}
    return kids, (rec[0, 0:3], rec[0, 3:6], int(ent[0, 0]))


def test_binary_pairs_layout_decodes(host_tables):
    """Walking the pair records from the header's entry meets every node of
    the flat BVH once, with its box, as a record (interior) or a leaf entry
    (offset, count); records 1.. hold the interior nodes in the flat tree's
    (depth-first) order."""
    lo, hi, meta, _ = host_tables
    rec = binary.pack_binary_pairs(lo, hi, meta)
    n_inner = int((meta[:, 1] == 0).sum())
    assert rec.shape == (1 + n_inner, 16) and rec.dtype == np.float32
    kids, (rlo, rhi, start) = _decode_pairs(rec)
    np.testing.assert_array_equal(rlo, lo[0])
    np.testing.assert_array_equal(rhi, hi[0])
    assert (rec[0, 6:12] == np.float32(binary.EMPTY)).all()
    assert rec[0, 13:14].view(np.int32)[0] == binary.NO_ENTRY
    assert (rec[:, 14:16] == 0).all()
    seen, record_of = [], {}
    todo = [(0, start)]  # (flat node, entry)
    while todo:
        node, entry = todo.pop()
        seen.append(node)
        if meta[node, 1] > 0:
            u = -entry - 1
            assert entry < 0 and (u >> 4, (u & 15) + 1) == tuple(meta[node, :2])
            continue
        assert entry >= 1
        record_of[node] = entry
        for (clo, chi, cent), child in zip(kids[entry], (node + 1, meta[node, 0])):
            np.testing.assert_array_equal(clo, lo[child])
            np.testing.assert_array_equal(chi, hi[child])
            todo.append((child, cent))
    assert sorted(seen) == list(range(len(meta)))
    assert [record_of[n] for n in sorted(record_of)] == list(range(1, 1 + n_inner))


def test_binary_cuda_layout_decodes(host_tables):
    lo, hi, meta, _ = host_tables
    rec = binary.pack_binary_cuda(lo, hi, meta)
    assert rec.shape == (len(lo), 8) and rec.dtype == np.float32
    np.testing.assert_array_equal(rec[:, 0:3], lo)
    np.testing.assert_array_equal(rec[:, 3:6], hi)
    np.testing.assert_array_equal(rec[:, 6].view(np.int32), meta[:, 0])
    np.testing.assert_array_equal(rec[:, 7].view(np.int32) & 31, meta[:, 1])
    np.testing.assert_array_equal(rec[:, 7].view(np.int32) >> 5, meta[:, 2])
    # the TPU table holds the same values, as f32
    tab = binary.pack_nodes(lo, hi, meta).reshape(-1, 8, 128)
    n = np.arange(len(lo))
    np.testing.assert_array_equal(tab[n // 128, 6, n % 128], rec[:, 6].view(np.int32))
    np.testing.assert_array_equal(tab[n // 128, 7, n % 128], rec[:, 7].view(np.int32))


def test_binary_packer_raises():
    tri = np.random.RandomState(0).rand(9, 3, 3).astype(np.float32)
    lo, hi = build.triangle_bounds(tri)
    b = build.build_sah(lo, hi, max_leaf=9)  # one leaf of 9 triangles
    with pytest.raises(ValueError, match="at most 8"):
        binary.pack_binary_cuda(b.node_lo, b.node_hi, b.node_meta)
    for levels, stack, ok in ((61, 64, True), (62, 64, True), (63, 64, False),
                              (100, 64, False), (100, 128, True), (126, 128, True),
                              (127, 128, False)):
        _, db = bench_scene.build_deep_tree(levels)
        if ok:
            binary.pack_binary_cuda(db.node_lo, db.node_hi, db.node_meta, stack)
        else:
            with pytest.raises(ValueError, match="stack"):
                binary.pack_binary_cuda(db.node_lo, db.node_hi, db.node_meta, stack)


def test_binary_pairs_packer_raises():
    """The pair packer keeps pack_binary_cuda's checks: leaves of at most 8
    triangles, depth < stack - 1."""
    tri = np.random.RandomState(0).rand(9, 3, 3).astype(np.float32)
    lo, hi = build.triangle_bounds(tri)
    b = build.build_sah(lo, hi, max_leaf=9)
    with pytest.raises(ValueError, match="at most 8"):
        binary.pack_binary_pairs(b.node_lo, b.node_hi, b.node_meta)
    for levels, stack, ok in ((62, 64, True), (63, 64, False), (126, 128, True),
                              (127, 128, False)):
        _, db = bench_scene.build_deep_tree(levels)
        if ok:
            binary.pack_binary_pairs(db.node_lo, db.node_hi, db.node_meta, stack)
        else:
            with pytest.raises(ValueError, match="stack"):
                binary.pack_binary_pairs(db.node_lo, db.node_hi, db.node_meta, stack)


@pytest.mark.parametrize("n_tris", [1, 2, 5, 40])
def test_plain_binary_small_trees_match_brute(n_tris):
    """Trees of one leaf (the header's entry is that leaf), two triangles
    and a few leaves through plain_binary, closest and any-hit, against
    intersect_brute; an empty tree walks nothing."""
    rs = np.random.RandomState(n_tris)
    tri = rs.rand(n_tris, 3, 3).astype(np.float32)
    lo, hi = build.triangle_bounds(tri)
    b = build.build_sah(lo, hi)
    nodes = torch.as_tensor(binary.pack_binary_pairs(b.node_lo, b.node_hi, b.node_meta))
    start = int(nodes[0, 12:13].view(torch.int32))
    assert (start < 0) == (len(b.node_meta) == 1)
    tri_p = torch.as_tensor(tri[b.prim_order])
    o = torch.as_tensor((rs.rand(512, 3) * 1.6 - 0.3).astype(np.float32))
    d = torch.as_tensor(rs.randn(512, 3).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.where(torch.arange(512) % 5 == 0, -1.0, 1e30)
    hb = traverse.intersect_brute(tri_p, o, d, t_max)
    assert 0 < int((hb.prim >= 0).sum()) < 400
    for tris in (tri_p, torch.as_tensor(bvh4.pack_tris_cuda(tri_p.numpy()))):
        h = traverse.traverse_binary_plain(nodes, tris, o, d, t_max, False)
        assert all(torch.equal(a, b) for a, b in zip(h, hb))
        occ = traverse.traverse_binary_plain(nodes, tris, o, d, t_max, True)
        assert torch.equal(occ, (hb.prim >= 0) | (t_max < 0))
    empty = torch.as_tensor(binary.pack_binary_pairs(np.zeros((0, 3)), np.zeros((0, 3)),
                                                     np.zeros((0, 3), np.int32)))
    counts = {}
    h = traverse.traverse_binary_plain(empty, tri_p, o, d, t_max, False, counts=counts)
    assert bool((h.prim == -1).all()) and int(counts["slab"].sum()) == 0


def test_bvh8_collapse_and_pack_identical(host_tables):
    lo, hi, meta, _ = host_tables
    jw, tw = j_bvh8.collapse_bvh8(lo, hi, meta), bvh8.collapse_bvh8(lo, hi, meta)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(j_bvh8.pack_wide(*jw), bvh8.pack_wide(*tw)):
        np.testing.assert_array_equal(a, b)


def _check_bvh8_records(lo, hi, meta):
    """pack_bvh8_cuda on the collapse of a flat BVH: the collapse's float32
    boxes, node entries equal, leaf entries the same (offset, count) in the
    walk's encoding, empty children entry 0 with their 3e38 box. -> the
    collapse and the records."""
    wl, wh, wm = bvh8.collapse_bvh8(lo, hi, meta)
    rec = bvh8.pack_bvh8_cuda(wl, wh, wm)
    assert rec.shape == (len(wl), 8, 8) and rec.dtype == np.float32
    np.testing.assert_array_equal(rec[..., 0:3], wl)
    np.testing.assert_array_equal(rec[..., 3:6], wh)
    ent = rec[..., 6].view(np.int32)
    node, leaf, empty = wm > 0, wm < 0, wm == 0
    np.testing.assert_array_equal(ent[node], wm[node])
    u_old, u_new = -wm[leaf] - 1, -ent[leaf].astype(np.int64) - 1
    assert (ent[leaf] < 0).all()
    np.testing.assert_array_equal(u_new >> 4, u_old >> 3)
    np.testing.assert_array_equal((u_new & 15) + 1, (u_old & 7) + 1)
    assert (ent[empty] == 0).all() and (rec[empty][:, 0:6] == np.float32(3e38)).all()
    return (wl, wh, wm), rec


def test_bvh8_cuda_layout_decodes(host_tables):
    """The kernel's records hold the collapse (_check_bvh8_records): the
    TPU table's bounds and, but for the leaf encoding, its meta."""
    lo, hi, meta, _ = host_tables
    (wl, wh, wm), rec = _check_bvh8_records(lo, hi, meta)
    bt, mt = bvh8.pack_wide(wl, wh, wm)
    n = np.arange(len(wl))
    bt = bt.reshape(-1, 8, 128)
    for f in range(6):
        np.testing.assert_array_equal(bt[n // 16, :, (n % 16) * 8 + f], rec[..., f])
    mt = mt.reshape(-1, 8, 128)[n // 16, :, n % 16]
    np.testing.assert_array_equal(mt[wm >= 0], rec[..., 6].view(np.int32)[wm >= 0])
    assert (wm == 0).any() and (wm < 0).any()


def _random_scene_tables(seed):
    """A random soup of 300 triangles of mixed sizes, SAH-built by the port."""
    rs = np.random.RandomState(seed)
    c = rs.randn(300, 1, 3).astype(np.float32) * 4
    tri = (c + rs.randn(300, 3, 3).astype(np.float32) * rs.choice([1e-3, 0.05, 1.0],
                                                                  (300, 1, 1))).astype(np.float32)
    lo, hi = build.triangle_bounds(tri)
    b = build.build_sah(lo, hi)
    return b.node_lo, b.node_hi, b.node_meta, tri[b.prim_order]


@pytest.mark.parametrize("seed", [4, 9])
def test_bvh8_records_on_random_scenes(seed):
    """_check_bvh8_records on random scenes, and plain_bvh8 on their
    records against brute force."""
    lo, hi, meta, tri = _random_scene_tables(seed)
    _, rec = _check_bvh8_records(lo, hi, meta)
    rs = np.random.RandomState(seed)
    o = torch.as_tensor(rs.randn(1024, 3).astype(np.float32) * 5)
    d = torch.as_tensor(rs.randn(1024, 3).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((1024,), 1e30)
    h = traverse.traverse_bvh8_plain(torch.as_tensor(rec),
                                     torch.as_tensor(bvh4.pack_tris_cuda(tri)), o, d, t_max,
                                     False)
    hb = traverse.intersect_brute(torch.as_tensor(tri), o, d, t_max)
    assert all(torch.equal(a, b) for a, b in zip(h, hb))
    assert int((hb.prim >= 0).sum()) > 50


def test_bvh8_empty_children_miss(host_tables):
    """An empty child (3e38 box, entry 0) fails the slab test of every ray:
    random rays, rays along the axes and the diagonals (where the three
    slabs agree), from inside and outside the scene, with a finite and an
    infinite t_max; so the walk never pushes entry 0 (the root)."""
    lo, hi, meta, _ = host_tables
    _, rec = _check_bvh8_records(lo, hi, meta)
    rs = np.random.RandomState(5)
    d = rs.randn(4096, 3).astype(np.float32)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    diag = np.array(np.meshgrid(*[[-1.0, 1.0]] * 3)).reshape(3, -1).T.astype(np.float32)
    d = np.concatenate([d, axes, diag / np.sqrt(np.float32(3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rs.randn(len(d), 3) * 10).astype(np.float32)
    o, d = torch.as_tensor(o)[:, None, :], torch.as_tensor(d)
    inv = traverse.safe_inv(d)[:, None, :]
    empty = torch.as_tensor(rec[rec[..., 6].view(np.int32) == 0])  # (n, 8)
    assert len(empty)
    for t in (1e30, float("inf")):
        hit, _ = traverse._slab(empty[None, :, 0:3], empty[None, :, 3:6], o, inv,
                                torch.full((len(d), 1), t))
        assert not bool(hit.any())


@pytest.mark.parametrize("n_tris", [1, 2, 9, 40])
def test_plain_bvh8_small_trees_match_brute(n_tris):
    """A tree of one leaf (the root's one child), two triangles and a few
    wide nodes through plain_bvh8, closest and any-hit, both triangle
    layouts, against intersect_brute."""
    rs = np.random.RandomState(n_tris)
    tri = rs.rand(n_tris, 3, 3).astype(np.float32)
    lo, hi = build.triangle_bounds(tri)
    b = build.build_sah(lo, hi, max_leaf=4)
    nodes = torch.as_tensor(bvh8.pack_bvh8_cuda(*bvh8.collapse_bvh8(b.node_lo, b.node_hi,
                                                                     b.node_meta)))
    tri_p = torch.as_tensor(tri[b.prim_order])
    o = torch.as_tensor((rs.rand(512, 3) * 1.6 - 0.3).astype(np.float32))
    d = torch.as_tensor(rs.randn(512, 3).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.where(torch.arange(512) % 5 == 0, -1.0, 1e30)
    hb = traverse.intersect_brute(tri_p, o, d, t_max)
    assert 0 < int((hb.prim >= 0).sum()) < 400
    for tris in (tri_p, torch.as_tensor(bvh4.pack_tris_cuda(tri_p.numpy()))):
        h = traverse.traverse_bvh8_plain(nodes, tris, o, d, t_max, False)
        assert all(torch.equal(a, b) for a, b in zip(h, hb))
        occ = traverse.traverse_bvh8_plain(nodes, tris, o, d, t_max, True)
        assert torch.equal(occ, (hb.prim >= 0) | (t_max < 0))


def test_bvh8_packer_raises_on_deep_tree():
    """A walk keeps at most 7 entries a level on its 192-entry stack: depth
    27 (189 entries) packs, depth 28 (196) is refused."""
    def chain(W):  # a chain of wide nodes, depth W
        lo = np.zeros((W, 8, 3), np.float32)
        hi = np.ones((W, 8, 3), np.float32)
        meta = np.full((W, 8), -1, np.int64)
        meta[:-1, 0] = np.arange(1, W)
        return lo, hi, meta

    assert bvh4.wide_depth(chain(27)[2]) == 27
    bvh8.pack_bvh8_cuda(*chain(27))  # 7*27 = 189 entries
    with pytest.raises(ValueError, match="stack"):
        bvh8.pack_bvh8_cuda(*chain(28))  # 196


def test_deep_tree_plain_matches_brute_and_hbm_interpret():
    """The caterpillar tree of depth 100 needs the 128-entry stack: the
    64-entry packer refuses it, the deep plain walk matches brute force, and
    hbm_traverse._traverse_hbm (interpret) on the JAX package's tables."""
    levels = 100
    tri, db = bench_scene.build_deep_tree(levels)
    assert binary.tree_depth(db.node_meta) == levels
    with pytest.raises(ValueError, match="stack"):
        binary.pack_binary_pairs(db.node_lo, db.node_hi, db.node_meta, 64)
    nodes = torch.as_tensor(binary.pack_binary_pairs(db.node_lo, db.node_hi, db.node_meta, 128))
    rays = bench_scene.deep_tree_rays(levels, 1536)
    o, d, t_max = map(torch.from_numpy, rays)
    tris = torch.as_tensor(bvh4.pack_tris_cuda(tri))
    counts = {}
    h = traverse.traverse_binary_plain(nodes, tris, o, d, t_max, False, 128, counts=counts)
    hb = traverse.intersect_brute(torch.as_tensor(tri), o, d, t_max)
    assert torch.equal(h.prim, hb.prim) and torch.equal(h.t, hb.t)
    assert int(counts["slab"].max()) == 2 * levels  # some rays visit every record of the chain
    assert 0.1 < float((h.prim >= 0).float().mean()) < 0.9
    occ = traverse.traverse_binary_plain(nodes, tris, o, d, t_max, True, 128)
    assert torch.equal(occ[t_max > 0], (hb.prim >= 0)[t_max > 0]) and bool(occ[t_max < 0].all())

    node_tab = j_ptrav.pack_nodes(db.node_lo, db.node_hi, db.node_meta).reshape(-1, 8, 128)
    tri_tab = j_ptrav.pack_tris(tri).reshape(-1, 9, 128)
    hj = j_hbm._traverse_hbm(jnp.asarray(node_tab), jnp.asarray(tri_tab),
                             *map(jnp.asarray, rays), any_hit=False, interpret=True)
    _check_closest(hj.prim, hj.t, h, rays[2], tri.reshape(-1, 9))


def test_default_backend_follows_device_and_env(port_scene, monkeypatch):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv("BVH_BACKEND", raising=False)
    assert dispatch.default_backend(cuda) == "cuda_bvh4"
    for env, backend in (("bvh4", "cuda_bvh4"), ("binary", "cuda_binary"),
                         ("hbm", "cuda_binary_deep"), ("bvh8", "cuda_bvh8")):
        monkeypatch.setenv("BVH_BACKEND", env)
        assert dispatch.default_backend(cuda) == backend
        assert dispatch.default_backend(cpu) == "plain"
        assert dispatch.make_intersectors(*port_scene, "cpu").backend == "plain"
    for env in ("xla", "pallas_vmem", ""):  # any other value falls back to bvh4, as in JAX
        monkeypatch.setenv("BVH_BACKEND", env)
        assert dispatch.default_backend(cuda) == "cuda_bvh4"
    for backend in dispatch.CUDA_BACKENDS:
        with pytest.raises(ValueError, match="CUDA"):
            dispatch.make_intersectors(*port_scene, "cpu", backend=backend)


def test_intersectors_hold_tables_and_device(port_scene):
    for backend, shape, tri_shape in (("plain", (4, 8), (3, 3)),
                                      ("plain_binary", (16,), (3, 4)),
                                      ("plain_binary_deep", (16,), (3, 4)),
                                      ("plain_bvh8", (8, 8), (3, 4))):
        isect = dispatch.make_intersectors(*port_scene, "cpu", backend=backend)
        nodes, tris = isect.tables
        assert isect.device == torch.device("cpu") and nodes.device == isect.device
        assert tuple(nodes.shape[1:]) == shape and tris.shape[1:] == tri_shape
        assert nodes.dtype == tris.dtype == torch.float32


def test_port_built_scene_through_new_backends():
    """The port's own SAH build (no JAX tables) through each plain backend."""
    rs = np.random.RandomState(5)
    b = scene.SceneBuilder()
    m = b.add_material("diffuse")
    for _ in range(4):
        b.add_sphere(rs.rand(3) * 3, 0.4, m, n_theta=8, n_phi=16)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    o = torch.as_tensor(rs.rand(512, 3).astype(np.float32) * 3)
    d = torch.as_tensor(rs.randn(512, 3).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((512,), 1e30)
    hb = traverse.intersect_brute(torch.as_tensor(sc.tri_p), o, d, t_max)
    for backend in PLAIN:
        h = dispatch.make_intersectors(sc, dbvh, "cpu", backend=backend).closest(o, d, t_max)
        assert torch.equal(h.prim, hb.prim) and torch.equal(h.t, hb.t), backend


def test_trav_prof_ray_classes_on_cpu(port_scene):
    """trav_prof's ray classes at a tiny size; the tool itself needs a card."""
    from nn_bvh_tpu_torch.wavefront import camera
    from nn_bvh_tpu_torch.geometry import transform

    cam = camera.make_perspective(transform.look_at((0, 3, -9), (0, 1, 0), (0, 1, 0)),
                                  fov=50.0, width=16, height=12)
    isect = dispatch.make_intersectors(*port_scene, "cpu")
    batches, live = trav_prof.ray_batches(port_scene[0], cam, isect.closest, "cpu")
    assert set(batches) == {"camera", "bounce", "shadow", "incoherent"}
    for o, d, t_max in batches.values():
        assert o.shape == d.shape == (192, 3) and t_max.shape == (192,)
        assert o.dtype == d.dtype == t_max.dtype == torch.float32
        assert bool(torch.isfinite(o).all() and torch.isfinite(d).all())
    found = isect.closest(*batches["camera"]).prim >= 0
    assert torch.equal(batches["bounce"][2] > 0, found)
    assert torch.equal(batches["shadow"][2] > 0, found)
    assert 0.0 < live == float(found.float().mean()) <= 1.0


def test_trav_prof_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trav_prof.main(["binary"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        trav_prof.main(["xla"])
