"""Kernel-vs-plain tests of the torch port on a CUDA card.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py

Every test is marked `cuda` and skips inside the test when no card is
present (the CUDA kernel has no CPU mode). The kernel and its plain torch
version round alike (-fmad=false), so hits and films must be identical.
"""

import numpy as np
import pytest
import torch

from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.accel import (binary, binary_kernel, bvh4, bvh4_kernel, bvh8_kernel,
                                    dispatch, traverse)
from nn_bvh_tpu_torch.accel.kernel_launch import n_launches
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene, transform
from nn_bvh_tpu_torch.tools import bench_scene
from nn_bvh_tpu_torch.wavefront import camera, film, integrator

torch.set_num_threads(1)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _scene():
    """tests/test_pallas_interpret.py's scene plus an emitter, port-built."""
    rs = np.random.RandomState(3)
    b = scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    for i in range(6):
        c = (rs.rand(3) - 0.5) * 4 + np.array([0, 1.0, 0])
        b.add_sphere(c, 0.3 + 0.3 * rs.rand(), metal if i % 2 else m, n_theta=10, n_phi=20)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), m,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=10.0)
    return accel.build_scene_bvh(b.build())[:2]


def _rays(dev):
    rs = np.random.RandomState(11)
    R = 20000
    o = (rs.rand(R, 3).astype(np.float32) - 0.5) * 6
    o[:, 1] += 1.5
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((R,), 1e30, np.float32)
    t_max[::5] = -1.0  # dead lanes
    return tuple(torch.as_tensor(x, device=dev) for x in (o, d, t_max))


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    _need_card()
    sc, dbvh = _scene()
    k = dispatch.make_intersectors(sc, dbvh, "cuda")
    p = dispatch.make_intersectors(sc, dbvh, "cuda", backend="plain")
    assert k.backend == "cuda_bvh4"
    o, d, t_max = _rays("cuda")
    before = n_launches["bvh4_traverse"]
    hk, hp = k.closest(o, d, t_max), p.closest(o, d, t_max)
    ok, op = k.any_hit(o, d, t_max), p.any_hit(o, d, t_max)
    torch.cuda.synchronize()
    assert n_launches["bvh4_traverse"] == before + 2
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    assert torch.equal(ok, op)
    live = t_max > 0
    assert bool((hk.prim[~live] == -1).all()) and bool(ok[~live].all())
    assert 0.1 < float((hk.prim[live] >= 0).float().mean()) < 1.0


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_cannot_take():
    _need_card()
    sc, dbvh = _scene()
    k = dispatch.make_intersectors(sc, dbvh, "cuda")
    o, d, t_max = _rays("cuda")
    bad = [(o.double(), d, t_max, TypeError),
           (o, d.cpu(), t_max, ValueError),
           (o[:, :2].contiguous(), d, t_max, ValueError),
           (o.t().contiguous().t(), d, t_max, ValueError),
           (o, d, t_max[:-1], ValueError)]
    for oo, dd, tt, err in bad:
        with pytest.raises(err):
            bvh4_kernel.traverse(*k.tables, oo, dd, tt)


@pytest.mark.cuda
def test_wrapper_refuses_vertex_triangle_table():
    """The BVH4 kernel reads 16-byte records: an (N, 3, 3) table, or records
    that do not start on a 16-byte boundary, are refused before launch."""
    _need_card()
    sc, dbvh = _scene()
    k = dispatch.make_intersectors(sc, dbvh, "cuda")
    p = dispatch.make_intersectors(sc, dbvh, "cuda", backend="plain")
    nodes, recs = k.tables
    assert recs.shape[1:] == (3, 4) and p.tables[1].shape[1:] == (3, 3)
    o, d, t_max = _rays("cuda")
    before = n_launches["bvh4_traverse"]
    with pytest.raises(ValueError, match="shape"):
        bvh4_kernel.traverse(nodes, p.tables[1], o, d, t_max)
    shifted = torch.zeros(recs.numel() + 1, device="cuda")[1:].view(recs.shape)
    shifted.copy_(recs)
    with pytest.raises(ValueError, match="16-byte"):
        bvh4_kernel.traverse(nodes, shifted, o, d, t_max)
    assert n_launches["bvh4_traverse"] == before


@pytest.mark.cuda
def test_kernel_meets_contract_on_wave_batches():
    """The nine batches of one bench wave, as the integrator hands them to
    the kernel: t bit-equal, prim/b1/b2 equal but on exact t ties, occlusion
    equal, against the plain traversal on the card."""
    _need_card()
    sc, dbvh, cam = bench_scene.build_bench_scene()
    batches = bench_scene.wave_batches(sc, dbvh, cam, "cuda")
    assert len(batches) == 2 * bench_scene.BENCH_DEPTH + 1
    k = dispatch.make_intersectors(sc, dbvh, "cuda")
    p = dispatch.make_intersectors(sc, dbvh, "cuda", backend="plain")
    ties = 0
    for i, (name, (o, d, t_max, any_hit)) in enumerate(
            zip(bench_scene.wave_batch_names(batches), batches)):
        out = k.fn(*k.tables, o, d, t_max, any_hit)
        ref = p.fn(*p.tables, o, d, t_max, any_hit)
        ties += bench_scene.check_hits(out, ref, t_max, any_hit, name)
        if i in (2, 4, 6):
            # a bounce's closest-hit batch: the integrator re-sorted its
            # lanes just before, dead lanes behind the live ones
            dead = (t_max < 0).int()
            assert bool((dead[1:] >= dead[:-1]).all())
    assert ties <= 16


def _contract_on_wave_batches(backend, plain, name):
    """`backend`'s kernel on the nine batches of one bench wave (recorded
    through cuda_bvh4) against `plain` on the card, under the contract of
    bench_scene.check_hits; its launches (kernel `name`) = the batches."""
    sc, dbvh, cam = bench_scene.build_bench_scene()
    batches = bench_scene.wave_batches(sc, dbvh, cam, "cuda")
    k = dispatch.make_intersectors(sc, dbvh, "cuda", backend=backend)
    p = dispatch.make_intersectors(sc, dbvh, "cuda", backend=plain)
    before = n_launches[name]
    ties = 0
    for label, (o, d, t_max, any_hit) in zip(bench_scene.wave_batch_names(batches), batches):
        out = k.fn(*k.tables, o, d, t_max, any_hit)
        ref = p.fn(*p.tables, o, d, t_max, any_hit)
        ties += bench_scene.check_hits(out, ref, t_max, any_hit, f"{backend} {label}")
    torch.cuda.synchronize()
    assert n_launches[name] == before + len(batches)
    assert ties <= 16


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda_binary", "cuda_binary_deep"])
def test_binary_kernels_meet_contract_on_wave_batches(backend):
    """Both entries of csrc/binary_traverse.cu on the nine batches of one
    bench wave against plain_binary."""
    _need_card()
    _contract_on_wave_batches(backend, "plain_binary",
                              binary_kernel.ENTRIES[128 if backend.endswith("deep") else 64])


@pytest.mark.cuda
def test_bvh8_kernel_meets_contract_on_wave_batches():
    """csrc/bvh8_traverse.cu on the nine batches of one bench wave, against
    plain_bvh8."""
    _need_card()
    _contract_on_wave_batches("cuda_bvh8", "plain_bvh8", bvh8_kernel.NAME)


@pytest.mark.cuda
def test_bvh8_wrapper_refuses_vertex_triangle_table():
    """The BVH8 kernel reads 16-byte triangle records and (W, 8, 8) node
    records: an (N, 3, 3) table or a BVH4 node table is refused before
    launch."""
    _need_card()
    sc, dbvh = _scene()
    nodes, recs = dispatch.make_intersectors(sc, dbvh, "cuda", backend="cuda_bvh8").tables
    assert nodes.shape[1:] == (8, 8) and recs.shape[1:] == (3, 4)
    verts = dispatch.make_intersectors(sc, dbvh, "cuda", backend="plain").tables[1]
    bvh4_nodes = dispatch.make_intersectors(sc, dbvh, "cuda").tables[0]
    o, d, t_max = _rays("cuda")
    before = n_launches[bvh8_kernel.NAME]
    for bad_nodes, bad_tris in ((nodes, verts), (bvh4_nodes, recs)):
        with pytest.raises(ValueError, match="shape"):
            bvh8_kernel.traverse(bad_nodes, bad_tris, o, d, t_max)
    assert n_launches[bvh8_kernel.NAME] == before


@pytest.mark.cuda
def test_wave_kernel_matches_plain_on_cuda():
    """Same seed, same film through the kernel and the plain traversal."""
    _need_card()
    sc, dbvh = _scene()
    cam = camera.make_perspective(transform.look_at((0, 3, -8), (0, 1, 0), (0, 1, 0)),
                                  fov=50.0, width=64, height=48)
    cfg = integrator.IntegratorConfig(max_depth=4, rr_depth=2)
    scfg = samplers.make_sampler("sobol", seed=0, spp=4)
    films = []
    for backend in ("cuda_bvh4", "plain"):
        isect = dispatch.make_intersectors(sc, dbvh, "cuda", backend=backend)
        wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=isect)
        f = film.make_film(cam.height, cam.width, "cuda")
        for s in range(2):
            f = wave(f, s)
        films.append(f.xyz)
    assert torch.equal(films[0], films[1])
    assert float(films[0].mean()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("interface", [False, True], ids=["opaque_sphere", "fog_boundary"])
def test_phased_volpath_kernel_matches_plain_trace(interface):
    """VolPath's phased wave through cuda_bvh4 (padded, cut and re-sorted
    batches, shadow segments across the fog's boundary) against the
    whole-wave trace through the plain traversal, with the crown's settings
    at 128x128; every batch of the kernel is held against the plain
    traversal on the same lanes."""
    _need_card()
    from nn_bvh_tpu_torch.wavefront import volpath

    sc, dbvh, cam = bench_scene.build_fog_scene(128, interface)
    cfg, scfg = bench_scene.volpath_fog_config()
    plain = dispatch.make_intersectors(sc, dbvh, "cuda", backend="plain")
    checked = bench_scene.CheckedIntersectors(
        dispatch.make_intersectors(sc, dbvh, "cuda"), plain, "fog")
    wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=checked)
    assert hasattr(wave, "phases")
    tsc = scene.to_device(sc, "cuda")
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32, device="cuda")
    f_ph = f_pl = film.make_film(cam.height, cam.width, "cuda")
    for s in range(2):
        f_ph = wave(f_ph, s)
        L, lam, pdf, fw = volpath.trace_wave_vol(tsc, None, cam, scfg, cfg, pix, s, None, plain)
        f_pl = film.add_samples(f_pl, pix, L, lam, pdf, filter_weight=fw, sequential=True)
    a, b = film.develop(f_ph), film.develop(f_pl)
    assert float(a.mean()) > 0
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert len({n for n, _ in checked.sizes}) > 1, checked.sizes  # the ladder cut lanes


@pytest.fixture(scope="module")
def bench():
    """The bench scene (52,996 triangles) and 20,000 incoherent rays in its
    box, 20% dead lanes."""
    _need_card()
    sc, dbvh, _ = bench_scene.build_bench_scene()
    rs = np.random.RandomState(7)
    R = 20000
    lo, hi = np.asarray(sc.bounds)
    o = (lo + rs.rand(R, 3) * (hi - lo)).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.rand(R) < 0.2, -1.0, 1e30).astype(np.float32)
    return sc, dbvh, (o, d, t_max)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda_binary", "cuda_binary_deep", "cuda_bvh8"])
def test_new_kernels_match_plain_on_bench_scene(bench, backend):
    _need_card()
    sc, dbvh, rays = bench
    k = dispatch.make_intersectors(sc, dbvh, "cuda", backend=backend)
    p = dispatch.make_intersectors(sc, dbvh, "cuda", backend=backend.replace("cuda_", "plain_"))
    o, d, t_max = (torch.as_tensor(x, device="cuda") for x in rays)
    before = sum(n_launches.values())
    hk, hp = k.closest(o, d, t_max), p.closest(o, d, t_max)
    ok, op = k.any_hit(o, d, t_max), p.any_hit(o, d, t_max)
    torch.cuda.synchronize()
    assert sum(n_launches.values()) == before + 2
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    assert torch.equal(ok, op)
    live = t_max > 0
    assert bool((hk.prim[~live] == -1).all()) and bool(ok[~live].all())
    assert 0.1 < float((hk.prim[live] >= 0).float().mean()) < 1.0


@pytest.mark.cuda
def test_deep_kernel_on_deep_tree():
    _need_card()
    tri, db = bench_scene.build_deep_tree(100)
    nodes = torch.as_tensor(binary.pack_binary_pairs(db.node_lo, db.node_hi, db.node_meta, 128),
                            device="cuda")
    tris = torch.as_tensor(bvh4.pack_tris_cuda(tri), device="cuda")
    rays = bench_scene.deep_tree_rays(100, 20000)
    o, d, t_max = (torch.as_tensor(x, device="cuda") for x in rays)
    hk = binary_kernel.traverse(nodes, tris, o, d, t_max, False, stack=128)
    hp = traverse.traverse_binary_plain(nodes, tris, o, d, t_max, False, 128)
    hb = traverse.intersect_brute(torch.as_tensor(tri, device="cuda"), o, d, t_max)
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    assert torch.equal(hk.prim, hb.prim)
    assert torch.equal(binary_kernel.traverse(nodes, tris, o, d, t_max, True, stack=128),
                       traverse.traverse_binary_plain(nodes, tris, o, d, t_max, True, 128))


# ---------------------------------------------------------------------------
# the traversal kernel lab (csrc/kernel_lab.cu): packet kernels vs their
# plain versions, bit for bit, on the small scene
# ---------------------------------------------------------------------------

LAB_VARIANTS = {
    "rows8": dict(rows=8, count=True),
    "rows16": dict(rows=16, count=True),
    "rows32": dict(rows=32, count=True),
    "rows32-k2": dict(rows=32, k_pop=2, count=True),
    "rows32-k4": dict(rows=32, k_pop=4, count=True),
    "rows32-none": dict(rows=32, leaf_mode="none", count=True),
    "rows32-vec": dict(rows=32, vec=True, count=True),
    "rows4-nocount": dict(rows=4),
}


# a packet of rows*128 lanes runs as a cluster of 1-8 blocks of at most 512
# threads (kernel_lab.launch_geometry); None: the size the wrapper picks
LAB_CLUSTERS = {4: (None, 1, 2, 4, 8), 8: (None, 2, 4), 16: (None, 4), 32: (None,)}


def _lab_inputs():
    from nn_bvh_tpu_torch.tools import kernel_lab  # imports no JAX

    sc, dbvh = _scene()
    return kernel_lab.lab_tables(sc, dbvh, "cuda"), _rays("cuda")


def _lab_batches(rays, rows):
    """The 20,000 rays; one packet; three packets, the last of them 100
    live lanes and the rest padding."""
    P = rows * 128
    return {"all": rays, "one packet": tuple(x[:P] for x in rays),
            "padded": tuple(x[:2 * P + 100] for x in rays)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant,cluster", [(v, c) for v, kw in LAB_VARIANTS.items()
                                             for c in LAB_CLUSTERS[kw["rows"]]])
def test_lab_kernel_matches_plain(variant, cluster):
    _need_card()
    from nn_bvh_tpu_torch.tools import kernel_lab

    tables, rays = _lab_inputs()
    kw = LAB_VARIANTS[variant]
    for name, batch in _lab_batches(rays, kw["rows"]).items():
        before = n_launches["lab_traverse"]
        out = kernel_lab.lab_traverse(*tables, *batch, cluster=cluster, **kw)
        torch.cuda.synchronize()
        assert n_launches["lab_traverse"] == before + 1
        ref = kernel_lab.lab_traverse_plain(*tables, *batch, **kw)
        for a, b in zip(out, ref):
            assert a.shape == b.shape and torch.equal(a, b), name
        if kw.get("count"):
            assert int(out[2].min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cluster", [(16, None), (4, 1), (4, 2), (4, 4), (4, 8)])
@pytest.mark.parametrize("leaf_when", [False, True])
def test_brless_kernel_matches_plain(leaf_when, rows, cluster):
    _need_card()
    from nn_bvh_tpu_torch.tools import kernel_lab

    tables, rays = _lab_inputs()
    for name, batch in _lab_batches(rays, rows).items():
        out = kernel_lab.brless_traverse(*tables, *batch, rows=rows, leaf_when=leaf_when,
                                         cluster=cluster)
        ref = kernel_lab.brless_traverse_plain(*tables, *batch, rows=rows, leaf_when=leaf_when)
        for a, b in zip(out, ref):
            assert torch.equal(a, b), name
        assert not out[2].any() and not out[3].any()
        lab = kernel_lab.lab_traverse(*tables, *batch, rows=rows, cluster=cluster)
        assert torch.equal(lab[1], out[1]) and torch.equal(lab[0], out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("with_load,with_slab", [(False, False), (True, False), (True, True)])
def test_floor_kernel_matches_plain(with_load, with_slab):
    """One packet a cluster: every rows at every cluster size that
    launch_geometry allows for it, bit for bit."""
    _need_card()
    from nn_bvh_tpu_torch.tools import kernel_lab

    rs = np.random.RandomState(2)
    nodes = torch.as_tensor(rs.randn(17100, 8).astype(np.float32), device="cuda")
    ox = torch.as_tensor(rs.randn(4096).astype(np.float32), device="cuda")
    ran = 0
    for rows in kernel_lab.ROWS:
        ref = {n_iter: kernel_lab.floor_bench_plain(nodes, ox, n_iter=n_iter,
                                                    with_load=with_load, with_slab=with_slab,
                                                    rows=rows) for n_iter in (37, 3000)}
        for cluster in (None, 1, 2, 4, 8):
            try:
                kernel_lab.launch_geometry(rows, cluster)
            except ValueError:
                continue
            for n_iter, want in ref.items():
                out = kernel_lab.floor_bench(nodes, ox, n_iter=n_iter, with_load=with_load,
                                             with_slab=with_slab, rows=rows, cluster=cluster)
                assert out.shape == (rows, 128) and torch.equal(out, want), (rows, cluster)
                ran += 1
    assert ran == 2 * (len(kernel_lab.ROWS) + 17)  # and the 17 sizes that can be forced
    with pytest.raises(ValueError, match="17023"):
        kernel_lab.floor_bench(nodes[:17000].contiguous(), ox, n_iter=10)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["rows=32", "rows=4 cluster=1", "rows=4 cluster=8"])
def test_floor_cycles_times_each_piece(geometry):
    """The probe runs in one cluster of each geometry of the floor's sweep,
    reads a positive number of cycles for every piece, and its chains are
    the ones it names: a record load outlasts a shared load, the vote its
    block OR, a publication the barrier after it, and an exchange between 8
    blocks one within a block."""
    _need_card()
    from nn_bvh_tpu_torch.tools import kernel_lab

    rows, cluster = kernel_lab.FLOOR_GEOMETRIES[geometry]
    rs = np.random.RandomState(2)
    nodes = torch.as_tensor(rs.randn(17100, 8).astype(np.float32), device="cuda")
    pieces = kernel_lab.floor_cycles(nodes, rows, cluster, reps=200)
    assert list(pieces) == list(kernel_lab.FLOOR_PIECES)
    assert all(0 < c < 1e5 for c in pieces.values()), pieces
    assert all(c > 0 for c in kernel_lab.floor_chain(pieces).values())
    p = pieces
    assert p["ldg"] > p["ld"] and p["vote"] > p["or"], pieces
    assert p["pub_bar"] > p["bar"] and p["pub_vote"] > p["pub_bar"], pieces
    if kernel_lab.launch_geometry(rows, cluster)[0] > 1:
        one_block = kernel_lab.floor_cycles(nodes, 4, 1, reps=200)
        assert p["xchg"] > one_block["xchg"], (pieces, one_block)


@pytest.mark.cuda
def test_lab_kernel_raises_on_stack_overflow():
    _need_card()
    from nn_bvh_tpu_torch.tools import kernel_lab

    tri, db = bench_scene.build_widening_tree(20)
    nodes = torch.as_tensor(binary.pack_binary_cuda(db.node_lo, db.node_hi, db.node_meta),
                            device="cuda")
    tris = torch.as_tensor(tri, device="cuda")
    o, d, t_max = (torch.as_tensor(x, device="cuda") for x in bench_scene.widening_tree_rays(2048))
    for cluster in (None, 8):  # 8: an overflow that any block finds is raised
        for k_pop in (1, 2):
            out = kernel_lab.lab_traverse(nodes, tris, o, d, t_max, rows=8, k_pop=k_pop,
                                          count=True, cluster=cluster)
            ref = kernel_lab.lab_traverse_plain(nodes, tris, o, d, t_max, rows=8, k_pop=k_pop,
                                                count=True)
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
        with pytest.raises(kernel_lab.StackOverflow):
            kernel_lab.lab_traverse(nodes, tris, o, d, t_max, rows=8, k_pop=4, cluster=cluster)
