"""Kernel-vs-plain tests of the torch port on a CUDA card.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py

Every test is marked `cuda` and skips inside the test when no card is
present (the CUDA kernel has no CPU mode). The kernel and its plain torch
version round alike (-fmad=false), so hits and films must be identical.
"""

import os
import re
import subprocess

import numpy as np
import pytest
import torch

from nn_bvh_tpu_torch import accel, devices, kernels
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
def test_texture_lookup_on_card_matches_cpu():
    """lookup on the card against the CPU: level 0 and the rounded level
    equal, trilinear within atol 1e-5 (the level's log2 rounds apart);
    out-of-range ids and non-finite uvs clamp instead of stopping the card."""
    _need_card()
    from nn_bvh_tpu_torch.geometry import texture

    rs = np.random.RandomState(2)
    atlas, desc = texture.pack_atlas([(rs.rand(37, 53, 3) * 1.6).astype(np.float32),
                                      rs.rand(64, 64, 3).astype(np.float32)])
    n = 65536
    uv = (rs.rand(n, 2) * 6 - 3).astype(np.float32)
    uv[:64] = np.nan
    tex_id = rs.randint(-2, 4, n).astype(np.int32)
    foot = (rs.rand(n) * 18 - 14).astype(np.float32)
    args = [atlas, desc, tex_id, uv]
    cpu = [torch.from_numpy(a) for a in args]
    gpu = [t.cuda() for t in cpu]
    for kw, tol in ((dict(), 0.0), (dict(trilinear=False), 0.0), (dict(trilinear=True), 1e-5)):
        f = None if not kw else torch.from_numpy(foot)
        a = texture.lookup(*cpu, foot_log2=f, **kw)
        b = texture.lookup(*gpu, foot_log2=None if f is None else f.cuda(), **kw).cpu()
        torch.cuda.synchronize()
        np.testing.assert_allclose(b[64:].numpy(), a[64:].numpy(), atol=max(tol, 1e-6), rtol=0)


@pytest.mark.cuda
def test_textured_wave_on_card():
    """A textured scene (image, checkerboard and procedural textures, a
    texture-driven mix, a projection and a goniometric light): the same
    film through bvh4_traverse and the plain traversal on the card, and
    close to the CPU's film."""
    _need_card()
    from nn_bvh_tpu_torch.geometry import texture

    rs = np.random.RandomState(4)
    b = scene.SceneBuilder()
    red = b.add_material("diffuse", reflectance=(0.7, 0.2, 0.1))
    metal = b.add_material("conductor", reflectance=(0.9, 0.8, 0.6), roughness=0.2)
    chk = b.add_material("diffuse", texture=b.add_texture_checker(uscale=8))
    img = b.add_material("diffuse", texture=b.add_texture_image(
        rs.rand(64, 48, 3).astype(np.float32)))
    fbm = b.add_material("diffuse", texture=b.add_texture_procedural("marble"))
    mask = b.add_texture_image(rs.rand(32, 32, 3).astype(np.float32))
    mix = b.add_material("mix", mix_materials=(red, metal), mix_amount=-(mask + 1.0))
    tt, pp = np.meshgrid(np.linspace(0, 1, 13), np.linspace(0, 2, 25), indexing="ij")
    sphere_uv = np.stack([pp, tt], -1).reshape(-1, 2).astype(np.float32)
    for i, m in enumerate((chk, img, fbm, mix, metal)):
        b.add_sphere(((i - 2) * 1.3, 0.6, 0), 0.55, m, n_theta=12, n_phi=24, uvs=sphere_uv)
    b.add_quad((-6, 0, -6), (6, 0, -6), (6, 0, 6), (-6, 0, 6), chk,
               uvs=np.asarray([(0, 0), (6, 0), (6, 6), (0, 6)], np.float32))
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), red,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=8.0)
    b.add_projection_light((0, 5, -3), (0, -1, 0.5), rs.rand(16, 16, 3).astype(np.float32),
                           scale=20.0, fov=40.0)
    b.add_goniometric_light((2, 3, -2), (rs.rand(16, 16, 3) + 0.2).astype(np.float32), scale=6.0)
    sc, dbvh = accel.build_scene_bvh(b.build())[:2]
    assert texture.has_textures(sc)
    cam = camera.make_perspective(transform.look_at((0, 2.5, -7), (0, 0.6, 0), (0, 1, 0)),
                                  fov=45.0, width=64, height=48)
    cfg = integrator.IntegratorConfig(max_depth=3, rr_depth=2)
    scfg = samplers.make_sampler("sobol", seed=0, spp=2)
    films = {}
    for dev, backend in (("cuda", "cuda_bvh4"), ("cuda", "plain"), ("cpu", "plain")):
        isect = dispatch.make_intersectors(sc, dbvh, dev, backend=backend)
        wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=isect)
        f = film.make_film(cam.height, cam.width, dev)
        for s in range(2):
            f = wave(f, s)
        films[dev, backend] = film.develop(f).cpu().numpy()
    assert np.array_equal(films["cuda", "cuda_bvh4"], films["cuda", "plain"])
    g, c = films["cuda", "plain"], films["cpu", "plain"]
    assert np.isfinite(g).all() and g.mean() > 0
    assert abs(g.mean() - c.mean()) <= 0.01 * c.mean()
    assert np.isclose(g, c, atol=1e-3, rtol=1e-2).all(-1).mean() >= 0.95


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


def _small_lights(env="image"):
    b = bench_scene.small_lights_scene(scene.SceneBuilder(), env)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    return sc, dbvh


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda_bvh4", "cuda_binary", "cuda_bvh8"])
def test_quadric_merge_on_cuda(backend):
    """The quadrics' min-t merge after each CUDA kernel against the same
    merge after the plain traversal, under the kernels' contract
    (bench_scene.check_hits), then a Path wave of the lights scene (every
    light, the light BVH, Halton) through both: equal films."""
    _need_card()
    sc, dbvh = _small_lights()
    kern = dispatch.make_intersectors(sc, dbvh, "cuda", backend=backend)
    plain = dispatch.make_intersectors(sc, dbvh, "cuda", backend="plain")
    o, d, t_max = _rays("cuda")
    hk, hp = kern.closest(o, d, t_max), plain.closest(o, d, t_max)
    bench_scene.check_hits(hk, hp, t_max, False, f"{backend} closest")
    assert bool((hk.prim >= kern.quad_base).any())
    bench_scene.check_hits(kern.any_hit(o, d, t_max), plain.any_hit(o, d, t_max), t_max, True,
                           f"{backend} any-hit")
    cam = bench_scene.small_lights_camera(camera, 48)
    cfg = integrator.IntegratorConfig(max_depth=4, rr_depth=2, light_sampler="bvh")
    scfg = samplers.make_sampler("halton", seed=0, spp=4)
    films = []
    for isect in (kern, plain):
        wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=isect)
        films.append(wave(wave(film.make_film(cam.height, cam.width, "cuda"), 0), 1).xyz)
    assert torch.equal(films[0], films[1]) and float(films[0].mean()) > 0


@pytest.mark.cuda
def test_motion_repack_on_cuda():
    """A moving scene's per-wave triangle records, rebuilt on the card, equal
    bvh4.pack_tris_cuda of the lerped vertices bit for bit, and its waves
    through cuda_bvh4 meet the contract on every batch against the plain
    traversal on the same lerped tables."""
    _need_card()
    sc, dbvh, _ = bench_scene.build_motion_scene(64)
    cam = bench_scene.motion_camera(64)
    tsc = scene.to_device(sc, "cuda")
    lerped = integrator.scene_at_shutter(tsc, 3, 16).tri_p
    rec = dispatch.tri_table_device("cuda_bvh4", lerped).cpu().numpy()
    ref = bvh4.pack_tris_cuda(lerped.cpu().numpy())
    assert np.array_equal(rec.view(np.uint32), ref.view(np.uint32))
    cfg, scfg = bench_scene.bench_config()
    checked = bench_scene.CheckedIntersectors(
        dispatch.make_intersectors(sc, dbvh, "cuda"),
        dispatch.make_intersectors(sc, dbvh, "cuda", backend="plain"), "motion")
    wave = integrator.make_wave_fn(sc, dbvh, cam, scfg, cfg, isect=checked)
    f = film.make_film(cam.height, cam.width, "cuda")
    for s in range(3):
        f = wave(f, s)
    assert len(checked.sizes) > 3 and float(film.develop(f).mean()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fullsobol", "pmj02bn"])
def test_sampler_tables_on_card(kind):
    """A sampler's tables are made on the CPU; draws on the card after
    samplers.to_device equal the CPU's bit for bit, and draws on the card
    from tables left on the CPU raise instead of copying them each call."""
    _need_card()
    scfg = samplers.make_sampler(kind, seed=3, spp=16, width=64)
    pix = torch.arange(4096, dtype=torch.int32)
    smp = pix % 16
    on_cpu = samplers.get_2d(scfg, pix, smp, 7)
    on_card = samplers.get_2d(samplers.to_device(scfg, "cuda"), pix.cuda(), smp.cuda(), 7)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    with pytest.raises(RuntimeError):
        samplers.get_1d(scfg, pix.cuda(), smp.cuda(), 7)


@pytest.mark.cuda
def test_treenet_step_on_card_matches_cpu():
    """One full-width treeNet EPO step (TreeNetConfig(): levels 4, capacity
    128, 2,048 prims) at batch 1 on the bench geometry, from the same
    weights on the card (TF32 off) and on the CPU: the losses within rtol
    1e-4, each weight's gradient within 1e-3 of its largest |g| on the CPU
    (chip_smoke 18.1's check)."""
    _need_card()
    from nn_bvh_tpu_torch.learn import treenet

    cfg = treenet.TreeNetConfig()
    weights = treenet.params_to_numpy(treenet.init_params(cfg, 0, "cpu"))
    clouds = bench_scene.treenet_scene().next_batch(1)
    devices.full_float32()
    out = []
    for dev in ("cuda", "cpu"):
        model = treenet.params_from_jax(weights, cfg, device=dev)
        loss, _ = treenet.loss_fn(model, cfg, torch.as_tensor(clouds, device=dev))
        out.append((loss.item(), [g.cpu() for g in torch.autograd.grad(
            loss, list(model.parameters()))]))
    (l_card, g_card), (l_cpu, g_cpu) = out
    assert not torch.backends.cuda.matmul.allow_tf32
    assert np.isfinite(l_card) and abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    for a, b in zip(g_card, g_cpu):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def _material_grads(R, M, C, seed):
    """grad (R, C) and skewed int32 ids on the card: a tenth of the lanes
    missed (-1), half on row 0, the rest spread over the M rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grad = torch.randn(R, C, generator=gen, device="cuda")
    u = torch.rand(R, generator=gen, device="cuda")
    spread = torch.randint(0, M, (R,), generator=gen, device="cuda")
    ids = torch.where(u < 0.1, -1, torch.where(u < 0.6, 0, spread))
    return grad, ids.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("R,M,C", [(921_600, 3, 17), (100_003, 1, 17), (50_001, 150, 17),
                                   (70_001, 5, 3), (20_001, 4, 200)],
                         ids=["joint", "one_row", "row_tiles", "narrow", "wide"])
def test_material_grad_matches_float64_segment_sum(R, M, C):
    """The segment sum of csrc/material_grad.cu against index_add_ in
    float64, at the joint_720p shape, one row, a table cut into row tiles
    (150 rows of 17 columns: the accumulators hold 48), and other widths.
    Tolerance: each entry is a tree of float32 adds (a thread's lanes, the
    block's lane groups, the blocks), so it lies within (its longest chain)
    x 2^-24 x the entry's absolute sum of the float64 value. Two calls are
    bit-identical."""
    _need_card()
    from nn_bvh_tpu_torch.scatter import material_grad as mg

    grad, ids = _material_grads(R, M, C, seed=R + M)
    before = n_launches[mg.NAME]
    got = mg.segment_sum(grad, ids, M)
    assert n_launches[mg.NAME] == before + 2  # partial sums, then their sum
    ref = mg.segment_sum_plain(grad, ids, M)
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    groups = 256 // C
    chain = -(-R // blocks) // groups + 1 + groups + blocks
    bound = chain * 2.0 ** -24 * mg.segment_sum_plain(grad.abs(), ids, M)
    assert got.dtype == torch.float32 and got.shape == (M, C)
    assert bool(((got.double() - ref).abs() <= bound).all())
    assert torch.equal(got, mg.segment_sum(grad, ids, M))


@pytest.mark.cuda
def test_material_grad_has_no_atomic_instruction():
    """No atomic or reduction instruction (ATOM, ATOMS, ATOMG, RED) in the
    library's SASS (cuobjdump, beside nvcc)."""
    _need_card()
    from torch.utils.cpp_extension import CUDA_HOME

    from nn_bvh_tpu_torch.scatter import material_grad as mg

    mg.segment_sum(*_material_grads(1000, 3, 17, seed=1), 3)
    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                           kernels.load(mg.NAME)._name], capture_output=True, text=True,
                          check=True).stdout
    assert "partial_sums" in sass
    assert re.findall(r"\b(?:ATOM|ATOMS|ATOMG|RED)\.[A-Z0-9_.]+", sass) == []


@pytest.mark.cuda
def test_joint_step_gradients_match_the_plain_gather(monkeypatch):
    """The joint_720p step's gradients (the bench scene at 1280x720, depth 4,
    RR from 2, the full-width tree on 8 clouds) with the kernel's backward
    against the same step with the material gather monkeypatched to the plain
    gather, whose backward is aten's index_put_. The sums run in another
    order, so the gradients differ by float32 rounding: the norms of the
    tree's and of the coefficients' gradients within the cell's gradient-norm
    limit (benchmark/workloads/joint_720p.json, 1.5e-4 relative), and each
    coefficient's gradient within 1.5e-4 of their norm."""
    _need_card()
    from nn_bvh_tpu_torch.geometry import scene as scene_mod
    from nn_bvh_tpu_torch.learn import joint, treenet
    from nn_bvh_tpu_torch.scatter import lightsamplers, material_grad as mg

    devices.full_float32()
    dev = torch.device("cuda")
    sc, dbvh, _ = bench_scene.build_bench_scene()
    cam = camera.make_perspective(transform.look_at((0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0)),
                                  fov=50.0, width=1280, height=720)
    rcfg = integrator.IntegratorConfig(max_depth=4, mis=True, rr_depth=2)
    tcfg = treenet.TreeNetConfig()
    tsc = scene_mod.to_device(sc, dev)
    lst = lightsamplers.build(tsc, rcfg.light_sampler, dev)
    isect = dispatch.make_intersectors(sc, dbvh, dev)
    pix = torch.arange(1280 * 720, dtype=torch.int32, device=dev)
    clouds = torch.as_tensor(bench_scene.treenet_scene().next_batch(8), device=dev)
    model = treenet.init_params(tcfg, seed=0, device=dev)
    loss_fn = joint.make_joint_loss(tcfg, cam, samplers.make_sampler("sobol", seed=7, spp=16),
                                    rcfg)

    def grads():
        mc = tsc.mat_coeffs.detach().clone().requires_grad_(True)
        params = list(model.parameters())
        loss, _ = loss_fn(joint.JointState(model, mc), tsc, None, lst, clouds, pix, 1, isect)
        g = torch.autograd.grad(loss, params + [mc])
        return torch.sqrt(sum((x.double() ** 2).sum() for x in g[:-1])), g[-1].double()

    before = n_launches[mg.NAME]
    tree_k, mat_k = grads()
    assert n_launches[mg.NAME] - before == 8  # two a bounce
    monkeypatch.setattr(mg, "gather", lambda t, i: t[torch.clamp(i, min=0).long()])
    tree_p, mat_p = grads()
    assert n_launches[mg.NAME] - before == 8
    norm_p = float(mat_p.norm())
    assert norm_p > 0 and float(tree_p) > 0
    assert abs(float(mat_k.norm()) - norm_p) <= 1.5e-4 * norm_p
    assert abs(float(tree_k) - float(tree_p)) <= 1.5e-4 * float(tree_p)
    assert float((mat_k - mat_p).abs().max()) <= 1.5e-4 * norm_p
