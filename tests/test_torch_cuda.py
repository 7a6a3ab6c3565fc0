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
from nn_bvh_tpu_torch.accel import binary, binary_kernel, bvh4_kernel, dispatch, traverse
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
    nodes = torch.as_tensor(binary.pack_binary_cuda(db.node_lo, db.node_hi, db.node_meta, 128),
                            device="cuda")
    tris = torch.as_tensor(tri, device="cuda")
    rays = bench_scene.deep_tree_rays(100, 20000)
    o, d, t_max = (torch.as_tensor(x, device="cuda") for x in rays)
    hk = binary_kernel.traverse(nodes, tris, o, d, t_max, False, stack=128)
    hp = traverse.traverse_binary_plain(nodes, tris, o, d, t_max, False, 128)
    hb = traverse.intersect_brute(tris, o, d, t_max)
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


def _lab_inputs():
    from nn_bvh_tpu_torch.tools import kernel_lab  # noqa: F401  (imports no JAX)

    sc, dbvh = _scene()
    tables = dispatch.make_intersectors(sc, dbvh, "cuda", backend="cuda_binary").tables
    return tables, _rays("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(LAB_VARIANTS))
def test_lab_kernel_matches_plain(variant):
    _need_card()
    from nn_bvh_tpu_torch.tools import kernel_lab

    tables, rays = _lab_inputs()
    kw = LAB_VARIANTS[variant]
    before = n_launches["lab_traverse"]
    out = kernel_lab.lab_traverse(*tables, *rays, **kw)
    torch.cuda.synchronize()
    assert n_launches["lab_traverse"] == before + 1
    ref = kernel_lab.lab_traverse_plain(*tables, *rays, **kw)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and torch.equal(a, b)
    if kw.get("count"):
        assert int(out[2].min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_when", [False, True])
def test_brless_kernel_matches_plain(leaf_when):
    _need_card()
    from nn_bvh_tpu_torch.tools import kernel_lab

    tables, rays = _lab_inputs()
    out = kernel_lab.brless_traverse(*tables, *rays, rows=16, leaf_when=leaf_when)
    ref = kernel_lab.brless_traverse_plain(*tables, *rays, rows=16, leaf_when=leaf_when)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert not out[2].any() and not out[3].any()
    lab = kernel_lab.lab_traverse(*tables, *rays, rows=16)
    assert torch.equal(lab[1], out[1]) and torch.equal(lab[0], out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("with_load,with_slab", [(False, False), (True, False), (True, True)])
def test_floor_kernel_matches_plain(with_load, with_slab):
    _need_card()
    from nn_bvh_tpu_torch.tools import kernel_lab

    rs = np.random.RandomState(2)
    nodes = torch.as_tensor(rs.randn(17100, 8).astype(np.float32), device="cuda")
    ox = torch.as_tensor(rs.randn(4096).astype(np.float32), device="cuda")
    for rows, n_iter in ((8, 100), (32, 3000)):
        out = kernel_lab.floor_bench(nodes, ox, n_iter=n_iter, with_load=with_load,
                                     with_slab=with_slab, rows=rows)
        ref = kernel_lab.floor_bench_plain(nodes, ox, n_iter=n_iter, with_load=with_load,
                                           with_slab=with_slab, rows=rows)
        assert out.shape == (rows, 128) and torch.equal(out, ref)
    with pytest.raises(ValueError, match="17023"):
        kernel_lab.floor_bench(nodes[:17000].contiguous(), ox, n_iter=10)


@pytest.mark.cuda
def test_lab_kernel_raises_on_stack_overflow():
    _need_card()
    from nn_bvh_tpu_torch.tools import kernel_lab

    tri, db = bench_scene.build_widening_tree(20)
    nodes = torch.as_tensor(binary.pack_binary_cuda(db.node_lo, db.node_hi, db.node_meta),
                            device="cuda")
    tris = torch.as_tensor(tri, device="cuda")
    o, d, t_max = (torch.as_tensor(x, device="cuda") for x in bench_scene.widening_tree_rays(2048))
    for k_pop in (1, 2):
        out = kernel_lab.lab_traverse(nodes, tris, o, d, t_max, rows=8, k_pop=k_pop, count=True)
        ref = kernel_lab.lab_traverse_plain(nodes, tris, o, d, t_max, rows=8, k_pop=k_pop,
                                            count=True)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(kernel_lab.StackOverflow):
        kernel_lab.lab_traverse(nodes, tris, o, d, t_max, rows=8, k_pop=4)
