"""Parity of the torch port's accel/ (and its scene builder) against the
JAX package on the CPU (the kernel-vs-plain tests that need a card are in
tests/test_torch_cuda.py, which imports no JAX).

Tolerances: scene tables, the SAH build and the packed BVH4 table are
identical (mat_coeffs / light_scale atol 1e-6: the same numpy fit). The
plain BVH4 traversal must return the same prim on every live lane as the
XLA anchor (traverse.intersect_*) and as pallas_bvh4 in interpret mode, with
t within atol 1e-4 + rtol 1e-5 (tests/test_pallas_interpret.py:65-79).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.accel import (traverse as j_traverse, pallas_bvh4 as j_pbvh4,
                              bvh4 as j_bvh4, build as j_build)
from nn_bvh_tpu.geometry import scene as j_scene
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.accel import (build, bvh4, bvh4_kernel, dispatch,
                                    kernel_launch, traverse)
from nn_bvh_tpu_torch.geometry import scene

torch.set_num_threads(1)


def reduced_bench_scene(mod):
    """bench.py's materials, floor and emissive quad, 6 coarse spheres."""
    rs = np.random.RandomState(42)
    b = mod.SceneBuilder()
    diffuse = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    for i in range(6):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        r = 0.25 + 0.45 * rs.rand()
        b.add_sphere(c, r, metal if i % 3 == 0 else diffuse, n_theta=8, n_phi=16)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), floor)
    b.add_quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2), floor,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=20.0, two_sided=True)
    return b.build()


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
def port_isect(small_scene):
    sc, dbvh = small_scene
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    return dispatch.make_intersectors(tsc, tbvh, "cpu")


@pytest.fixture(scope="module")
def port_hits(port_isect, ray_batch):
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    return port_isect.closest(o, d, t_max), port_isect.any_hit(o, d, t_max).numpy()


def _check_closest(prim_ref, t_ref, hit, t_max):
    live = t_max > 0
    prim = hit.prim.numpy()
    assert hit.prim.dtype == torch.int32 and hit.t.dtype == torch.float32
    assert (prim[live] == np.asarray(prim_ref)[live]).all()
    assert (prim[~live] == -1).all() and np.isinf(hit.t.numpy()[~live]).all()
    tn = np.nan_to_num(hit.t.numpy(), posinf=0.0)
    tr = np.nan_to_num(np.asarray(t_ref), posinf=0.0)
    np.testing.assert_allclose(tn[live], tr[live], atol=1e-4, rtol=1e-5)


def _check_any(occ, occ_ref, t_max):
    live = t_max > 0
    assert (occ[live] == np.asarray(occ_ref)[live]).all()
    assert occ[t_max < 0].all()  # dead any-hit lanes report occluded (TPU kernel)


def _jax_args(small_scene, ray_batch):
    sc, dbvh = small_scene
    return (jax.tree.map(jnp.asarray, dbvh), jnp.asarray(sc.tri_p),
            *map(jnp.asarray, ray_batch))


def test_plain_closest_matches_xla_anchor(small_scene, ray_batch, port_hits):
    h = j_traverse.intersect_closest(*_jax_args(small_scene, ray_batch))
    _check_closest(h.prim, h.t, port_hits[0], ray_batch[2])


def test_plain_any_matches_xla_anchor(small_scene, ray_batch, port_hits):
    occ = j_traverse.intersect_any(*_jax_args(small_scene, ray_batch))
    _check_any(port_hits[1], occ, ray_batch[2])


def test_plain_closest_matches_pallas_interpret(small_scene, ray_batch, port_hits):
    h = j_pbvh4.intersect_closest(*_jax_args(small_scene, ray_batch), interpret=True)
    _check_closest(h.prim, h.t, port_hits[0], ray_batch[2])


def test_plain_any_matches_pallas_interpret(small_scene, ray_batch, port_hits):
    occ = j_pbvh4.intersect_any(*_jax_args(small_scene, ray_batch), interpret=True)
    _check_any(port_hits[1], occ, ray_batch[2])
    live = ray_batch[2] > 0
    assert (port_hits[1][live] == np.asarray(occ)[live]).all()


def test_brute_oracle_matches_plain(small_scene, ray_batch, port_hits):
    sc, _ = small_scene
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    hb = traverse.intersect_brute(torch.as_tensor(np.asarray(sc.tri_p)), o, d, t_max,
                                  chunk=512)
    h = port_hits[0]
    assert torch.equal(hb.prim, h.prim)
    assert torch.equal(hb.t, h.t)


def test_wrapper_runs_plain_for_cpu_tensors(port_isect, ray_batch, port_hits):
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    before = dict(kernel_launch.n_launches)
    h = bvh4_kernel.traverse(*port_isect.tables, o, d, t_max, False)
    assert dict(kernel_launch.n_launches) == before  # no kernel launch on the CPU
    assert torch.equal(h.prim, port_hits[0].prim) and torch.equal(h.t, port_hits[0].t)


@pytest.fixture(scope="module")
def record_tables(port_isect):
    """The plain backend's tables with the triangles as the CUDA kernel's
    16-byte records."""
    nodes, tris = port_isect.tables
    return nodes, torch.as_tensor(bvh4.pack_tris_cuda(tris.numpy()))


def test_pack_tris_cuda_records(small_scene):
    sc, _ = small_scene
    tri_p = np.asarray(sc.tri_p)
    rec = bvh4.pack_tris_cuda(tri_p)
    assert rec.dtype == np.float32 and rec.shape == (len(tri_p), 3, 4)
    p = torch.as_tensor(tri_p, dtype=torch.float32)
    assert (rec[:, :, 3] == 0).all()  # pads zero
    np.testing.assert_array_equal(rec[:, 0, :3].view(np.uint32), tri_p[:, 0].view(np.uint32))
    for row, k in ((1, 1), (2, 2)):
        edge = (p[:, k] - p[:, 0]).numpy()  # one float32 rounding, as the kernel did
        np.testing.assert_array_equal(rec[:, row, :3].view(np.uint32), edge.view(np.uint32))
    # float64 input is rounded to float32 first, then subtracted in float32
    np.testing.assert_array_equal(bvh4.pack_tris_cuda(tri_p.astype(np.float64)).view(np.uint32),
                                  rec.view(np.uint32))


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_records_equal_vertices(port_isect, record_tables, ray_batch, any_hit):
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    a = traverse.traverse_bvh4_plain(*port_isect.tables, o, d, t_max, any_hit)
    b = traverse.traverse_bvh4_plain(*record_tables, o, d, t_max, any_hit)
    if any_hit:
        assert torch.equal(a, b)
    else:
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_plain_records_match_xla_anchor(small_scene, ray_batch, record_tables):
    o, d, t_max = (torch.from_numpy(x) for x in ray_batch)
    h = j_traverse.intersect_closest(*_jax_args(small_scene, ray_batch))
    _check_closest(h.prim, h.t, traverse.traverse_bvh4_plain(*record_tables, o, d, t_max, False),
                   ray_batch[2])
    occ = j_traverse.intersect_any(*_jax_args(small_scene, ray_batch))
    _check_any(traverse.traverse_bvh4_plain(*record_tables, o, d, t_max, True).numpy(), occ,
               ray_batch[2])


def test_port_scene_builder_matches_jax():
    js, ts = reduced_bench_scene(j_scene), reduced_bench_scene(scene)
    assert ts.n_tris == js.n_tris == 1348 and ts.n_lights == js.n_lights == 2
    for name in ("tri_p", "tri_shade", "tri_n", "tri_uv", "tri_mat", "tri_light",
                 "mat_type", "mat_params", "light_type", "light_params", "bounds"):
        np.testing.assert_array_equal(getattr(ts, name), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in ("mat_coeffs", "mat_scale", "light_coeffs", "light_scale"):
        np.testing.assert_allclose(getattr(ts, name), np.asarray(getattr(js, name)),
                                   atol=1e-6, err_msg=name)


def test_build_sah_identical(small_scene):
    sc, _ = small_scene
    lo, hi = j_build.triangle_bounds(np.asarray(sc.tri_p)[:sc.n_tris])
    a, b = j_build.build_sah(lo, hi), build.build_sah(lo, hi)
    assert a.n_nodes == b.n_nodes
    for f in ("node_lo", "node_hi", "node_meta", "prim_order"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_build_scene_bvh_reorders_like_jax():
    """Port build (numpy SAH) vs the JAX package's numpy SAH path."""
    js, ts = reduced_bench_scene(j_scene), reduced_bench_scene(scene)
    j_sc, j_dbvh, _ = j_accel.build_scene_bvh(js, method="sah_numpy")
    t_sc, t_dbvh, _ = accel.build_scene_bvh(ts, method="sah_numpy")
    for name in ("tri_p", "tri_shade", "light_params"):
        np.testing.assert_array_equal(getattr(t_sc, name), np.asarray(getattr(j_sc, name)))
    np.testing.assert_array_equal(t_dbvh.node_meta, np.asarray(j_dbvh.node_meta))


def test_pack_bvh4_bit_identical(small_scene):
    _, dbvh = small_scene
    args = [np.asarray(x) for x in (dbvh.node_lo, dbvh.node_hi, dbvh.node_meta)]
    jw, tw = j_bvh4.collapse_bvh4(*args), bvh4.collapse_bvh4(*args)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(a, b)
    assert bvh4.wide_depth(tw[2]) == j_bvh4.wide_depth(jw[2])
    np.testing.assert_array_equal(j_bvh4.pack_bvh4(*jw).view(np.uint32),
                                  bvh4.pack_bvh4(*tw).view(np.uint32))


def test_cuda_layout_decodes_tpu_bounds(small_scene):
    """The kernel's f32 bounds are exactly the TPU table's bf16 pairs."""
    _, dbvh = small_scene
    wl, wh, wm = bvh4.collapse_bvh4(*[np.asarray(x) for x in
                                      (dbvh.node_lo, dbvh.node_hi, dbvh.node_meta)])
    tab = bvh4.pack_bvh4(wl, wh, wm).reshape(-1, 8, 128).view(np.uint32)
    rec = bvh4.pack_bvh4_cuda(wl, wh, wm)
    n = np.arange(len(wl))
    for c in range(4):
        col = (n % 64) * 2 + c % 2
        rows = 4 * (c // 2)
        for ax in range(3):
            u = tab[n // 64, rows + ax, col]
            assert (rec[:, c, ax].view(np.uint32) == (u & 0xFFFF0000)).all()
            assert (rec[:, c, 3 + ax].view(np.uint32) == (u << 16).astype(np.uint32)).all()
        assert (rec[:, c, 6].view(np.int32) == wm[:, c]).all()
    assert (rec[..., 0:3] <= wl).all() and (rec[..., 3:6] >= wh).all()


def test_packer_raises_on_deep_tree():
    W = 25  # a chain of wide nodes: depth 25, 3*25+4 >= 64 stack entries
    lo = np.zeros((W, 4, 3), np.float32)
    hi = np.ones((W, 4, 3), np.float32)
    meta = np.full((W, 4), -1, np.int64)  # leaves of one triangle
    meta[:-1, 0] = np.arange(1, W)
    with pytest.raises(ValueError, match="stack"):
        bvh4.pack_bvh4_cuda(lo, hi, meta)
    bvh4.pack_bvh4_cuda(lo[:19], hi[:19], np.where(meta[:19] >= 19, -1, meta[:19]))


def test_packer_raises_on_leaf_over_8():
    tri = np.random.RandomState(0).rand(9, 3, 3).astype(np.float32)
    lo, hi = build.triangle_bounds(tri)
    b = build.build_sah(lo, hi, max_leaf=9)  # one leaf of 9 triangles
    wl, wh, wm = bvh4.collapse_bvh4(b.node_lo, b.node_hi, b.node_meta)
    with pytest.raises(ValueError, match="at most 8"):
        bvh4.pack_bvh4_cuda(wl, wh, wm)


def test_dispatch_backend_follows_device(small_scene):
    sc, dbvh = small_scene
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    assert dispatch.make_intersectors(tsc, tbvh, "cpu").backend == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.make_intersectors(tsc, tbvh, "cpu", backend="cuda_bvh4")
    with pytest.raises(ValueError, match="unknown"):
        dispatch.make_intersectors(tsc, tbvh, "cpu", backend="xla")


def test_scene_from_numpy_refuses_unported_features():
    """Textures (a textured material, a texture-driven mix amount) and the
    two lights that read the texture atlas (projection, goniometric) come
    across with their tables; what the port does not know (a material or
    light tag beyond the JAX package's) is refused."""
    def jax_scene(feature):
        b = j_scene.SceneBuilder()
        m = b.add_material("diffuse")
        if feature == "texture":
            m = b.add_material("diffuse", texture=b.add_texture_checker())
        elif feature == "mix_texture_amount":
            m = b.add_material("mix", mix_materials=(m, m), mix_amount=-1.0)
        elif feature == "projection_light":
            b.add_projection_light((0, 2, 0), (0, -1, 0), np.ones((4, 4, 3), np.float32))
        else:
            b.add_goniometric_light((0, 2, 0), np.ones((4, 4, 3), np.float32))
        b.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), m)
        sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
        return sc, dbvh

    for feature in ("texture", "mix_texture_amount", "projection_light", "goniometric_light"):
        sc, dbvh = jax_scene(feature)
        tsc, _ = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
        for name in ("tex_atlas", "tex_desc", "mat_params", "light_type", "light_params"):
            np.testing.assert_array_equal(getattr(tsc, name).numpy(),
                                          np.asarray(getattr(sc, name)), err_msg=name)
        assert tsc.tex_desc.dtype == torch.int32
    fields = sc._asdict()
    for name, tag in (("mat_type", scene.MAT_SUBSURFACE + 1),
                      ("light_type", scene.LIGHT_SPHERE_AREA + 1)):
        bad = dict(fields, **{name: np.full_like(np.asarray(fields[name]), tag)})
        with pytest.raises(NotImplementedError, match="unknown"):
            scene.scene_from_numpy(bad, dbvh._asdict(), "cpu")
    assert scene.SceneBuilder().add_material("diffuse", texture=0) == 0
