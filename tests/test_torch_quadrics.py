"""The port's analytic quadrics against the JAX package on the CPU: sphere,
disk, cylinder and bilinear patch intersection, any-hit and shading, one
kind at a time on rays from a seed, and the dispatch's min-t merge of the
quadrics onto the triangle traversal against the JAX package's XLA
Intersectors on a scene of both (the same prims, carried across with
scene_from_numpy).

Tolerances: t, u, v, position and normal to rtol 1e-5 / atol 1e-5 on
every hit lane; hit index and any-hit equal on every lane, dead lanes
miss. The merged intersector: prim equal on >= 99.9% of the lanes (the JAX
CPU anchor tests triangles watertight, the port by Moller-Trumbore, as
tests/test_torch_render.py allows), t to rtol 1e-5 and a quadric hit's
u, v to the tolerance above where prim agrees; any-hit equal on >= 99.9%
of the live lanes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.accel import dispatch as j_dispatch
from nn_bvh_tpu.geometry import quadrics as j_quadrics, scene as j_scene
from nn_bvh_tpu_torch.accel import dispatch
from nn_bvh_tpu_torch.geometry import quadrics, scene

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N = 2048

RECORDS = {
    "sphere": lambda m: m.make_record("sphere", (0.2, 0.5, -0.3), 0.8),
    "disk": lambda m: m.make_record("disk", (0.0, 0.3, 0.0), 1.0, axis=(0.2, 1.0, 0.1),
                                    inner_radius=0.3),
    "cylinder": lambda m: m.make_record("cylinder", (0.1, 0.0, 0.2), 0.5, axis=(0, 1, 0.3),
                                        zmin=-0.4, zmax=0.9),
    "partial sphere": lambda m: m.make_record("sphere", (0.0, 0.4, 0.0), 0.7, zmin=-0.3,
                                              zmax=0.5),
    "bilinear": lambda m: m.make_bilinear_record((-1, 0, -1), (1, 0.4, -1), (-1, 0.6, 1),
                                                 (1, -0.2, 1)),
}


def rays(seed: int, n: int = N):
    """Origins on a shell around the unit box aimed at points inside it,
    a tenth of the lanes dead, a tenth with a short t_max."""
    rs = np.random.RandomState(seed)
    o = rs.randn(n, 3)
    o = (3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    target = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    t_max[rs.rand(n) < 0.1] = -1.0
    short = rs.rand(n) < 0.1
    t_max[short] = rs.uniform(1.0, 3.5, short.sum())
    return o, d.astype(np.float32), t_max


def tables(kind):
    qt, qp = RECORDS[kind](j_quadrics)
    tqt, tqp = RECORDS[kind](quadrics)
    assert qt == tqt
    np.testing.assert_array_equal(qp, tqp)
    jq = (jnp.asarray([qt], jnp.int32), jnp.asarray(qp[None]))
    tq = (torch.tensor([qt], dtype=torch.int32), torch.from_numpy(qp[None]))
    return jq, tq


@pytest.mark.parametrize("kind", list(RECORDS))
def test_intersect_and_shading_match_jax(kind):
    jq, tq = tables(kind)
    o, d, t_max = rays(list(RECORDS).index(kind))
    jt, ji, ju, jv = j_quadrics.intersect(*jq, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    tt, ti, tu, tv = quadrics.intersect(*tq, torch.from_numpy(o), torch.from_numpy(d),
                                        torch.from_numpy(t_max))
    ji = np.asarray(ji)
    np.testing.assert_array_equal(ji, ti.numpy())
    hit = ji >= 0
    assert 0.1 < hit.mean() < 0.9, hit.mean()
    assert not hit[t_max < 0].any()  # dead lanes miss
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit], **TOL)
    np.testing.assert_allclose(tu.numpy()[hit], np.asarray(ju)[hit], **TOL)
    np.testing.assert_allclose(tv.numpy()[hit], np.asarray(jv)[hit], **TOL)
    np.testing.assert_array_equal(
        np.asarray(j_quadrics.intersect_any(*jq, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(t_max))),
        quadrics.intersect_any(*tq, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(t_max)).numpy())
    idx = np.zeros(N, np.int32)
    jp, jn = j_quadrics.shading(*jq, jnp.asarray(idx), jnp.asarray(o), jnp.asarray(d), jt,
                                u=ju, v=jv)
    tp, tn = quadrics.shading(*tq, torch.from_numpy(idx), torch.from_numpy(o),
                              torch.from_numpy(d), tt, u=tu, v=tv)
    np.testing.assert_allclose(tp.numpy()[hit], np.asarray(jp)[hit], **TOL)
    np.testing.assert_allclose(tn.numpy()[hit], np.asarray(jn)[hit], **TOL)


def test_bounds_and_uv_scale_match_jax():
    for kind in RECORDS:
        qt, qp = RECORDS[kind](j_quadrics)
        for a, b in zip(quadrics.bounds(qt, qp), j_quadrics.bounds(qt, qp)):
            np.testing.assert_array_equal(a, b)
    qts = np.array([RECORDS[k](j_quadrics)[0] for k in RECORDS], np.int32)
    qps = np.stack([RECORDS[k](j_quadrics)[1] for k in RECORDS])
    np.testing.assert_array_equal(quadrics.uv_scale(qts, qps), j_quadrics.uv_scale(qts, qps))


def quadric_scene(mod):
    """A floor, a tessellated sphere and an emissive quad with the four
    analytic kinds, one of them a light's shape."""
    b = mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.2)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_sphere((1.4, 0.5, 0.8), 0.5, m, n_theta=8, n_phi=16)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=8.0, two_sided=True)
    b.add_quadric("sphere", (-1.0, 0.6, 0.0), 0.6, metal)
    b.add_quadric("disk", (0.5, 0.01, -1.5), 0.7, m, axis=(0, 1, 0), inner_radius=0.2)
    b.add_quadric("cylinder", (0.3, 0.0, 0.2), 0.3, m, axis=(0, 1, 0), zmin=0.0, zmax=1.2)
    b.add_bilinear_patch((-2, 0.2, 1.5), (-0.5, 0.8, 1.5), (-2, 1.2, 2.5), (-0.5, 0.3, 2.5), m)
    return b.build()


@pytest.fixture(scope="module")
def merged():
    sc, dbvh, _ = j_accel.build_scene_bvh(quadric_scene(j_scene))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    return sc, dbvh, tsc, tbvh


def test_builders_match_jax():
    """The quadric tables and the appended tri_shade rows the two builders
    write."""
    sc = quadric_scene(j_scene)
    psc = quadric_scene(scene)
    assert psc.n_quadrics == sc.n_quadrics == 4
    for f in ("quad_type", "quad_params", "quad_uv_scale", "quad_mat", "quad_light",
              "quad_med", "tri_shade", "bounds"):
        np.testing.assert_array_equal(getattr(psc, f), np.asarray(getattr(sc, f)), err_msg=f)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_dispatch_merge_matches_jax(merged, any_hit):
    sc, dbvh, tsc, tbvh = merged
    o, d, t_max = rays(11, 4096)
    o = o * np.array([1.3, 1.0, 1.3], np.float32) + np.array([0, 1.2, 0], np.float32)
    jis = j_dispatch.make_intersectors(sc, dbvh, use_pallas=False)
    tis = dispatch.make_intersectors(tsc, tbvh, "cpu")
    assert tis.quad_base == jis.quad_base == sc.tri_p.shape[0]
    args_j = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    args_t = tuple(map(torch.from_numpy, (o, d, t_max)))
    if any_hit:
        # a dead lane is occluded in the port (the TPU kernels' contract),
        # not in the XLA anchor; the integrator masks those lanes either way
        ja = np.asarray(jis.any_hit(*args_j))
        ta = tis.any_hit(*args_t).numpy()
        live = t_max >= 0
        assert (ja == ta)[live].mean() >= 0.999
        assert ta[~live].all()
        assert 0.1 < ta[live].mean() < 0.95
        return
    jh, th = jis.closest(*args_j), tis.closest(*args_t)
    jp, tp = np.asarray(jh.prim), th.prim.numpy()
    same = jp == tp
    assert same.mean() >= 0.999, same.mean()
    is_q = tp >= tis.quad_base
    assert 0.05 < is_q.mean() and (tp[t_max < 0] == -1).all()
    hit = same & (tp >= 0)
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-5)
    qh = same & is_q
    np.testing.assert_allclose(th.b1.numpy()[qh], np.asarray(jh.b1)[qh], **TOL)
    np.testing.assert_allclose(th.b2.numpy()[qh], np.asarray(jh.b2)[qh], **TOL)


def test_sorted_merge_equals_unsorted(merged):
    """The merge runs after the sorted intersector's unsort."""
    _, _, tsc, tbvh = merged
    o, d, t_max = map(torch.from_numpy, rays(12, 4096))
    o = o + torch.tensor([0, 1.2, 0])
    a = dispatch.make_intersectors(tsc, tbvh, "cpu").closest(o, d, t_max)
    b = dispatch.make_intersectors(tsc, tbvh, "cpu", sort=True).closest(o, d, t_max)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
