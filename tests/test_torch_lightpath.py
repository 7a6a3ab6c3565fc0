"""The port's light tracing (wavefront/lightpath.py) against the JAX package
on the CPU: the pinhole projection, SampleLe per light kind, one light
wave's splats, render_lightpath and the FunctionIntegrator.

The scene is test_torch_integrators.py's (the reduced bench scene with a
black emissive quad) plus a point light and an analytic sphere light (with
its tessellated sphere), built by the JAX package and carried across with
`scene_from_numpy`; 16x16, depth 3.

Tolerances: camera_project's pixel equal on every lane, cos and validity
within atol 1e-5 (validity equal); sample_le's position, normal,
direction and beta0 within atol 1e-5 + rtol 1e-5 per light kind (the
area flag equal); a light wave's splats: pixel equal and L within atol
1e-3 + rtol 1e-2 on >= 99% of splats, the sum of splat L within 0.5%, the
rule of tests/test_torch_render.py (the JAX anchor intersects watertight,
the port Moller-Trumbore); render_lightpath's image by the same rule on
its pixels; render_function within atol 1e-6.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from functools import partial

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.core import samplers as j_samplers
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.scatter import lights as j_lights
from nn_bvh_tpu.wavefront import (camera as j_camera, integrator as j_integrator,
                                  lightpath as j_lightpath)
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.scatter import lights
from nn_bvh_tpu_torch.wavefront import camera, integrator, lightpath

from test_torch_integrators import emitter_scene
from test_torch_render import EYE, TARGET, UP

torch.set_num_threads(1)

W = H = 16
R = W * H
DEPTH = 3


def add_lights(b):
    """A point light and an analytic sphere light (with its tessellation)."""
    b.add_point_light((2.5, 4.0, -1.0), (1.0, 0.8, 0.6), scale=6.0)
    black = b.add_material("diffuse", reflectance=(0.0, 0.0, 0.0))
    lid = b.add_sphere_area_light((-2.5, 3.0, 1.0), 0.4, (0.6, 0.8, 1.0), emission_scale=8.0,
                                  n_theta=8)
    b.add_sphere((-2.5, 3.0, 1.0), 0.4, black, n_theta=8, n_phi=16, light_id=lid)


@pytest.fixture(scope="module")
def setup():
    sc, dbvh, _ = j_accel.build_scene_bvh(emitter_scene(j_scene, add_lights))
    jcam = j_camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=50.0, width=W, height=H)
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(jcam.cam_to_world), fov=50.0, width=W, height=H)
    return sc, dbvh, jcam, tsc, tbvh, tcam


def test_scene_has_every_light_kind(setup):
    types = set(np.asarray(setup[0].light_type).tolist())
    assert {j_scene.LIGHT_AREA_TRI, j_scene.LIGHT_POINT, j_scene.LIGHT_SPHERE_AREA} <= types


@pytest.mark.parametrize("aspect", [(16, 16), (24, 12), (12, 20)])
def test_camera_project(setup, aspect):
    jcam = setup[2]._replace(width=aspect[0], height=aspect[1])
    tcam = setup[5]._replace(width=aspect[0], height=aspect[1])
    rs = np.random.RandomState(1)
    p = (rs.rand(600, 3) * np.array([16.0, 8.0, 24.0]) - np.array([8.0, 1.0, 12.0])).astype(
        np.float32)
    jp, jc, jv = (np.asarray(x) for x in j_lightpath.camera_project(jcam, jnp.asarray(p)))
    tp, tc, tv = lightpath.camera_project(tcam, torch.from_numpy(p))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5)
    assert 0.2 < jv.mean() < 0.9  # inside and outside the frustum
    assert tp.min() >= 0 and tp.max() < aspect[0] * aspect[1]


def test_sample_le_per_light_kind(setup):
    sc, _, _, tsc, _, _ = setup
    n_l = int(sc.n_lights)
    rs = np.random.RandomState(2)
    lid = np.tile(np.arange(n_l, dtype=np.int32), 50)
    lam = (380 + 400 * rs.rand(lid.size, 4)).astype(np.float32)
    u_pos, u_dir = (rs.rand(2, lid.size, 2)).astype(np.float32)
    jsc = jax.tree.map(jnp.asarray, sc)
    jout = j_lightpath.sample_le(jsc, j_lights.light_records(jsc), jnp.asarray(lid),
                                 jnp.asarray(lam), jnp.asarray(u_pos), jnp.asarray(u_dir))
    tout = lightpath.sample_le(tsc, lights.light_records(tsc), torch.from_numpy(lid),
                               torch.from_numpy(lam), torch.from_numpy(u_pos),
                               torch.from_numpy(u_dir))
    for name, j, t in zip(("p", "ng", "dir", "beta0"), jout[:4], tout[:4]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    ltype = np.asarray(sc.light_type)[lid]
    for kind in (j_scene.LIGHT_AREA_TRI, j_scene.LIGHT_POINT, j_scene.LIGHT_SPHERE_AREA):
        assert (tout[3].numpy()[ltype == kind] > 0).any(), kind


@pytest.fixture(scope="module")
def light_wave(setup):
    sc, dbvh, jcam, tsc, tbvh, tcam = setup
    jcfg = j_integrator.IntegratorConfig(max_depth=DEPTH)
    tcfg = integrator.IntegratorConfig(max_depth=DEPTH)
    jscfg = j_samplers.make_sampler("independent", seed=3, spp=2, width=W)
    tscfg = samplers.make_sampler("independent", seed=3, spp=2, width=W)
    j = jax.jit(partial(j_lightpath.trace_light_wave, sc, dbvh, jcam, jscfg, jcfg, R))(
        jnp.int32(0))
    t = lightpath.trace_light_wave(tsc, tbvh, tcam, tscfg, tcfg, R, 0)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def test_light_wave_splats_match_jax(light_wave):
    (jpix, jL, jlam, _), (tpix, tL, tlam, _) = light_wave
    assert tpix.shape == jpix.shape == (R * DEPTH,)
    np.testing.assert_allclose(tlam, jlam, rtol=1e-6)
    same = (tpix == jpix) & np.isclose(tL, jL, atol=1e-3, rtol=1e-2).all(-1)
    assert same.mean() >= 0.99, same.mean()
    assert abs(tL.sum() - jL.sum()) <= 0.005 * jL.sum()
    hit = (tL > 0).any(-1)
    assert hit.mean() > 0.02 and (tpix[~hit] == 0).all()  # an unconnected splat: pixel 0, L 0


def test_render_lightpath_matches_jax(setup, light_wave):
    """render_lightpath at 1 spp (wave 0) against the JAX anchor's wave 0
    splatted and developed as the JAX render_lightpath does (scale 1)."""
    from nn_bvh_tpu.wavefront import film as j_film

    _, _, _, tsc, tbvh, tcam = setup
    jf = j_film.add_splats(j_film.make_film(H, W), *(jnp.asarray(x) for x in light_wave[0]))
    img_j = np.asarray(j_film.develop(jf, splat_scale=1.0))
    img_t = lightpath.render_lightpath(tsc, tbvh, tcam, spp=1, sampler="independent", seed=3,
                                       cfg=integrator.IntegratorConfig(max_depth=DEPTH)).numpy()
    assert img_t.shape == (H, W, 3) and np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    px_ok = np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1)
    assert px_ok.mean() >= 0.99, px_ok.mean()


@pytest.mark.parametrize("sampler", ["sobol", "halton", "independent"])
def test_render_function_matches_jax(sampler):
    fn = lambda u, v: u * v + 0.25 * u * u
    j = np.asarray(j_lightpath.render_function(fn, 12, 8, spp=4, sampler=sampler, seed=1))
    t = lightpath.render_function(fn, 12, 8, spp=4, sampler=sampler, seed=1, device="cpu")
    assert t.shape == (8, 12) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6)


def test_light_record_index_is_clamped():
    """Field 8 of a sphere light's record is its radius, which the area-
    triangle branches read as a triangle index on every lane: a radius past
    the triangle table must gather its last row, as XLA clamps a gather
    (an unclamped index stops the card), not raise."""
    b = scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m,
               emission_rgb=(1, 1, 1), emission_scale=2.0)
    b.add_sphere_area_light((0, 400, 0), 300.0, (1.0, 1.0, 1.0))
    tsc = scene.to_device(b.build(), "cpu")
    assert tsc.tri_shade.shape[0] < 300
    rec = lights.light_records(tsc)
    lid = torch.arange(rec.shape[0]).repeat(8)
    u = torch.rand(lid.shape[0], 2, generator=torch.Generator().manual_seed(0))
    lam = torch.full((lid.shape[0], 4), 550.0)
    out = lightpath.sample_le(tsc, rec, lid, lam, u, u.flip(-1))
    assert bool(torch.isfinite(out[3]).all()) and bool((out[3] > 0).any())
    ls = lights.sample_li(tsc, rec, lid, torch.tensor([[0.0, 1.0, 0.0]]).expand(lid.shape[0], 3),
                          lam, u)
    assert bool(torch.isfinite(ls.pdf).all())
