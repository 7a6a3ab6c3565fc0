"""Whole Path waves through the port's new materials against the JAX CPU
anchor (`integrator.trace_wave`, jitted, XLA traversal) on the same
JAX-built scenes, carried across with `scene_from_numpy`: 16x16, Sobol
4 spp, seed 0, depth 4, rr_depth 2, MIS.

- A scene of glass (smooth dielectric), a mix of diffuse and conductor,
  spectral gold (metal-Au-eta / metal-Au-k), hair (with sphere uvs) and a
  measured GGX table, over a diffuse floor under an emissive quad.
- tests/test_bssrdf.py's subsurface sphere: every bounce makes N_PROBE = 3
  extra closest-hit calls (wavefront/subsurface.py).

Thresholds of tests/test_torch_render.py, applied per sample as
tests/test_torch_volpath.py does on its media-free scene: >= 99% of the
1,024 lanes within atol 1e-3 + rtol 1e-2, and the image mean within 0.5%.
The anchor intersects with the watertight `triangle.intersect`, the port
with Moller-Trumbore: a lane whose ray flips at an edge (a camera ray, a
shadow ray or a subsurface probe) diverges from there on.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.core import samplers as j_samplers
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.wavefront import camera as j_camera, film as j_film, integrator as j_integrator
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.scatter import measured
from nn_bvh_tpu_torch.tools import bench_scene
from nn_bvh_tpu_torch.wavefront import camera, film, integrator

torch.set_num_threads(1)

RES = 16
SPP = 4
CFG = dict(max_depth=4, rr_depth=2, mis=True)


def spectral_scene():
    """Glass, mix, spectral gold, hair and measured spheres, JAX-built."""
    b = j_scene.SceneBuilder()
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    diffuse = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    mats = [b.add_material("dielectric", eta=1.5),
            b.add_material("mix", mix_materials=(diffuse, metal), mix_amount=0.5),
            b.add_material("conductor", reflectance=(1, 1, 1), roughness=0.1,
                           eta_spectrum="metal-Au-eta", k_spectrum="metal-Au-k"),
            b.add_material("hair", reflectance=(0.4, 0.25, 0.1), roughness=0.3, eta=1.55),
            b.add_material("measured", measured=b.add_measured_brdf(
                measured.tabulate(bench_scene.ggx_rgb, (8, 8, 8))))]
    uvs = bench_scene.sphere_uvs(8, 16)
    for i, m in enumerate(mats):
        b.add_sphere((-2.0 + 1.0 * i, 0.45, 0.3 * (i % 2)), 0.45, m, n_theta=8, n_phi=16,
                     uvs=uvs)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), floor)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), floor,
               emission_rgb=(1, 1, 1), emission_scale=8.0, two_sided=True)
    return b.build(), j_xf.look_at((0, 1.4, -4.0), (0, 0.45, 0), (0, 1, 0)), 50.0


def subsurface_scene():
    """tests/test_bssrdf.py's sss_scene, JAX-built."""
    b = j_scene.SceneBuilder()
    sss = b.add_material("subsurface", sigma_a=(0.02, 0.04, 0.07),
                         sigma_s=(2.2, 2.6, 3.0), sss_scale=2.0, eta=1.33)
    floor = b.add_material("diffuse", reflectance=(0.4, 0.4, 0.4))
    b.add_sphere((0, 0.7, 0), 0.7, sss, n_theta=12, n_phi=24)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), floor)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), floor,
               emission_rgb=(1, 1, 1), emission_scale=10.0, two_sided=True)
    return b.build(), j_xf.look_at((0, 1.6, -3.2), (0, 0.7, 0), (0, 1, 0)), 45.0


def lanes_both(built):
    """The scene wave by wave through both packages' trace_wave -> (JAX L
    per lane and sample, port L, JAX image, port image, port scene)."""
    sc, c2w, fov = built
    sc, dbvh, _ = j_accel.build_scene_bvh(sc)
    R = RES * RES
    jcam = j_camera.make_perspective(c2w, fov=fov, width=RES, height=RES)
    jcfg = j_integrator.IntegratorConfig(use_pallas=False, **CFG)
    jscfg = j_samplers.make_sampler("sobol", seed=0, spp=SPP, width=RES)
    jpix = jnp.arange(R, dtype=jnp.int32)
    jwave = jax.jit(lambda s: j_integrator.trace_wave(sc, dbvh, jcam, jscfg, jcfg, jpix, s))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(c2w), fov=fov, width=RES, height=RES)
    tscfg = samplers.make_sampler("sobol", seed=0, spp=SPP, width=RES)
    tcfg = integrator.IntegratorConfig(**CFG)
    tpix = torch.arange(R, dtype=torch.int32)
    jf, tf = j_film.make_film(RES, RES), film.make_film(RES, RES, "cpu")
    lj, lt = [], []
    for s in range(SPP):
        jout = jwave(jnp.int32(s))
        tout = integrator.trace_wave(tsc, tbvh, tcam, tscfg, tcfg, tpix, s)
        jf = j_film.add_samples(jf, jpix, *jout[:3], filter_weight=jout[3], sequential=True)
        tf = film.add_samples(tf, tpix, *tout[:3], filter_weight=tout[3], sequential=True)
        lj.append(np.asarray(jout[0]))
        lt.append(tout[0].numpy())
    return (np.concatenate(lj), np.concatenate(lt), np.asarray(j_film.develop(jf)),
            film.develop(tf).numpy(), tsc)


def assert_lanes_match(lane_j, lane_t, img_j, img_t):
    assert np.isfinite(lane_t).all() and np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean()), \
        (img_t.mean(), img_j.mean())
    lane_ok = np.isclose(lane_t, lane_j, atol=1e-3, rtol=1e-2).all(-1)
    assert lane_ok.mean() >= 0.99, lane_ok.mean()


@pytest.fixture(scope="module")
def spectral_lanes():
    return lanes_both(spectral_scene())


@pytest.fixture(scope="module")
def subsurface_lanes():
    return lanes_both(subsurface_scene())


def test_spectral_scene_matches_jax(spectral_lanes):
    lane_j, lane_t, img_j, img_t, tsc = spectral_lanes
    assert tsc.feat_mix and tsc.feat_hair and tsc.feat_measured and tsc.feat_spectral
    assert not tsc.feat_coated and not tsc.feat_subsurface
    assert_lanes_match(lane_j, lane_t, img_j, img_t)


def test_subsurface_scene_matches_jax(subsurface_lanes):
    lane_j, lane_t, img_j, img_t, tsc = subsurface_lanes
    assert tsc.feat_subsurface
    assert_lanes_match(lane_j, lane_t, img_j, img_t)


def test_subsurface_probes_go_through_the_traversal(subsurface_lanes, monkeypatch):
    """A subsurface scene makes N_PROBE closest-hit calls a bounce beside
    the camera, shadow and bounce calls. VolPath runs no subsurface stage
    (nor does the JAX package's) and ends its subsurface lanes there."""
    from nn_bvh_tpu_torch.accel import dispatch
    from nn_bvh_tpu_torch.wavefront import subsurface, volpath

    tsc = subsurface_lanes[-1]
    sc, c2w, fov = subsurface_scene()
    _, dbvh, _ = j_accel.build_scene_bvh(sc)
    tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")[1]
    cam = camera.make_perspective(np.asarray(c2w), fov=fov, width=8, height=8)
    scfg = samplers.make_sampler("sobol", seed=0, spp=1)
    cfg = integrator.IntegratorConfig(max_depth=2, rr_depth=2)
    isect = dispatch.make_intersectors(tsc, tbvh, "cpu")
    pix = torch.arange(64, dtype=torch.int32)
    calls = []
    transition = subsurface.transition
    monkeypatch.setattr(subsurface, "transition",
                        lambda *a, **kw: calls.append(1) or transition(*a, **kw))
    integrator.trace_wave(tsc, tbvh, cam, scfg, cfg, pix, 0, isect=isect)
    # camera; per bounce the probes, a shadow ray and the next closest hit
    assert len(calls) == 2 and isect.n_calls == 1 + 2 * (subsurface.N_PROBE + 2)
    L = volpath.trace_wave_vol(tsc, tbvh, cam, scfg, cfg._replace(kind="volpath"), pix, 0,
                               isect=isect)[0]
    assert len(calls) == 2 and torch.isfinite(L).all()
