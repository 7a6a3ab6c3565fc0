"""VolPath through a glass sphere that holds fog, and whole-wave gradients
through glass, against the JAX package on the CPU.

- The glass fog scene (`bench_scene.build_fog_scene(interface="glass")`,
  JAX-built: a smooth dielectric sphere, eta 1.33, whose inside is the
  homogeneous fog, a floor and an emissive quad), 16x16, Sobol 4 spp, seed
  0, VolPath depth 6, rr_depth 2, wave by wave through both packages'
  trace_wave_vol: >= 99% of the lanes of each sample within atol 1e-3 +
  rtol 1e-2 and the image mean within 0.5% (tests/test_torch_volpath.py's
  rule). Rays reach the fog only by real transmission through the glass:
  the port counts the lanes whose BSDF sample transmits (the medium
  change of volpath.bounce) and the lanes that scatter in the fog, both
  > 0.
- The port's phased wave against its whole-wave trace on the same scene
  at 24x24 (atol and rtol 1e-5).
- Gradients through glass: d sum(film.xyz)/R / d (mat_coeffs,
  light_scale) of one Path wave (4x4, Sobol 4 spp, depth 3, rr_depth 99)
  through a glass sphere over a diffuse floor, against jax.grad (eager, as
  tests/test_torch_grad.py): the whole loss within rtol 2e-2 + atol 2e-4,
  the lanes whose forward values agree within rtol 1e-3 + atol 1e-6.
- slow: the same through a coated-diffuse and a glass sphere (4x4, depth
  2, one wave): an eager JAX VJP through the layered walk takes 5-10
  minutes on the CPU. Finite, and equal to jax.grad over the agreeing lanes
  (a lane that shades a coated surface draws other numbers in the two
  packages: tests/test_torch_coated_render.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.core import samplers as j_samplers
from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.scatter import lightsamplers as j_ls
from nn_bvh_tpu.wavefront import camera as j_camera, film as j_film, integrator as j_integrator
from nn_bvh_tpu.wavefront import volpath as j_volpath
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.scatter import bxdf
from nn_bvh_tpu_torch.tools import bench_scene
from nn_bvh_tpu_torch.wavefront import camera, film, integrator, volpath

torch.set_num_threads(1)

RES = 16
SPP = 4
VCFG = dict(kind="volpath", max_depth=6, rr_depth=2)
FOG_C2W = j_xf.look_at((0, 2, -4), (0, 1, 0), (0, 1, 0))


def glass_fog(mod):
    """bench_scene.build_fog_scene(interface="glass")'s scene, unbuilt."""
    b = mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    fog = b.add_medium(sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.3, 0.3, 0.3))
    glass = b.add_material("dielectric", eta=1.33)
    b.add_sphere((0, 1, 0), 0.8, glass, n_theta=10, n_phi=20, med_inside=fog)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=10.0, two_sided=True)
    return b.build()


@pytest.fixture(scope="module")
def glass_lanes():
    sc, dbvh, _ = j_accel.build_scene_bvh(glass_fog(j_scene))
    R = RES * RES
    jcam = j_camera.make_perspective(FOG_C2W, fov=50.0, width=RES, height=RES)
    jcfg = j_integrator.IntegratorConfig(use_pallas=False, **VCFG)
    jscfg = j_samplers.make_sampler("sobol", seed=0, spp=SPP, width=RES)
    jpix = jnp.arange(R, dtype=jnp.int32)
    jwave = jax.jit(lambda s: j_volpath.trace_wave_vol(sc, dbvh, jcam, jscfg, jcfg, jpix, s))
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(FOG_C2W), fov=50.0, width=RES, height=RES)
    tscfg = samplers.make_sampler("sobol", seed=0, spp=SPP, width=RES)
    tpix = torch.arange(R, dtype=torch.int32)
    counts = dict(transmitted=0, scattered=0)
    sample, events = bxdf.sample, volpath.medium_events

    def counted_sample(ctx, *a, **kw):
        bs = sample(ctx, *a, **kw)
        counts["transmitted"] += int((bs.valid & bs.transmission).sum())
        return bs

    def counted_events(*a, **kw):
        out = events(*a, **kw)
        counts["scattered"] += int(out[0].sum())
        return out

    jf, tf = j_film.make_film(RES, RES), film.make_film(RES, RES, "cpu")
    lj, lt = [], []
    bxdf.sample, volpath.medium_events = counted_sample, counted_events
    try:
        for s in range(SPP):
            jout = jwave(jnp.int32(s))
            tout = volpath.trace_wave_vol(tsc, tbvh, tcam, tscfg,
                                          integrator.IntegratorConfig(**VCFG), tpix, s)
            jf = j_film.add_samples(jf, jpix, *jout[:3], filter_weight=jout[3],
                                    sequential=True)
            tf = film.add_samples(tf, tpix, *tout[:3], filter_weight=tout[3], sequential=True)
            lj.append(np.asarray(jout[0]))
            lt.append(tout[0].numpy())
    finally:
        bxdf.sample, volpath.medium_events = sample, events
    return (np.concatenate(lj), np.concatenate(lt), np.asarray(j_film.develop(jf)),
            film.develop(tf).numpy(), counts)


def test_glass_fog_matches_jax(glass_lanes):
    lane_j, lane_t, img_j, img_t, counts = glass_lanes
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean())
    lane_ok = np.isclose(lane_t, lane_j, atol=1e-3, rtol=1e-2).all(-1)
    assert lane_ok.mean() >= 0.99, lane_ok.mean()
    assert counts["transmitted"] > 0 and counts["scattered"] > 0, counts


def test_glass_fog_phased_wave_matches_plain_trace():
    sc, dbvh, cam = bench_scene.build_fog_scene(24, interface="glass")
    cfg = integrator.IntegratorConfig(max_depth=6, kind="volpath", rr_depth=2)
    scfg = samplers.make_sampler("sobol", seed=0, spp=2, width=24)
    img_plain = integrator.render(sc, dbvh, cam, spp=2, cfg=cfg, device="cpu")
    wave = volpath.make_phased_wave(sc, dbvh, cam, scfg, cfg, phase_len=2, device="cpu")
    f = film.make_film(cam.height, cam.width, "cpu")
    for s in range(2):
        f = wave(f, s)
    img = film.develop(f)
    assert float(img.mean()) > 0
    np.testing.assert_allclose(img.numpy(), img_plain.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# whole-wave gradients against jax.grad
# ---------------------------------------------------------------------------

GRES = 4
GR = GRES * GRES
GLASS_C2W = j_xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0))


def glass_scene(coated: bool):
    b = j_scene.SceneBuilder()
    d = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    g = b.add_material("dielectric", eta=1.5)
    b.add_sphere((0.2, 0.6, 0), 0.6, g, n_theta=8, n_phi=16)
    if coated:
        cd = b.add_material("coateddiffuse", reflectance=(0.7, 0.3, 0.2), roughness=0.1)
        b.add_sphere((-1.0, 0.6, 0.3), 0.6, cd, n_theta=8, n_phi=16)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), d)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), d,
               emission_rgb=(1, 1, 1), emission_scale=8.0, two_sided=True)
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    return sc, dbvh


def wave_gradients(coated: bool, max_depth: int):
    """One Path wave through both packages: per-lane XYZ, the mask of lanes
    that agree, and grad(weight) -> (port, JAX) gradients of sum(weight *
    xyz)/R with respect to (mat_coeffs, light_scale)."""
    sc, dbvh = glass_scene(coated)
    kw = dict(max_depth=max_depth, mis=True, rr_depth=99)
    mc = torch.tensor(np.asarray(sc.mat_coeffs), requires_grad=True)
    ls = torch.tensor(np.asarray(sc.light_scale), requires_grad=True)
    tsc, tbvh = scene.scene_from_numpy(dict(sc._asdict(), mat_coeffs=mc, light_scale=ls),
                                       dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(GLASS_C2W), fov=45.0, width=GRES, height=GRES)
    pix = torch.arange(GR, dtype=torch.int32)
    L, lam, pdf, _ = integrator.trace_wave(tsc, tbvh, tcam, samplers.make_sampler(
        "sobol", seed=0, spp=4), integrator.IntegratorConfig(**kw), pix, 0)
    xyz_t = film.add_samples(film.make_film(GRES, GRES, "cpu"), pix, L, lam, pdf).xyz

    jsc = jax.tree.map(jnp.asarray, sc)
    jcam = j_camera.make_perspective(GLASS_C2W, fov=45.0, width=GRES, height=GRES)
    jcfg = j_integrator.IntegratorConfig(use_pallas=False, early_exit=True, **kw)
    jscfg = j_samplers.make_sampler("sobol", seed=0, spp=4)
    jlst = j_ls.build(sc, jcfg.light_sampler)
    jpix = jnp.arange(GR, dtype=jnp.int32)

    def xyz_j(mat_coeffs, light_scale):
        s2 = jsc.replace(mat_coeffs=mat_coeffs, light_scale=light_scale)
        L, lam, pdf, _ = j_integrator.trace_wave(s2, dbvh, jcam, jscfg, jcfg, jpix,
                                                 jnp.int32(0), jlst)
        return j_film.add_samples(j_film.make_film(GRES, GRES), jpix, L, lam, pdf).xyz

    with jax.disable_jit():
        val_j, vjp = jax.vjp(xyz_j, jsc.mat_coeffs, jsc.light_scale)
    agree = np.isclose(xyz_t.detach().numpy(), np.asarray(val_j), rtol=1e-3, atol=1e-5).all(-1)

    def grad(weight):
        w = torch.as_tensor(weight, dtype=torch.float32)
        g_t = torch.autograd.grad((xyz_t * w[:, None]).sum() / GR, (mc, ls), retain_graph=True)
        with jax.disable_jit():
            g_j = vjp(jnp.asarray(np.repeat(weight[:, None], 3, -1) / GR, jnp.float32))
        return [g.numpy() for g in g_t], [np.asarray(g) for g in g_j]

    return xyz_t.detach().numpy(), agree, grad


def test_glass_wave_gradients_match_jax_grad():
    xyz, agree, grad = wave_gradients(coated=False, max_depth=3)
    assert np.isfinite(xyz).all() and agree.mean() >= 0.9, agree.mean()
    g_t, g_j = grad(np.ones(GR, np.float32))
    for got, want, name in zip(g_t, g_j, ("mat_coeffs", "light_scale")):
        assert np.isfinite(got).all() and np.abs(got).max() > 0, name
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-4, err_msg=name)
    g_t, g_j = grad(agree.astype(np.float32))
    for got, want, name in zip(g_t, g_j, ("mat_coeffs", "light_scale")):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=name)


@pytest.mark.slow
def test_coated_glass_wave_gradients_match_jax_grad():
    xyz, agree, grad = wave_gradients(coated=True, max_depth=2)
    assert np.isfinite(xyz).all() and agree.any()
    g_t, g_j = grad(agree.astype(np.float32))
    for got, want, name in zip(g_t, g_j, ("mat_coeffs", "light_scale")):
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=name)
    g_t, _ = grad(np.ones(GR, np.float32))
    assert np.isfinite(g_t[0]).all() and np.abs(g_t[0][2]).max() > 0  # the coated row
