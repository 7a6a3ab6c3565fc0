"""Whole Path renders through this slice's lights, light samplers,
samplers and quadrics against the JAX CPU anchor (`integrator.render`,
XLA traversal) on the same JAX-built scene, carried across with
`scene_from_numpy`: bench_scene.small_lights_scene (point, spot, distant,
sphere and area lights, an env map or a portal env, four analytic
quadrics), 16x16, 2 spp, depth 3, Russian roulette from depth 1, MIS. Each
case pairs a light sampler with one of the new sampler kinds.

Thresholds of tests/test_torch_render.py: the image mean within 0.5% and
>= 99% of the pixels within atol 1e-3 + rtol 1e-2 (the anchor tests
triangles watertight, the port by Moller-Trumbore).

VolPath with an env map is held against the port's own Path on the same
scene (no media: equal in expectation), means within 4 standard errors,
so no JAX VolPath compile is added; and the reference's fault that
VolPath leaves the portal strategy out of an escaped ray's light pdf is
shown on `volpath.add_emission` itself.
"""

import functools

import numpy as np
import pytest
import torch

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.geometry import scene as j_scene
from nn_bvh_tpu.wavefront import camera as j_camera, integrator as j_integrator
from nn_bvh_tpu_torch.core import sampling, samplers, spectrum
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.scatter import lights, lightsamplers
from nn_bvh_tpu_torch.tools import bench_scene
from nn_bvh_tpu_torch.wavefront import camera, film, integrator, volpath

torch.set_num_threads(1)

RES = 16
SPP = 2
CFG = dict(max_depth=3, rr_depth=1, mis=True)

# (env, light sampler, sampler kind); the portal's SAT warp makes the
# JAX wave's compile the longest (~50 s here), so it renders once
CASES = [("image", "bvh", "halton"), ("image", "power", "zsobol"),
         ("image", "bvh", "pmj02bn"), ("portal", "exhaustive", "stratified")]


@functools.lru_cache(maxsize=None)
def carried(env: str):
    sc, dbvh, _ = j_accel.build_scene_bvh(
        bench_scene.small_lights_scene(j_scene.SceneBuilder(), env).build())
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    return env, sc, dbvh, tsc, tbvh


def images_agree(img_t, img_j):
    assert img_t.shape == img_j.shape == (RES, RES, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) <= 0.005 * abs(img_j.mean()), \
        (img_t.mean(), img_j.mean())
    px_ok = np.isclose(img_t, img_j, atol=1e-3, rtol=1e-2).all(-1)
    assert px_ok.mean() >= 0.99, px_ok.mean()


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_path_render_matches_jax(case):
    env, ls, kind = case
    _, sc, dbvh, tsc, tbvh = carried(env)
    jcam = bench_scene.small_lights_camera(j_camera, RES)
    tcam = bench_scene.small_lights_camera(camera, RES)
    img_j = np.asarray(j_integrator.render(
        sc, dbvh, jcam, spp=SPP, sampler=kind, seed=0,
        cfg=j_integrator.IntegratorConfig(light_sampler=ls, **CFG)))
    img_t = integrator.render(tsc, tbvh, tcam, spp=SPP, sampler=kind, seed=0,
                              cfg=integrator.IntegratorConfig(light_sampler=ls, **CFG)).numpy()
    images_agree(img_t, img_j)


def test_fullsobol_render():
    """The JAX package cannot render with the global Sobol' sampler: its
    get_1d reads int(dim) (nn_bvh_tpu/core/samplers.py:135), and the wave's
    bounce dimension is a traced loop counter. The port's dim is a host int;
    its fullsobol image agrees with its own independent-sampler image in
    expectation (16 waves each, means within 4 standard errors), on the
    scene without an env map."""
    import jax

    _, sc, dbvh, tsc, tbvh = carried("none")
    with pytest.raises(jax.errors.ConcretizationTypeError):
        j_integrator.render(sc, dbvh, bench_scene.small_lights_camera(j_camera, 4), spp=1,
                            sampler="fullsobol", cfg=j_integrator.IntegratorConfig(**CFG))
    tcam = bench_scene.small_lights_camera(camera, RES)
    waves = 16
    per = {}
    for kind in ("fullsobol", "independent"):
        scfg = samplers.make_sampler(kind, seed=0, spp=waves, width=RES)
        wave = integrator.make_wave_fn(tsc, tbvh, tcam, scfg, integrator.IntegratorConfig(
            light_sampler="uniform", **CFG))
        per[kind] = np.asarray([float(film.develop(wave(film.make_film(RES, RES, "cpu"),
                                                           s)).mean()) for s in range(waves)])
    assert np.isfinite(per["fullsobol"]).all() and per["fullsobol"].mean() > 0
    se = np.sqrt(per["fullsobol"].var(ddof=1) / waves + per["independent"].var(ddof=1) / waves)
    assert abs(per["fullsobol"].mean() - per["independent"].mean()) <= 4 * se


def test_volpath_env_matches_path_in_expectation():
    """No media: VolPath's estimate (balance MIS over rescaled
    probabilities, env-map pdf on escape) equals Path's in expectation."""
    _, _, _, tsc, tbvh = carried("image")
    tcam = bench_scene.small_lights_camera(camera, RES)
    waves = 16
    means = {}
    for kind in ("path", "volpath"):
        cfg = integrator.IntegratorConfig(kind=kind, light_sampler="bvh", **CFG)
        scfg = samplers.make_sampler("halton", seed=0, spp=waves)
        wave = integrator.make_wave_fn(tsc, tbvh, tcam, scfg, cfg)
        per = []
        for s in range(waves):
            f = wave(film.make_film(RES, RES, "cpu"), s)
            per.append(float(film.develop(f).mean()))
        means[kind] = np.asarray(per)
    diff = means["volpath"] - means["path"]
    se = diff.std(ddof=1) / np.sqrt(waves)
    assert abs(diff.mean()) <= 4 * se + 1e-6, (diff.mean(), se)
    assert means["path"].mean() > 0


def test_volpath_escape_pdf_leaves_out_the_portal():
    """The reference's VolPath adds only the uniform-infinite and env-map
    terms to an escaped ray's light pdf (nn_bvh_tpu/wavefront/volpath.py:
    488-492); the port mirrors it: its escaped radiance is the one of that
    pdf, and the portal term, which Path adds, would change it."""
    _, _, _, tsc, tbvh = carried("portal")
    from nn_bvh_tpu_torch.accel import dispatch

    cfg = integrator.IntegratorConfig(kind="volpath", light_sampler="power", **CFG)
    scfg = samplers.make_sampler("sobol", seed=0, spp=1)
    cam = bench_scene.small_lights_camera(camera, RES)
    ctx = volpath.make_context(tsc, cam, scfg, cfg, None,
                               dispatch.make_intersectors(tsc, tbvh, "cpu"))
    R = 512
    rs = np.random.RandomState(0)
    d = rs.randn(R, 3).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 1.0  # up, through the portal's side
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    o = torch.from_numpy(rs.uniform(-1, 1, (R, 3)).astype(np.float32)) + torch.tensor([0, 1.0, 0])
    lam, _ = spectrum.sample_wavelengths_visible(torch.from_numpy(rs.rand(R).astype(np.float32)))
    ones = torch.ones(R, 4)
    r_l = torch.full((R, 4), 0.5)
    true = torch.ones(R, dtype=torch.bool)
    hit = ctx.isect.closest(o, d, torch.full((R,), 1e30))
    found = hit.prim >= 0
    sp = integrator._shading_point(tsc, hit, o, d)
    L = volpath.add_emission(ctx, 1, o, d, torch.zeros(R, 4), ones, ones, r_l, true, ~true,
                             o, sp, found, lam)
    escaped = ~found
    assert escaped.float().mean() > 0.5
    le = lights.infinite_le(tsc, d, lam)
    pdf_env = sampling.UNIFORM_SPHERE_PDF * ctx.inf_sel_pmf  # no uniform light: 0
    expect = le / (ones + r_l * pdf_env).mean(-1, keepdim=True)
    torch.testing.assert_close(L[escaped], expect[escaped], rtol=1e-5, atol=1e-6)
    ls = lightsamplers.build(tsc, "power", "cpu")
    portal_sel = torch.where(tsc.light_type == scene.LIGHT_PORTAL_ENV, ls.pmf, 0.0).sum()
    p_portal = portal_sel * lights.portal_pdf_dir(tsc, lights.light_records(tsc), o, d)
    with_portal = le / (ones + r_l * (pdf_env + p_portal)[:, None]).mean(-1, keepdim=True)
    moved = (with_portal - expect).abs().amax(-1) > 1e-4 * expect.abs().amax(-1)
    assert bool((moved & escaped).any())
