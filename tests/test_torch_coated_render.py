"""The coated materials (the stochastic layered walk, scatter/layered.py)
through whole Path waves against the JAX CPU anchor, and the port's
shading gradients through coated diffuse and glass against jax.grad.

The walk seeds its hash from the bits of wo and wi. The anchor intersects
with the watertight `triangle.intersect`, the port with Moller-Trumbore:
their hit points and shading normals differ by ulps, so a lane that shades
a coated surface draws other numbers in the two packages, and its values
are two estimates of the same expectation, not one. So:

- Image (a coated-diffuse sphere, a coated-conductor sphere, a glass
  sphere, a diffuse floor and an emissive quad; 24x24, Sobol 16 spp, depth
  4, rr_depth 2, MIS): the lanes that shaded no coated surface in the port
  (its `_shading_point` marks them, wave by wave) are held per sample, as
  tests/test_torch_render.py holds lanes: >= 99% of them within atol 1e-3
  + rtol 1e-2. The coated lanes are held by their mean over all samples:
  the mean of the per-sample difference (port - JAX) lies within 4
  standard errors of that paired difference, and within 5% of the JAX
  mean. (Observed: a paired difference of -0.27% with a standard error of
  2.7% of the mean, on 24% of the lane samples; 99.5% of the other lanes
  within tolerance.)
- Shading gradients: d loss / d refl (what gather_material expands from
  mat_coeffs) through evaluate and sample on 1,024 coated-diffuse,
  coated-conductor and glass lanes (the same inputs in both packages, so
  the walk draws the same numbers) against jax.grad, rtol 1e-3 + atol 1e-6
  per lane.
- Wave gradients (the same scene, 8x8, Sobol 4 spp, depth 3, rr_depth 99,
  two waves): finite on every material, and the port's autograd against
  central finite differences with common random numbers on the coated rows
  within rtol 2e-2 + atol 2e-4 (a coefficient moves no sampled direction and
  RR is off, so the same seed replays the same paths). Against jax.grad a
  whole wave through the walk is the slow test of
  tests/test_torch_glass_volpath.py: an eager JAX VJP of one 4x4 wave at
  depth 2 takes minutes on a CPU, and a jitted one did not compile in 20.
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
from nn_bvh_tpu_torch.wavefront import camera, film, integrator

torch.set_num_threads(1)

C2W = j_xf.look_at((0, 1.5, -4), (0, 0.5, 0), (0, 1, 0))
COATED = (scene.MAT_COATED_DIFFUSE, scene.MAT_COATED_CONDUCTOR)


def coated_scene(conductor: bool = True):
    b = j_scene.SceneBuilder()
    d = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    cd = b.add_material("coateddiffuse", reflectance=(0.7, 0.3, 0.2), roughness=0.1)
    g = b.add_material("dielectric", eta=1.5)
    b.add_sphere((-1.0, 0.6, 0), 0.6, cd, n_theta=8, n_phi=16)
    b.add_sphere((1.2, 0.5, -0.8), 0.5, g, n_theta=8, n_phi=16)
    if conductor:
        cc = b.add_material("coatedconductor", reflectance=(0.9, 0.75, 0.5), roughness=0.1)
        b.add_sphere((0.4, 0.6, 0.5), 0.6, cc, n_theta=8, n_phi=16)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), d)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), d,
               emission_rgb=(1, 1, 1), emission_scale=8.0, two_sided=True)
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    return sc, dbvh


@pytest.fixture(scope="module")
def lanes():
    """Both packages' trace_wave, wave by wave -> (JAX L, port L, coated
    mask), each (SPP, R, 4) or (SPP, R)."""
    res, spp = 24, 16
    cfg = dict(max_depth=4, rr_depth=2, mis=True)
    sc, dbvh = coated_scene()
    R = res * res
    jcam = j_camera.make_perspective(C2W, fov=45.0, width=res, height=res)
    jcfg = j_integrator.IntegratorConfig(use_pallas=False, **cfg)
    jscfg = j_samplers.make_sampler("sobol", seed=0, spp=spp, width=res)
    jpix = jnp.arange(R, dtype=jnp.int32)
    jwave = jax.jit(lambda s: j_integrator.trace_wave(sc, dbvh, jcam, jscfg, jcfg, jpix, s)[0])
    tsc, tbvh = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(np.asarray(C2W), fov=45.0, width=res, height=res)
    tscfg = samplers.make_sampler("sobol", seed=0, spp=spp, width=res)
    tcfg = integrator.IntegratorConfig(**cfg)
    tpix = torch.arange(R, dtype=torch.int32)
    coated = np.zeros((spp, R), bool)
    shading_point = integrator._shading_point

    def marking(scene_, hit, o, d):
        # the CPU traversal keeps the lanes in pixel order (no re-sort)
        sp = shading_point(scene_, hit, o, d)
        t = scene_.mat_type[torch.clamp(sp.mat, min=0).long()]
        hit_coated = (hit.prim >= 0) & (sp.mat >= 0) & ((t == COATED[0]) | (t == COATED[1]))
        coated[s] |= hit_coated.numpy()
        return sp

    lj, lt = [], []
    integrator._shading_point = marking
    try:
        for s in range(spp):
            lj.append(np.asarray(jwave(jnp.int32(s))))
            lt.append(integrator.trace_wave(tsc, tbvh, tcam, tscfg, tcfg, tpix, s)[0].numpy())
    finally:
        integrator._shading_point = shading_point
    return np.stack(lj), np.stack(lt), coated


def test_uncoated_lanes_match_jax_per_sample(lanes):
    lane_j, lane_t, coated = lanes
    assert np.isfinite(lane_t).all() and lane_t.mean() > 0
    assert 0.1 < coated.mean() < 0.5, coated.mean()  # the scene exercises the walk
    ok = np.isclose(lane_t, lane_j, atol=1e-3, rtol=1e-2).all(-1)
    assert ok[~coated].mean() >= 0.99, ok[~coated].mean()


def test_coated_lanes_match_jax_in_the_mean(lanes):
    lane_j, lane_t, coated = lanes
    yj, yt = lane_j.mean(-1)[coated], lane_t.mean(-1)[coated]
    diff = yt - yj
    se = diff.std() / np.sqrt(diff.size)
    assert abs(diff.mean()) <= 4 * se, (diff.mean(), se)
    assert abs(diff.mean()) <= 0.05 * yj.mean(), (yt.mean(), yj.mean())


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

N = 1024


def test_shading_gradients_match_jax_grad():
    """d loss / d refl (the reflectance gather_material expands from
    mat_coeffs) through evaluate and sample on 1,024 lanes of coated
    diffuse, coated conductor and glass (the scene's rows, the same inputs
    in both packages, so the walk draws the same numbers), against jax.grad
    (eager) per lane: rtol 1e-3 + atol 1e-6 on all but 4 lanes, room for a
    draw within rounding of one of the walk's thresholds (0 observed; the
    lobe values themselves miss on 2 lanes of 4,096, test_torch_materials)."""
    from nn_bvh_tpu.scatter import bxdf as j_bxdf
    from nn_bvh_tpu_torch.scatter import bxdf

    sc, _ = coated_scene()
    rs = np.random.RandomState(11)
    mat = rs.randint(1, 4, N)  # coated diffuse, glass, coated conductor
    params = np.asarray(sc.mat_params)[mat]
    alpha = np.sqrt(params[:, 0]).astype(np.float32)
    cols = dict(mat_type=np.asarray(sc.mat_type)[mat].astype(np.int32), ax=alpha, ay=alpha,
                eta=params[:, 2].astype(np.float32), k=params[:, 3].astype(np.float32),
                coat_ax=np.sqrt(params[:, 9]).astype(np.float32))
    wo = rs.randn(N, 3).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2]) * np.where(rs.rand(N) < 0.8, 1, -1)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi = rs.randn(N, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    refl = (0.1 + 0.8 * rs.rand(N, 4)).astype(np.float32)
    uc, u2 = rs.rand(N).astype(np.float32), rs.rand(N, 2).astype(np.float32)

    def loss(pkg, refl_, asarray):
        ctx = pkg.MaterialCtx(refl=refl_, **{k: asarray(v) for k, v in cols.items()})
        f, pdf = pkg.evaluate(ctx, asarray(wo), asarray(wi))
        bs = pkg.sample(ctx, asarray(wo), asarray(uc), asarray(u2))
        w = bs.f * (1.0 / (bs.pdf + 1e-3))[:, None]
        return (f * pdf[:, None]).sum() + (w * bs.valid[:, None]).sum()

    with jax.disable_jit():
        g_j = np.asarray(jax.grad(lambda r: loss(j_bxdf, r, jnp.asarray))(jnp.asarray(refl)))
    r_t = torch.from_numpy(refl).requires_grad_(True)
    g_t = torch.autograd.grad(loss(bxdf, r_t, torch.from_numpy), r_t)[0].numpy()
    assert np.isfinite(g_t).all()
    coated = cols["mat_type"] != scene.MAT_DIELECTRIC
    assert (np.abs(g_t[coated]).max(-1) > 0).mean() > 0.5
    off = ~np.isclose(g_t, g_j, rtol=1e-3, atol=1e-6).all(-1)
    assert off.sum() <= 4, off.sum()


RES = 8
R = RES * RES
GCFG = dict(max_depth=3, mis=True, rr_depth=99)


@pytest.mark.parametrize("row,j", [(1, 0), (1, 1), (1, 2), (3, 1)])
def test_wave_gradient_finite_and_matches_finite_differences(row, j):
    """d sum(film.xyz)/R / d mat_coeffs of two waves (8x8, Sobol 4 spp,
    depth 3, rr_depth 99) through the coated scene: finite on every
    material, and central differences with common random numbers on the
    coated rows (1: coated diffuse, 3: coated conductor)."""
    sc, dbvh = coated_scene()
    mc = torch.tensor(np.asarray(sc.mat_coeffs), requires_grad=True)
    tsc, tbvh = scene.scene_from_numpy(dict(sc._asdict(), mat_coeffs=mc), dbvh._asdict(), "cpu")
    cam = camera.make_perspective(np.asarray(C2W), fov=45.0, width=RES, height=RES)
    scfg = samplers.make_sampler("sobol", seed=0, spp=4)
    cfg = integrator.IntegratorConfig(**GCFG)
    pix = torch.arange(R, dtype=torch.int32)

    def loss(mat_coeffs):
        s2 = tsc.replace(mat_coeffs=mat_coeffs)
        total = 0.0
        for s in range(2):
            L, lam, pdf, _ = integrator.trace_wave(s2, tbvh, cam, scfg, cfg, pix, s)
            total = total + film.add_samples(film.make_film(RES, RES, "cpu"), pix, L, lam,
                                             pdf).xyz.sum() / R
        return total

    g = torch.autograd.grad(loss(mc), mc)[0]
    assert bool(torch.isfinite(g).all()) and float(g[row].abs().max()) > 0
    eps = 1e-3
    step = torch.zeros_like(mc)
    step[row, j] = eps
    with torch.no_grad():
        fd = (float(loss(mc + step)) - float(loss(mc - step))) / (2 * eps)
    np.testing.assert_allclose(float(g[row, j]), fd, rtol=2e-2, atol=2e-4)
