"""The port's shading gradients against jax.grad on the CPU.

The scene of tests/test_diff.py:24-42 (diffuse quads, a two-sided area
light, Sobol 4 spp, Path depth 3, rr_depth 99) at 8x8, carried across with
`scene_from_numpy`; the gradient inputs `mat_coeffs` and `light_scale` are
leaf tensors with requires_grad. The loss is test_diff.make_loss's:
sum(film.xyz) / R over two waves (samples 0 and 1).

The JAX side runs eagerly (jax.disable_jit) with early_exit=True: a jitted
jax.grad of the scanned wave takes ~4 minutes to compile on the CPU, an
eager VJP ~1.5 minutes. One forward pass gives both JAX gradients below
(one VJP, two cotangents).

- Whole loss: the gradients match jax.grad's within test_diff's
  finite-difference tolerance, rtol 2e-2 + atol 2e-4.
- Lanes whose forward values agree (per lane XYZ within rtol 1e-3 + atol
  1e-5: all but a few): the gradients of the loss over those lanes match
  within rtol 1e-3 + atol 1e-6. The lanes left out are decided by rounding:
  a path that bounces onto the emissive quad (itself diffuse) samples the
  light from a point in the light's own plane; the JAX package's jitted and
  eager runs differ on them too.
- The port alone: central finite differences with common random numbers
  (the same seed and samples) on the three mat_coeffs entries and one
  light_scale, against autograd, rtol 2e-2 + atol 2e-4.
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
from nn_bvh_tpu_torch.core import samplers
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.scatter import lightsamplers
from nn_bvh_tpu_torch.wavefront import camera, film, integrator

torch.set_num_threads(1)

RES = 8
R = RES * RES
WAVES = 2
EYE, TARGET, UP = (0, 2, -5), (0, 0, 0), (0, 1, 0)


def diff_scene():
    """tests/test_diff.py:24-32's scene, JAX-built."""
    b = j_scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.4, 0.3))
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), m)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=5.0, two_sided=True)
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    return sc, dbvh


@pytest.fixture(scope="module")
def port():
    """The scene in the port, its differentiable leaves, and
    xyz(mat_coeffs, light_scale) -> (WAVES, R, 3) film XYZ per wave."""
    sc, dbvh = diff_scene()
    fields = sc._asdict()
    mc = torch.tensor(np.asarray(sc.mat_coeffs), requires_grad=True)
    ls = torch.tensor(np.asarray(sc.light_scale), requires_grad=True)
    tsc, tbvh = scene.scene_from_numpy(dict(fields, mat_coeffs=mc, light_scale=ls), dbvh._asdict(),
                                       "cpu")
    assert tsc.mat_coeffs is mc and tsc.light_scale is ls  # the leaves ride in the scene
    cam = camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=40.0, width=RES, height=RES)
    cfg = integrator.IntegratorConfig(max_depth=3, mis=True, rr_depth=99)
    scfg = samplers.make_sampler("sobol", seed=0, spp=4)
    lst = lightsamplers.build(tsc, cfg.light_sampler, "cpu")
    pix = torch.arange(R, dtype=torch.int32)

    def xyz(mat_coeffs, light_scale):
        s2 = tsc.replace(mat_coeffs=mat_coeffs, light_scale=light_scale)
        out = []
        for s in range(WAVES):
            L, lam, pdf, _ = integrator.trace_wave(s2, tbvh, cam, scfg, cfg, pix, s, lst)
            out.append(film.add_samples(film.make_film(RES, RES, "cpu"), pix, L, lam, pdf).xyz)
        return torch.stack(out)

    return dict(mc=mc, ls=ls, xyz=xyz)


@pytest.fixture(scope="module")
def jax_vjp():
    """JAX: per-lane XYZ (WAVES, R, 3) and its VJP, eager, as
    test_diff.make_loss computes the loss."""
    sc, dbvh = diff_scene()
    jsc = jax.tree.map(jnp.asarray, sc)
    cam = j_camera.make_perspective(j_xf.look_at(EYE, TARGET, UP), fov=40.0, width=RES,
                                    height=RES)
    cfg = j_integrator.IntegratorConfig(max_depth=3, mis=True, rr_depth=99, early_exit=True)
    scfg = j_samplers.make_sampler("sobol", seed=0, spp=4)
    lst = j_ls.build(sc, cfg.light_sampler)
    pix = jnp.arange(R, dtype=jnp.int32)

    def xyz(mat_coeffs, light_scale):
        s2 = jsc.replace(mat_coeffs=mat_coeffs, light_scale=light_scale)
        out = []
        for s in range(WAVES):
            L, lam, pdf, _ = j_integrator.trace_wave(s2, dbvh, cam, scfg, cfg, pix, jnp.int32(s),
                                                     lst)
            out.append(j_film.add_samples(j_film.make_film(RES, RES), pix, L, lam, pdf).xyz)
        return jnp.stack(out)

    def grad(w):
        with jax.disable_jit():
            return [np.asarray(g) for g in vjp(jnp.asarray(w / R, jnp.float32))]

    with jax.disable_jit():
        val, vjp = jax.vjp(xyz, jsc.mat_coeffs, jsc.light_scale)
    return dict(xyz=np.asarray(val), g_full=grad(np.ones(val.shape, np.float32)), grad=grad)


@pytest.fixture(scope="module")
def agree(port, jax_vjp):
    """Forward per-lane XYZ of both packages and the mask of lanes that
    agree."""
    with torch.no_grad():
        xyz_t = port["xyz"](port["mc"], port["ls"]).numpy()
    ok = np.isclose(xyz_t, jax_vjp["xyz"], rtol=1e-3, atol=1e-5).all(-1)
    return xyz_t, ok


def port_grads(port, weight=None):
    xyz = port["xyz"](port["mc"], port["ls"])
    w = torch.ones(xyz.shape[:2]) if weight is None else torch.as_tensor(weight)
    loss = (xyz * w[..., None]).sum() / R
    return [g.numpy() for g in torch.autograd.grad(loss, (port["mc"], port["ls"]))]


def test_forward_matches_jax(agree):
    xyz_t, ok = agree
    assert ok.mean() >= 0.97, ok.mean()
    assert np.isfinite(xyz_t).all() and xyz_t.sum() > 0


def test_gradients_match_jax_grad(port, jax_vjp):
    g_t = port_grads(port)
    for got, want, name in zip(g_t, jax_vjp["g_full"], ("mat_coeffs", "light_scale")):
        assert np.isfinite(got).all() and np.abs(got).max() > 0, name
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-4, err_msg=name)


def test_gradients_match_jax_grad_on_agreeing_lanes(port, jax_vjp, agree):
    w = agree[1].astype(np.float32)
    g_t = port_grads(port, w)
    g_j = jax_vjp["grad"](w[..., None] * np.ones(3, np.float32))
    for got, want, name in zip(g_t, g_j, ("mat_coeffs", "light_scale")):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("which", ["mat_coeffs[0,0]", "mat_coeffs[0,1]", "mat_coeffs[0,2]",
                                   "light_scale[0]"])
def test_port_gradient_matches_finite_differences(port, which):
    """Central differences with common random numbers (same seed, same
    samples): RR is off (rr_depth 99), so a step cannot flip a decision."""
    grads = port_grads(port)
    eps = 1e-3
    mc0, ls0 = port["mc"].detach(), port["ls"].detach()
    if which.startswith("mat"):
        j = int(which[-2])
        step = torch.zeros_like(mc0)
        step[0, j] = eps
        args = lambda sgn: (mc0 + sgn * step, ls0)
        want = grads[0][0, j]
    else:
        step = torch.zeros_like(ls0)
        step[0] = eps
        args = lambda sgn: (mc0, ls0 + sgn * step)
        want = grads[1][0]
    with torch.no_grad():
        loss = lambda sgn: float(port["xyz"](*args(sgn)).sum()) / R
        fd = (loss(1.0) - loss(-1.0)) / (2 * eps)
    np.testing.assert_allclose(want, fd, rtol=2e-2, atol=2e-4)


@pytest.mark.slow
def test_volpath_gradients_match_jax_grad():
    """VolPath through media: the fog sphere of tests/test_phased_wave.py with
    the sphere as a pure medium boundary, 8x8, depth 3, Russian roulette
    off, one wave; d sum(film.xyz)/R / d (mat_coeffs, light_scale) against
    jax.grad (eager, as above), within test_diff's tolerance, rtol 2e-2 +
    atol 2e-4. Slow: the eager JAX VolPath gradient takes minutes."""
    from nn_bvh_tpu.wavefront import volpath as j_volpath
    from nn_bvh_tpu_torch.wavefront import volpath

    b = j_scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    fog = b.add_medium(sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.3, 0.3, 0.3))
    b.add_sphere((0, 1, 0), 0.8, -1, n_theta=10, n_phi=20, med_inside=fog)
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), m)
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), m,
               emission_rgb=(1, 1, 1), emission_scale=10.0, two_sided=True)
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    c2w = j_xf.look_at((0, 2, -4), (0, 1, 0), (0, 1, 0))
    kw = dict(kind="volpath", max_depth=3, rr_depth=99)

    jsc = jax.tree.map(jnp.asarray, sc)
    jcam = j_camera.make_perspective(c2w, fov=50.0, width=RES, height=RES)
    jcfg = j_integrator.IntegratorConfig(use_pallas=False, early_exit=True, **kw)
    jscfg = j_samplers.make_sampler("sobol", seed=0, spp=4)
    jlst = j_ls.build(sc, jcfg.light_sampler)
    jpix = jnp.arange(R, dtype=jnp.int32)

    def jloss(mat_coeffs, light_scale):
        s2 = jsc.replace(mat_coeffs=mat_coeffs, light_scale=light_scale)
        L, lam, pdf, _ = j_volpath.trace_wave_vol(s2, dbvh, jcam, jscfg, jcfg, jpix,
                                                  jnp.int32(0), jlst)
        return jnp.sum(j_film.add_samples(j_film.make_film(RES, RES), jpix, L, lam, pdf).xyz) / R

    with jax.disable_jit():
        g_j = jax.grad(jloss, argnums=(0, 1))(jsc.mat_coeffs, jsc.light_scale)

    mc = torch.tensor(np.asarray(sc.mat_coeffs), requires_grad=True)
    ls = torch.tensor(np.asarray(sc.light_scale), requires_grad=True)
    tsc, tbvh = scene.scene_from_numpy(dict(sc._asdict(), mat_coeffs=mc, light_scale=ls),
                                       dbvh._asdict(), "cpu")
    tcam = camera.make_perspective(c2w, fov=50.0, width=RES, height=RES)
    pix = torch.arange(R, dtype=torch.int32)
    L, lam, pdf, _ = volpath.trace_wave_vol(tsc, tbvh, tcam, samplers.make_sampler(
        "sobol", seed=0, spp=4), integrator.IntegratorConfig(**kw), pix, 0)
    loss = film.add_samples(film.make_film(RES, RES, "cpu"), pix, L, lam, pdf).xyz.sum() / R
    g_t = torch.autograd.grad(loss, (mc, ls))
    for got, want, name in zip(g_t, g_j, ("mat_coeffs", "light_scale")):
        assert np.isfinite(got.numpy()).all() and np.abs(got.numpy()).max() > 0, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-4,
                                   err_msg=name)
