"""Parity of the torch port's shading stages against the JAX package on the
CPU: BxDFs, lights, light samplers, camera rays, film.

Tolerances: bxdf evaluate/sample rtol 1e-4 + atol 1e-6; lights, light
samplers and camera rays atol 1e-5; film accumulate + develop rtol 1e-5.
Where a function is ill-conditioned in float32 on a few lanes, the stated
tolerance must hold on most lanes (`frac`) and a looser bound on all:
near-grazing directions take sqrt(1 - x^2 - y^2) of a tiny argument;
spherical-triangle sampling takes sqrt(1 - q^2) with q -> 1 when the sample
lands within ~1e-3 (barycentric) of an edge, which turns one ulp of the XLA
and torch transcendentals into up to 4e-4 barycentric, i.e. ~2e-3 scene
units on the bench light; small solid angles cancel in atan2.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nn_bvh_tpu.geometry import scene as j_scene, transform as j_xf
from nn_bvh_tpu.scatter import bxdf as j_bxdf, lights as j_lights, lightsamplers as j_ls
from nn_bvh_tpu.wavefront import camera as j_camera, film as j_film
from nn_bvh_tpu.wavefront import integrator as j_integrator
from nn_bvh_tpu.accel import traverse as j_traverse
from nn_bvh_tpu_torch.geometry import scene, transform
from nn_bvh_tpu_torch.scatter import bxdf, lights, lightsamplers
from nn_bvh_tpu_torch.wavefront import camera, film, integrator
from nn_bvh_tpu_torch.accel.traverse import Hit

torch.set_num_threads(1)

N = 4096


def close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol)


def close_bulk(a, b, rtol, atol, loose, frac=0.995):
    """Stated tolerance on >= frac of lanes, `loose` x it on every lane."""
    a, b = np.asarray(a), np.asarray(b)
    ok = np.isclose(b, a, rtol=rtol, atol=atol).reshape(len(a), -1).all(-1)
    assert ok.mean() >= frac, ok.mean()
    close(a, b, rtol=loose * rtol, atol=loose * atol)


def lit_scene(with_infinite: bool):
    """Two diffuse + one conductor material, a floor, one emissive quad
    (two area lights), optionally a uniform infinite light; JAX-built."""
    b = j_scene.SceneBuilder()
    if with_infinite:
        b.add_uniform_infinite_light((0.3, 0.4, 0.5), scale=0.7)
    m0 = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    m1 = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), m0)
    b.add_sphere((0.5, 1.0, 0.0), 0.6, m1, n_theta=6, n_phi=12)
    b.add_quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2), m0,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=20.0, two_sided=True)
    sc = b.build()
    return sc, scene.to_device(scene.CompiledScene(
        **{k: getattr(sc, k) for k in scene.CompiledScene._fields}), "cpu")


@pytest.fixture(scope="module")
def shading_draws():
    rs = np.random.RandomState(0)
    wo = rs.randn(N, 3).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2]) * np.where(rs.rand(N) < 0.9, 1, -1)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi = rs.randn(N, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    uc = rs.rand(N).astype(np.float32)
    u2 = rs.rand(N, 2).astype(np.float32)
    refl = (0.2 + 0.8 * rs.rand(N, 4)).astype(np.float32)
    return wo, wi, uc, u2, refl


MATERIALS = {
    "diffuse": (0, 0.0),
    "conductor_rough": (1, 0.15),
    "conductor_smooth": (1, 0.0),
}


def _ctxs(kind, refl):
    tag, rough = MATERIALS[kind]
    alpha = np.float32(np.sqrt(rough))
    cols = dict(mat_type=np.full(N, tag, np.int32), refl=refl,
                ax=np.full(N, alpha, np.float32), ay=np.full(N, alpha, np.float32),
                eta=np.full(N, 1.5, np.float32), k=np.full(N, 3.9, np.float32))
    return (j_bxdf.MaterialCtx(**{k: jnp.asarray(v) for k, v in cols.items()}),
            bxdf.MaterialCtx(**{k: torch.from_numpy(v) for k, v in cols.items()}))


@pytest.mark.parametrize("kind", sorted(MATERIALS))
def test_bxdf_evaluate_parity(shading_draws, kind):
    wo, wi, _, _, refl = shading_draws
    jc, tc = _ctxs(kind, refl)
    jf, jp = j_bxdf.evaluate(jc, jnp.asarray(wo), jnp.asarray(wi))
    tf, tp = bxdf.evaluate(tc, torch.from_numpy(wo), torch.from_numpy(wi))
    assert tf.dtype == torch.float32 and tp.dtype == torch.float32
    close_bulk(jf, tf, rtol=1e-4, atol=1e-6, loose=10)
    close_bulk(jp, tp, rtol=1e-4, atol=1e-6, loose=10)


@pytest.mark.parametrize("kind", sorted(MATERIALS))
def test_bxdf_sample_parity(shading_draws, kind):
    wo, _, uc, u2, refl = shading_draws
    jc, tc = _ctxs(kind, refl)
    js = j_bxdf.sample(jc, jnp.asarray(wo), jnp.asarray(uc), jnp.asarray(u2))
    ts = bxdf.sample(tc, torch.from_numpy(wo), torch.from_numpy(uc), torch.from_numpy(u2))
    for name in ("valid", "specular", "transmission"):
        assert (np.asarray(getattr(js, name)) == getattr(ts, name).numpy()).all(), name
    v = np.asarray(js.valid)
    for name in ("wi", "f", "pdf", "eta"):
        close_bulk(np.asarray(getattr(js, name))[v], getattr(ts, name).numpy()[v],
                   rtol=1e-4, atol=1e-6, loose=10)


def test_gather_material_parity():
    sc, tsc = lit_scene(False)
    rs = np.random.RandomState(1)
    mat = rs.randint(-1, 2, N).astype(np.int32)
    lam = (360 + 470 * rs.rand(N, 4)).astype(np.float32)
    jc = j_bxdf.gather_material(sc, jnp.asarray(mat), jnp.asarray(lam))
    tc = bxdf.gather_material(tsc, torch.from_numpy(mat), torch.from_numpy(lam))
    assert (np.asarray(jc.mat_type) == tc.mat_type.numpy()).all()
    for name in ("refl", "ax", "ay", "eta", "k"):
        close(getattr(jc, name), getattr(tc, name))


@pytest.mark.parametrize("with_infinite", [False, True])
def test_sample_li_parity(with_infinite):
    sc, tsc = lit_scene(with_infinite)
    rs = np.random.RandomState(2)
    p = ((rs.rand(N, 3) - 0.5) * [10, 4, 10] + [0, 2, 0]).astype(np.float32)
    lam = (360 + 470 * rs.rand(N, 4)).astype(np.float32)
    u2 = rs.rand(N, 2).astype(np.float32)
    lid = rs.randint(0, sc.n_lights, N).astype(np.int32)
    jl = j_lights.sample_li(sc, j_lights.light_records(sc), jnp.asarray(lid),
                            jnp.asarray(p), jnp.asarray(lam), jnp.asarray(u2))
    tl = lights.sample_li(tsc, lights.light_records(tsc), torch.from_numpy(lid),
                          torch.from_numpy(p), torch.from_numpy(lam), torch.from_numpy(u2))
    assert (np.asarray(jl.valid) == tl.valid.numpy()).all()
    assert (np.asarray(jl.is_delta) == tl.is_delta.numpy()).all()
    v = np.asarray(jl.valid)
    for name in ("wi", "li", "pdf"):
        close_bulk(np.asarray(getattr(jl, name))[v], getattr(tl, name).numpy()[v],
                   rtol=1e-5, atol=1e-5, loose=300, frac=0.99)
    close_bulk(np.asarray(jl.dist), tl.dist.numpy(), rtol=1e-5, atol=1e-5,
               loose=300, frac=0.99)  # inf matches inf
    jle = j_lights.infinite_le(sc, jnp.asarray(p), jnp.asarray(lam))
    close(jle, lights.infinite_le(tsc, torch.from_numpy(p), torch.from_numpy(lam)))


def test_emission_pdfs_parity():
    rs = np.random.RandomState(3)
    v0, v1, v2, ref = (((rs.rand(N, 3) - 0.5) * 4).astype(np.float32) for _ in range(4))
    close_bulk(j_lights.area_pdf_li_from_verts(*map(jnp.asarray, (v0, v1, v2, ref))),
               lights.area_pdf_li_from_verts(*map(torch.from_numpy, (v0, v1, v2, ref))),
               rtol=1e-5, atol=1e-5, loose=20)
    rec = np.zeros((N, 20), np.float32)
    rec[:, 1:4] = (rs.rand(N, 3) - 0.5) * 4
    rec[:, 8] = 0.2 + rs.rand(N)
    hp, ng = v1, v2 / np.linalg.norm(v2, axis=1, keepdims=True)
    # 1/(2 pi (1 - cos_max)) cancels for distant spheres
    close_bulk(j_lights.sphere_pdf_li(*map(jnp.asarray, (rec, ref, hp, ng))),
               lights.sphere_pdf_li(*map(torch.from_numpy, (rec, ref, hp, ng))),
               rtol=1e-5, atol=1e-5, loose=20)
    lrec = np.zeros((N, 20), np.float32)
    lrec[:, 4:7] = rs.randn(N, 3)
    lrec[:, 7] = 3.0
    lrec[:, 9] = rs.rand(N) < 0.5
    has = rs.rand(N) < 0.8
    lam = (360 + 470 * rs.rand(N, 4)).astype(np.float32)
    close(j_lights.area_light_l_rec(*map(jnp.asarray, (lrec, has, ng, v0, lam))),
          lights.area_light_l_rec(*map(torch.from_numpy, (lrec, has, ng, v0, lam))))


@pytest.mark.parametrize("kind", ["power", "uniform"])
def test_light_sampler_parity(kind):
    sc, tsc = lit_scene(True)
    jt = j_ls.build(sc, kind)
    tt = lightsamplers.build(tsc, kind, "cpu")
    close(jt.pmf, tt.pmf, rtol=1e-6)
    rs = np.random.RandomState(4)
    u = rs.rand(N).astype(np.float32)
    p = rs.rand(N, 3).astype(np.float32)
    jid, jpmf, ju = j_ls.sample_ctx(jt, jnp.asarray(p), jnp.asarray(u))
    tid, tpmf, tu = lightsamplers.sample_ctx(tt, torch.from_numpy(p), torch.from_numpy(u))
    assert (np.asarray(jid) == tid.numpy()).all()
    close(jpmf, tpmf)
    close(ju, tu)
    lid = rs.randint(-1, sc.n_lights, N).astype(np.int32)
    close(j_ls.pmf_ctx(jt, jnp.asarray(p), jnp.asarray(lid)),
          lightsamplers.pmf_ctx(tt, torch.from_numpy(p), torch.from_numpy(lid)))


@pytest.mark.parametrize("size,lens", [((24, 24), 0.0), ((40, 24), 0.0), ((24, 40), 0.2)])
def test_generate_rays_parity(size, lens):
    W, H = size
    c2w = j_xf.look_at((0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0))
    jc = j_camera.make_perspective(c2w, fov=50.0, width=W, height=H,
                                   lens_radius=lens, focal_distance=8.0)
    tc = camera.make_perspective(transform.look_at((0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0)),
                                 fov=50.0, width=W, height=H, lens_radius=lens,
                                 focal_distance=8.0)
    np.testing.assert_array_equal(tc.cam_to_world, np.asarray(jc.cam_to_world))
    rs = np.random.RandomState(5)
    pix = np.arange(W * H, dtype=np.int32)
    up = rs.rand(W * H, 2).astype(np.float32)
    ul = rs.rand(W * H, 2).astype(np.float32)
    jo, jd = j_camera.generate_rays(jc, *map(jnp.asarray, (pix, up, ul)))
    to, td = camera.generate_rays(tc, *map(torch.from_numpy, (pix, up, ul)))
    close(jo, to)
    close(jd, td)


@pytest.mark.parametrize("sequential", [True, False])
def test_film_add_samples_develop_parity(sequential):
    H, W = 16, 12
    rs = np.random.RandomState(6)
    jf = j_film.make_film(H, W)
    tf = film.make_film(H, W, "cpu")
    for s in range(3):
        pix = (np.arange(H * W) if sequential else rs.randint(0, H * W, H * W)).astype(np.int32)
        L = (rs.rand(H * W, 4) * 2).astype(np.float32)
        L[::37] = np.nan  # non-finite samples are dropped by both
        lam = (360 + 470 * rs.rand(H * W, 4)).astype(np.float32)
        pdf = (0.001 + 0.01 * rs.rand(H * W, 4)).astype(np.float32)
        w = rs.rand(H * W).astype(np.float32)
        jf = j_film.add_samples(jf, *map(jnp.asarray, (pix, L, lam, pdf)),
                                filter_weight=jnp.asarray(w), sequential=sequential)
        tf = film.add_samples(tf, *map(torch.from_numpy, (pix, L, lam, pdf)),
                              filter_weight=torch.from_numpy(w), sequential=sequential)
    close(jf.xyz, tf.xyz, rtol=1e-5, atol=1e-6)
    close(jf.weight, tf.weight, rtol=1e-5, atol=1e-6)
    img = film.develop(tf)
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    close(j_film.develop(jf), img, rtol=1e-5, atol=1e-6)
    close(j_film.develop(jf, sensor=j_film.make_sensor(None)),
          film.develop(tf, sensor=film.make_sensor(None)), rtol=1e-5, atol=1e-6)


def test_shading_point_parity():
    sc, tsc = lit_scene(False)
    rs = np.random.RandomState(7)
    prim = rs.randint(-1, sc.n_tris, N).astype(np.int32)
    t = np.where(prim >= 0, 1 + rs.rand(N), np.inf).astype(np.float32)
    b1 = (rs.rand(N) * 0.5).astype(np.float32)
    b2 = (rs.rand(N) * 0.5).astype(np.float32)
    o = rs.randn(N, 3).astype(np.float32)
    d = rs.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jsp = j_integrator._shading_point(
        j_scene.to_device(sc),
        j_traverse.Hit(*map(jnp.asarray, (t, prim, b1, b2))), jnp.asarray(o), jnp.asarray(d))
    tsp = integrator._shading_point(
        tsc, Hit(*map(torch.from_numpy, (t, prim, b1, b2))), torch.from_numpy(o),
        torch.from_numpy(d))
    for name in ("p", "ng", "ns", "uv", "v0", "uv_scale", "t"):
        close(getattr(jsp, name), getattr(tsp, name))
    for name in ("mat", "light", "prim"):
        assert (np.asarray(getattr(jsp, name)) == getattr(tsp, name).numpy()).all()
