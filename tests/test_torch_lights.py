"""The port's lights and light samplers against the JAX package on the CPU:
point, distant, spot, uniform and image infinite (equal-area env map),
portal env (with and without its warp tables), area-triangle and analytic
sphere lights; the light BVH and exhaustive samplers.

The scenes are built by the JAX package and carried across with
`scene_from_numpy`, so both read the very same tables; the inputs (points,
u, wavelengths) come from numpy RandomStates.

Tolerances: sample_li's wi, li and pdf to rtol 1e-5 / atol 1e-6, valid and
is_delta equal; env and portal pdfs to the same; light powers and every
sampler table equal, or within 1e-6 where JAX computes it in float32; the
samplers' light ids equal but on lanes within 1e-6 of a cdf boundary
(XLA's and torch's prefix sums may add in another order), pmfs to TOL.
Where a warp is ill-conditioned in float32 (close_bulk says which), TOL
holds on a stated share of the lanes.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.geometry import scene as j_scene
from nn_bvh_tpu.scatter import lights as j_lights, lightsamplers as j_ls
from nn_bvh_tpu_torch.geometry import scene
from nn_bvh_tpu_torch.scatter import lights, lightsamplers, portal
from nn_bvh_tpu_torch.tools import bench_scene

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N = 4096


def env_image(res: int = 16, seed: int = 0) -> np.ndarray:
    """A random map with a bright sun texel, one row of zeros and a few
    zero texels (equal neighbours in the cdfs)."""
    rs = np.random.RandomState(seed)
    img = (0.2 + rs.rand(res, res, 3)).astype(np.float32)
    img[res // 2 - 1] = 0.0
    img[3, 2:5] = 0.0
    img[res // 4, res // 3] = (40.0, 35.0, 30.0)
    return img


def build_lights(mod, env: str = "image"):
    """bench_scene.small_lights_scene with env_image as its map, through
    `mod`'s SceneBuilder (either package: the same calls build the same
    tables). env: "image" | "portal"."""
    b = bench_scene.small_lights_scene(mod.SceneBuilder(), "none")
    b.set_environment_map(env_image(), scale=0.8)
    if env == "portal":
        b.add_portal((-2, 3.5, -2), (-2, 3.5, 2), (2, 3.5, 2), (2, 3.5, -2))
    return b.build()


def lights_scene(mod, env: str = "image"):
    sc, dbvh, _ = j_accel.build_scene_bvh(build_lights(mod, env))
    return sc, dbvh


@functools.lru_cache(maxsize=None)
def carried(env: str):
    """(env, JAX scene of arrays, the port's scene of CPU tensors)."""
    sc, dbvh = lights_scene(j_scene, env)
    tsc, _ = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    return env, jax.tree.map(jnp.asarray, sc), tsc


@pytest.fixture(scope="module", params=["image", "portal"])
def scenes(request):
    return carried(request.param)


def inputs(seed: int, n: int = N):
    rs = np.random.RandomState(seed)
    p = (rs.rand(n, 3) * np.array([6.0, 2.5, 6.0]) - np.array([3.0, 0.0, 3.0])).astype(np.float32)
    u = rs.rand(n, 2).astype(np.float32)
    lam = (360.0 + 470.0 * rs.rand(n, 4)).astype(np.float32)
    return p, u, lam


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **(kw or TOL))


def close_bulk(a, b, frac, bound=None):
    """TOL on >= frac of the lanes, and |a - b| <= bound on every lane when
    a bound is given. For the ill-conditioned warps: the area triangle's
    spherical-triangle warp in float32 (tests/test_torch_shading.py holds it
    so), the sphere light's cone pdf 1 / (2 pi (1 - cos_max)) with cos_max
    near 1, the spot light's smoothstep over (cos - cos_total) /
    (cos_start - cos_total) near the cone's edges, and the portal's SAT
    bisection, where a step whose comparison
    flips moves the sample by one step (1/512 of the window) and may move it
    to another texel."""
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return
    ok = np.isclose(b, a, **TOL).reshape(len(a), -1).all(-1)
    assert ok.mean() >= frac, ok.mean()
    if bound is not None:
        assert np.abs(b - a).max() <= bound, np.abs(b - a).max()


# tag -> light tag (None: the scene's env light); the fraction of lanes held
# to TOL where the warp is ill-conditioned (close_bulk)
TAGS = {"point": 0, "distant": 1, "area_tri": 3, "env": None, "spot": 5, "sphere": 9}
BULK = {"area_tri": 0.95, "sphere": 0.999, "env": 0.99, "spot": 0.98}


@pytest.mark.parametrize("tag", list(TAGS))
def test_sample_li_matches_jax(scenes, tag):
    """Every lane samples the scene's first light of `tag` (env: the image
    or portal light)."""
    kind, jsc, tsc = scenes
    lt = np.asarray(jsc.light_type)
    want = {"image": 4, "portal": 8}[kind] if TAGS[tag] is None else TAGS[tag]
    lid = int(np.nonzero(lt == want)[0][0])
    p, u, lam = inputs(1 + lid)
    jl = j_lights.sample_li(jsc, j_lights.light_records(jsc), jnp.full(N, lid, jnp.int32),
                            jnp.asarray(p), jnp.asarray(lam), jnp.asarray(u))
    tl = lights.sample_li(tsc, lights.light_records(tsc), torch.full((N,), lid),
                          torch.from_numpy(p), torch.from_numpy(lam), torch.from_numpy(u))
    np.testing.assert_array_equal(np.asarray(jl.valid), tl.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jl.is_delta), tl.is_delta.numpy())
    v = np.asarray(jl.valid)
    assert v.sum() > 200, v.sum()
    tv = torch.from_numpy(v)
    fin = v & np.isfinite(np.asarray(jl.dist))
    pairs = [(np.asarray(getattr(jl, f))[v], getattr(tl, f)[tv]) for f in ("wi", "li", "pdf")]
    pairs.append((np.asarray(jl.dist)[fin], tl.dist[torch.from_numpy(fin)]))
    if tag in BULK:
        close_bulk(*pairs[0], BULK[tag], bound=1e-2)
        for a, b in pairs[1:]:
            close_bulk(a, b, BULK[tag])
    else:
        for a, b in pairs:
            close(a, b)


def test_sample_li_mixed_ids(scenes):
    """A random light per lane, every branch selected in one call."""
    _, jsc, tsc = scenes
    p, u, lam = inputs(9)
    lid = np.random.RandomState(9).randint(-1, int(jsc.n_lights), N).astype(np.int32)
    jl = j_lights.sample_li(jsc, j_lights.light_records(jsc), jnp.asarray(lid),
                            jnp.asarray(p), jnp.asarray(lam), jnp.asarray(u))
    tl = lights.sample_li(tsc, lights.light_records(tsc), torch.from_numpy(lid).long(),
                          torch.from_numpy(p), torch.from_numpy(lam), torch.from_numpy(u))
    v = np.asarray(jl.valid)
    np.testing.assert_array_equal(v, tl.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jl.is_delta), tl.is_delta.numpy())
    for f in ("wi", "li", "pdf"):  # some lanes pick an area triangle or the portal
        close_bulk(np.asarray(getattr(jl, f))[v], getattr(tl, f)[torch.from_numpy(v)], 0.98)


def test_env_functions_match_jax(scenes):
    """env_le, env_pdf_dir, env_sample_dir and infinite_le on a map with a
    zero row and zero texels (equal neighbours in both cdfs)."""
    _, jsc, tsc = scenes
    rs = np.random.RandomState(4)
    d = rs.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lam = (360.0 + 470.0 * rs.rand(N, 4)).astype(np.float32)
    u = rs.rand(N, 2).astype(np.float32)
    # u on the marginal and conditional cdf values themselves
    marg = np.asarray(jsc.env_marg_cdf)
    u[:64, 1] = marg[rs.randint(0, len(marg), 64)]
    u[64:128, 0] = np.asarray(jsc.env_cond_cdf)[3, rs.randint(0, 17, 64)]
    close(j_lights.env_le(jsc, jnp.asarray(d), jnp.asarray(lam)),
          lights.env_le(tsc, torch.from_numpy(d), torch.from_numpy(lam)))
    close(j_lights.env_pdf_dir(jsc, jnp.asarray(d)),
          lights.env_pdf_dir(tsc, torch.from_numpy(d)))
    close(j_lights.infinite_le(jsc, jnp.asarray(d), jnp.asarray(lam)),
          lights.infinite_le(tsc, torch.from_numpy(d), torch.from_numpy(lam)))
    jd, jp = j_lights.env_sample_dir(jsc, jnp.asarray(u))
    td, tp = lights.env_sample_dir(tsc, torch.from_numpy(u))
    close(jd, td)
    close(jp, tp)
    assert (tp.numpy() > 0).all()  # zero-luminance texels are never picked
    assert lights.has_env_map(tsc) == j_lights.has_env_map(jsc)
    assert lights.has_portal(tsc) == j_lights.has_portal(jsc) == (scenes[0] == "portal")
    assert lights.portal_ids(lights.light_types(tsc)) == [
        i for i, t in enumerate(np.asarray(jsc.light_type)) if t == j_scene.LIGHT_PORTAL_ENV]


def test_portal_pdf_matches_jax():
    """portal_pdf_dir with the SAT warp tables and, the tables taken away,
    by the uniform-area quad pdf."""
    _, jsc, tsc = carried("portal")
    p, _, _ = inputs(5)
    rs = np.random.RandomState(5)
    d = rs.randn(N, 3).astype(np.float32) + np.array([0, 2.0, 0], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for strip in (False, True):
        js, ts = jsc, tsc
        if strip:
            js = jsc.replace(portal_sat=None)
            ts = tsc.replace(portal_sat=None)
        jp = j_lights.portal_pdf_dir(js, j_lights.light_records(js), jnp.asarray(p),
                                     jnp.asarray(d))
        tp = lights.portal_pdf_dir(ts, lights.light_records(ts), torch.from_numpy(p),
                                   torch.from_numpy(d))
        close(jp, tp)
        assert (tp.numpy() > 0).mean() > 0.05


def test_portal_tables_match_jax():
    """The env, portal and quadric tables and the light rows the two
    builders write."""
    sc = build_lights(j_scene, "portal")
    psc = build_lights(scene, "portal")
    np.testing.assert_allclose(psc.portal_frame, np.asarray(sc.portal_frame), atol=1e-6)
    np.testing.assert_allclose(psc.portal_sat, np.asarray(sc.portal_sat), atol=1e-6)
    np.testing.assert_allclose(psc.portal_img_coeffs, np.asarray(sc.portal_img_coeffs),
                               atol=1e-6)
    for f in ("env_coeffs", "env_cond_cdf", "env_marg_cdf", "env_marg_func", "env_luminance",
              "light_type", "light_pos", "light_params", "light_scale", "light_coeffs",
              "tri_shade", "tri_light", "bounds", "quad_type", "quad_params", "quad_mat"):
        np.testing.assert_array_equal(getattr(psc, f), np.asarray(getattr(sc, f)), err_msg=f)
    assert psc.feat_portal and sc.feat_portal


def test_portal_build_tables_direct():
    quad = np.array([[-2, 3.5, -2], [-2, 3.5, 2], [2, 3.5, 2], [2, 3.5, -2]], np.float32)
    from nn_bvh_tpu.scatter import portal as j_portal

    for frame in (None, j_portal.frame_from_quad(*quad)):
        jpic, jsat = j_portal.build_tables(env_image(), quad, res=64, frame=frame)
        tpic, tsat = portal.build_tables(env_image(), quad, res=64, frame=frame)
        np.testing.assert_allclose(tsat, jsat, atol=1e-6)
        np.testing.assert_allclose(tpic, jpic, atol=1e-6)


# ---------------------------------------------------------------------------
# light samplers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def many_lights():
    """tests/test_lights.py's many-light scene: 40 one-sided quad lights, a
    point light and a uniform infinite light, plus this slice's spot,
    distant and sphere lights and an env map."""
    rs = np.random.RandomState(0)
    b = j_scene.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))
    b.add_quad((-10, 0, -10), (10, 0, -10), (10, 0, 10), (-10, 0, 10), m)
    for _ in range(20):
        c = rs.rand(3) * np.array([16, 0, 16]) + np.array([-8, 3.0, -8])
        s = 0.3
        b.add_quad(c + (-s, 0, -s), c + (s, 0, -s), c + (s, 0, s), c + (-s, 0, s),
                   m, emission_rgb=rs.rand(3) * 0.9 + 0.1,
                   emission_scale=float(rs.rand() * 12 + 1), two_sided=bool(rs.rand() < 0.3))
    b.add_point_light((0, 5, 0), scale=3.0)
    b.add_uniform_infinite_light((1, 1, 1), scale=0.2)
    b.add_spot_light((2, 4, 1), (0, -1, 0.2), scale=5.0)
    b.add_distant_light((0.2, 1, 0.1), scale=0.7)
    b.add_sphere((-3, 2, 2), 0.5, m, n_theta=6, n_phi=12, emission_rgb=(1, 1, 1),
                 emission_scale=4.0)
    b.set_environment_map(env_image(8, 3), scale=0.3)
    sc, dbvh, _ = j_accel.build_scene_bvh(b.build())
    tsc, _ = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    return sc, tsc


def test_light_powers_match_jax(many_lights):
    sc, tsc = many_lights
    np.testing.assert_array_equal(lightsamplers.compute_light_powers(tsc),
                                  j_ls.compute_light_powers(sc))


@pytest.mark.parametrize("kind", ["bvh", "exhaustive"])
def test_sampler_tables_match_jax(many_lights, kind):
    sc, tsc = many_lights
    jt = j_ls.build(sc, kind)
    tt = lightsamplers.build(tsc, kind, "cpu")
    assert (tt.kind, tt.p_infinite, tt.bvh_depth, tt.has_bvh) == \
        (jt.kind, jt.p_infinite, jt.bvh_depth, jt.has_bvh)
    for f in ("pmf", "cdf", "node_blo", "node_bhi", "node_w", "node_cos", "node_phi",
              "node_meta", "light_trail", "light_in_bvh", "inf_ids"):
        np.testing.assert_allclose(getattr(tt, f).numpy().astype(np.float64),
                                   np.asarray(getattr(jt, f)).astype(np.float64),
                                   rtol=0, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("kind", ["bvh", "exhaustive"])
def test_sample_and_pmf_ctx_match_jax(many_lights, kind):
    """sample_ctx and pmf_ctx lane by lane; an id may differ only on a lane
    whose target lies within 1e-6 of a cdf boundary (counted)."""
    sc, tsc = many_lights
    jt = j_ls.build(sc, kind)
    tt = lightsamplers.build(tsc, kind, "cpu")
    p, u2, _ = inputs(21)
    p[:, 1] = p[:, 1] * 2.0 - 1.0
    u = u2[:, 0]
    jid, jpmf, ju = j_ls.sample_ctx(jt, jnp.asarray(p), jnp.asarray(u))
    tid, tpmf, tu = lightsamplers.sample_ctx(tt, torch.from_numpy(p), torch.from_numpy(u))
    jid = np.asarray(jid)
    same = jid == tid.numpy()
    flips = int((~same).sum())
    if flips:
        # every differing lane sits on a cdf boundary of the exhaustive sum
        assert kind == "exhaustive", flips
        imp = lightsamplers._exhaustive_importances(tt, torch.from_numpy(p)).double()
        csum = imp.cumsum(-1)
        pinf = np.float32(tt.p_infinite)
        ub = np.clip((u - pinf) / (np.float32(1) - pinf), 0, 1 - 2 ** -24)
        target = torch.from_numpy(ub).double() * imp.sum(-1)
        gap = (csum - target[:, None]).abs().min(-1).values.numpy()
        assert (gap[~same] < 1e-6 * np.maximum(target.numpy()[~same], 1)).all()
    assert flips <= 4, flips
    np.testing.assert_allclose(np.asarray(jpmf)[same], tpmf.numpy()[same], **TOL)
    # the remapped u divides by (1 - w0) at each step of the descent, by the
    # chosen light's importance in the exhaustive sum (the integrator does
    # not read it): TOL on >= 95% of the lanes
    close_bulk(np.asarray(ju)[same], tu[torch.from_numpy(same)], 0.95)
    L = int(sc.n_lights)
    ids = np.random.RandomState(22).randint(0, L, N).astype(np.int32)
    close(j_ls.pmf_ctx(jt, jnp.asarray(p), jnp.asarray(ids)),
          lightsamplers.pmf_ctx(tt, torch.from_numpy(p), torch.from_numpy(ids).long()))


@pytest.mark.parametrize("kind", ["bvh", "exhaustive"])
def test_pmf_consistency(many_lights, kind):
    """tests/test_lights.py:131's check on the port: pmf_ctx sums to 1 over
    the lights at a point, the histogram of sample_ctx matches it, and the
    pmf sample_ctx reports is pmf_ctx's."""
    _, tsc = many_lights
    t = lightsamplers.build(tsc, kind, "cpu")
    L = int(tsc.n_lights)
    pt = torch.tensor([1.0, 0.5, 2.0])
    pmfs = lightsamplers.pmf_ctx(t, pt.expand(L, 3), torch.arange(L)).numpy()
    assert abs(pmfs.sum() - 1.0) < 1e-3, pmfs.sum()
    n = 16384
    u = torch.from_numpy(np.random.RandomState(3).rand(n).astype(np.float32))
    lid, pmf_s, u2 = lightsamplers.sample_ctx(t, pt.expand(n, 3), u)
    assert (lid >= 0).all()
    hist = np.bincount(lid.numpy(), minlength=L) / n
    assert np.abs(hist - pmfs).max() < 0.03
    np.testing.assert_allclose(pmf_s.numpy(),
                               lightsamplers.pmf_ctx(t, pt.expand(n, 3), lid).numpy(),
                               rtol=1e-3, atol=1e-5)
    assert ((u2 >= 0) & (u2 < 1)).all()
