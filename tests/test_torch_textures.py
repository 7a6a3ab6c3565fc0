"""Textures of the torch port against the JAX package on the CPU: the mip
pyramid and atlas (bit for bit), `lookup` (level 0, rounded level and
trilinear), the textured material gather (base color and texture-driven mix
amounts), the projection and goniometric lights' sample_li, the noise
module, and the JAX package's texture and light tests on port renders.

Tolerances: the pyramid, atlas, noise tables, level-0 and rounded-level
lookups are equal. A trilinear lookup's level is foot_log2 + log2(width),
and XLA's log2 and torch's differ by an ulp: its fraction between levels
then differs by ~2.4e-7, times a coefficient step of up to ~60 between
levels. Trilinear coefficients are held within atol 1e-5 and the spectrum
they give at four wavelengths within atol 1e-6 and rtol 1e-5. Gathered reflectance, eta,
alphas and light directions, distances and pdfs are held within atol 1e-6
(rtol 1e-6); the lights' radiance within atol 1e-6 and rtol 2e-5, since
XLA's and torch's exp and sqrt round apart on sigmoid polynomials of large
coefficients.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nn_bvh_tpu import accel as j_accel
from nn_bvh_tpu.core import rgb2spec as j_rgb2spec
from nn_bvh_tpu.geometry import scene as j_scene, texture as j_texture, transform as j_xf
from nn_bvh_tpu.scatter import bxdf as j_bxdf, lights as j_lights
from nn_bvh_tpu.utils import noise as j_noise
from nn_bvh_tpu_torch import accel
from nn_bvh_tpu_torch.accel import dispatch
from nn_bvh_tpu_torch.core import rgb2spec
from nn_bvh_tpu_torch.geometry import scene, texture, transform
from nn_bvh_tpu_torch.scatter import bxdf, lights
from nn_bvh_tpu_torch.utils import noise
from nn_bvh_tpu_torch.wavefront import camera, integrator

torch.set_num_threads(1)


def images(rs):
    """Odd and even sizes, values above 1 (scaled coefficients), a 1-texel
    texture (its chain is one level)."""
    return [(rs.rand(37, 53, 3) * 1.6).astype(np.float32),
            rs.rand(8, 8, 3).astype(np.float32),
            rs.rand(1, 5, 3).astype(np.float32),
            np.full((1, 1, 3), 0.3, np.float32)]


def test_pyramid_and_atlas_equal_jax():
    rs = np.random.RandomState(0)
    imgs = images(rs)
    for im in imgs:
        for a, b in zip(texture.build_pyramid(im), j_texture.build_pyramid(im), strict=True):
            np.testing.assert_array_equal(a, b)
    ta, td = texture.pack_atlas(imgs)
    ja, jd = j_texture.pack_atlas(imgs)
    assert ta.dtype == np.float32 and td.dtype == np.int32
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(td, jd)


def lookup_inputs(n=4096):
    rs = np.random.RandomState(1)
    atlas, desc = texture.pack_atlas(images(rs))
    uv = (rs.rand(n, 2) * 6 - 3).astype(np.float32)
    uv[:256] = np.round(uv[:256])               # exact integers
    uv[256:320] = -1e-9                         # wraps to exactly 1.0
    uv[320:384, 0] = np.float32(1.0) - 1e-8
    tex_id = rs.randint(-3, 6, n).astype(np.int32)  # out of range both ways
    foot = (rs.rand(n) * 18 - 14).astype(np.float32)  # below level 0 to past the top
    return atlas, desc, tex_id, uv, foot


@pytest.mark.parametrize("mode", ["level0", "rounded", "trilinear"])
def test_lookup_matches_jax(mode):
    atlas, desc, tex_id, uv, foot = lookup_inputs()
    kw = dict(level0=dict(foot_log2=None), rounded=dict(trilinear=False),
              trilinear={})[mode]
    jf = None if mode == "level0" else jnp.asarray(foot)
    tf = None if mode == "level0" else torch.from_numpy(foot)
    kw = {k: v for k, v in kw.items() if k != "foot_log2"}
    j = np.asarray(j_texture.lookup(jnp.asarray(atlas), jnp.asarray(desc), jnp.asarray(tex_id),
                                    jnp.asarray(uv), foot_log2=jf, **kw))
    t = texture.lookup(torch.from_numpy(atlas), torch.from_numpy(desc),
                       torch.from_numpy(tex_id), torch.from_numpy(uv), foot_log2=tf, **kw)
    assert t.shape == (4096, 4) and t.dtype == torch.float32
    if mode != "trilinear":
        np.testing.assert_allclose(t.numpy(), j, atol=1e-6, rtol=0)
        return
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=0)
    lam = np.random.RandomState(2).uniform(360, 830, (4096, 4)).astype(np.float32)
    js = np.asarray(j_rgb2spec.eval_sigmoid_poly(jnp.asarray(j[:, :3]), jnp.asarray(lam))) \
        * j[:, 3:]
    ts = rgb2spec.eval_sigmoid_poly(t[:, :3], torch.from_numpy(lam)) * t[:, 3:]
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-6, rtol=1e-5)


def test_lookup_indices_stay_in_range():
    """Non-finite uv and footprints clamp like XLA's gathers instead of
    indexing out of the tables (which stops a CUDA device)."""
    atlas, desc, tex_id, uv, foot = lookup_inputs(64)
    uv[:8] = np.nan
    uv[8:16] = np.inf
    foot[16:24] = np.nan
    foot[24:32] = -np.inf
    t = texture.lookup(torch.from_numpy(atlas), torch.from_numpy(desc), torch.from_numpy(tex_id),
                       torch.from_numpy(uv), foot_log2=torch.from_numpy(foot))
    assert t.shape == (64, 4)
    assert torch.isfinite(t[32:]).all()


def textured_scene(mod, untextured=False):
    """A checkerboard, an image texture, a procedural texture, a mix whose
    amount is a texture, and a projection and a goniometric light."""
    rs = np.random.RandomState(3)
    b = mod.SceneBuilder()
    plain = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.8, 0.5), roughness=0.2)
    if untextured:
        mats = [plain, metal, b.add_material("mix", mix_materials=(plain, metal),
                                             mix_amount=0.3)]
    else:
        chk = b.add_texture_checker((0.1, 0.2, 0.8), (0.9, 0.9, 0.1), uscale=4)
        img = b.add_texture_image((rs.rand(19, 24, 3) * 1.2).astype(np.float32))
        fbm = b.add_texture_procedural("fbm", seed=2)
        mask = b.add_texture_image(rs.rand(16, 16, 3).astype(np.float32))
        mats = [plain, metal,
                b.add_material("diffuse", texture=chk),
                b.add_material("coateddiffuse", texture=img, roughness=0.1),
                b.add_material("diffuse", texture=fbm),
                b.add_material("mix", mix_materials=(plain, metal), mix_amount=-(mask + 1.0)),
                b.add_material("mix", mix_materials=(metal, plain), mix_amount=0.7)]
        b.add_projection_light((0, 4, -1), (0, -1, 0.2), rs.rand(12, 10, 3).astype(np.float32),
                               scale=3.0, fov=50.0)
        b.add_goniometric_light((1, 3, 0), (rs.rand(16, 16, 3) + 0.1).astype(np.float32),
                                intensity_rgb=(1.0, 0.8, 0.6), scale=2.0)
    b.add_point_light((0, 5, 0), scale=4.0)
    for i, m in enumerate(mats):
        b.add_quad((i, 0, 0), (i + 1, 0, 0), (i + 1, 0, 1), (i, 0, 1), m,
                   uvs=np.asarray([(0, 0), (2, 0), (2, 3), (0, 3)], np.float32))
    return b.build()


@pytest.fixture(scope="module")
def tex_scenes():
    js = textured_scene(j_scene)
    ts = textured_scene(scene)
    sc, dbvh, _ = j_accel.build_scene_bvh(js)
    tsc, _ = scene.scene_from_numpy(sc._asdict(), dbvh._asdict(), "cpu")
    return js, ts, sc, tsc


def test_builder_tables_equal_jax(tex_scenes):
    js, ts, _, _ = tex_scenes
    for name in ("tex_atlas", "tex_desc", "mat_type", "mat_params", "light_type",
                 "light_params", "light_pos", "tri_uv", "tri_mat"):
        np.testing.assert_array_equal(getattr(ts, name), np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_allclose(ts.light_scale, np.asarray(js.light_scale), rtol=1e-6)
    assert ts.tex_desc.dtype == np.int32


def test_medium_kinds_are_grids_like_jax():
    rs = np.random.RandomState(4)
    dens = rs.rand(9, 7, 5).astype(np.float32)
    for kind in ("cloud", "rgbgrid", "nanovdb", "grid"):
        jb, tb = j_scene.SceneBuilder(), scene.SceneBuilder()
        for b in (jb, tb):
            b.add_medium(kind, sigma_a=(0.1, 0.2, 0.3), sigma_s=(1, 1, 1), density=dens,
                         bounds=((0, 0, 0), (1, 2, 1)))
            b.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), b.add_material())
        j, t = jb.build(), tb.build()
        assert t.med_type.tolist() == np.asarray(j.med_type).tolist() == [scene.MED_GRID]
        for name in ("med_grids", "med_maj_grids", "med_bounds", "med_max_density"):
            np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(j, name)))


def test_gather_matches_jax(tex_scenes):
    """Reflectance (textured and not), alphas, eta and the mix resolution
    (a texture amount among them) per lane, trilinear at random footprints
    and at level 0."""
    _, _, sc, tsc = tex_scenes
    rs = np.random.RandomState(5)
    n = 2048
    M = len(np.asarray(sc.mat_type))
    mat_id = rs.randint(-1, M, n).astype(np.int32)
    uv = (rs.rand(n, 2) * 5 - 2).astype(np.float32)
    lam = rs.uniform(360, 830, (n, 4)).astype(np.float32)
    u_mix = rs.rand(n).astype(np.float32)
    foot = (rs.rand(n) * 14 - 12).astype(np.float32)
    jsc = j_scene.to_device(sc)
    for f in (foot, None):
        jc = j_bxdf.gather_material(jsc, jnp.asarray(mat_id), jnp.asarray(lam), uv=jnp.asarray(uv),
                                    u_mix=jnp.asarray(u_mix),
                                    foot_log2=None if f is None else jnp.asarray(f))
        tc = bxdf.gather_material(tsc, torch.from_numpy(mat_id), torch.from_numpy(lam),
                                  uv=torch.from_numpy(uv), u_mix=torch.from_numpy(u_mix),
                                  foot_log2=None if f is None else torch.from_numpy(f))
        np.testing.assert_array_equal(tc.mat_type.numpy(), np.asarray(jc.mat_type))
        for name in ("refl", "ax", "ay", "eta", "k"):
            np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                       atol=1e-6, rtol=0, err_msg=name)
    # both mix outcomes and textured lanes occur
    mt = tc.mat_type.numpy()
    assert (mt == scene.MAT_CONDUCTOR).sum() > 100 and (mt == scene.MAT_COATED_DIFFUSE).sum() > 100


def test_lookups_gated_on_scene_kinds(tex_scenes, monkeypatch):
    """An untextured scene makes no lookup (so launches what it did before
    textures); a textured one makes one per lookup its materials need."""
    calls = []
    real = texture.lookup
    monkeypatch.setattr(texture, "lookup", lambda *a, **k: calls.append(1) or real(*a, **k))
    plain = scene.to_device(textured_scene(scene, untextured=True), "cpu")
    assert not {bxdf.TEXTURED, bxdf.MIX_TEXTURE} & bxdf.scene_kinds(plain)
    n = 64
    args = (torch.zeros(n, dtype=torch.int32), torch.full((n, 4), 550.0))
    kw = dict(uv=torch.rand(n, 2), u_mix=torch.rand(n), foot_log2=torch.zeros(n))
    bxdf.gather_material(plain, *args, **kw)
    tags = lights.scene_tags(plain)
    lights.sample_li(plain, lights.light_records(plain), torch.zeros(n, dtype=torch.int32),
                     torch.rand(n, 3), args[1], torch.rand(n, 2), tags)
    assert calls == []
    tsc = tex_scenes[3]
    assert {bxdf.TEXTURED, bxdf.MIX_TEXTURE} <= bxdf.scene_kinds(tsc)
    bxdf.gather_material(tsc, *args, **kw)
    assert len(calls) == 2  # base color + mix amount


def test_projection_goniometric_sample_li_match_jax(tex_scenes):
    _, _, sc, tsc = tex_scenes
    rs = np.random.RandomState(6)
    n = 1024
    lt = np.asarray(sc.light_type)
    ids = np.flatnonzero((lt == scene.LIGHT_PROJECTION) | (lt == scene.LIGHT_GONIOMETRIC))
    assert len(ids) == 2
    light_id = rs.choice(np.concatenate([ids, [int(np.flatnonzero(lt == 0)[0])]]), n)
    light_id = light_id.astype(np.int32)
    p = (rs.rand(n, 3) * np.array([8, 4, 3]) - np.array([1, 0, 1])).astype(np.float32)
    lam = rs.uniform(360, 830, (n, 4)).astype(np.float32)
    u2 = rs.rand(n, 2).astype(np.float32)
    jsc = j_scene.to_device(sc)
    j = j_lights.sample_li(jsc, j_lights.light_records(jsc), jnp.asarray(light_id),
                           jnp.asarray(p), jnp.asarray(lam), jnp.asarray(u2))
    t = lights.sample_li(tsc, lights.light_records(tsc), torch.from_numpy(light_id),
                         torch.from_numpy(p), torch.from_numpy(lam), torch.from_numpy(u2))
    for name in ("wi", "dist", "pdf"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(t.li.numpy(), np.asarray(j.li), atol=1e-6, rtol=2e-5)
    for name in ("is_delta", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    proj = light_id == ids[0]
    assert (t.li.numpy()[proj].max(-1) > 0).any() and (t.li.numpy()[proj].max(-1) == 0).any()


def test_noise_equal_jax():
    rs = np.random.RandomState(7)
    p = (rs.rand(500, 3) * 20 - 10).astype(np.float32)
    np.testing.assert_array_equal(noise.perlin(p, seed=3), j_noise.perlin(p, seed=3))
    np.testing.assert_array_equal(noise.fbm(p, 5, 0.6), j_noise.fbm(p, 5, 0.6))
    np.testing.assert_array_equal(noise.turbulence(p, 4), j_noise.turbulence(p, 4))
    np.testing.assert_array_equal(noise.dnoise(p), j_noise.dnoise(p))
    np.testing.assert_array_equal(noise.cloud_density(p), j_noise.cloud_density(p))
    for kind in ("fbm", "wrinkled", "windy", "marble", "dots"):
        np.testing.assert_array_equal(noise.bake(kind, res=32, seed=1),
                                      j_noise.bake(kind, res=32, seed=1), err_msg=kind)
    np.testing.assert_array_equal(noise.cloud_density_grid(res=24, wispiness=0.5),
                                  j_noise.cloud_density_grid(res=24, wispiness=0.5))


# ---------------------------------------------------------------------------
# the JAX package's texture and light tests, on the port
# ---------------------------------------------------------------------------

def primary_gathers(sc, dbvh, cam, jsc):
    """Camera rays through pixel centres of the port's scene; the port's and
    the JAX package's gather at the hits (the uv and cone footprint the
    port's wave would give) -> (port refl, JAX refl, hit mask)."""
    n = cam.width * cam.height
    tsc = scene.to_device(sc, "cpu")
    pix = torch.arange(n, dtype=torch.int32)
    half = torch.full((n, 2), 0.5)
    o, d = camera.generate_rays(cam, pix, half, half)
    hit = dispatch.make_intersectors(tsc, dbvh, "cpu").closest(o, d, torch.full((n,), 1e30))
    sp = integrator._shading_point(tsc, hit, o, d)
    spread = texture.camera_spread(cam.fov, cam.height)
    foot = texture.cone_foot_log2(sp.t * spread, (d * sp.ns).sum(-1).abs(), sp.uv_scale)
    lam = torch.full((n, 4), 550.0)
    found = hit.prim >= 0
    foot = torch.where(found, foot, 0.0)
    tc = bxdf.gather_material(tsc, sp.mat, lam, uv=sp.uv, foot_log2=foot)
    jc = j_bxdf.gather_material(jsc, jnp.asarray(sp.mat.numpy()), jnp.asarray(lam.numpy()),
                                uv=jnp.asarray(sp.uv.numpy()), foot_log2=jnp.asarray(foot.numpy()))
    return tc.refl.numpy(), np.asarray(jc.refl), found.numpy()


def ported_scene(build):
    """The same builder calls through both packages -> (port scene and
    BVH, JAX scene with the port's triangle order, as device arrays)."""
    tsc, dbvh, _ = accel.build_scene_bvh(build(scene).build(), method="sah_numpy")
    jsc, _, _ = j_accel.build_scene_bvh(build(j_scene).build(), method="sah_numpy")
    return tsc, dbvh, j_scene.to_device(jsc)


def test_checker_texture_renders_two_tones():
    """tests/test_render.py's checker test on the port, and the port's
    gathered reflectance at its primary hits against JAX's."""
    def build(mod):
        b = mod.SceneBuilder()
        tex = b.add_texture_checker((0.05, 0.05, 0.05), (0.9, 0.9, 0.9), uscale=4)
        m = b.add_material("diffuse", texture=tex)
        verts = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32)
        b.add_mesh(verts, np.array([[0, 1, 2], [0, 2, 3]]), m,
                   uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
        b.add_point_light((0, 3, 0), (1, 1, 1), scale=10.0)
        return b

    sc, dbvh, jsc = ported_scene(build)
    cam = camera.make_perspective(transform.look_at((0, 3.5, -0.01), (0, 0, 0), (0, 1, 0)),
                                  fov=60.0, width=16, height=16)
    t, j, found = primary_gathers(sc, dbvh, cam, jsc)
    assert found.mean() > 0.5
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    img = integrator.render(sc, dbvh, cam, spp=4, device="cpu",
                            cfg=integrator.IntegratorConfig(max_depth=1, mis=True)).numpy()
    lum = img.mean(-1).reshape(-1)
    lit = lum[lum > 1e-5]
    assert len(lit) > 50
    bright = lit > np.median(lit)
    assert lit[bright].mean() > 4 * max(lit[~bright].mean(), 1e-6)


def test_mipmap_minification_no_alias():
    """tests/test_render.py's LOD test on the port (a 64-per-uv checker on a
    receding plane: the far band's pixels cluster near the mean), and the
    trilinear reflectance at its primary-hit footprints against JAX's."""
    def build(mod):
        b = mod.SceneBuilder()
        tex = b.add_texture_checker((0.1, 0.1, 0.1), (0.9, 0.9, 0.9), uscale=64)
        m = b.add_material("diffuse", texture=tex)
        b.add_quad((-20, 0, 0), (20, 0, 0), (20, 0, 120), (-20, 0, 120), m,
                   uvs=np.asarray([(0, 0), (40, 0), (40, 120), (0, 120)], np.float32))
        b.add_uniform_infinite_light((1, 1, 1), scale=1.0)
        return b

    sc, dbvh, jsc = ported_scene(build)
    cam = camera.make_perspective(transform.look_at((0, 1.0, 0), (0, 0.85, 4), (0, 1, 0)),
                                  fov=40.0, width=48, height=48)
    t, j, found = primary_gathers(sc, dbvh, cam, jsc)
    assert found.mean() > 0.3
    np.testing.assert_allclose(t[found], j[found], atol=1e-6, rtol=0)
    img = integrator.render(sc, dbvh, cam, spp=8, sampler="independent", device="cpu",
                            cfg=integrator.IntegratorConfig(max_depth=2)).numpy()
    far = img[26:31, 8:-8].mean(-1)
    assert far.std() < 0.08, (far.std(), far.mean())
    assert 0.05 < far.mean() < 0.9


def li_at(mod_scene, mod_lights, sc, light_id, p, xp, u=(0.3, 0.7)):
    return mod_lights.sample_li(sc, mod_lights.light_records(sc), xp.asarray([light_id]),
                                xp.asarray([p], dtype=xp.float32), xp.full((1, 4), 550.0),
                                xp.asarray([u], dtype=xp.float32))


def light_scene(mod, kind):
    b = mod.SceneBuilder()
    m = b.add_material("diffuse")
    b.add_quad((-1, -1, -5), (1, -1, -5), (1, 1, -5), (-1, 1, -5), m)
    if kind == "projection":
        img = np.zeros((8, 8, 3), np.float32)
        img[:, :4] = (1, 0, 0)
        img[:, 4:] = (0, 1, 0)
        ids = [b.add_projection_light((0, 0, 0), (0, 0, 1), img, fov=60.0)]
    else:
        ids = [b.add_goniometric_light((0, 0, 0), np.ones((8, 8, 3), np.float32), scale=2.0),
               b.add_point_light((0, 0, 0), scale=2.0)]
    return b.build(), ids


def both_li(kind, which, p):
    jsc, ids = light_scene(j_scene, kind)
    tsc, _ = light_scene(scene, kind)
    j = np.asarray(li_at(j_scene, j_lights, j_scene.to_device(jsc), ids[which], p, jnp).li)
    t = li_at(scene, lights, scene.to_device(tsc, "cpu"), ids[which], p, torch).li.numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=1e-6)
    return t


def test_projection_light_frustum():
    """tests/test_lights.py's frustum test: lit inside, dark far outside."""
    assert both_li("projection", 0, (0, 0, 3)).mean() > 0
    assert both_li("projection", 0, (10, 0, 1)).mean() == 0.0


def test_goniometric_uniform_map_matches_point():
    a = both_li("goniometric", 0, (1, 2, 3))
    c = both_li("goniometric", 1, (1, 2, 3))
    assert np.allclose(a, c, rtol=0.02), (a, c)


def test_camera_spread_and_footprint_equal_jax():
    assert texture.camera_spread(50.0, 400) == j_texture.camera_spread(50.0, 400)
    rs = np.random.RandomState(8)
    w, c, s = (rs.rand(3, 256).astype(np.float32) * np.float32(2.0))
    j = np.asarray(j_texture.cone_foot_log2(jnp.asarray(w), jnp.asarray(c - 0.5), jnp.asarray(s)))
    t = texture.cone_foot_log2(torch.from_numpy(w), torch.from_numpy(c - 0.5), torch.from_numpy(s))
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6, rtol=1e-6)
    assert math.isfinite(float(t.min()))


def test_one_texel_atlas_is_no_texture():
    """A reference quirk the port mirrors: an atlas of one texel counts as
    no texture (`tex_atlas.size > 4` in the JAX package), so a material
    whose only texture is a 1x1 image shades with its row's color."""
    def build(mod):
        b = mod.SceneBuilder()
        red = b.add_texture_image(np.array([[[0.9, 0.05, 0.05]]], np.float32))
        m = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5), texture=red)
        b.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), m)
        return b.build()

    js, ts = build(j_scene), build(scene)
    assert ts.tex_atlas.shape == (1, 4) and ts.mat_params[0, 5] == 0
    n = 8
    lam = np.tile(np.array([[450.0, 520.0, 600.0, 680.0]], np.float32), (n, 1))
    uv = np.random.RandomState(9).rand(n, 2).astype(np.float32)
    j = j_bxdf.gather_material(j_scene.to_device(js), jnp.zeros(n, jnp.int32), jnp.asarray(lam),
                               uv=jnp.asarray(uv))
    t = bxdf.gather_material(scene.to_device(ts, "cpu"), torch.zeros(n, dtype=torch.int32),
                             torch.from_numpy(lam), uv=torch.from_numpy(uv))
    np.testing.assert_allclose(t.refl.numpy(), np.asarray(j.refl), atol=1e-6)
    assert np.ptp(t.refl.numpy()) < 1e-3  # the row's flat grey, not the red texel
