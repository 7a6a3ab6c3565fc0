"""Light tracing (LightPathIntegrator) and the FunctionIntegrator (port of
nn_bvh_tpu/wavefront/lightpath.py).

One wave is a dense batch of light subpaths started by `sample_le` (area
triangles, point and sphere lights); every surface vertex connects to the
pinhole camera through a shadow ray and splats into the film
(film.add_splats). The camera's importance is the pinhole's:
We = 1 / (A cos^4 theta) inside the frustum, SampleWi's pdf dist^2 / cos
theta. As in the JAX package there is no lens sampling, no shading-normal
correction of the transport asymmetry, and infinite lights start no light
path. `render_function` renders fn(u, v) over the image with a sampler
(the sampler-convergence harness); it runs no traversal.

Random numbers are hash_float(path, sample, seed, salt...) counters, the
JAX package's streams bit for bit. On the card the traversal calls go
through the sorting intersector (sort -> traverse -> unsort), as the JAX
package's default intersector sorts on its TPU backends.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel import dispatch
from ..core import vecmath as vm, sampling, spectrum, samplers, rng
from ..devices import resolve_device
from ..geometry import scene as scene_mod, triangle
from ..scatter import bxdf, lights, lightsamplers
from . import film as film_mod
from .integrator import IntegratorConfig, NoGradIntersectors, _shading_point


def _camera_screen_area(cam) -> float:
    """Area of the screen window on the z=1 plane."""
    tan_half = float(np.tan(np.deg2rad(cam.fov) / 2.0))
    aspect = cam.width / cam.height
    if aspect >= 1.0:
        return (2 * tan_half * aspect) * (2 * tan_half)
    return (2 * tan_half) * (2 * tan_half / aspect)


def camera_project(cam, p_world: torch.Tensor):
    """World points (R, 3) -> (flat pixel index (R,) int64, cos theta,
    valid) for the pinhole camera; the index is clamped into the image, as
    the JAX package clamps it, so an invalid lane still names a pixel."""
    m = torch.as_tensor(cam.cam_to_world, device=p_world.device)
    R3, t3 = m[:3, :3], m[:3, 3]
    pc = ((p_world - t3)[..., :, None] * R3).sum(-2)  # world -> camera (R3 orthonormal)
    z = pc[..., 2]
    valid = z > 1e-6
    sx = pc[..., 0] / torch.clamp(z, min=1e-6)
    sy = pc[..., 1] / torch.clamp(z, min=1e-6)
    tan_half = float(np.tan(np.deg2rad(cam.fov) / 2.0))
    aspect = cam.width / cam.height
    hx = tan_half * aspect if aspect >= 1.0 else tan_half
    hy = tan_half if aspect >= 1.0 else tan_half / aspect
    px = (sx / hx * 0.5 + 0.5) * cam.width
    py = (0.5 - sy / hy * 0.5) * cam.height
    inside = (px >= 0) & (px < cam.width) & (py >= 0) & (py < cam.height)
    pix = (torch.clamp(_to_i32(py), 0, cam.height - 1) * cam.width
           + torch.clamp(_to_i32(px), 0, cam.width - 1))
    cos_t = z / torch.clamp(vm.length(pc), min=1e-9)
    return pix, cos_t, valid & inside


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int toward zero, saturating at the int32 range (XLA's
    conversion; torch's is undefined out of range)."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), -2.0 ** 31, 2.0 ** 31 - 128).to(torch.int64)


def light_tri_verts(scene, rec):
    """The vertices (v0, v1, v2) of the triangle a gathered light record
    names (field 8), the index clamped into the table as XLA clamps a
    gather: field 8 of a sphere light is its radius, of a point light 0."""
    idx = torch.clamp(rec[..., 8].to(torch.int64), 0, scene.tri_shade.shape[0] - 1)
    tv = scene.tri_shade[idx][..., 0:9]
    return tv[..., 0:3], tv[..., 3:6], tv[..., 6:9]


def sample_le(scene, light_all, light_id, lam, u_pos, u_dir):
    """Light::SampleLe for area triangles, point and sphere lights ->
    (p, ng, dir, beta0, is_area): beta0 = Le cos / (pdf_pos pdf_dir), 0 for
    every other light type; is_area marks the area and sphere lights."""
    rec = light_all[torch.clamp(light_id, min=0).long()]
    ltype = rec[..., 0].to(torch.int32)
    emit = lights.record_spectrum(rec, lam)

    # area triangle: a uniform point on it, a cosine-weighted direction
    v0, v1, v2 = light_tri_verts(scene, rec)
    bary = sampling.sample_uniform_triangle(u_pos)
    p_area = bary[..., 0:1] * v0 + bary[..., 1:2] * v1 + bary[..., 2:3] * v2
    ng = triangle.geometric_normal(v0, v1, v2)
    area = torch.clamp(triangle.area(v0, v1, v2), min=1e-12)
    two_sided = rec[..., 9] > 0
    # a two-sided light emits from a random side (u_dir[0] reused)
    flip = two_sided & (u_dir[..., 0] > 0.5)
    u0 = torch.where(flip, 2 * u_dir[..., 0] - 1,
                     torch.where(two_sided, 2 * u_dir[..., 0], u_dir[..., 0]))
    ng_eff = torch.where(flip[..., None], -ng, ng)
    d_area = vm.from_local(ng_eff, sampling.sample_cosine_hemisphere(
        torch.stack([u0, u_dir[..., 1]], -1)))
    cos_l = torch.clamp(vm.dot(ng_eff, d_area), min=0.0)
    pdf_dir = sampling.cosine_hemisphere_pdf(cos_l)
    pdf_pos = 1.0 / area
    beta_area = emit * (cos_l / torch.clamp(pdf_pos * pdf_dir, min=1e-20))[..., None]
    beta_area = torch.where(two_sided[..., None], beta_area * 2.0, beta_area)

    # point light: uniform sphere
    lpos = rec[..., 1:4]
    d_pt = sampling.sample_uniform_sphere(u_dir)
    beta_pt = emit / sampling.UNIFORM_SPHERE_PDF

    # sphere area light: a uniform point, a cosine direction off the outward
    # normal (the inward one with probability 1/2 when two-sided)
    radius = rec[..., 8]
    n_sph = sampling.sample_uniform_sphere(u_pos)
    p_sph = lpos + radius[..., None] * n_sph
    flip_s = two_sided & (u_dir[..., 0] <= 0.5)
    u0s = torch.where(flip_s, 1.0 - 2.0 * u_dir[..., 0],
                      torch.where(two_sided, 2.0 * u_dir[..., 0] - 1.0, u_dir[..., 0]))
    n_sph_eff = torch.where(flip_s[..., None], -n_sph, n_sph)
    d_sph = vm.from_local(n_sph_eff, sampling.sample_cosine_hemisphere(
        torch.stack([u0s, u_dir[..., 1]], -1)))
    cos_sph = torch.clamp(vm.dot(n_sph_eff, d_sph), min=0.0)
    area_sph = torch.clamp(4.0 * np.pi * radius * radius, min=1e-12)
    pdf_dir_sph = sampling.cosine_hemisphere_pdf(cos_sph)
    beta_sph = emit * (cos_sph * area_sph / torch.clamp(pdf_dir_sph, min=1e-20))[..., None]
    beta_sph = torch.where(two_sided[..., None], beta_sph * 2.0, beta_sph)

    is_area = (ltype == scene_mod.LIGHT_AREA_TRI)[..., None]
    is_point = ltype == scene_mod.LIGHT_POINT
    is_sphere = (ltype == scene_mod.LIGHT_SPHERE_AREA)[..., None]
    p = torch.where(is_area, p_area, torch.where(is_sphere, p_sph, lpos))
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=p.device).expand(p.shape)
    ng_out = torch.where(is_area, ng_eff, torch.where(is_sphere, n_sph, z_axis))
    d = torch.where(is_area, d_area, torch.where(is_sphere, d_sph, d_pt))
    beta0 = torch.where(is_area, beta_area, torch.where(is_sphere, beta_sph, beta_pt))
    ok = is_area[..., 0] | is_point | is_sphere[..., 0]
    return p, ng_out, d, torch.where(ok[..., None], beta0, 0.0), is_area[..., 0] | is_sphere[..., 0]


def make_intersectors(scene, dbvh, device):
    """The intersectors of the light-tracing integrators (LightPath, BDPT,
    SPPM): on the card each call sorts its batch, traverses and unsorts."""
    return dispatch.make_intersectors(scene, dbvh, device, sort=device.type == "cuda")


def trace_light_wave(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig, n_paths: int,
                     sample_idx, ls_tables=None, isect=None, device=None):
    """One light-tracing wave of n_paths subpaths -> (splat pixel (n*D,),
    splat L, lam, lam_pdf) for film.add_splats, D = cfg.max_depth; a splat
    of a lane that is not connected goes to pixel 0 with L = 0. `scene`
    holds tensors on `device`."""
    device = resolve_device(device, scene)
    if ls_tables is None:
        ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = make_intersectors(scene, dbvh, device)
    isect = NoGradIntersectors(isect)
    R = n_paths
    path_idx = torch.arange(R, dtype=torch.int32, device=device)
    sidx = torch.as_tensor(sample_idx, dtype=torch.int32, device=device).expand(R)
    rand = lambda *salts: rng.hash_float(path_idx, sidx, sampler_cfg.seed, *salts)

    lam, lam_pdf = spectrum.sample_wavelengths_visible(rand(1))
    light_all = lights.light_records(scene)
    mat_all = bxdf.material_records(scene)
    kinds = bxdf.scene_kinds(scene)

    light_id, sel_pmf, _ = lightsamplers.sample(ls_tables, rand(2))
    p, ng, d, beta0, _ = sample_le(scene, light_all, light_id, lam,
                                   torch.stack([rand(3), rand(4)], -1),
                                   torch.stack([rand(5), rand(6)], -1))
    beta = beta0 / torch.clamp(sel_pmf, min=1e-12)[..., None]
    active = (light_id >= 0) & (beta > 0).any(-1)
    o = vm.offset_ray_origin(p, ng, d)

    cam_pos = torch.as_tensor(cam.cam_to_world, device=device)[:3, 3]
    A = _camera_screen_area(cam)
    splat_pix, splat_L = [], []
    # the light's own vertex is not splatted: the camera sees Le by hitting it
    for depth in range(cfg.max_depth):
        hit = isect.closest(o, d, torch.where(active, 1e30, -1.0))
        found = active & (hit.prim >= 0)
        sp = _shading_point(scene, hit, o, d)
        wo = -d
        ctx = bxdf.gather_material(scene, sp.mat, lam, mat_all, sp.uv, rand(7, depth),
                                   kinds=kinds)
        surf = found & (sp.mat >= 0)

        # connect the vertex to the camera: beta f cos We / pdf_wi
        to_cam = cam_pos - sp.p
        dist2 = torch.clamp(vm.length_squared(to_cam), min=1e-12)
        wi_cam = to_cam * torch.rsqrt(dist2)[..., None]
        pix, cos_cam, in_frustum = camera_project(cam, sp.p)
        f, _ = bxdf.evaluate(ctx, vm.to_local(sp.ns, wo), vm.to_local(sp.ns, wi_cam))
        cos_v = vm.absdot(wi_cam, sp.ns)
        want = surf & in_frustum & (f > 0).any(-1) & (cos_v > 0)
        so = vm.offset_ray_origin(sp.p, vm.face_forward(sp.ns, wi_cam), wi_cam)
        occluded = isect.any_hit(so, wi_cam, torch.where(want, torch.sqrt(dist2) * 0.999, -1.0))
        cos_c = torch.clamp(cos_cam, min=1e-6)
        we = 1.0 / (A * cos_c ** 4)
        pdf_wi = dist2 / cos_c
        ok = want & ~occluded
        splat_pix.append(torch.where(ok, pix, 0))
        splat_L.append(torch.where(ok[..., None],
                                   beta * f * (cos_v * we / pdf_wi)[..., None], 0.0))

        # continue the light path (importance transport)
        u2 = torch.stack([rand(9, depth), rand(10, depth)], -1)
        bs = bxdf.sample(ctx, vm.to_local(sp.ns, wo), rand(8, depth), u2, mode="importance")
        wi_world = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_world, sp.ns)
        beta = torch.where((surf & bs.valid)[..., None],
                           beta * bs.f * (cos_b / torch.clamp(bs.pdf, min=1e-20))[..., None],
                           beta)
        active = surf & bs.valid & (beta > 0).any(-1)
        # Russian roulette from depth 2
        if depth >= 2:
            q = torch.clamp(1.0 - beta.amax(-1), 0.0, 0.95)
            active = active & ~(active & (rand(11, depth) < q))
            beta = torch.where(active[..., None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[..., None], beta)
        ng_o = vm.face_forward(sp.ng, wi_world)
        o = torch.where(active[..., None], vm.offset_ray_origin(sp.p, ng_o, wi_world), o)
        d = torch.where(active[..., None], wi_world, d)

    reps = len(splat_pix)
    return (torch.cat(splat_pix), torch.cat(splat_L), lam.repeat(reps, 1),
            lam_pdf.repeat(reps, 1))


def render_lightpath(scene, dbvh, cam, spp: int = 16, sampler: str = "independent",
                     seed: int = 0, cfg: IntegratorConfig = IntegratorConfig(),
                     paths_per_wave: int | None = None, device=None,
                     isect=None) -> torch.Tensor:
    """LightPathIntegrator: spp waves of light subpaths splatted to the
    film, developed with splat_scale = pixels / (paths a wave * spp) ->
    (H, W, 3) linear sRGB. `isect` overrides the traversal backend."""
    device = resolve_device(device, scene)
    R = cam.width * cam.height
    n_paths = paths_per_wave or R
    sampler_cfg = samplers.make_sampler(sampler, seed=seed, spp=spp, width=cam.width)
    film = film_mod.make_film(cam.height, cam.width, device)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler, device)
    if isect is None:
        isect = make_intersectors(scene, dbvh, device)
    scene_d = scene_mod.to_device(scene, device)
    for s in range(spp):
        film = film_mod.add_splats(film, *trace_light_wave(
            scene_d, None, cam, sampler_cfg, cfg, n_paths, s, ls_tables, isect, device))
    return film_mod.develop(film, splat_scale=R / (n_paths * spp))


def render_function(fn, width: int = 128, height: int = 128, spp: int = 16,
                    sampler: str = "sobol", seed: int = 0, device=None) -> torch.Tensor:
    """FunctionIntegrator: the mean of fn(u, v) (tensors in, tensor out)
    over each pixel's samples -> (height, width) float32."""
    device = resolve_device(device)
    sampler_cfg = samplers.to_device(
        samplers.make_sampler(sampler, seed=seed, spp=spp, width=width), device)
    R = width * height
    pix = torch.arange(R, dtype=torch.int32, device=device)
    acc = torch.zeros(R, dtype=torch.float32, device=device)
    for s in range(spp):
        sidx = torch.full((R,), s, dtype=torch.int32, device=device)
        ux, uy = samplers.get_2d(sampler_cfg, pix, sidx, 0)
        px = ((pix % width).to(torch.float32) + ux) / width
        py = (torch.div(pix, width, rounding_mode="floor").to(torch.float32) + uy) / height
        acc = acc + fn(px, py)
    return (acc / spp).reshape(height, width)
