"""Cameras: batched ray generation (port of nn_bvh_tpu/wavefront/camera.py):
the perspective camera with thin-lens depth of field, the orthographic
camera, the spherical camera (equirectangular and equal-area mappings) and
the realistic camera, which traces film rays through a stack of spherical
lens elements. Perspective and orthographic cameras take camera motion
blur. The camera is host configuration; rays land on the device of the
pixel-index tensor."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import sampling, vecmath as vm

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
SPHERICAL_EQUIRECT = 2
SPHERICAL_EQUALAREA = 3
REALISTIC = 4


class Camera(NamedTuple):
    cam_to_world: np.ndarray  # (4,4) f32, pbrt LookAt convention (+z forward)
    fov: float                # degrees, shorter image axis (perspective; 0 otherwise)
    width: int
    height: int
    lens_radius: float        # thin-lens aperture (0 = pinhole)
    focal_distance: float
    # camera motion blur: K pre-slerped cam_to_world keyframes over the
    # shutter interval (with_motion); None = static camera
    motion_keys: np.ndarray | None = None  # (K, 4, 4) f32
    kind: int = PERSPECTIVE
    screen_scale: float = 1.0               # orthographic half-height
    # realistic camera: (E, 4) f32 rows rear-to-front, [curvature radius,
    # gap from the previous surface (the film for row 0), IOR of the medium
    # after the surface toward the scene, aperture radius], millimeters
    lens_elements: np.ndarray | None = None
    film_diag: float = 0.035                # film diagonal (make_realistic: mm)


def make_perspective(cam_to_world, fov: float, width: int, height: int,
                     lens_radius: float = 0.0, focal_distance: float = 1e6) -> Camera:
    return Camera(np.array(cam_to_world, np.float32), float(fov), int(width),
                  int(height), float(lens_radius), float(focal_distance))


def make_orthographic(cam_to_world, half_height: float, width: int, height: int) -> Camera:
    return Camera(np.array(cam_to_world, np.float32), 0.0, int(width), int(height), 0.0, 1e6,
                  kind=ORTHOGRAPHIC, screen_scale=float(half_height))


def make_spherical(cam_to_world, width: int, height: int, mapping: str = "equalarea") -> Camera:
    """The whole sphere in one image; mapping 'equirectangular' (or
    'equirect') or 'equalarea' (the octahedral default)."""
    kind = {"equirectangular": SPHERICAL_EQUIRECT, "equirect": SPHERICAL_EQUIRECT,
            "equalarea": SPHERICAL_EQUALAREA}[mapping]
    return Camera(np.array(cam_to_world, np.float32), 0.0, int(width), int(height), 0.0, 1e6,
                  kind=kind)


# Built-in lens: a symmetric biconvex singlet (f ~ 48 mm for R = 50, n =
# 1.52) with a front aperture stop; rows as Camera.lens_elements
_BICONVEX = np.array(
    [
        #  curv   gap    eta    ap
        [50.0, 48.0, 1.52, 12.0],   # rear surface (convex toward film)
        [-50.0, 6.0, 1.0, 12.0],    # front surface (into air)
        [0.0, 1.0, 1.0, 9.0],       # aperture stop
    ],
    np.float32,
)


def make_realistic(cam_to_world, width: int, height: int, lens_elements=None,
                   aperture_diameter: float | None = None, focus_distance: float = 1000.0,
                   film_diag: float = 35.0) -> Camera:
    """A camera that traces film rays through a lens-element stack (mm, as
    pbrt's lens files). aperture_diameter resizes the stop (rows of zero
    curvature); the rear gap is set so that the plane at focus_distance
    (mm) images onto the film (`_focus_lens`)."""
    el = np.array(lens_elements if lens_elements is not None else _BICONVEX,
                  np.float32).reshape(-1, 4)
    if aperture_diameter is not None:
        stop = np.abs(el[:, 0]) < 1e-6
        el[stop, 3] = aperture_diameter / 2.0
    el = _focus_lens(el, focus_distance)
    return Camera(np.array(cam_to_world, np.float32), 0.0, int(width), int(height), 0.0,
                  float(focus_distance), kind=REALISTIC, lens_elements=el,
                  film_diag=float(film_diag))


def _trace_lenses_from_film(elements: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """Camera-space rays from the film at z = 0 (+z into the lens) through
    the elements (E, 4), rear to front -> (o', d', valid). A ray that
    misses a surface, falls outside its aperture or is totally reflected
    keeps its last (o, d) and is not valid."""
    valid = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    z = torch.zeros((), dtype=torch.float32, device=o.device)
    zero3 = torch.zeros(3, dtype=torch.float32, device=o.device)
    for i in range(elements.shape[0]):
        curv, thick, eta_next, ap = elements[i].unbind()
        z = z + thick
        is_stop = curv.abs() < 1e-6
        # a sphere centered at z + curv, or the stop's plane at z
        oz, dz = o[..., 2], d[..., 2]
        t_plane = (z - oz) / torch.where(dz.abs() < 1e-9, 1e-9, dz)
        center = z + curv
        axis_c = torch.stack([zero3[0], zero3[1], center])
        oc = o - axis_c
        b = vm.dot(oc, d)
        c = vm.length_squared(oc) - curv * curv
        disc = b * b - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        use_near = (dz > 0) ^ (curv < 0)
        t_sph = torch.where(use_near, -b - sq, -b + sq)
        t = torch.where(is_stop, t_plane, t_sph)
        ok = torch.where(is_stop, t_plane > 0, (disc >= 0) & (t > 1e-7))
        p = o + t[..., None] * d
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        ok = ok & (r2 <= ap * ap)
        n = vm.face_forward(vm.normalize(p - axis_c), -d)
        eta_prev = elements[i - 1, 2] if i > 0 else torch.ones((), device=o.device)
        eta_rel = torch.where(is_stop, 1.0,
                              eta_prev / torch.where(eta_next < 1e-6, 1.0, eta_next))
        ok_r, _, wt = vm.refract(-d, n, 1.0 / torch.clamp(eta_rel, min=1e-6))
        d_new = torch.where(is_stop | ~ok_r[..., None], d, wt)
        ok = ok & (is_stop | ok_r)
        o = torch.where(ok[..., None], p, o)
        d = torch.where(ok[..., None], vm.normalize(d_new), d)
        valid = valid & ok
    return o, d, valid


def _focus_lens(el: np.ndarray, focus_distance: float) -> np.ndarray:
    """The lens with its rear gap (row 0's) set so that the plane at
    focus_distance (mm) images onto the film: a host bisection of 48 steps
    on where two traced film rays cross. The traces run in float32 on the
    CPU whatever the camera's device, so the decisions are the same on
    every device."""
    def film_blur(extra):
        e = el.copy()
        e[0, 1] += extra
        o = torch.zeros(2, 3, dtype=torch.float32)
        r = 0.3 * e[-1, 3]
        d = torch.tensor([[r, 0.0, e[:, 1].sum()], [-r, 0.0, e[:, 1].sum()]],
                         dtype=torch.float32)
        d = d / torch.from_numpy(np.linalg.norm(d.numpy(), axis=-1, keepdims=True))
        oo, dd, ok = _trace_lenses_from_film(torch.from_numpy(e), o, d)
        oo, dd = oo.numpy(), dd.numpy()
        if not bool(ok.all()):
            return None
        # the two exit rays' crossing in the x-z plane
        a = np.array([[dd[0, 0], -dd[1, 0]], [dd[0, 2], -dd[1, 2]]])
        b = np.array([oo[1, 0] - oo[0, 0], oo[1, 2] - oo[0, 2]])
        try:
            t = np.linalg.solve(a, b)
        except np.linalg.LinAlgError:
            return None
        zc = oo[0, 2] + t[0] * dd[0, 2]
        return zc - el[:, 1].sum()  # distance past the front vertex

    lo, hi = -0.5 * el[0, 1], 10.0
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        zb = film_blur(mid)
        if zb is None or zb < 0 or zb > focus_distance:
            # a diverging exit fan (film inside the focal length) or a
            # focus too far: more gap
            lo = mid
        else:
            hi = mid
    out = el.copy()
    out[0, 1] = max(out[0, 1] + 0.5 * (lo + hi), 1.0)
    return out


def interpolate_motion(cam: Camera, u_time: torch.Tensor) -> torch.Tensor:
    """Per-lane camera matrices (R, 4, 4) at shutter times u_time (R,) in
    [0, 1): a piecewise-linear blend of the pre-slerped keyframes."""
    keys = torch.as_tensor(cam.motion_keys, device=u_time.device)
    K = keys.shape[0]
    f = torch.clamp(u_time, 0.0, 1.0 - 1e-6) * (K - 1)
    i0 = f.to(torch.int64)
    fr = (f - i0.to(torch.float32))[..., None, None]
    return keys[i0] * (1.0 - fr) + keys[i0 + 1] * fr


def with_motion(cam: Camera, cam_to_world_end, n_keys: int = 16) -> Camera:
    """The camera with a shutter-close transform: n_keys matrices slerped
    between cam_to_world (shutter open) and cam_to_world_end."""
    from ..geometry import animated

    at = animated.AnimatedTransform(np.asarray(cam.cam_to_world), 0.0,
                                    np.asarray(cam_to_world_end), 1.0)
    keys = np.stack([at.interpolate(i / (n_keys - 1)) for i in range(n_keys)])
    return cam._replace(motion_keys=keys.astype(np.float32))


def _to_world(cam: Camera, o_cam, d_cam):
    """Camera-space rays through cam_to_world, as broadcast multiply-sums
    (full float32, no TF32 matmul path)."""
    m = torch.as_tensor(cam.cam_to_world, device=o_cam.device)
    R, t = m[:3, :3], m[:3, 3]
    return (o_cam[..., None, :] * R).sum(-1) + t, (d_cam[..., None, :] * R).sum(-1)


def generate_rays(cam: Camera, pixel_idx: torch.Tensor, u_pixel: torch.Tensor,
                  u_lens: torch.Tensor, u_time: torch.Tensor | None = None):
    """pixel_idx (R,) flat index; u_pixel/u_lens (R,2); u_time (R,) shutter
    times of a moving camera (ignored for a static one, and by the spherical
    and realistic cameras) -> world (o, d). The screen window spans the
    shorter image axis, +y up."""
    W, H = cam.width, cam.height
    dev = pixel_idx.device
    px = (pixel_idx % W).to(torch.float32) + u_pixel[..., 0]
    py = torch.div(pixel_idx, W, rounding_mode="floor").to(torch.float32) + u_pixel[..., 1]
    aspect = W / H
    sx = 2.0 * px / W - 1.0
    sy = 1.0 - 2.0 * py / H
    if aspect >= 1.0:
        sx = sx * aspect
    else:
        sy = sy / aspect

    if cam.kind in (SPHERICAL_EQUIRECT, SPHERICAL_EQUALAREA):
        u, v = px / W, py / H
        if cam.kind == SPHERICAL_EQUIRECT:
            theta, phi = math.pi * v, 2.0 * math.pi * u
            st, ct = torch.sin(theta), torch.cos(theta)
            d_cam = torch.stack([st * torch.cos(phi), ct, st * torch.sin(phi)], -1)
        else:
            d_cam = vm.equal_area_square_to_sphere(torch.stack([u, v], -1))
        return _to_world(cam, torch.zeros_like(d_cam), d_cam)

    if cam.kind == REALISTIC:
        # a film point (inverted through the lens) aimed at a sampled point
        # of the rear element's disk, traced through the stack; lens units
        # are mm, the exit origin is rescaled to scene meters
        el = torch.as_tensor(cam.lens_elements, dtype=torch.float32, device=dev)
        half_diag = cam.film_diag / 2.0
        aspect_n = torch.sqrt(torch.tensor(1.0 + (W / H) ** 2, dtype=torch.float32,
                                           device=dev))
        half_x = half_diag * (W / H) / aspect_n
        half_y = half_diag / aspect_n
        fx = -(2.0 * px / W - 1.0) * half_x
        fy = (1.0 - 2.0 * py / H) * half_y
        o_film = torch.stack([fx, fy, torch.zeros_like(fx)], -1)
        p_lens2 = el[0, 3] * sampling.sample_uniform_disk_concentric(u_lens)
        p_rear = torch.cat([p_lens2, el[0, 1].expand(p_lens2[..., :1].shape)], -1)
        d0 = vm.normalize(p_rear - o_film)
        o_cam, d_cam, ok = _trace_lenses_from_film(el, o_film, d0)
        # a vignetted ray goes from (0, 0, -1e9) along +z, as in the JAX
        # package: it is kept, not dropped, and can hit what lies on the axis
        d_cam = torch.where(ok[..., None], d_cam,
                            torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev))
        o_cam = torch.where(ok[..., None], o_cam * 1e-3,
                            torch.tensor([0.0, 0.0, -1e9], dtype=torch.float32, device=dev))
        return _to_world(cam, o_cam, d_cam)

    if cam.kind == PERSPECTIVE:
        tan_half = float(np.tan(np.deg2rad(cam.fov) / 2.0))
        d_cam = torch.stack([sx * tan_half, sy * tan_half, torch.ones_like(sx)], -1)
        o_cam = torch.zeros_like(d_cam)
        if cam.lens_radius > 0.0:
            # thin-lens depth of field
            p_lens = cam.lens_radius * sampling.sample_uniform_disk_concentric(u_lens)
            p_focus = d_cam * cam.focal_distance
            o_cam = torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])], -1)
            d_cam = p_focus - o_cam
        d_cam = d_cam / torch.sqrt((d_cam * d_cam).sum(-1, keepdim=True))
    else:  # orthographic
        o_cam = torch.stack([sx * cam.screen_scale, sy * cam.screen_scale,
                             torch.zeros_like(sx)], -1)
        d_cam = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev).expand(
            o_cam.shape)
    if cam.motion_keys is not None and u_time is not None:
        m = interpolate_motion(cam, u_time)
        Rm, tm = m[..., :3, :3], m[..., :3, 3]
        return (Rm * o_cam[..., None, :]).sum(-1) + tm, (Rm * d_cam[..., None, :]).sum(-1)
    return _to_world(cam, o_cam, d_cam)
