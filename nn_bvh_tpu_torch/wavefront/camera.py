"""Perspective camera ray generation (port of the PERSPECTIVE path of
nn_bvh_tpu/wavefront/camera.py, with camera motion blur). The camera is
host configuration; rays land on the device of the pixel-index tensor."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import sampling

class Camera(NamedTuple):
    """A perspective camera (the other kinds: ROADMAP queue 1, item 8)."""

    cam_to_world: np.ndarray  # (4,4) f32, pbrt LookAt convention (+z forward)
    fov: float                # degrees, shorter image axis
    width: int
    height: int
    lens_radius: float        # thin-lens aperture (0 = pinhole)
    focal_distance: float
    # camera motion blur: K pre-slerped cam_to_world keyframes over the
    # shutter interval (with_motion); None = static camera
    motion_keys: np.ndarray | None = None  # (K, 4, 4) f32


def make_perspective(cam_to_world, fov: float, width: int, height: int,
                     lens_radius: float = 0.0, focal_distance: float = 1e6) -> Camera:
    return Camera(np.array(cam_to_world, np.float32), float(fov), int(width),
                  int(height), float(lens_radius), float(focal_distance))


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


def generate_rays(cam: Camera, pixel_idx: torch.Tensor, u_pixel: torch.Tensor,
                  u_lens: torch.Tensor, u_time: torch.Tensor | None = None):
    """pixel_idx (R,) flat index; u_pixel/u_lens (R,2); u_time (R,) shutter
    times of a moving camera (ignored for a static one) -> world (o, d)."""
    W, H = cam.width, cam.height
    px = (pixel_idx % W).to(torch.float32) + u_pixel[..., 0]
    py = torch.div(pixel_idx, W, rounding_mode="floor").to(torch.float32) + u_pixel[..., 1]
    aspect = W / H
    sx = 2.0 * px / W - 1.0
    sy = 1.0 - 2.0 * py / H
    if aspect >= 1.0:
        sx = sx * aspect
    else:
        sy = sy / aspect
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
    if cam.motion_keys is not None and u_time is not None:
        m = interpolate_motion(cam, u_time)
        Rm, tm = m[..., :3, :3], m[..., :3, 3]
        return (Rm * o_cam[..., None, :]).sum(-1) + tm, (Rm * d_cam[..., None, :]).sum(-1)
    m = torch.as_tensor(cam.cam_to_world, device=pixel_idx.device)
    R, t = m[:3, :3], m[:3, 3]
    # broadcast multiply-sum: full float32, no TF32 matmul path
    o = (o_cam[..., None, :] * R).sum(-1) + t
    d = (d_cam[..., None, :] * R).sum(-1)
    return o, d
