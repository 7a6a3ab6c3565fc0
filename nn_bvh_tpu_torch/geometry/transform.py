"""4x4 host transforms (numpy copy of the parts of
nn_bvh_tpu/geometry/transform.py the port uses: look_at, translate, scale,
rotate, and applying a transform to points, vectors and normals)."""

from __future__ import annotations

import numpy as np


def look_at(eye, target, up) -> np.ndarray:
    """Camera-to-world transform (pbrt LookAt; +z into the screen)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    d = target - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    nr = np.linalg.norm(right)
    if nr < 1e-8:
        raise ValueError("look_at: up and view direction are parallel")
    right /= nr
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m


def translate(delta) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(delta, np.float32)
    return m


def scale(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate(angle_deg: float, axis) -> np.ndarray:
    """Rotation by angle_deg about axis (Rodrigues, in float64)."""
    a = np.asarray(axis, np.float64)
    x, y, z = a / np.linalg.norm(a)
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ]
    return m


def apply_points(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """(4,4) transform of (..., 3) points."""
    p = np.asarray(p, np.float32)
    return (p @ m[:3, :3].T + m[:3, 3]).astype(np.float32)


def apply_vectors(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    return (np.asarray(v, np.float32) @ m[:3, :3].T).astype(np.float32)


def apply_normals(m: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Normals transform by the inverse transpose, then renormalise."""
    inv = np.linalg.inv(m[:3, :3])
    r = np.asarray(n, np.float32) @ inv.astype(np.float32)
    norm = np.linalg.norm(r, axis=-1, keepdims=True)
    return (r / np.maximum(norm, 1e-20)).astype(np.float32)
