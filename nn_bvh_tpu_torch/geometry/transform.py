"""4x4 host transforms (numpy copy of the part of
nn_bvh_tpu/geometry/transform.py the bench path uses: the camera's look_at)."""

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
