"""AnimatedTransform: keyframe decomposition and interpolation (numpy copy
of nn_bvh_tpu/geometry/animated.py).

Two keyframe transforms are decomposed into translation, rotation
(quaternion, by iterative polar decomposition) and scale/shear, and
interpolated by lerp, slerp and lerp. Host code: the camera pre-slerps its
shutter keyframes with it (wavefront/camera.with_motion).
"""

from __future__ import annotations

import numpy as np


def decompose(m: np.ndarray):
    """M = T R S (transform.h:373 DecomposeMatrix): returns
    (translate (3,), rot_quat (4,) wxyz, scale (3,3))."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    M = m[:3, :3].copy()
    # polar decomposition: R_{k+1} = 0.5 (R_k + R_k^-T)
    R = M.copy()
    for _ in range(100):
        Rnext = 0.5 * (R + np.linalg.inv(R.T))
        if np.abs(Rnext - R).max() < 1e-10:
            R = Rnext
            break
        R = Rnext
    S = np.linalg.inv(R) @ M
    return t, _quat_from_matrix(R), S


def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) from a rotation matrix (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Quaternion slerp (transform.h Slerp); takes the short arc."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1, 1))
    thetap = theta * t
    qperp = q1 - q0 * d
    qperp /= np.linalg.norm(qperp)
    return q0 * np.cos(thetap) + qperp * np.sin(thetap)


class AnimatedTransform:
    """Two keyframe 4x4s + [t0, t1]; interpolate(t) gives the matrix."""

    def __init__(self, m0: np.ndarray, t0: float, m1: np.ndarray, t1: float):
        self.m0 = np.asarray(m0, np.float32)
        self.m1 = np.asarray(m1, np.float32)
        self.t0, self.t1 = float(t0), float(t1)
        self.actually_animated = not np.allclose(m0, m1)
        self.T0, self.R0, self.S0 = decompose(m0)
        self.T1, self.R1, self.S1 = decompose(m1)
        # flipped handedness between keyframes is unsupported (same as the
        # reference's CHECK on the decomposition)
        if np.dot(self.R0, self.R1) < 0:
            self.R1 = -self.R1

    def interpolate(self, time: float) -> np.ndarray:
        if not self.actually_animated or time <= self.t0:
            return self.m0.astype(np.float32)
        if time >= self.t1:
            return self.m1.astype(np.float32)
        dt = (time - self.t0) / max(self.t1 - self.t0, 1e-12)
        T = (1 - dt) * self.T0 + dt * self.T1
        R = _quat_to_matrix(slerp(self.R0, self.R1, dt))
        S = (1 - dt) * self.S0 + dt * self.S1
        m = np.eye(4)
        m[:3, :3] = R @ S
        m[:3, 3] = T
        return m.astype(np.float32)

    def motion_bounds(self, lo: np.ndarray, hi: np.ndarray,
                      n_steps: int = 16) -> tuple[np.ndarray, np.ndarray]:
        """Conservative world AABB of an object-space box over the motion
        (transform.h MotionBounds; sampled-time union + 5% dilation instead
        of the reference's closed-form extrema)."""
        corners = np.array([[x, y, z]
                            for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])], np.float64)
        wlo = np.full(3, np.inf)
        whi = np.full(3, -np.inf)
        for i in range(n_steps + 1):
            t = self.t0 + (self.t1 - self.t0) * i / n_steps
            m = self.interpolate(t)
            pts = corners @ m[:3, :3].T + m[:3, 3]
            wlo = np.minimum(wlo, pts.min(0))
            whi = np.maximum(whi, pts.max(0))
        pad = 0.05 * (whi - wlo).max()
        return (wlo - pad).astype(np.float32), (whi + pad).astype(np.float32)
