"""Synthetic camera frames (``data/simulator.py``): the numpy sprite
renderer only. The rest of the simulator (trajectories, IMU, GNSS and
landmarks by autodiff of the kinematics) stays in the JAX package; the
port's tests and ``chip_smoke.py`` take those streams from fixtures.
"""

import numpy as np


def render_sprite_frame_np(
    cam_intrinsic: tuple,
    resolution: tuple,
    landmarks: np.ndarray,  # [L,3] world points (numpy, f64)
    t_wc: np.ndarray,
    q_wc: np.ndarray,
    sprite_sigma: float = 1.6,
    base_level: float = 24.0,
) -> np.ndarray:
    """Render a camera image of a 3-D point-sprite field: each landmark is
    a Gaussian blob whose brightness falls with depth, accumulated as a
    local patch of +-3 sigma around its centre, on a constant background,
    clipped to [0, 255] (float32, [h, w])."""
    fx, fy, cx, cy = cam_intrinsic[:4]
    w, h = resolution
    q = np.asarray(q_wc, np.float64)
    # world -> camera: R(q)^T (pw - t)
    qw, xyz = q[0], q[1:]
    d = np.asarray(landmarks, np.float64) - np.asarray(t_wc, np.float64)
    t2 = 2.0 * np.cross(xyz, d)
    pc = d - qw * t2 + np.cross(xyz, t2)  # inverse rotation
    z = pc[:, 2]
    vis = z > 1.0
    u = fx * pc[:, 0] / np.where(vis, z, 1.0) + cx
    v = fy * pc[:, 1] / np.where(vis, z, 1.0) + cy
    amp = np.where(vis, 200.0 / np.sqrt(np.maximum(z, 1.0)), 0.0)
    half = int(np.ceil(3.0 * sprite_sigma))
    vis &= (u > -half) & (u < w + half) & (v > -half) & (v < h + half)

    img = np.full((h, w), base_level, np.float32)
    inv2s2 = 1.0 / (2.0 * sprite_sigma**2)
    for ui, vi, ai in zip(u[vis], v[vis], amp[vis]):
        x0 = max(int(np.floor(ui)) - half, 0)
        x1 = min(int(np.floor(ui)) + half + 2, w)
        y0 = max(int(np.floor(vi)) - half, 0)
        y1 = min(int(np.floor(vi)) + half + 2, h)
        if x1 <= x0 or y1 <= y0:
            continue
        ys = (np.arange(y0, y1, dtype=np.float32) - vi)[:, None] ** 2
        xs = (np.arange(x0, x1, dtype=np.float32) - ui)[None, :] ** 2
        img[y0:y1, x0:x1] += ai * np.exp(-(ys + xs) * inv2s2)
    return np.clip(img, 0.0, 255.0)
