"""Camera frames of a point-sprite field, many at once on the device.

The image model of ``render_sprite_frame_np`` in
ic_gvins_tpu_torch/data/simulator.py at commit ab7fbd6 (a Gaussian blob
per landmark, sigma 1.6 px, brightness 200 / sqrt(depth), on a grey level
of 24, clipped to [0, 255]), written for a batch of frames: each blob is a
12 x 12 patch around its centre. Changed from it: the centre goes through
the camera's distortion (the frozen ``vision/camera.py``), the sums are in
fixed point (exact, so the frames do not depend on the order of the
device's additions), and frames are rounded to 8-bit grey, as a camera
delivers them.
"""

import math

import torch

from ..reference.common import rotation as rot
from ..reference.vision import camera as cam_mod

SIGMA = 1.6  # px
BASE_LEVEL = 24.0
AMP = 200.0
HALF = int(math.ceil(3.0 * SIGMA))
FIXED = float(1 << 16)  # fixed-point scale of the blob sums
CHUNK_PIXELS = 1 << 26  # frame pixels rendered at once


def camera(cfg_engine: dict, device) -> cam_mod.Camera:
    """The frozen camera model of the configuration (float64)."""
    c = cfg_engine["cam"]
    return cam_mod.Camera.create(tuple(c["intrinsic"]), tuple(c["distortion"]),
                                 tuple(c["resolution"]), dtype=torch.float64, device=device)


def render_frames(cam, resolution, landmarks, t_wc, q_wc, out):
    """Render frames into ``out`` (uint8 [K, h, w]): frame k sees the
    landmarks ``landmarks[k]`` ([K, L, 3] world points, float64) from the
    camera pose (``t_wc`` [K, 3], ``q_wc`` [K, 4])."""
    w, h = resolution
    K, L = landmarks.shape[:2]
    dev = landmarks.device
    pc = rot.quat_rotate(rot.quat_inv(q_wc)[:, None, :], landmarks - t_wc[:, None, :])
    z = pc[..., 2]
    vis = z > 1.0
    zs = torch.where(vis, z, torch.ones_like(z))
    px = cam_mod.cam_to_pixel(cam, torch.stack([pc[..., 0] / zs, pc[..., 1] / zs,
                                                torch.ones_like(zs)], -1))
    u, v = px[..., 0], px[..., 1]
    amp = torch.where(vis, AMP / torch.sqrt(torch.clamp(z, min=1.0)), torch.zeros_like(z))
    vis = vis & (u > -HALF) & (u < w + HALF) & (v > -HALF) & (v < h + HALF)
    amp = torch.where(vis, amp, torch.zeros_like(amp))
    u = torch.where(vis, u, torch.zeros_like(u))
    v = torch.where(vis, v, torch.zeros_like(v))

    off = torch.arange(-HALF, HALF + 2, device=dev)
    x0 = torch.floor(u).to(torch.int64)
    y0 = torch.floor(v).to(torch.int64)
    xs = x0[..., None] + off  # [K, L, P]
    ys = y0[..., None] + off
    # float32 blob values, as the host renderer computes them
    dx2 = (xs.to(torch.float32) - u[..., None].to(torch.float32)) ** 2
    dy2 = (ys.to(torch.float32) - v[..., None].to(torch.float32)) ** 2
    inv2s2 = 1.0 / (2.0 * SIGMA**2)
    val = amp[..., None, None].to(torch.float32) * torch.exp(
        -(dy2[..., :, None] + dx2[..., None, :]) * inv2s2)  # [K, L, P, P]
    inside = ((ys >= 0) & (ys < h))[..., :, None] & ((xs >= 0) & (xs < w))[..., None, :]
    val = torch.where(inside, val, torch.zeros_like(val))
    fixed = torch.round(val.to(torch.float64) * FIXED).to(torch.int64)
    idx = (torch.arange(K, device=dev)[:, None, None, None] * (h * w)
           + ys.clamp(0, h - 1)[..., :, None] * w + xs.clamp(0, w - 1)[..., None, :])
    acc = torch.zeros(K * h * w, dtype=torch.int64, device=dev)
    acc.scatter_add_(0, idx.reshape(-1), fixed.reshape(-1))
    img = BASE_LEVEL + acc.to(torch.float64) / FIXED
    out.copy_(torch.round(torch.clamp(img, 0.0, 255.0)).to(torch.uint8).reshape(K, h, w))


def render_all(cam, resolution, landmarks_of, t_wc, q_wc, device):
    """All frames, uint8 [N, h, w] on ``device``: ``landmarks_of(a, b)``
    gives the landmarks [b - a, L, 3] that frames a..b-1 see."""
    w, h = resolution
    n = t_wc.shape[0]
    frames = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    step = max(1, CHUNK_PIXELS // (h * w * 8))
    for a in range(0, n, step):
        b = min(n, a + step)
        render_frames(cam, resolution, landmarks_of(a, b), t_wc[a:b], q_wc[a:b], frames[a:b])
    return frames
