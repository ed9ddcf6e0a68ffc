# Frozen copy of ic_gvins_tpu_torch/vision/camera.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Pinhole camera with radial-tangential distortion (``vision/camera.py``).

Intrinsics [fx, fy, cx, cy] (+ skew), distortion [k1, k2, p1, p2, (k3)];
undistortion is an 8-step fixed-point iteration. All functions broadcast
over leading axes.
"""

from typing import NamedTuple

import torch

from ..device import resolve_device

# The engine's default camera (1278 x 1022), as the JAX package's
# ``engine/config.py`` CameraConfig defines it.
DEFAULT_INTRINSIC = (787.16, 787.39, 664.4, 519.5)
DEFAULT_DISTORTION = (-0.0917, 0.0813, 0.00018, 0.00017)
DEFAULT_RESOLUTION = (1278, 1022)


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    skew: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    width: int
    height: int

    @staticmethod
    def create(intrinsic, distortion, resolution, dtype=torch.float64,
               device=None) -> "Camera":
        """intrinsic = [fx, fy, cx, cy(, skew)], distortion =
        [k1, k2, p1, p2(, k3)], resolution = (width, height); on the card
        unless ``device`` says otherwise."""
        device = resolve_device(device)
        intr, dist = list(intrinsic), list(distortion)
        a = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
        return Camera(
            fx=a(intr[0]), fy=a(intr[1]), cx=a(intr[2]), cy=a(intr[3]),
            skew=a(intr[4] if len(intr) > 4 else 0.0),
            k1=a(dist[0]), k2=a(dist[1]), p1=a(dist[2]), p2=a(dist[3]),
            k3=a(dist[4] if len(dist) > 4 else 0.0),
            width=int(resolution[0]), height=int(resolution[1]),
        )

    @property
    def focal(self):
        return 0.5 * (self.fx + self.fy)


def distort(cam: Camera, xy: torch.Tensor) -> torch.Tensor:
    """Apply distortion in the normalized plane (..., 2) -> (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], -1)


def undistort(cam: Camera, xy_d: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert the distortion by fixed-point iteration."""
    xy = xy_d
    for _ in range(iters):
        xy = xy_d - (distort(cam, xy) - xy)
    return xy


def cam_to_pixel(cam: Camera, xyz: torch.Tensor) -> torch.Tensor:
    """Camera-frame point -> distorted pixel."""
    xy_d = distort(cam, xyz[..., :2] / xyz[..., 2:3])
    u = cam.fx * xy_d[..., 0] + cam.skew * xy_d[..., 1] + cam.cx
    v = cam.fy * xy_d[..., 1] + cam.cy
    return torch.stack([u, v], -1)


def pixel_to_cam(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel -> undistorted normalized-plane homogeneous point."""
    y = (uv[..., 1] - cam.cy) / cam.fy
    x = (uv[..., 0] - cam.cx - cam.skew * y) / cam.fx
    xy = undistort(cam, torch.stack([x, y], -1))
    return torch.cat([xy, torch.ones_like(xy[..., :1])], -1)


def pixel_to_unit_cam(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel -> unit bearing vector in the camera frame."""
    pc = pixel_to_cam(cam, uv)
    return pc / torch.linalg.norm(pc, dim=-1, keepdim=True)


def world_to_pixel(cam: Camera, pw, r_wc, t_wc):
    """World point -> pixel through the camera pose (R_wc, t_wc)."""
    pc = (r_wc.transpose(-1, -2) @ (pw - t_wc)[..., None])[..., 0]
    return cam_to_pixel(cam, pc)


def pixel_to_world(cam: Camera, uv, depth, r_wc, t_wc):
    """Distorted pixel at z-depth ``depth`` -> world point through the
    camera pose (R_wc, t_wc)."""
    pc = pixel_to_cam(cam, uv) * depth[..., None]
    return (r_wc @ pc[..., None])[..., 0] + t_wc


def reprojection_error_px(cam: Camera, pw, r_wc, t_wc, uv):
    """Pixel-space reprojection error norm (``camera.cc:153-157``)."""
    return torch.linalg.norm(world_to_pixel(cam, pw, r_wc, t_wc) - uv, dim=-1)
