"""Batched two-view landmark triangulation (``vision/triangulation.py``).

DLT with the homogeneous scale fixed (h3 = 1) and the 4x3 least squares
solved through its 3x3 normal equations with a closed-form adjugate, plus
the reference's gates: depth in (NEAREST, FARTHEST * depth_scale),
reprojection error and rotation-compensated parallax.
"""

import torch

from ..common.rotation import mv

NEAREST_DEPTH = 1.0
FARTHEST_DEPTH = 200.0
DEFAULT_DEPTH = 10.0


def triangulate(r_wc0, t_wc0, r_wc1, t_wc1, xy0, xy1):
    """World points (..., 3) from two camera->world poses and undistorted
    normalized observations (..., 2)."""
    rt0 = r_wc0.transpose(-1, -2)
    rt1 = r_wc1.transpose(-1, -2)
    p0 = torch.cat([rt0, -mv(rt0, t_wc0)[..., None]], -1)
    p1 = torch.cat([rt1, -mv(rt1, t_wc1)[..., None]], -1)
    rows = torch.stack(
        [
            xy0[..., 0, None] * p0[..., 2, :] - p0[..., 0, :],
            xy0[..., 1, None] * p0[..., 2, :] - p0[..., 1, :],
            xy1[..., 0, None] * p1[..., 2, :] - p1[..., 0, :],
            xy1[..., 1, None] * p1[..., 2, :] - p1[..., 1, :],
        ],
        -2,
    )
    B = rows[..., :3]
    a4 = rows[..., 3]
    M = B.transpose(-1, -2) @ B
    rhs = -mv(B.transpose(-1, -2), a4)
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c01, c11, c12], -1),
        torch.stack([c02, c12, c22], -1),
    ], -2)
    return mv(adj, rhs) / det[..., None]


def _to_cam(pw, r_wc, t_wc):
    return mv(r_wc.transpose(-1, -2), pw - t_wc)


def _proj_err(pc, xy):
    z = pc[..., 2:]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.linalg.norm(pc[..., :2] / z - xy, dim=-1)


def triangulate_checked(r_wc0, t_wc0, r_wc1, t_wc1, xy0, xy1,
                        reproj_thresh: float = 0.01,
                        depth_scale: float = 3.0,
                        min_parallax: float = 0.0):
    """Triangulate and gate. Returns (world points, inverse depth in the
    reference view, ok mask)."""
    pw = triangulate(r_wc0, t_wc0, r_wc1, t_wc1, xy0, xy1)
    pc0 = _to_cam(pw, r_wc0, t_wc0)
    pc1 = _to_cam(pw, r_wc1, t_wc1)
    d0, d1 = pc0[..., 2], pc1[..., 2]
    far = FARTHEST_DEPTH * depth_scale
    ok = (
        (d0 > NEAREST_DEPTH) & (d0 < far) & (d1 > NEAREST_DEPTH) & (d1 < far)
        & (_proj_err(pc0, xy0) < reproj_thresh)
        & (_proj_err(pc1, xy1) < reproj_thresh)
    )
    if min_parallax > 0.0:
        r_c0c1 = r_wc0.transpose(-1, -2) @ r_wc1
        ok = ok & (parallax_rotation_compensated(xy0, xy1, r_c0c1) >= min_parallax)
    invdepth = 1.0 / torch.where(ok, d0, torch.full_like(d0, DEFAULT_DEPTH))
    return pw, invdepth, ok


def parallax_rotation_compensated(xy0, xy1, r_c0c1):
    """Normalized-plane displacement after rotating the second bearing into
    the first view."""
    h1 = torch.cat([xy1, torch.ones_like(xy1[..., :1])], -1)
    h1_in_0 = mv(r_c0c1, h1)
    return torch.linalg.norm(h1_in_0[..., :2] / h1_in_0[..., 2:] - xy0, dim=-1)
