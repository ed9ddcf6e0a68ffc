"""Whitened factor residuals with closed-form Jacobians (``factors/residuals.py``).

Every function batches over leading axes. Where the JAX package takes
Jacobians with ``jax.jacfwd`` on the manifold deltas, the port uses the
closed forms below; the tests hold them against the JAX jacfwd blocks.
"""

import torch

from ..common import rotation as rot
from ..common.rotation import mv


def gnss_residual(p, q, antlever, gnss_p, gnss_std):
    """3-dim whitened GNSS residual: (p + R(q) lever - p_gnss) / std."""
    return (p + rot.quat_rotate(q, antlever) - gnss_p) / gnss_std


def gnss_residual_jac(p, q, antlever, gnss_p, gnss_std):
    """3-dim whitened GNSS residual (p + R(q) lever - p_gnss) / std and its
    3x6 Jacobian w.r.t. the pose delta [dp | dtheta]."""
    r = (p + rot.quat_rotate(q, antlever) - gnss_p) / gnss_std
    R = rot.quat_to_matrix(q)
    eye3 = torch.eye(3, dtype=p.dtype, device=p.device)
    J = torch.cat([eye3.expand(R.shape), -R @ rot.skew(antlever).expand(R.shape)], -1)
    return r, J / gnss_std[..., :, None]


def _reproject(p0, q0, p1, q1, tic, qic, invdepth, td, uv0, uv1, vel0,
               vel1, td0, td1):
    one = torch.ones_like(uv0[..., :1])
    pts0 = torch.cat([uv0 - (td - td0)[..., None] * vel0, one], -1)
    pts1 = uv1 - (td - td1)[..., None] * vel1
    pc0 = pts0 / invdepth[..., None]
    pb0 = rot.quat_rotate(qic, pc0) + tic
    pw = rot.quat_rotate(q0, pb0) + p0
    pb1 = rot.quat_rotate(rot.quat_inv(q1), pw - p1)
    pc1 = rot.quat_rotate(rot.quat_inv(qic), pb1 - tic)
    r = pc1[..., :2] / pc1[..., 2:3] - pts1
    return r, pc0, pb0, pb1, pc1


def reprojection_residual(p0, q0, p1, q1, tic, qic, invdepth, td, uv0, uv1,
                          vel0, vel1, td0, td1, std):
    """Whitened 2-dim reprojection residual (see the Jacobian version)."""
    return _reproject(p0, q0, p1, q1, tic, qic, invdepth, td, uv0, uv1,
                      vel0, vel1, td0, td1)[0] / std


def reprojection_residual_jac(
    p0, q0, p1, q1, tic, qic, invdepth, td,
    uv0, uv1, vel0, vel1, td0, td1, std,
):
    """Whitened 2-dim reprojection residual with time-delay compensation
    and its analytic 2x20 Jacobian w.r.t. the boxplus deltas
    [ref pose 6 | obs pose 6 | ext 6 | td 1 | invdepth 1].

    Chain: ref normalized point / invdepth -> ref camera -> body -> world
    -> obs body -> obs camera -> normalized plane, minus the td-shifted
    observation. ``invdepth``, ``td``, ``td0``, ``td1`` carry the leading
    axes without a trailing one; ``std`` is a scalar."""
    r, pc0, pb0, pb1, pc1 = _reproject(p0, q0, p1, q1, tic, qic, invdepth,
                                       td, uv0, uv1, vel0, vel1, td0, td1)
    x, y, z = pc1[..., 0], pc1[..., 1], pc1[..., 2]
    Ric = rot.quat_to_matrix(qic)
    R0 = rot.quat_to_matrix(q0)
    R1t = rot.quat_to_matrix(q1).transpose(-1, -2)
    Rcw1 = Ric.transpose(-1, -2) @ R1t  # world -> obs camera
    B = Rcw1 @ R0  # ref body -> obs camera
    M = B @ Ric  # ref camera -> obs camera

    iz = 1.0 / z
    zero = torch.zeros_like(z)
    P = torch.stack(
        [
            torch.stack([iz, zero, -x * iz * iz], -1),
            torch.stack([zero, iz, -y * iz * iz], -1),
        ],
        -2,
    )
    PR = P @ Rcw1
    vel0h = torch.cat([vel0, torch.zeros_like(vel0[..., :1])], -1)
    dtd = -mv(P, mv(M, vel0h) / invdepth[..., None]) + vel1
    J = torch.cat(
        [
            PR,  # d p0
            -(P @ B) @ rot.skew(pb0),  # d theta0
            -PR,  # d p1
            (P @ Ric.transpose(-1, -2)) @ rot.skew(pb1),  # d theta1
            P @ (B - Ric.transpose(-1, -2)),  # d tic
            P @ (rot.skew(pc1) - M @ rot.skew(pc0)),  # d theta_ic
            dtd[..., None],  # d td
            (-mv(P, mv(M, pc0)) / invdepth[..., None])[..., None],  # d invdepth
        ],
        -1,
    )
    return r / std, J / std


def bias_soft_residual_jac(bg, ba, bg_std, ba_std):
    """6-dim soft zero-prior on the newest node's biases and its 6x15
    Jacobian w.r.t. the node delta."""
    r = torch.cat([bg / bg_std, ba / ba_std], -1)
    J = bg.new_zeros(bg.shape[:-1] + (6, 15))
    eye3 = torch.eye(3, dtype=bg.dtype, device=bg.device)
    J[..., 0:3, 9:12] = eye3 / bg_std
    J[..., 3:6, 12:15] = eye3 / ba_std
    return r, J


def pose_prior_residual(p, q, prior_p, prior_q, prior_std6):
    """6-dim whitened pose prior (position and attitude rotation vector)."""
    dq = rot.quat_mul(rot.quat_inv(prior_q), q)
    return torch.cat([p - prior_p, rot.quat_to_rotvec(dq)], -1) / prior_std6


def mix_prior_residual(v, bg, ba, prior_v, prior_bg, prior_ba, prior_std9):
    """9-dim whitened velocity and bias prior."""
    return torch.cat([v - prior_v, bg - prior_bg, ba - prior_ba], -1) / prior_std9


def bias_soft_residual(bg, ba, bg_std, ba_std):
    """6-dim soft zero-prior on the newest node's biases."""
    return torch.cat([bg / bg_std, ba / ba_std], -1)


def huber_weight(chi2, delta=1.0):
    """IRLS weight of Ceres' HuberLoss(delta), rho'(s) = min(1, delta /
    sqrt(s)) (rho(s) = s up to delta^2, then 2 delta sqrt(s) - delta^2)."""
    s = torch.clamp(chi2, min=1e-30)
    return torch.clamp(delta / torch.sqrt(s), max=1.0)
