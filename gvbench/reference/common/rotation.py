# Frozen copy of ic_gvins_tpu_torch/common/rotation.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Batched rotation math on SO(3) / quaternions (``common/rotation.py``).

Hamilton quaternions, scalar-first ``[w, x, y, z]``, body-to-nav. Every
function works over the trailing axes and broadcasts over leading ones.
"""

import torch

# Below this rotation angle the exp/log maps switch to their series.
_SMALL_ANGLE = 1e-8


def skew(v: torch.Tensor) -> torch.Tensor:
    """[v]x with [v]x @ u = v x u. (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            torch.stack([z, -w, y], -1),
            torch.stack([w, z, -x], -1),
            torch.stack([-y, x, z], -1),
        ],
        -2,
    )


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., m, n) x (..., n) -> (..., m)."""
    return (a @ v[..., None])[..., 0]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, broadcasting the leading ones."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def quat_identity(dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ p, broadcasting over leading axes."""
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        -1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (its conjugate)."""
    return quat_conj(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) @ v as v + 2*w*(u x v) + 2*u x (u x v)."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix, (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        -2,
    )


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (Shepperd's method: the best
    conditioned of four candidates)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = 1.0 + tr
    c0 = torch.stack([qw0, m21 - m12, m02 - m20, m10 - m01], -1)
    qx1 = 1.0 + m00 - m11 - m22
    c1 = torch.stack([m21 - m12, qx1, m01 + m10, m02 + m20], -1)
    qy2 = 1.0 - m00 + m11 - m22
    c2 = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], -1)
    qz3 = 1.0 - m00 - m11 + m22
    c3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz3], -1)
    best = torch.stack([qw0, qx1, qy2, qz3], -1).argmax(-1)
    cands = torch.stack([c0, c1, c2, c3], -2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])


def rotvec_to_quat(rv: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map: rotation vector -> quaternion."""
    sq = torch.sum(rv * rv, -1, keepdim=True)
    small = sq < _SMALL_ANGLE**2
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(0.5 * angle) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(0.5 * angle))
    return torch.cat([w, k * rv], -1)


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """SO(3) log map: unit quaternion -> rotation vector."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vn = torch.linalg.norm(q[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < _SMALL_ANGLE
    safe_vn = torch.where(small, torch.ones_like(vn), vn)
    scale = torch.where(
        small, 2.0 / torch.clamp(w, min=_SMALL_ANGLE), angle / safe_vn
    )
    return scale[..., None] * q[..., 1:]


def rotvec_to_matrix(rv: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(rotvec_to_quat(rv))


def matrix_to_rotvec(m: torch.Tensor) -> torch.Tensor:
    return quat_to_rotvec(matrix_to_quat(m))


def matrix_to_euler(m: torch.Tensor) -> torch.Tensor:
    """DCM (body->nav, front-right-down) -> [roll, pitch, yaw], ZYX order,
    yaw wrapped to [0, 2*pi), with the gimbal-lock branches."""
    pitch = torch.atan2(-m[..., 2, 0], torch.sqrt(m[..., 2, 1] ** 2 + m[..., 2, 2] ** 2))
    roll = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    yaw_normal = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    yaw_lock_lo = torch.atan2(m[..., 1, 2] - m[..., 0, 1], m[..., 0, 2] + m[..., 1, 1])
    yaw_lock_hi = torch.pi + torch.atan2(m[..., 1, 2] + m[..., 0, 1],
                                         m[..., 0, 2] - m[..., 1, 1])
    yaw = torch.where(m[..., 2, 0] <= -0.999, yaw_lock_lo,
                      torch.where(m[..., 2, 0] >= 0.999, yaw_lock_hi, yaw_normal))
    yaw = torch.where(yaw < 0, 2.0 * torch.pi + yaw, yaw)
    return torch.stack([roll, pitch, yaw], -1)


def euler_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """[roll, pitch, yaw] -> DCM body->nav (ZYX composition Rz @ Ry @ Rx)."""
    r, p, y = euler.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
            torch.stack([-sp, cp * sr, cp * cr], -1),
        ],
        -2,
    )


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
    return matrix_to_quat(euler_to_matrix(euler))


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    return matrix_to_euler(quat_to_matrix(q))


def quat_left(q: torch.Tensor) -> torch.Tensor:
    """L(q) with L(q) @ p = q ⊗ p. (..., 4, 4)."""
    w, v = q[..., 0], q[..., 1:]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w[..., None, None], -v[..., None, :]], -1)
    bottom = torch.cat([v[..., :, None], w[..., None, None] * eye + skew(v)], -1)
    return torch.cat([top, bottom], -2)


def quat_right(p: torch.Tensor) -> torch.Tensor:
    """R(p) with R(p) @ q = q ⊗ p. (..., 4, 4)."""
    w, v = p[..., 0], p[..., 1:]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    top = torch.cat([w[..., None, None], -v[..., None, :]], -1)
    bottom = torch.cat([v[..., :, None], w[..., None, None] * eye - skew(v)], -1)
    return torch.cat([top, bottom], -2)
