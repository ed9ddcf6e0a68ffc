# Frozen copy of ic_gvins_tpu_torch/ins/mechanization.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""INS mechanization (``ins/mechanization.py``): bias compensation,
two-sample coning/sculling, the mechanization step with Earth-rotation
(Coriolis + rotating-frame) terms, the scan over an increment series, IMU
and pose interpolation, and the zero-velocity detector.

Whether Earth terms apply is decided by the value of ``params.iewn``
(zeros turn them off). ``mechanize_scan`` is a Python loop over the
samples; every other function batches over leading axes.
"""

import torch

from ..common import rotation as rot
from ..common.rotation import cross
from ..data.types import ImuSeq, IntegrationParams, NavState


def compensate_bias(dtheta, dvel, dt, bg, ba):
    """Remove bias increments: dtheta - dt*bg, dvel - dt*ba."""
    return dtheta - dt[..., None] * bg, dvel - dt[..., None] * ba


def coning_sculling(dtheta_pre, dvel_pre, dtheta_cur, dvel_cur):
    """Two-sample coning/sculling corrected increments (dvfb, dtheta)."""
    dvfb = (
        dvel_cur
        + 0.5 * cross(dtheta_cur, dvel_cur)
        + (1.0 / 12.0)
        * (cross(dtheta_pre, dvel_cur) + cross(dvel_pre, dtheta_cur))
    )
    dtheta = dtheta_cur + (1.0 / 12.0) * cross(dtheta_pre, dtheta_cur)
    return dvfb, dtheta


def mechanize_step(params: IntegrationParams, state: NavState, imu_pre, imu_cur,
                   time_cur) -> NavState:
    """One step from ``state`` through the interval of ``imu_cur`` =
    (dt, dtheta, dvel); ``imu_pre`` only feeds the coning/sculling terms."""
    dt_pre, dth_pre, dv_pre = imu_pre
    dt, dth_cur, dv_cur = imu_cur
    dth_pre, dv_pre = compensate_bias(dth_pre, dv_pre, dt_pre, state.bg, state.ba)
    dth_cur, dv_cur = compensate_bias(dth_cur, dv_cur, dt, state.bg, state.ba)
    dvfb, dtheta = coning_sculling(dth_pre, dv_pre, dth_cur, dv_cur)

    dt1 = dt[..., None]
    dv_cor_g = (params.gravity - 2.0 * cross(params.iewn, state.v)) * dt1
    qnn = rot.rotvec_to_quat(-params.iewn * dt1)
    body_dv = rot.quat_rotate(state.q, dvfb)
    dvel = 0.5 * (body_dv + rot.quat_rotate(qnn, body_dv)) + dv_cor_g
    q_new = rot.quat_normalize(
        rot.quat_mul(qnn, rot.quat_mul(state.q, rot.rotvec_to_quat(dtheta)))
    )
    return NavState(time=time_cur, p=state.p + dt1 * state.v + 0.5 * dt1 * dvel,
                    q=q_new, v=state.v + dvel, bg=state.bg, ba=state.ba)


def mechanize_scan(params: IntegrationParams, state0: NavState, imu: ImuSeq) -> NavState:
    """Mechanize through a whole increment series: the states at every IMU
    epoch (leading axis = samples); sample 0 only seeds the coning
    predecessor and carries ``state0`` at its own time."""
    prev = (imu.dt[0], imu.dtheta[0], imu.dvel[0])
    states = [state0._replace(time=imu.time[0])]
    state = state0
    for k in range(1, imu.dt.shape[0]):
        cur = (imu.dt[k], imu.dtheta[k], imu.dvel[k])
        state = mechanize_step(params, state, prev, cur, imu.time[k])
        states.append(state)
        prev = cur
    return NavState(*(torch.stack(x) for x in zip(*states)))


def interpolate_imu(time0, imu_time, imu_dt, imu_dtheta, imu_dvel, t):
    """Split the increment of the interval ending at ``imu_time`` at time
    t by linear scaling: ((dt, dtheta, dvel) left of t, the same right of
    it). ``time0`` is unused, as in the JAX package."""
    scale = torch.clamp((imu_time - t) / imu_dt, 0.0, 1.0)
    left = (imu_dt - (imu_time - t), imu_dtheta * (1 - scale), imu_dvel * (1 - scale))
    right = (imu_time - t, imu_dtheta * scale, imu_dvel * scale)
    return left, right


def pose_interpolate(state0: NavState, state1: NavState, t):
    """(p, q) between two states at time t."""
    scale = (t - state0.time) / (state1.time - state0.time)
    dq = rot.quat_mul(rot.quat_inv(state1.q), state0.q)
    rvec = rot.quat_to_rotvec(dq) * scale
    q = rot.quat_normalize(rot.quat_mul(state0.q, rot.quat_inv(rot.rotvec_to_quat(rvec))))
    return state0.p + (state1.p - state0.p) * scale, q


def detect_zero_velocity(dtheta, dvel, rate: float, gyr_threshold: float = 0.002,
                         acc_threshold: float = 0.1):
    """Windowed std-dev zero-velocity detector: (is_zero_velocity,
    mean increments [6])."""
    inc = torch.cat([dtheta, dvel], -1)
    mean = torch.mean(inc, 0)
    std = torch.sqrt(torch.mean((inc - mean) ** 2, 0)) * rate
    return torch.all(std[:3] < gyr_threshold) & torch.all(std[3:] < acc_threshold), mean
