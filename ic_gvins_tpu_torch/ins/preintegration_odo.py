"""Odometer-augmented IMU preintegration, the ODO / EARTH_ODO variants
(``ins/preintegration_odo.py``).

The 19-dim error state adds the preintegrated odometer displacement ``ds``
(3) and the odometer scale factor ``dsodo`` (1) to the 15-dim IMU state:

    [dp 0:3 | dv 3:6 | dtheta 6:9 | dbg 9:12 | dba 12:15 | ds 15:18 | dsodo 18]

noise (16): [gyro white, accel white, gyro bias RW, accel bias RW,
             odometer velocity white, scale RW].

Per step, with ``C_comp`` the Earth-compensated delta attitude of the
velocity integration (the identity compensation when ``iewn == 0`` gives
the plain ODO variant):

    ds += C_comp @ (cvb @ [odovel, 0, 0] * (1 + sodo) - R(dtheta) @ lodo + lodo)

As in ``ins/preintegration.py`` the samples are processed together: the
IMU recursions are that module's prefix scans, ``ds`` is a cumulative sum
of the rotated increments, and the 19 x 19 Jacobian and covariance
compose in the same pairwise tree.
"""

from typing import NamedTuple

import torch

from ..common import rotation as rot
from ..common.rotation import mv
from ..data.types import ImuSeq, IntegrationParams, NavState
from .preintegration import (
    _corrected_terms,
    _imu_blocks,
    _integrate,
    _interval_length,
    _propagate,
    preint_residual_jac,
    sqrt_information,
)

NUM_STATE = 19
NUM_NOISE = 16


class OdoParams(NamedTuple):
    cvb: torch.Tensor  # (3,3) odometer/vehicle -> body mounting DCM
    lodo: torch.Tensor  # (3,) odometer lever arm in the body frame
    odo_vrw: torch.Tensor  # odometer velocity random walk (m/s/sqrt(s))
    odo_srw: torch.Tensor  # scale-factor random walk (1/sqrt(s))


class OdoPreintData(NamedTuple):
    """``PreintData`` with the odometer displacement and scale reference;
    the fields common to both keep their names and order."""

    dp: torch.Tensor
    dv: torch.Tensor
    dq: torch.Tensor
    ds: torch.Tensor  # (..., 3) preintegrated odometer displacement
    jac: torch.Tensor  # (..., 19, 19)
    cov: torch.Tensor  # (..., 19, 19)
    dt: torch.Tensor
    sum_dt_pn: torch.Tensor
    bg_ref: torch.Tensor
    ba_ref: torch.Tensor
    sodo_ref: torch.Tensor  # (...) scale linearization point
    end_state: NavState


def noise_psd_odo(params: IntegrationParams, odo: OdoParams, dtype=None) -> torch.Tensor:
    """16 x 16 diagonal noise PSD."""
    nbg = 2.0 * params.gyr_bias_std**2 / params.corr_time
    nba = 2.0 * params.acc_bias_std**2 / params.corr_time
    d = torch.cat([
        torch.stack([params.gyr_arw**2, params.acc_vrw**2, nbg, nba,
                     odo.odo_vrw**2]).repeat_interleave(3),
        (odo.odo_srw**2).reshape(1),
    ])
    return torch.diag(d.to(dtype) if dtype is not None else d)


def preintegrate_odo(
    params: IntegrationParams,
    odo: OdoParams,
    state0: NavState,
    sodo0: torch.Tensor,
    imu: ImuSeq,
    odovel: torch.Tensor,  # [..., N] odometer displacement increments per sample
) -> OdoPreintData:
    """Integrate IMU and odometer increments from ``state0`` at scale
    ``sodo0``; ``imu`` and ``odovel`` start with the seed sample, as in
    ``preintegrate``."""
    dtype = state0.p.dtype
    st = _integrate(params, state0, imu)
    cvb = odo.cvb.to(dtype)
    lodo = odo.lodo.to(dtype)
    scale = (1.0 + sodo0)[..., None, None]  # [..., 1, 1] over the steps
    dt2 = st.dt1[..., None]

    # displacement increments: cvb @ [odv, 0, 0] is odv times cvb's first column
    odv = odovel[..., 1:, None]
    wheel = cvb[:, 0] * odv  # [..., n, 3]
    s_inc = (wheel * scale - rot.quat_rotate(rot.rotvec_to_quat(st.dth_cur), lodo) + lodo)
    ds = torch.sum(rot.quat_rotate(st.q_comp, s_inc), -2)

    phi, gt = _imu_blocks(params, st, NUM_STATE, NUM_NOISE)
    cpos = -st.cbb0  # the compensated delta DCM after each step
    eye3 = torch.eye(3, dtype=dtype, device=cpos.device)
    stheta = wheel * scale - rot.cross(st.dth_cur, lodo)
    phi[..., 15:18, 6:9] = -cpos @ rot.skew(stheta)
    phi[..., 15:18, 9:12] = -cpos @ rot.skew(lodo) * dt2
    phi[..., 15:18, 15:18] = eye3
    phi[..., 15:18, 18] = mv(cpos, wheel)
    phi[..., 18, 18] = 1.0
    gt[..., 15:18, 0:3] = cpos @ rot.skew(lodo)
    gt[..., 15:18, 12:15] = cpos @ cvb * scale[..., None]
    gt[..., 18, 15] = 1.0
    J, P = _propagate(phi, gt, noise_psd_odo(params, odo, dtype), st.dt1)

    last = lambda x: x[..., -1, :]  # noqa: E731
    t_acc = _interval_length(imu)
    end_state = NavState(time=state0.time + t_acc, p=last(st.p_all), q=last(st.q_all),
                         v=last(st.v_all), bg=state0.bg, ba=state0.ba)
    return OdoPreintData(
        dp=last(st.dp_all), dv=last(st.dv_all), dq=last(st.dq_all), ds=ds, jac=J, cov=P,
        dt=t_acc, sum_dt_pn=torch.sum(st.dt1 * st.p_all, -2), bg_ref=state0.bg,
        ba_ref=state0.ba, sodo_ref=sodo0.expand(t_acc.shape), end_state=end_state,
    )


def _corrected_s(preint: OdoPreintData, state0: NavState, sodo0: torch.Tensor):
    jac = preint.jac
    return (preint.ds + mv(jac[..., 15:18, 9:12], state0.bg - preint.bg_ref)
            + jac[..., 15:18, 18] * (sodo0 - preint.sodo_ref)[..., None])


def preint_odo_residual(
    preint: OdoPreintData,
    state0: NavState,
    sodo0: torch.Tensor,
    state1: NavState,
    sodo1: torch.Tensor,
    params: IntegrationParams,
    whiten: bool = True,
) -> torch.Tensor:
    """19-dim residual: the 15 IMU rows of ``preint_residual``, the
    odometer displacement and the scale's random walk."""
    r, _, C0 = _corrected_terms(preint, state0, state1, params)[:3]
    r = torch.cat([
        r,
        mv(C0, state1.p - state0.p) - _corrected_s(preint, state0, sodo0),
        torch.zeros_like(r[..., :1]) + (sodo1 - sodo0)[..., None],
    ], -1)
    if whiten:
        r = mv(sqrt_information(preint.cov), r)
    return r


def preint_odo_residual_jac(
    preint: OdoPreintData,
    state0: NavState,
    state1: NavState,
    sodo: torch.Tensor,
    params: IntegrationParams,
):
    """Unwhitened residual and closed-form 19 x 31 Jacobian with respect
    to [node0 (dp, dtheta, dv, dbg, dba) | node1 (...) | sodo], for the
    window-global scale that enters both ends of every interval (so the
    random-walk row is identically zero). Rows 0:15 are
    ``preint_residual_jac``'s."""
    r15, J15 = preint_residual_jac(preint, state0, state1, params)
    C0 = rot.quat_to_matrix(rot.quat_inv(state0.q))
    dp01 = mv(C0, state1.p - state0.p)
    r = torch.cat([r15, dp01 - _corrected_s(preint, state0, sodo),
                   torch.zeros_like(r15[..., :1])], -1)
    J = torch.zeros(r.shape[:-1] + (NUM_STATE, 31), dtype=r.dtype, device=r.device)
    J[..., :15, :30] = J15
    J[..., 15:18, 0:3] = -C0
    J[..., 15:18, 3:6] = rot.skew(dp01)
    J[..., 15:18, 9:12] = -preint.jac[..., 15:18, 9:12]
    J[..., 15:18, 15:18] = C0
    J[..., 15:18, 30] = -preint.jac[..., 15:18, 18]
    return r, J
