# Frozen copy of ic_gvins_tpu_torch/ins/preintegration.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""IMU preintegration with Earth-rotation compensation (``ins/preintegration.py``).

One code path covers the NORMAL and EARTH variants: every Earth term
vanishes when ``iewn == 0``. Every function batches over leading axes, so
all intervals of a window integrate together, and the samples of an
interval are processed together too (prefix scans in log2(n) rounds).

Error-state ordering (15): [dp 0:3, dv 3:6, dtheta 6:9, dbg 9:12, dba 12:15],
noise ordering (12): [gyro white, accel white, gyro bias RW, accel bias RW].
"""

from typing import NamedTuple

import numpy as np
import torch

from ..common import rotation as rot
from ..common.rotation import mv
from ..data.types import ImuSeq, IntegrationParams, NavState
from .mechanization import compensate_bias, coning_sculling


class PreintData(NamedTuple):
    """Preintegrated measurement over one window interval (leading axes
    batch the intervals)."""

    dp: torch.Tensor  # (..., 3) delta position in the b0 frame
    dv: torch.Tensor  # (..., 3) delta velocity
    dq: torch.Tensor  # (..., 4) delta attitude quaternion
    jac: torch.Tensor  # (..., 15, 15) d(delta)/d(error state at start)
    cov: torch.Tensor  # (..., 15, 15) preintegration covariance
    dt: torch.Tensor  # (...) total integration time
    sum_dt_pn: torch.Tensor  # (..., 3) sum of dt_i * p_i (Earth Coriolis)
    bg_ref: torch.Tensor  # (..., 3) gyro bias at linearization
    ba_ref: torch.Tensor  # (..., 3) accel bias at linearization
    end_state: NavState  # continuous-state replay at interval end


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def noise_psd(params: IntegrationParams, dtype=None) -> torch.Tensor:
    """12x12 diagonal noise PSD."""
    nbg = 2.0 * params.gyr_bias_std**2 / params.corr_time
    nba = 2.0 * params.acc_bias_std**2 / params.corr_time
    d = torch.stack(
        [params.gyr_arw**2, params.acc_vrw**2, nbg, nba]
    ).repeat_interleave(3)
    return torch.diag(d.to(dtype) if dtype is not None else d)


def _scan(op, x, dim):
    """Inclusive prefix of ``x`` along ``dim`` under the associative
    ``op(earlier, later)``, in log2(n) batched rounds (Hillis-Steele)."""
    n, d = x.shape[dim], 1
    while d < n:
        x = torch.cat([x.narrow(dim, 0, d),
                       op(x.narrow(dim, 0, n - d), x.narrow(dim, d, n - d))], dim)
        d *= 2
    return x


def _compose_tree(phi, qk):
    """(J, P) of the recursions J <- Phi J, P <- Phi P Phi^T + Q over the
    steps (axis -3), composed pairwise in a log-depth tree padded to a
    power of two with the identity step, as the JAX package does."""
    n, d = phi.shape[-3], phi.shape[-1]
    n_pow2 = 1 << (n - 1).bit_length() if n > 1 else 1
    if n_pow2 != n:
        pad = phi.shape[:-3] + (n_pow2 - n, d, d)
        eye = torch.eye(d, dtype=phi.dtype, device=phi.device).expand(pad)
        phi = torch.cat([phi, eye], -3)
        qk = torch.cat([qk, torch.zeros(pad, dtype=qk.dtype, device=qk.device)], -3)
    while phi.shape[-3] > 1:
        pa, pb = phi[..., 0::2, :, :], phi[..., 1::2, :, :]
        qa, qb = qk[..., 0::2, :, :], qk[..., 1::2, :, :]
        phi = pb @ pa
        qk = pb @ qa @ pb.transpose(-1, -2) + qb
    return phi[..., 0, :, :], qk[..., 0, :, :]


class _Steps(NamedTuple):
    """Per-step quantities of one integration (step axis -2 or -3),
    shared by the plain and the odometer-augmented variants."""

    dth_cur: torch.Tensor  # [..., n, 3] bias-compensated increments
    dv_cur: torch.Tensor
    dt1: torch.Tensor  # [..., n, 1]
    q_comp: torch.Tensor  # [..., n, 4] Earth-compensated delta attitude before the step
    cbb0: torch.Tensor  # [..., n, 3, 3] minus the compensated delta DCM after the step
    q_all: torch.Tensor  # [..., n, 4] continuous state after each step
    v_all: torch.Tensor
    p_all: torch.Tensor
    dq_all: torch.Tensor  # [..., n, 4] delta state after each step
    dv_all: torch.Tensor
    dp_all: torch.Tensor


def _integrate(params: IntegrationParams, state0: NavState, imu: ImuSeq) -> _Steps:
    """The continuous and delta states of every step, as prefix scans."""
    p0 = state0.p
    dtype, dev = p0.dtype, p0.device
    batch = p0.shape[:-1]
    n = imu.dt.shape[-1] - 1  # integration steps
    eye3 = _eye(3, p0)
    q0, q0_inv = state0.q, rot.quat_inv(state0.q)
    iewn = params.iewn.to(dtype)
    gravity = params.gravity.to(dtype)
    step = lambda x: x[..., None, :]  # noqa: E731  state -> [..., 1, k]

    dth_all, dv_all = compensate_bias(imu.dtheta, imu.dvel, imu.dt,
                                      step(state0.bg), step(state0.ba))
    dth_cur, dv_cur = dth_all[..., 1:, :], dv_all[..., 1:, :]
    dvfb, dtheta = coning_sculling(dth_all[..., :-1, :], dv_all[..., :-1, :],
                                   dth_cur, dv_cur)
    dt = imu.dt[..., 1:]
    dt1 = dt[..., None]
    t_new = torch.cumsum(dt, -1)
    qid = torch.zeros(batch + (1, 4), dtype=dtype, device=dev)
    qid[..., 0] = 1.0

    # attitude chains: dq_k = e_1 ... e_k and q_k = qnn_k ... qnn_1 q0 dq_k
    e = rot.rotvec_to_quat(dtheta)
    dq_all = rot.quat_normalize(_scan(rot.quat_mul, e, -2))
    qnn = rot.rotvec_to_quat(-iewn * dt1)
    left = _scan(lambda a, b: rot.quat_mul(b, a), qnn, -2)
    q_all = rot.quat_normalize(rot.quat_mul(left, rot.quat_mul(step(q0), dq_all)))
    q_prev = torch.cat([step(q0), q_all[..., :-1, :]], -2)
    dq_prev = torch.cat([qid, dq_all[..., :-1, :]], -2)

    # continuous absolute state: v_k = (I - 2 dt [iewn]x) v_{k-1} + c_k
    body_dv = rot.quat_rotate(q_prev, dvfb)
    c = 0.5 * (body_dv + rot.quat_rotate(qnn, body_dv)) + gravity * dt1
    aff = torch.zeros(batch + (n, 4, 4), dtype=dtype, device=dev)
    aff[..., :3, :3] = eye3 - 2.0 * dt1[..., None] * rot.skew(iewn)
    aff[..., :3, 3] = c
    aff[..., 3, 3] = 1.0
    aff = _scan(lambda a, b: b @ a, aff, -3)
    v_all = rot.mv(aff[..., :3, :3], step(state0.v)) + aff[..., :3, 3]
    v_prev = torch.cat([step(state0.v), v_all[..., :-1, :]], -2)
    dvel_abs = c - 2.0 * rot.cross(iewn, v_prev) * dt1
    p_all = step(p0) + torch.cumsum(dt1 * v_prev + 0.5 * dt1 * dvel_abs, -2)

    # delta (preintegrated) state, mid-interval Earth compensation
    qmid = rot.rotvec_to_quat(-iewn * (t_new - 0.5 * dt)[..., None])
    q_comp = rot.quat_mul(step(q0_inv),
                          rot.quat_mul(qmid, rot.quat_mul(step(q0), dq_prev)))
    dvel_d = rot.quat_rotate(q_comp, dvfb)
    dv_all = torch.cumsum(dvel_d, -2)
    dv_prev = dv_all - dvel_d
    dp_all = torch.cumsum(dt1 * dv_prev + 0.5 * dt1 * dvel_d, -2)

    qend = rot.rotvec_to_quat(-iewn * t_new[..., None])
    cbb0 = -rot.quat_to_matrix(
        rot.quat_mul(step(q0_inv), rot.quat_mul(qend, rot.quat_mul(step(q0), dq_all))))
    return _Steps(dth_cur=dth_cur, dv_cur=dv_cur, dt1=dt1, q_comp=q_comp, cbb0=cbb0,
                  q_all=q_all, v_all=v_all, p_all=p_all, dq_all=dq_all, dv_all=dv_all,
                  dp_all=dp_all)


def _imu_blocks(params: IntegrationParams, st: _Steps, n_state: int, n_noise: int):
    """Phi [..., n, n_state, n_state] and G [..., n, n_state, n_noise] of
    every step with the 15-state IMU blocks filled; the odometer variant
    adds its rows."""
    dtype, dev = st.dt1.dtype, st.dt1.device
    eye3 = _eye(3, st.dt1)
    dt2 = st.dt1[..., None]
    cbb0 = st.cbb0
    decay = eye3 * (1.0 - dt2 / params.corr_time.to(dtype))
    lead = st.dt1.shape[:-1]
    phi = torch.zeros(lead + (n_state, n_state), dtype=dtype, device=dev)
    phi[..., 0:3, 0:3] = eye3
    phi[..., 0:3, 3:6] = eye3 * dt2
    phi[..., 3:6, 3:6] = eye3
    phi[..., 3:6, 6:9] = cbb0 @ rot.skew(st.dv_cur)
    phi[..., 3:6, 12:15] = cbb0 * dt2
    phi[..., 6:9, 6:9] = eye3 - rot.skew(st.dth_cur)
    phi[..., 6:9, 9:12] = -eye3 * dt2
    phi[..., 9:12, 9:12] = decay
    phi[..., 12:15, 12:15] = decay
    gt = torch.zeros(lead + (n_state, n_noise), dtype=dtype, device=dev)
    gt[..., 3:6, 3:6] = cbb0
    gt[..., 6:9, 0:3] = -eye3
    gt[..., 9:12, 6:9] = eye3
    gt[..., 12:15, 9:12] = eye3
    return phi, gt


def _propagate(phi, gt, noise, dt1):
    """(J, P) from the steps' transitions and noise maps: the trapezoid
    Q_k = dt/2 (Phi G N G^T + G N G^T Phi^T), composed in the tree."""
    gng = gt @ noise @ gt.transpose(-1, -2)
    qk = 0.5 * dt1[..., None] * (phi @ gng + gng @ phi.transpose(-1, -2))
    return _compose_tree(phi, qk)


def _interval_length(imu: ImuSeq):
    """The interval's length summed in sample order and in the samples'
    dtype, as the JAX scan sums it: a parallel scan on the card rounds
    otherwise, torch's CPU cumsum accumulates float32 in float64, and node
    times feed comparisons (the keyframe interval) that a last bit can
    flip. numpy's cumsum adds one sample after the other in the dtype."""
    t = np.cumsum(imu.dt[..., 1:].cpu().numpy(), -1)[..., -1]
    return torch.as_tensor(t, device=imu.dt.device)


def preintegrate(
    params: IntegrationParams, state0: NavState, imu: ImuSeq
) -> PreintData:
    """Integrate IMU increments from ``state0``.

    ``imu`` starts with the sample *at* the interval start (only the
    coning predecessor); the rest advance the integration. Zero-padded
    samples (dt = dtheta = dvel = 0) are no-ops. ``state0`` fields carry
    the same leading axes as ``imu.dt[..., 0]``.

    The recursions of the JAX package's per-sample scan run over all
    samples at once: the attitude chains are prefix products of
    quaternions, the velocity (with its Coriolis term) a prefix of affine
    maps, positions and deltas cumulative sums, each in log2(n) batched
    rounds; the Jacobian and covariance compose in the JAX package's
    pairwise tree. Only the association order of the sums and products
    differs from a sequential loop.
    """
    st = _integrate(params, state0, imu)
    phi, gt = _imu_blocks(params, st, 15, 12)
    J, P = _propagate(phi, gt, noise_psd(params, state0.p.dtype), st.dt1)

    last = lambda x: x[..., -1, :]  # noqa: E731
    t_acc = _interval_length(imu)
    end_state = NavState(time=state0.time + t_acc, p=last(st.p_all), q=last(st.q_all),
                         v=last(st.v_all), bg=state0.bg, ba=state0.ba)
    return PreintData(
        dp=last(st.dp_all), dv=last(st.dv_all), dq=last(st.dq_all), jac=J, cov=P, dt=t_acc,
        sum_dt_pn=torch.sum(st.dt1 * st.p_all, -2), bg_ref=state0.bg, ba_ref=state0.ba,
        end_state=end_state,
    )


def sqrt_information(cov: torch.Tensor) -> torch.Tensor:
    """Upper-triangular sqrt information chol(cov^-1)^T, computed on the
    diagonally normalized correlation matrix (cov = D Cn D):
    chol(cov^-1)^T = chol(Cn^-1)^T D^-1."""
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=1e-30))
    s = 1.0 / d
    cov_n = cov * s[..., :, None] * s[..., None, :]
    info_n = torch.linalg.inv(cov_n)
    info_n = 0.5 * (info_n + info_n.transpose(-1, -2))
    u_n = torch.linalg.cholesky(info_n).transpose(-1, -2)
    return u_n * s[..., None, :]


def _corrected_terms(preint: PreintData, state0: NavState, state1: NavState,
                     params: IntegrationParams):
    """Bias-corrected deltas and the n-frame residual pieces shared by
    the residual and its Jacobian."""
    dtype = state0.p.dtype
    iewn = params.iewn.to(dtype)
    gravity = params.gravity.to(dtype)
    W = rot.skew(iewn)
    T = preint.dt[..., None]

    dbg = state0.bg - preint.bg_ref
    dba = state0.ba - preint.ba_ref
    jac = preint.jac
    corrected_p = preint.dp + mv(jac[..., 0:3, 9:12], dbg) + mv(jac[..., 0:3, 12:15], dba)
    corrected_v = preint.dv + mv(jac[..., 3:6, 9:12], dbg) + mv(jac[..., 3:6, 12:15], dba)
    phi_bg = mv(jac[..., 6:9, 9:12], dbg)
    corrected_q = rot.quat_mul(preint.dq, rot.rotvec_to_quat(phi_bg))

    p_cor = 2.0 * mv(W, preint.sum_dt_pn - T * state0.p)
    v_cor = 2.0 * mv(W, state1.p - state0.p)
    qnn = rot.rotvec_to_quat(-iewn * T)

    dpn = state1.p - state0.p - state0.v * T - 0.5 * gravity * T * T + p_cor
    dvn = state1.v - state0.v - gravity * T + v_cor
    C0 = rot.quat_to_matrix(rot.quat_inv(state0.q))
    A = rot.quat_mul(rot.quat_inv(state1.q), rot.quat_mul(qnn, state0.q))
    M = rot.quat_mul(A, corrected_q)
    r = torch.cat(
        [
            mv(C0, dpn) - corrected_p,
            mv(C0, dvn) - corrected_v,
            2.0 * M[..., 1:],
            state1.bg - state0.bg,
            state1.ba - state0.ba,
        ],
        -1,
    )
    return r, W, C0, dpn, dvn, A, M, corrected_q, phi_bg


def preint_residual(
    preint: PreintData,
    state0: NavState,
    state1: NavState,
    params: IntegrationParams,
    whiten: bool = True,
) -> torch.Tensor:
    """15-dim preintegration residual; ``whiten`` multiplies by the
    sqrt-information of the propagated covariance."""
    r = _corrected_terms(preint, state0, state1, params)[0]
    if whiten:
        r = mv(sqrt_information(preint.cov), r)
    return r


def _so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian Jr(phi): exp(phi + d) = exp(phi) exp(Jr d)."""
    th2 = torch.sum(phi * phi, -1)[..., None, None]
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    K = rot.skew(phi)
    small = th2 < 1e-12
    a = torch.where(small, 0.5, (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-30))
    b = torch.where(
        small, 1.0 / 6.0, (th - torch.sin(th)) / torch.clamp(th2 * th, min=1e-30)
    )
    return _eye(3, phi) - a * K + b * (K @ K)


def preint_residual_jac(
    preint: PreintData,
    state0: NavState,
    state1: NavState,
    params: IntegrationParams,
):
    """Unwhitened residual + analytic 15x30 Jacobian w.r.t. the boxplus
    deltas [node0 (dp,dtheta,dv,dbg,dba) | node1 (...)]."""
    r, W, C0, dpn, dvn, A, M, corrected_q, phi_bg = _corrected_terms(
        preint, state0, state1, params
    )
    T = preint.dt[..., None, None]
    eye3 = _eye(3, r)
    jac = preint.jac
    CW = C0 @ W

    LA_RB = (rot.quat_left(A) @ rot.quat_right(corrected_q))[..., 1:, 1:]
    LM = rot.quat_left(M)[..., 1:, 1:]
    RM = rot.quat_right(M)[..., 1:, 1:]
    Jr = _so3_right_jacobian(phi_bg)

    J = r.new_zeros(r.shape[:-1] + (15, 30))
    J[..., 0:3, 0:3] = -C0 - 2.0 * T * CW
    J[..., 0:3, 3:6] = rot.skew(mv(C0, dpn))
    J[..., 0:3, 6:9] = -T * C0
    J[..., 0:3, 9:12] = -jac[..., 0:3, 9:12]
    J[..., 0:3, 12:15] = -jac[..., 0:3, 12:15]
    J[..., 0:3, 15:18] = C0
    J[..., 3:6, 0:3] = -2.0 * CW
    J[..., 3:6, 3:6] = rot.skew(mv(C0, dvn))
    J[..., 3:6, 6:9] = -C0
    J[..., 3:6, 9:12] = -jac[..., 3:6, 9:12]
    J[..., 3:6, 12:15] = -jac[..., 3:6, 12:15]
    J[..., 3:6, 15:18] = 2.0 * CW
    J[..., 3:6, 21:24] = C0
    J[..., 6:9, 3:6] = LA_RB
    J[..., 6:9, 9:12] = LM @ Jr @ jac[..., 6:9, 9:12]
    J[..., 6:9, 18:21] = -RM
    J[..., 9:12, 9:12] = -eye3
    J[..., 9:12, 24:27] = eye3
    J[..., 12:15, 12:15] = -eye3
    J[..., 12:15, 27:30] = eye3
    return r, J
