"""Normal-equation assembly and Schur solve (``solver/assembly.py``).

Every factor class is evaluated for all its factors at once (batch axes
written out), with closed-form Jacobians on the error-state manifold, and
its weighted blocks are accumulated into the Schur-structured system

    (Hxx [DX,DX], gx [DX], Hxl [DX,L], hll [L], gl [L], cost)

over the fixed window layout of ``window.py``. Blocks whose node index
repeats across factors (landmarks sharing an anchor) accumulate with
``index_add_``; blocks with unique indices use indexed ``+=``.

Robustification is IRLS: the Huber weight rho'(chi2) scales each factor's
(H, g) contribution and the robust cost 0.5 * sum(rho(chi2)) drives the LM
accept/reject decision.
"""

from typing import NamedTuple

import torch

from ..common.rotation import mv
from ..data.types import IntegrationParams, NavState
from ..factors.residuals import (
    bias_soft_residual_jac,
    gnss_residual_jac,
    reprojection_residual,
    reprojection_residual_jac,
)
from ..ins.preintegration import preint_residual, preint_residual_jac, sqrt_information
from ..ins.preintegration_odo import OdoPreintData, preint_odo_residual, preint_odo_residual_jac
from .window import EXT_DOF, NODE_DOF, Prior, SolverConfig, Window, state_boxminus

SODO = 7  # the odometer scale's index in the extrinsic block


class RobustFlags(NamedTuple):
    gnss_kernel: bool
    reproj_kernel: bool


class FactorSel(NamedTuple):
    """Sub-selection of factors for assembly (marginalization uses the
    factors touching node 0)."""

    preint: torch.Tensor  # [N-1] bool
    gnss: torch.Tensor  # [N] bool
    reproj: torch.Tensor  # [L] bool (per landmark)


def huber_rho(s):
    return torch.where(s <= 1.0, s, 2.0 * torch.sqrt(torch.clamp(s, min=1.0)) - 1.0)


def huber_weight(s):
    return torch.clamp(1.0 / torch.sqrt(torch.clamp(s, min=1e-30)), max=1.0)


def is_odo_window(window: Window) -> bool:
    """Does the window carry odometer-augmented intervals (the ODO /
    EARTH_ODO variants)?"""
    return isinstance(window.preint, OdoPreintData)


def _nodes_at(window: Window, idx) -> NavState:
    return NavState(*(x[idx] for x in window.nodes))


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------


def preint_mask(window: Window):
    return window.preint_valid & window.node_valid[:-1] & window.node_valid[1:]


def gnss_mask(window: Window):
    return window.gnss_valid & window.node_valid


def obs_mask(window: Window):
    """[L, N] reprojection factor mask: valid obs in a valid keyframe node,
    valid landmark, anchored at a *different* valid keyframe node."""
    L, N = window.obs_valid.shape
    ref = window.lm_ref.long()
    kf = window.node_valid & window.node_is_kf
    k_idx = torch.arange(N, device=ref.device)[None, :]
    return (
        window.obs_valid
        & window.lm_valid[:, None]
        & kf[ref][:, None]
        & kf[None, :]
        & (k_idx != ref[:, None])
    )


def newest_node_index(window: Window) -> torch.Tensor:
    N = window.n_nodes
    return N - 1 - torch.argmax(torch.flip(window.node_valid, [0]).to(torch.uint8))


# ---------------------------------------------------------------------------
# Batched residual / Jacobian evaluation
# ---------------------------------------------------------------------------


def _preint_pairs(window: Window):
    n = window.n_nodes
    return _nodes_at(window, slice(0, n - 1)), _nodes_at(window, slice(1, n))


def eval_preint(window: Window, params: IntegrationParams):
    """Whitened residuals [N-1,R] and Jacobians [N-1,R,C], masked (R, C =
    15, 30 plain; 19, 31 with the odometer, column 30 the window's scale)."""
    s0, s1 = _preint_pairs(window)
    if is_odo_window(window):
        r, J = preint_odo_residual_jac(window.preint, s0, s1, window.sodo, params)
    else:
        r, J = preint_residual_jac(window.preint, s0, s1, params)
    S = sqrt_information(window.preint.cov)
    m = preint_mask(window).to(r.dtype)
    return mv(S, r) * m[:, None], (S @ J) * m[:, None, None]


def eval_gnss(window: Window, cfg: SolverConfig):
    """Residuals [N,3] and Jacobians [N,3,6] w.r.t. the pose delta, masked."""
    std = torch.clamp(window.gnss_std, min=1e-6)
    r, J = gnss_residual_jac(window.nodes.p, window.nodes.q, cfg.antlever,
                             window.gnss_p, std)
    m = gnss_mask(window).to(r.dtype)
    return r * m[:, None], J * m[:, None, None]


def _reproj_args(window: Window):
    """Per-observation inputs of the [L, N] reprojection factors."""
    L, N = window.obs_valid.shape
    ref = window.lm_ref.long()
    lidx = torch.arange(L, device=ref.device)
    nref = _nodes_at(window, ref)
    ex = lambda x: x[:, None].expand((L, N) + x.shape[1:])  # noqa: E731
    ey = lambda x: x[None].expand((L,) + x.shape)  # noqa: E731
    invd = window.lm_invdepth
    guarded = torch.abs(invd) < 1e-4
    invd = torch.where(guarded, torch.full_like(invd, 1e-4), invd)
    args = (
        ex(nref.p), ex(nref.q), ey(window.nodes.p), ey(window.nodes.q),
        window.ext_p, window.ext_q, ex(invd), window.td,
        ex(window.obs_uv[lidx, ref]), window.obs_uv,
        ex(window.obs_vel[lidx, ref]), window.obs_vel,
        ex(window.frame_td[ref]), ey(window.frame_td),
    )
    return args, guarded


def eval_reproj(window: Window, cfg: SolverConfig):
    """Residuals [L,N,2] and Jacobians [L,N,2,20], masked. Jacobian
    columns: [ref pose 6 | obs pose 6 | ext 6 | td 1 | invdepth 1]."""
    args, guarded = _reproj_args(window)
    r, J = reprojection_residual_jac(*args, cfg.reproj_std)
    # a guarded inverse depth is a constant: no derivative w.r.t. it
    J[..., 19] = J[..., 19] * (~guarded).to(J.dtype)[:, None, None]
    m = obs_mask(window).to(r.dtype)
    return r * m[..., None], J * m[..., None, None]


def eval_reproj_res(window: Window, cfg: SolverConfig):
    """Masked reprojection residuals only [L,N,2]."""
    args, _ = _reproj_args(window)
    r = reprojection_residual(*args, cfg.reproj_std)
    return r * obs_mask(window).to(r.dtype)[..., None]


def eval_bias_prior(window: Window, cfg: SolverConfig):
    k = newest_node_index(window)
    r, J = bias_soft_residual_jac(window.nodes.bg[k], window.nodes.ba[k],
                                  cfg.bias_prior_bg_std, cfg.bias_prior_ba_std)
    m = torch.any(window.node_valid).to(r.dtype)
    return r * m, J * m, k


def eval_prior(window: Window, prior: Prior):
    """Prior quadratic form at the current estimate: (H, g + H dx,
    dx^T H dx + 2 g^T dx)."""
    dx = state_boxminus(window, prior)
    Hdx = prior.H @ dx
    return prior.H, prior.g + Hdx, dx @ Hdx + 2.0 * (prior.g @ dx)


# ---------------------------------------------------------------------------
# Cost / assembly
# ---------------------------------------------------------------------------


def robust_cost(window: Window, prior: Prior, cfg: SolverConfig,
                params: IntegrationParams, flags: RobustFlags):
    """Total robust cost 0.5 * sum(rho(chi2)) over all factors."""
    dtype = window.nodes.p.dtype
    s0, s1 = _preint_pairs(window)
    if is_odo_window(window):
        sodo = window.sodo
        r_pre = preint_odo_residual(window.preint, s0, sodo, s1, sodo, params, whiten=True)
    else:
        r_pre = preint_residual(window.preint, s0, s1, params, whiten=True)
    r_pre = r_pre * preint_mask(window).to(dtype)[:, None]
    r_g, _ = eval_gnss(window, cfg)
    r_v = eval_reproj_res(window, cfg)
    k = newest_node_index(window)
    r_b = torch.cat([window.nodes.bg[k] / cfg.bias_prior_bg_std,
                     window.nodes.ba[k] / cfg.bias_prior_ba_std])
    r_b = r_b * torch.any(window.node_valid).to(dtype)
    _, _, prior_cost2 = eval_prior(window, prior)

    chi_g = torch.sum(r_g**2, -1)
    chi_v = torch.sum(r_v**2, -1)
    cost = 0.5 * (
        torch.sum(r_pre**2)
        + torch.sum(huber_rho(chi_g) if flags.gnss_kernel else chi_g)
        + torch.sum(huber_rho(chi_v) if flags.reproj_kernel else chi_v)
        + torch.sum(r_b**2)
        + prior_cost2
    )
    if is_odo_window(window):
        cost = cost + 0.5 * (window.sodo / cfg.sodo_prior_std) ** 2
    return cost


def _ata(a, b):
    """sum_r a[..., r, c] b[..., r, d] -> [..., c, d]."""
    return a.transpose(-1, -2) @ b


def assemble_blocks(
    window: Window,
    prior: Prior,
    cfg: SolverConfig,
    params: IntegrationParams,
    flags: RobustFlags,
    sel: FactorSel = None,
    include_soft_priors: bool = True,
    gauge_fix: bool = True,
):
    """Schur-structured normal equations ``(Hxx, gx, Hxl, hll, gl, cost)``
    with frozen/invalid dims masked (zero rows/cols, unit diagonal)."""
    N, L = window.n_nodes, window.n_landmarks
    DX = window.dim_x
    dtype, dev = window.nodes.p.dtype, window.nodes.p.device
    NL = N * NODE_DOF
    ED = EXT_DOF
    kw = dict(dtype=dtype, device=dev)

    Hnn = torch.zeros((N, NODE_DOF, N, NODE_DOF), **kw)
    Hne = torch.zeros((N, NODE_DOF, ED), **kw)
    Hee = torch.zeros((ED, ED), **kw)
    g_n = torch.zeros((N, NODE_DOF), **kw)
    g_e = torch.zeros(ED, **kw)

    # --- preintegration factors: block-tridiagonal, unique indices ---
    r_pre, J_pre = eval_preint(window, params)
    if sel is not None:
        m_sel = sel.preint.to(dtype)
        r_pre, J_pre = r_pre * m_sel[:, None], J_pre * m_sel[:, None, None]
    Ji = J_pre[..., :NODE_DOF]
    Jj = J_pre[..., NODE_DOF : 2 * NODE_DOF]
    i = torch.arange(N - 1, device=dev)
    j = i + 1
    Aij = _ata(Ji, Jj)
    Hnn[i, :, i, :] += _ata(Ji, Ji)
    Hnn[j, :, j, :] += _ata(Jj, Jj)
    Hnn[i, :, j, :] += Aij
    Hnn[j, :, i, :] += Aij.transpose(-1, -2)
    g_n[i] += mv(Ji.transpose(-1, -2), r_pre)
    g_n[j] += mv(Jj.transpose(-1, -2), r_pre)
    if is_odo_window(window):
        Js = J_pre[..., 2 * NODE_DOF]  # w.r.t. the window's odometer scale
        Hne[i, :, SODO] += mv(Ji.transpose(-1, -2), Js)
        Hne[j, :, SODO] += mv(Jj.transpose(-1, -2), Js)
        Hee[SODO, SODO] += torch.sum(Js * Js)
        g_e[SODO] += torch.sum(Js * r_pre)
    cost = 0.5 * torch.sum(r_pre**2)

    # --- GNSS factors (Huber-weighted IRLS), diagonal pose blocks ---
    r_g, J_g = eval_gnss(window, cfg)
    if sel is not None:
        m_sel = sel.gnss.to(dtype)
        r_g, J_g = r_g * m_sel[:, None], J_g * m_sel[:, None, None]
    chi_g = torch.sum(r_g**2, -1)
    w_g = huber_weight(chi_g) if flags.gnss_kernel else torch.ones_like(chi_g)
    k = torch.arange(N, device=dev)
    Hnn[k, 0:6, k, 0:6] += w_g[:, None, None] * _ata(J_g, J_g)
    g_n[:, 0:6] += w_g[:, None] * mv(J_g.transpose(-1, -2), r_g)
    cost = cost + 0.5 * torch.sum(huber_rho(chi_g) if flags.gnss_kernel else chi_g)

    # --- reprojection factors ---
    r_v, J_v = eval_reproj(window, cfg)  # [L,N,2], [L,N,2,20]
    if sel is not None:
        m_sel = sel.reproj.to(dtype)
        r_v = r_v * m_sel[:, None, None]
        J_v = J_v * m_sel[:, None, None, None]
    chi_v = torch.sum(r_v**2, -1)
    w_v = huber_weight(chi_v) if flags.reproj_kernel else torch.ones_like(chi_v)
    Jr = J_v[..., 0:6]  # ref pose
    Jo = J_v[..., 6:12]  # obs pose
    Je = J_v[..., 12:19]  # extrinsic + td
    Jl = J_v[..., 19]  # landmark column
    wJr = w_v[..., None, None] * Jr
    wJo = w_v[..., None, None] * Jo
    wJe = w_v[..., None, None] * Je
    wJl = w_v[..., None] * Jl
    ref = window.lm_ref.long()

    def by_anchor(x):
        """Sum per-landmark terms [L, ...] into their anchor nodes [N, ...]."""
        return torch.zeros((N,) + x.shape[1:], **kw).index_add_(0, ref, x)

    H_oo = _ata(wJo, Jo).sum(0)  # [N,6,6]
    H_rr = by_anchor(_ata(wJr, Jr).sum(1))  # [N,6,6]
    H_ro = by_anchor(_ata(wJr, Jo))  # [a=ref, k=obs, 6, 6]
    # block (ref a, obs k) at [a, c, k, d]; its transpose at [k, d, a, c]
    Hpp_v = H_ro.permute(0, 2, 1, 3) + H_ro.permute(1, 3, 0, 2)
    Hpp_v[k, :, k, :] += H_oo + H_rr
    Hne_v = _ata(wJo, Je).sum(0) + by_anchor(_ata(wJr, Je).sum(1))  # [N,6,7]
    Hee_v = _ata(wJe, Je).sum((0, 1))  # [7,7]

    hll = torch.sum(wJl * Jl, (1, 2))
    wJl_ = wJl[..., None]
    H_lo = torch.sum(wJl_ * Jo, 2)  # [L,N,6]
    H_lr = torch.nn.functional.one_hot(ref, N).to(dtype)[:, :, None] * torch.sum(
        wJl_ * Jr, (1, 2)
    )[:, None, :]
    Hln = torch.zeros((L, N, NODE_DOF), **kw)
    Hln[:, :, 0:6] = H_lo + H_lr
    Hle = torch.zeros((L, ED), **kw)
    Hle[:, :7] = torch.sum(wJl_ * Je, (1, 2))

    rv_ = r_v[..., None]
    g_n_v = torch.sum(wJo * rv_, (0, 2)) + by_anchor(torch.sum(wJr * rv_, (1, 2)))
    g_e_v = torch.sum(wJe * rv_, (0, 1, 2))
    g_l = torch.sum(wJl * r_v, (1, 2))

    Hnn[:, 0:6, :, 0:6] += Hpp_v
    Hne[:, 0:6, :7] += Hne_v
    Hee[:7, :7] += Hee_v
    g_n[:, 0:6] += g_n_v
    g_e[:7] += g_e_v
    cost = cost + 0.5 * torch.sum(huber_rho(chi_v) if flags.reproj_kernel else chi_v)

    # --- soft bias prior on the newest node ---
    if include_soft_priors:
        r_b, J_b, k_new = eval_bias_prior(window, cfg)
        Hnn[k_new, :, k_new, :] += J_b.T @ J_b
        g_n[k_new] += J_b.T @ r_b
        cost = cost + 0.5 * torch.sum(r_b**2)

    # --- soft odometer-scale prior (imu_error_factor.h) ---
    if include_soft_priors and is_odo_window(window):
        w_s = 1.0 / cfg.sodo_prior_std**2
        Hee[SODO, SODO] += w_s
        g_e[SODO] += w_s * window.sodo
        cost = cost + 0.5 * w_s * window.sodo**2

    # --- marginalization / initialization prior ---
    P, g_pri, prior_cost2 = eval_prior(window, prior)
    Hnn += P[:NL, :NL].reshape(N, NODE_DOF, N, NODE_DOF)
    Hne += P[:NL, NL:DX].reshape(N, NODE_DOF, ED)
    Hee += P[NL:DX, NL:DX]
    g_n += g_pri[:NL].reshape(N, NODE_DOF)
    g_e += g_pri[NL:DX]
    cost = cost + 0.5 * prior_cost2

    Hne2 = Hne.reshape(NL, ED)
    Hxx = torch.cat([
        torch.cat([Hnn.reshape(NL, NL), Hne2], 1),
        torch.cat([Hne2.T, Hee], 1),
    ], 0)
    gx = torch.cat([g_n.reshape(-1), g_e])
    Hxl = torch.cat([Hln.reshape(L, NL), Hle], 1).T  # [DX, L]

    if gauge_fix:
        fx = free_mask_states(window, cfg).to(dtype)
        fl = free_mask_lm(window).to(dtype)
        Hxx = Hxx * fx[:, None] * fx[None, :]
        Hxx = Hxx + torch.diag((torch.diagonal(Hxx) < 1e-12).to(dtype))
        gx = gx * fx
        Hxl = Hxl * fx[:, None] * fl[None, :]
        hll = torch.where(hll * fl < 1e-12, torch.ones_like(hll), hll * fl)
        gl = g_l * fl
    else:
        gl = g_l
    return Hxx, gx, Hxl, hll, gl, cost


def free_mask_states(window: Window, cfg: SolverConfig) -> torch.Tensor:
    """[DX] bool: state dims free to move (valid nodes + enabled ext/td,
    and the odometer scale in odometer windows)."""
    dev = window.node_valid.device
    node_free = window.node_valid.repeat_interleave(NODE_DOF)
    flag = lambda b, n: torch.as_tensor(b, device=dev).to(torch.bool).reshape(1).expand(n)  # noqa: E731
    return torch.cat([
        node_free, flag(cfg.estimate_extrinsic, 6), flag(cfg.estimate_td, 1),
        flag(cfg.estimate_sodo, 1) & is_odo_window(window),
    ])


def free_mask_lm(window: Window) -> torch.Tensor:
    """[L] bool: landmarks free to move (valid with >= 1 live factor)."""
    return window.lm_valid & (torch.sum(obs_mask(window), 1) > 0)


def solve_reduced(H_red, g_red):
    """Solve the Jacobi-scaled SPD reduced system H_red y = g_red by a
    dense Cholesky (the JAX package's float64 branch)."""
    dtype = H_red.dtype
    if dtype != torch.float64:
        raise NotImplementedError("the solver is ported for float64 only")
    eps = 1e-12
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H_red), min=eps))
    H_n = H_red * s[:, None] * s[None, :]
    H_n = H_n + eps * torch.eye(H_n.shape[0], dtype=dtype, device=H_n.device)
    L = torch.linalg.cholesky(H_n)
    y = torch.cholesky_solve((s * g_red)[:, None], L)[:, 0]
    return s * y


def schur_solve_blocks(Hxx, gx, Hxl, hll, gl, lam):
    """Solve the damped system (H + lam diag(H)) dx = -g by eliminating the
    diagonal landmark block. Returns (dx_x [DX], dx_l [L])."""
    Hxx_d = Hxx + torch.diag(lam * torch.diagonal(Hxx))
    hll_d = hll * (1.0 + lam)
    Hxl_w = Hxl / hll_d[None, :]
    H_red = Hxx_d - Hxl_w @ Hxl.T
    g_red = gx - Hxl_w @ gl
    dx_x = -solve_reduced(H_red, g_red)
    dx_l = -(gl + Hxl.T @ dx_x) / hll_d
    return dx_x, dx_l
