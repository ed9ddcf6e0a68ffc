"""Normal-equation assembly and Schur solve (``solver/assembly.py``).

Every factor class is evaluated for all its factors at once (batch axes
written out), with closed-form Jacobians on the error-state manifold, and
its weighted blocks are accumulated into the Schur-structured system

    (Hxx [DX,DX], gx [DX], Hxl [DX,L], hll [L], gl [L], cost)

over the fixed window layout of ``window.py``. Blocks whose node index
repeats across factors (landmarks sharing an anchor) accumulate with
``index_sum_`` (a sum in a fixed order, on the card too); blocks with
unique indices use indexed ``+=``.

Robustification is IRLS: the Huber weight rho'(chi2) scales each factor's
(H, g) contribution and the robust cost 0.5 * sum(rho(chi2)) drives the LM
accept/reject decision.
"""

from typing import NamedTuple

import torch
import torch.utils._pytree as pytree

from ..common.rotation import mv
from ..data.types import IntegrationParams, NavState
from ..factors.manifold import node_boxplus
from ..factors.residuals import (
    bias_soft_residual_jac,
    gnss_residual_jac,
    huber_weight,
    reprojection_residual,
    reprojection_residual_jac,
)
from ..ins.preintegration import preint_residual, preint_residual_jac, sqrt_information
from ..ins.preintegration_odo import OdoPreintData, preint_odo_residual, preint_odo_residual_jac
from ..mesh import psum, psum_packed, psum_rank0
from .window import EXT_DOF, NODE_DOF, Prior, SolverConfig, Window, state_boxminus

SODO = 7  # the odometer scale's index in the extrinsic block
LM_AXIS = "lm"  # the mesh axis the landmarks are sharded over


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


def index_sum_(acc, index, src):
    """``acc[index[i]] += src[i]`` along dim 0, in place, summed in an order
    that the inputs fix. On the CPU that is ``index_add_`` (one pass in the
    order of ``index``). On the card ``index_add_`` adds with atomics, whose
    order, and so whose rounding, changes from run to run; there it is
    ``index_put_(accumulate=True)``, which sorts the index and adds each
    index's terms in a fixed order."""
    if acc.is_cuda:
        return acc.index_put_((index,), src, accumulate=True)
    return acc.index_add_(0, index, src)


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
# One interval's residual as a function of its local delta
# ---------------------------------------------------------------------------


def _preint_res(window: Window, params: IntegrationParams, i, delta30):
    """Unwhitened residual [15] of interval ``i`` at nodes i and i + 1
    moved by ``delta30`` = [node i (15) | node i + 1 (15)]."""
    s0 = node_boxplus(_nodes_at(window, i), delta30[:NODE_DOF])
    s1 = node_boxplus(_nodes_at(window, i + 1), delta30[NODE_DOF:])
    pre = pytree.tree_map(lambda x: x[i], window.preint)
    return preint_residual(pre, s0, s1, params, whiten=False)


def _preint_res_odo(window: Window, params: IntegrationParams, i, delta31):
    """The odometer variant: residual [19] over [node i (15) | node i + 1
    (15) | sodo (1)]; the window's one scale enters both ends."""
    s0 = node_boxplus(_nodes_at(window, i), delta31[:NODE_DOF])
    s1 = node_boxplus(_nodes_at(window, i + 1), delta31[NODE_DOF:2 * NODE_DOF])
    sodo = window.sodo + delta31[2 * NODE_DOF]
    pre = pytree.tree_map(lambda x: x[i], window.preint)
    return preint_odo_residual(pre, s0, sodo, s1, sodo, params, whiten=False)


def preint_sqrt_info(window: Window) -> torch.Tensor:
    """[N-1, R, R] whitening matrices of all intervals."""
    return sqrt_information(window.preint.cov)


def preint_res_fn(window: Window):
    """(residual function, delta dimension) for this window's
    preintegration variant: ``fn(window, params, i, delta)``, unwhitened."""
    if is_odo_window(window):
        return _preint_res_odo, 2 * NODE_DOF + 1
    return _preint_res, 2 * NODE_DOF


def preint_delta_cols(window: Window) -> torch.Tensor:
    """[N-1, C] global columns of each interval's factor delta."""
    N = window.n_nodes
    dev = window.node_valid.device
    node_cols = (torch.arange(N, device=dev)[:, None] * NODE_DOF
                 + torch.arange(NODE_DOF, device=dev)[None, :])
    cols = torch.cat([node_cols[:-1], node_cols[1:]], 1)
    if is_odo_window(window):
        cols = torch.cat([cols, torch.full((N - 1, 1), N * NODE_DOF + SODO, dtype=cols.dtype,
                                           device=dev)], 1)
    return cols


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
    k1 = k.reshape(1)  # a 1-element index: no host read, also under vmap
    r, J = bias_soft_residual_jac(window.nodes.bg[k1][0], window.nodes.ba[k1][0],
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


def _cost_terms(window: Window, prior: Prior, cfg: SolverConfig,
                params: IntegrationParams, flags: RobustFlags):
    """The robust cost's terms: the squared whitened preintegration
    residuals, the GNSS rho [N], the reprojection rho [L, N], the squared
    bias prior, the prior's 2 x cost and the odometer-scale prior's cost
    (None without the odometer)."""
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
    k1 = k.reshape(1)
    r_b = torch.cat([window.nodes.bg[k1][0] / cfg.bias_prior_bg_std,
                     window.nodes.ba[k1][0] / cfg.bias_prior_ba_std])
    r_b = r_b * torch.any(window.node_valid).to(dtype)
    _, _, prior_cost2 = eval_prior(window, prior)

    chi_g = torch.sum(r_g**2, -1)
    chi_v = torch.sum(r_v**2, -1)
    odo = 0.5 * (window.sodo / cfg.sodo_prior_std) ** 2 if is_odo_window(window) else None
    return (r_pre**2, huber_rho(chi_g) if flags.gnss_kernel else chi_g,
            huber_rho(chi_v) if flags.reproj_kernel else chi_v, r_b**2, prior_cost2, odo)


def robust_cost(window: Window, prior: Prior, cfg: SolverConfig,
                params: IntegrationParams, flags: RobustFlags, mesh=None, also_max=None):
    """Total robust cost 0.5 * sum(rho(chi2)) over all factors. With a
    ``mesh`` the vision term is summed per landmark shard (axis "lm"),
    then over the shards; across ranks the replicated terms enter from
    rank 0 only, in the same all-reduce, so that every rank reads the same
    cost, and ``also_max`` (this rank's 0-dim value) rides along: then
    (cost, the max of ``also_max`` over the ranks)."""
    pre2, rho_g, rho_v, b2, prior_cost2, odo = _cost_terms(window, prior, cfg, params, flags)
    if mesh is not None and mesh.distributed:
        rep = 0.5 * (torch.sum(pre2) + torch.sum(rho_g) + torch.sum(b2) + prior_cost2)
        if odo is not None:
            rep = rep + odo
        return psum_rank0(0.5 * landmark_shards(rho_v, mesh, 1), rep, mesh, also_max)
    cost = 0.5 * (
        torch.sum(pre2)
        + torch.sum(rho_g)
        + landmark_sum(rho_v, mesh, 1)
        + torch.sum(b2)
        + prior_cost2
    )
    if odo is not None:
        cost = cost + odo
    return cost


def landmark_shards(x, mesh, *dims):
    """Per-landmark terms ``x`` [L, ...] summed within each of the rank's
    ``mesh.local("lm")`` contiguous landmark shards (and over the further
    axes ``dims``): [S, ...], not yet reduced over the shards."""
    shards = mesh.local(LM_AXIS)
    xs = x.reshape((shards, x.shape[0] // shards) + x.shape[1:])
    return xs.sum((1,) + tuple(d + 1 for d in dims))


def landmark_sum(x, mesh, *dims):
    """Sum of per-landmark terms ``x`` [L, ...] over the landmarks (and
    the further axes ``dims``): at once, or with a ``mesh`` per shard of
    landmarks and then over the shards and ranks (the JAX ``psum``)."""
    if mesh is None:
        return x.sum((0,) + dims)
    return psum(landmark_shards(x, mesh, *dims), mesh)


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
    mesh=None,
):
    """Schur-structured normal equations ``(Hxx, gx, Hxl, hll, gl, cost)``
    with frozen/invalid dims masked (zero rows/cols, unit diagonal).

    With a ``mesh`` (``parallel.Mesh``) the window holds this rank's
    landmarks, cut into ``mesh.local("lm")`` contiguous shards: the vision
    terms of the state system and the vision cost are summed per shard,
    then over the shards and the ranks in one collective (JAX's ``psum``
    over the mesh axis), while ``Hxl``, ``hll`` and ``gl`` stay per
    landmark."""
    N, L = window.n_nodes, window.n_landmarks
    DX = window.dim_x
    dtype, dev = window.nodes.p.dtype, window.nodes.p.device
    NL = N * NODE_DOF
    ED = EXT_DOF
    # blocks allocated like the window's tensors (``new_zeros``), so that
    # the indexed writes below also batch under ``torch.func.vmap``
    like = window.nodes.p

    Hnn = like.new_zeros((N, NODE_DOF, N, NODE_DOF))
    Hne = like.new_zeros((N, NODE_DOF, ED))
    Hee = like.new_zeros((ED, ED))
    g_n = like.new_zeros((N, NODE_DOF))
    g_e = like.new_zeros(ED)

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
    # node-pair blocks through the [a, b, c, d] view of Hnn [a, c, b, d]:
    # adjacent index tensors, which vmap batches in place
    Hpair = Hnn.permute(0, 2, 1, 3)
    Hpair[i, i] += _ata(Ji, Ji)
    Hpair[j, j] += _ata(Jj, Jj)
    Hpair[i, j] += Aij
    Hpair[j, i] += Aij.transpose(-1, -2)
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
    Hpair[k, k, 0:6, 0:6] += w_g[:, None, None] * _ata(J_g, J_g)
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
    rv_ = r_v[..., None]
    # the vision terms of the state system and the vision cost, each a sum
    # of per-landmark terms over the landmarks (with the further axes
    # ``dims``) or, for dims None, into the landmarks' anchor nodes [N, ...]
    terms = (
        (_ata(wJo, Jo), ()),  # H_oo [N,6,6]
        (_ata(wJr, Jr).sum(1), None),  # H_rr [N,6,6]
        (_ata(wJr, Jo), None),  # H_ro [a=ref, k=obs, 6, 6]
        (_ata(wJo, Je), ()),  # Hne, observing node [N,6,7]
        (_ata(wJr, Je).sum(1), None),  # Hne, anchor node
        (_ata(wJe, Je), (1,)),  # Hee_v [7,7]
        (wJo * rv_, (2,)),  # g_n, observing node [N,6]
        (torch.sum(wJr * rv_, (1, 2)), None),  # g_n, anchor node
        (wJe * rv_, (1, 2)),  # g_e_v [7]
        (huber_rho(chi_v) if flags.reproj_kernel else chi_v, (1,)),  # cost
    )
    if mesh is None:
        sums = [index_sum_(x.new_zeros((N,) + x.shape[1:]), ref, x) if dims is None
                else x.sum((0,) + dims) for x, dims in terms]
    else:
        # per shard of landmarks, then over the shards and the ranks in one
        # collective (JAX's psum of a tuple)
        S = mesh.local(LM_AXIS)
        shard_of = torch.arange(L, device=dev) // (L // S)
        per_anchor = lambda x: index_sum_(  # noqa: E731
            x.new_zeros((S * N,) + x.shape[1:]), shard_of * N + ref, x
        ).reshape((S, N) + x.shape[1:])
        sums = psum_packed([per_anchor(x) if dims is None else landmark_shards(x, mesh, *dims)
                            for x, dims in terms], mesh)
    H_oo, H_rr, H_ro, Hne_o, Hne_r, Hee_v, g_n_o, g_n_r, g_e_v, cost_v = sums
    # block (ref a, obs k) at [a, c, k, d]; its transpose at [k, d, a, c]
    Hpp_v = H_ro.permute(0, 2, 1, 3) + H_ro.permute(1, 3, 0, 2)
    Hpp_v.permute(0, 2, 1, 3)[k, k] += H_oo + H_rr
    Hne_v = Hne_o + Hne_r

    hll = torch.sum(wJl * Jl, (1, 2))
    wJl_ = wJl[..., None]
    H_lo = torch.sum(wJl_ * Jo, 2)  # [L,N,6]
    H_lr = torch.nn.functional.one_hot(ref, N).to(dtype)[:, :, None] * torch.sum(
        wJl_ * Jr, (1, 2)
    )[:, None, :]
    Hln = like.new_zeros((L, N, NODE_DOF))
    Hln[:, :, 0:6] = H_lo + H_lr
    Hle = like.new_zeros((L, ED))
    Hle[:, :7] = torch.sum(wJl_ * Je, (1, 2))

    g_n_v = g_n_o + g_n_r
    g_l = torch.sum(wJl * r_v, (1, 2))

    Hnn[:, 0:6, :, 0:6] += Hpp_v
    Hne[:, 0:6, :7] += Hne_v
    Hee[:7, :7] += Hee_v
    g_n[:, 0:6] += g_n_v
    g_e[:7] += g_e_v
    cost = cost + 0.5 * cost_v

    # --- soft bias prior on the newest node ---
    if include_soft_priors:
        r_b, J_b, k_new = eval_bias_prior(window, cfg)
        k1 = k_new.reshape(1)
        Hpair[k1, k1] += (J_b.T @ J_b)[None]
        g_n[k1] += (J_b.T @ r_b)[None]
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


def assemble(window: Window, prior: Prior, cfg: SolverConfig, params: IntegrationParams,
             flags: RobustFlags):
    """The dense normal equations H [D, D], g [D] (H dx = -g) and the
    robust cost: ``assemble_blocks`` composed into one matrix, for callers
    that solve the whole system in one program (``entry.py``)."""
    Hxx, gx, Hxl, hll, gl, cost = assemble_blocks(window, prior, cfg, params, flags)
    H = torch.cat([torch.cat([Hxx, Hxl], 1), torch.cat([Hxl.T, torch.diag(hll)], 1)], 0)
    return H, torch.cat([gx, gl]), cost


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


def free_mask(window: Window, cfg: SolverConfig) -> torch.Tensor:
    """1.0 for parameters free to move, 0.0 for frozen or invalid ones,
    in the window's dtype."""
    return torch.cat([free_mask_states(window, cfg), free_mask_lm(window)]).to(window.nodes.p.dtype)


def _ns_solve(A, b, iters: int = 26, refine: int = 3):
    """Solve A y = b for a symmetric PD, Jacobi-normalized A by the
    Newton-Schulz inverse iteration plus iterative refinement (the JAX
    package's float32 branch, kept as it is so that the float32 numerics
    are those its design was tuned on). X0 = I / max row-sum gives
    ||I - A X0||_2 < 1 for any SPD A (Gershgorin); the refinement passes
    take the solution to the dtype's noise floor while the inverse iterate
    is still coarse."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    X = eye / torch.max(torch.sum(torch.abs(A), -1))
    for _ in range(iters):
        X = X @ (2.0 * eye - A @ X)
    y = X @ b
    for _ in range(refine):
        y = y + X @ (b - A @ y)
    return y


def solve_reduced(H_red, g_red):
    """Solve the Jacobi-scaled SPD reduced system H_red y = g_red: a dense
    Cholesky in float64, the Newton-Schulz iteration in float32, as the
    JAX package does. Scaled to unit diagonal, the system keeps full
    precision in float32, where the raw information (~1e2 GNSS to ~1e10
    bias links) would exceed its 7 digits. A system that is not positive
    definite gives a NaN step, as JAX's Cholesky does, which LM rejects:
    the factor's status stays on the device, so the solve never waits on
    the host."""
    dtype = H_red.dtype
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"solve_reduced takes float64 or float32, not {dtype}")
    eps = 1e-12 if dtype == torch.float64 else 1e-6
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H_red), min=eps))
    H_n = H_red * s[:, None] * s[None, :]
    H_n = H_n + eps * torch.eye(H_n.shape[0], dtype=dtype, device=H_n.device)
    if dtype == torch.float64:
        L, info = torch.linalg.cholesky_ex(H_n)
        L = torch.where((info == 0)[..., None, None], L, torch.nan)
        # two triangular solves, as JAX's ``cho_solve``: on the card a
        # batched ``cholesky_solve`` goes through MAGMA, which no CUDA graph
        # can capture
        z = torch.linalg.solve_triangular(L, (s * g_red)[..., None], upper=False)
        y = torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]
    else:
        y = _ns_solve(H_n, s * g_red)
    return s * y


def schur_solve_blocks(Hxx, gx, Hxl, hll, gl, lam, mesh=None):
    """Solve the damped system (H + lam diag(H)) dx = -g by eliminating the
    diagonal landmark block. With a ``mesh`` the landmark terms of the
    reduced system are summed per landmark shard, then over the shards and
    the ranks in one collective. Returns (dx_x [DX], dx_l [L])."""
    Hxx_d = Hxx + torch.diag(lam * torch.diagonal(Hxx))
    hll_d = hll * (1.0 + lam)
    Hxl_w = Hxl / hll_d[None, :]
    if mesh is None:
        H_red = Hxx_d - Hxl_w @ Hxl.T
        g_red = gx - Hxl_w @ gl
    else:
        DX, S = Hxl.shape[0], mesh.local(LM_AXIS)
        per_shard = lambda x: x.reshape(DX, S, -1).transpose(0, 1)  # noqa: E731
        Hw = per_shard(Hxl_w)  # [S, DX, L/S]
        H_red_v, g_red_v = psum_packed([Hw @ per_shard(Hxl).transpose(1, 2),
                                        (Hw @ gl.reshape(S, -1, 1))[..., 0]], mesh)
        H_red = Hxx_d - H_red_v
        g_red = gx - g_red_v
    dx_x = -solve_reduced(H_red, g_red)
    dx_l = -(gl + Hxl.T @ dx_x) / hll_d
    return dx_x, dx_l


def schur_solve(H, g, dim_x: int, lam):
    """Solve (H + lam diag(H)) dx = -g for the dense system of ``assemble``
    by eliminating its trailing diagonal landmark block (diagonal clamped
    at 1e-12), through ``schur_solve_blocks``. Returns dx [D]."""
    dx_x, dx_l = schur_solve_blocks(
        H[:dim_x, :dim_x], g[:dim_x], H[:dim_x, dim_x:],
        torch.clamp(torch.diagonal(H)[dim_x:], min=1e-12), g[dim_x:], lam)
    return torch.cat([dx_x, dx_l])
