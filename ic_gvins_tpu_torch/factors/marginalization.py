"""Marginalization of the oldest node into a dense prior, then the window
slide (``factors/marginalization.py``), float64 path.

The factors marginalized are those touching node 0: the existing prior,
node 0's GNSS factor, preintegration interval 0 and every reprojection
factor anchored at node 0. Anchored landmarks form a diagonal block
(eliminated by a divide), then node 0 is one 15x15 Jacobi-scaled block
elimination with a relative eigenvalue gate. The prior stays a quadratic
form (H, g) around the linearization snapshot.
"""

import torch

from ..data.types import IntegrationParams
from ..solver import assembly as asm
from ..solver.window import NODE_DOF, Prior, Window

EPS = 1e-8


def _schur_eliminate_scaled(H1, g1, k: int):
    """Schur-eliminate the leading k dims of (H1, g1) with Jacobi scaling:
    algebraically the plain elimination, with the pseudo-inverse taken on
    a unit-diagonal block. Dims with (near-)zero diagonal are excised."""
    dtype = H1.dtype
    dH = torch.diagonal(H1)
    floor = 1e-12 * torch.clamp(torch.max(dH), min=1.0)
    present = (dH > floor).to(dtype)
    sq = torch.sqrt(torch.maximum(dH, floor))
    s = present / sq
    # |Hs_ij| <= 1 holds for any PSD matrix; the clamp removes rounding
    # excursions and is exact otherwise
    Hs = torch.clamp(H1 * s[:, None] * s[None, :], -1.0, 1.0)
    gs = g1 * s

    A = 0.5 * (Hs[:k, :k] + Hs[:k, :k].T)
    B = Hs[:k, k:]
    w, v = torch.linalg.eigh(A)
    gate = 1e-8 * torch.clamp(torch.max(w), min=1.0)
    keep = w > gate
    w_inv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    a_inv = (v * w_inv[None, :]) @ v.T
    Hp_s = Hs[k:, k:] - B.T @ a_inv @ B
    gp_s = gs[k:] - B.T @ (a_inv @ gs[:k])
    u2 = (present * sq)[k:]
    return Hp_s * u2[:, None] * u2[None, :], gp_s * u2


def _marg_blocks(window: Window, prior: Prior, cfg, params: IntegrationParams):
    """Schur-structured blocks from the factors touching node 0, without
    robust weighting (the reference passes no loss to marginalized
    factors)."""
    N = window.n_nodes
    dev = window.node_valid.device
    sel = asm.FactorSel(
        preint=torch.arange(N - 1, device=dev) == 0,
        gnss=torch.arange(N, device=dev) == 0,
        reproj=(window.lm_ref == 0) & window.lm_valid,
    )
    flags = asm.RobustFlags(gnss_kernel=False, reproj_kernel=False)
    Hxx, gx, Hxl, hll, gl, _ = asm.assemble_blocks(
        window, prior, cfg, params, flags,
        sel=sel, include_soft_priors=False, gauge_fix=False,
    )
    return Hxx, gx, Hxl, hll, gl


def marginalize_node0(window: Window, prior: Prior, cfg, params,
                      forgetting: float = 1.0) -> Prior:
    """The new prior (pre-roll coordinates) from marginalizing node 0 and
    its anchored landmarks; ``forgetting`` < 1 discounts H and g jointly."""
    if window.nodes.p.dtype != torch.float64:
        raise NotImplementedError("marginalization is ported for float64 only")
    DX = window.dim_x
    dtype, dev = window.nodes.p.dtype, window.nodes.p.device
    Hxx, gx, Hxl, hll, gl = _marg_blocks(window, prior, cfg, params)

    # step 1: eliminate anchored landmarks (diagonal block)
    anchored = ((window.lm_ref == 0) & window.lm_valid).to(dtype)
    live_b = anchored * hll > EPS
    hll_safe = torch.where(live_b, hll, torch.ones_like(hll))
    live = live_b.to(dtype)
    Hxl = Hxl * live[None, :]
    gl = gl * live
    Hxl_w = Hxl / hll_safe[None, :]
    H1 = Hxx - Hxl_w @ Hxl.T
    g1 = gx - Hxl_w @ gl

    # step 2: eliminate node 0
    Hp, gp = _schur_eliminate_scaled(H1, g1, NODE_DOF)

    H_full = torch.zeros((DX, DX), dtype=dtype, device=dev)
    H_full[NODE_DOF:, NODE_DOF:] = 0.5 * (Hp + Hp.T) * forgetting
    g_full = torch.zeros(DX, dtype=dtype, device=dev)
    g_full[NODE_DOF:] = gp * forgetting
    return Prior(
        H=H_full, g=g_full, lin_nodes=window.nodes,
        lin_ext_p=window.ext_p, lin_ext_q=window.ext_q,
        lin_td=window.td, lin_sodo=window.sodo,
    )


def _roll1(x, dim=0):
    return torch.roll(x, -1, dims=dim)


def _roll_tree(x):
    """Roll every leaf of a (nested) NamedTuple left by one."""
    return type(x)(*map(_roll_tree, x)) if isinstance(x, tuple) else _roll1(x)


def _roll_clear(x, dim=0, fill=False):
    """Roll left by one along ``dim`` and clear the freed last slot."""
    y = _roll1(x, dim)
    y.select(dim, -1).fill_(fill)
    return y


def slide_window(window: Window, prior: Prior):
    """Roll everything left by one node, clear the freed slots and remap
    the prior's node block and linearization snapshot."""
    N = window.n_nodes
    n15 = N * NODE_DOF
    ref = window.lm_ref
    lm_dead = (ref == 0) & window.lm_valid
    win = window._replace(
        nodes=_roll_tree(window.nodes),
        node_valid=_roll_clear(window.node_valid),
        node_is_kf=_roll_clear(window.node_is_kf),
        preint=_roll_tree(window.preint),
        preint_valid=_roll_clear(window.preint_valid),
        gnss_p=_roll1(window.gnss_p),
        gnss_std=_roll1(window.gnss_std),
        gnss_std_base=_roll1(window.gnss_std_base),
        gnss_valid=_roll_clear(window.gnss_valid),
        frame_td=_roll1(window.frame_td),
        obs_uv=_roll_clear(window.obs_uv, 1, 0.0),
        obs_vel=_roll_clear(window.obs_vel, 1, 0.0),
        obs_valid=_roll_clear(window.obs_valid, 1),
        lm_valid=window.lm_valid & ~lm_dead,
        lm_ref=torch.clamp(ref - 1, min=0),
    )

    def roll_dx(x):
        """Roll the node block of the last axis; freed node dims become 0."""
        node = x[..., :n15].reshape(x.shape[:-1] + (N, NODE_DOF))
        node = _roll_clear(node, node.dim() - 2, 0.0)
        return torch.cat([node.reshape(x.shape[:-1] + (n15,)), x[..., n15:]], -1)

    pr = prior._replace(
        H=roll_dx(roll_dx(prior.H).T).T,
        g=roll_dx(prior.g),
        lin_nodes=_roll_tree(prior.lin_nodes),
    )
    return win, pr


def marginalize_and_slide(window: Window, prior: Prior, cfg, params,
                          forgetting: float = 1.0):
    """Full marginalization round: build the new prior, then slide."""
    return slide_window(window, marginalize_node0(window, prior, cfg, params,
                                                  forgetting))
