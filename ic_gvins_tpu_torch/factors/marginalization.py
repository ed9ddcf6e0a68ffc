"""Marginalization of the oldest node into a dense prior, then the window
slide (``factors/marginalization.py``).

The factors marginalized are those touching node 0: the existing prior,
node 0's GNSS factor, preintegration interval 0 and every reprojection
factor anchored at node 0. Anchored landmarks form a diagonal block
(eliminated by a divide), then node 0 is one 15x15 Jacobi-scaled block
elimination with a relative eigenvalue gate. The prior stays a quadratic
form (H, g) around the linearization snapshot.

In float32, as in the JAX package's float32 mode, the gate is looser
(1e-5 of the largest eigenvalue against 1e-8), the scaled prior is
projected onto its numerically supported eigenspace (H and g), and the
prior's gradient is zeroed: the prior is anchored at the marginalized
estimate.

``remove_node`` and ``insert_node`` shift the window and the prior's node
block around one interior node (second-new keyframes, late GNSS fixes).
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
    gate = (1e-8 if dtype == torch.float64 else 1e-5) * torch.clamp(torch.max(w), min=1.0)
    keep = w > gate
    w_inv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    a_inv = (v * w_inv[None, :]) @ v.T
    Hp_s = Hs[k:, k:] - B.T @ a_inv @ B
    gp_s = gs[k:] - B.T @ (a_inv @ gs[:k])
    if dtype != torch.float64:
        # Float32 rounding accumulated over the slides leaves the prior with
        # negative eigenvalues, which hand LM a descent direction of the
        # cost that the next marginalization bakes in (the bias runs away).
        # Project H onto the eigenspace above a relative gate, exactly (an
        # iterative clip leaves residuals that the unscaling inflates), and
        # drop g's component outside it: a gradient over no curvature is a
        # constant force with no restoring stiffness.
        # The absent dims' rows and columns are exactly zero and project to
        # zero, so the eigenspace is taken on the present dims alone (which
        # costs one host read): on the whole matrix, with its ~200-fold
        # zero eigenvalue, MKL's float32 eigh was measured not to converge.
        idx = torch.nonzero(present[k:]).flatten()
        if idx.numel():
            Hq = Hp_s[idx][:, idx]
            w2, v2 = torch.linalg.eigh(0.5 * (Hq + Hq.T))
            gate2 = 1e-5 * torch.clamp(torch.max(w2), min=1e-30)
            keep2 = (w2 > gate2).to(dtype)
            sub = (idx[:, None], idx[None, :])
            Hp_s = torch.zeros_like(Hp_s).index_put_(sub, (v2 * (w2 * keep2)[None, :]) @ v2.T)
            gp_s = torch.zeros_like(gp_s).index_put_((idx,), v2 @ (keep2 * (v2.T @ gp_s[idx])))
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
    if dtype != torch.float64:
        # float32: keep the Schur information but anchor the prior's mean
        # at the marginalized estimate (g = 0). The exact marginal gradient
        # comes through 1e6-scale cancellations whose float32 noise would
        # act as constant forces in the prior's weak directions.
        gp = torch.zeros_like(gp)

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


def _map_tree(fn, x):
    """Apply ``fn`` to every leaf of a (nested) NamedTuple."""
    return type(x)(*(_map_tree(fn, v) for v in x)) if isinstance(x, tuple) else fn(x)


def _node_dx(x, N, fn):
    """Apply ``fn`` to the [..., N, 15] node block of the last axis."""
    n15 = N * NODE_DOF
    node = fn(x[..., :n15].reshape(x.shape[:-1] + (N, NODE_DOF)))
    return torch.cat([node.reshape(x.shape[:-1] + (n15,)), x[..., n15:]], -1)


def _roll_clear(x, dim=0, fill=False):
    """Roll left by one along ``dim`` and clear the freed last slot."""
    y = _roll1(x, dim)
    y.select(dim, -1).fill_(fill)
    return y


def slide_window(window: Window, prior: Prior):
    """Roll everything left by one node, clear the freed slots and remap
    the prior's node block and linearization snapshot."""
    N = window.n_nodes
    ref = window.lm_ref
    lm_dead = (ref == 0) & window.lm_valid
    win = window._replace(
        nodes=_map_tree(_roll1, window.nodes),
        node_valid=_roll_clear(window.node_valid),
        node_is_kf=_roll_clear(window.node_is_kf),
        preint=_map_tree(_roll1, window.preint),
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
        return _node_dx(x, N, lambda node: _roll_clear(node, node.dim() - 2, 0.0))

    # rows, then columns: the new H is laid out row-major like the old, so
    # that the solver's products with it take the same path every round
    pr = prior._replace(
        H=roll_dx(roll_dx(prior.H.T).T),
        g=roll_dx(prior.g),
        lin_nodes=_map_tree(_roll1, prior.lin_nodes),
    )
    return win, pr


def marginalize_and_slide(window: Window, prior: Prior, cfg, params,
                          forgetting: float = 1.0):
    """Full marginalization round: build the new prior, then slide."""
    return slide_window(window, marginalize_node0(window, prior, cfg, params,
                                                  forgetting))


def _set(x, i, value):
    y = x.clone()
    y[i] = value
    return y


def remove_node(window: Window, prior: Prior, i: int, n_active: int):
    """Drop interior or tail time node ``i`` (< ``n_active``), shifting the
    nodes above it down one slot. Preintegration slot ``i-1`` then spans
    node ``i-1`` -> old node ``i+1`` and must be re-preintegrated by the
    caller. Landmarks anchored at node ``i`` die, later anchors shift
    down, and the prior loses node ``i``'s rows and columns. Freed slots
    take a copy of the last entry, not zeros: masked slots are still
    evaluated, and a zero quaternion or covariance would make NaNs."""
    assert 0 < i < n_active

    def drop(x):
        return torch.cat([x[:i], x[i + 1:], x[-1:]], 0)

    j = i if i < n_active - 1 else i - 1  # the interval that goes

    def drop_pre(x):
        return torch.cat([x[:j], x[j + 1:], x[-1:]], 0)

    preint_valid = _set(drop_pre(window.preint_valid), -1, False)
    if i >= n_active - 1:
        preint_valid[i - 1] = False

    def drop_col(x):
        return torch.cat([x[:, :i], x[:, i + 1:], torch.zeros_like(x[:, :1])], 1)

    lm_dead = (window.lm_ref == i) & window.lm_valid
    win = window._replace(
        nodes=_map_tree(drop, window.nodes),
        node_valid=_set(drop(window.node_valid), -1, False),
        node_is_kf=_set(drop(window.node_is_kf), -1, False),
        preint=_map_tree(drop_pre, window.preint), preint_valid=preint_valid,
        gnss_p=drop(window.gnss_p), gnss_std=drop(window.gnss_std),
        gnss_std_base=drop(window.gnss_std_base),
        gnss_valid=_set(drop(window.gnss_valid), -1, False),
        frame_td=drop(window.frame_td),
        obs_uv=drop_col(window.obs_uv), obs_vel=drop_col(window.obs_vel),
        obs_valid=drop_col(window.obs_valid) & ~lm_dead[:, None],
        lm_valid=window.lm_valid & ~lm_dead,
        lm_ref=torch.where(window.lm_ref > i, window.lm_ref - 1, window.lm_ref),
    )

    N = window.n_nodes

    def drop_dx(x):
        return _node_dx(x, N, lambda node: torch.cat(
            [node[..., :i, :], node[..., i + 1:, :], torch.zeros_like(node[..., :1, :])], -2))

    pr = prior._replace(H=drop_dx(drop_dx(prior.H.T).T), g=drop_dx(prior.g),
                        lin_nodes=_map_tree(drop, prior.lin_nodes))
    return win, pr


def insert_node(window: Window, prior: Prior, i: int, n_active: int):
    """Open a free slot at node index ``i`` (0 < i <= n_active < capacity),
    shifting nodes i.. up by one. The caller fills the slot: node state,
    GNSS fields and both preintegrations around it (slots ``i-1`` and
    ``i``, left invalid here). Landmark anchors at or after ``i`` move up;
    observation columns shift with their nodes. The new slot holds a copy
    of entry ``i-1``, finite and masked until filled."""
    assert 0 < i <= n_active < window.n_nodes

    def ins(x):
        return torch.cat([x[:i], x[i - 1:i], x[i:-1]], 0)

    def ins_pre(x):
        return torch.cat([x[:i - 1], x[i - 2:i - 1] if i >= 2 else x[:1], x[i - 1:-1]], 0)

    preint_valid = ins_pre(window.preint_valid)
    preint_valid[i - 1] = False
    preint_valid[i] = False

    def ins_col(x):
        return torch.cat([x[:, :i], torch.zeros_like(x[:, :1]), x[:, i:-1]], 1)

    win = window._replace(
        nodes=_map_tree(ins, window.nodes),
        node_valid=_set(ins(window.node_valid), i, True),
        node_is_kf=_set(ins(window.node_is_kf), i, False),
        preint=_map_tree(ins_pre, window.preint), preint_valid=preint_valid,
        gnss_p=ins(window.gnss_p), gnss_std=ins(window.gnss_std),
        gnss_std_base=ins(window.gnss_std_base),
        gnss_valid=_set(ins(window.gnss_valid), i, False),
        frame_td=ins(window.frame_td),
        obs_uv=ins_col(window.obs_uv), obs_vel=ins_col(window.obs_vel),
        obs_valid=ins_col(window.obs_valid),
        lm_ref=torch.where(window.lm_ref >= i, window.lm_ref + 1, window.lm_ref),
    )

    N = window.n_nodes

    def ins_dx(x):
        return _node_dx(x, N, lambda node: torch.cat(
            [node[..., :i, :], torch.zeros_like(node[..., :1, :]), node[..., i:-1, :]], -2))

    pr = prior._replace(H=ins_dx(ins_dx(prior.H.T).T), g=ins_dx(prior.g),
                        lin_nodes=_map_tree(ins, prior.lin_nodes))
    return win, pr
