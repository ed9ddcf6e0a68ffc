"""Landmark-sharded Schur-complement Gauss-Newton step
(``parallel/schur.py``).

The reduced camera system ``H_red = Hxx - sum_l Hxl_l hll_l^-1 Hlx_l`` is
a sum of per-landmark terms, so it shards over landmarks: each shard
computes its landmarks' contribution, the contributions are summed over
the shards (the JAX ``psum``), the small reduced system is solved once,
and the landmark back-substitution stays per landmark. On one card the
shards are slices of one tensor axis.
"""

import torch

from ..data.types import IntegrationParams
from ..solver.assembly import (
    FactorSel,
    RobustFlags,
    assemble_blocks,
    eval_bias_prior,
    free_mask_lm,
    free_mask_states,
)
from ..solver.window import NODE_DOF, Prior, SolverConfig, Window, apply_delta
from . import psum
from .lm_sharded import AXIS, check_mesh


def _zero_prior(window: Window) -> Prior:
    """A prior with no information, linearized at the window's estimate."""
    p = window.nodes.p
    return Prior(H=p.new_zeros((window.dim_x, window.dim_x)), g=p.new_zeros(window.dim_x),
                 lin_nodes=window.nodes, lin_ext_p=window.ext_p, lin_ext_q=window.ext_q,
                 lin_td=window.td, lin_sodo=window.sodo)


def _select(window: Window, preint: bool, gnss: bool, reproj: bool) -> FactorSel:
    dev = window.node_valid.device
    full = lambda n, on: torch.full((n,), on, dtype=torch.bool, device=dev)  # noqa: E731
    return FactorSel(preint=full(window.n_nodes - 1, preint), gnss=full(window.n_nodes, gnss),
                     reproj=full(window.n_landmarks, reproj))


def _reproj_blocks(window: Window, cfg: SolverConfig, params: IntegrationParams,
                   shards: int | None = None):
    """The reprojection factors' contributions, Huber-weighted:
    (Hxx_v [DX,DX], gx_v [DX], Hxl [DX,L], hll [L], gl [L]). With ``shards``
    Hxx_v and gx_v are summed per shard of landmarks, then over the
    shards; Hxl, hll and gl are per landmark."""
    Hxx_v, gx_v, Hxl, hll, gl, _ = assemble_blocks(
        window, _zero_prior(window), cfg, params, RobustFlags(True, True),
        sel=_select(window, False, False, True), include_soft_priors=False,
        gauge_fix=False, shards=shards)
    return Hxx_v, gx_v, Hxl, hll, gl


def _state_system(window: Window, prior: Prior, cfg: SolverConfig,
                  params: IntegrationParams):
    """H [DX,DX], g [DX] over the states only, from the non-vision factors:
    preintegration, Huber-weighted GNSS, the newest node's bias prior and
    the marginalization prior."""
    H, g, _, _, _, _ = assemble_blocks(
        window, prior, cfg, params, RobustFlags(True, True),
        sel=_select(window, True, True, False), include_soft_priors=False,
        gauge_fix=False)
    r_b, J_b, k = eval_bias_prior(window, cfg)
    cols = k * NODE_DOF + torch.arange(NODE_DOF, device=H.device)
    H = H.index_put((cols[:, None], cols[None, :]), J_b.T @ J_b, accumulate=True)
    g = g.index_put((cols,), J_b.T @ r_b, accumulate=True)
    return H, g


def sharded_gn_step(window: Window, prior: Prior, cfg: SolverConfig,
                    params: IntegrationParams, mesh, lam: float = 1e-4) -> Window:
    """One damped Gauss-Newton step with the landmarks sharded over the
    mesh axis "lm" (the landmark capacity must divide its size). Returns
    the updated window."""
    shards = check_mesh(window, mesh, AXIS)
    dtype = window.nodes.p.dtype
    Hx, gx = _state_system(window, prior, cfg, params)
    Hxx_v, gx_v, Hxl, hll, gl = _reproj_blocks(window, cfg, params, shards)
    Hx = Hx + Hxx_v
    gx = gx + gx_v

    lm_free = free_mask_lm(window).to(dtype)
    hll = torch.where(lm_free > 0, hll, torch.ones_like(hll))
    hll_d = hll * (1.0 + lam)
    DX = Hx.shape[0]
    per_shard = lambda x: x.reshape(DX, shards, -1).transpose(0, 1)  # noqa: E731
    Hw = per_shard(Hxl / hll_d[None, :])  # [S, DX, L/S]
    H_red = Hx - psum(Hw @ per_shard(Hxl).transpose(1, 2))
    g_red = gx - psum((per_shard(Hxl) @ (gl * lm_free / hll_d).reshape(shards, -1, 1))[..., 0])

    # damp and freeze the invalid state dims; the reduced solve runs once
    free = free_mask_states(window, cfg).to(dtype)
    H_red = H_red * free[:, None] * free[None, :]
    g_red = g_red * free
    dH = torch.diagonal(H_red)
    H_red = H_red + torch.diag(lam * dH + (dH < 1e-12).to(dtype))
    chol = torch.linalg.cholesky(H_red + 1e-12 * torch.eye(DX, dtype=dtype, device=Hx.device))
    dx_x = -torch.cholesky_solve(g_red[:, None], chol)[:, 0]
    dx_l = -lm_free * (gl + Hxl.T @ dx_x) / hll_d
    return apply_delta(window, torch.cat([dx_x, dx_l]))
