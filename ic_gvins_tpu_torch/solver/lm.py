"""Levenberg-Marquardt loop with two-phase chi2 outlier handling (``solver/lm.py``).

* phase 1: Huber kernels on GNSS + reprojection,
* chi2 gates between the phases: GNSS fixes with chi2 > 7.815 get their std
  inflated by sqrt(chi2/thr), reprojection observations with chi2 > 5.991
  are masked out,
* phase 2: GNSS without kernel, reprojection with kernel.

The JAX ``lax.while_loop`` is a Python loop that reads its stop flag on
the host once per iteration.
"""

from typing import NamedTuple

import torch

from ..data.types import IntegrationParams
from ..parallel import pmax, psum
from .assembly import (
    RobustFlags,
    assemble_blocks,
    eval_gnss,
    eval_reproj_res,
    gnss_mask,
    robust_cost,
    schur_solve_blocks,
)
from .window import Prior, SolverConfig, Window, apply_delta

# Ceres Solver default termination criteria
FUNCTION_TOLERANCE = 1e-6  # |cost drop| < tol * cost on an accepted step
PARAMETER_TOLERANCE = 1e-8  # max |dx| below this
LAMBDA_MAX = 1e10  # trust region collapsed


class LMStats(NamedTuple):
    cost0: torch.Tensor
    cost1: torch.Tensor
    lam: float
    accepted: int  # number of accepted steps
    iters_run: int  # iterations executed before the early exit


def lm_step(window: Window, prior: Prior, cfg: SolverConfig,
            params: IntegrationParams, flags: RobustFlags, lam,
            shards: int | None = None):
    """One damped Gauss-Newton step, the pure body of the LM loop: the
    trial window, its robust cost and the step's largest entry (the max
    over the landmark shards with ``shards``)."""
    Hxx, gx, Hxl, hll, gl, _ = assemble_blocks(window, prior, cfg, params, flags,
                                               shards=shards)
    dx_x, dx_l = schur_solve_blocks(Hxx, gx, Hxl, hll, gl, lam, shards=shards)
    win_new = apply_delta(window, torch.cat([dx_x, dx_l]))
    cost_new = robust_cost(win_new, prior, cfg, params, flags, shards=shards)
    dx_max = torch.max(torch.abs(dx_x))
    if dx_l.numel():
        l_max = (torch.max(torch.abs(dx_l)) if shards is None
                 else pmax(torch.abs(dx_l).reshape(shards, -1).amax(1)))
        dx_max = torch.maximum(dx_max, l_max)
    return win_new, cost_new, dx_max


def lm_run(window: Window, prior: Prior, cfg: SolverConfig,
           params: IntegrationParams, flags: RobustFlags, iters: int,
           lam0: float = 1e-4, shards: int | None = None):
    """LM with multiplicative damping and Ceres-parity early termination;
    ``iters`` is the iteration budget. With ``shards`` the landmark sums
    run per shard, then over the shards; every decision is made once."""
    cost_init = robust_cost(window, prior, cfg, params, flags, shards=shards)
    cost = cost_init
    lam = lam0
    naccept = 0
    it = 0
    while it < iters:
        win_new, cost_new, dx_max = lm_step(window, prior, cfg, params, flags, lam,
                                            shards=shards)
        # one host read per iteration: the accept decision and stop flags
        cost_cur_f, cost_new_f, dx_max = (
            torch.stack([cost, cost_new, dx_max]).tolist()
        )
        accept = cost_new_f < cost_cur_f
        it += 1
        converged = False
        if accept:
            window = win_new
            cost = cost_new
            lam = max(lam / 3.0, 1e-10)
            naccept += 1
            converged = abs(cost_cur_f - cost_new_f) < FUNCTION_TOLERANCE * max(
                cost_cur_f, 1e-30
            )
        else:
            lam = lam * 4.0
        if converged or dx_max < PARAMETER_TOLERANCE or lam > LAMBDA_MAX:
            break
    return window, LMStats(cost0=cost_init, cost1=cost, lam=lam,
                           accepted=naccept, iters_run=it)


def chi2_cull(window: Window, cfg: SolverConfig, shards: int | None = None):
    """Between-phase chi2 gates. A majority of simultaneously bad GNSS fixes
    points at the state, not the sensors, and skips the reweight. With
    ``shards`` the culled count is summed per landmark shard, then over the
    shards."""
    gm = gnss_mask(window)
    r_g, _ = eval_gnss(window._replace(gnss_std=window.gnss_std_base), cfg)
    chi_g = torch.sum(r_g**2, -1)
    n_valid = torch.clamp(torch.sum(gm), min=1)
    majority_bad = torch.sum(gm & (chi_g > 7.815)) * 2 > n_valid
    one = torch.ones_like(chi_g)
    scale = torch.sqrt(torch.clamp(chi_g / 7.815, 1.0, 1e8))
    scale = torch.where(majority_bad, one, scale)
    gnss_std = window.gnss_std_base * scale[:, None]
    if cfg.chi2_compound is not None:
        r_gc, _ = eval_gnss(window, cfg)
        chi_c = torch.sum(r_gc**2, -1)
        scale_c = torch.sqrt(torch.clamp(chi_c / 7.815, min=1.0))
        scale_c = torch.where(majority_bad, one, scale_c)
        gnss_std = torch.where(
            cfg.chi2_compound, window.gnss_std * scale_c[:, None], gnss_std
        )

    r_v = eval_reproj_res(window, cfg)
    chi_v = torch.sum(r_v**2, -1)
    obs_valid = window.obs_valid & (chi_v <= 5.991)
    culled = window.obs_valid & ~obs_valid
    n_culled = (torch.sum(culled) if shards is None
                else psum(culled.reshape(shards, -1).sum(1)))
    return window._replace(gnss_std=gnss_std, obs_valid=obs_valid), n_culled


def phase_iters(iters: int):
    """(phase-1, phase-2) iteration budgets: the reference's num/4 + 3num/4
    split with a 5-iteration phase-1 floor."""
    return max(iters // 4, min(5, iters)), max(iters - iters // 4, 1)


def optimize_impl(window: Window, prior: Prior, cfg: SolverConfig,
                  params: IntegrationParams, iters: int = 20,
                  do_cull: bool = True, shards: int | None = None):
    """Two-phase optimization round. ``do_cull=False`` is the
    initialization-phase solve: one robust LM run, no chi2 gates.
    ``shards`` runs it landmark-sharded (``parallel/lm_sharded.py``).
    Returns (window, (stats1, stats2, n_culled))."""
    robust = RobustFlags(gnss_kernel=True, reproj_kernel=True)
    if not do_cull:
        window, stats = lm_run(window, prior, cfg, params, robust, iters, shards=shards)
        return window, (stats, stats, 0)
    it1, it2 = phase_iters(iters)
    window, stats1 = lm_run(window, prior, cfg, params, robust, it1, shards=shards)
    window, n_culled = chi2_cull(window, cfg, shards=shards)
    flags2 = RobustFlags(gnss_kernel=False, reproj_kernel=True)
    window, stats2 = lm_run(window, prior, cfg, params, flags2, it2, shards=shards)
    return window, (stats1, stats2, n_culled)


def optimize(window: Window, prior: Prior, cfg: SolverConfig,
             params: IntegrationParams, iters: int = 20, do_cull: bool = True):
    """The estimator's optimization round (see :func:`optimize_impl`)."""
    return optimize_impl(window, prior, cfg, params, iters, do_cull)


def optimize_phase1(window: Window, prior: Prior, cfg: SolverConfig,
                    params: IntegrationParams, iters: int = 20):
    """Phase 1 alone (robust kernels, then the chi2 gates), so that the
    two phases can be timed apart. Returns (window, stats1, n_culled)."""
    window, stats1 = lm_run(window, prior, cfg, params,
                            RobustFlags(gnss_kernel=True, reproj_kernel=True),
                            phase_iters(iters)[0])
    window, n_culled = chi2_cull(window, cfg)
    return window, stats1, n_culled


def optimize_phase2(window: Window, prior: Prior, cfg: SolverConfig,
                    params: IntegrationParams, iters: int = 20):
    """Phase 2 alone (GNSS kernel off). Returns (window, stats2)."""
    return lm_run(window, prior, cfg, params,
                  RobustFlags(gnss_kernel=False, reproj_kernel=True),
                  phase_iters(iters)[1])
