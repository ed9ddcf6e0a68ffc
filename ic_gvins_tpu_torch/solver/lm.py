"""Levenberg-Marquardt loop with two-phase chi2 outlier handling (``solver/lm.py``).

* phase 1: Huber kernels on GNSS + reprojection,
* chi2 gates between the phases: GNSS fixes with chi2 > 7.815 get their std
  inflated by sqrt(chi2/thr), reprojection observations with chi2 > 5.991
  are masked out,
* phase 2: GNSS without kernel, reprojection with kernel.

The JAX ``lax.while_loop`` is a Python loop over chains
(``solver/graphs.py``) that keep the loop's state (cost, damping, counts,
stop flag) on the device; the host reads the stop flag once per
iteration. On a CUDA device the chains are replayed from CUDA graphs once
a window's shapes come again; on the CPU, and landmark-sharded, they run
eagerly. ``parallel/multi_seq.optimize_batch`` runs the same chains over a
batch of windows, each window under the same rule.
"""

from typing import NamedTuple

import torch
import torch.utils._pytree as pytree

from ..data.types import IntegrationParams
from ..mesh import pmax, psum
from . import graphs
from .assembly import (
    RobustFlags,
    assemble_blocks,
    eval_gnss,
    eval_reproj_res,
    LM_AXIS,
    gnss_mask,
    robust_cost,
    schur_solve_blocks,
)
from .window import Prior, SolverConfig, Window, apply_delta

# Ceres Solver default termination criteria
FUNCTION_TOLERANCE = 1e-6  # |cost drop| < tol * cost on an accepted step
PARAMETER_TOLERANCE = 1e-8  # max |dx| below this
LAMBDA_MAX = 1e10  # trust region collapsed

# phase 1 (and the initialization solve): both robust kernels; phase 2: no GNSS kernel
PHASE1_FLAGS = RobustFlags(gnss_kernel=True, reproj_kernel=True)
PHASE2_FLAGS = RobustFlags(gnss_kernel=False, reproj_kernel=True)


class LMStats(NamedTuple):
    cost0: torch.Tensor
    cost1: torch.Tensor
    lam: float
    accepted: int  # number of accepted steps
    iters_run: int  # iterations executed before the early exit


def lm_step(window: Window, prior: Prior, cfg: SolverConfig,
            params: IntegrationParams, flags: RobustFlags, lam, mesh=None):
    """One damped Gauss-Newton step, the pure body of the LM loop: the
    trial window, its robust cost and the step's largest entry (with a
    ``mesh``, the max over the landmark shards and the ranks)."""
    Hxx, gx, Hxl, hll, gl, _ = assemble_blocks(window, prior, cfg, params, flags, mesh=mesh)
    dx_x, dx_l = schur_solve_blocks(Hxx, gx, Hxl, hll, gl, lam, mesh=mesh)
    win_new = apply_delta(window, torch.cat([dx_x, dx_l]))
    dx_max = torch.max(torch.abs(dx_x))
    if mesh is not None and mesh.distributed:
        # the rank's step max rides in the cost's collective, so that every
        # rank decides and stops on the same values
        return (win_new, *robust_cost(win_new, prior, cfg, params, flags, mesh=mesh,
                                      also_max=torch.maximum(dx_max, torch.abs(dx_l).max())))
    cost_new = robust_cost(win_new, prior, cfg, params, flags, mesh=mesh)
    if dx_l.numel():
        l_max = (torch.max(torch.abs(dx_l)) if mesh is None
                 else pmax(torch.abs(dx_l).reshape(mesh.local(LM_AXIS), -1).amax(1)))
        dx_max = torch.maximum(dx_max, l_max)
    return win_new, cost_new, dx_max


def take_vars(win_new: Window, win: Window, accept) -> Window:
    """The window fields an LM step changes (``apply_delta``'s), from
    ``win_new`` where the step was accepted: ``accept`` is 0-dim, or [B]
    over a batch's leading axis."""
    def pick(a, b):
        return torch.where(accept.reshape(accept.shape + (1,) * (a.dim() - accept.dim())), a, b)

    return win._replace(**{k: pytree.tree_map(pick, getattr(win_new, k), getattr(win, k))
                           for k in ("nodes", "ext_p", "ext_q", "td", "sodo", "lm_invdepth")})


# ---------------------------------------------------------------------------
# The loop as chains (``solver/graphs.py``): pure functions of the state (a
# dict of the inputs ``window``, ``prior``, ``cfg``, ``params`` and the
# loop's tensors) that return the entries they change. The loop's tensors
# are 0-dim for one window, and [B] for a batch (``batched``: each leaf of
# the window and the prior has a leading batch axis, and the per-window
# calls run under ``torch.func.vmap``). The rule is elementwise, so each
# member of a batch makes its own window's decisions. Every decision is
# made in float64 on the values the host would read, so a chain's damping,
# accept / reject and stop flags are the host loop's bit for bit.


def _each(fn, batched: bool):
    """``fn`` on one window, or on each window of a batch."""
    return torch.func.vmap(fn) if batched else fn


def _lm_init(flags: RobustFlags, lam0: float, mesh, batched: bool):
    """The phase's starting cost and loop state."""
    def chain(s):
        cost = _each(lambda w, p: robust_cost(w, p, s["cfg"], s["params"], flags, mesh=mesh),
                     batched)(s["window"], s["prior"])
        zero = lambda dtype: torch.zeros(cost.shape, dtype=dtype, device=cost.device)  # noqa: E731
        return dict(cost0=cost, cost=cost,
                    lam=torch.full(cost.shape, lam0, dtype=torch.float64, device=cost.device),
                    naccept=zero(torch.int64), it=zero(torch.int64), done=zero(torch.bool))
    return chain


def _lm_iteration(flags: RobustFlags, mesh, batched: bool):
    """One LM iteration through the stop flags; after ``done`` it changes
    nothing. ``all_done`` is the flag the host reads."""
    def chain(s):
        window, cost, lam, done = s["window"], s["cost"], s["lam"], s["done"]
        step = _each(lambda w, p, lam: lm_step(w, p, s["cfg"], s["params"], flags, lam,
                                               mesh=mesh), batched)
        win_new, cost_new, dx_max = step(window, s["prior"], lam)
        c, c_new = cost.double(), cost_new.double()
        active = ~done
        accept = active & (c_new < c)
        converged = accept & (torch.abs(c - c_new)
                              < FUNCTION_TOLERANCE * torch.clamp(c, min=1e-30))
        lam_next = torch.where(accept, torch.clamp(lam / 3.0, min=1e-10), lam * 4.0)
        lam = torch.where(active, lam_next, lam)
        done = done | (active & (converged | (dx_max.double() < PARAMETER_TOLERANCE)
                                 | (lam > LAMBDA_MAX)))
        return dict(window=take_vars(win_new, window, accept),
                    cost=torch.where(accept, cost_new, cost), lam=lam,
                    naccept=s["naccept"] + accept.to(torch.int64),
                    it=s["it"] + active.to(torch.int64), done=done, all_done=done.all())
    return chain


def _cull(mesh, batched: bool):
    def chain(s):
        window, n_culled = _each(lambda w: chi2_cull(w, s["cfg"], mesh=mesh), batched)(s["window"])
        return dict(window=window, n_culled=n_culled)
    return chain


_GRAPHS = graphs.Graphs()


def graph_counts() -> dict:
    """This process's single-window chains captured, replayed from a graph
    and run eagerly (an LM iteration is one chain)."""
    return _GRAPHS.graph_counts()


def reset_graphs():
    """Forget every key and captured graph, and zero ``graph_counts``."""
    _GRAPHS.reset()


def runner(window: Window, prior: Prior, cfg: SolverConfig, params: IntegrationParams,
           mesh=None, cache: graphs.Graphs = _GRAPHS):
    """The run of a window's chains, or a batch's, with ``cache``'s graphs
    and counts. The landmark-sharded loop runs eagerly: its collectives
    decide on values from every rank."""
    state = dict(window=window, prior=prior, cfg=cfg, params=params)
    if mesh is not None:
        return graphs.Eager(state, cache.counts)
    return cache.runner(state, window.nodes.p.device)


def _lm_phase(run, flags: RobustFlags, iters: int, lam0: float = 1e-4, mesh=None,
              batched: bool = False):
    """One LM run over ``run``'s window or batch: ``iters`` iterations at
    most, the host reading the stop flag after each. Returns (cost0, cost1,
    lam, accepted, iters_run) as device tensors, 0-dim or [B]."""
    run.run(("init", flags, lam0), _lm_init(flags, lam0, mesh, batched))
    for _ in range(iters):
        run.run(("iteration", flags), _lm_iteration(flags, mesh, batched))
        if bool(run.state["all_done"]):  # one host read per iteration: the early exit
            break
    return run.take("cost0", "cost", "lam", "naccept", "it")


def two_phases(run, iters: int, mesh=None, batched: bool = False):
    """Phase 1 with both robust kernels, the chi2 gates, phase 2 without
    the GNSS kernel: each phase's ``_lm_phase`` statistics. The window and
    ``n_culled`` stay in ``run``."""
    it1, it2 = phase_iters(iters)
    stats1 = _lm_phase(run, PHASE1_FLAGS, it1, mesh=mesh, batched=batched)
    run.run(("cull",), _cull(mesh, batched))
    return stats1, _lm_phase(run, PHASE2_FLAGS, it2, mesh=mesh, batched=batched)


def _stats(cost0, cost1, lam, naccept, it) -> LMStats:
    """A single window's phase statistics, read to the host at once."""
    lam, naccept, it = torch.stack([lam, naccept.double(), it.double()]).tolist()
    return LMStats(cost0=cost0, cost1=cost1, lam=lam, accepted=int(naccept), iters_run=int(it))


def lm_run(window: Window, prior: Prior, cfg: SolverConfig,
           params: IntegrationParams, flags: RobustFlags, iters: int,
           lam0: float = 1e-4, mesh=None):
    """LM with multiplicative damping and Ceres-parity early termination;
    ``iters`` is the iteration budget. With a ``mesh`` the landmark sums
    run per shard, then over the shards and the ranks; every decision is
    made once, on values every rank received from one collective."""
    run = runner(window, prior, cfg, params, mesh)
    stats = _stats(*_lm_phase(run, flags, iters, lam0, mesh))
    return run.take("window")[0], stats


def chi2_cull(window: Window, cfg: SolverConfig, mesh=None):
    """Between-phase chi2 gates. A majority of simultaneously bad GNSS fixes
    points at the state, not the sensors, and skips the reweight. With a
    ``mesh`` the culled count is summed per landmark shard, then over the
    shards and the ranks."""
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
    n_culled = (torch.sum(culled) if mesh is None
                else psum(culled.reshape(mesh.local(LM_AXIS), -1).sum(1), mesh))
    return window._replace(gnss_std=gnss_std, obs_valid=obs_valid), n_culled


def phase_iters(iters: int):
    """(phase-1, phase-2) iteration budgets: the reference's num/4 + 3num/4
    split with a 5-iteration phase-1 floor."""
    return max(iters // 4, min(5, iters)), max(iters - iters // 4, 1)


def optimize_impl(window: Window, prior: Prior, cfg: SolverConfig,
                  params: IntegrationParams, iters: int = 20,
                  do_cull: bool = True, mesh=None):
    """Two-phase optimization round. ``do_cull=False`` is the
    initialization-phase solve: one robust LM run, no chi2 gates. A
    ``mesh`` runs it landmark-sharded on a window that holds this rank's
    landmarks (``parallel/lm_sharded.py``). Returns (window, (stats1,
    stats2, n_culled))."""
    run = runner(window, prior, cfg, params, mesh)
    if not do_cull:
        stats = _stats(*_lm_phase(run, PHASE1_FLAGS, iters, mesh=mesh))
        return run.take("window")[0], (stats, stats, 0)
    stats1, stats2 = two_phases(run, iters, mesh)
    window, n_culled = run.take("window", "n_culled")
    return window, (_stats(*stats1), _stats(*stats2), n_culled)


def optimize(window: Window, prior: Prior, cfg: SolverConfig,
             params: IntegrationParams, iters: int = 20, do_cull: bool = True):
    """The estimator's optimization round (see :func:`optimize_impl`)."""
    return optimize_impl(window, prior, cfg, params, iters, do_cull)


def optimize_phase1(window: Window, prior: Prior, cfg: SolverConfig,
                    params: IntegrationParams, iters: int = 20):
    """Phase 1 alone (robust kernels, then the chi2 gates), so that the
    two phases can be timed apart. Returns (window, stats1, n_culled)."""
    run = runner(window, prior, cfg, params)
    stats1 = _stats(*_lm_phase(run, PHASE1_FLAGS, phase_iters(iters)[0]))
    run.run(("cull",), _cull(None, False))
    window, n_culled = run.take("window", "n_culled")
    return window, stats1, n_culled


def optimize_phase2(window: Window, prior: Prior, cfg: SolverConfig,
                    params: IntegrationParams, iters: int = 20):
    """Phase 2 alone (GNSS kernel off). Returns (window, stats2)."""
    return lm_run(window, prior, cfg, params, PHASE2_FLAGS, phase_iters(iters)[1])
