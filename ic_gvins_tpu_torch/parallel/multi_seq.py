"""Multi-sequence bundle adjustment (``parallel/multi_seq.py``).

Many independent sliding windows (sequences, or segments of one) are
optimized together: every leaf of the window and the prior carries a
leading batch axis [B], and each LM iteration evaluates, assembles and
solves all B windows in one set of batched operations
(``torch.func.vmap`` over the solver's pure per-iteration body,
``solver.lm.lm_step``), where the JAX package ``jax.vmap``s
``lm.optimize``.

Across ``torch.distributed`` ranks each rank takes its share of the
sequences (``shard_batch``) and optimizes them with no communication, as
the JAX package's data-parallel mesh axis ``"dp"`` does; ``gather_batch``
makes the results whole on every rank.

Each sequence keeps its own control, as under ``jax.vmap``: its own
accept / reject, damping ``lam``, chi2 gates and culls, and its own early
exit. A sequence that has stopped is frozen while the others go on, and
the loop ends when every sequence has stopped. The host reads the stop
flags once per iteration for all B sequences.

The solver allocates its blocks like the window's tensors
(``new_zeros``) and writes them through adjacent index tensors, so its
indexed writes batch in place under vmap, with no per-sequence fallback.
"""

import torch
import torch.utils._pytree as pytree

from ..data.types import IntegrationParams
from ..solver.assembly import RobustFlags, robust_cost
from ..solver.lm import (
    FUNCTION_TOLERANCE,
    LAMBDA_MAX,
    PARAMETER_TOLERANCE,
    chi2_cull,
    lm_step,
    phase_iters,
)
from ..solver.window import Prior, SolverConfig, Window
from . import assemble


def _batched(fn):
    return torch.func.vmap(fn)


def _where(mask, a, b):
    """Per sequence: leaves of ``a`` where ``mask`` [B], else of ``b``."""
    def pick(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y)
    return pytree.tree_map(pick, a, b)


def _take_vars(win_new: Window, win: Window, accept) -> Window:
    """The window fields an LM step changes, from ``win_new`` where the
    step was accepted."""
    return win._replace(
        nodes=_where(accept, win_new.nodes, win.nodes),
        ext_p=_where(accept, win_new.ext_p, win.ext_p),
        ext_q=_where(accept, win_new.ext_q, win.ext_q),
        td=_where(accept, win_new.td, win.td),
        sodo=_where(accept, win_new.sodo, win.sodo),
        lm_invdepth=_where(accept, win_new.lm_invdepth, win.lm_invdepth),
    )


def lm_run_batch(windows: Window, priors: Prior, cfg: SolverConfig,
                 params: IntegrationParams, flags: RobustFlags, iters: int,
                 lam0: float = 1e-4):
    """``solver.lm.lm_run`` over a batch of windows, each with its own
    damping, accept / reject and early exit. Returns (windows, (cost0,
    cost1, lam, accepted, iters_run)), each statistic a [B] tensor."""
    cost_of = _batched(lambda w, p: robust_cost(w, p, cfg, params, flags))
    step = _batched(lambda w, p, lam: lm_step(w, p, cfg, params, flags, lam))
    cost_init = cost_of(windows, priors)
    B = cost_init.shape[0]
    dev = cost_init.device
    cost = cost_init
    lam = torch.full((B,), lam0, dtype=cost.dtype, device=dev)
    naccept = torch.zeros(B, dtype=torch.int64, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(iters):
        win_new, cost_new, dx_max = step(windows, priors, lam)
        active = ~done
        accept = active & (cost_new < cost)
        windows = _take_vars(win_new, windows, accept)
        converged = accept & (torch.abs(cost - cost_new)
                              < FUNCTION_TOLERANCE * torch.clamp(cost, min=1e-30))
        cost = torch.where(accept, cost_new, cost)
        lam_next = torch.where(accept, torch.clamp(lam / 3.0, min=1e-10), lam * 4.0)
        lam = torch.where(active, lam_next, lam)
        naccept = naccept + accept.to(torch.int64)
        it = it + active.to(torch.int64)
        done = done | (active & (converged | (dx_max < PARAMETER_TOLERANCE)
                                 | (lam > LAMBDA_MAX)))
        if bool(done.all()):  # one host read per iteration for all sequences
            break
    return windows, (cost_init, cost, lam, naccept, it)


def optimize_batch(windows: Window, priors: Prior, cfg: SolverConfig,
                   params: IntegrationParams, iters: int = 20):
    """The two-phase round (``solver.lm.optimize``) over a batch of
    windows: phase 1 with both robust kernels, the chi2 gates, phase 2
    without the GNSS kernel, each sequence on its own. ``cfg`` and
    ``params`` are shared. Returns (windows, (cost0, cost1, n_culled,
    iters_run, accepted)), each a [B] tensor, as the JAX function does."""
    it1, it2 = phase_iters(iters)
    windows, s1 = lm_run_batch(windows, priors, cfg, params,
                               RobustFlags(gnss_kernel=True, reproj_kernel=True), it1)
    windows, n_culled = _batched(lambda w: chi2_cull(w, cfg))(windows)
    windows, s2 = lm_run_batch(windows, priors, cfg, params,
                               RobustFlags(gnss_kernel=False, reproj_kernel=True), it2)
    return windows, (s1[0], s2[1], n_culled, s1[4] + s2[4], s1[3] + s2[3])


def batch_rows(n: int, mesh) -> slice:
    """The sequences of a batch of ``n`` that this rank holds: a contiguous
    run, rank r the sequences [r n / W, (r + 1) n / W) rounded down, so a
    batch that the W ranks do not divide is split as evenly as it can be."""
    if n < mesh.world:
        raise ValueError(f"a batch of {n} cannot give each of {mesh.world} ranks a sequence")
    return slice(n * mesh.rank // mesh.world, n * (mesh.rank + 1) // mesh.world)


def shard_batch(windows: Window, priors: Prior, mesh, axis: str = "dp"):
    """This rank's sequences of the batch (``batch_rows``), on the mesh's
    device; with one rank the whole batch. The JAX function splits the
    batch axis over the devices of ``axis`` and needs the batch to divide
    them; here it need not. ``optimize_batch`` then runs each rank's
    sequences with no communication, as in JAX, and ``gather_batch``
    returns the results of the whole batch to every rank."""
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.shape}")
    rows = batch_rows(windows.nodes.p.shape[0], mesh)
    take = lambda x: x[rows].to(mesh.device)  # noqa: E731
    return pytree.tree_map(take, windows), pytree.tree_map(take, priors)


def gather_batch(tree, n: int, mesh):
    """A pytree of this rank's per-sequence results (leading axis: its
    ``batch_rows(n, mesh)``) made whole on every rank with one collective,
    the same bits on every rank."""
    leaves, spec = pytree.tree_flatten(tree)
    start = batch_rows(n, mesh).start
    return pytree.tree_unflatten(assemble([(x, start, n) for x in leaves], mesh), spec)


def stack_windows(wins: list[Window]) -> Window:
    return pytree.tree_map(lambda *xs: torch.stack(xs), *wins)


def stack_priors(prs: list[Prior]) -> Prior:
    return pytree.tree_map(lambda *xs: torch.stack(xs), *prs)


def unstack(tree, i: int):
    """Sequence ``i`` of a batched window or prior."""
    return pytree.tree_map(lambda x: x[i], tree)
