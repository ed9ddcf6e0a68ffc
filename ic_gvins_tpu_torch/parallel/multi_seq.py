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
flags once per iteration for all B sequences. On a CUDA device the loop's
chains are replayed from CUDA graphs once a batch's shapes come again.

The solver allocates its blocks like the window's tensors
(``new_zeros``) and writes them through adjacent index tensors, so its
indexed writes batch in place under vmap, with no per-sequence fallback.
"""

import torch
import torch.utils._pytree as pytree

from ..data.types import IntegrationParams
from ..solver import graphs
from ..solver.assembly import RobustFlags, robust_cost
from ..solver.lm import (
    FUNCTION_TOLERANCE,
    LAMBDA_MAX,
    PARAMETER_TOLERANCE,
    PHASE1_FLAGS,
    PHASE2_FLAGS,
    chi2_cull,
    lm_step,
    phase_iters,
    take_vars,
)
from ..solver.window import Prior, SolverConfig, Window
from . import assemble


def _batched(fn):
    return torch.func.vmap(fn)


# ---------------------------------------------------------------------------
# The chains: pure functions of the batch's state (a dict of the inputs
# ``windows``, ``priors``, ``cfg``, ``params`` and the loop's [B] tensors)
# that return the entries they change. A run takes each chain's result as
# the new state, eagerly or from a CUDA graph.


def _lm_init(flags: RobustFlags):
    """The phase's starting cost and loop state (``solver.lm.lm_run``'s
    damping 1e-4)."""
    def chain(s):
        cost = _batched(lambda w, p: robust_cost(w, p, s["cfg"], s["params"], flags))(
            s["windows"], s["priors"])
        B, dev = cost.shape[0], cost.device
        zeros = lambda dtype: torch.zeros(B, dtype=dtype, device=dev)  # noqa: E731
        return dict(cost0=cost, cost=cost,
                    lam=torch.full((B,), 1e-4, dtype=cost.dtype, device=dev),
                    naccept=zeros(torch.int64), it=zeros(torch.int64), done=zeros(torch.bool))
    return chain


def _lm_iteration(flags: RobustFlags):
    """One LM iteration of every sequence, through the stop flags."""
    def chain(s):
        windows, cost, lam, done = s["windows"], s["cost"], s["lam"], s["done"]
        step = _batched(lambda w, p, lam: lm_step(w, p, s["cfg"], s["params"], flags, lam))
        win_new, cost_new, dx_max = step(windows, s["priors"], lam)
        active = ~done
        accept = active & (cost_new < cost)
        converged = accept & (torch.abs(cost - cost_new)
                              < FUNCTION_TOLERANCE * torch.clamp(cost, min=1e-30))
        lam_next = torch.where(accept, torch.clamp(lam / 3.0, min=1e-10), lam * 4.0)
        lam = torch.where(active, lam_next, lam)
        done = done | (active & (converged | (dx_max < PARAMETER_TOLERANCE)
                                 | (lam > LAMBDA_MAX)))
        return dict(windows=take_vars(win_new, windows, accept),
                    cost=torch.where(accept, cost_new, cost), lam=lam,
                    naccept=s["naccept"] + accept.to(torch.int64),
                    it=s["it"] + active.to(torch.int64), done=done, all_done=done.all())
    return chain


def _cull(s):
    windows, n_culled = _batched(lambda w: chi2_cull(w, s["cfg"]))(s["windows"])
    return dict(windows=windows, n_culled=n_culled)


# ---------------------------------------------------------------------------
# Running the chains (``solver/graphs.py``): on a CUDA device each chain is
# captured once per key and replayed, one graph launch in place of ~1900
# kernel launches for an LM iteration of the batch.

_GRAPHS = graphs.Graphs()


def graph_counts() -> dict:
    """This process's batched chains captured, replayed from a graph and
    run eagerly (an LM iteration is one chain)."""
    return _GRAPHS.graph_counts()


def reset_graphs():
    """Forget every key and captured graph, and zero ``graph_counts``."""
    _GRAPHS.reset()


def _runner(windows, priors, cfg, params):
    state = dict(windows=windows, priors=priors, cfg=cfg, params=params)
    return _GRAPHS.runner(state, windows.nodes.p.device)


def _lm_phase(run, flags: RobustFlags, iters: int):
    """``solver.lm.lm_run`` over the batch, each sequence with its own
    damping, accept / reject and early exit: (cost0, cost1, lam, accepted,
    iters_run), each a [B] tensor."""
    run.run(("init", flags), _lm_init(flags))
    for _ in range(iters):
        run.run(("iteration", flags), _lm_iteration(flags))
        if bool(run.state["all_done"]):  # one host read per iteration for all sequences
            break
    return run.take("cost0", "cost", "lam", "naccept", "it")


def optimize_batch(windows: Window, priors: Prior, cfg: SolverConfig,
                   params: IntegrationParams, iters: int = 20):
    """The two-phase round (``solver.lm.optimize``) over a batch of
    windows: phase 1 with both robust kernels, the chi2 gates, phase 2
    without the GNSS kernel, each sequence on its own. ``cfg`` and
    ``params`` are shared. Returns (windows, (cost0, cost1, n_culled,
    iters_run, accepted)), each a [B] tensor, as the JAX function does."""
    it1, it2 = phase_iters(iters)
    run = _runner(windows, priors, cfg, params)
    s1 = _lm_phase(run, PHASE1_FLAGS, it1)
    run.run(("cull",), _cull)
    s2 = _lm_phase(run, PHASE2_FLAGS, it2)
    windows, n_culled = run.take("windows", "n_culled")
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
