"""Multi-sequence bundle adjustment (``parallel/multi_seq.py``).

Many independent sliding windows (sequences, or segments of one) are
optimized together: every leaf of the window and the prior carries a
leading batch axis [B], and each LM iteration evaluates, assembles and
solves all B windows in one set of batched operations. The loop is
``solver/lm.py``'s own chains with their per-window calls under
``torch.func.vmap``, where the JAX package ``jax.vmap``s
``lm.optimize``.

Across ``torch.distributed`` ranks each rank takes its share of the
sequences (``shard_batch``) and optimizes them with no communication, as
the JAX package's data-parallel mesh axis ``"dp"`` does; ``gather_batch``
makes the results whole on every rank.

Each sequence keeps its own control, as under ``jax.vmap``: its own
accept / reject, damping ``lam``, chi2 gates and culls, and its own early
exit, by the rule its own ``lm.optimize`` follows. A sequence that has
stopped is frozen while the others go on, and the loop ends when every
sequence has stopped. The host reads the stop flags once per iteration
for all B sequences. On a CUDA device the loop's chains are replayed from
CUDA graphs once a batch's shapes come again.

The solver allocates its blocks like the window's tensors
(``new_zeros``) and writes them through adjacent index tensors, so its
indexed writes batch in place under vmap, with no per-sequence fallback.
"""

import torch
import torch.utils._pytree as pytree

from ..data.types import IntegrationParams
from ..solver import graphs, lm
from ..solver.window import Prior, SolverConfig, Window
from . import assemble

# the batch's chains captured, replayed and run, apart from the single window's
_GRAPHS = graphs.Graphs()


def graph_counts() -> dict:
    """This process's batched chains captured, replayed from a graph and
    run eagerly (an LM iteration is one chain)."""
    return _GRAPHS.graph_counts()


def reset_graphs():
    """Forget every key and captured graph, and zero ``graph_counts``."""
    _GRAPHS.reset()


def optimize_batch(windows: Window, priors: Prior, cfg: SolverConfig,
                   params: IntegrationParams, iters: int = 20):
    """The two-phase round (``solver.lm.optimize``) over a batch of
    windows: phase 1 with both robust kernels, the chi2 gates, phase 2
    without the GNSS kernel, each sequence on its own. ``cfg`` and
    ``params`` are shared. Returns (windows, (cost0, cost1, n_culled,
    iters_run, accepted)), each a [B] tensor, as the JAX function does."""
    run = lm.runner(windows, priors, cfg, params, cache=_GRAPHS)
    s1, s2 = lm.two_phases(run, iters, batched=True)
    windows, n_culled = run.take("window", "n_culled")
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
