"""Landmark-sharded two-phase LM (``parallel/lm_sharded.py``): the
engine's optimization round with the landmarks cut into shards.

The whole algorithm of ``solver/lm.py`` runs (accept / reject damping,
Ceres-parity early exit, the chi2 gates between the phases) with the
landmark axis cut into ``mesh.shape["lm"]`` contiguous shards, of which
each rank holds ``mesh.local("lm")``: each shard's reprojection factors
are evaluated and reduced on their own, the shards' sums of the state
system, the reduced camera system and the vision cost are summed over the
shards and the ranks (the JAX ``psum``), the step's largest entry is a max
over them (``pmax``), and every decision is made on values that every rank
received from one collective, so the ranks stay in step. The result is
the whole window on every rank, bit for bit the same: the landmark rows
gathered from their ranks, the replicated fields from rank 0.

Numerically this is ``lm.optimize`` with another order of the landmark
sums, the only difference the JAX package allows between its sharded and
single-device rounds.
"""

import torch.utils._pytree as pytree

from ..data.types import IntegrationParams
from ..solver.lm import optimize_impl
from ..solver.window import Prior, SolverConfig, Window
from . import assemble

AXIS = "lm"
# the Window fields indexed by landmark, the ones a shard holds a slice of
LANDMARK_FIELDS = ("lm_invdepth", "lm_ref", "lm_valid", "obs_uv", "obs_vel", "obs_valid")


def window_pspec(window: Window | None = None, axis: str = AXIS) -> dict:
    """Field by field, the mesh axis a Window field is cut along (the
    landmark-indexed ones) or None (replicated): the JAX PartitionSpec
    tree."""
    return {f: (axis if f in LANDMARK_FIELDS else None) for f in Window._fields}


def check_mesh(window: Window, mesh, axis: str = AXIS) -> int:
    """The global shard count of ``axis``; raises when the landmark
    capacity does not divide it or the window is not on this rank's
    device."""
    shards = mesh.shape[axis]
    if window.n_landmarks % shards != 0:
        raise ValueError(
            f"landmark capacity {window.n_landmarks} must divide the mesh "
            f"size {shards}"
        )
    if window.nodes.p.device != mesh.device:
        raise ValueError(f"the window is on {window.nodes.p.device}, rank {mesh.rank}'s "
                         f"mesh on {mesh.device}")
    return shards


def landmark_rows(n_landmarks: int, mesh) -> slice:
    """The rows of the landmark-indexed fields this rank holds: its
    shards' landmarks, a contiguous run."""
    per_rank = n_landmarks // mesh.world
    return slice(mesh.rank * per_rank, (mesh.rank + 1) * per_rank)


def shard_window(window: Window, mesh) -> Window:
    """This rank's part of a whole window: its slice of the
    ``LANDMARK_FIELDS``, the other fields as they are. With one rank the
    window itself."""
    check_mesh(window, mesh)
    if not mesh.distributed:
        return window
    rows = landmark_rows(window.n_landmarks, mesh)
    return window._replace(**{f: getattr(window, f)[rows] for f in LANDMARK_FIELDS})


def gather_window(local: Window, n_landmarks: int, mesh) -> Window:
    """The whole window from every rank's part (``shard_window``), with one
    collective: the landmark rows from the rank that holds them, every
    other field from rank 0. The same bits on every rank."""
    if not mesh.distributed:
        return local
    start = landmark_rows(n_landmarks, mesh).start
    fields = [pytree.tree_flatten(getattr(local, f)) for f in Window._fields]
    whole = iter(assemble([(x, start if f in LANDMARK_FIELDS else None, n_landmarks)
                           for f, (xs, _) in zip(Window._fields, fields) for x in xs], mesh))
    return Window(*(pytree.tree_unflatten([next(whole) for _ in xs], spec)
                    for xs, spec in fields))


def optimize_sharded(window: Window, prior: Prior, cfg: SolverConfig,
                     params: IntegrationParams, mesh, iters: int = 20,
                     do_cull: bool = True):
    """Two-phase round with the landmarks sharded over the mesh axis "lm".
    Every rank passes the same whole window and gets the whole result back.
    The landmark capacity must divide the mesh size. Returns the same
    ``(window, (stats1, stats2, n_culled))`` as ``lm.optimize``."""
    local = shard_window(window, mesh)
    out, stats = optimize_impl(local, prior, cfg, params, iters, do_cull, mesh=mesh)
    return gather_window(out, window.n_landmarks, mesh), stats
