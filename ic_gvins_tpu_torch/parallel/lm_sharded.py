"""Landmark-sharded two-phase LM (``parallel/lm_sharded.py``): the
engine's optimization round with the landmarks cut into shards.

The whole algorithm of ``solver/lm.py`` runs (accept / reject damping,
Ceres-parity early exit, the chi2 gates between the phases) with the
landmark axis cut into ``mesh.shape["lm"]`` contiguous shards: each
shard's reprojection factors are evaluated and reduced on their own, the
shards' sums of the state system, the reduced camera system and the
vision cost are summed over the shard axis (the JAX ``psum``), the step's
largest entry is a max over the shards (``pmax``), and every decision is
made once. On one card the shards are slices of one tensor axis.

Numerically this is ``lm.optimize`` with another order of the landmark
sums, the only difference the JAX package allows between its sharded and
single-device rounds.
"""

from ..data.types import IntegrationParams
from ..solver.lm import optimize_impl
from ..solver.window import Prior, SolverConfig, Window

AXIS = "lm"
# the Window fields indexed by landmark, the ones a shard holds a slice of
LANDMARK_FIELDS = ("lm_invdepth", "lm_ref", "lm_valid", "obs_uv", "obs_vel", "obs_valid")


def window_pspec(window: Window | None = None, axis: str = AXIS) -> dict:
    """Field by field, the mesh axis a Window field is cut along (the
    landmark-indexed ones) or None (replicated): the JAX PartitionSpec
    tree."""
    return {f: (axis if f in LANDMARK_FIELDS else None) for f in Window._fields}


def check_mesh(window: Window, mesh, axis: str = AXIS) -> int:
    """The shard count of ``axis``; raises when the landmark capacity does
    not divide it or the window is not on the mesh's device."""
    shards = mesh.shape[axis]
    if window.n_landmarks % shards != 0:
        raise ValueError(
            f"landmark capacity {window.n_landmarks} must divide the mesh "
            f"size {shards}"
        )
    if window.nodes.p.device != mesh.device:
        raise ValueError(f"the window is on {window.nodes.p.device}, the mesh on {mesh.device}")
    return shards


def optimize_sharded(window: Window, prior: Prior, cfg: SolverConfig,
                     params: IntegrationParams, mesh, iters: int = 20,
                     do_cull: bool = True):
    """Two-phase round with the landmarks sharded over the mesh axis "lm".
    The landmark capacity must divide the mesh size. Returns the same
    ``(window, (stats1, stats2, n_culled))`` as ``lm.optimize``."""
    shards = check_mesh(window, mesh)
    return optimize_impl(window, prior, cfg, params, iters, do_cull, shards=shards)
