"""Entry points of the port, the counterpart of the JAX package's
``__graft_entry__.py``: a single-card check of one dense LM step on the
flagship GVINS window, and a dry run of the engine's sharded paths.

``entry()`` returns ``(forward, example_args)``: ``forward`` is one
damped Gauss-Newton step over the dense normal equations (``assemble`` ->
``schur_solve`` -> ``apply_delta``) on ``tiny_problem()``'s window.

``dryrun_multichip(n_devices)`` runs JAX's three sharded parts at JAX's
shapes on a ``parallel.Mesh`` of ``n_devices`` shards: the landmark-sharded
two-phase round of a 24-node x 192-landmark window, the node-chunked BA,
and, for an even count, the batch of two windows over a ``dp`` x ``lm``
grid. It runs in one process, with the shards as tensor axes, or as one
rank of a ``torch.distributed`` group of ``n_devices`` ranks (or of a
world that divides the shard count).

    python -m ic_gvins_tpu_torch.entry [--device D]
    python -m ic_gvins_tpu_torch.entry --device cpu --nproc 2 --backend gloo

prints ``entry OK, cost = ...`` and ``dryrun_multichip OK``. In one
process the dry run has a shard for each card, as JAX's has a shard for
each device (one on the CPU); with ``--nproc N`` it spans N processes
(``parallel.spawn``), one shard each, on ``--device`` (``gloo``) or on
card ``cuda:R`` (``nccl``).
"""

import argparse
import sys

import numpy as np
import torch
import torch.utils._pytree as pytree

from .common import prng
from .common import rotation as rot
from .data import simulator as sim
from .device import resolve_device
from .ins.preintegration import preintegrate
from .parallel import Mesh, assemble as assemble_parts
from .solver.assembly import RobustFlags, assemble, schur_solve
from .solver.window import SolverConfig, apply_delta, empty_window, make_init_prior

# the window's node times t0 + i * node_dt, IMU at 200 Hz (``_tiny_problem``)
T0, NODE_DT, IMU_RATE = 5.0, 0.4, 200.0
D2R = np.pi / 180.0


def tiny_problem(n_nodes: int = 6, n_landmarks: int = 16, dtype=torch.float64, seed: int = 0,
                 device=None):
    """(window, prior, cfg, params) of the JAX package's ``_tiny_problem``:
    ``n_nodes`` truth nodes 0.4 s apart on the car trajectory, their
    intervals preintegrated from the simulated IMU, GNSS fixes with 5 cm
    noise, ``n_landmarks`` landmarks seen by ideal tracks, an initial
    prior on node 0. The GNSS noise and the landmark draws are JAX's
    (``common/prng.py``), so the problem is the JAX package's. The
    simulation runs in float64; states, IMU and what follows in
    ``dtype``. On ``device`` (``cuda:0`` unless told)."""
    dev = resolve_device(device)
    N, L = n_nodes, n_landmarks
    kw = dict(dtype=dtype, device=dev)
    params64 = sim.default_params(with_earth=True, device=dev)
    params = sim.default_params(with_earth=True, dtype=dtype, device=dev)
    traj = sim.car_trajectory()
    node_times = torch.from_numpy(T0 + np.arange(N) * NODE_DT).to(dev)
    truth64 = sim.truth_state(traj, params64, node_times)
    truth = pytree.tree_map(lambda x: x.to(dtype), truth64)

    imus = [sim.simulate_imu(traj, params64, T0 + i * NODE_DT, NODE_DT, IMU_RATE)
            for i in range(N - 1)]
    imu = pytree.tree_map(lambda *xs: torch.stack(xs).to(dtype), *imus)
    pre = preintegrate(params, pytree.tree_map(lambda x: x[:N - 1], truth), imu)

    key = prng.prng_key(seed)
    noise = prng.normal(key, (N, 3), {torch.float64: np.float64, torch.float32: np.float32}[dtype])
    gnss_p = truth.p + 0.05 * torch.from_numpy(noise).to(dev)

    ext_q = rot.matrix_to_quat(torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                                            **kw))
    ext_p = torch.tensor([0.1, 0.0, -0.05], **kw)
    t1 = T0 + N * NODE_DT
    kt, kd, ko = prng.split(key, 3)
    draws = (prng.uniform(kt, (L,), minval=T0, maxval=t1),
             prng.uniform(kd, (L,), minval=8.0, maxval=60.0),
             prng.uniform(ko, (L, 2), minval=-30.0, maxval=30.0))
    lms = sim.scatter_landmarks(traj, params64, None, L, T0, t1, draws=draws)
    uv, vis = sim.project_landmarks(traj, params64, lms.to(dtype), truth.time, ext_p, ext_q)
    first = torch.argmax(vis.to(torch.uint8), 1)
    lm_valid = torch.sum(vis, 1) >= 2

    # the anchor's camera depth of each landmark, at least 0.5 m
    s = sim.truth_state(traj, params64, truth.time[first].to(torch.float64))
    t_wc = s.p + rot.quat_rotate(s.q, ext_p.to(torch.float64))
    q_wc = rot.quat_mul(s.q, ext_q.to(torch.float64))
    pc = rot.quat_rotate(rot.quat_inv(q_wc), lms - t_wc)
    invd = 1.0 / torch.clamp(pc[:, 2], min=0.5)

    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)  # noqa: E731
    win = empty_window(N, L, dtype=dtype, device=dev)._replace(
        nodes=truth, node_valid=ones(N), node_is_kf=ones(N), preint=pre,
        preint_valid=ones(N - 1), gnss_p=gnss_p, gnss_std=torch.full((N, 3), 0.05, **kw),
        gnss_std_base=torch.full((N, 3), 0.05, **kw), gnss_valid=ones(N), ext_p=ext_p,
        ext_q=ext_q, lm_ref=first.to(torch.int32), lm_valid=lm_valid,
        lm_invdepth=invd.to(dtype), obs_uv=uv.to(dtype), obs_valid=vis)

    pose_std = torch.tensor([0.1] * 3 + [0.5 * D2R] * 2 + [1.5 * D2R], **kw)
    mix_std = torch.tensor([0.1] * 3 + [2 * D2R] * 3 + [0.2] * 3, **kw)
    prior = make_init_prior(win, pose_std, mix_std)
    t = lambda x: torch.tensor(x, **kw)  # noqa: E731
    no = torch.tensor(False, device=dev)
    cfg = SolverConfig(antlever=torch.zeros(3, **kw), reproj_std=t(1.5 / 780.0),
                       bias_prior_bg_std=t(7200.0 * D2R / 3600.0), bias_prior_ba_std=t(0.2),
                       estimate_extrinsic=no, estimate_td=no, estimate_sodo=no,
                       sodo_prior_std=t(0.02))
    return win, prior, cfg, params


def forward(window, prior, cfg, params):
    """One damped Gauss-Newton step over the dense normal equations (both
    robust kernels, lambda 1e-4): (updated window, robust cost before the
    step)."""
    H, g, cost = assemble(window, prior, cfg, params, RobustFlags(gnss_kernel=True,
                                                                   reproj_kernel=True))
    dx = schur_solve(H, g, window.dim_x, 1e-4)
    return apply_delta(window, dx), cost


def entry(device=None):
    """(forward, example_args): one LM step of the flagship GVINS
    sliding-window problem, ``tiny_problem()`` on ``device`` (``cuda:0``
    unless told)."""
    return forward, tiny_problem(device=device)


def _check_finite(x, what):
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{what} produced a non-finite cost")


def _batch_part(n_devices: int, mesh: Mesh, dev):
    """Two 5 x 16 windows (seeds 0 and 1), 2 iterations of the batched
    round on the ``{"dp": 2, "lm": n / 2}`` grid: one process runs both;
    across ranks a rank runs its row's window (JAX's device (r // (W / 2),
    r % (W / 2)) of a W-rank world) and the first rank of each row gives
    it to the gather. Returns (nodes, stats) of both windows."""
    from .parallel import multi_seq

    wins, prs = [], []
    for s in range(2):
        w, p, cfg, params = tiny_problem(5, 16, seed=s, device=dev)
        wins.append(w)
        prs.append(p)
    bw, bp = multi_seq.stack_windows(wins), multi_seq.stack_priors(prs)
    W, r = mesh.world, mesh.rank
    if W == 1:
        grid = Mesh({"dp": 2, "lm": n_devices // 2}, device=dev)
        mine, mine_pr = multi_seq.shard_batch(bw, bp, grid)
        out, stats = multi_seq.optimize_batch(mine, mine_pr, cfg, params, iters=2)
        return out.nodes, stats
    if W % 2:
        raise ValueError(f"the dp x lm grid needs an even world, not {W} ranks")
    row, lead = r // (W // 2), r % (W // 2) == 0
    take = lambda x: x[row:row + 1]  # noqa: E731
    out, stats = multi_seq.optimize_batch(pytree.tree_map(take, bw), pytree.tree_map(take, bp),
                                          cfg, params, iters=2)
    leaves, spec = pytree.tree_flatten((out.nodes, stats))
    parts = [(x if lead else x[:0], row, 2) for x in leaves]
    return pytree.tree_unflatten(assemble_parts(parts, mesh), spec)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """JAX's multi-device dry run on ``n_devices`` shards: (1) the
    landmark-sharded two-phase round (``optimize_sharded``, 4 iterations,
    the chi2 cull) of ``tiny_problem(24, L)``, L = 192 padded to a multiple
    of the shards; (2) the node-chunked BA (``build_nodes_ba`` /
    ``ba_nodes_solve``) of ``tiny_problem(8 n, 32)``, chunks of 8 nodes,
    stencil 8, separator 2, 3 iterations; (3) for an even count, the batch
    of two 5 x 16 windows. Raises when a part's cost is not finite.
    Returns each part's results, whole on every rank: {"round": (window,
    stats), "ba": (problem, costs), "batch": (nodes, stats) or None}."""
    from .parallel.ba_nodes import ba_nodes_solve, build_nodes_ba
    from .parallel.lm_sharded import optimize_sharded

    n = int(n_devices)
    dev = resolve_device(device)
    mesh_lm = Mesh({"lm": n}, device=dev)
    n_lm = 192 + (-192) % n
    win, prior, cfg, params = tiny_problem(24, n_lm, device=dev)
    out, (s1, s2, n_culled) = optimize_sharded(win, prior, cfg, params, mesh_lm, iters=4,
                                               do_cull=True)
    _check_finite(s2.cost1, "the landmark-sharded LM")

    wl, _, _, params_l = tiny_problem(8 * n, 32, device=dev)
    mesh_nodes = Mesh({"nodes": n}, device=dev)
    ba, _ = build_nodes_ba(wl.nodes, wl.preint, wl.gnss_p, wl.gnss_std, wl.gnss_valid,
                           wl.lm_invdepth, wl.lm_ref, wl.obs_uv, wl.obs_valid, ext_p=wl.ext_p,
                           ext_q=wl.ext_q, reproj_std=1.5 / 780.0, n_chunks=n, stencil=8,
                           sep_width=2, device=dev)
    ba_out, costs = ba_nodes_solve(ba, params_l, mesh_nodes, iters=3, sep_width=2)
    _check_finite(costs[1], "the node-sharded BA")

    batch = _batch_part(n, mesh_lm, dev) if n >= 2 and n % 2 == 0 else None
    return {"round": (out, (s1, s2, n_culled)), "ba": (ba_out, costs), "batch": batch}


def _rank(rank, world, init, backend, devices):
    """One rank of ``--nproc``: join the group, run the dry run on
    ``world`` shards, leave."""
    from .parallel import init_distributed, shutdown_distributed

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(backend, init, world, rank)
    try:
        dryrun_multichip(world, dev)
    finally:
        shutdown_distributed()


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda:0 unless told, e.g. cpu")
    ap.add_argument("--nproc", type=int, default=1,
                    help="run the dry run across this many processes, one shard each")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="the process group's backend with --nproc (nccl: rank R on cuda:R)")
    return ap


def main(argv=None) -> int:
    from .parallel import spawn

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    fn, example = entry(dev)
    _, cost = fn(*example)
    print("entry OK, cost =", float(cost), flush=True)
    if args.nproc > 1:
        devices = ([f"cuda:{r}" for r in range(args.nproc)] if args.backend == "nccl"
                   else [str(dev)] * args.nproc)
        spawn(args.nproc, _rank, (args.backend, devices))
    else:
        dryrun_multichip(torch.cuda.device_count() if dev.type == "cuda" else 1, dev)
    print("dryrun_multichip OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
