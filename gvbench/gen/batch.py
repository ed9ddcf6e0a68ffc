"""Pools of sliding windows for the batched solver, made from ``--seed``.

The window is ``tiny_problem`` of ic_gvins_tpu_torch/entry.py at commit
ab7fbd6 (truth nodes 0.4 s apart on the car drive, their intervals
preintegrated from the simulated IMU, GNSS fixes, landmarks seen by ideal
tracks, an initial prior on node 0); the members of a batch are
``perturb_round`` of chip_smoke.py at that commit. Changed from them: the
draws come from the benchmark's generators (not JAX's), a batch mixes
several drive segments (``make_pool``), the drive and
the landmark field from the traffic file (``route``, ``landmarks``), the solver
settings from the configuration, the optimum that half of the members
start near from the frozen reference solver, and the member's class and
size of perturbation from the traffic file. Nothing here imports the
program.
"""

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..reference.common import rotation as rot
from ..reference.data import simulator as sim
from ..reference.ins.preintegration import preintegrate
from ..reference.solver import lm
from ..reference.solver.window import SolverConfig, empty_window, make_init_prior
from .streams import generator, trajectory

D2R = np.pi / 180.0


def solver_config(eng: dict, dtype, device) -> SolverConfig:
    """The solver settings the estimator derives from the configuration
    (its extrinsic, time-delay and odometer estimation off, as outside
    normal tracking)."""
    t = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
    intr = eng["cam"]["intrinsic"]
    focal = 0.5 * (intr[0] + intr[1])
    no = torch.tensor(False, device=device)
    return SolverConfig(
        antlever=t(eng.get("antlever", (0.0, 0.0, 0.0))),
        reproj_std=t(eng["reprojection_error_std"] / focal),
        bias_prior_bg_std=t(eng["gyr_bias_prior_std"]),
        bias_prior_ba_std=t(eng["acc_bias_prior_std"]),
        estimate_extrinsic=no, estimate_td=no, estimate_sodo=no,
        sodo_prior_std=t(eng["odo"]["sodo_prior_std"]),
        chi2_compound=torch.tensor(bool(eng["chi2_compound"]), device=device))


def problem(eng: dict, traffic: dict, g: torch.Generator, device):
    """(window, prior, params) of one segment of the traffic's drive: the
    configuration's node and landmark slots, every node a keyframe."""
    N, L = int(eng["max_nodes"]), int(eng["max_landmarks"])
    kw = dict(dtype=torch.float64, device=device)
    params = sim.default_params(with_earth=True, device=device)
    prob, lm_field = traffic["problem"], traffic["landmarks"]
    traj = trajectory(traffic["route"], float(prob["t0"]) + float(prob["t0_spread"]), device)
    t0 = float(prob["t0"]) + float(prob["t0_spread"]) * float(torch.rand((), generator=g,
                                                                       dtype=torch.float64))
    dt = float(prob["node_dt"])
    times = torch.from_numpy(t0 + np.arange(N) * dt).to(device)
    truth = sim.truth_state(traj, params, times)
    imus = [sim.simulate_imu(traj, params, t0 + i * dt, dt, float(eng["imudatarate"]))
            for i in range(N - 1)]
    imu = pytree.tree_map(lambda *xs: torch.stack(xs), *imus)
    pre = preintegrate(params, pytree.tree_map(lambda x: x[:N - 1], truth), imu)
    gstd = float(prob["gnss_std"])
    gnss_p = truth.p + gstd * torch.randn((N, 3), generator=g, dtype=torch.float64).to(device)

    ext_q = torch.tensor(eng["cam"]["q_b_c"], **kw)
    ext_q = ext_q / torch.linalg.norm(ext_q)
    ext_p = torch.tensor(eng["cam"]["t_b_c"], **kw)
    t1 = t0 + N * dt
    draws = sim.landmark_draws(g, L, t0, t1, lateral=float(lm_field["lateral"]),
                               depth_range=tuple(lm_field["depth"]))
    lms = sim.scatter_landmarks(traj, params, None, L, t0, t1, draws=draws)
    uv, vis = sim.project_landmarks(traj, params, lms, truth.time, ext_p, ext_q)
    first = torch.argmax(vis.to(torch.uint8), 1)
    lm_valid = torch.sum(vis, 1) >= 2
    s = sim.truth_state(traj, params, truth.time[first])
    t_wc = s.p + rot.quat_rotate(s.q, ext_p)
    q_wc = rot.quat_mul(s.q, ext_q)
    pc = rot.quat_rotate(rot.quat_inv(q_wc), lms - t_wc)
    invd = 1.0 / torch.clamp(pc[:, 2], min=0.5)
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=device)  # noqa: E731
    win = empty_window(N, L, dtype=torch.float64, device=device)._replace(
        nodes=truth, node_valid=ones(N), node_is_kf=ones(N), preint=pre,
        preint_valid=ones(N - 1), gnss_p=gnss_p, gnss_std=torch.full((N, 3), gstd, **kw),
        gnss_std_base=torch.full((N, 3), gstd, **kw), gnss_valid=ones(N), ext_p=ext_p,
        ext_q=ext_q, lm_ref=first.to(torch.int32), lm_valid=lm_valid, lm_invdepth=invd,
        obs_uv=uv, obs_valid=vis)
    pose_std = torch.tensor([0.1] * 3 + [0.5 * D2R] * 2 + [1.5 * D2R], **kw)
    mix_std = torch.tensor([0.1] * 3 + [2 * D2R] * 3 + [0.2] * 3, **kw)
    return win, make_init_prior(win, pose_std, mix_std), params


def perturb(win, opt, b: int, pert: dict, rng: np.random.Generator):
    """Member ``b`` of a batch: with b % 4 < 2 the window with its own node
    and depth noise, larger for higher b % 8, and in every third of them two
    observations pushed ``outlier`` off their track (the chi2 gate culls
    them); otherwise the optimum ``opt`` moved by ``near[0]`` (b % 4 == 2)
    or ``near[1]`` (b % 4 == 3) metres times 1 + b // 4, so that members
    stop after different numbers of iterations."""
    dev = win.nodes.p.device
    n = win.nodes.p.shape[0]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    if b % 4 >= 2:
        scale = pert["near"][b % 4 - 2] * (1 + b // 4)
        nodes = opt.nodes._replace(p=opt.nodes.p + scale * t(rng.standard_normal((n, 3))))
        return win._replace(nodes=nodes, lm_invdepth=opt.lm_invdepth.clone())
    lo, hi = pert["node_noise"]
    scale = lo + (hi - lo) * (b % 8) / 7.0
    nodes = win.nodes._replace(p=win.nodes.p + scale * t(rng.standard_normal((n, 3))),
                               v=win.nodes.v + 0.5 * scale * t(rng.standard_normal((n, 3))))
    invd = win.lm_invdepth * (1.0 + pert["depth_noise"] * (b % 5)
                              * t(rng.standard_normal(win.lm_invdepth.shape)))
    out = win._replace(nodes=nodes, lm_invdepth=invd)
    if b % 3 == 0:
        ref = win.lm_ref.long().cpu().numpy()
        kf = (win.node_valid & win.node_is_kf).cpu().numpy()
        live = (win.obs_valid.cpu().numpy() & win.lm_valid.cpu().numpy()[:, None]
                & kf[ref][:, None] & kf[None, :] & (np.arange(n)[None, :] != ref[:, None]))
        ls, ks = np.nonzero(live)
        pick = rng.choice(len(ls), 2, replace=False)
        uv = win.obs_uv.clone()
        uv[torch.as_tensor(ls[pick], device=dev), torch.as_tensor(ks[pick], device=dev), 0] += \
            float(pert["outlier"])
        out = out._replace(obs_uv=uv)
    return out


def make_pool(config: dict, traffic: dict, seed: int, device):
    """``traffic["pool"]`` batches of ``traffic["batch"]`` windows each,
    float64, over ``traffic["segments"]`` drive segments: member b of batch
    k perturbs segment (b // 4 + k) % segments, so that every batch mixes
    the segments (as a fleet's batch mixes drives) and its solve, which
    runs until its slowest member stops, does about the same work for
    every seed. A list of (members, their priors), with the solver
    settings and the IMU parameters: (pool, cfg, params)."""
    eng = config["engine"]
    g = generator(seed, "batch")
    rng = np.random.default_rng(int(torch.randint(0, 2**62, (), generator=g)))
    cfg = solver_config(eng, torch.float64, device)
    iters = int(eng["optimize_num_iterations"])
    segments = []
    params = None
    for _ in range(int(traffic["segments"])):
        win, prior, params = problem(eng, traffic, g, device)
        opt, _ = lm.optimize(win, prior, cfg, params, iters=iters)
        segments.append((win, prior, opt))
    pool = []
    for k in range(int(traffic["pool"])):
        picks = [segments[(b // 4 + k) % len(segments)] for b in range(int(traffic["batch"]))]
        members = [perturb(win, opt, b, traffic["perturb"], rng)
                   for b, (win, _, opt) in enumerate(picks)]
        pool.append((members, [prior for _, prior, _ in picks]))
    return pool, cfg, params
