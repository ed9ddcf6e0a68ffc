#!/usr/bin/env python
"""Replay a simulated GNSS / IMU (/ camera) drive through the port's
``Estimator``: sensor streams -> engine -> reference-format outputs and the
ATE against the simulator's truth, in one command:

    python -m ic_gvins_tpu_torch.tools.run_sim --duration 30 --vision --out runs/demo
    python -m ic_gvins_tpu_torch.tools.run_sim --duration 8 --device cpu   # on the CPU

The offline counterpart of the reference's ROS node and rosbag replay
(``fusion_ros.cc``), with its GNSS-outage fault injection
(``--gnss-outage-time``, ``fusion_ros.cc:199-211``). The flags and the
printed JSON line are those of the JAX package's ``tools/run_sim.py``,
except that ``--device`` (default the first CUDA card) replaces
``--platform``. ``--f32`` runs the engine in float32 with window
re-centering on (the line adds ``n_recenters`` and the engine's
``dtype``); the simulator stays float64, where the JAX package's x64
switch makes its synthesis float32 too. The streams are drawn from
``torch.Generator``s seeded from ``--seed`` (``tools/sequence.py``), so
they are not the JAX package's draws.
"""

import argparse
import json
import os
import time

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--vision", action="store_true")
    ap.add_argument("--gnss-std", type=float, default=0.05)
    ap.add_argument("--gnss-outage-time", type=float, default=None)
    ap.add_argument("--imu-rate", type=float, default=200.0)
    ap.add_argument("--frame-rate", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/sim")
    ap.add_argument("--landmarks", type=int, default=96)
    ap.add_argument("--odo", action="store_true",
                    help="fuse a simulated wheel odometer (ODO/EARTH_ODO preintegration "
                         "with online scale estimation)")
    ap.add_argument("--sodo-true", type=float, default=0.03,
                    help="true odometer scale error injected by the simulator")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--f32", action="store_true",
                    help="run the engine in float32 with window re-centering on "
                         "(the JAX package's TPU numeric mode)")
    ap.add_argument("--config", default=None,
                    help="reference-format gvins.yaml: engine keys are loaded via "
                         "EngineConfig.from_yaml; the runner keys isusegnssoutage / "
                         "gnssoutagetime / outputpath are honoured here "
                         "(fusion_ros.cc:71-102)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    import torch

    from ..data.types import NavState
    from ..engine.config import EngineConfig, OdoConfig
    from ..engine.outputs import RunWriter
    from .sequence import ate, run_sequence, small_cfg

    if args.config is not None:
        import yaml

        cfg = EngineConfig.from_yaml(args.config)
        # runner keys (fusion_ros.cc:84-97, 199-211)
        with open(args.config) as f:
            ycfg = yaml.safe_load(f)
        if ycfg.get("isusegnssoutage") and args.gnss_outage_time is None:
            args.gnss_outage_time = float(ycfg["gnssoutagetime"])
        if args.out == ap.get_default("out") and ycfg.get("outputpath"):
            args.out = ycfg["outputpath"]
            if ycfg.get("is_make_outputdir", False):
                args.out = os.path.join(args.out, time.strftime("%Y%m%d%H%M%S"))
        # the window this runner's simulated scene is sized for
        cfg.max_nodes = 16
        cfg.max_landmarks = 64
    elif args.odo:
        cfg = small_cfg(antlever=(0.0, 0.0, 0.0),
                        odo=OdoConfig(use_odo=True, odo_vrw=0.03, sodo_prior_std=0.05))
    else:
        cfg = small_cfg()
    t0 = time.perf_counter()
    est, traj, params = run_sequence(
        cfg, duration=args.duration, with_vision=args.vision, gnss_std=args.gnss_std,
        seed=args.seed, imu_rate=args.imu_rate, frame_rate=args.frame_rate,
        n_landmarks=args.landmarks, gnss_until=args.gnss_outage_time,
        odo_sodo_true=args.sodo_true if args.odo else None, device=args.device,
        dtype=torch.float32 if args.f32 else torch.float64)
    wall = time.perf_counter() - t0

    writer = RunWriter(args.out)
    times, ps, qs = est.trajectory()
    zero3 = np.zeros(3)
    bg0, ba0 = est.window.nodes.bg[0], est.window.nodes.ba[0]
    for t, p, q in zip(times, ps, qs):
        writer.write_nav(NavState(time=t, p=p, q=q, v=zero3, bg=bg0, ba=ba0), decimate=1)
    for row in est.stats:
        writer.write_statistics(row)
    for row in est.track_log:
        writer.write_tracking(**row)
    if est.fixed_mappoints:
        writer.write_mappoints(est.fixed_mappoints)
    writer.write_extrinsic(times[-1] if len(times) else 0.0, est.window.ext_p,
                           est.window.ext_q, est.window.td)
    writer.close()

    rmse, mx = ate(est, traj, params, t_min=5.0)
    n_nodes = len(times)
    result = dict(
        ate_rmse_m=round(rmse, 4),
        ate_max_m=round(mx, 4),
        nodes_processed=n_nodes,
        wall_s=round(wall, 2),
        nodes_per_s=round(n_nodes / wall, 2),
        state=est.state,
        outdir=args.out,
    )
    if args.f32:
        result["n_recenters"] = est.n_recenters
        result["dtype"] = str(est.window.nodes.p.dtype).replace("torch.", "")
    if args.odo:
        result["sodo_est"] = round(float(est.window.sodo), 5)
        result["sodo_true"] = args.sodo_true
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
