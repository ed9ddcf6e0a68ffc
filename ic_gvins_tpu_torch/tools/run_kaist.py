#!/usr/bin/env python
"""Real-data replay with the PyTorch port: a KAIST-layout dataset (or a
rosbag) -> ``Pipeline`` -> trajectory, reference-format outputs and
ATE / RPE, in one command:

    # a KAIST urban38/39 directory (sensor_data/*.csv + image/), on the GPU
    python -m ic_gvins_tpu_torch.tools.run_kaist --data /data/urban38 \\
        --config config/gvins.yaml --ref /data/urban38/global_pose.csv

    # a reference-compatible rosbag (converted to the KAIST layout first)
    python -m ic_gvins_tpu_torch.tools.run_kaist --data urban38.bag \\
        --imu-topic /imu/data_raw --gnss-topic /gps/fix --image-topic /stereo/left/image_raw

The flags and the printed JSON line are those of the JAX package's
``tools/run_kaist.py``, except that ``--device`` (default the first CUDA
card; ``--device cpu`` for the CPU) replaces ``--platform``. ``--f32`` runs
the engine in float32 with window re-centering on; the line then adds
``n_recenters`` and the engine's ``dtype``. Frames are decoded
by the port's own PNG reader (``data/image.py``); ``--ref`` takes a KAIST
``global_pose.csv`` or a TUM file.
"""

import argparse
import json
import os
import time

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="KAIST-layout dir or a .bag file")
    ap.add_argument("--config", default=None, help="reference gvins.yaml")
    ap.add_argument("--out", default="runs/kaist")
    ap.add_argument("--ref", default=None,
                    help="ground truth: global_pose.csv (KAIST) or TUM file")
    ap.add_argument("--start", type=float, default=0.0,
                    help="skip this many seconds from the first IMU stamp")
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--no-vision", action="store_true", help="GNSS/INS only (ignore images)")
    ap.add_argument("--camera", default="stereo_left", help="image subdirectory name")
    ap.add_argument("--bayer", default="auto",
                    choices=("auto", "none", "rggb", "bggr", "grbg", "gbrg"),
                    help="Bayer pattern of the raw images (KAIST stereo_left is rggb); "
                         "auto = rggb for KAIST dirs")
    ap.add_argument("--gnss-outage-time", type=float, default=None,
                    help="drop GNSS after this time (fault injection, fusion_ros.cc:199-211)")
    ap.add_argument("--gps-default-std", type=float, default=None,
                    help="override GNSS std when the CSV has no cov columns")
    ap.add_argument("--gps-std-cols", default=None,
                    help="comma list of std column indices in vrs_gps.csv")
    ap.add_argument("--imu-topic", default="/imu/data_raw")
    ap.add_argument("--gnss-topic", default="/gps/fix")
    ap.add_argument("--image-topic", default=None)
    ap.add_argument("--f32", action="store_true",
                    help="run the engine in float32 with window re-centering on "
                         "(the JAX package's TPU numeric mode)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--max-nodes", type=int, default=24)
    ap.add_argument("--max-landmarks", type=int, default=192)
    ap.add_argument("--checkpoint-every", type=float, default=None,
                    help="save an engine checkpoint every N seconds")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ..common.logging import LOGI
    from ..data import kaist
    from ..data.image import load_gray
    from ..data.types import NavState
    from ..engine.config import EngineConfig
    from ..engine.outputs import RunWriter
    from ..engine.pipeline import Pipeline
    from ..eval import (
        Trajectory,
        absolute_trajectory_error,
        load_kaist_global_pose,
        load_tum,
        relative_pose_error,
    )

    data = args.data
    bayer = None if args.bayer in ("auto", "none") else args.bayer
    if data.endswith(".bag"):
        from ..data.rosbag import convert_bag

        conv = data[:-4] + "_kaist"
        if not os.path.isdir(conv):
            LOGI(f"converting {data} -> {conv}")
            convert_bag(data, conv, imu_topic=args.imu_topic, gnss_topic=args.gnss_topic,
                        image_topic=args.image_topic)
        data = conv
        gps_cols = kaist.GpsColumns(std=(4, 5, 6))
        camera = ""
    else:
        gps_cols = kaist.GpsColumns()
        camera = args.camera
        if args.bayer == "auto":
            bayer = "rggb"  # KAIST stereo_left publishes bayer_rggb8
    if args.gps_std_cols is not None:
        gps_cols.std = tuple(int(c) for c in args.gps_std_cols.split(","))
    if args.gps_default_std is not None:
        gps_cols.default_std = args.gps_default_std

    # --- config ---
    if args.config is not None:
        import yaml

        cfg = EngineConfig.from_yaml(args.config)
        with open(args.config) as f:
            ycfg = yaml.safe_load(f)
        if ycfg.get("isusegnssoutage") and args.gnss_outage_time is None:
            args.gnss_outage_time = float(ycfg["gnssoutagetime"])
        if args.out == build_parser().get_default("out") and ycfg.get("outputpath"):
            args.out = ycfg["outputpath"]
            if ycfg.get("is_make_outputdir", False):
                args.out = os.path.join(args.out, time.strftime("%Y%m%d%H%M%S"))
    else:
        cfg = EngineConfig()
    cfg.max_nodes = args.max_nodes
    cfg.max_landmarks = args.max_landmarks

    # --- data ---
    imu, gnss, origin = kaist.load_sequence(data, gps_cols=gps_cols)
    imu_t, imu_dt, imu_dth, imu_dv = imu
    g_t, g_p, g_std = gnss

    frame_times = np.zeros(0)
    frame_files: list[str] = []
    if not args.no_vision:
        try:
            frame_times, frame_files = _image_index(data, camera)
        except FileNotFoundError:
            LOGI("no images found; running GNSS/INS only")

    # stamps relative to the sequence start (the engine carries time in its
    # dtype: float32 keeps ~0.1 ms at 1000 s, not at the epoch's 1.7e9 s);
    # outputs add the base back
    t_rebase = imu_t[0]
    imu_t = imu_t - t_rebase
    g_t = g_t - t_rebase
    if len(frame_times):
        frame_times = frame_times - t_rebase

    t0 = imu_t[0] + args.start
    t_end = imu_t[-1] if args.duration is None else t0 + args.duration

    pipe = Pipeline(cfg, device=args.device, dtype=torch.float32 if args.f32 else torch.float64)
    pipe.set_origin_blh(origin)
    writer = RunWriter(args.out, origin_blh=origin)

    # --- replay in strict time order ---
    gi = int(np.searchsorted(g_t, t0))
    fi = int(np.searchsorted(frame_times, t0))
    n_frames = 0
    last_ckpt = t0
    wall0 = time.perf_counter()
    for k in range(int(np.searchsorted(imu_t, t0)), len(imu_t)):
        t = imu_t[k]
        if t > t_end:
            break
        if imu_dt[k] <= 0.0:
            continue
        pipe.add_imu(t, imu_dt[k], imu_dth[k], imu_dv[k])
        while gi < len(g_t) and g_t[gi] <= t:
            if args.gnss_outage_time is None or g_t[gi] - imu_t[0] <= args.gnss_outage_time:
                pipe.add_gnss(g_t[gi], g_p[gi], g_std[gi])
            gi += 1
        while fi < len(frame_times) and frame_times[fi] <= t:
            pipe.add_image(frame_times[fi], load_gray(frame_files[fi], bayer=bayer))
            n_frames += 1
            fi += 1
        if args.checkpoint_every and t - last_ckpt >= args.checkpoint_every:
            pipe.est.save_checkpoint(os.path.join(args.out, "checkpoint.pkl"))
            last_ckpt = t
    wall = time.perf_counter() - wall0

    est = pipe.est
    times, ps, qs = est.trajectory()
    zero3 = np.zeros(3)
    bg0, ba0 = est.window.nodes.bg[0], est.window.nodes.ba[0]
    for t, p, q in zip(times, ps, qs):
        writer.write_nav(NavState(time=t + t_rebase, p=p, q=q, v=zero3, bg=bg0, ba=ba0),
                         decimate=1)
    for row in est.stats:
        writer.write_statistics(row)
    for row in est.track_log:
        writer.write_tracking(**row)
    if est.fixed_mappoints:
        writer.write_mappoints(est.fixed_mappoints)
    if len(times):
        writer.write_extrinsic(times[-1], est.window.ext_p, est.window.ext_q, est.window.td)
    writer.close()

    result = dict(
        nodes=len(times),
        frames=n_frames,
        keyframes=len(est.track_log),
        state=est.state,
        imu_repaired=est.imu_repaired,
        dropped_gnss=est.dropped_gnss,
        wall_s=round(wall, 2),
        replay_rate=round((t_end - t0) / max(wall, 1e-9), 2),
        outdir=args.out,
    )
    if args.f32:
        result["n_recenters"] = est.n_recenters
        result["dtype"] = str(est.window.nodes.p.dtype).replace("torch.", "")

    if args.ref is not None:
        ref = (load_kaist_global_pose(args.ref)
               if args.ref.endswith(".csv") and "global_pose" in args.ref
               else load_tum(args.ref))
        est_traj = Trajectory(t=np.asarray(times) + t_rebase,
                              p=np.stack(ps) if len(ps) else np.zeros((0, 3)))
        # KAIST global_pose is in another global frame -> align; TUM truths
        # written in the local GNSS frame share the engine's frame
        align = "global_pose" in args.ref
        # the first 5 s of the trajectory are left out (the JAX runner
        # compares this bound, rebased, with absolute stamps and keeps all)
        ate = absolute_trajectory_error(est_traj, ref, max_diff=0.05, align=align,
                                        t_min=est_traj.t[0] + 5.0 if len(times) else None)
        rpe = relative_pose_error(est_traj, ref, delta_t=1.0, max_diff=0.05)
        result["ate_rmse_m"] = round(ate["rmse"], 4)
        result["ate_max_m"] = round(ate.get("max", float("nan")), 4)
        result["rpe_rmse_m"] = round(rpe["rmse"], 4)
        result["eval_pairs"] = ate.get("n", 0)

    print(json.dumps(result))
    return result


def _image_index(root: str, camera: str):
    """(stamps [s], file paths) of the sequence's image stream."""
    for sub in ([os.path.join("image", camera)] if camera else []) + ["image"]:
        img_dir = os.path.join(root, sub)
        if os.path.isdir(img_dir):
            names = [n for n in sorted(os.listdir(img_dir))
                     if n.lower().endswith((".png", ".npy"))]
            if not names:
                continue
            stamps = np.array([float(os.path.splitext(n)[0]) * 1e-9 for n in names])
            return stamps, [os.path.join(img_dir, n) for n in names]
    raise FileNotFoundError(f"no images under {root}")


if __name__ == "__main__":
    main()
