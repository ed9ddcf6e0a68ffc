#!/usr/bin/env python
"""Urban-scale endurance replay with the PyTorch port: a KAIST
urban38-sized simulated drive (2154 s, ~12 km of 90-degree corners,
U-turns and traffic stops, ``data/simulator.py::urban_route``) with
rendered point-sprite frames and GNSS outage windows, through the port's
``Pipeline`` (on a card, the KLT kernel once per tracked frame):

    # generate the streams only (on the first CUDA card)
    python -m ic_gvins_tpu_torch.tools.run_urban --gen --out runs/urban
    # generate if missing, then replay 300 s with two outages
    python -m ic_gvins_tpu_torch.tools.run_urban --duration 300 --outages 120 150 200 230 \\
        --out runs/urban300
    # a short replay on the CPU
    python -m ic_gvins_tpu_torch.tools.run_urban --duration 20 --device cpu --out runs/u20

Two phases, as in the JAX package's ``tools/run_urban.py``:

* ``--gen`` computes the route, the IMU (100 Hz), GNSS (1 Hz, sigma
  0.2 m), the frame-rate truth poses and the landmark bins on the device
  and writes ``<out>/sensors.npz`` with the JAX file's keys, shapes and
  dtypes, so either package replays the other's file. It runs in this
  process (torch dtypes are explicit). The draws come from
  ``torch.Generator``s seeded from ``1000 + --seed``, not the JAX draws.
* the replay (default) feeds ``sensors.npz`` through
  ``Pipeline(cfg, use_clahe=False)`` at the JAX defaults (320 x 240
  frames, 120 features, a 20-node x 160-landmark window, 12 LM
  iterations, an 8-keyframe window); frames are rendered on the fly on
  the host. It writes a rolling ``result.json``, ``trajectory.npz`` and,
  every ``--checkpoint-every`` seconds of data, ``ckpt.npz`` (a pickle,
  the estimator's checkpoint), and prints a progress line every 30 s of
  data and the result at the end.

``--device`` (default the first CUDA card) replaces the JAX runner's
``--tpu`` and ``--no-pallas``. ``--f32`` replays with the engine in
float32 and window re-centering on (``result.json``'s ``mode`` "f32",
``n_recenters``, and the prior's spectrum); ``--gen`` stays float64, as in
the JAX runner.
"""

import argparse
import json
import os
import time

import numpy as np

RES = (320, 240)
INTR = (240.0, 240.0, 160.0, 120.0)
BG = (2e-4, -1e-4, 3e-4)  # true gyro bias, rad/s
BA = (5e-3, -8e-3, 2e-3)  # true accel bias, m/s^2


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=2154.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--imu-rate", type=float, default=100.0)
    ap.add_argument("--frame-rate", type=float, default=10.0)
    ap.add_argument("--gnss-std", type=float, default=0.2)
    ap.add_argument("--gnss-rate", type=float, default=1.0)
    ap.add_argument("--outages", type=float, nargs="*", default=[],
                    help="flat list of outage (start, end) pairs in seconds")
    ap.add_argument("--no-vision", action="store_true", help="GINS-only endurance (no camera)")
    ap.add_argument("--f32", action="store_true",
                    help="replay with the engine in float32 and window re-centering on "
                         "(the JAX package's TPU numeric mode); --gen stays float64")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--features", type=int, default=120)
    ap.add_argument("--max-landmarks", type=int, default=160)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--lm-per-bin", type=int, default=130)
    ap.add_argument("--bin-dt", type=float, default=10.0)
    ap.add_argument("--checkpoint-every", type=float, default=300.0)
    ap.add_argument("--out", default="runs/urban")
    ap.add_argument("--sensors", default=None,
                    help="sensors.npz path (default <out>/sensors.npz)")
    ap.add_argument("--gen", action="store_true", help="generation phase only")
    return ap


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(args) -> dict:
    """The streams of the drive, computed on ``args.device`` and written to
    ``args.sensors``: route, IMU, GNSS, frame-rate truth poses and landmark
    bins. Returns the file's size and the seconds of each part."""
    import torch

    from ..common import rotation as rot
    from ..data import simulator as sim
    from ..device import resolve_device
    from .sequence import CAM_R, stream_generator

    dev = resolve_device(args.device)
    t_start = time.perf_counter()
    route = sim.urban_route(seed=args.seed, duration=args.duration, device=dev)
    traj = sim.urban_trajectory(route)
    params = sim.default_params(with_earth=True, device=dev)
    print(f"route: {route.total_time:.0f} s, {route.total_dist:.0f} m, "
          f"{route.t0.shape[0]} segments", flush=True)
    gen = lambda s: stream_generator(1000 + args.seed, s)  # noqa: E731

    t0 = time.perf_counter()
    imu = sim.simulate_imu(traj, params, 0.0, args.duration, args.imu_rate)
    imu = sim.corrupt_imu(imu, params, BG, BA, generator=gen("imu"))
    _sync(dev)
    imu_s = time.perf_counter() - t0
    print(f"imu generated in {imu_s:.2f} s ({len(imu.time) - 1} samples)", flush=True)
    gnss = sim.simulate_gnss(traj, params, torch.zeros(3, dtype=torch.float64, device=dev), 0.0,
                             args.duration, args.gnss_rate, std=args.gnss_std,
                             generator=gen("gnss"))

    # frame stamps, the truth body states there and the camera attitudes
    ext_q = rot.matrix_to_quat(torch.tensor(CAM_R, dtype=torch.float64, device=dev))
    frame_dt = 1.0 / args.frame_rate
    frame_times = np.arange(2 * frame_dt, args.duration, frame_dt)
    st = sim.truth_state(traj, params, torch.as_tensor(frame_times, device=dev))
    q_wc = rot.quat_mul(st.q, ext_q)

    # landmark bins covering the whole run, placed in one batch
    n_bins = int(np.ceil(args.duration / args.bin_dt)) + 2
    g_lm = gen("landmarks")
    draws = [sim.landmark_draws(g_lm, args.lm_per_bin, b * args.bin_dt,
                                b * args.bin_dt + args.bin_dt + 5.0, lateral=26.0,
                                depth_range=(7.0, 45.0)) for b in range(n_bins)]
    bins = sim.scatter_landmarks(traj, params, None, n_bins * args.lm_per_bin, 0.0, 0.0,
                                 draws=[torch.cat(parts) for parts in zip(*draws)])
    bins = bins.reshape(n_bins, args.lm_per_bin, 3)
    _sync(dev)
    gen_s = time.perf_counter() - t_start

    np_ = lambda x: x.cpu().numpy()  # noqa: E731
    t0 = time.perf_counter()
    np.savez_compressed(
        args.sensors,
        imu_time=np_(imu.time), imu_dt=np_(imu.dt), imu_dtheta=np_(imu.dtheta),
        imu_dvel=np_(imu.dvel), gnss_time=np_(gnss.time), gnss_p=np_(gnss.p),
        gnss_std=np_(gnss.std), frame_times=frame_times, frame_p=np_(st.p), frame_q=np_(st.q),
        frame_qwc=np_(q_wc), lm_bins=np_(bins), bin_dt=args.bin_dt, ext_q=np_(ext_q),
        route_length=route.total_dist, route_time=route.total_time,
    )
    size = os.path.getsize(args.sensors)
    write_s = time.perf_counter() - t0
    print(f"sensors written: {args.sensors} ({size / 1e6:.1f} MB); generation "
          f"{gen_s:.2f} s on {dev}, writing {write_s:.2f} s", flush=True)
    return dict(bytes=size, imu_s=imu_s, generate_s=gen_s, write_s=write_s)


def urban_config(args, ext_q):
    """The replay's ``EngineConfig``: the JAX runner's window, features and
    camera (320 x 240 pinhole, body-to-camera attitude ``ext_q``)."""
    from ..engine.config import CameraConfig, EngineConfig

    return EngineConfig(
        optimize_num_iterations=args.iters,
        max_nodes=20,
        max_landmarks=args.max_landmarks,
        optimize_windows_size=8,
        track_max_features=args.features,
        track_min_parallax=12.0,
        imudatarate=args.imu_rate,
        antlever=(0.0, 0.0, 0.0),
        cam=CameraConfig(intrinsic=INTR, distortion=(0.0, 0.0, 0.0, 0.0), resolution=RES,
                         q_b_c=tuple(float(x) for x in ext_q), t_b_c=(0.0, 0.0, 0.0)),
    )


def truth_interp(frame_times, frame_p):
    """Dense truth for the ATE: linear interpolation of the frame-rate truth
    positions (error ~ a dt^2 / 8, ~1 mm at 10 Hz), host float64."""

    def truth_at(ts):
        ts = np.atleast_1d(np.asarray(ts, np.float64))
        return np.stack([np.interp(ts, frame_times, frame_p[:, i]) for i in range(3)], axis=-1)

    return truth_at


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def replay(args) -> dict:
    """Replay ``args.sensors`` through the port's ``Pipeline``; returns the
    final result (also written to ``<out>/result.json``)."""
    import torch

    from ..data import simulator as sim
    from ..engine.pipeline import Pipeline

    d = np.load(args.sensors)
    cfg = urban_config(args, d["ext_q"])
    pipe = Pipeline(cfg, device=args.device, use_clahe=False,
                    dtype=torch.float32 if args.f32 else torch.float64)
    est = pipe.est

    imu_t, imu_dt = d["imu_time"], d["imu_dt"]
    imu_dth, imu_dv = d["imu_dtheta"], d["imu_dvel"]
    g_t, g_p, g_s = d["gnss_time"], d["gnss_p"], d["gnss_std"]
    frame_times = d["frame_times"]
    frame_p, frame_qwc = d["frame_p"], d["frame_qwc"]
    lm_bins, bin_dt = d["lm_bins"], float(d["bin_dt"])
    truth_at = truth_interp(frame_times, frame_p)

    outages = [(args.outages[i], args.outages[i + 1]) for i in range(0, len(args.outages), 2)]
    in_outage = lambda t: any(a <= t < b for a, b in outages)  # noqa: E731

    def render(fi: int) -> np.ndarray:
        b = int(frame_times[fi] // bin_dt)
        lms = np.concatenate([lm_bins[max(b - 1, 0)], lm_bins[b], lm_bins[b + 1]])
        return sim.render_sprite_frame_np(INTR, RES, lms, frame_p[fi], frame_qwc[fi])

    def prior_eigs():
        hp = _host(est.prior.H)
        w = np.linalg.eigvalsh(np.nan_to_num(0.5 * (hp + hp.T)))
        return w[w > 1e-6]

    wall0 = time.time()
    next_ckpt = args.checkpoint_every
    gnss_count = dropped = 0
    frame_walls: list[float] = []
    progress: list[dict] = []
    prior_spectra: list[dict] = []
    gi, fi = 0, 0
    t_report = 30.0
    n_frames = len(frame_times) if not args.no_vision else 0

    # the metrics, written at every checkpoint (partial) so that a replay
    # cut short still leaves its result, and once at the end
    def finalize(partial: bool = False) -> dict:
        times, ps, _ = est.trajectory()
        mask = times >= 10.0
        errs = np.linalg.norm(ps[mask] - truth_at(times[mask]), axis=1)
        ts = times[mask]
        nz = prior_eigs()
        # errors in and just after an outage vs the rest
        in_out = np.array([any(a - 2 <= t <= b + 30 for a, b in outages) for t in ts], bool)
        result = dict(
            mode="f32" if est.window.nodes.p.dtype == torch.float32 else "f64",
            partial=bool(partial),
            sim_t_reached=float(ts[-1]) if ts.size else 0.0,
            duration_s=args.duration,
            route_length_m=float(d["route_length"]),
            ate_rmse_m=float(np.sqrt(np.mean(errs**2))) if errs.size else None,
            ate_max_m=float(errs.max()) if errs.size else None,
            ate_p99_m=float(np.percentile(errs, 99)) if errs.size else None,
            ate_rmse_clean_m=(float(np.sqrt(np.mean(errs[~in_out] ** 2)))
                              if (~in_out).any() else None),
            ate_max_outage_m=float(errs[in_out].max()) if in_out.any() else None,
            n_keyframes=est.n_keyframes,
            n_landmark_slots_used=len(est.lm_slot),
            n_recenters=est.n_recenters,
            n_gnss=gnss_count, n_gnss_dropped_outage=dropped,
            outages=outages, gnss_std=args.gnss_std,
            wall_s=time.time() - wall0, frames=len(frame_walls),
            frame_wall_mean_ms=float(np.mean(frame_walls)) * 1e3 if frame_walls else None,
            prior_eig_max=float(nz.max()) if nz.size else 0.0,
            prior_eig_min=float(nz.min()) if nz.size else 0.0,
            prior_rank=int(nz.size),
            prior_spectra=prior_spectra[::4],
            progress=progress,
            config=dict(features=args.features, iters=args.iters,
                        max_landmarks=args.max_landmarks, seed=args.seed,
                        imu_rate=args.imu_rate, frame_rate=args.frame_rate),
        )
        with open(os.path.join(args.out, "result.json"), "w") as f:
            json.dump(result, f, indent=1)
        np.savez(os.path.join(args.out, "trajectory.npz"), times=ts, errs=errs, est_p=ps,
                 est_t=times)
        if not partial:
            print(json.dumps({k: v for k, v in result.items()
                              if k not in ("progress", "prior_spectra")}, indent=1), flush=True)
        return result

    for k in range(len(imu_t)):
        if imu_dt[k] == 0.0:
            continue
        t = float(imu_t[k])
        pipe.add_imu(t, float(imu_dt[k]), imu_dth[k], imu_dv[k])
        while gi < len(g_t) and g_t[gi] <= t:
            if in_outage(float(g_t[gi])):
                dropped += 1
            else:
                pipe.add_gnss(float(g_t[gi]), g_p[gi], g_s[gi])
                gnss_count += 1
            gi += 1
        while fi < n_frames and frame_times[fi] <= t:
            fw0 = time.time()
            pipe.add_image(float(frame_times[fi]), render(fi))
            frame_walls.append(time.time() - fw0)
            fi += 1
        if t >= t_report:
            times, ps, _ = est.trajectory()
            err = float(np.linalg.norm(ps[-1] - truth_at(times[-1])[0])) if len(times) else None
            try:
                nzw = prior_eigs()
                prior_spectra.append(dict(t=round(t, 1),
                                          eig_max=float(nzw.max()) if nzw.size else 0.0,
                                          eig_min=float(nzw.min()) if nzw.size else 0.0,
                                          rank=int(nzw.size)))
            except np.linalg.LinAlgError:
                prior_spectra.append(dict(t=round(t, 1), eig_max=None, eig_min=None, rank=-1))
            rec = dict(sim_t=round(t, 1), wall_s=round(time.time() - wall0, 1),
                       err_m=round(err, 3) if err is not None else None,
                       kf=est.n_keyframes, recenters=est.n_recenters,
                       frames=len(frame_walls), lm_active=len(est.lm_slot),
                       fw_ms=(round(float(np.mean(frame_walls[-300:])) * 1e3, 1)
                              if frame_walls else None))
            progress.append(rec)
            print(json.dumps(rec), flush=True)
            t_report += 30.0
        if t >= next_ckpt:
            est.save_checkpoint(os.path.join(args.out, "ckpt.npz"))
            next_ckpt += args.checkpoint_every
            finalize(partial=True)

    return finalize(partial=False)


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.sensors is None:
        args.sensors = os.path.join(args.out, "sensors.npz")
    if args.gen:
        return generate(args)
    if not os.path.exists(args.sensors):
        print(f"generating sensors: {args.sensors}", flush=True)
        generate(args)
    return replay(args)


if __name__ == "__main__":
    main()
