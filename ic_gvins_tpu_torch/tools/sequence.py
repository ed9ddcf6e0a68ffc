"""Simulated sensor sequences through the port's ``Estimator``: the port's
copy of ``tests/test_estimator.py``'s ``small_cfg``, ``run_sequence`` and
``ate``, which the JAX package's ``tools/run_sim.py`` imports from its
tests (the port imports nothing of ``tests/``).

The streams are drawn from one CPU ``torch.Generator`` per stream,
seeded from ``seed`` (``stream_generator``); ``draws`` passes arrays drawn
elsewhere instead, stream by stream (the JAX package's ``jax.random``
draws give its streams).
"""

import numpy as np
import torch

from ..common import rotation as rot
from ..data import simulator as sim
from ..engine.config import EngineConfig
from ..engine.estimator import Estimator

# the streams of a sequence, each drawn from its own generator
STREAMS = ("imu", "gnss", "landmarks", "pixels", "odometer")
BG = (2e-4, -1e-4, 3e-4)  # true gyro bias, rad/s
BA = (5e-3, -8e-3, 2e-3)  # true accel bias, m/s^2
# the camera of run_sequence: z forward, x right, y down; set on the window
CAM_R = ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
CAM_P = (0.1, 0.0, -0.05)
PIXEL_STD = 0.5 / 780.0  # normalized-plane noise of the ideal tracks
ODO_RATE = 50.0  # Hz
ODO_NOISE = 0.02  # m/s


def small_cfg(**kw) -> EngineConfig:
    """The window geometry the JAX tests share (16 nodes x 64 landmarks, 10
    LM iterations, a 6-keyframe window, a lever arm)."""
    kw.setdefault("optimize_num_iterations", 10)
    kw.setdefault("max_nodes", 16)
    kw.setdefault("max_landmarks", 64)
    kw.setdefault("optimize_windows_size", 6)
    kw.setdefault("antlever", (0.1, -0.05, 0.2))
    return EngineConfig(**kw)


def stream_generator(seed: int, stream: str) -> torch.Generator:
    """The CPU generator of one stream of a sequence."""
    return torch.Generator().manual_seed(seed * len(STREAMS) + STREAMS.index(stream))


def make_streams(cfg, duration=15.0, with_vision=False, gnss_std=0.05, seed=0,
                 imu_rate=200.0, frame_rate=10.0, gnss_rate=1.0, n_landmarks=96,
                 odo_sodo_true=None, device=None, draws=None) -> dict:
    """The sensor streams of a simulated car drive, on ``device``: ``traj``,
    ``params``, ``imu`` (corrupted ``ImuSeq``), ``gnss``, ``frames`` (a list
    of (t, landmark ids, normalized uv) of the ideal tracks), ``cam``
    ((ext_p, ext_q) or None) and ``odo`` ((t, v) numpy or None).
    ``draws`` maps a stream of ``STREAMS`` to its draws: ``imu`` (gyro,
    accel) standard normals, ``gnss`` and ``pixels`` standard normals,
    ``landmarks`` (times, depths, offsets), ``odometer`` standard normals."""
    draws = draws or {}
    params = sim.default_params(with_earth=cfg.iswithearth, lat_deg=cfg.track_ref_lat_deg,
                                device=device)
    dev = params.gravity.device
    traj = sim.car_trajectory()
    gen = lambda s: None if s in draws else stream_generator(seed, s)  # noqa: E731
    t0 = 0.0
    imu = sim.simulate_imu(traj, params, t0, duration, imu_rate)
    imu = sim.corrupt_imu(imu, params, BG, BA, generator=gen("imu"), noise=draws.get("imu"))
    gnss = sim.simulate_gnss(traj, params, cfg.antlever, t0, duration, gnss_rate, std=gnss_std,
                             generator=gen("gnss"), noise=draws.get("gnss"))
    out = dict(traj=traj, params=params, imu=imu, gnss=gnss, frames=[], cam=None, odo=None)
    if with_vision:
        ext_q = rot.matrix_to_quat(torch.tensor(CAM_R, dtype=torch.float64, device=dev))
        ext_p = torch.tensor(CAM_P, dtype=torch.float64, device=dev)
        n_frames = int(duration * frame_rate)
        ftimes = sim.time_grid(t0, n_frames, frame_rate, first=1, device=dev)
        lms = sim.scatter_landmarks(traj, params, gen("landmarks"), n_landmarks, t0,
                                    t0 + duration + 3.0, draws=draws.get("landmarks"))
        uv, vis = sim.project_landmarks(traj, params, lms, ftimes, ext_p, ext_q,
                                        noise_std=PIXEL_STD, generator=gen("pixels"),
                                        noise=draws.get("pixels"))
        uv, vis, ft = uv.cpu().numpy(), vis.cpu().numpy(), ftimes.cpu().numpy()
        for j in range(n_frames):
            ids = np.nonzero(vis[:, j])[0]
            out["frames"].append((float(ft[j]), ids, uv[ids, j]))
        out["cam"] = (ext_p, ext_q)
    if odo_sodo_true is not None:
        odo_t, odo_v = sim.simulate_odometer(traj, params, t0, duration, ODO_RATE,
                                             sodo_true=odo_sodo_true, noise_std=ODO_NOISE,
                                             generator=gen("odometer"),
                                             noise=draws.get("odometer"))
        out["odo"] = (odo_t.cpu().numpy(), odo_v.cpu().numpy())
    return out


def run_sequence(cfg, duration=15.0, with_vision=False, gnss_std=0.05, seed=0,
                 imu_rate=200.0, frame_rate=10.0, gnss_rate=1.0, n_landmarks=96,
                 gnss_until=None, odo_sodo_true=None, imu_gap=None, gnss_outage=None,
                 mesh=None, device=None, draws=None, dtype=torch.float64):
    """Feed a simulated drive (``make_streams``) to a port ``Estimator`` in
    time order, as ``tests/test_estimator.py::run_sequence`` does: GNSS
    only until ``gnss_until`` and not in ``gnss_outage`` = [t0, t1); no
    IMU samples in ``imu_gap`` = (t0, t1], the next one spanning the gap
    (the ROS node computes increments as rate times the time since the last
    sample, ``fusion_ros.cc:145-150``). A ``mesh`` (``parallel.Mesh``)
    makes the rounds landmark-sharded (``Estimator.set_mesh``); ``dtype``
    is the engine's (the streams are float64 either way). Returns
    (estimator, trajectory, params)."""
    est = Estimator(cfg, device=device, dtype=dtype)
    if mesh is not None:
        est.set_mesh(mesh)
    s = make_streams(cfg, duration, with_vision, gnss_std, seed, imu_rate, frame_rate,
                     gnss_rate, n_landmarks, odo_sodo_true, est.device, draws)
    if s["cam"] is not None:
        est.window = est.window._replace(ext_p=s["cam"][0].to(dtype),
                                         ext_q=s["cam"][1].to(dtype))
    imu, gnss, frames = s["imu"], s["gnss"], s["frames"]
    odo_t, odo_v = s["odo"] if s["odo"] is not None else (None, None)
    imu_t, imu_dt = imu.time.cpu().numpy(), imu.dt.cpu().numpy()
    imu_dth, imu_dv = imu.dtheta.cpu().numpy(), imu.dvel.cpu().numpy()
    gt, gp, gs = (x.cpu().numpy() for x in gnss)

    gi = fi = oi = 0
    t_last_fed = None
    for k in range(len(imu_t)):
        t, dt = float(imu_t[k]), float(imu_dt[k])
        if dt == 0.0:
            continue
        if imu_gap is not None and imu_gap[0] < t <= imu_gap[1]:
            continue  # a dropout: these samples never arrive
        if odo_t is not None:
            while oi < len(odo_t) and odo_t[oi] <= t:
                est.add_odo(odo_t[oi], odo_v[oi])
                oi += 1
        dth, dv = imu_dth[k], imu_dv[k]
        if t_last_fed is not None and t - t_last_fed > 1.5 * dt:
            scale = (t - t_last_fed) / dt
            dth, dv, dt = dth * scale, dv * scale, t - t_last_fed
        est.add_imu(t, dt, dth, dv)
        t_last_fed = t
        while gi < len(gt) and gt[gi] <= t:
            ok = gnss_until is None or gt[gi] <= gnss_until
            if gnss_outage is not None and gnss_outage[0] <= gt[gi] < gnss_outage[1]:
                ok = False  # an outage window (fusion_ros.cc:199-211)
            if ok:
                est.add_gnss(float(gt[gi]), gp[gi], gs[gi])
            gi += 1
        while fi < len(frames) and frames[fi][0] <= t:
            est.add_frame_observations(*frames[fi])
            fi += 1
    return est, s["traj"], s["params"]


def ate(est, traj, params, t_min=2.0):
    """(RMS, max) position error of the estimator's trajectory after
    ``t_min`` against the simulator's truth."""
    times, ps, _ = est.trajectory()
    sel = times >= t_min
    if not sel.any():
        raise ValueError(f"no trajectory entry at or after t_min = {t_min} s")
    dev = params.gravity.device
    truth = sim.truth_state(traj, params, torch.as_tensor(times[sel], device=dev))
    errs = np.linalg.norm(ps[sel] - truth.p.cpu().numpy(), axis=1)
    return float(np.sqrt(np.mean(np.square(errs)))), float(np.max(errs))
