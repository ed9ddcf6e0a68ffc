"""The benchmark's inputs, made from ``--seed``: the sensor streams of a
drive (IMU, GNSS, camera frames) and pools of sliding windows.

Built on the frozen simulator (``reference/data/simulator.py``), the
stream recipe of ic_gvins_tpu_torch/tools/sequence.py (``make_streams``)
and tools/run_urban.py (``generate``: landmark bins along the route) at
commit ab7fbd6. Changed from them: every draw comes from generators seeded
by the benchmark's seed; frames are rendered here, in bulk on the device
(``render.py``); the drive and its scene are set by the traffic file.
Nothing here imports the program.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..reference.common import rotation as rot
from ..reference.data import simulator as sim
from . import render

STREAMS = ("imu", "gnss", "landmarks", "batch")


def generator(seed: int, stream: str) -> torch.Generator:
    """The CPU generator of one input stream of a run with ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), STREAMS.index(stream)])
    return torch.Generator().manual_seed(int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))


@dataclass
class Replay:
    """A drive's streams: IMU, GNSS (host float64 arrays) and frames
    (uint8 [N, h, w] on the device); and the truth they were made from
    (the trajectory, the IMU parameters and the camera's extrinsic)."""

    imu_t: np.ndarray
    imu_dt: np.ndarray
    imu_dth: np.ndarray
    imu_dv: np.ndarray
    gnss_t: np.ndarray
    gnss_p: np.ndarray
    gnss_std: np.ndarray
    frame_t: np.ndarray
    frames: torch.Tensor
    duration: float
    traj: sim.Trajectory
    params: sim.IntegrationParams
    t_bc: torch.Tensor
    q_bc: torch.Tensor


def trajectory(route: dict, duration: float, device):
    """The drive's analytic trajectory from the traffic's ``route``."""
    kind = route["type"]
    if kind == "car":
        return sim.car_trajectory(**{k: v for k, v in route.items() if k != "type"})
    if kind == "urban":
        r = sim.urban_route(seed=int(route["seed"]), duration=duration + 5.0, device=device)
        return sim.urban_trajectory(r)
    raise ValueError(f"unknown route type {kind!r}")


def make_replay(config: dict, traffic: dict, seed: int, device) -> Replay:
    """The streams of one replay cell: ``config`` (the configuration file)
    gives the sensors, ``traffic`` the drive, its scene and its outages."""
    eng, sens = config["engine"], config["sensors"]
    duration = float(traffic["duration_s"])
    params = sim.default_params(with_earth=eng.get("iswithearth", True), device=device)
    traj = trajectory(traffic["route"], duration, device)
    imu = sim.simulate_imu(traj, params, 0.0, duration, float(eng["imudatarate"]))
    bias = traffic["bias"]
    imu = sim.corrupt_imu(imu, params, bias["bg"], bias["ba"], generator=generator(seed, "imu"))
    gnss = sim.simulate_gnss(traj, params, eng.get("antlever", (0.0, 0.0, 0.0)), 0.0, duration,
                             float(sens["gnss_rate"]), std=float(sens["gnss_std"]),
                             generator=generator(seed, "gnss"))
    g_t = gnss.time.cpu().numpy()
    keep = np.ones(len(g_t), bool)
    for a, b in traffic.get("gnss_outages", []):
        keep &= ~((g_t >= a) & (g_t < b))

    # frame stamps and the camera poses there
    rate = float(sens["camera_rate"])
    frame_t = (np.arange(int(duration * rate) - 1) + 1) / rate
    st = sim.truth_state(traj, params, torch.as_tensor(frame_t, device=device))
    cam_cfg = eng["cam"]
    q_bc = torch.tensor(cam_cfg["q_b_c"], dtype=torch.float64, device=device)
    q_bc = q_bc / torch.linalg.norm(q_bc)
    t_bc = torch.tensor(cam_cfg["t_b_c"], dtype=torch.float64, device=device)
    t_wc = st.p + rot.quat_rotate(st.q, t_bc)
    q_wc = rot.quat_mul(st.q, q_bc)

    # landmarks in bins along the drive; a frame sees its bin and the two beside it
    lm = traffic["landmarks"]
    bin_s, per_bin = float(lm["bin_s"]), int(lm["per_bin"])
    n_bins = int(np.ceil(duration / bin_s)) + 2
    g_lm = generator(seed, "landmarks")
    draws = [sim.landmark_draws(g_lm, per_bin, b * bin_s, b * bin_s + bin_s + float(lm["lead_s"]),
                                lateral=float(lm["lateral"]), depth_range=tuple(lm["depth"]))
             for b in range(n_bins)]
    bins = sim.scatter_landmarks(traj, params, None, n_bins * per_bin, 0.0, 0.0,
                                 draws=[torch.cat(parts) for parts in zip(*draws)])
    bins = bins.reshape(n_bins, per_bin, 3)
    fbin = torch.as_tensor((frame_t // bin_s).astype(np.int64), device=device)
    sel = torch.stack([torch.clamp(fbin - 1, min=0), fbin, fbin + 1], 1)  # [N, 3]

    def landmarks_of(a, b):
        return bins[sel[a:b]].reshape(b - a, 3 * per_bin, 3)

    cam = render.camera(eng, device)
    frames = render.render_all(cam, tuple(cam_cfg["resolution"]), landmarks_of, t_wc, q_wc,
                               device)
    host = lambda x: x.cpu().numpy()  # noqa: E731
    return Replay(imu_t=host(imu.time), imu_dt=host(imu.dt), imu_dth=host(imu.dtheta),
                  imu_dv=host(imu.dvel), gnss_t=g_t[keep], gnss_p=host(gnss.p)[keep],
                  gnss_std=host(gnss.std)[keep], frame_t=frame_t, frames=frames,
                  duration=duration, traj=traj, params=params, t_bc=t_bc, q_bc=q_bc)
