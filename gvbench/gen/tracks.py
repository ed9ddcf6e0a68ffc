"""Feature tracks of a drive as a tracker outside the estimator hands them
over, one message a frame: feature ids, normalized-plane points and their
velocities (VINS-Mono's ``feature_tracker`` -> ``vins_estimator`` layout),
with the drive's IMU and GNSS streams; made from ``--seed``.

The drive, its sensors and its landmark bins are ``streams.make_replay``'s
(the same draws from the same seed); no frame is rendered. Instead every
landmark of the three bins a frame sees is projected through the frozen
simulator (``simulator.project_landmarks``) and the camera model
(``vision/camera.py``, distortion included), and the tracker is simulated:

* a live track continues while its landmark projects inside the image with
  ``margin_px`` to spare, at a depth in (``nearest_depth``,
  ``farthest_depth``); a landmark that leaves view and returns gets a new
  id;
* each frame tops the count up to ``max_tracks`` from the visible untracked
  landmarks, in an order drawn from the seed; continuing tracks are handed
  over first, in the order they were born;
* the handed point is the undistorted normalized-plane point plus Gaussian
  noise of ``noise_px`` per axis (over fx and fy), drawn anew each frame;
* ``outlier_share`` of the tracks, drawn at birth, jump by
  ``outlier_px`` (uniform) in a uniform direction at a frame drawn from
  their life after the first, and keep that offset to their end, as a KLT
  track that locked onto a neighbouring corner;
* ``vel`` is the difference of the handed points over the frame interval,
  0 at a track's first frame.

Nothing here imports the program.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..reference.data import simulator as sim
from ..reference.vision import camera as cam_mod
from . import streams


@dataclass
class Tracks:
    """A drive's streams with its tracks in place of frames. Frame ``f``'s
    tracks are rows ``start[f]:start[f + 1]`` of ``ids`` (int64), ``uv``
    and ``vel`` (float64 [T, 2], host); ``lm`` is each row's landmark (of
    ``landmarks``, world points), ``uv_true`` its noise-free point,
    ``outlier`` the tracks (by id) that jump. ``frames`` indexes the frames, for ``drivers.replay.Feed``."""

    imu_t: np.ndarray
    imu_dt: np.ndarray
    imu_dth: np.ndarray
    imu_dv: np.ndarray
    gnss_t: np.ndarray
    gnss_p: np.ndarray
    gnss_std: np.ndarray
    frame_t: np.ndarray
    start: np.ndarray
    ids: np.ndarray
    uv: np.ndarray
    vel: np.ndarray
    lm: np.ndarray
    uv_true: np.ndarray
    outlier: np.ndarray
    landmarks: np.ndarray
    duration: float
    traj: sim.Trajectory
    params: sim.IntegrationParams
    t_bc: torch.Tensor
    q_bc: torch.Tensor

    @property
    def frames(self) -> range:
        return range(len(self.frame_t))

    def frame(self, f: int):
        """(ids, uv, vel) of frame ``f``."""
        a, b = self.start[f], self.start[f + 1]
        return self.ids[a:b], self.uv[a:b], self.vel[a:b]

    def counts(self) -> np.ndarray:
        """Tracks per frame."""
        return np.diff(self.start)


def tracker_rng(seed: int) -> np.random.Generator:
    """The tracker's own draws (order, noise, outliers) of a run."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), 16]))


def make_tracks(config: dict, traffic: dict, seed: int, device) -> Tracks:
    """The streams of one tracks cell: ``config`` gives the sensors and the
    camera, ``traffic`` the drive, its scene and the tracker."""
    eng, sens, trk = config["engine"], config["sensors"], traffic["tracker"]
    duration = float(traffic["duration_s"])
    params = sim.default_params(with_earth=eng.get("iswithearth", True), device=device)
    traj = streams.trajectory(traffic["route"], duration, device)
    imu = sim.simulate_imu(traj, params, 0.0, duration, float(eng["imudatarate"]))
    bias = traffic["bias"]
    imu = sim.corrupt_imu(imu, params, bias["bg"], bias["ba"],
                          generator=streams.generator(seed, "imu"))
    gnss = sim.simulate_gnss(traj, params, eng.get("antlever", (0.0, 0.0, 0.0)), 0.0, duration,
                             float(sens["gnss_rate"]), std=float(sens["gnss_std"]),
                             generator=streams.generator(seed, "gnss"))
    g_t = gnss.time.cpu().numpy()
    keep = np.ones(len(g_t), bool)
    for a, b in traffic.get("gnss_outages", []):
        keep &= ~((g_t >= a) & (g_t < b))
    rate = float(sens["camera_rate"])
    frame_t = (np.arange(int(duration * rate) - 1) + 1) / rate

    # the landmark bins of streams.make_replay, from the same draws
    lmc = traffic["landmarks"]
    bin_s, per_bin = float(lmc["bin_s"]), int(lmc["per_bin"])
    n_bins = int(np.ceil(duration / bin_s)) + 2
    g_lm = streams.generator(seed, "landmarks")
    draws = [sim.landmark_draws(g_lm, per_bin, b * bin_s, b * bin_s + bin_s + float(lmc["lead_s"]),
                                lateral=float(lmc["lateral"]), depth_range=tuple(lmc["depth"]))
             for b in range(n_bins)]
    lms = sim.scatter_landmarks(traj, params, None, n_bins * per_bin, 0.0, 0.0,
                                draws=[torch.cat(parts) for parts in zip(*draws)])

    cam_cfg = eng["cam"]
    q_bc = torch.tensor(cam_cfg["q_b_c"], dtype=torch.float64, device=device)
    q_bc = q_bc / torch.linalg.norm(q_bc)
    t_bc = torch.tensor(cam_cfg["t_b_c"], dtype=torch.float64, device=device)
    cam = cam_mod.Camera.create(tuple(cam_cfg["intrinsic"]), tuple(cam_cfg["distortion"]),
                                tuple(cam_cfg["resolution"]), dtype=torch.float64, device=device)
    w, h = cam_cfg["resolution"]
    margin = float(trk["margin_px"])
    near, far = float(eng["nearest_depth"]), float(eng["farthest_depth"])

    # per bin of frames: the landmarks of its three bins, where each is seen
    fbin = (frame_t // bin_s).astype(np.int64)
    view = []  # (first frame, first landmark, uv [K, L, 2], visible [K, L])
    for b in np.unique(fbin):
        fs = np.nonzero(fbin == b)[0]
        lo, hi = max(int(b) - 1, 0) * per_bin, (int(b) + 2) * per_bin
        uv, vis = sim.project_landmarks(traj, params, lms[lo:hi], frame_t[fs], t_bc, q_bc,
                                        fov_tan=math.inf, min_depth=near, max_depth=far)
        px = cam_mod.cam_to_pixel(cam, torch.cat([uv, torch.ones_like(uv[..., :1])], -1))
        vis = (vis & (px[..., 0] >= margin) & (px[..., 0] <= w - 1 - margin)
               & (px[..., 1] >= margin) & (px[..., 1] <= h - 1 - margin))
        view.append((int(fs[0]), lo, uv.transpose(0, 1).cpu().numpy(),
                     vis.transpose(0, 1).cpu().numpy()))

    rng = tracker_rng(seed)
    rows = _simulate(view, len(frame_t), lms.shape[0], int(trk["max_tracks"]), rng)
    start, lm_of, ids, uv_true, prev, age = rows
    n_ids = int(ids.max()) + 1 if len(ids) else 0

    fx, fy = float(cam_cfg["intrinsic"][0]), float(cam_cfg["intrinsic"][1])
    scale = np.array([1.0 / fx, 1.0 / fy])
    uv = uv_true + rng.standard_normal(uv_true.shape) * float(trk["noise_px"]) * scale
    # outliers: drawn at birth, jumping at a frame of their life after the first
    outlier = rng.random(n_ids) < float(trk["outlier_share"])
    lo_px, hi_px = trk["outlier_px"]
    mag = lo_px + rng.random(n_ids) * (hi_px - lo_px)
    ang = rng.random(n_ids) * 2.0 * math.pi
    life = np.bincount(ids, minlength=n_ids)
    jump = 1 + np.floor(rng.random(n_ids) * np.maximum(life - 1, 0)).astype(np.int64)
    hit = outlier[ids] & (age >= jump[ids])
    off = np.stack([np.cos(ang), np.sin(ang)], -1) * mag[:, None] * scale
    uv[hit] += off[ids[hit]]
    vel = np.zeros_like(uv)
    cont = prev >= 0
    vel[cont] = (uv[cont] - uv[prev[cont]]) * rate

    host = lambda x: x.cpu().numpy()  # noqa: E731
    return Tracks(imu_t=host(imu.time), imu_dt=host(imu.dt), imu_dth=host(imu.dtheta),
                  imu_dv=host(imu.dvel), gnss_t=g_t[keep], gnss_p=host(gnss.p)[keep],
                  gnss_std=host(gnss.std)[keep], frame_t=frame_t, start=start, ids=ids, uv=uv,
                  vel=vel, lm=lm_of, uv_true=uv_true, outlier=outlier, landmarks=host(lms),
                  duration=duration, traj=traj, params=params, t_bc=t_bc, q_bc=q_bc)


def _simulate(view, n_frames, n_lm, max_tracks, rng):
    """The tracker over the frames: row offsets [F + 1], and each row's
    landmark, track id, true point, previous row of its track (-1 at its
    birth) and frames since that birth."""
    track = np.full(n_lm, -1, np.int64)  # landmark -> its live track's id
    last_row = np.zeros(n_lm, np.int64)
    age = np.zeros(n_lm, np.int64)
    live = np.zeros(0, np.int64)  # tracked landmarks, in birth order
    next_id = 0
    start = np.zeros(n_frames + 1, np.int64)
    out = {k: [] for k in ("lm", "id", "uv", "prev", "age")}
    n_rows = 0
    for f0, lo, uv, vis in view:
        for k in range(uv.shape[0]):
            seen = vis[k]
            # live tracks continue while their landmark stays in view
            local = live - lo
            ok = (local >= 0) & (local < seen.shape[0])
            ok[ok] = seen[local[ok]]
            track[live[~ok]] = -1
            live = live[ok]
            # top up from the visible untracked landmarks, in a drawn order
            free = np.nonzero(seen & (track[lo:lo + seen.shape[0]] < 0))[0]
            born = free[rng.permutation(len(free))[:max_tracks - len(live)]] + lo
            track[born] = next_id + np.arange(len(born))
            next_id += len(born)
            age[born] = 0
            prev = np.concatenate([last_row[live], np.full(len(born), -1, np.int64)])
            live = np.concatenate([live, born])
            out["lm"].append(live)
            out["id"].append(track[live])
            out["uv"].append(uv[k, live - lo])
            out["prev"].append(prev)
            out["age"].append(age[live].copy())
            age[live] += 1
            last_row[live] = n_rows + np.arange(len(live))
            n_rows += len(live)
            start[f0 + k + 1] = n_rows
    cat = {k: np.concatenate(v) for k, v in out.items()}
    return start, cat["lm"], cat["id"], cat["uv"], cat["prev"], cat["age"]
