"""The full GVINS pipeline (``engine/pipeline.py``): raw images + IMU +
GNSS -> trajectory.

A deterministic host loop: IMU and GNSS go straight to the estimator;
each camera frame gets the INS-predicted camera pose
(``Estimator.predicted_state``), is tracked by the front end (on a card,
through the hand-written KLT kernel) and its normalized observations feed
the estimator's keyframe logic. An optional drawer (``engine/drawer.py``)
receives the tracked points, poses and fixed landmarks of every frame.
"""

import time as _time

import numpy as np
import torch

from ..common.logging import LOGW
from ..vision import camera as cam_mod
from .config import EngineConfig
from .estimator import INITIALIZING, Estimator, _host, _np_quat_mul, _np_quat_rotate
from .frontend import Frontend


class Pipeline:
    def __init__(self, cfg: EngineConfig, device=None, use_clahe: bool = True,
                 drawer=None, cell: int | None = None, dtype=torch.float64):
        """``dtype``: the engine's type (the estimator's and the front end's
        geometry); the images stay float32."""
        self.cfg = cfg
        self.est = Estimator(cfg, device=device, dtype=dtype)
        cam = cam_mod.Camera.create(cfg.cam.intrinsic, cfg.cam.distortion,
                                    cfg.cam.resolution, dtype=dtype, device=self.est.device)
        if cell is None:
            # a detection grid with comfortably more cells than the feature
            # budget (the reference: 200 px blocks on 1278 px imagery)
            w, h = cfg.cam.resolution
            cell = 64
            while cell > 16 and (w // cell) * (h // cell) < cfg.track_max_features:
                cell //= 2
        self.frontend = Frontend(cam, max_features=cfg.track_max_features, cell=cell,
                                 use_clahe=use_clahe,
                                 check_histogram=cfg.track_check_histogram)
        self.frame_ms: list[float] = []  # front-end wall ms per frame
        self.drawer = drawer
        self._n_fixed_pushed = 0

    def add_imu(self, t, dt, dtheta, dvel):
        self.est.add_imu(t, dt, dtheta, dvel)

    def set_origin_blh(self, blh):
        self.est.set_origin_blh(blh)

    def add_gnss(self, t, p_local, std):
        self.est.add_gnss(t, p_local, std)

    def add_image(self, t, img):
        """Track the frame and feed its observations to the estimator."""
        q_wc = p_wc = None
        state = self.est.predicted_state(t)
        if state is not None:
            # full predicted camera pose: full-reprojection seeds for mapped
            # landmarks (tracking.cc:367-378), rotation seeds for the rest
            sq = _host(state.q)
            q_wc = _np_quat_mul(sq, self.est._npw("ext_q"))
            p_wc = _host(state.p) + _np_quat_rotate(sq, self.est._npw("ext_p"))
        t0 = _time.perf_counter()
        ids, uv, vel = self.frontend.process(t, img, q_wc=q_wc, p_wc=p_wc,
                                             lm_lookup=self.est.landmark_positions)
        track_ms = (_time.perf_counter() - t0) * 1e3
        self.frame_ms.append(track_ms)
        n_log = len(self.est.track_log)
        if self.est.state != INITIALIZING and len(ids):
            # tracking lost: the re-initialized frame becomes a fresh
            # keyframe (ic_gvins.cc:566-568)
            force = True if self.frontend.track_lost else None
            if force:
                LOGW(f"tracking lost at t={t:.3f}; re-initialized front-end")
            self.est.add_frame_observations(t, ids, uv, vel, force_kf=force)
            if len(self.est.track_log) > n_log:  # this frame made a keyframe
                self.est.track_log[-1]["cost_ms"] = round(track_ms, 3)
        if self.drawer is not None:
            self._push_drawer(t, img)

    def _push_drawer(self, t, img):
        """Forward the frame's tracking, map and pose state to the drawer
        (the reference's updateTrackedMapPoints / updateTrackedRefPoints /
        updateFrame / addNewFixedMappoint calls)."""
        fe, est, d = self.frontend, self.est, self.drawer
        in_map = np.array([fid in est.lm_slot for fid in fe.last_tracked_ids], bool)
        types = np.array([est.lm_type[est.lm_slot[fid]]
                          for fid in fe.last_tracked_ids[in_map]], np.int32)
        d.update_tracked_mappoints(fe.last_prev_pts[in_map], fe.last_cur_pts[in_map], types)
        d.update_tracked_refpoints(fe.last_prev_pts[~in_map], fe.last_cur_pts[~in_map])
        d.update_frame(img)
        s = est.predicted_state(t) or est.last_node_state
        if s is not None:
            d.update_odometry(t, _host(s.p) + est.origin, _host(s.q))
        while self._n_fixed_pushed < len(est.fixed_mappoints):
            d.add_new_fixed_mappoint(est.fixed_mappoints[self._n_fixed_pushed])
            self._n_fixed_pushed += 1

    def trajectory(self):
        return self.est.trajectory()

