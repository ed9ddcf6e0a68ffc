"""Visual front end: INS-aided KLT tracking and feature replenishment
over raw images (``engine/frontend.py``).

Per frame, ``track_frame`` equalizes the image (CLAHE), builds the
pyramid, predicts the LK seeds (rotation-only from the INS attitude, full
reprojection for mapped landmarks; float64), runs the bidirectional KLT
(float32; the Hopper kernel on a CUDA device), normalizes the tracked
points and culls them by FM-RANSAC on undistorted pixels;
``detect_frame`` replenishes features with grid Shi-Tomasi + subpixel
refinement. ``Frontend`` keeps the fixed-capacity feature table in numpy
on the host, as the JAX package does, and the previous pyramid on the
device between frames; ``check_histogram`` adds the illumination-glitch
gate, which skips a frame whose histogram differs from the last one's.
"""

import numpy as np
import torch

from ..common import rotation as rot
from ..common.prng import ransac_uniforms
from ..vision import camera as cam_mod
from ..vision import klt_cuda
from ..vision import ransac as ransac_mod
from ..vision.detector import corner_subpix, detect_features
from ..vision.preprocess import clahe, histogram_correlation
from ..vision.pyramid import build_pyramid


def prep_frame(img, levels: int, use_clahe: bool):
    """Preprocess + pyramid (first frame and the frame after a reset)."""
    return build_pyramid(clahe(img) if use_clahe else img, levels)


def track_frame(cam, prev_pyr, img, pts, valid, q_prev_wc, q_wc,
                has_rot: bool, p_wc, lm_pw, lm_ok, levels: int,
                use_clahe: bool, fm_ransac: bool, uv_prev, ransac_thr: float,
                ransac_u):
    """Preprocess -> pyramid -> LK seed prediction -> bidirectional KLT ->
    normalize -> FM-RANSAC epipolar culling. ``uv_prev`` [F,2] f64 holds
    the previous normalized observations and ``ransac_u`` [128, 8] f64 the
    uniforms of the RANSAC draws.
    Returns (pyr, pts1 [F,2] f32, ok [F], uv1 [F,2] f64)."""
    pyr = prep_frame(img, levels, use_clahe)

    # rotation-only seed
    q_rel = rot.quat_mul(rot.quat_inv(q_wc), q_prev_wc)
    pc1 = rot.quat_rotate(q_rel, cam_mod.pixel_to_cam(cam, pts.to(torch.float64)))
    z = pc1[:, 2:]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    pred = cam_mod.cam_to_pixel(cam, pc1 / z).to(torch.float32) if has_rot else pts

    # full-pose seed for mapped landmarks
    pcf = rot.quat_rotate(rot.quat_inv(q_wc)[None, :], lm_pw - p_wc[None, :])
    zf = pcf[:, 2]
    zf_safe = torch.where(torch.abs(zf) < 1e-6, torch.full_like(zf, 1e-6), zf)
    px_full = cam_mod.cam_to_pixel(cam, pcf / zf_safe[:, None])
    h, w = img.shape
    inb = (
        (zf > 0.1)
        & (px_full[:, 0] >= 0) & (px_full[:, 0] < w)
        & (px_full[:, 1] >= 0) & (px_full[:, 1] < h)
    )
    pred = torch.where((lm_ok & inb)[:, None], px_full.to(torch.float32), pred)

    pts1, ok, _ = klt_cuda.lk_track_bidirectional(prev_pyr, pyr, pts, pred, valid)
    uv1 = cam_mod.pixel_to_cam(cam, pts1.to(torch.float64))[:, :2]
    ok = ok & valid

    if fm_ransac:
        # epipolar culling on undistorted pixels; the RANSAC always runs
        # and its mask applies only with at least MIN_POINTS tracked points
        to_px = lambda nrm: torch.stack(  # noqa: E731
            [cam.fx * nrm[:, 0] + cam.cx, cam.fy * nrm[:, 1] + cam.cy], -1)
        inl, _ = ransac_mod.fundamental_ransac(
            to_px(uv_prev), to_px(uv1), ok, ransac_thr, ransac_u)
        ok = ok & (inl | (ok.sum() < ransac_mod.MIN_POINTS))
    return pyr, pts1, ok, uv1


def detect_frame(cam, img0, pts, valid, cell: int, max_new: int, subpix: bool):
    """Grid Shi-Tomasi + subpixel refinement + normalize.
    Returns (pts_new [max_new,2] f32, ok_new, uv_new [max_new,2] f64)."""
    pts_new, _, ok_new = detect_features(img0, pts, valid, cell=cell,
                                         max_new=max_new)
    if subpix:
        pts_new = corner_subpix(img0, pts_new, ok_new)
    uv_new = cam_mod.pixel_to_cam(cam, pts_new.to(torch.float64))[:, :2]
    return pts_new, ok_new, uv_new


class Frontend:
    def __init__(self, cam: cam_mod.Camera, max_features: int = 200,
                 pyramid_levels: int = 3, cell: int = 64,
                 use_clahe: bool = True, check_histogram: bool = False,
                 histogram_threshold: float = 0.7, fm_ransac: bool = True,
                 ransac_threshold: float = 1.5, subpix: bool = True):
        self.cam = cam
        self.device = cam.fx.device
        self.max_features = max_features
        self.levels = pyramid_levels
        self.cell = cell
        self.use_clahe = use_clahe
        self.check_histogram = check_histogram
        self.histogram_threshold = histogram_threshold
        self.fm_ransac = fm_ransac
        self.ransac_threshold = ransac_threshold
        self.subpix = subpix
        self.frame_count = 0
        self.min_track_features = max(8, max_features // 20)
        self.track_lost = False
        self.prev_raw = None  # last accepted raw frame (histogram gate)
        self.prev_pyr = None  # device tensors, kept between frames
        self.prev_time = None
        self.prev_q_wc = None
        F = max_features
        self.pts = np.zeros((F, 2), np.float32)  # distorted pixels
        self.uv_norm = np.zeros((F, 2), np.float64)  # undistorted normalized
        self.vel_norm = np.zeros((F, 2), np.float64)
        self.ids = np.full(F, -1, np.int64)
        self.valid = np.zeros(F, bool)
        self.next_id = 0
        # the last frame's tracked features, for a drawer
        self.last_prev_pts = np.zeros((0, 2), np.float32)
        self.last_cur_pts = np.zeros((0, 2), np.float32)
        self.last_tracked_ids = np.zeros(0, np.int64)

    def reset(self):
        """Drop all tracked features; the next frame re-initializes."""
        self.ids[:] = -1
        self.valid[:] = False
        self.vel_norm[:] = 0.0
        self.prev_pyr = None
        self.prev_q_wc = None

    def _dev(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def process(self, t: float, img, q_wc=None, p_wc=None, lm_lookup=None):
        """Track into the new frame and replenish. Returns (ids, uv_norm,
        vel_norm) of the currently tracked features (numpy); the previous
        observations unchanged when the histogram gate rejects the frame
        as an illumination glitch.

        ``q_wc``/``p_wc``: predicted camera pose at ``t``; ``lm_lookup``
        maps the feature-id array to ``(pw [n,3], ok [n])`` world positions
        of triangulated landmarks for the full-pose seed."""
        img = torch.as_tensor(img, device=self.device)
        if self.check_histogram and self.prev_raw is not None:
            corr = float(histogram_correlation(self.prev_raw, img))
            if corr < self.histogram_threshold:
                sel = self.valid
                return self.ids[sel], self.uv_norm[sel].copy(), self.vel_norm[sel].copy()
        self.prev_raw = img

        if self.prev_pyr is not None and self.valid.any():
            F = self.max_features
            lm_pw = np.zeros((F, 3), np.float64)
            lm_ok = np.zeros(F, bool)
            if lm_lookup is not None and p_wc is not None and q_wc is not None:
                lm_pw, lm_ok = lm_lookup(self.ids)
                lm_ok = np.asarray(lm_ok) & self.valid
            has_rot = self.prev_q_wc is not None and q_wc is not None
            qi = np.array([1.0, 0.0, 0.0, 0.0])
            f64 = torch.float64
            # the JAX package's draws for this frame counter, so both
            # packages (and a replay) cull the same tracks
            u = self._dev(ransac_uniforms(self.frame_count), f64)
            pyr, pts1_d, ok_d, uv1_d = track_frame(
                self.cam, self.prev_pyr, img,
                self._dev(self.pts), self._dev(self.valid),
                self._dev(self.prev_q_wc if has_rot else qi, f64),
                self._dev(q_wc if q_wc is not None else qi, f64),
                has_rot,
                self._dev(p_wc if p_wc is not None else np.zeros(3), f64),
                self._dev(lm_pw, f64), self._dev(lm_ok, torch.bool),
                self.levels, self.use_clahe, self.fm_ransac,
                self._dev(self.uv_norm, f64), self.ransac_threshold, u,
            )
            pts1, ok, uv_new = (x.cpu().numpy() for x in (pts1_d, ok_d, uv1_d))
            dt = max(t - self.prev_time, 1e-3)
            self.vel_norm = np.where(ok[:, None], (uv_new - self.uv_norm) / dt, 0.0)
            sel_draw = np.nonzero(ok)[0]
            self.last_prev_pts = self.pts[sel_draw].copy()
            self.last_cur_pts = pts1[sel_draw].astype(np.float32)
            self.last_tracked_ids = self.ids[sel_draw].copy()
            self.pts = np.where(ok[:, None], pts1, self.pts).astype(np.float32)
            self.uv_norm = np.where(ok[:, None], uv_new, self.uv_norm)
            self.valid = ok
        else:
            pyr = prep_frame(img, self.levels, self.use_clahe)

        # tracking lost: too few survivors -> reset, re-detect on this frame
        self.track_lost = (
            self.prev_pyr is not None
            and int(self.valid.sum()) < self.min_track_features
        )
        if self.track_lost:
            self.reset()

        n_missing = self.max_features - int(self.valid.sum())
        if n_missing > self.max_features // 4 or not self.valid.any():
            pts_new, ok_new, uv_new2 = (
                x.cpu().numpy() for x in detect_frame(
                    self.cam, pyr[0], self._dev(self.pts), self._dev(self.valid),
                    self.cell, self.max_features, self.subpix,
                )
            )
            free = np.nonzero(~self.valid)[0]
            cand = np.nonzero(ok_new)[0][: min(n_missing, len(free))]
            slots = free[: len(cand)]
            if len(cand):
                self.pts[slots] = pts_new[cand]
                self.uv_norm[slots] = uv_new2[cand]
                self.vel_norm[slots] = 0.0
                self.ids[slots] = self.next_id + np.arange(len(cand))
                self.next_id += len(cand)
                self.valid[slots] = True

        self.prev_pyr = pyr
        self.prev_time = t
        self.prev_q_wc = q_wc
        self.frame_count += 1
        sel = self.valid
        return self.ids[sel], self.uv_norm[sel].copy(), self.vel_norm[sel].copy()
