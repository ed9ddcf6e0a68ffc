# Frozen copy of prep_frame, track_frame and detect_frame of
# ic_gvins_tpu_torch/engine/frontend.py at commit ab7fbd6. Changed: the
# KLT is the plain tracker (vision/klt.py here) on every device, where the
# program launches its CUDA kernel; the imports point into this tree.
"""The front end's per-frame stages, plain PyTorch: the reference the
benchmark holds the program's tracks, RANSAC culls and detections to."""

import torch

from .common import rotation as rot
from .vision import camera as cam_mod
from .vision import klt
from .vision import ransac as ransac_mod
from .vision.detector import corner_subpix, detect_features
from .vision.preprocess import clahe
from .vision.pyramid import build_pyramid


def prep_frame(img, levels: int, use_clahe: bool):
    """Preprocess + pyramid (first frame and the frame after a reset)."""
    return build_pyramid(clahe(img) if use_clahe else img, levels)


def track_frame(cam, prev_pyr, img, pts, valid, q_prev_wc, q_wc,
                has_rot: bool, p_wc, lm_pw, lm_ok, levels: int,
                use_clahe: bool, fm_ransac: bool, uv_prev, ransac_thr: float,
                ransac_u):
    """Preprocess -> pyramid -> LK seed prediction -> bidirectional KLT ->
    normalize -> FM-RANSAC epipolar culling. Returns (pyr, pts1 [F,2] f32,
    ok [F], uv1 [F,2])."""
    pyr = prep_frame(img, levels, use_clahe)
    dtype = cam.fx.dtype

    # rotation-only seed
    q_rel = rot.quat_mul(rot.quat_inv(q_wc), q_prev_wc)
    pc1 = rot.quat_rotate(q_rel, cam_mod.pixel_to_cam(cam, pts.to(dtype)))
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

    pts1, ok, _ = klt.lk_track_bidirectional(prev_pyr, pyr, pts, pred, valid)
    uv1 = cam_mod.pixel_to_cam(cam, pts1.to(dtype))[:, :2]
    ok = ok & valid

    if fm_ransac:
        to_px = lambda nrm: torch.stack(  # noqa: E731
            [cam.fx * nrm[:, 0] + cam.cx, cam.fy * nrm[:, 1] + cam.cy], -1)
        inl, _ = ransac_mod.fundamental_ransac(
            to_px(uv_prev), to_px(uv1), ok, ransac_thr, ransac_u)
        ok = ok & (inl | (ok.sum() < ransac_mod.MIN_POINTS))
    return pyr, pts1, ok, uv1


def detect_frame(cam, img0, pts, valid, cell: int, max_new: int, subpix: bool):
    """Grid Shi-Tomasi + subpixel refinement + normalize.
    Returns (pts_new [max_new,2] f32, ok_new, uv_new [max_new,2])."""
    pts_new, _, ok_new = detect_features(img0, pts, valid, cell=cell,
                                         max_new=max_new)
    if subpix:
        pts_new = corner_subpix(img0, pts_new, ok_new)
    uv_new = cam_mod.pixel_to_cam(cam, pts_new.to(cam.fx.dtype))[:, :2]
    return pts_new, ok_new, uv_new
