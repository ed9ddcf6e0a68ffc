"""Fundamental-matrix RANSAC outlier culling, fixed-shape and batched
(``vision/ransac.py``).

All hypotheses are evaluated at once: H random 8-point subsets each give
an F candidate by the normalized 8-point algorithm (batched 9 x 9
``eigh``), every candidate is scored on every correspondence with the
Sampson distance, and the best-supported candidate is refit on its
inliers. Everything runs in float64 on the device of the points, with no
data-dependent trip counts and no host reads.

``fundamental_ransac`` maps given uniform numbers to the 8-point subsets
as the JAX package does (the front end passes JAX's own draws,
``common/prng.py``); ``fundamental_ransac_idx`` takes the sample indices.
"""

import math

import torch

N_HYPOTHESES = 128
MIN_POINTS = 15  # the caller applies the mask only with at least this many points


def _normalize(pts, valid):
    """Hartley normalization: masked mean 0, mean distance sqrt(2).
    Returns (pts_n, T) with pts_h_n = T @ pts_h."""
    w = valid.to(pts.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (pts * w[:, None]).sum(0) / n
    d = torch.sqrt(((pts - mean) ** 2).sum(-1)) * w
    s = math.sqrt(2.0) / torch.clamp(d.sum() / n, min=1e-9)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([s, zero, -s * mean[0], zero, s, -s * mean[1], zero, zero, one])
    return (pts - mean) * s, T.reshape(3, 3)


def _smallest_eigvec_rank2(A):
    """The rank-2 3 x 3 matrix nearest to the eigenvector of A^T A with the
    smallest eigenvalue. A: (..., M, 9) -> (..., 3, 3)."""
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    F = vecs[..., :, 0].reshape(A.shape[:-2] + (3, 3))
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return (u * s[..., None, :]) @ vt


def _eight_point(p0, p1, w=None):
    """F from 8 (or more, weighted) normalized correspondences, batched over
    leading axes. p0, p1: (..., M, 2); w: (..., M) row weights. Returns
    F (..., 3, 3) in the normalized frames (x1' F x0 = 0)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    one = torch.ones_like(x0)
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, one], -1)
    if w is not None:
        A = A * w[..., None]
    return _smallest_eigvec_rank2(A)


def _sampson_sq(F, p0h, p1h):
    """Squared Sampson distance of each correspondence (homogeneous points
    (N, 3)) under each F (..., 3, 3) -> (..., N)."""
    Fx0 = p0h @ F.transpose(-1, -2)
    Ftx1 = p1h @ F
    num = (p1h * Fx0).sum(-1) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def sample_indices(valid, u):
    """(H, 8) indices into the points, drawn uniformly (with replacement)
    from the valid ones: the uniforms ``u`` (H, 8) in [0, 1), float64,
    scaled by the valid count and truncated."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)  # valid first
    m = torch.clamp(valid.sum(), min=1)
    u = torch.as_tensor(u, dtype=torch.float64, device=valid.device)
    return order[torch.minimum((u * m).to(torch.int64), m - 1)]


def fundamental_ransac_idx(pts0, pts1, valid, threshold, idx):
    """RANSAC with given 8-point subsets ``idx`` (H, 8); see
    ``fundamental_ransac``."""
    pts0 = pts0.to(torch.float64)
    pts1 = pts1.to(torch.float64)
    p0n, T0 = _normalize(pts0, valid)
    p1n, T1 = _normalize(pts1, valid)

    F_n = _eight_point(p0n[idx], p1n[idx])  # (H, 3, 3)
    # back to pixel coordinates: x1'^T F_n x0' = (T1 x1)^T F_n (T0 x0)
    F_px = T1.T @ F_n @ T0

    ones = torch.ones_like(pts0[:, :1])
    p0h = torch.cat([pts0, ones], -1)
    p1h = torch.cat([pts1, ones], -1)
    thr2 = torch.as_tensor(threshold, dtype=pts0.dtype, device=pts0.device) ** 2
    inl = (_sampson_sq(F_px, p0h, p1h) < thr2) & valid[None, :]
    best = torch.argmax(inl.sum(-1))
    inliers = inl[best]

    # refit on the best consensus set (weighted normalized 8-point)
    p0r, T0r = _normalize(pts0, inliers)
    p1r, T1r = _normalize(pts1, inliers)
    Fr_px = T1r.T @ _eight_point(p0r, p1r, inliers.to(pts0.dtype)) @ T0r
    inliers_r = (_sampson_sq(Fr_px, p0h, p1h) < thr2) & valid
    # keep the refit only if it does not lose support
    better = inliers_r.sum() >= inliers.sum()
    return torch.where(better, inliers_r, inliers), torch.where(better, Fr_px, F_px[best])


def fundamental_ransac(pts0, pts1, valid, threshold, u):
    """RANSAC inlier mask for the epipolar constraint between two views.

    pts0, pts1: (N, 2) undistorted pixel coordinates; valid: (N,) bool;
    threshold: inlier Sampson distance in pixels; u: (H, 8) uniforms in
    [0, 1) the 8-point subsets are drawn with (H = N_HYPOTHESES in the front
    end). Returns (inliers (N,) bool, F (3, 3) in pixel coordinates).
    Invalid entries are never inliers."""
    idx = sample_indices(valid, u)
    return fundamental_ransac_idx(pts0, pts1, valid, threshold, idx)
