"""Trajectory evaluation (``eval/trajectory.py``): ATE / RPE with the evo
association protocol, numpy only.

The reference evaluates its TUM-format ``trajectory.csv`` externally with
the ``evo`` package (its ``README.md:160-162``); this module is the
in-repo equivalent, so accuracy numbers come out of the replay runner
directly:

* timestamp association with a max-difference gate (evo's
  ``associate_trajectories`` semantics),
* optional Umeyama SE(3)/Sim(3) alignment (evo ``--align``) — for
  GNSS-georeferenced runs alignment is correctly skipped, both
  trajectories already share the world frame,
* ATE RMSE/mean/median/max over translation, RPE over fixed-distance or
  fixed-time deltas.

Ground-truth loaders: TUM files (t x y z qx qy qz qw) and the KAIST urban
``global_pose.csv`` (timestamp_ns + row-major 3x4 SE(3)).
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class Trajectory:
    t: np.ndarray  # [N] seconds
    p: np.ndarray  # [N,3]
    q: np.ndarray | None = None  # [N,4] (w,x,y,z), optional

    def __len__(self):
        return len(self.t)


def load_tum(path: str) -> Trajectory:
    """TUM format: ``t x y z qx qy qz qw`` per line (misc.cc:507-521)."""
    raw = np.loadtxt(path)
    if raw.ndim == 1:
        raw = raw[None]
    q = raw[:, [7, 4, 5, 6]] if raw.shape[1] >= 8 else None  # -> (w,x,y,z)
    return Trajectory(t=raw[:, 0], p=raw[:, 1:4], q=q)


def load_kaist_global_pose(path: str) -> Trajectory:
    """KAIST urban ``global_pose.csv``: timestamp_ns, then the 12 entries
    of a row-major 3x4 [R|t] pose (vehicle -> global)."""
    raw = np.loadtxt(path, delimiter=",")
    if raw.ndim == 1:
        raw = raw[None]
    t = raw[:, 0] * 1e-9
    mats = raw[:, 1:13].reshape(-1, 3, 4)
    p = mats[:, :, 3]
    # rotation -> quaternion (w,x,y,z)
    q = np.zeros((len(t), 4))
    for i, R in enumerate(mats[:, :, :3]):
        w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
        if w > 1e-6:
            q[i] = [w, (R[2, 1] - R[1, 2]) / (4 * w),
                    (R[0, 2] - R[2, 0]) / (4 * w),
                    (R[1, 0] - R[0, 1]) / (4 * w)]
        else:
            q[i] = [1.0, 0.0, 0.0, 0.0]
    return Trajectory(t=t, p=p, q=q)


def associate(est: Trajectory, ref: Trajectory, max_diff: float = 0.02):
    """Nearest-timestamp association within ``max_diff`` s (evo protocol).

    Returns index arrays (ie, ir) of matched samples, strictly increasing.
    """
    ir_all = np.searchsorted(ref.t, est.t)
    ie, ir = [], []
    last_r = -1
    for i, j in enumerate(ir_all):
        best, bestd = -1, max_diff
        for cand in (j - 1, j):
            if 0 <= cand < len(ref.t):
                d = abs(ref.t[cand] - est.t[i])
                if d <= bestd:
                    best, bestd = cand, d
        if best > last_r:
            ie.append(i)
            ir.append(best)
            last_r = best
    return np.asarray(ie, int), np.asarray(ir, int)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares rigid (or similarity) transform dst ~ s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    s = float((S * np.diag(D)).sum() / (xs**2).sum() * len(src)) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _stats(err: np.ndarray) -> dict:
    return dict(
        rmse=float(np.sqrt(np.mean(err**2))),
        mean=float(np.mean(err)),
        median=float(np.median(err)),
        max=float(np.max(err)),
        min=float(np.min(err)),
        n=int(len(err)),
    )


def absolute_trajectory_error(
    est: Trajectory, ref: Trajectory,
    max_diff: float = 0.02, align: bool = False, t_min: float | None = None,
) -> dict:
    """ATE over translation (evo ``ape --pose_relation trans_part``)."""
    ie, ir = associate(est, ref, max_diff)
    if t_min is not None:
        keep = est.t[ie] >= t_min
        ie, ir = ie[keep], ir[keep]
    if len(ie) == 0:
        return dict(rmse=float("nan"), n=0)
    pe, pr = est.p[ie], ref.p[ir]
    if align and len(ie) >= 3:
        s, R, t = umeyama_alignment(pe, pr)
        pe = (s * (R @ pe.T)).T + t
    return _stats(np.linalg.norm(pe - pr, axis=1))


def relative_pose_error(
    est: Trajectory, ref: Trajectory,
    delta_t: float = 1.0, max_diff: float = 0.02, t_min: float | None = None,
) -> dict:
    """Translational RPE over time deltas (evo ``rpe`` with delta in s):
    error of the relative displacement across each delta interval."""
    ie, ir = associate(est, ref, max_diff)
    if t_min is not None:
        keep = est.t[ie] >= t_min
        ie, ir = ie[keep], ir[keep]
    if len(ie) < 2:
        return dict(rmse=float("nan"), n=0)
    te = est.t[ie]
    errs = []
    j = 0
    for i in range(len(ie)):
        while j < len(ie) and te[j] < te[i] + delta_t:
            j += 1
        if j >= len(ie):
            break
        de = est.p[ie[j]] - est.p[ie[i]]
        dr = ref.p[ir[j]] - ref.p[ir[i]]
        errs.append(np.linalg.norm(de - dr))
    if not errs:
        return dict(rmse=float("nan"), n=0)
    return _stats(np.asarray(errs))
