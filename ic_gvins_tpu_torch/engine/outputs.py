"""Result writers in the reference's column formats (``engine/outputs.py``;
``ic_gvins.cc:68-73``, ``misc.cc:440-522``, ``ic_gvins.cc:964-1067``):

* ``gvins.nav``       - 0, time, pos (deg/deg/m or local m), vel, att (deg)
* ``IMU_ERR.txt``     - time, bg (deg/hr), ba (mGal)
* ``trajectory.csv``  - TUM: time px py pz qx qy qz qw
* ``statistics.txt``  - per-round solver statistics
* ``tracking.txt``    - per-keyframe tracking log
* ``mappoint.txt``    - landmarks fixed at marginalization
* ``extrinsic.txt``   - time, t_b_c, euler(q_b_c), td

The rotation and geodetic conversions are the port's ``common/rotation.py``
and ``common/earth.py`` on CPU float64 tensors. The nav writer decimates
10x like the reference (``misc.cc:443-445``).
"""

import os

import numpy as np
import torch

from ..common import earth
from ..common import rotation as rot
from ..common.angle import R2D
from .fileio import FileSaver


def _np(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)).astype(np.float64)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(_np(x))


class RunWriter:
    def __init__(self, outdir: str, origin_blh=None):
        """``origin_blh`` (lat rad, lon rad, h m): when given, gvins.nav
        rows carry the geodetic position and attitude like the reference
        (``Earth::local2global``, ``misc.cc:452``, lat/lon in degrees);
        when None the local n-frame position is written."""
        os.makedirs(outdir, exist_ok=True)
        self.outdir = outdir
        self.origin_blh = _np(origin_blh) if origin_blh is not None else None
        self._nav = open(os.path.join(outdir, "gvins.nav"), "w")
        self._err = open(os.path.join(outdir, "IMU_ERR.txt"), "w")
        self._traj = open(os.path.join(outdir, "trajectory.csv"), "w")
        self._stat = open(os.path.join(outdir, "statistics.txt"), "w")
        self._ext = open(os.path.join(outdir, "extrinsic.txt"), "w")
        self._track = None
        self._counts = 0

    def write_nav(self, state, decimate: int = 10):
        """One state (``NavState`` of tensors or arrays) to gvins.nav,
        IMU_ERR.txt and trajectory.csv, every ``decimate``-th call."""
        self._counts += 1
        if (self._counts - 1) % decimate:
            return
        t = float(state.time)
        p, v, q = _np(state.p), _np(state.v), _np(state.q)
        if self.origin_blh is not None:
            r_g, blh = earth.pose_local_to_global(_t(self.origin_blh),
                                                  rot.quat_to_matrix(_t(q)), _t(p))
            att = rot.matrix_to_euler(r_g).numpy() * R2D
            pos = blh.numpy().copy()
            pos[:2] *= R2D
        else:
            att = rot.quat_to_euler(_t(q)).numpy() * R2D
            pos = p
        bg = _np(state.bg) * R2D * 3600.0
        ba = _np(state.ba) * 1e5
        self._nav.write(f"0 {t:.9f} " + " ".join(f"{x:.9f}" for x in (*pos, *v, *att)) + "\n")
        self._err.write(f"{t:.9f} " + " ".join(f"{x:.6f}" for x in (*bg, *ba)) + "\n")
        self._traj.write(  # w x y z -> TUM x y z w
            f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
            f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
        )

    def write_statistics(self, row: dict):
        keys = sorted(row)
        if self._stat.tell() == 0:
            self._stat.write("# " + " ".join(keys) + "\n")
        self._stat.write(" ".join(str(row[k]) for k in keys) + "\n")

    def write_tracking(self, t, interval=0.0, parallax=0.0, translation=0.0,
                       rotation=0.0, n_mappoints=0, cost_ms=0.0, **_):
        """Per-keyframe tracking log in the reference's tracking.txt layout
        (``tracking.cc:297-315``): t, keyframe interval (s), mean parallax
        (px), translation (m), rotation (deg), tracked mappoints, front-end
        time (ms)."""
        if self._track is None:
            self._track = open(os.path.join(self.outdir, "tracking.txt"), "w")
        self._track.write(
            f"{t:.9f} {interval:.6f} {parallax:.3f} {translation:.6f} "
            f"{rotation:.6f} {int(n_mappoints)} {cost_ms:.3f}\n"
        )

    def write_mappoints(self, points):
        """Landmark cloud, one world position per row (mappoint.txt,
        ``ic_gvins.cc:69,1704``)."""
        with FileSaver(os.path.join(self.outdir, "mappoint.txt"), 3) as fs:
            fs.dumpn(points)

    def write_extrinsic(self, t, ext_p, ext_q, td):
        att = rot.quat_to_euler(_t(ext_q)).numpy() * R2D
        p = _np(ext_p)
        self._ext.write(
            f"{t:.9f} " + " ".join(f"{x:.6f}" for x in (*p, *att)) + f" {float(td):.6f}\n"
        )

    def close(self):
        for f in (self._nav, self._err, self._traj, self._stat, self._ext, self._track):
            if f is not None:
                f.close()
