"""KAIST Complex Urban dataset ingest, urban38/urban39 layout
(``data/kaist.py``).

The reference consumes these sequences as rosbags through its ROS node
(``fusion_ros.cc:130-249``); this module reads the dataset's CSV layout
directly:

* ``sensor_data/xsens_imu.csv``  - timestamp [ns], quaternion(4),
  euler(3), gyro(3) [rad/s], accel(3) [m/s^2], magnetometer(3)
* ``sensor_data/vrs_gps.csv``    - timestamp [ns], latitude [deg],
  longitude [deg], altitude [m], then solution/covariance fields (the
  x/y/z std columns are configurable via ``GpsColumns``)

Conversions as the reference's ingest: rate -> increment (dtheta = w dt,
dvel = a dt, ``fusion_ros.cc:145-150``); geodetic -> the local NED frame
anchored at the first fix (``Earth::global2local``, ``ic_gvins.cc:239``,
here the port's ``common/earth.py`` on CPU float64 tensors); ns -> s.
Tables load with the native parser (``native/csv.cpp``, as the JAX
package's loader), and the loaders return the port's ``ImuSeq`` /
``Gnss`` containers holding float64 numpy arrays.
"""

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..common import earth
from ..native import load_numeric_table
from .types import Gnss, ImuSeq


def _load_table(path: str, delimiter=",") -> np.ndarray:
    """A numeric table parsed by the native library (``native/csv.cpp``);
    a ragged table goes to ``np.loadtxt``, which raises its usual error."""
    out = load_numeric_table(path)
    if out is None:
        out = np.loadtxt(path, delimiter=delimiter, ndmin=2)
    return out


@dataclass
class ImuColumns:
    time: int = 0  # ns
    gyro: tuple = (8, 9, 10)  # rad/s
    accel: tuple = (11, 12, 13)  # m/s^2
    time_scale: float = 1e-9


@dataclass
class GpsColumns:
    time: int = 0  # ns
    lat: int = 1  # deg
    lon: int = 2  # deg
    alt: int = 3  # m
    std: tuple | None = None  # optional (sx, sy, sz) columns
    default_std: float = 0.5  # m, when no covariance columns
    time_scale: float = 1e-9


def load_imu_csv(path: str, cols: ImuColumns = ImuColumns()) -> ImuSeq:
    """An IMU rate CSV as increments; the first sample is the seed
    (dt = 0)."""
    raw = _load_table(path)
    t = raw[:, cols.time] * cols.time_scale
    dt = np.diff(t, prepend=t[0])
    dt[0] = 0.0  # leading seed sample
    return ImuSeq(time=t, dt=dt, dtheta=raw[:, list(cols.gyro)] * dt[:, None],
                  dvel=raw[:, list(cols.accel)] * dt[:, None])


def load_gps_csv(path: str, cols: GpsColumns = GpsColumns(), origin_blh=None):
    """A GNSS CSV as (``Gnss`` in the local NED frame, origin_blh); the
    frame is anchored at the first fix unless ``origin_blh`` is given."""
    raw = _load_table(path)
    t = raw[:, cols.time] * cols.time_scale
    d2r = np.pi / 180.0
    blh = np.stack([raw[:, cols.lat] * d2r, raw[:, cols.lon] * d2r, raw[:, cols.alt]], axis=1)
    if origin_blh is None:
        origin_blh = blh[0]
    local = earth.global_to_local(torch.as_tensor(np.asarray(origin_blh, np.float64)),
                                  torch.as_tensor(blh)).numpy()
    if cols.std is not None:
        std = raw[:, list(cols.std)]
    else:
        std = np.full((len(t), 3), cols.default_std)
    return Gnss(time=t, p=local, std=std), origin_blh


def load_sequence(root: str, imu_cols=ImuColumns(), gps_cols=GpsColumns()):
    """A KAIST-layout sequence directory,
    root/sensor_data/{xsens_imu.csv, vrs_gps.csv}: (imu, gnss, origin_blh)."""
    imu = load_imu_csv(os.path.join(root, "sensor_data", "xsens_imu.csv"), imu_cols)
    gnss, origin = load_gps_csv(os.path.join(root, "sensor_data", "vrs_gps.csv"), gps_cols)
    return imu, gnss, origin


def image_timestamps(root: str, camera: str = "stereo_left"):
    """Image stamps in s (root/sensor_data/<camera>_stamp.csv, or the
    ns-named files in root/image/<camera>/)."""
    stamp_file = os.path.join(root, "sensor_data", f"{camera}_stamp.csv")
    if os.path.exists(stamp_file):
        return np.loadtxt(stamp_file) * 1e-9
    img_dir = os.path.join(root, "image", camera)
    if os.path.isdir(img_dir):
        names = sorted(os.listdir(img_dir))
        return np.array([float(os.path.splitext(n)[0]) * 1e-9 for n in names])
    raise FileNotFoundError(f"no image stamps under {root}")
