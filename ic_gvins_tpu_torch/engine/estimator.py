"""The fusion engine (``engine/estimator.py``): sensor ingest, time nodes,
optimization rounds, marginalization.

A deterministic host pipeline, as in the JAX package: events are consumed
in time order, and each one runs the device stages on the window's tensors
(on ``cuda:0`` unless the caller names a device):

* IMU    -> the host IMU buffer (gap repair, deferred events replayed)
* GNSS   -> time node + preintegration + optimization round
* frame  -> keyframe decision + node + landmark bookkeeping + round +
            marginalization while the window is over-full

State machine: INITIALIZING -> INITIALIZING_INS (GNSS/INS rounds) ->
INITIALIZING_VIO -> TRACKING_INITIALIZING -> TRACKING_NORMAL.

The host bookkeeping (IMU buffer, slot maps, keyframe decisions, outlier
culling, the per-frame INS prediction) is numpy, copied from the JAX
package. Unlike it, nothing is padded for a compiler: IMU slices have
their real length and triangulation takes only the real candidates.
Window tensors are never written in place (the prior's linearization
snapshot and the mechanization origin share them); every update builds
new tensors.

With ``cfg.odo.use_odo`` the window's intervals carry the wheel
odometer (``ins/preintegration_odo.py``) and the window estimates its
scale. ``save_checkpoint`` / ``load_checkpoint`` use the JAX package's
pickle layout, so either package resumes the other's checkpoints.

``set_mesh`` runs the rounds landmark-sharded
(``parallel/lm_sharded.py``), on one card or across ``torch.distributed``
ranks: every rank runs the same estimator on the same streams, each round
leaves the whole window, bit for bit the same, on every rank, and the
rest (culling, marginalization, the host's landmark slots) goes on as in
the single path.

``dtype`` (float64 by default, or float32) is the type of every device
tensor: the window, the prior, the integration parameters, the solver
configuration and the preintegration, as the JAX package's arrays are
with x64 on or off. The host bookkeeping (IMU buffer, ``origin``, slot
maps, trajectory) stays float64 numpy. In float32 the window is
re-centered (``recenter_threshold``, on by default there): once the
oldest node lies farther than the threshold from the local origin, every
absolute position shifts by it and ``origin`` takes it up.
``cfg.use_native_imu_buffer`` picks the C++ IMU buffer of the port's
native library (the default) or the Python one, as in the JAX package; a
C++ buffer that cannot be built raises.
"""

import bisect
import math
import pickle
import time as _time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from ..common import rotation as rot
from ..common.logging import LOGE, LOGI, LOGW
from ..data.types import ImuSeq, IntegrationParams, NavState
from ..device import resolve_device
from ..factors.marginalization import (
    insert_node,
    marginalize_and_slide,
    remove_node,
    slide_window,
)
from ..ins import mechanization as mech
from ..ins.preintegration import preintegrate
from ..ins.preintegration_odo import OdoParams, preintegrate_odo
from ..native import NativeImuBuffer
from ..parallel.lm_sharded import optimize_sharded
from ..solver import lm as lm_mod
from ..solver.assembly import eval_reproj_res, obs_mask
from ..solver.window import SolverConfig, empty_prior, empty_window, make_init_prior
from ..vision.triangulation import triangulate_checked
from .config import D2R, EngineConfig

# engine states (parity with GVINSState, ic_gvins.h:47-55)
ERROR = -1
INITIALIZING = 0
INITIALIZING_INS = 1  # GNSS/INS rounds only
INITIALIZING_VIO = 2  # first keyframe node added without optimization
TRACKING_INITIALIZING = 3  # full rounds; ext/td still frozen
TRACKING_NORMAL = 4  # window full; ext/td estimation enabled
TRACKING_LOST = 5

# landmark slot lifecycle (MapPointType, mappoint.h:38-44)
MAPPOINT_NONE = 0
MAPPOINT_TRIANGULATED = 1
MAPPOINT_DEPTH_ASSOCIATED = 2
MAPPOINT_DEPTH_INITIALIZED = 3
MAPPOINT_FIXED = 4


def _host(x) -> np.ndarray:
    """A tensor (or number, or array) as a numpy array on the host."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _put(full, i, x):
    """``full`` (a tensor or NamedTuple of tensors) with entry ``i``
    replaced by ``x``, as new tensors."""
    if isinstance(full, tuple):
        return type(full)(*(_put(f, i, v) for f, v in zip(full, x)))
    out = full.clone()
    out[i] = torch.as_tensor(x, dtype=out.dtype, device=out.device)
    return out


def _leaves(tree) -> list:
    """The leaves of nested NamedTuples in field order, ``None`` left out:
    the JAX package's ``jax.tree.flatten`` order."""
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(template, leaves, device):
    """``template``'s structure (tensors) filled with ``leaves`` (numpy
    arrays in ``_leaves`` order, of the template's shapes) as tensors on
    ``device``, each in the type of the template's tensor."""
    shapes = [tuple(x.shape) for x in _leaves(template)]
    if [np.shape(x) for x in leaves] != shapes:
        raise ValueError("the checkpoint's window layout is not this configuration's "
                         "(window sizes, odometer)")
    it = iter(leaves)

    def build(t):
        if isinstance(t, tuple):
            return type(t)(*(build(v) for v in t))
        return None if t is None else torch.as_tensor(np.asarray(next(it)), dtype=t.dtype,
                                                      device=device)

    return build(template)


def _np_quat_mul(q1, q2):
    """Hamilton product, numpy, broadcasting over leading axes."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def _np_quat_rotate(q, v):
    """Rotate v by unit quaternion q, numpy, broadcasting."""
    w_, xyz = q[..., :1], q[..., 1:]
    t2 = 2.0 * np.cross(xyz, v)
    return v + w_ * t2 + np.cross(xyz, t2)


def _np_rotvec_to_quat(v):
    """Rotation vector -> unit quaternion (numpy, single vector)."""
    half = 0.5 * float(np.linalg.norm(v))
    s = 0.5 * np.sinc(half / np.pi)  # sin(half)/|v|, exact as |v| -> 0
    return np.concatenate([[np.cos(half)], v * s])


def _np_mechanize_series(gravity, iewn, p, q, v, bg, ba, dt, dth, dv):
    """Host (numpy, float64) mirror of ``mech.mechanize_scan``, final state
    only: the per-frame INS pose prediction without a device call."""
    prev_th = dth[0] - dt[0] * bg
    prev_dv = dv[0] - dt[0] * ba
    for k in range(1, len(dt)):
        dtc = float(dt[k])
        if dtc == 0.0:
            continue
        th_c = dth[k] - dtc * bg
        v_c = dv[k] - dtc * ba
        dvfb = (v_c + 0.5 * np.cross(th_c, v_c)
                + (1.0 / 12.0) * (np.cross(prev_th, v_c)
                                  + np.cross(prev_dv, th_c)))
        dtheta = th_c + (1.0 / 12.0) * np.cross(prev_th, th_c)
        dv_cor_g = (gravity - 2.0 * np.cross(iewn, v)) * dtc
        qnn = _np_rotvec_to_quat(-iewn * dtc)
        body_dv = _np_quat_rotate(q, dvfb)
        dvel = 0.5 * (body_dv + _np_quat_rotate(qnn, body_dv)) + dv_cor_g
        q = _np_quat_mul(qnn, _np_quat_mul(q, _np_rotvec_to_quat(dtheta)))
        q = q / np.linalg.norm(q)
        p = p + dtc * v + 0.5 * dtc * dvel
        v = v + dvel
        prev_th, prev_dv = th_c, v_c
    return p, q, v


def _np_quat_to_matrix(q):
    """[...,4] unit quaternion -> [...,3,3] rotation matrix (numpy)."""
    w, x, y, z = (q[..., i] for i in range(4))
    r = np.empty(q.shape[:-1] + (3, 3), np.float64)
    r[..., 0, 0] = 1 - 2 * (y * y + z * z)
    r[..., 0, 1] = 2 * (x * y - w * z)
    r[..., 0, 2] = 2 * (x * z + w * y)
    r[..., 1, 0] = 2 * (x * y + w * z)
    r[..., 1, 1] = 1 - 2 * (x * x + z * z)
    r[..., 1, 2] = 2 * (y * z - w * x)
    r[..., 2, 0] = 2 * (x * z - w * y)
    r[..., 2, 1] = 2 * (y * z + w * x)
    r[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return r


@dataclass
class _ImuBuffer:
    """Host buffer of IMU increments (numpy)."""

    time: list = field(default_factory=list)
    dt: list = field(default_factory=list)
    dtheta: list = field(default_factory=list)
    dvel: list = field(default_factory=list)

    def append(self, t, dt, dth, dv):
        self.time.append(float(t))
        self.dt.append(float(dt))
        self.dtheta.append(np.asarray(dth, np.float64))
        self.dvel.append(np.asarray(dv, np.float64))

    def drop_before(self, t):
        i = 0
        while i < len(self.time) - 2 and self.time[i + 1] < t:
            i += 1
        if i > 0:
            del self.time[:i], self.dt[:i], self.dtheta[:i], self.dvel[:i]

    def slice_between_np(self, t0, t1, min_dt=1e-4):
        """IMU series covering (t0, t1] with boundary interpolation and a
        leading zero seed sample, as ``MISC::getImuSeriesFromTo``
        (misc.cc:330-384): (time, dt, dtheta, dvel) numpy arrays."""
        times = np.asarray(self.time)
        i0 = int(np.searchsorted(times, t0 + min_dt))
        i1 = int(np.searchsorted(times, t1 - min_dt))
        out_t, out_dt, out_th, out_dv = [t0], [0.0], [np.zeros(3)], [np.zeros(3)]
        # partial first interval: scale the increment crossing t0
        if i0 > 0 and times[i0] > t0 + min_dt and times[i0] - self.dt[i0] < t0 - min_dt:
            frac = (times[i0] - t0) / self.dt[i0]
            out_t.append(times[i0])
            out_dt.append(times[i0] - t0)
            out_th.append(self.dtheta[i0] * frac)
            out_dv.append(self.dvel[i0] * frac)
            i0 += 1
        for k in range(i0, min(i1 + 1, len(times))):
            if times[k] <= t1 + min_dt:
                out_t.append(times[k])
                out_dt.append(self.dt[k])
                out_th.append(self.dtheta[k])
                out_dv.append(self.dvel[k])
        # partial last interval: the first sample beyond t1, scaled to its
        # part inside the interval (misc.cc:360-381)
        k = int(np.searchsorted(times, t1 + min_dt))
        if k < len(times) and times[k] > t1 + min_dt:
            t_start = times[k] - self.dt[k]
            if t0 - min_dt <= t_start < t1 - min_dt:
                frac = (t1 - t_start) / self.dt[k]
                if frac > 1e-9:
                    out_t.append(t1)
                    out_dt.append(t1 - t_start)
                    out_th.append(self.dtheta[k] * frac)
                    out_dv.append(self.dvel[k] * frac)
        out_t[-1] = t1  # stamp the end exactly (misc.cc:381)
        return (np.asarray(out_t, np.float64), np.asarray(out_dt, np.float64),
                np.stack(out_th), np.stack(out_dv))

    def arrays(self):
        """(time [n], dt [n], dtheta [n,3], dvel [n,3]) numpy arrays."""
        if not self.time:
            z = np.zeros(0)
            return z, z, np.zeros((0, 3)), np.zeros((0, 3))
        return (np.asarray(self.time), np.asarray(self.dt),
                np.stack(self.dtheta), np.stack(self.dvel))


class _NativeImuBuffer:
    """The C++ IMU buffer (``native/imu_buffer.cpp``): the increments, the
    gap filling and the interpolated slices live in C++, and a float list
    mirrors the stamps for the host's coverage checks. The interface of
    :class:`_ImuBuffer`."""

    def __init__(self, nominal_dt: float):
        self._nat = NativeImuBuffer(nominal_dt)
        self._nominal = float(nominal_dt)
        self.time: list[float] = []

    def append(self, t, dt, dth, dv):
        added = int(self._nat.append(t, dt, dth, dv))
        if added > 1 and self.time:
            # the buffer filled a gap of the stamps before this sample
            last = self.time[-1]
            for k in range(added - 1):
                self.time.append(last + (k + 1) * self._nominal)
        self.time.append(float(t))

    def drop_before(self, t):
        self._nat.drop_before(t)
        n_keep = len(self._nat)
        if n_keep < len(self.time):
            del self.time[: len(self.time) - n_keep]

    def arrays(self):
        return self._nat.export_arrays()

    def slice_between_np(self, t0, t1, min_dt=1e-4):
        """The C++ slice of (t0, t1] at its real length (the seed, every
        stored sample at most once and the tail bound its size)."""
        time, dt, dth, dv, n = self._nat.slice_between(t0, t1, len(self._nat) + 2, min_dt)
        return time[:n], dt[:n], dth[:n], dv[:n]


def _make_imu_buffer(cfg: EngineConfig):
    """The C++ buffer when ``cfg.use_native_imu_buffer`` (the default), else
    the Python one. Where the JAX package falls back to Python when the
    native library cannot be built, this raises."""
    if not cfg.use_native_imu_buffer:
        return _ImuBuffer()
    try:
        return _NativeImuBuffer(1.0 / cfg.imudatarate)
    except (OSError, RuntimeError) as e:
        raise RuntimeError(
            "use_native_imu_buffer=True needs the native library, which could not be "
            "built or loaded; set use_native_imu_buffer=False for the Python buffer"
        ) from e


class Estimator:
    """INS-centric GNSS(+Visual) fusion engine."""

    def __init__(self, cfg: EngineConfig, device=None, dtype=torch.float64):
        if dtype not in (torch.float64, torch.float32):
            raise TypeError(f"the engine runs in float64 or float32, not {dtype}")
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.dtype = dtype
        self._np_cache: dict = {}
        # the intake's counts (cumulative): frames, keyframes and tracks
        # fed; landmark slots taken, and new tracks a keyframe dropped for
        # want of a free slot; window tensors read to the host by _host
        self.counters = {"frames": 0, "keyframes": 0, "tracks": 0, "slots_taken": 0,
                         "slot_drops": 0, "host_reads": 0}
        kw = dict(dtype=dtype, device=dev)
        t = lambda x: torch.tensor(x, **kw)  # noqa: E731
        m = cfg.imumodel
        self.params = IntegrationParams(
            gyr_arw=t(m.arw * D2R / 60.0), acc_vrw=t(m.vrw / 60.0),
            gyr_bias_std=t(m.gbstd * D2R / 3600.0), acc_bias_std=t(m.abstd * 1e-5),
            corr_time=t(m.corrtime * 3600.0),
            gravity=t([0.0, 0.0, cfg.gravity]),
            iewn=torch.zeros(3, **kw),  # set at initialization from latitude
        )
        self._set_params()  # host mirrors of gravity and iewn
        self._focal = 0.5 * (cfg.cam.intrinsic[0] + cfg.cam.intrinsic[1])
        self._reproj_std = cfg.reprojection_error_std / self._focal  # normalized units
        flag = lambda b: torch.tensor(bool(b), device=dev)  # noqa: E731
        self.solver_cfg = SolverConfig(
            antlever=t(cfg.antlever),
            reproj_std=t(self._reproj_std),
            bias_prior_bg_std=t(cfg.gyr_bias_prior_std),
            bias_prior_ba_std=t(cfg.acc_bias_prior_std),
            estimate_extrinsic=flag(cfg.optimize_estimate_extrinsic),
            estimate_td=flag(cfg.optimize_estimate_td),
            estimate_sodo=flag(cfg.odo.estimate_sodo),
            sodo_prior_std=t(cfg.odo.sodo_prior_std),
            chi2_compound=flag(cfg.chi2_compound),
        )
        self.use_odo = bool(cfg.odo.use_odo)
        if self.use_odo:
            self.odo_params = OdoParams(
                cvb=rot.quat_to_matrix(rot.euler_to_quat(t(cfg.odo.mount_euler))),
                lodo=t(cfg.odo.lever), odo_vrw=t(cfg.odo.odo_vrw),
                odo_srw=t(cfg.odo.odo_srw),
            )
        # odometer forward-velocity samples (t, v) for interval slicing
        self.odo_t: list[float] = []
        self.odo_v: list[float] = []

        self.state = INITIALIZING
        self.imu = _make_imu_buffer(cfg)
        self.gnss_queue: list[tuple[float, np.ndarray, np.ndarray]] = []
        # events (GNSS fixes / tracked frames) that arrived ahead of IMU
        # coverage wait here and are replayed by add_imu, in time order
        self.pending_events: list[tuple] = []
        self.imu_repaired = 0  # IMU samples synthesized into rate gaps
        self.n_recenters = 0  # window shifts (_maybe_recenter)
        self.mesh = None  # set_mesh: rounds landmark-sharded over this mesh
        self.dropped_gnss = 0  # fixes lost despite the capacity slide
        # geodetic anchor of the local frame (lat rad, lon rad, h m); when
        # set, Earth rate + gravity derive from position
        self.origin_blh: np.ndarray | None = None

        q_bc = np.asarray(cfg.cam.q_b_c, np.float64)
        self.window = empty_window(cfg.max_nodes, cfg.max_landmarks, dtype, device=dev,
                                   odo=self.use_odo)._replace(
            ext_p=t(cfg.cam.t_b_c), ext_q=t(q_bc / np.linalg.norm(q_bc)),
            td=t(cfg.cam.td_b_c),
        )
        self.prior = empty_prior(cfg.max_nodes, dtype, device=dev)
        self.n_nodes = 0  # host count of valid nodes
        self.node_times: list[float] = []
        self.node_is_kf: list[bool] = []
        self.n_keyframes = 0

        self.cur_state: NavState | None = None
        self.last_node_state: NavState | None = None
        self.traj_times: list[float] = []
        self.traj_p: list[np.ndarray] = []
        self.traj_q: list[np.ndarray] = []

        # landmark slot bookkeeping: external id -> slot
        self.lm_slot: dict[int, int] = {}
        self.free_slots = list(range(cfg.max_landmarks - 1, -1, -1))
        self.lm_type = np.zeros(cfg.max_landmarks, np.int8)  # MAPPOINT_*
        self.stats: list[dict] = []
        self.track_log: list[dict] = []  # per-keyframe tracking diagnostics
        self._ext_accepted = None  # last sanity-accepted extrinsic (p, q)
        self._kf_kind = "normal"
        self._last_parallax = 0.0
        # world positions of landmarks fixed at marginalization
        self.fixed_mappoints: list[np.ndarray] = []
        # the local frame's offset: window positions are kept near zero by
        # re-centering so that float32 keeps its precision; outputs add it
        self.origin = np.zeros(3, np.float64)
        self._mech_cache = (None, None, None)  # (t, state obj, result)
        self._np_state_cache = (None, None)
        # chi2 of the newest GNSS residual after each GINS-phase round;
        # vision joins once the recent history is steady
        self._gins_chi2: list[float] = []
        self._vio_join_waits = 0
        self._align_rejects = 0
        # alignment cached across initialization attempts (leveling
        # results survive until motion)
        self._align_bg: np.ndarray | None = None
        self._align_rollpitch: tuple | None = None
        self._t_marg_accum = 0.0
        # wall ms of each call of the device stages, on a synchronized
        # host clock: "preintegrate", "optimize", "marginalize"
        self.stage_ms: dict[str, list[float]] = {
            "preintegrate": [], "optimize": [], "marginalize": []}
        self._staged_ms = 0.0  # the sum of every stage_ms entry
        # host wall ms of each add_frame_observations call, less the
        # stage_ms stages it ran
        self.feed_ms: list[float] = []
        # observations and landmark slots that died with a marginalized
        # anchor and were cleared before the slots were freed (cumulative)
        self._dead_cleared = {"observations": 0, "slots": 0}
        # None: on (20 m) in float32, off in float64, as the JAX package
        # picks it by its x64 switch
        thr = cfg.recenter_threshold
        if thr is None:
            thr = 0.0 if dtype == torch.float64 else 20.0
        self.recenter_threshold = float(thr)

    # ------------------------------------------------------------------
    # device helpers
    # ------------------------------------------------------------------

    def _dev(self, x, dtype=None):
        """A host value as a device tensor, in the engine's dtype unless
        ``dtype`` names another."""
        return torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype, device=self.device)

    def _host(self, x) -> np.ndarray:
        """``_host``, counting the tensors read (``counters["host_reads"]``)."""
        if torch.is_tensor(x):
            self.counters["host_reads"] += 1
        return _host(x)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage_done(self, stage, ms):
        self.stage_ms[stage].append(ms)
        self._staged_ms += ms

    @contextmanager
    def _timed(self, stage):
        self._sync()
        t0 = _time.perf_counter()
        yield
        self._sync()
        self._stage_done(stage, (_time.perf_counter() - t0) * 1e3)

    def _imu_slice(self, t0, t1) -> ImuSeq:
        return ImuSeq(*(self._dev(x) for x in self.imu.slice_between_np(t0, t1)))

    def _set_params(self, **kw):
        self.params = self.params._replace(**kw)
        self._gravity = self._host(self.params.gravity).astype(np.float64)
        self._iewn = self._host(self.params.iewn).astype(np.float64)

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def add_imu(self, t, dt, dtheta, dvel):
        nominal = 1.0 / self.cfg.imudatarate
        if self.imu.time and dt > 1.5 * nominal:
            # sensor dropout: restore the nominal rate (ic_gvins.cc:191-203);
            # "split" slices the spanning increment into nominal-dt pieces,
            # "repeat" repeats the raw increment as the reference does
            LOGE(f"Lost IMU data at {t:.3f} dt {dt:.3f}; repairing")
            n_fill = int(round(dt / nominal)) - 1
            tj = t - dt
            dtheta = np.asarray(dtheta, np.float64)
            dvel = np.asarray(dvel, np.float64)
            if self.cfg.imu_gap_repair == "repeat":
                for _ in range(n_fill):
                    tj += nominal
                    self.imu.append(tj, nominal, dtheta, dvel)
                    self.imu_repaired += 1
            else:
                frac = nominal / dt
                for _ in range(n_fill):
                    tj += nominal
                    self.imu.append(tj, nominal, dtheta * frac, dvel * frac)
                    self.imu_repaired += 1
                dt_last = t - tj
                self.imu.append(t, dt_last, dtheta * (dt_last / dt), dvel * (dt_last / dt))
        else:
            self.imu.append(t, dt, dtheta, dvel)
        self._drain_pending()

    def _drain_pending(self):
        """Replay deferred events now covered by IMU data (in time order)."""
        if not self.imu.time:
            return
        t_cov = self.imu.time[-1]
        while self.pending_events and self.pending_events[0][0] <= t_cov:
            ev = self.pending_events.pop(0)
            if ev[1] == "gnss":
                _, _, p, std = ev
                self._dispatch_gnss(ev[0], p, std)
            else:
                _, _, ids, uv, vel, force_kf = ev
                self._dispatch_frame(ev[0], ids, uv, vel, force_kf)
        if self.state == INITIALIZING and len(self.gnss_queue) >= 2:
            self._try_initialize()

    def add_odo(self, t, vel):
        """Wheel-odometer forward velocity sample (m/s), interpolated onto
        the IMU sample times at preintegration."""
        self.odo_t.append(float(t))
        self.odo_v.append(float(vel))

    def _odo_increments(self, imu: ImuSeq) -> torch.Tensor:
        """Per-IMU-sample odometer displacement increments dt * v(t)."""
        if not self.odo_t:
            return torch.zeros_like(imu.dt)
        t, dt = self._host(imu.time), self._host(imu.dt)
        return self._dev(np.interp(t, np.asarray(self.odo_t), np.asarray(self.odo_v)) * dt)

    def set_mesh(self, mesh):
        """Run the optimization rounds landmark-sharded over ``mesh``
        (``parallel.Mesh``, axis "lm"; ``parallel/lm_sharded.optimize_sharded``:
        the same two-phase LM, the landmark sums per shard, then over the
        shards and the ranks). A distributed mesh holds this rank's device,
        which must be the estimator's. ``None`` restores the single path."""
        if mesh is not None:
            if self.cfg.max_landmarks % mesh.shape["lm"] != 0:
                raise ValueError("max_landmarks must divide the mesh size")
            if mesh.device != self.device:
                raise ValueError(f"rank {mesh.rank}'s mesh is on {mesh.device}, the estimator "
                                 f"on {self.device}")
        self.mesh = mesh

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str):
        """Pickle the window, prior and host bookkeeping in the JAX
        package's layout (its keys; window and prior leaves as numpy in its
        flatten order), so that either package resumes the other's
        checkpoints."""
        to_np = lambda xs: [self._host(x) for x in xs]  # noqa: E731
        state = dict(
            window=to_np(_leaves(self.window)),
            prior=to_np(_leaves(self.prior)),
            n_nodes=self.n_nodes,
            node_times=self.node_times,
            node_is_kf=self.node_is_kf,
            n_keyframes=self.n_keyframes,
            lm_slot=self.lm_slot,
            free_slots=self.free_slots,
            engine_state=self.state,
            iewn=self._host(self.params.iewn),
            last_node_state=(to_np(self.last_node_state)
                             if self.last_node_state is not None else None),
            imu=self.imu.arrays(),
            odo=(self.odo_t, self.odo_v),
            origin=self.origin,
            traj=(self.traj_times, self.traj_p, self.traj_q),
            ext_accepted=(to_np(self._ext_accepted)
                          if self._ext_accepted is not None else None),
            pending_events=self.pending_events,
            imu_repaired=self.imu_repaired,
            dropped_gnss=self.dropped_gnss,
            origin_blh=self.origin_blh,
            gravity=self._host(self.params.gravity),
            n_recenters=self.n_recenters,
            gins_chi2=list(self._gins_chi2),
            align_bg=self._align_bg,
            align_rollpitch=self._align_rollpitch,
        )
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint of either package; the configuration
        (window sizes, odometer) must be the one it was saved with. The
        state takes the estimator's dtype, whichever it was saved in."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        dev = self.device
        self.window = _unflatten(self.window, state["window"], dev)
        self.prior = _unflatten(self.prior, state["prior"], dev)
        self.n_nodes = state["n_nodes"]
        self.node_times = state["node_times"]
        self.node_is_kf = state["node_is_kf"]
        self.n_keyframes = state["n_keyframes"]
        self.lm_slot = state["lm_slot"]
        self.free_slots = state["free_slots"]
        self.state = state["engine_state"]
        self._set_params(iewn=self._dev(state["iewn"]))
        if "gravity" in state:
            self._set_params(gravity=self._dev(state["gravity"]))
        if state["last_node_state"] is not None:
            self.last_node_state = _unflatten(self.window.nodes.index(0),
                                              state["last_node_state"], dev)
            self.cur_state = self.last_node_state
        self.imu = _make_imu_buffer(self.cfg)
        for t, dt, dth, dv in zip(*state["imu"]):
            self.imu.append(float(t), float(dt), np.asarray(dth), np.asarray(dv))
        self.odo_t, self.odo_v = state.get("odo", ([], []))
        self.origin = state.get("origin", np.zeros(3, np.float64))
        self.traj_times, self.traj_p, self.traj_q = state["traj"]
        ea = state.get("ext_accepted")
        self._ext_accepted = (self._dev(ea[0]), self._dev(ea[1])) if ea is not None else None
        self.pending_events = state.get("pending_events", [])
        self.imu_repaired = state.get("imu_repaired", 0)
        self.dropped_gnss = state.get("dropped_gnss", 0)
        self.origin_blh = state.get("origin_blh")
        self.n_recenters = state.get("n_recenters", 0)
        self._gins_chi2 = list(state.get("gins_chi2", []))
        self._align_bg = state.get("align_bg")
        self._align_rollpitch = state.get("align_rollpitch")

    def set_origin_blh(self, blh):
        """Geodetic anchor (lat rad, lon rad, h m) of the local frame:
        enables position-derived Earth rate and Somigliana gravity."""
        self.origin_blh = np.asarray(blh, np.float64)

    def _refresh_earth_params(self, p_local: np.ndarray):
        """Re-derive iewn (and gravity) at the given local position."""
        if not self.cfg.iswithearth or self.origin_blh is None:
            return
        from ..common import earth

        blh = earth.local_to_global(
            self._dev(self.origin_blh),
            self._dev(np.asarray(p_local, np.float64) + self.origin),
        )
        self._set_params(iewn=earth.iewn(blh[0]),
                         gravity=torch.stack([torch.zeros_like(blh[0]),
                                              torch.zeros_like(blh[0]), earth.gravity(blh)]))

    def add_gnss(self, t, p_local, std):
        """GNSS fix already in the local frame."""
        t = float(t)
        std = np.asarray(std, np.float64)
        if np.any(std <= 0) or np.any(std > self.cfg.gnssthreshold):
            return  # quality gate (fusion_ros.cc:195-211)
        p_local = np.asarray(p_local, np.float64)
        if self.state != INITIALIZING and self.imu.time and self.imu.time[-1] < t:
            bisect.insort(self.pending_events, (t, "gnss", p_local, std), key=lambda e: e[0])
            return
        self._dispatch_gnss(t, p_local, std)

    def _dispatch_gnss(self, t, p_local, std):
        p_local = np.asarray(p_local, np.float64) - self.origin
        self.gnss_queue.append((float(t), p_local, std))
        if self.state == INITIALIZING:
            self._try_initialize()
        else:
            self._process_gnss_node()

    # ------------------------------------------------------------------
    # initialization (gvinsInitialization, ic_gvins.cc:618-726)
    # ------------------------------------------------------------------

    def _try_initialize(self):
        if len(self.gnss_queue) < 2:
            return
        t0, p0, _ = self.gnss_queue[-2]
        t1, p1, g1std = self.gnss_queue[-1]
        if not self.imu.time or self.imu.time[-1] < t1 or self.imu.time[0] > t0:
            return

        cfg = self.cfg
        if cfg.iswithearth and self.origin_blh is not None:
            self._refresh_earth_params(p1)
        elif cfg.iswithearth:
            lat = cfg.track_ref_lat_deg * D2R
            wie = 7.2921151467e-5
            self._set_params(iewn=self._dev([wie * math.cos(lat), 0.0, -wie * math.sin(lat)]))
        else:
            self._set_params(iewn=self._dev(np.zeros(3)))

        # IMU stats between the two fixes
        times, all_dt, all_dth, all_dv = self.imu.arrays()
        sel = (times > t0) & (times <= t1)
        rate = cfg.imudatarate
        is_zv, mean = mech.detect_zero_velocity(
            self._dev(all_dth[sel]), self._dev(all_dv[sel]), rate,
            cfg.zupt_gyr_threshold, cfg.zupt_acc_threshold,
        )
        mean = self._host(mean)
        g = float(self._gravity[2])

        vel_gnss = (p1 - p0) / (t1 - t0)
        # a displacing antenna vetoes the static hypothesis
        is_zv = bool(is_zv) and np.linalg.norm(vel_gnss) < 0.5 * cfg.min_align_velocity
        if is_zv:
            # static: estimate the gyro biases, level roll/pitch, wait for
            # motion to align heading (ic_gvins.cc:644-686)
            fb = mean[3:] * rate
            self._align_bg = mean[:3] * rate
            self._align_rollpitch = (
                math.atan2(-fb[1], -fb[2]),
                math.asin(np.clip(fb[0] / g, -1, 1)),
            )
            return

        hv = np.linalg.norm(vel_gnss[:2])
        if hv < cfg.min_align_velocity:
            return  # not enough motion to align heading
        # noise-adaptive alignment: wait until the heading implied by the
        # GNSS velocity is good to align_max_heading_std (or the liveness
        # fallback), then open the attitude prior to that information
        sigma_vh = math.sqrt(2.0) * float(np.mean(g1std[:2])) / (t1 - t0)
        yaw_err = math.atan2(sigma_vh, hv)
        if yaw_err > cfg.align_max_heading_std:
            self._align_rejects += 1
            if self._align_rejects <= cfg.align_max_rejects:
                return
        sigma_vz = math.sqrt(2.0) * float(g1std[2]) / (t1 - t0)
        yaw = math.atan2(vel_gnss[1], vel_gnss[0])
        if self._align_rollpitch is not None:
            roll, pitch = self._align_rollpitch
            pitch_err = 0.0
        else:
            roll = 0.0
            pitch = math.atan2(-vel_gnss[2], hv)
            pitch_err = math.atan2(sigma_vz, hv)
        bg = self._align_bg if self._align_bg is not None else np.zeros(3)

        q = rot.euler_to_quat(self._dev([roll, pitch, yaw]))
        r_bn = self._host(rot.quat_to_matrix(q))
        p_node = p1 - r_bn @ np.asarray(cfg.antlever)

        state0 = NavState(time=self._dev(t1), p=self._dev(p_node), q=q,
                          v=self._dev(vel_gnss), bg=self._dev(bg),
                          ba=self._dev(np.zeros(3)))
        self._append_node(state0, is_kf=False)
        self._set_gnss(0, p1, g1std)

        # initialization prior (constructPrior, ic_gvins.cc:2003-2038)
        leveled = self._align_rollpitch is not None
        bg_std = (float(self.params.gyr_bias_std) * 3 if leveled
                  else self.cfg.gyr_bias_prior_std)
        roll_std = 0.5 * D2R if leveled else 2.0 * D2R
        pitch_std = max(0.5 * D2R, pitch_err)
        yaw_std = max(1.5 * D2R, yaw_err)
        vel_std = max(0.1, sigma_vh)
        pose_std = self._dev([0.1, 0.1, 0.1, roll_std, pitch_std, yaw_std])
        mix_std = self._dev([vel_std] * 3 + [bg_std] * 3 + [self.cfg.acc_bias_prior_std] * 3)
        self.prior = make_init_prior(self.window, pose_std, mix_std)

        self.cur_state = state0
        self.last_node_state = state0
        self.imu.drop_before(t1 - 0.1)
        self.state = INITIALIZING_INS
        LOGI(f"GNSS/INS initialized at t={t1:.3f} (moving alignment, "
             f"{'leveled' if leveled else 'GNSS-derived'} roll/pitch, "
             f"yaw std {yaw_std / D2R:.1f} deg)")

    # ------------------------------------------------------------------
    # node management
    # ------------------------------------------------------------------

    def _append_node(self, state: NavState, is_kf: bool):
        """Write a node at slot n_nodes (host-tracked append)."""
        n = self.n_nodes
        w = self.window
        self.window = w._replace(
            nodes=_put(w.nodes, n, state),
            node_valid=_put(w.node_valid, n, True),
            node_is_kf=_put(w.node_is_kf, n, is_kf),
        )
        self.node_times.append(float(state.time))
        self.node_is_kf.append(is_kf)
        self.n_nodes += 1
        if is_kf:
            self.n_keyframes += 1

    def _set_gnss(self, k, p, std):
        w = self.window
        self.window = w._replace(
            gnss_p=_put(w.gnss_p, k, p), gnss_std=_put(w.gnss_std, k, std),
            gnss_std_base=_put(w.gnss_std_base, k, std),
            gnss_valid=_put(w.gnss_valid, k, True),
        )

    def _mechanize_to(self, t: float) -> NavState:
        """Mechanize from the last node state to time t (replays from the
        freshest optimized node, misc.cc:231-284); one-entry memo, since
        the front-end prediction and the keyframe decision ask for the same
        t within one frame."""
        s = self.last_node_state
        ct, cs, cout = self._mech_cache
        if ct == t and cs is s:
            return cout
        if t <= float(s.time) + self.cfg.min_time_interval:
            return s
        if self.cfg.host_predict:
            # camera-rate prediction on the host (float64 numpy mirror of
            # the scan): no device call per frame
            _, dt_a, th_a, dv_a = self.imu.slice_between_np(float(s.time), t)
            # one device-to-host copy of the node state per round
            if self._np_state_cache[0] is not s:
                self._np_state_cache = (s, tuple(
                    self._host(x).astype(np.float64) for x in (s.p, s.q, s.v, s.bg, s.ba)))
            sp, sq, sv, sbg, sba = self._np_state_cache[1]
            p, q, v = _np_mechanize_series(self._gravity, self._iewn, sp, sq, sv, sbg, sba,
                                           dt_a, th_a, dv_a)
            out = NavState(time=t, p=p, q=q, v=v, bg=sbg, ba=sba)
        else:
            states = mech.mechanize_scan(self.params, s, self._imu_slice(float(s.time), t))
            out = states.index(-1)
        self._mech_cache = (t, s, out)
        return out

    def _preintegrate(self, state_prev: NavState, t0: float, t1: float):
        """Preintegrate the IMU of (t0, t1] from ``state_prev``, with the
        odometer at the window's scale when one is configured."""
        imu = self._imu_slice(t0, t1)
        with self._timed("preintegrate"):
            if self.use_odo:
                return preintegrate_odo(self.params, self.odo_params, state_prev,
                                        self.window.sodo, imu, self._odo_increments(imu))
            return preintegrate(self.params, state_prev, imu)

    def _add_time_node(self, t: float, is_kf: bool):
        """Preintegrate from the previous node and append a node at t
        (addNewTimeNode, ic_gvins.cc:931-962). An interval longer than the
        JAX package's slice capacity or the reference's 10 s maximum is
        broken into intermediate plain time nodes first."""
        max_span = min(
            0.8 * self.cfg.max_imu_per_interval / self.cfg.imudatarate,
            self.cfg.max_preint_length,
        )
        while t - self.node_times[-1] > max_span:
            self._add_time_node_single(self.node_times[-1] + max_span, False)
            # keep a free slot for the real node (and its successor)
            while self.n_nodes > self.cfg.max_nodes - 2:
                self._marginalize_oldest()
        self._add_time_node_single(t, is_kf)

    def _add_time_node_single(self, t: float, is_kf: bool):
        i = self.n_nodes - 1
        data = self._preintegrate(self.window.nodes.index(i), self.node_times[-1], t)
        new_state = data.end_state
        self._append_node(new_state, is_kf)
        w = self.window
        self.window = w._replace(preint=_put(w.preint, i, data),
                                 preint_valid=_put(w.preint_valid, i, True))
        self.last_node_state = new_state
        self.cur_state = new_state

    def _process_gnss_node(self):
        t, p, std = self.gnss_queue[-1]
        if abs(t - self.node_times[-1]) < self.cfg.min_sync_interval:
            # same time node: attach the fix to the newest node
            self._set_gnss(self.n_nodes - 1, p, std)
            self._optimize_round()
            return
        if t < self.node_times[-1]:
            # late fix inside the window (insertNewGnssTimeNode)
            self._insert_gnss_node(t, p, std)
            return
        if self.imu.time[-1] < t:
            return  # wait for IMU coverage
        self._add_time_node(t, is_kf=False)
        self._set_gnss(self.n_nodes - 1, p, std)
        self._optimize_round()

    def _attach_gnss(self, k: int, t: float, p, std, inflate=1.0):
        """Attach a fix to node k, velocity-compensating the position for
        the time offset (ic_gvins.cc:864-891: p + v dt, std x 1.2)."""
        v = self._npw("nodes.v")[k]
        dt = self.node_times[k] - t
        self._set_gnss(k, np.asarray(p) + v * dt, np.asarray(std) * inflate)

    def _insert_gnss_node(self, t: float, p, std):
        """Late fix with t inside the window: align to an adjacent node
        within the sync interval, else split the enclosing preintegration
        and insert a GNSS node, shifting the window tail up."""
        k = None
        for j in range(len(self.node_times) - 1, 0, -1):
            if self.node_times[j - 1] < t <= self.node_times[j]:
                k = j
                break
        if k is None:
            return  # older than the window head: drop
        if t - self.node_times[k - 1] < self.cfg.min_sync_interval:
            self._attach_gnss(k - 1, t, p, std, inflate=1.2)
        elif self.node_times[k] - t < self.cfg.min_sync_interval:
            self._attach_gnss(k, t, p, std, inflate=1.2)
        else:
            if float(self.window.preint.dt[k - 1]) > self.cfg.max_preint_length:
                self.dropped_gnss += 1
                LOGW(f"GNSS fix at {t:.3f} dropped: enclosing preintegration too long")
                return
            if self.n_nodes >= self.cfg.max_nodes - 1:
                # no free slot: marginalize the oldest node first (which
                # shifts every node index down by one)
                if k > 1 and self.n_nodes > 2:
                    origin_before = self.origin.copy()
                    self._marginalize_oldest()
                    k -= 1
                    p = np.asarray(p) - (self.origin - origin_before)
                if self.n_nodes >= self.cfg.max_nodes - 1 or k < 1:
                    self.dropped_gnss += 1
                    LOGW(f"GNSS fix at {t:.3f} dropped: window at capacity")
                    return
            self.window, self.prior = insert_node(self.window, self.prior, k, self.n_nodes)
            self.node_times.insert(k, t)
            self.node_is_kf.insert(k, False)
            self.n_nodes += 1
            # split the preintegration: [k-1 -> t] and [t -> k+1]
            data0 = self._preintegrate(self.window.nodes.index(k - 1),
                                       self.node_times[k - 1], t)
            new_state = data0.end_state
            self.window = self.window._replace(nodes=_put(self.window.nodes, k, new_state))
            data1 = self._preintegrate(new_state, t, self.node_times[k + 1])
            w = self.window
            self.window = w._replace(
                preint=_put(_put(w.preint, k - 1, data0), k, data1),
                preint_valid=_put(_put(w.preint_valid, k - 1, True), k, True),
            )
            self._attach_gnss(k, t, p, std)
        self._optimize_round()

    # ------------------------------------------------------------------
    # vision ingest: observations from the front end
    # ------------------------------------------------------------------

    def add_frame_observations(self, t, ids, uv, vel=None, force_kf=None):
        """A tracked frame: landmark ids + normalized-plane observations
        (and their velocities); its host wall, less the stages it ran, goes
        to ``feed_ms``."""
        t0, staged = _time.perf_counter(), self._staged_ms
        self.counters["frames"] += 1
        self.counters["tracks"] += len(ids)
        self._add_frame(t, ids, uv, vel, force_kf)
        self.feed_ms.append((_time.perf_counter() - t0) * 1e3 - (self._staged_ms - staged))

    def _add_frame(self, t, ids, uv, vel, force_kf):
        if self.state == INITIALIZING:
            return
        t = float(t)
        if self.imu.time[-1] < t:
            # ahead of IMU coverage: defer until add_imu covers the stamp
            bisect.insort(
                self.pending_events,
                (t, "frame", list(ids), np.array(uv, np.float64),
                 None if vel is None else np.array(vel, np.float64), force_kf),
                key=lambda e: e[0],
            )
            return
        self._dispatch_frame(t, ids, uv, vel, force_kf)

    def _dispatch_frame(self, t, ids, uv, vel, force_kf):
        if self.state == INITIALIZING_INS:
            # vision joins after initlength GINS rounds and once the GINS
            # solution is steady (the available newest-node GNSS chi2, up
            # to the last 3 rounds, below the 3-dof 95% gate), or after
            # vio_join_max_wait_rounds blocked attempts
            if self.n_nodes - 1 < max(1, int(self.cfg.initlength)):
                return
            if self.cfg.vio_join_require_steady and not (
                len(self._gins_chi2) >= 1 and all(c < 7.815 for c in self._gins_chi2)
            ):
                self._vio_join_waits += 1
                if self._vio_join_waits <= self.cfg.vio_join_max_wait_rounds:
                    return
            self.state = INITIALIZING_VIO
        ids = list(map(int, ids))
        uv = np.asarray(uv, np.float64)
        vel = np.zeros_like(uv) if vel is None else np.asarray(vel, np.float64)

        self._kf_kind = "normal"
        is_kf = self._keyframe_decision(t, ids, uv) if force_kf is None else force_kf
        if not is_kf:
            return
        if t < self.node_times[-1] + self.cfg.keyframe_min_interval:
            return
        kf_kind = self._kf_kind

        self._add_time_node(t, is_kf=True)
        self.counters["keyframes"] += 1
        n = self.n_nodes - 1
        w = self.window
        obs_uv = self._host(w.obs_uv).copy()
        obs_vel = self._host(w.obs_vel).copy()
        obs_valid = self._host(w.obs_valid).copy()
        lm_ref = self._host(w.lm_ref).copy()
        lm_valid = self._host(w.lm_valid).copy()
        lm_invd = self._host(w.lm_invdepth).copy()

        for fid, xy, vxy in zip(ids, uv, vel):
            slot = self.lm_slot.get(fid)
            if slot is None:
                if not self.free_slots:
                    self.counters["slot_drops"] += 1
                    continue
                slot = self.free_slots.pop()
                self.counters["slots_taken"] += 1
                self.lm_slot[fid] = slot
                lm_ref[slot] = n
                # factor-eligible only once triangulated (_init_new_depths)
                lm_valid[slot] = False
                lm_invd[slot] = 1.0 / 10.0  # DEFAULT_DEPTH
                self.lm_type[slot] = MAPPOINT_DEPTH_INITIALIZED
            obs_uv[slot, n] = xy
            obs_vel[slot, n] = vxy
            obs_valid[slot, n] = True

        self.window = w._replace(
            obs_uv=self._dev(obs_uv), obs_vel=self._dev(obs_vel),
            obs_valid=self._dev(obs_valid, torch.bool),
            lm_ref=self._dev(lm_ref, w.lm_ref.dtype),
            lm_valid=self._dev(lm_valid, torch.bool),
            lm_invdepth=self._dev(lm_invd),
            frame_td=_put(w.frame_td, n, 0.0),
        )
        self._init_new_depths(n)

        # per-keyframe tracking log (tracking.txt columns, tracking.cc:297-315)
        prev_kf = [i for i in range(n) if self.node_is_kf[i]]
        if prev_kf:
            j = prev_kf[-1]
            p_nodes, q_nodes = self._npw("nodes.p"), self._npw("nodes.q")
            dp = float(np.linalg.norm(p_nodes[n] - p_nodes[j]))
            q_j = q_nodes[j] * np.array([1.0, -1.0, -1.0, -1.0])
            dq = _np_quat_mul(q_j, q_nodes[n])
            ang = float(np.degrees(2.0 * math.atan2(np.linalg.norm(dq[1:]), abs(float(dq[0])))))
            interval = t - self.node_times[j]
        else:
            dp, ang, interval = 0.0, 0.0, 0.0
        n_tracked = sum(1 for fid in ids if fid in self.lm_slot)
        self.track_log.append(dict(
            t=t, interval=interval, parallax=self._last_parallax,
            translation=dp, rotation=ang, n_mappoints=n_tracked, cost_ms=0.0,
        ))

        if self.state == INITIALIZING_VIO:
            # the first visual keyframe joins without a round (ic_gvins.cc:357-366)
            self.state = TRACKING_INITIALIZING
            return
        if self.state == TRACKING_INITIALIZING and self.n_keyframes > self.cfg.optimize_windows_size:
            # window full: normal tracking; ext/td estimation unfreezes
            self.state = TRACKING_NORMAL
        self._optimize_round(remove_node_t=t if kf_kind == "second_new" else None)

    def _keyframe_decision(self, t, ids, uv) -> bool:
        """Mean rotation-compensated parallax against each landmark's last
        stored observation above track_min_parallax, or a long interval
        (then a second-new keyframe), as tracking.cc:263-307."""
        if not any(self.node_is_kf):
            return True
        last_kf_t = max(tt for tt, k in zip(self.node_times, self.node_is_kf) if k)
        obs_uv = self._npw("obs_uv")
        obs_valid = self._npw("obs_valid")
        idxs, slots, k_lasts = [], [], []
        for i, fid in enumerate(ids):
            slot = self.lm_slot.get(fid)
            if slot is None or not obs_valid[slot].any():
                continue
            idxs.append(i)
            slots.append(slot)
            k_lasts.append(np.nonzero(obs_valid[slot])[0][-1])
        if not idxs:
            self._last_parallax = 0.0
        else:
            s_cur = self._mechanize_to(t)
            ext_q = self._npw("ext_q")
            r1 = _np_quat_to_matrix(_np_quat_mul(self._host(s_cur.q), ext_q))
            k_lasts = np.asarray(k_lasts)
            q_nodes = self._npw("nodes.q")[k_lasts]
            r0 = _np_quat_to_matrix(_np_quat_mul(q_nodes, ext_q[None, :]))
            xy0 = obs_uv[np.asarray(slots), k_lasts]
            h0 = np.concatenate([xy0, np.ones((len(idxs), 1))], 1)
            # the ref bearing rotated into the current view (keyPointParallax)
            pc01 = np.einsum("ji,kj->ki", r1, np.einsum("kij,kj->ki", r0, h0))
            xy1 = np.asarray(uv)[np.asarray(idxs)]
            ds = np.linalg.norm(pc01[:, :2] - xy1, axis=-1) * self._focal
            self._last_parallax = float(np.mean(ds))
        if bool(idxs) and self._last_parallax > self.cfg.track_min_parallax:
            self._kf_kind = "normal"
            return True
        if t - last_kf_t > self.cfg.track_max_interval:
            # low parallax over a long interval: a second-new keyframe, which
            # constrains one round and is then removed
            self._kf_kind = "second_new"
            return True
        return False

    def _init_new_depths(self, n):
        """Triangulate landmarks anchored earlier and observed now
        (tracking.cc:690-811, with window poses); only the real
        candidates go to the device."""
        w = self.window
        obs_valid = self._host(w.obs_valid)
        lm_ref = self._host(w.lm_ref).copy()
        lm_valid = self._host(w.lm_valid).copy()
        lm_invd = self._host(w.lm_invdepth).copy()
        slots_in_use = set(self.lm_slot.values())
        cand = []
        reanchored = False
        for lm in range(w.n_landmarks):
            if lm not in slots_in_use or not obs_valid[lm, n]:
                continue
            if not (abs(lm_invd[lm] - 0.1) < 1e-12 and lm_ref[lm] != n):
                continue
            if not obs_valid[lm, lm_ref[lm]]:
                # anchor observation slid out before triangulation: re-anchor
                # on the current frame (tracking.cc:726-733)
                lm_ref[lm] = n
                reanchored = True
                continue
            cand.append(lm)
        if reanchored:
            self.window = w = w._replace(lm_ref=self._dev(lm_ref, w.lm_ref.dtype))
        if not cand:
            return
        cand = np.asarray(cand)
        refs = lm_ref[cand]
        p_nodes, q_nodes = self._npw("nodes.p"), self._npw("nodes.q")

        def cam_pose(k_arr):
            qj, pj = self._dev(q_nodes[k_arr]), self._dev(p_nodes[k_arr])
            return (rot.quat_to_matrix(rot.quat_mul(qj, w.ext_q)),
                    pj + rot.quat_rotate(qj, w.ext_p))

        r0, t0 = cam_pose(refs)
        r1, t1 = cam_pose(np.full(len(cand), n))
        obs_uv = self._npw("obs_uv")
        # the reference's gates in normalized units (tracking.cc:741-757)
        gate_px = self.cfg.triangulate_reproj_gate_px
        if gate_px is None:
            gate_px = self.cfg.reprojection_error_std
        _, invd, ok = triangulate_checked(
            r0, t0, r1, t1, self._dev(obs_uv[cand, refs]), self._dev(obs_uv[cand, n]),
            reproj_thresh=gate_px / self._focal, depth_scale=3.0,
            min_parallax=self.cfg.triangulate_min_parallax / self._focal,
        )
        invd, ok = self._host(invd), self._host(ok)
        lm_invd[cand[ok]] = invd[ok]
        lm_valid[cand[ok]] = True  # triangulated: factor-eligible
        self.lm_type[cand[ok]] = MAPPOINT_TRIANGULATED
        self.window = self.window._replace(lm_invdepth=self._dev(lm_invd),
                                           lm_valid=self._dev(lm_valid, torch.bool))

    # ------------------------------------------------------------------
    # optimization + marginalization round
    # ------------------------------------------------------------------

    def _optimize_round(self, remove_node_t: float | None = None):
        # initialization phase: longer solve, no chi2 culling, until
        # max(warmup_min_preint, initlength) preintegrations
        warming_up = self.n_nodes - 1 < max(self.cfg.warmup_min_preint, int(self.cfg.initlength))
        # extrinsic/time-delay estimation only in normal tracking
        cfg_round = self.solver_cfg
        gate = self.state >= TRACKING_NORMAL
        if self.cfg.optimize_estimate_extrinsic or self.cfg.optimize_estimate_td:
            flag = lambda b: torch.tensor(bool(b), device=self.device)  # noqa: E731
            cfg_round = cfg_round._replace(
                estimate_extrinsic=flag(self.cfg.optimize_estimate_extrinsic and gate),
                estimate_td=flag(self.cfg.optimize_estimate_td and gate),
            )
        t_opt1 = t_opt2 = None
        it = self.cfg.optimize_num_iterations
        with self._timed("optimize"):
            if self.mesh is not None:
                self.window, stats = optimize_sharded(
                    self.window, self.prior, cfg_round, self.params, self.mesh,
                    iters=(30 if warming_up else it), do_cull=not warming_up)
            elif self.cfg.stat_phase_split and not warming_up:
                # the two phases apart, so that each is timed
                t0 = _time.perf_counter()
                self.window, s1p, ncull_p = lm_mod.optimize_phase1(
                    self.window, self.prior, cfg_round, self.params, iters=it)
                self._sync()
                t_opt1 = _time.perf_counter() - t0
                self.window, s2p = lm_mod.optimize_phase2(
                    self.window, self.prior, cfg_round, self.params, iters=it)
                self._sync()
                t_opt2 = _time.perf_counter() - t0 - t_opt1
                stats = (s1p, s2p, ncull_p)
            else:
                self.window, stats = lm_mod.optimize(
                    self.window, self.prior, cfg_round, self.params,
                    iters=(30 if warming_up else it), do_cull=not warming_up)
        t_opt = self.stage_ms["optimize"][-1] / 1e3
        if self.cfg.stat_phase_split and t_opt1 is None:
            t_opt1, t_opt2 = t_opt, 0.0  # warm-up and sharded rounds: unsplit
        s1, s2, ncull = stats
        # per-keyframe statistics (statistics.txt columns, ic_gvins.cc:964-1067)
        r_v = eval_reproj_res(self.window, self.solver_cfg)
        m = self._host(obs_mask(self.window))
        px_err = (np.linalg.norm(self._host(r_v), axis=-1)
                  * float(self.solver_cfg.reproj_std) * self._focal)
        errs = px_err[m]
        # extrinsic sanity gate + landmark-level culling (ic_gvins.cc:1260-1270)
        self._extrinsic_gate()
        n_out_lm, n_out_feat = self._outlier_culling(px_err) if not warming_up else (0, 0)
        self.stats.append(dict(
            t=self.node_times[-1],
            cost0=float(s1.cost0),
            cost1=float(s2.cost1),
            iterations=int(s1.accepted) + int(s2.accepted),
            iters_run=int(s1.iters_run) + int(s2.iters_run),
            reproj_min=float(errs.min()) if errs.size else 0.0,
            reproj_max=float(errs.max()) if errs.size else 0.0,
            reproj_mean=float(errs.mean()) if errs.size else 0.0,
            reproj_rms=float(np.sqrt((errs**2).mean())) if errs.size else 0.0,
            n_obs=int(m.sum()),
            culled=int(ncull),
            outlier_mappoints=n_out_lm,
            outlier_features=n_out_feat,
            n_nodes=self.n_nodes,
            timecost_ms=round(t_opt * 1e3, 2),
            # slides follow the round, so their cost lands on the next row
            timecost_marg_ms=round(self._t_marg_accum * 1e3, 2),
            imu_repaired=self.imu_repaired,
            dropped_gnss=self.dropped_gnss,
            **(dict(timecost_opt1_ms=round(t_opt1 * 1e3, 2),
                    timecost_opt2_ms=round(t_opt2 * 1e3, 2))
               if self.cfg.stat_phase_split else {}),
        ))
        self._t_marg_accum = 0.0
        self._maybe_reintegrate()
        # refresh the mechanization origin from the newest optimized node
        self.last_node_state = self.window.nodes.index(self.n_nodes - 1)
        if self.state == INITIALIZING_INS:
            gv = self._npw("gnss_valid")
            if gv.any():
                k = int(np.nonzero(gv)[0][-1])
                r = (
                    self._npw("nodes.p")[k]
                    + _np_quat_rotate(self._npw("nodes.q")[k], np.asarray(self.cfg.antlever))
                    - self._npw("gnss_p")[k]
                ) / np.maximum(self._npw("gnss_std_base")[k], 1e-6)
                self._gins_chi2.append(float(r @ r))
                del self._gins_chi2[:-3]
        self._log_pose()

        # second-new keyframe: removed after its one round, before the
        # slide (ic_gvins.cc:461-475)
        if remove_node_t is not None:
            for i, tt in enumerate(self.node_times):
                if abs(tt - remove_node_t) < 1e-9 and i > 0:
                    self._remove_node(i)
                    break

        # keyframes left empty by outlier culling are removed the same way
        if not warming_up:
            j = 1
            while j < self.n_nodes - 1:
                if (self.node_is_kf[j] and not self._npw("obs_valid")[:, j].any()
                        and not self._npw("gnss_valid")[j]):
                    self._remove_node(j)
                else:
                    j += 1

        # slide while over-full: too many keyframes or node slots nearly
        # exhausted (ic_gvins.cc:472-475)
        while (self.n_keyframes > self.cfg.optimize_windows_size
               or self.n_nodes > self.cfg.max_nodes - 2):
            self._marginalize_oldest()

    def _extrinsic_gate(self):
        """Reject implausible per-round extrinsic jumps (> 1 m or > 5 deg
        from the last accepted calibration), ic_gvins.cc:1354-1364."""
        if not self.cfg.optimize_estimate_extrinsic:
            return
        if self._ext_accepted is None:
            self._ext_accepted = (self.window.ext_p, self.window.ext_q)
            return
        p0, q0 = self._ext_accepted
        dt = float(torch.linalg.norm(self.window.ext_p - p0))
        dq = self._host(rot.quat_mul(rot.quat_inv(q0), self.window.ext_q))
        dr = float(np.degrees(2.0 * math.atan2(np.linalg.norm(dq[1:]), abs(float(dq[0])))))
        if dt > 1.0 or dr > 5.0:
            LOGE(f"Estimated extrinsic is too large, dt={dt:.3f} m, dr={dr:.2f} deg; reverting")
            self.window = self.window._replace(ext_p=p0, ext_q=q0)
        else:
            self._ext_accepted = (self.window.ext_p, self.window.ext_q)

    def _outlier_culling(self, px_err: np.ndarray) -> tuple[int, int]:
        """Landmark-level reprojection culling after the round
        (gvinsOutlierCulling, ic_gvins.cc:1069-1162): observations beyond
        3 sigma go; a bad observation in the anchor frame, fewer than two
        surviving observations or a mean error above sigma kill the
        landmark."""
        w = self.window
        obs_valid = self._npw("obs_valid")
        lm_valid = self._npw("lm_valid")
        lm_ref = self._npw("lm_ref")
        sigma = self.cfg.reprojection_error_std
        bad = obs_valid & lm_valid[:, None] & (px_err > 3.0 * sigma)
        ref_bad = bad[np.arange(px_err.shape[0]), lm_ref]
        surv = obs_valid & ~bad
        nsurv = surv.sum(axis=1)
        avg = (px_err * surv).sum(axis=1) / np.maximum(nsurv, 1)
        kill = lm_valid & (ref_bad | (nsurv < 2) | (avg > sigma))
        n_feat = int(bad.sum())
        n_lm = int(kill.sum())
        if n_feat == 0 and n_lm == 0:
            return 0, 0
        self.window = w._replace(obs_valid=self._dev(surv & ~kill[:, None], torch.bool),
                                 lm_valid=self._dev(lm_valid & ~kill, torch.bool))
        for fid in [f for f, s in self.lm_slot.items() if kill[s]]:
            self._free_lm_slot(fid)
        return n_lm, n_feat

    def _free_lm_slot(self, fid):
        s = self.lm_slot.pop(fid)
        self.free_slots.append(s)
        self.lm_type[s] = MAPPOINT_NONE

    def _remove_node(self, i: int):
        """Remove time node i and re-preintegrate the merged interval
        (removeUnusedTimeNode, ic_gvins.cc:788-823)."""
        n = self.n_nodes
        assert 0 < i < n
        self.window, self.prior = remove_node(self.window, self.prior, i, n)
        was_kf = self.node_is_kf.pop(i)
        self.node_times.pop(i)
        self.n_nodes -= 1
        if was_kf:
            self.n_keyframes -= 1
        # landmark slots anchored at the removed node died in remove_node
        lm_valid = self._npw("lm_valid")
        obs_any = self._npw("obs_valid").any(axis=1)
        for fid in [f for f, s in self.lm_slot.items() if not lm_valid[s] and not obs_any[s]]:
            self._free_lm_slot(fid)
        if i < self.n_nodes:
            # interior removal: slot i-1 now spans node i-1 -> old node i+1
            data = self._preintegrate(self.window.nodes.index(i - 1),
                                      self.node_times[i - 1], self.node_times[i])
            w = self.window
            self.window = w._replace(preint=_put(w.preint, i - 1, data),
                                     preint_valid=_put(w.preint_valid, i - 1, True))
        else:
            # tail removal: mechanization restarts from the new last node
            self.last_node_state = self.window.nodes.index(self.n_nodes - 1)
            self.cur_state = self.last_node_state

    def _maybe_reintegrate(self):
        """Re-preintegrate intervals whose bias linearization drifted more
        than 6 sigma from the current estimate (doReintegration,
        ic_gvins.cc:1715-1737)."""
        n = self.n_nodes
        if n < 2:
            return
        bg_ref = self._host(self.window.preint.bg_ref[: n - 1])
        ba_ref = self._host(self.window.preint.ba_ref[: n - 1])
        bg_now = self._npw("nodes.bg")[: n - 1]
        ba_now = self._npw("nodes.ba")[: n - 1]
        sg = 6.0 * float(self.params.gyr_bias_std)
        sa = 6.0 * float(self.params.acc_bias_std)
        drift = ((np.linalg.norm(bg_now - bg_ref, axis=1) > sg)
                 | (np.linalg.norm(ba_now - ba_ref, axis=1) > sa))
        for i in np.nonzero(drift)[0]:
            i = int(i)
            data = self._preintegrate(self.window.nodes.index(i), self.node_times[i],
                                      self.node_times[i + 1])
            self.window = self.window._replace(preint=_put(self.window.preint, i, data))

    def _marginalize_oldest(self):
        self._sync()
        t0 = _time.perf_counter()
        lm_ref, lm_valid = self._npw("lm_ref"), self._npw("lm_valid")
        dead_slots = [s for s in self.lm_slot.values() if lm_ref[s] == 0 and lm_valid[s]]
        self._save_fixed_mappoints(dead_slots)
        mode = self.cfg.marg_prior_mode
        if mode == "full":
            # reference-parity accumulating marginalization
            self.window, self.prior = marginalize_and_slide(
                self.window, self.prior, self.solver_cfg, self.params,
                self.cfg.prior_forgetting)
        else:
            # slide only; then re-anchor with bounded information ("anchor")
            # or leave no prior ("none")
            self.window, _ = slide_window(
                self.window, empty_prior(self.window.n_nodes, self.dtype, device=self.device))
            if mode == "anchor":
                self.prior = make_init_prior(self.window, self._dev(self.cfg.anchor_pose_std),
                                             self._dev(self.cfg.anchor_mix_std))
            else:
                self.prior = empty_prior(self.window.n_nodes, self.dtype, device=self.device)
        was_kf = self.node_is_kf.pop(0)
        self.node_times.pop(0)
        self.n_nodes -= 1
        # trim the IMU buffer and the odometer samples to the window head
        self.imu.drop_before(self.node_times[0] - 0.05)
        if self.odo_t:
            head = self.node_times[0] - 0.1
            k = 0
            while k < len(self.odo_t) - 2 and self.odo_t[k + 1] < head:
                k += 1
            if k > 0:
                del self.odo_t[:k], self.odo_v[:k]
        if was_kf:
            self.n_keyframes -= 1
        obs_valid = self._npw("obs_valid")
        if dead_slots:
            # the slide keeps the dead landmarks' observations at the other
            # nodes; clear their rows, as remove_node does, so that a new
            # feature given the slot carries only its own
            w = self.window
            dead = np.zeros(w.lm_valid.shape[0], bool)
            dead[dead_slots] = True
            dead = self._dev(dead, torch.bool)[:, None]
            self.window = w._replace(obs_valid=w.obs_valid & ~dead,
                                     obs_uv=w.obs_uv.masked_fill(dead[..., None], 0.0),
                                     obs_vel=w.obs_vel.masked_fill(dead[..., None], 0.0))
            self._dead_cleared["observations"] += int(obs_valid[dead_slots].sum())
            self._dead_cleared["slots"] += len(dead_slots)
            obs_valid = obs_valid.copy()
            obs_valid[dead_slots] = False
        # free landmark slots that died with the marginalized anchor
        dead = set(dead_slots)
        for fid in [f for f, s in self.lm_slot.items() if s in dead]:
            self._free_lm_slot(fid)
        # landmarks anchored at the old node 0 that were not valid yet also
        # die; reclaim any slot with no observation
        lm_valid = self._npw("lm_valid")
        for fid in [f for f, s in self.lm_slot.items()
                    if not lm_valid[s] and obs_valid[s].sum() == 0]:
            self._free_lm_slot(fid)
        self._maybe_recenter()
        # track the Earth rate with the vehicle: refresh at the window head
        self._refresh_earth_params(self._npw("nodes.p")[0])
        self._sync()
        ms = (_time.perf_counter() - t0) * 1e3
        self._stage_done("marginalize", ms)
        self._t_marg_accum += ms / 1e3

    def _save_fixed_mappoints(self, slots):
        """World positions of landmarks leaving the window (mappoint.txt,
        ic_gvins.cc:1704): ref normalized point / invdepth -> camera ->
        body -> world."""
        if not slots:
            return
        slots = np.asarray(slots, np.int64)
        invd = self._npw("lm_invdepth")[slots]
        refs = self._npw("lm_ref")[slots]
        uv = self._npw("obs_uv")[slots, refs]
        ok = (invd > 1.0 / self.cfg.farthest_depth) & (invd < 1.0 / self.cfg.nearest_depth)
        if not ok.any():
            return
        pc = np.concatenate([uv, np.ones((len(slots), 1))], 1) / invd[:, None]
        pb = _np_quat_rotate(self._npw("ext_q")[None, :], pc) + self._npw("ext_p")
        pw = _np_quat_rotate(self._npw("nodes.q")[refs], pb) + self._npw("nodes.p")[refs]
        for x in pw[ok]:
            self.fixed_mappoints.append(np.asarray(x, np.float64) + self.origin)

    def _log_pose(self):
        s = self.last_node_state
        self.traj_times.append(float(s.time))
        self.traj_p.append(self._host(s.p).astype(np.float64) + self.origin)
        self.traj_q.append(self._host(s.q))

    def _maybe_recenter(self):
        """Shift the window so that the oldest node sits at the origin once
        it lies ``recenter_threshold`` away (the float32 precision guard).
        The shift is exact: every residual sees positions only through
        differences (GNSS p + R l - p_gnss, preintegration p1 - p0 - ...
        with the Earth term's cache as sum_dt_pn - dt p0, the prior as
        p - lin_p), so the costs do not change."""
        if self.recenter_threshold <= 0 or self.n_nodes < 1:
            return
        p0 = self._npw("nodes.p")[0].astype(np.float64)
        if float(np.linalg.norm(p0)) < self.recenter_threshold:
            return
        w = self.window
        sh = self._dev(p0)
        pre = w.preint._replace(
            sum_dt_pn=w.preint.sum_dt_pn - w.preint.dt[:, None] * sh,
            end_state=w.preint.end_state._replace(p=w.preint.end_state.p - sh),
        )
        self.window = w._replace(nodes=w.nodes._replace(p=w.nodes.p - sh),
                                 gnss_p=w.gnss_p - sh, preint=pre)
        self.prior = self.prior._replace(
            lin_nodes=self.prior.lin_nodes._replace(p=self.prior.lin_nodes.p - sh))
        if self.last_node_state is not None:
            self.last_node_state = self.last_node_state._replace(
                p=self.last_node_state.p - sh)
        if self.cur_state is not None:
            self.cur_state = self.cur_state._replace(p=self.cur_state.p - sh)
        self.gnss_queue = [(t, p - p0, s) for t, p, s in self.gnss_queue]
        self.origin += p0
        self.n_recenters += 1

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def current_state(self) -> NavState | None:
        return self.cur_state

    def predicted_state(self, t: float) -> NavState | None:
        """INS-mechanized state at t (front-end pose prediction,
        ``MISC::getCameraPoseFromInsWindow``)."""
        if self.state == INITIALIZING:
            return None
        return self._mechanize_to(t)

    def _npw(self, name: str) -> np.ndarray:
        """Host (numpy) copy of a window field, cached per window object:
        the per-frame paths run at camera rate, the window changes only at
        rounds, and every update makes a new Window."""
        cache = self._np_cache
        w = self.window
        if cache.get("_id") is not w:
            cache.clear()
            cache["_id"] = w
        if name not in cache:
            val = getattr(w.nodes, name[6:]) if name.startswith("nodes.") else getattr(w, name)
            cache[name] = self._host(val)
        return cache[name]

    def landmark_positions(self, ids):
        """World positions (local frame) of the triangulated landmarks
        among the given feature ids: ``(pw [n,3], ok [n])``, for the front
        end's full-pose LK seed (tracking.cc:367-378)."""
        n = len(ids)
        pw = np.zeros((n, 3), np.float64)
        ok = np.zeros(n, bool)
        if n == 0 or self.state == INITIALIZING:
            return pw, ok
        lm_valid = self._npw("lm_valid")
        lm_invd = self._npw("lm_invdepth")
        lm_ref = self._npw("lm_ref")
        idxs, slots = [], []
        for i, fid in enumerate(np.asarray(ids)):
            s = self.lm_slot.get(int(fid))
            if s is None or not lm_valid[s]:
                continue
            invd = lm_invd[s]
            # 1/DEFAULT_DEPTH = not triangulated yet; depth gates isGoodDepth
            if abs(invd - 0.1) < 1e-12:
                continue
            if not (1.0 / self.cfg.farthest_depth < invd < 1.0 / self.cfg.nearest_depth):
                continue
            idxs.append(i)
            slots.append(s)
        if not idxs:
            return pw, ok
        idxs = np.asarray(idxs)
        slots = np.asarray(slots)
        refs = lm_ref[slots]
        uv = self._npw("obs_uv")[slots, refs]
        pc = np.concatenate([uv, np.ones((len(slots), 1))], 1) / lm_invd[slots][:, None]
        pb = _np_quat_rotate(self._npw("ext_q")[None, :], pc) + self._npw("ext_p")
        pw[idxs] = _np_quat_rotate(self._npw("nodes.q")[refs], pb) + self._npw("nodes.p")[refs]
        ok[idxs] = True
        return pw, ok

    def trajectory(self):
        return (
            np.asarray(self.traj_times),
            np.stack(self.traj_p) if self.traj_p else np.zeros((0, 3)),
            np.stack(self.traj_q) if self.traj_q else np.zeros((0, 4)),
        )
