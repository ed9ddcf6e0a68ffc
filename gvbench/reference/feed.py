"""The intake of one tracked frame into the window, as the estimator's
``add_frame_observations`` runs it once tracking is under way: the
keyframe decision, the keyframe's node, its landmark slots and
observation rows, and the triangulation of new depths. Plain PyTorch for
the arithmetic (mechanization, preintegration, triangulation), numpy for
the host's bookkeeping (slots and rows); it imports nothing of the
program.

From IC-GVINS (github.com/i2Nav-WHU/IC-GVINS), ``tracking/tracking.cc``:
the keyframe decision of 263-307 (the mean rotation-compensated parallax
of the tracked features against each one's last stored observation,
``keyPointParallax`` 861-922, over ``track_min_parallax``; else a "second
new" keyframe once ``track_max_interval`` has passed); the triangulation
of 690-811 (a landmark anchored earlier and observed now; one whose
anchor observation has gone is re-anchored on the current frame, 726-733;
the depth, reprojection and parallax gates of 741-757). Departures, each
the port's and kept here so that the two agree:

* a landmark is a slot of a fixed table (``max_landmarks``): a new track
  takes the slot freed last, and a keyframe drops a new track when no slot
  is free (IC-GVINS keeps every map point);
* a landmark awaits triangulation while its inverse depth is the default
  depth's (1 / 10 m) and its anchor is another node;
* the two-view DLT fixes the homogeneous scale (h3 = 1) and solves the
  4 x 3 least squares, here by ``torch.linalg.solve`` of its normal
  equations; IC-GVINS takes the null vector of the 4 x 4 system by SVD
  (800-811);
* keyframes come no closer than ``keyframe_min_interval``.
"""

from typing import NamedTuple

import numpy as np
import torch

from .common import rotation as rot
from .data.types import NavState
from .ins.mechanization import mechanize_scan
from .ins.preintegration import preintegrate

DEFAULT_DEPTH = 10.0
NEAREST_DEPTH = 1.0
FARTHEST_DEPTH = 200.0
DEPTH_SCALE = 3.0  # triangulated depths up to FARTHEST_DEPTH times this


class Before(NamedTuple):
    """The program's state before the call: the window (tensors), the
    integration parameters, the mechanization's origin (the last node's
    state), and the host's node and slot bookkeeping."""

    window: tuple
    params: tuple
    last_state: NavState
    node_times: list
    node_is_kf: list
    lm_slot: dict
    free_slots: list


class Intake(NamedTuple):
    """What the intake decided and wrote: the keyframe decision and its
    kind, the window's landmark rows after it (None without a keyframe)
    and the slot map."""

    keyframe: bool
    kind: str
    rows: dict | None
    lm_slot: dict


ROWS = ("obs_uv", "obs_vel", "obs_valid", "lm_ref", "lm_valid", "lm_invdepth")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _quat_to_matrix_np(q):
    return _np(rot.quat_to_matrix(torch.as_tensor(q, dtype=torch.float64)))


def _quat_mul_np(a, b):
    return _np(rot.quat_mul(torch.as_tensor(a, dtype=torch.float64),
                            torch.as_tensor(b, dtype=torch.float64)))


def keyframe_decision(b: Before, t, ids, uv, eng: dict, imu_of) -> tuple[bool, str]:
    """(keyframe, kind): ``kind`` is "normal" or "second_new"."""
    if not any(b.node_is_kf):
        return True, "normal"
    w = b.window
    last_kf_t = max(tt for tt, k in zip(b.node_times, b.node_is_kf) if k)
    obs_uv, obs_valid = _np(w.obs_uv), _np(w.obs_valid)
    idx, slots, k_last = [], [], []
    for i, fid in enumerate(ids):
        s = b.lm_slot.get(int(fid))
        if s is None or not obs_valid[s].any():
            continue
        idx.append(i)
        slots.append(s)
        k_last.append(int(np.nonzero(obs_valid[s])[0][-1]))
    focal = 0.5 * (eng["cam"]["intrinsic"][0] + eng["cam"]["intrinsic"][1])
    if idx:
        ext_q = _np(w.ext_q)
        q_cur = _np(mechanize_to(b, t, eng, imu_of).q)
        r1 = _quat_to_matrix_np(_quat_mul_np(q_cur, ext_q))
        r0 = _quat_to_matrix_np(_quat_mul_np(_np(w.nodes.q)[k_last], ext_q[None]))
        xy0 = obs_uv[slots, k_last]
        h0 = np.concatenate([xy0, np.ones((len(idx), 1))], 1)
        # keyPointParallax: the stored bearing rotated into the current
        # view, against the current point (not re-normalized to z = 1)
        pc01 = (r1.T @ np.einsum("kij,kj->ki", r0, h0).T).T
        parallax = float(np.mean(np.linalg.norm(pc01[:, :2] - np.asarray(uv)[idx], axis=-1))
                         * focal)
        if parallax > eng["track_min_parallax"]:
            return True, "normal"
    if t - last_kf_t > eng["track_max_interval"]:
        return True, "second_new"
    return False, "normal"


def mechanize_to(b: Before, t, eng: dict, imu_of) -> NavState:
    """The INS state at ``t`` from the last node's (``imu_of(t0, t1)``: the
    IMU series covering the interval)."""
    s = b.last_state
    if t <= float(s.time) + eng["min_time_interval"]:
        return s
    states = mechanize_scan(b.params, s, imu_of(float(s.time), t))
    return NavState(*(x[-1] for x in states))


def intake(b: Before, t, ids, uv, vel, eng: dict, imu_of) -> Intake:
    """The intake of the frame at ``t`` with its tracks (``ids``, ``uv``,
    ``vel``, host arrays) from the state ``b``."""
    keyframe, kind = keyframe_decision(b, t, ids, uv, eng, imu_of)
    if keyframe and t < b.node_times[-1] + eng["keyframe_min_interval"]:
        keyframe = False
    if not keyframe:
        return Intake(False, kind, None, dict(b.lm_slot))
    w = b.window
    n = len(b.node_times)  # the keyframe's node
    # the node: the last node's state preintegrated to t
    last = NavState(*(x[n - 1] for x in w.nodes))
    node = preintegrate(b.params, last, imu_of(b.node_times[-1], t)).end_state

    rows = {k: _np(getattr(w, k)).copy() for k in ROWS}
    lm_slot, free = dict(b.lm_slot), list(b.free_slots)
    for fid, xy, v in zip(ids, np.asarray(uv, np.float64), np.asarray(vel, np.float64)):
        fid = int(fid)
        s = lm_slot.get(fid)
        if s is None:
            if not free:
                continue  # no free slot: the new track is dropped
            s = free.pop()
            lm_slot[fid] = s
            rows["lm_ref"][s] = n
            rows["lm_valid"][s] = False
            rows["lm_invdepth"][s] = 1.0 / DEFAULT_DEPTH
        rows["obs_uv"][s, n] = xy
        rows["obs_vel"][s, n] = v
        rows["obs_valid"][s, n] = True
    _triangulate(rows, lm_slot, w, node, n, eng)
    return Intake(True, kind, rows, lm_slot)


def _triangulate(rows, lm_slot, w, node, n, eng):
    """New depths for the landmarks anchored earlier and observed at node
    ``n`` (in place in ``rows``)."""
    obs_valid, lm_ref = rows["obs_valid"], rows["lm_ref"]
    invd, lm_valid = rows["lm_invdepth"], rows["lm_valid"]
    cand = []
    for s in sorted(set(lm_slot.values())):
        if not obs_valid[s, n] or not (abs(invd[s] - 1.0 / DEFAULT_DEPTH) < 1e-12
                                       and lm_ref[s] != n):
            continue
        if not obs_valid[s, lm_ref[s]]:
            lm_ref[s] = n  # the anchor observation has gone: re-anchor
            continue
        cand.append(s)
    if not cand:
        return
    cand = np.asarray(cand)
    refs = lm_ref[cand]
    dev, dt = w.nodes.p.device, torch.float64
    ext_p, ext_q = w.ext_p.to(dt), w.ext_q.to(dt)
    p = w.nodes.p.to(dt).clone()
    q = w.nodes.q.to(dt).clone()
    p[n], q[n] = node.p.to(dt), node.q.to(dt)

    def cam(k):
        k = torch.as_tensor(k, device=dev)
        qk = q[k]
        return rot.quat_to_matrix(rot.quat_mul(qk, ext_q)), p[k] + rot.quat_rotate(qk, ext_p)

    r0, t0 = cam(refs)
    r1, t1 = cam(np.full(len(cand), n))
    uv = torch.as_tensor(rows["obs_uv"], dtype=dt, device=dev)
    xy0 = uv[torch.as_tensor(cand, device=dev), torch.as_tensor(refs, device=dev)]
    xy1 = uv[torch.as_tensor(cand, device=dev), n]
    focal = 0.5 * (eng["cam"]["intrinsic"][0] + eng["cam"]["intrinsic"][1])
    gate_px = eng["triangulate_reproj_gate_px"]
    if gate_px is None:
        gate_px = eng["reprojection_error_std"]
    d0, ok = two_view(r0, t0, r1, t1, xy0, xy1, gate_px / focal,
                      eng["triangulate_min_parallax"] / focal)
    d0, ok = _np(d0), _np(ok)
    invd[cand[ok]] = 1.0 / d0[ok]
    lm_valid[cand[ok]] = True


def two_view(r0, t0, r1, t1, xy0, xy1, reproj_gate, min_parallax):
    """Depth in the first view of the point two views see (camera->world
    rotations and centres, normalized points), and whether it passes the
    gates: depth in (NEAREST_DEPTH, FARTHEST_DEPTH x DEPTH_SCALE) in both
    views, reprojection under ``reproj_gate`` in both, and the
    rotation-compensated parallax at least ``min_parallax``."""
    rows = []
    for r, c, xy in ((r0, t0, xy0), (r1, t1, xy1)):
        rt = r.transpose(-1, -2)
        proj = torch.cat([rt, -(rt @ c[..., None])], -1)  # [K, 3, 4] world -> camera
        rows += [xy[:, 0, None] * proj[:, 2] - proj[:, 0], xy[:, 1, None] * proj[:, 2] - proj[:, 1]]
    a = torch.stack(rows, 1)  # [K, 4, 4]
    m, y = a[..., :3], -a[..., 3]
    pw = torch.linalg.solve(m.transpose(-1, -2) @ m, (m.transpose(-1, -2) @ y[..., None]))[..., 0]
    pc0 = (r0.transpose(-1, -2) @ (pw - t0)[..., None])[..., 0]
    pc1 = (r1.transpose(-1, -2) @ (pw - t1)[..., None])[..., 0]
    far = FARTHEST_DEPTH * DEPTH_SCALE
    ok = ((pc0[:, 2] > NEAREST_DEPTH) & (pc0[:, 2] < far) & (pc1[:, 2] > NEAREST_DEPTH)
          & (pc1[:, 2] < far))
    for pc, xy in ((pc0, xy0), (pc1, xy1)):
        ok &= torch.linalg.norm(pc[:, :2] / pc[:, 2:] - xy, dim=-1) < reproj_gate
    if min_parallax > 0:
        h1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], -1)
        h10 = ((r0.transpose(-1, -2) @ r1) @ h1[..., None])[..., 0]
        ok &= torch.linalg.norm(h10[:, :2] / h10[:, 2:] - xy0, dim=-1) >= min_parallax
    return pc0[:, 2], ok
