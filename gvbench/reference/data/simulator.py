# Frozen copy of ic_gvins_tpu_torch/data/simulator.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Synthetic GNSS / IMU / camera data (``data/simulator.py``).

The repository ships no dataset, so its validation runs build their
streams here: an analytic trajectory in the local NED n-frame, from which
the IMU increments follow by differentiating the kinematics (forward-mode
``torch.func.jvp``, exact derivatives, not finite differences), with the
Earth-rotation terms of the mechanization (``misc.cc:204-223``):

    gyro rate   w_ib^b = w_nb^b + R(q)^T w_ie^n
    accel rate  f^b    = R(q)^T (a_n - g_n + 2 w_ie^n x v_n)

so that mechanizing the clean increments reproduces the trajectory to the
integrator's order. Increments integrate the rates over each IMU interval
by 4-point Gauss-Legendre quadrature, all nodes of all samples in batches
on the device. GNSS fixes apply the antenna lever arm as the reference
does (``gnss_factor.h:60``).

Every function takes a batch of times and computes on the device of its
inputs (``default_params`` and ``urban_route`` place them, on ``cuda:0``
unless told otherwise). The random ones draw from a CPU
``torch.Generator`` (the same streams on every device) and also accept the
pre-drawn arrays instead (``noise``, ``draws``): with the JAX package's
``jax.random`` draws passed in, they return its streams.
"""

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jvp

from ..common import rotation as rot
from ..device import resolve_device
from .types import Gnss, ImuSeq, IntegrationParams, NavState

# 4-point Gauss-Legendre nodes and weights on [0, 1]
_GL_NODES = (0.069431844202974, 0.330009478207572, 0.669990521792428, 0.930568155797026)
_GL_WEIGHTS = (0.173927422568727, 0.326072577431273, 0.326072577431273, 0.173927422568727)
# time points per batch of the rate evaluation
CHUNK = 1 << 17


class Trajectory(NamedTuple):
    """Analytic trajectory: position and Euler attitude as functions of a
    batch of times t [...] -> [..., 3]."""

    pos: Callable[[torch.Tensor], torch.Tensor]  # NED position
    euler: Callable[[torch.Tensor], torch.Tensor]  # roll, pitch, yaw


def time_grid(t0: float, n: int, rate: float, first: int = 0, device=None) -> torch.Tensor:
    """Stamps t0 + (k + first) / rate for k < n, float64 on ``device``. The
    division runs on the host: for a scalar divisor CUDA multiplies by its
    reciprocal, which rounds otherwise than the JAX package's division."""
    return torch.from_numpy(t0 + (np.arange(n) + first) / rate).to(device)


def _d(fn, t):
    """(fn(t), d fn / dt) for a function that is elementwise in the times."""
    return jvp(fn, (t,), (torch.ones_like(t),))


def car_trajectory(speed: float = 8.0, turn_period: float = 60.0, turn_amp: float = 0.6,
                   bump_amp: float = 0.05, roll_amp: float = 0.005,
                   pitch_amp: float = 0.004) -> Trajectory:
    """A smooth car-like run: forward at ~speed with a serpentine heading
    and small roll / pitch, shaped after the KAIST urban drives."""
    w = 2 * math.pi / turn_period

    def pos(t):
        x = speed * t
        y = (speed * turn_amp / w) * (1.0 - torch.cos(w * t))
        z = bump_amp * torch.sin(2 * math.pi * t / 7.3)
        return torch.stack([x, y, z], -1)

    def euler(t):
        # yaw follows the path tangent; roll and pitch a few tenths of a degree
        s = turn_amp * torch.sin(w * t)
        yw = torch.atan2(s, torch.ones_like(s))
        r = roll_amp * torch.sin(2 * math.pi * t / 11.0)
        p = pitch_amp * torch.sin(2 * math.pi * t / 5.0)
        return torch.stack([r, p, yw], -1)

    return Trajectory(pos=pos, euler=euler)


class UrbanRoute(NamedTuple):
    """Piecewise closed-form urban drive (KAIST urban38 scale): straights
    with cosine speed ramps, constant-speed arcs (corners, U-turns) and
    dwells (traffic stops). Velocity is continuous across junctions; the
    acceleration steps there, like a car's jerk."""

    t0: torch.Tensor  # [S] segment start times
    kind: torch.Tensor  # [S] 0 = straight (ramp), 1 = arc
    p0: torch.Tensor  # [S, 2] start xy (NED north / east)
    yaw0: torch.Tensor  # [S] start heading (continuous, unwrapped)
    v0: torch.Tensor  # [S] entry speed
    v1: torch.Tensor  # [S] exit speed (straights; == v0 for arcs)
    omega: torch.Tensor  # [S] yaw rate (arcs; 1.0 for straights)
    dur: torch.Tensor  # [S] duration
    d0: torch.Tensor  # [S] distance travelled at the segment's start
    total_time: float
    total_dist: float


def urban_route(seed: int = 0, duration: float = 2154.0,
                cruise_range: tuple = (6.0, 11.0), turn_speed: float = 4.5,
                block_range: tuple = (150.0, 450.0), radius_range: tuple = (10.0, 22.0),
                stop_prob: float = 0.30, dwell_range: tuple = (8.0, 20.0),
                uturn_prob: float = 0.08, initial_dwell: float = 8.0,
                device=None) -> UrbanRoute:
    """Plan a deterministic urban drive until ``duration`` is covered (the
    defaults aim at KAIST urban38: 2154 s, city blocks with 90-degree
    corners, some U-turns, stops at lights; ``README.md:131``). Planned on
    the host with ``np.random.RandomState(seed)``, in float64, so that a
    seed gives the JAX package's route bit for bit."""
    rng = np.random.RandomState(seed)
    segs = []  # (kind, v0, v1, omega, dur)
    t = 0.0

    def add(kind, v0, v1, omega, dur):
        nonlocal t
        if dur <= 1e-6:
            return
        segs.append((kind, v0, v1, omega, dur))
        t += dur

    # a static start (the leveling and bias window), then pull away
    if initial_dwell > 0:
        add(0, 0.0, 0.0, 1.0, initial_dwell)
    add(0, 0.0, turn_speed, 1.0, 6.0)
    v_cur = turn_speed
    while t < duration:
        v_cruise = rng.uniform(*cruise_range)
        block = rng.uniform(*block_range)
        # ramp to cruise over 40% of the block, down to the junction over 60%
        l1, l2 = 0.4 * block, 0.6 * block
        add(0, v_cur, v_cruise, 1.0, 2 * l1 / (v_cur + v_cruise))
        if rng.uniform() < stop_prob:
            # a stop mid-block: brake to 0, dwell, pull away
            l_stop = min(0.5 * l2, 40.0)
            add(0, v_cruise, 0.0, 1.0, 2 * l_stop / v_cruise)
            add(0, 0.0, 0.0, 1.0, rng.uniform(*dwell_range))
            add(0, 0.0, v_cruise, 1.0, 2 * l_stop / v_cruise)
            l2 = max(l2 - 2 * l_stop, 20.0)
        add(0, v_cruise, turn_speed, 1.0, 2 * l2 / (v_cruise + turn_speed))
        # the junction: a +-90 degree corner, sometimes a U-turn
        ang = np.pi if rng.uniform() < uturn_prob else np.pi / 2
        sgn = 1.0 if rng.uniform() < 0.5 else -1.0
        radius = rng.uniform(*radius_range)
        omega = sgn * turn_speed / radius
        add(1, turn_speed, turn_speed, omega, ang / abs(omega))
        v_cur = turn_speed

    # junction states, integrated on the host in float64
    n = len(segs)
    kind = np.array([s[0] for s in segs], np.int32)
    v0 = np.array([s[1] for s in segs])
    v1 = np.array([s[2] for s in segs])
    omega = np.array([s[3] for s in segs])
    dur = np.array([s[4] for s in segs])
    t0 = np.concatenate([[0.0], np.cumsum(dur)[:-1]])
    p0 = np.zeros((n + 1, 2))
    yaw0 = np.zeros(n + 1)
    d0 = np.zeros(n + 1)
    for i in range(n):
        if kind[i] == 0:
            d = 0.5 * (v0[i] + v1[i]) * dur[i]
            p0[i + 1] = p0[i] + d * np.array([np.cos(yaw0[i]), np.sin(yaw0[i])])
            yaw0[i + 1] = yaw0[i]
        else:
            y1 = yaw0[i] + omega[i] * dur[i]
            r = v0[i] / omega[i]
            p0[i + 1] = p0[i] + r * np.array([np.sin(y1) - np.sin(yaw0[i]),
                                              np.cos(yaw0[i]) - np.cos(y1)])
            yaw0[i + 1] = y1
            d = v0[i] * dur[i]
        d0[i + 1] = d0[i] + d
    dev = resolve_device(device)
    f = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return UrbanRoute(t0=f(t0), kind=f(kind), p0=f(p0[:-1]), yaw0=f(yaw0[:-1]), v0=f(v0),
                      v1=f(v1), omega=f(omega), dur=f(dur), d0=f(d0[:-1]),
                      total_time=float(t0[-1] + dur[-1]), total_dist=float(d0[-1]))


def _route_eval(route: UrbanRoute, t):
    """(xy [..., 2], yaw [...], distance [...]) at the times t, in closed
    form. The segment index comes from the detached times; the offset in
    the segment is clipped with ``maximum`` / ``minimum``, whose derivative
    at a tie is 1/2, as ``jnp.clip``'s (``torch.clamp``'s is 1)."""
    i = (torch.searchsorted(route.t0, t.detach(), right=True) - 1).clamp(0, len(route.t0) - 1)
    v0, v1, T = route.v0[i], route.v1[i], route.dur[i]
    tau = torch.minimum(torch.maximum(t - route.t0[i], torch.zeros_like(t)), T)
    # straight: cosine speed ramp v0 -> v1, closed-form distance
    d_str = v0 * tau + 0.5 * (v1 - v0) * (tau - (T / math.pi) * torch.sin(math.pi * tau / T))
    yaw0 = route.yaw0[i]
    xy_str = route.p0[i] + d_str[..., None] * torch.stack([torch.cos(yaw0), torch.sin(yaw0)], -1)
    # arc: constant speed and yaw rate (omega is 1.0 on straights, no 0 division)
    w = route.omega[i]
    yaw_arc = yaw0 + w * tau
    r = v0 / w
    xy_arc = route.p0[i] + r[..., None] * torch.stack(
        [torch.sin(yaw_arc) - torch.sin(yaw0), torch.cos(yaw0) - torch.cos(yaw_arc)], -1)
    d_arc = v0 * tau
    is_arc = route.kind[i] == 1
    xy = torch.where(is_arc[..., None], xy_arc, xy_str)
    yaw = torch.where(is_arc, yaw_arc, yaw0)
    dist = route.d0[i] + torch.where(is_arc, d_arc, d_str)
    return xy, yaw, dist


def urban_trajectory(route: UrbanRoute, bump_amp: float = 0.04, roll_amp: float = 0.006,
                     pitch_amp: float = 0.005) -> Trajectory:
    """Trajectory over an ``UrbanRoute``. Bumps, roll and pitch are
    functions of the distance travelled, so they freeze at stops, where the
    ZUPT detector sees true standstill (``ic_gvins.cc:644-660``)."""

    def pos(t):
        xy, _, dist = _route_eval(route, t)
        z = bump_amp * torch.sin(2 * math.pi * dist / 23.0)
        return torch.cat([xy, z[..., None]], -1)

    def euler(t):
        _, yaw, dist = _route_eval(route, t)
        r = roll_amp * torch.sin(2 * math.pi * dist / 31.0)
        p = pitch_amp * torch.sin(2 * math.pi * dist / 17.0)
        return torch.stack([r, p, yaw], -1)

    return Trajectory(pos=pos, euler=euler)


def static_trajectory() -> Trajectory:
    """A platform at rest (ZUPT and initialization tests)."""
    zero = lambda t: torch.zeros(t.shape + (3,), dtype=t.dtype, device=t.device) * t[..., None]  # noqa: E731
    return Trajectory(pos=zero, euler=zero)


def _quat(traj: Trajectory):
    return lambda t: rot.euler_to_quat(traj.euler(t))


def truth_state(traj: Trajectory, params: IntegrationParams, t: torch.Tensor) -> NavState:
    """Ground-truth states at the times t [...] (zero biases)."""
    p, v = _d(traj.pos, t)
    q = _quat(traj)(t)
    z = torch.zeros_like(p)
    return NavState(time=t, p=p, q=q, v=v, bg=z, ba=z)


def _rates(traj: Trajectory, params: IntegrationParams, t: torch.Tensor):
    """Exact body-frame gyro and specific-force rates at the times t [...]:
    ([..., 3], [..., 3])."""
    v, a = _d(lambda tt: _d(traj.pos, tt)[1], t)
    q, qdot = _d(_quat(traj), t)
    # qdot = 0.5 q ⊗ [0, w_nb^b]  =>  w_nb^b = 2 vec(q^-1 ⊗ qdot)
    w_nb_b = 2.0 * rot.quat_mul(rot.quat_inv(q), qdot)[..., 1:]
    r_t = rot.quat_to_matrix(q).transpose(-1, -2)
    gyro = w_nb_b + rot.mv(r_t, params.iewn)
    accel = rot.mv(r_t, a - params.gravity + 2.0 * rot.cross(params.iewn, v))
    return gyro, accel


def _chunked(fn, t: torch.Tensor, chunk: int = CHUNK):
    """fn over the flat times t in batches of ``chunk``, outputs joined."""
    outs = [fn(t[i:i + chunk]) for i in range(0, len(t), chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _f64(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, dtype=np.float64))
    return x.to(device=device, dtype=torch.float64)


def _randn(generator, shape, device) -> torch.Tensor:
    """Standard normal draws from a CPU generator, moved to ``device``."""
    return torch.randn(shape, generator=generator, dtype=torch.float64).to(device)


def simulate_imu(traj: Trajectory, params: IntegrationParams, t0: float, duration: float,
                 rate: float) -> ImuSeq:
    """Clean IMU increments by Gauss-Legendre quadrature of the exact rates
    over each interval. Sample i covers (t0 + (i-1) dt, t0 + i dt]; sample
    0 is a zero seed at t0 (the first buffer entry only provides the
    coning predecessor)."""
    dev = params.gravity.device
    dt = 1.0 / rate
    n = int(round(duration * rate))
    times = torch.from_numpy(t0 + np.arange(1, n + 1) * dt).to(dev)  # on the host, as time_grid
    nodes = torch.tensor(_GL_NODES, dtype=torch.float64, device=dev)
    weights = torch.tensor(_GL_WEIGHTS, dtype=torch.float64, device=dev)
    ts = (times[:, None] - dt + nodes * dt).reshape(-1)
    gyros, accels = _chunked(lambda tt: _rates(traj, params, tt), ts)
    dtheta = torch.einsum("k,nki->ni", weights, gyros.reshape(n, 4, 3)) * dt
    dvel = torch.einsum("k,nki->ni", weights, accels.reshape(n, 4, 3)) * dt
    z = torch.zeros((1, 3), dtype=torch.float64, device=dev)
    return ImuSeq(
        time=torch.cat([torch.tensor([t0], dtype=torch.float64, device=dev), times]),
        dt=torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                      torch.full((n,), dt, dtype=torch.float64, device=dev)]),
        dtheta=torch.cat([z, dtheta]), dvel=torch.cat([z, dvel]))


def corrupt_imu(imu: ImuSeq, params: IntegrationParams, bg, ba, generator=None,
                noise=None) -> ImuSeq:
    """Constant biases plus white noise per the IMU noise model (ARW / VRW
    as increment noise, sigma sqrt(dt)). ``noise`` = (gyro, accel) standard
    normal draws [n, 3] each, else drawn from ``generator``."""
    dev = imu.dt.device
    if noise is None:
        noise = (_randn(generator, imu.dtheta.shape, dev), _randn(generator, imu.dvel.shape, dev))
    zg, za = (_f64(x, dev) for x in noise)
    sdt = torch.sqrt(torch.clamp(imu.dt, min=0.0))[:, None]
    noise_g = params.gyr_arw * sdt * zg
    noise_a = params.acc_vrw * sdt * za
    return imu._replace(dtheta=imu.dtheta + imu.dt[:, None] * _f64(bg, dev) + noise_g,
                        dvel=imu.dvel + imu.dt[:, None] * _f64(ba, dev) + noise_a)


def simulate_gnss(traj: Trajectory, params: IntegrationParams, antlever, t0: float,
                  duration: float, rate: float = 1.0, std: float = 0.05, generator=None,
                  noise=None) -> Gnss:
    """GNSS fixes at the antenna phase centre, p + R(q) antlever, plus
    ``std`` times ``noise`` (standard normal [n, 3], else drawn from
    ``generator``; no noise when neither is given)."""
    dev = params.gravity.device
    n = int(round(duration * rate)) + 1
    times = time_grid(t0, n, rate, device=dev)
    s = truth_state(traj, params, times)
    ps = s.p + rot.quat_rotate(s.q, _f64(antlever, dev))
    if noise is None and generator is not None:
        noise = _randn(generator, ps.shape, dev)
    if noise is not None:
        ps = ps + std * _f64(noise, dev)
    return Gnss(time=times, p=ps, std=torch.full((n, 3), std, dtype=torch.float64, device=dev))


def simulate_odometer(traj: Trajectory, params: IntegrationParams, t0: float, duration: float,
                      rate: float = 100.0, sodo_true: float = 0.0, noise_std: float = 0.0,
                      generator=None, noise=None):
    """Wheel-odometer forward-velocity samples (times [n], vel [n]). The
    reference's scale convention (``preintegration_odo.cc:212-215``: true
    displacement = measured * (1 + sodo)) gives vel = v_body_x / (1 +
    sodo_true); plus ``noise_std`` times ``noise`` (standard normal [n],
    else drawn from ``generator``)."""
    dev = params.gravity.device
    n = int(round(duration * rate)) + 1
    times = time_grid(t0, n, rate, device=dev)
    _, v = _d(traj.pos, times)
    r_t = rot.quat_to_matrix(_quat(traj)(times)).transpose(-1, -2)
    vel = rot.mv(r_t, v)[..., 0] / (1.0 + sodo_true)
    if noise_std > 0:
        if noise is None and generator is not None:
            noise = _randn(generator, vel.shape, dev)
        if noise is not None:
            vel = vel + noise_std * _f64(noise, dev)
    return times, vel


def landmark_draws(generator, n: int, t0: float, t1: float, lateral: float = 30.0,
                   depth_range: tuple = (8.0, 60.0)):
    """The uniforms of ``scatter_landmarks`` from a CPU generator: (times
    in [t0, t1) [n], depths [n], lateral / vertical offsets [n, 2])."""
    u = lambda *shape: torch.rand(shape, generator=generator, dtype=torch.float64)  # noqa: E731
    ts = t0 + u(n) * (t1 - t0)
    depths = depth_range[0] + u(n) * (depth_range[1] - depth_range[0])
    offsets = -lateral + u(n, 2) * (2.0 * lateral)
    return ts, depths, offsets


def scatter_landmarks(traj: Trajectory, params: IntegrationParams, generator, n: int,
                      t0: float, t1: float, lateral: float = 30.0,
                      depth_range: tuple = (8.0, 60.0), draws=None) -> torch.Tensor:
    """World landmarks [n, 3] around the trajectory over [t0, t1]: each is
    placed at a random depth in front of the camera at a random time, so
    that nearby frames see it. ``draws`` = (times, depths, offsets) as
    ``landmark_draws`` gives them, else drawn from ``generator``."""
    dev = params.gravity.device
    if draws is None:
        draws = landmark_draws(generator, n, t0, t1, lateral, depth_range)
    ts, d, off = (_f64(x, dev) for x in draws)
    s = truth_state(traj, params, ts)
    axis = lambda k: rot.quat_rotate(s.q, torch.eye(3, dtype=torch.float64, device=dev)[k])  # noqa: E731
    fwd, right, down = axis(0), axis(1), axis(2)
    return (s.p + fwd * d[:, None] + right * off[:, :1]
            + down * (off[:, 1:] * 0.15 - 1.0))


def project_landmarks(traj: Trajectory, params: IntegrationParams, landmarks, times, ext_p,
                      ext_q, fov_tan: float = 0.8, min_depth: float = 2.0,
                      max_depth: float = 120.0, noise_std: float = 0.0, generator=None,
                      noise=None):
    """Ideal feature tracks: the normalized-plane observations of every
    landmark from every frame and their visibility, (uv [L, K, 2], vis
    [L, K]); plus ``noise_std`` times ``noise`` (standard normal [L, K,
    2], else drawn from ``generator``)."""
    dev = params.gravity.device
    lms = _f64(landmarks, dev)
    s = truth_state(traj, params, _f64(times, dev))
    t_wc = s.p + rot.quat_rotate(s.q, _f64(ext_p, dev))
    q_wc = rot.quat_mul(s.q, _f64(ext_q, dev))
    pc = rot.quat_rotate(rot.quat_inv(q_wc)[:, None, :], lms[None] - t_wc[:, None])  # [K, L, 3]
    z = pc[..., 2]
    uv = pc[..., :2] / torch.where(torch.abs(z) < 1e-6, 1e-6, z)[..., None]
    vis = ((z > min_depth) & (z < max_depth) & (torch.abs(uv[..., 0]) < fov_tan)
           & (torch.abs(uv[..., 1]) < fov_tan))
    uv, vis = uv.transpose(0, 1), vis.transpose(0, 1)
    if noise_std > 0:
        if noise is None and generator is not None:
            noise = _randn(generator, uv.shape, dev)
        if noise is not None:
            uv = uv + noise_std * _f64(noise, dev)
    return uv, vis


def render_sprite_frame(cam_intrinsic: tuple, resolution: tuple, landmarks, t_wc, q_wc,
                        sprite_sigma: float = 1.6, base_level: float = 24.0) -> torch.Tensor:
    """A camera image of a 3-D point-sprite field, on the landmarks'
    device: every landmark is a Gaussian blob over the whole frame whose
    brightness falls with depth (float64 per blob, accumulated in float32
    on a constant background, clipped to [0, 255]; float32 [h, w])."""
    fx, fy, cx, cy = cam_intrinsic[:4]
    w, h = resolution
    dev = landmarks.device
    pc = rot.quat_rotate(rot.quat_inv(_f64(q_wc, dev)), landmarks - _f64(t_wc, dev))
    z = pc[:, 2]
    vis = z > 1.0
    zs = torch.where(vis, z, 1.0)
    u = fx * pc[:, 0] / zs + cx
    v = fy * pc[:, 1] / zs + cy
    amp = torch.where(vis, 200.0 / torch.sqrt(torch.clamp(z, min=1.0)), 0.0)
    ys = torch.arange(h, dtype=torch.float32, device=dev).double()[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev).double()[None, :]
    img = torch.full((h, w), base_level, dtype=torch.float32, device=dev)
    chunk = max(1, (1 << 22) // (h * w))
    for i in range(0, len(u), chunk):
        d2 = (ys - v[i:i + chunk, None, None]) ** 2 + (xs - u[i:i + chunk, None, None]) ** 2
        blobs = amp[i:i + chunk, None, None] * torch.exp(-d2 / (2 * sprite_sigma**2))
        img = img + blobs.float().sum(0)
    return torch.clamp(img, 0.0, 255.0)


def render_sprite_frame_np(
    cam_intrinsic: tuple,
    resolution: tuple,
    landmarks: np.ndarray,  # [L,3] world points (numpy, f64)
    t_wc: np.ndarray,
    q_wc: np.ndarray,
    sprite_sigma: float = 1.6,
    base_level: float = 24.0,
) -> np.ndarray:
    """Render a camera image of a 3-D point-sprite field on the host: the
    image model of ``render_sprite_frame``, with each blob accumulated as
    a local patch of +-3 sigma around its centre, on a constant background,
    clipped to [0, 255] (float32, [h, w])."""
    fx, fy, cx, cy = cam_intrinsic[:4]
    w, h = resolution
    q = np.asarray(q_wc, np.float64)
    # world -> camera: R(q)^T (pw - t)
    qw, xyz = q[0], q[1:]
    d = np.asarray(landmarks, np.float64) - np.asarray(t_wc, np.float64)
    t2 = 2.0 * np.cross(xyz, d)
    pc = d - qw * t2 + np.cross(xyz, t2)  # inverse rotation
    z = pc[:, 2]
    vis = z > 1.0
    u = fx * pc[:, 0] / np.where(vis, z, 1.0) + cx
    v = fy * pc[:, 1] / np.where(vis, z, 1.0) + cy
    amp = np.where(vis, 200.0 / np.sqrt(np.maximum(z, 1.0)), 0.0)
    half = int(np.ceil(3.0 * sprite_sigma))
    vis &= (u > -half) & (u < w + half) & (v > -half) & (v < h + half)

    img = np.full((h, w), base_level, np.float32)
    inv2s2 = 1.0 / (2.0 * sprite_sigma**2)
    for ui, vi, ai in zip(u[vis], v[vis], amp[vis]):
        x0 = max(int(np.floor(ui)) - half, 0)
        x1 = min(int(np.floor(ui)) + half + 2, w)
        y0 = max(int(np.floor(vi)) - half, 0)
        y1 = min(int(np.floor(vi)) + half + 2, h)
        if x1 <= x0 or y1 <= y0:
            continue
        ys = (np.arange(y0, y1, dtype=np.float32) - vi)[:, None] ** 2
        xs = (np.arange(x0, x1, dtype=np.float32) - ui)[None, :] ** 2
        img[y0:y1, x0:x1] += ai * np.exp(-(ys + xs) * inv2s2)
    return np.clip(img, 0.0, 255.0)


def default_params(with_earth: bool = True, lat_deg: float = 30.5, dtype=torch.float64,
                   device=None) -> IntegrationParams:
    """IMU noise parameters of the reference configuration (``gvins.yaml:26-31``:
    ARW 0.1 deg/sqrt(hr), VRW 0.1 m/s/sqrt(hr), bias std 50 deg/hr and 50
    mGal, correlation time 1 hr), gravity fixed to the reference's
    NORMAL_GRAVITY = 9.80, on ``device`` (``cuda:0`` unless told)."""
    dev = resolve_device(device)
    d2r = np.pi / 180.0
    arw = 0.1 * d2r / 60.0  # deg/sqrt(hr) -> rad/sqrt(s)
    vrw = 0.1 / 60.0  # m/s/sqrt(hr) -> m/s/sqrt(s)
    gb = 50.0 * d2r / 3600.0  # deg/hr -> rad/s
    ab = 50.0 * 1e-5  # mGal -> m/s^2
    wie = 7.2921151467e-5
    lat = lat_deg * d2r
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    iewn = t([wie * np.cos(lat), 0.0, -wie * np.sin(lat)]) if with_earth else t([0.0] * 3)
    return IntegrationParams(gyr_arw=t(arw), acc_vrw=t(vrw), gyr_bias_std=t(gb),
                             acc_bias_std=t(ab), corr_time=t(3600.0),
                             gravity=t([0.0, 0.0, 9.80]), iewn=iewn)
