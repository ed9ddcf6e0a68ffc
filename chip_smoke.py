#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ic_gvins_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path at the engine's default sizes: the visual
front end (``Frontend.process`` with its defaults: CLAHE, bidirectional
KLT, FM-RANSAC) over 1278 x 1022 frames with 200 features and a 4-image
pyramid; one GVINS keyframe round on a 24-node x 192-landmark float64
window (preintegrate -> triangulate -> ``optimize_impl(iters=20)`` ->
``marginalize_and_slide``); then the engine as users call it, the
``Estimator`` on sensor streams and the ``Pipeline`` on camera frames,
with ``EngineConfig()``. Phases:

1. the card's name and power limit; build the CUDA kernel (nvcc, sm_90a);
2. KLT kernel vs its plain PyTorch version at slice shapes (200 features)
   and at 1000 and 4000 features, with times and the roofline bound of the
   work the kernel counted; then CLAHE on the card vs the CPU and FM-RANSAC
   on a synthetic two-view scene with 20% gross outliers;
3. ``Frontend.process`` over 8 frames shifted by a known subpixel flow, and
   the histogram gate on a frame at a quarter of the brightness;
4. the keyframe round, held against the JAX package's float64 results in
   ``tests/fixtures/torch_slice_24x192.npz`` (``tools/make_torch_fixture.py``);
5. ``Estimator(EngineConfig())`` fed 15 s of IMU (200 Hz), GNSS (1 Hz) and
   ideal tracks (10 Hz) from ``tests/fixtures/torch_estimator_defaults.npz``,
   held against the JAX ``Estimator``'s run stored there
   (``tools/make_torch_estimator_fixture.py``): the same events, node
   times, keyframes and LM steps, the trajectory within 1e-6 m / 1e-7 rad;
6. ``Pipeline`` (the defaults without lens distortion) on the same IMU and
   GNSS and 150 frames of 1278 x 1022 rendered at the fixture's truth
   camera poses: it must reach TRACKING_NORMAL, launch the KLT kernel
   once per tracked frame and stay under tests/test_pipeline.py's 0.45 m
   ATE bound.

Phases 3 to 6 run with the kernel's launch count set to 0 before each and
read after it; the ``launches`` of the kernels line sums phases 3 and 6.
Every phase raises on failure. Needs a CUDA device: without one it exits
with code 1 and prints no result. Prints a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_slice_24x192.npz")
ESTIMATOR_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_estimator_defaults.npz")

IMG_W, IMG_H = 1278, 1022  # engine default camera
N_FEATURES = 200
KLT_SIZES = (N_FEATURES, 1000, 4000)  # features per call in phase 2
PYR_LEVELS = 3  # -> 4 pyramid images
CELL = 64
FLOW = (1.3, -0.7)  # known per-frame shift (x, y) in px
N_FRAMES = 8
ITERS = 20

# Limits. KLT: the kernel sums the 441 window terms in another order than
# the plain version (and may fuse multiply-adds), so points agree to
# rounding except where a step norm sits on the 0.01 px stop threshold,
# which moves the result by less than one such step at the finest level.
KLT_PTS_ATOL = 0.05  # px, both ok
KLT_OK_AGREE = 0.99  # fraction of equal ok flags
FLOW_ATOL = 0.1  # px, median error of the recovered shift
TRACKED_MIN = 0.8  # fraction of features kept frame to frame
# CLAHE on the card vs the CPU: same integer histograms, float32 sums in
# another order (a few roundings of values up to 255).
CLAHE_ATOL = 1e-2  # grey levels
RANSAC_KEEP = 0.95  # fraction of the true inliers FM-RANSAC must keep
# Roofline of one H100 SXM (NVIDIA's data sheet): HBM3 and plain float32.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# Work of the KLT per window pixel. All 441 pixels of a window share one
# point's four bilinear weights, so a sample is 4 multiply-adds (8 flop). A
# level pass builds the template: 5 samples, 4 flop of gradients, 6 of the
# structure tensor. A Gauss-Newton step takes 1 sample, 1 subtraction and
# 2 multiply-adds. The weights cost 8 flop once per pass and once per step.
FLOP_WEIGHTS = 8
FLOP_PER_PASS = 441 * (5 * 8 + 4 + 6) + FLOP_WEIGHTS
FLOP_PER_STEP = 441 * (8 + 1 + 4) + FLOP_WEIGHTS
# Pixels a level pass must read: the 25 x 25 template neighbourhood and the
# 23 x 23 footprint of the search window, 4 bytes each.
BYTES_PER_PASS = (25 * 25 + 23 * 23) * 4
# Keyframe round vs JAX float64 on the CPU: closed forms agree to rounding
# (relative 1e-9 of each array's largest entry); the 20 LM iterations and
# the marginalization's eigen-decomposition amplify reduction-order
# differences, hence 1e-7.
RTOL_CLOSED = 1e-9
RTOL_ITERATIVE = 1e-7
# Estimator vs the JAX package's float64 Estimator on the same streams: the
# same decisions everywhere, hence the same rounds; each round's solve
# differs from JAX only by rounding (relative ~1e-12), which the window
# carries along the run.
TRAJ_POS_ATOL = 1e-6  # m
TRAJ_ATT_ATOL = 1e-8  # rad, on the CPU
# On the card the solver's sums (atomic index_add_, cuBLAS and cuSOLVER
# blockings) round otherwise than on the CPU, and differently from run to
# run: two full-width runs ended 5.2e-9 and 8.9e-9 rad from JAX. The card
# gets the attitude bound that matches TRAJ_POS_ATOL at the ~10 m range of
# the landmarks.
CARD_TRAJ_ATT_ATOL = 1e-7  # rad
# Pipeline on rendered frames: tests/test_pipeline.py's ATE bound (after 4 s)
PIPELINE_ATE = 0.45  # m
PIPELINE_T_MIN = 4.0  # s
# ~0.1 s of spinning at 2 GHz: far longer than the host takes to enqueue
# 50 calls of the KLT wrapper (~0.13 ms each on the slowest host seen)
SPIN_CYCLES = 200_000_000


def log(msg):
    print(msg, flush=True)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps, queue_ahead=False):
    """Mean ms per call of fn over reps calls, by CUDA events. Back to back
    the events time whichever is slower, the card or the host's launches;
    with ``queue_ahead`` the card first spins while the host enqueues every
    call, so the events time the card alone."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scenario(fx, name):
    """One scenario of an estimator fixture (``tools/make_torch_estimator_fixture.py``)
    as a dict of numpy arrays without the ``name/`` prefix."""
    pre = name + "/"
    return {k[len(pre):]: v for k, v in fx.items() if k.startswith(pre)}


def engine_config(config_mod, s, cam=None, **overrides):
    """The scenario's ``EngineConfig``, built by ``config_mod`` (the config
    module of either package) from the JSON the fixture stores, with
    ``overrides`` of its fields and ``cam``'s of the camera's."""
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}  # noqa: E731
    kw = tup(json.loads(str(s["cfg_json"])))
    cam_kw = {**kw.pop("cam", {}), **(cam or {})}
    cfg = config_mod.EngineConfig(**kw, **overrides)
    if cam_kw:
        cfg.cam = config_mod.CameraConfig(**tup(cam_kw))
    return cfg


def to_np(x):
    """A tensor of either package (or a number) as a float64 or bool numpy array."""
    x = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return x if x.dtype == bool else x.astype(np.float64)


def feed(sink, est, s, on_frame):
    """Feed a scenario's streams to ``sink`` (an ``Estimator`` or a
    ``Pipeline`` of either package; ``est`` is its estimator) in the order
    of the JAX package's tests: each IMU sample, then the GNSS fixes and
    the frames stamped at or before it; ``on_frame(j)`` hands frame j to
    the sink. Returns the event log, one row after each fix or frame:
    ``log`` (engine state, nodes, keyframes, landmark slots in use, stats
    rows) and the node times and keyframe flags, padded to the window."""
    n_cap = est.cfg.max_nodes
    rows, node_t, node_kf = [], [], []
    gt, ft = s["gnss_t"], s["frame_t"]
    gi = fi = 0

    def record():
        rows.append((est.state, est.n_nodes, est.n_keyframes, len(est.lm_slot), len(est.stats)))
        node_t.append(np.pad(np.asarray(est.node_times, np.float64), (0, n_cap - est.n_nodes),
                             constant_values=np.nan))
        node_kf.append(np.pad(np.asarray(est.node_is_kf, bool), (0, n_cap - est.n_nodes)))

    for k in range(len(s["imu_t"])):
        t = float(s["imu_t"][k])
        sink.add_imu(t, float(s["imu_dt"][k]), s["imu_dth"][k], s["imu_dv"][k])
        while gi < len(gt) and gt[gi] <= t:
            sink.add_gnss(float(gt[gi]), s["gnss_p"][gi], s["gnss_std"][gi])
            gi += 1
            record()
        while fi < len(ft) and ft[fi] <= t:
            on_frame(fi)
            fi += 1
            record()
    return {"log": np.asarray(rows, np.int64), "log_node_t": np.asarray(node_t),
            "log_node_kf": np.asarray(node_kf)}


def observations(s, j):
    """Frame j's ideal tracks of a scenario: (time, ids, normalized uv)."""
    lo = int(np.sum(s["frame_n"][:j]))
    hi = lo + int(s["frame_n"][j])
    return float(s["frame_t"][j]), s["frame_ids"][lo:hi], s["frame_uv"][lo:hi]


STATS_KEYS = ("t", "cost0", "cost1", "iterations", "iters_run", "n_obs", "culled",
              "outlier_mappoints", "outlier_features", "n_nodes", "reproj_rms")


def summarize(est):
    """What the fixture holds of a finished run of either package's
    ``Estimator``: trajectory, per-round stats rows, the final window's
    active nodes and its landmark inverse depths."""
    times, ps, qs = est.trajectory()
    w, n = est.window, est.n_nodes
    out = {"traj_t": np.asarray(times, np.float64), "traj_p": np.asarray(ps, np.float64),
           "traj_q": np.asarray(qs, np.float64),
           "stats": np.array([[float(r[k]) for k in STATS_KEYS] for r in est.stats]),
           "node_times": np.asarray(est.node_times, np.float64),
           "node_is_kf": np.asarray(est.node_is_kf, bool),
           "lm_invdepth": to_np(w.lm_invdepth), "lm_valid": to_np(w.lm_valid)}
    for k in ("p", "q", "v", "bg", "ba"):
        out[f"nodes_{k}"] = to_np(getattr(w.nodes, k))[:n]
    return out


def trajectory_errors(traj_t, traj_p, s, t_min):
    """Position errors of the trajectory entries at or after ``t_min``
    against the scenario's 200 Hz truth."""
    idx = np.rint((traj_t - s["truth_t"][0]) * 200.0).astype(np.int64)
    check(np.all(np.abs(s["truth_t"][idx] - traj_t) < 1e-9), "trajectory off the truth grid")
    sel = traj_t >= t_min
    return np.linalg.norm(traj_p[sel] - s["truth_p"][idx[sel]], axis=1)


def quat_angle(q1, q2):
    """Rotation angle (rad) between unit quaternions, row by row."""
    w = np.abs(np.sum(q1 * q2, axis=-1))
    v = np.linalg.norm(q1[..., :1] * q2[..., 1:] - q2[..., :1] * q1[..., 1:]
                       - np.cross(q1[..., 1:], q2[..., 1:]), axis=-1)
    return 2.0 * np.arctan2(v, w)


def compare_estimator(got, ref, att_atol=TRAJ_ATT_ATOL):
    """Hold a run of the port's ``Estimator`` (``feed`` log +
    ``summarize``) against the JAX run of the fixture: the event log
    (engine state, nodes, keyframes, landmark slots, rounds), node times
    and keyframe flags after every event, and per round the LM's accepted
    steps and iterations and the culling counts must be identical; the
    trajectory must agree within TRAJ_POS_ATOL and ``att_atol``. Raises
    on a difference; returns (max position error m, max attitude error
    rad)."""
    check(got["log"].shape == ref["log"].shape and np.array_equal(got["log"], ref["log"]),
          "event log (state, nodes, keyframes, landmark slots, rounds) differs from JAX")
    check(np.array_equal(got["log_node_t"], ref["log_node_t"], equal_nan=True),
          "node times differ from JAX")
    check(np.array_equal(got["log_node_kf"], ref["log_node_kf"]), "keyframe flags differ")
    cols = [STATS_KEYS.index(k) for k in STATS_KEYS if k not in ("cost0", "cost1", "reproj_rms")]
    check(np.array_equal(got["stats"][:, cols], ref["stats"][:, cols]),
          "per-round LM steps, iterations or culling counts differ from JAX")
    dp = float(np.max(np.linalg.norm(got["traj_p"] - ref["traj_p"], axis=1)))
    dq = float(np.max(quat_angle(got["traj_q"], ref["traj_q"])))
    check(dp <= TRAJ_POS_ATOL, f"trajectory positions {dp:.3g} m from JAX (> {TRAJ_POS_ATOL})")
    check(dq <= att_atol, f"trajectory attitudes {dq:.3g} rad from JAX (> {att_atol})")
    return dp, dq


def make_frames(n):
    """Band-limited noise (smoothed uniform noise) with its contrast
    stretched about mid-grey, shifted by k * FLOW and kept inside [0, 255]
    (a standard deviation of ~40 grey levels, so CLAHE has something to
    equalize and clips nothing but the tails)."""
    from scipy.ndimage import gaussian_filter, shift

    rng = np.random.RandomState(0)
    base = (gaussian_filter(rng.rand(IMG_H, IMG_W) * 255.0, 2.0) - 127.5) * 4.0 + 127.5
    return [
        np.clip(shift(base, (k * FLOW[1], k * FLOW[0]), order=3, mode="nearest"),
                0.0, 255.0).astype(np.float32)
        for k in range(n)
    ]


def two_view_scene(n, n_out, seed, noise=0.2):
    """n pixel correspondences of random 3-D points seen by two cameras (a
    1 m baseline and a 0.08 rad turn, f = 400 px, ``noise`` px of Gaussian
    noise); the first ``n_out`` are gross outliers, moved in the second
    view by 8-40 px in y, across the epipolar lines (the baseline is along
    x, so they are within 0.2 of horizontal; a move along its line leaves
    a point an inlier of the geometry), and by up to 20 px in x.
    Returns (uv0 [n, 2], uv1 [n, 2], is_out [n])."""
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], -1)
    t, ang = np.array([1.0, 0.15, 0.1]), 0.08
    rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    proj = lambda p: 400.0 * p[:, :2] / p[:, 2:] + np.array([320.0, 240.0])  # noqa: E731
    uv0 = proj(pw) + rng.normal(0, noise, (n, 2))
    uv1 = proj((pw - t) @ rot) + rng.normal(0, noise, (n, 2))
    is_out = np.arange(n) < n_out
    uv1[is_out, 0] += rng.uniform(-20, 20, n_out)
    uv1[is_out, 1] += rng.uniform(8, 40, n_out) * rng.choice([-1, 1], n_out)
    return uv0, uv1, is_out


def phase_build():
    from ic_gvins_tpu_torch.vision import klt_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    klt_cuda.load_library()
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a)")
    for line in klt_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def klt_bound(work, n, pyr):
    """Roofline bound of one bidirectional KLT call from the work the
    kernel counted (``work`` [n, 2]: packed level passes and Gauss-Newton
    steps per feature): (ms, "bytes" or "operations"). Bytes: at each level
    the pixels its passes must read, at most that level of both pyramids
    once, plus the points in and the results out; operations: the float32
    flop of the passes and steps."""
    from ic_gvins_tpu_torch.vision.klt_cuda import passes_per_level

    per_level = passes_per_level(work, len(pyr))
    passes, steps = sum(per_level), int(work[:, 1].sum())
    pixels = sum(min(p * BYTES_PER_PASS, 2 * x.numel() * 4) for p, x in zip(per_level, pyr))
    nbytes = pixels + n * (8 + 8 + 1 + 8 + 4 + 1)
    flop = passes * FLOP_PER_PASS + steps * FLOP_PER_STEP
    t_bytes, t_flop = nbytes / PEAK_BYTES_S * 1e3, flop / PEAK_F32_FLOP_S * 1e3
    log(f"phase 2 klt bound n={n}: level passes {per_level} (level 0 first), {steps} steps "
        f"({steps / max(passes, 1):.2f} per pass); {nbytes / 1e6:.3f} MB -> {t_bytes:.5f} ms "
        f"at 3.35 TB/s, {flop / 1e6:.1f} MFLOP -> {t_flop:.5f} ms at 67 TFLOP/s f32")
    return max(t_bytes, t_flop), "bytes" if t_bytes >= t_flop else "operations"


def klt_inputs(n, pyr0, pyr1):
    """Phase 2's arguments of one bidirectional KLT call at n features:
    seeded points at least 40 px inside the frame, each its own seed, all
    valid."""
    import torch

    pts = np.random.RandomState(n).rand(n, 2) * np.array([IMG_W - 80, IMG_H - 80]) + 40
    pts0 = torch.as_tensor(pts, dtype=torch.float32, device=pyr0[0].device)
    return pyr0, pyr1, pts0, pts0, torch.ones(n, dtype=torch.bool, device=pts0.device)


def phase_klt(frames, dev):
    import torch

    from ic_gvins_tpu_torch.vision import klt, klt_cuda
    from ic_gvins_tpu_torch.vision.pyramid import build_pyramid

    pyr0 = build_pyramid(torch.as_tensor(frames[0], device=dev), PYR_LEVELS)
    pyr1 = build_pyramid(torch.as_tensor(frames[1], device=dev), PYR_LEVELS)
    stats = {}
    for n in KLT_SIZES:
        args = klt_inputs(n, pyr0, pyr1)
        pts0 = args[2]

        pk, ok_k, _, work = klt_cuda.lk_track_bidirectional_counted(*args)
        pp, ok_p, _ = klt.lk_track_bidirectional(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(pk).all()), "KLT kernel returned non-finite points")
        both = ok_k & ok_p
        check(int(both.sum()) > 0, "no feature tracked by both kernel and plain version")
        err = float((pk - pp).abs()[both].max())
        agree = float((ok_k == ok_p).float().mean())
        flow = (pk - pts0)[ok_k].cpu().numpy()
        flow_err = float(np.median(np.linalg.norm(flow - np.array(FLOW), axis=1)))
        frac = float(ok_k.float().mean())
        log(f"phase 2 klt: {n} features, 4 levels of {IMG_W}x{IMG_H}: "
            f"ok kernel {frac:.3f}, ok agreement {agree:.4f} (>= {KLT_OK_AGREE}), "
            f"max |kernel - plain| {err:.3g} px (<= {KLT_PTS_ATOL}), "
            f"median flow error {flow_err:.3g} px (<= {FLOW_ATOL})")
        check(err <= KLT_PTS_ATOL, "KLT kernel disagrees with the plain version")
        check(agree >= KLT_OK_AGREE, "KLT kernel ok flags disagree with the plain version")
        check(flow_err <= FLOW_ATOL and frac >= 0.9, "KLT kernel missed the known flow")
        bound_ms, bound_by = klt_bound(work, n, pyr0)

        kernel = lambda: klt_cuda.lk_track_bidirectional(*args)  # noqa: E731
        plain = lambda: klt.lk_track_bidirectional(*args)  # noqa: E731
        for _ in range(3):
            kernel()
        # in turns: plain, kernel, kernel, plain (the plain version only at
        # the slice's size). The kernel's time is the card's (calls queued
        # behind a spin); the plain version syncs with the host every
        # iteration, so its time is what a caller waits.
        t_p = [cuda_ms(plain, 10)] if n == N_FEATURES else []
        t_k = [cuda_ms(kernel, 50, queue_ahead=True) for _ in range(2)]
        t_p += [cuda_ms(plain, 10)] if n == N_FEATURES else []
        t_call = cuda_ms(kernel, 50)
        ms_k = float(np.mean(t_k))
        log(f"phase 2 klt time n={n}: kernel {ms_k:.4f} ms on the card ({t_k[0]:.4f}, "
            f"{t_k[1]:.4f}), {t_call:.4f} ms per call back to back, bound {bound_ms:.5f} ms "
            f"({bound_by})" + (f"; plain {np.mean(t_p):.4f} ms ({t_p[0]:.4f}, {t_p[1]:.4f})"
                               if t_p else "") + " per bidirectional call")
        if n == N_FEATURES:
            stats.update(max_abs_err=err, ms=ms_k, plain_ms=float(np.mean(t_p)),
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                         ms_back_to_back=t_call)
        else:
            stats[f"ms_{n}"], stats[f"bound_ms_{n}"] = ms_k, bound_ms
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
    return stats


def phase_preprocess(frames, dev):
    """CLAHE on the card against the CPU on one full-size frame, and
    FM-RANSAC on the card on a synthetic two-view scene."""
    import torch

    from ic_gvins_tpu_torch.vision.preprocess import clahe
    from ic_gvins_tpu_torch.vision.ransac import fundamental_ransac

    img = torch.as_tensor(frames[0])
    on_card = clahe(img.to(dev))
    torch.cuda.synchronize()
    err = float((on_card.cpu() - clahe(img)).abs().max())
    ms_clahe = cuda_ms(lambda: clahe(img.to(dev)), 5)
    log(f"phase 2 clahe: {IMG_W}x{IMG_H} on the card vs the CPU: max |diff| {err:.3g} grey "
        f"levels (<= {CLAHE_ATOL}), output std {float(on_card.std()):.1f} (input "
        f"{float(img.std()):.1f}), {ms_clahe:.3f} ms per frame with its host-to-device copy")
    check(err <= CLAHE_ATOL, "CLAHE on the card disagrees with the CPU")
    check(float(on_card.std()) > float(img.std()), "CLAHE did not raise the contrast")

    n, n_out = N_FEATURES, N_FEATURES // 5
    uv0, uv1, is_out = two_view_scene(n, n_out, seed=0)
    args = (torch.as_tensor(uv0, device=dev), torch.as_tensor(uv1, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev), 1.5)
    inl, F = fundamental_ransac(*args, torch.Generator().manual_seed(0))
    inl = inl.cpu().numpy()
    kept = float(inl[~is_out].mean())
    ms_ransac = cuda_ms(lambda: fundamental_ransac(*args, torch.Generator().manual_seed(0)), 5)
    log(f"phase 2 ransac: {n} correspondences, {n_out} gross outliers: kept "
        f"{kept:.3f} of the true inliers (>= {RANSAC_KEEP}), {int(inl[is_out].sum())} "
        f"outliers kept (0), {ms_ransac:.3f} ms per call")
    check(bool(torch.isfinite(F).all()), "FM-RANSAC returned a non-finite F")
    check(kept >= RANSAC_KEEP, "FM-RANSAC dropped too many true inliers")
    check(not inl[is_out].any(), "FM-RANSAC kept a gross outlier")


def phase_frontend(frames, dev):
    import torch

    from ic_gvins_tpu_torch.engine.frontend import Frontend
    from ic_gvins_tpu_torch.vision import camera as cam_mod

    cam = cam_mod.Camera.create(cam_mod.DEFAULT_INTRINSIC, cam_mod.DEFAULT_DISTORTION,
                                cam_mod.DEFAULT_RESOLUTION, device=dev)
    # every stage at its default: CLAHE and FM-RANSAC on
    fe = Frontend(cam, max_features=N_FEATURES, pyramid_levels=PYR_LEVELS, cell=CELL)
    check(fe.use_clahe and fe.fm_ransac, "the front end's defaults switch a stage off")
    q = np.array([1.0, 0.0, 0.0, 0.0])
    prev_ids, walls, kept, moves = None, [], [], []
    for k, img in enumerate(frames):
        prev_px = dict(zip(fe.ids[fe.valid], fe.pts[fe.valid]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, uv, vel = fe.process(0.1 * k, img, q_wc=q, p_wc=np.zeros(3))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(np.all(np.isfinite(uv)) and uv.shape == (len(ids), 2), "bad frontend output")
        if prev_ids is not None:
            kept.append(len(np.intersect1d(prev_ids, ids)) / max(len(prev_ids), 1))
        moves += [px - prev_px[i] for i, px in zip(fe.ids[fe.valid], fe.pts[fe.valid])
                  if i in prev_px]
        prev_ids = ids
    flow_err = float(np.median(np.linalg.norm(np.array(moves) - np.array(FLOW), axis=1)))
    log(f"phase 3 frontend: {len(frames)} frames, features {len(prev_ids)}, "
        f"kept frame to frame min {min(kept):.3f} (>= {TRACKED_MIN}), "
        f"median flow error {flow_err:.3g} px (<= {FLOW_ATOL}), "
        f"ms per frame first {walls[0]:.2f}, rest mean {np.mean(walls[1:]):.2f}")
    check(len(prev_ids) >= 0.8 * N_FEATURES, "frontend holds too few features")
    check(min(kept) >= TRACKED_MIN, "frontend lost too many features")
    check(flow_err <= FLOW_ATOL, "frontend tracks miss the known flow")

    # histogram gate: a frame at a quarter of the brightness is skipped and
    # the previous observations come back unchanged
    fe = Frontend(cam, max_features=N_FEATURES, pyramid_levels=PYR_LEVELS, cell=CELL,
                  check_histogram=True)
    for k in range(2):
        before = fe.process(0.1 * k, frames[k], q_wc=q, p_wc=np.zeros(3))
    after = fe.process(0.2, frames[2] * 0.25, q_wc=q, p_wc=np.zeros(3))
    check(fe.frame_count == 2 and all(np.array_equal(a, b) for a, b in zip(before, after)),
          "the histogram gate let an illumination glitch through")
    after = fe.process(0.2, frames[2], q_wc=q, p_wc=np.zeros(3))
    check(fe.frame_count == 3 and len(after[0]) >= 0.8 * N_FEATURES,
          "the histogram gate rejected a good frame")
    log("phase 3 histogram gate: dark frame skipped, next frame tracked")


def round_inputs(dev):
    """The fixture's keyframe-round inputs on ``dev`` and its JAX results:
    ((window, prior, cfg, params, imu), nested dict of numpy arrays)."""
    from ic_gvins_tpu_torch.convert import to_torch, unflatten
    from ic_gvins_tpu_torch.data.types import ImuSeq, IntegrationParams
    from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig, Window

    fx = dict(np.load(FIXTURE))
    inp = unflatten(fx, "in/")
    types = (("window", Window), ("prior", Prior), ("cfg", SolverConfig),
             ("params", IntegrationParams), ("imu", ImuSeq))
    return tuple(to_torch(t, inp[k], dev) for k, t in types), unflatten(fx, "out/")


def phase_round(dev):
    import torch

    from ic_gvins_tpu_torch.engine.keyframe import preintegrate_window, triangulate_window
    from ic_gvins_tpu_torch.factors.marginalization import marginalize_and_slide
    from ic_gvins_tpu_torch.solver.lm import optimize_impl

    (win, prior, cfg, params, imu), ref = round_inputs(dev)

    def stage(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def run():
        ms = {}
        w, ms["preint"] = stage(lambda: preintegrate_window(win, params, imu))
        (w, invd, ok), ms["triangulate"] = stage(lambda: triangulate_window(w))
        (w_opt, (s1, s2, nc)), ms["optimize"] = stage(
            lambda: optimize_impl(w, prior, cfg, params, iters=ITERS))
        (w_sl, pr), ms["marginalize"] = stage(
            lambda: marginalize_and_slide(w_opt, prior, cfg, params))
        return w, invd, ok, w_opt, s1, s2, nc, w_sl, pr, ms

    for rep in range(2):  # the first run warms the solver libraries
        w, invd, ok, w_opt, s1, s2, nc, w_sl, pr, ms = run()
        errs = {}
        for k, v in ref["preint"].items():
            errs[f"preint.{k}"] = rel_err(v, getattr(w.preint, k).cpu())
        check(np.array_equal(ref["tri"]["ok"], ok.cpu().numpy()), "triangulation ok differs")
        okn = ref["tri"]["ok"]
        errs["tri.invdepth"] = rel_err(ref["tri"]["invdepth"][okn], invd.cpu().numpy()[okn])
        for name, s, r in (("phase1", s1, ref["opt"]["stats1"]), ("phase2", s2, ref["opt"]["stats2"])):
            check(s.iters_run == int(r["iters_run"]) and s.accepted == int(r["accepted"]),
                  f"LM {name} iters/accepted {s.iters_run}/{s.accepted} vs JAX "
                  f"{int(r['iters_run'])}/{int(r['accepted'])}")
            errs[f"opt.{name}.cost1"] = rel_err(r["cost1"], s.cost1.cpu())
        check(int(nc) == int(ref["opt"]["n_culled"]), "chi2 cull count differs")
        for k, v in ref["opt"]["nodes"].items():
            errs[f"opt.nodes.{k}"] = rel_err(v, getattr(w_opt.nodes, k).cpu())
        errs["opt.lm_invdepth"] = rel_err(ref["opt"]["lm_invdepth"], w_opt.lm_invdepth.cpu())
        errs["marg.H"] = rel_err(ref["marg"]["H"], pr.H.cpu())
        errs["marg.g"] = rel_err(ref["marg"]["g"], pr.g.cpu())
        for k, v in ref["marg"]["nodes"].items():
            errs[f"marg.nodes.{k}"] = rel_err(v, getattr(w_sl.nodes, k).cpu())
        check(np.array_equal(ref["marg"]["lm_valid"], w_sl.lm_valid.cpu().numpy()),
              "slid window landmarks differ")
        for k, e in errs.items():
            lim = RTOL_CLOSED if k.startswith(("preint", "tri")) else RTOL_ITERATIVE
            check(np.isfinite(e) and e <= lim, f"{k}: relative error {e:.3g} > {lim}")
    worst = max(errs, key=errs.get)
    log(f"phase 4 keyframe round (24 nodes x 192 landmarks, f64, {ITERS} iters): "
        f"LM iters {s1.iters_run}+{s2.iters_run} accepted {s1.accepted}+{s2.accepted} "
        f"as JAX; worst relative error {worst} {errs[worst]:.3g}")
    log("phase 4 stage ms: " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
        + f", round {sum(ms.values()):.2f}")


def run_estimator(s, dev, **overrides):
    """The port's ``Estimator`` (the scenario's configuration with
    ``overrides``) fed the scenario's ideal tracks on ``dev``:
    (estimator, feed log + summary)."""
    import torch

    from ic_gvins_tpu_torch.engine import config as tconfig
    from ic_gvins_tpu_torch.engine.estimator import Estimator

    est = Estimator(engine_config(tconfig, s, **overrides), device=dev)
    if "ext_p" in s:  # the scenario's camera, set on the window as the JAX tests do
        est.window = est.window._replace(ext_p=torch.as_tensor(s["ext_p"], device=dev),
                                         ext_q=torch.as_tensor(s["ext_q"], device=dev))
    log = feed(est, est, s, lambda j: est.add_frame_observations(*observations(s, j)))
    return est, {**log, **summarize(est)}


def run_pipeline(s, dev, use_clahe, **overrides):
    """The port's ``Pipeline`` (the scenario's configuration with
    ``overrides``) fed the scenario's IMU, GNSS and frames that the sprite
    renderer draws with the configured camera at the truth camera poses:
    (pipeline, feed log + summary, frames the KLT tracked)."""
    from ic_gvins_tpu_torch.data.simulator import render_sprite_frame_np
    from ic_gvins_tpu_torch.engine import config as tconfig
    from ic_gvins_tpu_torch.engine.pipeline import Pipeline

    cfg = engine_config(tconfig, s, **overrides)
    pipe = Pipeline(cfg, device=dev, use_clahe=use_clahe)
    fe, tracked = pipe.frontend, [0]

    def on_frame(j):
        tracked[0] += int(fe.prev_pyr is not None and fe.valid.any())
        img = render_sprite_frame_np(cfg.cam.intrinsic, cfg.cam.resolution, s["sprites"],
                                     s["cam_t_wc"][j], s["cam_q_wc"][j])
        pipe.add_image(float(s["frame_t"][j]), img)

    log = feed(pipe, pipe.est, s, on_frame)
    return pipe, {**log, **summarize(pipe.est)}, tracked[0]


def stage_line(est, seconds, data_s):
    ms = {k: float(np.median(v)) if v else float("nan") for k, v in est.stage_ms.items()}
    return (f"median ms per call: preintegrate {ms['preintegrate']:.2f} "
            f"({len(est.stage_ms['preintegrate'])} calls), optimize {ms['optimize']:.2f} "
            f"({len(est.stage_ms['optimize'])}), marginalize {ms['marginalize']:.2f} "
            f"({len(est.stage_ms['marginalize'])}); wall {seconds:.1f} s for {data_s:.1f} s "
            f"of data ({seconds / data_s:.3f} s per s)")


def phase_estimator(dev):
    """Phase 5: the full-width Estimator on the defaults fixture's streams
    against the JAX run stored beside them."""
    import torch

    fx = dict(np.load(ESTIMATOR_FIXTURE))
    s = scenario(fx, "defaults")
    ref = {k[4:]: v for k, v in s.items() if k.startswith("out/")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, got = run_estimator(s, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg = est.cfg
    dp, dq = compare_estimator(got, ref, CARD_TRAJ_ATT_ATOL)
    e = trajectory_errors(got["traj_t"], got["traj_p"], s, 5.0)
    log(f"phase 5 estimator ({cfg.max_nodes} nodes x {cfg.max_landmarks} landmarks, f64, "
        f"{cfg.optimize_num_iterations} iters, window {cfg.optimize_windows_size}): "
        f"{len(got['stats'])} rounds, {int(got['log'][-1, 2])} keyframes, peak landmark slots "
        f"{int(got['log'][:, 3].max())}, final state {est.state}; identical to JAX in events, "
        f"node times, keyframes, LM steps; trajectory vs JAX {dp:.3g} m (<= {TRAJ_POS_ATOL}), "
        f"{dq:.3g} rad (<= {CARD_TRAJ_ATT_ATOL}); "
        f"ATE {np.sqrt(np.mean(e ** 2)):.4f} m (JAX {float(ref['ate_rmse']):.4f})")
    log("phase 5 " + stage_line(est, wall, float(s["imu_t"][-1])))


def phase_pipeline(dev):
    """Phase 6: the full-width Pipeline on 1278 x 1022 frames rendered at
    the defaults fixture's truth camera poses (pinhole: no distortion)."""
    import torch

    from ic_gvins_tpu_torch.engine.estimator import TRACKING_NORMAL
    from ic_gvins_tpu_torch.vision import klt_cuda

    fx = dict(np.load(ESTIMATOR_FIXTURE))
    s = scenario(fx, "defaults")
    klt_cuda.lk_track_bidirectional.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the renderer draws a pinhole: no distortion
    pipe, got, tracked = run_pipeline(s, dev, use_clahe=True,
                                      cam={"distortion": (0.0, 0.0, 0.0, 0.0)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = klt_cuda.lk_track_bidirectional.launches
    est = pipe.est
    e = trajectory_errors(got["traj_t"], got["traj_p"], s, PIPELINE_T_MIN)
    ate = float(np.sqrt(np.mean(e ** 2)))
    fm = np.asarray(pipe.frame_ms)
    log(f"phase 6 pipeline ({len(s['frame_t'])} frames of {est.cfg.cam.resolution[0]}x"
        f"{est.cfg.cam.resolution[1]}, {est.cfg.track_max_features} features, CLAHE, "
        f"FM-RANSAC): final state {est.state} (>= {TRACKING_NORMAL}), {est.n_keyframes} "
        f"keyframes in the window, {len(est.lm_slot)} landmark slots, {len(got['stats'])} "
        f"rounds; KLT launches {launches} for {tracked} tracked frames; ATE after "
        f"{PIPELINE_T_MIN:.0f} s {ate:.4f} m (< {PIPELINE_ATE}), max {e.max():.4f} m")
    log(f"phase 6 front end ms per frame: first {fm[0]:.2f}, median {np.median(fm[1:]):.2f}, "
        f"max {fm[1:].max():.2f}; " + stage_line(est, wall, float(s["imu_t"][-1])))
    check(est.state == TRACKING_NORMAL, "the pipeline did not reach TRACKING_NORMAL")
    check(est.n_keyframes >= 2 and len(est.lm_slot) >= 10, "too few keyframes or landmarks")
    check(tracked > 0 and launches == tracked, "the KLT kernel was not launched once per "
          "tracked frame")
    check(ate < PIPELINE_ATE, f"pipeline ATE {ate:.3f} m >= {PIPELINE_ATE}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "ic_gvins_tpu_torch")) or not all(
            os.path.exists(f) for f in (FIXTURE, ESTIMATOR_FIXTURE)):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ic_gvins_tpu_torch.vision import klt_cuda

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_build()
    frames = make_frames(N_FRAMES)
    klt_stats = phase_klt(frames, dev)
    phase_preprocess(frames, dev)

    # each path of the main path with the launch counts set to 0 just
    # before it and read just after; the KLT lies on phases 3 and 6
    klt_cuda.lk_track_bidirectional.launches = 0
    phase_frontend(frames, dev)
    launches_frontend = klt_cuda.lk_track_bidirectional.launches
    check(launches_frontend > 0, "the front end never launched the KLT kernel")
    phase_round(dev)
    phase_estimator(dev)
    launches_pipeline = phase_pipeline(dev)
    launches = launches_frontend + launches_pipeline
    log(f"klt launches: frontend {launches_frontend}, pipeline {launches_pipeline}")
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s, the build included")

    print(json.dumps({"kernels": [{
        "name": "klt_bidirectional", "route": "cuda",
        "source": "ic_gvins_tpu_torch/csrc/klt.cu",
        "replaces": "ic_gvins_tpu/vision/klt_pallas.py:269",
        "launches": launches, **klt_stats,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
