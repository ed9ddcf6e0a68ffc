#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ic_gvins_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path at the engine's default sizes: the visual
front end (``Frontend.process`` with its defaults: CLAHE, bidirectional
KLT, FM-RANSAC) over 1278 x 1022 frames with 200 features and a 4-image
pyramid; one GVINS keyframe round on a 24-node x 192-landmark float64
window (preintegrate -> triangulate -> ``optimize_impl(iters=20)`` ->
``marginalize_and_slide``); then the engine as users call it: the
``Estimator`` on sensor streams, the replay command on a recorded drive
(CSV and PNG files), whose ``Pipeline`` tracks the camera frames, both
with ``EngineConfig()``, and the ``Estimator`` with the wheel odometer
and its checkpoints; then the simulator and the two commands that run on
it, ``run_sim`` and ``run_urban``; then the ``parallel/`` package (a
batch of 32 windows, landmark shards, node chunks); then the engine's
float32 mode on these paths; then the ``parallel/`` paths across
``torch.distributed`` ranks. Phases:

1. the card's name and power limit; build the CUDA kernel (nvcc, sm_90a);
2. KLT kernel vs its plain PyTorch version at slice shapes (200 features)
   and at 1000 and 4000 features, with times and the roofline bound of the
   work the kernel counted; then CLAHE on the card vs the CPU and FM-RANSAC
   on a synthetic two-view scene with 20% gross outliers;
3. ``Frontend.process`` over 8 frames shifted by a known subpixel flow, and
   the histogram gate on a frame at a quarter of the brightness;
4. the keyframe round, held against the JAX package's float64 results in
   ``tests/fixtures/torch_slice_24x192.npz`` (``tools/make_torch_fixture.py``);
5. ``Estimator(EngineConfig())`` unchanged, so with the C++ IMU buffer of
   the port's native library, fed 15 s of IMU (200 Hz), GNSS (1 Hz) and
   ideal tracks (10 Hz) from ``tests/fixtures/torch_estimator_defaults.npz``,
   held against the JAX ``Estimator(EngineConfig())`` run stored there
   (``defaults_native``, ``tools/make_torch_estimator_fixture.py``): the
   same events, node times, keyframes and LM steps, the trajectory within
   1e-6 m / 1e-7 rad. It prints where the JAX runs with the Python and the
   C++ buffer part;
6. the replay command ``python -m ic_gvins_tpu_torch.tools.run_kaist`` (its
   ``main``) on a KAIST-layout directory written from the same streams:
   IMU and GNSS as CSV (fixes in geodetic coordinates), 150 frames of
   1278 x 1022 rendered at the fixture's truth camera poses as 8-bit PNGs,
   a TUM truth file and a ``gvins.yaml`` for the pinhole camera. The
   ``Pipeline`` it drives (the defaults without lens distortion) must reach
   TRACKING_NORMAL, launch the KLT kernel once per tracked frame, stay
   under tests/test_pipeline.py's 0.45 m ATE after 4 s, write its output
   files and report the ATE of its own trajectory.csv. The CSV load and
   PNG decode times print on their own lines;
7. ``Estimator(EngineConfig(odo=OdoConfig(use_odo=True)))`` at full width on
   ``tests/fixtures/torch_estimator_odo.npz`` (the defaults streams, GNSS
   until 9 s, a 50 Hz wheel odometer) against the JAX run stored there:
   the same decisions, the trajectory within 1e-6 m / 1e-7 rad, the
   odometer scale within 1e-8; then the run resumed in a fresh estimator
   from its own checkpoint and from the JAX run's, both taken after the
   middle event, within the same bounds of the run it continues;
8. the simulator and its commands: (a) the port's simulator on the card
   against ``tests/fixtures/torch_sim.npz`` (``tools/make_torch_sim_fixture.py``)
   with the JAX draws: the seed-3 urban route and the time grids bit for
   bit, the float64 streams within 1e-10 relative, a 320 x 240 full-frame
   render within 1e-3 grey levels; (b) ``run_urban --gen`` at KAIST
   urban38's 2154 s (its wall time and file size), and mechanizing the
   clean increments of an urban stretch back to the truth; (c) ``run_sim
   --vision --gnss-outage-time 20`` (30 s) under an ATE bound; (d)
   ``run_urban`` replaying the JAX runner's 90 s drive
   (``tests/fixtures/torch_urban90.npz``) through the ``Pipeline`` at full
   width (320 x 240, 120 features, 20 x 160 window, 12 iterations) with a
   GNSS outage: TRACKING_NORMAL, one KLT launch per tracked frame, ATE
   bounds beside the JAX replay of the file, and its checkpoint resumed in
   a fresh ``Estimator``; then the KLT kernel timed at that shape beside
   its plain version and bound. Phases 6 and 8 print their decisions
   beside the JAX runs' (rounds, ATE, where the trajectories part);
9. the ``parallel/`` package on the card, against
   ``tests/fixtures/torch_parallel.npz`` (``tools/make_torch_parallel_fixture.py``):
   (a) ``optimize_batch`` of BATCH = 32 perturbations of the 24 x 192
   float64 window (bench.py's batch; each sequence with its own damping,
   gates and early exit) against each sequence's own ``optimize`` and, for
   the first four, the JAX ``optimize_batch``, with the batched call's and
   the 32 single rounds' ms, launches and busy share; (b)
   ``optimize_sharded`` with 8 landmark shards against ``optimize`` at
   tests/test_sharding.py's tolerances, and ``Estimator.set_mesh`` on
   phase 5's streams cut to their first 8 s against phase 5's run; (c)
   ``ba_nodes_solve`` at N = 256 nodes, 8 chunks, a band of 8, against the
   one-chunk solve and the JAX solves. Phase 9 launches no hand kernel:
   the JAX package writes these modules in jnp, outside any Pallas
   kernel;
10. the float32 engine mode (``dtype=torch.float32``: window re-centering,
   the Newton-Schulz reduced solve, the float32 marginalization) against
   the JAX package's float32 mode in ``tests/fixtures/torch_f32.npz``
   (``tools/make_torch_f32_fixture.py``): (a) ``solve_reduced`` and
   ``marginalize_node0`` in float32, then phase 4's round in float32
   beside float64 (stage ms, launches); (b) ``Estimator(EngineConfig(),
   dtype=torch.float32)`` on phase 5's streams against the JAX float32
   and float64 runs, its stage medians beside phase 5's; (c) ``run_kaist
   --f32`` on phase 6's directory; (d) ``run_urban --f32`` on the first
   45 s of phase 8's drive (no ATE bound: the JAX float32 replay diverges
   on this route; cut from 90 s in depth to make room for phase 11);
   (e) ``optimize_batch`` of phase 9's 32 windows in float32 against each
   one's float32 ``optimize``;
11. phase 9's paths across ``torch.distributed`` ranks (``parallel/``
   with a distributed ``Mesh``): W = 2 and W = 4 processes, started with
   the ``spawn`` method, joined by ``gloo``, every rank on the one card,
   each running (a) ``optimize_sharded`` of phase 9's sequence 0 with 8
   global landmark shards (8 / W a rank), (b) ``ba_nodes_solve`` at N =
   256 with 8 chunks over the ranks, (c) ``optimize_batch`` of the 32
   windows split over the ranks, (d) ``Estimator.set_mesh`` on phase 5's
   first 8 s. Every rank's results must be bit for bit rank 0's; (a)-(c)
   within 1e-10 m of phase 9's one-process runs with their decisions and
   within 1e-8 m of JAX, (d) phase 5's decisions within phase 9 (b)'s
   bounds. It prints each path's wall and all-reduces beside phase 9's
   one-process time. (e) the same with ``nccl``, one rank per card, where
   the machine shows as many cards as ranks; otherwise a line says it did
   not run;
12. the entry points ``ic_gvins_tpu_torch/entry.py`` (the counterpart of
   ``__graft_entry__.py``): (a) ``entry()`` with no device, and its
   ``forward`` (the dense normal equations: ``assemble`` ->
   ``schur_solve`` -> ``apply_delta``) on ``tiny_problem()`` (6 x 16) and
   at full width on ``tiny_problem(24, 192)`` (D = 560), in float64 and
   float32, against the JAX forward in ``tests/fixtures/torch_entry.npz``
   (``tools/make_torch_entry_fixture.py``), the block path and itself
   repeated bit for bit, with the dense and the block step's ms and
   launches; (b) ``dryrun_multichip(n)`` (JAX's sharded round, node-chunked
   BA and dp x lm batch at JAX's shapes) across 2 and 4 ``gloo`` ranks on
   the one card, both worlds spawned at once, and meanwhile in one process
   with n = 2 and 4 shards: every rank's results bit for bit rank 0's and
   within 1e-10 m of the one-process run; (c) the same with ``nccl`` where
   the machine shows a card per rank, else a line says it did not run.

Phases 3 to 12 run with the kernel's launch count set to 0 before each and
read after it; the ``launches`` of the kernels line sums phases 3, 6, 8
and 10 (c) and (d); phase 9, phase 10 (a), (b) and (e) and phases 11 and
12 must launch it no time.
Every phase raises on failure. Needs a CUDA device: without one it exits
with code 1 and prints no result. Prints a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager, redirect_stdout

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_slice_24x192.npz")
ESTIMATOR_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_estimator_defaults.npz")
ODO_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_estimator_odo.npz")
SIM_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_sim.npz")
URBAN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_urban90.npz")
PARALLEL_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_parallel.npz")
F32_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_f32.npz")
ENTRY_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_entry.npz")

IMG_W, IMG_H = 1278, 1022  # engine default camera
N_FEATURES = 200
KLT_SIZES = (N_FEATURES, 1000, 4000)  # features per call in phase 2
PYR_LEVELS = 3  # -> 4 pyramid images
CELL = 64
FLOW = (1.3, -0.7)  # known per-frame shift (x, y) in px
N_FRAMES = 8
ITERS = 20
BATCH = 32  # sequences of phase 9's optimize_batch (bench.py's BATCH)
BATCH_SEED = 100  # numpy seed of sequence b: BATCH_SEED + b
BATCH_JAX = 4  # sequences 0..3 are held against the JAX optimize_batch
SHARDS = 8  # landmark shards of phase 9's optimize_sharded
SHARDED_S = 8.0  # s of phase 5's streams that phase 9 replays landmark-sharded
BATCH_POS_ATOL = 1e-8  # m, a batch member against its own round
DIST_WORLDS = (2, 4)  # ranks of phase 11
DIST_TIMEOUT = 60.0  # s, the process group's bound on each collective
DIST_SPAWN_TIMEOUT = 400.0  # s, one spawn of phase 11's ranks
# across ranks against one process with the same global shard count: the
# sums over the ranks round otherwise; against JAX, tests/test_multihost.py
DIST_POS_ATOL = 1e-10  # m
DIST_JAX_POS_ATOL = 1e-8  # m
# phase 12: the entry's dense step against JAX's and the block path
ENTRY_POS_ATOL = {"float64": 1e-9, "float32": 1e-4}  # m
ENTRY_COST_RTOL = {"float64": 1e-10, "float32": 1e-5}
ENTRY_REPS = 10  # timed forwards of each kind after the warm-up
DRYRUN_SHARDS = (2, 4)  # shards, and ranks, of phase 12 (b)

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
# the odometer scale of the full-width odometer run vs JAX on the card
CARD_SODO_ATOL = 1e-8
# KAIST-layout sequences written for the replay entry point: the local
# frame's geodetic anchor (the latitude of the simulator's Earth rate) and
# unix stamps of the dataset's epoch
ORIGIN_BLH = (np.radians(30.5), np.radians(114.3), 20.0)
T_BASE = 1.7e9  # s
# Pipeline on rendered frames: tests/test_pipeline.py's ATE bound (after 4 s)
PIPELINE_ATE = 0.45  # m
PIPELINE_T_MIN = 4.0  # s
# Simulator vs the JAX package's on the same draws: time grids and the
# route's arrays bit for bit; the float64 streams to rounding (forward-mode
# derivatives of the same closed forms, summed in another order), relative
# to each array's largest entry; the rendered frame, float32 blobs summed in
# batches where JAX adds them one by one, in grey levels.
SIM_RTOL = 1e-10
SIM_FRAME_ATOL = 1e-3  # grey levels
SIM_EXACT = ("imu_time", "imu_dt", "gnss_time", "odo_t", "frame_t", "vis")
SIM_CLOSE = ("imu_dtheta", "imu_dvel", "imu_dtheta_c", "imu_dvel_c", "truth_p", "truth_q",
             "truth_v", "gnss_p", "odo_v", "landmarks", "uv")
# Phase 8. Generation at KAIST urban38's length (s of data).
URBAN38_S = 2154.0
# Mechanizing the clean increments of the urban route from the truth: the
# acceleration steps at segment junctions (a corner's onset), which the
# quadrature does not resolve, leave a few mm over 30 s with an arc (the
# CPU: 3.2 mm, 1.0e-4 m/s, 1.2e-5 rad over 80-110 s), where
# tests/test_mechanization.py's smooth car drive keeps 2e-3 m.
MECH_STRETCH = (80.0, 110.0)  # s, with the route's first arc
MECH_POS, MECH_VEL, MECH_ATT = 1e-2, 1e-3, 1e-4  # m, m/s, rad
# run_sim --vision --gnss-outage-time 20 (30 s, GNSS sigma 0.05 m): JAX's
# recipe expects 0.08-0.15 m with GNSS throughout; vision bridges the last
# 10 s here (the CPU: 0.194 m, max 0.595 m)
RUN_SIM_ATE = 0.3  # m
# run_urban replay of the JAX-written 90 s drive (torch_urban90.npz, the
# JAX runner's replay flags): duration, one outage, one checkpoint (s)
URBAN_S = 90.0
URBAN_OUTAGE = (60.0, 75.0)
URBAN_CKPT = 60.0
# phase 10 (d)'s float32 replay of that drive, cut in depth to its first
# 45 s (before the outage) so that phase 11 fits in the smoke's time
URBAN_F32_S = 45.0
# its ATE (errors after 10 s): the port on the CPU 0.560 m rms, 2.33 m max;
# the JAX runner on this file 0.530 / 2.58 m (stored beside it), on 300 s
# of the same drive 0.306 / 2.58 m. Both have a start-up transient of ~2 m
# at 25-35 s, which the card's otherwise rounded sums can amplify.
URBAN_ATE_RMSE = 1.0  # m
URBAN_ATE_MAX = 4.0  # m
# the checkpoint at 60 s resumed with IMU and GNSS to 90 s (the CPU: 0.213
# m rms, 0.411 m max)
URBAN_RESUME_ATE = 1.0  # m, max
# ~0.1 s of spinning at 2 GHz: far longer than the host takes to enqueue
# 50 calls of the KLT wrapper (~0.13 ms each on the slowest host seen)
SPIN_CYCLES = 200_000_000
# Phase 10, the float32 engine mode, against tests/fixtures/torch_f32.npz
# (tools/make_torch_f32_fixture.py: the JAX package with x64 off). The
# reduced solve: the 24 x 192 round's scaled system has condition number
# 2.7e4, so float32 solves that sum in another order part by ~1e-4 to 1e-3
# (the CPU: 4.0e-4 from JAX, 7.7e-3 from float64); the SPD matrix's
# (condition 4) by rounding. tests/test_torch_f32.py holds the same bounds.
F32_SOLVE_VS_JAX = {"round": 1e-3, "spd": 1e-4}
F32_SOLVE_VS_F64 = {"round": 1.5e-2, "spd": 1e-5}
F32_PRIOR_FRO = 4e-3  # relative Frobenius of the marginalization's H vs JAX
F32_PRIOR_EIG_FLOOR = -1e-6  # its smallest eigenvalue, relative to the largest
F32_TIME_ATOL = 1e-5  # s, float32 node times against the 200 Hz truth grid
# the float32 round's optimum vs JAX's float64 one (the CPU: 1.4e-2 m)
F32_ROUND_POS_ATOL = 0.05  # m
# the float32 Estimator at full width vs the JAX float32 run of its streams:
# float32 LM decisions (accept on a cost comparison) may part on the card,
# so the trajectory and ATE are held, not the events
F32_TRAJ_VS_JAX32 = 0.05  # m
F32_ATE_MARGIN = 0.02  # m over JAX float32's ATE
# a float32 batch member against its own float32 round: float32 accept
# decisions part on the near-optimal members (the CPU: 9.6e-4 m)
F32_BATCH_POS_ATOL = 5e-3  # m


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
    odo_kw = kw.pop("odo", None)
    cfg = config_mod.EngineConfig(**kw, **overrides)
    if cam_kw:
        cfg.cam = config_mod.CameraConfig(**tup(cam_kw))
    if odo_kw:
        cfg.odo = config_mod.OdoConfig(**tup(odo_kw))
    return cfg


def to_np(x):
    """A tensor of either package (or a number) as a float64 or bool numpy array."""
    x = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return x if x.dtype == bool else x.astype(np.float64)


def schedule(s):
    """A scenario's sensor calls in the order of the JAX package's tests,
    as (kind, index): for each IMU sample the odometer samples stamped at
    or before it, the sample itself, then the GNSS fixes and the frames
    stamped at or before it."""
    calls = []
    imu_t, gt, ft = s["imu_t"], s["gnss_t"], s["frame_t"]
    ot = s.get("odo_t", np.zeros(0))
    gi = fi = oi = 0
    for k in range(len(imu_t)):
        t = imu_t[k]
        while oi < len(ot) and ot[oi] <= t:
            calls.append(("odo", oi))
            oi += 1
        calls.append(("imu", k))
        while gi < len(gt) and gt[gi] <= t:
            calls.append(("gnss", gi))
            gi += 1
        while fi < len(ft) and ft[fi] <= t:
            calls.append(("frame", fi))
            fi += 1
    return calls


def feed(sink, est, s, on_frame, start=0, on_event=None):
    """Feed a scenario's streams (``schedule``) to ``sink`` (an
    ``Estimator`` or a ``Pipeline`` of either package; ``est`` is its
    estimator); ``on_frame(j)`` hands frame j to the sink. An event is a
    fix or a frame; ``start`` skips the calls up to and including event
    ``start - 1`` (to continue a run resumed from a checkpoint taken
    there), and ``on_event(e)`` runs after event e. Returns the event log,
    one row per event fed: ``log`` (engine state, nodes, keyframes,
    landmark slots in use, stats rows) and the node times and keyframe
    flags, padded to the window."""
    n_cap = est.cfg.max_nodes
    rows, node_t, node_kf = [], [], []

    def record():
        rows.append((est.state, est.n_nodes, est.n_keyframes, len(est.lm_slot), len(est.stats)))
        node_t.append(np.pad(np.asarray(est.node_times, np.float64), (0, n_cap - est.n_nodes),
                             constant_values=np.nan))
        node_kf.append(np.pad(np.asarray(est.node_is_kf, bool), (0, n_cap - est.n_nodes)))

    event = 0
    for kind, i in schedule(s):
        if event < start:
            event += kind in ("gnss", "frame")
            continue
        if kind == "odo":
            sink.add_odo(float(s["odo_t"][i]), float(s["odo_v"][i]))
        elif kind == "imu":
            sink.add_imu(float(s["imu_t"][i]), float(s["imu_dt"][i]), s["imu_dth"][i],
                         s["imu_dv"][i])
        else:
            if kind == "gnss":
                sink.add_gnss(float(s["gnss_t"][i]), s["gnss_p"][i], s["gnss_std"][i])
            else:
                on_frame(i)
            record()
            if on_event is not None:
                on_event(event)
            event += 1
    return {"log": np.asarray(rows, np.int64).reshape(-1, 5), "log_node_t": np.asarray(node_t),
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


def grid_index(traj_t, s, atol_t=1e-9):
    """The samples of the scenario's 200 Hz truth grid at the trajectory's
    node times; a float32 engine's node times lie within its rounding
    (``atol_t``) of the grid."""
    idx = np.rint((traj_t - s["truth_t"][0]) * 200.0).astype(np.int64)
    check(np.all(np.abs(s["truth_t"][idx] - traj_t) < atol_t), "trajectory off the truth grid")
    return idx


def trajectory_errors(traj_t, traj_p, s, t_min, atol_t=1e-9):
    """Position errors of the trajectory entries at or after ``t_min``
    against the scenario's 200 Hz truth (``grid_index``)."""
    idx = grid_index(traj_t, s, atol_t)
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


def write_kaist_dir(root, s, cfg):
    """Write a scenario as a KAIST-layout sequence for
    ``ic_gvins_tpu_torch.tools.run_kaist``: ``sensor_data/xsens_imu.csv``
    (ns stamps, rates), ``sensor_data/vrs_gps.csv`` (the fixes converted to
    geodetic about ORIGIN_BLH by the port's ``earth.local_to_global``),
    ``image/stereo_left/<ns>.png`` (frames rendered with ``cfg``'s camera
    at the truth poses, 8-bit grey, by the port's PNG writer), ``truth_tum.txt``
    (200 Hz truth positions in the replay's frame, anchored at the first
    fix) and ``gvins.yaml`` (``cfg``'s camera and window). Returns
    (config path, truth path, truth times, truth positions in the replay's
    frame, seconds spent writing PNGs)."""
    import torch

    from ic_gvins_tpu_torch.common import earth
    from ic_gvins_tpu_torch.data.image import write_png
    from ic_gvins_tpu_torch.data.simulator import render_sprite_frame_np

    sensor = os.path.join(root, "sensor_data")
    img_dir = os.path.join(root, "image", "stereo_left")
    os.makedirs(sensor, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    ns = lambda t: np.int64(np.rint((T_BASE + np.asarray(t, np.float64)) * 1e9))  # noqa: E731
    dt = s["imu_dt"][:, None]
    rows = np.concatenate([np.zeros((len(dt), 7)), s["imu_dth"] / dt, s["imu_dv"] / dt], 1)
    rows[:, 0] = 1.0  # quaternion w; the replay reads rates only
    with open(os.path.join(sensor, "xsens_imu.csv"), "w") as f:
        for t_ns, r in zip(ns(s["imu_t"]), rows):
            f.write(f"{t_ns}," + ",".join(f"{x:.17g}" for x in r) + "\n")
    tt = lambda x: torch.as_tensor(np.asarray(x, np.float64))  # noqa: E731
    blh = earth.local_to_global(tt(ORIGIN_BLH), tt(s["gnss_p"])).numpy()
    with open(os.path.join(sensor, "vrs_gps.csv"), "w") as f:
        for t_ns, b in zip(ns(s["gnss_t"]), blh):
            f.write(f"{t_ns},{np.degrees(b[0]):.15f},{np.degrees(b[1]):.15f},{b[2]:.6f}\n")
    png_s = 0.0
    for j, t in enumerate(s["frame_t"]):
        img = render_sprite_frame_np(cfg.cam.intrinsic, cfg.cam.resolution, s["sprites"],
                                     s["cam_t_wc"][j], s["cam_q_wc"][j])
        t0 = time.perf_counter()
        write_png(os.path.join(img_dir, f"{ns(t)}.png"), np.rint(img).astype(np.uint8), level=1)
        png_s += time.perf_counter() - t0
    # the replay anchors its local frame at the first fix
    truth_p = earth.global_to_local(tt(blh[0]), earth.local_to_global(
        tt(ORIGIN_BLH), tt(s["truth_p"]))).numpy()
    truth_path = os.path.join(root, "truth_tum.txt")
    with open(truth_path, "w") as f:
        for t_ns, p in zip(ns(s["truth_t"]), truth_p):
            f.write(f"{t_ns * 1e-9:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f}\n")
    c = cfg.cam
    qw, qx, qy, qz = c.q_b_c
    fmt = lambda v: "[" + ", ".join(repr(float(x)) for x in v) + "]"  # noqa: E731
    cfg_path = os.path.join(root, "gvins.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"""# {len(s['frame_t'])} frames of {c.resolution[0]}x{c.resolution[1]}
imudatarate: {cfg.imudatarate}
iswithearth: {str(cfg.iswithearth).lower()}
antlever: {fmt(cfg.antlever)}
track_min_parallax: {cfg.track_min_parallax}
track_max_interval: {cfg.track_max_interval}
track_max_features: {cfg.track_max_features}
reprojection_error_std: {cfg.reprojection_error_std}
optimize_windows_size: {cfg.optimize_windows_size}
optimize_num_iterations: {cfg.optimize_num_iterations}
optimize_estimate_extrinsic: {str(cfg.optimize_estimate_extrinsic).lower()}
optimize_estimate_td: {str(cfg.optimize_estimate_td).lower()}
cam0:
  intrinsic: {fmt(c.intrinsic)}
  distortion: {fmt(c.distortion)}
  resolution: [{c.resolution[0]}, {c.resolution[1]}]
  q_b_c: {fmt((qx, qy, qz, qw))}  # x, y, z, w
  t_b_c: {fmt(c.t_b_c)}
  td_b_c: {float(c.td_b_c)}
""")
    return cfg_path, truth_path, ns(s["truth_t"]) * 1e-9, truth_p, png_s


def replay_errors(out_dir, truth_t, truth_p):
    """(stamps, position errors) of a replay's ``trajectory.csv``, each row
    against the truth sample nearest in time (both lie on the same 200 Hz
    grid)."""
    rows = np.loadtxt(os.path.join(out_dir, "trajectory.csv"), ndmin=2)
    t, p = rows[:, 0], rows[:, 1:4]
    idx = np.clip(np.searchsorted(truth_t, t), 1, len(truth_t) - 1)
    idx -= (t - truth_t[idx - 1]) < (truth_t[idx] - t)
    check(np.all(np.abs(truth_t[idx] - t) < 1e-3), "trajectory off the truth grid")
    return t, np.linalg.norm(p - truth_p[idx], axis=1)


def rms(x):
    return float(np.sqrt(np.mean(np.square(x))))


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


def sim_stretch(sp, ref, route, params, dev):
    """A stretch of the simulator fixture (``tools/make_torch_sim_fixture.py``)
    computed by the port on ``dev`` with the JAX draws of ``ref``: a dict of
    numpy arrays under the fixture's names."""
    import torch

    from ic_gvins_tpu_torch.common import rotation as rot
    from ic_gvins_tpu_torch.data import simulator as sim

    t0, dur = sp["t0"], sp["duration"]
    traj = sim.car_trajectory() if sp["traj"] == "car" else sim.urban_trajectory(route)
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)  # noqa: E731
    imu = sim.simulate_imu(traj, params, t0, dur, sp["imu_rate"])
    bad = sim.corrupt_imu(imu, params, sp["bg"], sp["ba"], noise=(ref["noise_g"], ref["noise_a"]))
    gnss = sim.simulate_gnss(traj, params, sp["antlever"], t0, dur, sp["gnss_rate"],
                             std=sp["gnss_std"], noise=ref["gnss_noise"])
    odo_t, odo_v = sim.simulate_odometer(traj, params, t0, dur, sp["odo_rate"],
                                         sodo_true=sp["sodo_true"], noise_std=sp["odo_noise"],
                                         noise=ref["odo_noise"])
    lms = sim.scatter_landmarks(traj, params, None, sp["n_landmarks"], t0, t0 + dur + 3.0,
                                draws=(ref["lm_ts"], ref["lm_depth"], ref["lm_off"]))
    n_frames = int(dur * sp["frame_rate"])
    ftimes = sim.time_grid(t0, n_frames, sp["frame_rate"], first=1, device=dev)
    ext_q = rot.matrix_to_quat(f64(sp["cam_r"]))
    uv, vis = sim.project_landmarks(traj, params, lms, ftimes, sp["cam_p"], ext_q,
                                    noise_std=sp["px_noise"], noise=ref["px_noise"])
    st = sim.truth_state(traj, params, ftimes)
    frame = sim.render_sprite_frame(tuple(sp["intr"]), tuple(sp["res"]), lms, ref["render_t_wc"],
                                     ref["render_q_wc"])
    out = dict(imu_time=imu.time, imu_dt=imu.dt, imu_dtheta=imu.dtheta, imu_dvel=imu.dvel,
               imu_dtheta_c=bad.dtheta, imu_dvel_c=bad.dvel, gnss_time=gnss.time, gnss_p=gnss.p,
               odo_t=odo_t, odo_v=odo_v, landmarks=lms, frame_t=ftimes, uv=uv, vis=vis,
               truth_p=st.p, truth_q=st.q, truth_v=st.v, frame=frame)
    return {k: v.cpu().numpy() for k, v in out.items()}


def compare_sim(got, ref):
    """Hold a stretch of the port (``sim_stretch``) against the fixture's:
    raises on a difference; returns (worst relative error and its array,
    frame error in grey levels)."""
    for k in SIM_EXACT:
        check(got[k].shape == ref[k].shape and np.array_equal(got[k], ref[k]),
              f"simulator {k} differs from JAX")
    errs = {k: rel_err(ref[k], got[k]) for k in SIM_CLOSE}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= SIM_RTOL, f"simulator {worst}: relative error {errs[worst]:.3g} "
          f"> {SIM_RTOL}")
    frame_err = float(np.max(np.abs(got["frame"] - ref["frame"])))
    check(frame_err <= SIM_FRAME_ATOL, f"rendered frame {frame_err:.3g} grey levels from JAX")
    return worst, errs[worst], frame_err


def card() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_build():
    from ic_gvins_tpu_torch.vision import klt_cuda

    log(card())
    t0 = time.perf_counter()
    klt_cuda.load_library()
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a)")
    for line in klt_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def klt_bound(work, n, pyr, phase="phase 2"):
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
    log(f"{phase} klt bound n={n}: level passes {per_level} (level 0 first), {steps} steps "
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
    from ic_gvins_tpu_torch.common.prng import ransac_uniforms

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
    u = ransac_uniforms(0)
    inl, F = fundamental_ransac(*args, u)
    inl = inl.cpu().numpy()
    kept = float(inl[~is_out].mean())
    ms_ransac = cuda_ms(lambda: fundamental_ransac(*args, u), 5)
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


def perturb_round(win, opt, b):
    """Sequence ``b`` of phase 9's batch from the round's window ``win``
    (a nested dict of numpy arrays) and the JAX round's optimum ``opt``
    (``nodes``, ``lm_invdepth``). Sequences with b % 4 < 2 start at the
    window with their own node and depth perturbation, larger for higher
    ``b % 8``, and every third of them has two observations pushed 0.03
    (about 15 sigma) off their track, which the chi2 gate culls; the others
    start at the optimum moved by 1e-3 m (b % 4 == 2) or 1e-6 m (b % 4 ==
    3) times 1 + b // 4, so the sequences stop after different numbers of
    iterations."""
    rng = np.random.default_rng(BATCH_SEED + b)
    out = dict(win)
    n = win["nodes"]["p"].shape[0]
    if b % 4 >= 2:
        nodes = dict(opt["nodes"])
        scale = (1e-3 if b % 4 == 2 else 1e-6) * (1 + b // 4)
        nodes["p"] = nodes["p"] + scale * rng.standard_normal((n, 3))
        out["nodes"] = nodes
        out["lm_invdepth"] = opt["lm_invdepth"].copy()
        return out
    nodes = dict(win["nodes"])
    scale = 0.01 + 0.09 * (b % 8) / 7.0
    nodes["p"] = nodes["p"] + scale * rng.standard_normal((n, 3))
    nodes["v"] = nodes["v"] + 0.5 * scale * rng.standard_normal((n, 3))
    out["nodes"] = nodes
    out["lm_invdepth"] = win["lm_invdepth"] * (1.0 + 0.02 * (b % 5) * rng.standard_normal(
        win["lm_invdepth"].shape))
    if b % 3 == 0:
        ref = win["lm_ref"].astype(np.int64)
        kf = win["node_valid"] & win["node_is_kf"]
        live = (win["obs_valid"] & win["lm_valid"][:, None] & kf[ref][:, None] & kf[None, :]
                & (np.arange(n)[None, :] != ref[:, None]))
        ls, ks = np.nonzero(live)
        pick = rng.choice(len(ls), 2, replace=False)
        uv = win["obs_uv"].copy()
        uv[ls[pick], ks[pick], 0] += 0.03
        out["obs_uv"] = uv
    return out


def tensor_bits(tree):
    """The bytes of every tensor in ``tree``, in order."""
    import torch
    from torch.utils._pytree import tree_leaves

    return [x.cpu().numpy().tobytes() for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def round_once(win, prior, cfg, params, imu):
    """Phase 4's keyframe round (preintegrate -> triangulate -> optimize ->
    marginalize) on the given inputs, each stage timed on a synchronized
    host clock: ((preintegrated window, inverse depths, triangulated flags,
    optimized window, LM stats, slid window, prior), stage ms)."""
    from ic_gvins_tpu_torch.engine.keyframe import preintegrate_window, triangulate_window
    from ic_gvins_tpu_torch.factors.marginalization import marginalize_and_slide
    from ic_gvins_tpu_torch.solver.lm import optimize_impl

    ms = {}
    w, ms["preint"] = timed(lambda: preintegrate_window(win, params, imu))
    (w, invd, ok), ms["triangulate"] = timed(lambda: triangulate_window(w))
    (w_opt, stats), ms["optimize"] = timed(
        lambda: optimize_impl(w, prior, cfg, params, iters=ITERS))
    (w_sl, pr), ms["marginalize"] = timed(
        lambda: marginalize_and_slide(w_opt, prior, cfg, params))
    return (w, invd, ok, w_opt, stats, w_sl, pr), ms


def phase_round(dev):
    inputs, ref = round_inputs(dev)
    for rep in range(2):  # the first run warms the solver libraries
        (w, invd, ok, w_opt, (s1, s2, nc), w_sl, pr), ms = round_once(*inputs)
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


def run_estimator(s, dev, on_event=None, mesh=None, dtype=None, **overrides):
    """The port's ``Estimator`` (the scenario's configuration with
    ``overrides``, in ``dtype``, float64 by default; its rounds
    landmark-sharded over ``mesh`` if given) fed the scenario's ideal
    tracks on ``dev``, calling ``on_event(e, est)`` after event e:
    (estimator, feed log + summary)."""
    import torch

    from ic_gvins_tpu_torch.engine import config as tconfig
    from ic_gvins_tpu_torch.engine.estimator import Estimator

    est = Estimator(engine_config(tconfig, s, **overrides), device=dev,
                    dtype=dtype or torch.float64)
    if mesh is not None:
        est.set_mesh(mesh)
    if "ext_p" in s:  # the scenario's camera, set on the window as the JAX tests do
        est.window = est.window._replace(ext_p=est._dev(s["ext_p"]), ext_q=est._dev(s["ext_q"]))
    log = feed(est, est, s, lambda j: est.add_frame_observations(*observations(s, j)),
               on_event=None if on_event is None else lambda e: on_event(e, est))
    return est, {**log, **summarize(est)}


def run_pipeline(s, dev, use_clahe, dtype=None, **overrides):
    """The port's ``Pipeline`` (the scenario's configuration with
    ``overrides``, in ``dtype``, float64 by default) fed the scenario's IMU, GNSS and frames that the sprite
    renderer draws with the configured camera at the truth camera poses:
    (pipeline, feed log + summary, frames the KLT tracked)."""
    from ic_gvins_tpu_torch.data.simulator import render_sprite_frame_np
    from ic_gvins_tpu_torch.engine import config as tconfig
    from ic_gvins_tpu_torch.engine.pipeline import Pipeline

    cfg = engine_config(tconfig, s, **overrides)
    pipe = Pipeline(cfg, device=dev, use_clahe=use_clahe,
                    **({} if dtype is None else {"dtype": dtype}))
    fe, tracked = pipe.frontend, [0]

    def on_frame(j):
        tracked[0] += int(fe.prev_pyr is not None and fe.valid.any())
        img = render_sprite_frame_np(cfg.cam.intrinsic, cfg.cam.resolution, s["sprites"],
                                     s["cam_t_wc"][j], s["cam_q_wc"][j])
        pipe.add_image(float(s["frame_t"][j]), img)

    log = feed(pipe, pipe.est, s, on_frame)
    return pipe, {**log, **summarize(pipe.est)}, tracked[0]


def resume_estimator(s, path, dev, start, dtype=None):
    """A fresh port ``Estimator`` (in ``dtype``, float64 by default) for
    scenario ``s`` resumed from the checkpoint at ``path`` (either
    package's) and fed the calls after event ``start - 1``: (estimator,
    feed log + summary)."""
    import torch

    from ic_gvins_tpu_torch.engine import config as tconfig
    from ic_gvins_tpu_torch.engine.estimator import Estimator

    est = Estimator(engine_config(tconfig, s), device=dev, dtype=dtype or torch.float64)
    est.load_checkpoint(path)
    log = feed(est, est, s, lambda j: est.add_frame_observations(*observations(s, j)),
               start=start)
    return est, {**log, **summarize(est)}


def continuation_ref(full, ck, n_rounds):
    """What a run resumed after event ``ck`` of the run ``full`` (feed log +
    summary) must reproduce: its later events (stats rows count from 0 again:
    they are not checkpointed), its last ``n_rounds`` stats rows and its
    whole trajectory (checkpointed)."""
    log = full["log"][ck + 1:].copy()
    log[:, 4] -= full["log"][ck, 4]
    return {**full, "log": log, "log_node_t": full["log_node_t"][ck + 1:],
            "log_node_kf": full["log_node_kf"][ck + 1:], "stats": full["stats"][-n_rounds:]}


def stage_line(est, seconds, data_s):
    ms = {k: float(np.median(v)) if v else float("nan") for k, v in est.stage_ms.items()}
    return (f"median ms per call: preintegrate {ms['preintegrate']:.2f} "
            f"({len(est.stage_ms['preintegrate'])} calls), optimize {ms['optimize']:.2f} "
            f"({len(est.stage_ms['optimize'])}), marginalize {ms['marginalize']:.2f} "
            f"({len(est.stage_ms['marginalize'])}); wall {seconds:.1f} s for {data_s:.1f} s "
            f"of data ({seconds / data_s:.3f} s per s)")


def first_parting(a, b):
    """The first event at which two runs' feed logs differ (events, node
    times), or None."""
    n = min(len(a["log"]), len(b["log"]))
    for e in range(n):
        if not (np.array_equal(a["log"][e], b["log"][e]) and np.array_equal(
                a["log_node_t"][e], b["log_node_t"][e], equal_nan=True)):
            return e
    return None if len(a["log"]) == len(b["log"]) else n


def trajectory_parting(t_a, t_b, atol_t=1e-6):
    """The first trajectory entry at which two runs part (another time: a
    node made at another moment), or None."""
    n = min(len(t_a), len(t_b))
    bad = np.abs(np.asarray(t_a[:n]) - np.asarray(t_b[:n])) > atol_t
    if bad.any():
        return int(np.argmax(bad))
    return None if len(t_a) == len(t_b) else n


def parting_line(t_a, p_a, t_b, p_b):
    """Where a port run's trajectory parts from a JAX run's, in words, with
    the positions' largest gap before that entry."""
    e = trajectory_parting(t_a, t_b)
    n = min(len(t_a), len(t_b)) if e is None else e
    gap = float(np.linalg.norm(np.asarray(p_a[:n]) - np.asarray(p_b[:n]), axis=1).max()) if n else 0.0
    head = f"{len(t_a)} trajectory entries (JAX {len(t_b)})"
    if e is None:
        return f"{head} at the same times; positions at most {gap:.3g} m apart"
    return (f"{head}; the runs part at entry {e} (t = {float(t_b[min(e, len(t_b) - 1)]):.2f} s "
            f"of JAX's), positions at most {gap:.3g} m apart before it")


def phase_estimator(dev):
    """Phase 5: ``Estimator(EngineConfig())``, so with the C++ IMU buffer,
    at full width on the defaults fixture's streams against the JAX run of
    ``EngineConfig()`` stored beside them (``defaults_native``)."""
    import torch

    from ic_gvins_tpu_torch.engine.estimator import _NativeImuBuffer

    fx = dict(np.load(ESTIMATOR_FIXTURE))
    s = scenario(fx, "defaults")
    native = scenario(fx, "defaults_native")
    ref = {k[4:]: v for k, v in native.items() if k.startswith("out/")}
    py_ref = {k[4:]: v for k, v in s.items() if k.startswith("out/")}
    part = first_parting(py_ref, ref)
    log(f"phase 5: the JAX runs of these streams with the Python and the C++ IMU buffer part "
        f"at event {part} of {len(ref['log'])} (within the first 40 events: "
        f"{'yes' if part is not None and part < 40 else 'no'}); a port with only the Python "
        f"buffer would part from EngineConfig()'s JAX run there")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, got = run_estimator({**s, "cfg_json": native["cfg_json"]}, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg = est.cfg
    check(cfg.use_native_imu_buffer and isinstance(est.imu, _NativeImuBuffer),
          "EngineConfig() did not run the C++ IMU buffer")
    dp, dq = compare_estimator(got, ref, CARD_TRAJ_ATT_ATOL)
    e = trajectory_errors(got["traj_t"], got["traj_p"], s, 5.0)
    log(f"phase 5 estimator ({cfg.max_nodes} nodes x {cfg.max_landmarks} landmarks, f64, "
        f"{cfg.optimize_num_iterations} iters, window {cfg.optimize_windows_size}, C++ IMU "
        f"buffer): {len(got['stats'])} rounds, {int(got['log'][-1, 2])} keyframes, peak landmark "
        f"slots {int(got['log'][:, 3].max())}, final state {est.state}; identical to JAX in "
        f"events, node times, keyframes, LM steps; trajectory vs JAX {dp:.3g} m (<= "
        f"{TRAJ_POS_ATOL}), {dq:.3g} rad (<= {CARD_TRAJ_ATT_ATOL}); "
        f"ATE {np.sqrt(np.mean(e ** 2)):.4f} m (JAX {float(ref['ate_rmse']):.4f})")
    line = stage_line(est, wall, float(s["imu_t"][-1]))
    log("phase 5 " + line)
    return {**s, "cfg_json": native["cfg_json"]}, got, line


def head(s, t_end):
    """A scenario's streams up to ``t_end`` (s)."""
    out = dict(s)
    for prefix, keys in (("imu_t", ("imu_t", "imu_dt", "imu_dth", "imu_dv")),
                         ("gnss_t", ("gnss_t", "gnss_p", "gnss_std")),
                         ("frame_t", ("frame_t", "frame_n"))):
        keep = s[prefix] <= t_end
        for k in keys:
            out[k] = s[k][keep]
    return out


def profiled(fn):
    """Run fn once under torch.profiler: (its result, kernel launches,
    device ms summed over the kernels, wall ms, busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the raw device events: key_averages() would build a Python event tree,
    # minutes for the million launches of 32 single rounds
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    dev_ms = sum(e.duration_ns() for e in kernels) / 1e6
    return out, len(kernels), dev_ms, wall, dev_ms / wall


def timed(fn):
    """(fn's result, wall ms with the card synchronized before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def parallel_round(dev):
    """Phase 9's batch: the round's 24 x 192 window under BATCH
    perturbations (``perturb_round``) on ``dev``, and the shared prior,
    configuration and parameters."""
    from ic_gvins_tpu_torch.convert import to_torch, unflatten
    from ic_gvins_tpu_torch.data.types import IntegrationParams
    from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig, Window

    fx = dict(np.load(PARALLEL_FIXTURE))
    inp = unflatten(fx, "round/in/")
    wins = [to_torch(Window, perturb_round(inp["window"], inp["opt"], b), dev)
            for b in range(BATCH)]
    return (wins, to_torch(Prior, inp["prior"], dev), to_torch(SolverConfig, inp["cfg"], dev),
            to_torch(IntegrationParams, inp["params"], dev), fx)


def batch6_inputs(fx, dev):
    """The three 6 x 24 windows of ``tests/fixtures/torch_parallel.npz``'s
    ``batch6`` (tests/test_sharding.py's), their priors, the configuration
    and the parameters on ``dev``."""
    from ic_gvins_tpu_torch.convert import to_torch, unflatten
    from ic_gvins_tpu_torch.data.types import IntegrationParams
    from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig, Window

    inp = unflatten(fx, "batch6/in/")
    return ([to_torch(Window, inp[f"window{i}"], dev) for i in range(3)],
            [to_torch(Prior, inp[f"prior{i}"], dev) for i in range(3)],
            to_torch(SolverConfig, inp["cfg"], dev), to_torch(IntegrationParams, inp["params"], dev))


def ba_problem(fx, name, n_chunks, sep_width, dev):
    """A node-chunked BA problem of ``tests/fixtures/torch_parallel.npz``
    (``ba32`` / ``ba256``) cut into ``n_chunks`` with a band of
    ``sep_width`` on ``dev``: (problem, masked observations, parameters,
    iterations)."""
    from ic_gvins_tpu_torch.convert import to_torch, unflatten
    from ic_gvins_tpu_torch.data.types import IntegrationParams, NavState
    from ic_gvins_tpu_torch.ins.preintegration import PreintData
    from ic_gvins_tpu_torch.parallel import ba_nodes

    inp = unflatten(fx, f"{name}/in/")
    ba, dropped = ba_nodes.build_nodes_ba(
        to_torch(NavState, inp["nodes"], dev), to_torch(PreintData, inp["preint"], dev),
        inp["gnss_p"], inp["gnss_std"], inp["gnss_valid"], inp["lm_invd"], inp["lm_ref"],
        inp["obs_uv"], inp["obs_valid"], ext_p=np.zeros(3), ext_q=np.array([1.0, 0, 0, 0]),
        reproj_std=1.5 / 500.0, n_chunks=n_chunks, stencil=int(inp["stencil"]),
        sep_width=sep_width, device=dev)
    return ba, dropped, to_torch(IntegrationParams, inp["params"], dev), int(inp["iters"])


def phase_batch(dev):
    """Phase 9 (a): ``optimize_batch`` of BATCH sequences of the 24 x 192
    float64 window, ITERS iterations, against the port's own ``optimize``
    of each sequence alone (equal counts of accepted steps, iterations and
    culls; positions within 1e-8 m) and, for the first BATCH_JAX, against
    the JAX ``optimize_batch`` in ``tests/fixtures/torch_parallel.npz``;
    with the batched call's and the BATCH single rounds' ms, launches and
    busy share."""
    from ic_gvins_tpu_torch.convert import unflatten
    from ic_gvins_tpu_torch.parallel import multi_seq
    from ic_gvins_tpu_torch.solver.lm import optimize

    wins, prior, cfg, params, fx = parallel_round(dev)
    windows = multi_seq.stack_windows(wins)
    priors = multi_seq.stack_priors([prior] * BATCH)
    batched = lambda: multi_seq.optimize_batch(windows, priors, cfg, params, iters=ITERS)  # noqa: E731
    singles = lambda ws: [optimize(w, prior, cfg, params, iters=ITERS) for w in ws]  # noqa: E731
    batched()  # the first call warms vmap and the solver libraries
    (out, (c0, c1, ncull, iters, acc)), ms_b = timed(batched)
    ref, ms_s = timed(lambda: singles(wins))
    _, n_b, dev_b, wall_b, busy_b = profiled(batched)
    # a quarter of the single rounds under the profiler (every perturbation
    # class of perturb_round): the profiler's wall and events grow with the
    # launches, about a million for all 32
    _, n_s, dev_s, wall_s, busy_s = profiled(lambda: singles(wins[:BATCH // 4]))
    worst = 0.0
    for b, (w, (s1, s2, nc)) in enumerate(ref):
        check((int(ncull[b]), int(iters[b]), int(acc[b])) == (
            int(nc), s1.iters_run + s2.iters_run, s1.accepted + s2.accepted),
            f"batch member {b}: culls / iterations / accepted steps differ from its own round")
        worst = max(worst, float((out.nodes.p[b] - w.nodes.p).abs().max()))
    check(worst <= BATCH_POS_ATOL, f"batch positions {worst:.3g} m from the single rounds "
          f"(> {BATCH_POS_ATOL})")
    jx = unflatten(fx, "round/batch/")
    errs = []
    for k, got in (("n_culled", ncull), ("iters_run", iters), ("accepted", acc)):
        check(np.array_equal(got[:BATCH_JAX].cpu().numpy(), jx["stats"][k]),
              f"batch {k} differs from the JAX optimize_batch")
    for k in ("p", "v", "q"):
        errs.append(rel_err(jx["window"]["nodes"][k], getattr(out.nodes, k)[:BATCH_JAX].cpu()))
    check(max(errs) <= RTOL_ITERATIVE, f"batch nodes {max(errs):.3g} from JAX (relative)")
    it, nc = iters.tolist(), ncull.tolist()
    check(len(set(it)) > 1 and max(nc) > 0, "the batch neither stops apart nor culls")
    log(f"phase 9 (a) optimize_batch of {BATCH} sequences (24 nodes x 192 landmarks, f64, "
        f"{ITERS} iters): iterations {min(it)}-{max(it)} ({sorted(set(it))}), culls in "
        f"{sum(x > 0 for x in nc)} sequences (max {max(nc)}); every member equals its own round "
        f"(positions {worst:.3g} m), the first {BATCH_JAX} the JAX optimize_batch ({max(errs):.3g} "
        f"relative)")
    log(f"phase 9 (a) batched call {ms_b:.2f} ms, {BATCH} single rounds {ms_s:.2f} ms "
        f"({ms_s / ms_b:.2f} x); launches {n_b} for the batched call, {n_s} for the first "
        f"{BATCH // 4} single rounds (profiled); busy share {busy_b:.4f} batched ({dev_b:.2f} "
        f"ms of device time in {wall_b:.2f} ms profiled), {busy_s:.4f} single ({dev_s:.2f} "
        f"in {wall_s:.2f} ms)")
    return wins, prior, cfg, params, fx, dict(
        ms=ms_b, launches=n_b, busy=busy_b, single_ms=ms_s,
        result={"p": to_np(out.nodes.p), "stats": np.stack([to_np(x) for x in (ncull, iters, acc)])})


def round_decisions(stats) -> np.ndarray:
    """A round's decisions: accepted steps and iterations of both phases,
    and the culled observations."""
    s1, s2, n_culled = stats
    return np.array([s1.accepted, s2.accepted, s1.iters_run, s2.iters_run, int(n_culled)])


def phase_sharded(dev, wins, prior, cfg, params, phase5):
    """Phase 9 (b): ``optimize_sharded`` with SHARDS landmark shards on
    sequence 0 against ``optimize`` at tests/test_sharding.py's
    tolerances; then ``Estimator.set_mesh`` on phase 5's streams, cut to
    the first SHARDED_S s, against phase 5's unsharded run up to then."""
    from ic_gvins_tpu_torch.parallel import Mesh
    from ic_gvins_tpu_torch.parallel.lm_sharded import optimize_sharded
    from ic_gvins_tpu_torch.solver.assembly import free_mask_lm
    from ic_gvins_tpu_torch.solver.lm import optimize

    mesh = Mesh({"lm": SHARDS}, device=dev)
    (ref, (r1, r2, nr)), ms_1 = timed(lambda: optimize(wins[0], prior, cfg, params, iters=ITERS))
    (out, (s1, s2, ns)), ms_s = timed(lambda: optimize_sharded(wins[0], prior, cfg, params, mesh,
                                                               iters=ITERS))
    check(int(ns) == int(nr) and (s1.accepted, s2.accepted) == (r1.accepted, r2.accepted),
          "the sharded round's culls or accepted steps differ")
    dc = abs(float(s2.cost1) - float(r2.cost1)) / abs(float(r2.cost1))
    err = {k: float((getattr(out.nodes, k) - getattr(ref.nodes, k)).abs().max())
           for k in ("p", "v", "q")}
    free = free_mask_lm(wins[0])
    err["invd"] = float((out.lm_invdepth - ref.lm_invdepth)[free].abs().max())
    check(dc <= 1e-8, f"sharded cost1 {dc:.3g} from the single round (relative)")
    check(err["p"] <= 1e-5 and err["v"] <= 1e-5 and err["q"] <= 1e-6 and err["invd"] <= 1e-5,
          f"sharded round off the single round: {err}")
    check(bool((out.obs_valid == ref.obs_valid).all()), "sharded culling masks differ")
    log(f"phase 9 (b) optimize_sharded ({SHARDS} landmark shards, sequence 0): culls {int(ns)}, "
        f"accepted {s1.accepted}+{s2.accepted} as the single round; cost1 {dc:.3g} relative, "
        f"positions {err['p']:.3g} m, velocities {err['v']:.3g}, attitudes {err['q']:.3g}, "
        f"inverse depths {err['invd']:.3g}; {ms_s:.2f} ms sharded, {ms_1:.2f} ms single")

    s5, got5, _ = phase5
    s = head(s5, SHARDED_S)
    (est, got), ms_e = timed(lambda: run_estimator(s, dev, mesh=mesh))
    n_ev, n_rounds = len(got["log"]), len(got["stats"])
    want = {k: got5[k][:n_ev] for k in ("log", "log_node_t", "log_node_kf")}
    want.update({k: got5[k][:n_rounds] for k in ("stats", "traj_p", "traj_q")})
    dp, dq = compare_estimator(got, want, CARD_TRAJ_ATT_ATOL)
    log(f"phase 9 (b) Estimator.set_mesh({SHARDS} shards) on phase 5's first {SHARDED_S:.0f} s "
        f"(cut from {float(s5['imu_t'][-1]):.0f} s): {n_ev} events, {n_rounds} rounds with "
        f"phase 5's events, node times, keyframes and LM steps; trajectory {dp:.3g} m, "
        f"{dq:.3g} rad from phase 5's; {ms_e / 1e3:.1f} s of wall")
    return {"round": {"p": to_np(out.nodes.p), "obs_valid": to_np(out.obs_valid),
                      "decisions": round_decisions((s1, s2, ns)), "ms": ms_s},
            "estimator": {"want": want, "got": got, "ms": ms_e}}


def phase_ba_nodes(dev, fx):
    """Phase 9 (c): ``ba_nodes_solve`` at tests/test_ba_nodes.py's largest
    shape (N = 256 nodes, 8 chunks, a band of 8, landmarks across every
    cut) against the one-chunk solve and the JAX solves in the fixture."""
    from ic_gvins_tpu_torch.convert import unflatten
    from ic_gvins_tpu_torch.parallel import Mesh, ba_nodes

    band = int(fx["ba256/in/sep_width"])
    sols = {}
    for n, b in ((8, band), (1, 1)):
        ba, dropped, params, iters = ba_problem(fx, "ba256", n, b, dev)
        check(dropped == 0, f"{dropped} observations masked with {n} chunks")
        solve = lambda: ba_nodes.ba_nodes_solve(ba, params, Mesh({"nodes": n}, device=dev),  # noqa: E731
                                                iters=iters, sep_width=b)
        solve()  # warm
        sols[n] = timed(solve)
    (o8, (c0, c1, nacc, it)), ms8 = sols[8]
    (o1, _), ms1 = sols[1]
    d = {k: float((getattr(o8.nodes, k) - getattr(o1.nodes, k)).abs().max()) for k in ("p", "v")}
    inv = lambda o: np.sort(o.lm_invdepth[o.lm_valid].cpu().numpy())  # noqa: E731
    d["invd"] = float(np.abs(inv(o8) - inv(o1)).max())
    check(d["p"] <= 1e-5 and d["v"] <= 1e-5 and d["invd"] <= 1e-6,
          f"8 chunks off the one-chunk solve: {d}")
    errs = []
    for n, o in ((8, o8), (1, o1)):
        jx = unflatten(fx, f"ba256/chunks{n}/")
        check(int(sols[n][0][1][2]) == int(jx["stats"]["accepted"]),
              f"{n}-chunk accepted steps differ from JAX")
        errs += [rel_err(jx["nodes"][k], getattr(o.nodes, k).cpu()) for k in ("p", "v", "q")]
    check(max(errs) <= RTOL_ITERATIVE, f"node-chunked BA {max(errs):.3g} from JAX (relative)")
    check(float(c1) < 0.3 * float(c0), "node-chunked BA did not converge")
    log(f"phase 9 (c) ba_nodes_solve (256 nodes, 8 chunks, band {band}, {iters} iters, no "
        f"observation masked): cost {float(c0):.6g} -> {float(c1):.6g}, {nacc} accepted; vs one "
        f"chunk positions {d['p']:.3g} m, velocities {d['v']:.3g}, inverse depths "
        f"{d['invd']:.3g}; vs JAX {max(errs):.3g} relative; {ms8:.2f} ms per solve with 8 "
        f"chunks, {ms1:.2f} ms with one")
    return {"p": to_np(o8.nodes.p), "lm_invdepth": to_np(o8.lm_invdepth),
            "decisions": np.array([int(nacc), int(it)]), "ms": ms8}


# ---------------------------------------------------------------------------
# Ranks of torch.distributed (phase 11; tests/test_torch_distributed.py)
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a process group's rendezvous."""
    from ic_gvins_tpu_torch.parallel import free_port as port

    return port()


def rank_timed(fn, dev, mesh):
    """(fn's result, wall ms on a clock synchronized with ``dev``, the
    all-reduces ``mesh`` made in it)."""
    import torch

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    n0 = mesh.all_reduces
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3, mesh.all_reduces - n0


def round_sequence(b, dev, dtype=None):
    """Sequence ``b`` of phase 9's batch (``perturb_round`` of the 24 x 192
    round's window) with the shared prior, configuration and parameters on
    ``dev``, in ``dtype`` (the fixture's float64 when None)."""
    from ic_gvins_tpu_torch.convert import cast, to_torch, unflatten
    from ic_gvins_tpu_torch.data.types import IntegrationParams
    from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig, Window

    inp = unflatten(dict(np.load(PARALLEL_FIXTURE)), "round/in/")
    out = (to_torch(Window, perturb_round(inp["window"], inp["opt"], b), dev),
           to_torch(Prior, inp["prior"], dev), to_torch(SolverConfig, inp["cfg"], dev),
           to_torch(IntegrationParams, inp["params"], dev))
    return out if dtype is None else tuple(cast(x, dtype) for x in out)


def round_result(window, stats) -> dict:
    """A landmark-sharded round's whole window and its decisions, as numpy."""
    from ic_gvins_tpu_torch.convert import to_numpy

    return {"window": to_numpy(window), "decisions": round_decisions(stats),
            "cost1": to_np(stats[1].cost1)}


def dist_collectives(dev):
    """psum / pmax / psum_packed / psum_rank0 (alone and with a max) /
    assemble over the ranks,
    two local shards each, on integer-valued data (exact in any order):
    each rank's results and the global input."""
    import torch

    from ic_gvins_tpu_torch.parallel import Mesh, assemble, pmax, psum, psum_packed, psum_rank0

    mesh = Mesh({"lm": 2 * _world()}, device=dev)
    k, first = mesh.local("lm"), mesh.first("lm")
    g = np.random.default_rng(3)
    x = torch.as_tensor(g.integers(-50, 50, (mesh.shape["lm"], 3, 4)).astype(np.float64), device=dev)
    rows = torch.as_tensor(g.integers(0, 9, (4 * mesh.world, 2)), device=dev)
    mine = x[first:first + k]
    packed = psum_packed([mine, 2 * mine[:, 0]], mesh)
    per = rows.shape[0] // mesh.world
    whole = assemble([(rows[mesh.rank * per:(mesh.rank + 1) * per], mesh.rank * per, rows.shape[0]),
                      (x[0] + mesh.rank, None, 0), (mine > 0, first, mesh.shape["lm"])], mesh)
    return {"x": x, "rows": rows, "psum": psum(mine, mesh), "pmax": pmax(mine, mesh),
            "packed0": packed[0], "packed1": packed[1],
            "rank0": psum_rank0(mine[:, 0, 0], torch.tensor(0.5, dtype=x.dtype, device=dev) + mesh.rank,
                                mesh),
            "rank0_max": torch.stack(psum_rank0(
                mine[:, 0, 0], x[0, 0, 0], mesh, also_max=x[first:first + k, 1, 1].amax())),
            "rows_whole": whole[0], "rep_whole": whole[1], "mask_whole": whole[2],
            "all_reduces": mesh.all_reduces}


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size()


def dist_round(dev, b=0, dtype="float64"):
    """``optimize_sharded`` with SHARDS global landmark shards of phase 9's
    sequence ``b`` in ``dtype``, ITERS iterations."""
    import torch

    from ic_gvins_tpu_torch.parallel import Mesh
    from ic_gvins_tpu_torch.parallel.lm_sharded import optimize_sharded

    win, prior, cfg, params = round_sequence(b, dev, getattr(torch, dtype))
    mesh = Mesh({"lm": SHARDS}, device=dev)
    (out, stats), ms, n = rank_timed(
        lambda: optimize_sharded(win, prior, cfg, params, mesh, iters=ITERS), dev, mesh)
    return {**round_result(out, stats), "time": {"ms": ms, "all_reduces": n}}


def dist_gn_step(dev):
    """``sharded_gn_step`` with SHARDS landmark shards on ``batch6``'s
    second window."""
    from ic_gvins_tpu_torch.convert import to_numpy
    from ic_gvins_tpu_torch.parallel import Mesh, schur

    wins, prs, cfg, params = batch6_inputs(dict(np.load(PARALLEL_FIXTURE)), dev)
    mesh = Mesh({"lm": SHARDS}, device=dev)
    return {"window": to_numpy(schur.sharded_gn_step(wins[1], prs[1], cfg, params, mesh,
                                                     lam=1e-4)),
            "all_reduces": mesh.all_reduces}


def dist_ba(dev, name="ba32"):
    """``ba_nodes_solve`` of a fixture problem cut into SHARDS chunks
    (``ba32``: a band of 1; ``ba256``: a band of 8), the chunks over the
    ranks."""
    from ic_gvins_tpu_torch.parallel import Mesh, ba_nodes

    fx = dict(np.load(PARALLEL_FIXTURE))
    band = int(fx[f"{name}/in/sep_width"])
    ba, _, params, iters = ba_problem(fx, name, SHARDS, band, dev)
    mesh = Mesh({"nodes": SHARDS}, device=dev)
    (out, (c0, c1, nacc, it)), ms, n = rank_timed(
        lambda: ba_nodes.ba_nodes_solve(ba, params, mesh, iters=iters, sep_width=band), dev, mesh)
    return {"nodes": {k: to_np(getattr(out.nodes, k)) for k in ("p", "v", "q")},
            "lm_invdepth": to_np(out.lm_invdepth), "decisions": np.array([nacc, it]),
            "cost": np.array([float(c0), float(c1)]), "time": {"ms": ms, "all_reduces": n}}


def dist_batch(dev, source="batch6"):
    """``optimize_batch`` of ``batch6``'s three windows (8 iterations) or of
    phase 9's BATCH sequences (ITERS), split over the ranks by
    ``shard_batch`` and made whole by ``gather_batch``."""
    from ic_gvins_tpu_torch.parallel import Mesh, multi_seq

    if source == "batch6":
        wins, prs, cfg, params = batch6_inputs(dict(np.load(PARALLEL_FIXTURE)), dev)
        iters = 8
    else:
        wins, prior, cfg, params, _ = parallel_round(dev)
        prs, iters = [prior] * len(wins), ITERS
    mesh = Mesh({"dp": _world()}, device=dev)
    mine, mine_pr = multi_seq.shard_batch(multi_seq.stack_windows(wins),
                                          multi_seq.stack_priors(prs), mesh)

    def run():
        out, stats = multi_seq.optimize_batch(mine, mine_pr, cfg, params, iters=iters)
        return multi_seq.gather_batch((out.nodes, stats), len(wins), mesh)

    (nodes, stats), ms, n = rank_timed(run, dev, mesh)
    return {"nodes": {k: to_np(getattr(nodes, k)) for k in ("p", "v", "q")},
            "stats": np.stack([to_np(x) for x in stats]),
            "rank": {"n_local": np.int64(mine.nodes.p.shape[0])},
            "time": {"ms": ms, "all_reduces": n}}


def estimator_scenario(name):
    """The streams ``Estimator.set_mesh`` runs on: the small fixture's
    ``gvins`` scenario (``small``), or phase 5's streams cut to their
    first SHARDED_S s (``defaults``)."""
    if name == "small":
        fx = dict(np.load(os.path.join(ROOT, "tests", "fixtures", "torch_estimator_small.npz")))
        return scenario(fx, "gvins")
    fx = dict(np.load(ESTIMATOR_FIXTURE))
    return head({**scenario(fx, "defaults"),
                 "cfg_json": scenario(fx, "defaults_native")["cfg_json"]}, SHARDED_S)


def dist_estimator(dev, name="small"):
    """``Estimator.set_mesh`` with SHARDS global landmark shards over the
    ranks, every rank on the same streams: its feed log and summary."""
    from ic_gvins_tpu_torch.parallel import Mesh

    mesh = Mesh({"lm": SHARDS}, device=dev)
    (_, got), ms, n = rank_timed(lambda: run_estimator(estimator_scenario(name), dev, mesh=mesh),
                                 dev, mesh)
    return {"got": got, "time": {"ms": ms, "all_reduces": n}}


def dist_guards(dev):
    """What a rank refuses: a shard count the world does not divide, and a
    window, problem or estimator on another device than its mesh's (the
    mesh here on ``meta``). Each entry is 1 where it raised."""
    from ic_gvins_tpu_torch.engine.config import EngineConfig
    from ic_gvins_tpu_torch.engine.estimator import Estimator
    from ic_gvins_tpu_torch.parallel import Mesh, ba_nodes, lm_sharded

    def raises(fn):
        try:
            fn()
        except ValueError:
            return 1
        return 0

    fx = dict(np.load(PARALLEL_FIXTURE))
    wins, prs, cfg, params = batch6_inputs(fx, dev)
    ba, _, bparams, _ = ba_problem(fx, "ba32", SHARDS, 1, dev)
    other = Mesh({"lm": SHARDS, "nodes": SHARDS}, device="meta")
    est = Estimator(EngineConfig(max_nodes=4, max_landmarks=8), device=dev)
    return {"odd_count": raises(lambda: Mesh({"lm": 2 * _world() + 1}, device=dev)),
            "round_device": raises(lambda: lm_sharded.optimize_sharded(
                wins[0], prs[0], cfg, params, other)),
            "ba_device": raises(lambda: ba_nodes.ba_nodes_solve(ba, bparams, other, iters=1)),
            "estimator_device": raises(lambda: est.set_mesh(other))}


def dist_phase11(dev):
    """Phase 11 on one rank, at full width: (a) the sharded round of
    phase 9's sequence 0, (b) the node-chunked BA at N = 256, (c) the
    batch of BATCH windows, each after a warm-up call, and (d)
    ``Estimator.set_mesh`` on phase 5's first SHARDED_S s."""
    from ic_gvins_tpu_torch.vision import klt_cuda

    klt_cuda.lk_track_bidirectional.launches = 0
    out = {}
    for key, fn in (("a", lambda: dist_round(dev)), ("b", lambda: dist_ba(dev, "ba256")),
                    ("c", lambda: dist_batch(dev, "round"))):
        fn()  # warm: the solver libraries' first calls on this rank
        out[key] = fn()
    out["d"] = dist_estimator(dev, "defaults")
    out["klt_launches"] = np.int64(klt_cuda.lk_track_bidirectional.launches)
    return out


def dryrun_result(res) -> dict:
    """``entry.dryrun_multichip``'s results as numpy: each part's nodes,
    inverse depths, decisions and costs."""
    w, stats = res["round"]
    ba, (c0, c1, nacc, it) = res["ba"]
    nodes = lambda n: {k: to_np(getattr(n, k)) for k in ("p", "q", "v")}  # noqa: E731
    out = {"round": {"nodes": nodes(w.nodes), "lm_invdepth": to_np(w.lm_invdepth),
                     "obs_valid": to_np(w.obs_valid), "decisions": round_decisions(stats),
                     "cost1": to_np(stats[1].cost1)},
           "ba": {"nodes": nodes(ba.nodes), "lm_invdepth": to_np(ba.lm_invdepth),
                  "cost": np.array([float(c0), float(c1)]), "decisions": np.array([nacc, it])}}
    if res["batch"] is not None:
        bn, bstats = res["batch"]
        out["batch"] = {"nodes": nodes(bn), "stats": np.stack([to_np(x) for x in bstats])}
    return out


def dist_dryrun(dev):
    """``entry.dryrun_multichip`` on as many shards as ranks, each rank one
    shard of each part: its results and wall."""
    import torch

    from ic_gvins_tpu_torch.entry import dryrun_multichip
    from ic_gvins_tpu_torch.vision import klt_cuda

    klt_cuda.lk_track_bidirectional.launches = 0
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    res = dryrun_result(dryrun_multichip(_world(), dev))
    sync()
    return {**res, "klt_launches": np.int64(klt_cuda.lk_track_bidirectional.launches),
            "time": {"ms": (time.perf_counter() - t0) * 1e3}}


DIST_CASES = {"collectives": dist_collectives, "round": dist_round, "gn_step": dist_gn_step,
              "ba": dist_ba, "batch": dist_batch, "estimator": dist_estimator,
              "guards": dist_guards, "phase11": dist_phase11, "dryrun": dist_dryrun}


def dist_rank(rank, world, init, backend, devices, case, kwargs, out_paths, threads=None):
    """One rank of a spawned run: join the process group, run
    ``DIST_CASES[case](devices[rank], **kwargs)`` and write its results to
    ``out_paths[rank]`` (npz)."""
    import torch

    sys.path.insert(0, ROOT)
    from ic_gvins_tpu_torch.convert import flatten
    from ic_gvins_tpu_torch.parallel import init_distributed, shutdown_distributed

    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(backend, init, world, rank, timeout=DIST_TIMEOUT)
    try:
        out = DIST_CASES[case](dev, **kwargs)
    finally:
        shutdown_distributed()
    np.savez(out_paths[rank], **flatten(_numpy_tree(out)))


def _numpy_tree(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)


def spawn_ranks(world, case, devices, out_dir, kwargs=None, backend="gloo",
                timeout=DIST_SPAWN_TIMEOUT, threads=None, meanwhile=None):
    """Run ``case`` on ``world`` ranks (``parallel.spawn``: processes
    started with the ``spawn`` method, joined by a process group on a free
    local port), rank r on ``devices[r]``, and ``meanwhile()`` here while
    they run. Raises when they have not finished in ``timeout`` s or when
    one failed. Returns (each rank's results as nested dicts of numpy
    arrays, what ``meanwhile`` returned)."""
    from ic_gvins_tpu_torch.convert import unflatten
    from ic_gvins_tpu_torch.parallel import spawn

    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"{case}_w{world}_r{r}.npz") for r in range(world)]
    for p in paths:
        if os.path.exists(p):
            os.remove(p)
    ref = spawn(world, dist_rank, (backend, [str(d) for d in devices], case, kwargs or {},
                                   paths, threads), timeout=timeout, meanwhile=meanwhile)
    return [unflatten(dict(np.load(p))) for p in paths], ref


def same_bits(results) -> bool:
    """Are every rank's results bit for bit rank 0's (its timings and its
    own share, under ``time`` and ``rank``, aside)?"""
    from ic_gvins_tpu_torch.convert import flatten

    flat = [{k: v for k, v in flatten(r).items() if not {"time", "rank"} & set(k.split("/"))} for r in results]
    return all(f.keys() == flat[0].keys()
               and all(f[k].dtype == flat[0][k].dtype and f[k].tobytes() == flat[0][k].tobytes()
                       for k in f) for f in flat[1:])


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def phase_distributed(dev, ref9, fx):
    """Phase 11: phase 9's paths across W = 2 and 4 ranks of
    ``torch.distributed`` (``gloo``, every rank on ``dev``), each rank
    running ``dist_phase11``: every rank's results bit for bit rank 0's,
    within DIST_POS_ATOL of phase 9's one-process runs with the same global
    shard count and with their decisions, within DIST_JAX_POS_ATOL of JAX,
    and the estimator within phase 9 (b)'s bounds of phase 5; then the
    same with ``nccl``, one rank per card, where the machine has the
    cards."""
    import torch

    from ic_gvins_tpu_torch.convert import unflatten

    out_dir = os.path.join(ROOT, "build", "phase11")
    jx_round = unflatten(fx, "round/sharded/")
    jx_ba = unflatten(fx, "ba256/chunks8/")
    cards = torch.cuda.device_count()
    runs = [("gloo", w, [dev] * w) for w in DIST_WORLDS]
    runs += [("nccl", w, [torch.device("cuda", r) for r in range(w)])
             for w in DIST_WORLDS if w <= cards]
    for backend, world, devices in runs:
        t0 = time.perf_counter()
        res, _ = spawn_ranks(world, "phase11", devices, out_dir, backend=backend,
                          threads=max(1, (os.cpu_count() or world) // world))
        wall = time.perf_counter() - t0
        tag = f"phase 11 {backend}, {world} ranks"
        check(same_bits(res), f"{tag}: the ranks' results differ from rank 0's")
        r0 = res[0]
        check(all(int(r["klt_launches"]) == 0 for r in res), f"{tag} launched the KLT kernel")
        # (a) the landmark-sharded round
        a, a9 = r0["a"], ref9["round"]
        check(np.array_equal(a["decisions"], a9["decisions"])
              and np.array_equal(a["window"]["obs_valid"], a9["obs_valid"]),
              f"{tag} (a): decisions or culls differ from one process")
        da = max_abs(a["window"]["nodes"]["p"], a9["p"])
        dja = max_abs(a["window"]["nodes"]["p"], jx_round["window"]["nodes"]["p"])
        check(da <= DIST_POS_ATOL, f"{tag} (a): {da:.3g} m from one process")
        check(dja <= DIST_JAX_POS_ATOL and int(jx_round["n_culled"]) == int(a["decisions"][4]),
              f"{tag} (a): {dja:.3g} m from JAX or other culls")
        # (b) the node-chunked BA
        b, b9 = r0["b"], ref9["ba"]
        check(np.array_equal(b["decisions"], b9["decisions"]),
              f"{tag} (b): accepted steps or iterations differ from one process")
        db = max_abs(b["nodes"]["p"], b9["p"])
        djb = max_abs(b["nodes"]["p"], jx_ba["nodes"]["p"])
        check(db <= DIST_POS_ATOL, f"{tag} (b): {db:.3g} m from one process")
        check(djb <= DIST_JAX_POS_ATOL
              and int(b["decisions"][0]) == int(jx_ba["stats"]["accepted"]),
              f"{tag} (b): {djb:.3g} m from JAX or other accepted steps")
        # (c) the batch
        c, c9 = r0["c"], ref9["batch"]
        check(np.array_equal(c["stats"][2:], c9["stats"]),
              f"{tag} (c): culls, iterations or accepted steps differ from one process")
        dc = max_abs(c["nodes"]["p"], c9["p"])
        check(dc <= DIST_POS_ATOL, f"{tag} (c): {dc:.3g} m from one process")
        # (d) the estimator
        d, d9 = r0["d"], ref9["estimator"]
        dp, dq = compare_estimator(d["got"], d9["want"], CARD_TRAJ_ATT_ATOL)
        t = {k: r0[k]["time"] for k in "abcd"}
        slow = {k: max(float(r[k]["time"]["ms"]) for r in res) for k in "abcd"}
        log(f"{tag} ({' '.join(str(x) for x in devices)}): every rank's results bit for bit "
            f"rank 0's; (a) optimize_sharded ({SHARDS} shards, {SHARDS // world} a rank): "
            f"decisions {a['decisions'].tolist()} as one process, positions {da:.3g} m from "
            f"one process, {dja:.3g} m from JAX; (b) ba_nodes_solve (256 nodes, {SHARDS} "
            f"chunks): {db:.3g} m from one process, {djb:.3g} m from JAX; (c) optimize_batch "
            f"({BATCH} windows, {int(c['rank']['n_local'])} on rank 0): {dc:.3g} m from one process, "
            f"the same stops and culls; (d) Estimator.set_mesh on phase 5's first "
            f"{SHARDED_S:.0f} s: phase 5's decisions, trajectory {dp:.3g} m, {dq:.3g} rad")
        log(f"{tag} walls, rank 0 (slowest rank) beside one process (phase 9), ms: "
            + "; ".join(f"({k}) {float(t[k]['ms']):.2f} ({slow[k]:.2f}) with "
                        f"{int(t[k]['all_reduces'])} all-reduces, one process "
                        f"{float(ref9[n]['ms']):.2f}"
                        for k, n in zip("abcd", ("round", "ba", "batch", "estimator")))
            + f"; spawn to end {wall:.1f} s")
    if not any(b == "nccl" for b, _, _ in runs):
        log(f"phase 11 (e) nccl: not run ({cards} card(s) visible)")
    else:
        for w in DIST_WORLDS:
            if w > cards:
                log(f"phase 11 (e) nccl, {w} ranks: not run ({cards} card(s) visible)")


def block_step(window, prior, cfg, params):
    """``entry.forward`` by the block path: ``assemble_blocks`` ->
    ``schur_solve_blocks`` -> ``apply_delta``."""
    import torch

    from ic_gvins_tpu_torch.solver import assembly
    from ic_gvins_tpu_torch.solver.window import apply_delta

    Hxx, gx, Hxl, hll, gl, cost = assembly.assemble_blocks(
        window, prior, cfg, params, assembly.RobustFlags(gnss_kernel=True, reproj_kernel=True))
    dx_x, dx_l = assembly.schur_solve_blocks(Hxx, gx, Hxl, hll, gl, 1e-4)
    return apply_delta(window, torch.cat([dx_x, dx_l])), cost


def phase_entry(dev):
    """Phase 12 (a): ``entry()`` as a user calls it (no device: ``cuda:0``)
    and its ``forward`` on ``tiny_problem()`` (6 x 16) and on
    ``tiny_problem(24, 192)`` (D = 560), in float64 and float32 (the
    problem cast): against the JAX forward in ``torch_entry.npz``, against
    the block path, and against itself repeated bit for bit; then the
    dense and the block step's ms and launches."""
    import torch

    from ic_gvins_tpu_torch import entry
    from ic_gvins_tpu_torch.convert import cast, unflatten

    fx = unflatten(dict(np.load(ENTRY_FIXTURE)))
    forward, args = entry.entry()
    check(args[0].nodes.p.device == dev, f"entry() put its problem on {args[0].nodes.p.device}")
    smi = card()
    for name, prob in (("6 x 16", args), ("24 x 192", entry.tiny_problem(24, 192))):
        key = "tiny" if name == "6 x 16" else "slice"
        for dtype in ("float64", "float32"):
            p = prob if dtype == "float64" else tuple(cast(x, torch.float32) for x in prob)
            (w, c), (w2, c2) = forward(*p), forward(*p)
            check(tensor_bits((w, c)) == tensor_bits((w2, c2)),
                  f"phase 12 (a) {name} {dtype}: the forward does not repeat bit for bit")
            wb, cb = block_step(*p)
            want = fx[key]["forward" if dtype == "float64" else "forward32"]
            dj = max_abs(to_np(w.nodes.p), want["nodes"]["p"])
            cj = abs(float(c) - float(want["cost"])) / abs(float(want["cost"]))
            db = max_abs(to_np(w.nodes.p), to_np(wb.nodes.p))
            ib = rel_err(to_np(wb.lm_invdepth), to_np(w.lm_invdepth))
            check(dj <= ENTRY_POS_ATOL[dtype] and cj <= ENTRY_COST_RTOL[dtype],
                  f"phase 12 (a) {name} {dtype}: {dj:.3g} m, cost {cj:.3g} from JAX")
            check(db <= ENTRY_POS_ATOL[dtype] and ib <= ENTRY_COST_RTOL[dtype]
                  and float(c) == float(cb),
                  f"phase 12 (a) {name} {dtype}: {db:.3g} m, inverse depths {ib:.3g} from "
                  f"the block path")
            ms = timed(lambda: [forward(*p) for _ in range(ENTRY_REPS)])[1] / ENTRY_REPS
            ms_b = timed(lambda: [block_step(*p) for _ in range(ENTRY_REPS)])[1] / ENTRY_REPS
            _, n, dev_ms, wall, busy = profiled(lambda: forward(*p))
            _, n_b, dev_ms_b, wall_b, busy_b = profiled(lambda: block_step(*p))
            log(f"phase 12 (a) forward {name} {dtype} ({smi}): dense {ms:.3f} ms "
                f"(mean of {ENTRY_REPS}, synced host clock), {n} launches, busy {busy:.4f}; "
                f"block path {ms_b:.3f} ms, {n_b} launches, busy {busy_b:.4f}; from JAX "
                f"{dj:.3g} m, cost {cj:.3g}; from the block path {db:.3g} m, inverse depths "
                f"{ib:.3g}; repeated bit for bit")


def phase_dryrun(dev):
    """Phase 12 (b)-(c): ``entry.dryrun_multichip(n)`` across n ``gloo``
    ranks on ``dev`` for n = 2 and 4 and, where the machine has the cards,
    across n ``nccl`` ranks, one a card; every world spawned once, all at
    the same time, and meanwhile the same in one process with n shards.
    Every rank's results bit for bit rank 0's, within DIST_POS_ATOL of the
    one-process run with its decisions."""
    import torch

    from ic_gvins_tpu_torch.entry import dryrun_multichip

    smi = card()
    cards = torch.cuda.device_count()
    runs = [("gloo", n, [dev] * n) for n in DRYRUN_SHARDS]
    runs += [("nccl", n, [torch.device("cuda", r) for r in range(n)])
             for n in DRYRUN_SHARDS if n <= cards]
    threads = max(1, (os.cpu_count() or 1) // sum(n for _, n, _ in runs))
    one, res, ms_one = {}, {}, {}

    def launch(i):
        """Spawn run i with runs i + 1, ... and then the one-process runs
        started while its ranks run."""
        if i == len(runs):
            for n in DRYRUN_SHARDS:
                one[n], ms_one[n] = timed(lambda: dryrun_result(dryrun_multichip(n, dev)))
            return
        backend, world, devices = runs[i]
        res[i], _ = spawn_ranks(world, "dryrun", devices, os.path.join(ROOT, "build", "phase12",
                                                                       backend),
                                backend=backend, threads=threads, meanwhile=lambda: launch(i + 1))

    t0 = time.perf_counter()
    launch(0)
    wall = time.perf_counter() - t0
    for n in DRYRUN_SHARDS:
        r = one[n]
        log(f"phase 12 (b) dryrun_multichip({n}) in one process ({smi}): {ms_one[n]:.1f} ms "
            f"(while the ranks ran); round decisions {r['round']['decisions'].tolist()}, BA "
            f"costs {r['ba']['cost'].tolist()}, batch costs {r['batch']['stats'][1].tolist()}")
    for i, (backend, world, devices) in enumerate(runs):
        tag = f"phase 12 ({'b' if backend == 'gloo' else 'c'}) {backend}, {world} ranks"
        check(same_bits(res[i]), f"{tag}: the ranks' results differ from rank 0's")
        check(all(int(r["klt_launches"]) == 0 for r in res[i]), f"{tag} launched the KLT kernel")
        r0, ref = res[i][0], one[world]
        errs = {}
        for part in ("round", "ba", "batch"):
            errs[part] = max_abs(r0[part]["nodes"]["p"], ref[part]["nodes"]["p"])
            check(errs[part] <= DIST_POS_ATOL, f"{tag}: {part} {errs[part]:.3g} m from one process")
        for part in ("round", "ba"):
            check(np.array_equal(r0[part]["decisions"], ref[part]["decisions"]),
                  f"{tag}: {part} decisions differ from one process")
        check(np.array_equal(r0["batch"]["stats"][2:], ref["batch"]["stats"][2:]),
              f"{tag}: batch decisions differ from one process")
        log(f"{tag} ({smi}): every rank's results bit for bit rank 0's; round / BA / batch "
            f"{errs['round']:.3g} / {errs['ba']:.3g} / {errs['batch']:.3g} m from one process, "
            f"its decisions; rank 0 {float(r0['time']['ms']):.1f} ms")
    log(f"phase 12 (b)-(c): {sum(n for _, n, _ in runs)} ranks of {len(runs)} worlds at once, "
        f"spawn to end {wall:.1f} s")
    if cards < min(DRYRUN_SHARDS):
        log(f"phase 12 (c) nccl: not run ({cards} card(s) visible)")
    else:
        for n in DRYRUN_SHARDS:
            if n > cards:
                log(f"phase 12 (c) nccl, {n} ranks: not run ({cards} card(s) visible)")


@contextmanager
def watch_pipeline():
    """Record the ``Pipeline`` that a command builds and count the frames
    its front end tracks (those after the first with features alive)."""
    from ic_gvins_tpu_torch.engine import pipeline as pipeline_mod

    seen = {"pipe": None, "tracked": 0}
    add_image = pipeline_mod.Pipeline.add_image

    def watched(self, t, img):
        seen["pipe"] = self
        fe = self.frontend
        seen["tracked"] += int(fe.prev_pyr is not None and fe.valid.any())
        return add_image(self, t, img)

    pipeline_mod.Pipeline.add_image = watched
    try:
        yield seen
    finally:
        pipeline_mod.Pipeline.add_image = add_image


def png_filter_ms(img, path):
    """ms to decode ``img`` (uint8 grey) written with each PNG row filter:
    None, Sub, Up (whole image at once), Average, Paeth (byte by byte)."""
    from ic_gvins_tpu_torch.data.image import read_png, write_png

    out = []
    for f in range(5):
        write_png(path, img, filters=f)
        t0 = time.perf_counter()
        back = read_png(path)
        out.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(back, img), f"PNG filter {f} did not round-trip")
    os.remove(path)
    return out


def phase_pipeline(dev, work):
    """Phase 6: the replay command ``ic_gvins_tpu_torch.tools.run_kaist`` on
    a KAIST-layout directory written from the defaults fixture (IMU and
    GNSS as CSV, 150 frames of 1278 x 1022 rendered at the truth camera
    poses as 8-bit PNGs, pinhole: no distortion)."""
    from ic_gvins_tpu_torch.data import kaist
    from ic_gvins_tpu_torch.data.image import load_gray
    from ic_gvins_tpu_torch.engine import config as tconfig
    from ic_gvins_tpu_torch.engine.estimator import TRACKING_NORMAL

    s = scenario(dict(np.load(ESTIMATOR_FIXTURE)), "defaults")
    # the renderer draws a pinhole: no distortion
    cfg = engine_config(tconfig, s, cam={"distortion": (0.0, 0.0, 0.0, 0.0)})
    root, out = os.path.join(work, "kaist"), os.path.join(work, "run")
    t0 = time.perf_counter()
    cfg_path, truth_path, truth_t, truth_p, png_s = write_kaist_dir(root, s, cfg)
    log(f"phase 6 wrote the KAIST-layout sequence in {time.perf_counter() - t0:.2f} s "
        f"({len(s['frame_t'])} PNGs in {png_s:.2f} s)")
    t0 = time.perf_counter()
    kaist.load_sequence(root)
    csv_s = time.perf_counter() - t0
    frames = sorted(os.listdir(os.path.join(root, "image", "stereo_left")))
    t0 = time.perf_counter()
    img = None
    for name in frames:
        img = load_gray(os.path.join(root, "image", "stereo_left", name))
    png_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    log(f"phase 6 CSV load: {csv_s:.3f} s for {len(s['imu_t'])} IMU rows and "
        f"{len(s['gnss_t'])} fixes (kaist.load_sequence)")
    log(f"phase 6 PNG decode: {png_ms:.2f} ms per {img.shape[1]}x{img.shape[0]} frame "
        f"({len(frames)} frames, rows filtered None); one frame by row filter None / Sub / "
        f"Up / Average / Paeth: " + " / ".join(
            f"{x:.1f}" for x in png_filter_ms(img, os.path.join(work, "filters.png"))) + " ms")

    seq = (root, cfg_path, truth_path, truth_t, truth_p)
    res, pipe, tracked, launches, wall, t, err = replay_kaist(dev, seq, out, "phase 6")
    est = pipe.est
    ate = rms(err[t >= T_BASE + PIPELINE_T_MIN])
    ate_run = rms(err[t >= t[0] + 5.0])
    fm = np.asarray(pipe.frame_ms)
    log(f"phase 6 run_kaist ({res['frames']} frames of {est.cfg.cam.resolution[0]}x"
        f"{est.cfg.cam.resolution[1]}, {est.cfg.track_max_features} features, CLAHE, "
        f"FM-RANSAC): final state {est.state} (>= {TRACKING_NORMAL}), {est.n_keyframes} "
        f"keyframes in the window, {len(est.lm_slot)} landmark slots, {len(est.stats)} "
        f"rounds; KLT launches {launches} for {tracked} tracked frames; ATE after "
        f"{PIPELINE_T_MIN:.0f} s {ate:.4f} m (< {PIPELINE_ATE}), max {err.max():.4f} m; "
        f"the command's ate_rmse_m {res['ate_rmse_m']} vs {ate_run:.4f} m from its "
        f"trajectory.csv; outputs " + ", ".join(sorted(os.listdir(out))))
    log(f"phase 6 front end ms per frame: first {fm[0]:.2f}, median {np.median(fm[1:]):.2f}, "
        f"max {fm[1:].max():.2f}; " + stage_line(est, wall, float(s["imu_t"][-1])))
    check(est.state == TRACKING_NORMAL, "the pipeline did not reach TRACKING_NORMAL")
    check(est.n_keyframes >= 2 and len(est.lm_slot) >= 10, "too few keyframes or landmarks")
    check(tracked > 0 and launches == tracked, "the KLT kernel was not launched once per "
          "tracked frame")
    ref = {k[4:]: v for k, v in s.items() if k.startswith("out/")}
    log(f"phase 6 decisions against JAX (no JAX pipeline run exists at this width: the JAX "
        f"Estimator on the ideal tracks of these streams): {len(est.stats)} rounds (JAX "
        f"{len(ref['stats'])}), ATE after 5 s {rms(err[t >= T_BASE + 5.0]):.4f} m (JAX "
        f"{float(ref['ate_rmse']):.4f})")
    check(ate < PIPELINE_ATE, f"pipeline ATE {ate:.3f} m >= {PIPELINE_ATE}")
    check(abs(res["ate_rmse_m"] - ate_run) <= 1e-4, "the command's ATE disagrees with its "
          "trajectory.csv")
    return launches, seq, stage_line(est, wall, float(s["imu_t"][-1]))


def replay_kaist(dev, seq, out, label, extra=()):
    """``run_kaist.main`` on the KAIST-layout sequence ``seq`` (the paths and
    truth ``write_kaist_dir`` returns) with ``extra`` flags, the KLT's
    launch count set to 0 just before and read just after: (the command's
    result, its pipeline, tracked frames, KLT launches, wall s, stamps and
    errors of its trajectory.csv). Checks that it wrote its output files."""
    import torch

    from ic_gvins_tpu_torch.tools import run_kaist
    from ic_gvins_tpu_torch.vision import klt_cuda

    root, cfg_path, truth_path, truth_t, truth_p = seq
    klt_cuda.lk_track_bidirectional.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with watch_pipeline() as seen, redirect_stdout(printed):
        res = run_kaist.main(["--data", root, "--config", cfg_path, "--out", out,
                              "--ref", truth_path, "--gps-default-std", "0.05",
                              "--bayer", "none", "--device", str(dev), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = klt_cuda.lk_track_bidirectional.launches
    log(f"{label} run_kaist printed: " + printed.getvalue().strip())
    for name in ("gvins.nav", "trajectory.csv", "statistics.txt", "tracking.txt"):
        check(os.path.getsize(os.path.join(out, name)) > 0, f"the replay wrote no {name}")
    t, err = replay_errors(out, truth_t, truth_p)
    return res, seen["pipe"], seen["tracked"], launches, wall, t, err


def phase_odometer(dev, work):
    """Phase 7: ``Estimator(EngineConfig(odo=OdoConfig(use_odo=True)))`` at
    full width on the odometer fixture (the defaults streams, GNSS until 9
    s, a 50 Hz wheel odometer) against the JAX run stored there; then the
    run resumed from its own checkpoint and from the JAX run's, both taken
    after the middle event."""
    import torch

    s = scenario(dict(np.load(ODO_FIXTURE)), "odo")
    ref = {k[4:]: v for k, v in s.items() if k.startswith("out/")}
    ck = int(ref["ckpt_event"])
    path = os.path.join(work, "odo_port.pkl")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, got = run_estimator(s, dev, on_event=lambda e, est: (
        est.save_checkpoint(path) if e == ck else None))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg = est.cfg
    dp, dq = compare_estimator(got, ref, CARD_TRAJ_ATT_ATOL)
    dsodo = abs(float(est.window.sodo) - float(ref["sodo"]))
    e = trajectory_errors(got["traj_t"], got["traj_p"], s, 5.0)
    log(f"phase 7 odometer estimator ({cfg.max_nodes} nodes x {cfg.max_landmarks} landmarks, "
        f"{cfg.optimize_num_iterations} iters, GNSS until {s['gnss_t'][-1]:.0f} s, "
        f"{len(s['odo_t'])} odometer samples): {len(got['stats'])} rounds, final state "
        f"{est.state}; identical to JAX in events, node times, keyframes, LM steps; trajectory "
        f"vs JAX {dp:.3g} m (<= {TRAJ_POS_ATOL}), {dq:.3g} rad (<= {CARD_TRAJ_ATT_ATOL}); "
        f"sodo {float(est.window.sodo):.9f} vs JAX {float(ref['sodo']):.9f} ({dsodo:.3g} <= "
        f"{CARD_SODO_ATOL}); ATE {rms(e):.4f} m (JAX {float(ref['ate_rmse']):.4f})")
    log("phase 7 " + stage_line(est, wall, float(s["imu_t"][-1])))
    check(dsodo <= CARD_SODO_ATOL, "odometer scale differs from JAX")
    for name, ck_path, full in (("port", path, got), ("JAX", os.path.join(work, "odo_jax.pkl"),
                                                       ref)):
        if name == "JAX":
            with open(ck_path, "wb") as f:
                f.write(ref["ckpt"].tobytes())
        t0 = time.perf_counter()
        est2, got2 = resume_estimator(s, ck_path, dev, ck + 1)
        dp2, dq2 = compare_estimator(got2, continuation_ref(full, ck, len(got2["stats"])),
                                     CARD_TRAJ_ATT_ATOL)
        ds2 = abs(float(est2.window.sodo) - float(ref["sodo"]))
        log(f"phase 7 resumed from the {name} checkpoint after event {ck} of "
            f"{len(ref['log'])}: {len(got2['stats'])} rounds in {time.perf_counter() - t0:.1f} s, "
            f"identical events; trajectory vs the {name} run {dp2:.3g} m, {dq2:.3g} rad; sodo "
            f"vs JAX {ds2:.3g}")
        check(ds2 <= CARD_SODO_ATOL, f"odometer scale after the {name} checkpoint differs")


def phase_simulator(dev):
    """Phase 8 (a): the port's simulator on the card against the JAX
    package's (``tests/fixtures/torch_sim.npz``) with the JAX draws: the
    seed-3 urban route and three stretches."""
    import torch

    from ic_gvins_tpu_torch.data import simulator as sim

    fx = dict(np.load(SIM_FIXTURE))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    route = sim.urban_route(seed=3, device=dev)
    for k in route._fields:
        v = getattr(route, k)
        check(np.array_equal(v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v),
                             fx["route/" + k]), f"urban route {k} differs from JAX")
    params = sim.default_params(device=dev)
    lines = []
    for name in ("car", "urban_start", "urban_arc"):
        ref = scenario(fx, name)
        sp = json.loads(str(ref["spec"]))
        worst, err, frame_err = compare_sim(sim_stretch(sp, ref, route, params, dev), ref)
        lines.append(f"{name} ({sp['t0']} s + {sp['duration']} s at {sp['imu_rate']:.0f} Hz): "
                     f"worst {worst} {err:.3g}, frame {frame_err:.3g} grey levels")
    torch.cuda.synchronize()
    log(f"phase 8 simulator vs JAX ({time.perf_counter() - t0:.2f} s): route of seed 3 "
        f"({len(route.t0)} segments) bit-equal; time grids bit-equal; " + "; ".join(lines)
        + f" (<= {SIM_RTOL} relative, <= {SIM_FRAME_ATOL} grey levels)")


def phase_generate(dev, work):
    """Phase 8 (b): ``run_urban --gen`` at urban38's 2154 s on the card, and
    the self-check that mechanizing the port's clean increments over an
    urban stretch reproduces the truth."""
    import torch

    from ic_gvins_tpu_torch.data import simulator as sim
    from ic_gvins_tpu_torch.ins import mechanization as mech
    from ic_gvins_tpu_torch.tools import run_urban

    out = os.path.join(work, "urban38")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(printed):
        info = run_urban.main(["--gen", "--duration", str(URBAN38_S), "--out", out,
                               "--device", str(dev)])
    wall = time.perf_counter() - t0
    log("phase 8 run_urban --gen printed: " + printed.getvalue().strip().replace("\n", "; "))
    with np.load(os.path.join(out, "sensors.npz")) as d:
        shapes = {k: d[k].shape for k in d.files}
        finite = all(np.all(np.isfinite(d[k])) for k in d.files)
        route_m = float(d["route_length"])
    n_imu = int(round(URBAN38_S * 100.0)) + 1
    log(f"phase 8 urban38 generation: {wall:.2f} s of wall for {URBAN38_S:.0f} s of data "
        f"(IMU {info['imu_s']:.2f} s, all streams {info['generate_s']:.2f} s on {dev}, "
        f"writing {info['write_s']:.2f} s), {info['bytes'] / 1e6:.1f} MB; IMU "
        f"{shapes['imu_time'][0] - 1} samples, {shapes['frame_times'][0]} frame poses, "
        f"landmark bins {shapes['lm_bins']}, route {route_m:.0f} m")
    check(finite, "generated streams are not finite")
    check(shapes["imu_time"] == (n_imu,) and shapes["imu_dtheta"] == (n_imu, 3),
          "generated IMU has the wrong shape")
    check(shapes["frame_p"] == (shapes["frame_times"][0], 3), "frame poses misshapen")

    # mechanize the clean increments of an urban stretch from the truth
    route = sim.urban_route(seed=3, device=dev)
    traj, params = sim.urban_trajectory(route), sim.default_params(device=dev)
    a, b = MECH_STRETCH
    imu = sim.simulate_imu(traj, params, a, b - a, 100.0)
    s0 = sim.truth_state(traj, params, torch.tensor(a, dtype=torch.float64, device=dev))
    t0 = time.perf_counter()
    end = mech.mechanize_scan(params, s0, imu).index(-1)
    truth = sim.truth_state(traj, params, imu.time[-1])
    dp = float(torch.linalg.norm(end.p - truth.p))
    dv = float(torch.linalg.norm(end.v - truth.v))
    from ic_gvins_tpu_torch.common import rotation as rot

    da = float(torch.linalg.norm(rot.quat_to_rotvec(rot.quat_mul(rot.quat_inv(end.q), truth.q))))
    log(f"phase 8 mechanizing the clean increments of {a:.0f}-{b:.0f} s at 100 Hz "
        f"({time.perf_counter() - t0:.2f} s): end {dp:.3g} m, {dv:.3g} m/s, {da:.3g} rad from "
        f"the truth (<= {MECH_POS} m, {MECH_VEL} m/s, {MECH_ATT} rad)")
    check(dp <= MECH_POS and dv <= MECH_VEL and da <= MECH_ATT,
          "mechanized clean increments leave the truth")


def phase_run_sim(dev, work):
    """Phase 8 (c): ``run_sim --vision --gnss-outage-time 20`` at its 30 s."""
    from ic_gvins_tpu_torch.engine.estimator import TRACKING_NORMAL
    from ic_gvins_tpu_torch.tools import run_sim

    printed = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(printed):
        res = run_sim.main(["--vision", "--gnss-outage-time", "20", "--out",
                            os.path.join(work, "sim"), "--device", str(dev)])
    log(f"phase 8 run_sim ({time.perf_counter() - t0:.1f} s): " + printed.getvalue().strip())
    check(res["state"] == TRACKING_NORMAL, f"run_sim ended in state {res['state']}")
    check(res["ate_rmse_m"] < RUN_SIM_ATE, f"run_sim ATE {res['ate_rmse_m']} m >= {RUN_SIM_ATE}")


def klt_urban(pipe, sensors, dev):
    """The KLT kernel at the urban replay's shape: the last two rendered
    frames' pyramids and the front end's feature slots (120, 320 x 240, 4
    images): (max |kernel - plain| px, kernel ms on the card, plain ms,
    bound ms, bound_by)."""
    import torch

    from ic_gvins_tpu_torch.data.simulator import render_sprite_frame_np
    from ic_gvins_tpu_torch.engine.frontend import prep_frame
    from ic_gvins_tpu_torch.tools.run_urban import INTR, RES
    from ic_gvins_tpu_torch.vision import klt, klt_cuda

    fe = pipe.frontend
    with np.load(sensors) as d:
        ft, fp, fq, bins, bin_dt = (d["frame_times"], d["frame_p"], d["frame_qwc"],
                                    d["lm_bins"], float(d["bin_dt"]))
    pyrs = []
    for fi in (len(ft) - 2, len(ft) - 1):
        b = int(ft[fi] // bin_dt)
        lms = np.concatenate([bins[max(b - 1, 0)], bins[b], bins[b + 1]])
        img = render_sprite_frame_np(INTR, RES, lms, fp[fi], fq[fi])
        pyrs.append(prep_frame(torch.as_tensor(img, device=dev), fe.levels, False))
    pts = torch.as_tensor(fe.pts, device=dev)
    args = (pyrs[0], pyrs[1], pts, pts, torch.as_tensor(fe.valid, device=dev))
    pk, ok_k, _, work = klt_cuda.lk_track_bidirectional_counted(*args)
    pp, ok_p, _ = klt.lk_track_bidirectional(*args)
    both = ok_k & ok_p
    err = float((pk - pp).abs()[both].max()) if bool(both.any()) else 0.0
    check(err <= KLT_PTS_ATOL, "KLT kernel disagrees with the plain version at the urban shape")
    check(float((ok_k == ok_p).float().mean()) >= KLT_OK_AGREE, "KLT ok flags disagree (urban)")
    bound_ms, bound_by = klt_bound(work, len(pts), pyrs[0], "phase 8")
    kernel = lambda: klt_cuda.lk_track_bidirectional(*args)  # noqa: E731
    plain = lambda: klt.lk_track_bidirectional(*args)  # noqa: E731
    for _ in range(3):
        kernel()
    t_p = [cuda_ms(plain, 10)]
    t_k = [cuda_ms(kernel, 50, queue_ahead=True) for _ in range(2)]
    t_p.append(cuda_ms(plain, 10))
    return err, float(np.mean(t_k)), float(np.mean(t_p)), bound_ms, bound_by


def phase_urban(dev, work):
    """Phase 8 (d): ``run_urban`` replaying the JAX-written 90 s drive of
    ``tests/fixtures/torch_urban90.npz`` through the ``Pipeline`` at full
    width (120 features, 160 landmarks, 12 iterations), with an outage and
    a checkpoint, beside the JAX replay of the same file stored there; then
    the checkpoint resumed in a fresh ``Estimator`` fed the IMU and GNSS
    after it. Returns (KLT launches, the kernel's numbers at the urban
    shape)."""
    import torch

    from ic_gvins_tpu_torch.engine.estimator import TRACKING_NORMAL, Estimator
    from ic_gvins_tpu_torch.tools import run_urban
    from ic_gvins_tpu_torch.vision import klt_cuda

    out = os.path.join(work, "urban")
    os.makedirs(out)
    sensors = os.path.join(out, "sensors.npz")
    with np.load(URBAN_FIXTURE) as z:
        jax_res = {k[4:]: z[k] for k in z.files if k.startswith("jax/")}
        np.savez(sensors, **{k: z[k] for k in z.files if not k.startswith("jax/")})
    argv = ["--duration", str(URBAN_S), "--outages", *map(str, URBAN_OUTAGE),
            "--checkpoint-every", str(URBAN_CKPT), "--sensors", sensors, "--out", out,
            "--device", str(dev)]
    klt_cuda.lk_track_bidirectional.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with watch_pipeline() as seen, redirect_stdout(printed):
        res = run_urban.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = klt_cuda.lk_track_bidirectional.launches
    pipe, tracked = seen["pipe"], seen["tracked"]
    est = pipe.est
    for line in printed.getvalue().splitlines():
        if line.startswith('{"sim_t"'):
            log("phase 8 run_urban progress: " + line)
    fm = np.asarray(pipe.frame_ms)
    log(f"phase 8 run_urban {URBAN_S:.0f} s ({res['frames']} frames of 320x240, "
        f"{est.cfg.track_max_features} features, {est.cfg.max_nodes} nodes x "
        f"{est.cfg.max_landmarks} landmarks, {est.cfg.optimize_num_iterations} iters, GNSS out "
        f"{URBAN_OUTAGE[0]:.0f}-{URBAN_OUTAGE[1]:.0f} s): final state {est.state} (== "
        f"{TRACKING_NORMAL}), {len(est.stats)} rounds, {est.n_keyframes} keyframes, "
        f"{len(est.lm_slot)} landmark slots; KLT launches {launches} for {tracked} tracked "
        f"frames; ATE rmse {res['ate_rmse_m']:.4f} m (< {URBAN_ATE_RMSE}; JAX on this file "
        f"{float(jax_res['ate_rmse_m']):.4f}), max {res['ate_max_m']:.4f} m (< "
        f"{URBAN_ATE_MAX}; JAX {float(jax_res['ate_max_m']):.4f}), in and after the outage "
        f"max {res['ate_max_outage_m']:.4f} m (JAX {float(jax_res['ate_max_outage_m']):.4f}); "
        f"route {res['route_length_m']:.0f} m")
    log(f"phase 8 run_urban front end ms per frame: first {fm[0]:.2f}, median "
        f"{np.median(fm[1:]):.2f}, max {fm[1:].max():.2f}; frame wall mean (render + track + "
        f"estimator) {res['frame_wall_mean_ms']:.2f} ms; " + stage_line(est, wall, URBAN_S))
    with np.load(os.path.join(out, "trajectory.npz")) as z:
        log(f"phase 8 run_urban decisions against the JAX replay of the file (the same "
            f"FM-RANSAC draws): ATE rmse {res['ate_rmse_m']:.4f} m (JAX "
            f"{float(jax_res['ate_rmse_m']):.4f}), {len(est.stats)} rounds; "
            + parting_line(z["est_t"], z["est_p"], jax_res["est_t"], jax_res["est_p"]))
    check(est.state == TRACKING_NORMAL, "the urban replay did not reach TRACKING_NORMAL")
    check(tracked > 0 and launches == tracked, "the KLT kernel was not launched once per "
          "tracked frame in the urban replay")
    check(res["ate_rmse_m"] < URBAN_ATE_RMSE and res["ate_max_m"] < URBAN_ATE_MAX,
          "urban replay ATE over its bound")
    for name in ("result.json", "trajectory.npz", "ckpt.npz"):
        check(os.path.exists(os.path.join(out, name)), f"run_urban wrote no {name}")

    # the checkpoint, resumed in a fresh estimator fed the IMU and GNSS after it
    d = dict(np.load(sensors))
    est2 = Estimator(run_urban.urban_config(run_urban.build_parser().parse_args(argv),
                                            d["ext_q"]), device=dev)
    est2.load_checkpoint(os.path.join(out, "ckpt.npz"))
    t_ck = est2.imu.time[-1]
    n_ck = len(est2.traj_times)
    times, ps, _ = est.trajectory()
    check(n_ck > 0 and np.array_equal(np.asarray(est2.traj_times), times[:n_ck])
          and np.array_equal(np.stack(est2.traj_p), ps[:n_ck]),
          "the checkpoint's trajectory is not the run's")
    gi = int(np.searchsorted(d["gnss_time"], t_ck, side="right"))
    for k in range(int(np.searchsorted(d["imu_time"], t_ck, side="right")), len(d["imu_time"])):
        t = float(d["imu_time"][k])
        est2.add_imu(t, float(d["imu_dt"][k]), d["imu_dtheta"][k], d["imu_dvel"][k])
        while gi < len(d["gnss_time"]) and d["gnss_time"][gi] <= t:
            est2.add_gnss(float(d["gnss_time"][gi]), d["gnss_p"][gi], d["gnss_std"][gi])
            gi += 1
    t2, p2, _ = est2.trajectory()
    sel = t2 > t_ck
    truth_at = run_urban.truth_interp(d["frame_times"], d["frame_p"])
    err2 = np.linalg.norm(p2[sel] - truth_at(t2[sel]), axis=1)
    log(f"phase 8 resumed from the checkpoint at {t_ck:.2f} s ({n_ck} trajectory entries, "
        f"{est2.n_nodes} nodes): {int(sel.sum())} new entries to {t2[-1]:.1f} s from IMU and "
        f"GNSS, state {est2.state}, ATE rmse {rms(err2):.4f} m, max {err2.max():.4f} m "
        f"(< {URBAN_RESUME_ATE})")
    check(sel.sum() > 0 and err2.max() < URBAN_RESUME_ATE, "the resumed estimator lost the truth")
    return launches, klt_urban(pipe, sensors, dev)


def f32_fixture():
    return dict(np.load(F32_FIXTURE))


def phase_f32_modules(dev):
    """Phase 10 (a): the float32 reduced solve (Newton-Schulz) and the
    float32 marginalization on the card against JAX float32; then phase
    4's round in float32 beside the same round in float64: stage ms and
    launches."""
    import torch

    from ic_gvins_tpu_torch.convert import cast, to_torch, unflatten
    from ic_gvins_tpu_torch.data.types import IntegrationParams
    from ic_gvins_tpu_torch.factors.marginalization import marginalize_node0
    from ic_gvins_tpu_torch.solver.assembly import solve_reduced
    from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig, Window

    fx = f32_fixture()
    parts = []
    for case in ("round", "spd"):
        H, g, y64 = (fx[f"solve64/{case}_{k}"] for k in ("H", "g", "y"))
        y = solve_reduced(torch.as_tensor(H, dtype=torch.float32, device=dev),
                          torch.as_tensor(g, dtype=torch.float32, device=dev))
        check(y.dtype == torch.float32, "the float32 solve came back in another dtype")
        e_jax, e64 = rel_err(fx[f"solve32/{case}_y"], y.cpu()), rel_err(y64, y.cpu())
        e64_jax = rel_err(y64, fx[f"solve32/{case}_y"])
        parts.append(f"{case}: {e_jax:.3g} from JAX float32 (<= {F32_SOLVE_VS_JAX[case]}), "
                     f"{e64:.3g} from float64 (JAX float32 {e64_jax:.3g}; <= "
                     f"{F32_SOLVE_VS_F64[case]})")
        check(e_jax <= F32_SOLVE_VS_JAX[case] and e64 <= F32_SOLVE_VS_F64[case],
              f"the float32 reduced solve ({case}) is off its bounds")
    r = unflatten(fx, "round32/")
    win, prior = to_torch(Window, r["window"], dev), to_torch(Prior, r["prior"], dev)
    cfg, params = to_torch(SolverConfig, r["cfg"], dev), to_torch(IntegrationParams,
                                                                  r["params"], dev)
    out = marginalize_node0(win, prior, cfg, params)
    check(out.H.dtype == torch.float32, "the float32 prior came back in another dtype")
    H = out.H.double().cpu().numpy()
    fro = float(np.linalg.norm(H - r["marg_H"]) / np.linalg.norm(r["marg_H"]))
    w = np.linalg.eigvalsh(H)
    log(f"phase 10 (a) float32 reduced solve on the card, " + "; ".join(parts))
    log(f"phase 10 (a) float32 marginalize_node0 on the card: H {fro:.3g} from JAX float32 "
        f"(relative Frobenius, <= {F32_PRIOR_FRO}), g zero {not bool(out.g.any())}, eigenvalues "
        f"{w[0]:.3g} .. {w[-1]:.3g} ({w[0] / w[-1]:.3g} >= {F32_PRIOR_EIG_FLOOR})")
    check(fro <= F32_PRIOR_FRO and not bool(out.g.any())
          and w[0] >= F32_PRIOR_EIG_FLOOR * w[-1], "the float32 marginalization is off JAX's")

    inputs, ref = round_inputs(dev)
    rows = {}
    for dtype in (torch.float64, torch.float32):
        args = [cast(x, dtype) for x in inputs]
        first, _ = round_once(*args)  # also warms the solver libraries
        out, ms = round_once(*args)
        _, _, _, w_opt, (s1, s2, nc), w_sl, pr = out
        _, launches, dev_ms, wall, busy = profiled(lambda: round_once(*args))
        check(w_opt.nodes.p.dtype == pr.H.dtype == dtype, "the round changed its dtype")
        # the card's sums run in a fixed order (solver/assembly.index_sum_):
        # the same round twice gives the same bits
        check(tensor_bits(first) == tensor_bits(out),
              f"two {str(dtype)[6:]} rounds on the same inputs differ")
        check(all(bool(torch.isfinite(x).all()) for x in (w_opt.nodes.p, pr.H)),
              "the round is not finite")
        dp = float(np.abs(w_opt.nodes.p.double().cpu().numpy() - ref["opt"]["nodes"]["p"]).max())
        rows[dtype] = (ms, launches, busy, dp, (s1.iters_run, s2.iters_run), int(nc))
    for dtype, (ms, launches, busy, dp, iters, nc) in rows.items():
        log(f"phase 10 (a) round in {str(dtype)[6:]} (24 x 192, {ITERS} iters): " + ", ".join(
            f"{k} {v:.2f}" for k, v in ms.items()) + f" ms, round {sum(ms.values()):.2f} ms; "
            f"{launches} launches, busy {busy:.4f} (profiled); LM iterations {iters}, culled "
            f"{nc}; positions {dp:.3g} m from JAX float64's optimum; a second round on "
            f"the same inputs gives the same bits")
    check(rows[torch.float32][3] <= F32_ROUND_POS_ATOL,
          f"the float32 round's optimum is more than {F32_ROUND_POS_ATOL} m from JAX's")


def phase_estimator_f32(dev, phase5):
    """Phase 10 (b): ``Estimator(EngineConfig(), dtype=torch.float32)`` on
    phase 5's streams against the JAX float32 run of them and the JAX
    float64 run; stage medians beside phase 5's."""
    import torch

    fx = f32_fixture()
    s, _, line5 = phase5
    ref = {k[len("defaults32/"):]: v for k, v in fx.items() if k.startswith("defaults32/")}
    ref64 = {k[4:]: v for k, v in scenario(dict(np.load(ESTIMATOR_FIXTURE)),
                                           "defaults_native").items() if k.startswith("out/")}
    (est, got), wall_ms = timed(lambda: run_estimator(s, dev, dtype=torch.float32))
    check(est.window.nodes.p.dtype == est.prior.H.dtype == torch.float32,
          "the float32 Estimator came back in another dtype")
    check(np.isfinite(got["traj_p"]).all(), "the float32 Estimator's trajectory is not finite")
    part = first_parting(got, ref)
    # the entries at JAX float32's node times (the same frames unless a
    # keyframe decision parts), as samples of the truth grid: a float32
    # node time is its predecessor's plus its interval's IMU steps, so the
    # same frame's time differs in its last bits where the node chains
    # before it differ
    _, ig, ir = np.intersect1d(grid_index(got["traj_t"], s, F32_TIME_ATOL),
                               grid_index(ref["traj_t"], s, F32_TIME_ATOL), return_indices=True)
    n, n_ref = len(ig), len(ref["traj_t"])
    dist = float(np.max(np.linalg.norm(got["traj_p"][ig] - ref["traj_p"][ir], axis=1)))
    e = trajectory_errors(got["traj_t"], got["traj_p"], s, 5.0, atol_t=F32_TIME_ATOL)
    ate = rms(e)
    log(f"phase 10 (b) Estimator(EngineConfig(), dtype=float32): {len(got['stats'])} rounds "
        f"(JAX float32 {len(ref['stats'])}, float64 {len(ref64['stats'])}), events "
        f"{'as JAX float32' if part is None else f'part from JAX float32 at event {part}'}, "
        f"n_recenters {est.n_recenters} (JAX float32 {int(ref['n_recenters'])}), final state "
        f"{est.state}; trajectory {dist:.3g} m from JAX float32 at the {n} of its {n_ref} "
        f"node times it shares (<= {F32_TRAJ_VS_JAX32}); ATE "
        f"{ate:.4f} m (JAX float32 {float(ref['ate_rmse']):.4f}, float64 "
        f"{float(ref64['ate_rmse']):.4f}; <= JAX float32 + {F32_ATE_MARGIN})")
    log("phase 10 (b) float32 " + stage_line(est, wall_ms / 1e3, float(s["imu_t"][-1])))
    log("phase 10 (b) beside phase 5, float64: " + line5)
    check(est.n_recenters >= 1, "the float32 Estimator never re-centered")
    check(n >= 0.9 * n_ref and dist <= F32_TRAJ_VS_JAX32,
          "the float32 Estimator's trajectory is off JAX float32's")
    check(ate <= float(ref["ate_rmse"]) + F32_ATE_MARGIN, "the float32 Estimator's ATE")


def phase_kaist_f32(dev, work, seq, line6):
    """Phase 10 (c): ``run_kaist --f32`` on phase 6's KAIST-layout
    directory: TRACKING_NORMAL, one KLT launch per tracked frame, phase
    6's ATE bound, the output files. Returns its KLT launches."""
    from ic_gvins_tpu_torch.engine.estimator import TRACKING_NORMAL

    out = os.path.join(work, "run_f32")
    res, pipe, tracked, launches, wall, t, err = replay_kaist(dev, seq, out, "phase 10 (c)",
                                                              ["--f32"])
    est = pipe.est
    ate = rms(err[t >= T_BASE + PIPELINE_T_MIN])
    ate_run = rms(err[t >= t[0] + 5.0])
    data_s = float(seq[3][-1] - seq[3][0]) - 1.0  # the truth runs 1 s past the data
    log(f"phase 10 (c) run_kaist --f32 ({res['frames']} frames): dtype {res['dtype']}, final "
        f"state {est.state}, {len(est.stats)} rounds, n_recenters {res['n_recenters']}; KLT "
        f"launches {launches} for {tracked} tracked frames; ATE after {PIPELINE_T_MIN:.0f} s "
        f"{ate:.4f} m (< {PIPELINE_ATE}), the command's {res['ate_rmse_m']}; "
        + stage_line(est, wall, data_s))
    log("phase 10 (c) beside phase 6, float64: " + line6)
    check(res["dtype"] == "float32", "run_kaist --f32 did not run in float32")
    check(est.state == TRACKING_NORMAL, "run_kaist --f32 did not reach TRACKING_NORMAL")
    check(tracked > 0 and launches == tracked, "run_kaist --f32 did not launch the KLT kernel "
          "once per tracked frame")
    check(ate < PIPELINE_ATE, f"run_kaist --f32 ATE {ate:.3f} m >= {PIPELINE_ATE}")
    check(abs(res["ate_rmse_m"] - ate_run) <= 1e-4, "the command's ATE disagrees with its "
          "trajectory.csv")
    return launches


def phase_urban_f32(dev, work):
    """Phase 10 (d): ``run_urban --f32`` on the first URBAN_F32_S s of the
    JAX runner's 90 s drive (phase 8 (d)'s file and flags): no NaN,
    re-centered, a PSD prior, one KLT launch per tracked frame; its ATE
    beside the JAX float64 and float32 replays of the whole file (the JAX
    float32 one diverges on this route, so no ATE bound is set), and where
    it parts from the JAX float32 replay within its span. Returns its KLT
    launches."""
    import torch

    from ic_gvins_tpu_torch.tools import run_urban
    from ic_gvins_tpu_torch.vision import klt_cuda

    out = os.path.join(work, "urban_f32")
    os.makedirs(out)
    sensors = os.path.join(out, "sensors.npz")
    with np.load(URBAN_FIXTURE) as z:
        ate64 = float(z["jax/ate_rmse_m"])
        # the replay runs the whole file: its streams cut to the first URBAN_F32_S s
        keep = {"imu": z["imu_time"] <= URBAN_F32_S, "gnss": z["gnss_time"] <= URBAN_F32_S,
                "frame": z["frame_times"] <= URBAN_F32_S}
        np.savez(sensors, **{k: z[k][keep[k.split("_")[0]]] if k.split("_")[0] in keep else z[k]
                             for k in z.files if not k.startswith("jax/")})
    fx = f32_fixture()
    j32 = {k[len("urban32/"):]: v for k, v in fx.items() if k.startswith("urban32/")}
    argv = ["--f32", "--duration", str(URBAN_F32_S), "--outages", *map(str, URBAN_OUTAGE),
            "--checkpoint-every", str(URBAN_CKPT), "--sensors", sensors, "--out", out,
            "--device", str(dev)]
    klt_cuda.lk_track_bidirectional.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with watch_pipeline() as seen, redirect_stdout(printed):
        res = run_urban.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = klt_cuda.lk_track_bidirectional.launches
    pipe, tracked = seen["pipe"], seen["tracked"]
    est = pipe.est
    for line in printed.getvalue().splitlines():
        if line.startswith('{"sim_t"'):
            log("phase 10 (d) run_urban --f32 progress: " + line)
    with np.load(os.path.join(out, "trajectory.npz")) as z:
        span = j32["est_t"] <= z["est_t"][-1] + 1e-6  # the JAX replay over this run's span
        parting = parting_line(z["est_t"], z["est_p"], j32["est_t"][span], j32["est_p"][span])
        finite = bool(np.isfinite(z["est_p"]).all())
    log(f"phase 10 (d) run_urban --f32 {URBAN_F32_S:.0f} s: mode {res['mode']}, final state "
        f"{est.state}, {len(est.stats)} rounds, n_recenters {res['n_recenters']} (JAX float32 "
        f"{int(j32['n_recenters'])}), prior eig min {res['prior_eig_min']:.3g} rank "
        f"{res['prior_rank']}; KLT launches {launches} for {tracked} tracked frames; ATE rmse "
        f"{res['ate_rmse_m']:.4f} m, max {res['ate_max_m']:.4f} m (JAX float64 {ate64:.4f}, "
        f"JAX float32 {float(j32['ate_rmse_m']):.4f} rmse / {float(j32['ate_max_m']):.4f} max "
        f"over its {float(j32['duration']):.0f} s); " + stage_line(est, wall, URBAN_F32_S))
    log("phase 10 (d) against the JAX float32 replay: " + parting)
    check(res["mode"] == "f32" and est.window.nodes.p.dtype == torch.float32,
          "run_urban --f32 did not run in float32")
    check(finite and res["ate_rmse_m"] is not None and np.isfinite(res["ate_rmse_m"]),
          "run_urban --f32 produced a non-finite trajectory")
    check(res["n_recenters"] >= 1, "run_urban --f32 never re-centered")
    check(res["prior_eig_min"] >= 0.0, "run_urban --f32 left an indefinite prior")
    check(tracked > 0 and launches == tracked, "run_urban --f32 did not launch the KLT kernel "
          "once per tracked frame")
    return launches


def phase_batch_f32(dev, wins, prior, cfg, params, f64):
    """Phase 10 (e): ``optimize_batch`` of phase 9's 32 windows in float32
    against each window's float32 ``optimize``; ms, launches and busy share
    beside phase 9 (a)'s float64 call (``f64``)."""
    import torch

    from ic_gvins_tpu_torch.convert import cast
    from ic_gvins_tpu_torch.parallel import multi_seq
    from ic_gvins_tpu_torch.solver.lm import optimize

    f = lambda x: cast(x, torch.float32)  # noqa: E731
    wins, prior, cfg, params = [f(w) for w in wins], f(prior), f(cfg), f(params)
    windows = multi_seq.stack_windows(wins)
    priors = multi_seq.stack_priors([prior] * BATCH)
    batched = lambda: multi_seq.optimize_batch(windows, priors, cfg, params, iters=ITERS)  # noqa: E731
    batched()  # warm-up
    (out, (c0, c1, ncull, iters, acc)), ms_b = timed(batched)
    _, n_b, dev_b, wall_b, busy_b = profiled(batched)
    ref, ms_s = timed(lambda: [optimize(w, prior, cfg, params, iters=ITERS) for w in wins])
    check(out.nodes.p.dtype == torch.float32, "the float32 batch came back in another dtype")
    worst, same = 0.0, 0
    for b, (w, (s1, s2, nc)) in enumerate(ref):
        check(int(ncull[b]) == int(nc), f"batch member {b}: culls differ from its own round")
        same += (int(iters[b]), int(acc[b])) == (s1.iters_run + s2.iters_run,
                                                 s1.accepted + s2.accepted)
        worst = max(worst, float((out.nodes.p[b] - w.nodes.p).abs().max()))
    log(f"phase 10 (e) optimize_batch of {BATCH} float32 windows: culls as each one's own "
        f"float32 round, iterations and accepted steps as it in {same} of {BATCH}, positions "
        f"{worst:.3g} m from it (<= {F32_BATCH_POS_ATOL}); batched call {ms_b:.2f} ms, "
        f"{BATCH} single float32 rounds {ms_s:.2f} ms; launches {n_b}, busy share "
        f"{busy_b:.4f} ({dev_b:.2f} ms of device time in {wall_b:.2f} ms profiled); phase 9 "
        f"(a), float64: {f64['ms']:.2f} ms, {f64['launches']} launches, busy {f64['busy']:.4f}, "
        f"{BATCH} single rounds {f64['single_ms']:.2f} ms")
    check(worst <= F32_BATCH_POS_ATOL, "float32 batch members are off their own rounds")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    fixtures = (FIXTURE, ESTIMATOR_FIXTURE, ODO_FIXTURE, SIM_FIXTURE, URBAN_FIXTURE,
                PARALLEL_FIXTURE, F32_FIXTURE, ENTRY_FIXTURE)
    if not os.path.isdir(os.path.join(ROOT, "ic_gvins_tpu_torch")) or not all(
            os.path.exists(f) for f in fixtures):
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
    phase5 = phase_estimator(dev)
    work = os.path.join(ROOT, "build", "smoke_replay")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        launches_pipeline, seq, line6 = phase_pipeline(dev, work)
        phase_odometer(dev, work)
        phase_simulator(dev)
        phase_generate(dev, work)
        phase_run_sim(dev, work)
        launches_urban, (err_u, ms_u, plain_u, bound_u, by_u) = phase_urban(dev, work)
        # phase 9: the parallel/ package on the card
        klt_cuda.lk_track_bidirectional.launches = 0
        t9 = time.perf_counter()
        wins, prior, cfg, params, fx, batch64 = phase_batch(dev)
        sharded9 = phase_sharded(dev, wins, prior, cfg, params, phase5)
        ba9 = phase_ba_nodes(dev, fx)
        check(klt_cuda.lk_track_bidirectional.launches == 0, "phase 9 launched the KLT kernel")
        log(f"phase 9 wall: {time.perf_counter() - t9:.1f} s")
        # phase 10: the float32 engine mode; (c) and (d) zero and read the
        # KLT's count around their commands
        t10 = time.perf_counter()
        klt_cuda.lk_track_bidirectional.launches = 0
        phase_f32_modules(dev)
        phase_estimator_f32(dev, phase5)
        check(klt_cuda.lk_track_bidirectional.launches == 0,
              "phase 10 (a)-(b) launched the KLT kernel")
        launches_kaist32 = phase_kaist_f32(dev, work, seq, line6)
        launches_urban32 = phase_urban_f32(dev, work)
        klt_cuda.lk_track_bidirectional.launches = 0
        phase_batch_f32(dev, wins, prior, cfg, params, batch64)
        check(klt_cuda.lk_track_bidirectional.launches == 0, "phase 10 (e) launched the KLT kernel")
        log(f"phase 10 wall: {time.perf_counter() - t10:.1f} s")
        # phase 11: phase 9's paths across torch.distributed ranks
        klt_cuda.lk_track_bidirectional.launches = 0
        t11 = time.perf_counter()
        phase_distributed(dev, {**sharded9, "ba": ba9,
                                "batch": {**batch64["result"], "ms": batch64["ms"]}}, fx)
        check(klt_cuda.lk_track_bidirectional.launches == 0, "phase 11 launched the KLT kernel")
        log(f"phase 11 wall: {time.perf_counter() - t11:.1f} s")
        # phase 12: the entry point and its dry run
        klt_cuda.lk_track_bidirectional.launches = 0
        t12 = time.perf_counter()
        phase_entry(dev)
        phase_dryrun(dev)
        check(klt_cuda.lk_track_bidirectional.launches == 0, "phase 12 launched the KLT kernel")
        log(f"phase 12 wall: {time.perf_counter() - t12:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 8 klt at the urban replay's shape (320x240, 120 feature slots, 4 images): "
        f"kernel {ms_u:.4f} ms on the card, plain {plain_u:.4f} ms, bound {bound_u:.5f} ms "
        f"({by_u}), max |kernel - plain| {err_u:.3g} px")
    klt_stats.update(ms_urban=ms_u, plain_ms_urban=plain_u, bound_ms_urban=bound_u,
                     max_abs_err=max(klt_stats["max_abs_err"], err_u))
    launches = (launches_frontend + launches_pipeline + launches_urban + launches_kaist32
                + launches_urban32)
    log(f"klt launches: frontend {launches_frontend}, replay {launches_pipeline}, "
        f"urban replay {launches_urban}, float32 replay {launches_kaist32}, float32 urban "
        f"replay {launches_urban32}")
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
