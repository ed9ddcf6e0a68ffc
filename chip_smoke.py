#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ic_gvins_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path at the engine's default sizes: the visual
front end (``Frontend.process``) over 1278 x 1022 frames with 200
features and a 4-image pyramid, then one GVINS keyframe round on a
24-node x 192-landmark float64 window (preintegrate -> triangulate ->
``optimize_impl(iters=20)`` -> ``marginalize_and_slide``). Phases:

1. the card's name and power limit; build the CUDA kernel (nvcc, sm_90a);
2. KLT kernel vs its plain PyTorch version at slice shapes, with times;
3. ``Frontend.process`` over 8 frames shifted by a known subpixel flow;
4. the keyframe round, held against the JAX package's float64 results in
   ``tests/fixtures/torch_slice_24x192.npz`` (``tools/make_torch_fixture.py``).

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

IMG_W, IMG_H = 1278, 1022  # engine default camera
N_FEATURES = 200
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
# Keyframe round vs JAX float64 on the CPU: closed forms agree to rounding
# (relative 1e-9 of each array's largest entry); the 20 LM iterations and
# the marginalization's eigen-decomposition amplify reduction-order
# differences, hence 1e-7.
RTOL_CLOSED = 1e-9
RTOL_ITERATIVE = 1e-7
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


def make_frames(n):
    """Band-limited noise (smoothed uniform noise), shifted by k * FLOW."""
    from scipy.ndimage import gaussian_filter, shift

    rng = np.random.RandomState(0)
    base = gaussian_filter(rng.rand(IMG_H, IMG_W) * 255.0, 2.0) * 4.0
    return [
        shift(base, (k * FLOW[1], k * FLOW[0]), order=3, mode="nearest").astype(np.float32)
        for k in range(n)
    ]


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


def phase_klt(frames, dev):
    import torch

    from ic_gvins_tpu_torch.vision import klt, klt_cuda
    from ic_gvins_tpu_torch.vision.pyramid import build_pyramid

    pyr0 = build_pyramid(torch.as_tensor(frames[0], device=dev), PYR_LEVELS)
    pyr1 = build_pyramid(torch.as_tensor(frames[1], device=dev), PYR_LEVELS)
    rng = np.random.RandomState(1)
    pts = rng.rand(N_FEATURES, 2) * np.array([IMG_W - 80, IMG_H - 80]) + 40
    pts0 = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    valid = torch.ones(N_FEATURES, dtype=torch.bool, device=dev)
    args = (pyr0, pyr1, pts0, pts0, valid)

    pk, ok_k, _ = klt_cuda.lk_track_bidirectional(*args)
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
    log(f"phase 2 klt: {N_FEATURES} features, 4 levels of {IMG_W}x{IMG_H}: "
        f"ok kernel {frac:.3f}, ok agreement {agree:.4f} (>= {KLT_OK_AGREE}), "
        f"max |kernel - plain| {err:.3g} px (<= {KLT_PTS_ATOL}), "
        f"median flow error {flow_err:.3g} px (<= {FLOW_ATOL})")
    check(err <= KLT_PTS_ATOL, "KLT kernel disagrees with the plain version")
    check(agree >= KLT_OK_AGREE, "KLT kernel ok flags disagree with the plain version")
    check(flow_err <= FLOW_ATOL and frac >= 0.9, "KLT kernel missed the known flow")

    kernel = lambda: klt_cuda.lk_track_bidirectional(*args)  # noqa: E731
    plain = lambda: klt.lk_track_bidirectional(*args)  # noqa: E731
    for _ in range(3):
        kernel()
        plain()
    # in turns: plain, kernel, kernel, plain. The kernel's time is the
    # card's (calls queued behind a spin); the plain version syncs with the
    # host every iteration, so its time is what a caller waits.
    t_p1 = cuda_ms(plain, 10)
    t_k1 = cuda_ms(kernel, 50, queue_ahead=True)
    t_k2 = cuda_ms(kernel, 50, queue_ahead=True)
    t_p2 = cuda_ms(plain, 10)
    t_call = cuda_ms(kernel, 50)
    ms_k, ms_p = 0.5 * (t_k1 + t_k2), 0.5 * (t_p1 + t_p2)
    log(f"phase 2 klt time: kernel {ms_k:.4f} ms on the card ({t_k1:.4f}, {t_k2:.4f}), "
        f"{t_call:.4f} ms per call back to back; plain {ms_p:.4f} ms "
        f"({t_p1:.4f}, {t_p2:.4f}) per bidirectional call")
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p}


def phase_frontend(frames, dev):
    import torch

    from ic_gvins_tpu_torch.engine.frontend import Frontend
    from ic_gvins_tpu_torch.vision import camera as cam_mod

    cam = cam_mod.Camera.create(cam_mod.DEFAULT_INTRINSIC, cam_mod.DEFAULT_DISTORTION,
                                cam_mod.DEFAULT_RESOLUTION, device=dev)
    fe = Frontend(cam, max_features=N_FEATURES, pyramid_levels=PYR_LEVELS, cell=CELL)
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "ic_gvins_tpu_torch")) or not os.path.exists(FIXTURE):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ic_gvins_tpu_torch.vision import klt_cuda

    dev = torch.device("cuda", 0)
    phase_build()
    frames = make_frames(N_FRAMES)
    klt_stats = phase_klt(frames, dev)

    klt_cuda.lk_track_bidirectional.launches = 0  # count the main path only
    phase_frontend(frames, dev)
    phase_round(dev)
    launches = klt_cuda.lk_track_bidirectional.launches
    check(launches > 0, "the front end never launched the KLT kernel")

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
