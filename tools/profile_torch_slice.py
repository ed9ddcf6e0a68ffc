#!/usr/bin/env python3
"""Where the time of the PyTorch port's slice goes, on one NVIDIA GPU.

    python3 tools/profile_torch_slice.py [--reps 5] [--out DIR]

Runs each stage of the keyframe round of ``chip_smoke.py`` (the
24-node x 192-landmark float64 fixture, 20 LM iterations) ``--reps`` times
from fixed inputs and prints the median wall per stage (host clock around
synchronized work). Then it profiles one run of each stage, and 5 front-end
frames at 1278 x 1022, with ``torch.profiler``: kernel launches, summed
device time, wall and the device's busy share (device time over wall), and
the heaviest operators. Chrome traces go to ``--out`` when it is given.
Needs a CUDA device; the numbers are the card's, printed beside its name
and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def profiled(fn, name, out):
    """Run fn once under torch.profiler; print launches, device ms, wall
    and busy share, and return the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profiled {name}: {launches} kernel launches, device {dev_ms:.3f} ms, "
          f"wall {wall:.3f} ms, busy share {dev_ms / wall:.4f}", flush=True)
    if out:
        prof.export_chrome_trace(os.path.join(out, f"trace_{name}.json"))
    return prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    import chip_smoke as cs
    from ic_gvins_tpu_torch.engine.frontend import Frontend
    from ic_gvins_tpu_torch.engine.keyframe import preintegrate_window, triangulate_window
    from ic_gvins_tpu_torch.factors.marginalization import marginalize_and_slide
    from ic_gvins_tpu_torch.solver.lm import optimize_impl
    from ic_gvins_tpu_torch.vision import camera as cam_mod

    print(card(), flush=True)
    dev = torch.device("cuda", 0)
    (win, prior, cfg, params, imu), _ = cs.round_inputs(dev)
    w_pre = preintegrate_window(win, params, imu)
    w_tri = triangulate_window(w_pre)[0]
    w_opt = optimize_impl(w_tri, prior, cfg, params, iters=cs.ITERS)[0]
    stages = {
        "preint": lambda: preintegrate_window(win, params, imu),
        "triangulate": lambda: triangulate_window(w_pre),
        "optimize": lambda: optimize_impl(w_tri, prior, cfg, params, iters=cs.ITERS),
        "marginalize": lambda: marginalize_and_slide(w_opt, prior, cfg, params),
    }
    walls = {k: [] for k in stages}
    for _ in range(args.reps):
        for k, fn in stages.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    for k, v in walls.items():
        print(f"stage {k}: median {np.median(v):.3f} ms, min {min(v):.3f}, "
              f"max {max(v):.3f} ({args.reps} runs)", flush=True)
    total = np.sum([v for v in walls.values()], 0)
    print(f"round: median {np.median(total):.3f} ms, min {total.min():.3f}, "
          f"max {total.max():.3f}", flush=True)
    for k, fn in stages.items():
        prof = profiled(fn, k, args.out)
        if k == "optimize":
            print(prof.key_averages().table(sort_by="self_device_time_total",
                                            row_limit=12), flush=True)

    frames = cs.make_frames(cs.N_FRAMES)
    cam = cam_mod.Camera.create(cam_mod.DEFAULT_INTRINSIC, cam_mod.DEFAULT_DISTORTION,
                                cam_mod.DEFAULT_RESOLUTION, device=dev)
    fe = Frontend(cam, max_features=cs.N_FEATURES, pyramid_levels=cs.PYR_LEVELS,
                  cell=cs.CELL)
    q, p = np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3)
    for k in range(3):
        fe.process(0.1 * k, frames[k], q_wc=q, p_wc=p)

    def frontend():
        for k in range(3, 8):
            fe.process(0.1 * k, frames[k], q_wc=q, p_wc=p)

    prof = profiled(frontend, "frontend_5_frames", args.out)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=10),
          flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
