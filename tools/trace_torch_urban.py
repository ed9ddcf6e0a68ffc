#!/usr/bin/env python
"""Trace where the PyTorch port's ``run_urban`` replay of the JAX runner's
90 s drive (``tests/fixtures/torch_urban90.npz``) parts between two ways
of running its front end.

One replay records, for every frame, the front end's feature table after
the frame (ids, the valid flags, the tracked pixels) and the inlier mask of
its FM-RANSAC:

    python tools/trace_torch_urban.py --device cuda --tracker kernel --out build/trace/kernel.npz
    python tools/trace_torch_urban.py --device cuda --tracker plain --out build/trace/plain.npz
    python tools/trace_torch_urban.py --device cuda --tracker plain --ransac-device cpu \\
        --out build/trace/plain_cpu_ransac.npz
    python tools/trace_torch_urban.py --device cpu --out build/trace/cpu.npz

``--tracker plain`` tracks with the plain PyTorch tracker (``vision/klt.py``)
on the replay's device instead of the KLT kernel; ``--ransac-device cpu``
fits the RANSAC hypotheses on the CPU. Then

    python tools/trace_torch_urban.py --compare build/trace/a.npz build/trace/b.npz

prints the first frame whose tracks (ids or valid flags) or RANSAC inliers
differ between two records, the largest pixel gap of the tracks before it,
and where the two trajectories part.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
URBAN = os.path.join(ROOT, "tests", "fixtures", "torch_urban90.npz")
# the flags of the replay chip_smoke.py phase 8 (d) runs
REPLAY = ["--duration", "90", "--outages", "60", "75", "--checkpoint-every", "60"]


def record(args):
    import torch

    from ic_gvins_tpu_torch.engine import frontend as fe_mod
    from ic_gvins_tpu_torch.tools import run_urban
    from ic_gvins_tpu_torch.vision import klt, klt_cuda

    frames, inliers = [], {}
    ransac = fe_mod.ransac_mod.fundamental_ransac
    process = fe_mod.Frontend.process

    def traced_ransac(pts0, pts1, valid, thr, u):
        dev = pts0.device
        if args.ransac_device == "cpu":
            cpu = lambda x: x.cpu() if torch.is_tensor(x) else x  # noqa: E731
            inl, F = ransac(*map(cpu, (pts0, pts1, valid, thr, u)))
            inl, F = inl.to(dev), F.to(dev)
        else:
            inl, F = ransac(pts0, pts1, valid, thr, u)
        inliers[len(frames)] = inl.cpu().numpy()
        return inl, F

    def traced_process(self, t, img, **kw):
        out = process(self, t, img, **kw)
        frames.append((float(t), self.ids.copy(), self.valid.copy(), self.pts.copy()))
        return out

    fe_mod.ransac_mod.fundamental_ransac = traced_ransac
    fe_mod.Frontend.process = traced_process
    if args.tracker == "plain":
        klt_cuda.lk_track_bidirectional = klt.lk_track_bidirectional
    with tempfile.TemporaryDirectory() as tmp:
        sensors = os.path.join(tmp, "sensors.npz")
        with np.load(URBAN) as z:
            np.savez(sensors, **{k: z[k] for k in z.files if not k.startswith("jax/")})
        res = run_urban.main([*REPLAY, "--sensors", sensors, "--out", tmp,
                              *(["--device", args.device] if args.device else [])])
        with np.load(os.path.join(tmp, "trajectory.npz")) as z:
            traj_t, traj_p = z["est_t"], z["est_p"]
    n, F = len(frames), len(frames[0][1])
    inl = np.zeros((n, F), np.int8) - 1  # -1: no RANSAC on this frame
    for i, m in inliers.items():
        inl[i] = m
    np.savez_compressed(
        args.out, t=np.array([f[0] for f in frames]), ids=np.stack([f[1] for f in frames]),
        valid=np.stack([f[2] for f in frames]), pts=np.stack([f[3] for f in frames]),
        inliers=inl, traj_t=traj_t, traj_p=traj_p, ate_rmse_m=np.float64(res["ate_rmse_m"]),
        setup=np.array(json.dumps(dict(device=args.device, tracker=args.tracker,
                                       ransac_device=args.ransac_device))))
    print(json.dumps({"frames": n, "ate_rmse_m": res["ate_rmse_m"],
                      "trajectory_entries": len(traj_t), "out": args.out}))


def compare(a_path, b_path):
    from chip_smoke import parting_line

    a, b = dict(np.load(a_path)), dict(np.load(b_path))
    n = min(len(a["t"]), len(b["t"]))
    first, what = None, None
    for i in range(n):
        for k in ("ids", "valid", "inliers"):
            if not np.array_equal(a[k][i], b[k][i]):
                first, what = i, k
                break
        if first is not None:
            break
    m = n if first is None else first
    both = a["valid"][:m] & b["valid"][:m]
    gap = float(np.abs(a["pts"][:m] - b["pts"][:m])[both].max()) if both.any() else 0.0
    out = {"a": str(a["setup"]), "b": str(b["setup"]), "frames": n,
           "ate_rmse_m": [float(a["ate_rmse_m"]), float(b["ate_rmse_m"])],
           "first_frame_apart": first, "what": what,
           "t": None if first is None else float(a["t"][first]),
           "max_track_gap_px_before": gap,
           "trajectory": parting_line(a["traj_t"], a["traj_p"], b["traj_t"], b["traj_p"])}
    if first is not None:
        d = a[what][first] != b[what][first]
        out["slots_apart"] = np.nonzero(d)[0].tolist()
        if what == "inliers":
            out["inliers_a_b"] = [int((a["inliers"][first] == 1).sum()),
                                  int((b["inliers"][first] == 1).sum())]
    print(json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    ap.add_argument("--tracker", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--ransac-device", choices=("same", "cpu"), default="same")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        record(args)


if __name__ == "__main__":
    main()
