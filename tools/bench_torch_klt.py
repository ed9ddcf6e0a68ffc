#!/usr/bin/env python3
"""Time the port's KLT kernel on one NVIDIA GPU, for any checkout of the port.

    python3 tools/bench_torch_klt.py [--root DIR] [--reps 3]

Imports ``ic_gvins_tpu_torch`` from ``--root`` (default: this checkout), so
two versions of the kernel can be timed on the same card on the same
inputs: unpack the other commit somewhere (``git archive``), and run this
script once per root, in turns, inside one job. The frames, the timing
(``cuda_ms``: CUDA events, the calls queued behind a spin so that the card
alone is timed, and back to back), the points (``klt_inputs``) and the sizes
are ``chip_smoke.py``'s of this checkout: 4 levels of 1278 x 1022, 200 / 1000 / 4000 features. Prints
the card's name and power limit and one JSON line of ms per bidirectional
call, each the median of ``--reps`` windows of 50 calls.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_klt: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))
    from ic_gvins_tpu_torch.vision import klt_cuda
    from ic_gvins_tpu_torch.vision.pyramid import build_pyramid

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    frames = cs.make_frames(2)
    pyr0 = build_pyramid(torch.as_tensor(frames[0], device=dev), cs.PYR_LEVELS)
    pyr1 = build_pyramid(torch.as_tensor(frames[1], device=dev), cs.PYR_LEVELS)
    out = {"root": os.path.abspath(args.root), "card": card}
    for n in cs.KLT_SIZES:
        inputs = cs.klt_inputs(n, pyr0, pyr1)
        call = lambda: klt_cuda.lk_track_bidirectional(*inputs)  # noqa: E731
        _, ok, _ = call()
        for _ in range(3):
            call()
        out[f"ok_{n}"] = float(ok.float().mean())
        out[f"ms_{n}"] = float(np.median(
            [cs.cuda_ms(call, 50, queue_ahead=True) for _ in range(args.reps)]))
        out[f"ms_back_to_back_{n}"] = float(np.median(
            [cs.cuda_ms(call, 50) for _ in range(args.reps)]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
