#!/usr/bin/env python
"""Multi-process landmark-sharded LM runner, the port's counterpart of the
JAX package's ``tools/multihost_lm.py``: N processes join one
``torch.distributed`` process group, the mesh's ``"lm"`` axis (N x K
global shards, K a process) crosses the process boundary, and the
reductions of ``parallel/lm_sharded.optimize_sharded`` ride the backend's
``all_reduce``. Each process builds the same problem, the JAX runner's
``_tiny_problem(n_nodes=6, n_landmarks=32, seed=7)`` stored in
``tests/fixtures/torch_multihost.npz`` (``tools/make_torch_multihost_fixture.py``),
runs the two-phase round (8 iterations) and compares it with the port's
one-process ``lm.optimize`` of the same problem: positions within 1e-8 m
and the same decisions, on every process. Process 0 prints one JSON line
(``ok``, ``max_node_p_err``, ``cost1_sharded``, ``cost1_single``,
``n_processes``, ``n_global_shards``, ``backend``, and
``max_node_p_err_jax`` against the JAX runner's 8-device round); the exit
code is 1 when the comparison fails on any process.

    # two processes on the CPU, four shards each
    python -m ic_gvins_tpu_torch.tools.multihost_lm --init tcp://127.0.0.1:PORT \\
        --nproc 2 --pid 0 --local-shards 4 --backend gloo --device cpu &
    python -m ic_gvins_tpu_torch.tools.multihost_lm --init tcp://127.0.0.1:PORT \\
        --nproc 2 --pid 1 --local-shards 4 --backend gloo --device cpu
    # one process per card
    ... --backend nccl --device cuda:R

The device of each process is an argument: ``nccl`` needs one card per
process, ``gloo`` takes any (on a card it stages each all-reduce through
host memory).
"""

import argparse
import json
import os
import sys

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                       "tests", "fixtures", "torch_multihost.npz")
POS_ATOL = 1e-8  # m, the JAX runner's bound


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init", required=True, help="rendezvous, e.g. tcp://127.0.0.1:PORT")
    ap.add_argument("--nproc", type=int, required=True, help="processes (the world size)")
    ap.add_argument("--pid", type=int, required=True, help="this process's rank")
    ap.add_argument("--local-shards", type=int, default=4, help="landmark shards a process")
    ap.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    ap.add_argument("--device", required=True, help="this process's device, e.g. cuda:0 or cpu")
    ap.add_argument("--timeout", type=float, default=60.0, help="s, bound on each collective")
    ap.add_argument("--fixture", default=FIXTURE)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from ..convert import to_torch, unflatten
    from ..data.types import IntegrationParams
    from ..parallel import Mesh, init_distributed, shutdown_distributed
    from ..parallel.lm_sharded import optimize_sharded
    from ..solver.lm import optimize
    from ..solver.window import Prior, SolverConfig, Window

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(args.backend, args.init, args.nproc, args.pid, timeout=args.timeout)
    try:
        fx = unflatten(dict(np.load(args.fixture)))
        inp = fx["in"]
        win = to_torch(Window, inp["window"], dev)
        prior = to_torch(Prior, inp["prior"], dev)
        cfg = to_torch(SolverConfig, inp["cfg"], dev)
        params = to_torch(IntegrationParams, inp["params"], dev)
        iters = int(inp["iters"])
        mesh = Mesh({"lm": args.nproc * args.local_shards}, device=dev)
        out, (s1, s2, nc) = optimize_sharded(win, prior, cfg, params, mesh, iters=iters)
        ref, (r1, r2, nr) = optimize(win, prior, cfg, params, iters=iters)
        p = out.nodes.p.cpu().numpy()
        err = float(np.max(np.abs(p - ref.nodes.p.cpu().numpy())))
        err_jax = float(np.max(np.abs(p - fx["sharded"]["window"]["nodes"]["p"])))
        cost1 = float(s2.cost1)
        same = ((s1.accepted, s2.accepted, s1.iters_run, s2.iters_run, int(nc))
                == (r1.accepted, r2.accepted, r1.iters_run, r2.iters_run, int(nr)))
        ok = err < POS_ATOL and np.isfinite(cost1) and same
        # the verdict of every process
        bad = mesh.all_reduce(torch.tensor([0 if ok else 1], device=dev), "max")
        ok = ok and int(bad[0]) == 0
    finally:
        shutdown_distributed()
    if args.pid == 0:
        print(json.dumps(dict(
            ok=bool(ok), max_node_p_err=err, cost1_sharded=cost1, cost1_single=float(r2.cost1),
            n_processes=args.nproc, n_global_shards=mesh.shape["lm"], backend=args.backend,
            max_node_p_err_jax=err_jax)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
