#!/usr/bin/env python
"""Write ``tests/fixtures/torch_parallel.npz``: the JAX package's float64
results of its ``parallel/`` package on the CPU, which the PyTorch port's
tests and ``chip_smoke.py`` phase 9 hold the port against.

* ``batch6``: ``optimize_batch`` (8 iterations) of the three 6 x 24
  windows of ``tests/test_sharding.py::test_multi_sequence_batch_matches_sequential``
  (seeds 41, 42, 43), inputs and results.
* ``round``: the optimize input of the 24 x 192 keyframe round of
  ``tools/make_torch_fixture.py`` (JAX's preintegration and triangulation);
  ``optimize_batch`` (20 iterations) of its first ``chip_smoke.BATCH_JAX``
  perturbations ``chip_smoke.perturb_round``; and ``optimize_sharded``
  over an 8-device mesh of perturbation 0, with ``lm.optimize`` of it.
* ``ba32`` / ``ba256``: the node-chunked BA problems of
  ``tests/test_ba_nodes.py`` (N = 32, 8 chunks, band 1; N = 256, 8
  chunks, band 8, landmarks across every cut), the inputs and
  ``ba_nodes_solve`` over 8 chunks and over 1.

    python tools/make_torch_parallel_fixture.py [--out tests/fixtures/torch_parallel.npz]

One process per part, about 5 minutes on the CPU.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

DEFAULT_OUT = os.path.join(ROOT, "tests", "fixtures", "torch_parallel.npz")
SHARDS = 8


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + f" --xla_force_host_platform_device_count={SHARDS}"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _stats(st):
    import numpy as np

    names = ("cost0", "cost1", "n_culled", "iters_run", "accepted")
    return {k: np.asarray(v) for k, v in zip(names, st)}


def _out_window(win):
    import numpy as np

    from ic_gvins_tpu_torch.convert import to_numpy

    return {"nodes": to_numpy(win.nodes), "lm_invdepth": np.asarray(win.lm_invdepth),
            "obs_valid": np.asarray(win.obs_valid), "gnss_std": np.asarray(win.gnss_std)}


def batch6():
    jax = _jax()
    import jax.numpy as jnp
    from helpers import build_gvins_window, default_cfg, perturb_window

    from ic_gvins_tpu.parallel import multi_seq
    from ic_gvins_tpu.solver.window import make_init_prior
    from ic_gvins_tpu_torch.convert import to_numpy

    pose_std = jnp.array([0.1] * 3 + [0.5 * jnp.pi / 180] * 2 + [1.5 * jnp.pi / 180])
    mix_std = jnp.array([0.1] * 3 + [2 * jnp.pi / 180] * 3 + [0.2] * 3)
    wins, prs = [], []
    for seed in (41, 42, 43):
        win, _, params, _, _, _ = build_gvins_window(n_nodes=6, n_landmarks=24, seed=seed)
        wins.append(perturb_window(win, 6, jax.random.PRNGKey(seed), dp=0.1))
        prs.append(make_init_prior(win, pose_std, mix_std))
    cfg = default_cfg()
    out, st = multi_seq.optimize_batch(multi_seq.stack_windows(wins),
                                       multi_seq.stack_priors(prs), cfg, params, iters=8)
    tree = {"in": {f"window{i}": to_numpy(w) for i, w in enumerate(wins)},
            "out": {"window": _out_window(out), "stats": _stats(st)}}
    tree["in"].update({f"prior{i}": to_numpy(p) for i, p in enumerate(prs)})
    tree["in"].update({"cfg": to_numpy(cfg), "params": to_numpy(params)})
    return tree


def round_batch():
    jax = _jax()
    import numpy as np
    from jax.sharding import Mesh

    import chip_smoke
    from __graft_entry__ import _tiny_problem
    from ic_gvins_tpu.parallel import lm_sharded, multi_seq
    from ic_gvins_tpu.solver import lm
    from ic_gvins_tpu_torch.convert import flatten, to_numpy
    from make_torch_fixture import N_LANDMARKS, N_NODES, jax_keyframe_round, raw_imu

    win, prior, cfg, params = _tiny_problem(n_nodes=N_NODES, n_landmarks=N_LANDMARKS)
    imu = raw_imu(N_NODES - 1, params)
    rnd = jax_keyframe_round(win, prior, cfg, params, imu)
    base = rnd["tri_window"]
    base_np = to_numpy(base)
    opt = {"nodes": to_numpy(rnd["opt_window"].nodes),
           "lm_invdepth": np.asarray(rnd["opt_window"].lm_invdepth)}
    leaves, treedef = jax.tree.flatten(base)
    keys = list(flatten(base_np))  # to_numpy keeps the field order of the tree
    assert len(keys) == len(leaves)

    def to_jax_window(d):
        flat = flatten(d)
        return jax.tree.unflatten(treedef, [jax.numpy.asarray(flat[k]) for k in keys])

    wins = [to_jax_window(chip_smoke.perturb_round(base_np, opt, b))
            for b in range(chip_smoke.BATCH_JAX)]
    out, st = multi_seq.optimize_batch(multi_seq.stack_windows(wins),
                                       multi_seq.stack_priors([prior] * len(wins)),
                                       cfg, params, iters=chip_smoke.ITERS)
    mesh = Mesh(np.array(jax.devices()[:SHARDS]), ("lm",))
    w_sh, (s1, s2, nc) = lm_sharded.optimize_sharded(wins[0], prior, cfg, params, mesh,
                                                    iters=chip_smoke.ITERS, do_cull=True)
    w_1, (r1, r2, nr) = lm.optimize(wins[0], prior, cfg, params, iters=chip_smoke.ITERS,
                                    do_cull=True)
    one = lambda w, a, b, n: {"window": _out_window(w), "stats1": to_numpy(a),  # noqa: E731
                              "stats2": to_numpy(b), "n_culled": np.asarray(n)}
    print("round batch: iterations", np.asarray(st[3]), "accepted", np.asarray(st[4]),
          "culled", np.asarray(st[2]), flush=True)
    return {"in": {"window": base_np, "opt": opt, "prior": to_numpy(prior),
                   "cfg": to_numpy(cfg), "params": to_numpy(params)},
            "batch": {"window": _out_window(out), "stats": _stats(st)},
            "sharded": one(w_sh, s1, s2, nc), "single": one(w_1, r1, r2, nr)}


def ba(big: bool):
    jax = _jax()
    import numpy as np
    import test_ba_nodes as T

    from ic_gvins_tpu_torch.convert import to_numpy

    prob = T._build_problem_big() if big else T._build_problem()
    if big:
        out8, st8, drop8 = T._solve_band(prob, SHARDS, jax.devices()[:SHARDS], T.BAND)
        out1, st1, drop1 = T._solve_band(prob, 1, jax.devices()[:1], 1)
    else:
        out8, st8 = T._solve(prob, SHARDS, jax.devices()[:SHARDS])
        out1, st1 = T._solve(prob, 1, jax.devices()[:1])
        drop8 = drop1 = 0
    res = lambda o, s, d: {  # noqa: E731
        "nodes": to_numpy(o.nodes), "lm_invdepth": np.asarray(o.lm_invdepth),
        "lm_valid": np.asarray(o.lm_valid), "dropped": np.int64(d),
        "stats": {k: np.asarray(v) for k, v in zip(("cost0", "cost1", "accepted", "iters_run"), s)}}
    return {"in": {"nodes": to_numpy(prob["nodes"]), "truth_p": np.asarray(prob["truth"].p),
                   "preint": to_numpy(prob["preint"]), "gnss_p": prob["gnss_p"],
                   "gnss_std": prob["gnss_std"], "gnss_valid": prob["gnss_valid"],
                   "lm_invd": prob["lm_invd"], "lm_ref": np.asarray(prob["lm_ref"]),
                   "obs_uv": prob["obs_uv"], "obs_valid": prob["obs_valid"],
                   "params": to_numpy(prob["params"]),
                   "sep_width": np.int64(T.BAND if big else 1),
                   "stencil": np.int64(T.BAND + 2 if big else T.C),
                   "iters": np.int64(6 if big else 10)},
            "chunks8": res(out8, st8, drop8), "chunks1": res(out1, st1, drop1)}


PARTS = ("batch6", "round", "ba32", "ba256")


def run_part(name, out):
    import numpy as np

    from ic_gvins_tpu_torch.convert import flatten

    make = {"batch6": batch6, "round": round_batch, "ba32": lambda: ba(False),
            "ba256": lambda: ba(True)}[name]
    np.savez(out, **flatten({name: make()}))
    print(f"{name}: done", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--part", choices=PARTS, help="compute one part into --out (internal)")
    ap.add_argument("--only", nargs="+", choices=PARTS,
                    help="recompute these parts; the file keeps the others")
    args = ap.parse_args()
    if args.part:
        run_part(args.part, args.out)
        return
    import subprocess
    import tempfile

    import numpy as np

    # one process per part: XLA:CPU runs out of code memory after many
    # compiles in one process
    work = tempfile.mkdtemp(prefix="parallel_fixture_")
    parts = args.only or PARTS
    procs = {n: subprocess.Popen([sys.executable, __file__, "--part", n, "--out",
                                  os.path.join(work, n + ".npz")]) for n in parts}
    bad = [n for n, p in procs.items() if p.wait() != 0]
    if bad:
        raise SystemExit(f"parts failed: {bad}")
    merged = {}
    if args.only and os.path.exists(args.out):
        with np.load(args.out) as z:
            merged = {k: z[k] for k in z.files if k.split("/")[0] not in parts}
    for n in parts:
        with np.load(os.path.join(work, n + ".npz")) as z:
            merged.update({k: z[k] for k in z.files})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **merged)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
