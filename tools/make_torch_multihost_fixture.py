#!/usr/bin/env python
"""Write ``tests/fixtures/torch_multihost.npz``: the problem of the JAX
package's multi-process runner (``tools/multihost_lm.py``:
``_tiny_problem(n_nodes=6, n_landmarks=32, seed=7)``) and the JAX float64
results on it, which the port's runner
(``python -m ic_gvins_tpu_torch.tools.multihost_lm``) and
``tests/test_torch_distributed.py`` hold the port against:

* ``in``: the window, prior, configuration and parameters;
* ``single``: ``lm.optimize(iters=8)``;
* ``sharded``: ``lm_sharded.optimize_sharded(iters=8)`` over an 8-device
  virtual CPU mesh (the 8 global shards of 2 processes x 4 devices).

    python tools/make_torch_multihost_fixture.py [--out tests/fixtures/torch_multihost.npz]

About a minute on the CPU.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "tests", "fixtures", "torch_multihost.npz")
SHARDS = 8
N_NODES, N_LANDMARKS, SEED, ITERS = 6, 32, 7, 8


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + f" --xla_force_host_platform_device_count={SHARDS}"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from jax.sharding import Mesh

    from __graft_entry__ import _tiny_problem
    from ic_gvins_tpu.parallel import lm_sharded
    from ic_gvins_tpu.solver import lm
    from ic_gvins_tpu_torch.convert import flatten, to_numpy

    win, prior, cfg, params = _tiny_problem(n_nodes=N_NODES, n_landmarks=N_LANDMARKS, seed=SEED)
    mesh = Mesh(np.array(jax.devices()[:SHARDS]), ("lm",))
    w_sh, (s1, s2, nc) = lm_sharded.optimize_sharded(win, prior, cfg, params, mesh, iters=ITERS)
    w_1, (r1, r2, nr) = lm.optimize(win, prior, cfg, params, iters=ITERS)

    def result(w, a, b, n):
        return {"window": to_numpy(w), "stats1": to_numpy(a), "stats2": to_numpy(b),
                "n_culled": np.asarray(n)}

    tree = {"in": {"window": to_numpy(win), "prior": to_numpy(prior), "cfg": to_numpy(cfg),
                   "params": to_numpy(params), "iters": np.int64(ITERS),
                   "shards": np.int64(SHARDS)},
            "single": result(w_1, r1, r2, nr), "sharded": result(w_sh, s1, s2, nc)}
    np.savez_compressed(args.out, **flatten(tree))
    err = float(np.abs(np.asarray(w_sh.nodes.p) - np.asarray(w_1.nodes.p)).max())
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes); sharded vs single "
          f"positions {err:.3g} m, culls {int(nc)} / {int(nr)}, accepted "
          f"{int(s1.accepted)}+{int(s2.accepted)}", flush=True)


if __name__ == "__main__":
    main()
