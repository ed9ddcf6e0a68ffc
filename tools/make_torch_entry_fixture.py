#!/usr/bin/env python
"""Write the fixture that holds the PyTorch port's entry points
(``ic_gvins_tpu_torch/entry.py``) against the JAX package's
(``__graft_entry__.py``): the JAX results on the CPU, x64 on.

    python tools/make_torch_entry_fixture.py [--out tests/fixtures/torch_entry.npz]

For ``_tiny_problem()`` (6 nodes x 16 landmarks) it stores the jitted
``forward``'s result, and on that window moved off the truth as
``tests/test_torch_solver.py``'s ``perturbed`` moves it (at the truth the
gradient is rounding noise of residuals near zero) the dense normal
equations of the step (``assemble``: H, g, cost), the free mask and
``schur_solve``'s step; for ``_tiny_problem(24, 192)`` the forward's
result. Both forwards also run on the problems cast to float32 (every
floating leaf), and the window of ``_tiny_problem(dtype=float32)`` is
stored as the JAX package builds it. The preintegration helpers
(``preint_res_fn`` at interval 2 and a seeded delta, ``preint_sqrt_info``,
``preint_delta_cols``) run on the moved window and on it with odometer
intervals (``tests/test_torch_odo.py``'s wheel model on the stored raw
IMU). A forward's result is the updated
nodes, extrinsic and inverse depths and the cost. About 3 minutes on the
CPU (XLA compiles).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_entry.npz")


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def forward_result(window, cost) -> dict:
    """What the tests compare of a forward's output, as numpy."""
    import numpy as np

    from ic_gvins_tpu_torch.convert import to_numpy

    return {"nodes": to_numpy(window.nodes), "ext_p": np.asarray(window.ext_p),
            "ext_q": np.asarray(window.ext_q), "lm_invdepth": np.asarray(window.lm_invdepth),
            "cost": np.asarray(cost)}


def preint_case(window, params, seed=5) -> dict:
    """The JAX preintegration helpers on ``window``: interval 2's residual
    at a delta drawn from a numpy seed, the whitening and the columns."""
    import jax.numpy as jnp
    import numpy as np

    from ic_gvins_tpu.solver import assembly as jasm

    fn, dim = jasm.preint_res_fn(window)
    delta = 1e-3 * np.random.default_rng(seed).standard_normal(dim)
    return {"res": np.asarray(fn(window, params, 2, jnp.asarray(delta))),
            "sqrt_info": np.asarray(jasm.preint_sqrt_info(window)),
            "cols": np.asarray(jasm.preint_delta_cols(window))}


def odo_window(window, params, imu_tree):
    """``window`` with every interval preintegrated with wheel increments
    (``tests/test_torch_odo.py``'s ``_odo_params`` / ``_odovel``), the scale
    0.024 against 0.02 at integration."""
    jax = _jax()
    import jax.numpy as jnp

    from ic_gvins_tpu.data.types import ImuSeq
    from ic_gvins_tpu.ins import preintegration_odo as jpo
    from ic_gvins_tpu.solver import window as jwin
    from test_torch_odo import _odo_params, _odovel

    imu = ImuSeq(**{k: jnp.asarray(v) for k, v in imu_tree.items()})
    odo = jpo.OdoParams(**{k: jnp.asarray(v) for k, v in _odo_params().items()})
    state0 = jax.tree.map(lambda x: x[:-1], window.nodes)
    stack = jax.jit(jax.vmap(jpo.preintegrate_odo, in_axes=(None, None, 0, None, 0, 0)))(
        params, odo, state0, jnp.asarray(0.02), imu, jnp.asarray(_odovel(imu, 0)))
    owin = jwin.empty_window(window.n_nodes, window.n_landmarks, odo=True)
    return owin._replace(**{k: getattr(window, k) for k in window._fields
                            if k not in ("preint", "sodo")},
                         preint=stack, sodo=jnp.asarray(0.024))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _tiny_problem, entry
    from ic_gvins_tpu.solver import assembly as jasm
    from ic_gvins_tpu_torch.convert import flatten, to_numpy
    from test_torch_solver import perturbed

    fn, (win, prior, cfg, params) = entry()
    fwd = jax.jit(fn)
    to32 = lambda tree: jax.tree.map(  # noqa: E731
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)
    flags = jasm.RobustFlags(gnss_kernel=np.True_, reproj_kernel=np.True_)
    moved = perturbed(win)
    H, g, cost = jax.jit(lambda *a: jasm.assemble(*a, flags))(moved, prior, cfg, params)
    dx = jax.jit(jasm.schur_solve, static_argnums=2)(H, g, win.dim_x, 1e-4)
    tiny = (win, prior, cfg, params)
    slice_ = _tiny_problem(n_nodes=24, n_landmarks=192)
    imu = dict(np.load(os.path.join(ROOT, "tests", "fixtures", "torch_tiny.npz")))
    imu = {k[len("in/imu/"):]: v for k, v in imu.items() if k.startswith("in/imu/")}
    tree = {
        "preint": {"plain": preint_case(moved, params),
                   "odo": preint_case(odo_window(moved, params, imu), params)},
        "tiny": {"H": np.asarray(H), "g": np.asarray(g), "cost": np.asarray(cost),
                 "dx": np.asarray(dx), "free_mask": np.asarray(jasm.free_mask(win, cfg)),
                 "forward": forward_result(*fwd(*tiny)),
                 "forward32": forward_result(*fwd(*to32(tiny)))},
        "slice": {"forward": forward_result(*fwd(*slice_)),
                  "forward32": forward_result(*fwd(*to32(slice_)))},
        "tiny32": {"window": to_numpy(_tiny_problem(dtype=jnp.float32)[0])},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **flatten(tree))
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes); cost "
          f"{float(cost):.9g}, forward cost on 24 x 192 "
          f"{float(tree['slice']['forward']['cost']):.9g}")


if __name__ == "__main__":
    main()
