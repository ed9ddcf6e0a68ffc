#!/usr/bin/env python
"""Write the keyframe-round fixture that ``chip_smoke.py`` holds the
PyTorch port against: the JAX package's float64 results on the CPU.

The window is ``__graft_entry__._tiny_problem(n_nodes=24, n_landmarks=192)``
(the engine's 24-node x 192-landmark window), with the raw IMU of every
interval rebuilt as ``_tiny_problem`` simulates it. The round is
preintegrate (23 intervals) -> triangulate (anchor node vs newest
observing node) -> ``optimize_impl(iters=20)`` -> ``marginalize_and_slide``.

    python tools/make_torch_fixture.py [--out tests/fixtures/torch_slice_24x192.npz]

``--tiny`` writes the same for ``_tiny_problem()``'s 6-node x 16-landmark
window into ``tests/fixtures/torch_tiny.npz``, with the JAX results of
``tests/test_torch_solver.py``'s ``preint_case`` (two simulated intervals
preintegrated from its perturbed window), ``optimized``
(``optimize_impl`` of that window, 20 iterations) and ``phases``
(``optimize_phase1`` then ``optimize_phase2`` of it, 20 iterations each). The port's CPU tests
load them instead of rebuilding them in every test process (~2 minutes
of XLA compiles each).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

DEFAULT_OUT = os.path.join(ROOT, "tests", "fixtures", "torch_slice_24x192.npz")
TINY_OUT = os.path.join(ROOT, "tests", "fixtures", "torch_tiny.npz")
N_NODES, N_LANDMARKS, ITERS = 24, 192, 20
# _tiny_problem's node times: t0 + i * node_dt, IMU at 200 Hz
T0, NODE_DT, IMU_RATE = 5.0, 0.4, 200.0


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def raw_imu(n_intervals, params):
    """[n_intervals, n] stacked IMU of the window's intervals."""
    jax = _jax()
    import jax.numpy as jnp

    from ic_gvins_tpu.data import simulator as sim

    traj = sim.car_trajectory()
    imus = [sim.simulate_imu(traj, params, T0 + i * NODE_DT, NODE_DT, IMU_RATE)
            for i in range(n_intervals)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *imus)


def jax_keyframe_round(win, prior, cfg, params, imu, iters=ITERS):
    """The round in the JAX package; returns a dict of its stage outputs."""
    jax = _jax()
    import jax.numpy as jnp

    from ic_gvins_tpu.common import rotation as rot
    from ic_gvins_tpu.factors.marginalization import marginalize_and_slide
    from ic_gvins_tpu.ins.preintegration import preintegrate
    from ic_gvins_tpu.solver.lm import optimize_impl
    from ic_gvins_tpu.vision.triangulation import triangulate_checked

    N, L = win.n_nodes, win.n_landmarks
    state0 = jax.tree.map(lambda x: x[: N - 1], win.nodes)
    pre = jax.jit(jax.vmap(preintegrate, in_axes=(None, 0, 0)))(params, state0, imu)
    win = win._replace(preint=pre)

    ref = win.lm_ref
    last = jnp.clip(jnp.max(jnp.where(win.obs_valid, jnp.arange(N), -1), 1), 0)

    def cam_pose(k):
        q = win.nodes.q[k]
        return (rot.quat_to_matrix(rot.quat_mul(q, win.ext_q)),
                win.nodes.p[k] + rot.quat_rotate(q, win.ext_p))

    r0, t0 = cam_pose(ref)
    r1, t1 = cam_pose(last)
    lidx = jnp.arange(L)
    _, invd, ok = triangulate_checked(r0, t0, r1, t1, win.obs_uv[lidx, ref],
                                      win.obs_uv[lidx, last])
    ok = ok & win.lm_valid & (last != ref)
    win = win._replace(lm_invdepth=jnp.where(ok, invd, win.lm_invdepth))
    tri_win = win

    opt = jax.jit(lambda w, p, c, pa: optimize_impl(w, p, c, pa, iters=iters))
    win_opt, (s1, s2, n_culled) = opt(win, prior, cfg, params)
    marg = jax.jit(marginalize_and_slide)
    win_slid, prior_new = marg(win_opt, prior, cfg, params)
    return {
        "preint": pre, "tri_invdepth": invd, "tri_ok": ok, "tri_window": tri_win,
        "opt_window": win_opt, "stats1": s1, "stats2": s2, "n_culled": n_culled,
        "slid_window": win_slid, "prior": prior_new,
    }


def round_tree(win, prior, cfg, params, imu):
    """The round's inputs ("in") and the JAX results of its stages ("out"),
    as nested dicts of numpy arrays."""
    import numpy as np

    from ic_gvins_tpu_torch.convert import to_numpy

    out = jax_keyframe_round(win, prior, cfg, params, imu)
    pre = out["preint"]
    tree = {
        "in": {"window": to_numpy(win), "prior": to_numpy(prior),
               "cfg": to_numpy(cfg), "params": to_numpy(params),
               "imu": to_numpy(imu)},
        "out": {
            "preint": {k: np.asarray(getattr(pre, k)) for k in
                       ("dp", "dv", "dq", "jac", "cov", "dt", "sum_dt_pn")},
            "tri": {"invdepth": np.asarray(out["tri_invdepth"]),
                    "ok": np.asarray(out["tri_ok"])},
            "opt": {"nodes": to_numpy(out["opt_window"].nodes),
                    "lm_invdepth": np.asarray(out["opt_window"].lm_invdepth),
                    "gnss_std": np.asarray(out["opt_window"].gnss_std),
                    "obs_valid": np.asarray(out["opt_window"].obs_valid),
                    "stats1": to_numpy(out["stats1"]),
                    "stats2": to_numpy(out["stats2"]),
                    "n_culled": np.asarray(out["n_culled"])},
            "marg": {"H": np.asarray(out["prior"].H),
                     "g": np.asarray(out["prior"].g),
                     "nodes": to_numpy(out["slid_window"].nodes),
                     "lm_valid": np.asarray(out["slid_window"].lm_valid),
                     "lm_ref": np.asarray(out["slid_window"].lm_ref)},
        },
    }
    return tree


def solver_cases(win, prior, cfg, params):
    """The JAX results ``tests/test_torch_solver.py`` holds the port against
    on its perturbed tiny window: ``preint_case`` and ``optimized``."""
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    from ic_gvins_tpu.data import simulator as sim
    from ic_gvins_tpu.ins import preintegration as jpre
    from ic_gvins_tpu.solver import lm as jlm
    from ic_gvins_tpu_torch.convert import to_numpy
    from test_torch_solver import perturbed

    win = perturbed(win)
    traj = sim.car_trajectory()
    imus = [sim.simulate_imu(traj, params, 5.0 + 0.4 * i, 0.4, 200.0) for i in range(2)]
    imu = jax.tree.map(lambda *xs: jnp.stack(xs), *imus)
    state0 = jax.tree.map(lambda x: x[:2], win.nodes)
    state0 = state0._replace(ba=state0.ba + 1e-3)
    want = jax.jit(jax.vmap(jpre.preintegrate, in_axes=(None, 0, 0)))(params, state0, imu)
    jw, (j1, j2, jn) = jax.jit(lambda *a: jlm.optimize_impl(*a, iters=20))(win, prior, cfg, params)
    pw1, p1, pn = jlm.optimize_phase1(win, prior, cfg, params, iters=20)
    pw2, p2 = jlm.optimize_phase2(pw1, prior, cfg, params, iters=20)
    return {"preint_case": {"imu": to_numpy(imu), "want": to_numpy(want)},
            "optimized": {"window": to_numpy(jw), "stats1": to_numpy(j1),
                          "stats2": to_numpy(j2), "n_culled": np.asarray(jn)},
            "phases": {"window1": to_numpy(pw1), "stats1": to_numpy(p1),
                       "n_culled": np.asarray(pn), "window2": to_numpy(pw2),
                       "stats2": to_numpy(p2)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="the round of _tiny_problem()'s 6 x 16 window instead, into "
                         "tests/fixtures/torch_tiny.npz")
    args = ap.parse_args()
    _jax()
    import numpy as np

    from __graft_entry__ import _tiny_problem
    from ic_gvins_tpu_torch.convert import flatten

    out_path = args.out or (TINY_OUT if args.tiny else DEFAULT_OUT)
    if args.tiny:
        win, prior, cfg, params = _tiny_problem()
    else:
        win, prior, cfg, params = _tiny_problem(n_nodes=N_NODES, n_landmarks=N_LANDMARKS)
    imu = raw_imu(win.n_nodes - 1, params)
    tree = round_tree(win, prior, cfg, params, imu)
    if args.tiny:
        tree.update(solver_cases(win, prior, cfg, params))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **flatten(tree))
    s1, s2 = tree["out"]["opt"]["stats1"], tree["out"]["opt"]["stats2"]
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes); "
          f"phase1 iters {int(s1['iters_run'])} accepted {int(s1['accepted'])}, "
          f"phase2 iters {int(s2['iters_run'])} accepted {int(s2['accepted'])}, "
          f"cost {float(s1['cost0']):.6g} -> {float(s2['cost1']):.6g}, "
          f"triangulated {int(np.sum(tree['out']['tri']['ok']))}")


if __name__ == "__main__":
    main()
