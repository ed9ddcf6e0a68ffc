"""PyTorch port: the float32 engine mode against the JAX package's float32
mode (x64 off), whose results ``tools/make_torch_f32_fixture.py`` stores
in ``tests/fixtures/torch_f32.npz``: the Newton-Schulz reduced solve, the
float32 marginalization, a float32 preintegration, an ``Estimator`` run
and a checkpoint across the packages; and window re-centering against the
JAX float64 engine on one state.

Tolerances, with what was measured on the CPU when they were set:

* the reduced solve: the Jacobi-scaled reduced system of the 24 x 192
  round has condition number 2.7e4, so two float32 solves that sum in
  another order part by about that times float32's epsilon: 1e-3 relative
  against JAX (4.0e-4), and both within 1.5e-2 of the float64 solution
  (7.7e-3, JAX 8.1e-3). The SPD matrix (diagonal 1e2-1e10, condition 4
  after scaling): 1e-4 against JAX (2.2e-7), 1e-5 from float64 (1.6e-6);
* the prior of the marginalization: 0.4% relative Frobenius against JAX
  float32 (1.4e-5; the chip-vs-CPU bound of the JAX package's float32
  records), g exactly zero, its smallest eigenvalue at least -1e-6 of the
  largest (-4.2e-9);
* preintegration: the port's log-depth scans add in another order than
  JAX's sample-by-sample scan, 1e-5 relative (8e-7); the interval length
  (node times) bit for bit;
* the ``Estimator``: the same events, node times, keyframes and
  ``n_recenters``, the trajectory within 1e-2 m of JAX float32 (4.7e-3 m),
  the ATE within 0.02 m of JAX float32's; the LM's accepted-step counts may
  part (float32 cost comparisons), and the first round where they do is
  printed. Resumed from JAX's float32 checkpoint: the same decisions, the
  trajectory within 2e-2 m (1.17e-2 m: a transient two rounds after the
  resume, 1-3 mm at the end);
* re-centering (float64): the robust cost within 1e-12 relative, the
  next round within 1e-9 m, the shifted fields JAX's to 1e-12 m.
"""

import io
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from ic_gvins_tpu_torch.convert import cast, to_numpy, to_torch, unflatten
from ic_gvins_tpu_torch.data.types import ImuSeq, IntegrationParams, NavState
from ic_gvins_tpu_torch.engine import config as tconfig
from ic_gvins_tpu_torch.engine.estimator import Estimator
from ic_gvins_tpu_torch.factors import marginalization as tmarg
from ic_gvins_tpu_torch.ins.preintegration import preintegrate
from ic_gvins_tpu_torch.parallel import Mesh, multi_seq
from ic_gvins_tpu_torch.parallel.lm_sharded import optimize_sharded
from ic_gvins_tpu_torch.solver import assembly as tasm
from ic_gvins_tpu_torch.solver import lm as tlm
from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig, Window
from test_torch_solver import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = os.path.join(ROOT, "tests", "fixtures", "torch_f32.npz")
SMALL = os.path.join(ROOT, "tests", "fixtures", "torch_estimator_small.npz")

# the solve's and the prior's bounds are the card's, chip_smoke.py phase 10's
SOLVE_VS_JAX, SOLVE_VS_F64 = chip_smoke.F32_SOLVE_VS_JAX, chip_smoke.F32_SOLVE_VS_F64
PRIOR_FRO, PRIOR_EIG_FLOOR = chip_smoke.F32_PRIOR_FRO, chip_smoke.F32_PRIOR_EIG_FLOOR
PREINT_RTOL = 1e-5
TRAJ_VS_JAX32 = 1e-2  # m
RESUME_VS_JAX32 = 2e-2  # m
ATE_MARGIN = 0.02  # m
F32_TIME_ATOL = chip_smoke.F32_TIME_ATOL
RECENTER_COST_RTOL = 1e-12
RECENTER_STEP_ATOL = 1e-9  # m
RECENTER_FIELD_ATOL = 1e-12  # m


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(F32))


def rel(got, want):
    return chip_smoke.rel_err(want, got)


@pytest.mark.parametrize("case", ["round", "spd"])
def test_solve_reduced_f32_matches_jax(fx, case):
    """The float32 branch (Jacobi scaling, 26 Newton-Schulz iterations, 3
    refinements) on a float64 system cast to float32, against JAX's
    float32 solve and the float64 solution."""
    H, g, y64 = (fx[f"solve64/{case}_{k}"] for k in ("H", "g", "y"))
    y_jax = fx[f"solve32/{case}_y"]
    y = tasm.solve_reduced(torch.from_numpy(H.astype(np.float32)),
                           torch.from_numpy(g.astype(np.float32)))
    assert y.dtype == torch.float32
    e_jax, e64, e64_jax = rel(y, y_jax), rel(y, y64), rel(y_jax, y64)
    assert e_jax <= SOLVE_VS_JAX[case], e_jax
    assert max(e64, e64_jax) <= SOLVE_VS_F64[case], (e64, e64_jax)


def test_solve_reduced_refuses_other_dtypes(fx):
    """No silent widening: a half-precision system raises."""
    H, g = fx["solve64/spd_H"], fx["solve64/spd_g"]
    with pytest.raises(TypeError):
        tasm.solve_reduced(torch.from_numpy(H).half(), torch.from_numpy(g).half())


def _round32(fx):
    r = unflatten(fx, "round32/")
    return (r, to_torch(Window, r["window"], "cpu"), to_torch(Prior, r["prior"], "cpu"),
            to_torch(SolverConfig, r["cfg"], "cpu"), to_torch(IntegrationParams, r["params"], "cpu"))


def test_marginalize_node0_f32_matches_jax(fx):
    """``marginalize_node0`` on the round's optimum in float32: the prior's
    H against JAX float32, g zero (the estimate-anchored prior), H PSD to
    its gate."""
    r, win, prior, cfg, params = _round32(fx)
    assert win.nodes.p.dtype == torch.float32  # convert keeps JAX's float32
    out = tmarg.marginalize_node0(win, prior, cfg, params)
    assert out.H.dtype == out.g.dtype == torch.float32
    H = out.H.numpy().astype(np.float64)
    fro = np.linalg.norm(H - r["marg_H"]) / np.linalg.norm(r["marg_H"])
    assert fro <= PRIOR_FRO, fro
    assert not out.g.any()
    w = np.linalg.eigvalsh(H)
    assert w[0] >= PRIOR_EIG_FLOOR * w[-1], (w[0], w[-1])


def test_schur_eliminate_scaled_f32_matches_jax(fx):
    """``_schur_eliminate_scaled`` (relative gate, exact PSD projection) on
    JAX's landmark-eliminated float32 system."""
    r = unflatten(fx, "round32/")
    Hp, gp = tmarg._schur_eliminate_scaled(torch.from_numpy(r["H1"]), torch.from_numpy(r["g1"]),
                                           15)
    fro = np.linalg.norm(Hp.numpy() - r["Hp"]) / np.linalg.norm(r["Hp"])
    assert Hp.dtype == torch.float32 and fro <= PRIOR_FRO, fro
    assert torch.isfinite(gp).all() and gp.dtype == torch.float32


@pytest.fixture(scope="module")
def preint32(fx):
    """The round's first interval preintegrated in float32, and JAX's."""
    r, win, _, _, params = _round32(fx)
    imu = to_torch(ImuSeq, r["imu0"], "cpu")
    return preintegrate(params, NavState(*(x[0] for x in win.nodes)), imu), r["preint"]


@pytest.mark.parametrize("field", ["dp", "dv", "dq", "jac", "cov", "sum_dt_pn", "end_p"])
def test_preintegrate_f32_matches_jax(preint32, field):
    """Against JAX's float32 scan, in float32."""
    pre, ref = preint32
    got, want = ((pre.end_state.p, ref["end_state"]["p"]) if field == "end_p"
                 else (getattr(pre, field), ref[field]))
    assert got.dtype == torch.float32, field
    assert rel(got, want) <= PREINT_RTOL, (field, rel(got, want))


def test_preintegrate_f32_node_time_is_jax(preint32):
    """The interval length and the end time (the node time) bit for bit."""
    pre, ref = preint32
    assert pre.dt.numpy() == ref["dt"] and pre.end_state.time.numpy() == ref["end_state"]["time"]


@pytest.fixture(scope="module")
def round32(fx):
    """The round's optimum in float32 and one 4-iteration ``optimize`` of it."""
    _, win, prior, cfg, params = _round32(fx)
    return (win, prior, cfg, params), tlm.optimize(win, prior, cfg, params, iters=4)


@pytest.mark.parametrize("path", ["optimize", "slide", "batch", "sharded", "cast"])
def test_f32_round_and_batch_stay_f32(round32, path):
    """An optimization round, a slide, ``optimize_batch`` and the
    landmark-sharded round on a float32 window keep float32 throughout
    (nothing built on the side promotes it; the batch and the sharded round
    land where the single round does), and ``cast`` changes only the
    floating leaves."""
    (win, prior, cfg, params), (w_opt, (s1, s2, nc)) = round32
    if path == "optimize":
        assert all(x.dtype == torch.float32 for x in _floats(w_opt))
        assert s2.cost1.dtype == torch.float32 and torch.isfinite(s2.cost1)
    elif path == "slide":
        w_sl, pr = tmarg.marginalize_and_slide(w_opt, prior, cfg, params)
        assert all(x.dtype == torch.float32 for t in (w_sl, pr) for x in _floats(t))
        assert w_sl.lm_ref.dtype == win.lm_ref.dtype and w_sl.node_valid.dtype == torch.bool
    elif path == "batch":
        out, _ = multi_seq.optimize_batch(multi_seq.stack_windows([win, win]),
                                          multi_seq.stack_priors([prior, prior]), cfg, params,
                                          iters=4)
        assert out.nodes.p.dtype == torch.float32
        np.testing.assert_allclose(out.nodes.p[0].numpy(), w_opt.nodes.p.numpy(), atol=1e-4)
    elif path == "sharded":
        w_sh, _ = optimize_sharded(win, prior, cfg, params, Mesh({"lm": 8}, device="cpu"),
                                   iters=4)
        assert w_sh.nodes.p.dtype == torch.float32
        np.testing.assert_allclose(w_sh.nodes.p.numpy(), w_opt.nodes.p.numpy(), atol=1e-4)
    else:
        w64 = cast(win, torch.float64)
        assert w64.nodes.p.dtype == torch.float64 and w64.lm_ref.dtype == win.lm_ref.dtype
        assert torch.equal(w64.obs_valid, win.obs_valid)


def _floats(tree):
    if isinstance(tree, tuple):
        return [x for v in tree for x in _floats(v)]
    return [tree] if torch.is_tensor(tree) and tree.is_floating_point() else []


# --- re-centering ---------------------------------------------------------------


def test_recenter_matches_jax_and_is_exact(fx, tmp_path):
    """The JAX float64 checkpoint of the small ``gvins`` run at its middle
    event, loaded with the run's GNSS queue and re-centered at a 1 m
    threshold: every shifted field JAX's, the robust cost unchanged, and
    the next round's result the same positions moved by the shift."""
    s = chip_smoke.scenario(dict(np.load(SMALL)), "gvins")
    path = tmp_path / "ckpt.pkl"
    path.write_bytes(fx["recenter/ckpt"].tobytes())
    est = Estimator(chip_smoke.engine_config(tconfig, s), device="cpu")
    assert est.recenter_threshold == 0.0  # float64: off unless configured
    est.load_checkpoint(str(path))
    est.gnss_queue = [(float(t), p, sd) for t, p, sd in zip(
        fx["recenter/queue_t"], fx["recenter/queue_p"], fx["recenter/queue_std"])]
    est.recenter_threshold = 1.0
    flags = tasm.RobustFlags(gnss_kernel=True, reproj_kernel=True)
    cost = lambda: float(tasm.robust_cost(est.window, est.prior, est.solver_cfg,  # noqa: E731
                                          est.params, flags))
    win0, prior0, c0 = est.window, est.prior, cost()
    est._maybe_recenter()
    assert est.n_recenters == int(fx["recenter/shifted/n_recenters"]) == 1
    shift = est.origin.copy()
    np.testing.assert_array_equal(shift, fx["recenter/shifted/origin"])
    assert abs(cost() - c0) <= RECENTER_COST_RTOL * c0
    w, pr = est.window, est.prior
    for name, got in (("nodes_p", w.nodes.p), ("gnss_p", w.gnss_p),
                      ("sum_dt_pn", w.preint.sum_dt_pn), ("end_state_p", w.preint.end_state.p),
                      ("lin_nodes_p", pr.lin_nodes.p), ("last_node_p", est.last_node_state.p),
                      ("cur_p", est.cur_state.p),
                      ("queue_p", np.array([q[1] for q in est.gnss_queue]))):
        np.testing.assert_allclose(to_numpy(got), fx[f"recenter/shifted/{name}"], rtol=0,
                                   atol=RECENTER_FIELD_ATOL, err_msg=name)
    it = est.cfg.optimize_num_iterations
    a, _ = tlm.optimize(win0, prior0, est.solver_cfg, est.params, iters=it)
    b, _ = tlm.optimize(w, pr, est.solver_cfg, est.params, iters=it)
    n = est.n_nodes
    dp = (b.nodes.p[:n] + torch.from_numpy(shift) - a.nodes.p[:n]).abs().max()
    assert float(dp) <= RECENTER_STEP_ATOL, float(dp)
    for k in ("q", "v", "bg", "ba"):
        assert rel(getattr(b.nodes, k)[:n], getattr(a.nodes, k)[:n]) <= RECENTER_STEP_ATOL, k


# --- the float32 Estimator ------------------------------------------------------


@pytest.fixture(scope="module")
def run32():
    s = chip_smoke.scenario(dict(np.load(SMALL)), "gvins")
    est, got = chip_smoke.run_estimator(s, "cpu", dtype=torch.float32)
    return s, est, got


def _jax32(fx, part):
    return {k[len(part) + 1:]: v for k, v in fx.items() if k.startswith(part + "/")}


def compare_f32(got, ref, est, what, atol=TRAJ_VS_JAX32):
    """Events, node times and keyframes equal to JAX float32's; the
    trajectory within ``atol``; returns (distance m, the first round
    whose LM counts part or None)."""
    part = chip_smoke.first_parting(got, ref)
    assert part is None, f"{what}: the events part from JAX float32 at event {part}"
    assert np.array_equal(got["log_node_kf"], ref["log_node_kf"]), what
    assert est.window.nodes.p.dtype == torch.float32, what
    dist = float(np.max(np.linalg.norm(got["traj_p"] - ref["traj_p"], axis=1)))
    assert dist <= atol, (what, dist)
    cols = [chip_smoke.STATS_KEYS.index(k) for k in ("iterations", "iters_run", "culled")]
    apart = [i for i in range(len(ref["stats"]))
             if not np.array_equal(got["stats"][i, cols], ref["stats"][i, cols])]
    return dist, (apart[0] if apart else None)


def test_estimator_f32_matches_jax_f32(fx, run32):
    """``Estimator(cfg, dtype=torch.float32)`` on the small ``gvins``
    streams (16 x 64 window, 10 s) against the JAX float32 run: its
    decisions, re-centerings (two), trajectory and ATE."""
    s, est, got = run32
    ref = _jax32(fx, "est32")
    assert est.recenter_threshold == 20.0
    assert est.n_recenters == int(ref["n_recenters"]) >= 1
    np.testing.assert_allclose(est.origin, ref["origin"], atol=TRAJ_VS_JAX32)
    dist, lm_part = compare_f32(got, ref, est, "gvins float32")
    e = chip_smoke.trajectory_errors(got["traj_t"], got["traj_p"], s, 5.0, atol_t=F32_TIME_ATOL)
    ate = float(np.sqrt(np.mean(e ** 2)))
    assert ate <= float(ref["ate_rmse"]) + ATE_MARGIN, (ate, float(ref["ate_rmse"]))
    print(f"float32 gvins: trajectory {dist:.3g} m from JAX float32, ATE {ate:.4f} m (JAX "
          f"float32 {float(ref['ate_rmse']):.4f}); LM counts part from round {lm_part}")


def test_jax_f32_checkpoint_resumes_in_port(fx, tmp_path):
    """The checkpoint the JAX float32 run saved after its middle event
    (float32 leaves, ``origin`` and ``n_recenters``) resumes in a float32
    port estimator, which continues as the JAX run did."""
    s = chip_smoke.scenario(dict(np.load(SMALL)), "gvins")
    ref = _jax32(fx, "est32")
    raw = fx["est32/ckpt"].tobytes()
    state = pickle.load(io.BytesIO(raw))
    assert state["window"][1].dtype == np.float32  # nodes.p, as JAX saved it
    path = tmp_path / "ckpt.pkl"
    path.write_bytes(raw)
    ck = int(fx["est32/ckpt_event"])
    est, got = chip_smoke.resume_estimator(s, str(path), "cpu", ck + 1, dtype=torch.float32)
    assert est.window.nodes.p.dtype == torch.float32
    cont = chip_smoke.continuation_ref(ref, ck, len(got["stats"]))
    compare_f32(got, cont, est, "resumed float32", RESUME_VS_JAX32)
    assert est.n_recenters == int(ref["n_recenters"])
    np.testing.assert_allclose(est.origin, ref["origin"], atol=TRAJ_VS_JAX32)
    # a float64 estimator takes the same checkpoint in float64
    e64 = Estimator(chip_smoke.engine_config(tconfig, s), device="cpu")
    e64.load_checkpoint(str(path))
    assert e64.window.nodes.p.dtype == e64.prior.H.dtype == torch.float64
    assert e64.n_recenters == state["n_recenters"] and np.array_equal(e64.origin, state["origin"])
