"""PyTorch port, the odometer (ODO / EARTH_ODO) variant against the JAX
package: ``preintegrate_odo``, the 19-state residual and its closed-form
19 x 31 Jacobian, and the odometer window's assembly, cost and
marginalization, on the stored keyframe-round window
(``tests/fixtures/torch_slice_24x192.npz``) with every interval
re-preintegrated with odometer increments; the port's odometer
``Estimator`` against its stored JAX run, and checkpoints.

Tolerances are test_torch_solver's: relative 1e-9 of each array's largest
entry for closed forms (the sides differ in summation order only), 1e-7
where the marginalization's eigen-decomposition enters."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_solver import CLOSED, ITERATIVE, _same_tree, assert_rel, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from ic_gvins_tpu.data.types import ImuSeq as JImu
from ic_gvins_tpu.data.types import IntegrationParams as JParams
from ic_gvins_tpu.data.types import NavState as JNav
from ic_gvins_tpu.factors import marginalization as jmarg
from ic_gvins_tpu.ins import preintegration as jpre
from ic_gvins_tpu.ins import preintegration_odo as jpo
from ic_gvins_tpu.solver import assembly as jasm
from ic_gvins_tpu.solver import window as jwin
from ic_gvins_tpu_torch.convert import to_numpy, to_torch, unflatten
from ic_gvins_tpu_torch.data.types import ImuSeq, IntegrationParams, NavState
from ic_gvins_tpu_torch.engine.estimator import _unflatten
from ic_gvins_tpu_torch.factors import marginalization as tmarg
from ic_gvins_tpu_torch.factors.manifold import node_boxplus
from ic_gvins_tpu_torch.ins import preintegration_odo as tpo
from ic_gvins_tpu_torch.solver import assembly as tasm
from ic_gvins_tpu_torch.solver import window as twin
from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig

SODO = 0.02
SMALL = os.path.join(ROOT, "tests", "fixtures", "torch_estimator_small.npz")
SLICE = os.path.join(ROOT, "tests", "fixtures", "torch_slice_24x192.npz")


def _odo_params():
    return dict(cvb=np.array([[1.0, -0.01, 0.0], [0.01, 1.0, 0.0], [0.0, 0.0, 1.0]]),
                lodo=np.array([-0.3, 0.1, 0.5]), odo_vrw=np.asarray(0.05),
                odo_srw=np.asarray(1e-4))


def _odovel(imu, seed):
    """Wheel increments of a ~5 m/s car with noise, one per IMU sample."""
    rng = np.random.default_rng(seed)
    dt = np.asarray(imu.dt)
    return (5.0 + 0.2 * rng.standard_normal(dt.shape)) * dt


def _jax_tree(cls, d):
    """A JAX-package NamedTuple from the fixture's nested numpy dicts."""
    nested = {"nodes": JNav, "lin_nodes": JNav, "end_state": JNav, "preint": jpre.PreintData}
    return cls(**{k: _jax_tree(nested[k], v) if k in nested else jnp.asarray(v)
                  for k, v in d.items()})


@pytest.fixture(scope="module")
def odo_case():
    """The stored keyframe-round window (``torch_slice_24x192.npz``, the
    JAX package's ``_tiny_problem(24, 192)``) as an odometer window: every
    interval re-preintegrated by the JAX package with wheel increments
    from a numpy seed, then moved off the estimate."""
    inp = unflatten(dict(np.load(SLICE)), "in/")
    win = _jax_tree(jwin.Window, inp["window"])
    prior, cfg = _jax_tree(jwin.Prior, inp["prior"]), _jax_tree(jwin.SolverConfig, inp["cfg"])
    params = _jax_tree(JParams, inp["params"])
    imu = _jax_tree(JImu, inp["imu"])
    odo = jpo.OdoParams(**{k: jnp.asarray(v) for k, v in _odo_params().items()})
    odovel = jnp.asarray(_odovel(imu, 0))
    n = win.n_nodes
    state0 = jax.tree.map(lambda x: x[:-1], win.nodes)
    stack = jax.jit(jax.vmap(jpo.preintegrate_odo, in_axes=(None, None, 0, None, 0, 0)))(
        params, odo, state0, jnp.asarray(SODO), imu, odovel)
    owin = jwin.empty_window(n, win.n_landmarks, odo=True)
    owin = owin._replace(**{k: getattr(win, k) for k in win._fields if k not in ("preint", "sodo")},
                         preint=stack, sodo=jnp.asarray(SODO + 0.004))
    rng = np.random.default_rng(0)
    owin = owin._replace(
        nodes=owin.nodes._replace(p=owin.nodes.p + 0.02 * rng.standard_normal((n, 3)),
                                  v=owin.nodes.v + 0.01 * rng.standard_normal((n, 3)),
                                  bg=owin.nodes.bg + 1e-5 * rng.standard_normal((n, 3))),
        lm_invdepth=owin.lm_invdepth * (1 + 0.05 * rng.standard_normal(win.n_landmarks)))
    cfg = cfg._replace(estimate_sodo=jnp.asarray(True))
    return dict(win=owin, prior=prior, cfg=cfg, params=params, odo=odo, imu=imu,
                odovel=odovel, data=stack, state0=state0)


def _port(case):
    """The case on the port: the odometer window rebuilt from the JAX
    window's leaves in ``jax.tree.flatten`` order, as checkpoints are."""
    w = case["win"]
    tw = _unflatten(twin.empty_window(w.n_nodes, w.n_landmarks, device="cpu", odo=True),
                    [np.asarray(x) for x in jax.tree.leaves(w)], "cpu")
    return (tw, to_torch(Prior, to_numpy(case["prior"]), "cpu"),
            to_torch(SolverConfig, to_numpy(case["cfg"]), "cpu"),
            to_torch(IntegrationParams, to_numpy(case["params"]), "cpu"))


@pytest.fixture(scope="module")
def preint_pair(odo_case):
    """The JAX intervals and the port's, all 23 integrated in one call."""
    c = odo_case
    tp = to_torch(IntegrationParams, to_numpy(c["params"]), "cpu")
    t_odo = tpo.OdoParams(*(torch.as_tensor(v) for v in _odo_params().values()))
    got = tpo.preintegrate_odo(tp, t_odo, to_torch(NavState, to_numpy(c["state0"]), "cpu"),
                               torch.tensor(SODO, dtype=torch.float64),
                               to_torch(ImuSeq, to_numpy(c["imu"]), "cpu"),
                               torch.as_tensor(np.asarray(c["odovel"])))
    return c["data"], got, tp, t_odo


@pytest.mark.parametrize("field", ["dp", "dv", "dq", "ds", "jac", "cov", "dt", "sum_dt_pn",
                                   "end_state"])
def test_preintegrate_odo_matches_jax(preint_pair, field):
    """Log-depth scans and the pairwise tree vs the JAX sample-by-sample
    scan: the same products in another association order."""
    want, got = preint_pair[:2]
    if field == "end_state":
        for k in ("time", "p", "q", "v"):
            assert_rel(getattr(got.end_state, k), getattr(want.end_state, k), CLOSED, k)
    else:
        assert_rel(getattr(got, field), getattr(want, field), CLOSED, field)
    assert_rel(got.sodo_ref, np.full(got.dt.shape[0], SODO), 0.0, "sodo_ref")


def test_odo_noise_and_residual_match_jax(odo_case):
    c = odo_case
    tw, _, _, tp = _port(c)
    t_odo = tpo.OdoParams(*(torch.as_tensor(v) for v in _odo_params().values()))
    assert_rel(tpo.noise_psd_odo(tp, t_odo), jpo.noise_psd_odo(c["params"], c["odo"]), 0.0, "psd")
    w = c["win"]
    s0 = jax.tree.map(lambda x: x[:-1], w.nodes)
    s1 = jax.tree.map(lambda x: x[1:], w.nodes)
    sodo1 = w.sodo + 0.001  # a random-walk row that is not zero
    want = jax.jit(jax.vmap(jpo.preint_odo_residual, in_axes=(0, 0, None, 0, None, None)))(
        w.preint, s0, w.sodo, s1, sodo1, c["params"])
    got = tpo.preint_odo_residual(tw.preint, NavState(*(x[:-1] for x in tw.nodes)), tw.sodo,
                                  NavState(*(x[1:] for x in tw.nodes)), tw.sodo + 0.001, tp)
    assert_rel(got, want, CLOSED, "whitened residual")


def test_odo_jacobian_matches_autodiff(odo_case):
    """The closed-form 19 x 31 Jacobian against torch.func.jacfwd of the
    port's own residual and against the JAX package's jacfwd blocks
    (``eval_preint`` on the odometer window), whitened."""
    c = odo_case
    tw, _, _, tp = _port(c)
    s0 = NavState(*(x[:-1] for x in tw.nodes))
    s1 = NavState(*(x[1:] for x in tw.nodes))
    r, J = tpo.preint_odo_residual_jac(tw.preint, s0, s1, tw.sodo, tp)

    def res(delta):  # [N-1, 31] -> [N-1, 19]
        return tpo.preint_odo_residual(
            tw.preint, node_boxplus(s0, delta[:, :15]), tw.sodo + delta[:, 30],
            node_boxplus(s1, delta[:, 15:30]), tw.sodo + delta[:, 30], tp, whiten=False)

    z = torch.zeros(s0.p.shape[0], 31, dtype=torch.float64)
    J_ad = torch.func.jacfwd(res)(z)  # [N-1, 19, N-1, 31]
    J_ad = torch.stack([J_ad[i, :, i] for i in range(z.shape[0])])
    assert_rel(r, res(z), CLOSED, "residual")
    assert_rel(J, J_ad, CLOSED, "jacobian vs torch jacfwd")
    want = jax.jit(jasm.eval_preint)(c["win"], c["params"])
    got = tasm.eval_preint(tw, tp)
    assert_rel(got[0], want[0], CLOSED, "whitened residual vs JAX")
    assert_rel(got[1], want[1], CLOSED, "whitened jacobian vs JAX jacfwd")


@pytest.mark.parametrize("case", ["robust", "plain", "marg_selection"])
def test_odo_assemble_blocks_matches_jax(odo_case, case):
    """(Hxx, gx, Hxl, hll, gl, cost) of the odometer window: the factor's
    sodo column, the soft scale prior and the scale's free flag."""
    c = odo_case
    win, prior, cfg, params = c["win"], c["prior"], c["cfg"], c["params"]
    tw, tpr, tc, tp = _port(c)
    kw, jsel, tsel = {}, None, None
    flags = (case == "robust",) * 2
    if case == "marg_selection":
        n = win.n_nodes
        jsel = jasm.FactorSel(preint=jnp.arange(n - 1) == 0, gnss=jnp.arange(n) == 0,
                              reproj=(win.lm_ref == 0) & win.lm_valid)
        tsel = tasm.FactorSel(*(torch.from_numpy(np.array(x)) for x in jsel))
        kw = dict(include_soft_priors=False, gauge_fix=False)
    want = jax.jit(jasm.assemble_blocks, static_argnames=("include_soft_priors", "gauge_fix"))(
        win, prior, cfg, params, jasm.RobustFlags(*map(jnp.asarray, flags)), sel=jsel, **kw)
    got = tasm.assemble_blocks(tw, tpr, tc, tp, tasm.RobustFlags(*flags), sel=tsel, **kw)
    for g, w, what in zip(got, want, ("Hxx", "gx", "Hxl", "hll", "gl", "cost")):
        assert_rel(g, w, CLOSED, what)
    if case == "robust":
        sodo = win.n_nodes * 15 + 7
        assert float(got[0][sodo, sodo]) > 1.0 and float(got[0][sodo, :sodo].abs().max()) > 0


def test_odo_robust_cost_and_marginalization_match_jax(odo_case):
    """The cost with the scale prior, and the prior that marginalizing
    node 0 of the odometer window leaves (its sodo row and column filled)."""
    c = odo_case
    win, prior, cfg, params = c["win"], c["prior"], c["cfg"], c["params"]
    tw, tpr, tc, tp = _port(c)
    flags = jasm.RobustFlags(jnp.asarray(True), jnp.asarray(True))
    assert_rel(tasm.robust_cost(tw, tpr, tc, tp, tasm.RobustFlags(True, True)),
               jax.jit(jasm.robust_cost)(win, prior, cfg, params, flags), CLOSED, "cost")
    j_win, j_prior = jax.jit(jmarg.marginalize_and_slide)(win, prior, cfg, params)
    t_win, t_prior = tmarg.marginalize_and_slide(tw, tpr, tc, tp)
    assert_rel(t_prior.H, j_prior.H, ITERATIVE, "H")
    assert_rel(t_prior.g, j_prior.g, ITERATIVE, "g")
    sodo = win.n_nodes * 15 + 7
    assert float(t_prior.H[sodo, sodo]) > 0 and float(t_prior.H[sodo, :sodo].abs().max()) > 0
    assert_rel(t_win.preint.ds, j_win.preint.ds, 0.0, "slid ds")
    assert_rel(t_win.preint.sodo_ref, j_win.preint.sodo_ref, 0.0, "slid sodo_ref")


def test_odo_window_constructor_matches_jax():
    _same_tree(twin.empty_window(5, 7, device="cpu", odo=True), jwin.empty_window(5, 7, odo=True))


# --- the estimator with the odometer, and checkpoints ------------------------------

# The CPU bounds of the odometer estimator against its stored JAX run: the
# same decisions, each round's solve equal but for rounding
ODO_POS_ATOL = 1e-8  # m
ODO_ATT_ATOL = 1e-8  # rad
SODO_ATOL = 1e-10


@pytest.fixture(scope="module")
def odo_small_run(tmp_path_factory):
    """The port's ``Estimator`` on the stored ``odo_small`` scenario
    (tests/test_odo_window.py's configuration over 12 s), saving a
    checkpoint after the event where the JAX run saved its own."""
    s = chip_smoke.scenario(dict(np.load(SMALL)), "odo_small")
    ref = {k[4:]: v for k, v in s.items() if k.startswith("out/")}
    ck = int(ref["ckpt_event"])
    path = str(tmp_path_factory.mktemp("ckpt") / "port.pkl")
    est, got = chip_smoke.run_estimator(
        s, "cpu", on_event=lambda e, est: est.save_checkpoint(path) if e == ck else None)
    return dict(s=s, ref=ref, ck=ck, path=path, est=est, got=got)


def test_odo_estimator_matches_jax(odo_small_run):
    """The same events, node times and LM steps as the JAX run; the
    trajectory within ODO_POS_ATOL / ODO_ATT_ATOL and the scale within
    SODO_ATOL of JAX's; the scale recovered near the simulated 0.03."""
    run = odo_small_run
    dp, dq = chip_smoke.compare_estimator(run["got"], run["ref"])
    assert dp <= ODO_POS_ATOL and dq <= ODO_ATT_ATOL, (dp, dq)
    sodo = float(run["est"].window.sodo)
    assert abs(sodo - float(run["ref"]["sodo"])) <= SODO_ATOL
    assert abs(sodo - 0.03) < 0.015


def test_checkpoint_round_trip_is_bit_equal(odo_small_run):
    """Saved at the middle event and resumed in a fresh estimator, the run
    makes the same decisions and ends bit for bit where the uninterrupted
    run ends."""
    run = odo_small_run
    est, got = chip_smoke.resume_estimator(run["s"], run["path"], "cpu", run["ck"] + 1)
    want = chip_smoke.continuation_ref(run["got"], run["ck"], len(got["stats"]))
    for k in ("log", "log_node_t", "log_node_kf", "stats", "traj_t", "traj_p", "traj_q",
              "nodes_p", "nodes_q", "nodes_v", "nodes_bg", "nodes_ba"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert float(est.window.sodo) == float(run["est"].window.sodo)
    assert torch.equal(est.prior.H, run["est"].prior.H)


def test_jax_checkpoint_continues_to_jax_end(odo_small_run, tmp_path):
    """The checkpoint the JAX package saved at the same event (a pickle of
    numpy and Python objects only) resumes in the port, which then makes
    the JAX run's decisions and ends within the estimator bounds of its
    end."""
    run = odo_small_run
    path = str(tmp_path / "jax.pkl")
    with open(path, "wb") as f:
        f.write(run["ref"]["ckpt"].tobytes())
    est, got = chip_smoke.resume_estimator(run["s"], path, "cpu", run["ck"] + 1)
    want = chip_smoke.continuation_ref(run["ref"], run["ck"], len(got["stats"]))
    dp, dq = chip_smoke.compare_estimator(got, want)
    assert dp <= ODO_POS_ATOL and dq <= ODO_ATT_ATOL, (dp, dq)
    assert abs(float(est.window.sodo) - float(run["ref"]["sodo"])) <= SODO_ATOL


def test_checkpoint_of_another_layout_is_refused(tmp_path):
    """A checkpoint of a plain window does not load into an odometer
    estimator (nor one of other window sizes): the layout is checked
    before any state changes."""
    from ic_gvins_tpu_torch.engine.config import EngineConfig, OdoConfig
    from ic_gvins_tpu_torch.engine.estimator import Estimator

    path = str(tmp_path / "plain.pkl")
    Estimator(EngineConfig(max_nodes=6, max_landmarks=4), device="cpu").save_checkpoint(path)
    for cfg in (EngineConfig(max_nodes=6, max_landmarks=4, odo=OdoConfig(use_odo=True)),
                EngineConfig(max_nodes=7, max_landmarks=4)):
        est = Estimator(cfg, device="cpu")
        with pytest.raises(ValueError, match="layout"):
            est.load_checkpoint(path)
    est = Estimator(EngineConfig(max_nodes=6, max_landmarks=4), device="cpu")
    est.load_checkpoint(path)
    assert est.n_nodes == 0 and est.last_node_state is None
