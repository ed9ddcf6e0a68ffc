"""PyTorch port: rotation, mechanization, preintegration, factor
evaluation, assembly, Schur solve, LM and marginalization against the JAX
package, on ``__graft_entry__._tiny_problem()`` (6 nodes x 16 landmarks,
float64) carried over with ``ic_gvins_tpu_torch.convert``. The problem is
read from ``tests/fixtures/torch_tiny.npz`` (``tools/make_torch_fixture.py
--tiny``), where ``_tiny_problem()`` stored it, rather than simulated anew
in every test process; so are the JAX results of the two costliest
fixtures (the simulated intervals' preintegration and the 20-iteration
``optimize_impl``), which the tests hold the port against as before.

Tolerances are relative to each array's largest entry: 1e-9 for closed
forms (the two sides differ only in summation order), 1e-7 for LM and
marginalization outputs (20 damped solves and an eigen-decomposition
amplify those rounding differences)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import os

from ic_gvins_tpu.common import rotation as jrot
from ic_gvins_tpu.factors import marginalization as jmarg
from ic_gvins_tpu.ins import mechanization as jmech
from ic_gvins_tpu.ins import preintegration as jpre
from ic_gvins_tpu.solver import assembly as jasm
from ic_gvins_tpu.solver import lm as jlm
from ic_gvins_tpu.data import types as jtypes
from ic_gvins_tpu.solver import window as jwin
from ic_gvins_tpu_torch.common import rotation as trot
from ic_gvins_tpu_torch.convert import to_numpy, to_torch, unflatten
from ic_gvins_tpu_torch.data.types import ImuSeq, IntegrationParams, NavState
from ic_gvins_tpu_torch.factors import marginalization as tmarg
from ic_gvins_tpu_torch.ins import mechanization as tmech
from ic_gvins_tpu_torch.ins import preintegration as tpre
from ic_gvins_tpu_torch.solver import assembly as tasm
from ic_gvins_tpu_torch.solver import lm as tlm
from ic_gvins_tpu_torch.solver import window as twin
from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig, Window

CLOSED = 1e-9
ITERATIVE = 1e-7
TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                    "fixtures", "torch_tiny.npz")

# one XLA compile per structure: flags and selections are traced arguments
_j_assemble = jax.jit(jasm.assemble_blocks,
                      static_argnames=("include_soft_priors", "gauge_fix"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A module's port tests on one intra-op thread (the port test files
    import this fixture): the suite runs several test processes at once,
    and torch's default of one thread per core in each oversubscribes the
    cores (all port tests on 6 workers of an 8-core CPU: 628 s with the
    default, 155 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_rel(got, want, tol, what=""):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-300)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def port(jax_state):
    """(window, prior, cfg, params) of the JAX package -> the port's."""
    win, prior, cfg, params = jax_state
    return (to_torch(Window, to_numpy(win), "cpu"), to_torch(Prior, to_numpy(prior), "cpu"),
            to_torch(SolverConfig, to_numpy(cfg), "cpu"),
            to_torch(IntegrationParams, to_numpy(params), "cpu"))


def perturbed(win, seed=0):
    """Move nodes and landmarks off the truth so every residual and
    gradient is well above rounding."""
    rng = np.random.default_rng(seed)
    n, lm = win.n_nodes, win.n_landmarks
    nodes = win.nodes._replace(
        p=win.nodes.p + 0.02 * rng.standard_normal((n, 3)),
        v=win.nodes.v + 0.01 * rng.standard_normal((n, 3)),
        bg=win.nodes.bg + 1e-5 * rng.standard_normal((n, 3)),
    )
    return win._replace(nodes=nodes,
                        lm_invdepth=win.lm_invdepth * (1 + 0.05 * rng.standard_normal(lm)))


def jax_tree(cls, tree):
    """A NamedTuple of the JAX package (``Window``, ``Prior``, ...) from nested
    dicts of numpy arrays, the inverse of ``to_numpy``; absent fields keep
    their defaults."""
    nested = {jwin.Window: {"nodes": jtypes.NavState, "preint": jpre.PreintData},
              jpre.PreintData: {"end_state": jtypes.NavState},
              jwin.Prior: {"lin_nodes": jtypes.NavState}}.get(cls, {})
    return cls(**{k: jax_tree(nested[k], v) if k in nested else jnp.asarray(v)
                  for k, v in tree.items()})


def tiny_problem():
    """``_tiny_problem()``'s (window, prior, cfg, params) and what
    ``tools/make_torch_fixture.py --tiny`` stored with it: (JAX state, the
    round's inputs, the round's JAX results, the whole file), as nested
    dicts of numpy arrays."""
    fx = unflatten(dict(np.load(TINY)))
    inp = fx["in"]
    state = tuple(jax_tree(cls, inp[k]) for cls, k in (
        (jwin.Window, "window"), (jwin.Prior, "prior"), (jwin.SolverConfig, "cfg"),
        (jtypes.IntegrationParams, "params")))
    return state, inp, fx["out"], fx


@pytest.fixture(scope="module")
def stored():
    """The fixture file's JAX results (``tiny_problem``'s last item)."""
    return tiny_problem()[3]


@pytest.fixture(scope="module")
def tiny():
    (win, prior, cfg, params), _, _, _ = tiny_problem()
    return perturbed(win), prior, cfg, params


# --- rotation and mechanization --------------------------------------------


def _quats(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "quat_to_matrix",
                                  "matrix_to_quat", "rotvec_to_quat", "quat_to_rotvec",
                                  "skew", "quat_left", "quat_right"])
def test_rotation_matches_jax(name):
    rng = np.random.default_rng(3)
    q, p = _quats(32, 1), _quats(32, 2)
    rv = rng.standard_normal((32, 3)) * np.r_[np.ones(30), 1e-10, 0.0][:, None]
    args = {
        "quat_mul": (q, p), "quat_rotate": (q, rv), "quat_to_matrix": (q,),
        "matrix_to_quat": (np.array(jrot.quat_to_matrix(jnp.asarray(q))),),
        "rotvec_to_quat": (rv,), "quat_to_rotvec": (q,), "skew": (rv,),
        "quat_left": (q,), "quat_right": (q,),
    }[name]
    want = getattr(jrot, name)(*map(jnp.asarray, args))
    got = getattr(trot, name)(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-14)


def test_mechanization_pieces_match_jax():
    rng = np.random.default_rng(4)
    a = [rng.standard_normal((10, 3)) * 1e-2 for _ in range(4)]
    dt, bg, ba = rng.random(10) * 5e-3, rng.standard_normal(3) * 1e-4, rng.standard_normal(3)
    for got, want in zip(
        tmech.compensate_bias(*map(torch.from_numpy, (a[0], a[1], dt, bg, ba))),
        jmech.compensate_bias(*map(jnp.asarray, (a[0], a[1], dt, bg, ba))),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)
    for got, want in zip(tmech.coning_sculling(*map(torch.from_numpy, a)),
                         jmech.coning_sculling(*map(jnp.asarray, a))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)


# --- preintegration ---------------------------------------------------------


@pytest.fixture(scope="module")
def preint_case(tiny, stored):
    """Two 0.4 s intervals of simulated 200 Hz IMU from biased start states;
    the IMU and its JAX preintegration (``jax.vmap(preintegrate)``) are
    the stored ones."""
    win, _, _, params = tiny
    state0 = jax.tree.map(lambda x: x[:2], win.nodes)
    state0 = state0._replace(ba=state0.ba + 1e-3)
    state1 = jax.tree.map(lambda x: x[1:3], win.nodes)
    want = jax_tree(jpre.PreintData, stored["preint_case"]["want"])
    tp = to_torch(IntegrationParams, to_numpy(params), "cpu")
    got = tpre.preintegrate(tp, to_torch(NavState, to_numpy(state0), "cpu"),
                            to_torch(ImuSeq, stored["preint_case"]["imu"], "cpu"))
    return params, state0, state1, want, tp, got


@pytest.mark.parametrize("field", ["dp", "dv", "dq", "jac", "cov", "dt", "sum_dt_pn"])
def test_preintegrate_matches_jax(preint_case, field):
    """Sequential Phi/P recursion vs the JAX log-depth composition: the
    same products in another association order."""
    _, _, _, want, _, got = preint_case
    assert_rel(getattr(got, field), getattr(want, field), CLOSED, field)


def test_preint_end_state_matches_jax(preint_case):
    _, _, _, want, _, got = preint_case
    for k in ("p", "q", "v", "time"):
        assert_rel(getattr(got.end_state, k), getattr(want.end_state, k), CLOSED, k)


def test_preint_residuals_match_jax(preint_case):
    params, state0, state1, want, tp, got = preint_case
    ts0 = to_torch(NavState, to_numpy(state0), "cpu")
    ts1 = to_torch(NavState, to_numpy(state1), "cpu")
    # feed both sides the same preintegration (the JAX one)
    gp = to_torch(tpre.PreintData, to_numpy(want), "cpu")
    j_r, j_rj = jax.jit(lambda *a: (
        jax.vmap(jpre.preint_residual, in_axes=(0, 0, 0, None))(*a),
        jax.vmap(jpre.preint_residual_jac, in_axes=(0, 0, 0, None))(*a),
    ))(want, state0, state1, params)
    assert_rel(tpre.preint_residual(gp, ts0, ts1, tp), j_r, CLOSED, "whitened residual")
    r, J = tpre.preint_residual_jac(gp, ts0, ts1, tp)
    assert_rel(r, j_rj[0], CLOSED, "residual")
    assert_rel(J, j_rj[1], CLOSED, "jacobian")
    assert_rel(tpre.sqrt_information(gp.cov), jax.jit(jpre.sqrt_information)(want.cov),
               CLOSED, "sqrt info")
    assert_rel(tpre.noise_psd(tp), jpre.noise_psd(params), 0.0, "noise psd")


# --- factor evaluation, assembly and solve ----------------------------------


@pytest.mark.parametrize("which", ["preint", "gnss", "reproj", "bias"])
def test_factor_jacobians_match_jax(tiny, which):
    """The port's closed-form Jacobians against the JAX package's factor
    blocks (analytic for preintegration, jacfwd for the others)."""
    win, prior, cfg, params = tiny
    tw, _, tc, tp = port(tiny)
    if which == "preint":
        want, got = jax.jit(jasm.eval_preint)(win, params), tasm.eval_preint(tw, tp)
    elif which == "gnss":
        want, got = jax.jit(jasm.eval_gnss)(win, cfg), tasm.eval_gnss(tw, tc)
    elif which == "reproj":
        want, got = jax.jit(jasm.eval_reproj)(win, cfg), tasm.eval_reproj(tw, tc)
        assert_rel(tasm.eval_reproj_res(tw, tc), want[0], CLOSED, "residual only")
    else:
        want, got = jax.jit(jasm.eval_bias_prior)(win, cfg), tasm.eval_bias_prior(tw, tc)
    for g, w, what in zip(got, want, ("residual", "jacobian", "index")):
        assert_rel(g, w, CLOSED, what)


_FLAGS = {"robust": (True, True), "gnss_plain": (False, True), "plain": (False, False)}


@pytest.mark.parametrize("case", ["robust", "gnss_plain", "plain", "marg_selection"])
def test_assemble_blocks_matches_jax(tiny, case):
    """(Hxx, gx, Hxl, hll, gl, cost) at a perturbed state."""
    win, prior, cfg, params = tiny
    tw, tpr, tc, tp = port(tiny)
    if case == "marg_selection":
        n = win.n_nodes
        jsel = jasm.FactorSel(preint=jnp.arange(n - 1) == 0, gnss=jnp.arange(n) == 0,
                              reproj=(win.lm_ref == 0) & win.lm_valid)
        tsel = tasm.FactorSel(*(torch.from_numpy(np.array(x)) for x in jsel))
        kw = dict(include_soft_priors=False, gauge_fix=False)
        jflags, tflags = (False, False), tasm.RobustFlags(False, False)
    else:
        jsel = tsel = None
        kw = {}
        jflags = _FLAGS[case]
        tflags = tasm.RobustFlags(*jflags)
    want = _j_assemble(win, prior, cfg, params,
                       jasm.RobustFlags(*map(jnp.asarray, jflags)), sel=jsel, **kw)
    got = tasm.assemble_blocks(tw, tpr, tc, tp, tflags, sel=tsel, **kw)
    for g, w, what in zip(got, want, ("Hxx", "gx", "Hxl", "hll", "gl", "cost")):
        assert_rel(g, w, CLOSED, what)


def test_robust_cost_and_schur_solve_match_jax(tiny):
    win, prior, cfg, params = tiny
    tw, tpr, tc, tp = port(tiny)
    jflags = jasm.RobustFlags(jnp.asarray(True), jnp.asarray(True))
    assert_rel(tasm.robust_cost(tw, tpr, tc, tp, tasm.RobustFlags(True, True)),
               jax.jit(jasm.robust_cost)(win, prior, cfg, params, jflags), CLOSED, "cost")
    blocks = _j_assemble(win, prior, cfg, params, jflags)
    want = jax.jit(jasm.schur_solve_blocks)(*blocks[:5], 1e-4)
    got = tasm.schur_solve_blocks(*(torch.from_numpy(np.array(b)) for b in blocks[:5]), 1e-4)
    assert_rel(got[0], want[0], CLOSED, "dx_x")
    assert_rel(got[1], want[1], CLOSED, "dx_l")


# --- LM and marginalization -------------------------------------------------


@pytest.fixture(scope="module")
def optimized(tiny, stored):
    """``optimize_impl(iters=20)`` of the tiny window: the stored JAX result
    and the port's."""
    opt = stored["optimized"]
    want = (jax_tree(jwin.Window, opt["window"]),
            (jax_tree(jlm.LMStats, opt["stats1"]), jax_tree(jlm.LMStats, opt["stats2"]),
             opt["n_culled"]))
    got = tlm.optimize_impl(*port(tiny), iters=20)
    return want, got


def test_optimize_impl_matches_jax(optimized):
    (jw, (j1, j2, jn)), (tw, (t1, t2, tn)) = optimized
    for js, ts in ((j1, t1), (j2, t2)):
        assert (ts.iters_run, ts.accepted) == (int(js.iters_run), int(js.accepted))
        assert_rel(ts.cost0, js.cost0, ITERATIVE, "cost0")
        assert_rel(ts.cost1, js.cost1, ITERATIVE, "cost1")
    assert int(tn) == int(jn)
    for k in ("p", "q", "v", "bg", "ba"):
        assert_rel(getattr(tw.nodes, k), getattr(jw.nodes, k), ITERATIVE, k)
    assert_rel(tw.lm_invdepth, jw.lm_invdepth, ITERATIVE, "invdepth")
    np.testing.assert_array_equal(tw.obs_valid.numpy(), np.asarray(jw.obs_valid))
    assert_rel(tw.gnss_std, jw.gnss_std, ITERATIVE, "gnss_std")


def test_optimize_impl_without_cull_matches_jax(tiny):
    """The initialization-phase solve: one robust LM run, no chi2 gates."""
    win, prior, cfg, params = tiny
    jw, (j1, j2, jn) = jax.jit(lambda *a: jlm.optimize_impl(*a, iters=20, do_cull=False))(
        win, prior, cfg, params)
    tw, (t1, t2, tn) = tlm.optimize_impl(*port(tiny), iters=20, do_cull=False)
    assert (t1.iters_run, t1.accepted) == (int(j1.iters_run), int(j1.accepted))
    assert t2 is t1 and int(tn) == int(jn) == 0
    assert_rel(t1.cost1, j1.cost1, ITERATIVE, "cost1")
    for k in ("p", "q", "v", "bg", "ba"):
        assert_rel(getattr(tw.nodes, k), getattr(jw.nodes, k), ITERATIVE, k)
    np.testing.assert_array_equal(tw.obs_valid.numpy(), np.asarray(win.obs_valid))


def test_phase_iters_split():
    assert tlm.phase_iters(20) == (5, 15)
    assert tlm.phase_iters(8) == (5, 6)
    assert tlm.phase_iters(2) == (2, 2)


def test_marginalize_and_slide_matches_jax(tiny, optimized):
    _, prior, cfg, params = tiny
    (jw, _), (tw, _) = optimized
    j_win, j_prior = jax.jit(jmarg.marginalize_and_slide)(jw, prior, cfg, params)
    t_win, t_prior = tmarg.marginalize_and_slide(tw, to_torch(Prior, to_numpy(prior), "cpu"),
                                                 *port(tiny)[2:])
    assert_rel(t_prior.H, j_prior.H, ITERATIVE, "H")
    assert_rel(t_prior.g, j_prior.g, ITERATIVE, "g")
    for k in ("p", "q", "v"):
        assert_rel(getattr(t_prior.lin_nodes, k), getattr(j_prior.lin_nodes, k), ITERATIVE, k)
        assert_rel(getattr(t_win.nodes, k), getattr(j_win.nodes, k), ITERATIVE, k)
    for k in ("node_valid", "preint_valid", "gnss_valid", "lm_valid", "lm_ref", "obs_valid"):
        np.testing.assert_array_equal(getattr(t_win, k).numpy(), np.asarray(getattr(j_win, k)))
    assert_rel(t_win.obs_uv, j_win.obs_uv, 0.0, "obs_uv")
    assert_rel(t_win.preint.cov, j_win.preint.cov, 0.0, "preint cov")


# --- window constructors and conversion -----------------------------------


def _same_tree(got, want):
    """Equal field names, shapes, dtypes and values, leaf by leaf."""
    a, b = to_numpy(got), to_numpy(want)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["empty_window", "empty_prior", "init_prior",
                                  "init_prior_ext7", "init_prior_ext8"])
def test_window_constructors_match_jax(tiny, case):
    if case == "empty_window":
        _same_tree(twin.empty_window(5, 7, device="cpu"), jwin.empty_window(5, 7))
    elif case == "empty_prior":
        _same_tree(twin.empty_prior(5, device="cpu"), jwin.empty_prior(5))
    else:
        rng = np.random.default_rng(6)
        stds = [rng.random(n) + 0.1 for n in (6, 9)]
        if case != "init_prior":
            stds.append(rng.random(int(case[-1])) + 0.1)
        win = tiny[0]
        _same_tree(twin.make_init_prior(to_torch(Window, to_numpy(win), "cpu"),
                                        *map(torch.from_numpy, stds)),
                   jwin.make_init_prior(win, *map(jnp.asarray, stds)))




def test_convert_round_trip(tiny):
    win = tiny[0]
    back = to_numpy(to_torch(Window, to_numpy(win), "cpu"))
    flat_a = jax.tree.leaves(to_numpy(win))
    flat_b = jax.tree.leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_odometer_window_is_refused():
    odo = to_numpy(jwin.empty_window(4, 3, odo=True))
    with pytest.raises(ValueError):
        to_torch(Window, odo, "cpu")


def test_index_sum_on_the_cpu_is_index_add():
    """On the CPU ``index_sum_`` is ``index_add_`` to the bit (one pass in
    index order), so the CPU results stay those of ``index_add_``."""
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 5, 64))
    src = torch.from_numpy(rng.standard_normal((64, 6, 6)))
    acc = torch.from_numpy(rng.standard_normal((5, 6, 6)))
    got = tasm.index_sum_(acc.clone(), idx, src)
    assert torch.equal(got, acc.clone().index_add_(0, idx, src))
