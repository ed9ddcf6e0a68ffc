"""PyTorch port: the modules the estimator needs, each against the JAX
package on the same seeded inputs: the rotation helpers (Euler angles,
matrices, rotation vectors), the WGS84 Earth model, the mechanization
functions, node removal and insertion on a 16-node x 64-landmark window,
and the optimization wrappers (the two phases apart against the JAX
package's, ``optimize`` against the port's ``optimize_impl``).

Tolerances: 1e-12 relative to each output's largest entry for closed forms
(the two sides round in another order at most); index shuffles are exact;
the LM wrappers use test_torch_solver's 1e-7 for iterated solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_solver import ITERATIVE, assert_rel, one_torch_thread, port, stored, tiny  # noqa: F401

from ic_gvins_tpu.common import earth as jearth
from ic_gvins_tpu.common import rotation as jrot
from ic_gvins_tpu.factors import marginalization as jmarg
from ic_gvins_tpu.ins import mechanization as jmech
from ic_gvins_tpu.solver import window as jwin
from ic_gvins_tpu_torch.common import earth as tearth
from ic_gvins_tpu_torch.common import rotation as trot
from ic_gvins_tpu_torch.convert import to_numpy, to_torch
from ic_gvins_tpu_torch.data.types import ImuSeq, IntegrationParams, NavState
from ic_gvins_tpu_torch.factors import marginalization as tmarg
from ic_gvins_tpu_torch.ins import mechanization as tmech
from ic_gvins_tpu_torch.solver import lm as tlm
from ic_gvins_tpu_torch.solver.window import Prior, Window

CLOSED = 1e-12


def _same(got, want, tol=CLOSED, what=""):
    """Leaf by leaf: equal shapes, values within ``tol`` of each leaf's
    largest entry (exact for bool and integer leaves)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], tol, f"{what}.{k}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _same(g, w, tol, what)
        return
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, what
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer) or tol == 0.0:
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        assert_rel(g, w, tol, what)


def _quats(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _eulers():
    """Random attitudes plus both gimbal locks (pitch +-90 deg)."""
    rng = np.random.default_rng(11)
    e = rng.uniform(-3.0, 3.0, (24, 3)) * np.array([1.0, 0.5, 1.0])
    lock = np.array([[0.3, np.pi / 2, 0.7], [-0.2, -np.pi / 2, 2.1], [0.1, 1.5706, 0.4]])
    return np.concatenate([e, lock])


# --- rotation ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["quat_identity", "quat_conj", "rotvec_to_matrix",
                                  "matrix_to_rotvec", "matrix_to_euler", "euler_to_matrix",
                                  "euler_to_quat", "quat_to_euler"])
def test_rotation_additions_match_jax(name):
    rng = np.random.default_rng(3)
    q, e = _quats(27, 1), _eulers()
    rv = rng.standard_normal((27, 3)) * np.r_[np.ones(25), 1e-10, 0.0][:, None]
    m = np.asarray(jrot.euler_to_matrix(jnp.asarray(e)))
    args = {"quat_identity": (), "quat_conj": (q,), "rotvec_to_matrix": (rv,),
            "matrix_to_rotvec": (m,), "matrix_to_euler": (m,), "euler_to_matrix": (e,),
            "euler_to_quat": (e,), "quat_to_euler": (q,)}[name]
    want = getattr(jrot, name)(*map(jnp.asarray, args))
    got = getattr(trot, name)(*map(torch.from_numpy, args))
    _same(got, want, what=name)


# --- Earth model ------------------------------------------------------------


def _blh(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1.4, 1.4, n), rng.uniform(-3.1, 3.1, n),
                     rng.uniform(-50.0, 3000.0, n)], -1)


EARTH = ["gravity", "gravity_ned", "meridian_prime_vertical_radius", "rn", "cne", "qne",
         "blh_from_qne", "blh_to_ecef", "ecef_to_blh", "dri", "dr", "local_to_global",
         "global_to_local", "pose_local_to_global", "pose_global_to_local", "iewe", "iewn",
         "iewn_at", "enwn"]


@pytest.mark.parametrize("name", EARTH)
def test_earth_matches_jax(name):
    blh, blh1 = _blh(16, 0), _blh(16, 1)
    origin = blh[0]
    rng = np.random.default_rng(2)
    local = rng.uniform(-2000.0, 2000.0, (16, 3))
    r = np.asarray(jrot.euler_to_matrix(jnp.asarray(_eulers()[:16])))
    vel = rng.standard_normal((16, 3)) * 10.0
    ecef = np.asarray(jearth.blh_to_ecef(jnp.asarray(blh)))
    rmn = tuple(np.asarray(x) for x in jearth.meridian_prime_vertical_radius(jnp.asarray(blh[:, 0])))
    args = {
        "gravity": (blh,), "gravity_ned": (blh,), "meridian_prime_vertical_radius": (blh[:, 0],),
        "rn": (blh[:, 0],), "cne": (blh,), "qne": (blh,),
        "blh_from_qne": (np.asarray(jearth.qne(jnp.asarray(blh))), blh[:, 2]),
        "blh_to_ecef": (blh,), "ecef_to_blh": (ecef,), "dri": (blh,), "dr": (blh,),
        "local_to_global": (origin, local), "global_to_local": (origin, blh1),
        "pose_local_to_global": (origin, r, local), "pose_global_to_local": (origin, r, blh1),
        "iewe": (), "iewn": (blh[:, 0],), "iewn_at": (origin, local), "enwn": (rmn, blh, vel),
    }[name]
    conv = lambda f, a: tuple(conv(f, x) for x in a) if isinstance(a, tuple) else f(a)  # noqa: E731
    want = getattr(jearth, name)(*conv(jnp.asarray, args))
    got = getattr(tearth, name)(*conv(torch.from_numpy, args))
    _same(got, want, what=name)


# --- mechanization ------------------------------------------------------------


def _params(with_earth=True):
    from ic_gvins_tpu.data import simulator as sim

    jp = sim.default_params(with_earth=with_earth)
    return jp, to_torch(IntegrationParams, to_numpy(jp), "cpu")


def _imu(n, seed):
    rng = np.random.default_rng(seed)
    dt = np.full(n, 0.005)
    dt[0] = 0.0
    return dict(time=10.0 + np.cumsum(dt), dt=dt,
                dtheta=rng.standard_normal((n, 3)) * 1e-3 + np.array([0, 0, 2e-4]),
                dvel=rng.standard_normal((n, 3)) * 1e-2 + np.array([0.04, 0, -0.049]))


def _state(seed):
    rng = np.random.default_rng(seed)
    return dict(time=np.float64(10.0), p=rng.standard_normal(3) * 50, q=_quats(1, seed)[0],
                v=rng.standard_normal(3) * 5, bg=rng.standard_normal(3) * 1e-4,
                ba=rng.standard_normal(3) * 1e-2)


@pytest.mark.parametrize("with_earth", [True, False])
def test_mechanize_scan_and_step_match_jax(with_earth):
    """40 samples at 200 Hz from a moving state; the step alone from the
    same state with its own predecessor sample."""
    jp, tp = _params(with_earth)
    imu, st = _imu(41, 5), _state(6)
    want = jmech.mechanize_scan(jp, jmech.NavState(**{k: jnp.asarray(v) for k, v in st.items()}),
                                jmech.ImuSeq(**{k: jnp.asarray(v) for k, v in imu.items()}))
    got = tmech.mechanize_scan(tp, to_torch(NavState, st, "cpu"), to_torch(ImuSeq, imu, "cpu"))
    _same(got, want, 1e-11, "mechanize_scan")  # 40 steps of rounding
    pre = tuple(imu[k][3] for k in ("dt", "dtheta", "dvel"))
    cur = tuple(imu[k][4] for k in ("dt", "dtheta", "dvel"))
    want = jmech.mechanize_step(jp, jmech.NavState(**{k: jnp.asarray(v) for k, v in st.items()}),
                                tuple(map(jnp.asarray, pre)), tuple(map(jnp.asarray, cur)),
                                jnp.asarray(imu["time"][4]))
    got = tmech.mechanize_step(tp, to_torch(NavState, st, "cpu"),
                               tuple(map(torch.as_tensor, pre)), tuple(map(torch.as_tensor, cur)),
                               torch.as_tensor(imu["time"][4]))
    _same(got, want, what="mechanize_step")


def test_interpolation_matches_jax():
    imu = _imu(8, 7)
    t = np.array([imu["time"][5] - 0.0012, imu["time"][5] - 0.006, imu["time"][5] + 0.001])
    for tt in t:  # inside, before and after the interval (clipped)
        a = (imu["time"][4], imu["time"][5], imu["dt"][5], imu["dtheta"][5], imu["dvel"][5], tt)
        _same(tmech.interpolate_imu(*map(torch.as_tensor, a)),
              jmech.interpolate_imu(*map(jnp.asarray, a)), what="interpolate_imu")
    s0, s1 = _state(8), _state(9)
    s1["time"] = np.float64(10.4)
    for tt in (10.0, 10.13, 10.4):
        want = jmech.pose_interpolate(*(jmech.NavState(**{k: jnp.asarray(v) for k, v in s.items()})
                                        for s in (s0, s1)), jnp.asarray(tt))
        got = tmech.pose_interpolate(to_torch(NavState, s0, "cpu"), to_torch(NavState, s1, "cpu"),
                                     torch.tensor(tt, dtype=torch.float64))
        _same(got, want, what="pose_interpolate")


@pytest.mark.parametrize("case", ["static", "moving"])
def test_detect_zero_velocity_matches_jax(case):
    rng = np.random.default_rng(12)
    scale = (1e-6, 1e-5) if case == "static" else (1e-3, 1e-2)
    dth = rng.standard_normal((200, 3)) * scale[0]
    dv = rng.standard_normal((200, 3)) * scale[1] + np.array([0.0, 0.0, -0.049])
    j_zv, j_mean = jmech.detect_zero_velocity(jnp.asarray(dth), jnp.asarray(dv), 200.0)
    t_zv, t_mean = tmech.detect_zero_velocity(torch.as_tensor(dth), torch.as_tensor(dv), 200.0)
    assert bool(t_zv) == bool(j_zv) == (case == "static")
    _same(t_mean, j_mean, what="mean increments")


# --- node removal and insertion ---------------------------------------------


@pytest.fixture(scope="module")
def random_window():
    """A 16-node x 64-landmark window and prior with random contents (the
    index shuffles are exact whatever the values): 12 active nodes,
    landmarks anchored all over them."""
    rng = np.random.default_rng(21)
    jw = jwin.empty_window(16, 64)
    leaves = []
    for x in jax.tree.leaves(jw):
        x = np.asarray(x)
        if x.dtype == bool:
            leaves.append(rng.random(x.shape) < 0.6)
        elif np.issubdtype(x.dtype, np.integer):
            leaves.append(rng.integers(0, 12, x.shape).astype(x.dtype))
        else:
            leaves.append(rng.standard_normal(x.shape))
    jw = jax.tree.unflatten(jax.tree.structure(jw), [jnp.asarray(x) for x in leaves])
    jp = jwin.empty_prior(16)
    h = rng.standard_normal(jp.H.shape)
    jp = jp._replace(H=jnp.asarray(h + h.T), g=jnp.asarray(rng.standard_normal(jp.g.shape)),
                     lin_nodes=jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape)),
                                            jp.lin_nodes))
    return jw, jp, to_torch(Window, to_numpy(jw), "cpu"), to_torch(Prior, to_numpy(jp), "cpu")


@pytest.mark.parametrize("op,i", [("remove", 5), ("remove", 11), ("remove", 1),
                                  ("insert", 5), ("insert", 12), ("insert", 1)])
def test_remove_and_insert_node_match_jax(random_window, op, i):
    """Interior, tail and first-interval removal; interior, append-position
    and first-slot insertion, with 12 active nodes."""
    jw, jp, tw, tp = random_window
    fn = {"remove": (jmarg.remove_node, tmarg.remove_node),
          "insert": (jmarg.insert_node, tmarg.insert_node)}[op]
    j_win, j_pr = fn[0](jw, jp, i, 12)
    t_win, t_pr = fn[1](tw, tp, i, 12)
    _same(to_numpy(t_win), to_numpy(j_win), 0.0, f"{op} window")
    _same(to_numpy(t_pr), to_numpy(j_pr), 0.0, f"{op} prior")
    assert t_win.lm_ref.dtype == tw.lm_ref.dtype


# --- optimization wrappers ----------------------------------------------------


@pytest.mark.parametrize("do_cull", [True, False])
def test_optimize_is_optimize_impl(tiny, do_cull):  # noqa: F811
    """``optimize`` is the estimator's entry to ``optimize_impl``, which
    test_torch_solver.py holds against the JAX package: the same numbers."""
    tw, stats = tlm.optimize(*port(tiny), iters=20, do_cull=do_cull)
    rw, rstats = tlm.optimize_impl(*port(tiny), iters=20, do_cull=do_cull)
    _same(to_numpy(tw), to_numpy(rw), 0.0, "window")
    for ts, rs in zip(stats[:2], rstats[:2]):
        assert (ts.iters_run, ts.accepted, float(ts.cost1)) == (
            rs.iters_run, rs.accepted, float(rs.cost1))
    assert int(stats[2]) == int(rstats[2])


def test_optimize_phases_match_jax(tiny, stored):  # noqa: F811
    """Phase 1 (robust, then the chi2 gates) and phase 2 as two calls,
    against the JAX package's ``optimize_phase1`` / ``optimize_phase2`` of
    the same window, stored in ``tests/fixtures/torch_tiny.npz``
    (``tools/make_torch_fixture.py --tiny``)."""
    ref = stored["phases"]
    jw1, j1, jn = ref["window1"], ref["stats1"], ref["n_culled"]
    jw2, j2 = ref["window2"], ref["stats2"]
    tport = port(tiny)
    tw1, t1, tn = tlm.optimize_phase1(*tport, iters=20)
    tw2, t2 = tlm.optimize_phase2(tw1, *tport[1:], iters=20)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tw1.obs_valid.numpy(), jw1["obs_valid"])
    assert_rel(tw1.gnss_std, jw1["gnss_std"], ITERATIVE, "gnss_std")
    for js, ts, jw, tw in ((j1, t1, jw1, tw1), (j2, t2, jw2, tw2)):
        assert (ts.iters_run, ts.accepted) == (int(js["iters_run"]), int(js["accepted"]))
        assert_rel(ts.cost1, js["cost1"], ITERATIVE, "cost1")
        for k in ("p", "q", "v"):
            assert_rel(getattr(tw.nodes, k), jw["nodes"][k], ITERATIVE, k)
