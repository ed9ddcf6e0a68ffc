"""PyTorch port, the fusion engine: the port's ``Estimator`` and
``Pipeline`` on the CPU against the JAX package's float64 runs stored in
``tests/fixtures/torch_estimator_small.npz`` (``tools/make_torch_estimator_fixture.py``):
the three scenarios of tests/port_estimator.py with ideal tracks, and
tests/test_pipeline.py's 320 x 240 scene on rendered frames. The JAX
estimator is not run here: its XLA:CPU compiles take minutes.

The estimator must make the same decisions as JAX (events, node times,
keyframes, LM steps and iterations per round, culling) and follow its
trajectory within chip_smoke's TRAJ_POS_ATOL / TRAJ_ATT_ATOL, and meet
each JAX test's own bound. The pipeline draws JAX's FM-RANSAC uniforms
(``common/prng.py``) and makes the JAX pipeline's rounds, but not every
one of its tracks: an 8-point subset drawn with a repeated index has a
two-dimensional null space, whose eigenvector each LAPACK picks
otherwise, and on this scene such a subset wins frame 14's RANSAC in JAX
(24 inliers) and not in the port (23). The port then keeps one landmark
more from event 27 on; it is held to the JAX pipeline's events, node
times, keyframes and per-round LM steps, iterations and culls exactly,
to its landmark count within one, and to its ATE within
PIPELINE_ATE_VS_JAX."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from test_torch_solver import one_torch_thread  # noqa: E402, F401

from ic_gvins_tpu_torch.engine import estimator as port_est  # noqa: E402
from ic_gvins_tpu_torch.engine.config import EngineConfig  # noqa: E402
from ic_gvins_tpu_torch.engine.estimator import TRACKING_NORMAL, Estimator  # noqa: E402
from ic_gvins_tpu_torch.engine.pipeline import Pipeline  # noqa: E402

SMALL = os.path.join(ROOT, "tests", "fixtures", "torch_estimator_small.npz")
PIPELINE_ATE_VS_JAX = 0.005  # m (1.2 mm apart on the CPU)
# (t_min, bound on the RMS or the max of the errors after t_min): the JAX tests'
BOUNDS = {"gins": (5.0, "rmse", 0.13), "gvins": (5.0, "rmse", 0.13),
          "outage": (10.0, "max", 1.0)}


@pytest.fixture(scope="module")
def small():
    return dict(np.load(SMALL))


def _ref(s):
    return {k[4:]: v for k, v in s.items() if k.startswith("out/")}


def _bound(got, s, name):
    t_min, kind, lim = BOUNDS[name]
    e = chip_smoke.trajectory_errors(got["traj_t"], got["traj_p"], s, t_min)
    return (np.sqrt(np.mean(e**2)) if kind == "rmse" else e.max()), lim


@pytest.mark.parametrize("name", ["gins", "gvins", "outage"])
def test_estimator_matches_jax(small, name):
    """GINS 15 s; GVINS 10 s with frames at 5 Hz; GNSS lost after 6 s of
    12 s, bridged by vision. Same events and rounds as JAX; trajectory and
    the final window within tolerance; the JAX test's own ATE bound."""
    s = chip_smoke.scenario(small, name)
    est, got = chip_smoke.run_estimator(s, "cpu")
    ref = _ref(s)
    chip_smoke.compare_estimator(got, ref)
    np.testing.assert_array_equal(got["node_times"], ref["node_times"])
    for k in ("p", "v"):
        np.testing.assert_allclose(got[f"nodes_{k}"], ref[f"nodes_{k}"], rtol=0,
                                   atol=chip_smoke.TRAJ_POS_ATOL)
    assert np.max(chip_smoke.quat_angle(got["nodes_q"], ref["nodes_q"])) <= chip_smoke.TRAJ_ATT_ATOL
    np.testing.assert_array_equal(got["lm_valid"], ref["lm_valid"])
    m = ref["lm_valid"]
    np.testing.assert_allclose(got["lm_invdepth"][m], ref["lm_invdepth"][m], rtol=1e-6)
    err, lim = _bound(got, s, name)
    assert err < lim, (name, err)
    if name != "gins":
        assert est.state == TRACKING_NORMAL and est.n_keyframes > 0
    if name == "gvins":
        assert len(est.lm_slot) > 10


def test_pipeline_against_jax(small):
    """tests/test_pipeline.py's scene: 8 s, 320 x 240 frames at 5 Hz from
    the numpy sprite renderer, plain KLT, no CLAHE. Initializes, makes
    keyframes and landmarks, stays under 0.45 m; the JAX pipeline's 16
    rounds with their LM steps, iterations and culls, its events with the
    landmark count within one, and its ATE within PIPELINE_ATE_VS_JAX."""
    s = chip_smoke.scenario(small, "pipeline")
    pipe, got, tracked = chip_smoke.run_pipeline(s, "cpu", use_clahe=False)
    ref = _ref(s)
    assert len(got["stats"]) == len(ref["stats"]) == 16
    cols = [i for i, k in enumerate(chip_smoke.STATS_KEYS)
            if k not in ("cost0", "cost1", "reproj_rms")]
    np.testing.assert_array_equal(got["stats"][:, cols], ref["stats"][:, cols])
    assert got["log"].shape == ref["log"].shape
    np.testing.assert_array_equal(np.delete(got["log"], 3, 1), np.delete(ref["log"], 3, 1))
    assert np.abs(got["log"][:, 3] - ref["log"][:, 3]).max() <= 1
    np.testing.assert_array_equal(got["log_node_t"], ref["log_node_t"])
    np.testing.assert_array_equal(got["log_node_kf"], ref["log_node_kf"])
    est = pipe.est
    assert est.state != 0, "no initialization"
    assert est.n_keyframes >= 2, "no visual keyframes"
    assert len(est.lm_slot) >= 10, "no landmarks created"
    assert tracked == len(s["frame_t"]) - 1
    e = chip_smoke.trajectory_errors(got["traj_t"], got["traj_p"], s, chip_smoke.PIPELINE_T_MIN)
    ate = float(np.sqrt(np.mean(e**2)))
    assert ate < chip_smoke.PIPELINE_ATE, ate
    assert abs(ate - float(ref["ate_rmse"])) <= PIPELINE_ATE_VS_JAX, (ate, ref["ate_rmse"])


@pytest.mark.parametrize("option", ["stat_phase_split", "host_predict_off"])
def test_estimator_options_match_jax(small, option):
    """The two phases as separate calls, and the INS prediction through
    the device mechanization instead of its numpy mirror: the same
    arithmetic as the default path, so the JAX run's first 7 s (vision
    joins at 3.6 s; 11 rounds, 6 of them with the chi2 phases)."""
    s = chip_smoke.scenario(small, "gvins")
    kw = {"stat_phase_split": {"stat_phase_split": True},
          "host_predict_off": {"host_predict": False}}[option]
    est, got = chip_smoke.run_estimator(chip_smoke.head(s, 7.0), "cpu", **kw)
    ref = _ref(s)
    n_ev, n_rounds = len(got["log"]), len(got["stats"])
    assert n_rounds >= 10 and est.n_keyframes > 0
    head = {k: ref[k][:n_ev] for k in ("log", "log_node_t", "log_node_kf")}
    head.update({k: ref[k][:n_rounds] for k in ("stats", "traj_p", "traj_q")})
    chip_smoke.compare_estimator(got, head)
    if option == "stat_phase_split":
        assert all("timecost_opt1_ms" in r for r in est.stats)


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no device given, Estimator and Pipeline go to cuda:0 and raise
    when there is none; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Estimator, Pipeline):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(EngineConfig())
    assert Estimator(EngineConfig(), device="cpu").window.nodes.p.device.type == "cpu"


@pytest.mark.parametrize("option", ["recenter_threshold", "set_mesh", "run_kaist_f32"])
def test_unported_options_raise(option, tmp_path):
    """What cannot run refuses instead of being ignored: ``set_mesh``
    refuses a mesh whose shard count does not divide the landmark capacity,
    the engine a dtype other than float64 and float32. The float32 mode,
    which these cases refused before it was ported, now runs and is held
    to it: ``recenter_threshold`` is kept when configured and resolves to
    20 m in float32 and 0 in float64, every device tensor of a float32
    engine is float32; ``run_kaist --f32`` replays (GNSS/INS from a small
    rosbag) in float32 and says so."""
    if option == "set_mesh":
        from ic_gvins_tpu_torch.parallel import Mesh

        with pytest.raises(ValueError, match="must divide"):
            Estimator(EngineConfig(max_nodes=4, max_landmarks=4), device="cpu").set_mesh(
                Mesh({"lm": 3}, device="cpu"))
        return
    if option == "recenter_threshold":
        small = EngineConfig(max_nodes=4, max_landmarks=4)
        est = Estimator(EngineConfig(max_nodes=4, max_landmarks=4, recenter_threshold=5.0),
                        device="cpu")
        assert est.recenter_threshold == 5.0 and est.window.nodes.p.dtype == torch.float64
        assert Estimator(small, device="cpu").recenter_threshold == 0.0
        e32 = Estimator(small, device="cpu", dtype=torch.float32)
        assert e32.recenter_threshold == 20.0
        leaves = [x for t in (e32.window, e32.prior, e32.params, e32.solver_cfg)
                  for x in port_est._leaves(t) if x.is_floating_point()]
        assert leaves and all(x.dtype == torch.float32 for x in leaves)
        with pytest.raises(TypeError):
            Estimator(small, device="cpu", dtype=torch.float16)
        return
    from test_rosbag import make_bag

    from ic_gvins_tpu_torch.tools import run_kaist

    bag = str(tmp_path / "t.bag")
    make_bag(bag, compression="bz2")
    res = run_kaist.main(["--data", bag, "--no-vision", "--f32", "--out",
                          str(tmp_path / "run"), "--device", "cpu"])
    assert res["dtype"] == "float32" and res["n_recenters"] == 0 and res["imu_repaired"] == 18


def test_states_and_map_point_types_are_the_reference_ones():
    from ic_gvins_tpu.engine import drawer as jdrawer
    from ic_gvins_tpu.engine import estimator as jest

    for k in ("ERROR", "INITIALIZING", "INITIALIZING_INS", "INITIALIZING_VIO",
              "TRACKING_INITIALIZING", "TRACKING_NORMAL", "TRACKING_LOST"):
        assert getattr(port_est, k) == getattr(jest, k), k
    for k in ("NONE", "TRIANGULATED", "DEPTH_ASSOCIATED", "DEPTH_INITIALIZED", "FIXED"):
        assert getattr(port_est, f"MAPPOINT_{k}") == getattr(jdrawer, f"MAPPOINT_{k}"), k
