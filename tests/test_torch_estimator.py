"""PyTorch port, the fusion engine: the port's ``Estimator`` and
``Pipeline`` on the CPU against the JAX package's float64 runs stored in
``tests/fixtures/torch_estimator_small.npz`` (``tools/make_torch_estimator_fixture.py``):
the three scenarios of tests/port_estimator.py with ideal tracks, and
tests/test_pipeline.py's 320 x 240 scene on rendered frames. The JAX
estimator is not run here: its XLA:CPU compiles take minutes.

The estimator must make the same decisions as JAX (events, node times,
keyframes, LM steps and iterations per round, culling) and follow its
trajectory within chip_smoke's TRAJ_POS_ATOL / TRAJ_ATT_ATOL, and meet
each JAX test's own bound. The pipeline draws its FM-RANSAC subsets from
another generator than JAX, so its tracks and rounds differ; it is held to
tests/test_pipeline.py's checks and to the JAX pipeline's ATE within
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
PIPELINE_ATE_VS_JAX = 0.1  # m
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
    keyframes and landmarks, stays under 0.45 m, and within
    PIPELINE_ATE_VS_JAX of the JAX pipeline's ATE."""
    s = chip_smoke.scenario(small, "pipeline")
    pipe, got, tracked = chip_smoke.run_pipeline(s, "cpu", use_clahe=False)
    est = pipe.est
    assert est.state != 0, "no initialization"
    assert est.n_keyframes >= 2, "no visual keyframes"
    assert len(est.lm_slot) >= 10, "no landmarks created"
    assert tracked == len(s["frame_t"]) - 1
    e = chip_smoke.trajectory_errors(got["traj_t"], got["traj_p"], s, chip_smoke.PIPELINE_T_MIN)
    ate = float(np.sqrt(np.mean(e**2)))
    assert ate < chip_smoke.PIPELINE_ATE, ate
    assert abs(ate - float(_ref(s)["ate_rmse"])) <= PIPELINE_ATE_VS_JAX, (ate, _ref(s)["ate_rmse"])


def _head(s, t_end):
    """The scenario's streams up to ``t_end``."""
    out = dict(s)
    for prefix, keys in (("imu_t", ("imu_t", "imu_dt", "imu_dth", "imu_dv")),
                         ("gnss_t", ("gnss_t", "gnss_p", "gnss_std")),
                         ("frame_t", ("frame_t", "frame_n"))):
        keep = s[prefix] <= t_end
        for k in keys:
            out[k] = s[k][keep]
    return out


@pytest.mark.parametrize("option", ["stat_phase_split", "host_predict_off"])
def test_estimator_options_match_jax(small, option):
    """The two phases as separate calls, and the INS prediction through
    the device mechanization instead of its numpy mirror: the same
    arithmetic as the default path, so the JAX run's first 7 s (vision
    joins at 3.6 s; 11 rounds, 6 of them with the chi2 phases)."""
    s = chip_smoke.scenario(small, "gvins")
    kw = {"stat_phase_split": {"stat_phase_split": True},
          "host_predict_off": {"host_predict": False}}[option]
    est, got = chip_smoke.run_estimator(_head(s, 7.0), "cpu", **kw)
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
def test_unported_options_raise(option):
    """Options and entry points the port does not have refuse to run
    instead of being ignored."""
    with pytest.raises(NotImplementedError):
        if option == "recenter_threshold":
            Estimator(EngineConfig(recenter_threshold=20.0), device="cpu")
        elif option == "set_mesh":
            Estimator(EngineConfig(max_nodes=4, max_landmarks=4), device="cpu").set_mesh(None)
        else:
            from ic_gvins_tpu_torch.tools import run_kaist

            run_kaist.main(["--data", "unused", "--f32", "--device", "cpu"])


def test_states_and_map_point_types_are_the_reference_ones():
    from ic_gvins_tpu.engine import drawer as jdrawer
    from ic_gvins_tpu.engine import estimator as jest

    for k in ("ERROR", "INITIALIZING", "INITIALIZING_INS", "INITIALIZING_VIO",
              "TRACKING_INITIALIZING", "TRACKING_NORMAL", "TRACKING_LOST"):
        assert getattr(port_est, k) == getattr(jest, k), k
    for k in ("NONE", "TRIANGULATED", "DEPTH_ASSOCIATED", "DEPTH_INITIALIZED", "FIXED"):
        assert getattr(port_est, f"MAPPOINT_{k}") == getattr(jdrawer, f"MAPPOINT_{k}"), k
