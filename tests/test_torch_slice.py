"""PyTorch port, the slice as a whole: the front end over a few frames and
one GVINS keyframe round (preintegrate -> triangulate -> optimize_impl ->
marginalize_and_slide), each against the JAX package; the committed
24-node x 192-landmark fixture that chip_smoke.py uses; and the rule that
the port never imports jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_solver import CLOSED, ITERATIVE, assert_rel, one_torch_thread, tiny_problem  # noqa: F401
from test_vision import random_texture, shift_image

from ic_gvins_tpu.engine.frontend import Frontend as JFrontend
from ic_gvins_tpu.vision.camera import Camera as JCamera
from ic_gvins_tpu_torch.convert import to_numpy, to_torch
from ic_gvins_tpu_torch.data.types import ImuSeq, IntegrationParams
from ic_gvins_tpu_torch.engine.frontend import Frontend
from ic_gvins_tpu_torch.engine.keyframe import preintegrate_window, triangulate_window
from ic_gvins_tpu_torch.factors.marginalization import marginalize_and_slide
from ic_gvins_tpu_torch.solver.lm import optimize_impl
from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig, Window
from ic_gvins_tpu_torch.vision.camera import Camera

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
import chip_smoke  # noqa: E402

INTR, DIST, RES = (200.0, 201.0, 80.0, 60.0), (-0.05, 0.02, 1e-4, 2e-4), (160, 120)


def _landmarks_ahead(fe):
    """lm_lookup for the full-pose seed: even ids get a world point 5 m
    along the bearing of the feature's last normalized observation."""
    def lookup(ids):
        pw = np.concatenate([fe.uv_norm, np.ones((len(ids), 1))], 1) * 5.0
        return pw, ids % 2 == 0
    return lookup


# Front-end cases: (scenario, stages switched on). The scenarios run with
# every stage off, as before; the stage cases run the "drift" frames.
FRONTEND_CASES = {
    "drift": {}, "seeded": {}, "lost": {},
    "clahe": {"use_clahe": True},
    "ransac": {"fm_ransac": True},
    "defaults": {"use_clahe": True, "fm_ransac": True},
    "histogram_gate": {"check_histogram": True},
}


@pytest.mark.parametrize("scenario", list(FRONTEND_CASES))
def test_frontend_matches_jax(scenario):
    """Four 160x120 frames drifting by a subpixel flow, 32 features, 32 px
    cells. "seeded" turns the camera by 1 mrad a frame (rotation seeds)
    and maps even ids to landmarks (full-pose seeds); in "lost" the third
    frame is black, so tracking is lost and the front end resets and
    detects anew. Ids and the lost flag must be equal; uv (normalized)
    agree to 1e-6, i.e. ~2e-4 px at this focal length, the size of the
    float32 rounding of the subpixel window sums; velocities to 1e-5 (uv
    over a 0.1 s step).

    "clahe" equalizes every frame on both sides (the equalized images
    agree to ~1e-4 grey levels, test_torch_preprocess.py, which the
    tracker turns into less than 1e-6 of uv); "ransac" culls by FM-RANSAC:
    the flow is clean, so every tracked feature is an inlier on both sides
    whatever their draws, and ids and uv agree as before; "defaults" has
    both on, as the reference runs; in "histogram_gate" the third frame
    has a quarter of the brightness, the gate rejects it on both sides and
    the previous observations come back unchanged."""
    stages = {"use_clahe": False, "fm_ransac": False, **FRONTEND_CASES[scenario]}
    jf = JFrontend(JCamera.create(INTR, DIST, RES), max_features=32, cell=32,
                   use_pallas=False, **stages)
    tf = Frontend(Camera.create(INTR, DIST, RES, device="cpu"), max_features=32, cell=32,
                  **stages)
    base = random_texture(120, 160, seed=3)
    seeded = scenario == "seeded"
    lost, outs = [], []
    for k in range(4):
        img = np.array(shift_image(base, 1.1 * k, -0.6 * k), np.float32)
        if scenario == "lost" and k == 2:
            img = np.zeros_like(img)
        if scenario == "histogram_gate" and k == 2:
            img = img * 0.25
        yaw = 1e-3 * k if seeded else 0.0
        q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
        j_ids, j_uv, j_vel = jf.process(0.1 * k, img, q_wc=q, p_wc=np.zeros(3),
                                        lm_lookup=_landmarks_ahead(jf) if seeded else None)
        t_ids, t_uv, t_vel = tf.process(0.1 * k, img, q_wc=q, p_wc=np.zeros(3),
                                        lm_lookup=_landmarks_ahead(tf) if seeded else None)
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_allclose(t_uv, j_uv, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_vel, j_vel, rtol=0, atol=1e-5)
        assert tf.track_lost == jf.track_lost
        assert tf.frame_count == jf.frame_count
        lost.append(tf.track_lost)
        outs.append((t_ids, t_uv, t_vel))
    assert len(t_ids) >= 12
    assert tf.next_id == jf.next_id
    assert any(lost) == (scenario == "lost")
    if scenario == "histogram_gate":  # frame 2 was skipped: frame 1's output again
        for a, b in zip(outs[1], outs[2]):
            np.testing.assert_array_equal(a, b)
        assert tf.frame_count == 3
    if stages["fm_ransac"]:  # nothing culled on a clean flow
        assert set(outs[1][0]) <= set(outs[3][0])


def test_frontend_defaults_are_the_reference_defaults():
    """The port's Frontend takes the JAX Frontend's stage arguments with
    the same defaults (``use_pallas`` picks a JAX backend, no stage)."""
    import inspect

    want = inspect.signature(JFrontend.__init__).parameters
    got = inspect.signature(Frontend.__init__).parameters
    assert [k for k in want if k != "use_pallas"] == list(got)
    for k, p in got.items():
        assert p.default == want[k].default, k


def test_frontend_ransac_culls_and_replays():
    """A frame pair in three parts that move by (3, 0), (0, 4) and
    (-3, -3) px, which no single epipolar geometry explains to 0.5 px:
    FM-RANSAC drops tracks that the tracker alone keeps, and the same
    frames give the same survivors again (the draws are seeded from the
    frame counter). With 14 features, fewer than the 15 the mask needs,
    nothing is culled."""
    base = random_texture(120, 160, seed=3)
    moved = np.array(shift_image(base, 3.0, 0.0), np.float32)
    moved[70:] = np.array(shift_image(base, 0.0, 4.0), np.float32)[70:]
    moved[:, 100:] = np.array(shift_image(base, -3.0, -3.0), np.float32)[:, 100:]
    runs = {}
    for name, fm, n in (("off", False, 64), ("on", True, 64), ("again", True, 64),
                        ("few_off", False, 14), ("few_on", True, 14)):
        fe = Frontend(Camera.create(INTR, DIST, RES, device="cpu"), max_features=n,
                      cell=16, use_clahe=False, fm_ransac=fm, ransac_threshold=0.5)
        fe.process(0.0, base)
        first = fe.next_id  # later ids are replenished features
        fe.process(0.1, moved)
        runs[name] = fe.ids[fe.valid & (fe.ids < first)]
    assert len(runs["on"]) < len(runs["off"])
    assert set(runs["on"]) <= set(runs["off"])
    np.testing.assert_array_equal(runs["on"], runs["again"])
    np.testing.assert_array_equal(runs["few_on"], runs["few_off"])
    assert len(runs["few_on"]) >= 8


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device given the port's entry points go to cuda:0, and
    raise when there is no card; none falls back to the CPU."""
    from ic_gvins_tpu_torch.device import resolve_device
    from ic_gvins_tpu_torch.solver.window import empty_prior, empty_window

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: resolve_device(),
        lambda: Camera.create(INTR, DIST, RES),
        lambda: to_torch(Camera, to_numpy(Camera.create(INTR, DIST, RES, device="cpu"))),
        lambda: empty_window(3, 4),
        lambda: empty_prior(3),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    assert empty_prior(3, device="cpu").H.device.type == "cpu"


def _port_round(win, prior, cfg, params, imu, iters):
    w = preintegrate_window(win, params, imu)
    w, invd, ok = triangulate_window(w)
    w_opt, stats = optimize_impl(w, prior, cfg, params, iters=iters)
    w_sl, pr = marginalize_and_slide(w_opt, prior, cfg, params)
    return w, invd, ok, w_opt, stats, w_sl, pr


@pytest.fixture(scope="module")
def rounds():
    """The port's round on _tiny_problem's window beside the JAX round's
    results stored with it (``tools/make_torch_fixture.py --tiny``:
    ``jax_keyframe_round``, 20 iterations)."""
    _, inp, want, _ = tiny_problem()
    got = _port_round(*(to_torch(t, inp[k], "cpu") for t, k in (
        (Window, "window"), (Prior, "prior"), (SolverConfig, "cfg"),
        (IntegrationParams, "params"), (ImuSeq, "imu"))), 20)
    return want, got


@pytest.mark.parametrize("stage", ["preintegrate", "triangulate", "optimize", "marginalize"])
def test_keyframe_round_matches_jax(rounds, stage):
    """One round on _tiny_problem (6 nodes x 16 landmarks, float64)."""
    want, (w, invd, ok, w_opt, (s1, s2, nc), w_sl, pr) = rounds
    if stage == "preintegrate":
        for k in ("dp", "dv", "dq", "jac", "cov", "dt", "sum_dt_pn"):
            assert_rel(getattr(w.preint, k), want["preint"][k], CLOSED, k)
    elif stage == "triangulate":
        np.testing.assert_array_equal(ok.numpy(), want["tri"]["ok"])
        m = want["tri"]["ok"]
        assert m.any()
        assert_rel(invd.numpy()[m], want["tri"]["invdepth"][m], CLOSED, "invdepth")
    elif stage == "optimize":
        opt = want["opt"]
        for ts, js in ((s1, opt["stats1"]), (s2, opt["stats2"])):
            assert (ts.iters_run, ts.accepted) == (int(js["iters_run"]), int(js["accepted"]))
            assert_rel(ts.cost1, js["cost1"], ITERATIVE, "cost")
        assert int(nc) == int(opt["n_culled"])
        for k in ("p", "q", "v", "bg", "ba"):
            assert_rel(getattr(w_opt.nodes, k), opt["nodes"][k], ITERATIVE, k)
        assert_rel(w_opt.lm_invdepth, opt["lm_invdepth"], ITERATIVE, "invdepth")
    else:
        marg = want["marg"]
        assert_rel(pr.H, marg["H"], ITERATIVE, "H")
        assert_rel(pr.g, marg["g"], ITERATIVE, "g")
        for k in ("p", "q", "v"):
            assert_rel(getattr(w_sl.nodes, k), marg["nodes"][k], ITERATIVE, k)
        np.testing.assert_array_equal(w_sl.lm_valid.numpy(), marg["lm_valid"])


def test_committed_fixture_round_on_cpu():
    """The 24 x 192 round of chip_smoke.py phase 4, here on the CPU against
    the fixture's stored JAX numbers (tools/make_torch_fixture.py)."""
    inputs, ref = chip_smoke.round_inputs(torch.device("cpu"))
    assert (inputs[0].n_nodes, inputs[0].n_landmarks) == (24, 192)
    w, invd, ok, w_opt, (s1, s2, nc), w_sl, pr = _port_round(*inputs, chip_smoke.ITERS)
    for k, v in ref["preint"].items():
        assert_rel(getattr(w.preint, k), v, CLOSED, k)
    np.testing.assert_array_equal(ok.numpy(), ref["tri"]["ok"])
    assert (s1.iters_run, s2.iters_run) == (int(ref["opt"]["stats1"]["iters_run"]),
                                            int(ref["opt"]["stats2"]["iters_run"]))
    for k, v in ref["opt"]["nodes"].items():
        assert_rel(getattr(w_opt.nodes, k), v, ITERATIVE, k)
    assert_rel(pr.H, ref["marg"]["H"], ITERATIVE, "H")
    assert_rel(pr.g, ref["marg"]["g"], ITERATIVE, "g")


def test_port_imports_no_jax():
    """Importing every module of the port (the commands under ``tools/``,
    the simulator, the native library's loader and the data, I/O and
    evaluation modules included) pulls in neither jax nor the JAX package,
    and leaves TF32 off for matmuls and convolutions."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import ic_gvins_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "need = {'engine.estimator', 'engine.pipeline', 'engine.outputs', 'engine.fileio',\n"
        "        'engine.drawer', 'data.kaist', 'data.image', 'data.rosbag', 'eval.trajectory',\n"
        "        'ins.preintegration_odo', 'tools.run_kaist', 'vision.klt_cuda', 'native',\n"
        "        'data.simulator', 'tools.sequence', 'tools.run_sim', 'tools.run_urban',\n"
        "        'common.timecost', 'common.prng', 'parallel', 'parallel.multi_seq',\n"
        "        'parallel.lm_sharded', 'parallel.schur', 'parallel.ba_nodes',\n"
        "        'tools.convert_bag', 'tools.multihost_lm'}\n"
        "missing = {f'ic_gvins_tpu_torch.{n}' for n in need} - set(names)\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ic_gvins_tpu')]\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_solver_imports_no_parallel_module():
    """The packages import in one direction: importing the LM loop (and
    with it the assembly and the collectives of ``mesh.py``) loads no
    module of ``parallel/``."""
    code = (
        "import sys\n"
        "import ic_gvins_tpu_torch.solver.lm\n"
        "assert 'ic_gvins_tpu_torch.mesh' in sys.modules\n"
        "bad = [m for m in sys.modules if m.startswith('ic_gvins_tpu_torch.parallel')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cpu_tensors_never_reach_cuda(monkeypatch):
    """On the CPU the KLT wrapper must not even load the kernel library."""
    from ic_gvins_tpu_torch.vision import klt_cuda

    def boom():
        raise AssertionError("kernel library loaded for CPU tensors")

    monkeypatch.setattr(klt_cuda, "load_library", boom)
    tf = Frontend(Camera.create(INTR, DIST, RES, device="cpu"), max_features=16, cell=32)
    base = random_texture(120, 160, seed=5)
    for k in range(2):
        tf.process(0.1 * k, np.array(shift_image(base, 0.5 * k, 0.0), np.float32))
    assert tf.valid.sum() > 0
