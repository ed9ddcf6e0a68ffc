"""PyTorch port, the simulation tools: ``tools/sequence.py`` (the port's
``run_sequence``, ``small_cfg``, ``ate``), the commands ``tools/run_sim.py``
and ``tools/run_urban.py``, and ``common/timecost.py``.

With the JAX package's ``jax.random`` draws passed in, ``make_streams``
returns the streams stored in ``tests/fixtures/torch_estimator_small.npz``
(time grids and frame ids exactly, values within SIM_RTOL of each array's
largest entry); ``run_sequence`` feeds them as the JAX tests' helper
does, dropout and outage windows included. ``run_urban --gen`` writes the
JAX file's keys, shapes and dtypes and its deterministic parts; the
port's replay of the JAX-written drive in ``tests/fixtures/torch_urban90.npz``
(``tools/make_torch_sim_fixture.py``), cut to its first 20 s, stays within
URBAN_ATE."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from test_torch_solver import one_torch_thread  # noqa: E402, F401

from ic_gvins_tpu_torch.common import timecost  # noqa: E402
from ic_gvins_tpu_torch.engine import config as tconfig  # noqa: E402
from ic_gvins_tpu_torch.engine import estimator as test  # noqa: E402
from ic_gvins_tpu_torch.tools import run_sim, run_urban, sequence  # noqa: E402

SMALL = os.path.join(ROOT, "tests", "fixtures", "torch_estimator_small.npz")
URBAN90 = os.path.join(ROOT, "tests", "fixtures", "torch_urban90.npz")
SIM_RTOL = chip_smoke.SIM_RTOL
# the port's replay of the JAX-written 20 s urban drive at reduced width
# (40 features, 64 landmarks, 12 iterations), RMS of the errors after 10 s
# (0.368 m on the CPU; the port at full width on these streams: 0.345 m)
URBAN_ATE = 0.6  # m
# the JAX tests' scenarios (tests/test_estimator.py), as the fixture tool runs them
SCENARIOS = {"gins": dict(duration=15.0, with_vision=False, seed=0),
             "gvins": dict(duration=10.0, with_vision=True, seed=0, frame_rate=5.0,
                           n_landmarks=64),
             "outage": dict(duration=12.0, with_vision=True, seed=3, frame_rate=5.0,
                            n_landmarks=64)}


def jax_draws(seed, duration, with_vision=False, frame_rate=10.0, n_landmarks=96,
              imu_rate=200.0):
    """The draws of tests/test_estimator.py::run_sequence, stream by stream."""
    key = jax.random.PRNGKey(seed)
    k_imu, k_gnss, k_lm, k_px = jax.random.split(key, 4)
    kg, ka = jax.random.split(k_imu)
    n_imu, n_gnss = int(round(duration * imu_rate)) + 1, int(round(duration)) + 1
    d = {"imu": (jax.random.normal(kg, (n_imu, 3)), jax.random.normal(ka, (n_imu, 3))),
         "gnss": jax.random.normal(k_gnss, (n_gnss, 3))}
    if with_vision:
        t1, n_frames = duration + 3.0, int(duration * frame_rate)
        kt, kd, ko = jax.random.split(k_lm, 3)
        d["landmarks"] = (jax.random.uniform(kt, (n_landmarks,), minval=0.0, maxval=t1),
                          jax.random.uniform(kd, (n_landmarks,), minval=8.0, maxval=60.0),
                          jax.random.uniform(ko, (n_landmarks, 2), minval=-30.0, maxval=30.0))
        d["pixels"] = jax.random.normal(k_px, (n_landmarks, n_frames, 2))
    return {k: tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v)
            for k, v in d.items()}


@pytest.fixture(scope="module")
def small():
    return dict(np.load(SMALL))


class Recorder:
    """An ``Estimator`` stand-in that records what ``run_sequence`` feeds."""

    def __init__(self, cfg, device=None, dtype=torch.float64):
        self.cfg, self.device, self.calls = cfg, torch.device(device), []
        self.window = test.Estimator(cfg, device=device, dtype=dtype).window

    def add_imu(self, *a):
        self.calls.append(("imu", *a))

    def add_gnss(self, *a):
        self.calls.append(("gnss", *a))

    def add_frame_observations(self, *a):
        self.calls.append(("frame", *a))

    def add_odo(self, *a):
        self.calls.append(("odo", *a))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_streams_match_fixture(small, name):
    """make_streams with the JAX draws: the fixture's IMU, GNSS and tracks."""
    s = chip_smoke.scenario(small, name)
    kw = SCENARIOS[name]
    cfg = chip_smoke.engine_config(tconfig, s)
    draws = jax_draws(kw["seed"], kw["duration"], kw["with_vision"], kw.get("frame_rate", 10.0),
                      kw.get("n_landmarks", 96))
    st = sequence.make_streams(cfg, device="cpu", draws=draws, **kw)
    imu = st["imu"]
    keep = imu.dt.numpy() != 0.0
    assert np.array_equal(imu.time.numpy()[keep], s["imu_t"])
    assert np.array_equal(imu.dt.numpy()[keep], s["imu_dt"])
    for k, x in (("imu_dth", imu.dtheta), ("imu_dv", imu.dvel)):
        assert chip_smoke.rel_err(s[k], x.numpy()[keep]) <= SIM_RTOL, k
    n = len(s["gnss_t"])
    assert np.array_equal(st["gnss"].time.numpy()[:n], s["gnss_t"])
    assert chip_smoke.rel_err(s["gnss_p"], st["gnss"].p.numpy()[:n]) <= SIM_RTOL
    if kw["with_vision"]:
        assert np.array_equal([f[0] for f in st["frames"]], s["frame_t"])
        assert np.array_equal(np.concatenate([f[1] for f in st["frames"]]), s["frame_ids"])
        uv = np.concatenate([f[2] for f in st["frames"]])
        assert chip_smoke.rel_err(s["frame_uv"], uv) <= SIM_RTOL
        assert np.array_equal(st["cam"][0].numpy(), s["ext_p"])


def test_run_sequence_feeds_gap_and_outages(small, monkeypatch):
    """The dropout is left out and the next sample spans it (the fixture's
    gap_native streams); fixes only until gnss_until and outside the
    outage; a mesh reaches Estimator.set_mesh, which refuses one whose
    shards do not divide the landmark capacity."""
    monkeypatch.setattr(sequence, "Estimator", Recorder)
    s = chip_smoke.scenario(small, "gap_native")
    cfg = chip_smoke.engine_config(tconfig, s)
    rec, _, _ = sequence.run_sequence(cfg, duration=12.0, imu_gap=(6.0, 6.25),
                                      gnss_outage=(3.0, 5.0), gnss_until=9.0, device="cpu",
                                      draws=jax_draws(0, 12.0))
    imu = np.array([c[1:3] for c in rec.calls if c[0] == "imu"])
    assert np.array_equal(imu[:, 0], s["imu_t"]) and np.array_equal(imu[:, 1], s["imu_dt"])
    dth = np.stack([c[3] for c in rec.calls if c[0] == "imu"])
    assert chip_smoke.rel_err(s["imu_dth"], dth) <= SIM_RTOL
    fixes = [c[1] for c in rec.calls if c[0] == "gnss"]
    assert fixes == [t for t in s["gnss_t"] if t <= 9.0 and not 3.0 <= t < 5.0]
    monkeypatch.undo()
    from ic_gvins_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="must divide"):
        sequence.run_sequence(cfg, duration=1.0, mesh=Mesh({"lm": 7}, device="cpu"),
                              device="cpu")


def test_ate_matches_jax():
    """The port's ate() against the JAX tests' ate() on one trajectory."""
    from ic_gvins_tpu.data import simulator as jsim
    from ic_gvins_tpu_torch.data import simulator as tsim
    from test_estimator import ate as jate

    class Traj:
        def __init__(self, t, p):
            self.t, self.p = t, p

        def trajectory(self):
            return self.t, self.p, np.zeros((len(self.t), 4))

    t = np.arange(1.0, 9.0, 1.5)
    p = np.stack([8.0 * t, 0.1 * np.sin(t), 0.02 * t], 1)
    est = Traj(t, p)
    got = sequence.ate(est, tsim.car_trajectory(), tsim.default_params(device="cpu"), t_min=2.0)
    ref = jate(est, jsim.car_trajectory(), jsim.default_params(), t_min=2.0)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_run_sim_end_to_end(tmp_path):
    """GINS for 6 s: the JSON line, the reference-format files, an ATE at
    the GNSS noise level; with --f32 the engine runs in float32 (the line
    says so) at the same bound."""
    res = run_sim.main(["--duration", "6", "--device", "cpu", "--out", str(tmp_path)])
    assert set(res) == {"ate_rmse_m", "ate_max_m", "nodes_processed", "wall_s", "nodes_per_s",
                        "state", "outdir"}
    assert res["state"] == test.INITIALIZING_INS and res["nodes_processed"] >= 3
    assert res["ate_rmse_m"] < 0.13  # tests/test_estimator.py's GINS bound
    for name in ("gvins.nav", "trajectory.csv", "statistics.txt", "extrinsic.txt"):
        assert os.path.getsize(tmp_path / name) > 0
    res = run_sim.main(["--f32", "--duration", "6", "--device", "cpu", "--out",
                        str(tmp_path / "f32")])
    assert res["dtype"] == "float32" and res["n_recenters"] == 0
    assert res["state"] == test.INITIALIZING_INS and res["ate_rmse_m"] < 0.13


def test_run_sim_honours_config_runner_keys(tmp_path, monkeypatch):
    """--config: the engine keys, the GNSS outage and the output path."""
    out = tmp_path / "from_yaml"
    cfg_path = tmp_path / "gvins.yaml"
    cfg_path.write_text(f"isusegnssoutage: true\ngnssoutagetime: 4.0\noutputpath: {out}\n"
                        "optimize_num_iterations: 6\n")
    seen = {}

    def fake(cfg, **kw):
        seen.update(cfg=cfg, **kw)
        raise StopIteration

    monkeypatch.setattr(sequence, "run_sequence", fake)
    with pytest.raises(StopIteration):
        run_sim.main(["--config", str(cfg_path), "--device", "cpu"])
    assert seen["gnss_until"] == 4.0 and seen["cfg"].optimize_num_iterations == 6
    assert (seen["cfg"].max_nodes, seen["cfg"].max_landmarks) == (16, 64)


def test_run_urban_gen_matches_jax_file(tmp_path):
    """--gen: the JAX-written file's keys, shapes and dtypes; its route,
    time grids, truth poses and camera exactly or to rounding."""
    ref = {k: v for k, v in np.load(URBAN90).items() if not k.startswith("jax/")}
    info = run_urban.main(["--gen", "--duration", "90", "--device", "cpu", "--out",
                           str(tmp_path)])
    assert info["bytes"] == os.path.getsize(tmp_path / "sensors.npz")
    got = dict(np.load(tmp_path / "sensors.npz"))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    for k in ("imu_time", "imu_dt", "gnss_time", "gnss_std", "frame_times", "bin_dt", "ext_q",
              "route_length", "route_time"):
        assert np.array_equal(got[k], ref[k]), k
    for k in ("frame_p", "frame_q", "frame_qwc"):
        assert chip_smoke.rel_err(ref[k], got[k]) <= SIM_RTOL, k
    # the noise is the port's own: same scale, other draws
    dn = got["gnss_p"] - ref["gnss_p"]
    assert 0.05 < dn.std() < 0.6 and not np.allclose(got["imu_dvel"], ref["imu_dvel"])


def test_run_urban_replays_jax_drive(tmp_path):
    """The JAX-written drive cut to 20 s through the port's Pipeline at
    reduced width: every output, the ATE bound, a checkpoint that loads,
    no re-centering in float64; then its first 3 s with --f32, whose
    result says the engine ran in float32."""
    full = {k: v for k, v in np.load(URBAN90).items() if not k.startswith("jax/")}

    def cut(t_end, path):
        out = dict(full)
        for prefix, t in (("imu_", "imu_time"), ("gnss_", "gnss_time"),
                          ("frame_", "frame_times")):
            keep = full[t] <= t_end
            out.update({k: v[keep] for k, v in full.items() if k.startswith(prefix)})
        np.savez(path, **out)
        return out

    sensors = tmp_path / "sensors.npz"
    ref = cut(20.0, sensors)
    res = run_urban.main(["--duration", "20", "--features", "40", "--max-landmarks", "64",
                          "--checkpoint-every", "15", "--device", "cpu",
                          "--sensors", str(sensors), "--out", str(tmp_path)])
    assert not res["partial"] and res["n_recenters"] == 0 and res["frames"] == 198
    assert res["mode"] == "f64"
    assert res["ate_rmse_m"] < URBAN_ATE, res["ate_rmse_m"]
    with open(tmp_path / "result.json") as f:
        assert json.load(f)["ate_rmse_m"] == res["ate_rmse_m"]
    assert set(np.load(tmp_path / "trajectory.npz").files) == {"times", "errs", "est_p",
                                                               "est_t"}
    est = test.Estimator(run_urban.urban_config(run_urban.build_parser().parse_args(
        ["--max-landmarks", "64", "--features", "40"]), ref["ext_q"]), device="cpu")
    est.load_checkpoint(str(tmp_path / "ckpt.npz"))
    assert est.state >= test.TRACKING_INITIALIZING and est.n_nodes > 0
    cut(3.0, tmp_path / "sensors3.npz")
    res = run_urban.main(["--f32", "--duration", "3", "--features", "40", "--max-landmarks",
                          "64", "--device", "cpu", "--sensors", str(tmp_path / "sensors3.npz"),
                          "--out", str(tmp_path / "f32")])
    assert res["mode"] == "f32" and not res["partial"] and res["frames"] == 28


def test_timecost(tmp_path):
    """The stopwatch, the synchronized timer, and a profiler trace written."""
    tc = timecost.TimeCost()
    assert tc.costms() >= 0.0
    tc.restart()
    assert timecost.device_time(lambda: sum(range(100)), iters=3, warmup=1) >= 0.0
    with timecost.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0
