#!/usr/bin/env python
"""Write the estimator fixtures that the PyTorch port's ``Estimator`` and
``Pipeline`` are held against: simulated sensor streams and what the JAX
package's float64 ``Estimator`` (or ``Pipeline``) makes of them on the CPU.

Three files:

* ``tests/fixtures/torch_estimator_small.npz``: the window geometry of
  ``tests/test_estimator.py::small_cfg`` (16 nodes x 64 landmarks, 10 LM
  iterations) in that file's three scenarios (GINS 15 s, GVINS 10 s,
  GNSS outage after 6 s of 12 s), the 320 x 240 scene of
  ``tests/test_pipeline.py`` through the JAX ``Pipeline`` (frames from the
  numpy sprite renderer, so the port can render the same pixels), and
  ``odo_small``: ``tests/test_odo_window.py``'s odometer configuration (16
  nodes x 8 landmarks, 10 iterations) on 12 s of GNSS, IMU and a 50 Hz
  wheel odometer; and ``gap_native``: the GINS scenario's configuration
  with the JAX package's C++ IMU buffer, on 12 s with a 0.25 s IMU dropout
  (``run_sequence``'s ``imu_gap``; the streams stored as fed, the samples
  of the gap left out and the next one spanning it);
* ``tests/fixtures/torch_estimator_defaults.npz``: ``EngineConfig()`` (24
  nodes x 192 landmarks, 20 iterations, a 10-keyframe window) on 15 s of a
  car drive with IMU at 200 Hz, GNSS at 1 Hz and ideal tracks at 10 Hz,
  plus the truth camera poses and sprite landmarks from which
  ``chip_smoke.py`` renders 1278 x 1022 frames for the port's ``Pipeline``.
  The JAX ``Pipeline`` at that size is not run: an XLA:CPU replay of 150
  full-size frames takes far longer than the rest of the tool. Scenario
  ``defaults_native`` is the same streams through ``EngineConfig()``
  unchanged, so with the C++ IMU buffer; it stores only its configuration
  and the run (the streams are ``defaults``');
* ``tests/fixtures/torch_estimator_odo.npz``: scenario ``odo``, the
  defaults scenario's streams with GNSS dropped after 9 s plus a 50 Hz
  wheel odometer, through ``EngineConfig(odo=OdoConfig(use_odo=True))``.

The odometer scenarios also store the checkpoint the JAX run saved after
its middle event (``ckpt``, the pickle's bytes, and ``ckpt_event``).

Each scenario stores its streams, its 200 Hz truth positions, the
configuration as JSON, and the run's event log (``chip_smoke.feed``), stats
rows, trajectory and final window (``chip_smoke.summarize``). Every JAX
estimator runs with ``tests/dead_rows.clear_dead_rows``: the rows of the
landmark slots that die with a marginalized anchor are cleared, as the port
clears them (the JAX package keeps them; the count is stored as
``dead_cleared``). Each scenario
runs in its own process (an XLA:CPU process that replays several
estimators can crash its compiler), all at once.

    python tools/make_torch_estimator_fixture.py            # all files, ~5 min on 8 cores
    python tools/make_torch_estimator_fixture.py --scenario gins --out /tmp/gins.npz
"""

import argparse
import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
import chip_smoke  # noqa: E402
from dead_rows import clear_dead_rows  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SMALL = ("gins", "gvins", "outage", "pipeline", "odo_small", "gap_native")
DEFAULTS = ("defaults", "defaults_native")
ODO = ("odo",)
# Most JAX runs take their IMU slices from the Python buffer: the C++ buffer
# computes a boundary sample's dt 1 ulp apart, and at 10 Hz frames the
# keyframe test ``t - last_kf_t > track_max_interval`` (0.5 s) compares
# numbers that are equal but for such ulps. The ``*_native`` scenarios run
# the C++ buffer, which the port has too.
PY_BUFFER = dict(use_native_imu_buffer=False)
# kwargs of tests/test_estimator.py::small_cfg, C++ buffer (its default) or Python
SMALL_CFG_NATIVE = dict(optimize_num_iterations=10, max_nodes=16, max_landmarks=64,
                        optimize_windows_size=6, antlever=(0.1, -0.05, 0.2))
SMALL_CFG = dict(SMALL_CFG_NATIVE, **PY_BUFFER)
# run_sequence arguments of the three tests of tests/test_estimator.py
ESTIMATOR_SCENARIOS = {
    "gins": dict(cfg=SMALL_CFG, duration=15.0, with_vision=False, seed=0),
    "gvins": dict(cfg=SMALL_CFG, duration=10.0, with_vision=True, seed=0,
                  frame_rate=5.0, n_landmarks=64),
    "outage": dict(cfg=SMALL_CFG, duration=12.0, with_vision=True, seed=3, gnss_until=6.0,
                   frame_rate=5.0, n_landmarks=64),
    # the engine's defaults; 320 landmarks over the 18 m of road ahead keep
    # most of the 192 slots in use
    "defaults": dict(cfg=PY_BUFFER, duration=15.0, with_vision=True, seed=0, frame_rate=10.0,
                     n_landmarks=320, cam_ext=True),
    # the same streams through EngineConfig() unchanged: the C++ buffer
    "defaults_native": dict(cfg={}, duration=15.0, with_vision=True, seed=0, frame_rate=10.0,
                            n_landmarks=320, cam_ext=True, streams_of="defaults"),
    # a 0.25 s IMU dropout through the C++ buffer (tests/test_ingest.py's gap)
    "gap_native": dict(cfg=SMALL_CFG_NATIVE, duration=12.0, with_vision=False, seed=0,
                       imu_gap=(6.0, 6.25)),
    # the defaults scenario's streams, GNSS only until 9 s, and a wheel
    # odometer (tests/test_odo_window.py's scale and noise)
    "odo": dict(cfg=PY_BUFFER, odo_cfg=dict(use_odo=True), duration=15.0, with_vision=True,
                seed=0, frame_rate=10.0, n_landmarks=320, cam_ext=True, gnss_until=9.0,
                odometer=True),
}
# tests/test_odo_window.py's configuration and odometer
ODO_SMALL_CFG = dict(optimize_num_iterations=10, max_nodes=16, max_landmarks=8,
                     optimize_windows_size=8, antlever=(0.0, 0.0, 0.0), **PY_BUFFER)
ODO_SMALL_ODO = dict(use_odo=True, odo_vrw=0.03, sodo_prior_std=0.05)
ODOMETER = dict(rate=50.0, sodo_true=0.03, noise_std=0.02)
# sprite field of chip_smoke.py phase 6 (1278 x 1022 frames, focal 787)
SPRITES = dict(n=900, lateral=24.0, depth_range=(7.0, 40.0))
IMU_RATE = 200.0


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _cfg_json(cfg):
    d = dataclasses.asdict(cfg)
    base = dataclasses.asdict(type(cfg)())
    out = {k: v for k, v in d.items() if v != base[k] and k not in ("cam", "odo", "imumodel")}
    if d["cam"] != base["cam"]:
        out["cam"] = d["cam"]
    if d["odo"] != base["odo"]:
        out["odo"] = d["odo"]
    return json.dumps(out)


def _truth(traj, params, duration):
    jax = _jax()
    import jax.numpy as jnp

    from ic_gvins_tpu.data import simulator as sim

    t = np.arange(int(round((duration + 1.0) * IMU_RATE)) + 1) / IMU_RATE
    p = jax.jit(jax.vmap(lambda tt: sim.truth_state(traj, params, tt).p))(jnp.asarray(t))
    return {"truth_t": t, "truth_p": np.asarray(p)}


def _imu_streams(imu, gap=None):
    """The IMU samples as ``run_sequence`` feeds them: without the zero
    seed, and with ``gap`` = (t0, t1) the samples in (t0, t1] left out and
    the next one's increments and dt scaled to span the gap."""
    keep = np.asarray(imu.dt) != 0.0
    t, dt = np.asarray(imu.time)[keep], np.asarray(imu.dt)[keep]
    dth, dv = np.asarray(imu.dtheta)[keep], np.asarray(imu.dvel)[keep]
    if gap is not None:
        k = int(np.argmax(t > gap[1]))  # the first sample after the gap
        span = t[k] - t[t <= gap[0]][-1]  # since the last sample before it
        dth, dv, dt = dth.copy(), dv.copy(), dt.copy()
        dth[k], dv[k], dt[k] = dth[k] * (span / dt[k]), dv[k] * (span / dt[k]), span
        keep = ~((gap[0] < t) & (t <= gap[1]))
        t, dt, dth, dv = t[keep], dt[keep], dth[keep], dv[keep]
    return {"imu_t": t, "imu_dt": dt, "imu_dth": dth, "imu_dv": dv}


def _cam_poses(traj, params, times, ext_p, ext_q):
    jax = _jax()
    import jax.numpy as jnp

    from ic_gvins_tpu.common import rotation as rot
    from ic_gvins_tpu.data import simulator as sim

    def pose(t):
        s = sim.truth_state(traj, params, t)
        return s.p + rot.quat_rotate(s.q, ext_p), rot.quat_mul(s.q, ext_q)

    t_wc, q_wc = jax.jit(jax.vmap(pose))(jnp.asarray(times))
    return {"cam_t_wc": np.asarray(t_wc), "cam_q_wc": np.asarray(q_wc)}


def estimator_scenario(name):
    """Streams of one scenario of ``tests/test_estimator.py::run_sequence``
    (the same keys and draws), and the JAX ``Estimator`` run on them."""
    jax = _jax()
    import jax.numpy as jnp

    from ic_gvins_tpu.common import rotation as rot
    from ic_gvins_tpu.data import simulator as sim
    from ic_gvins_tpu.engine import config as jconfig
    from ic_gvins_tpu.engine.estimator import Estimator

    sc = ESTIMATOR_SCENARIOS[name]
    cfg = jconfig.EngineConfig(**sc["cfg"])
    if "odo_cfg" in sc:
        cfg.odo = jconfig.OdoConfig(**sc["odo_cfg"])
    duration, seed = sc["duration"], sc["seed"]
    params = sim.default_params(with_earth=cfg.iswithearth, lat_deg=cfg.track_ref_lat_deg)
    traj = sim.car_trajectory()
    key = jax.random.PRNGKey(seed)
    k_imu, k_gnss, k_lm, k_px = jax.random.split(key, 4)
    imu = sim.simulate_imu(traj, params, 0.0, duration, IMU_RATE)
    imu = sim.corrupt_imu(imu, params, k_imu, jnp.array([2e-4, -1e-4, 3e-4]),
                          jnp.array([5e-3, -8e-3, 2e-3]))
    gnss = sim.simulate_gnss(traj, params, jnp.asarray(cfg.antlever), 0.0, duration, 1.0,
                             std=0.05, key=k_gnss)
    gt = np.asarray(gnss.time)
    keep = gt <= sc.get("gnss_until", np.inf)
    s = {"cfg_json": np.array(_cfg_json(cfg)), **_imu_streams(imu, sc.get("imu_gap")),
         "gnss_t": gt[keep], "gnss_p": np.asarray(gnss.p)[keep],
         "gnss_std": np.asarray(gnss.std)[keep], **_truth(traj, params, duration)}
    if sc.get("odometer"):
        s.update(_odometer(traj, params, duration, jax.random.fold_in(key, 7)))
    s["frame_t"] = np.zeros(0)
    if sc["with_vision"]:
        if sc.get("cam_ext"):  # the configured camera
            ext_q = jnp.asarray(cfg.cam.q_b_c) / np.linalg.norm(cfg.cam.q_b_c)
            ext_p = jnp.asarray(cfg.cam.t_b_c)
        else:  # run_sequence's camera, set on the window after construction
            ext_q = rot.matrix_to_quat(
                jnp.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
            ext_p = jnp.array([0.1, 0.0, -0.05])
            s["ext_p"], s["ext_q"] = np.asarray(ext_p), np.asarray(ext_q)
        n_frames = int(duration * sc["frame_rate"])
        ftimes = (jnp.arange(n_frames) + 1) / sc["frame_rate"]
        lms = sim.scatter_landmarks(traj, params, k_lm, sc["n_landmarks"], 0.0, duration + 3.0)
        uv, vis = sim.project_landmarks(traj, params, lms, ftimes, ext_p, ext_q,
                                        noise_std=0.5 / 780.0, key=k_px)
        uv, vis = np.asarray(uv), np.asarray(vis)
        ids = [np.nonzero(vis[:, j])[0] for j in range(n_frames)]
        s.update(frame_t=np.asarray(ftimes, np.float64),
                 frame_n=np.array([len(i) for i in ids]),
                 frame_ids=np.concatenate(ids),
                 frame_uv=np.concatenate([uv[i, j] for j, i in enumerate(ids)]))
        if name == "defaults":
            sprites = sim.scatter_landmarks(
                traj, params, jax.random.fold_in(key, 11), SPRITES["n"], 0.0, duration + 3.0,
                lateral=SPRITES["lateral"], depth_range=SPRITES["depth_range"])
            s["sprites"] = np.asarray(sprites)
            s.update(_cam_poses(traj, params, ftimes, ext_p, ext_q))

    est = clear_dead_rows(Estimator(cfg))
    if "ext_p" in s:
        est.window = est.window._replace(ext_p=jnp.asarray(s["ext_p"]),
                                         ext_q=jnp.asarray(s["ext_q"]))

    def on_frame(j):
        est.add_frame_observations(*chip_smoke.observations(s, j))

    return s, _run(est, s, on_frame)


def _odometer(traj, params, duration, key):
    from ic_gvins_tpu.data import simulator as sim

    t, v = sim.simulate_odometer(traj, params, 0.0, duration, ODOMETER["rate"],
                                 sodo_true=ODOMETER["sodo_true"],
                                 noise_std=ODOMETER["noise_std"], key=key)
    return {"odo_t": np.asarray(t), "odo_v": np.asarray(v)}


class _NoJax(pickle.Unpickler):
    """Loads a checkpoint only if it holds no object of JAX."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(f"checkpoint holds {module}.{name}")
        return super().find_class(module, name)


def _run(est, s, on_frame):
    """Feed the JAX estimator the scenario; an odometer scenario also
    saves the checkpoint after its middle event."""
    extra = {}
    on_event = None
    if "odo_t" in s:
        n_events = sum(kind in ("gnss", "frame") for kind, _ in chip_smoke.schedule(s))
        ck = n_events // 2
        path = os.path.join(tempfile.mkdtemp(prefix="ckpt_"), "ckpt.pkl")

        def on_event(e):
            if e == ck:
                est.save_checkpoint(path)

    log = chip_smoke.feed(est, est, s, on_frame, on_event=on_event)
    if on_event is not None:
        with open(path, "rb") as f:
            raw = f.read()
        _NoJax(io.BytesIO(raw)).load()
        extra = {"ckpt": np.frombuffer(raw, np.uint8), "ckpt_event": np.int64(ck),
                 "sodo": np.float64(est.window.sodo)}
    return {**log, **chip_smoke.summarize(est), **extra}


def odo_small_scenario():
    """``tests/test_odo_window.py::_run_gins_odo``'s streams and
    configuration over 12 s (the same keys and draws)."""
    jax = _jax()
    import jax.numpy as jnp

    from ic_gvins_tpu.data import simulator as sim
    from ic_gvins_tpu.engine import config as jconfig
    from ic_gvins_tpu.engine.estimator import Estimator

    duration = 12.0
    cfg = jconfig.EngineConfig(**ODO_SMALL_CFG, odo=jconfig.OdoConfig(**ODO_SMALL_ODO))
    params = sim.default_params(with_earth=True, lat_deg=cfg.track_ref_lat_deg)
    traj = sim.car_trajectory(speed=5.0)
    ki, kg, ko = jax.random.split(jax.random.PRNGKey(0), 3)
    imu = sim.simulate_imu(traj, params, 0.0, duration, IMU_RATE)
    imu = sim.corrupt_imu(imu, params, ki, jnp.array([2e-4, -1e-4, 3e-4]),
                          jnp.array([5e-3, -8e-3, 2e-3]))
    gnss = sim.simulate_gnss(traj, params, jnp.zeros(3), 0.0, duration, 1.0, std=0.05, key=kg)
    s = {"cfg_json": np.array(_cfg_json(cfg)), **_imu_streams(imu),
         "gnss_t": np.asarray(gnss.time), "gnss_p": np.asarray(gnss.p),
         "gnss_std": np.asarray(gnss.std), "frame_t": np.zeros(0),
         **_odometer(traj, params, duration, ko), **_truth(traj, params, duration)}
    est = clear_dead_rows(Estimator(cfg))
    return s, _run(est, s, None)


def pipeline_scenario():
    """``tests/test_pipeline.py``'s scene (320 x 240, 8 s, frames at 5 Hz
    from 0.4 s) through the JAX ``Pipeline``, frames from the numpy
    sprite renderer."""
    jax = _jax()
    import jax.numpy as jnp

    from ic_gvins_tpu.common import rotation as rot
    from ic_gvins_tpu.data import simulator as sim
    from ic_gvins_tpu.engine.config import CameraConfig, EngineConfig
    from ic_gvins_tpu.engine.pipeline import Pipeline

    res, intr = (320, 240), (240.0, 240.0, 160.0, 120.0)
    ext_q = rot.matrix_to_quat(jnp.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    cfg = EngineConfig(
        optimize_num_iterations=8, max_nodes=16, max_landmarks=64, optimize_windows_size=6,
        track_max_features=60, track_min_parallax=12.0, antlever=(0.0, 0.0, 0.0),
        **PY_BUFFER,
        cam=CameraConfig(intrinsic=intr, distortion=(0.0, 0.0, 0.0, 0.0), resolution=res,
                         q_b_c=tuple(float(x) for x in np.asarray(ext_q)),
                         t_b_c=(0.0, 0.0, 0.0)),
    )
    params = sim.default_params(with_earth=True, lat_deg=cfg.track_ref_lat_deg)
    traj = sim.car_trajectory(speed=5.0)
    duration = 8.0
    kl, ki, kg = jax.random.split(jax.random.PRNGKey(0), 3)
    lms = sim.scatter_landmarks(traj, params, kl, 140, 0.0, duration + 4.0,
                                lateral=24.0, depth_range=(7.0, 40.0))
    imu = sim.simulate_imu(traj, params, 0.0, duration, IMU_RATE)
    imu = sim.corrupt_imu(imu, params, ki, jnp.array([2e-4, -1e-4, 3e-4]),
                          jnp.array([5e-3, -8e-3, 2e-3]))
    gnss = sim.simulate_gnss(traj, params, jnp.zeros(3), 0.0, duration, 1.0, std=0.05, key=kg)
    # test_pipeline.py's frame clock: 0.4 s, then += 0.2 s while IMU lasts
    ftimes, nf = [], 0.4
    while nf <= float(imu.time[-1]):
        ftimes.append(nf)
        nf += 0.2
    ftimes = np.asarray(ftimes)
    s = {"cfg_json": np.array(_cfg_json(cfg)), **_imu_streams(imu),
         "gnss_t": np.asarray(gnss.time), "gnss_p": np.asarray(gnss.p),
         "gnss_std": np.asarray(gnss.std), "frame_t": ftimes, "sprites": np.asarray(lms),
         **_truth(traj, params, duration),
         **_cam_poses(traj, params, ftimes, jnp.zeros(3), ext_q / jnp.linalg.norm(ext_q))}

    pipe = Pipeline(cfg, use_pallas=False, use_clahe=False)
    clear_dead_rows(pipe.est)

    def on_frame(j):
        img = sim.render_sprite_frame_np(intr, res, s["sprites"], s["cam_t_wc"][j],
                                         s["cam_q_wc"][j])
        pipe.add_image(float(ftimes[j]), img)

    log = chip_smoke.feed(pipe, pipe.est, s, on_frame)
    return s, {**log, **chip_smoke.summarize(pipe.est)}


# the JAX tests' ATE windows: errors after t_min (s)
ATE = {"gins": 5.0, "gvins": 5.0, "outage": 10.0, "pipeline": 4.0, "defaults": 5.0,
       "odo_small": 5.0, "odo": 5.0, "defaults_native": 5.0, "gap_native": 5.0}


def run_one(name, out):
    make = {"pipeline": pipeline_scenario, "odo_small": odo_small_scenario}
    s, o = make[name]() if name in make else estimator_scenario(name)
    e = chip_smoke.trajectory_errors(o["traj_t"], o["traj_p"], s, ATE[name])
    o["ate_rmse"], o["err_max"] = np.sqrt(np.mean(e**2)), np.max(e)
    if "streams_of" in ESTIMATOR_SCENARIOS.get(name, {}):  # the streams are stored once
        s = {"cfg_json": s["cfg_json"]}
    np.savez_compressed(out, **s, **{f"out/{k}": v for k, v in o.items()})
    print(f"{name}: {len(o['stats'])} rounds, {int(o['log'][-1, 2])} keyframes, "
          f"peak landmark slots {int(o['log'][:, 3].max())}, final state "
          f"{int(o['log'][-1, 0])}, ATE {float(o['ate_rmse']):.4f} m, "
          f"max {float(o['err_max']):.4f} m", flush=True)


FILES = (("torch_estimator_small.npz", SMALL), ("torch_estimator_defaults.npz", DEFAULTS),
         ("torch_estimator_odo.npz", ODO))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=SMALL + DEFAULTS + ODO)
    ap.add_argument("--out")
    ap.add_argument("--only", nargs="+", choices=SMALL + DEFAULTS + ODO,
                    help="rerun these scenarios; the files keep the others'")
    args = ap.parse_args()
    if args.scenario:
        run_one(args.scenario, args.out)
        return
    names = args.only or SMALL + DEFAULTS + ODO
    work = tempfile.mkdtemp(prefix="estimator_fixture_")
    procs = {n: subprocess.Popen([sys.executable, __file__, "--scenario", n, "--out",
                                  os.path.join(work, n + ".npz")])
             for n in names}
    bad = [n for n, p in procs.items() if p.wait() != 0]
    if bad:
        raise SystemExit(f"scenarios failed: {bad}")
    for fname, in_file in FILES:
        rerun = [n for n in in_file if n in names]
        if not rerun:
            continue
        path = os.path.join(FIXTURES, fname)
        merged = {}
        if os.path.exists(path):
            with np.load(path) as z:
                merged = {k: z[k] for k in z.files if k.split("/")[0] not in rerun}
        for n in rerun:
            with np.load(os.path.join(work, n + ".npz")) as z:
                merged.update({f"{n}/{k}": z[k] for k in z.files})
        np.savez_compressed(path, **merged)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
