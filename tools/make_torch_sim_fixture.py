#!/usr/bin/env python
"""Write ``tests/fixtures/torch_sim.npz`` and ``torch_urban90.npz``.

``torch_sim.npz`` holds what the JAX package's simulator
(``ic_gvins_tpu/data/simulator.py``) makes of three short stretches, in
float64 on the CPU, with the random draws it used, so that the PyTorch
port's simulator can be held against it with the same draws passed in
(``tests/test_torch_simulator.py``, ``chip_smoke.py`` phase 8).

* ``car``: ``car_trajectory()`` from 3 s to 5 s, IMU at 200 Hz;
* ``urban_start``: the urban route of seed 3 (``urban_route(seed=3)``, the
  route of ``tools/run_urban.py``) from 6 s to 10 s, IMU at 100 Hz: the end
  of the initial dwell, the junction at 8 s and the start of the ramp;
* ``urban_arc``: the same route around its first arc, from 2 s before its
  first junction to 2 s after its second, IMU at 100 Hz.

Each stretch stores its specification (``spec``, JSON), the clean IMU, the
standard normal draws and the corrupted IMU (``corrupt_imu``), the truth
states at the frame times, GNSS fixes with their draws, odometer samples
with theirs, landmarks with their uniforms, their projections with the
pixel draws, and one 320 x 240 frame of ``render_sprite_frame`` (the
full-frame renderer) at the first frame's camera pose. ``route/`` holds
the arrays of the whole seed-3 route.

``torch_urban90.npz`` is the ``sensors.npz`` that the JAX package's
``tools/run_urban.py --gen --duration 90`` writes (seed 3: the first 90 s
of the drive of its 2154 s runs, with its draws), and under ``jax/`` what
its f64 replay of that file with ``--outages 60 75 --checkpoint-every 60``
reports (``result.json``'s numbers, ``trajectory.npz``'s arrays). The
port's ``run_urban`` replays the file in ``chip_smoke.py`` phase 8 and,
cut to 20 s, in ``tests/test_torch_sim_tools.py``.

    python tools/make_torch_sim_fixture.py        # ~30 min on the CPU (the replay)
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_sim.npz")
URBAN_OUT = os.path.join(ROOT, "tests", "fixtures", "torch_urban90.npz")
# the JAX-written urban drive and the flags of its replay
URBAN_S = 90.0
URBAN_REPLAY = ["--outages", "60", "75", "--checkpoint-every", "60"]

# shared by every stretch: run_sequence's biases and camera (rotation
# matrix, position), run_urban's frame
BASE = dict(bg=(2e-4, -1e-4, 3e-4), ba=(5e-3, -8e-3, 2e-3),
            cam_r=((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)), cam_p=(0.1, 0.0, -0.05),
            res=(320, 240), intr=(240.0, 240.0, 160.0, 120.0), gnss_rate=5.0, gnss_std=0.05,
            antlever=(0.1, -0.05, 0.2), odo_rate=50.0, sodo_true=0.03, odo_noise=0.02,
            n_landmarks=48, lateral=30.0, depth_range=(8.0, 60.0), frame_rate=10.0,
            px_noise=0.5 / 780.0)


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def specs(route):
    """The three stretches' specifications (JSON-able dicts)."""
    kind, t0, dur = (np.asarray(x) for x in (route.kind, route.t0, route.dur))
    i = int(np.argmax(kind == 1))  # the first arc
    arc_t0 = float(np.floor((t0[i] - 2.0) * 10.0) / 10.0)
    arc_dur = float(np.ceil((dur[i] + 4.0) * 10.0) / 10.0)
    return {
        "car": dict(BASE, traj="car", t0=3.0, duration=2.0, imu_rate=200.0, seed=5),
        "urban_start": dict(BASE, traj="urban", t0=6.0, duration=4.0, imu_rate=100.0, seed=6),
        "urban_arc": dict(BASE, traj="urban", t0=arc_t0, duration=arc_dur, imu_rate=100.0,
                          seed=7),
    }


def stretch(sp, traj, params):
    """One stretch through the JAX simulator: a dict of numpy arrays."""
    jax = _jax()
    import jax.numpy as jnp

    from ic_gvins_tpu.common import rotation as rot
    from ic_gvins_tpu.data import simulator as sim

    t0, dur = sp["t0"], sp["duration"]
    k_imu, k_gnss, k_odo, k_lm, k_px = jax.random.split(jax.random.PRNGKey(sp["seed"]), 5)
    out = {}
    imu = sim.simulate_imu(traj, params, t0, dur, sp["imu_rate"])
    # corrupt_imu's own draws: a split of its key, standard normals
    kg, ka = jax.random.split(k_imu)
    out["noise_g"] = np.asarray(jax.random.normal(kg, imu.dtheta.shape))
    out["noise_a"] = np.asarray(jax.random.normal(ka, imu.dvel.shape))
    bad = sim.corrupt_imu(imu, params, k_imu, jnp.asarray(sp["bg"]), jnp.asarray(sp["ba"]))
    out.update(imu_time=imu.time, imu_dt=imu.dt, imu_dtheta=imu.dtheta, imu_dvel=imu.dvel,
               imu_dtheta_c=bad.dtheta, imu_dvel_c=bad.dvel)

    gnss = sim.simulate_gnss(traj, params, jnp.asarray(sp["antlever"]), t0, dur,
                             sp["gnss_rate"], std=sp["gnss_std"], key=k_gnss)
    out.update(gnss_time=gnss.time, gnss_p=gnss.p,
               gnss_noise=jax.random.normal(k_gnss, gnss.p.shape))
    odo_t, odo_v = sim.simulate_odometer(traj, params, t0, dur, sp["odo_rate"],
                                         sodo_true=sp["sodo_true"],
                                         noise_std=sp["odo_noise"], key=k_odo)
    out.update(odo_t=odo_t, odo_v=odo_v, odo_noise=jax.random.normal(k_odo, odo_v.shape))

    n, t1 = sp["n_landmarks"], t0 + dur + 3.0
    lms = sim.scatter_landmarks(traj, params, k_lm, n, t0, t1, lateral=sp["lateral"],
                                depth_range=tuple(sp["depth_range"]))
    kt, kd, ko = jax.random.split(k_lm, 3)  # scatter_landmarks' own draws
    out.update(landmarks=lms,
               lm_ts=jax.random.uniform(kt, (n,), minval=t0, maxval=t1),
               lm_depth=jax.random.uniform(kd, (n,), minval=sp["depth_range"][0],
                                           maxval=sp["depth_range"][1]),
               lm_off=jax.random.uniform(ko, (n, 2), minval=-sp["lateral"],
                                         maxval=sp["lateral"]))
    n_frames = int(dur * sp["frame_rate"])
    ftimes = t0 + (jnp.arange(n_frames) + 1) / sp["frame_rate"]
    ext_q = rot.matrix_to_quat(jnp.asarray(sp["cam_r"]))
    ext_p = jnp.asarray(sp["cam_p"])
    uv, vis = sim.project_landmarks(traj, params, lms, ftimes, ext_p, ext_q,
                                    noise_std=sp["px_noise"], key=k_px)
    out.update(frame_t=ftimes, uv=uv, vis=vis, px_noise=jax.random.normal(k_px, uv.shape))
    st = jax.vmap(lambda t: sim.truth_state(traj, params, t))(ftimes)
    out.update(truth_p=st.p, truth_q=st.q, truth_v=st.v)
    # the full-frame renderer at the first frame's camera pose
    t_wc = st.p[0] + rot.quat_rotate(st.q[0], ext_p)
    q_wc = rot.quat_mul(st.q[0], ext_q)
    out.update(render_t_wc=t_wc, render_q_wc=q_wc,
               frame=sim.render_sprite_frame(tuple(sp["intr"]), tuple(sp["res"]), lms, t_wc,
                                             q_wc))
    return {k: np.asarray(v) for k, v in out.items()}


def urban_drive():
    """The JAX runner's sensors.npz for URBAN_S s and, under ``jax/``, its
    replay's result (each in a process of its own, as the runner runs)."""
    import subprocess
    import tempfile

    runner = os.path.join(ROOT, "tools", "run_urban.py")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sensors.npz")
        common = ["--duration", str(URBAN_S), "--sensors", path, "--out", tmp]
        subprocess.run([sys.executable, runner, "--gen", *common], check=True)
        with np.load(path) as z:
            out = {k: z[k] for k in z.files}
        subprocess.run([sys.executable, runner, *common, *URBAN_REPLAY], check=True)
        with open(os.path.join(tmp, "result.json")) as f:
            res = json.load(f)
        for k in ("ate_rmse_m", "ate_max_m", "ate_max_outage_m", "ate_rmse_clean_m",
                  "n_keyframes", "frames"):
            out[f"jax/{k}"] = np.asarray(res[k])
        with np.load(os.path.join(tmp, "trajectory.npz")) as z:
            out.update({f"jax/{k}": z[k] for k in z.files})
    return out


def main():
    _jax()
    from ic_gvins_tpu.data import simulator as sim

    params = sim.default_params(with_earth=True)
    route = sim.urban_route(seed=3)
    arrays = {f"route/{k}": np.asarray(getattr(route, k)) for k in route._fields}
    for name, sp in specs(route).items():
        traj = sim.car_trajectory() if sp["traj"] == "car" else sim.urban_trajectory(route)
        arrays[f"{name}/spec"] = np.array(json.dumps(sp))
        arrays.update({f"{name}/{k}": v for k, v in stretch(sp, traj, params).items()})
        print(f"{name}: {sp['t0']} s + {sp['duration']} s at {sp['imu_rate']} Hz", flush=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    np.savez_compressed(URBAN_OUT, **urban_drive())
    print(f"wrote {URBAN_OUT} ({os.path.getsize(URBAN_OUT)} bytes)")


if __name__ == "__main__":
    main()
