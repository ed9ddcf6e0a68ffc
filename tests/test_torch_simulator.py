"""PyTorch port, the simulator (``ic_gvins_tpu_torch/data/simulator.py``)
against the JAX package's, live, in float64 on the CPU, on short
stretches, with the JAX draws passed in: time grids and the urban route's
arrays bit for bit, every float64 stream within SIM_RTOL of the largest
entry of its array (chip_smoke's bound: forward-mode derivatives of the
same closed forms, summed in another order), the full-frame render within
SIM_FRAME_ATOL grey levels. Also the stretches of
``tests/fixtures/torch_sim.npz`` (``tools/make_torch_sim_fixture.py``), the
derivative at a segment junction (where ``jnp.clip`` halves it), seeded
determinism and the moments of the port's own draws."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from test_torch_solver import one_torch_thread  # noqa: E402, F401

from ic_gvins_tpu.common import rotation as jrot  # noqa: E402
from ic_gvins_tpu.data import simulator as jsim  # noqa: E402
from ic_gvins_tpu_torch.data import simulator as tsim  # noqa: E402

SIM_RTOL = chip_smoke.SIM_RTOL
SIM_FRAME_ATOL = chip_smoke.SIM_FRAME_ATOL


# the JAX calls run jitted (eager vmaps of the simulator take seconds each)


def close(a, b, rtol=SIM_RTOL):
    """b (port, tensor or array) within rtol of a's (JAX) largest entry."""
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert np.asarray(a).shape == b.shape
    err = chip_smoke.rel_err(a, b)
    assert err <= rtol, err


def exact(a, b):
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert np.array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def routes():
    return jsim.urban_route(seed=3), tsim.urban_route(seed=3, device="cpu")


def trajs(kind, routes):
    if kind == "car":
        return jsim.car_trajectory(), tsim.car_trajectory()
    if kind == "static":
        return jsim.static_trajectory(), tsim.static_trajectory()
    return jsim.urban_trajectory(routes[0]), tsim.urban_trajectory(routes[1])


PARAMS = (jsim.default_params(), tsim.default_params(device="cpu"))
# (trajectory, t0, duration, IMU rate): the car, and the urban route where
# its ramp ends (a junction on the IMU stamp 14.0 s). The fixture's
# stretches (test_fixture_stretches) cover the dwell end and a corner.
STRETCHES = {"car": ("car", 3.0, 0.5, 200.0), "urban": ("urban", 13.5, 1.0, 100.0)}


@pytest.mark.parametrize("seed", [0, 3])
def test_urban_route_bit_equal(seed):
    j, t = jsim.urban_route(seed=seed), tsim.urban_route(seed=seed, device="cpu")
    for k in j._fields[:-2]:
        exact(getattr(j, k), getattr(t, k))
    assert (j.total_time, j.total_dist) == (t.total_time, t.total_dist)


def test_default_params_match_jax():
    for with_earth in (True, False):
        j, t = jsim.default_params(with_earth), tsim.default_params(with_earth, device="cpu")
        for a, b in zip(j, t):
            exact(a, b)


@pytest.mark.parametrize("kind", sorted(STRETCHES))
def test_truth_and_imu_match_jax(kind, routes):
    """truth_state at the IMU stamps, simulate_imu's grids and increments,
    corrupt_imu (on the car).
    On the urban route a segment starts exactly on a stamp (14 s: the ramp
    to 4.5 m/s ends); there JAX's clip has derivative 1/2, so its truth
    velocity is half the speed, which the port's maximum / minimum
    reproduce (torch.clamp would not)."""
    _, t0, dur, rate = STRETCHES[kind]
    jt, tt = trajs(kind, routes)
    ji = jsim.simulate_imu(jt, PARAMS[0], t0, dur, rate)
    ti = tsim.simulate_imu(tt, PARAMS[1], t0, dur, rate)
    exact(ji.time, ti.time)
    exact(ji.dt, ti.dt)
    close(ji.dtheta, ti.dtheta)
    close(ji.dvel, ti.dvel)
    js = jax.jit(jax.vmap(lambda x: jsim.truth_state(jt, PARAMS[0], x)))(ji.time)
    ts = tsim.truth_state(tt, PARAMS[1], ti.time)
    for k in ("p", "q", "v"):
        close(getattr(js, k), getattr(ts, k))
    if kind == "urban":
        k = int(np.flatnonzero(ti.time.numpy() == 14.0)[0])
        assert abs(float(ts.v[k, 0]) - 2.25) < 1e-9
        return
    # corrupt_imu with the JAX draws (a split of its key)
    key = jax.random.PRNGKey(4)
    kg, ka = jax.random.split(key)
    noise = (jax.random.normal(kg, ji.dtheta.shape), jax.random.normal(ka, ji.dvel.shape))
    bg, ba = (2e-4, -1e-4, 3e-4), (5e-3, -8e-3, 2e-3)
    jb = jsim.corrupt_imu(ji, PARAMS[0], key, jnp.asarray(bg), jnp.asarray(ba))
    tb = tsim.corrupt_imu(ti, PARAMS[1], bg, ba, noise=tuple(np.asarray(n) for n in noise))
    close(jb.dtheta, tb.dtheta)
    close(jb.dvel, tb.dvel)


def test_static_trajectory_matches_jax():
    jt, tt = jsim.static_trajectory(), tsim.static_trajectory()
    for t in (0.0, 1.5):
        js = jsim.truth_state(jt, PARAMS[0], jnp.asarray(t))
        ts = tsim.truth_state(tt, PARAMS[1], torch.tensor(t, dtype=torch.float64))
        for k in ("p", "q", "v"):
            exact(getattr(js, k), getattr(ts, k))


def test_gnss_and_odometer_with_jax_draws(routes):
    jt, tt = trajs("urban", routes)
    t0 = 6.0
    key = jax.random.PRNGKey(5)
    lever = (0.1, -0.05, 0.2)
    jg = jsim.simulate_gnss(jt, PARAMS[0], jnp.asarray(lever), t0, 3.0, 2.0, std=0.2, key=key)
    tg = tsim.simulate_gnss(tt, PARAMS[1], lever, t0, 3.0, 2.0, std=0.2,
                            noise=np.asarray(jax.random.normal(key, jg.p.shape)))
    exact(jg.time, tg.time)
    close(jg.p, tg.p)
    exact(jg.std, tg.std)
    jo = jsim.simulate_odometer(jt, PARAMS[0], t0, 3.0, 50.0, sodo_true=0.03, noise_std=0.02,
                                key=key)
    to = tsim.simulate_odometer(tt, PARAMS[1], t0, 3.0, 50.0, sodo_true=0.03, noise_std=0.02,
                                noise=np.asarray(jax.random.normal(key, jo[1].shape)))
    exact(jo[0], to[0])
    close(jo[1], to[1])


def test_landmarks_and_projection_with_jax_draws(routes):
    jt, tt = trajs("urban", routes)
    t0, t1, n = 85.0, 95.0, 40
    key = jax.random.PRNGKey(6)
    jl = jax.jit(lambda k: jsim.scatter_landmarks(jt, PARAMS[0], k, n, t0, t1, lateral=26.0,
                                                  depth_range=(7.0, 45.0)))(key)
    kt, kd, ko = jax.random.split(key, 3)
    draws = (jax.random.uniform(kt, (n,), minval=t0, maxval=t1),
             jax.random.uniform(kd, (n,), minval=7.0, maxval=45.0),
             jax.random.uniform(ko, (n, 2), minval=-26.0, maxval=26.0))
    tl = tsim.scatter_landmarks(tt, PARAMS[1], None, n, t0, t1,
                                draws=tuple(np.asarray(d) for d in draws))
    close(jl, tl)
    ftimes = t0 + (jnp.arange(12) + 1) / 2.0
    ext_q = jrot.matrix_to_quat(jnp.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    ext_p = jnp.array([0.1, 0.0, -0.05])
    juv, jvis = jsim.project_landmarks(jt, PARAMS[0], jl, ftimes, ext_p, ext_q,
                                       noise_std=0.5 / 780.0, key=key)
    noise = np.asarray(jax.random.normal(key, juv.shape))
    tuv, tvis = tsim.project_landmarks(tt, PARAMS[1], tl, np.asarray(ftimes), np.asarray(ext_p),
                                       np.asarray(ext_q), noise_std=0.5 / 780.0, noise=noise)
    exact(jvis, tvis)
    assert bool(np.asarray(jvis).any())
    close(juv, tuv)


def test_render_sprite_frame_matches_jax():
    """The full-frame renderer (float32 blobs summed in batches)."""
    rng = np.random.default_rng(0)
    lms = np.stack([rng.uniform(-8, 8, 30), rng.uniform(-6, 6, 30), rng.uniform(3, 40, 30)], 1)
    lms[0, 2] = 0.5  # one behind the near plane: drawn nowhere
    intr, res = (90.0, 90.0, 48.0, 32.0), (96, 64)
    q = np.array([0.99, 0.05, -0.08, 0.1])
    q /= np.linalg.norm(q)
    t = np.array([0.3, -0.2, 0.1])
    j = jsim.render_sprite_frame(intr, res, jnp.asarray(lms), jnp.asarray(t), jnp.asarray(q))
    got = tsim.render_sprite_frame(intr, res, torch.as_tensor(lms), t, q)
    assert got.dtype == torch.float32 and got.shape == (64, 96)
    assert float(np.max(np.abs(np.asarray(j) - got.numpy()))) <= SIM_FRAME_ATOL


@pytest.mark.parametrize("name", ["car", "urban_start", "urban_arc"])
def test_fixture_stretches(name, routes):
    """chip_smoke.py phase 8's comparison, on the CPU."""
    fx = dict(np.load(chip_smoke.SIM_FIXTURE))
    for k in routes[1]._fields[:-2]:
        exact(fx["route/" + k], getattr(routes[1], k))
    ref = chip_smoke.scenario(fx, name)
    sp = json.loads(str(ref["spec"]))
    got = chip_smoke.sim_stretch(sp, ref, routes[1], PARAMS[1], "cpu")
    chip_smoke.compare_sim(got, ref)


def test_port_draws_are_seeded():
    """The port's own draws: one seed, one stream; another seed, another."""
    tt = tsim.car_trajectory()
    imu = tsim.simulate_imu(tt, PARAMS[1], 0.0, 0.2, 200.0)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        bad = tsim.corrupt_imu(imu, PARAMS[1], (0.0,) * 3, (0.0,) * 3, generator=g)
        lms = tsim.scatter_landmarks(tt, PARAMS[1], g, 16, 0.0, 3.0)
        gnss = tsim.simulate_gnss(tt, PARAMS[1], (0.0,) * 3, 0.0, 3.0, generator=g)
        return torch.cat([bad.dtheta.reshape(-1), lms.reshape(-1), gnss.p.reshape(-1)])

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def test_port_draw_moments():
    """Standard normals and uniforms of the port's generator: moments within
    5 standard errors over 60000 draws."""
    g = torch.Generator().manual_seed(0)
    n = 60000
    z = tsim._randn(g, (n,), "cpu").numpy()
    se = 5.0 / np.sqrt(n)
    assert abs(z.mean()) < se and abs(z.std() - 1.0) < 5.0 * np.sqrt(0.5 / n)
    ts, d, off = (x.numpy() for x in tsim.landmark_draws(g, n, 2.0, 12.0, 30.0, (8.0, 60.0)))
    assert ts.min() >= 2.0 and ts.max() < 12.0 and abs(ts.mean() - 7.0) < 10.0 * se / np.sqrt(12)
    assert d.min() >= 8.0 and d.max() < 60.0 and abs(d.mean() - 34.0) < 52.0 * se / np.sqrt(12)
    assert off.min() >= -30.0 and off.max() < 30.0 and np.all(np.abs(off.mean(0)) < 60 * se)
