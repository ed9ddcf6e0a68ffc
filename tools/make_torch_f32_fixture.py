#!/usr/bin/env python
"""Write ``tests/fixtures/torch_f32.npz``: what the JAX package computes in
its float32 mode (x64 off, as its runners' ``--f32``), which the PyTorch
port's float32 engine mode is held against by ``tests/test_torch_f32.py``
and ``chip_smoke.py`` phase 10.

Parts, one process each (x64 is a process-wide switch of JAX):

* ``solve64`` (x64 on): the reduced camera system of the 24 x 192
  keyframe round's first LM step (``tools/make_torch_parallel_fixture.py``'s
  ``round`` input: JAX's preintegration and triangulation; damping 1e-4),
  an SPD matrix whose diagonal spans 1e2-1e10 (numpy seed 7), the float64
  ``solve_reduced`` of both, and ``marginalize_node0`` of the round's
  optimum in float64;
* ``solve32``: ``solve_reduced`` of the two systems cast to float32 (the
  Newton-Schulz branch);
* ``round32``: on the round's optimum cast to float32,
  ``marginalize_node0``, its landmark-eliminated system and
  ``_schur_eliminate_scaled`` of it; the float32 preintegration of the
  round's first interval;
* ``recenter`` (x64 on): the small ``gvins`` scenario of
  ``torch_estimator_small.npz`` run to its middle event and checkpointed;
  that checkpoint loaded into a fresh estimator with the run's GNSS queue,
  and ``_maybe_recenter`` at a 1 m threshold: the shifted fields;
* ``est32``: the ``gvins`` scenario through the float32 ``Estimator``
  (re-centering on), with the checkpoint it saved after its middle event;
* ``defaults32``: ``torch_estimator_defaults.npz``'s 15 s through
  ``EngineConfig()`` in float32 (the C++ IMU buffer);
* ``urban32``: ``tools/run_urban.py --f32`` replaying
  ``torch_urban90.npz`` with the flags of the float64 replay stored there
  (``--outages 60 75 --checkpoint-every 60``); ``--urban-duration`` cuts
  it shorter.

The estimators of ``recenter``, ``est32`` and ``defaults32`` run with
``tests/dead_rows.clear_dead_rows``, the port's clearing of the landmark
slots that die with a marginalized anchor (the JAX package keeps their
observations). ``urban32`` is the JAX runner's own replay, without it:
``chip_smoke.py`` only prints it beside the port's.

    python tools/make_torch_f32_fixture.py              # all parts (urban32 ~40 min)
    python tools/make_torch_f32_fixture.py --only est32 # rerun parts; the file keeps the others'
"""

import argparse
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
OUT = os.path.join(FIXTURES, "torch_f32.npz")
PARALLEL = os.path.join(FIXTURES, "torch_parallel.npz")
SLICE = os.path.join(FIXTURES, "torch_slice_24x192.npz")
SMALL = os.path.join(FIXTURES, "torch_estimator_small.npz")
DEFAULTS = os.path.join(FIXTURES, "torch_estimator_defaults.npz")
URBAN = os.path.join(FIXTURES, "torch_urban90.npz")
LAM = 1e-4  # the LM's first damping
SPD_N, SPD_SEED = 192, 7
RECENTER_THRESHOLD = 1.0  # m, the recenter part's threshold
PARTS = ("solve64", "solve32", "round32", "recenter", "est32", "defaults32", "urban32")
FIRST = ("solve64",)  # parts whose output another part reads (solve32)


def _jax(x64):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    return jax


def round_state(opt: bool):
    """The 24 x 192 round's (window, prior, cfg, params) in JAX types: the
    optimize input, or with ``opt`` its optimum (the marginalization's
    input)."""
    from ic_gvins_tpu.data.types import IntegrationParams
    from ic_gvins_tpu.solver.window import Prior, SolverConfig, Window
    from ic_gvins_tpu_torch.convert import unflatten
    from test_torch_solver import jax_tree  # jnp.asarray: float32 with x64 off

    fx = unflatten(dict(np.load(PARALLEL)), "round/in/")
    win = fx["window"]
    if opt:
        win = {**win, "nodes": fx["opt"]["nodes"], "lm_invdepth": fx["opt"]["lm_invdepth"]}
    return (jax_tree(Window, win), jax_tree(Prior, fx["prior"]),
            jax_tree(SolverConfig, fx["cfg"]), jax_tree(IntegrationParams, fx["params"]))


def spd_system():
    """An SPD matrix with its diagonal spanning 1e2-1e10 (a well-conditioned
    correlation matrix between diagonal scales) and a right-hand side."""
    rng = np.random.default_rng(SPD_SEED)
    q, _ = np.linalg.qr(rng.standard_normal((SPD_N, SPD_N)))
    c = (q * rng.uniform(0.5, 2.0, SPD_N)) @ q.T
    d = 1.0 / np.sqrt(np.diag(c)) * np.sqrt(np.logspace(2, 10, SPD_N))
    return c * d[:, None] * d[None, :], rng.standard_normal(SPD_N) * np.sqrt(np.logspace(2, 10, SPD_N))


def reduced_system(win, prior, cfg, params):
    """The damped reduced camera system of the window's first LM step."""
    import jax.numpy as jnp

    from ic_gvins_tpu.solver import assembly as asm

    flags = asm.RobustFlags(gnss_kernel=jnp.asarray(True), reproj_kernel=jnp.asarray(True))
    Hxx, gx, Hxl, hll, gl, _ = asm.assemble_blocks(win, prior, cfg, params, flags)
    Hxx_d = Hxx + jnp.diag(LAM * jnp.diag(Hxx))
    Hxl_w = Hxl / (hll * (1.0 + LAM))[None, :]
    return Hxx_d - Hxl_w @ Hxl.T, gx - Hxl_w @ gl


def solve64(_):
    _jax(True)
    from ic_gvins_tpu.factors.marginalization import marginalize_node0
    from ic_gvins_tpu.solver.assembly import solve_reduced

    H, g = (np.asarray(x) for x in reduced_system(*round_state(False)))
    A, b = spd_system()
    prior = marginalize_node0(*round_state(True))
    return {"round_H": H, "round_g": g, "round_y": np.asarray(solve_reduced(H, g)),
            "spd_H": A, "spd_g": b, "spd_y": np.asarray(solve_reduced(A, b)),
            "marg_H": np.asarray(prior.H), "marg_g": np.asarray(prior.g)}


def solve32(inputs):
    _jax(False)
    import jax.numpy as jnp

    from ic_gvins_tpu.solver.assembly import solve_reduced

    out = {}
    for k in ("round", "spd"):
        H, g = (jnp.asarray(inputs[f"solve64/{k}_{x}"], jnp.float32) for x in ("H", "g"))
        out[f"{k}_y"] = np.asarray(solve_reduced(H, g))
    return out


def round32(_):
    jax = _jax(False)
    import jax.numpy as jnp

    from ic_gvins_tpu.data.types import ImuSeq
    from ic_gvins_tpu.factors import marginalization as marg
    from ic_gvins_tpu.ins.preintegration import preintegrate
    from ic_gvins_tpu_torch.convert import to_numpy, unflatten

    win, prior, cfg, params = round_state(True)
    assert win.nodes.p.dtype == jnp.float32
    prior_new = marg.marginalize_node0(win, prior, cfg, params)
    # marginalize_node0's first step, then its node-0 elimination
    Hxx, gx, Hxl, hll, gl = marg._marg_blocks(win, prior, cfg, params)
    anchored = ((win.lm_ref == 0) & win.lm_valid).astype(jnp.float32)
    live = (anchored * hll > marg.EPS).astype(jnp.float32)
    hll_safe = jnp.where(anchored * hll > marg.EPS, hll, 1.0)
    Hxl = Hxl * live[None, :]
    H1 = Hxx - (Hxl / hll_safe[None, :]) @ Hxl.T
    g1 = gx - (Hxl / hll_safe[None, :]) @ (gl * live)
    Hp, gp = marg._schur_eliminate_scaled(H1, g1, 15)
    imu = unflatten(dict(np.load(SLICE)), "in/imu/")
    imu0 = ImuSeq(**{k: jnp.asarray(v[0]) for k, v in imu.items()})
    state0 = jax.tree.map(lambda x: x[0], win.nodes)
    pre = preintegrate(params, state0, imu0)
    return {"window": to_numpy(win), "prior": to_numpy(prior), "cfg": to_numpy(cfg),
            "params": to_numpy(params), "marg_H": np.asarray(prior_new.H),
            "marg_g": np.asarray(prior_new.g), "H1": np.asarray(H1), "g1": np.asarray(g1),
            "Hp": np.asarray(Hp), "gp": np.asarray(gp), "imu0": to_numpy(imu0),
            "preint": to_numpy(pre)}


class _NoJax(pickle.Unpickler):
    """Loads a checkpoint only if it holds no object of JAX."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(f"checkpoint holds {module}.{name}")
        return super().find_class(module, name)


def _estimator(s):
    import jax.numpy as jnp

    from ic_gvins_tpu.engine import config as jconfig
    from ic_gvins_tpu.engine.estimator import Estimator

    est = clear_dead_rows(Estimator(chip_smoke.engine_config(jconfig, s)))
    if "ext_p" in s:
        est.window = est.window._replace(ext_p=jnp.asarray(s["ext_p"]),
                                         ext_q=jnp.asarray(s["ext_q"]))
    return est


def _run(s, ckpt_event=None):
    """The JAX estimator fed scenario ``s`` (checkpointed after event
    ``ckpt_event``): (estimator, feed log + summary, checkpoint bytes)."""
    est = _estimator(s)
    path = os.path.join(tempfile.mkdtemp(prefix="ckpt_"), "ckpt.pkl")

    def on_event(e):
        if e == ckpt_event:
            est.save_checkpoint(path)

    log = chip_smoke.feed(est, est, s,
                          lambda j: est.add_frame_observations(*chip_smoke.observations(s, j)),
                          on_event=on_event)
    out = {**log, **chip_smoke.summarize(est), "n_recenters": np.int64(est.n_recenters),
           "origin": np.asarray(est.origin)}
    raw = None
    if ckpt_event is not None:
        with open(path, "rb") as f:
            raw = f.read()
        _NoJax(io.BytesIO(raw)).load()
    return est, out, raw


class _Stop(Exception):
    pass


def _middle(s):
    return sum(kind in ("gnss", "frame") for kind, _ in chip_smoke.schedule(s)) // 2


def recenter(_):
    _jax(True)
    s = chip_smoke.scenario(dict(np.load(SMALL)), "gvins")
    ck = _middle(s)
    est = _estimator(s)
    path = os.path.join(tempfile.mkdtemp(prefix="ckpt_"), "ckpt.pkl")
    queue = []

    def on_event(e):
        if e == ck:
            est.save_checkpoint(path)
            queue.extend(est.gnss_queue)
            raise _Stop

    try:
        chip_smoke.feed(est, est, s,
                        lambda j: est.add_frame_observations(*chip_smoke.observations(s, j)),
                        on_event=on_event)
    except _Stop:
        pass
    with open(path, "rb") as f:
        raw = f.read()
    fresh = _estimator(s)
    fresh.load_checkpoint(path)
    fresh.gnss_queue = list(queue)
    fresh.recenter_threshold = RECENTER_THRESHOLD
    fresh._maybe_recenter()
    w, pr = fresh.window, fresh.prior
    return {"ckpt": np.frombuffer(raw, np.uint8), "ckpt_event": np.int64(ck),
            "queue_t": np.array([q[0] for q in queue]),
            "queue_p": np.array([q[1] for q in queue]),
            "queue_std": np.array([q[2] for q in queue]),
            "shifted/nodes_p": np.asarray(w.nodes.p), "shifted/gnss_p": np.asarray(w.gnss_p),
            "shifted/sum_dt_pn": np.asarray(w.preint.sum_dt_pn),
            "shifted/end_state_p": np.asarray(w.preint.end_state.p),
            "shifted/lin_nodes_p": np.asarray(pr.lin_nodes.p),
            "shifted/last_node_p": np.asarray(fresh.last_node_state.p),
            "shifted/cur_p": np.asarray(fresh.cur_state.p),
            "shifted/queue_p": np.array([q[1] for q in fresh.gnss_queue]),
            "shifted/origin": np.asarray(fresh.origin),
            "shifted/n_recenters": np.int64(fresh.n_recenters)}


def est32(_):
    _jax(False)
    s = chip_smoke.scenario(dict(np.load(SMALL)), "gvins")
    ck = _middle(s)
    est, out, raw = _run(s, ck)
    assert est.window.nodes.p.dtype == np.float32
    e = chip_smoke.trajectory_errors(out["traj_t"], out["traj_p"], s, 5.0, atol_t=1e-5)
    out.update(ate_rmse=np.sqrt(np.mean(e ** 2)), ckpt=np.frombuffer(raw, np.uint8),
               ckpt_event=np.int64(ck))
    return out


def defaults32(_):
    _jax(False)
    fx = dict(np.load(DEFAULTS))
    s = {**chip_smoke.scenario(fx, "defaults"),
         "cfg_json": chip_smoke.scenario(fx, "defaults_native")["cfg_json"]}
    est, out, _ = _run(s)
    assert est.window.nodes.p.dtype == np.float32
    e = chip_smoke.trajectory_errors(out["traj_t"], out["traj_p"], s, 5.0, atol_t=1e-5)
    out["ate_rmse"] = np.sqrt(np.mean(e ** 2))
    return out


def urban32(_, duration):
    runner = os.path.join(ROOT, "tools", "run_urban.py")
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([sys.executable, runner, "--duration", str(duration), "--sensors", URBAN,
                        "--out", tmp, "--outages", "60", "75", "--checkpoint-every", "60",
                        "--f32"], check=True, env={**os.environ, "IC_GVINS_NO_CACHE": "1"})
        with open(os.path.join(tmp, "result.json")) as f:
            res = json.load(f)
        out = {k: np.asarray(res[k]) for k in ("ate_rmse_m", "ate_max_m", "n_keyframes",
                                               "frames", "n_recenters", "prior_eig_min",
                                               "prior_rank", "sim_t_reached")}
        out["duration"] = np.float64(duration)
        with np.load(os.path.join(tmp, "trajectory.npz")) as z:
            out.update({k: z[k] for k in z.files})
    return out


def run_part(name, out, inputs, urban_duration):
    from ic_gvins_tpu_torch.convert import flatten

    make = {"solve64": solve64, "solve32": solve32, "round32": round32,
            "recenter": recenter, "est32": est32, "defaults32": defaults32}
    res = urban32(inputs, urban_duration) if name == "urban32" else make[name](inputs)
    np.savez_compressed(out, **flatten(res))
    print(f"{name}: {len(res)} entries", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=PARTS)
    ap.add_argument("--out")
    ap.add_argument("--only", nargs="+", choices=PARTS,
                    help="rerun these parts; the file keeps the others'")
    ap.add_argument("--urban-duration", type=float, default=90.0,
                    help="s of the urban drive the urban32 part replays")
    args = ap.parse_args()
    inputs = dict(np.load(OUT)) if os.path.exists(OUT) else {}
    if args.part:
        run_part(args.part, args.out, inputs, args.urban_duration)
        return
    names = args.only or PARTS
    work = tempfile.mkdtemp(prefix="f32_fixture_")

    def start(n):
        return subprocess.Popen([sys.executable, __file__, "--part", n, "--out",
                                 os.path.join(work, n + ".npz"),
                                 "--urban-duration", str(args.urban_duration)])

    merged = {k: v for k, v in inputs.items() if k.split("/")[0] not in names}

    def collect(procs):
        bad = [n for n, p in procs.items() if p.wait() != 0]
        if bad:
            raise SystemExit(f"parts failed: {bad}")
        for n in procs:
            with np.load(os.path.join(work, n + ".npz")) as z:
                merged.update({f"{n}/{k}": z[k] for k in z.files})
        np.savez_compressed(OUT, **merged)

    first = [n for n in names if n in FIRST]
    collect({n: start(n) for n in first})
    collect({n: start(n) for n in names if n not in first})
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
