"""PyTorch port: the entry points (``ic_gvins_tpu_torch/entry.py``, the
counterpart of ``__graft_entry__.py``) over the dense normal equations
(``solver/assembly.py``: ``assemble``, ``free_mask``, ``schur_solve``, the
preintegration helpers), JAX's ``split`` / ``normal`` draws
(``common/prng.py``), the Python file classes (``engine/fileio.py``) and
the small API (``ImuSeq.n`` / ``slice``, ``NavState.zero``), against the
JAX package on the CPU.

The JAX results of ``__graft_entry__.entry()``'s step come from
``tests/fixtures/torch_entry.npz`` (``tools/make_torch_entry_fixture.py``),
the JAX problems from ``torch_tiny.npz`` and ``torch_slice_24x192.npz``;
nothing here jits JAX (``jax.random`` runs live). Each test's docstring
states its tolerance and what it measured."""

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
from test_torch_distributed import _ranks  # noqa: E402
from test_torch_odo import _odo_params, _odovel  # noqa: E402
from test_torch_solver import one_torch_thread  # noqa: E402, F401
from test_torch_solver import assert_rel, perturbed, port, tiny_problem  # noqa: E402

from ic_gvins_tpu.data import types as jtypes  # noqa: E402
from ic_gvins_tpu.engine import fileio as jfileio  # noqa: E402
from ic_gvins_tpu_torch import entry as tentry  # noqa: E402
from ic_gvins_tpu_torch import native as tnative  # noqa: E402
from ic_gvins_tpu_torch.common import prng  # noqa: E402
from ic_gvins_tpu_torch.convert import cast, flatten, to_numpy, to_torch, unflatten  # noqa: E402
from ic_gvins_tpu_torch.data.types import ImuSeq, IntegrationParams, NavState  # noqa: E402
from ic_gvins_tpu_torch.engine import fileio as tfileio  # noqa: E402
from ic_gvins_tpu_torch.ins import preintegration_odo as tpo  # noqa: E402
from ic_gvins_tpu_torch.solver import assembly as tasm  # noqa: E402
from ic_gvins_tpu_torch.solver import lm as tlm  # noqa: E402
from ic_gvins_tpu_torch.solver import window as twin  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
ENTRY = os.path.join(FIXTURES, "torch_entry.npz")
PROBLEMS = {"tiny": ("torch_tiny.npz", (6, 16)), "slice": ("torch_slice_24x192.npz", (24, 192))}
CPU = "cpu"
FLAGS = tasm.RobustFlags(gnss_kernel=True, reproj_kernel=True)


@pytest.fixture(scope="module")
def fx():
    return unflatten(dict(np.load(ENTRY)))


def _leaves_close(got, want, tol, what):
    """Leaf by leaf of two nested dicts: floats within ``tol`` of each
    leaf's largest entry, bool and integer leaves equal. Returns the
    largest relative error."""
    g, w = flatten(got), flatten(want)
    assert g.keys() == w.keys(), what
    worst = 0.0
    for k, v in w.items():
        a = np.asarray(g[k])
        assert a.shape == v.shape, f"{what}/{k}"
        if v.dtype.kind != "f":
            np.testing.assert_array_equal(a, v, err_msg=f"{what}/{k}")
            continue
        if v.size and np.max(np.abs(v)) > 0:
            worst = max(worst, float(np.max(np.abs(a - v)) / np.max(np.abs(v))))
    assert worst <= tol, f"{what}: relative error {worst:.3g} > {tol}"
    return worst


@pytest.mark.parametrize("name", ["tiny", "slice"])
def test_tiny_problem_matches_jax(name):
    """``tiny_problem()`` and ``tiny_problem(24, 192)`` against the JAX
    package's ``_tiny_problem`` windows, priors, configurations and
    parameters stored in the fixtures: within 1e-12 of each array's
    largest entry, masks and indices exact (measured 1.1e-15 and 1.0e-14,
    the latter on the observations)."""
    path, shape = PROBLEMS[name]
    want = unflatten(dict(np.load(os.path.join(FIXTURES, path))), "in/")
    got = tentry.tiny_problem(*shape, device=CPU)
    for part, tree in zip(("window", "prior", "cfg", "params"), got):
        _leaves_close(to_numpy(tree), want[part], 1e-12, f"{name}/{part}")


def test_tiny_problem_float32_matches_jax(fx):
    """``tiny_problem(dtype=torch.float32)`` against the JAX package's
    ``_tiny_problem(dtype=float32)``: float32 states, intervals and tracks
    within 1e-5 of each array's largest entry (measured 1.7e-6: the port
    simulates in float64 and casts, the JAX package mixes its float32
    parameters into the simulation), float32 JAX draws for the noise."""
    win = tentry.tiny_problem(dtype=torch.float32, device=CPU)[0]
    assert all(x.dtype == torch.float32 for x in win.nodes)
    _leaves_close(to_numpy(win), fx["tiny32"]["window"], 1e-5, "tiny32")


@pytest.mark.parametrize("seed", [0, 1, 7, 2**40 + 3])
def test_split_is_jax_bit_for_bit(seed):
    """``prng.split(key, n)`` equals ``jax.random.split``, every bit."""
    key = jax.random.PRNGKey(seed)
    for n in (2, 3, 5, 16):
        np.testing.assert_array_equal(prng.split(prng.prng_key(seed), n),
                                      np.asarray(jax.random.split(key, n)))
    lo, hi = 5.0, 7.4
    np.testing.assert_array_equal(prng.uniform(prng.prng_key(seed), (64,), minval=lo, maxval=hi),
                                  np.asarray(jax.random.uniform(key, (64,), minval=lo, maxval=hi)))


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-14), (np.float32, 2e-6)])
def test_normal_matches_jax(dtype, atol):
    """``prng.normal`` against ``jax.random.normal`` over 4 keys x 2000
    draws: within 1e-14 (float64) / 2e-6 (float32) absolute, on draws up
    to ~4 in size (measured 3.0e-15 / 4.8e-7: XLA's log1p in the erfinv
    rounds otherwise than numpy's; 88% / 94% of the draws are bit-equal)."""
    for seed in (0, 1, 7, 123):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (2000,), dtype))
        got = prng.normal(prng.prng_key(seed), (2000,), dtype)
        assert got.dtype == want.dtype
        assert float(np.max(np.abs(got - want))) <= atol


def test_dense_system_matches_jax(fx):
    """``assemble`` (H, g, cost), ``free_mask`` and ``schur_solve`` on
    ``_tiny_problem()``'s window moved off the truth (test_torch_solver's
    ``perturbed``) against the JAX package's: within 1e-10 of each
    output's largest entry (measured 2.2e-16 to 1.7e-12), the mask exact
    and in the window's dtype."""
    (win, prior, cfg, params), _, _, _ = tiny_problem()
    tw, tp, tc, tparams = port((perturbed(win), prior, cfg, params))
    want = fx["tiny"]
    H, g, cost = tasm.assemble(tw, tp, tc, tparams, FLAGS)
    for got, key in ((H, "H"), (g, "g"), (cost, "cost")):
        assert_rel(got, want[key], 1e-10, key)
    assert_rel(tasm.schur_solve(H, g, tw.dim_x, 1e-4), want["dx"], 1e-10, "dx")
    mask = tasm.free_mask(tw, tc)
    assert mask.dtype == torch.float64
    np.testing.assert_array_equal(mask.numpy(), want["free_mask"])


@pytest.mark.parametrize("name", ["tiny", "slice"])
def test_dense_step_equals_block_path(name):
    """The dense system is ``assemble_blocks`` composed into one matrix,
    every bit; its Schur step equals ``schur_solve_blocks``'s within 1e-10
    of the step's largest entry (measured 0 and 1.8e-17: the dense path
    multiplies strided views of H)."""
    win, prior, cfg, params = tentry.tiny_problem(*PROBLEMS[name][1], device=CPU)
    H, g, cost = tasm.assemble(win, prior, cfg, params, FLAGS)
    Hxx, gx, Hxl, hll, gl, cost_b = tasm.assemble_blocks(win, prior, cfg, params, FLAGS)
    D = win.dim_x
    assert torch.equal(H[:D, :D], Hxx) and torch.equal(H[:D, D:], Hxl)
    assert torch.equal(H[D:, :D], Hxl.T) and torch.equal(H[D:, D:], torch.diag(hll))
    assert torch.equal(g, torch.cat([gx, gl])) and torch.equal(cost, cost_b)
    dx_x, dx_l = tasm.schur_solve_blocks(Hxx, gx, Hxl, hll, gl, 1e-4)
    assert_rel(tasm.schur_solve(H, g, D, 1e-4), torch.cat([dx_x, dx_l]), 1e-10, "dx")


def _odo_window(tw, tparams, imu_tree):
    """``tw`` with every interval preintegrated with wheel increments by the
    port (``preintegrate_odo`` on the stored raw IMU), as the fixture tool
    makes the JAX one."""
    imu = to_torch(ImuSeq, imu_tree, CPU)
    t_odo = tpo.OdoParams(*(torch.as_tensor(v) for v in _odo_params().values()))
    state0 = NavState(*(x[:-1] for x in tw.nodes))
    pre = tpo.preintegrate_odo(tparams, t_odo, state0, torch.tensor(0.02, dtype=torch.float64),
                               imu, torch.as_tensor(_odovel(imu, 0)))
    odo = twin.empty_window(tw.n_nodes, tw.n_landmarks, device=CPU, odo=True)
    return odo._replace(**{k: getattr(tw, k) for k in tw._fields if k not in ("preint", "sodo")},
                        preint=pre, sodo=torch.tensor(0.024, dtype=torch.float64))


@pytest.mark.parametrize("variant", ["plain", "odo"])
def test_preint_helpers_match_jax(fx, variant):
    """``preint_res_fn`` (interval 2 at a delta from a numpy seed),
    ``preint_sqrt_info`` and ``preint_delta_cols`` against the JAX
    package's, on the perturbed tiny window and on it with odometer
    intervals: the residual within 1e-9 of its largest entry (measured
    ~1e-15; the two odometer windows were integrated each by its own
    package), the whitening within 1e-9, the columns and the delta
    dimension exact."""
    (win, prior, cfg, params), inp, _, _ = tiny_problem()
    tw, _, _, tparams = port((perturbed(win), prior, cfg, params))
    if variant == "odo":
        tw = _odo_window(tw, tparams, inp["imu"])
    want = fx["preint"][variant]
    fn, dim = tasm.preint_res_fn(tw)
    assert dim == (31 if variant == "odo" else 30)
    delta = 1e-3 * np.random.default_rng(5).standard_normal(dim)
    assert_rel(fn(tw, tparams, 2, torch.as_tensor(delta)), want["res"], 1e-9, "residual")
    assert_rel(tasm.preint_sqrt_info(tw), want["sqrt_info"], 1e-9, "sqrt info")
    np.testing.assert_array_equal(tasm.preint_delta_cols(tw).numpy(), want["cols"])


@pytest.mark.parametrize("name,dtype", [("tiny", torch.float64), ("tiny", torch.float32),
                                        ("slice", torch.float64), ("slice", torch.float32)])
def test_entry_forward_matches_jax(fx, name, dtype):
    """``entry()``'s forward (dense ``assemble`` -> ``schur_solve`` ->
    ``apply_delta``) on ``tiny_problem()`` and ``tiny_problem(24, 192)``
    against the JAX ``__graft_entry__.entry()`` forward on the JAX
    problems: float64 node positions within 1e-9 m, attitudes within 1e-9,
    inverse depths and the cost within 1e-10 relative (measured 3.6e-15 m,
    1.1e-16, 1.4e-15 and 4.3e-16); float32 (both problems cast) positions
    within 1e-4 m, the cost within 1e-5 relative (measured 3.8e-6 m, a
    float32 unit in the last place of ~60 m, and 6.2e-7)."""
    forward, args = tentry.entry(device=CPU)
    assert forward is tentry.forward
    args = args if name == "tiny" else tentry.tiny_problem(*PROBLEMS[name][1], device=CPU)
    args = args if dtype == torch.float64 else tuple(cast(x, dtype) for x in args)
    win, cost = forward(*args)
    want = fx[name]["forward" if dtype == torch.float64 else "forward32"]
    f64 = dtype == torch.float64
    pos = float(np.max(np.abs(win.nodes.p.numpy().astype(np.float64) - want["nodes"]["p"])))
    assert pos <= (1e-9 if f64 else 1e-4), pos
    assert_rel(win.nodes.q, want["nodes"]["q"], 1e-9 if f64 else 1e-6, "q")
    assert_rel(win.lm_invdepth, want["lm_invdepth"], 1e-10 if f64 else 1e-5, "lm_invdepth")
    assert_rel(cost, want["cost"], 1e-10 if f64 else 1e-5, "cost")


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no device given, the entry, its problem, the dry run, the
    command and ``NavState.zero`` go to cuda:0 and raise when there is
    none; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tentry.entry, tentry.tiny_problem, lambda: tentry.dryrun_multichip(2),
                 lambda: tentry.main([]), NavState.zero):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert NavState.zero(device=CPU).p.device.type == "cpu"


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """``dryrun_multichip(2)`` across 2 ``gloo`` ranks (rank 0's results,
    bit for bit every rank's) and, meanwhile, in one process."""
    return _ranks(tmp_path_factory.mktemp("dryrun"), "dryrun",
                  meanwhile=lambda: chip_smoke.dryrun_result(tentry.dryrun_multichip(2, CPU)))


def test_dryrun_one_process_two_shards_against_one(dry):
    """In one process: the 24 x 192 round on 2 landmark shards against 1
    (positions within 1e-10 m, measured 3.6e-14; the same decisions and
    culls); the BA on 2 node chunks against the same problem solved
    without a mesh, and the batch against each window's own ``optimize``
    (1e-10 m; measured 0 and ~1e-15); every cost finite."""
    one, two = chip_smoke.dryrun_result(tentry.dryrun_multichip(1, CPU)), dry[1]
    assert "batch" not in one
    a, b = one["round"], two["round"]
    np.testing.assert_array_equal(a["decisions"], b["decisions"])
    np.testing.assert_array_equal(a["obs_valid"], b["obs_valid"])
    assert chip_smoke.max_abs(a["nodes"]["p"], b["nodes"]["p"]) <= 1e-10
    from ic_gvins_tpu_torch.parallel.ba_nodes import ba_nodes_solve, build_nodes_ba

    wl, _, _, pl = tentry.tiny_problem(16, 32, device=CPU)
    ba, _ = build_nodes_ba(wl.nodes, wl.preint, wl.gnss_p, wl.gnss_std, wl.gnss_valid,
                           wl.lm_invdepth, wl.lm_ref, wl.obs_uv, wl.obs_valid, ext_p=wl.ext_p,
                           ext_q=wl.ext_q, reproj_std=1.5 / 780.0, n_chunks=2, stencil=8,
                           sep_width=2, device=CPU)
    out, (c0, c1, nacc, it) = ba_nodes_solve(ba, pl, None, iters=3, sep_width=2)
    assert chip_smoke.max_abs(out.nodes.p.numpy(), two["ba"]["nodes"]["p"]) <= 1e-10
    np.testing.assert_array_equal(two["ba"]["decisions"], [nacc, it])
    for s in range(2):
        w, p, cfg, params = tentry.tiny_problem(5, 16, seed=s, device=CPU)
        ws, _ = tlm.optimize(w, p, cfg, params, iters=2)
        assert chip_smoke.max_abs(ws.nodes.p.numpy(), two["batch"]["nodes"]["p"][s]) <= 1e-10
    assert all(np.isfinite(x).all() for x in (two["round"]["cost1"], two["ba"]["cost"],
                                              two["batch"]["stats"]))


def test_dryrun_across_two_gloo_ranks(dry):
    """``dryrun_multichip(2)`` as 2 ranks of a ``gloo`` group, one shard
    each: every rank's results bit for bit rank 0's, within 1e-10 m of the
    one-process run (measured 0 to 3.6e-15 m) with the same decisions,
    and no KLT launch."""
    ranks, one = dry
    assert int(ranks["klt_launches"]) == 0
    for part in ("round", "ba", "batch"):
        assert chip_smoke.max_abs(ranks[part]["nodes"]["p"], one[part]["nodes"]["p"]) <= 1e-10
    for part in ("round", "ba"):
        np.testing.assert_array_equal(ranks[part]["decisions"], one[part]["decisions"])
    np.testing.assert_array_equal(ranks["batch"]["stats"][2:], one["batch"]["stats"][2:])


@pytest.mark.parametrize("mode", [tfileio.TEXT, tfileio.BINARY])
def test_python_file_classes_match_jax_and_native(tmp_path, mode):
    """``PyFileSaver`` writes the JAX package's Python writer's bytes and
    the port's native writer's, in TEXT and BINARY mode; ``PyFileLoader``
    reads them back as the JAX reader does (TEXT with a comment line);
    both are context managers; ``FileSaver`` stays the native class."""
    rows = np.random.default_rng(mode).standard_normal((300, 4))
    paths = [str(tmp_path / f"{k}.dat") for k in ("py", "jax", "native")]
    makers = (tfileio.PyFileSaver, jfileio.PyFileSaver, tfileio.FileSaver)
    for path, make in zip(paths, makers):
        with make(path, 4, mode) as s:
            s.dump(rows[0])
            s.dumpn(rows[1:])
            s.flush()
    assert isinstance(tfileio.FileSaver(str(tmp_path / "n2.dat"), 4, mode), tnative.NativeFileSaver)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] == data[2]
    if mode == tfileio.TEXT:
        with open(paths[0], "a") as f:
            f.write("# a comment\n\n")
    with tfileio.PyFileLoader(paths[0], 4, mode) as a, jfileio.PyFileLoader(paths[0], 4, mode) as b:
        first = a.load()
        got = np.concatenate([first[None], a.load_all()])
        assert a.load() is None
        np.testing.assert_array_equal(got, b.load_all())
    np.testing.assert_allclose(got, rows, rtol=0, atol=1e-8 if mode == tfileio.TEXT else 0)
    with pytest.raises(ValueError):
        tfileio.PyFileSaver(str(tmp_path / "x.dat"), 4, mode).dump(np.zeros(3))
    with pytest.raises(ValueError):
        tfileio.PyFileLoader(paths[0], 4, 7)


def test_python_file_classes_need_no_native_library(monkeypatch, tmp_path):
    """Without a compiler ``FileSaver`` raises (no quiet fallback) while
    the Python classes, which a caller names, still write and read."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    path = str(tmp_path / "o.txt")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tfileio.FileSaver(path, 2)
    with tfileio.PyFileSaver(path, 2) as s:
        s.dump([1.5, -2.0])
    with tfileio.PyFileLoader(path, 2) as f:
        np.testing.assert_array_equal(f.load_all(), [[1.5, -2.0]])


def test_imu_seq_and_nav_state_match_jax():
    """``ImuSeq.n`` and ``ImuSeq.slice`` (a start inside, past the end and
    below 0: JAX's ``dynamic_slice`` moves it back into range) and
    ``NavState.zero`` in float64 and float32, exactly as the JAX
    package's."""
    rng = np.random.default_rng(2)
    arrays = (np.cumsum(np.full(12, 0.005)), np.full(12, 0.005), rng.standard_normal((12, 3)),
              rng.standard_normal((12, 3)))
    t = ImuSeq(*(torch.as_tensor(a) for a in arrays))
    j = jtypes.ImuSeq(*(jnp.asarray(a) for a in arrays))
    assert t.n == j.n == 12
    for start, size in ((0, 5), (3, 4), (10, 4), (-2, 3), (0, 12)):
        got, want = t.slice(start, size), j.slice(start, size)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for tdt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        got, want = NavState.zero(tdt, device=CPU), jtypes.NavState.zero(jdt)
        for a, b in zip(got, want):
            assert a.dtype == tdt and a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
