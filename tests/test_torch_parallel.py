"""PyTorch port: the ``parallel/`` package on one device, against the JAX
package's ``parallel/`` results in ``tests/fixtures/torch_parallel.npz``
(``tools/make_torch_parallel_fixture.py``: JAX float64 on the CPU, its
shard_map over 8 virtual devices) and against the port's own single path.

Tolerances are the JAX package's own tests' (``tests/test_sharding.py``,
``tests/test_ba_nodes.py``): a batch member against its sequential solve
1e-8 m; the landmark-sharded round against the single round with the same
culls and accepted steps, cost to a relative 1e-8, positions and
velocities 1e-5, attitudes 1e-6, free inverse depths 1e-5, the same
observation mask; the GN step 2e-5; node-chunked BA against one chunk
1e-5 in positions and velocities and 1e-6 in inverse depths. Against the
JAX results: the same decisions and 1e-7 relative to each array's
largest entry (the LM tolerance of ``tests/test_torch_solver.py``)."""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_solver import assert_rel, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

from ic_gvins_tpu_torch.convert import cast, to_torch, unflatten  # noqa: E402
from ic_gvins_tpu_torch.data.types import IntegrationParams, NavState  # noqa: E402
from ic_gvins_tpu_torch.ins.preintegration import PreintData  # noqa: E402
from ic_gvins_tpu_torch.parallel import Mesh, ba_nodes, lm_sharded, multi_seq, pmax, psum, schur  # noqa: E402
from ic_gvins_tpu_torch.solver import assembly as tasm  # noqa: E402
from ic_gvins_tpu_torch.solver import lm as tlm  # noqa: E402
from ic_gvins_tpu_torch.solver.window import Prior, SolverConfig, Window, apply_delta  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_parallel.npz")
ITERATIVE = 1e-7
CPU = "cpu"


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


def _round(fx, b):
    """Phase 9's sequence ``b`` (chip_smoke.perturb_round) and the shared
    prior, configuration and parameters, on the CPU."""
    inp = unflatten(fx, "round/in/")
    win = to_torch(Window, chip_smoke.perturb_round(inp["window"], inp["opt"], b), CPU)
    return (win, to_torch(Prior, inp["prior"], CPU), to_torch(SolverConfig, inp["cfg"], CPU),
            to_torch(IntegrationParams, inp["params"], CPU))


def _batch6(fx):
    inp = unflatten(fx, "batch6/in/")
    wins = [to_torch(Window, inp[f"window{i}"], CPU) for i in range(3)]
    prs = [to_torch(Prior, inp[f"prior{i}"], CPU) for i in range(3)]
    return (wins, prs, to_torch(SolverConfig, inp["cfg"], CPU),
            to_torch(IntegrationParams, inp["params"], CPU))


def test_mesh_and_collectives():
    mesh = Mesh({"lm": 8, "dp": 2}, device=CPU)
    assert mesh.shape == {"lm": 8, "dp": 2} and mesh.device == torch.device("cpu")
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(psum(x), x.sum(0)) and torch.equal(pmax(x), x[-1])
    with pytest.raises(ValueError):
        Mesh({"lm": 0}, device=CPU)


def test_optimize_batch_matches_sequential_and_jax(fx):
    """Three 6 x 24 windows (test_sharding.py's seeds 41, 42 and one more),
    8 iterations: each batch member equals its own ``lm.optimize`` (counts
    exactly, positions to 1e-8 m) and the JAX ``optimize_batch``."""
    wins, prs, cfg, params = _batch6(fx)
    out, (c0, c1, ncull, iters, acc) = multi_seq.optimize_batch(
        multi_seq.stack_windows(wins), multi_seq.stack_priors(prs), cfg, params, iters=8)
    ref = unflatten(fx, "batch6/out/")
    for i in range(3):
        w, (s1, s2, nc) = tlm.optimize(wins[i], prs[i], cfg, params, iters=8)
        assert (int(ncull[i]), int(iters[i]), int(acc[i])) == (
            int(nc), s1.iters_run + s2.iters_run, s1.accepted + s2.accepted)
        np.testing.assert_allclose(out.nodes.p[i].numpy(), w.nodes.p.numpy(), rtol=0, atol=1e-8)
        assert float(c1[i]) < float(c0[i])
        for k, got in (("n_culled", ncull), ("iters_run", iters), ("accepted", acc)):
            assert int(got[i]) == int(ref["stats"][k][i]), k
        for k in ("p", "v", "q"):
            assert_rel(getattr(out.nodes, k)[i], ref["window"]["nodes"][k][i], ITERATIVE, k)
        assert_rel(out.lm_invdepth[i], ref["window"]["lm_invdepth"][i], ITERATIVE, "invdepth")
    assert_rel(c1, ref["stats"]["cost1"], ITERATIVE, "cost1")


def test_optimize_batch_on_the_cpu_runs_eagerly(fx):
    """Off the card no chain is captured: the same key twice runs every
    chain eagerly both times, with the same bits and the JAX counts."""
    wins, prs, cfg, params = _batch6(fx)
    windows, priors = multi_seq.stack_windows(wins), multi_seq.stack_priors(prs)
    multi_seq.reset_graphs()
    first = multi_seq.optimize_batch(windows, priors, cfg, params, iters=8)
    n = multi_seq.graph_counts()
    second = multi_seq.optimize_batch(windows, priors, cfg, params, iters=8)
    assert n["captured"] == n["replayed"] == 0 and n["eager"] >= 5
    assert multi_seq.graph_counts() == dict(captured=0, replayed=0, eager=2 * n["eager"])
    assert all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(first),
                                                  torch.utils._pytree.tree_leaves(second)))
    ref = unflatten(fx, "batch6/out/")
    for k, got in zip(("n_culled", "iters_run", "accepted"), second[1][2:]):
        np.testing.assert_array_equal(got.numpy(), ref["stats"][k], err_msg=k)


def test_batch_members_stop_on_their_own(fx):
    """Phase 9's first four sequences of the 24 x 192 round: a sequence
    that stops is frozen while the others go on, as under jax.vmap; the
    counts are the JAX ``optimize_batch``'s."""
    seqs = [_round(fx, b) for b in range(chip_smoke.BATCH_JAX)]
    _, pr, cfg, params = seqs[0]
    out, (c0, c1, ncull, iters, acc) = multi_seq.optimize_batch(
        multi_seq.stack_windows([s[0] for s in seqs]), multi_seq.stack_priors([pr] * len(seqs)),
        cfg, params, iters=chip_smoke.ITERS)
    ref = unflatten(fx, "round/batch/")
    for k, got in (("n_culled", ncull), ("iters_run", iters), ("accepted", acc)):
        np.testing.assert_array_equal(got.numpy(), ref["stats"][k], err_msg=k)
    assert len(set(iters.tolist())) > 1 and int(ncull.max()) > 0
    for k in ("p", "v", "q"):
        assert_rel(getattr(out.nodes, k), ref["window"]["nodes"][k], ITERATIVE, k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_batch_members_follow_their_own_round(fx, dtype):
    """The three 6 x 24 windows cast to ``dtype``: each member of the batch
    makes its own ``lm.optimize``'s decisions (the same culls, iterations
    run and accepted steps), under the one rule both run, and lands where
    that round does: to 1e-8 m in float64, and in float32 to 1e-3 m, since
    the batched kernels round otherwise than the single window's and 8
    iterations from the perturbed starts leave up to 8.9e-4 m between
    them."""
    wins, prs, cfg, params = _batch6(fx)
    wins, prs = [cast(w, dtype) for w in wins], [cast(p, dtype) for p in prs]
    cfg, params = cast(cfg, dtype), cast(params, dtype)
    out, (_, _, ncull, iters, acc) = multi_seq.optimize_batch(
        multi_seq.stack_windows(wins), multi_seq.stack_priors(prs), cfg, params, iters=8)
    assert out.nodes.p.dtype == dtype
    atol = 1e-8 if dtype == torch.float64 else 1e-3
    for i in range(3):
        w, (s1, s2, nc) = tlm.optimize(wins[i], prs[i], cfg, params, iters=8)
        assert (int(ncull[i]), int(iters[i]), int(acc[i])) == (
            int(nc), s1.iters_run + s2.iters_run, s1.accepted + s2.accepted)
        np.testing.assert_allclose(out.nodes.p[i].numpy(), w.nodes.p.numpy(), rtol=0, atol=atol)


def test_optimize_sharded_matches_optimize_and_jax(fx):
    """Phase 9's sequence 0 (24 x 192, two outliers), 8 landmark shards
    against the single round, at tests/test_sharding.py's tolerances, and
    against the JAX ``optimize_sharded``."""
    win, pr, cfg, params = _round(fx, 0)
    mesh = Mesh({"lm": 8}, device=CPU)
    ref, (r1, r2, nr) = tlm.optimize(win, pr, cfg, params, iters=chip_smoke.ITERS)
    out, (s1, s2, ns) = lm_sharded.optimize_sharded(win, pr, cfg, params, mesh,
                                                    iters=chip_smoke.ITERS)
    assert int(ns) == int(nr) > 0
    assert (s1.accepted, s2.accepted) == (r1.accepted, r2.accepted)
    np.testing.assert_allclose(float(s2.cost1), float(r2.cost1), rtol=1e-8, atol=0)
    for k, tol in (("p", 1e-5), ("v", 1e-5), ("q", 1e-6)):
        np.testing.assert_allclose(getattr(out.nodes, k).numpy(), getattr(ref.nodes, k).numpy(),
                                   rtol=0, atol=tol)
    free = tasm.free_mask_lm(win).numpy()
    np.testing.assert_allclose(out.lm_invdepth.numpy()[free], ref.lm_invdepth.numpy()[free],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out.obs_valid.numpy(), ref.obs_valid.numpy())
    jx = unflatten(fx, "round/sharded/")
    assert int(jx["n_culled"]) == int(ns)
    assert (int(jx["stats1"]["accepted"]), int(jx["stats2"]["accepted"])) == (s1.accepted, s2.accepted)
    np.testing.assert_array_equal(out.obs_valid.numpy(), jx["window"]["obs_valid"])
    for k in ("p", "v", "q"):
        assert_rel(getattr(out.nodes, k), jx["window"]["nodes"][k], ITERATIVE, k)


def test_optimize_sharded_refuses_a_capacity_the_shards_do_not_divide(fx):
    wins, prs, cfg, params = _batch6(fx)  # 24 landmarks
    with pytest.raises(ValueError, match="must divide"):
        lm_sharded.optimize_sharded(wins[0], prs[0], cfg, params, Mesh({"lm": 5}, device=CPU))
    assert set(lm_sharded.window_pspec(wins[0]).values()) == {"lm", None}
    assert [f for f, a in lm_sharded.window_pspec(wins[0]).items() if a] == list(
        lm_sharded.LANDMARK_FIELDS)


def test_sharded_gn_step_matches_single_step(fx):
    """One damped GN step with 8 landmark shards against the single-path
    assembly and Schur solve (tests/test_sharding.py: 2e-5)."""
    wins, prs, cfg, params = _batch6(fx)
    win, pr = wins[1], prs[1]
    flags = tasm.RobustFlags(True, True)
    Hxx, gx, Hxl, hll, gl, _ = tasm.assemble_blocks(win, pr, cfg, params, flags)
    dx_x, dx_l = tasm.schur_solve_blocks(Hxx, gx, Hxl, hll, gl, 1e-4)
    ref = apply_delta(win, torch.cat([dx_x, dx_l]))
    out = schur.sharded_gn_step(win, pr, cfg, params, Mesh({"lm": 8}, device=CPU), lam=1e-4)
    for k in ("p", "v"):
        np.testing.assert_allclose(getattr(out.nodes, k).numpy(), getattr(ref.nodes, k).numpy(),
                                   rtol=0, atol=2e-5)
    free = tasm.free_mask_lm(win).numpy()
    np.testing.assert_allclose(out.lm_invdepth.numpy()[free], ref.lm_invdepth.numpy()[free],
                               rtol=0, atol=1e-5)


def test_estimator_with_a_mesh_makes_the_same_decisions():
    """``Estimator.set_mesh`` on the small fixture's ``gvins`` scenario:
    the JAX run's events, node times, keyframes, LM steps and culls, as
    the unsharded port run (tests/test_torch_estimator.py); a capacity the
    shards do not divide is refused; ``set_mesh(None)`` restores the
    single path."""
    small = dict(np.load(os.path.join(ROOT, "tests", "fixtures", "torch_estimator_small.npz")))
    s = chip_smoke.scenario(small, "gvins")
    est, got = chip_smoke.run_estimator(s, CPU, mesh=Mesh({"lm": 8}, device=CPU))
    chip_smoke.compare_estimator(got, {k[4:]: v for k, v in s.items() if k.startswith("out/")})
    with pytest.raises(ValueError, match="must divide"):
        est.set_mesh(Mesh({"lm": 5}, device=CPU))
    est.set_mesh(None)
    assert est.mesh is None


def _ba_problem(fx, name, n_chunks, sep_width):
    inp = unflatten(fx, f"{name}/in/")
    ba, dropped = ba_nodes.build_nodes_ba(
        to_torch(NavState, inp["nodes"], CPU), to_torch(PreintData, inp["preint"], CPU),
        inp["gnss_p"], inp["gnss_std"], inp["gnss_valid"], inp["lm_invd"], inp["lm_ref"],
        inp["obs_uv"], inp["obs_valid"], ext_p=np.zeros(3), ext_q=np.array([1.0, 0, 0, 0]),
        reproj_std=1.5 / 500.0, n_chunks=n_chunks, stencil=int(inp["stencil"]),
        sep_width=sep_width, device=CPU)
    return ba, dropped, inp


def test_ba_nodes_chunked_matches_one_chunk_and_jax(fx):
    """tests/test_ba_nodes.py's N = 32 problem: 8 chunks against 1 chunk
    (exact algebra up to the order of sums) and against the JAX solves; it
    converges as the JAX test requires."""
    sols = {}
    for n in (8, 1):
        ba, dropped, inp = _ba_problem(fx, "ba32", n, int(fx["ba32/in/sep_width"]) if n > 1 else 1)
        assert dropped == 0
        params = to_torch(IntegrationParams, inp["params"], CPU)
        sols[n] = ba_nodes.ba_nodes_solve(ba, params, Mesh({"nodes": n}, device=CPU),
                                          iters=int(inp["iters"]),
                                          sep_width=int(inp["sep_width"]) if n > 1 else 1)
    (o8, (c0, c1, nacc, _)), (o1, _) = sols[8], sols[1]
    for k in ("p", "v"):
        np.testing.assert_allclose(getattr(o8.nodes, k).numpy(), getattr(o1.nodes, k).numpy(),
                                   rtol=0, atol=1e-5)
    inv = lambda o: np.sort(o.lm_invdepth.numpy()[o.lm_valid.numpy()])  # noqa: E731
    np.testing.assert_allclose(inv(o8), inv(o1), rtol=0, atol=1e-6)
    for n, o in ((8, o8), (1, o1)):
        jx = unflatten(fx, f"ba32/chunks{n}/")
        assert int(sols[n][1][2]) == int(jx["stats"]["accepted"])
        for k in ("p", "v", "q"):
            assert_rel(getattr(o.nodes, k), jx["nodes"][k], ITERATIVE, k)
        np.testing.assert_allclose(o.lm_invdepth.numpy(), jx["lm_invdepth"], rtol=0, atol=1e-9)
    assert float(c1) < 0.2 * float(c0) and nacc >= 3
    p_t = fx["ba32/in/truth_p"]
    err0 = np.linalg.norm(fx["ba32/in/nodes/p"] - p_t, axis=1)
    err1 = np.linalg.norm(o8.nodes.p.numpy() - p_t, axis=1)
    assert np.sqrt((err1**2).mean()) < min(0.4 * np.sqrt((err0**2).mean()), 0.08)


def test_build_nodes_ba_masks_and_counts(fx):
    """N = 256, landmarks across every cut: a band of 8 keeps every
    observation, the one-node band masks some (tests/test_ba_nodes.py),
    and chunk c's local node set starts B nodes before its first node
    (chunk 0: B masked copies of node 0), as the JAX ``_take_local``."""
    _, dropped_band, _ = _ba_problem(fx, "ba256", 8, 8)
    _, dropped_one, _ = _ba_problem(fx, "ba256", 8, 1)
    assert dropped_band == 0 and dropped_one > 0
    import jax.numpy as jnp

    from ic_gvins_tpu.parallel import ba_nodes as jba

    N, S, B = 256, 8, 8
    C = N // S
    idx, ok = ba_nodes.local_node_index(S, C, B)
    nodes = jnp.arange(N, dtype=jnp.float64)[:, None]
    for c in range(S):
        loc, val = jba._take_local(nodes, jnp.ones(N, bool), c, C, B)
        np.testing.assert_array_equal(idx[c].numpy(), np.asarray(loc)[:, 0].astype(int))
        np.testing.assert_array_equal(ok[c].numpy(), np.asarray(val))


def test_residual_helpers_match_jax():
    import jax.numpy as jnp

    from ic_gvins_tpu.factors import residuals as jres
    from ic_gvins_tpu_torch.factors import residuals as tres

    rng = np.random.default_rng(0)
    q = rng.standard_normal((16, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.standard_normal((16, 4))
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    v = [rng.standard_normal((16, 3)) for _ in range(6)]
    std = np.abs(rng.standard_normal(9)) + 0.1
    cases = (
        ("gnss_residual", (v[0], q, v[1][0], v[2], np.abs(v[3]) + 0.1)),
        ("pose_prior_residual", (v[0], q, v[1], q2, std[:6])),
        ("mix_prior_residual", (*v, std)),
        ("bias_soft_residual", (v[0], v[1], 0.3, 0.02)),
    )
    for name, args in cases:
        want = jnp.stack([getattr(jres, name)(*(a[i] if np.ndim(a) and len(a) == 16 else a
                                                for a in args)) for i in range(16)])
        got = getattr(tres, name)(*(torch.as_tensor(np.asarray(a)) for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13,
                                   err_msg=name)
    chi2 = np.concatenate([[0.0, 1e-40, 0.5, 1.0], np.abs(rng.standard_normal(12)) * 30])
    np.testing.assert_allclose(tres.huber_weight(torch.as_tensor(chi2)).numpy(),
                               np.asarray(jres.huber_weight(jnp.asarray(chi2))), rtol=1e-15)
