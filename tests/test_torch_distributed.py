"""PyTorch port: ``parallel/`` across ``torch.distributed`` ranks on the
CPU. Each case spawns 2 ranks (``chip_smoke.spawn_ranks``: the ``spawn``
start method, ``gloo`` on a free 127.0.0.1 port, a process-group timeout
of ``chip_smoke.DIST_TIMEOUT`` s on each collective and at most
SPAWN_TIMEOUT s for the whole spawn, so a hang fails) on one small
problem; while they run, this process computes the one-process reference.

Bounds: every rank's results bit for bit rank 0's; against one process
with the same global shard count the same decisions (accepted steps,
iterations, culls, ``obs_valid``) and positions within 1e-10 m
(``chip_smoke.DIST_POS_ATOL``: only the order of the sums over the ranks
differs); against the JAX package's results
(``tests/fixtures/torch_parallel.npz``, ``torch_multihost.npz``) the same
decisions and 1e-8 m (``DIST_JAX_POS_ATOL``, tests/test_multihost.py).
The float32 round is held against the one-process float32 round with the
same decisions and float32 rounding of its positions (1e-4 m). The
collectives are held exactly on integer-valued data, and with no process
group bit for bit against the plain sum / max."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_solver import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

from ic_gvins_tpu_torch.convert import unflatten  # noqa: E402
from ic_gvins_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    assemble,
    ba_nodes,
    multi_seq,
    pmax,
    psum,
    psum_packed,
    schur,
)
from ic_gvins_tpu_torch.parallel.lm_sharded import optimize_sharded  # noqa: E402

RANKS = 2
SPAWN_TIMEOUT = 120.0  # s
CPU = "cpu"
POS_ATOL = chip_smoke.DIST_POS_ATOL
JAX_POS_ATOL = chip_smoke.DIST_JAX_POS_ATOL
F32_POS_ATOL = 1e-4  # m


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(chip_smoke.PARALLEL_FIXTURE))


def _ranks(tmp_path, case, meanwhile=None, **kwargs):
    """Rank 0's results of ``case`` on RANKS ranks (checked bit for bit
    against every other rank's) and what ``meanwhile()`` returned, run here
    while the ranks ran."""
    res, ref = chip_smoke.spawn_ranks(RANKS, case, [CPU] * RANKS, str(tmp_path), kwargs=kwargs,
                                      timeout=SPAWN_TIMEOUT, threads=1, meanwhile=meanwhile)
    assert chip_smoke.same_bits(res), f"{case}: the ranks' results differ from rank 0's"
    return res[0], ref


def _max(a, b):
    return chip_smoke.max_abs(a, b)


def test_collectives_across_ranks_and_alone(tmp_path):
    """2 ranks x 2 local shards: psum / pmax / psum_packed / psum_rank0 /
    assemble equal the one-process reductions (integer-valued data, exact
    in any order), in 6 all-reduces; with no process group each is the
    plain reduction bit for bit and makes no collective."""
    r, _ = _ranks(tmp_path, "collectives")
    x, rows = r["x"], r["rows"]
    np.testing.assert_array_equal(r["psum"], x.sum(0))
    np.testing.assert_array_equal(r["pmax"], x.max(0))
    np.testing.assert_array_equal(r["packed0"], x.sum(0))
    np.testing.assert_array_equal(r["packed1"], 2 * x[:, 0].sum(0))
    assert float(r["rank0"]) == float(x[:, 0, 0].sum()) + 0.5
    np.testing.assert_array_equal(r["rank0_max"], [x[:, 0, 0].sum() + x[0, 0, 0], x[:, 1, 1].max()])
    np.testing.assert_array_equal(r["rows_whole"], rows)
    np.testing.assert_array_equal(r["rep_whole"], x[0])
    np.testing.assert_array_equal(r["mask_whole"], x > 0)
    assert int(r["all_reduces"]) == 6

    mesh = Mesh({"lm": 4}, device=CPU)
    assert (mesh.world, mesh.rank, mesh.local("lm"), mesh.distributed) == (1, 0, 4, False)
    y = torch.as_tensor(np.random.default_rng(0).standard_normal((4, 5, 3)))
    assert torch.equal(psum(y, mesh), y.sum(0)) and torch.equal(pmax(y, mesh), y.amax(0))
    assert torch.equal(psum(y), y.sum(0)) and torch.equal(pmax(y), y.amax(0))
    a, b = psum_packed([y, y[:, 0]], mesh)
    assert torch.equal(a, y.sum(0)) and torch.equal(b, y[:, 0].sum(0))
    assert assemble([(y, 0, 4), (y[0], None, 0)], mesh)[0] is y
    assert mesh.all_reduces == 0


def test_optimize_sharded_across_ranks(tmp_path, fx):
    """Phase 9's sequence 0 (24 x 192, two outliers), 8 global landmark
    shards, 4 a rank: the one-process 8-shard round's decisions and culls,
    its positions within 1e-10 m, JAX's ``optimize_sharded`` within 1e-8 m
    (3 all-reduces an iteration: the state system, the reduced system, the
    cost with the step's max; 4 more: the two starting costs, the cull and
    the gather)."""
    def one_process():
        win, pr, cfg, params = chip_smoke.round_sequence(0, CPU)
        return optimize_sharded(win, pr, cfg, params, Mesh({"lm": 8}, device=CPU),
                                iters=chip_smoke.ITERS)

    r, (ref, stats) = _ranks(tmp_path, "round", one_process)
    np.testing.assert_array_equal(r["decisions"], chip_smoke.round_decisions(stats))
    assert int(r["decisions"][4]) > 0
    np.testing.assert_array_equal(r["window"]["obs_valid"], ref.obs_valid.numpy())
    for k in ("p", "v", "q"):
        assert _max(r["window"]["nodes"][k], getattr(ref.nodes, k)) <= POS_ATOL, k
    assert _max(r["window"]["lm_invdepth"], ref.lm_invdepth) <= POS_ATOL
    jx = unflatten(fx, "round/sharded/")
    assert int(jx["n_culled"]) == int(r["decisions"][4])
    assert (int(jx["stats1"]["accepted"]), int(jx["stats2"]["accepted"])) == tuple(
        r["decisions"][:2])
    np.testing.assert_array_equal(r["window"]["obs_valid"], jx["window"]["obs_valid"])
    assert _max(r["window"]["nodes"]["p"], jx["window"]["nodes"]["p"]) <= JAX_POS_ATOL
    assert int(r["time"]["all_reduces"]) == 3 * int(r["decisions"][2:4].sum()) + 4


def test_optimize_sharded_float32_across_ranks(tmp_path):
    """The same round in float32 against the one-process float32 8-shard
    round: the same decisions, positions within float32 rounding."""
    def one_process():
        win, pr, cfg, params = chip_smoke.round_sequence(0, CPU, torch.float32)
        return optimize_sharded(win, pr, cfg, params, Mesh({"lm": 8}, device=CPU),
                                iters=chip_smoke.ITERS)

    r, (ref, stats) = _ranks(tmp_path, "round", one_process, dtype="float32")
    assert r["window"]["nodes"]["p"].dtype == np.float32
    np.testing.assert_array_equal(r["decisions"], chip_smoke.round_decisions(stats))
    np.testing.assert_array_equal(r["window"]["obs_valid"], ref.obs_valid.numpy())
    assert _max(r["window"]["nodes"]["p"], ref.nodes.p) <= F32_POS_ATOL


def test_sharded_gn_step_across_ranks(tmp_path, fx):
    """One damped GN step with 8 landmark shards, 4 a rank, against the
    one-process 8-shard step, in 3 all-reduces (the state system, the
    reduced system, the gather)."""
    def one_process():
        wins, prs, cfg, params = chip_smoke.batch6_inputs(fx, CPU)
        return schur.sharded_gn_step(wins[1], prs[1], cfg, params, Mesh({"lm": 8}, device=CPU),
                                     lam=1e-4)

    r, ref = _ranks(tmp_path, "gn_step", one_process)
    for k in ("p", "v", "q"):
        assert _max(r["window"]["nodes"][k], getattr(ref.nodes, k)) <= POS_ATOL, k
    assert _max(r["window"]["lm_invdepth"], ref.lm_invdepth) <= POS_ATOL
    assert int(r["all_reduces"]) == 3


def test_ba_nodes_across_ranks(tmp_path, fx):
    """tests/test_ba_nodes.py's N = 32 problem, 8 chunks, 4 a rank, against
    one process with 8 chunks and JAX's ``ba32/chunks8``."""
    def one_process():
        ba, _, params, iters = chip_smoke.ba_problem(fx, "ba32", 8, 1, CPU)
        return ba_nodes.ba_nodes_solve(ba, params, Mesh({"nodes": 8}, device=CPU), iters=iters)

    r, (ref, (c0, c1, nacc, it)) = _ranks(tmp_path, "ba", one_process, name="ba32")
    np.testing.assert_array_equal(r["decisions"], [nacc, it])
    for k in ("p", "v", "q"):
        assert _max(r["nodes"][k], getattr(ref.nodes, k)) <= POS_ATOL, k
    assert _max(r["lm_invdepth"], ref.lm_invdepth) <= POS_ATOL
    jx = unflatten(fx, "ba32/chunks8/")
    assert int(r["decisions"][0]) == int(jx["stats"]["accepted"])
    assert _max(r["nodes"]["p"], jx["nodes"]["p"]) <= JAX_POS_ATOL
    assert _max(r["lm_invdepth"], jx["lm_invdepth"]) <= 1e-9
    assert float(r["cost"][1]) < 0.2 * float(r["cost"][0])


def test_optimize_batch_across_ranks(tmp_path, fx):
    """``batch6``'s three windows over 2 ranks, split 1 + 2 by
    ``shard_batch``, made whole by ``gather_batch``, against one process's
    ``optimize_batch`` of the three and JAX's."""
    def one_process():
        wins, prs, cfg, params = chip_smoke.batch6_inputs(fx, CPU)
        return multi_seq.optimize_batch(multi_seq.stack_windows(wins),
                                        multi_seq.stack_priors(prs), cfg, params, iters=8)

    r, (ref, stats) = _ranks(tmp_path, "batch", one_process, source="batch6")
    assert int(r["rank"]["n_local"]) == 1
    np.testing.assert_array_equal(r["stats"][2:], np.stack([x.numpy() for x in stats[2:]]))
    for k in ("p", "v", "q"):
        assert _max(r["nodes"][k], getattr(ref.nodes, k)) <= POS_ATOL, k
    jx = unflatten(fx, "batch6/out/")
    for i, k in enumerate(("n_culled", "iters_run", "accepted")):
        np.testing.assert_array_equal(r["stats"][2 + i], jx["stats"][k], err_msg=k)
    assert _max(r["nodes"]["p"], jx["window"]["nodes"]["p"]) <= JAX_POS_ATOL


def test_estimator_set_mesh_across_ranks(tmp_path):
    """``Estimator.set_mesh`` with 8 global landmark shards over 2 ranks on
    the small fixture's ``gvins`` scenario: the JAX run's events, node
    times, keyframes, LM steps and culls, its trajectory within 1e-8 m /
    1e-8 rad (``chip_smoke.compare_estimator``), on every rank bit for
    bit."""
    r, _ = _ranks(tmp_path, "estimator", name="small")
    s = chip_smoke.estimator_scenario("small")
    chip_smoke.compare_estimator(r["got"], {k[4:]: v for k, v in s.items() if k.startswith("out/")})


def test_multihost_runner(tmp_path):
    """``python -m ic_gvins_tpu_torch.tools.multihost_lm`` in 2 processes x
    4 shards on the CPU (``gloo``): its JSON line is ``ok``, within 1e-8 m
    of the port's single path and of the JAX runner's round."""
    init = f"tcp://127.0.0.1:{chip_smoke.free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ic_gvins_tpu_torch.tools.multihost_lm", "--init", init,
         "--nproc", "2", "--pid", str(pid), "--local-shards", "4", "--backend", "gloo",
         "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs
    rec = json.loads(outs[0][0].strip().splitlines()[-1])
    assert rec["ok"] and rec["backend"] == "gloo", rec
    assert rec["n_processes"] == 2 and rec["n_global_shards"] == 8, rec
    assert rec["max_node_p_err"] < 1e-8 and rec["max_node_p_err_jax"] < 1e-8, rec
    assert not outs[1][0].strip()


def test_ranks_refuse_what_they_cannot_run(tmp_path):
    """A shard count the world does not divide, and a window, a BA problem
    or an estimator on another device than the rank's mesh, raise."""
    r, _ = _ranks(tmp_path, "guards")
    assert {k: int(v) for k, v in r.items()} == {
        "odd_count": 1, "round_device": 1, "ba_device": 1, "estimator_device": 1}
