"""PyTorch port on the card: the Hopper KLT kernel against its plain
PyTorch version, the solver's fixed-order sum, ``optimize_batch`` and the
single window's ``lm.optimize`` and the IMU preintegration replayed from
CUDA graphs against their eager runs, the estimator's rounds and
preintegrations replayed, and a full-width
``Pipeline`` replay clearing the landmark slots that die with a
marginalized anchor. Imports neither jax nor
the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips."""

import json
import os

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import chip_smoke
from ic_gvins_tpu_torch.convert import cast
from ic_gvins_tpu_torch.ins import preintegration as tpre
from ic_gvins_tpu_torch.parallel import multi_seq
from ic_gvins_tpu_torch.solver import graphs, lm
from ic_gvins_tpu_torch.solver.assembly import index_sum_
from ic_gvins_tpu_torch.vision import klt, klt_cuda
from ic_gvins_tpu_torch.vision.pyramid import build_pyramid


def _texture(h, w, seed):
    """Smooth random texture plus fine detail (bilinear-upsampled grid)."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(h // 16 + 2, w // 16 + 2) * 255
    ys, xs = np.arange(h) / 16, np.arange(w) / 16
    y0, x0 = ys.astype(int), xs.astype(int)
    ay, ax = (ys - y0)[:, None], (xs - x0)[None, :]
    img = (coarse[y0][:, x0] * (1 - ay) * (1 - ax) + coarse[y0][:, x0 + 1] * (1 - ay) * ax
           + coarse[y0 + 1][:, x0] * ay * (1 - ax) + coarse[y0 + 1][:, x0 + 1] * ay * ax)
    return (img + rng.rand(h, w) * 40).astype(np.float32)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64, 513, 4000, "border"])
def test_kernel_matches_plain_version(n):
    """Kernel vs plain version on one card; the window sums are reduced in
    another order, so points agree to rounding except where a step sits on
    the 0.01 px stop threshold (< 0.05 px). "border" puts 64 features on
    the entry gate's edges (x = 10, x = w - 11, y = 10, y = h - 11), where
    the staged tiles reach past the image."""
    dev = _device()
    img0 = _texture(240, 320, 7)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    pyr0 = build_pyramid(torch.from_numpy(img0).to(dev), 3)
    pyr1 = build_pyramid(torch.from_numpy(img1).to(dev), 3)
    if n == "border":
        n = 64
        rng = np.random.default_rng(0)
        pts = rng.random((n, 2)) * [300, 220] + 10
        pts[0::4, 0], pts[1::4, 0], pts[2::4, 1], pts[3::4, 1] = 10, 320 - 11, 10, 240 - 11
    else:
        rng = np.random.default_rng(n)
        pts = rng.random((n, 2)) * [300, 220] + 10
    pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    before = klt_cuda.lk_track_bidirectional.launches
    pk, ok_k, fb_k = klt_cuda.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid)
    pp, ok_p, _ = klt.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid)
    torch.cuda.synchronize()
    assert klt_cuda.lk_track_bidirectional.launches == before + 1
    assert pk.shape == (n, 2) and pk.is_contiguous() and ok_k.dtype == torch.bool
    assert not bool((ok_k & ~valid).any())
    assert float((ok_k == ok_p).float().mean()) >= 0.95
    both = ok_k & ok_p
    if bool(both.any()):
        assert float((pk - pp).abs()[both].max()) <= 0.05
        assert bool(torch.isfinite(fb_k[both]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("move", [(-16, 0), (0, 16), (12, -12)])
def test_kernel_follows_a_long_move_within_one_level(move):
    """One pyramid image of a very smooth texture, moved by more than the
    staged search tile's margin: the estimate leaves the tile, the kernel
    reloads it around the new estimate and still agrees with the plain
    version."""
    dev = _device()
    rng = np.random.RandomState(3)
    coarse = rng.rand(8, 10) * 255  # one blob per 48 px: LK converges from 16 px away
    ys, xs = np.linspace(0, 6.999, 288), np.linspace(0, 8.999, 384)
    y0, x0 = ys.astype(int), xs.astype(int)
    sy, sx = ys - y0, xs - x0
    sy, sx = (sy * sy * (3 - 2 * sy))[:, None], (sx * sx * (3 - 2 * sx))[None, :]
    img0 = np.ascontiguousarray(
        coarse[y0][:, x0] * (1 - sy) * (1 - sx) + coarse[y0][:, x0 + 1] * (1 - sy) * sx
        + coarse[y0 + 1][:, x0] * sy * (1 - sx) + coarse[y0 + 1][:, x0 + 1] * sy * sx,
        dtype=np.float32)
    img1 = np.roll(img0, (move[1], move[0]), axis=(0, 1))
    pyr0 = (torch.from_numpy(img0).to(dev),)
    pyr1 = (torch.from_numpy(img1).to(dev),)
    pts = torch.as_tensor(rng.rand(64, 2) * [280, 190] + 50, dtype=torch.float32, device=dev)
    valid = torch.ones(64, dtype=torch.bool, device=dev)
    pk, ok_k, _ = klt_cuda.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid, fb_thresh=2.0)
    pp, ok_p, _ = klt.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid, fb_thresh=2.0)
    torch.cuda.synchronize()
    both = ok_k & ok_p
    far = ((pk - pts).abs().max(1).values > 11.0) & both  # these left the first tile
    assert int(far.sum()) >= 8
    assert float((ok_k == ok_p).float().mean()) >= 0.95
    assert float((pk - pp).abs()[both].max()) <= 0.05


@pytest.mark.cuda
def test_kernel_counts_its_work():
    """The counted call gives the same results plus per-feature work: an
    invalid feature runs nothing, a valid interior one 8 level passes (4
    levels, both directions) and at least one step per pass."""
    dev = _device()
    pyr = build_pyramid(torch.from_numpy(_texture(240, 320, 7)).to(dev), 3)
    pts = torch.tensor([[160.0, 120.0], [100.0, 90.0]], device=dev)
    valid = torch.tensor([True, False], device=dev)
    pk, ok, fb, work = klt_cuda.lk_track_bidirectional_counted(pyr, pyr, pts, pts, valid)
    pp, ok_p, fb_p = klt_cuda.lk_track_bidirectional(pyr, pyr, pts, pts, valid)
    assert torch.equal(pk, pp) and torch.equal(ok, ok_p) and torch.equal(fb, fb_p)
    assert ok.tolist() == [True, False]
    assert work[1].tolist() == [0, 0]
    assert int(work[0, 0]) == 0x2222 and 8 <= int(work[0, 1]) <= 8 * 30
    assert klt_cuda.passes_per_level(work, 4) == [2, 2, 2, 2]
    with pytest.raises(ValueError):
        klt_cuda.lk_track_bidirectional_counted(
            tuple(x.cpu() for x in pyr), tuple(x.cpu() for x in pyr), pts.cpu(), pts.cpu(),
            valid.cpu())


@pytest.mark.cuda
def test_no_features_no_launch():
    dev = _device()
    pyr = build_pyramid(torch.from_numpy(_texture(64, 64, 1)).to(dev), 2)
    pts = torch.zeros((0, 2), device=dev)
    before = klt_cuda.lk_track_bidirectional.launches
    pk, ok, fb = klt_cuda.lk_track_bidirectional(pyr, pyr, pts, pts,
                                                 torch.zeros(0, dtype=torch.bool, device=dev))
    assert pk.shape == (0, 2) and ok.shape == (0,) and fb.shape == (0,)
    assert klt_cuda.lk_track_bidirectional.launches == before


@pytest.mark.cuda
def test_kernel_rejects_cpu_cuda_mix():
    dev = _device()
    pyr = build_pyramid(torch.from_numpy(_texture(64, 64, 1)).to(dev), 2)
    pts = torch.full((4, 2), 32.0)
    with pytest.raises(ValueError):
        klt_cuda.lk_track_bidirectional(pyr, pyr, pts, pts, torch.ones(4, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_index_sum_repeats_on_the_card(dtype):
    """``index_sum_`` on the card, 6 x 6 blocks of 4096 landmarks into their
    24 anchor nodes: the same bits on every call (``index_add_``'s atomics
    give no such promise), and the CPU's float64 sum to rounding."""
    dev = _device()
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 24, 4096))
    src = torch.from_numpy(rng.standard_normal((4096, 6, 6)))
    outs = [index_sum_(torch.zeros((24, 6, 6), dtype=dtype, device=dev), idx.to(dev),
                       src.to(dev, dtype)) for _ in range(5)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = torch.zeros((24, 6, 6), dtype=torch.float64).index_add_(0, idx, src.to(dtype).double())
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    assert float((outs[0].cpu().double() - ref).abs().max()) <= tol


def _batch(dev, dtype=torch.float64, order=None):
    """``chip_smoke``'s phase-9 batch of 32 perturbed 24 x 192 windows (in
    ``order``) and its ``optimize_batch`` call."""
    wins, prior, cfg, params, _ = chip_smoke.parallel_round(dev)
    prior, cfg, params = (cast(x, dtype) for x in (prior, cfg, params))
    wins = [cast(wins[b], dtype) for b in (order or range(len(wins)))]
    windows = multi_seq.stack_windows(wins)
    priors = multi_seq.stack_priors([prior] * len(wins))
    return lambda: multi_seq.optimize_batch(windows, priors, cfg, params, iters=chip_smoke.ITERS)


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_optimize_batch_graph_equals_eager(dtype):
    """The same key three times: run eagerly, captured, replayed. The
    captured and the replayed call give the eager call's windows and
    statistics bit for bit; each chain is captured once, and every chain
    the eager call ran is replayed in each later call."""
    dev = _device()
    call = _batch(dev, dtype)
    multi_seq.reset_graphs()
    eager = call()
    n1 = multi_seq.graph_counts()
    assert n1["captured"] == n1["replayed"] == 0 and n1["eager"] > 0
    captured = call()
    n2 = multi_seq.graph_counts()
    assert n2 == dict(captured=5, replayed=n1["eager"], eager=n1["eager"])
    replayed = call()
    assert multi_seq.graph_counts() == dict(captured=5, replayed=2 * n1["eager"],
                                           eager=n1["eager"])
    assert _same_bits(captured, eager) and _same_bits(replayed, eager)
    assert eager[0].nodes.p.dtype == dtype and len(set(eager[1][3].tolist())) > 1


@pytest.mark.cuda
def test_optimize_batch_graph_refills_its_buffers():
    """A second batch of the same key, other values in every slot, through
    the graphs captured on the first gives its own eager run bit for bit,
    and leaves the first batch's returned tensors as they were."""
    dev = _device()
    other = _batch(dev, order=range(31, -1, -1))
    multi_seq.reset_graphs()
    ref = other()
    multi_seq.reset_graphs()
    first = _batch(dev)
    first()
    out = first()
    kept = pytree.tree_map(torch.clone, out)
    assert multi_seq.graph_counts()["captured"] == 5
    got = other()
    assert multi_seq.graph_counts()["captured"] == 5
    assert _same_bits(got, ref) and not _same_bits(got, out)
    assert _same_bits(out, kept)


# the estimator's two forms of a round: the initialization solve and the normal round
FORMS = {"warmup": dict(iters=30, do_cull=False), "normal": dict(iters=chip_smoke.ITERS)}


def _window_round(dev, dtype=torch.float64, member=0, form="normal"):
    """``lm.optimize`` of one member of phase 9's batch, a 24 x 192 window,
    in ``form``."""
    wins, prior, cfg, params, _ = chip_smoke.parallel_round(dev)
    win, prior, cfg, params = (cast(x, dtype) for x in (wins[member], prior, cfg, params))
    return lambda: lm.optimize(win, prior, cfg, params, **FORMS[form])


def _same(a, b) -> bool:
    """The same tree, tensors bit for bit and every other leaf equal."""
    (xs, sa), (ys, sb) = pytree.tree_flatten(a), pytree.tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                            for x, y in zip(xs, ys))


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_optimize_graph_equals_eager(dtype, form):
    """One window's round three times: run eagerly, captured, replayed. The
    captured and the replayed call give the eager call's window, ``LMStats``
    and cull count bit for bit; each chain is captured once (the normal
    round's two inits, two iterations and cull; the initialization solve's
    init and iteration), and every chain the eager call ran is replayed in
    each later call."""
    dev = _device()
    call = _window_round(dev, dtype, form=form)
    lm.reset_graphs()
    eager = call()
    n1 = lm.graph_counts()
    assert n1["captured"] == n1["replayed"] == 0 and n1["eager"] > 0
    captured = call()
    n_graphs = 5 if FORMS[form].get("do_cull", True) else 2
    assert lm.graph_counts() == dict(captured=n_graphs, replayed=n1["eager"], eager=n1["eager"])
    replayed = call()
    assert lm.graph_counts() == dict(captured=n_graphs, replayed=2 * n1["eager"],
                                     eager=n1["eager"])
    assert _same(captured, eager) and _same(replayed, eager)
    s1, s2, _ = eager[1]
    assert eager[0].nodes.p.dtype == dtype and s1.accepted > 0 and s2.iters_run > 0
    assert isinstance(s1.lam, float) and isinstance(s2.iters_run, int)


@pytest.mark.cuda
def test_optimize_graph_refills_its_buffers():
    """A second window of the same key through the graphs captured on the
    first gives its own eager round bit for bit, and leaves the first
    window's returned tensors as they were."""
    dev = _device()
    other = _window_round(dev, member=5)
    lm.reset_graphs()
    ref = other()
    lm.reset_graphs()
    first = _window_round(dev)
    first()
    out = first()
    kept = pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, out)
    assert lm.graph_counts()["captured"] == 5
    got = other()
    assert lm.graph_counts()["captured"] == 5
    assert _same(got, ref) and not _same(got, out)
    assert _same(out, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_preintegrate_graph_equals_eager(dtype, monkeypatch):
    """Intervals of each padded length (64, 128, 256 and 512 samples) and
    a batch of three through ``preintegrate``, twice: a key's first call
    runs eagerly, its second captures, every later one replays; each call
    gives the same call run eagerly at the same padded shape bit for bit,
    and a result kept from an earlier call is not changed by later ones
    (each is a copy of the graph's buffers)."""
    dev = _device()
    shapes = [(57, ()), (40, ()), (65, ()), (100, ()), (200, ()), (150, ()), (512, ()),
              (400, ()), (57, (3,)), (33, (3,))]
    cases = [chip_smoke.imu_case(n, lead, dtype, dev, seed)
             for seed, (n, lead) in enumerate(shapes)]
    with monkeypatch.context() as m:
        m.setattr(tpre._GRAPHS, "runner", lambda state, device: graphs.Eager(
            state, tpre._GRAPHS.counts))
        eager = [tpre.preintegrate(*c) for c in cases]
    tpre.reset_graphs()
    first = [tpre.preintegrate(*c) for c in cases]
    assert tpre.graph_counts() == dict(captured=5, replayed=5, eager=5)
    kept = pytree.tree_map(torch.clone, first)
    again = [tpre.preintegrate(*c) for c in cases]
    assert tpre.graph_counts() == dict(captured=5, replayed=15, eager=5)
    assert all(_same(a, e) and _same(b, e) for a, b, e in zip(first, again, eager))
    assert _same(first, kept) and eager[0].dp.dtype == dtype


def _replay_rounds(dev, n_rounds: int):
    """The benchmark's robot drive through the port's ``Pipeline`` until
    ``n_rounds`` estimator rounds have run: each round's statistics,
    ``lm.graph_counts()`` after it, whether it was a normal round (not the
    initialization solve) and ``tpre.graph_counts()`` after it."""
    from gvbench.drivers import replay
    from gvbench.gen import streams
    from ic_gvins_tpu_torch.engine.pipeline import Pipeline

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    read = lambda *p: json.loads(open(os.path.join(root, "gvbench", *p)).read())  # noqa: E731
    config, traffic = read("configs", "icgvins_robot_node.json"), read("traffic",
                                                                        "replay_robot.json")
    traffic["duration_s"] = 25.0
    s = streams.make_replay(config, traffic, 2**31 + 15, dev)
    pipe = Pipeline(replay.engine_config(config), device=dev,
                    use_clahe=config["pipeline"]["use_clahe"])
    feed, rows, counts, preint = replay.Feed(s), [], [], []
    while not feed.done() and len(rows) < n_rounds:
        feed.step(pipe)
        for row in pipe.est.stats[len(rows):]:
            rows.append(row)
            counts.append(lm.graph_counts())
            preint.append(tpre.graph_counts())
    assert len(rows) == n_rounds, "the drive ended first"
    cfg = pipe.est.cfg
    warm_nodes = max(cfg.warmup_min_preint, int(cfg.initlength))
    return rows, counts, [r["n_nodes"] - 1 >= warm_nodes for r in rows], preint


@pytest.mark.cuda
def test_estimator_rounds_replay_from_graphs(monkeypatch):
    """A full-width replay on the card: after the first round every round
    replays its chains (the initialization solves and the normal rounds
    share one key), and the rounds' iterations, iterations run and culls
    are those of the same replay with every chain run eagerly. The
    preintegrations run eagerly once per padded length (at most the four
    of 64 to 512 samples); from the first normal round on every one
    replays its graph."""
    dev = _device()
    lm.reset_graphs()
    tpre.reset_graphs()
    rows, counts, normal, preint = _replay_rounds(dev, 14)
    assert sum(normal) >= 3 and not all(normal)
    for before, after in zip(counts, counts[1:]):
        assert after["eager"] == before["eager"] and after["replayed"] > before["replayed"]
    assert counts[-1]["captured"] == 5
    first = normal.index(True)
    assert preint[-1]["eager"] == preint[first - 1]["eager"] <= 4
    assert preint[-1]["captured"] <= preint[-1]["eager"]
    for before, after, is_normal in zip(preint, preint[1:], normal[1:]):
        assert not is_normal or after["replayed"] > before["replayed"]
    monkeypatch.setattr(lm._GRAPHS, "runner", lambda state, device: graphs.Eager(
        state, lm._GRAPHS.counts))
    eager_rows, _, _, _ = _replay_rounds(dev, 14)
    keys = ("iterations", "iters_run", "culled")
    assert [[r[k] for k in keys] for r in rows] == [[r[k] for k in keys] for r in eager_rows]


@pytest.mark.cuda
def test_pipeline_replay_clears_dead_slots_at_full_width():
    """The benchmark's robot drive (``gvbench/configs/icgvins_robot.json``:
    1278 x 1022 at 20 Hz, 24 node x 192 landmark slots, float64) through
    the port's ``Pipeline`` on the card until a landmark slot that died
    with its marginalized anchor has been given to a new feature: after
    every marginalization the dead rows hold no observation, and after
    every frame no live slot holds one at a node before its anchor."""
    from gvbench.drivers import replay
    from gvbench.gen import streams
    from ic_gvins_tpu_torch.engine.pipeline import Pipeline

    dev = _device()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    read = lambda *p: json.loads(open(os.path.join(root, "gvbench", *p)).read())  # noqa: E731
    config, traffic = read("configs", "icgvins_robot.json"), read("traffic", "replay_robot.json")
    traffic["duration_s"] = 40.0
    s = streams.make_replay(config, traffic, 2**31 + 14, dev)
    pipe = Pipeline(replay.engine_config(config), device=dev,
                    use_clahe=config["pipeline"]["use_clahe"])
    est = pipe.est
    real, dead_ever, reused = est._marginalize_oldest, set(), set()

    def marginalize_oldest():
        lm_ref, lm_valid = est._npw("lm_ref"), est._npw("lm_valid")
        dead = [sl for sl in est.lm_slot.values() if lm_ref[sl] == 0 and lm_valid[sl]]
        real()
        assert not est._npw("obs_valid")[dead].any()
        assert not bool(est.window.obs_uv[dead].any()) and not bool(est.window.obs_vel[dead].any())
        dead_ever.update(dead)

    est._marginalize_oldest = marginalize_oldest
    feed = replay.Feed(s)
    while not feed.done() and not reused:
        feed.step(pipe)
        obs, ref = est._npw("obs_valid"), est._npw("lm_ref")
        slots = np.fromiter(est.lm_slot.values(), np.int64)
        before = obs[slots] & (np.arange(obs.shape[1])[None, :] < ref[slots][:, None])
        assert not before.any(), feed.t_last
        reused = set(slots.tolist()) & dead_ever
    assert reused, "no dead slot was given out again"
    assert est._dead_cleared["observations"] > 0
