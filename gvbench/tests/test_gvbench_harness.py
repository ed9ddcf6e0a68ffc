"""The harness's bookkeeping on the CPU: finding a cell's files by name,
``BENCHMARK.json`` against the contract's shape, the window arithmetic,
the KLT work count and the comparison's gap."""

import json
import re

import numpy as np
import pytest
import torch

from gvbench import harness, klt_work, trace
from gvbench.reference.vision import klt
from gvbench.reference.vision.pyramid import build_pyramid
from gvbench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def spec():
    return harness.Spec(REPO)


def test_finds_every_file_by_name(spec):
    for w in spec.data["workloads"]:
        traffic = spec.traffic(w["traffic"])
        assert harness.driver(traffic["kind"]).run
        assert spec.config(w["config"])["name"] == w["config"]
        assert spec.limits(traffic["kind"])
    for m in spec.data["end_to_end"] + spec.data["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_benchmark_json_shape(spec):
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in d[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"]: w for w in d["workloads"]}
    for m in d["per_layer"]:
        reporters = e2e[m["moves"]].get("workloads", list(cells))
        assert set(m["workloads"]) <= set(reporters), m["name"]
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
        ms = [m for m in d["per_layer"] if w["name"] in m["workloads"]]
        assert ms and any(w["name"] in m.get("workloads", [w["name"]])
                          for m in d["end_to_end"] if m["name"] != "setup_s")
    for c in d["configs"]:
        assert c["file"].startswith("gvbench/")
        assert json.loads((REPO / c["file"]).read_text())["dtype"] == "float64"


def test_window_arithmetic(spec):
    frame_ms = [float(x) for x in range(1, 101)]
    ctx = {"window": {"wall_s": 40.0, "data_s": 16.0, "frame_ms": frame_ms,
                      "frontend_ms": [10.0] * 100,
                      "stage_ms": {"optimize": [300.0, 500.0], "preintegrate": [5.0] * 4,
                                   "marginalize": [20.0]}},
           "setup_s": 30.0}
    read = lambda n: spec.reader(n)(ctx)  # noqa: E731
    assert read("data_rate") == pytest.approx(0.4)
    # every frame counts: numpy's 90th percentile of 1..100 ms
    assert read("frame_ms.p90") == pytest.approx(np.percentile(frame_ms, 90)) == 90.1
    assert read("frontend_ms") == 10.0
    assert read("optimize_ms") == 400.0  # the mean of all rounds, not a median
    host = (sum(frame_ms) - 1000.0 - 800.0 - 20.0 - 20.0) / 16.0
    assert read("host_ms") == pytest.approx(host)
    assert read("setup_s") == 30.0
    batch = {"window": {"wall_s": 10.0, "calls": 12, "batch": 32}}
    assert spec.reader("windows_per_s")(batch) == pytest.approx(38.4)
    # a reader with nothing to read returns nothing
    assert spec.reader("klt_roofline")({"trace": None}) is None


def test_trace_arithmetic(spec):
    # overlapping device intervals count once
    assert trace.union_length([(0, 10), (5, 12), (20, 25), (24, 24.5)]) == 17.0
    assert trace.merged([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]
    assert trace.count_in([1, 2, 3, 7, 8], [(0, 2), (7, 9)]) == 4
    tr = {"window_s": 2.0, "busy_s": 0.5, "span_calls": {"optimize": 2, "batch": 4},
          "span_launches": {"optimize": 74000, "batch": 160000},
          "kernel_s": {"klt_bidirectional_kernel": 4e-4}, "klt_bound_s": 1e-5}
    ctx = {"trace": tr}
    assert spec.reader("device_idle.replay")(ctx) == 75.0
    assert spec.reader("device_idle.batch")(ctx) == 75.0
    assert spec.reader("lm_launches")(ctx) == 37000
    assert spec.reader("batch_launches")(ctx) == 40000
    assert spec.reader("klt_roofline")(ctx) == pytest.approx(2.5)


def _pyramids(seed):
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((1, 1, 30, 40), generator=g, dtype=torch.float32) * 255
    img = torch.nn.functional.interpolate(base, size=(240, 320), mode="bilinear")[0, 0]
    shifted = torch.roll(img, shifts=(1, 2), dims=(0, 1))
    return build_pyramid(img, 3), build_pyramid(shifted.contiguous(), 3)


def test_klt_work_counted_from_inputs():
    pyr0, pyr1 = _pyramids(0)
    n = 50
    g = torch.Generator().manual_seed(1)
    pts = (torch.rand((n, 2), generator=g) * torch.tensor([240.0, 160.0]) + 40).float()
    valid = torch.ones(n, dtype=torch.bool)
    valid[::7] = False
    passes, steps = klt_work.count(pyr0, pyr1, pts, pts, valid)
    # at most a pass per valid feature, level and direction
    assert all(0 < p <= 2 * int(valid.sum()) for p in passes)
    assert sum(passes) <= steps <= sum(passes) * klt.MAX_ITERS
    # the counting copy tracks exactly as the frozen tracker
    p_ref, ok_ref, _ = klt.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid)
    pf, okf = klt_work._track(pyr0, pyr1, pts, pts, valid, [0] * 4, [0])
    assert torch.equal(pf, klt.lk_track(pyr0, pyr1, pts, pts, valid)[0])
    # the bound: bytes of the passes (capped by the levels) and the flop
    t, by = klt_work.bound(passes, steps, n, pyr0)
    nbytes = sum(min(p * klt_work.BYTES_PER_PASS, 2 * x.numel() * 4)
                 for p, x in zip(passes, pyr0)) + n * klt_work.BYTES_PER_FEATURE
    flop = sum(passes) * klt_work.FLOP_PER_PASS + steps * klt_work.FLOP_PER_STEP
    assert t == max(nbytes / 3.35e12, flop / 67e12)
    assert by == ("bytes" if nbytes / 3.35e12 >= flop / 67e12 else "operations")
    assert ok_ref.any()


def test_tree_gap():
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    a = (f64([1.0, 2.0]), torch.tensor([True, False]), f64([100.0]))
    assert harness.tree_gap(a, a) == 0.0
    b = (f64([1.0, 2.0 + 1e-6]), a[1], a[2])
    # against the larger of the leaf's scale (2) and the median leaf's (51)
    assert harness.tree_gap(b, a) == pytest.approx(1e-6 / 51.0)
    c = (a[0], torch.tensor([True, True]), a[2])
    assert harness.tree_gap(c, a) == 1.0
    d = (f64([1.0, float("nan")]), a[1], a[2])
    assert harness.tree_gap(d, a) == float("inf")


def test_sampler_keeps_a_uniform_sample_and_the_top():
    counts = np.zeros(20)
    for seed in range(400):
        s = harness.Sampler(3, np.random.default_rng(seed), key=lambda out: -abs(out - 7))
        for i in range(20):
            s.offer(lambda i=i: i, i)
        got = s.records()
        assert s.seen == 20 and 7 in got and got == sorted(got)
        assert len([x for x in got if x != 7]) >= 2 and len(got) <= 4
        counts[[x for x in got if x != 7][:3]] += 1
    # every call is as likely to be drawn: 3 of 20 over 400 runs, 60 each
    assert counts[[i for i in range(20) if i != 7]].min() > 25
    only = harness.Sampler(100, np.random.default_rng(0), when=lambda: flag[0])
    flag = [False]
    only.offer(lambda: "a", None)
    flag[0] = True
    only.offer(lambda: "b", None)
    assert only.records() == ["b"] and only.seen == 1


def test_assembly_gap_against_the_truth():
    from gvbench.drivers import replay
    from gvbench.gen import streams
    from gvbench.reference.data import simulator as sim
    from gvbench.reference.solver.window import empty_window

    cpu = torch.device("cpu")
    traj = sim.car_trajectory(speed=1.4)
    params = sim.default_params(with_earth=True, device=cpu)
    q_bc = torch.tensor([0.5, 0.5, 0.5, 0.5], dtype=torch.float64)
    t_bc = torch.tensor([0.074, -0.03, 0.128], dtype=torch.float64)
    s = streams.Replay(*([None] * 10), traj=traj, params=params, t_bc=t_bc, q_bc=q_bc)
    N, L = 8, 40
    times = torch.arange(N, dtype=torch.float64) * 0.4 + 3.0
    g = torch.Generator().manual_seed(0)
    lms = sim.scatter_landmarks(traj, params, g, L, 3.0, 6.0, lateral=20.0,
                                depth_range=(5.0, 40.0))
    uv, vis = sim.project_landmarks(traj, params, lms, times, t_bc, q_bc)
    win = empty_window(N, L, dtype=torch.float64, device=cpu)
    win = win._replace(nodes=win.nodes._replace(time=times),
                       node_valid=torch.ones(N, dtype=torch.bool), obs_uv=uv, obs_valid=vis,
                       lm_valid=vis.sum(1) >= 2)
    assert vis.sum() > 100
    assert replay.assembly_gap(win, s, 787.0) == 0.0
    # slots that take another landmark's observation at one node
    mixed = uv.clone()
    both = torch.nonzero(vis[:, 3] & (vis.sum(1) >= 3))[:, 0]
    k = len(both) // 2
    assert k >= 3
    mixed[both[:k], 3] = uv[both[k:2 * k], 3]
    gap = replay.assembly_gap(win._replace(obs_uv=mixed), s, 787.0)
    assert gap > 0.02
    # a slot the program has not triangulated does not enter the round
    assert replay.assembly_gap(win._replace(obs_uv=mixed, lm_valid=win.lm_valid.index_fill(
        0, both[:k], False)), s, 787.0) == 0.0
    # two nodes' stamps swapped: their observations lie at the wrong node
    swapped = times.clone()
    swapped[[3, 4]] = times[[4, 3]]
    assert replay.assembly_gap(win._replace(nodes=win.nodes._replace(time=swapped)), s,
                               787.0) > 0.05
