"""PyTorch port, the estimator fed by an outside feature tracker
(``Estimator.add_frame_observations``), on the CPU at a small size with
seeded tracks from ``gvbench/gen/tracks.py``:

- the port's intake equals the plain reference of it
  (``gvbench/reference/feed.py``) on every frame once vision has joined:
  the keyframe decision and its kind, the slot map and the window's
  observation and landmark rows bit for bit, but the inverse depths that
  triangulation sets, which the reference solves in other arithmetic
  (within 1e-9 relative); over a run whose slot table fills, drops new
  tracks and frees slots;
- the counters count what happened (frames, tracks, keyframes, slots taken
  and dropped, host reads) and ``feed_ms`` has one entry a call;
- the tracks generator keeps its contract at the cell's own settings.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gvbench import harness  # noqa: E402
from gvbench.drivers import replay, tracks as drv  # noqa: E402
from gvbench.gen import tracks as gen  # noqa: E402
from gvbench.reference import feed as ref_feed  # noqa: E402
from gvbench.reference.data import simulator as sim  # noqa: E402
from gvbench.reference.data.types import ImuSeq  # noqa: E402
from gvbench.reference.vision import camera as cam_mod  # noqa: E402
from ic_gvins_tpu_torch.engine import estimator as est_mod  # noqa: E402
from ic_gvins_tpu_torch.engine.estimator import TRACKING_INITIALIZING, Estimator  # noqa: E402

CPU = torch.device("cpu")
CONFIG = os.path.join(ROOT, "gvbench", "configs", "icgvins_robot_tracks.json")
TRAFFIC = os.path.join(ROOT, "gvbench", "traffic", "tracks_robot.json")


def _load():
    return json.load(open(CONFIG)), json.load(open(TRAFFIC))


def small(max_landmarks=40):
    """The cell's configuration and traffic at CPU sizes: a 320 x 240
    camera at 10 Hz, 60 tracks a frame into 40 landmark slots, 14 nodes."""
    cfg, tr = _load()
    eng = cfg["engine"]
    eng.update(max_nodes=14, max_landmarks=max_landmarks, optimize_num_iterations=6,
               optimize_windows_size=5, track_max_features=60, imudatarate=100.0,
               track_min_parallax=12.0)
    eng["cam"].update(intrinsic=[240.0, 240.0, 160.0, 120.0], resolution=[320, 240])
    cfg["sensors"]["camera_rate"] = 10.0
    tr.update(duration_s=24.0)
    tr["tracker"]["max_tracks"] = 60
    return cfg, tr


@pytest.fixture(scope="module")
def fed():
    """A small run from its start, every frame's intake once vision has
    joined recorded by the benchmark's own watcher (``drivers/tracks.py``),
    with the tracks handed to each call and its ``feed_ms`` entry."""
    torch.set_num_threads(2)
    cfg, tr = small()
    s = gen.make_tracks(cfg, tr, 2**31 + 1234, CPU)
    est = Estimator(replay.engine_config(cfg), device=CPU)
    intakes = drv.Intakes(est, harness.Seams(), np.random.default_rng(0), 1 << 30, 1 << 30)
    sink = drv.Sink(est, s)
    feed = replay.Feed(s)
    calls = []
    real = Estimator.add_frame_observations

    def counted(self, t, ids, uv, vel=None, force_kf=None):
        calls.append(len(ids))
        return real(self, t, ids, uv, vel, force_kf)

    Estimator.add_frame_observations = counted
    try:
        while feed.t_last < 18.0:
            sink.watch = intakes if est.state >= TRACKING_INITIALIZING else None
            feed.step(sink)
    finally:
        Estimator.add_frame_observations = real
    return cfg, s, est, intakes.records(), calls, sink


def test_intake_equals_the_reference(fed):
    cfg, s, est, records, _, _ = fed
    raw = (s.imu_t, s.imu_dt, s.imu_dth, s.imu_dv)

    def imu_of(t0, t1):
        return ImuSeq(*(torch.as_tensor(x) for x in replay.imu_slice(raw, t0, t1)))

    n_kf = n_second = n_drops = 0
    for f, t, ids, uv, vel, b, (kf, kind, post) in records:
        ref = ref_feed.intake(b, t, ids, uv, vel, cfg["engine"], imu_of)
        assert (kf, kind) == (ref.keyframe, ref.kind), (f, t)
        if not kf:
            continue
        n_kf += 1
        n_second += kind == "second_new"
        win, lm_slot = post
        assert lm_slot == ref.lm_slot
        new = [int(i) for i in ids if int(i) not in b.lm_slot]
        n_drops += max(0, len(new) - len(b.free_slots))
        for k in ref_feed.ROWS:
            got, want = getattr(win, k).numpy(), ref.rows[k]
            if k == "lm_invdepth":
                np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
                moved = got != harness.to64(b.window).lm_invdepth.numpy()
                np.testing.assert_array_equal(got[~moved], want[~moved])
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)
    # the run filled the table, dropped new tracks and reused freed slots
    assert n_kf >= 10 and n_second >= 1 and n_drops > 0
    assert est.counters["slots_taken"] > est.cfg.max_landmarks


def test_counters_count_what_happened(fed):
    _, s, est, records, calls, sink = fed
    c = est.counters
    assert c["frames"] == len(calls) == len(est.feed_ms)
    assert c["tracks"] == sum(calls)
    assert c["keyframes"] == len(est.track_log)
    assert sink.kf_tracks > 0
    # the drops the reference's slot rule counts on the recorded keyframes
    drops = sum(max(0, len([i for i in ids if int(i) not in b.lm_slot]) - len(b.free_slots))
                for _, _, ids, _, _, b, (kf, _, _) in records if kf)
    assert 0 < drops <= c["slot_drops"]
    assert c["slots_taken"] >= len(est.lm_slot)
    assert all(math.isfinite(x) for x in est.feed_ms)


def test_host_reads_count_tensors_read(monkeypatch):
    est = Estimator(replay.engine_config(small()[0]), device=CPU)
    seen = []
    real = est_mod._host
    monkeypatch.setattr(est_mod, "_host", lambda x: seen.append(torch.is_tensor(x)) or real(x))
    n0 = est.counters["host_reads"]
    est._host(torch.zeros(3))
    est._host(np.zeros(3))
    est._host(1.5)
    assert est.counters["host_reads"] - n0 == 1 and seen == [True, False, False]
    before = est.counters["host_reads"]
    est._npw("obs_uv")
    est._npw("obs_uv")  # cached per window: no second read
    assert est.counters["host_reads"] == before + 1


@pytest.fixture(scope="module")
def cell_tracks():
    """The cell's own tracks over 40 s of its drive."""
    cfg, tr = _load()
    tr["duration_s"] = 40.0
    return cfg, tr, gen.make_tracks(cfg, tr, 2**31 + 77, CPU)


def test_generator_counts_and_ids(cell_tracks):
    cfg, tr, s = cell_tracks
    n = s.counts()
    assert n.max() <= tr["tracker"]["max_tracks"] == cfg["engine"]["track_max_features"]
    assert np.median(n) >= 180
    frame = np.repeat(np.arange(len(n)), n)
    # an id is one landmark over consecutive frames, born once
    order = np.lexsort((frame, s.ids))
    ids, fr, lm = s.ids[order], frame[order], s.lm[order]
    same = ids[1:] == ids[:-1]
    assert np.all(fr[1:][same] == fr[:-1][same] + 1)
    assert np.all(lm[1:][same] == lm[:-1][same])
    # within a frame no landmark is tracked twice
    key = frame * (len(s.landmarks) + 1) + s.lm
    assert len(np.unique(key)) == len(key)


def _in_view(cfg, tr, s, lm, f):
    """Whether landmarks ``lm`` are in view at frame ``f`` (the tracker's
    rule, recomputed from the world points)."""
    eng = cfg["engine"]
    uv, vis = sim.project_landmarks(s.traj, s.params, torch.as_tensor(s.landmarks[lm]),
                                    s.frame_t[f:f + 1], s.t_bc, s.q_bc, fov_tan=math.inf,
                                    min_depth=eng["nearest_depth"], max_depth=eng["farthest_depth"])
    cam = cam_mod.Camera.create(tuple(eng["cam"]["intrinsic"]), tuple(eng["cam"]["distortion"]),
                                tuple(eng["cam"]["resolution"]), device=CPU)
    px = cam_mod.cam_to_pixel(cam, torch.cat([uv, torch.ones_like(uv[..., :1])], -1))[:, 0]
    w, h = eng["cam"]["resolution"]
    m = tr["tracker"]["margin_px"]
    return (vis[:, 0] & (px[:, 0] >= m) & (px[:, 0] <= w - 1 - m) & (px[:, 1] >= m)
            & (px[:, 1] <= h - 1 - m)).numpy()


def test_generator_tracks_live_while_in_view(cell_tracks):
    cfg, tr, s = cell_tracks
    per_bin, bin_s = tr["landmarks"]["per_bin"], tr["landmarks"]["bin_s"]
    for f in range(0, len(s.frame_t) - 1, 97):
        ids, _, _ = s.frame(f)
        a, b = s.start[f], s.start[f + 1]
        assert _in_view(cfg, tr, s, s.lm[a:b], f).all()
        nxt = set(map(int, s.frame(f + 1)[0]))
        ended = np.array([int(i) not in nxt for i in ids])
        if ended.any():
            # an ended track's landmark is out of view, or out of the bins seen
            lm = s.lm[a:b][ended]
            fb = int(s.frame_t[f + 1] // bin_s)
            seen_bins = (lm // per_bin >= max(fb - 1, 0)) & (lm // per_bin <= fb + 1)
            assert not (_in_view(cfg, tr, s, lm, f + 1) & seen_bins).any()


def test_generator_noise_outliers_and_velocity(cell_tracks):
    cfg, tr, s = cell_tracks
    fx, fy = cfg["engine"]["cam"]["intrinsic"][:2]
    err = (s.uv - s.uv_true) * np.array([fx, fy])
    clean = ~s.outlier[s.ids]
    sd = err[clean].std(axis=0)
    np.testing.assert_allclose(sd, tr["tracker"]["noise_px"], rtol=0.02)
    # outliers: drawn per track at the configured share, each jumping once
    n_ids = len(s.outlier)
    share = tr["tracker"]["outlier_share"]
    assert abs(s.outlier.mean() - share) < 4.0 * math.sqrt(share * (1 - share) / n_ids)
    jumped = np.linalg.norm(err, axis=1) > 4.0 * tr["tracker"]["noise_px"] + 1.0
    assert not (jumped & clean).any()
    lo, hi = tr["tracker"]["outlier_px"]
    big = np.linalg.norm(err[~clean & jumped], axis=1)
    assert big.min() > lo - 4.0 and big.max() < hi + 4.0
    # velocity: the handed points' difference over the frame interval, 0 at birth
    rate = cfg["sensors"]["camera_rate"]
    for f in range(1, len(s.frame_t), 131):
        ids0, uv0, _ = s.frame(f - 1)
        ids1, uv1, vel1 = s.frame(f)
        prev = dict(zip(map(int, ids0), uv0))
        for i, x, v in zip(ids1, uv1, vel1):
            p = prev.get(int(i))
            np.testing.assert_array_equal(v, np.zeros(2) if p is None else (x - p) * rate)
