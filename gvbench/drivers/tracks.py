"""A closed-loop feed of a drive's feature tracks into the program's
``Estimator``, as a tracker outside the estimator hands them over, as fast
as it goes: IMU samples and GNSS fixes in time order (``add_imu`` /
``add_gnss``), and before each frame's stamp is passed, the frame's tracks
(``add_frame_observations(t, ids, uv, vel)``, host numpy arrays), in the
order ``replay.Feed`` keeps. No front end runs. ``windows_per_s`` reads the
estimator's rounds completed in the window over its wall (batch 1), as
``replay_rounds`` does.

Set-up makes the streams (``gen/tracks.py``) and feeds them until the
estimator tracks normally, at least ``warmup.min_data_s`` of data. The
window then feeds for ``--seconds`` of wall, frame by frame. With
``--trace 1`` the profiler covers ``trace_frames`` frames from the window's
``trace_from``-th, and at least ``trace_min_rounds`` rounds.

Correctness: after the window the frozen reference recomputes a sample
drawn from the seed of the window's calls, from the program's state before
each: ``preint_err``, ``round_err``, ``round_cost`` and ``marg_err`` as in
``replay.compare``; ``feed_err``, the frames' intake
(``reference/feed.py``: the keyframe decision and its kind on sampled
frames, and on sampled keyframes the window's landmark rows after the
intake, triangulation included; a differing flag reads 1); and
``assembly_err``, exact here since the generator knows every track: over
the sampled rounds' window, the share of the observations of occupied
slots that differ by more than ``ASSEMBLY_TOL`` from what the generator
handed over for the slot's track id at the node's stamp (or that it never
handed over).

The program's intake span (``Estimator.feed_ms``) and counters
(``Estimator.counters``) are read where the program has them; the run's
notes carry the counters, the tracks offered to keyframes and the share of
them dropped for want of a landmark slot.
"""

import gc
import math
import time

import numpy as np
import torch

from .. import harness
from ..gen import tracks as gen
from ..reference import feed as ref_feed
from ..reference.data.types import ImuSeq
from . import replay

ASSEMBLY_TOL = 1e-9


class Sink:
    """The estimator behind ``replay.Feed``'s calls: a frame's image is its
    tracks, handed to ``add_frame_observations``, or, while ``watch`` is
    set, to ``watch(f, t, ids, uv, vel)``, which makes the call."""

    def __init__(self, est, s: gen.Tracks):
        self.est, self.s = est, s
        self.add_imu, self.add_gnss = est.add_imu, est.add_gnss
        self.watch = None
        self.kf_tracks = 0  # tracks offered to keyframes

    def add_image(self, t, f):
        ids, uv, vel = self.s.frame(f)
        if not len(ids):
            return
        est = self.est
        n_kf = len(est.track_log)
        if self.watch is None:
            est.add_frame_observations(t, ids, uv, vel)
        else:
            self.watch(f, t, ids, uv, vel)
        if len(est.track_log) > n_kf:
            self.kf_tracks += len(ids)


class Intakes:
    """The sampled frames' intake: the program's state before each frame's
    call (``feed.Before``), the tracks handed over, and what the call
    decided and left in the window before its round. Frames are sampled
    from every frame of the window, keyframes from those that made one.
    Every round puts the slot map it runs with in ``seams.context``."""

    def __init__(self, est, seams, rng, n_frames, n_keyframes):
        self.est = est
        self.frames = harness.Sampler(int(n_frames), rng)
        self.keyframes = harness.Sampler(int(n_keyframes), rng)
        self.post = None
        self.on = False
        real = est._optimize_round

        def round_with_slots(*args, **kwargs):
            slots = seams.context["lm_slot"] = dict(est.lm_slot)
            if self.on and self.post is None:
                self.post = (est.window, slots)
            return real(*args, **kwargs)

        est._optimize_round = round_with_slots

    def __call__(self, f, t, ids, uv, vel):
        est = self.est
        b = ref_feed.Before(window=est.window, params=est.params, last_state=est.last_node_state,
                            node_times=list(est.node_times), node_is_kf=list(est.node_is_kf),
                            lm_slot=dict(est.lm_slot), free_slots=list(est.free_slots))
        n_kf = len(est.track_log)
        self.post, self.on = None, True
        try:
            est.add_frame_observations(t, ids, uv, vel)
        finally:
            self.on = False
        kf = len(est.track_log) > n_kf
        got = (kf, est._kf_kind, self.post)
        rec = lambda: (f, t, ids, uv, vel, b, got)  # noqa: E731
        self.frames.offer(rec, None)
        if kf:
            self.keyframes.offer(rec, None)

    def records(self) -> list:
        got = {r[0]: r for r in self.frames.records() + self.keyframes.records()}
        return [got[f] for f in sorted(got)]


def install(seams, est, rng, sample):
    """Watch the program at the seams the comparison reads: the estimator's
    preintegrations, rounds (each with the slot map it ran with) and
    marginalizations; the frames' intake (``Intakes``)."""
    from ic_gvins_tpu_torch.engine import estimator as est_mod
    from ic_gvins_tpu_torch.solver import lm as lm_mod

    pick = lambda n, **kw: harness.Sampler(int(n), rng, **kw)  # noqa: E731
    seams.wrap(est_mod, "preintegrate", "preintegrate", pick(sample["preint"]))
    seams.wrap(lm_mod, "optimize", "optimize", pick(sample["rounds"], key=lambda out: (
        int(out[1][0].iters_run) + int(out[1][1].iters_run))))
    seams.wrap(est_mod, "marginalize_and_slide", "marginalize", pick(sample["marg"]))
    return Intakes(est, seams, rng, sample["frames"], sample["keyframes"])


def run(spec, cell, config, traffic, seed, seconds, trace, device, t_start, dtype=torch.float64):
    from ic_gvins_tpu_torch.engine.estimator import TRACKING_NORMAL, Estimator

    cfg = replay.engine_config(config)
    s = gen.make_tracks(config, traffic, seed, device)
    est = Estimator(cfg, device=device, dtype=dtype)
    seams = harness.Seams()
    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), 7]))
    intakes = install(seams, est, rng, traffic["sample"])
    sink = Sink(est, s)
    feed = replay.Feed(s)
    try:
        # set-up: feed until the estimator tracks normally
        wu = traffic["warmup"]
        while not (est.state == TRACKING_NORMAL and feed.t_last >= wu["min_data_s"]):
            if feed.done() or feed.t_last > wu["max_data_s"]:
                raise RuntimeError(f"the warm-up did not reach normal tracking by "
                                   f"{feed.t_last:.1f} s of data (state {est.state})")
            feed.step(sink)
        warm_data_s = feed.t_last
        replay._sync(device)
        setup_s = time.perf_counter() - t_start

        # the window
        n0 = {k: len(v) for k, v in est.stage_ms.items()}
        feed_ms = getattr(est, "feed_ms", None)
        nfeed0 = len(feed_ms) if feed_ms is not None else 0
        counters = getattr(est, "counters", None)
        c0 = dict(counters) if counters is not None else None
        t_data0 = feed.t_last
        prof = None
        trace_from, trace_frames = int(traffic["trace_from"]), int(traffic["trace_frames"])
        min_rounds = int(traffic["trace_min_rounds"])
        frame_ms, stream_end = [], False
        seams.on = True
        sink.watch = intakes
        w0 = time.perf_counter()
        while True:
            if feed.done():
                stream_end = True
                break
            k = len(frame_ms)
            if trace and k == trace_from:
                prof = replay._start_trace(seams, device)
                n_opt = seams.samplers["optimize"].seen
            a = time.perf_counter()
            feed.step(sink)
            frame_ms.append((time.perf_counter() - a) * 1e3)
            if (prof is not None and seams.spans and k >= trace_from + trace_frames - 1
                    and seams.samplers["optimize"].seen - n_opt >= min_rounds):
                replay._stop_trace(seams, prof)
            if time.perf_counter() - w0 >= seconds:
                break
        wall = time.perf_counter() - w0
        seams.on = False
        sink.watch = None
        if prof is not None and seams.spans:
            replay._stop_trace(seams, prof)
        replay._sync(device)
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        stage = {k: v[n0[k]:] for k, v in est.stage_ms.items()}
        window = dict(wall_s=wall, data_s=feed.t_last - t_data0, frame_ms=frame_ms,
                      stage_ms=stage, frames=len(frame_ms), warm_data_s=warm_data_s,
                      stream_end=stream_end, batch=1, calls=len(stage["optimize"]))
        if feed_ms is not None:
            window["feed_ms"] = list(feed_ms[nfeed0:])
        if counters is not None:
            window["counters"] = {k: counters[k] - c0[k] for k in counters}
    finally:
        seams.on = False
        seams.restore()
    calls = {k: seams.records(k) for k in seams.samplers}
    calls["intake"] = intakes.records()
    counts = dict(seams.counts(), frames=intakes.frames.seen, keyframes=intakes.keyframes.seen)
    notes = dict(lm_slots=len(est.lm_slot), keyframes=est.n_keyframes, state=est.state,
                 kf_tracks=sink.kf_tracks,
                 tracks_per_frame_median=float(np.median(s.counts())))
    if counters is not None:
        notes["counters"] = dict(counters)
        notes["slot_drop_share"] = counters["slot_drops"] / max(sink.kf_tracks, 1)
    dead = getattr(est, "_dead_cleared", None)
    if dead is not None:
        notes["dead_cleared"] = dict(dead)
    del est, intakes, sink
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison
    limits = spec.limits(traffic["kind"])
    t_ref = time.perf_counter()
    numbers = compare(calls, s, config, device)
    ref_s = time.perf_counter() - t_ref
    checks = [(n, numbers[n], limits[n]) for n in limits]
    correct = (not stream_end) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    traced = prof.reduce(()) if prof is not None else None
    return dict(
        correct=correct, attempted=len(frame_ms), failed=int(stream_end),
        checks=checks, setup_s=setup_s, memory_peak=memory_peak, window=window,
        trace=traced, notes=dict(notes, warm_data_s=warm_data_s, reference_s=ref_s,
                                 calls=counts))


# ---------------------------------------------------------------------------
# the comparison


def compare(calls, s: gen.Tracks, config, device) -> dict:
    """``replay.compare``'s numbers for the estimator's stages (its
    ``frontend_err`` reads inf: no front end runs), with ``assembly_err``
    exact (``assembly_gap``) and ``feed_err`` (``feed_gap``)."""
    out = replay.compare(calls, s, config, False, device)
    rounds = calls.get("optimize", [])
    out["assembly_err"] = max((assembly_gap(harness.to64(args[0], device), ctx["lm_slot"], s)
                               for ctx, (args, _, _) in rounds), default=math.inf)
    out["feed_err"] = feed_gap(calls.get("intake", []), s, config, device)
    return out


def assembly_gap(win, lm_slot: dict, s: gen.Tracks) -> float:
    """The share of the window's observations of occupied slots that the
    generator does not bear out: the observation of slot ``lm_slot[id]`` at
    a node differs by more than ``ASSEMBLY_TOL`` from the point handed over
    for track ``id`` at the frame of the node's stamp, or no such point was
    handed over."""
    obs_uv = win.obs_uv.cpu().numpy()
    obs_valid = (win.obs_valid & win.node_valid[None, :]).cpu().numpy()
    times = win.nodes.time.cpu().numpy()
    rate = 1.0 / (s.frame_t[1] - s.frame_t[0])
    handed = {}  # node -> {track id: point}
    total = bad = 0
    for fid, slot in lm_slot.items():
        for k in np.nonzero(obs_valid[slot])[0]:
            if k not in handed:
                f = int(round(times[k] * rate)) - 1
                hit = 0 <= f < len(s.frame_t) and abs(s.frame_t[f] - times[k]) < 1e-9
                ids, uv, _ = s.frame(f) if hit else ((), (), ())
                handed[k] = dict(zip(map(int, ids), uv))
            want = handed[k].get(fid)
            total += 1
            if want is None or not np.all(np.abs(obs_uv[slot, k] - want) <= ASSEMBLY_TOL):
                bad += 1
    return bad / total if total else 0.0


def feed_gap(records, s: gen.Tracks, config, device) -> float:
    """The worst gap of the sampled frames' intake against the frozen
    reference's (``reference/feed.py``) from the same state and tracks: 1
    where the keyframe decision, its kind or a flag of the window's rows
    differs, else the rows' ``harness.tree_gap``; inf with no sample."""
    if not records:
        return math.inf
    eng = config["engine"]
    raw = (s.imu_t, s.imu_dt, s.imu_dth, s.imu_dv)

    def imu_of(t0, t1):
        return ImuSeq(*(torch.as_tensor(x, device=device) for x in replay.imu_slice(raw, t0, t1)))

    gap = 0.0
    for f, t, ids, uv, vel, b, (kf, kind, post) in records:
        b64 = b._replace(window=harness.to64(b.window, device),
                         params=harness.to64(b.params, device),
                         last_state=harness.to64(b.last_state, device))
        ref = ref_feed.intake(b64, t, ids, uv, vel, eng, imu_of)
        if (kf, kind) != (ref.keyframe, ref.kind) or (kf and post is None):
            gap = max(gap, 1.0)
            continue
        if not kf:
            continue
        win, lm_slot = post
        if lm_slot != ref.lm_slot:
            gap = max(gap, 1.0)
        got = tuple(getattr(win, k) for k in ref_feed.ROWS)
        want = tuple(torch.as_tensor(ref.rows[k], device=device) for k in ref_feed.ROWS)
        gap = max(gap, harness.tree_gap(harness.to64(got, device), want))
    return gap
