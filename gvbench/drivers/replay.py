"""A closed-loop replay of a drive through the program's ``Pipeline``, as
fast as it goes: IMU samples, GNSS fixes and camera frames in time order
(``add_imu`` / ``add_gnss`` / ``add_image``), each frame after the data due
before it.

Set-up makes the streams and replays them until the estimator tracks
normally (vision has joined and the window is full), at least
``warmup.min_data_s`` of data. The window then replays for ``--seconds``
of wall, frame by frame. With ``--trace 1`` the profiler covers
``trace_frames`` frames from the window's ``trace_from``-th.

Correctness: after the window the frozen reference recomputes, from the
program's state before each call and the benchmark's own inputs, a sample
drawn from the seed of the window's front-end frames (tracking, RANSAC,
detection), preintegrations, optimization rounds and marginalizations,
and compares what the program produced (``checks``). What no call
recomputes, the program's gathering of observations into the window
(keyframes, landmark slots, nodes), is held against the generator's
truth: ``assembly_err``.
"""

import gc
import math
import time

import numpy as np
import torch

from .. import harness
from ..gen import streams
from ..reference import frontend as ref_fe
from ..reference.common.prng import ransac_uniforms
from ..reference.factors.marginalization import marginalize_and_slide as ref_marg
from ..reference.ins.preintegration import preintegrate as ref_preint
from ..reference.solver import lm as ref_lm
from ..reference.vision import camera as ref_cam
from ..reference.data.types import ImuSeq
from .. import klt_work

KLT_KERNEL = "klt_bidirectional_kernel"


def engine_config(config: dict):
    """The program's ``EngineConfig`` of a configuration file."""
    from ic_gvins_tpu_torch.engine import config as cm

    e = dict(config["engine"])
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}  # noqa: E731
    cam, imu, odo = (tup(e.pop(k)) for k in ("cam", "imumodel", "odo"))
    return cm.EngineConfig(**tup(e), cam=cm.CameraConfig(**cam), imumodel=cm.ImuModel(**imu),
                           odo=cm.OdoConfig(**odo))


def install(seams, pipe, rng, sample):
    """Watch the program at the seams the comparison reads, keeping the
    ``sample`` of calls of each that ``rng`` draws (with the round that
    ran the most iterations, and every tracking kernel call traced)."""
    from ic_gvins_tpu_torch.engine import estimator as est_mod
    from ic_gvins_tpu_torch.engine import frontend as fe_mod
    from ic_gvins_tpu_torch.solver import lm as lm_mod
    from ic_gvins_tpu_torch.vision import klt_cuda

    fe = pipe.frontend
    pick = lambda n, **kw: harness.Sampler(int(n), rng, **kw)  # noqa: E731
    # track_frame: the state it starts from (not the pyramids: the
    # reference rebuilds them from the frames) and what it returned
    seams.wrap(fe_mod, "track_frame", "track", pick(sample["frames"]), keep=lambda a, k, out: (
        _own(a[3:]), fe.frame_count, _own(out[1:])))
    seams.wrap(fe_mod, "detect_frame", "detect", pick(sample["detections"]),
               keep=lambda a, k, out: (_own(a[2:7]), _own(out)))
    seams.wrap(klt_cuda, "lk_track_bidirectional", "klt",
               pick(1 << 30, when=lambda: seams.context.get("traced", False)),
               keep=lambda a, k, out: (_own(a[2:5]), len(a[0])))
    seams.wrap(est_mod, "preintegrate", "preintegrate", pick(sample["preint"]))
    seams.wrap(lm_mod, "optimize", "optimize", pick(sample["rounds"], key=lambda out: (
        int(out[1][0].iters_run) + int(out[1][1].iters_run))))
    seams.wrap(est_mod, "marginalize_and_slide", "marginalize", pick(sample["marg"]))


def _own(args):
    """Tensors on the host copied: on the CPU the front end shares memory
    between its tensors and its numpy tables, and updates the tables."""
    return tuple(x.clone() if torch.is_tensor(x) and x.device.type == "cpu" else x
                 for x in args)


class Feed:
    """The streams in time order, one frame (and the data due before it)
    per step."""

    def __init__(self, s: streams.Replay):
        self.s = s
        self.imu = [(float(t), float(dt), th, dv) for t, dt, th, dv in
                    zip(s.imu_t, s.imu_dt, s.imu_dth, s.imu_dv) if dt != 0.0]
        self.gnss = [(float(t), p, sd) for t, p, sd in zip(s.gnss_t, s.gnss_p, s.gnss_std)]
        self.frame_t = [float(t) for t in s.frame_t]
        self.i = self.g = self.f = 0
        self.t_last = 0.0

    def done(self) -> bool:
        return self.f >= len(self.frame_t)

    def step(self, pipe):
        """Feed the IMU and GNSS due before the next frame, then the frame."""
        tf = self.frame_t[self.f]
        imu, gnss, i, g = self.imu, self.gnss, self.i, self.g
        while i < len(imu) and imu[i][0] < tf:
            t = imu[i][0]
            pipe.add_imu(*imu[i])
            i += 1
            while g < len(gnss) and gnss[g][0] <= t:
                pipe.add_gnss(*gnss[g])
                g += 1
        # the sample at the frame's stamp covers it
        if i < len(imu):
            t = imu[i][0]
            pipe.add_imu(*imu[i])
            i += 1
            while g < len(gnss) and gnss[g][0] <= t:
                pipe.add_gnss(*gnss[g])
                g += 1
        self.i, self.g = i, g
        pipe.add_image(tf, self.s.frames[self.f])
        self.t_last = tf
        self.f += 1


def run(spec, cell, config, traffic, seed, seconds, trace, device, t_start, dtype=torch.float64):
    from ic_gvins_tpu_torch.engine.estimator import TRACKING_NORMAL
    from ic_gvins_tpu_torch.engine.pipeline import Pipeline

    cfg = engine_config(config)
    use_clahe = bool(config["pipeline"]["use_clahe"])
    s = streams.make_replay(config, traffic, seed, device)
    pipe = Pipeline(cfg, device=device, use_clahe=use_clahe, dtype=dtype)
    est = pipe.est
    seams = harness.Seams()
    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), 7]))
    install(seams, pipe, rng, traffic["sample"])
    feed = Feed(s)
    try:
        # set-up: replay until the estimator tracks normally
        wu = traffic["warmup"]
        while not (est.state == TRACKING_NORMAL and feed.t_last >= wu["min_data_s"]):
            if feed.done() or feed.t_last > wu["max_data_s"]:
                raise RuntimeError(f"the warm-up did not reach normal tracking by "
                                   f"{feed.t_last:.1f} s of data (state {est.state})")
            feed.step(pipe)
        warm_data_s = feed.t_last
        _sync(device)
        setup_s = time.perf_counter() - t_start

        # the window
        n0 = {k: len(v) for k, v in est.stage_ms.items()}
        nf0 = len(pipe.frame_ms)
        t_data0 = feed.t_last
        prof = None
        trace_from, trace_frames = int(traffic["trace_from"]), int(traffic["trace_frames"])
        min_rounds = int(traffic["trace_min_rounds"])
        frame_ms, stream_end = [], False
        seams.on = True
        w0 = time.perf_counter()
        while True:
            if feed.done():
                stream_end = True
                break
            k = len(frame_ms)
            if trace and k == trace_from:
                prof = _start_trace(seams, device)
                n_opt = seams.samplers["optimize"].seen
            seams.context["frame"] = feed.f
            a = time.perf_counter()
            feed.step(pipe)
            frame_ms.append((time.perf_counter() - a) * 1e3)
            if (prof is not None and seams.spans and k >= trace_from + trace_frames - 1
                    and seams.samplers["optimize"].seen - n_opt >= min_rounds):
                _stop_trace(seams, prof)
            if time.perf_counter() - w0 >= seconds:
                break
        wall = time.perf_counter() - w0
        seams.on = False
        if prof is not None and seams.spans:
            _stop_trace(seams, prof)
        _sync(device)
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        stage = {k: v[n0[k]:] for k, v in est.stage_ms.items()}
        window = dict(wall_s=wall, data_s=feed.t_last - t_data0, frame_ms=frame_ms,
                      frontend_ms=list(pipe.frame_ms[nf0:]), stage_ms=stage,
                      frames=len(frame_ms), warm_data_s=warm_data_s, stream_end=stream_end)
    finally:
        seams.on = False
        seams.restore()
    calls = {k: seams.records(k) for k in seams.samplers}
    counts = seams.counts()
    state = dict(lm_slots=len(est.lm_slot), keyframes=est.n_keyframes, state=est.state)
    del pipe, est
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison
    limits = spec.limits(traffic["kind"])
    t_ref = time.perf_counter()
    numbers = compare(calls, s, config, use_clahe, device)
    ref_s = time.perf_counter() - t_ref
    checks = [(n, numbers[n], limits[n]) for n in limits]
    correct = (not stream_end) and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    traced = None
    if prof is not None:
        traced = prof.reduce((KLT_KERNEL,))
        traced["klt_bound_s"], traced["klt_bound_by"] = klt_bound(calls, s, use_clahe, device)
    return dict(
        correct=correct, attempted=len(frame_ms), failed=int(stream_end),
        checks=checks, setup_s=setup_s, memory_peak=memory_peak, window=window,
        trace=traced, notes=dict(warm_data_s=warm_data_s, reference_s=ref_s,
                                 calls=counts, **state))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_trace(seams, device):
    from ..trace import Profile

    prof = Profile(device)
    seams.spans = True
    seams.context["traced"] = True
    prof.start()
    return prof


def _stop_trace(seams, prof):
    prof.stop()
    seams.spans = False
    seams.context["traced"] = False


# ---------------------------------------------------------------------------
# the comparison


def compare(calls, s, config, use_clahe, device) -> dict:
    """The comparison's numbers over the window's sampled calls. Each is the
    worst gap of its kind (``harness.tree_gap``): 1 where a decision (a
    flag, a count of iterations or culls) differs, inf where a sampled
    call never came; and ``assembly_err`` (``assembly_gap``)."""
    eng = config["engine"]
    out = {}
    cam = ref_cam.Camera.create(tuple(eng["cam"]["intrinsic"]), tuple(eng["cam"]["distortion"]),
                                tuple(eng["cam"]["resolution"]), dtype=torch.float64,
                                device=device)
    frames = s.frames

    # the front end: tracking with RANSAC, and detection
    gap = 0.0
    picked = calls.get("track", [])
    for ctx, (args, frame_count, got) in picked:
        j = ctx["frame"]
        (pts, valid, q_prev, q_wc, has_rot, p_wc, lm_pw, lm_ok, lv, _clahe, fm, uv_prev,
         thr, _u) = args
        prev_pyr = ref_fe.prep_frame(frames[j - 1].to(device), lv, use_clahe)
        u = torch.as_tensor(ransac_uniforms(frame_count, dtype=np.float64), device=device)
        f64 = harness.to64
        _, pts1, ok, uv1 = ref_fe.track_frame(
            cam, prev_pyr, frames[j].to(device), pts.to(device), valid.to(device),
            f64(q_prev, device), f64(q_wc, device), has_rot, f64(p_wc, device),
            f64(lm_pw, device), lm_ok.to(device), lv, use_clahe, fm, f64(uv_prev, device),
            thr, u)
        g_pts, g_ok, g_uv = got
        g_ok = g_ok.to(device)
        if not torch.equal(g_ok, ok):
            gap = max(gap, 1.0)
        both = g_ok & ok
        if bool(both.any()):
            gap = max(gap, float((g_uv.to(device).double() - uv1)[both].abs().max()))
    for ctx, (args, got) in calls.get("detect", []):
        j = ctx["frame"]
        pts, valid, cell, max_new, subpix = args
        img0 = ref_fe.prep_frame(frames[j].to(device), 0, use_clahe)[0]
        p_new, ok_new, uv_new = ref_fe.detect_frame(cam, img0, pts.to(device),
                                                    valid.to(device), cell, max_new, subpix)
        g_pts, g_ok, g_uv = got
        if not torch.equal(g_ok.to(device), ok_new):
            gap = max(gap, 1.0)
        both = g_ok.to(device) & ok_new
        if bool(both.any()):
            gap = max(gap, float((g_uv.to(device).double() - uv_new)[both].abs().max()))
    out["frontend_err"] = gap if picked else math.inf

    # preintegration from the raw IMU between the interval's stamps
    params = None
    gap = 0.0
    pre = calls.get("preintegrate", [])
    raw = (s.imu_t, s.imu_dt, s.imu_dth, s.imu_dv)
    for _, (args, _, got) in pre:
        prm, state0, imu = args
        params = harness.to64(prm, device)
        t0, t1 = float(imu.time[0]), float(imu.time[-1])
        seq = ImuSeq(*(torch.as_tensor(x, device=device) for x in imu_slice(raw, t0, t1)))
        ref = ref_preint(params, harness.to64(state0, device), seq)
        gap = max(gap, harness.tree_gap(got, ref))
    out["preint_err"] = gap if pre else math.inf

    # optimization rounds: the window, costs, culls and iterations
    gap_w = gap_c = 0.0
    rounds = calls.get("optimize", [])
    for _, (args, kwargs, got) in rounds:
        win, prior, scfg, prm = (harness.to64(a, device) for a in args[:4])
        it, cull = kwargs.get("iters", 20), kwargs.get("do_cull", True)
        ref_w, (r1, r2, rn) = ref_lm.optimize(win, prior, scfg, prm, iters=it, do_cull=cull)
        g_w, (g1, g2, gn) = got
        gap_w = max(gap_w, harness.tree_gap(g_w, ref_w))
        if (int(g1.accepted), int(g2.accepted), int(g1.iters_run), int(g2.iters_run),
                int(gn)) != (int(r1.accepted), int(r2.accepted), int(r1.iters_run),
                             int(r2.iters_run), int(rn)):
            gap_w = max(gap_w, 1.0)
        gap_c = max(gap_c, harness.rel_scalar(g1.cost0, r1.cost0),
                    harness.rel_scalar(g2.cost1, r2.cost1))
    out["round_err"] = gap_w if rounds else math.inf
    out["round_cost"] = gap_c if rounds else math.inf

    # marginalization: the prior and the slid window
    gap = 0.0
    margs = calls.get("marginalize", [])
    for _, (args, kwargs, got) in margs:
        win, prior, scfg, prm = (harness.to64(a, device) for a in args[:4])
        rest = args[4:]
        ref = ref_marg(win, prior, scfg, prm, *rest, **kwargs)
        gap = max(gap, harness.tree_gap(got, ref))
    out["marg_err"] = gap if margs else math.inf

    # the window as the program gathered it, against the truth
    focal = 0.5 * (eng["cam"]["intrinsic"][0] + eng["cam"]["intrinsic"][1])
    out["assembly_err"] = max((assembly_gap(harness.to64(args[0], device), s, focal)
                               for _, (args, _, _) in rounds), default=math.inf)
    return out


GATE_PX = 10.0


def assembly_gap(win, s, focal: float) -> float:
    """The share of a window's observations that the truth does not bear
    out: each landmark slot that enters the round (``lm_valid``: the
    program has triangulated it) with observations at two nodes or more is
    triangulated from them under the generator's true camera poses at the
    nodes' stamps, and an observation counts where it lies more than
    ``GATE_PX`` pixels from that point's projection (or the point lies
    behind the camera). Observations of one world point at the right nodes
    agree to the tracker's noise; a slot that mixes points, an observation
    put at the wrong node or a node at the wrong stamp do not."""
    from ..reference.common import rotation as rot
    from ..reference.data import simulator as sim

    m = win.obs_valid & win.node_valid[None, :] & win.lm_valid[:, None]
    m = m & (m.sum(1, keepdim=True) >= 2)
    if not bool(m.any()):
        return 0.0
    st = sim.truth_state(s.traj, s.params, win.nodes.time)
    c = st.p + rot.quat_rotate(st.q, s.t_bc)  # [N, 3] camera centres
    r_wc = rot.quat_to_matrix(rot.quat_mul(st.q, s.q_bc / torch.linalg.norm(s.q_bc)))
    uv = win.obs_uv
    bear = torch.cat([uv, torch.ones_like(uv[..., :1])], -1)  # [L, N, 3]
    d = torch.einsum("nij,lnj->lni", r_wc, bear)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    proj = (eye - d[..., :, None] * d[..., None, :]) * m[..., None, None]  # [L, N, 3, 3]
    a = proj.sum(1)
    b = torch.einsum("lnij,nj->li", proj, c)
    # a weak pull to a point on the first ray at 10 m settles the depth of
    # near-parallel rays (a metre along the ray weighs as a millimetre
    # across it)
    first = torch.argmax(m.to(torch.uint8), 1)
    ar = torch.arange(m.shape[0], device=m.device)
    x0 = c[first] + 10.0 * d[ar, first]
    eps = 1e-6 * m.sum(1).clamp(min=1).to(d.dtype)
    x = torch.linalg.solve(a + eps[:, None, None] * eye, b + eps[:, None] * x0)
    pc = torch.einsum("nji,lnj->lni", r_wc, x[:, None, :] - c[None])  # camera frame
    z = pc[..., 2]
    px = focal * torch.linalg.norm(pc[..., :2] / torch.where(z > 0, z, torch.ones_like(z))[..., None]
                                   - uv, dim=-1)
    bad = m & ((z <= 0) | ~(px <= GATE_PX))
    return float(bad.sum()) / float(m.sum())


def imu_slice(raw, t0, t1, min_dt=1e-4):
    """The IMU series covering (t0, t1] from the raw stream, with boundary
    interpolation and a leading zero seed sample: ``_ImuBuffer.
    slice_between_np`` of ic_gvins_tpu_torch/engine/estimator.py at commit
    ab7fbd6 over the whole stream (its samples with dt > 0)."""
    t_all, dt_all, th_all, dv_all = raw
    m = dt_all > 0
    times, dts, dth, dvel = t_all[m], dt_all[m], th_all[m], dv_all[m]
    i0 = int(np.searchsorted(times, t0 + min_dt))
    i1 = int(np.searchsorted(times, t1 - min_dt))
    out_t, out_dt, out_th, out_dv = [t0], [0.0], [np.zeros(3)], [np.zeros(3)]
    if i0 > 0 and times[i0] > t0 + min_dt and times[i0] - dts[i0] < t0 - min_dt:
        frac = (times[i0] - t0) / dts[i0]
        out_t.append(times[i0])
        out_dt.append(times[i0] - t0)
        out_th.append(dth[i0] * frac)
        out_dv.append(dvel[i0] * frac)
        i0 += 1
    for k in range(i0, min(i1 + 1, len(times))):
        if times[k] <= t1 + min_dt:
            out_t.append(times[k])
            out_dt.append(dts[k])
            out_th.append(dth[k])
            out_dv.append(dvel[k])
    k = int(np.searchsorted(times, t1 + min_dt))
    if k < len(times) and times[k] > t1 + min_dt:
        t_start = times[k] - dts[k]
        if t0 - min_dt <= t_start < t1 - min_dt:
            frac = (t1 - t_start) / dts[k]
            if frac > 1e-9:
                out_t.append(t1)
                out_dt.append(t1 - t_start)
                out_th.append(dth[k] * frac)
                out_dv.append(dvel[k] * frac)
    out_t[-1] = t1
    return (np.asarray(out_t, np.float64), np.asarray(out_dt, np.float64),
            np.stack(out_th), np.stack(out_dv))


def klt_bound(calls, s, use_clahe, device):
    """The roofline bound (s) of the traced KLT calls, from the frozen
    tracker's work on the reference's pyramids of the same frames."""
    total, by = 0.0, {"bytes": 0.0, "operations": 0.0}
    for ctx, ((pts0, pts1_init, valid), n_images) in calls.get("klt", []):
        j = ctx["frame"]
        pyr0 = ref_fe.prep_frame(s.frames[j - 1].to(device), n_images - 1, use_clahe)
        pyr1 = ref_fe.prep_frame(s.frames[j].to(device), n_images - 1, use_clahe)
        passes, steps = klt_work.count(pyr0, pyr1, pts0, pts1_init, valid)
        t, kind = klt_work.bound(passes, steps, pts0.shape[0], pyr0)
        total += t
        by[kind] += t
    return (total, max(by, key=by.get)) if total > 0 else (None, None)
