"""A checkout of the benchmark with two cells added as data files alone:
a configuration, two traffic mixes and their entries in a copy of
``BENCHMARK.json`` (with the replay metrics' entries where it has none),
at sizes that run on the CPU in seconds."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def make_root(root: Path, duration_s: float = 20.0) -> Path:
    """Copy ``BENCHMARK.json`` and ``gvbench/`` under ``root`` and add the
    cells ``tiny.replay`` and ``tiny.batch``: only new files and new
    entries, no existing file edited."""
    shutil.copytree(REPO / "gvbench", root / "gvbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "gvbench/configs/icgvins_robot.json").read_text())
    eng = cfg["engine"]
    eng.update(max_nodes=16, max_landmarks=64, optimize_num_iterations=8,
               optimize_windows_size=6, track_max_features=60, imudatarate=100.0,
               track_min_parallax=12.0)
    eng["cam"].update(intrinsic=[240.0, 240.0, 160.0, 120.0], resolution=[320, 240])
    cfg["sensors"]["camera_rate"] = 10.0
    cfg["name"] = "tiny"
    (root / "gvbench/configs/tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((REPO / "gvbench/traffic/replay_robot.json").read_text())
    # a car's drive, whose parallax fills the window at these test sizes
    tr.update(duration_s=duration_s, trace_from=1, trace_frames=3, trace_min_rounds=1,
              route={"type": "car", "speed": 8.0, "turn_period": 60.0, "turn_amp": 0.6})
    tr["landmarks"] = {"per_bin": 130, "bin_s": 10.0, "lead_s": 5.0, "lateral": 30.0,
                       "depth": [8.0, 60.0]}
    tr["warmup"] = {"min_data_s": 3.0, "max_data_s": 20.0}
    tr["sample"] = {"frames": 2, "detections": 1, "preint": 3, "rounds": 1, "marg": 1}
    (root / "gvbench/traffic/tiny_replay.json").write_text(json.dumps(tr))
    tb = json.loads((REPO / "gvbench/traffic/batch32.json").read_text())
    tb.update(batch=4, pool=2, segments=2, trace_from=0, trace_calls=1)
    tb["sample"] = {"calls": 1, "members": 2}
    (root / "gvbench/traffic/tiny_batch.json").write_text(json.dumps(tb))
    spec["configs"].append({"name": "tiny", "source": "https://github.com/i2Nav-WHU/IC-GVINS",
                            "file": "gvbench/configs/tiny.json", "reduced": [],
                            "why": "CPU test sizes"})
    spec["workloads"] += [
        {"name": "tiny.replay", "config": "tiny", "traffic": "tiny_replay", "chips": 1,
         "why": "CPU test sizes"},
        {"name": "tiny.batch", "config": "tiny", "traffic": "tiny_batch", "chips": 1,
         "why": "CPU test sizes"}]
    # the replay metrics' entries, new where BENCHMARK.json has no replay cell
    for key, entries in REPLAY_METRICS.items():
        have = {m["name"] for m in spec[key]}
        spec[key] += [dict(m, workloads=[]) for m in entries if m["name"] not in have]
    replay = {m["name"] for ms in REPLAY_METRICS.values() for m in ms}
    for m in spec["end_to_end"] + spec["per_layer"]:
        ws = m.get("workloads")
        if ws is not None:
            ws.append("tiny.replay" if m["name"] in replay else "tiny.batch")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def _metric(name, unit, better, source, **kw):
    return dict(name=name, unit=unit, better=better, source=source, **kw)


REPLAY_METRICS = {
    "end_to_end": [
        _metric("data_rate", "s/s", "higher", "host_clock", bound=0.25),
        _metric("frame_ms.p90", "ms", "lower", "host_clock", bound=0.25)],
    "per_layer": [
        _metric("frontend_ms", "ms", "lower", "program_span", layer="front end",
                moves="data_rate"),
        _metric("klt_roofline", "%", "higher", "device_trace", layer="tracking kernel",
                moves="data_rate"),
        _metric("optimize_ms", "ms", "lower", "program_span", layer="estimator round",
                moves="frame_ms.p90"),
        _metric("host_ms", "ms", "lower", "program_span", layer="estimator host",
                moves="data_rate"),
        _metric("lm_launches", "launches", "lower", "device_trace", layer="solver",
                moves="frame_ms.p90"),
        _metric("device_idle.replay", "%", "lower", "device_trace", layer="device",
                moves="data_rate")],
}
