"""The estimator fed by an outside tracker (kind ``tracks``), as a cell
added in data files alone at CPU sizes: a sound run is correct and reads
``windows_per_s`` as its rounds over its wall; the planted
``assembly-fault``, an observation written at the wrong node and the
comparison's control each come out not correct."""

import json

import pytest
import torch

from gvbench import run
from gvbench.tests.tiny import REPO, make_root

CPU = torch.device("cpu")
CELL = "tiny.tracks"


def tiny_tracks(root):
    """Add the cell ``tiny.tracks`` (the configuration ``tiny`` with a lower
    parallax for keyframes) to a checkout made by ``tiny.make_root``, and
    the tracks metrics' entries."""
    tr = json.loads((REPO / "gvbench/traffic/tracks_robot.json").read_text())
    tiny = json.loads((root / "gvbench/traffic/tiny_replay.json").read_text())
    # the robot's drive and scene, through the small camera
    tr.update(duration_s=30.0, warmup=tiny["warmup"], trace_from=1, trace_frames=3,
              trace_min_rounds=1)
    tr["tracker"]["max_tracks"] = 60
    tr["sample"] = {"frames": 3, "keyframes": 2, "preint": 3, "rounds": 1, "marg": 1}
    (root / "gvbench/traffic/tiny_tracks.json").write_text(json.dumps(tr))
    cfg = json.loads((root / "gvbench/configs/tiny.json").read_text())
    # keyframes by parallax often enough to fill the small window soon
    cfg["engine"]["track_min_parallax"] = 6.0
    (root / "gvbench/configs/tiny_tracks.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_tracks", "source": "https://github.com/i2Nav-WHU/IC-GVINS",
                            "file": "gvbench/configs/tiny_tracks.json", "reduced": [],
                            "why": "CPU test sizes"})
    spec["workloads"].append({"name": CELL, "config": "tiny_tracks", "traffic": "tiny_tracks",
                              "chips": 1, "why": "CPU test sizes"})
    have = {m["name"] for m in spec["per_layer"]}
    for name, unit in (("feed_ms", "ms"), ("host_reads", "reads")):
        if name not in have:
            spec["per_layer"].append(dict(name=name, unit=unit, better="lower",
                                          source="program_span", layer="estimator intake",
                                          moves="windows_per_s", workloads=[]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        ws = m.get("workloads")
        if ws is not None and (m["name"] in ("windows_per_s", "feed_ms", "host_reads")):
            ws.append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_tracks(make_root(tmp_path_factory.mktemp("gvbench_tracks")))


def run_tiny(root, control="f64", seed=2**31 + 99):
    return run.run_cell(root, CELL, seed, 4.0, 0, CPU, control)


def test_tracks_cell_is_correct_and_counts_rounds(root):
    line, rec = run_tiny(root)
    assert line["correct"], rec["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(json.loads(
        (root / "gvbench/limits/tracks.json").read_text()))
    w = rec["window"]
    rounds = len(w["stage_ms"]["optimize"])
    assert rounds > 0 and w["calls"] == rounds and w["batch"] == 1
    assert line["metrics"]["windows_per_s"]["value"] == pytest.approx(rounds / w["wall_s"])
    # the per-layer metrics this cell adds, read from the run's record
    spec = run.harness.Spec(root)
    c = w["counters"]
    assert c["frames"] == line["attempted"] == len(w["feed_ms"]) and c["tracks"] > 0
    feed_ms = spec.reader("feed_ms")(rec)
    assert feed_ms == pytest.approx(sum(w["feed_ms"]) / len(w["feed_ms"])) and feed_ms > 0
    assert spec.reader("host_reads")(rec) == c["host_reads"] / c["frames"] > 0
    assert set(rec["notes"]["counters"]) == set(c)


def _observation_at_wrong_node(monkeypatch):
    from ic_gvins_tpu_torch.engine import estimator as est_mod

    real = est_mod.Estimator._init_new_depths

    def fault(self, n):
        # the keyframe's observations written one node early
        w = self.window
        shifted = lambda x: torch.cat([x[:, 1:], x[:, :1]], 1)  # noqa: E731
        new = w.obs_valid[:, n] & ~w.obs_valid[:, n - 1]
        m = torch.zeros_like(w.obs_valid)
        m[:, n - 1] = new
        self.window = w._replace(
            obs_valid=w.obs_valid | m,
            obs_uv=torch.where(m[..., None], shifted(w.obs_uv), w.obs_uv))
        return real(self, n)

    monkeypatch.setattr(est_mod.Estimator, "_init_new_depths", fault)


@pytest.mark.parametrize("fault", ["assembly-fault", "f32", "wrong-node"])
def test_tracks_cell_broken_path_is_not_correct(root, monkeypatch, fault):
    if fault == "wrong-node":
        _observation_at_wrong_node(monkeypatch)
        line, rec = run_tiny(root)
    else:
        line, rec = run_tiny(root, control=fault)
    assert not line["correct"], rec["checks"]
    if fault != "f32":
        assert line["checks"]["assembly_err"]["value"] > line["checks"]["assembly_err"]["limit"]
