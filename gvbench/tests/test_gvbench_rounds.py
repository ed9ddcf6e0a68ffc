"""The replay whose window counts the estimator's rounds (kind
``replay_rounds``), as a cell added in data files alone at CPU sizes: a
sound run is correct and reads ``windows_per_s`` as its rounds over its
wall; the planted ``assembly-fault`` comes out not correct."""

import json

import pytest
import torch

from gvbench import run
from gvbench.tests.tiny import make_root

CPU = torch.device("cpu")
CELL = "tiny.rounds"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    root = make_root(tmp_path_factory.mktemp("gvbench_rounds"))
    tr = json.loads((root / "gvbench/traffic/tiny_replay.json").read_text())
    tr["kind"] = "replay_rounds"
    (root / "gvbench/traffic/tiny_rounds.json").write_text(json.dumps(tr))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "tiny", "traffic": "tiny_rounds",
                              "chips": 1, "why": "CPU test sizes"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        ws = m.get("workloads")
        if ws is not None and ("tiny.replay" in ws or m["name"] == "windows_per_s"):
            ws.append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run_tiny(root, control="f64", seed=2**31 + 99):
    return run.run_cell(root, CELL, seed, 4.0, 0, CPU, control)


def test_rounds_cell_is_correct_and_counts_rounds(root):
    line, rec = run_tiny(root)
    assert line["correct"], rec["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in run.harness.Spec(root).metrics(CELL, False)}
    assert {"windows_per_s", "setup_s"} <= want == set(line["metrics"])
    w = rec["window"]
    rounds = len(w["stage_ms"]["optimize"])
    assert rounds > 0 and w["calls"] == rounds and w["batch"] == 1
    assert line["metrics"]["windows_per_s"]["value"] == pytest.approx(rounds / w["wall_s"])
    assert set(rec["notes"]["dead_cleared"]) == {"observations", "slots"}
    assert set(line["checks"]) == set(json.loads(
        (root / "gvbench/limits/replay_rounds.json").read_text()))


def test_rounds_cell_assembly_fault_is_not_correct(root):
    line, rec = run_tiny(root, control="assembly-fault")
    assert not line["correct"], rec["checks"]
    assert line["checks"]["assembly_err"]["value"] > line["checks"]["assembly_err"]["limit"]
