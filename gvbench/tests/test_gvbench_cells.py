"""Whole runs at CPU sizes, past the harness's look for a card: cells added
as data files alone run; a sound run is correct; the comparison's control
(the program's float32 mode) and the timed path broken underneath come
out not correct. On the card (marker ``cuda``) each cell of
``BENCHMARK.json`` runs a short window."""

import json
import subprocess
import sys

import pytest
import torch
import torch.utils._pytree as pytree

from gvbench import run
from gvbench.tests.tiny import REPO, make_root

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("gvbench"))


def run_tiny(root, cell, seconds=4.0, control="f64", seed=2**31 + 99):
    return run.run_cell(root, cell, seed, seconds, 0, CPU, control)


@pytest.mark.parametrize("cell", ["tiny.replay", "tiny.batch"])
def test_new_cell_from_data_files_is_correct(root, cell):
    line, rec = run_tiny(root, cell)
    assert line["correct"], rec["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in run.harness.Spec(root).metrics(cell, False)}
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,control", [("tiny.replay", "f32"), ("tiny.batch", "f32"),
                                          ("tiny.replay", "klt-bf16")])
def test_control_is_not_correct(root, cell, control):
    line, rec = run_tiny(root, cell, control=control)
    assert not line["correct"], rec["checks"]


# the timed path broken underneath the harness's seams


def _unchanged_round(monkeypatch):
    from ic_gvins_tpu_torch.solver import lm

    real = lm.optimize

    def fault(window, *a, **k):
        return window, real(window, *a, **k)[1]  # the step returns its state unchanged

    monkeypatch.setattr(lm, "optimize", fault)


def _altered_track(monkeypatch):
    from ic_gvins_tpu_torch.vision import klt_cuda

    real = klt_cuda.lk_track_bidirectional

    def fault(*a, **k):
        pts, ok, fb = real(*a, **k)
        return pts + 0.25, ok, fb  # every tracked point moved where it is produced

    monkeypatch.setattr(klt_cuda, "lk_track_bidirectional", fault)


def _batch_fault(kind):
    def install(monkeypatch):
        from ic_gvins_tpu_torch.parallel import multi_seq

        real = multi_seq.optimize_batch

        def fault(windows, *a, **k):
            out, stats = real(windows, *a, **k)
            if kind == "unchanged":
                return windows, stats
            B = windows.nodes.p.shape[0]
            if kind == "half":  # the second half of the batch left out
                keep = torch.arange(B) < B // 2
                pick = lambda o, w: torch.where(  # noqa: E731
                    keep.view((B,) + (1,) * (o.dim() - 1)), o, w)
                return pytree.tree_map(pick, out, windows), stats
            p = out.nodes.p.clone()
            # one member's answer altered: the one that ran the most
            # iterations, which the comparison's sample always holds
            # by 5 cm, over the limit against positions some tens of m out
            p[int(torch.argmax(stats[3]))] += 0.05
            return out._replace(nodes=out.nodes._replace(p=p)), stats

        monkeypatch.setattr(multi_seq, "optimize_batch", fault)

    return install


def _misgathered_observations(monkeypatch):
    from ic_gvins_tpu_torch.engine.estimator import Estimator

    from gvbench import controls

    # record the method for monkeypatch to restore, then plant the fault
    monkeypatch.setattr(Estimator, "add_frame_observations", Estimator.add_frame_observations)
    controls.install("assembly-fault", [])


FAULTS = {
    "replay_unchanged_round": ("tiny.replay", _unchanged_round),
    "replay_misgathered_observations": ("tiny.replay", _misgathered_observations),
    "replay_altered_track": ("tiny.replay", _altered_track),
    "batch_unchanged": ("tiny.batch", _batch_fault("unchanged")),
    "batch_half_left_out": ("tiny.batch", _batch_fault("half")),
    "batch_altered_answer": ("tiny.batch", _batch_fault("altered")),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(root, monkeypatch, fault):
    cell, install = FAULTS[fault]
    install(monkeypatch)
    line, rec = run_tiny(root, cell)
    assert not line["correct"], rec["checks"]


# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    return torch.device("cuda", 0)


CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "gvbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 5), "--seconds", "3", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
