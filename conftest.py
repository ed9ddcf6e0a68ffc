"""Run settings of the test suite in ``tests/`` that sit beside
``tests/conftest.py``; pytest loads this file as the rootdir's conftest.

- ``SLOW`` marks ``slow`` the JAX-package tests that run for minutes, by
  node ID, so that tier-1 (``-m 'not slow'``) deselects them and
  ``-m slow`` runs them.
- ``LIMIT`` gives every other test in ``tests/`` a time limit of its own.
"""

import contextlib
import faulthandler
import os
import signal
import sys
import time
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"

# JAX-package tests that took over 120 s start to end on one worker of the
# tier-1 command (6 xdist workers, --dist load, 8 cores), counting the module
# fixture or the compiles the test was first to pay for. The tests that share
# a costly module fixture (test_ba_nodes.py's ``problem``, test_odo_window.py's
# ``odo_run``) are listed together: whichever of them runs first on a worker
# builds it. Others carry the marker in their own modules.
SLOW = frozenset("tests/" + t for t in (
    "test_ba_nodes.py::test_sharded_ba_converges",
    "test_ba_nodes.py::test_sharded_matches_single_chunk",
    "test_chi2_ab.py::test_chi2_capped_vs_compounding_under_bad_gnss",
    "test_extrinsic_td.py::test_extrinsic_recovered",
    "test_extrinsic_td.py::test_td_recovered",
    "test_f32_longrun.py::test_f32_longrun_tracks_f64",
    "test_f32_longrun.py::test_f32_vision_endurance_ci",
    "test_gvins_window.py::test_gvins_window_converges_and_recovers_depth",
    "test_gvins_window.py::test_gvins_beats_gins_with_sparse_gnss",
    "test_marginalization.py::test_prior_preserves_information",
    "test_marginalization.py::test_prior_residual_zero_at_linearization",
    "test_marginalization.py::test_prior_anchors_attitude_after_sliding",
    "test_marginalization.py::test_prior_matches_exact_schur_complement",
    "test_odo_window.py::test_odo_window_estimates_scale",
    "test_odo_window.py::test_odo_mode_accuracy_not_degraded",
    "test_odo_window.py::test_odo_checkpoint_roundtrip",
    "test_phase_split.py::test_split_phases_match_fused_round",
    "test_pipeline.py::test_pipeline_images_end_to_end",
    "test_second_new.py::test_second_new_frames_do_not_accumulate",
    "test_second_new.py::test_remove_node_merges_preintegration",
    "test_sharding.py::test_sharded_gn_step_matches_single_device",
    "test_sharding.py::test_multi_sequence_batch_matches_sequential",
    "test_sharding.py::test_sharded_two_phase_lm_matches_single_device",
    "test_sharding.py::test_engine_rounds_with_mesh_match_single_device",
    "test_solver.py::test_gins_window_converges",
))

# Time limit of each test in tests/ not marked ``slow``, in seconds, shared by
# its setup, call and teardown, so a module fixture's build counts against the
# first test that uses it. A test that hangs or runs long fails under its own
# name instead of holding its xdist worker, and the tests queued behind it,
# until the suite's own limit cuts the whole run. The alarm also ends a
# subprocess the test waits on (``subprocess.run`` kills its child). The
# longest tests left outside ``slow`` took 110-130 s in the tier-1 command on
# an 8-core host, about a third of LIMIT: each is the first test of its module
# on a worker and pays the XLA compiles the module's tests share, which
# marking it would only move to the next.
LIMIT = 400.0
# If the test is still running this long after its limit, it is stuck in
# native code (the alarm's handler runs only when the interpreter regains
# control, as inside an XLA compile it does not): dump every thread's
# traceback and end the process, so the worker's queue moves on.
DUMP_MARGIN = 60.0

_DEADLINE = pytest.StashKey[float]()
_TRACEBACK_FD = pytest.StashKey[int]()


def pytest_configure(config):
    # a copy of the real stderr: while a test runs, fd 2 is pytest's capture
    config.stash[_TRACEBACK_FD] = os.dup(sys.stderr.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_TRACEBACK_FD])


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # first, so that ``-m`` selects on the marker
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


@contextlib.contextmanager
def _within_limit(item):
    """Arm the alarm, and the traceback dump behind it, for what is left of
    the item's LIMIT during one phase, so the alarm always fires inside a
    phase whose exceptions pytest reports against the test."""
    if not item.path.is_relative_to(TESTS) or item.get_closest_marker("slow") is not None:
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"test exceeded the per-test time limit of {LIMIT:g} s (LIMIT in conftest.py)")

    left = item.stash[_DEADLINE] - time.monotonic()
    previous = signal.signal(signal.SIGALRM, expire)
    try:
        signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))
        faulthandler.dump_traceback_later(max(left, 0.0) + DUMP_MARGIN, exit=True,
                                          file=item.config.stash[_TRACEBACK_FD])
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True, trylast=True)
def pytest_runtest_setup(item):
    item.stash[_DEADLINE] = time.monotonic() + LIMIT
    with _within_limit(item):
        return (yield)


@pytest.hookimpl(wrapper=True, trylast=True)
def pytest_runtest_call(item):
    with _within_limit(item):
        return (yield)


@pytest.hookimpl(wrapper=True, trylast=True)
def pytest_runtest_teardown(item):
    with _within_limit(item):
        return (yield)
