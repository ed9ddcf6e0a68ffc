"""The per-test time limit and the ``slow`` list of the rootdir's
``conftest.py``: a test that runs past LIMIT, in its call, across its setup
and call, or waiting on a subprocess, fails with a message that names the
limit; a test under it passes; a test marked ``slow``, in its module or by
SLOW, has no limit; and every entry of SLOW names a test that exists.

Runs pytest in a subprocess on a throwaway test file, with the rootdir's
conftest registered as a plugin and its LIMIT patched to 1 s.
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

ROOT_CONFTEST = Path(__file__).resolve().parent.parent / "conftest.py"

INNER_CONFTEST = f"""
import importlib.util

spec = importlib.util.spec_from_file_location("root_conftest", {str(ROOT_CONFTEST)!r})
root = importlib.util.module_from_spec(spec)
spec.loader.exec_module(root)
root.LIMIT = 1.0
root.TESTS = root.Path(__file__).resolve().parent
root.SLOW = frozenset({{"test_inner.py::test_listed_in_slow"}})


def pytest_configure(config):
    config.pluginmanager.register(root, "root_conftest")
"""

INNER_TESTS = """
import os
import subprocess
import sys
import time

import pytest


@pytest.fixture
def setup_of_07_s():
    time.sleep(0.7)


def test_past_the_limit():
    time.sleep(30)


def test_setup_and_call_share_the_limit(setup_of_07_s):
    time.sleep(0.7)


def test_subprocess_past_the_limit():
    subprocess.run([sys.executable, "-c", "import os, time; "
                    "open('child.pid', 'w').write(str(os.getpid())); time.sleep(30)"], timeout=60)


def test_under_the_limit():
    time.sleep(0.1)


@pytest.mark.slow
def test_slow_has_no_limit():
    time.sleep(1.5)


def test_listed_in_slow():
    time.sleep(1.5)
"""


def test_limit_fails_only_a_test_past_it(tmp_path):
    (tmp_path / "pytest.ini").write_text("[pytest]\nmarkers =\n    slow: no time limit\n")
    (tmp_path / "conftest.py").write_text(INNER_CONFTEST)
    (tmp_path / "test_inner.py").write_text(INNER_TESTS)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider", "-p", "no:randomly",
         "test_inner.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=60)
    log = out.stdout + out.stderr
    assert out.returncode == 1, log
    for name in ("test_past_the_limit", "test_setup_and_call_share_the_limit",
                 "test_subprocess_past_the_limit"):
        assert f"FAILED test_inner.py::{name}" in log, log
    assert log.count("Failed: test exceeded the per-test time limit of 1 s") == 3, log
    for name in ("test_under_the_limit", "test_slow_has_no_limit", "test_listed_in_slow"):
        assert f"PASSED test_inner.py::{name}" in log, log
    assert "3 failed, 3 passed" in log, log
    # the alarm ended the subprocess the test waited on
    pid = int((tmp_path / "child.pid").read_text())
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        pass
    else:
        raise AssertionError(f"the test's subprocess {pid} outlived the limit")


def test_slow_list_names_tests_that_exist():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT_CONFTEST)
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    missing = []
    for entry in sorted(root.SLOW):
        module, name = entry.split("::")
        tree = ast.parse((ROOT_CONFTEST.parent / module).read_text())
        if name not in {node.name for node in tree.body if isinstance(node, ast.FunctionDef)}:
            missing.append(entry)
    assert not missing, missing
