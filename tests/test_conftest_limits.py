"""The per-test wall limit of the root conftest.py, run in a pytest of its own.

One test sleeps past a 2 s `time_limit`, one finishes inside it; the first
fails with its own name and the limit, the second passes, and the whole
session ends in seconds instead of when the sleep would have.
"""
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = '''
import time

import pytest


@pytest.mark.time_limit(2, reason="the limit under test")
def test_sleeps_past_its_limit():
    time.sleep(60)


@pytest.mark.time_limit(2, reason="the limit under test")
def test_finishes_inside_its_limit():
    time.sleep(0.1)
'''

INI = '''[pytest]
markers =
    slow: long tier
    time_limit(seconds, reason): wall limit
'''


def test_a_test_past_its_time_limit_fails_and_the_rest_runs(tmp_path):
    shutil.copy(os.path.join(ROOT, "conftest.py"), tmp_path / "conftest.py")
    (tmp_path / "pytest.ini").write_text(INI)
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_cases.py").write_text(CASES)
    start = time.monotonic()
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "-p", "no:randomly", "tests/test_cases.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=60,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    took = time.monotonic() - start
    out = p.stdout + p.stderr
    assert p.returncode == 1, out
    assert ("tests/test_cases.py::test_sleeps_past_its_limit ran past its "
            "time limit of 2 s (in call)") in out, out
    assert "FAILED tests/test_cases.py::test_sleeps_past_its_limit" in out, out
    assert ("PASSED tests/test_cases.py::test_finishes_inside_its_limit"
            in out), out
    assert "time.sleep(60)" in out, out  # the traceback reaches the test
    assert took < 30, took
