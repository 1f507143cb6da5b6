"""The slow tier and the per-test wall limit of the tests under tests/.

Tier-1 is `python -m pytest tests/ -m "not slow"`; `python -m pytest -m slow
tests/` runs the rest.  Every test under tests/ runs under a wall limit:
240 s unless a `time_limit(seconds, reason=...)` mark raises it.  Tests
outside tests/ (portbench/tests) keep their own settings; only xdist's file
order is set for every session.  Nothing of the JAX package is imported here,
so this file loads on the card's machine too.
"""
import contextlib
import faulthandler
import os
import signal
import time
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"

# -- the slow tier ---------------------------------------------------------------
# A test is `slow` only if it takes more than a minute on one CPU worker (the
# JAX package's interpret-mode Pallas programs) or starts a multi-process
# cluster that compiles the JAX package's sharded train program.  Each entry
# gives the test's wall limit and, as its reason, what it waits on and its
# seconds measured cold on one worker.
_SLOW = {
    "test_pallas_contact.py::test_env_step_pallas_matches_xla":
        (1500, "interpret-mode Pallas env step, 657 s cold"),
    "test_pallas_dynamics.py::test_env_step_exact_pallas_matches_exact_xla":
        (900, "interpret-mode Pallas env step, 337 s cold"),
    "test_pallas_dynamics.py::"
    "test_env_step_heightfield_exact_pallas_matches_xla":
        (900, "interpret-mode Pallas env step, 330 s cold"),
    "test_pallas_dynamics.py::"
    "test_env_step_heightfield_reuse_pallas_close_to_xla":
        (900, "interpret-mode Pallas env step, 277 s cold"),
    "test_pallas_megastep.py::test_megastep_matches_substep_actuator_net":
        (1200, "interpret-mode Pallas megastep, 364 s cold"),
    "test_pallas_megastep.py::test_megastep_matches_substep_p_control":
        (1200, "interpret-mode Pallas megastep, 353 s cold"),
    "test_pallas_megastep.py::test_megastep_heightfield":
        (900, "interpret-mode Pallas megastep, 245 s cold"),
    "test_pallas_megastep.py::test_megastep_exact_mode":
        (900, "interpret-mode Pallas megastep, 237 s cold"),
    "test_pallas_megastep.py::"
    "test_substep_targets_unroll_matches_sequential_shift":
        (600, "interpret-mode Pallas megastep, 111 s cold"),
    "test_warm_start.py::test_megastep_warmstart_standing_trajectory":
        (1500, "interpret-mode Pallas megastep rollout, 626 s cold"),
    "test_sharding.py::test_sharded_step_matches_single_device":
        (1800, "8-device interpret-mode Pallas step, 795 s cold"),
    "test_sharding.py::test_sharded_train_iteration_matches_single_device":
        (1800, "8-device interpret-mode train iteration, 647 s cold"),
    "test_sharding.py::test_full_config_pallas_step_on_mesh":
        (1200, "8-device interpret-mode Pallas step, 398 s cold"),
    "test_sharding.py::test_runner_with_mesh":
        (1200, "8-device interpret-mode Runner iteration, 501 s cold"),
    "test_golden_trajectory.py::test_matches_golden_trajectory":
        (900, "interpret-mode Pallas rollout, 293 s cold"),
    "test_golden_trajectory.py::test_matches_golden_trajectory_default_config":
        (900, "interpret-mode Pallas rollout, 283 s cold"),
    "test_multihost.py::test_two_process_cluster_trains_and_agrees":
        (1560, "2-process jax.distributed cluster, 427 s cold"),
    "test_multihost.py::test_shared_storage_checkpoint_resume_bit_exact":
        (1560, "two 2-process jax.distributed clusters, 667 s cold"),
}
# tier-1 tests that need more than the default wall limit
_LONG = {
    "test_sharding.py::test_scaling_dryrun_8dev":
        (1200, "8-device train iteration, 415 s cold, 404-625 s in tier-1"),
}


def _in_tests(item):
    return TESTS in item.path.parents


def _name(item):
    return f"{item.path.name}::{getattr(item, 'originalname', item.name)}"


def pytest_itemcollected(item):
    if not _in_tests(item):
        return
    name = _name(item)
    if name in _SLOW:
        item.add_marker(pytest.mark.slow)
    seconds, reason = _SLOW.get(name) or _LONG.get(name) or (None, None)
    if seconds is not None:
        item.add_marker(pytest.mark.time_limit(seconds, reason=reason))
    # test_config_parity.py reads the reference's own config snapshot, which
    # is not in the repo; its cases run where the file exists
    ref = getattr(item.module, "REF_PKL", None)
    if ref is not None and not os.path.exists(ref):
        item.add_marker(pytest.mark.skip(
            reason=f"the reference's config snapshot {ref} is absent"))


@pytest.hookimpl(trylast=True)  # after `-m` has deselected
def pytest_collection_modifyitems(config, items):
    # a file holding a test with a raised limit goes first, so that under
    # `--dist loadfile` a worker starts it at once instead of ending the run
    # with it (see pytest_configure)
    long = {item.path for item in items
            if time_limit(item) > DEFAULT_TIME_LIMIT}
    items.sort(key=lambda item: item.path not in long)


# -- per-test wall limit ---------------------------------------------------------
# Every test's set-up, call and teardown share one wall limit, so the set-up
# of a module-scoped fixture counts against the test that triggers it.
# SIGALRM fails the test with its own name and traceback.  A call into C code
# holds the signal until it returns; if it is still inside after a grace
# period, faulthandler prints every thread's stack to the real stderr.
# (Ending the worker there instead would not help: xdist's loadfile
# scheduling hands the crashed test to each new worker in turn.)
DEFAULT_TIME_LIMIT = 240.0
_BACKSTOP_GRACE = 60.0
_TEARDOWN_GRACE = 30.0
_DEADLINE = pytest.StashKey[float]()
_STDERR_FD = pytest.StashKey[int]()


def time_limit(item):
    """The wall limit of `item` in seconds: its closest `time_limit` mark,
    else DEFAULT_TIME_LIMIT."""
    mark = item.get_closest_marker("time_limit")
    if mark is None:
        return DEFAULT_TIME_LIMIT
    if not mark.args or not mark.kwargs.get("reason"):
        raise pytest.UsageError(
            f"{item.nodeid}: write time_limit(seconds, reason=...)")
    return float(mark.args[0])


def pytest_configure(config):
    # xdist's loadfile hands out files by their number of tests, most first,
    # unless `--no-loadscope-reorder`; keep the collection's order instead
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False
    # the real stderr, not the capture's, so the backstop's dump is seen
    capman = config.pluginmanager.getplugin("capturemanager")
    with (capman.global_and_fixture_disabled() if capman
          else contextlib.nullcontext()):
        config.stash[_STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


@contextlib.contextmanager
def _wall_limit(item, when):
    if not _in_tests(item):
        yield
        return
    limit = time_limit(item)
    if when == "setup":
        item.stash[_DEADLINE] = time.monotonic() + limit
    left = item.stash[_DEADLINE] - time.monotonic()
    if when == "teardown":
        left = max(left, _TEARDOWN_GRACE)

    def on_alarm(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit:g} s "
                    f"(in {when})")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))
    faulthandler.dump_traceback_later(left + _BACKSTOP_GRACE,
                                      file=item.config.stash[_STDERR_FD])
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _wall_limit(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _wall_limit(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _wall_limit(item, "teardown"):
        return (yield)
