"""Subprocesses that do not outlive their test: each runs in a session of
its own, whose whole process group is killed when the test is done with it."""
import os
import signal
import subprocess


def kill_group(proc):
    """Kill `proc`, started with `start_new_session=True`, and every process
    it started, then reap it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def run_group(cmd, timeout, **kwargs):
    """`subprocess.run(cmd, capture_output=True, text=True, timeout=...)`
    in a session of its own, whose whole process group is killed when the
    call returns, times out or is ended by the test's wall limit."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True, **kwargs)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        kill_group(proc)
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)
