"""Tracing / profiling utilities.

Counterpart of the JAX package's utils/profiling.py.  The reference has no
profiling beyond wall-clock splits (reference ppo_cse/__init__.py:136,
186-206).  Here: a `torch.profiler` trace context manager (host ops and the
device's kernels, CUPTI) that writes a Chrome trace, a summary of a trace
(the longest device ops and the device-busy share of the window), and a
simple phase timer.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: "str | None" = None):
    """Profile the block: host ops and, with a CUDA device, its kernels.
    Yields the `torch.profiler.profile`; on exit writes
    `<log_dir>/trace.json` (chrome://tracing or Perfetto) when `log_dir` is
    given (a PPO iteration's trace holds about 300,000 events)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_summary(prof, top: int = 5):
    """(the `top` device ops by total device time as [(name, ms, count)],
    device-busy share of the traced window, window ms).  The window runs
    from the first to the last event of any kind; busy is the union of the
    device events' intervals within it.  Reads the profiler's raw events:
    `prof.events()` would first build a Python object per event, over a
    minute for one PPO iteration's trace."""
    cuda = torch.autograd.DeviceType.CUDA
    t0, t1, dev = None, None, []
    for e in prof.profiler.kineto_results.events():
        s, en = e.start_ns(), e.end_ns()
        t0 = s if t0 is None else min(t0, s)
        t1 = en if t1 is None else max(t1, en)
        if e.device_type() == cuda:
            dev.append((s, en, e.name()))
    if t0 is None:
        return [], 0.0, 0.0
    busy, end = 0, t0
    by_name = defaultdict(lambda: [0.0, 0])
    for s, en, name in sorted(dev):
        if en > end:
            busy += en - max(s, end)
            end = en
        by_name[name][0] += (en - s) / 1e6
        by_name[name][1] += 1
    ops = sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                 key=lambda x: -x[1])[:top]
    window = t1 - t0
    return ops, (busy / window if window > 0 else 0.0), window / 1e6


class PhaseTimer:
    """Accumulates wall-clock per named phase (host-side)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        return {k: dict(total_s=v, mean_ms=1e3 * v / max(self.counts[k], 1))
                for k, v in self.totals.items()}
