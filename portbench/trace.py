"""The traced run's readings: the harness's own spans around the calls into
the learner's layers (each ends in a synchronise), and one profiled stretch
of whole iterations under torch.profiler, reduced to device intervals,
host ranges, the busy and idle time of the device and the breakdown.  The
interval arithmetic is a frozen copy of the program's
`utils/profiling.device_summary`: the union of the device events'
intervals, read from the profiler's raw events."""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

ROLLOUT, UPDATE, ITERATION = ("portbench.rollout", "portbench.update",
                              "portbench.iteration")
COLLECTIVE = "portbench.collective"
# the iterations of the stretch in which the collectives are timed
COLLECTIVE_ITERATION = "portbench.collective_iteration"
# host events of the profiler itself, not of the program
PROFILER_BOOKKEEPING = ("Activity Buffer Request",)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Wraps the learner's `collect` and `update` so that each call is a
    span (host clock, ending in a synchronise) and a profiler range."""

    def __init__(self, learner, device):
        self.learner = learner
        self.device = device
        self.times = defaultdict(list)
        self._orig = {}
        self._patched = []      # (owner, attribute, original)

    def _wrap(self, attr, name):
        orig = getattr(self.learner, attr)
        self._orig[attr] = orig

        def call(*a, **kw):
            t = time.perf_counter()
            with torch.profiler.record_function(name):
                out = orig(*a, **kw)
                _sync(self.device)
            self.times[name].append(time.perf_counter() - t)
            return out
        setattr(self.learner, attr, call)

    def install(self):
        self._wrap("collect", ROLLOUT)
        self._wrap("update", UPDATE)

    def install_collectives(self, mesh_mod):
        """Each outermost call of the program's `parallel/mesh`
        `all_reduce_sum`, `broadcast_` and `EnvRows.gather` (which sums
        through `all_reduce_sum`) a span under COLLECTIVE: a synchronise,
        the call, a synchronise, so that the span is the collective with
        the wait for the other ranks, not the work queued before it."""
        depth = [0]

        def wrap(owner, attr):
            orig = getattr(owner, attr)
            self._patched.append((owner, attr, orig))

            def call(*a, **kw):
                if depth[0]:
                    return orig(*a, **kw)
                depth[0] += 1
                try:
                    _sync(self.device)
                    t = time.perf_counter()
                    with torch.profiler.record_function(COLLECTIVE):
                        out = orig(*a, **kw)
                        _sync(self.device)
                    self.times[COLLECTIVE].append(time.perf_counter() - t)
                finally:
                    depth[0] -= 1
                return out
            setattr(owner, attr, call)
        wrap(mesh_mod, "all_reduce_sum")
        wrap(mesh_mod, "broadcast_")
        wrap(mesh_mod.EnvRows, "gather")

    @contextlib.contextmanager
    def iteration(self, name: str = ITERATION):
        t = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            _sync(self.device)
        self.times[name].append(time.perf_counter() - t)

    def remove(self):
        for attr, orig in self._orig.items():
            setattr(self.learner, attr, orig)
        self._orig = {}
        for owner, attr, orig in reversed(self._patched):
            setattr(owner, attr, orig)
        self._patched = []


def _annotation(e) -> bool:
    """A range a `record_function` marks on the device's timeline, which
    is no device work (`Optimizer.step#Adam.step`, the harness's ranges)."""
    return bool(e.is_user_annotation())


def read_profile(prof) -> dict:
    """Device operations [(start_ns, end_ns, name)] sorted (kernels,
    copies and sets; the device-side marks of host ranges left out), host
    events the same (the profiler's own bookkeeping left out), and the
    harness's ranges by name, from the raw kineto events."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    ranges = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        s, en, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == cuda:
            if not _annotation(e):
                dev.append((s, en, name))
        elif name.startswith("portbench."):
            ranges[name].append((s, en))
        elif name not in PROFILER_BOOKKEEPING:
            host.append((s, en, name))
    dev.sort()
    host.sort()
    return dict(device=dev, host=host,
                ranges={k: sorted(v) for k, v in ranges.items()})


def busy_intervals(dev, t0: int, t1: int):
    """The union of the device intervals clipped to [t0, t1], merged."""
    out = []
    for s, en, _ in dev:
        s, en = max(s, t0), min(en, t1)
        if en <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], en)
        else:
            out.append([s, en])
    return out


def window_summary(p: dict) -> dict:
    """busy_s, window_s (from the first profiled iteration's start to the
    last one's end), the idle gaps [(start, end)] between busy intervals
    inside it, and the device time by op name."""
    its = p["ranges"].get(ITERATION, [])
    if not its:
        return {}
    t0, t1 = its[0][0], its[-1][1]
    busy = busy_intervals(p["device"], t0, t1)
    busy_ns = sum(en - s for s, en in busy)
    gaps, prev = [], t0
    for s, en in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = en
    if t1 > prev:
        gaps.append((prev, t1))
    by_name = defaultdict(float)
    for s, en, name in p["device"]:
        if s >= t0 and en <= t1:
            by_name[name] += (en - s) / 1e9
    return dict(busy_s=busy_ns / 1e9, window_s=(t1 - t0) / 1e9, gaps=gaps,
                by_name=dict(by_name), t0=t0, t1=t1)


def label_gap(host, starts, mid: int, ranges=None) -> str:
    """The innermost host op running at `mid` (the shortest that spans
    it), skipping the CUDA runtime's own calls where an op holds them;
    where none runs, the harness's range (rollout or update) it lies in."""
    i = bisect.bisect_right(starts, mid)
    best, best_rt = None, None
    for j in range(i - 1, max(-1, i - 4000), -1):
        s, en, name = host[j]
        if en >= mid:
            if name.startswith("cuda"):
                if best_rt is None or en - s < best_rt[0]:
                    best_rt = (en - s, name)
            elif best is None or en - s < best[0]:
                best = (en - s, name)
    if best is not None:
        return best[1] if best_rt is None else f"{best[1]} > {best_rt[1]}"
    if best_rt is not None:
        return best_rt[1]
    for name in (ROLLOUT, UPDATE):
        if any(a <= mid <= b for a, b in (ranges or {}).get(name, [])):
            return f"host between ops in {name.split('.')[1]}"
    return "host between ops"


def breakdown(p: dict, w: dict, top: int = 10, gaps_labelled: int = 400):
    """{"device_ops": the `top` ops by device time, "idle_gaps": the idle
    time of the `gaps_labelled` longest gaps summed by the host op running
    in each, the `top` largest}, seconds as measured."""
    ops = sorted(w["by_name"].items(), key=lambda x: -x[1])[:top]
    starts = [h[0] for h in p["host"]]
    longest = sorted(w["gaps"], key=lambda g: g[0] - g[1])[:gaps_labelled]
    by_label = defaultdict(float)
    for s, en in longest:
        by_label[label_gap(p["host"], starts, (s + en) // 2,
                           p["ranges"])] += (en - s) / 1e9
    gaps = sorted(by_label.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


def in_ranges(events, ranges):
    """The events whose start lies inside one of `ranges`."""
    out = []
    for s, en, name in events:
        for a, b in ranges:
            if a <= s <= b:
                out.append((s, en, name))
                break
    return out
