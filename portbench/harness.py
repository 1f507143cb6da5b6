"""One run of one cell: set-up (the job built from the seed and driven
through its first, checked iterations), the measured window, the traced
stretch (`--trace 1`), the comparison with the reference, and the result's
line.  `run.py` is its command line."""
from __future__ import annotations

import gc
import json
import math
import os
import resource
import subprocess
import sys
import time

from . import spec

CACHE = os.path.join(spec.HERE, ".cache")
# what must not be in the process once the window has closed, by whole
# top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "walk_these_ways_tpu")


def prepare_caches():
    """Every build and kernel cache of the program in fixed directories
    inside the checkout, so that only a cell's first run there builds."""
    for var, sub in (("WTW_TORCH_BUILD_DIR", "build"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        path = os.path.join(CACHE, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0] if out else "unknown"


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def drain(pending):
    """The iterations' metrics to the host in one copy, as the program's
    Runner drains them every `log_freq` iterations."""
    import torch
    if not pending:
        return None
    flat = torch.cat([torch.cat([v.reshape(-1).to(torch.float64)
                                 for v in m if isinstance(v, torch.Tensor)])
                      for m in pending])
    return flat.cpu().numpy()


def set_up(cell, seed: int, device, package: str, phases: dict):
    """The job built and driven through its checked iterations (the
    warm-up: every shape the window uses), with their capture."""
    from . import capture as cap_mod
    from . import job as job_mod
    side = job_mod.side(package, cell.config["algo"])
    job = job_mod.build(side, cell, device, seed, phases)
    t = time.perf_counter()
    traffic = cell.traffic
    steps = int(traffic["num_steps_per_env"])
    n_it = int(traffic["checked_iterations"])
    cap = cap_mod.Capture(job, cap_mod.sample_steps(
        job.seeds["sample"], n_it, steps, int(traffic["checked_env_steps"])))
    cap.install()
    pending = []
    for k in range(n_it):
        cap.begin(k)
        job.env_state, job.obs_dict, job.ts, metrics = job.train_iter(
            job.env_state, job.obs_dict, job.ts)
        cap.end(metrics)
        pending.append(metrics)
    cap.remove()
    drain(pending)      # the window's drain, warmed with its own kernels
    sync(device)
    phases["warmup"] = time.perf_counter() - t
    return job, cap


class HostClocks:
    """What the host did in each stretch between drains: the wall seconds,
    the CPU seconds of the main thread and of the whole process, the
    seconds the Python garbage collector paused, and the involuntary
    context switches; read once a drain, so the window pays nothing
    else."""

    def __init__(self):
        self.rows = []
        self.gc_s = 0.0
        self._gc_t = None
        gc.callbacks.append(self._on_gc)
        self._last = self._now()

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self._gc_t = None

    def _now(self):
        return (time.perf_counter(), time.thread_time(), time.process_time(),
                self.gc_s, resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw)

    def mark(self):
        now = self._now()
        self.rows.append([b - a for a, b in zip(self._last, now)])
        self._last = now

    def close(self) -> str:
        gc.callbacks.remove(self._on_gc)
        cols = list(zip(*self.rows)) or [()] * 5
        names = ("seconds", "main thread's CPU seconds",
                 "process's CPU seconds", "garbage-collector pauses, s",
                 "involuntary context switches")
        return "; ".join(f"{n}: {[round(v, 4) for v in c]}"
                         for n, c in zip(names, cols))


def window(job, seconds: float, log_freq: int, device, spans=None):
    """Whole iterations until `seconds` have passed, the metrics drained
    every `log_freq`; (iterations, seconds from the first one's start to a
    synchronise after the last)."""
    pending, n = [], 0
    clocks = HostClocks()
    t0 = time.perf_counter()
    while True:
        if spans is None:
            job.env_state, job.obs_dict, job.ts, m = job.train_iter(
                job.env_state, job.obs_dict, job.ts)
        else:
            with spans.iteration():
                job.env_state, job.obs_dict, job.ts, m = job.train_iter(
                    job.env_state, job.obs_dict, job.ts)
        pending.append(m)
        n += 1
        if n % log_freq == 0:
            drain(pending)
            pending = []
            clocks.mark()
        if time.perf_counter() - t0 >= seconds:
            break
    drain(pending)
    sync(device)
    secs = time.perf_counter() - t0
    log(f"window: {n} iterations in {secs:.6f} s; each {log_freq} "
        f"iterations between drains: {clocks.close()}")
    return n, secs


PROFILED_ITERATIONS = 2


def traced(job, cell, seconds: float, device):
    """The spans over a window of `seconds`, then PROFILED_ITERATIONS whole
    iterations under torch.profiler; the readers' context."""
    import torch

    from . import trace, work
    spans = trace.Spans(job.side.learner, device)
    spans.install()
    window(job, seconds, int(cell.traffic["log_freq"]), device, spans)
    outside = {k: list(v) for k, v in spans.times.items()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED_ITERATIONS):
            with spans.iteration():
                job.env_state, job.obs_dict, job.ts, _ = job.train_iter(
                    job.env_state, job.obs_dict, job.ts)
    spans.remove()
    t = time.perf_counter()
    p = trace.read_profile(prof)
    del prof
    w = trace.window_summary(p)
    n_envs = int(cell.traffic["num_envs"])
    steps = int(cell.traffic["num_steps_per_env"])
    ctx = dict(cell=cell, spans=outside, profile=p, window=w,
               num_envs=n_envs, num_steps=steps,
               flops=work.iteration_flops(cell.config, n_envs, steps),
               kernel_work=work.kernel_work(cell.config, n_envs))
    log(f"trace read in {time.perf_counter() - t:.3f} s: "
        f"{len(p['device'])} device operations, {len(p['host'])} host "
        "events")
    return ctx


def _num(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def main(argv=None, t_start=None):
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if a.seed < 0:
        ap.error("--seed: a whole number >= 0")
    cell = spec.load_cell(a.workload)
    prepare_caches()

    phases = {}
    t = time.perf_counter()
    import torch
    try:
        import walk_these_ways_tpu_torch  # noqa: F401  (the program)
    except ImportError as e:
        log(f"the program does not import: {e}")
        return 2
    phases["imports"] = time.perf_counter() - t
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    if cell.chips != 1 or int(cell.traffic.get("ranks", 1)) != 1:
        log(f"{cell.name}: this harness runs one rank on one card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    result = run_cell(cell, a.seed, a.seconds, a.trace, device, phases,
                      t_start, kind=torch.cuda.get_device_name(0),
                      limit=power_limit())
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, trace_: int, device,
             phases: dict, t_start: float, kind: str, limit: str):
    """Everything of a run after the look for the card: set-up, the window
    or the traced stretch, the comparison; the result (None where a
    forbidden module was loaded, which is logged)."""
    import torch
    job, cap = set_up(cell, seed, device, "walk_these_ways_tpu_torch",
                      phases)
    setup_s = time.perf_counter() - t_start
    log("setup " + ", ".join(f"{k} {v:.6f} s" for k, v in phases.items())
        + f"; total {setup_s:.6f} s")

    n_envs = int(cell.traffic["num_envs"])
    steps = int(cell.traffic["num_steps_per_env"])
    metrics, device_info, extra = {}, {}, {}
    if trace_ == 0:
        n_it, secs = window(job, seconds, int(cell.traffic["log_freq"]),
                            device)
        rate = n_it * steps * n_envs / secs
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = {"train_env_steps_per_s": rate, "setup_s": setup_s}
        metrics = {k: {"value": values[k], "unit": units[k]}
                   for k in units}
    else:
        from . import trace
        ctx = traced(job, cell, seconds, device)
        n_it = len(ctx["spans"].get(trace.ITERATION, []))
        for m in cell.per_layer:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        w = ctx["window"]
        device_info = dict(busy_s=w["busy_s"], window_s=w["window_s"])
        extra["breakdown"] = trace.breakdown(ctx["profile"], w)
        del ctx
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"card: {kind}, power limit {limit}, memory peak {peak} bytes")

    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    from . import check
    nums, extras = check.numbers(cap, cell, device)
    ok, rows = check.verdict(nums, cell.limits)
    log(f"reference check {time.perf_counter() - t:.3f} s; a state left "
        f"unchanged reads {extras['stale']}; leaves left out of change: "
        f"{extras['change_left_out']}; largest gaps at {extras['worst']}")
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the benchmark must not load: {bad}")
        return None
    result = {"correct": bool(ok), "attempted": n_it, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu", "kind": kind, "count": 1,
                         "memory_peak_bytes": int(peak), **device_info},
              **extra,
              "checks": {n: {"value": _num(v), "limit": lim}
                         for n, v, lim in rows}}
    for n, v, lim in rows:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    return result
