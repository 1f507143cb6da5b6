#!/usr/bin/env python3
"""Where the time of the team control-step kernel (K4) goes, on one NVIDIA
GPU.

    python3 kernel_ablation.py

Builds `csrc/megastep_team.cu` as it is and in copies with one part of its
work cut out or one launch setting changed (one text edit each, under
`build/ablation/`, one nvcc each, all started together), times every copy
with CUDA events over 20 launches on one input (`mob_train_cfg(4000)`, 24
random control steps in, the default route's arguments) and prints one JSON
line per variant with its time beside the unchanged kernel's, then the
card's name and power limit.  The cut copies compute wrong results: they
are timed, never checked (`chip_smoke.py` checks the kernel).  Runs
nothing else; needs one CUDA device.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    sys.stderr.write("kernel_ablation.py needs a CUDA device\n")
    sys.exit(2)

from walk_these_ways_tpu_torch.envs.go1_env import (  # noqa: E402
    LeggedRobotEnv, make_generator)
from walk_these_ways_tpu_torch.go1_config import mob_train_cfg  # noqa: E402
from walk_these_ways_tpu_torch.ops import _build, megastep  # noqa: E402
from walk_these_ways_tpu_torch.physics import engine  # noqa: E402

SRC = "megastep_team.cu"
# (name, what it changes, [(text, replacement)] in SRC)
VARIANTS = (
    ("kernel", "the kernel as it is", []),
    ("no_actuator_net", "the two hidden layers skipped (torques from "
     "zeros)", [("for (int jj = 0; jj < NJ; jj += 2) {",
                 "for (int jj = 0; jj < 0; jj += 2) {")]),
    ("no_entry_cache", "the entry-cache build skipped",
     [("    team_entry_cache(s, q, LD(I_PAYLOAD, 0), comdisp, mk, lane);\n",
       "")]),
    ("no_contact_sweeps", "no projected-Jacobi sweep (gaps, seed and point "
     "advance kept)", [("for (int it = 0; it < iters; ++it) {",
                        "for (int it = 0; it < 0; ++it) {")]),
    ("one_dynamics_evaluation", "the midpoint rule's second dynamics "
     "evaluation skipped", [("    team_dynamics(s, s.gv, mk, lane);\n",
                             "")]),
    ("registers_unbounded", "__launch_bounds__ asks for no number of "
     "resident blocks (ptxas may use more registers a thread)",
     [("__launch_bounds__(TEAM * TEAM_ENVS, TEAM_MIN_BLOCKS)",
       "__launch_bounds__(TEAM * TEAM_ENVS)")]),
)


def build(model, root):
    """One nvcc per variant, all started together; returns the bound
    libraries by name."""
    header = megastep.topology_header(model, 32, 6)
    procs = {}
    for name, _, edits in VARIANTS:
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        path = os.path.join(d, SRC)
        text = open(path).read()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} stands {text.count(old)} "
                                 "times")
            text = text.replace(old, new)
        open(path, "w").write(text)
        open(os.path.join(d, _build.HEADER_NAME), "w").write(header)
        lib = os.path.join(d, "libmegastep_team.so")
        cmd = [_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-I", d, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs, logs = {}, {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        logs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "stack frame" in ln]
        libs[name] = _build.bind(ctypes.CDLL(lib), "megastep_team",
                                 *megastep.library_spec(model)[2])
    return libs, logs


def main():
    dev = torch.device("cuda", 0)
    n = 4000
    env = LeggedRobotEnv(mob_train_cfg(n), device=dev)
    gen = make_generator(0, dev)
    state, _ = env.reset(gen)
    for _ in range(24):
        state, *_ = env.step(state, torch.randn((n, 12), generator=gen,
                                                device=dev))
    _, dyn, _, _, tgt_eff, ctrl, lam_in = env.control_step_inputs(state)
    args, kwargs = engine.megakernel_args(
        env.model, env.sim_params, state.phys, dyn, env.terrain, tgt_eff,
        state.motor_strengths, env.torque_limits, ctrl,
        env.cfg.control.decimation, lam_in)
    ptrs, outs, floats, ints, _ = megastep.kernel_operands(*args, **kwargs)
    libs, logs = build(env.model, os.path.join(_build.build_dir(),
                                                "ablation"))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def time_ms(lib):
        def once():
            _build.launch(lib, "megastep_team", ptrs, outs, floats, ints,
                          stream)
        for _ in range(3):
            once()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            once()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / 20

    # in turns: kernel, each variant, kernel
    base = [time_ms(libs["kernel"])]
    rows = []
    for name, what, _ in VARIANTS[1:]:
        rows.append((name, what, time_ms(libs[name])))
    base.append(time_ms(libs["kernel"]))
    print(json.dumps(dict(variant="kernel", what=VARIANTS[0][1],
                          ms=base, n_envs=n, ptxas=logs["kernel"])),
          flush=True)
    for name, what, ms in rows:
        print(json.dumps(dict(variant=name, what=what, ms=ms,
                              kernel_ms=sum(base) / 2, n_envs=n,
                              ptxas=logs[name])), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
