#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for sm_90a).

    python3 chip_smoke.py

Builds the control-step kernel from csrc/megastep.cu with nvcc, holds it
against its plain PyTorch version on the card at the main path's shapes
(4000 envs), then drives the port's main path — the policy rollout of
`mob_train_cfg(4000)` — through the entry points a user calls, and checks
what comes out.  Prints one JSON line per phase; needs one CUDA device and no
network; exits non-zero if any phase fails or no CUDA device is present.

The last line of the output is
    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": n}}
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py needs a CUDA device: "
                     "torch.cuda.is_available() is False\n")
    sys.exit(2)

from walk_these_ways_tpu_torch.envs.go1_env import (  # noqa: E402
    LeggedRobotEnv, make_generator)
from walk_these_ways_tpu_torch.go1_config import mob_train_cfg  # noqa: E402
from walk_these_ways_tpu_torch.learn.rollout import rollout  # noqa: E402
from walk_these_ways_tpu_torch.models.actor_critic import ActorCritic  # noqa: E402
from walk_these_ways_tpu_torch.ops import megastep  # noqa: E402
from walk_these_ways_tpu_torch.physics import engine  # noqa: E402
from walk_these_ways_tpu_torch.utils import convert  # noqa: E402

DEV = torch.device("cuda", 0)
OUT_NAMES = ("q", "qd", "pos", "quat", "lin", "ang", "pcp", "pcp_prev",
             "lam", "tau", "el", "ell", "vl", "vll")
# Kernel vs plain version on the card: |a - b| <= ATOL + RTOL * |b|.
# Both are float32.  nvcc contracts a*b+c into one fused multiply-add and the
# kernel sums in its own order, while the plain version rounds every
# elementwise op; over 4 substeps x (2 dynamics evaluations + 3 solver sweeps)
# those roundings are amplified by M^-1 (entries up to 1e2) into joint
# velocities that reach the 28 rad/s clip.  The largest error measured at
# 4000 envs is 3e-5 (on a joint velocity): the bound leaves a factor of a few.
ATOL, RTOL = 2e-4, 2e-4
N_ENVS = 4000       # the full width of mob_train_cfg
ROLLOUT_STEPS = 64  # control steps of the main-path rollout
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s on CUDA cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# directory of the JAX package, which this script names and never imports
JAX_PACKAGE = "walk_these_ways_" + "tpu"


def say(**kw):
    print(json.dumps(kw), flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True).stdout.strip()


def time_cuda(fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_call_of(env, state):
    """(args, kwargs) of the control-step call that `env.step` makes from
    `state`."""
    _, dyn, _, _, tgt_eff, ctrl, lam_in = env.control_step_inputs(state)
    return engine.megakernel_args(
        env.model, env.sim_params, state.phys, dyn, env.terrain, tgt_eff,
        state.motor_strengths, env.torque_limits, ctrl,
        env.cfg.control.decimation, lam_in)


def compare(name, args, kwargs, n_valid):
    """Kernel vs plain version on the same inputs, on the card."""
    out_k = megastep.control_step(*args, **kwargs)
    torch.cuda.synchronize()
    out_r = megastep.control_step_reference(*args, **kwargs)
    torch.cuda.synchronize()
    errs, worst_abs, ok = {}, 0.0, True
    for nm, a, b in zip(OUT_NAMES, out_k, out_r):
        a, b = a[..., :n_valid], b[..., :n_valid]
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise SystemExit(f"kernel phase '{name}': non-finite values in {nm}")
        d = (a - b).abs()
        max_abs = float(d.max())
        max_rel = float((d / (b.abs() + ATOL / RTOL)).max())
        bad = int((d > ATOL + RTOL * b.abs()).sum())
        errs[nm] = dict(max_abs=max_abs, max_rel=max_rel, beyond_tol=bad,
                        ref_max=float(b.abs().max()))
        worst_abs = max(worst_abs, max_abs)
        ok = ok and bad == 0
    say(phase="kernel_vs_plain", state=name, n_envs=n_valid, atol=ATOL,
        rtol=RTOL, ok=ok, max_abs_err=worst_abs,
        tolerance="|kernel - plain| <= atol + rtol |plain|; float32 both, "
                  "fused multiply-adds and another summation order in the "
                  "kernel, amplified over 4 substeps into joint velocities "
                  "of up to 28 rad/s",
        outputs=errs,
        contact_impulse_max=errs["lam"]["ref_max"])
    if not ok:
        raise SystemExit(f"kernel phase '{name}': control-step kernel "
                         "disagrees with its plain version")
    return worst_abs


def main():
    t_start = time.time()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise SystemExit("float32 products must not run in TF32")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    say(phase="environment", python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=run([megastep._find_nvcc(), "--version"]).splitlines()[-2:],
        gpu=smi, device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count())

    N = N_ENVS
    cfg = mob_train_cfg(N)
    env = LeggedRobotEnv(cfg, device=DEV)
    gen = make_generator(SEED, DEV)

    # ---- build ---------------------------------------------------------
    megastep.build_library(env.model, 32, 6)
    b = megastep.last_build
    say(phase="build", source="walk_these_ways_tpu_torch/csrc/megastep.cu",
        seconds=b["seconds"], cached=b["cached"], command=b["command"],
        ptxas=[ln for ln in b["log"].splitlines() if "registers" in ln
               or "stack frame" in ln][:4])

    # ---- policy: seeded actor/critic + the committed adaptation module --
    policy = ActorCritic(env.num_obs, env.num_privileged_obs,
                         env.num_obs_history, env.num_actions,
                         generator=gen, device=DEV)
    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "resources", "reference_policy",
                               "pretrain_v0_policy.npz"))
    convert.actor_critic_from_numpy({k: ref[k] for k in ref.files},
                                    module=policy)

    # ---- kernel phase: K4 against its plain version at N envs ----------
    state, obs = env.reset(gen)
    worst = compare("after_reset", *kernel_call_of(env, state), N)
    # 24 control steps of random actions in: feet and bodies on the ground
    for _ in range(24):
        a = torch.randn((N, 12), generator=gen, device=DEV)
        state, obs, _, _, _ = env.step(state, a)
    args, kwargs = kernel_call_of(env, state)
    worst = max(worst, compare("24_random_steps_in", args, kwargs, N))

    kernel_ms = time_cuda(lambda: megastep.control_step(*args, **kwargs), 20)
    t0 = time.time()
    megastep.control_step_reference(*args, **kwargs)
    torch.cuda.synchronize()
    t1 = time.time()
    megastep.control_step_reference(*args, **kwargs)
    torch.cuda.synchronize()
    plain_ms = min(t1 - t0, time.time() - t1) * 1e3
    t0 = time.time()
    engine.build_pallas_env_inputs(env.model, state.phys,
                                   env.control_step_inputs(state)[1],
                                   env.terrain, engine.MEGASTEP_BLOCK)
    torch.cuda.synchronize()
    cache_ms = (time.time() - t0) * 1e3
    nbytes, nops = megastep.work_per_env(
        env.model, cfg.control.decimation, cfg.sim.num_contact_iters_warm)
    bytes_ms = nbytes * N / PEAK_BYTES_S * 1e3
    ops_ms = nops * N / PEAK_FP32_S * 1e3
    say(phase="kernel_timing", n_envs=N, kernel_ms=kernel_ms,
        plain_ms=plain_ms, entry_cache_build_ms=cache_ms,
        bytes_per_env=nbytes, fp32_ops_per_env=nops, bytes_bound_ms=bytes_ms,
        ops_bound_ms=ops_ms, threads_per_block=megastep.KERNEL_THREADS,
        note="kernel timed over 20 back-to-back launches on one input set "
             "(inputs L2-resident); plain version is one eager call")

    # ---- small-input agreement: CUDA env (kernel) vs CPU env (plain) ----
    n_small = 64
    quiet = dataclasses.replace(
        mob_train_cfg(n_small),
        noise=dataclasses.replace(cfg.noise, add_noise=False))
    env_c = LeggedRobotEnv(quiet, device="cpu")
    env_g = LeggedRobotEnv(quiet, device=DEV)
    s_c, _ = env_c.reset(make_generator(SEED + 1, "cpu"))

    def to_dev(x):
        if isinstance(x, torch.Tensor):
            return x.to(DEV)
        if isinstance(x, torch.Generator):
            return make_generator(SEED + 1, DEV)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[to_dev(v) for v in x])
        return x

    s_g = to_dev(s_c)
    cpu_gen = make_generator(SEED + 2, "cpu")
    small_err = 0.0
    for _ in range(3):
        a = 0.5 * torch.randn((n_small, 12), generator=cpu_gen)
        s_c, o_c, r_c, d_c, _ = env_c.step(s_c, a)
        s_g, o_g, r_g, d_g, _ = env_g.step(s_g, a.to(DEV))
        small_err = max(small_err,
                        float((o_g["obs"].cpu() - o_c["obs"]).abs().max()),
                        float((r_g.cpu() - r_c).abs().max()))
        if not torch.equal(d_g.cpu(), d_c):
            raise SystemExit("small-input check: done masks differ")
    small_ok = small_err <= 1e-3
    say(phase="small_input_agreement", n_envs=n_small, steps=3,
        what="obs and reward, env on the card (kernel) vs env on the CPU "
             "(plain version), same state and actions", max_abs_err=small_err,
        atol=1e-3, ok=small_ok)
    if not small_ok:
        raise SystemExit("small-input check: card and CPU env disagree")

    # ---- main path: the rollout ------------------------------------------
    steps = ROLLOUT_STEPS
    state, obs = env.reset(gen)
    torch.cuda.synchronize()
    megastep.launches = 0
    t0 = time.time()
    state, obs, ro = rollout(env, policy, steps, gen, state=state, obs=obs)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = megastep.launches

    finite = all(bool(torch.isfinite(v).all()) for v in
                 list(obs.values()) + [ro.rewards, ro.actions, ro.values,
                                       ro.log_probs, state.phys.q,
                                       state.phys.base_pos,
                                       state.phys.base_quat,
                                       state.contact_lam_t])
    n_resets = int(ro.num_resets.sum())
    # a reset env starts its episode anew: its length restarts from 0
    reinit = int((state.episode_length < steps + 1).sum())
    mean_h = float(state.phys.base_pos[:, 2].mean())
    shapes_ok = (tuple(obs["obs"].shape) == (N, 70)
                 and tuple(obs["obs_history"].shape) == (N, 2100)
                 and tuple(obs["privileged_obs"].shape) == (N, 2)
                 and tuple(ro.actions.shape) == (steps, N, 12))
    main_ok = (finite and shapes_ok and launches == steps and n_resets > 0
               and reinit > 0 and 0.10 < mean_h < 0.45)
    say(phase="main_path", config="mob_train_cfg", n_envs=N, steps=steps,
        seconds=seconds, env_steps_per_s=N * steps / seconds, gpu=smi,
        kernel_launches=launches, finite=finite, shapes_ok=shapes_ok,
        envs_reset=n_resets, envs_reinitialised=reinit,
        mean_base_height=mean_h, mean_reward=float(ro.rewards.mean()),
        ok=main_ok)
    if not main_ok:
        raise SystemExit("main-path phase failed")

    say(phase="total", seconds=time.time() - t_start)
    print(smi, flush=True)
    say(kernels=[dict(
        name="control_step (K4: whole control step, flat ground, actuator "
             "net, warm start)",
        route="cuda",
        source="walk_these_ways_tpu_torch/csrc/megastep.cu",
        replaces=JAX_PACKAGE + "/ops/pallas_megastep.py:154",
        launches=launches, max_abs_err=worst, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None)])
    say(ok=True, device=dict(platform="gpu",
                             kind=torch.cuda.get_device_name(0),
                             count=torch.cuda.device_count()))


if __name__ == "__main__":
    main()
