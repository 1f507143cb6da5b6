#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for sm_90a).

    python3 chip_smoke.py

Builds the port's five kernel sources from csrc/*.cu with nvcc (one nvcc
each, all started together; csrc/megastep_team.cu holds the control-step
kernel, one warp per env with the cache built in the launch: in reuse mode
K4, K4c with P control, K4b and K4b-P on a heightfield, in exact mode K5
and K5-P with P control, the cache rebuilt before every substep;
csrc/dynamics_substep.cu K3 and K3b on a heightfield, one warp per env;
csrc/entry_cache.cu the per-substep route's entry cache, flat and on a
heightfield; csrc/contact_cache.cu K1, a tile of 16 envs a block with the
operands staged in shared memory once; csrc/contact_substep.cu K2, one warp
per env), prints the resident warps per SM of each kernel, holds
each kernel against its plain PyTorch version on the card at the shapes
the paths below give it (4000 envs), then drives the port's paths through
the entry points a user calls and checks what comes out:

- the policy rollout of `mob_train_cfg(4000)` on the default route (one
  control-step kernel launch per step),
- the same rollout on the per-substep route (`sim.megastep=False`: one
  entry-cache and one contact-cache launch per control step, one
  dynamics-substep launch per physics substep, no eager cache build), and
  one control step of both routes held against each other,
- env-axis data parallelism (parallel/mesh.py, `multi_rank_phase`):
  `scripts/multihost_smoke.py` in a child, 2 ranks of 2000 envs of
  `mob_train_cfg(4000)` sharing the card over gloo, each launching K4 24
  times an iteration; their reset and step, gathered, against the same on
  one rank here, bit for bit; their first iteration against a 1-rank
  Runner's (the logged losses within 1e-3, the learning rates equal, the
  parameters' distance from the 1-rank ones at most 5 % of the 1-rank
  update's length) and an RMA iteration likewise, the ranks' checksums
  equal, and a fresh cluster resumed from the shared checkpoint
  bit-exactly; then `scripts.train --mesh --multihost --shared-ckpt` on an
  NCCL group of one and `--resume` from its directory
  (`train_script_mesh_phase`),
- the contact-substep kernel driven directly (no env branch reaches it),
- PPO training iterations (`learn/ppo.make_train_iteration`) on both routes,
- exact mode on the control-step route (`sim.reuse_matrices=False`: one K5
  launch per step, no eager cache build; with `small_train_cfg`'s P control
  one K5-P launch per step), and one control step of it held against the
  per-substep exact route, which rolls out too (an entry-cache, a
  contact-cache and a dynamics-substep launch per substep, no eager cache
  build),
- P control on the control-step route (`small_train_cfg(4000)`, K4c, no
  eager cache build),
- the training entry point: `learn/runner.Runner` (log, checkpoint, resume,
  export), then six commands as subprocesses started together:
  `python -m walk_these_ways_tpu_torch.scripts.train --exact`,
  `... --terrain rough` and `... --num-eval-envs 400 --eval-dr rand_large`,
  `scripts.play` and `scripts.evaluate` (on the policy the runner exported)
  and `scripts.test`; the bench's `main`,
- rough terrain (`rough_train_cfg(4000)`): the default route (one K4b launch
  per step), the P-control route (one K4b-P launch per step), the exact
  route (`decimation` K4b launches of one substep per step), the
  per-substep route (entry cache + K1 + 4 K3b per step) and the per-substep
  exact route (4 x {entry cache, K1, K3b} per step), the exact route held
  against the per-substep exact route, a PPO iteration and the bench on
  rough terrain,
- the dense route (`sim.use_pallas_contact=False`: stock torch ops, no hand
  kernel), reuse and exact mode: one control step from one shared state
  held against the per-substep route, the per-substep exact route, K5 and
  (rough) the per-substep exact rough route, each flat exact pair's envs
  beyond the tolerance required to be ones a 1 + 1e-7 branch probe names,
  24-step rollouts that launch no hand kernel, and a PPO iteration,
- the train/eval env split (`eval_split_phases`): 4000 train + 400 eval
  envs under the rand_large DR preset, each slice's DR draws in its own
  range, a 24-step rollout (one K4 launch a step for all 4400 envs), the
  eval slice's deterministic actions, a PPO iteration, the per-substep
  route against K4 from one split state, and the eval slice on rough
  terrain rows appended to the train field (K4b on a 3000 x 1500 field:
  against its plain version, against the per-substep route, a rollout);
  `scripts.train --num-eval-envs 400 --eval-dr rand_large` and
  `scripts.evaluate` run among the commands,
- RMA teacher-student training (`rma_train_phase`): `Runner(algo="rma")`
  on `mob_train_cfg(4000)` at the reference's widths, 2 iterations of 24
  K4 launches each (seconds, rollout and update), a video of env 0 after
  the second (`log_video`: the FK skeleton on the card against the CPU's,
  drawn when matplotlib and imageio import), the export played back, a
  resumed Runner against the uninterrupted one, and the update's two
  steps in their order (`rma_adaptation_target`); one RMA iteration on
  4000 + 400 envs (`rma_eval_split`, the eval slice on `student_mean`,
  then `teacher_mean`); among the commands `scripts.train --algo rma`,
  `scripts.profile_train --rollout-only` (flat, exact, rough) in one
  process, and `scripts.play --video`, `scripts.actuator_net_train` +
  `actuator_net_eval` and `scripts.validate_adaptation_cross_engine` in
  another, each reporting its launches,
- the deploy stack (`deploy_phase`, `deploy_loopback`): the runner's (cse)
  and the RMA trainer's (rma) exports read by the port's numpy deploy
  loader against `actor_mean` / `student_mean` on the card; among the
  commands, the port's UDP bridge built on the host and run with `--sim`,
  and `deploy_policy.load_and_run_policy` on the cse export for 100 steps
  against it (leg data back, the policy's PD targets inside the joint
  limits),
- the MuJoCo cross-check's engine halves (`mujoco_engine_phase`,
  `scripts/mujoco_parity.py --engine-only`: the seven experiments on the
  dense route at N = 1) on the card, in a child process started after the
  last kernel timings, against the same halves on the CPU in a child
  started first: the analytic gates on the card, the first 10 rows elementwise,
  the full horizons reported; the state mapping to MuJoCo's conventions;
  where mujoco imports, the script's whole `main()` on the card,
- one PPO iteration under `utils/profiling.trace` (the longest device ops
  and the device-busy share).

Prints one JSON line per phase; needs one CUDA device and no network; exits
non-zero if any phase fails or no CUDA device is present.

The last line of the output is
    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": n}}
"""
import atexit
import ctypes
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py needs a CUDA device: "
                     "torch.cuda.is_available() is False\n")
    sys.exit(2)

from walk_these_ways_tpu_torch import bench  # noqa: E402
from walk_these_ways_tpu_torch.envs.go1_env import (  # noqa: E402
    LeggedRobotEnv, make_generator)
from walk_these_ways_tpu_torch.go1_config import (  # noqa: E402
    mob_train_cfg, rough_train_cfg, small_train_cfg)
from walk_these_ways_tpu_torch.learn import ppo, ppo_rma  # noqa: E402
from walk_these_ways_tpu_torch.learn.eval_metrics import DR_SETTINGS  # noqa: E402
from walk_these_ways_tpu_torch.learn.rollout import rollout  # noqa: E402
from walk_these_ways_tpu_torch.learn.runner import Runner, RunnerArgs  # noqa: E402
from walk_these_ways_tpu_torch.models.actor_critic import ActorCritic  # noqa: E402
from walk_these_ways_tpu_torch.ops import (  # noqa: E402
    _build, contact, dynamics, entry_cache, megastep)
from walk_these_ways_tpu_torch.physics import engine, envminor  # noqa: E402
from walk_these_ways_tpu_torch.scripts import (  # noqa: E402
    multihost_smoke, play)
from walk_these_ways_tpu_torch.utils import (  # noqa: E402
    checkpoint as ckpt_mod, convert, profiling, render)

DEV = torch.device("cuda", 0)
OUT_NAMES = ("q", "qd", "pos", "quat", "lin", "ang", "pcp", "pcp_prev",
             "lam", "tau", "el", "ell", "vl", "vll")
# the entry-cache kernel's outputs: the EnvMinorCache fields, then on a
# heightfield the point heights plus radii and the normals
ENTRY_NAMES = envminor.EnvMinorCache._fields + ("rh_t", "n_t")
# Kernel vs plain version on the card: |a - b| <= ATOL + RTOL * |b|.
# Both are float32 and round every product on its own (the kernels are built
# without fused multiply-adds), but the kernels sum in their own order and
# take the card's sinf / cosf; over 4 substeps x (2 dynamics evaluations + 3 solver sweeps)
# — or 16 sweeps from a cold start — those roundings are amplified by M^-1
# (entries up to 1e2) into joint velocities that reach the 28 rad/s clip.
# PERF.md keeps the errors measured at 4000 envs: a few 1e-5 in reuse mode,
# a few 1e-4 in exact mode, whose closed-form M^-1 is rebuilt every substep.
ATOL, RTOL = 2e-4, 2e-4
TOLERANCE = ("|kernel - plain| <= atol + rtol |plain|; float32 both, "
             "another summation order in the kernel, amplified by M^-1 into "
             "joint velocities of up to 28 rad/s")
N_ENVS = 4000       # the full width of mob_train_cfg
N_EVAL = 400        # the eval slice appended to it by the eval_split phases
ROLLOUT_STEPS = 24  # control steps of each rollout (one PPO iteration's)
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s on CUDA cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# directory of the JAX package, which this script names and never imports
JAX_PACKAGE = "walk_these_ways_" + "tpu"
CSRC = "walk_these_ways_tpu_torch/csrc/"
SCRIPTS = "walk_these_ways_tpu_torch.scripts."
DEPLOY_PORT = 7821   # the deploy loopback's bus port (the robot's is 7667)
# the deploy loader (numpy on the host) against the actors on the card:
# float32 products in other orders (measured 1.5e-7 on an H100)
DEPLOY_ATOL = 1e-6
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(_build.build_dir(), "smoke")


T0 = time.time()


def say(**kw):
    """One JSON line; `t` is the script's elapsed time in seconds."""
    print(json.dumps(dict(kw, t=time.time() - T0)), flush=True)


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


def time_host(fn, reps=2):
    """Least host-clock time of `fn` ending in a synchronise, in ms."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.time() - t0) * 1e3)
    return best


def reset_counts():
    megastep.launches = 0
    megastep.p_launches = 0
    megastep.normal_launches = 0
    megastep.p_normal_launches = 0
    megastep.exact_launches = 0
    megastep.p_exact_launches = 0
    contact.cache_launches = 0
    contact.substep_launches = 0
    dynamics.launches = 0
    dynamics.normal_launches = 0
    entry_cache.launches = 0
    entry_cache.normal_launches = 0
    envminor.cache_builds = 0


def counts():
    return dict(control_step=megastep.launches,
                control_step_p=megastep.p_launches,
                control_step_normals=megastep.normal_launches,
                control_step_normals_p=megastep.p_normal_launches,
                control_step_exact=megastep.exact_launches,
                control_step_exact_p=megastep.p_exact_launches,
                contact_cache=contact.cache_launches,
                contact_substep=contact.substep_launches,
                dynamics_substep=dynamics.launches,
                dynamics_substep_normals=dynamics.normal_launches,
                entry_cache=entry_cache.launches,
                entry_cache_normals=entry_cache.normal_launches,
                eager_cache_builds=envminor.cache_builds)


def expect(**given):
    """Expected counts: the ones named, every other 0."""
    out = dict.fromkeys(counts(), 0)
    out.update(given)
    return out


def bound(nbytes, nops, n):
    b_ms = nbytes * n / PEAK_BYTES_S * 1e3
    o_ms = nops * n / PEAK_FP32_S * 1e3
    return dict(bytes_per_env=nbytes, fp32_ops_per_env=nops,
                bytes_bound_ms=b_ms, ops_bound_ms=o_ms,
                bound_ms=max(b_ms, o_ms),
                bound_by="operations" if o_ms >= b_ms else "bytes")


def kernel_call_of(env, state, eager_cache=False):
    """(args, kwargs) of the control-step call that `env.step` makes from
    `state`; with `eager_cache` the entry cache (and on a heightfield the
    normals) built on the host, as the plain version of the team kernel's
    variants (K4, K4b, K4c, K4b-P) is fed here: the kernel builds it inside
    its launch."""
    _, dyn, _, _, tgt_eff, ctrl, lam_in = env.control_step_inputs(state)
    return engine.megakernel_args(
        env.model, env.sim_params, state.phys, dyn, env.terrain, tgt_eff,
        state.motor_strengths, env.torque_limits, ctrl,
        env.cfg.control.decimation, lam_in, exact=not env.reuse_matrices,
        eager_cache=eager_cache)


def compare(kernel, state_name, names, out_k, out_r, n_valid):
    """Kernel outputs vs plain-version outputs, on the card.  The valid
    lanes must agree within the tolerance; every lane, padded ones included,
    must be finite.  `out_k` / `out_r` may be callables: a CUDA error while
    they run is this kernel's failure."""
    try:
        if callable(out_k):
            out_k = out_k()
        torch.cuda.synchronize()
        if callable(out_r):
            out_r = out_r()
        torch.cuda.synchronize()
    except RuntimeError as e:
        say(phase="kernel_vs_plain", kernel=kernel, state=state_name,
            ok=False, max_abs_err=None, error=str(e)[:300])
        raise SystemExit(f"{kernel} '{state_name}': CUDA error: {e}")
    errs, worst_abs, ok = {}, 0.0, True
    for nm, a, b in zip(names, out_k, out_r):
        if not (bool(torch.isfinite(a).all())
                and bool(torch.isfinite(b[..., :n_valid]).all())):
            say(phase="kernel_vs_plain", kernel=kernel, state=state_name,
                ok=False, max_abs_err=None,
                error=f"non-finite values in {nm} (kernel: padded lanes "
                      "included)")
            raise SystemExit(f"{kernel} '{state_name}': non-finite values "
                             f"in {nm}")
        a, b = a[..., :n_valid], b[..., :n_valid]
        d = (a - b).abs()
        max_abs = float(d.max())
        bad = int((d > ATOL + RTOL * b.abs()).sum())
        errs[nm] = dict(max_abs=max_abs,
                        max_rel=float((d / (b.abs() + ATOL / RTOL)).max()),
                        beyond_tol=bad, ref_max=float(b.abs().max()))
        worst_abs = max(worst_abs, max_abs)
        ok = ok and bad == 0
    say(phase="kernel_vs_plain", kernel=kernel, state=state_name,
        n_envs=n_valid, atol=ATOL, rtol=RTOL, ok=ok, max_abs_err=worst_abs,
        tolerance=TOLERANCE, outputs=errs)
    if not ok:
        raise SystemExit(f"{kernel} '{state_name}': kernel disagrees with "
                         "its plain version")
    return worst_abs


def substep_inputs(env, state):
    """What the per-substep route hands its kernels at the first substep of
    a control step from `state`: the env-minor cache, the anchor-point
    velocity and the torques (env-minor, block 256)."""
    m, p = env.model, env.sim_params
    block = engine.SUBSTEP_BLOCK
    dyn = env.dynamics_params(state)[1]
    em, rh_t, mu_t, e_t, g_t, n_t = engine.build_pallas_env_inputs(
        m, state.phys, dyn, env.terrain, block)
    anc_p = torch.tensor(
        np.asarray(m.anc_dof_body)[:, np.asarray(m.cp_body)].T,
        dtype=torch.float32, device=DEV).contiguous()
    tau, _, _, _ = env._compute_torques(state)
    tau_t = contact.to_env_minor(
        torch.cat([torch.zeros((env.num_envs, 6), device=DEV), tau], dim=-1),
        block)
    gv_t = contact.to_env_minor(torch.cat(
        [state.phys.base_ang_vel, state.phys.base_lin_vel, state.phys.qd],
        dim=-1), block)
    vlim = engine._velocity_bounds(m, p, torch.float32, DEV)
    solver = dict(num_iters=p.num_contact_iters, relaxation=p.relaxation,
                  dt=p.dt, baumgarte=p.contact_baumgarte, slop=p.contact_slop,
                  max_depen=p.max_depenetration_velocity,
                  bounce_thresh=p.bounce_threshold_velocity)
    topo = dict(anc=m.anc_dof_body, joint_body=m.joint_body,
                cp_body=m.cp_body)
    return dict(em=em, anc_p=anc_p, rh_t=rh_t, mu_t=mu_t, e_t=e_t, g_t=g_t,
                n_t=n_t, tau_t=tau_t, gv_t=gv_t, vlim=vlim, solver=solver,
                topo=topo)


def substep_kernel_calls(x):
    """The three kernels' argument lists from `substep_inputs` (on a
    heightfield K3's end in the normals: K3b).  K2 is fed the free velocity
    of the plain dynamics, so that its result can be held against K3's as
    well."""
    em = x["em"]
    k1 = (x["anc_p"], em.Sw_t, em.Sv_t, em.Minv_t, em.r_t)
    J_t, W_t = contact.build_contact_cache(*k1)
    k3 = (em.Sw_t, em.Sv_t, em.A_t, em.B_t, em.m_t, em.Minv_t, x["g_t"],
          x["tau_t"], x["gv_t"], J_t, W_t, em.p_cp_t, x["rh_t"], x["mu_t"],
          x["e_t"], x["vlim"], x["n_t"])
    k3_kw = dict(x["topo"], **x["solver"])
    gv_free = dynamics.dynamics_substep_reference(
        *k3, **dict(k3_kw, contact=False))[0].contiguous()
    k2 = (J_t, W_t, em.Minv_t, em.p_cp_t, gv_free, x["rh_t"], x["mu_t"],
          x["e_t"], x["vlim"])
    return k1, k2, k3, k3_kw


def entry_cache_calls(env, state):
    """The entry-cache kernel's call and its plain version's (the eager
    build) for the per-substep route from `state`, each returning its
    outputs in ENTRY_NAMES order (rh_t and n_t on a heightfield only)."""
    m, block = env.model, engine.SUBSTEP_BLOCK
    dyn = env.dynamics_params(state)[1]

    def kernel():
        em, rh_t, n_t = entry_cache.entry_cache(m, state.phys, dyn,
                                                env.terrain, block)
        return tuple(em) + (() if n_t is None else (rh_t, n_t))

    def plain():
        em, rh_t, _, _, _, n_t = engine.build_pallas_env_inputs(
            m, state.phys, dyn, env.terrain, block)
        return tuple(em) + (() if n_t is None else (rh_t, n_t))

    return kernel, plain


def compare_entry_cache(key, env, state, state_name, worst):
    """The per-substep route's entry-cache kernel against the eager build
    on every lane, the padded ones (zeros, normals +z) included."""
    kernel, plain = entry_cache_calls(env, state)
    npad = -(-env.num_envs // engine.SUBSTEP_BLOCK) * engine.SUBSTEP_BLOCK
    worst[key] = max(worst.get(key, 0.0), compare(
        key, state_name, ENTRY_NAMES, kernel, plain, npad))


def compare_substep_kernels(env, state, state_name, worst):
    n = env.num_envs
    compare_entry_cache("entry_cache", env, state, state_name, worst)
    x = substep_inputs(env, state)
    k1, k2, k3, k3_kw = substep_kernel_calls(x)
    worst["contact_cache"] = max(worst.get("contact_cache", 0.0), compare(
        "contact_cache", state_name, ("J", "W"),
        contact.build_contact_cache(*k1),
        contact.cache_core(*k1, eps=1e-6), n))
    out3 = dynamics.dynamics_substep(*k3, **k3_kw)
    worst["dynamics_substep"] = max(
        worst.get("dynamics_substep", 0.0), compare(
            "dynamics_substep", state_name, ("gv", "pcp", "lam"), out3,
            dynamics.dynamics_substep_reference(*k3, **k3_kw), n))
    out2 = contact.contact_substep(*k2, **x["solver"])
    worst["contact_substep"] = max(
        worst.get("contact_substep", 0.0), compare(
            "contact_substep", state_name, ("gv", "pcp", "lam"), out2,
            contact.contact_core(*k2, **x["solver"]), n))
    # K2 on the plain free velocity against K3 (its own dynamics in-kernel)
    compare("contact_substep_vs_dynamics_substep", state_name,
            ("gv", "pcp", "lam"), out2, out3, n)
    return (k1, k2, k3, k3_kw, x)


def megastep_launch(model, args, kw):
    """The control-step kernel's launch on operands packed once: one ctypes
    call, without the wrapper's checks and allocations."""
    ptrs, outs, floats, ints, (H, F) = megastep.kernel_operands(*args, **kw)
    lib = megastep.build_library(model, H, F)
    stream = torch.cuda.current_stream(DEV).cuda_stream
    return lambda: _build.launch(lib, "megastep_team", ptrs, outs, floats,
                                 ints, stream)


def contact_cache_launch(k1):
    """K1's launch on operands packed once."""
    ptrs, outs, floats, ints = contact.cache_operands(*k1)
    lib = contact.cache_library(k1[1].shape[0], k1[4].shape[0])
    stream = torch.cuda.current_stream(DEV).cuda_stream
    return lambda: _build.launch(lib, "contact_cache", ptrs, outs, floats,
                                 ints, stream)


def contact_substep_launch(k2, solver):
    """K2's launch on operands packed once."""
    ptrs, outs, floats, ints = contact.substep_operands(*k2, **solver)
    lib = contact.substep_library(k2[4].shape[0], k2[3].shape[0])
    stream = torch.cuda.current_stream(DEV).cuda_stream
    return lambda: _build.launch(lib, "contact_substep", ptrs, outs, floats,
                                 ints, stream)


def entry_cache_launch(env, state):
    """The entry-cache kernel's launch on operands packed once."""
    m = env.model
    ptrs, outs, floats, ints, keep = entry_cache.kernel_operands(
        m, state.phys, env.dynamics_params(state)[1], env.terrain,
        engine.SUBSTEP_BLOCK)
    lib = entry_cache.build_library(m)
    stream = torch.cuda.current_stream(DEV).cuda_stream

    def launch():
        _build.launch(lib, "entry_cache", ptrs, outs, floats, ints, stream)
        return keep         # the packed inputs live as long as the launch

    return launch


def dynamics_launch(args, kw):
    """The dynamics-substep kernel's launch on operands packed once."""
    ptrs, outs, floats, ints = dynamics.kernel_operands(
        *args, **{k: v for k, v in kw.items() if k != "joint_body"})
    lib = dynamics.build_library(kw["anc"], kw["joint_body"], kw["cp_body"])
    stream = torch.cuda.current_stream(DEV).cuda_stream
    return lambda: _build.launch(lib, "dynamics_substep", ptrs, outs, floats,
                                 ints, stream)


def timing(kernel, fn_kernel, fn_plain, work, n, launch=None, **extra):
    """The kernel's time over 20 back-to-back launches (CUDA events):
    `launch` (operands packed once, so that the device and not the
    wrapper's Python paces the launches) where given, else the wrapper
    `fn_kernel`; the wrapper's own time beside it; the plain version's."""
    wrapper_ms = time_cuda(fn_kernel, 20)
    ms = wrapper_ms if launch is None else time_cuda(launch, 20)
    plain_ms = time_host(fn_plain)
    b = bound(*work, n)
    say(phase="kernel_timing", kernel=kernel, n_envs=n, kernel_ms=ms,
        wrapper_ms=wrapper_ms, plain_ms=plain_ms, **b, **extra,
        note="kernel timed over 20 back-to-back launches on one input set "
             "(inputs L2-resident): "
             + ("launches of operands packed once" if launch is not None
                else "wrapper calls, which may pace them")
             + "; plain version is one eager call, the less of two")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"])


def check_rollout(name, env, state, obs, ro, steps, seconds, expect_counts,
                  smi, config="mob_train_cfg", need_resets=True, got=None,
                  **extra):
    """The rollout's outputs, its launch counts (`got`, read here unless
    given) against `expect_counts`, and its rate; `extra` goes into the
    phase's line."""
    N = env.num_envs
    got = counts() if got is None else got
    finite = all(bool(torch.isfinite(v).all()) for v in
                 list(obs.values()) + [ro.rewards, ro.actions, ro.values,
                                       ro.log_probs, ro.base_height,
                                       state.phys.q, state.phys.base_pos,
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
    ok = (finite and shapes_ok and got == expect_counts
          and (not need_resets or (n_resets > 0 and reinit > 0))
          and 0.10 < mean_h < 0.45)
    say(phase=name, config=config, n_envs=N, steps=steps,
        seconds=seconds, env_steps_per_s=N * steps / seconds, gpu=smi,
        kernel_launches=got, expected_launches=expect_counts, finite=finite,
        shapes_ok=shapes_ok, envs_reset=n_resets, envs_reinitialised=reinit,
        mean_base_height=mean_h, mean_reward=float(ro.rewards.mean()),
        **extra, ok=ok)
    if not ok:
        raise SystemExit(f"{name} phase failed")
    return got


def seconds_of(f):
    """(host-clock seconds of `f()` ending in a synchronise, its result)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = f()
    torch.cuda.synchronize()
    return time.time() - t0, out


def train_phase(route, env, gen, iterations, expect_per_iter):
    """PPO iterations through `make_train_iteration`, then one more
    iteration put together here from its three parts (`collect`,
    `compute_gae`, `update`) to read the rollout / update split."""
    args = ppo.PPO_Args()
    ts = ppo.init_train_state(gen, env, args)
    fn = ppo.make_train_iteration(env, args, num_steps=ROLLOUT_STEPS)
    state, obs = env.reset(gen)
    before = [p.detach().clone() for p in ts.policy.parameters()]
    for it in range(iterations):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        state, obs, ts, m = fn(state, obs, ts)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        got = counts()
        losses = dict(value_loss=float(m.value_loss),
                      surrogate_loss=float(m.surrogate_loss),
                      adaptation_loss=float(m.adaptation_loss),
                      adaptation_test_loss=float(m.adaptation_test_loss),
                      mean_kl=float(m.mean_kl),
                      mean_reward=float(m.mean_reward))
        params_finite = all(bool(torch.isfinite(p).all())
                            for p in ts.policy.parameters())
        moved = max(float((p.detach() - b).abs().max())
                    for p, b in zip(ts.policy.parameters(), before))
        ok = (all(np.isfinite(v) for v in losses.values())
              and params_finite and moved > 0
              # the learning rate is a float32, as are its clamps
              and np.float32(1e-5) <= np.float32(m.lr) <= np.float32(1e-2)
              and got == expect_per_iter and ts.iteration == it + 1
              and bool(torch.isfinite(state.phys.base_pos).all()))
        say(phase="train_iteration", route=route, iteration=it,
            n_envs=env.num_envs, num_steps=ROLLOUT_STEPS, seconds=seconds,
            env_steps_per_s=env.num_envs * ROLLOUT_STEPS / seconds,
            lr=m.lr, **losses, params_finite=params_finite,
            largest_parameter_change=moved, kernel_launches=got,
            expected_launches=expect_per_iter,
            envelope_exits=float(m.envelope_exits), ok=ok)
        if not ok:
            raise SystemExit(f"train_iteration ({route}) failed")
    t_roll, (state, obs, traj, _) = seconds_of(lambda: ppo.collect(
        env, state, obs, ts.policy, ts.rng, ROLLOUT_STEPS, args.gamma))

    def gae():
        with torch.no_grad():
            last = ts.policy.evaluate(obs["obs_history"],
                                      obs["privileged_obs"])
            return ppo.flatten_rollout(traj, *ppo.compute_gae(
                traj, last, args.gamma, args.lam))

    t_gae, data = seconds_of(gae)
    perm = torch.randperm(data[0].shape[0], generator=ts.rng, device=DEV)
    t_upd, (lr, ms) = seconds_of(lambda: ppo.update(
        ts.policy, (ts.optimizer, ts.adapt_optimizer), ts.lr, data, perm,
        args))
    ok = bool(torch.isfinite(ms.value_loss).all()
              & torch.isfinite(ms.surrogate_loss).all())
    say(phase="train_iteration_split", route=route, iteration=iterations,
        what="one more iteration, put together from collect, compute_gae "
             "and update as train_iteration does",
        rollout_seconds=t_roll, gae_seconds=t_gae, update_seconds=t_upd,
        seconds=t_roll + t_gae + t_upd, lr=lr, ok=ok)
    if not ok:
        raise SystemExit(f"train_iteration_split ({route}) failed")


def runner_phase(env_p):
    """`Runner` on small_train_cfg: 2 iterations logged each, the
    checkpoint it saves at the end, a new Runner resumed from it for one
    more, and the exported policy.  Returns the resumed Runner (its export
    is the deploy phases' cse policy) and its K4c launches."""
    d = os.path.join(OUT_DIR, "runner")
    shutil.rmtree(d, ignore_errors=True)
    reset_counts()
    t0 = time.time()
    r = Runner(env_p, log_dir=d, seed=SEED, args=RunnerArgs(log_freq=1))
    r.learn(2)
    ck = os.path.join(d, "checkpoints", "train_state_last.pkl")
    r2 = Runner(env_p, log_dir=d, seed=SEED, args=RunnerArgs(
        log_freq=1, resume=True, resume_path=ck))
    resumed_at = r2.train_state.iteration
    same = all(torch.equal(p, q) for p, q in zip(
        r.train_state.policy.parameters(), r2.train_state.policy.parameters()))
    r2.learn(1)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    rows = [json.loads(ln) for ln in open(os.path.join(d, "metrics.jsonl"))]
    pol = np.load(os.path.join(d, "checkpoints", "policy_latest.npz"))
    files = [f for f in ("metrics.jsonl", ".charts.yml", "provenance.json",
                         "checkpoints/train_state_last.pkl",
                         "checkpoints/policy_latest.npz")
             if os.path.exists(os.path.join(d, f))]
    got = counts()
    ok = (resumed_at == 2 and r2.train_state.iteration == 3 and same
          and [row["iterations"] for row in rows] == [1, 2, 3]
          and all(np.isfinite(v) for row in rows for v in row.values())
          and len(files) == 5 and str(pol["meta/variant"]) == "cse"
          and got["control_step_p"] > 0 and got["control_step"] == 0)
    say(phase="runner", config="small_train_cfg", n_envs=env_p.num_envs,
        what="Runner.learn(2) with log_freq=1, a new Runner resumed from "
             "checkpoints/train_state_last.pkl, learn(1), export",
        seconds=seconds, resumed_at_iteration=resumed_at,
        resumed_weights_equal=same, iterations=r2.train_state.iteration,
        log_rows=len(rows), artifacts=files, kernel_launches=got,
        last_row={k: rows[-1].get(k) for k in (
            "mean_reward_per_step", "mean_value_loss", "lr", "time_iter",
            "train/episode/rew_tracking_lin_vel/mean")}, ok=ok)
    if not ok:
        raise SystemExit("runner phase failed")
    return r2, got["control_step_p"]


def command_phases(rma_pol, smi):
    """The port's commands as a user runs them, subprocesses started
    together: the train script with --exact (2 iterations), with --terrain
    rough (1 iteration) and with 400 eval envs under the rand_large DR
    preset (2 iterations), `scripts.play` and `scripts.evaluate` (presets
    rand_regular and static_medium at 4000 envs, 30 steps) on the policy
    the runner phase exported, and `scripts.test`.  One phase line for each
    train script, one for play and test, one for evaluate with its rows.
    Then the commands of the RMA and tool scripts, in three processes
    that each run their commands one after another through `CHILD` (each
    command's kernel launches and checked videos reported): `train --algo
    rma` (1 iteration: `rma_train_phase` runs the trainer's iterations);
    `profile_train --rollout-only` (one 24-step rollout timed, one traced)
    flat, in exact mode and on rough terrain (the full iteration is what
    `trace_phase` traces); and `play --video` on the RMA export
    (`rma_pol`), `actuator_net_train` then `actuator_net_eval` on
    synthetic deploy logs, and `validate_adaptation_cross_engine` on the
    runner phase's export at 256 envs; and the deploy loopback
    (`DEPLOY_CHILD`) on that export.  Returns, for K4, K5 and K4b, the
    launches of each of these commands that steps the env on its route."""
    mod = SCRIPTS
    train = [sys.executable, "-m", mod + "train", "--num-envs", str(N_ENVS)]
    logs = {k: os.path.join(OUT_DIR, k)
            for k in ("exact", "rough", "eval", "rma_cmd", "tools")}
    for d in logs.values():
        shutil.rmtree(d, ignore_errors=True)
    pol = os.path.join(OUT_DIR, "runner", "checkpoints", "policy_latest.npz")
    shutil.rmtree(os.path.join(OUT_DIR, "deploy_logs"), ignore_errors=True)
    presets = ["rand_regular", "static_medium"]
    tools = logs["tools"]
    deploy_logs = os.path.join(tools, "deploy_logs")
    write_deploy_logs(deploy_logs)
    net = os.path.join(tools, "actuator_net.npz")

    rollout = ["--iters", "1", "--rollout-only"]
    children = dict(
        rma_cmd=child(("rma_cmd", "train", [
            "--num-envs", str(N_ENVS), "--iterations", "1", "--algo", "rma",
            "--log-dir", logs["rma_cmd"]])),
        profile=child(
            ("profile", "profile_train", rollout),
            ("profile_exact", "profile_train", rollout + ["--mode", "exact"]),
            ("profile_rough", "profile_train",
             rollout + ["--terrain", "rough"])),
        tools=child(
            ("play_video", "play", [
                "--policy", rma_pol, "--steps", "24", "--video",
                os.path.join(tools, "play.gif")]),
            ("actuator_net_train", "actuator_net_train", [
                "--log-dir", deploy_logs, "--out", net, "--epochs", "5"]),
            ("actuator_net_eval", "actuator_net_eval", [
                "--log-dir", deploy_logs, "--net", net, "--out",
                os.path.join(tools, "eval.json")]),
            ("validate", "validate_adaptation_cross_engine", [
                "--policy", pol, "--num-envs", "256", "--warmup-steps", "30",
                "--collect-steps", "60", "--out",
                os.path.join(tools, "adaptation.json")])))
    cmds = dict(
        exact=train + ["--iterations", "2", "--exact",
                       "--log-dir", logs["exact"]],
        rough=train + ["--iterations", "1", "--terrain", "rough",
                       "--log-dir", logs["rough"]],
        eval=train + ["--iterations", "2", "--num-eval-envs", str(N_EVAL),
                      "--eval-dr", "rand_large", "--log-dir", logs["eval"]],
        play=[sys.executable, "-m", mod + "play", "--policy", pol,
              "--steps", "24"],
        evaluate=[sys.executable, "-m", mod + "evaluate", "--policy", pol,
                  "--settings", *presets, "--num-envs", str(N_ENVS),
                  "--steps", "30"],
        test=[sys.executable, "-m", mod + "test", "--num-envs", "3",
              "--steps", "50"],
        deploy_loopback=[sys.executable, "-c", DEPLOY_CHILD, json.dumps(
            [pol, os.path.join(OUT_DIR, "deploy_logs")])], **children)
    t0 = time.time()
    procs = {k: start(c) for k, c in cmds.items()}
    res = {}
    for k, p in procs.items():
        out, err = finish(p)
        collected = time.time() - t0
        if k not in children:
            res[k] = dict(command=" ".join(cmds[k][1:]),
                          seconds_to_collected=collected,
                          returncode=p.returncode,
                          stdout_tail=out.strip().splitlines()[-3:],
                          stderr_tail=err.strip().splitlines()[-3:])
            continue
        for job, rec in child_records(cmds[k], out, err, p.returncode).items():
            res[job] = dict(rec, process=k, seconds_to_collected=collected)
    ok_all = True
    for k in ("exact", "rough", "eval"):
        files = [f for f in ("provenance.json",
                             "checkpoints/train_state_last.pkl",
                             "checkpoints/policy_latest.npz")
                 if os.path.exists(os.path.join(logs[k], f))]
        ok = res[k]["returncode"] == 0 and len(files) == 3
        if k == "eval" and ok:
            prov = json.load(open(os.path.join(logs[k], "provenance.json")))
            ok = prov["num_envs"] == N_ENVS + N_EVAL
        say(phase="train_script_" + k, **res[k], artifacts=files, ok=ok)
        ok_all = ok_all and ok
    rows = [ln.split() for ln in res["evaluate"]["stdout_tail"]]
    ok = (res["evaluate"]["returncode"] == 0
          and [r[0] for r in rows if r] == presets
          and all(np.isfinite(float(f.split("=")[1])) for r in rows
                  for f in r[1:] if "=" in f))
    say(phase="scripts_evaluate", **res["evaluate"], ok=ok)
    ok_all = ok_all and ok
    ok = (res["play"]["returncode"] == 0
          and any("mean body-frame vx" in ln
                  for ln in res["play"]["stdout_tail"])
          and res["test"]["returncode"] == 0
          and res["test"]["stdout_tail"][-1:] == ["OK"])
    say(phase="scripts", play=res["play"], test=res["test"], ok=ok)
    ok_all = ok_all and ok
    ok_all = check_deploy_loopback(res["deploy_loopback"]) and ok_all

    def launched(k, **given):
        return res[k].get("kernel_launches") == expect(**given)

    # each child's own reset steps the env once before its loops
    files = [f for f in ("provenance.json", "checkpoints/train_state_last.pkl",
                         "checkpoints/policy_latest.npz")
             if os.path.exists(os.path.join(logs["rma_cmd"], f))]
    variant = (str(np.load(os.path.join(logs["rma_cmd"], files[-1]))[
        "meta/variant"]) if len(files) == 3 else None)
    want = 1 + ROLLOUT_STEPS
    ok = (res["rma_cmd"]["returncode"] == 0 and len(files) == 3
          and variant == "rma" and launched("rma_cmd", control_step=want))
    say(phase="train_script_rma", **res["rma_cmd"], artifacts=files,
        export_variant=variant, expected_launches=expect(control_step=want),
        ok=ok)
    ok_all = ok_all and ok
    videos = res["play_video"].get("videos", [])
    ok = (res["play_video"]["returncode"] == 0 and len(videos) == 1
          and videos[0]["ok"] and videos[0]["frames"] == 24
          and launched("play_video", control_step=25))
    say(phase="scripts_play_video", **res["play_video"],
        expected_launches=expect(control_step=25), ok=ok)
    ok_all = ok_all and ok
    # one warm-up, one timed and one traced rollout
    for k, given in (("profile", dict(control_step=1 + 3 * ROLLOUT_STEPS)),
                     ("profile_exact",
                      dict(control_step_exact=1 + 3 * ROLLOUT_STEPS)),
                     ("profile_rough",
                      dict(control_step_normals=1 + 3 * ROLLOUT_STEPS))):
        row = res[k].get("last_json", {})
        ok = (res[k]["returncode"] == 0 and launched(k, **given)
              and row.get("env_steps_per_s", 0) > 0
              and len(row.get("top_device_ops", [])) > 0
              and 0.0 < row.get("device_busy_share", 0) <= 1.0)
        say(phase="scripts_" + k, **res[k], expected_launches=expect(**given),
            gpu=smi, ok=ok)
        ok_all = ok_all and ok
    ev = os.path.join(tools, "eval.json")
    ev = json.load(open(ev)) if os.path.exists(ev) else {}
    ok = (all(res[k]["returncode"] == 0 and launched(k) for k in (
        "actuator_net_train", "actuator_net_eval")) and os.path.exists(net)
          and ev.get("samples") == 2 * 198 * 12
          and all(np.isfinite(ev.get(k, np.nan))
                  for k in ("mse", "r2", "mse_pd_baseline")))
    say(phase="scripts_actuator_net", train=res["actuator_net_train"],
        evaluate=res["actuator_net_eval"],
        eval={k: ev.get(k) for k in ("samples", "mse", "r2",
                                      "mse_pd_baseline")}, ok=ok)
    ok_all = ok_all and ok
    va = os.path.join(tools, "adaptation.json")
    va = json.load(open(va)) if os.path.exists(va) else {}
    want = 1 + 30 + 60
    ok = (res["validate"]["returncode"] == 0 and va.get("samples") == 256 * 6
          and all(np.isfinite(va.get(k, np.nan)) for k in (
              "mse_reference_module", "mse_our_module",
              "mse_predict_mean_baseline"))
          and launched("validate", control_step=want))
    say(phase="scripts_validate_adaptation", **res["validate"],
        result={k: va.get(k) for k in (
            "samples", "mse_reference_module", "mse_our_module",
            "mse_predict_mean_baseline", "corr_reference_module",
            "corr_our_module", "device")},
        expected_launches=expect(control_step=want), ok=ok)
    ok_all = ok_all and ok
    if not ok_all:
        raise SystemExit("a command of the port failed")
    return {key: {k: res[k].get("kernel_launches", {}).get(key, 0)
                  for k in names}
            for key, names in (
                ("control_step", ("rma_cmd", "play_video", "profile",
                                  "validate")),
                ("control_step_exact", ("profile_exact",)),
                ("control_step_normals", ("profile_rough",)))}


# the 2-rank parameters after one iteration may stand from the 1-rank ones
# at most this share of the 1-rank update's length
MULTI_RANK_UPDATE_RATIO = 0.05


def multi_rank_phase(env, smi):
    """`scripts/multihost_smoke.py --device cuda --backend gloo
    --num-processes 2 --num-envs 4000 --iters 2 --shared-resume` in a
    child: 2 ranks of 2000 envs of mob_train_cfg(4000) sharing the card
    (gloo; NCCL refuses two ranks on one device), each stepping its rows
    through K4.  Then here, on one rank: the same reset and step (the
    gathered 2-rank states must be these, bit for bit), the same RMA
    iteration and the same Runner for 2 iterations (the first iteration's
    logged losses within 1e-3 and its learning rates equal; the parameters
    read against the 1-rank update's length: Adam's normalised step moves
    an entry whose gradient is rounding noise by up to the learning rate
    either way, so at 4000 envs tests/test_sharding.py's elementwise
    tolerances, which it reports, do not hold for every entry).  Returns
    {path: K4 launches}."""
    rec_dir = os.path.join(OUT_DIR, "multi_rank")
    shutil.rmtree(rec_dir, ignore_errors=True)
    iters = 2
    cmd = [sys.executable, "-m", SCRIPTS + "multihost_smoke", "--device",
           DEV.type, "--backend", "gloo", "--num-processes", "2",
           "--num-envs", str(N_ENVS), "--iters", str(iters),
           "--num-steps", str(ROLLOUT_STEPS), "--shared-resume",
           "--record", rec_dir]
    t0 = time.time()
    p = start(cmd)
    out, err = finish(p, timeout=900)
    child_s = time.time() - t0
    ok_child = p.returncode == 0 and "multihost_smoke: OK" in out
    if not ok_child:
        say(phase="multi_rank", command=" ".join(cmd[1:]),
            returncode=p.returncode, stdout_tail=out.splitlines()[-12:],
            stderr_tail=err.splitlines()[-12:], ok=False)
        raise SystemExit("multi_rank phase failed")
    a = [ckpt_mod.load(os.path.join(rec_dir, f"save_rank{r}.pkl"))
         for r in range(2)]
    b = [ckpt_mod.load(os.path.join(rec_dir, f"resume_rank{r}.pkl"))
         for r in range(2)]
    # the same work on one rank, here
    one = multihost_smoke.env_checks(env, ROLLOUT_STEPS)
    differ = {k: multihost_smoke.differing_leaves(
        a[0][k], one[k], N_ENVS, close=("bin_task_sums",))
              for k in ("reset", "step")}
    d = os.path.join(OUT_DIR, "multi_rank_one")
    shutil.rmtree(d, ignore_errors=True)
    big = 10 ** 9
    runner = Runner(env, log_dir=d, seed=multihost_smoke.SEED,
                    args=RunnerArgs(
                        num_steps_per_env=ROLLOUT_STEPS, log_freq=1,
                        save_interval=big, curriculum_dump_freq=big))
    before = multihost_smoke.params_numpy(runner.train_state)
    reset_counts()
    t1 = time.time()
    runner.learn(1)       # as each rank did: the first iteration alone
    first = multihost_smoke.params_numpy(runner.train_state)
    runner.learn(iters - 1)
    torch.cuda.synchronize()
    one_s = time.time() - t1
    one_launches = counts()["control_step"]
    rows_one = [json.loads(ln) for ln in open(os.path.join(d,
                                                           "metrics.jsonl"))]
    last = multihost_smoke.params_numpy(runner.train_state)
    # one iteration against one rank: the losses, KL and reward its 20
    # minibatches logged (the ranks' sums) and its learning rates, then the
    # parameters.  Adam's normalised step moves an entry whose gradient is
    # rounding noise by up to the learning rate either way, so the
    # parameters are read as the 2-rank result's distance from the 1-rank
    # one over the 1-rank update's length; tests/test_sharding.py's
    # elementwise tolerances (rtol 3e-3, atol 4e-4) are reported beside it
    m2, m1 = a[0]["metrics"][0], rows_one[0]
    loss_rel = {k: abs(m2[k] - m1[k]) / max(abs(m1[k]), 1e-12) for k in (
        "mean_value_loss", "mean_surrogate_loss", "adaptation_loss",
        "mean_adaptation_module_test_loss", "mean_kl",
        "mean_reward_per_step")}
    lr_equal = ([r["lr"] for r in a[0]["metrics"]]
                == [r["lr"] for r in rows_one])
    got1 = a[0]["params_first"]

    def norm(x):
        return float(np.sqrt(sum(float(np.sum(np.square(
            v.astype(np.float64)))) for v in x)))

    def over_update(got, want, start):
        """The distance of `got` from `want` over `want`'s update from
        `start`, all parameters."""
        return norm([got[k] - v for k, v in want.items()]) / norm(
            [v - start[k] for k, v in want.items()])

    update_ratio = {k: norm([got1[k] - v]) / max(norm([v - before[k]]),
                                                 1e-30)
                    for k, v in first.items()}
    ratio_all = over_update(got1, first, before)
    # the RMA learner's iteration from the stepped state (env_checks)
    rma = [r["rma"] for r in a]
    rma_ratio = over_update(rma[0]["params"], one["rma"]["params"],
                            one["rma"]["before"])
    rma_rel = {k: abs(rma[0]["metrics"][k] - v) / max(abs(v), 1e-12)
               for k, v in one["rma"]["metrics"].items()}
    beyond = sum(int((~np.isclose(got1[k], v, rtol=3e-3, atol=4e-4)).sum())
                 for k, v in first.items())
    entries = sum(v.size for v in first.values())
    worst = {k: float(np.abs(got1[k] - v).max()) for k, v in first.items()}
    worst_last = {k: float(np.abs(a[0]["params"][k] - v).max())
                  for k, v in last.items()}
    k4 = "megastep.launches"
    per_rank = [int(r["launches"][k4]) for r in a]
    others = [sum(int(v) for k, v in r["launches"].items() if k != k4)
              for r in a + b]
    resumed = [int(r["launches"][k4]) for r in b]
    want_a = 1 + iters * ROLLOUT_STEPS       # the reset's step, then 2 x 24
    checks = dict(
        k4_launches=(per_rank == [want_a, want_a] and not any(others)
                     and resumed == [ROLLOUT_STEPS] * 2
                     and one_launches == want_a),
        checksums_equal=a[0]["checksum"] == a[1]["checksum"],
        resume_bit_exact=(a[0]["continued_checksum"] == b[0]["checksum"]
                          == b[1]["checksum"]),
        generator_states_equal=(a[0]["generator_checksums"]
                                == a[1]["generator_checksums"]),
        shard_gather_round_trip=all(r["roundtrip_bit_exact"] for r in a),
        env_equals_one_rank=not any(differ.values()),
        logged_losses=max(loss_rel.values()) <= 1e-3,
        learning_rates_equal=lr_equal,
        params_distance_over_update=ratio_all <= MULTI_RANK_UPDATE_RATIO,
        rma_checksums_equal=rma[0]["checksum"] == rma[1]["checksum"],
        rma_params_distance_over_update=(
            rma_ratio <= MULTI_RANK_UPDATE_RATIO),
        rma_logged_losses=max(rma_rel.values()) <= 1e-3,
        backend_gloo="backend=gloo" in a[0]["mesh"])
    ok = ok_child and all(checks.values())
    say(phase="multi_rank", command=" ".join(cmd[1:]),
        failed_checks=[k for k, v in checks.items() if not v],
        readings=dict(params_distance_over_update=ratio_all,
                      rma_params_distance_over_update=rma_ratio,
                      logged_rel_diff_max=max(loss_rel.values()),
                      learning_rates_equal=lr_equal),
        config=f"mob_train_cfg({N_ENVS}) on 2 ranks of {N_ENVS // 2} envs, "
               "one card",
        mesh=[r["mesh"] for r in a], child_seconds=child_s,
        k4_launches_per_rank=per_rank,
        k4_launches_per_rank_per_iteration=[
            (n - 1) / iters for n in per_rank],
        k4_launches_resumed_per_rank=resumed,
        checksums=[r["checksum"] for r in a],
        continued_checksum=a[0]["continued_checksum"],
        resumed_checksums=[r["checksum"] for r in b],
        generator_states_equal=a[0]["generator_checksums"]
        == a[1]["generator_checksums"],
        shard_gather_round_trip_bit_exact=[r["roundtrip_bit_exact"]
                                           for r in a],
        leaves_differing_from_one_rank=differ,
        logged_rel_diff_vs_one_rank=loss_rel, logged_rtol=1e-3,
        learning_rates_equal=lr_equal,
        params_distance_over_update=ratio_all,
        params_distance_over_update_max=MULTI_RANK_UPDATE_RATIO,
        params_distance_over_update_by_leaf=update_ratio,
        rma_checksums=[r["checksum"] for r in rma],
        rma_params_distance_over_update=rma_ratio,
        rma_logged_rel_diff_vs_one_rank=rma_rel,
        params_after_one_iteration_max_abs_diff_vs_one_rank=max(
            worst.values()),
        params_beyond_test_sharding_tolerance=[beyond, entries],
        params_after_one_iteration_worst_leaves=sorted(
            worst.items(), key=lambda kv: -kv[1])[:4],
        params_after_two_iterations_max_abs_diff_vs_one_rank=max(
            worst_last.values()),
        params_after_two_iterations_worst_leaves=sorted(
            worst_last.items(), key=lambda kv: -kv[1])[:4],
        lr_two_ranks=[r["lr"] for r in a[0]["metrics"]],
        lr_one_rank=[r["lr"] for r in rows_one],
        mean_kl_two_ranks=[r["mean_kl"] for r in a[0]["metrics"]],
        mean_kl_one_rank=[r["mean_kl"] for r in rows_one],
        one_rank_k4_launches=one_launches,
        seconds_per_iteration_two_ranks=[r["time_iter"]
                                         for r in a[0]["metrics"]],
        seconds_per_iteration_one_rank=[r["time_iter"] for r in rows_one],
        learn_seconds_two_ranks=a[0]["learn_seconds"],
        learn_seconds_one_rank=one_s, gpu=smi, ok=ok)
    if not ok:
        raise SystemExit("multi_rank phase failed")
    return dict(multi_rank_rank0=per_rank[0], multi_rank_rank1=per_rank[1],
                multi_rank_resumed_rank0=resumed[0],
                multi_rank_resumed_rank1=resumed[1])


def train_script_mesh_phase(env, smi):
    """`scripts.train --mesh --multihost --shared-ckpt DIR --num-envs 4000
    --iterations 1` in a child whose launcher variables say one rank
    (WORLD_SIZE=1: an NCCL group of one, K4), then, in the same child,
    `--resume DIR` for one more iteration (the second `maybe_init_distributed`
    finds the group up).  Here: the committed directory holds the state of
    the run's last pickle, and a Runner resumed from it holds that state
    bit for bit.  Returns {path: K4 launches}."""
    logs = os.path.join(OUT_DIR, "train_mesh")
    shared = os.path.join(OUT_DIR, "train_mesh_shared")
    for x in (logs, shared):
        shutil.rmtree(x, ignore_errors=True)
    port = multihost_smoke.free_port()
    base = ["--mesh", "--multihost", "--num-envs", str(N_ENVS),
            "--iterations", "1"]
    cmd = child(("train_mesh", "train", base + [
                    "--shared-ckpt", shared, "--log-dir",
                    os.path.join(logs, "first")]),
                ("train_mesh_resume", "train", base + [
                    "--resume", shared, "--log-dir",
                    os.path.join(logs, "resumed")]))
    t0 = time.time()
    p = start(cmd, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
              LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
              MASTER_PORT=str(port))
    out, err = finish(p)
    res = child_records(cmd, out, err, p.returncode, keep_lines=True)
    seconds = time.time() - t0
    first, again = res["train_mesh"], res["train_mesh_resume"]
    mesh_lines = [ln for ln in first.get("lines", [])
                  if ln.startswith("mesh:")]
    pkl = os.path.join(logs, "first", "checkpoints", "train_state_last.pkl")
    differ = ["no checkpoint"]
    if os.path.exists(pkl) and os.path.exists(shared):
        saved = ckpt_mod.load(pkl)
        r = Runner(env, log_dir=os.path.join(logs, "check"), seed=SEED,
                   args=RunnerArgs(resume=True, resume_path=shared))
        differ = multihost_smoke.differing_leaves(r._state_tree(), saved,
                                                  N_ENVS)
    # the resumed command's last checkpoint: one iteration past the first's
    last = os.path.join(logs, "resumed", "checkpoints",
                        "train_state_last.pkl")
    resumed_at = (int(ckpt_mod.load(last)["train_state"]["iteration"])
                  if os.path.exists(last) else None)

    def launched(rec):
        return rec.get("kernel_launches") == expect(
            control_step=1 + ROLLOUT_STEPS)

    ok = (first["returncode"] == 0 and again["returncode"] == 0
          and len(mesh_lines) == 1 and "backend=nccl" in mesh_lines[0]
          and "world_size=1" in mesh_lines[0] and launched(first)
          and launched(again) and not differ and resumed_at == 2)
    say(phase="train_script_mesh", commands=[first["command"],
                                             again["command"]],
        mesh_line=mesh_lines, seconds=seconds,
        kernel_launches=[first.get("kernel_launches"),
                         again.get("kernel_launches")],
        expected_launches=expect(control_step=1 + ROLLOUT_STEPS),
        resumed_state_leaves_differing=differ,
        resumed_run_ends_at_iteration=resumed_at,
        stdout_tail=[first["stdout_tail"], again["stdout_tail"]],
        stderr_tail=[first["stderr_tail"], again["stderr_tail"]],
        gpu=smi, ok=bool(ok))
    if not ok:
        raise SystemExit("train_script_mesh phase failed")
    return dict(train_script_mesh=first["kernel_launches"]["control_step"],
                train_script_mesh_resume=again["kernel_launches"][
                    "control_step"])


def rough_kernel_checks(env_r, env_rp, env_rs, gen, worst):
    """K4b (actuator net), K4b with P control and K3b against their plain
    versions on rough_train_cfg states: after the reset and after 24 random
    steps on the default rough route.  Returns the last state and its
    three kernel calls."""
    N = env_r.num_envs
    state, _ = env_r.reset(gen)
    for st_name in ("after_reset", "24_random_steps_in"):
        if st_name != "after_reset":
            for _ in range(24):
                a = torch.randn((N, 12), generator=gen, device=DEV)
                state, *_ = env_r.step(state, a)
        calls = []
        for key, env_x, names in (
                ("control_step_normals", env_r, OUT_NAMES),
                ("control_step_normals_p", env_rp, OUT_NAMES[:10])):
            args, kw = kernel_call_of(env_x, state)
            p_args, p_kw = kernel_call_of(env_x, state, eager_cache=True)
            # the normals for the plain version, the terrain for the kernel
            # to sample in its launch
            assert p_args[5] is not None
            assert args[5] is None and kw["entry_inputs"][2] is not None
            worst[key] = max(worst.get(key, 0.0), compare(
                key, st_name, names,
                lambda: megastep.control_step(*args, **kw),
                lambda: megastep.control_step_reference(*p_args, **p_kw),
                N))
            calls.append((args, kw))
        compare_entry_cache("entry_cache_normals", env_rs, state, st_name,
                            worst)
        x = substep_inputs(env_rs, state)
        k3, k3_kw = substep_kernel_calls(x)[2:4]
        assert k3[16] is not None                       # the normals
        worst["dynamics_substep_normals"] = max(
            worst.get("dynamics_substep_normals", 0.0), compare(
                "dynamics_substep_normals", st_name, ("gv", "pcp", "lam"),
                lambda: dynamics.dynamics_substep(*k3, **k3_kw),
                lambda: dynamics.dynamics_substep_reference(*k3, **k3_kw),
                N))
        calls.append((k3, k3_kw))
    n_t = calls[2][0][16]                               # K3b's normals
    say(phase="rough_normals", state="24_random_steps_in",
        normal_z_min=float(n_t[:, 2, :N].min()),
        padded_lanes_plus_z=bool((n_t[:, 2, N:] == 1).all()))
    return state, calls


def rough_route(name, config, env_x, policy, steps, gen, expect_counts, smi):
    """A rollout on rough terrain."""
    state, obs = env_x.reset(gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state, obs, ro = rollout(env_x, policy, steps, gen, state=state, obs=obs)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    return check_rollout(
        name, env_x, state, obs, ro, steps, seconds, expect_counts, smi,
        config=config, need_resets=False, got=counts())


def team_occupancy(lib, name, variants, envs_per_block=None):
    """Launch shape of a kernel (`name`: megastep_team, dynamics_substep,
    entry_cache, contact_cache or contact_substep) and the resident blocks
    and warps per SM of its instantiations, `variants` in the order its
    `<name>_occupancy` reports them
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  `envs_per_block`:
    one env per warp where not given."""
    blocks = (ctypes.c_int * len(variants))()
    threads, smem = ctypes.c_int(), ctypes.c_int()
    fn = getattr(lib, name + "_occupancy")
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    rc = fn(blocks, ctypes.byref(threads), ctypes.byref(smem))
    threads, smem = threads.value, smem.value
    per_sm = dict(zip(variants, blocks))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps_per_block = -(-threads // 32)
    envs_per_block = envs_per_block or warps_per_block
    say(phase="team_occupancy",
        kernel=f"{name} ({', '.join(variants)})",
        threads_per_block=threads, envs_per_block=envs_per_block,
        static_shared_bytes_per_block=smem, multiprocessors=sms,
        blocks_per_sm=per_sm,
        warps_per_sm={k: b * warps_per_block for k, b in per_sm.items()},
        waves_at_n_envs=dict(n_envs=N_ENVS, **{
            k: N_ENVS / max(1, b * envs_per_block * sms)
            for k, b in per_sm.items()}),
        ok=rc == 0 and min(per_sm.values()) > 0)
    if rc != 0:
        raise SystemExit(f"{name}_occupancy failed: {rc}")


def agreement(phase, what, s_a, s_b, n, max_envs_beyond=0, why=None,
              stop=True):
    """PhysicsState of two routes after one control step: the largest
    difference per leaf and the count of elements and of envs beyond the
    tolerance, over the envs that no reset touched.  Passes when at most
    `max_envs_beyond` envs hold an element beyond it (`why` says why a
    pair is allowed any).  A failure ends the run, or with `stop=False` is
    returned for the caller to end it: (ok, the indices of the envs beyond
    the tolerance)."""
    keep = (s_a.episode_length > 0) & (s_b.episode_length > 0)
    err, bad = {}, 0
    env_bad = torch.zeros_like(keep)
    for leaf in s_a.phys._fields:
        u, v = getattr(s_a.phys, leaf)[keep], getattr(s_b.phys, leaf)[keep]
        d = (u - v).abs()
        err[leaf] = float(d.max())
        beyond = d > ATOL + RTOL * v.abs()
        bad += int(beyond.sum())
        env_bad[keep] |= beyond.reshape(beyond.shape[0], -1).any(dim=1)
    envs_beyond = int(env_bad.sum())
    ids = torch.nonzero(env_bad).flatten().tolist()
    ok = envs_beyond <= max_envs_beyond and int(keep.sum()) > n // 2
    say(phase=phase, n_envs=n, envs_compared=int(keep.sum()), what=what,
        atol=ATOL, rtol=RTOL, tolerance=TOLERANCE, max_abs_err=err,
        beyond_tol=bad, envs_beyond_tol=envs_beyond, envs_beyond_ids=ids[:20],
        max_envs_beyond=max_envs_beyond, allowance=why, ok=ok)
    if not ok and stop:
        raise SystemExit(f"{phase}: the two routes disagree")
    return ok, ids


def dense_phase(state, state_r, routes, policy, gen, smi):
    """The dense route (`sim.use_pallas_contact=False`: stock torch ops, no
    hand kernel) at 4000 envs.  First one control step from one shared
    mid-stance state held against the kernel routes, a second oracle for
    them: dense reuse against the per-substep route (the same algorithm:
    one cache anchored at the entry state, 16 cold sweeps, contact points
    advanced at velocity level), dense exact against the per-substep exact
    route and against K5, and on `rough_train_cfg` dense exact against the
    per-substep exact rough route (K3b); all four are read before a failure
    ends the run.  A probe (`branch_probe`) beside them steps dense exact
    from the same state with the entry velocities scaled by 1 + 1e-7 and
    names the envs that move beyond the tolerance by that alone: each env
    beyond it in a flat exact pair must be one the probe names (a solver
    branch, not a fault, parts the routes there), whatever the allowance;
    on rough ground the probe's overlap is reported beside the 1 %
    allowance.  Then a
    24-step rollout of each mode, which must launch no hand kernel and
    build no env-minor cache, and one PPO iteration on dense reuse, then one
    more under the profiler."""
    N = N_ENVS
    cfg = mob_train_cfg(N)
    dense = dict(use_pallas_contact=False, megastep=False)
    env_d = LeggedRobotEnv(dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, **dense)), device=DEV)
    env_dx = LeggedRobotEnv(dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, reuse_matrices=False, **dense)), device=DEV)
    cfg_r = rough_train_cfg(N)
    env_drx = LeggedRobotEnv(dataclasses.replace(
        cfg_r, sim=dataclasses.replace(cfg_r.sim, reuse_matrices=False,
                                       **dense)), device=DEV)
    branch = ("two formulations of exact mode (N-major einsums, the "
              "kernels' fixed-order lane sums) part where a solver branch "
              "amplifies a last-bit difference: 1 env of 3996 from this "
              "state on an NVIDIA H100 80GB HBM3 (PERF.md, section 6), the "
              "one the branch probe names; at most 0.25 % of the envs may, "
              "each one the probe names")
    pairs = (
        ("dense_reuse_agreement", env_d, routes["substep"], state, 0, None,
         "dense reuse (N-major cache anchored at the entry state, cold "
         "solves, points advanced at velocity level; stock torch ops) vs the "
         "per-substep route (entry cache, K1, 4 x K3)"),
        ("dense_exact_agreement", env_dx, routes["substep_exact"], state,
         N // 400, branch, "dense exact (FK, M^-1 and the contact solve anew "
         "every substep; stock torch ops) vs the per-substep exact route (4 "
         "x {entry cache, K1, K3})"),
        ("dense_exact_vs_k5_agreement", env_dx, routes["exact"], state,
         N // 400, branch, "dense exact vs the control-step kernel in exact "
         "mode (K5, the cache rebuilt in the launch before every substep)"),
        ("dense_rough_exact_agreement", env_drx, routes["rough_substep_exact"],
         state_r, N // 100,
         "as the two exact rough kernel routes (rough_exact_route_agreement):"
         " on rough ground a few envs sit where a solver branch amplifies a "
         "last-bit difference; at most 1 % of the envs may",
         "dense exact vs the per-substep exact route (4 x {entry cache, K1, "
         "K3b}) on rough_train_cfg"))
    def step(env_x, st, a, k):
        return env_x.step(st._replace(
            rng=make_generator(SEED + 6 + k, DEV)), a)[0]

    oks, beyond, probes = [], {}, {}
    for k, (phase, env_a, env_b, st, allow, why, what) in enumerate(pairs):
        a = torch.randn((N, 12), generator=gen, device=DEV)
        s_a, s_b = step(env_a, st, a, k), step(env_b, st, a, k)
        torch.cuda.synchronize()
        ok, beyond[phase] = agreement(
            phase, "PhysicsState after one control step from one state and "
            "the same actions: " + what, s_a, s_b, N, max_envs_beyond=allow,
            why=why, stop=False)
        oks.append(ok)
        if phase in ("dense_exact_agreement", "dense_rough_exact_agreement"):
            # dense exact from the pair's state and actions
            probes["rough" if "rough" in phase else "flat"] = branch_probe(
                phase.replace("agreement", "branch_probe"), env_a, st, a,
                SEED + 6 + k, N)
    report = {}
    for p, ids in beyond.items():
        probe = set(probes["rough" if "rough" in p else "flat"])
        report[p] = dict(envs_beyond=len(ids),
                         of_them_probe_named=len(set(ids) & probe),
                         outside_the_probe=sorted(set(ids) - probe)[:20])
        if "exact" in p and "rough" not in p and not set(ids) <= probe:
            # a flat exact pair's envs beyond the tolerance must be branch
            # envs, whatever the allowance
            oks.append(False)
    say(phase="dense_branch_probe_overlap",
        envs_probe_named={k: len(v) for k, v in probes.items()},
        pairs=report, ok=all(oks))
    if not all(oks):
        raise SystemExit("dense route: an agreement with a kernel route "
                         "failed")
    for name, env_x, config in (
            ("dense_route", env_d, "mob_train_cfg, sim.use_pallas_contact="
             "False, sim.megastep=False"),
            ("dense_exact_route", env_dx, "mob_train_cfg, sim.use_pallas_"
             "contact=False, sim.megastep=False, sim.reuse_matrices=False")):
        st, obs = env_x.reset(gen)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        st, obs, ro = rollout(env_x, policy, ROLLOUT_STEPS, gen, state=st,
                              obs=obs)
        torch.cuda.synchronize()
        check_rollout(name, env_x, st, obs, ro, ROLLOUT_STEPS,
                      time.time() - t0, expect(), smi, config=config,
                      need_resets=False)
    train_phase("dense", env_d, gen, 1, expect())
    trace_phase(env_d, gen, "dense", "mob_train_cfg, sim.use_pallas_contact="
                "False, sim.megastep=False")


def check_dr_split(env, state):
    """Each slice's friction, added mass, COM shift and motor strength:
    with its randomisation on, inside its own range and spread over at
    least 90 % of it (a few hundred uniform draws span ~99 %); off, the
    default.  Returns (ok, a report per field and slice)."""
    T = env.num_train_envs
    fields = (("friction_coeffs", "randomize_friction", "friction_range",
               1.0),
              ("payloads", "randomize_base_mass", "added_mass_range", 0.0),
              ("com_displacements", "randomize_com_displacement",
               "com_displacement_range", 0.0),
              ("motor_strengths", "randomize_motor_strength",
               "motor_strength_range", 1.0))
    ok, out = True, {}
    for leaf, flag, rng, default in fields:
        for name, dr, sl in (("train", env.cfg.domain_rand, slice(0, T)),
                             ("eval", env.eval_cfg.domain_rand,
                              slice(T, None))):
            v = getattr(state, leaf)[sl]
            lo, hi = getattr(dr, rng)
            vmin, vmax = float(v.min()), float(v.max())
            on = bool(getattr(dr, flag))
            good = (lo <= vmin and vmax <= hi and vmax - vmin >= 0.9 * (
                hi - lo)) if on else bool((v == default).all())
            out[f"{leaf}/{name}"] = dict(on=on, range=[lo, hi], min=vmin,
                                         max=vmax, ok=good)
            ok = ok and good
    return ok, out


def branch_probe(phase, env_x, st, a, seed, n):
    """The envs that a step of `env_x` from `st` with the entry base and
    joint velocities scaled by 1 + 1e-7 moves beyond the tolerance, against
    the step from `st` itself (a measurement, no limit): where a route
    pair's envs beyond the tolerance are among them, a solver branch, not a
    fault, parts the routes."""
    def step(scale):
        phys = st.phys._replace(base_lin_vel=st.phys.base_lin_vel * scale,
                                base_ang_vel=st.phys.base_ang_vel * scale,
                                qd=st.phys.qd * scale)
        return env_x.step(st._replace(
            phys=phys, rng=make_generator(seed, DEV)), a)[0]

    return agreement(
        phase, "the step from a state with its velocities scaled by 1 + "
        "1e-7 vs from the state itself: the envs a last-bit change alone "
        "moves beyond the tolerance (a measurement, no limit)",
        step(1.0 + 1e-7), step(1.0), n, max_envs_beyond=n, stop=False)[1]


def eval_split_phases(policy, gen, smi, worst):
    """The train/eval env split of `mob_train_cfg(4000)` with an eval slice
    of `mob_train_cfg(400)` under the `rand_large` DR preset (4400 envs):
    (a) each slice's DR draws in its own range, a 24-step rollout through
    `ppo.collect` (one K4 launch a step for all 4400 envs; the eval slice
    acting with the student's mean), the eval actions against `actor_mean`
    and, with `eval_expert`, `act_teacher` of their observations, a PPO
    iteration; (b) one control step from one split state on the
    per-substep route against K4 with warm start off; (c) the eval slice on
    `rough_train_cfg`'s terrain rows appended to the train field (a 3000 x
    1500 heightfield, K4b): the eval origins beyond the train rows, K4b
    against its plain version on that field, one control step of K4b with
    warm start off against the per-substep route (K1, 4 x K3b), a 24-step
    rollout.  (d), the train and evaluate commands with eval flags, runs in
    `command_phases`.  Returns the launch counts of (a)'s and (c)'s
    rollouts."""
    N, E = N_ENVS, N_EVAL
    NT = N + E
    steps = ROLLOUT_STEPS
    cfg = mob_train_cfg(N)
    ev = dataclasses.replace(mob_train_cfg(E),
                             domain_rand=DR_SETTINGS["rand_large"])
    ev_r = dataclasses.replace(ev, terrain=rough_train_cfg(E).terrain)

    def split_env(eval_cfg, **sim):
        s = dataclasses.replace(cfg.sim, **sim)
        return LeggedRobotEnv(
            dataclasses.replace(cfg, sim=s),
            eval_cfg=dataclasses.replace(eval_cfg, sim=s), device=DEV)

    def collect_route(phase, env_x, state, obs, expect_counts, config):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        state, obs, traj, logs = ppo.collect(env_x, state, obs, policy, gen,
                                             steps, 0.99)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        got = counts()
        finite = all(bool(torch.isfinite(v).all()) for v in
                     list(obs.values()) + list(traj) + list(logs)
                     + [state.phys.q, state.phys.base_pos])
        shapes_ok = (tuple(traj.actions.shape) == (steps, N, 12)
                     and tuple(traj.rewards.shape) == (steps, N)
                     and tuple(obs["obs_history"].shape) == (NT, 2100))
        mean_h = float(state.phys.base_pos[:, 2].mean())
        ok = (finite and shapes_ok and got == expect_counts
              and 0.10 < mean_h < 0.45)
        say(phase=phase, config=config, n_envs=NT, n_train_envs=N,
            n_eval_envs=E, steps=steps, seconds=seconds,
            env_steps_per_s=NT * steps / seconds, gpu=smi,
            kernel_launches=got, expected_launches=expect_counts,
            finite=finite, trajectory_shape=list(traj.actions.shape),
            shapes_ok=shapes_ok, mean_base_height=mean_h,
            train_episodes_done=float(logs[1].sum()),
            eval_episodes_done=float(logs[4].sum()), ok=ok)
        if not ok:
            raise SystemExit(f"{phase} phase failed")
        return state, obs, got

    # ---- (a) flat split: DR, rollout, eval actions, PPO iteration ------
    env_s = split_env(ev)
    state, obs = env_s.reset(gen, random_episode_lengths=True)
    dr_ok, dr = check_dr_split(env_s, state)
    say(phase="eval_split_dr", n_train_envs=N, n_eval_envs=E,
        eval_preset="rand_large", fields=dr, ok=dr_ok)
    if not dr_ok:
        raise SystemExit("eval_split_dr: a slice's DR draws leave its range")
    config = "mob_train_cfg(4000) + eval mob_train_cfg(400), rand_large"
    state, obs, flat_counts = collect_route(
        "eval_split_route", env_s, state, obs, expect(control_step=steps),
        config)
    errs = {}
    clip = cfg.normalization.clip_actions
    for expert in (False, True):
        with torch.no_grad():
            hist, priv = obs["obs_history"][N:], obs["privileged_obs"][N:]
            want = (policy.act_teacher(hist, priv) if expert
                    else policy.actor_mean(hist))
        st1 = ppo.collect(env_s, state._replace(
            rng=make_generator(SEED + 7, DEV)), obs, policy,
            make_generator(SEED + 8, DEV), 1, 0.99, expert)[0]
        errs["act_teacher" if expert else "actor_mean"] = float(
            (st1.actions[N:] - torch.clamp(want, -clip, clip)).abs().max())
    act_ok = max(errs.values()) <= 1e-6
    say(phase="eval_split_actions", n_eval_envs=E,
        what="the eval slice's actions in a collect step vs the student's "
             "mean (actor_mean) and, with eval_expert, the teacher "
             "(act_teacher) of its observations", max_abs_err=errs,
        atol=1e-6, ok=act_ok)
    if not act_ok:
        raise SystemExit("eval_split_actions: the eval slice does not act "
                         "deterministically")
    ts = ppo.init_train_state(gen, env_s)
    fn = ppo.make_train_iteration(env_s, num_steps=steps)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    _, _, ts, m = fn(state, obs, ts)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    got = counts()
    ev_m = dict(eval_ep_sums_done=m.eval_ep_sums_done.tolist(),
                eval_ep_count_done=float(m.eval_ep_count_done),
                eval_ep_len_done=float(m.eval_ep_len_done))
    ok = (all(np.isfinite(np.asarray(ev_m["eval_ep_sums_done"])))
          and np.isfinite(ev_m["eval_ep_count_done"])
          and np.isfinite(ev_m["eval_ep_len_done"])
          and bool(torch.isfinite(m.value_loss)) and ts.iteration == 1
          and got == expect(control_step=steps))
    say(phase="train_iteration", route="eval_split", n_envs=NT,
        n_train_envs=N, num_steps=steps, seconds=seconds,
        env_steps_per_s=NT * steps / seconds, lr=m.lr,
        value_loss=float(m.value_loss), train_episodes_done=float(
            m.ep_count_done), **ev_m, kernel_launches=got,
        expected_launches=expect(control_step=steps), ok=ok)
    if not ok:
        raise SystemExit("train_iteration (eval_split) failed")

    # K4 at the split's width: 4400 envs, past the 4224 of one wave
    args, kw = kernel_call_of(env_s, state)
    timing("control_step_eval_split",
           lambda: megastep.control_step(*args, **kw),
           lambda: megastep.control_step_reference(*args, **kw),
           megastep.work_per_env(env_s.model, cfg.control.decimation,
                                 kw["warm_iters"], entry=True),
           NT, launch=megastep_launch(env_s.model, args, kw),
           threads_per_block=megastep.TEAM_THREADS)

    # ---- (b) one split state, the per-substep route vs K4 cold ---------
    a = torch.randn((NT, 12), generator=gen, device=DEV)
    s_sub, *_ = split_env(ev, megastep=False).step(
        state._replace(rng=make_generator(SEED + 9, DEV)), a)
    s_k4, *_ = split_env(ev, contact_warm_start=False).step(
        state._replace(rng=make_generator(SEED + 9, DEV)), a)
    torch.cuda.synchronize()
    agreement(
        "eval_split_route_agreement",
        "PhysicsState after one control step from one split state (4000 + "
        "400 envs) and the same actions: per-substep route (K1, 4 x K3) vs "
        "the control-step kernel with contact_warm_start off", s_sub, s_k4,
        NT)

    # ---- (c) the eval slice on rough terrain rows: K4b -------------------
    env_sr = split_env(ev_r)
    x = env_sr.env_origins[:, 0]
    field = list(env_sr.terrain.height.shape)
    rows_ok = (float(x[N:].min()) > float(x[:N].max()) and env_sr.rough
               and field == [3000, 1500])
    say(phase="eval_split_rough_terrain", heightfield=field,
        train_origin_x_max=float(x[:N].max()),
        eval_origin_x_min=float(x[N:].min()), ok=rows_ok)
    if not rows_ok:
        raise SystemExit("eval_split_rough_terrain: the eval rows are not "
                         "beyond the train rows")
    state_r, obs_r = env_sr.reset(gen)
    key = "control_step_normals"

    def k4b_check(st, st_name):
        args, kw = kernel_call_of(env_sr, st)
        p_args, p_kw = kernel_call_of(env_sr, st, eager_cache=True)
        worst[key] = max(worst.get(key, 0.0), compare(
            key, st_name, OUT_NAMES,
            lambda: megastep.control_step(*args, **kw),
            lambda: megastep.control_step_reference(*p_args, **p_kw), NT))

    k4b_check(state_r, "eval_split_rough_after_reset")
    state_r, obs_r, rough_counts = collect_route(
        "eval_split_rough_route", env_sr, state_r, obs_r,
        expect(control_step_normals=steps),
        config + ", eval terrain rough_train_cfg")
    k4b_check(state_r, "eval_split_rough_24_steps_in")
    args, kw = kernel_call_of(env_sr, state_r)
    timing("control_step_normals_eval_split",
           lambda: megastep.control_step(*args, **kw),
           lambda: megastep.control_step_reference(*args, **kw),
           megastep.work_per_env(env_sr.model, cfg.control.decimation,
                                 kw["warm_iters"], flat=False, entry=True),
           NT, launch=megastep_launch(env_sr.model, args, kw),
           threads_per_block=megastep.TEAM_THREADS)
    env_srs = split_env(ev_r, megastep=False)
    a = torch.randn((NT, 12), generator=gen, device=DEV)
    s_sub, *_ = env_srs.step(
        state_r._replace(rng=make_generator(SEED + 10, DEV)), a)
    s_k4b, *_ = split_env(ev_r, contact_warm_start=False).step(
        state_r._replace(rng=make_generator(SEED + 10, DEV)), a)
    torch.cuda.synchronize()
    ok, ids = agreement(
        "eval_split_rough_route_agreement",
        "PhysicsState after one control step from one split state with the "
        "eval slice on rough rows (4000 + 400 envs) and the same actions: "
        "per-substep route (K1, 4 x K3b) vs the control-step kernel with "
        "contact_warm_start off (K4b, cold)", s_sub, s_k4b, NT, stop=False)
    sensitive = branch_probe("eval_split_rough_branch_probe", env_srs,
                             state_r, a, SEED + 10, NT)
    say(phase="eval_split_rough_probe_overlap", envs_beyond=len(ids),
        of_them_probe_named=len(set(ids) & set(sensitive)),
        envs_probe_named=len(sensitive), ok=ok)
    if not ok:
        raise SystemExit("eval_split_rough_route_agreement: the two routes "
                         "disagree")
    return flat_counts, rough_counts


def drawing_libraries():
    """(True, versions) when matplotlib and imageio import, which
    utils/render.py draws with; else (False, the import error)."""
    try:
        import imageio
        import matplotlib
    except ImportError as e:
        return False, f"{type(e).__name__}: {e}"
    return True, dict(matplotlib=matplotlib.__version__,
                      imageio=imageio.__version__)


VIDEOS = []   # what each checked render_trajectory call saw, in order


def checked_render(model, phys_states, out_path, fps=50, env_idx=0,
                   stride=1):
    """Stands in for utils/render.render_trajectory in the smoke and its
    commands: the FK skeleton of the recorded frames on their device (the
    card), held against the same points from copies of the frames on the
    CPU; then the port's render_trajectory draws the video when matplotlib
    and imageio import, and else it is not drawn, with the reason."""
    frames = range(0, len(phys_states), stride)
    pts = [render._skeleton_points(model, phys_states[t], env_idx)
           for t in frames]
    pts_h = [render._skeleton_points(model, type(phys_states[t])(
        *[x.cpu() for x in phys_states[t]]), env_idx) for t in frames]
    err = max(float(np.abs(a - b).max()) for u, v in zip(pts, pts_h)
              for a, b in zip(u, v))
    drawn, why = drawing_libraries()
    rec = dict(path=out_path, frames=len(phys_states), points=len(pts),
               frames_device=str(phys_states[0].q.device),
               skeleton_max_abs_err=err, skeleton_atol=1e-5,
               finite=all(bool(np.isfinite(a).all()) for u in pts for a in u),
               drawn=drawn)
    if drawn:
        render_trajectory(model, phys_states, out_path, fps, env_idx, stride)
        rec["bytes"] = os.path.getsize(out_path)
    else:
        rec["why_not_drawn"] = why
    rec["ok"] = (rec["frames_device"] == str(DEV) and err <= 1e-5
                 and rec["finite"] and (not drawn or rec["bytes"] > 0))
    VIDEOS.append(rec)
    return out_path


render_trajectory = render.render_trajectory   # the port's, for drawing
render.render_trajectory = checked_render

def child(*jobs):
    """The command of a child process that runs the port's scripts `jobs`
    ([(job, module under walk_these_ways_tpu_torch.scripts, argv)]) one
    after another through `CHILD`."""
    return [sys.executable, "-c", CHILD, json.dumps(
        [[job, SCRIPTS + name, list(argv)] for job, name, argv in jobs])]


STARTED = []   # every child process `start` made; ended at exit


def _kill(p):
    """End a started child and whatever it started (its session)."""
    if p.poll() is None:
        os.killpg(p.pid, signal.SIGKILL)


@atexit.register
def _end_children():
    """A phase that fails ends the smoke while children still run (the
    MuJoCo engine halves start early): none outlives it."""
    for p in STARTED:
        _kill(p)
        p.wait()


def start(cmd, **env):
    """Start `cmd` from the repo root in a session of its own, its output
    piped, on the smoke's build directory (and `env` set)."""
    p = subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True,
        env=dict(os.environ, WTW_TORCH_BUILD_DIR=_build.build_dir(), **env))
    STARTED.append(p)
    return p


def finish(p, timeout=600):
    """(stdout, stderr) of a started process; killed after `timeout` s."""
    try:
        return p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill(p)
        return p.communicate()


def child_records(cmd, out, err, returncode, keep_lines=False):
    """{job: record} from a `child` process's output: each command's lines
    after its SMOKE_JOB line (all of them under "lines" with
    `keep_lines`), what it did on its SMOKE_DONE line, and the last line of
    its output that is a JSON object of its own."""
    err_tail = err.strip().splitlines()[-3:]
    lines, job, done = {}, None, {}
    for ln in out.strip().splitlines():
        if ln.startswith("SMOKE_JOB "):
            job = ln[len("SMOKE_JOB "):]
            lines[job] = []
        elif ln.startswith("SMOKE_DONE "):
            done[job] = json.loads(ln[len("SMOKE_DONE "):])
        elif job is not None:
            lines[job].append(ln)
    res = {}
    for job, name, argv in json.loads(cmd[-1]):
        rec = dict(command=" ".join([name] + argv),
                   returncode=0 if job in done else (returncode or 1),
                   stdout_tail=lines.get(job, [])[-3:],
                   stderr_tail=err_tail if job not in done else [])
        if keep_lines:
            rec["lines"] = lines.get(job, [])
        rec.update(done.get(job, {}))
        for ln in lines.get(job, []):
            try:
                row = json.loads(ln)
            except ValueError:
                continue
            if isinstance(row, dict):
                rec["last_json"] = row
        res[job] = rec
    return res


# run by each child process of `command_phases` (python -c CHILD '<json>'):
# the port's scripts as `python -m` runs them, one after another; each
# command's output follows a SMOKE_JOB line, and a SMOKE_DONE line after it
# gives its seconds, its kernels' launch counts and its checked videos
CHILD = """
import json, runpy, sys, time
jobs = json.loads(sys.argv[1])
sys.argv = sys.argv[:1]
import chip_smoke as smoke
for job, mod, argv in jobs:
    print("SMOKE_JOB " + job, flush=True)
    smoke.reset_counts()
    del smoke.VIDEOS[:]
    sys.argv = [mod] + argv
    t0 = time.time()
    try:
        runpy.run_module(mod, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (0, None):
            raise
    print("SMOKE_DONE " + json.dumps(dict(
        seconds=time.time() - t0, kernel_launches=smoke.counts(),
        videos=smoke.VIDEOS)), flush=True)
"""


def rma_train_phase(env, smi):
    """`Runner(algo="rma")` on mob_train_cfg(4000) at the reference's RMA
    widths: 2 iterations (launches, seconds, rollout / update split of
    each), a video of env 0 after the second, the export with
    meta/variant "rma" played back (scripts/play.load_policy against
    `student_mean`; play_go1 for 24 steps), a new Runner resumed from the
    checkpoint against the first for one more iteration, and the order of
    the update's two steps (`rma_adaptation_target`).  Returns the
    policy's export path, the Runner that wrote it and the K4 launches of
    each path."""
    d = os.path.join(OUT_DIR, "rma")
    shutil.rmtree(d, ignore_errors=True)
    rows = []
    split = {}
    inner_collect, inner_update = ppo_rma.collect, ppo_rma.update

    def timed(name, f):
        def g(*a, **k):
            t, out = seconds_of(lambda: f(*a, **k))
            split[name] = t
            return out
        return g

    ppo_rma.collect = timed("rollout_seconds", inner_collect)
    ppo_rma.update = timed("update_seconds", inner_update)
    try:
        r = Runner(env, log_dir=d, seed=SEED, algo="rma", args=RunnerArgs(
            num_steps_per_env=ROLLOUT_STEPS, log_freq=1, render_interval=2,
            render_steps=ROLLOUT_STEPS))
        train_iter, log_video = r.train_iter, r.log_video
        videos = []

        def counted_iter(*a):
            reset_counts()
            t, out = seconds_of(lambda: train_iter(*a))
            m = out[3]
            rows.append(dict(seconds=t, **split, lr=m.lr,
                             kernel_launches=counts(), **{
                                 k: float(getattr(m, k)) for k in (
                                     "value_loss", "surrogate_loss",
                                     "adaptation_loss", "mean_kl",
                                     "mean_reward")}))
            return out

        def counted_video(it):
            reset_counts()
            n = len(VIDEOS)
            t, path = seconds_of(lambda: log_video(it))
            videos.append(dict(VIDEOS[n], seconds=t,
                               kernel_launches=counts()))
            return path

        r.train_iter, r.log_video = counted_iter, counted_video
        r.learn(2)
    finally:
        ppo_rma.collect, ppo_rma.update = inner_collect, inner_update
    want = expect(control_step=ROLLOUT_STEPS)
    ok_iters = all(
        row["kernel_launches"] == want
        and all(np.isfinite(row[k]) for k in (
            "value_loss", "surrogate_loss", "adaptation_loss", "mean_kl"))
        and np.float32(1e-5) <= np.float32(row["lr"]) <= np.float32(1e-2)
        for row in rows) and len(rows) == 2
    for i, row in enumerate(rows):
        say(phase="rma_train_iteration", config="mob_train_cfg", algo="rma",
            n_envs=env.num_envs, iteration=i, num_steps=ROLLOUT_STEPS,
            expected_launches=want, **row, gpu=smi,
            ok=row["kernel_launches"] == want)
    video_ok = videos[0]["ok"] and videos[0]["kernel_launches"] == want
    say(phase="rma_video", **dict(videos[0], ok=video_ok),
        expected_launches=want)

    # the export, played back
    pol_path = os.path.join(d, "checkpoints", "policy_latest.npz")
    z = np.load(pol_path)
    student = play.load_policy(pol_path, device=DEV)
    with torch.no_grad():
        mine = r.train_state.policy.student_mean(r.obs_dict["obs"],
                                                 r.obs_dict["obs_history"])
    play_err = float((student(r.obs_dict) - mine).abs().max())
    reset_counts()
    t_play, vxs = seconds_of(lambda: play.play_go1(pol_path, steps=24,
                                                   device=DEV))
    play_counts = counts()

    # save, then resume: the same next iteration
    ck = os.path.join(d, "checkpoints", "train_state_last.pkl")
    r2 = Runner(env, log_dir=os.path.join(d, "resumed"), seed=SEED,
                algo="rma", args=RunnerArgs(
                    num_steps_per_env=ROLLOUT_STEPS, log_freq=1, resume=True,
                    resume_path=ck))
    r.train_iter, r.log_video = train_iter, log_video
    r.learn(1)
    r2.learn(1)
    torch.cuda.synchronize()
    resume_diff = max(float((p - q).detach().abs().max()) for p, q in zip(
        r.train_state.policy.parameters(), r2.train_state.policy.parameters()))
    resume_equal = resume_diff == 0.0
    ok = (ok_iters and video_ok and str(z["meta/variant"]) == "rma" and "encoder/w0" not in z.files
          and play_err <= 1e-6 and bool(np.isfinite(vxs).all())
          and play_counts == expect(control_step=25)
          and r2.train_state.iteration == r.train_state.iteration == 3
          and resume_diff <= 1e-5
          and r.train_state.lr == r2.train_state.lr)
    say(phase="rma_train", config="mob_train_cfg", algo="rma",
        n_envs=env.num_envs,
        what="Runner(algo='rma').learn(2) with a video after the second "
             "iteration, the export played back, a new Runner resumed from "
             "checkpoints/train_state_last.pkl and both run one iteration "
             "more",
        widths=dict(actor=[512, 256, 128], critic=[512, 256, 128],
                    encoder=[256, 128], adaptation=[256, 32], latent=18),
        iteration_seconds=[row["seconds"] for row in rows],
        rollout_seconds=[row["rollout_seconds"] for row in rows],
        update_seconds=[row["update_seconds"] for row in rows],
        export_variant=str(z["meta/variant"]),
        export_student_vs_student_mean=play_err,
        play_seconds=t_play, play_kernel_launches=play_counts,
        play_mean_vx=float(np.mean(vxs)),
        resumed_vs_uninterrupted_max_abs_param_diff=resume_diff,
        resumed_bit_equal=resume_equal, gpu=smi, ok=ok)
    if not ok:
        raise SystemExit("rma_train phase failed")

    # the update's two steps in their order: one minibatch of a fresh
    # learner; the adaptation loss it reports must be against the encoder
    # AFTER the main step (the adaptation module itself does not move in
    # that step: the PPO loss does not reach it)
    import copy
    ts = ppo_rma.init_train_state(make_generator(SEED + 8, DEV), env)
    _, _, traj, _ = ppo_rma.collect(env, r.env_state, r.obs_dict, ts.policy,
                                    ts.rng, 2, 0.99)
    with torch.no_grad():
        last = ts.policy.evaluate(r.obs_dict["obs"],
                                  r.obs_dict["privileged_obs"])
    data = ppo_rma.flatten_rollout(traj, *ppo.compute_gae(traj, last, 0.99,
                                                          0.95))
    before = copy.deepcopy(ts.policy)
    _, ms = ppo_rma.update(ts.policy, (ts.optimizer, ts.adapt_optimizer),
                           ts.lr, data, torch.arange(data[0].shape[0],
                                                     device=DEV),
                           ppo.PPO_Args(num_learning_epochs=1,
                                        num_mini_batches=1))
    with torch.no_grad():
        pred = before.adaptation(data[2])
        after = float(torch.mean(torch.square(
            pred - ts.policy.encoder(data[1]))))
        stale = float(torch.mean(torch.square(pred - before.encoder(
            data[1]))))
    got = float(ms.adaptation_loss[0])
    rel = abs(got - after) / after
    ok = rel <= 1e-5 and abs(stale - after) / after > 1e-3
    say(phase="rma_adaptation_target", n_samples=int(data[0].shape[0]),
        what="one minibatch of ppo_rma.update from a fresh learner: its "
             "adaptation loss against the MSE to the encoder after the main "
             "Adam step (and, to show that the check tells them apart, to "
             "the encoder before it)",
        reported=got, against_encoder_after=after,
        against_encoder_before=stale, rel_err=rel, rtol=1e-5, ok=ok)
    if not ok:
        raise SystemExit("rma_adaptation_target failed")
    return pol_path, r, dict(rma_train=sum(
        row["kernel_launches"]["control_step"] for row in rows),
        rma_log_video=videos[0]["kernel_launches"]["control_step"],
        rma_play=play_counts["control_step"])


def rma_eval_split_phase(gen, smi):
    """One RMA iteration on mob_train_cfg(4000) + 400 eval envs under the
    rand_large DR preset (4400 envs: 24 K4 launches), the eval slice acting
    with `student_mean`; then one with eval_expert, acting with
    `teacher_mean`.  Returns the K4 launches."""
    ev = dataclasses.replace(mob_train_cfg(N_EVAL),
                             domain_rand=DR_SETTINGS["rand_large"])
    env = LeggedRobotEnv(mob_train_cfg(N_ENVS), eval_cfg=ev, device=DEV)
    T = env.num_train_envs
    ts = ppo_rma.init_train_state(gen, env)
    state, obs = env.reset(gen)
    given = []
    step = env.step

    def recording_step(s, a):
        if not given:
            given.append(a[T:].clone())
        return step(s, a)

    env.step = recording_step
    launches = 0
    for expert in (False, True):
        with torch.no_grad():
            o, pv, h = (obs[k][T:] for k in ("obs", "privileged_obs",
                                             "obs_history"))
            want = (ts.policy.teacher_mean(o, pv)[0] if expert
                    else ts.policy.student_mean(o, h))
        del given[:]
        fn = ppo_rma.make_train_iteration(env, num_steps=ROLLOUT_STEPS,
                                          eval_expert=expert)
        reset_counts()
        t, (state, obs, ts, m) = seconds_of(lambda: fn(state, obs, ts))
        got = counts()
        launches += got["control_step"]
        err = float((given[0] - want).abs().max())
        ok = (got == expect(control_step=ROLLOUT_STEPS) and err == 0.0
              and all(bool(torch.isfinite(getattr(m, k))) for k in (
                  "value_loss", "surrogate_loss", "adaptation_loss"))
              and float(m.eval_ep_len_done) >= 0)
        say(phase="rma_eval_split", config=f"mob_train_cfg + {N_EVAL} eval "
            "envs of mob_train_cfg under rand_large", algo="rma",
            eval_expert=expert, n_envs=env.num_envs, n_eval=N_EVAL,
            eval_acts_with="teacher_mean" if expert else "student_mean",
            eval_actions_max_abs_diff=err, seconds=t, lr=m.lr,
            value_loss=float(m.value_loss),
            adaptation_loss=float(m.adaptation_loss),
            eval_episodes=float(m.eval_ep_count_done),
            kernel_launches=got,
            expected_launches=expect(control_step=ROLLOUT_STEPS), gpu=smi,
            ok=ok)
        if not ok:
            raise SystemExit("rma_eval_split phase failed")
    return launches


def mujoco_version():
    """(True, version) when mujoco imports, else (False, the import
    error)."""
    try:
        import mujoco
    except ImportError as e:
        return False, f"{type(e).__name__}: {e}"
    return True, mujoco.__version__


def start_mujoco_engine(device):
    """Start the engine halves of scripts/mujoco_parity.py's seven
    experiments (`--engine-only`) on `device` in a child process; on the
    card, where mujoco imports, the script's whole `main()` after them."""
    out = os.path.join(OUT_DIR, "mujoco_" + device)
    shutil.rmtree(out, ignore_errors=True)
    jobs = [("mujoco_engine_" + device, "mujoco_parity",
             ["--device", device, "--engine-only", "--out", out])]
    if device == "cuda" and mujoco_version()[0]:
        jobs.append(("mujoco_parity_main", "mujoco_parity",
                     ["--device", device, "--out", out + "_main"]))
    cmd = child(*jobs)
    return dict(cmd=cmd, proc=start(cmd), out=out, t0=time.time())


class _StandInMjData:
    """The two arrays of MuJoCo's MjData that set_mj_state and
    get_mj_state touch (a free joint, then the hinges)."""

    def __init__(self, nj):
        self.qpos = np.zeros(7 + nj)
        self.qvel = np.zeros(6 + nj)


def _rotate_inverse(quat_xyzw, v):
    """v in the frame of the unit quaternion q (xyzw): q^-1 v q."""
    x, y, z, w = quat_xyzw
    u = -np.array([x, y, z])
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def mujoco_state_mapping(row, real):
    """models/mjcf.set_mj_state / get_mj_state on an engine state `row`
    (pos, quat, lin, ang, q, qd) of the card's run: MuJoCo's conventions
    written (quaternion wxyz, free-joint angular velocity in the body
    frame) and the state read back.  On a stand-in MjData, and on a real
    one where mujoco imports (`real`)."""
    from walk_these_ways_tpu_torch.models import mjcf, robot
    st = [np.asarray(x, dtype=np.float64) for x in row[:6]]
    st[1] = st[1] / np.linalg.norm(st[1])
    datas = [("stand_in", _StandInMjData(len(st[4])))]
    if real:
        import mujoco
        mjm = mujoco.MjModel.from_xml_string(mjcf.go1_mjcf(robot.go1()))
        datas.append(("mujoco", mujoco.MjData(mjm)))
    x, y, z, w = st[1]
    errs = {}
    for name, d in datas:
        mjcf.set_mj_state(d, *st)
        written = np.concatenate([
            d.qpos[:3] - st[0], d.qpos[3:7] - [w, x, y, z],
            d.qpos[7:] - st[4], d.qvel[:3] - st[2],
            d.qvel[3:6] - _rotate_inverse(st[1], st[3]), d.qvel[6:] - st[5]])
        back = np.concatenate([np.ravel(a - b) for a, b in zip(
            mjcf.get_mj_state(d), st)])
        errs[name] = dict(written_max_abs_err=float(np.abs(written).max()),
                          read_back_max_abs_err=float(np.abs(back).max()))
    ok = all(e["written_max_abs_err"] <= 1e-12
             and e["read_back_max_abs_err"] <= 1e-12 for e in errs.values())
    say(phase="mujoco_state_mapping",
        what="set_mj_state then get_mj_state on the card's last "
             "go1_standing state: qpos[3:7] = (w, x, y, z), qvel[3:6] the "
             "world angular velocity in the body frame, and the state read "
             "back", atol=1e-12, **errs, ok=ok)
    return ok


def _engine_lines(rec):
    """{experiment: its PASS / FAIL line} of a `--engine-only` job."""
    out = {}
    for ln in rec.get("lines", []):
        if ln.startswith(("PASS ", "FAIL ")):
            row = json.loads(ln[5:])
            out[row["experiment"]] = row
    return out


def mujoco_engine_phase(cpu, card):
    """The seven experiments' engine halves (scripts/mujoco_parity.py
    `--engine-only`, the dense route at N = 1) from their two children: on
    the card each held to its analytic gate where it has one (the slide's
    mu g, the incline's stick and g(sin - mu cos), rest penetration within
    contact_slop + 1e-3, the bounce's e^2 h0, standing fz within 5 % of
    the weight), and elementwise to the same half on the CPU over its first
    10 rows (substeps; control steps in reuse mode) at 2e-4 + 2e-4 |cpu|
    (report forces as impulses, F dt); the full horizons, chaotic, between
    card and CPU by `_traj_metrics` without a gate.  Then the state mapping
    to MuJoCo's conventions on the card's last standing state."""
    from walk_these_ways_tpu_torch.scripts import mujoco_parity as mp
    recs = {}
    for side in (cpu, card):
        out, err = finish(side["proc"])
        side["wall_seconds"] = time.time() - side["t0"]
        recs.update(child_records(side["cmd"], out, err,
                                  side["proc"].returncode, keep_lines=True))
    rec_c, rec_g = recs["mujoco_engine_cpu"], recs["mujoco_engine_cuda"]
    lines_c, lines_g = _engine_lines(rec_c), _engine_lines(rec_g)
    ok_all = (rec_g["returncode"] == 0 and rec_c["returncode"] == 0
              and rec_g.get("kernel_launches") == expect())
    last = None
    for name in mp.ENGINE_HALVES:
        g_line, c_line = lines_g.get(name, {}), lines_c.get(name, {})
        fg = os.path.join(card["out"], f"{name}.engine.npz")
        fc = os.path.join(cpu["out"], f"{name}.engine.npz")
        if not (os.path.exists(fg) and os.path.exists(fc)):
            say(phase="mujoco_engine", experiment=name, ok=False,
                card=g_line, cpu=c_line)
            ok_all = False
            continue
        zg, zc = np.load(fg), np.load(fc)
        dt = mp.SETUPS[name]["DT"]
        modes = sorted({k.split("/")[0] for k in zc.files})
        first, full = {}, {}
        ok = g_line.get("analytic_ok") is not False
        for mode in modes:
            errs, beyond = {}, 0
            for f in mp.ROW_FIELDS:
                a, b = zg[f"{mode}/{f}"][:10], zc[f"{mode}/{f}"][:10]
                if f == "report_forces":
                    a, b = a * dt, b * dt
                d = np.abs(a - b)
                errs[f] = float(d.max()) if d.size else 0.0
                beyond += int((d > 2e-4 + 2e-4 * np.abs(b)).sum())
            first[mode] = dict(max_abs_err=errs, beyond=beyond)
            ok = ok and beyond == 0 and len(zg[f"{mode}/pos"]) == \
                len(zc[f"{mode}/pos"])

            def arrays(z):
                q = z[f"{mode}/q"]
                if q.shape[1] == 0:          # the box has no joints
                    q = np.zeros((len(q), 1))
                return z[f"{mode}/pos"], z[f"{mode}/quat"], q
            full[mode] = mp._traj_metrics(*arrays(zg), *arrays(zc))
        metric_keys = [k for k in g_line if k not in (
            "experiment", "device", "seconds", "rows", "analytic_ok")]
        say(phase="mujoco_engine", experiment=name, device="cuda",
            rows=g_line.get("rows"), seconds_card=g_line.get("seconds"),
            seconds_cpu=c_line.get("seconds"),
            analytic_ok=g_line.get("analytic_ok"),
            card={k: g_line[k] for k in metric_keys},
            cpu={k: c_line.get(k) for k in metric_keys},
            first_10_rows_card_vs_cpu=first, tolerance="2e-4 + 2e-4 |cpu|",
            full_horizon_card_vs_cpu=full, ok=ok)
        ok_all = ok_all and ok
        if name == "go1_standing":
            last = [zg[f"run/{f}"][-1] for f in mp.ROW_FIELDS[:6]]
    if "mujoco_parity_main" in recs:
        rec = dict(recs["mujoco_parity_main"])
        rec.pop("lines")
        ok = rec["returncode"] == 0
        say(phase="mujoco_parity_main", **rec, ok=ok)
        ok_all = ok_all and ok
    say(phase="mujoco_engine_total",
        seconds_card=rec_g.get("seconds"), seconds_cpu=rec_c.get("seconds"),
        wall_seconds_card=card["wall_seconds"],
        wall_seconds_cpu=cpu["wall_seconds"],
        card_kernel_launches=rec_g.get("kernel_launches"),
        stderr_tail=rec_g["stderr_tail"] + rec_c["stderr_tail"], ok=ok_all)
    mapped = last is not None and mujoco_state_mapping(
        last, mujoco_version()[0])
    if not (ok_all and mapped):
        raise SystemExit("mujoco_engine phase failed")


def deploy_phase(runner_cse, runner_rma, n=64):
    """The exports of the runner phase (cse) and the rma_train phase (rma),
    read by the port's numpy deploy loader (deploy/deploy_policy.py, the
    robot's side: no torch, no card), against the trained actors on the
    card (`actor_mean` / `student_mean`) on `n` observation rows of the
    card's rollout."""
    from walk_these_ways_tpu_torch.deploy.deploy_policy import (
        load_student_policy)
    ok_all = True
    for variant, r in (("cse", runner_cse), ("rma", runner_rma)):
        path = os.path.join(r.log_dir, "checkpoints", "policy_latest.npz")
        obs = r.obs_dict["obs"][:n]
        hist = r.obs_dict["obs_history"][:n]
        pol = r.train_state.policy
        with torch.no_grad():
            want = (pol.actor_mean(hist) if variant == "cse"
                    else pol.student_mean(obs, hist)).cpu().numpy()
        policy = load_student_policy(path)
        o_h, h_h = obs.cpu().numpy(), hist.cpu().numpy()
        t0 = time.time()
        try:
            got = np.stack([policy({"obs": o_h[i:i + 1],
                                    "obs_history": h_h[i:i + 1]})
                            for i in range(len(h_h))])
            err, why = float(np.abs(got - want).max()), None
        except ValueError as e:       # an actor fed the wrong input width
            err, why = float("inf"), f"{type(e).__name__}: {e}"
        seconds = time.time() - t0
        ok = str(np.load(path)["meta/variant"]) == variant \
            and err <= DEPLOY_ATOL
        say(phase="deploy_export", variant=variant, export=path,
            n_rows=len(h_h), what="load_student_policy (numpy, host) against "
            + ("actor_mean" if variant == "cse" else "student_mean")
            + " on the card, the same rows of the card's rollout",
            max_abs_err=err, atol=DEPLOY_ATOL, error=why,
            host_seconds=seconds, ok=ok)
        ok_all = ok_all and ok
    if not ok_all:
        raise SystemExit("deploy phase failed")


def deploy_loopback(policy_path, log_root, port=DEPLOY_PORT, max_steps=100):
    """Run in a child process (`DEPLOY_CHILD`): the port's UDP bridge built
    on this host for `port` and started with `--sim`, a second bus
    listening, then deploy_policy.load_and_run_policy on the export for
    `max_steps` steps; prints a JSON line: leg data received, the policy
    loop's PD targets heard on the wire (SDK joint order) among those it
    logged, the logged targets against the joint limits, the log's rows.
    The calibration walk before the loop starts from the sim robot's
    q = 0, outside the calf range (the bridge clamps those targets)."""
    import pickle
    from walk_these_ways_tpu_torch.deploy import bridge
    from walk_these_ways_tpu_torch.deploy import messages as msg
    from walk_these_ways_tpu_torch.deploy.bus import Bus
    from walk_these_ways_tpu_torch.deploy.deploy_policy import (
        load_and_run_policy)
    from walk_these_ways_tpu_torch.deploy.state_estimator import (
        StateEstimator)
    from walk_these_ways_tpu_torch.models.robot import go1
    t0 = time.time()
    exe = bridge.build(port)
    build_s = time.time() - t0
    proc = subprocess.Popen([exe, "--sim", "--ticks", "10000"],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    mon = Bus(port=port)
    targets, legs = [], []
    mon.subscribe(msg.CHANNEL_PD_TARGETS,
                  lambda p: targets.append(msg.PdTauTargets.decode(p)))
    mon.subscribe(msg.CHANNEL_LEG_CONTROL, lambda p: legs.append(1))
    mon.spin()
    t1 = time.time()
    try:
        log = load_and_run_policy(policy_path, max_steps=max_steps,
                                  wait_for_button=False, port=port,
                                  log_root=log_root)
    finally:
        mon.close()
        proc.terminate()
        proc.wait(timeout=5)
    loop_s = time.time() - t1
    with open(log, "rb") as f:
        rec = pickle.load(f)["hardware_closed_loop"]
    m = go1()
    q = np.concatenate(rec["joint_pos"])
    q_tgt = np.concatenate(rec["joint_pos_target"])
    # the policy loop's targets, SDK joint order, as published; a datagram
    # the listener drops under load is not matched, none is mismatched
    sent = q_tgt[:, StateEstimator.JOINT_IDXS]
    heard = np.array([t.q_des for t in targets])
    matched = int((np.abs(heard[:, None] - sent[None]).max(-1)
                   <= 1e-6).any(-1).sum())
    print(json.dumps(dict(
        port=port, bridge_build_seconds=build_s, loop_seconds=loop_s,
        leg_messages=len(legs), targets_heard=len(targets),
        targets_heard_of_the_policy_loop=matched,
        log_rows=len(rec["joint_pos"]),
        targets_inside_limits=bool(np.all(q_tgt >= m.dof_lower)
                                   and np.all(q_tgt <= m.dof_upper)),
        last_joint_tracking_err=float(np.abs(q[-1] - q_tgt[-1]).max()),
        log=log)), flush=True)


# the deploy loopback's child process (python -c DEPLOY_CHILD '<json>')
DEPLOY_CHILD = """
import json, sys
import chip_smoke
chip_smoke.deploy_loopback(*json.loads(sys.argv[1]))
"""


def check_deploy_loopback(res):
    """The deploy loopback child's record: leg data came back from the
    bridge, the policy loop's targets were heard on the wire as logged
    (SDK order, float32), each lies inside the joint limits, the log holds
    the loop's rows and the sim robot tracked the last target."""
    row = {}
    for ln in res["stdout_tail"]:
        try:
            row = json.loads(ln)
        except ValueError:
            continue
    ok = (res["returncode"] == 0 and row.get("leg_messages", 0) > 0
          and row.get("targets_heard_of_the_policy_loop", 0) > 0
          and row.get("log_rows") == 100
          and row.get("targets_inside_limits") is True
          and row.get("last_joint_tracking_err", 1.0) < 0.2)
    say(phase="deploy_loopback",
        what="the port's UDP bridge (--sim) built on this host, "
             "deploy_policy.load_and_run_policy on the runner phase's cse "
             "export for 100 steps, a second bus listening",
        command=res["command"], returncode=res["returncode"], **row,
        stderr_tail=res["stderr_tail"], ok=ok)
    return ok


def write_deploy_logs(log_dir, seed=0, T=200):
    """Two log*.pkl of PD-behaved joints in the deploy logger's format (no
    hardware log is in the repo): the actuator-net commands' input."""
    import pickle
    rs = np.random.RandomState(seed)
    os.makedirs(log_dir, exist_ok=True)
    for f in range(2):
        q = 0.1 * rs.randn(T, 12)
        qd = 0.5 * rs.randn(T, 12)
        q_tgt = q + 0.05 * rs.randn(T, 12)
        tau = 20.0 * (q_tgt - q) - 0.5 * qd + 0.1 * rs.randn(T, 12)
        with open(os.path.join(log_dir, f"log_{f}.pkl"), "wb") as fh:
            pickle.dump({"ep0": {"joint_pos": [q], "joint_vel": [qd],
                                 "joint_pos_target": [q_tgt],
                                 "tau_est": [tau], "torques": [tau]}}, fh)


def trace_phase(env, gen, route="control_step", config="mob_train_cfg"):
    """One PPO iteration (of the default route unless named) under
    utils/profiling.trace."""
    ts = ppo.init_train_state(gen, env)
    fn = ppo.make_train_iteration(env, num_steps=ROLLOUT_STEPS)
    state, obs = env.reset(gen)
    torch.cuda.synchronize()
    t0 = time.time()
    with profiling.trace() as prof:
        state, obs, ts, _ = fn(state, obs, ts)
        torch.cuda.synchronize()
    traced_s = time.time() - t0
    ops, busy, window_ms = profiling.device_summary(prof, 5)
    ok = len(ops) > 0 and 0.0 < busy <= 1.0
    say(phase="trace", route=route, config=config, n_envs=env.num_envs,
        what="one PPO iteration (24-step rollout + update) under "
             "torch.profiler: the five device ops with the most device "
             "time, and the share of the traced window in which the device "
             "ran a kernel", window_ms=window_ms, device_busy_share=busy,
        top_device_ops=[dict(name=n[:120], ms=ms, count=c)
                        for n, ms, c in ops],
        seconds_traced=traced_s, seconds_with_summary=time.time() - t0,
        ok=ok)
    if not ok:
        raise SystemExit("trace phase failed")


def main():
    t_start = time.time()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise SystemExit("float32 products must not run in TF32")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    drawn, libs_or_why = drawing_libraries()
    has_mujoco, mujoco_or_why = mujoco_version()
    say(phase="environment", python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=run([_build.find_nvcc(), "--version"]).splitlines()[-2:],
        gpu=smi, device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count(),
        video_drawing_libraries=drawn, drawing=libs_or_why,
        mujoco_imports=has_mujoco, mujoco=mujoco_or_why)
    # the MuJoCo experiments' engine halves on the CPU, the reference of
    # the card's: a host process from the start (it never touches the card)
    mujoco_cpu = start_mujoco_engine("cpu")

    N = N_ENVS
    cfg = mob_train_cfg(N)
    cfg_sub = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, megastep=False))
    cfg_cold = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, contact_warm_start=False))
    cfg_exact = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, reuse_matrices=False))
    cfg_sub_exact = dataclasses.replace(cfg_exact, sim=dataclasses.replace(
        cfg_exact.sim, megastep=False))
    cfg_p = small_train_cfg(N)
    cfg_r = rough_train_cfg(N)

    def rough(**sim):
        return dataclasses.replace(cfg_r, sim=dataclasses.replace(
            cfg_r.sim, **sim))

    cfg_rp = dataclasses.replace(cfg_r, control=dataclasses.replace(
        cfg_r.control, control_type="P"))
    env = LeggedRobotEnv(cfg, device=DEV)
    env_sub = LeggedRobotEnv(cfg_sub, device=DEV)
    env_cold = LeggedRobotEnv(cfg_cold, device=DEV)
    env_exact = LeggedRobotEnv(cfg_exact, device=DEV)
    env_sub_exact = LeggedRobotEnv(cfg_sub_exact, device=DEV)
    env_p = LeggedRobotEnv(cfg_p, device=DEV)
    env_px = LeggedRobotEnv(dataclasses.replace(cfg_p, sim=dataclasses.replace(
        cfg_p.sim, reuse_matrices=False)), device=DEV)    # K5-P
    env_r = LeggedRobotEnv(cfg_r, device=DEV)           # K4b
    env_rp = LeggedRobotEnv(cfg_rp, device=DEV)         # K4b with P control
    env_rs = LeggedRobotEnv(rough(megastep=False), device=DEV)   # K1 + K3b
    env_rx = LeggedRobotEnv(rough(reuse_matrices=False), device=DEV)
    env_rsx = LeggedRobotEnv(rough(megastep=False, reuse_matrices=False),
                             device=DEV)
    gen = make_generator(SEED, DEV)
    m = env.model
    nv, P = m.nv, m.cp_body.shape[0]

    # ---- build: one nvcc per source, all started together ----------------
    t0 = time.time()
    libs = _build.build_libraries([
        megastep.library_spec(m, 32, 6),
        contact.cache_spec(nv, P), contact.substep_spec(nv, P),
        dynamics.library_spec(m.anc_dof_body, m.joint_body, m.cp_body),
        entry_cache.library_spec(m)])
    for name in ("megastep_team", "contact_cache", "contact_substep",
                 "dynamics_substep", "entry_cache"):
        b = _build.builds[name]
        say(phase="build", library=name, source=CSRC + name + ".cu",
            seconds=b["seconds"], cached=b["cached"], command=b["command"],
            ptxas=[ln.strip() for ln in b["log"].splitlines()
                   if "registers" in ln or "stack frame" in ln
                   or "Compiling entry" in ln][:48])
    say(phase="build_all", sources=5, libraries=5, seconds=time.time() - t0)
    team_occupancy(libs[0], "megastep_team",
                   ("K4", "K4b", "K4c", "K4b-P", "K5", "K5-P"))
    team_occupancy(libs[3], "dynamics_substep", ("K3", "K3b"))
    team_occupancy(libs[4], "entry_cache", ("flat", "heightfield"))
    team_occupancy(libs[1], "contact_cache", ("K1",), contact.CACHE_ENVS)
    team_occupancy(libs[2], "contact_substep", ("K2",))

    # ---- policy: seeded actor/critic + the committed adaptation module --
    policy = ActorCritic(env.num_obs, env.num_privileged_obs,
                         env.num_obs_history, env.num_actions,
                         generator=gen, device=DEV)
    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "resources", "reference_policy",
                               "pretrain_v0_policy.npz"))
    convert.actor_critic_from_numpy({k: ref[k] for k in ref.files},
                                    module=policy)

    # ---- kernels against their plain versions at N envs, two states -----
    worst = {}
    state, obs = env.reset(gen)
    state0 = state
    args, kwargs = kernel_call_of(env, state)
    p_args, p_kwargs = kernel_call_of(env, state, eager_cache=True)
    worst["control_step"] = compare(
        "control_step", "after_reset", OUT_NAMES,
        megastep.control_step(*args, **kwargs),
        megastep.control_step_reference(*p_args, **p_kwargs), N)
    compare_substep_kernels(env_sub, state, "after_reset", worst)
    # 24 control steps of random actions in: feet and bodies on the ground
    for _ in range(24):
        a = torch.randn((N, 12), generator=gen, device=DEV)
        state, obs, _, _, _ = env.step(state, a)
    args, kwargs = kernel_call_of(env, state)
    p_args, p_kwargs = kernel_call_of(env, state, eager_cache=True)
    out_r = megastep.control_step_reference(*p_args, **p_kwargs)
    worst["control_step"] = max(worst["control_step"], compare(
        "control_step", "24_random_steps_in", OUT_NAMES,
        megastep.control_step(*args, **kwargs), out_r, N))
    say(phase="contacts", state="24_random_steps_in",
        contact_impulse_max=float(out_r[8][..., :N].abs().max()))
    k1, k2, k3, k3_kw, x = compare_substep_kernels(
        env_sub, state, "24_random_steps_in", worst)

    # ---- K4c (P control, small_train_cfg; the team kernel, against the ---
    # plain version fed the eager build), then K5 and K5-P (exact mode) ----
    state_p, _ = env_p.reset(gen)
    p_states = []
    for st_name in ("after_reset", "24_random_steps_in"):
        if st_name != "after_reset":
            for _ in range(24):
                a = torch.randn((N, 12), generator=gen, device=DEV)
                state_p, *_ = env_p.step(state_p, a)
        args_p, kw_p = kernel_call_of(env_p, state_p)
        pp_args, pp_kw = kernel_call_of(env_p, state_p, eager_cache=True)
        assert args_p[0] is None and kw_p["entry_inputs"] is not None
        worst["control_step_p"] = max(worst.get("control_step_p", 0.0),
                                      compare(
            "control_step_p", st_name, OUT_NAMES[:10],
            lambda: megastep.control_step(*args_p, **kw_p),
            lambda: megastep.control_step_reference(*pp_args, **pp_kw), N))
        p_states.append((st_name, state_p))
    for st_name, st in (("after_reset", state0),
                        ("24_random_steps_in", state)):
        args_x, kw_x = kernel_call_of(env_exact, st)
        worst["control_step_exact"] = max(
            worst.get("control_step_exact", 0.0), compare(
                "control_step_exact", st_name, OUT_NAMES,
                lambda: megastep.control_step(*args_x, **kw_x),
                lambda: megastep.control_step_reference(*args_x, **kw_x), N))
    for st_name, st in p_states:
        args_px, kw_px = kernel_call_of(env_px, st)
        worst["control_step_exact_p"] = max(
            worst.get("control_step_exact_p", 0.0), compare(
                "control_step_exact_p", st_name, OUT_NAMES[:10],
                lambda: megastep.control_step(*args_px, **kw_px),
                lambda: megastep.control_step_reference(*args_px, **kw_px),
                N))

    # ---- K4b (both torque models) and K3b on rough_train_cfg states -------
    state_r, ((args_b, kw_b), (args_bp, kw_bp), (k3b, k3b_kw)) = \
        rough_kernel_checks(env_r, env_rp, env_rs, gen, worst)

    # ---- kernel timing, bounds, plain versions' times ---------------------
    # K4, K4b, K4c and K4b-P build their entry cache in the launch: the
    # kernel's time and its plain version's (eager build + plain step)
    # include it; the eager build alone, which no route on the card makes
    # any more, is timed beside
    timed = {}
    t0 = time.time()
    engine.build_pallas_env_inputs(env.model, state.phys,
                                   env.dynamics_params(state)[1],
                                   env.terrain, engine.MEGASTEP_BLOCK)
    torch.cuda.synchronize()
    cache_ms = (time.time() - t0) * 1e3
    timed["control_step"] = timing(
        "control_step", lambda: megastep.control_step(*args, **kwargs),
        lambda: megastep.control_step_reference(*args, **kwargs),
        megastep.work_per_env(m, cfg.control.decimation,
                              cfg.sim.num_contact_iters_warm, entry=True), N,
        launch=megastep_launch(m, args, kwargs),
        eager_entry_cache_build_ms=cache_ms,
        threads_per_block=megastep.TEAM_THREADS)
    anc_p_np = np.asarray(m.anc_dof_body)[:, np.asarray(m.cp_body)].T
    timed["contact_cache"] = timing(
        "contact_cache", lambda: contact.build_contact_cache(*k1),
        lambda: contact.cache_core(*k1, eps=1e-6),
        contact.cache_work_per_env(anc_p_np), N,
        launch=contact_cache_launch(k1),
        threads_per_block=contact.cache_threads(P),
        max_abs_err_vs_plain=worst["contact_cache"])
    iters = cfg.sim.num_contact_iters
    timed["contact_substep"] = timing(
        "contact_substep",
        lambda: contact.contact_substep(*k2, **x["solver"]),
        lambda: contact.contact_core(*k2, **x["solver"]),
        contact.substep_work_per_env(nv, P, iters), N,
        launch=contact_substep_launch(k2, x["solver"]),
        threads_per_block=contact.SUBSTEP_THREADS,
        max_abs_err_vs_plain=worst["contact_substep"])
    timed["dynamics_substep"] = timing(
        "dynamics_substep", lambda: dynamics.dynamics_substep(*k3, **k3_kw),
        lambda: dynamics.dynamics_substep_reference(*k3, **k3_kw),
        dynamics.work_per_env(m.anc_dof_body, m.cp_body, iters), N,
        launch=dynamics_launch(k3, k3_kw),
        threads_per_block=dynamics.KERNEL_THREADS,
        max_abs_err_vs_plain=worst["dynamics_substep"])
    timed["entry_cache"] = timing(
        "entry_cache", *entry_cache_calls(env_sub, state),
        entry_cache.work_per_env(m), N,
        launch=entry_cache_launch(env_sub, state),
        threads_per_block=megastep.TEAM_THREADS,
        max_abs_err_vs_plain=worst["entry_cache"])
    D = cfg.control.decimation
    timed["control_step_p"] = timing(
        "control_step_p", lambda: megastep.control_step(*args_p, **kw_p),
        lambda: megastep.control_step_reference(*args_p, **kw_p),
        megastep.work_per_env(m, D, kw_p["warm_iters"], control_type="P",
                              entry=True),
        N, launch=megastep_launch(m, args_p, kw_p),
        eager_entry_cache_build_ms=cache_ms,
        threads_per_block=megastep.TEAM_THREADS,
        max_abs_err_vs_plain=worst["control_step_p"])
    timed["control_step_exact"] = timing(
        "control_step_exact", lambda: megastep.control_step(*args_x, **kw_x),
        lambda: megastep.control_step_reference(*args_x, **kw_x),
        megastep.work_per_env(m, D, 0, exact=True, num_iters=iters), N,
        launch=megastep_launch(m, args_x, kw_x),
        threads_per_block=megastep.TEAM_THREADS,
        max_abs_err_vs_plain=worst["control_step_exact"])
    timed["control_step_exact_p"] = timing(
        "control_step_exact_p",
        lambda: megastep.control_step(*args_px, **kw_px),
        lambda: megastep.control_step_reference(*args_px, **kw_px),
        megastep.work_per_env(m, D, 0, control_type="P", exact=True,
                              num_iters=iters), N,
        launch=megastep_launch(m, args_px, kw_px),
        threads_per_block=megastep.TEAM_THREADS,
        max_abs_err_vs_plain=worst["control_step_exact_p"])
    t0 = time.time()
    engine.build_pallas_env_inputs(env_r.model, state_r.phys,
                                   env_r.dynamics_params(state_r)[1],
                                   env_r.terrain, engine.MEGASTEP_BLOCK)
    torch.cuda.synchronize()
    rough_cache_ms = (time.time() - t0) * 1e3
    timed["control_step_normals"] = timing(
        "control_step_normals",
        lambda: megastep.control_step(*args_b, **kw_b),
        lambda: megastep.control_step_reference(*args_b, **kw_b),
        megastep.work_per_env(m, D, kw_b["warm_iters"], flat=False,
                              entry=True), N,
        launch=megastep_launch(m, args_b, kw_b),
        eager_entry_cache_build_ms=rough_cache_ms,
        threads_per_block=megastep.TEAM_THREADS,
        max_abs_err_vs_plain=worst["control_step_normals"])
    timed["control_step_normals_p"] = timing(
        "control_step_normals_p",
        lambda: megastep.control_step(*args_bp, **kw_bp),
        lambda: megastep.control_step_reference(*args_bp, **kw_bp),
        megastep.work_per_env(m, D, kw_bp["warm_iters"], control_type="P",
                              flat=False, entry=True), N,
        launch=megastep_launch(m, args_bp, kw_bp),
        eager_entry_cache_build_ms=rough_cache_ms,
        threads_per_block=megastep.TEAM_THREADS,
        max_abs_err_vs_plain=worst["control_step_normals_p"])
    timed["dynamics_substep_normals"] = timing(
        "dynamics_substep_normals",
        lambda: dynamics.dynamics_substep(*k3b, **k3b_kw),
        lambda: dynamics.dynamics_substep_reference(*k3b, **k3b_kw),
        dynamics.work_per_env(m.anc_dof_body, m.cp_body, iters, flat=False),
        N, launch=dynamics_launch(k3b, k3b_kw),
        threads_per_block=dynamics.KERNEL_THREADS,
        max_abs_err_vs_plain=worst["dynamics_substep_normals"])
    timed["entry_cache_normals"] = timing(
        "entry_cache_normals", *entry_cache_calls(env_rs, state_r),
        entry_cache.work_per_env(m, flat=False), N,
        launch=entry_cache_launch(env_rs, state_r),
        threads_per_block=megastep.TEAM_THREADS,
        max_abs_err_vs_plain=worst["entry_cache_normals"])

    # ---- small-input agreement: CUDA env (kernels) vs CPU env (plain) ----
    # the CPU env runs thousands of tiny ops: one intra-op thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    n_small = 64
    small_err = {}
    for route, sim in (("control_step", cfg.sim), ("substep", cfg_sub.sim)):
        quiet = dataclasses.replace(
            mob_train_cfg(n_small), sim=sim,
            noise=dataclasses.replace(cfg.noise, add_noise=False))
        env_c = LeggedRobotEnv(quiet, device="cpu")
        env_g = LeggedRobotEnv(quiet, device=DEV)
        s_c, _ = env_c.reset(make_generator(SEED + 1, "cpu"))

        def to_dev(v):
            if isinstance(v, torch.Tensor):
                return v.to(DEV)
            if isinstance(v, torch.Generator):
                return make_generator(SEED + 1, DEV)
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                return type(v)(*[to_dev(u) for u in v])
            return v

        s_g = to_dev(s_c)
        cpu_gen = make_generator(SEED + 2, "cpu")
        err = 0.0
        for _ in range(3):
            a = 0.5 * torch.randn((n_small, 12), generator=cpu_gen)
            s_c, o_c, r_c, d_c, _ = env_c.step(s_c, a)
            s_g, o_g, r_g, d_g, _ = env_g.step(s_g, a.to(DEV))
            err = max(err, float((o_g["obs"].cpu() - o_c["obs"]).abs().max()),
                      float((r_g.cpu() - r_c).abs().max()))
            if not torch.equal(d_g.cpu(), d_c):
                raise SystemExit("small-input check: done masks differ")
        small_err[route] = err
    torch.set_num_threads(threads)
    small_ok = max(small_err.values()) <= 1e-3
    say(phase="small_input_agreement", n_envs=n_small, steps=3,
        what="obs and reward, env on the card (kernels) vs env on the CPU "
             "(plain versions), same state and actions, on both routes",
        max_abs_err=small_err, atol=1e-3, ok=small_ok)
    if not small_ok:
        raise SystemExit("small-input check: card and CPU env disagree")

    # ---- main path: the rollout on the default route ----------------------
    steps = ROLLOUT_STEPS
    state, obs = env.reset(gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state, obs, ro = rollout(env, policy, steps, gen, state=state, obs=obs)
    torch.cuda.synchronize()
    main_counts = check_rollout(
        "main_path", env, state, obs, ro, steps, time.time() - t0,
        expect(control_step=steps), smi)

    # ---- the same rollout on the per-substep route -------------------------
    state_s, obs_s = env_sub.reset(gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state_s, obs_s, ro_s = rollout(env_sub, policy, steps, gen, state=state_s,
                                   obs=obs_s)
    torch.cuda.synchronize()
    sub_counts = check_rollout(
        "substep_route", env_sub, state_s, obs_s, ro_s, steps,
        time.time() - t0,
        expect(entry_cache=steps, contact_cache=steps,
               dynamics_substep=steps * D), smi)

    # ---- one control step by both routes from one state --------------------
    a = torch.randn((N, 12), generator=gen, device=DEV)
    s_sub, *_ = env_sub.step(
        state._replace(rng=make_generator(SEED + 3, DEV)), a)
    s_k4, *_ = env_cold.step(
        state._replace(rng=make_generator(SEED + 3, DEV)), a)
    torch.cuda.synchronize()
    # untouched by resets (an env reset in this step draws a fresh state)
    agreement(
        "route_agreement",
        "PhysicsState after one control step from one state and the same "
        "actions: per-substep route (torque model in PyTorch, K1, 4 x K3) "
        "vs the control-step kernel with contact_warm_start off (cold "
        "start, 16 sweeps every substep)", s_sub, s_k4, N)

    # ---- env-axis data parallel: 2 ranks x 2000 envs on the card (gloo), --
    # then the train script on an NCCL group of one; K4 on every rank
    mesh_paths = multi_rank_phase(env, smi)
    mesh_paths.update(train_script_mesh_phase(env, smi))

    # ---- the train/eval env split at 4000 + 400 envs: K4, K4b -----------
    eval_split_phases(policy, gen, smi, worst)

    # ---- the MuJoCo experiments' engine halves on the card: N = 1, in a --
    # child process that runs beside the phases below, after the last
    # kernel timings (the split's): its launches would share the card with
    # them and lengthen them by a third
    mujoco_card = start_mujoco_engine("cuda")

    # ---- the contact-substep kernel, driven directly ------------------------
    # No env branch launches it alone (as in the JAX package): a control
    # step's four substeps as {plain dynamics, contact-substep kernel},
    # held against the dynamics-substep kernel over the same four substeps.
    xs = substep_inputs(env_sub, state)
    k1, _, k3, k3_kw = substep_kernel_calls(xs)[:4]
    reset_counts()
    gv_a = gv_b = xs["gv_t"]
    pcp_a = pcp_b = xs["em"].p_cp_t
    for _ in range(D):
        k3_a = k3[:8] + (gv_a,) + k3[9:11] + (pcp_a,) + k3[12:]
        gv_free = dynamics.dynamics_substep_reference(
            *k3_a, **dict(k3_kw, contact=False))[0].contiguous()
        gv_a, pcp_a, lam_a = contact.contact_substep(
            k3[9], k3[10], k3[5], pcp_a, gv_free, *k3[12:16], **xs["solver"])
        k3_b = k3[:8] + (gv_b,) + k3[9:11] + (pcp_b,) + k3[12:]
        gv_b, pcp_b, lam_b = dynamics.dynamics_substep(*k3_b, **k3_kw)
    torch.cuda.synchronize()
    direct_counts = counts()
    direct_err = max(float((u[..., :N] - v[..., :N]).abs().max()) for u, v in
                     ((gv_a, gv_b), (pcp_a, pcp_b), (lam_a, lam_b)))
    direct_ok = (direct_counts["contact_substep"] == D
                 and direct_counts["dynamics_substep"] == D
                 and direct_err <= 1e-3
                 and bool(torch.isfinite(gv_a).all()))
    say(phase="contact_substep_direct", n_envs=N, substeps=D,
        what="four substeps of {plain dynamics, contact-substep kernel} vs "
             "four launches of the dynamics-substep kernel",
        kernel_launches=direct_counts, max_abs_err=direct_err, atol=1e-3,
        ok=direct_ok)
    if not direct_ok:
        raise SystemExit("contact_substep_direct phase failed")

    # ---- PPO training iterations on both routes ----------------------------
    train_phase("control_step", env, gen, 1, expect(control_step=steps))
    train_phase("substep", env_sub, gen, 1,
                expect(entry_cache=steps, contact_cache=steps,
                       dynamics_substep=steps * D))

    # ---- exact mode on the control-step route: K5, no eager cache build ---
    state_e, obs_e = env_exact.reset(gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state_e, obs_e, ro_e = rollout(env_exact, policy, steps, gen,
                                   state=state_e, obs=obs_e)
    torch.cuda.synchronize()
    exact_counts = check_rollout(
        "exact_route", env_exact, state_e, obs_e, ro_e, steps,
        time.time() - t0, expect(control_step_exact=steps), smi,
        config="mob_train_cfg, sim.reuse_matrices=False")

    # ---- exact mode with P control: K5-P ---------------------------------
    state_px, obs_px = env_px.reset(gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state_px, obs_px, ro_px = rollout(env_px, policy, steps, gen,
                                      state=state_px, obs=obs_px)
    torch.cuda.synchronize()
    exact_p_counts = check_rollout(
        "exact_p_route", env_px, state_px, obs_px, ro_px, steps,
        time.time() - t0, expect(control_step_exact_p=steps), smi,
        config="small_train_cfg, sim.reuse_matrices=False",
        need_resets=False)

    # ---- one control step: K5 against the per-substep exact route ----------
    a = torch.randn((N, 12), generator=gen, device=DEV)
    s_k5, *_ = env_exact.step(
        state._replace(rng=make_generator(SEED + 4, DEV)), a)
    s_sx, *_ = env_sub_exact.step(
        state._replace(rng=make_generator(SEED + 4, DEV)), a)
    torch.cuda.synchronize()
    agreement(
        "exact_route_agreement",
        "PhysicsState after one control step from one state and the same "
        "actions, exact mode: the control-step kernel (K5, cache rebuilt "
        "in-kernel before every substep) vs the per-substep route (entry "
        "cache, K1 and K3 per substep)", s_k5, s_sx, N)

    # ---- the per-substep exact route: D x {entry cache, K1, K3} a step ----
    state_sx, obs_sx = env_sub_exact.reset(gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state_sx, obs_sx, ro_sx = rollout(env_sub_exact, policy, steps, gen,
                                      state=state_sx, obs=obs_sx)
    torch.cuda.synchronize()
    check_rollout(
        "substep_exact_route", env_sub_exact, state_sx, obs_sx, ro_sx, steps,
        time.time() - t0,
        expect(entry_cache=steps * D, contact_cache=steps * D,
               dynamics_substep=steps * D), smi,
        config="mob_train_cfg, sim.megastep=False, sim.reuse_matrices=False",
        need_resets=False)

    # ---- the dense route: against the kernel routes, rollouts, PPO --------
    dense_phase(state, state_r, dict(
        substep=env_sub, substep_exact=env_sub_exact, exact=env_exact,
        rough_substep_exact=env_rsx), policy, gen, smi)

    # ---- P control on the control-step route: K4c ---------------------------
    state_p, obs_p = env_p.reset(gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state_p, obs_p, ro_p = rollout(env_p, policy, steps, gen, state=state_p,
                                   obs=obs_p)
    torch.cuda.synchronize()
    p_counts = check_rollout(
        "p_control_route", env_p, state_p, obs_p, ro_p, steps,
        time.time() - t0, expect(control_step_p=steps), smi,
        config="small_train_cfg", need_resets=False)

    # ---- the training entry point ---------------------------------------
    runner_cse, runner_k4c = runner_phase(env_p)
    rma_pol, runner_rma, k4_paths = rma_train_phase(env, smi)
    deploy_phase(runner_cse, runner_rma)
    k4_paths["rma_eval_split"] = rma_eval_split_phase(gen, smi)
    # launches on the paths of the RMA trainer and the tool scripts
    paths = command_phases(rma_pol, smi)
    mujoco_engine_phase(mujoco_cpu, mujoco_card)
    paths["control_step"].update(k4_paths)
    paths["control_step"].update(mesh_paths)
    # the runner's K4c launches trained the cse export the deploy phases read
    paths["control_step_p"] = dict(runner_cse_export=runner_k4c)
    row = bench.main(num_envs=N, warmup=1, iters=2)
    bench_ok = bool(np.isfinite(row["value"]) and row["value"] > 0)
    say(phase="bench", **row, ok=bench_ok)
    if not bench_ok:
        raise SystemExit("bench phase failed")

    # ---- rough terrain: K4b, K4b-P, D x K4b (exact), K1 + 4 x K3b ---------
    rough_counts = rough_route(
        "rough_route", "rough_train_cfg", env_r, policy, steps, gen,
        expect(control_step_normals=steps), smi)
    rough_p_counts = rough_route(
        "rough_p_control_route", "rough_train_cfg, control.control_type=P",
        env_rp, policy, steps, gen, expect(control_step_normals_p=steps),
        smi)
    rough_steps_exact = 4
    rough_route(
        "rough_exact_route", "rough_train_cfg, sim.reuse_matrices=False",
        env_rx, policy, rough_steps_exact, gen,
        expect(control_step_normals=rough_steps_exact * D), smi)
    rough_sub_counts = rough_route(
        "rough_substep_route", "rough_train_cfg, sim.megastep=False", env_rs,
        policy, steps, gen,
        expect(entry_cache_normals=steps, contact_cache=steps,
               dynamics_substep_normals=steps * D), smi)
    rough_route(
        "rough_substep_exact_route",
        "rough_train_cfg, sim.megastep=False, sim.reuse_matrices=False",
        env_rsx, policy, steps, gen,
        expect(entry_cache_normals=steps * D, contact_cache=steps * D,
               dynamics_substep_normals=steps * D), smi)
    a = torch.randn((N, 12), generator=gen, device=DEV)
    s_xb, *_ = env_rx.step(
        state_r._replace(rng=make_generator(SEED + 5, DEV)), a)
    s_sxb, *_ = env_rsx.step(
        state_r._replace(rng=make_generator(SEED + 5, DEV)), a)
    torch.cuda.synchronize()
    ok, ids = agreement(
        "rough_exact_route_agreement",
        "PhysicsState after one control step from one rough_train_cfg state "
        "and the same actions, exact mode: D control-step launches of one "
        "substep each (K4b, cold, fresh cache and terrain samples) vs the "
        "per-substep route (entry cache, K1 and K3b per substep)",
        s_xb, s_sxb, N, max_envs_beyond=N // 100,
        why="the two routes' torque models sum in other orders (1e-6 in a "
            "torque) and on rough ground a few envs sit where the solve "
            "amplifies that into 1e-3 in a joint velocity: the plain "
            "versions of the two routes, on the CPU from a state made the "
            "same way, differ beyond the tolerance in 8 envs of 3995, and "
            "in 7 of the same 8 with the entry velocities scaled by 1 + "
            "1e-7 (PERF.md, section 6); at most 1 % of the envs may",
        stop=False)
    sensitive = branch_probe("rough_exact_branch_probe", env_rsx, state_r, a,
                             SEED + 5, N)
    say(phase="rough_exact_probe_overlap", envs_beyond=len(ids),
        of_them_probe_named=len(set(ids) & set(sensitive)),
        envs_probe_named=len(sensitive), max_envs_beyond=N // 100, ok=ok)
    if not ok:
        raise SystemExit("rough_exact_route_agreement: the two routes "
                         "disagree")
    train_phase("rough", env_r, gen, 1, expect(control_step_normals=steps))
    row = bench.main(num_envs=N, warmup=1, iters=1, terrain="rough")
    bench_ok = bool(np.isfinite(row["value"]) and row["value"] > 0
                    and row["metric"] == f"train_env_steps_per_s_{N}env_rough")
    say(phase="bench_rough", **row, ok=bench_ok)
    if not bench_ok:
        raise SystemExit("bench (rough) phase failed")

    # ---- one PPO iteration under the profiler -----------------------------
    trace_phase(env, gen)

    say(phase="total", seconds=time.time() - t_start)
    print(smi, flush=True)
    launches = dict(
        control_step=main_counts["control_step"],
        contact_cache=sub_counts["contact_cache"],
        contact_substep=direct_counts["contact_substep"],
        dynamics_substep=sub_counts["dynamics_substep"],
        dynamics_substep_normals=rough_sub_counts["dynamics_substep_normals"],
        control_step_normals=rough_counts["control_step_normals"],
        control_step_normals_p=rough_p_counts["control_step_normals_p"],
        control_step_p=p_counts["control_step_p"],
        control_step_exact=exact_counts["control_step_exact"],
        control_step_exact_p=exact_p_counts["control_step_exact_p"],
        entry_cache=sub_counts["entry_cache"],
        entry_cache_normals=rough_sub_counts["entry_cache_normals"])
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel was never launched on its path: {launches}")
    rows = (
        ("control_step", "control_step (K4: whole control step, flat ground, "
         "actuator net, warm start, entry cache built in the launch, one "
         "warp per env)", "megastep_team.cu",
         "/ops/pallas_megastep.py:154"),
        ("contact_cache", "build_contact_cache (K1: point Jacobians J and "
         "effective masses W, a tile of 16 envs a block, operands staged "
         "in shared memory once)", "contact_cache.cu",
         "/ops/pallas_contact.py:131"),
        ("contact_substep", "contact_substep (K2: contact solve + point "
         "advance on cached J/W, one warp per env)", "contact_substep.cu",
         "/ops/pallas_contact.py:372"),
        ("dynamics_substep", "dynamics_substep (K3: unconstrained dynamics, "
         "midpoint rule, then the contact solve, flat ground, one warp per "
         "env)", "dynamics_substep.cu", "/ops/pallas_dynamics.py:139"),
        ("dynamics_substep_normals", "dynamics_substep with surface normals "
         "(K3b: as K3 on a heightfield, general-normal contact rows, one "
         "warp per env)", "dynamics_substep.cu",
         "/ops/pallas_dynamics.py:147"),
        ("entry_cache", "entry_cache (the per-substep route's entry cache: "
         "FK, twist bases, inertia blocks, CRBA, M^-1, contact points, one "
         "warp per env; ports plain array code, not a TPU kernel)",
         "entry_cache.cu", "/physics/envminor.py:333"),
        ("entry_cache_normals", "entry_cache on a heightfield (as "
         "entry_cache, with the height and normal sampled under each "
         "contact point; not a TPU kernel)", "entry_cache.cu",
         "/physics/engine.py:645"),
        ("control_step_normals", "control_step with surface normals (K4b: "
         "whole control step on a heightfield, actuator net, warm start, "
         "general-normal contact rows, entry cache and heightfield samples "
         "in the launch, one warp per env)", "megastep_team.cu",
         "/ops/pallas_megastep.py:185"),
        ("control_step_normals_p", "control_step with surface normals, P "
         "control (K4b-P: as K4b with tau = kp (tgt - q) - kd qd, entry "
         "cache and heightfield samples in the launch, one warp per env)",
         "megastep_team.cu", "/ops/pallas_megastep.py:185"),
        ("control_step_p", "control_step, P control (K4c: whole control "
         "step, flat ground, reuse mode, tau = kp (tgt - q) - kd qd, entry "
         "cache built in the launch, one warp per env)",
         "megastep_team.cu", "/ops/pallas_megastep.py:154"),
        ("control_step_exact", "control_step, exact mode (K5: whole control "
         "step, actuator net, FK/CRBA/M^-1/J/W rebuilt in shared memory "
         "before every substep, cold solves, one warp per env)",
         "megastep_team.cu", "/ops/pallas_megastep.py:154"),
        ("control_step_exact_p", "control_step, exact mode, P control (K5-P: "
         "as K5 with tau = kp (tgt - q) - kd qd, one warp per env)",
         "megastep_team.cu", "/ops/pallas_megastep.py:154"))
    print(json.dumps(dict(kernels=[dict(
        name=title, route="cuda", source=CSRC + src,
        replaces=JAX_PACKAGE + site, launches=launches[key],
        max_abs_err=worst[key], ms=timed[key]["ms"],
        plain_ms=timed[key]["plain_ms"], bound_ms=timed[key]["bound_ms"],
        bound_by=timed[key]["bound_by"], library_ms=None,
        **({"launches_on_other_paths": paths[key]} if key in paths else {}))
        for key, title, src, site in rows])), flush=True)
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))), flush=True)


if __name__ == "__main__":
    main()
