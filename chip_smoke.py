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
  export), then four commands as subprocesses started together:
  `python -m walk_these_ways_tpu_torch.scripts.train --exact` and
  `... --terrain rough`, `scripts.play` (on the policy the runner exported)
  and `scripts.test`; the bench's `main`,
- rough terrain (`rough_train_cfg(4000)`): the default route (one K4b launch
  per step), the P-control route (one K4b-P launch per step), the exact
  route (`decimation` K4b launches of one substep per step), the
  per-substep route (entry cache + K1 + 4 K3b per step) and the per-substep
  exact route (4 x {entry cache, K1, K3b} per step), the exact route held
  against the per-substep exact route, a PPO iteration and the bench on
  rough terrain,
- one PPO iteration under `utils/profiling.trace` (the longest device ops
  and the device-busy share).

Prints one JSON line per phase; needs one CUDA device and no network; exits
non-zero if any phase fails or no CUDA device is present.

The last line of the output is
    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": n}}
"""
import ctypes
import dataclasses
import json
import os
import shutil
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
from walk_these_ways_tpu_torch.learn import ppo  # noqa: E402
from walk_these_ways_tpu_torch.learn.rollout import rollout  # noqa: E402
from walk_these_ways_tpu_torch.learn.runner import Runner, RunnerArgs  # noqa: E402
from walk_these_ways_tpu_torch.models.actor_critic import ActorCritic  # noqa: E402
from walk_these_ways_tpu_torch.ops import (  # noqa: E402
    _build, contact, dynamics, entry_cache, megastep)
from walk_these_ways_tpu_torch.physics import engine, envminor  # noqa: E402
from walk_these_ways_tpu_torch.utils import convert, profiling  # noqa: E402

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
ROLLOUT_STEPS = 24  # control steps of each rollout (one PPO iteration's)
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s on CUDA cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# directory of the JAX package, which this script names and never imports
JAX_PACKAGE = "walk_these_ways_" + "tpu"
CSRC = "walk_these_ways_tpu_torch/csrc/"
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
    more, and the exported policy."""
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


def command_phases():
    """The port's commands as a user runs them, four subprocesses started
    together: the train script with --exact (2 iterations) and with
    --terrain rough (1 iteration), `scripts.play` on the policy the runner
    phase exported and `scripts.test`.  One phase line for each train
    script and one for the two scripts."""
    mod = "walk_these_ways_tpu_torch.scripts."
    train = [sys.executable, "-m", mod + "train", "--num-envs", str(N_ENVS)]
    logs = {k: os.path.join(OUT_DIR, k) for k in ("exact", "rough")}
    for d in logs.values():
        shutil.rmtree(d, ignore_errors=True)
    pol = os.path.join(OUT_DIR, "runner", "checkpoints", "policy_latest.npz")
    cmds = dict(
        exact=train + ["--iterations", "2", "--exact",
                       "--log-dir", logs["exact"]],
        rough=train + ["--iterations", "1", "--terrain", "rough",
                       "--log-dir", logs["rough"]],
        play=[sys.executable, "-m", mod + "play", "--policy", pol,
              "--steps", "24"],
        test=[sys.executable, "-m", mod + "test", "--num-envs", "3",
              "--steps", "50"])
    t0 = time.time()
    env = dict(os.environ, WTW_TORCH_BUILD_DIR=_build.build_dir())
    procs = {k: subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for k, c in cmds.items()}
    res = {}
    for k, p in procs.items():
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        res[k] = dict(command=" ".join(cmds[k][1:]),
                      seconds_to_collected=time.time() - t0,
                      returncode=p.returncode,
                      stdout_tail=out.strip().splitlines()[-3:],
                      stderr_tail=err.strip().splitlines()[-3:])
    ok_all = True
    for k in ("exact", "rough"):
        files = [f for f in ("provenance.json",
                             "checkpoints/train_state_last.pkl",
                             "checkpoints/policy_latest.npz")
                 if os.path.exists(os.path.join(logs[k], f))]
        ok = res[k]["returncode"] == 0 and len(files) == 3
        say(phase="train_script_" + k, **res[k], artifacts=files, ok=ok)
        ok_all = ok_all and ok
    ok = (res["play"]["returncode"] == 0
          and any("mean body-frame vx" in ln
                  for ln in res["play"]["stdout_tail"])
          and res["test"]["returncode"] == 0
          and res["test"]["stdout_tail"][-1:] == ["OK"])
    say(phase="scripts", play=res["play"], test=res["test"], ok=ok)
    if not (ok and ok_all):
        raise SystemExit("a command of the port failed")


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


def agreement(phase, what, s_a, s_b, n, max_envs_beyond=0, why=None):
    """PhysicsState of two routes after one control step: the largest
    difference per leaf and the count of elements and of envs beyond the
    tolerance, over the envs that no reset touched.  Passes when at most
    `max_envs_beyond` envs hold an element beyond it (`why` says why a
    pair is allowed any)."""
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
    ok = envs_beyond <= max_envs_beyond and int(keep.sum()) > n // 2
    say(phase=phase, n_envs=n, envs_compared=int(keep.sum()), what=what,
        atol=ATOL, rtol=RTOL, tolerance=TOLERANCE, max_abs_err=err,
        beyond_tol=bad, envs_beyond_tol=envs_beyond,
        max_envs_beyond=max_envs_beyond, allowance=why, ok=ok)
    if not ok:
        raise SystemExit(f"{phase}: the two routes disagree")


def trace_phase(env, gen):
    """One PPO iteration (default route) under utils/profiling.trace."""
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
    say(phase="trace", config="mob_train_cfg", n_envs=env.num_envs,
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
    say(phase="environment", python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=run([_build.find_nvcc(), "--version"]).splitlines()[-2:],
        gpu=smi, device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count())

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
    runner_phase(env_p)
    command_phases()
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
    agreement(
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
            "1e-7 (PERF.md, section 6); at most 1 % of the envs may")
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
        bound_by=timed[key]["bound_by"], library_ms=None)
        for key, title, src, site in rows])), flush=True)
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))), flush=True)


if __name__ == "__main__":
    main()
