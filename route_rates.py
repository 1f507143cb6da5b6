#!/usr/bin/env python3
"""Env-steps per second of the port's routes on one NVIDIA GPU.

    python3 route_rates.py [route ...]

For each route, at 4000 envs: a seeded random policy rolls 24 control steps
out (`learn/rollout.rollout`, the rollout of a PPO iteration) three times
after one warm-up rollout (kernels built, caches warm), host clock around
each rollout ending in a synchronise.  Routes (all, or the ones named):
`flat` (`mob_train_cfg`, the default route), `p` (`small_train_cfg`, P
control), `rough_p` (`rough_train_cfg` with P control), `substep` and
`rough_substep` (the per-substep route, `sim.megastep=False`, of
`mob_train_cfg` and `rough_train_cfg`: per control step the entry cache, K1
and 4 x K3 or K3b), `substep_exact` (its exact mode on `mob_train_cfg`,
`sim.reuse_matrices=False` too: 4 x {entry cache, K1, K3} a step), `exact`
and `exact_p` (exact mode on the control-step route,
`sim.reuse_matrices=False`, of `mob_train_cfg` and `small_train_cfg`),
`dense` and `dense_exact` (the dense route of `mob_train_cfg`,
`sim.use_pallas_contact=False`: stock torch ops, no hand kernel; reuse
mode, and exact mode with `sim.reuse_matrices=False`), `eval_split` (the
default route of `mob_train_cfg(4000)` with 400 eval envs appended under
the `rand_large` DR preset: 4400 envs, one K4 launch a step).
Prints one JSON line per route with every rollout's
env-steps/s, the eager cache builds and kernel launches of the timed
rollouts (the launch counters the measured tree has), then the card's name
and power limit, and as the last line the directory of the package it
measured.

It uses only entry points that every slice of the port has, so a copy of
it runs against an older tree: put it at that tree's root and run it there
(the package is imported from the script's directory).  Compare two trees
only within one machine's run, in turns (old, new, new, old).  Needs one
CUDA device.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("route_rates.py needs a CUDA device\n")
    sys.exit(2)

import walk_these_ways_tpu_torch  # noqa: E402
from walk_these_ways_tpu_torch.envs.go1_env import (  # noqa: E402
    LeggedRobotEnv, make_generator)
from walk_these_ways_tpu_torch.go1_config import (  # noqa: E402
    mob_train_cfg, rough_train_cfg, small_train_cfg)
from walk_these_ways_tpu_torch.learn.rollout import rollout  # noqa: E402
from walk_these_ways_tpu_torch.models.actor_critic import ActorCritic  # noqa: E402
from walk_these_ways_tpu_torch.physics import envminor  # noqa: E402

# (ops module, its launch counters); a module or counter the measured tree
# does not have is left out
COUNTERS = (
    ("megastep", ("launches", "p_launches", "normal_launches",
                  "p_normal_launches", "exact_launches", "p_exact_launches")),
    ("contact", ("cache_launches",)),
    ("dynamics", ("launches", "normal_launches")),
    ("entry_cache", ("launches", "normal_launches")))
ROUTES = ("flat", "p", "rough_p", "substep", "rough_substep",
          "substep_exact", "exact", "exact_p", "dense", "dense_exact",
          "eval_split")
N_ENVS, STEPS, REPS = 4000, 24, 3
N_EVAL = 400        # the eval slice of the eval_split route


def counters():
    """{"module.counter": value} of the launch counters this tree has."""
    out = {}
    for name, attrs in COUNTERS:
        try:
            mod = importlib.import_module("walk_these_ways_tpu_torch.ops."
                                          + name)
        except ImportError:
            continue
        out.update({f"{name}.{a}": getattr(mod, a) for a in attrs
                    if hasattr(mod, a)})
    return out


def route_env(route, n, dev):
    """The route's env: `n` envs, and on `eval_split` N_EVAL more."""
    if route != "eval_split":
        return LeggedRobotEnv(route_cfg(route, n), device=dev)
    # a tree without the train/eval split has no eval_metrics module
    from walk_these_ways_tpu_torch.learn.eval_metrics import DR_SETTINGS
    ev = dataclasses.replace(mob_train_cfg(N_EVAL),
                             domain_rand=DR_SETTINGS["rand_large"])
    return LeggedRobotEnv(mob_train_cfg(n), eval_cfg=ev, device=dev)


def route_cfg(route, n):
    if route in ("flat", "substep", "substep_exact", "exact", "dense",
                 "dense_exact"):
        cfg = mob_train_cfg(n)
    elif route in ("p", "exact_p"):
        cfg = small_train_cfg(n)
    elif route in ("rough_p", "rough_substep"):
        cfg = rough_train_cfg(n)
    else:
        raise ValueError(f"unknown route {route!r}: one of {ROUTES}")
    if route == "rough_p":
        cfg = dataclasses.replace(cfg, control=dataclasses.replace(
            cfg.control, control_type="P"))
    if "substep" in route:
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, megastep=False))
    if "dense" in route:
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, use_pallas_contact=False, megastep=False))
    if "exact" in route:
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, reuse_matrices=False))
    return cfg


def measure(route, n, steps, reps, dev):
    env = route_env(route, n, dev)
    n = env.num_envs
    gen = make_generator(0, dev)
    policy = ActorCritic(env.num_obs, env.num_privileged_obs,
                         env.num_obs_history, env.num_actions,
                         generator=gen, device=dev)
    state, obs = env.reset(gen)
    state, obs, _ = rollout(env, policy, steps, gen, state=state, obs=obs)
    torch.cuda.synchronize()
    builds = envminor.cache_builds
    launches = counters()
    rates = []
    for _ in range(reps):
        t0 = time.time()
        state, obs, _ = rollout(env, policy, steps, gen, state=state,
                                obs=obs)
        torch.cuda.synchronize()
        rates.append(n * steps / (time.time() - t0))
    return dict(
        route=route, n_envs=n, steps=steps, env_steps_per_s=rates,
        eager_cache_builds=envminor.cache_builds - builds,
        kernel_launches={c: v - launches[c] for c, v in counters().items()
                         if v != launches[c]},
        finite=bool(torch.isfinite(state.phys.base_pos).all()))


def main(routes=ROUTES):
    unknown = set(routes) - set(ROUTES)
    if unknown:
        raise SystemExit(f"unknown routes {sorted(unknown)}: one of {ROUTES}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for route in routes:
        row = measure(route, N_ENVS, STEPS, REPS, dev)
        print(json.dumps(row), flush=True)
        if not row["finite"]:
            raise SystemExit(f"{route}: non-finite state")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(json.dumps(dict(package=os.path.dirname(os.path.abspath(
        walk_these_ways_tpu_torch.__file__)))), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ROUTES)
