"""One training job of a cell: the env, the learner and the weights, built
from the cell's files and the seed on one side: the program
(walk_these_ways_tpu_torch) or, in its place for the control, the frozen
reference (portbench.reference.wtw), which has the same interface.

The benchmark makes the weights itself from the seed, on the device in one
draw, and hands the same to both sides; the env's reset and the learner's
generator (action noise, minibatch permutations) are seeded from it too."""
from __future__ import annotations

import dataclasses
import importlib
import math
import time
import types

import numpy as np
import torch

PROGRAM = "walk_these_ways_tpu_torch"
REFERENCE = "portbench.reference.wtw"


@dataclasses.dataclass(frozen=True)
class Side:
    """The modules of one side: config, env, engine, curriculum, the PPO
    core, the learner (the PPO core for cse, `ppo_rma` for rma), the
    policy's module and the env rows' module."""
    name: str
    go1_config: types.ModuleType
    go1_env: types.ModuleType
    engine: types.ModuleType
    curriculum: types.ModuleType
    ppo: types.ModuleType
    learner: types.ModuleType
    actor_critic: types.ModuleType
    mesh: types.ModuleType


def side(package: str, algo: str) -> Side:
    if algo not in ("cse", "rma"):
        raise ValueError(f"unknown algo {algo!r}")

    def imp(name):
        return importlib.import_module(f"{package}.{name}")
    ppo = imp("learn.ppo")
    return Side(package, imp("go1_config"), imp("envs.go1_env"),
                imp("physics.engine"), imp("envs.curriculum"), ppo,
                ppo if algo == "cse" else imp("learn.ppo_rma"),
                imp("models.actor_critic"), imp("parallel.mesh"))


def seeds(seed: int) -> dict:
    """The run's seeds, drawn from `--seed` (any whole number >= 0)."""
    s = np.random.SeedSequence(int(seed)).generate_state(4, dtype=np.uint64)
    return dict(weights=int(s[0]), learner=int(s[1]), reset=int(s[2]),
                sample=int(s[3]))


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def weight_shapes(config: dict):
    """[(name, shape, fan_in)] of the policy's parameters but `std`, in the
    configuration's order: each network's layers as (in, out) weights and
    biases, named as the policy's parameters are."""
    out = []
    for net, sizes in config["networks"].items():
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out.append((f"{net}.weights.{i}", (a, b), a))
            out.append((f"{net}.biases.{i}", (b,), a))
    return out


def make_weights(config: dict, seed: int, device) -> dict:
    """The initial weights from `seed`: uniform in +-1/sqrt(fan in), one
    draw on the device for all of them, float32; `std` at the
    configuration's initial noise."""
    shapes = weight_shapes(config)
    total = sum(math.prod(s) for _, s, _ in shapes)
    u = torch.rand(total, generator=generator(seed, device),
                   device=device) * 2 - 1
    out, k = {}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        out[name] = u[k:k + n].view(shape) / math.sqrt(fan_in)
        k += n
    out["std"] = torch.full((config["num_actions"],),
                            float(config["init_noise_std"]), device=device)
    return out


@torch.no_grad()
def load_weights(policy: torch.nn.Module, weights: dict):
    """Copy `weights` into the policy's parameters by name; raises where
    the policy's parameters are not the configuration's."""
    params = dict(policy.named_parameters())
    if set(params) != set(weights):
        raise ValueError("the policy's parameters differ from the "
                         f"configuration's: {sorted(set(params) ^ set(weights))}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)}, the "
                             f"configuration's {tuple(weights[name].shape)}")
        p.copy_(weights[name])


@dataclasses.dataclass
class Job:
    side: Side
    env: object
    ts: object
    env_state: object
    obs_dict: dict
    train_iter: object
    ppo_args: object
    seeds: dict
    weights: dict          # the initial weights, as made from the seed


def build(side_: Side, cell, device, seed: int, phases: dict | None = None):
    """The env reset and the learner with the seed's weights, ready for its
    first iteration.  `phases` collects the seconds of env_build, reset
    (which loads or builds the control-step kernel at the first step) and
    learner_build."""
    phases = {} if phases is None else phases
    cfg_c, traffic = cell.config, cell.traffic
    s = seeds(seed)
    t = time.perf_counter()
    cfg = getattr(side_.go1_config, cfg_c["env_cfg"])(
        num_envs=int(traffic["num_envs"]))
    env = side_.go1_env.LeggedRobotEnv(cfg, device=device)
    for key, attr in (("num_obs", "num_obs"),
                      ("num_privileged_obs", "num_privileged_obs"),
                      ("num_obs_history", "num_obs_history"),
                      ("num_actions", "num_actions")):
        if int(getattr(env, attr)) != int(cfg_c[key]):
            raise ValueError(f"the env's {attr} is {getattr(env, attr)}, "
                             f"the configuration's {cfg_c[key]}")
    if int(cfg.control.decimation) != int(cfg_c["decimation"]):
        raise ValueError("the env's decimation differs from the "
                         "configuration's")
    phases["env_build"] = time.perf_counter() - t

    t = time.perf_counter()
    env_state, obs_dict = env.reset(
        side_.go1_env.make_generator(s["reset"], device),
        random_episode_lengths=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["reset"] = time.perf_counter() - t

    t = time.perf_counter()
    ppo_args = side_.ppo.PPO_Args(**cfg_c["ppo"])
    ts = side_.learner.init_train_state(generator(s["learner"], device), env,
                                        ppo_args)
    weights = make_weights(cfg_c, s["weights"], device)
    load_weights(ts.policy, weights)
    ts.rng.manual_seed(s["learner"])
    train_iter = side_.learner.make_train_iteration(
        env, ppo_args, num_steps=int(traffic["num_steps_per_env"]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["learner_build"] = time.perf_counter() - t
    return Job(side_, env, ts, env_state, obs_dict, train_iter, ppo_args, s,
               weights)
