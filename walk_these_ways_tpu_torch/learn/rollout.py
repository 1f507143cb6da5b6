"""Policy rollout in the simulator.

The loop that playing a policy and collecting PPO experience share:
policy forward on the observation history -> `env.step` -> the control-step
kernel, `steps` times.  (Counterpart of the loop in the JAX package's
scripts/play.py and of the rollout half of its learn/ppo.py.)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..envs.go1_env import EnvState, LeggedRobotEnv
from ..models.actor_critic import ActorCritic


class Rollout(NamedTuple):
    """Stacked over steps (leading dim T = steps)."""

    obs_history: torch.Tensor      # (T, N, H * num_obs) fed to the policy
    privileged_obs: torch.Tensor   # (T, N, num_privileged_obs)
    actions: torch.Tensor          # (T, N, 12)
    log_probs: torch.Tensor        # (T, N)
    values: torch.Tensor           # (T, N)
    rewards: torch.Tensor          # (T, N)
    dones: torch.Tensor            # (T, N) bool
    time_outs: torch.Tensor        # (T, N) bool
    base_height: torch.Tensor      # (T,) mean base height after each step
    num_resets: torch.Tensor       # (T,) envs reset at each step


@torch.no_grad()
def rollout(env: LeggedRobotEnv, policy: ActorCritic, steps: int,
            generator: torch.Generator, state: "EnvState | None" = None,
            obs: "dict | None" = None):
    """Roll `policy` out in `env` for `steps` control steps.

    `generator` (on the env's device) draws the action noise; the env's own
    draws come from the generator in its state.  Starts from `state`/`obs`
    when given, else from `env.reset(generator)`.  Returns (final state,
    final obs dict, Rollout)."""
    if state is None:
        state, obs = env.reset(generator)
    cols = {k: [] for k in Rollout._fields}
    for _ in range(steps):
        hist, priv = obs["obs_history"], obs["privileged_obs"]
        actions, logp, _, _ = policy.sample_actions(hist, generator)
        value = policy.evaluate(hist, priv)
        state, obs, rew, done, info = env.step(state, actions)
        cols["obs_history"].append(hist)
        cols["privileged_obs"].append(priv)
        cols["actions"].append(actions)
        cols["log_probs"].append(logp)
        cols["values"].append(value)
        cols["rewards"].append(rew)
        cols["dones"].append(done)
        cols["time_outs"].append(info.time_outs)
        cols["base_height"].append(state.phys.base_pos[:, 2].mean())
        cols["num_resets"].append(done.sum())
    return state, obs, Rollout(**{k: torch.stack(v) for k, v in cols.items()})
