"""Stateful gym-style adapter over the functional env.

API parity with the reference's env stack for users coming from
HistoryWrapper + VecEnv (reference: go1_gym/envs/wrappers/history_wrapper.py
:18-41 step/get_observations/reset returning {'obs','privileged_obs',
'obs_history'}, and go1_gym_learn/env/vec_env.py:10-39).  The functional
`LeggedRobotEnv` stays the first-class interface; this class just owns the
EnvState for imperative-style scripts.
"""
from __future__ import annotations

import torch

from .go1_env import LeggedRobotEnv


class VecEnvAdapter:
    def __init__(self, env: LeggedRobotEnv, seed: int = 0):
        self.env = env
        self.num_envs = env.num_envs
        self.num_obs = env.num_obs
        self.num_privileged_obs = env.num_privileged_obs
        self.num_obs_history = env.num_obs_history
        self.num_actions = env.num_actions
        self.num_train_envs = env.num_train_envs
        self.num_eval_envs = env.num_eval_envs
        self.dt = env.dt
        self.max_episode_length = env.max_episode_length
        self._step = env.step
        self._seed = seed
        self.state = None
        self._last_obs = None

    def reset(self, random_episode_lengths: bool = False):
        self.state, obs = self.env.reset(
            self._seed, random_episode_lengths=random_episode_lengths)
        self._last_obs = obs
        return obs

    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32,
                                  device=self.env.device)
        self.state, obs, rew, done, info = self._step(self.state, actions)
        self._last_obs = obs
        return obs, rew, done, info

    def get_observations(self):
        if self._last_obs is None:
            return self.reset()
        return self._last_obs

    def __getattr__(self, name):
        return getattr(self.env, name)
