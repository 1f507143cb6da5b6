"""Deploy-side rolling observation history.

Rebuild of the reference deploy HistoryWrapper (reference:
go1_gym_deploy/envs/history_wrapper.py:6-53): maintains the flat
(1, H * num_obs) history the student policy consumes; numpy only.
"""
from __future__ import annotations

import numpy as np


class HistoryWrapper:
    def __init__(self, agent):
        self.agent = agent
        self.H = agent.cfg.env.num_observation_history
        self.num_obs = agent.num_obs
        self.obs_history = np.zeros(self.H * self.num_obs, dtype=np.float32)

    def step(self, actions, hard_reset: bool = False):
        obs, rew, done, info = self.agent.step(actions, hard_reset=hard_reset)
        self.obs_history = np.concatenate(
            [self.obs_history[self.num_obs:], obs])
        return {"obs": obs, "privileged_obs": None,
                "obs_history": self.obs_history[None, :]}, rew, done, info

    def get_observations(self):
        obs = self.agent.get_obs()
        self.obs_history = np.concatenate(
            [self.obs_history[self.num_obs:], obs])
        return {"obs": obs, "privileged_obs": None,
                "obs_history": self.obs_history[None, :]}

    def reset(self):
        obs = self.agent.reset()
        self.obs_history[:] = 0.0
        return {"obs": obs, "privileged_obs": None,
                "obs_history": self.obs_history[None, :]}

    def __getattr__(self, name):
        return getattr(self.agent, name)
