"""VelocityTrackingEasyEnv — reference-API adapter with the full extras set.

API parity with the reference's top-level env class
(go1_gym/envs/go1/velocity_tracking/__init__.py:10-49): `step(actions)`
returns the 4-tuple `(obs_dict, rew, reset, extras)` where `extras`
carries the same 13 diagnostic keys the reference stuffs in
(`privileged_obs`, `joint_pos`, `joint_vel`, `joint_pos_target`,
`joint_vel_target`, `body_linear_vel`, `body_angular_vel`,
`body_linear_vel_cmd`, `body_angular_vel_cmd`, `contact_states`,
`foot_positions`, `body_pos`, `torques`), as numpy arrays exactly like
the reference's `.cpu().numpy()` conversions.  `reset()` steps zero
actions once and returns the obs dict (reference `reset`, `:46-49`).

The extras are copied to the host after the step, so this adapter costs one
device->host fetch per step — it is an analysis/eval surface, not the
training path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..envs.wrappers import VecEnvAdapter
from ..ops import quat as qops


class VelocityTrackingEasyEnv(VecEnvAdapter):
    """Reference-parity step/reset surface over the functional env."""

    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32,
                                  device=self.env.device)
        self.state, obs, rew, done, info = self._step(self.state, actions)
        self._last_obs = obs
        extras = self._extras(obs, info)
        return obs, rew, done, extras

    def reset(self, random_episode_lengths: bool = False):
        super().reset(random_episode_lengths=random_episode_lengths)
        obs, _, _, _ = self.step(
            torch.zeros((self.num_envs, self.num_actions),
                        device=self.env.device))
        return obs

    def _extras(self, obs, info):
        """The reference's diagnostics dict (velocity_tracking/__init__.py:
        28-42), host numpy."""
        s = self.state
        base_lin_b = qops.quat_rotate_inverse(
            s.phys.base_quat, s.phys.base_lin_vel)
        base_ang_b = qops.quat_rotate_inverse(
            s.phys.base_quat, s.phys.base_ang_vel)
        feet = list(self.env.feet_indices)
        contact_states = s.contact_forces[:, feet, 2] > 1.0
        dev = dict(
            joint_pos=s.phys.q, joint_vel=s.phys.qd,
            joint_pos_target=s.joint_pos_target,
            body_linear_vel=base_lin_b, body_angular_vel=base_ang_b,
            body_linear_vel_cmd=s.commands[:, 0:2],
            body_angular_vel_cmd=s.commands[:, 2:],
            contact_states=contact_states,
            foot_positions=s.foot_positions,
            body_pos=s.phys.base_pos, torques=s.torques)
        host = {k: v.detach().cpu().numpy() for k, v in dev.items()}
        host["privileged_obs"] = obs["privileged_obs"]
        host["joint_vel_target"] = np.zeros(12, np.float32)
        host["time_outs"] = info.time_outs.detach().cpu().numpy()
        host["env_bins"] = info.env_bins.detach().cpu().numpy()
        return host
