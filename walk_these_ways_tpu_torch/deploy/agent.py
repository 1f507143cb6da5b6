"""Hardware "env": mirrors the sim observation layout on the real robot.

Rebuild of the reference LCMAgent (reference:
go1_gym_deploy/envs/lcm_agent.py:31-301): assembles the exact training
observation vector from estimator state (:125-190), converts policy actions
to PD targets with action scaling + hip_scale_reduction and the sim->SDK
joint remap (:193-217), runs the software gait clock (:238-263), and paces
the loop at 50 Hz (:233).  Torch-free (numpy only), as is the policy it
feeds (deploy_policy.load_student_policy).
"""
from __future__ import annotations

import time

import numpy as np

from ..config import Cfg
from . import messages as msg
from .bus import Bus
from .state_estimator import StateEstimator


class Agent:
    def __init__(self, cfg: Cfg, se: StateEstimator, command_profile,
                 bus: Bus, default_dof_pos: np.ndarray,
                 p_gains: np.ndarray, d_gains: np.ndarray):
        self.cfg = cfg
        self.se = se
        self.command_profile = command_profile
        self.bus = bus
        self.dt = cfg.control.decimation * cfg.sim.dt      # 0.02 -> 50 Hz
        self.num_commands = cfg.commands.num_commands
        self.num_obs = cfg.env.num_observations
        self.default_dof_pos = np.asarray(default_dof_pos)
        self.p_gains = np.asarray(p_gains)
        self.d_gains = np.asarray(d_gains)

        osc = cfg.obs_scales
        self.commands_scale = np.array(
            [osc.lin_vel, osc.lin_vel, osc.ang_vel, osc.body_height_cmd,
             osc.gait_freq_cmd, osc.gait_phase_cmd, osc.gait_phase_cmd,
             osc.gait_phase_cmd, osc.gait_phase_cmd, osc.footswing_height_cmd,
             osc.body_pitch_cmd, osc.body_roll_cmd, osc.stance_width_cmd,
             osc.stance_length_cmd, osc.aux_reward_cmd][: self.num_commands])

        self.commands = np.zeros(self.num_commands)
        self.actions = np.zeros(12)
        self.last_actions = np.zeros(12)
        self.gait_indices = 0.0
        self.clock_inputs = np.zeros(4)
        self.joint_pos_target = np.zeros(12)
        self.torques = np.zeros(12)
        self.timestep = 0
        self.time = time.time()

    # -- observation (lcm_agent.py:125-190) --------------------------------
    def get_obs(self) -> np.ndarray:
        cfg = self.cfg
        gravity = self.se.get_gravity_vector()
        cmds, reset_timer = self.command_profile.get_command(
            self.timestep * self.dt)
        self.commands[:] = cmds[: self.num_commands]
        if reset_timer:
            self.gait_indices = 0.0
        dof_pos = self.se.get_dof_pos()
        dof_vel = self.se.get_dof_vel()

        parts = [gravity,
                 self.commands * self.commands_scale,
                 (dof_pos - self.default_dof_pos) * cfg.obs_scales.dof_pos,
                 dof_vel * cfg.obs_scales.dof_vel,
                 np.clip(self.actions, -cfg.normalization.clip_actions,
                         cfg.normalization.clip_actions)]
        if cfg.env.observe_two_prev_actions:
            parts.append(self.last_actions)
        if cfg.env.observe_clock_inputs:
            parts.append(self.clock_inputs)
        ob = np.concatenate(parts)
        if cfg.env.observe_vel:
            ob = np.concatenate([
                self.se.get_body_linear_vel() * cfg.obs_scales.lin_vel,
                self.se.get_body_angular_vel() * cfg.obs_scales.ang_vel, ob])
        if cfg.env.observe_yaw:
            ob = np.concatenate([ob, [self.se.get_yaw()]])
        if cfg.env.observe_contact_states:
            ob = np.concatenate([ob, self.se.get_contact_state()])
        assert ob.shape[0] == self.num_obs, (ob.shape, self.num_obs)
        return ob.astype(np.float32)

    # -- action path (lcm_agent.py:193-217) --------------------------------
    def publish_action(self, action: np.ndarray, hard_reset: bool = False):
        cfg = self.cfg
        target = action[:12] * cfg.control.action_scale
        target[[0, 3, 6, 9]] *= cfg.control.hip_scale_reduction
        target = target + self.default_dof_pos
        self.joint_pos_target = target
        sdk_target = target[self.se.JOINT_IDXS]
        m = msg.PdTauTargets(
            q_des=list(sdk_target), qd_des=[0.0] * 12,
            kp=list(self.p_gains[self.se.JOINT_IDXS]),
            kd=list(self.d_gains[self.se.JOINT_IDXS]),
            tau_ff=[0.0] * 12, id=-1 if hard_reset else 0)
        self.torques = ((target - self.se.get_dof_pos()) * self.p_gains
                        - self.se.get_dof_vel() * self.d_gains)
        self.bus.publish(msg.CHANNEL_PD_TARGETS, m.encode())

    def reset(self):
        self.actions = np.zeros(12)
        self.time = time.time()
        self.timestep = 0
        return self.get_obs()

    def step(self, actions: np.ndarray, hard_reset: bool = False):
        cfg = self.cfg
        self.last_actions = self.actions.copy()
        self.actions = np.clip(np.asarray(actions).reshape(-1)[:12],
                               -cfg.normalization.clip_actions,
                               cfg.normalization.clip_actions)
        self.publish_action(self.actions, hard_reset=hard_reset)
        time.sleep(max(self.dt - (time.time() - self.time), 0))
        self.time = time.time()
        obs = self.get_obs()

        # software gait clock (lcm_agent.py:238-263)
        freq, phase, offset, bound = (self.commands[4], self.commands[5],
                                      self.commands[6], self.commands[7])
        self.gait_indices = (self.gait_indices + self.dt * freq) % 1.0
        gi = self.gait_indices
        foot_idx = [gi + phase + offset + bound, gi + offset,
                    gi + bound, gi + phase]
        self.clock_inputs = np.sin(2 * np.pi * np.array(foot_idx))

        self.timestep += 1
        infos = {
            "joint_pos": self.se.get_dof_pos()[None, :],
            "joint_vel": self.se.get_dof_vel()[None, :],
            "joint_pos_target": self.joint_pos_target[None, :],
            "torques": self.torques[None, :],
            "contact_state": self.se.get_contact_state()[None, :],
            "body_linear_vel": self.se.get_body_linear_vel()[None, :],
            "body_angular_vel": self.se.get_body_angular_vel()[None, :],
        }
        if self.se.use_cameras:
            # (reference lcm_agent.py:266-297)
            for name in self.se.camera_names:
                infos[f"camera_image_{name}"] = self.se.camera_images[name]
        return obs, None, None, infos
