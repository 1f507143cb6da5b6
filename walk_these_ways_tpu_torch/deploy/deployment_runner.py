"""Robot deployment control loop.

Rebuild of the reference DeploymentRunner (reference:
go1_gym_deploy/utils/deployment_runner.py:125-222): operator-gated
calibration walk to the nominal pose (:65-122), 50 Hz policy loop with
per-step logging, and the |roll|,|pitch| > 1.6 rad emergency recalibrate
(:160-162).
"""
from __future__ import annotations

import time

import numpy as np

from .logger import MultiLogger


class DeploymentRunner:
    def __init__(self, se, agent_wrapped, policy, log_root: str = "./deploy_logs",
                 wait_for_button: bool = True):
        self.se = se
        self.agent = agent_wrapped          # HistoryWrapper(Agent)
        self.policy = policy                # fn(obs_dict) -> (12,) actions
        self.logger = MultiLogger(log_root)
        self.wait_for_button = wait_for_button
        self.button_states = np.zeros(4)

    def calibrate(self, wait: bool = True, low: bool = False):
        """Slow interpolation walk from the current pose to nominal
        (reference deployment_runner.py:65-122)."""
        agent = self.agent
        if hasattr(agent, "agent"):
            inner = agent.agent
        else:
            inner = agent
        if wait and self.wait_for_button:
            print("Press R2 to calibrate (waiting for button)...")
            while self.se.get_buttons()[2] == 0:
                time.sleep(0.05)
        final_goal = (np.zeros(12) if not low
                      else np.array([0., 0.3, -0.7] * 4))
        nominal = inner.default_dof_pos
        cur = self.se.get_dof_pos()
        # action-space error (inverse of action scaling)
        cfg = inner.cfg
        target_sequence = []
        target = (cur - nominal).copy()
        while np.max(np.abs(target - final_goal)) > 0.01:
            target -= np.clip(target - final_goal, -0.05, 0.05)
            target_sequence.append(target.copy())
        for target in target_sequence:
            action = target / cfg.control.action_scale
            hips = [0, 3, 6, 9]
            action[hips] /= cfg.control.hip_scale_reduction
            inner.step(action)
        print("Calibration complete.")

    def run(self, max_steps: int = 10_000_000, logging: bool = True):
        """The policy loop for `max_steps` steps; returns the path of the
        log it saves at the end."""
        self.calibrate(wait=True)
        obs = self.agent.reset()
        for step in range(max_steps):
            action = self.policy(obs)
            obs, rew, done, info = self.agent.step(action)
            if logging:
                self.logger.log("hardware_closed_loop", info)
            rpy = self.se.get_rpy()
            if abs(rpy[0]) > 1.6 or abs(rpy[1]) > 1.6:
                print("Emergency: bad orientation — recalibrating")
                self.calibrate(wait=False, low=True)
                obs = self.agent.reset()
            # button-gated log save (reference :178-199)
            buttons = self.se.get_buttons()
            if buttons[1] and self.button_states[1] == 0:
                self.logger.save()
            self.button_states = buttons
        return self.logger.save()
