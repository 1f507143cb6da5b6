"""Load an exported policy and run it on the robot.

Rebuild of the reference deploy entry point (reference:
go1_gym_deploy/scripts/deploy_policy.py:15-77): wires
Bus -> StateEstimator -> RCControllerProfile -> Agent -> HistoryWrapper ->
DeploymentRunner with the student policy from policy_latest.npz.

Run the C++ bridge first (deploy/cpp/udp_bridge.cpp, built by
deploy/bridge.py) on the robot — or with --sim for a loopback test on any
machine:

    python -m walk_these_ways_tpu_torch.deploy.deploy_policy --policy \
        RUN/checkpoints/policy_latest.npz [--port 7667] [--max-steps N]

This is the robot's side of the system and runs in numpy by design: no
torch and no CUDA device on the robot's computer.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..config import Cfg
from ..go1_config import GO1_DEFAULT_JOINT_ANGLES, mob_train_cfg
from ..models.robot import default_dof_pos, go1, pd_gains
from .agent import Agent
from .bus import DEFAULT_PORT, Bus
from .command_profile import RCControllerProfile
from .deployment_runner import DeploymentRunner
from .history_wrapper import HistoryWrapper
from .state_estimator import StateEstimator


def load_student_policy(path: str):
    """Numpy-only student policy (adaptation + actor from policy_latest.npz);
    no torch dependency on the robot.

    Variant-aware: meta/variant 'cse' feeds the actor obs_history+latent;
    'rma' feeds obs+latent (reference ppo/actor_critic.py:38-56).  Older
    artifacts without meta keys are treated as cse with the default MoB
    layer counts."""
    z = np.load(path)
    variant = str(z["meta/variant"]) if "meta/variant" in z else "cse"
    n_adapt = int(z["meta/n_adaptation"]) if "meta/n_adaptation" in z else 3
    n_actor = int(z["meta/n_actor"]) if "meta/n_actor" in z else 4

    def mlp(prefix, n, x):
        for i in range(n):
            x = x @ z[f"{prefix}/w{i}"] + z[f"{prefix}/b{i}"]
            if i < n - 1:
                x = np.where(x > 0, x, np.exp(np.clip(x, None, 0)) - 1)  # ELU
        return x

    def policy(obs_dict):
        hist = np.asarray(obs_dict["obs_history"], dtype=np.float32)
        latent = mlp("adaptation", n_adapt, hist)
        if variant == "rma":
            obs = np.asarray(obs_dict["obs"], dtype=np.float32)
            if obs.ndim == 1:
                obs = obs[None, :]
            body_in = np.concatenate([obs, latent], axis=-1)
        else:
            body_in = np.concatenate([hist, latent], axis=-1)
        action = mlp("actor", n_actor, body_in)
        return action[0]

    return policy


def load_and_run_policy(policy_path: str, cfg: Cfg = None,
                        max_steps: int = 10_000_000,
                        wait_for_button: bool = True,
                        port: int = DEFAULT_PORT,
                        log_root: str = "./deploy_logs"):
    """Run the policy against the bridge on bus `port`; returns the path
    of the deploy log saved at the end."""
    cfg = cfg or mob_train_cfg(num_envs=1)
    model = go1()
    bus = Bus(port=port)
    try:
        se = StateEstimator(bus)
        se.spin()
        profile = RCControllerProfile(dt=cfg.dt, state_estimator=se,
                                      x_scale=1.4, y_scale=0.8,
                                      yaw_scale=1.4)
        # the model's constants as numpy on the host: the robot has no GPU
        ddp = default_dof_pos(model, dict(GO1_DEFAULT_JOINT_ANGLES),
                              device="cpu").numpy()
        p, d = pd_gains(model, dict(cfg.control.stiffness),
                        dict(cfg.control.damping), device="cpu")
        agent = Agent(cfg, se, profile, bus, ddp, p.numpy(), d.numpy())
        wrapped = HistoryWrapper(agent)
        policy = load_student_policy(policy_path)
        runner = DeploymentRunner(se, wrapped, policy, log_root=log_root,
                                  wait_for_button=wait_for_button)
        return runner.run(max_steps=max_steps)
    finally:
        bus.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="runs/latest/checkpoints/policy_latest.npz")
    ap.add_argument("--max-steps", type=int, default=10_000_000)
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    a = ap.parse_args()
    load_and_run_policy(a.policy, max_steps=a.max_steps, port=a.port)
