"""Policy-quality evaluation metrics and domain-randomisation sweep presets.

Counterpart of the JAX package's learn/eval_metrics.py (reference:
go1_gym_learn/eval_metrics/metrics.py:1-99 `METRICS_FNS` and
go1_gym_learn/eval_metrics/domain_randomization.py:141-148 `DR_SETTINGS`).
A metric is a function of (env, env_state, policy, obs_dict) -> (N,) tensor
(or (N, k), or a dict of (N,) tensors); `policy` is anything with the
student's `actor_mean(obs_history)` and `adaptation_forward(obs_history)`:
an `ActorCritic`, or the export that `scripts/play.load_policy` reads.
A DR preset is a DomainRandCfg to `dataclasses.replace` into a config.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..config import DomainRandCfg
from ..envs import rewards as rew_mod
from ..ops import quat as qops


def _base_vels(env_state):
    q = env_state.phys.base_quat
    return (qops.quat_rotate_inverse(q, env_state.phys.base_lin_vel),
            qops.quat_rotate_inverse(q, env_state.phys.base_ang_vel))


def lin_vel_rmsd(env, s, policy, obs):
    v, _ = _base_vels(s)
    return torch.abs(v[:, 0] - s.commands[:, 0])


def ang_vel_rmsd(env, s, policy, obs):
    _, w = _base_vels(s)
    return torch.abs(w[:, 2] - s.commands[:, 2])


def lin_vel_x(env, s, policy, obs):
    v, _ = _base_vels(s)
    return v[:, 0]


def ang_vel_yaw(env, s, policy, obs):
    _, w = _base_vels(s)
    return w[:, 2]


def base_height(env, s, policy, obs):
    return s.phys.base_pos[:, 2]


def max_torques(env, s, policy, obs):
    return torch.amax(torch.abs(s.torques), dim=1)


def power_consumption(env, s, policy, obs):
    return torch.sum(s.torques * s.phys.qd, dim=1)


def cost_of_transport(env, s, policy, obs):
    """P / (m g v) (reference metrics.py:40-47)."""
    P = power_consumption(env, s, policy, obs)
    m = float(env.model.mass.sum()) + s.payloads
    v, _ = _base_vels(s)
    speed = torch.linalg.norm(v[:, :2], dim=1)
    return P / (m * 9.8 * torch.clamp(speed, min=1e-6))


def froude_number(env, s, policy, obs):
    v = lin_vel_x(env, s, policy, obs)
    return v ** 2 / (9.8 * 0.30)


def adaptation_loss(env, s, policy, obs):
    pred = policy.adaptation_forward(obs["obs_history"])
    return torch.mean(torch.square(pred - obs["privileged_obs"]), dim=1)


def termination(env, s, policy, obs):
    return (s.episode_length == 0).to(torch.float32)


def auxiliary_rewards(env, s, policy, obs):
    """Per-term scaled reward dict (reference metrics.py:66-73 loops
    env.reward_functions; here every active term is a function of the
    env's RewardCtx)."""
    ctx = env.make_reward_ctx(s)
    return {name: rew_mod.TERMS[name](ctx) * scale
            for name, scale in zip(env.reward_names, env.reward_scales)}


def privileged_obs(env, s, policy, obs):
    """reference metrics.py:79-80"""
    return obs["privileged_obs"]


def latents(env, s, policy, obs):
    """The policy's estimate of the privileged latent (reference
    metrics.py:83-84 uses the RMA env_factor_encoder; the cse variant's
    analog is the adaptation module's prediction from the obs history)."""
    return policy.adaptation_forward(obs["obs_history"])


METRICS_FNS = dict(
    lin_vel_rmsd=lin_vel_rmsd,
    ang_vel_rmsd=ang_vel_rmsd,
    lin_vel_x=lin_vel_x,
    ang_vel_yaw=ang_vel_yaw,
    base_height=base_height,
    max_torques=max_torques,
    power_consumption=power_consumption,
    cost_of_transport=cost_of_transport,
    froude_number=froude_number,
    adaptation_loss=adaptation_loss,
    termination=termination,
    auxiliary_rewards=auxiliary_rewards,
    privileged_obs=privileged_obs,
    latents=latents,
)


# -- DR sweep presets (domain_randomization.py) -----------------------------

def _dr(**kw) -> DomainRandCfg:
    base = DomainRandCfg(
        randomize_friction=True, randomize_restitution=True,
        randomize_base_mass=True, randomize_com_displacement=True,
        randomize_motor_strength=True,
        randomize_Kp_factor=False, randomize_Kd_factor=False,
        push_robots=False,
    )
    return replace(base, **kw)


DR_SETTINGS = dict(
    rand_regular=_dr(
        friction_range=(0.05, 4.5), restitution_range=(0.0, 1.0),
        added_mass_range=(-1.0, 3.0), com_displacement_range=(-0.1, 0.1),
        motor_strength_range=(0.9, 1.1)),
    rand_large=_dr(
        friction_range=(0.04, 6.0), restitution_range=(0.0, 1.0),
        added_mass_range=(-1.5, 4.0), com_displacement_range=(-0.13, 0.13),
        motor_strength_range=(0.88, 1.12)),
    static_low=_dr(
        friction_range=(0.05, 0.06), restitution_range=(0.0, 0.01),
        added_mass_range=(-1.0, -0.99), com_displacement_range=(-0.1, -0.09),
        motor_strength_range=(0.9, 0.91)),
    static_medium=_dr(
        friction_range=(1.0, 1.01), restitution_range=(0.5, 0.51),
        added_mass_range=(0.0, 0.01), com_displacement_range=(0.0, 0.01),
        motor_strength_range=(1.0, 1.01)),
    static_high=_dr(
        friction_range=(4.49, 4.5), restitution_range=(0.99, 1.0),
        added_mass_range=(2.99, 3.0), com_displacement_range=(0.09, 0.1),
        motor_strength_range=(1.09, 1.1)),
    only_base_mass=_dr(
        randomize_friction=False, randomize_restitution=False,
        randomize_com_displacement=False, randomize_motor_strength=False,
        randomize_base_mass=True, added_mass_range=(-1.0, 3.0)),
)


@torch.no_grad()
def evaluate_policy(env, policy, generator: torch.Generator,
                    num_steps: int = 250,
                    metric_names=("lin_vel_rmsd", "ang_vel_rmsd",
                                  "power_consumption", "cost_of_transport")):
    """Roll the student policy's mean out from `env.reset(generator)` and
    return each metric's mean over envs and steps (the analog of the
    reference's eval loop).  Every random draw comes from `generator` (on
    the env's device); the per-step means are summed on the device and
    read once."""
    state, obs = env.reset(generator)
    sums = torch.zeros(len(metric_names), dtype=torch.float64,
                       device=env.device)
    for _ in range(num_steps):
        actions = policy.actor_mean(obs["obs_history"])
        state, obs, _, _, _ = env.step(state, actions)
        sums += torch.stack([torch.mean(METRICS_FNS[k](env, state, policy,
                                                       obs)).double()
                             for k in metric_names])
    return dict(zip(metric_names, (sums / num_steps).tolist()))
