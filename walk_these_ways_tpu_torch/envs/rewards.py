"""CoRL (walk-these-ways / MoB) reward terms, pure functions on tensors.

Each term reproduces the corresponding ``_reward_<name>`` method of the
reference reward container (reference: go1_gym/envs/rewards/corl_rewards.py,
file:line cited per term).  Terms take a `RewardCtx` of batched tensors and
return an unscaled (N,) reward; scaling by `scale * dt` and the
positive/negative split happen in the env (legged_robot.py:263-300).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Cfg
from ..ops import quat as qops


class RewardCtx(NamedTuple):
    cfg: Cfg
    dt: float
    commands: torch.Tensor              # (N, 15)
    base_pos: torch.Tensor              # (N, 3)
    base_quat: torch.Tensor             # (N, 4)
    base_lin_vel: torch.Tensor          # (N, 3) body frame
    base_ang_vel: torch.Tensor          # (N, 3) body frame
    projected_gravity: torch.Tensor     # (N, 3)
    gravity_vec: torch.Tensor           # (N, 3) unit gravity direction
    dof_pos: torch.Tensor               # (N, 12)
    default_dof_pos: torch.Tensor       # (12,)
    dof_vel: torch.Tensor               # (N, 12)
    last_dof_vel: torch.Tensor
    torques: torch.Tensor               # (N, 12)
    actions: torch.Tensor               # (N, 12)
    last_actions: torch.Tensor
    last_last_actions: torch.Tensor
    joint_pos_target: torch.Tensor
    last_joint_pos_target: torch.Tensor
    last_last_joint_pos_target: torch.Tensor
    contact_forces: torch.Tensor        # (N, 17, 3) report bodies
    foot_velocities: torch.Tensor       # (N, 4, 3)
    prev_foot_velocities: torch.Tensor  # (N, 4, 3)
    foot_positions: torch.Tensor        # (N, 4, 3)
    desired_contact_states: torch.Tensor  # (N, 4)
    foot_indices: torch.Tensor          # (N, 4) raw gait phases in [0,1)
    last_contacts: torch.Tensor         # (N, 4) bool
    dof_pos_limits: torch.Tensor        # (12, 2) soft limits
    # report indices of the feet and of thigh + calf: index tensors on the
    # device (the env's), or tuples
    feet_indices: "torch.Tensor | tuple"
    penalised_indices: "torch.Tensor | tuple"


def tracking_lin_vel(c: RewardCtx):
    # corl_rewards.py:15-18
    err = torch.sum(torch.square(c.commands[:, :2] - c.base_lin_vel[:, :2]), dim=1)
    return torch.exp(-err / c.cfg.rewards.tracking_sigma)


def tracking_ang_vel(c: RewardCtx):
    # corl_rewards.py:20-23
    err = torch.square(c.commands[:, 2] - c.base_ang_vel[:, 2])
    return torch.exp(-err / c.cfg.rewards.tracking_sigma_yaw)


def lin_vel_z(c: RewardCtx):
    # corl_rewards.py:25-27
    return torch.square(c.base_lin_vel[:, 2])


def ang_vel_xy(c: RewardCtx):
    # corl_rewards.py:29-31
    return torch.sum(torch.square(c.base_ang_vel[:, :2]), dim=1)


def orientation(c: RewardCtx):
    # corl_rewards.py:33-35
    return torch.sum(torch.square(c.projected_gravity[:, :2]), dim=1)


def torques(c: RewardCtx):
    # corl_rewards.py:37-39
    return torch.sum(torch.square(c.torques), dim=1)


def dof_acc(c: RewardCtx):
    # corl_rewards.py:41-43
    return torch.sum(torch.square((c.last_dof_vel - c.dof_vel) / c.dt), dim=1)


def action_rate(c: RewardCtx):
    # corl_rewards.py:45-47
    return torch.sum(torch.square(c.last_actions - c.actions), dim=1)


def collision(c: RewardCtx):
    # corl_rewards.py:49-52 (thigh/calf contacts)
    f = c.contact_forces[:, c.penalised_indices, :]
    return torch.sum(1.0 * (torch.linalg.norm(f, dim=-1) > 0.1), dim=1)


def dof_pos_limits(c: RewardCtx):
    # corl_rewards.py:54-58
    out = -torch.clamp(c.dof_pos - c.dof_pos_limits[:, 0], max=0.0)
    out = out + torch.clamp(c.dof_pos - c.dof_pos_limits[:, 1], min=0.0)
    return torch.sum(out, dim=1)


def jump(c: RewardCtx):
    # corl_rewards.py:60-65
    body_height = c.base_pos[:, 2]
    target = c.commands[:, 3] + c.cfg.rewards.base_height_target
    return -torch.square(body_height - target)


def tracking_contacts_shaped_force(c: RewardCtx):
    # corl_rewards.py:67-75
    foot_forces = torch.linalg.norm(c.contact_forces[:, c.feet_indices, :], dim=-1)
    desired = c.desired_contact_states
    r = -(1 - desired) * (
        1 - torch.exp(-foot_forces ** 2 / c.cfg.rewards.gait_force_sigma))
    return torch.sum(r, dim=1) / 4


def tracking_contacts_shaped_vel(c: RewardCtx):
    # corl_rewards.py:77-84
    foot_speed = torch.linalg.norm(c.foot_velocities, dim=2)
    desired = c.desired_contact_states
    r = -desired * (1 - torch.exp(-foot_speed ** 2 / c.cfg.rewards.gait_vel_sigma))
    return torch.sum(r, dim=1) / 4


def dof_pos(c: RewardCtx):
    # corl_rewards.py:86-88
    return torch.sum(torch.square(c.dof_pos - c.default_dof_pos[None, :]), dim=1)


def dof_vel(c: RewardCtx):
    # corl_rewards.py:90-92
    return torch.sum(torch.square(c.dof_vel), dim=1)


def action_smoothness_1(c: RewardCtx):
    # corl_rewards.py:94-98
    diff = torch.square(c.joint_pos_target - c.last_joint_pos_target)
    diff = diff * (c.last_actions != 0)
    return torch.sum(diff, dim=1)


def action_smoothness_2(c: RewardCtx):
    # corl_rewards.py:100-105
    diff = torch.square(c.joint_pos_target - 2 * c.last_joint_pos_target
                      + c.last_last_joint_pos_target)
    diff = diff * (c.last_actions != 0) * (c.last_last_actions != 0)
    return torch.sum(diff, dim=1)


def feet_slip(c: RewardCtx):
    # corl_rewards.py:107-113 (uses the step's contact OR'd with last step's)
    contact = c.contact_forces[:, c.feet_indices, 2] > 1.0
    contact_filt = torch.logical_or(contact, c.last_contacts)
    foot_speed_sq = torch.square(
        torch.linalg.norm(c.foot_velocities[:, :, 0:2], dim=2))
    return torch.sum(contact_filt * foot_speed_sq, dim=1)


def feet_contact_vel(c: RewardCtx):
    # corl_rewards.py:115-120
    near_ground = c.foot_positions[:, :, 2] < 0.03
    foot_speed_sq = torch.square(torch.linalg.norm(c.foot_velocities, dim=2))
    return torch.sum(near_ground * foot_speed_sq, dim=1)


def feet_contact_forces(c: RewardCtx):
    # corl_rewards.py:122-125
    f = torch.linalg.norm(c.contact_forces[:, c.feet_indices, :], dim=-1)
    return torch.sum(torch.clamp(f - c.cfg.rewards.max_contact_force, min=0.0), dim=1)


def feet_clearance_cmd_linear(c: RewardCtx):
    # corl_rewards.py:127-132
    phases = 1 - torch.abs(1.0 - torch.clamp(c.foot_indices * 2.0 - 1.0, 0.0, 1.0) * 2.0)
    foot_height = c.foot_positions[:, :, 2]
    target = c.commands[:, 9:10] * phases + 0.02   # +2cm foot radius
    rew = torch.square(target - foot_height) * (1 - c.desired_contact_states)
    return torch.sum(rew, dim=1)


def feet_impact_vel(c: RewardCtx):
    # corl_rewards.py:134-140
    prev_vz = c.prev_foot_velocities[:, :, 2]
    contact = torch.linalg.norm(c.contact_forces[:, c.feet_indices, :], dim=-1) > 1.0
    return torch.sum(contact * torch.square(torch.clamp(prev_vz, -100.0, 0.0)), dim=1)


def orientation_control(c: RewardCtx):
    # corl_rewards.py:148-159
    roll_cmd, pitch_cmd = c.commands[:, 11], c.commands[:, 10]
    # the x and y axes made on the device: no host data in the step
    axes = torch.eye(3, device=roll_cmd.device)
    quat_roll = qops.quat_from_angle_axis(-roll_cmd, axes[0])
    quat_pitch = qops.quat_from_angle_axis(-pitch_cmd, axes[1])
    desired_q = qops.quat_mul(quat_roll, quat_pitch)
    desired_pg = qops.quat_rotate_inverse(desired_q, c.gravity_vec)
    return torch.sum(
        torch.square(c.projected_gravity[:, :2] - desired_pg[:, :2]), dim=1)


def raibert_heuristic(c: RewardCtx):
    # corl_rewards.py:161-202
    cur = c.foot_positions - c.base_pos[:, None, :]
    inv_yaw = qops.quat_conjugate(c.base_quat)
    steps_body = qops.quat_apply_yaw(inv_yaw[:, None, :], cur)   # (N, 4, 3)
    w = c.commands[:, 12:13]
    ys_nom = torch.cat([w / 2, -w / 2, w / 2, -w / 2], dim=1)
    ln = c.commands[:, 13:14]
    xs_nom = torch.cat([ln / 2, ln / 2, -ln / 2, -ln / 2], dim=1)
    phases = torch.abs(1.0 - c.foot_indices * 2.0) * 1.0 - 0.5
    freq = c.commands[:, 4]
    x_vel_des = c.commands[:, 0:1]
    yaw_vel_des = c.commands[:, 2:3]
    y_vel_des = yaw_vel_des * ln / 2
    ys_off = phases * y_vel_des * (0.5 / freq[:, None])
    ys_off = torch.cat([ys_off[:, 0:2], -1.0 * ys_off[:, 2:4]], dim=1)
    xs_off = phases * x_vel_des * (0.5 / freq[:, None])
    desired = torch.stack([xs_nom + xs_off, ys_nom + ys_off], dim=2)
    err = torch.abs(desired - steps_body[:, :, 0:2])
    return torch.sum(torch.square(err), dim=(1, 2))


TERMS = {
    "tracking_lin_vel": tracking_lin_vel,
    "tracking_ang_vel": tracking_ang_vel,
    "lin_vel_z": lin_vel_z,
    "ang_vel_xy": ang_vel_xy,
    "orientation": orientation,
    "torques": torques,
    "dof_acc": dof_acc,
    "action_rate": action_rate,
    "collision": collision,
    "dof_pos_limits": dof_pos_limits,
    "jump": jump,
    "tracking_contacts_shaped_force": tracking_contacts_shaped_force,
    "tracking_contacts_shaped_vel": tracking_contacts_shaped_vel,
    "dof_pos": dof_pos,
    "dof_vel": dof_vel,
    "action_smoothness_1": action_smoothness_1,
    "action_smoothness_2": action_smoothness_2,
    "feet_slip": feet_slip,
    "feet_contact_vel": feet_contact_vel,
    "feet_contact_forces": feet_contact_forces,
    "feet_clearance_cmd_linear": feet_clearance_cmd_linear,
    "feet_impact_vel": feet_impact_vel,
    "orientation_control": orientation_control,
    "raibert_heuristic": raibert_heuristic,
}


def active_terms(cfg: Cfg):
    """Nonzero-scale terms, in declaration order (mirrors
    _prepare_reward_function, legged_robot.py:1385-1412).  The reference
    warns on a nonzero scale with no _reward_<name> implementation; here
    that is a hard error so a typo'd or unimplemented term cannot silently
    train as a no-op."""
    names = []
    for name, scale in cfg.reward_scales.items():
        if scale == 0.0 or name == "termination":
            continue
        if name not in TERMS:
            raise NotImplementedError(
                f"reward '{name}' has nonzero scale {scale} but no "
                f"implementation in rewards.TERMS (available: "
                f"{sorted(TERMS)})")
        names.append(name)
    return tuple(names)
