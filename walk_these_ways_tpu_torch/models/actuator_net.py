"""Learned Go1 actuator (motor) model.

Counterpart of the reference's TorchScript actuator network (reference:
go1_gym/envs/base/legged_robot.py:1238-1258 load + closure,
scripts/actuator_net/utils.py:66-79 architecture: MLP 6->32->32->1 with
softsign activations).  Input per joint: (q_err, q_err_last, q_err_last_last,
qd, qd_last, qd_last_last); output: torque.

Weights are stored as a plain .npz (the network is a hardware-log-fitted
artifact, i.e. data, and is the sim-to-real contract for torque realism).
On the main path the network is evaluated inside the control-step kernel
(ops/megastep.py); this module holds the weights and the plain forward.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "resources", "actuator_nets", "unitree_go1.npz",
)


class ActuatorNetParams(nn.Module):
    """Weights of the actuator MLP, rows = outputs as in the .npz:
    w0 (32, 6), b0 (32,), w1 (32, 32), b1 (32,), w2 (1, 32), b2 (1,)."""

    def __init__(self, w0, b0, w1, b1, w2, b2, device="cuda"):
        super().__init__()
        for name, val in (("w0", w0), ("b0", b0), ("w1", w1), ("b1", b1),
                          ("w2", w2), ("b2", b2)):
            self.register_buffer(
                name, torch.tensor(np.asarray(val), dtype=torch.float32,
                                   device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self, x)


def load(path: str = _DEFAULT_PATH, device="cuda") -> ActuatorNetParams:
    z = np.load(path)
    return ActuatorNetParams(z["w0"], z["b0"], z["w1"], z["b1"], z["w2"],
                             z["b2"], device=device)


def init_random(rng=None, device="cuda") -> ActuatorNetParams:
    """Random-init weights (for tests / training from scratch): numpy's
    RandomState(rng or 0), U[-1/sqrt(fan_in), 1/sqrt(fan_in)] drawn in
    float64 and rounded to float32, in the JAX package's order, so both
    packages start from the same bits."""
    rs = np.random.RandomState(0 if rng is None else rng)

    def lin(o, i):
        lim = 1.0 / np.sqrt(i)
        return (rs.uniform(-lim, lim, (o, i)).astype(np.float32),
                rs.uniform(-lim, lim, (o,)).astype(np.float32))

    w0, b0 = lin(32, 6)
    w1, b1 = lin(32, 32)
    w2, b2 = lin(1, 32)
    return ActuatorNetParams(w0, b0, w1, b1, w2, b2, device=device)


def _softsign(x):
    return x / (1.0 + torch.abs(x))


def apply(params: ActuatorNetParams, x: torch.Tensor) -> torch.Tensor:
    """x: (..., 6) -> torque (...)."""
    h = _softsign(x @ params.w0.T + params.b0)
    h = _softsign(h @ params.w1.T + params.b1)
    return (h @ params.w2.T + params.b2)[..., 0]


def eval_torques(
    params: ActuatorNetParams,
    joint_pos_err, joint_pos_err_last, joint_pos_err_last_last,
    joint_vel, joint_vel_last, joint_vel_last_last,
) -> torch.Tensor:
    """Reference input stacking (legged_robot.py:1242-1251). All (N, 12)."""
    xs = torch.stack(
        [joint_pos_err, joint_pos_err_last, joint_pos_err_last_last,
         joint_vel, joint_vel_last, joint_vel_last_last],
        dim=-1,
    )  # (N, 12, 6)
    return apply(params, xs)
