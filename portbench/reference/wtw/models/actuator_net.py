"""Frozen copy of walk_these_ways_tpu_torch/models/actuator_net.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Learned Go1 actuator (motor) model.

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

# the committed weights at the repository's root, read by the program too
_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))),
    "resources", "actuator_nets", "unitree_go1.npz")


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


def load(path: str = _DEFAULT_PATH, device="cuda") -> ActuatorNetParams:
    z = np.load(path)
    return ActuatorNetParams(z["w0"], z["b0"], z["w1"], z["b1"], z["w2"],
                             z["b2"], device=device)
