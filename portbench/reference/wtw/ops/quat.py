"""Frozen copy of walk_these_ways_tpu_torch/ops/quat.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Quaternion and rotation ops (PyTorch).

Convention: quaternions are stored ``(x, y, z, w)`` — the IsaacGym layout the
reference uses for ``root_states[:, 3:7]`` (reference:
go1_gym/envs/base/legged_robot.py:107) — so observation layouts and checkpoints
stay layout-compatible.

All functions broadcast over arbitrary leading batch dimensions.
"""
from __future__ import annotations


import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Normalize along the last axis."""
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, xyzw layout."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (active rotation)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q (world -> body for a body-to-world q)."""
    return quat_apply(quat_conjugate(q), v)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """angle: (...,), axis: (..., 3) or (3,). Returns (..., 4) xyzw."""
    axis = normalize(torch.broadcast_to(
        axis.to(angle.device), tuple(angle.shape) + (3,)))
    half = 0.5 * angle
    s = torch.sin(half)[..., None]
    return torch.cat([axis * s, torch.cos(half)[..., None]], dim=-1)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q.

    Matches reference go1_gym/utils/math_utils.py:12-16 (zero the x/y
    components, renormalize, rotate).
    """
    q_yaw = torch.cat([torch.zeros_like(q[..., :2]), q[..., 2:]], dim=-1)
    return quat_apply(normalize(q_yaw), v)
