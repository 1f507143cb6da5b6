"""Quaternion and rotation ops (PyTorch).

Convention: quaternions are stored ``(x, y, z, w)`` — the IsaacGym layout the
reference uses for ``root_states[:, 3:7]`` (reference:
go1_gym/envs/base/legged_robot.py:107) — so observation layouts and checkpoints
stay layout-compatible.

All functions broadcast over arbitrary leading batch dimensions.
"""
from __future__ import annotations

import math

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Normalize along the last axis."""
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def quat_identity(shape=(), device="cuda") -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 3] = 1.0
    return q


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


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw -> (..., 3, 3) rotation matrix (body-to-world)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(tuple(m.shape[:-1]) + (3, 3))


def quat_from_euler_xyz(roll, pitch, yaw):
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


def quat_to_euler_xyz(q: torch.Tensor):
    """Returns (roll, pitch, yaw)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch_arg = torch.clamp(2 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(pitch_arg)
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation with world-frame angular velocity (exp map)."""
    angle = torch.linalg.norm(omega_world, dim=-1)
    # guard the 0/0 at rest; sinc-style limit
    axis = omega_world / torch.clamp(angle, min=1e-9)[..., None]
    dq = quat_from_angle_axis(angle * dt, axis)
    return normalize(quat_mul(dq, q))


def wrap_to_pi(angles: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]; matches reference math_utils.py:20-23."""
    a = torch.remainder(angles, 2 * math.pi)
    return a - 2 * math.pi * (a > math.pi)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(tuple(m.shape[:-1]) + (3, 3))


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """The yaw-only quaternion of q."""
    q_yaw = torch.cat([torch.zeros_like(q[..., :2]), q[..., 2:]], dim=-1)
    return normalize(q_yaw)
