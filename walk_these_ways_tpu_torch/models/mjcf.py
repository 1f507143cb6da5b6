"""MuJoCo MJCF generation + state mapping for physics cross-validation.

The reference's physics authority is PhysX inside IsaacGym (reference:
go1_gym/envs/base/legged_robot.py:74-81 `gym.simulate`, solver config
legged_robot_config.py:402-421), which cannot run in this environment.
MuJoCo is available and serves as the *independent oracle* for our engine
(physics/engine.py): the MJCF here is generated from the very same
`RobotModel` instance the engine integrates, so masses, inertias, joint
frames, and collision proxies agree by construction, and any trajectory
disagreement is attributable to the solvers, not the model data.

Conventions bridged (ours <-> MuJoCo):
- quaternions: ours xyzw, MuJoCo wxyz;
- free-joint angular velocity: ours world-frame, MuJoCo body-frame;
- free-joint linear velocity: both world-frame at the body-frame origin.

Collision model: same proxy set as the engine — foot/calf/thigh spheres at
the engine's cp_offset/cp_radius, the trunk as the box whose corners are
the engine's 8 trunk contact points.  Self-collision is disabled
(contype/conaffinity), matching the engine's point-vs-terrain-only model.
"""
from __future__ import annotations

import io

import numpy as np

from .robot import RobotModel


def _fmt(x) -> str:
    if np.ndim(x) == 0:
        return f"{float(x):.17g}"
    return " ".join(f"{float(v):.17g}" for v in np.asarray(x).ravel())


def go1_mjcf(model: RobotModel, mu: float = 1.0, timestep: float = 0.001,
             solref: str = "0.02 1", solimp: str = "0.9 0.95 0.001",
             gravity=(0.0, 0.0, -9.81), payload: float = 0.0,
             with_limits: bool = False) -> str:
    """Generate the Go1 MJCF from a RobotModel.

    mu: contact friction coefficient for every robot<->ground pair (the
    engine's combined mu is 0.5*(dyn.friction+1); pass the combined value
    here and set dyn.friction = 2*mu-1 on the engine side).
    payload: extra mass added to the trunk (engine DynamicsParams.payload).
    with_limits: emit hard joint limits (the engine uses soft one-sided
    limit springs instead; keep False for parity tests that stay inside
    the range).
    """
    out = io.StringIO()
    w = out.write
    w(f'<mujoco model="{model.name}">\n')
    w(f'  <option timestep="{timestep}" gravity="{_fmt(gravity)}"'
      f' cone="elliptic" integrator="Euler"/>\n')
    w('  <default>\n')
    w(f'    <geom condim="3" friction="{mu} 0 0" solref="{solref}"'
      f' solimp="{solimp}" contype="2" conaffinity="1"/>\n')
    w('    <joint damping="0" armature="0" frictionloss="0"/>\n')
    w('  </default>\n')
    w('  <worldbody>\n')
    w(f'    <geom name="floor" type="plane" size="50 50 1" contype="1"'
      f' conaffinity="2" friction="{mu} 0 0"/>\n')

    # joint per child body (our tree: every non-base body has exactly one)
    body_joint = {int(model.joint_body[j]): j for j in range(model.nj)}
    # per-body geoms from the engine's contact proxies
    body_geoms: dict[int, list[str]] = {b: [] for b in range(model.nb)}
    trunk_pts = model.cp_offset[model.cp_body == 0]
    if trunk_pts.shape[0] == 8:
        half = np.abs(trunk_pts).max(axis=0)
        body_geoms[0].append(
            f'<geom name="trunk_box" type="box" size="{_fmt(half)}"/>')
    for p in range(model.cp_body.shape[0]):
        b = int(model.cp_body[p])
        if b == 0:
            continue
        r = float(model.cp_radius[p])
        body_geoms[b].append(
            f'<geom name="cp{p}" type="sphere" size="{r}"'
            f' pos="{_fmt(model.cp_offset[p])}"/>')

    def emit_body(b: int, indent: str):
        name = model.body_names[b]
        if b == 0:
            w(f'{indent}<body name="{name}" pos="0 0 0.5">\n')
            w(f'{indent}  <freejoint name="root"/>\n')
        else:
            j = body_joint[b]
            w(f'{indent}<body name="{name}"'
              f' pos="{_fmt(model.joint_anchor[j])}">\n')
            rng = (f' range="{_fmt(model.dof_lower[j])}'
                   f' {_fmt(model.dof_upper[j])}" limited="true"'
                   if with_limits else ' limited="false"')
            w(f'{indent}  <joint name="{model.joint_names[j]}" type="hinge"'
              f' axis="{_fmt(model.joint_axis[j])}"{rng}/>\n')
        m = float(model.mass[b]) + (payload if b == 0 else 0.0)
        I = model.inertia[b] * (m / float(model.mass[b]) if b == 0 else 1.0)
        full = [I[0, 0], I[1, 1], I[2, 2], I[0, 1], I[0, 2], I[1, 2]]
        w(f'{indent}  <inertial pos="{_fmt(model.com[b])}" mass="{m:.17g}"'
          f' fullinertia="{_fmt(full)}"/>\n')
        for g in body_geoms[b]:
            w(f'{indent}  {g}\n')
        for c in range(model.nb):
            if int(model.parent[c]) == b:
                emit_body(c, indent + "  ")
        w(f'{indent}</body>\n')

    emit_body(0, "    ")
    w('  </worldbody>\n')
    w('  <actuator>\n')
    for j in range(model.nj):
        w(f'    <motor name="m_{model.joint_names[j]}"'
          f' joint="{model.joint_names[j]}" gear="1"'
          f' ctrlrange="-1000 1000"/>\n')
    w('  </actuator>\n')
    w('</mujoco>\n')
    return out.getvalue()


# ---------------------------------------------------------------------------
# state mapping (numpy; operates on env 0 of a batched PhysicsState)
# ---------------------------------------------------------------------------


def _rotmat_xyzw(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def set_mj_state(mjd, base_pos, base_quat_xyzw, lin_vel_w, ang_vel_w, q, qd):
    """Write our engine's state (single env, numpy) into mjData."""
    base_quat_xyzw = np.asarray(base_quat_xyzw, dtype=np.float64)
    mjd.qpos[:3] = np.asarray(base_pos)
    x, y, z, w = base_quat_xyzw
    mjd.qpos[3:7] = [w, x, y, z]
    mjd.qpos[7:] = np.asarray(q)
    R = _rotmat_xyzw(base_quat_xyzw)
    mjd.qvel[:3] = np.asarray(lin_vel_w)
    mjd.qvel[3:6] = R.T @ np.asarray(ang_vel_w)   # world -> body frame
    mjd.qvel[6:] = np.asarray(qd)


def get_mj_state(mjd):
    """Read mjData into our conventions: (pos, quat_xyzw, lin_w, ang_w,
    q, qd)."""
    pos = np.array(mjd.qpos[:3])
    w, x, y, z = mjd.qpos[3:7]
    quat = np.array([x, y, z, w])
    R = _rotmat_xyzw(quat)
    lin = np.array(mjd.qvel[:3])
    ang = R @ np.array(mjd.qvel[3:6])             # body -> world frame
    return pos, quat, lin, ang, np.array(mjd.qpos[7:]), np.array(mjd.qvel[6:])
