"""The port's model formats (models/mjcf.py, models/urdf.py) against the JAX
package's on the same models and files.

The MJCF generator is string code on the numpy arrays of a RobotModel, so
the port's XML must equal the JAX package's byte for byte; the state
mapping is numpy on both sides, so its arrays must be equal; the URDF
loader must give a RobotModel whose every field equals the JAX loader's.
"""
import dataclasses
import os

import numpy as np
import pytest

from walk_these_ways_tpu.models import mjcf as j_mjcf
from walk_these_ways_tpu.models import robot as j_robot
from walk_these_ways_tpu.models import urdf as j_urdf

from walk_these_ways_tpu_torch.models import mjcf as t_mjcf
from walk_these_ways_tpu_torch.models import robot as t_robot
from walk_these_ways_tpu_torch.models import urdf as t_urdf

from test_urdf import REF_URDF       # the reference's go1.urdf, where present


def assert_models_equal(a, b):
    """Every field of two RobotModels equal (arrays exactly, with dtype)."""
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


# ---------------------------------------------------------------------------
# MJCF
# ---------------------------------------------------------------------------

MODELS = {"go1": (j_robot.go1, t_robot.go1),
          "box": (lambda: j_robot.box(half_extents=(0.1, 0.1, 0.05), mass=1.0),
                  lambda: t_robot.box(half_extents=(0.1, 0.1, 0.05), mass=1.0))}
MJCF_ARGS = [
    dict(),
    dict(mu=0.5, timestep=0.001),
    dict(mu=0.4, gravity=(3.6, 0.0, -9.1), timestep=0.0005),
    dict(payload=1.7, with_limits=True),
    dict(mu=0.8, payload=-0.5, gravity=(0.0, 0.0, -9.8), with_limits=True,
         solref="0.01 1", solimp="0.95 0.99 0.001"),
]


@pytest.mark.parametrize("args", MJCF_ARGS,
                         ids=[str(i) for i in range(len(MJCF_ARGS))])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_go1_mjcf_is_byte_equal(name, args):
    j_make, t_make = MODELS[name]
    j_xml = j_mjcf.go1_mjcf(j_make(), **args)
    t_xml = t_mjcf.go1_mjcf(t_make(), **args)
    assert t_xml.encode() == j_xml.encode()


def test_rotmat_xyzw_is_equal():
    rs = np.random.RandomState(0)
    for _ in range(8):
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(t_mjcf._rotmat_xyzw(q),
                                      j_mjcf._rotmat_xyzw(q))


def _engine_state(seed, nj):
    rs = np.random.RandomState(seed)
    quat = rs.randn(4)
    quat /= np.linalg.norm(quat)
    return (rs.randn(3), quat, rs.randn(3), rs.randn(3), rs.randn(nj),
            rs.randn(nj))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_mj_state_mapping_is_equal(name):
    """set_mj_state then get_mj_state on one MjData, through both packages:
    the same qpos / qvel written (quaternion wxyz, angular velocity in the
    body frame) and the same arrays read back."""
    mujoco = pytest.importorskip("mujoco")
    j_make, t_make = MODELS[name]
    m = t_make()
    mjm = mujoco.MjModel.from_xml_string(t_mjcf.go1_mjcf(m))
    for seed in range(3):
        st = _engine_state(seed, m.nj)
        got = {}
        for pkg, mod in (("jax", j_mjcf), ("torch", t_mjcf)):
            mjd = mujoco.MjData(mjm)
            mod.set_mj_state(mjd, *st)
            got[pkg] = (np.array(mjd.qpos), np.array(mjd.qvel),
                        mod.get_mj_state(mjd))
        np.testing.assert_array_equal(got["torch"][0], got["jax"][0])
        np.testing.assert_array_equal(got["torch"][1], got["jax"][1])
        for a, b in zip(got["torch"][2], got["jax"][2]):
            np.testing.assert_array_equal(a, b)
        # the conventions themselves: MuJoCo's quaternion is wxyz, and the
        # state read back is the state written
        x, y, z, w = st[1]
        np.testing.assert_array_equal(got["torch"][0][3:7], [w, x, y, z])
        for a, b in zip(got["torch"][2], st):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# URDF
# ---------------------------------------------------------------------------

TWO_LINK = """<?xml version="1.0"?>
<robot name="pendulum">
  <link name="world_base">
    <inertial><mass value="1.0"/><origin xyz="0 0 0"/>
      <inertia ixx="0.1" ixy="0" ixz="0" iyy="0.1" iyz="0" izz="0.1"/></inertial>
  </link>
  <joint name="j1" type="revolute">
    <origin xyz="0 0 -0.1"/><parent link="world_base"/><child link="arm"/>
    <axis xyz="0 1 0"/>
    <limit effort="10" lower="-1" upper="1" velocity="5"/>
  </joint>
  <link name="arm">
    <inertial><mass value="0.5"/><origin xyz="0 0 -0.2"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.001"/></inertial>
    <collision><origin xyz="0 0 -0.4"/><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
</robot>"""

# every branch of the loader: a box trunk with rotated inertia, a fixed joint
# collapsed (the imu) and two kept as report bodies (dont_collapse: the
# feet), siblings out of alphabetical order, rotated joint origins,
# cylinder and capsule proxies, a joint without limit or axis
BRANCHY = """<?xml version="1.0"?>
<robot name="branchy">
  <link name="trunk">
    <inertial><mass value="4.0"/><origin xyz="0.01 0 0.02" rpy="0.1 0 0.2"/>
      <inertia ixx="0.05" ixy="0.001" ixz="0" iyy="0.2" iyz="0.002" izz="0.22"/></inertial>
    <collision><origin xyz="0 0 0" rpy="0 0 0.3"/><geometry><box size="0.3 0.2 0.1"/></geometry></collision>
  </link>
  <joint name="imu_joint" type="fixed">
    <origin xyz="0 0 0.05"/><parent link="trunk"/><child link="imu"/>
  </joint>
  <link name="imu">
    <inertial><mass value="0.1"/><origin xyz="0 0 0"/>
      <inertia ixx="0.0001" iyy="0.0001" izz="0.0001"/></inertial>
  </link>
  <joint name="R_hip" type="revolute">
    <origin xyz="0.1 -0.05 0" rpy="0 0 0.1"/><parent link="trunk"/><child link="R_leg"/>
    <axis xyz="1 0 0"/><limit effort="20" lower="-0.8" upper="0.8" velocity="30"/>
  </joint>
  <joint name="L_hip" type="revolute">
    <origin xyz="0.1 0.05 0"/><parent link="trunk"/><child link="L_leg"/>
    <axis xyz="0 1 0"/>
  </joint>
  <link name="L_leg">
    <inertial><mass value="0.6"/><origin xyz="0 0 -0.1"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.0003"/></inertial>
    <collision><origin xyz="0 0 -0.1" rpy="0 1.5708 0"/><geometry><cylinder radius="0.02" length="0.2"/></geometry></collision>
  </link>
  <link name="R_leg">
    <inertial><mass value="0.6"/><origin xyz="0 0 -0.1"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.0003"/></inertial>
    <collision><origin xyz="0 0 -0.1"/><geometry><capsule radius="0.015" length="0.15"/></geometry></collision>
  </link>
  <joint name="L_foot_fixed" type="fixed" dont_collapse="true">
    <origin xyz="0 0 -0.2"/><parent link="L_leg"/><child link="L_foot"/>
  </joint>
  <link name="L_foot">
    <inertial><mass value="0.05"/><origin xyz="0 0 0"/>
      <inertia ixx="0.00001" iyy="0.00001" izz="0.00001"/></inertial>
    <collision><origin xyz="0 0 0"/><geometry><sphere radius="0.021"/></geometry></collision>
  </link>
  <joint name="R_foot_fixed" type="fixed" dont_collapse="true">
    <origin xyz="0 0 -0.2"/><parent link="R_leg"/><child link="R_foot"/>
  </joint>
  <link name="R_foot">
    <collision><origin xyz="0 0 0"/><geometry><sphere radius="0.019"/></geometry></collision>
  </link>
</robot>"""


@pytest.mark.skipif(not os.path.exists(REF_URDF), reason="reference URDF absent")
def test_go1_urdf_matches_the_jax_loader_and_the_baked_model():
    m = t_urdf.load(REF_URDF)
    assert_models_equal(m, j_urdf.load(REF_URDF))
    g = t_robot.go1()
    assert m.nb == g.nb and m.nj == g.nj
    assert m.joint_names == g.joint_names
    np.testing.assert_allclose(m.mass, g.mass, atol=1e-9)
    np.testing.assert_array_equal(m.crba_conn, g.crba_conn)


@pytest.mark.parametrize("urdf,foot", [(TWO_LINK, "foot"),
                                       (BRANCHY, "foot")],
                         ids=["two_link", "branchy"])
def test_synthetic_urdf_every_field_equal(tmp_path, urdf, foot):
    p = tmp_path / "robot.urdf"
    p.write_text(urdf)
    m = t_urdf.load(str(p), foot_name=foot)
    assert_models_equal(m, j_urdf.load(str(p), foot_name=foot))


def test_synthetic_two_link(tmp_path):
    """tests/test_urdf.py's case, through the port's loader."""
    p = tmp_path / "robot.urdf"
    p.write_text(TWO_LINK)
    m = t_urdf.load(str(p))
    assert m.nb == 2 and m.nj == 1
    assert m.mass[0] == 1.0 and m.mass[1] == 0.5
    np.testing.assert_allclose(m.joint_anchor[0], [0, 0, -0.1])
    assert m.cp_radius[-1] == 0.03


def test_branchy_urdf_layout(tmp_path):
    """Siblings in alphabetical order, fixed links merged, the kept feet as
    report bodies of their legs, the box's 8 corners as radius-0 points."""
    p = tmp_path / "robot.urdf"
    p.write_text(BRANCHY)
    m = t_urdf.load(str(p))
    assert m.body_names == ("base", "L_leg", "R_leg")
    assert m.joint_names == ("L_hip", "R_hip")
    assert m.report_body_names == ("base", "L_leg", "L_foot", "R_leg",
                                   "R_foot")
    np.testing.assert_array_equal(m.feet_report_indices, [2, 4])
    np.testing.assert_array_equal(m.foot_body, [1, 2])
    assert m.mass[0] == pytest.approx(4.1)
    assert int((m.cp_radius == 0).sum()) == 8
    assert m.foot_radius == pytest.approx(0.019)
    assert m.dof_effort[0] == 1e9 and m.dof_effort[1] == 20.0
