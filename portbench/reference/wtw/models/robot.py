"""Frozen copy of walk_these_ways_tpu_torch/models/robot.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Robot model: kinematic tree + inertial parameters (numpy constants).

Explicit replacement for the reference's IsaacGym asset pipeline
(reference: go1_gym/envs/base/legged_robot.py:1481-1590 `_create_envs`, which
loads go1.urdf through `gym.load_asset`).  Instead of an opaque engine handle
we build an explicit, fully-inspectable model:

- 13 *dynamics bodies* (floating trunk + 4 legs x {hip, thigh, calf}); the
  foot (kept un-collapsed in the reference via ``dont_collapse="true"``,
  go1.urdf) is rigidly composited into the calf for dynamics but tracked as a
  separate *report body* so contact-force tensors keep the reference's
  17-body layout (base, then per leg: hip, thigh, calf, foot; legs ordered
  FL, FR, RL, RR — IsaacGym's alphabetical child ordering, which is what makes
  the deploy-side joint map [3,4,5,0,1,2,9,10,11,6,7,8] in
  go1_gym_deploy/utils/cheetah_state_estimator.py:55 work out).
- 12 revolute DoFs in leg order (hip_x, thigh_y, calf_y) x (FL, FR, RL, RR).
- a set of collision proxy points (trunk box corners, thigh/calf spheres,
  foot spheres) used by the penalty contact solver and for the
  per-report-body contact force tensor.

All topology index sets (ancestor masks, subtree masks, CRBA pair tables) are
precomputed as numpy constants so the batched dynamics code and the CUDA
control-step kernel unroll over static masks.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static robot description. All arrays are numpy (trace-time constants)."""

    name: str
    # -- dynamics bodies -------------------------------------------------
    nb: int                      # number of dynamics bodies (incl. floating base)
    parent: np.ndarray           # (nb,) int, parent body index; -1 for base
    body_names: Tuple[str, ...]
    mass: np.ndarray             # (nb,)
    com: np.ndarray              # (nb, 3)  local frame
    inertia: np.ndarray          # (nb, 3, 3) about com, local frame
    # -- joints ----------------------------------------------------------
    nj: int                      # number of revolute dofs (12)
    joint_names: Tuple[str, ...]
    joint_body: np.ndarray       # (nj,) child dynamics body moved by each dof
    joint_anchor: np.ndarray     # (nj, 3) joint origin in parent frame
    joint_axis: np.ndarray       # (nj, 3) axis in child (== parent) frame
    dof_lower: np.ndarray        # (nj,)
    dof_upper: np.ndarray        # (nj,)
    dof_effort: np.ndarray       # (nj,) torque limit
    dof_vel_limit: np.ndarray    # (nj,)
    # -- report bodies (reference 17-body layout) -------------------------
    num_report_bodies: int
    report_body_names: Tuple[str, ...]
    feet_report_indices: np.ndarray   # (4,) indices into report bodies
    # feet as FK targets: dynamics body + local offset (= foot fixed joint)
    foot_body: np.ndarray        # (4,) dynamics body (calf) per foot
    foot_offset: np.ndarray      # (4, 3)
    foot_radius: float
    # -- contact proxy points ---------------------------------------------
    cp_body: np.ndarray          # (P,) dynamics body of each contact point
    cp_offset: np.ndarray        # (P, 3) local offset
    cp_radius: np.ndarray        # (P,)
    cp_report_body: np.ndarray   # (P,) report body each point's force accrues to
    cp_is_foot: np.ndarray       # (P,) bool, one per foot point (4 total)
    # -- derived topology tables ------------------------------------------
    nv: int                      # generalized velocity dim = 6 + nj
    anc_dof_body: np.ndarray     # (nv, nb) 1 if dof on path root->body
    subtree: np.ndarray          # (nb, nb) subtree[i, j]=1 if j in subtree(i)
    crba_conn: np.ndarray        # (nv, nv) 1 if dofs on a common path
    crba_body: np.ndarray        # (nv, nv) dynamics body of the deeper dof

    def __hash__(self):
        return hash((self.name, self.nb, self.nj))

    def __eq__(self, other):
        return isinstance(other, RobotModel) and self.name == other.name


def _merge_inertia(m1, c1, I1, m2, c2, I2):
    """Composite of two rigid bodies expressed in the same frame."""
    m = m1 + m2
    c = (m1 * c1 + m2 * c2) / m

    def shift(mi, ci, Ii):
        d = ci - c
        return Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, shift(m1, c1, I1) + shift(m2, c2, I2)


def _build_topology(nb, parent, nj, joint_body):
    nv = 6 + nj
    # subtree masks
    subtree = np.zeros((nb, nb), dtype=np.float32)
    for b in range(nb):
        x = b
        while x >= 0:
            subtree[x, b] = 1.0
            x = parent[x]
    # ancestor dofs per body: root dofs 0..5 touch everything
    anc = np.zeros((nv, nb), dtype=np.float32)
    anc[:6, :] = 1.0
    for d in range(nj):
        anc[6 + d, :] = subtree[joint_body[d], :]
    # CRBA pair tables
    conn = np.zeros((nv, nv), dtype=np.float32)
    kbody = np.zeros((nv, nv), dtype=np.int32)

    def dof_depth(d):
        if d < 6:
            return 0
        depth, x = 0, joint_body[d - 6]
        while x >= 0:
            depth += 1
            x = parent[x]
        return depth

    def dof_body_of(d):
        return 0 if d < 6 else joint_body[d - 6]

    for i in range(nv):
        for j in range(nv):
            bi, bj = dof_body_of(i), dof_body_of(j)
            # connected iff one body is in the subtree of the other
            if subtree[bi, bj] or subtree[bj, bi]:
                conn[i, j] = 1.0
                kbody[i, j] = bi if dof_depth(i) >= dof_depth(j) else bj
    return nv, anc, subtree, conn, kbody


# ---------------------------------------------------------------------------
# Unitree Go1 constants
#
# Physical parameters of the Unitree Go1 Edu (publicly documented robot;
# values match the go1 URDF the reference trains with — masses/inertias/
# kinematic offsets cited per body below).
# ---------------------------------------------------------------------------

_GO1_TRUNK = dict(
    mass=4.801,  # trunk 4.8 + imu 0.001 (fixed-joint collapsed, exact merge)
    com=np.array([0.01160526557, 0.00442220579, 0.000106692356]),
    inertia=np.array(
        [
            [1.623582510802e-02, 5.912255699624e-04, 7.151858382754e-06],
            [5.912255699624e-04, 3.660860801516e-02, 2.052372237205e-05],
            [7.151858382754e-06, 2.052372237205e-05, 4.479967363503e-02],
        ]
    ),
)
# hip: mirrored com/products of inertia per leg (fx = front sign on x,
# s = side sign on y: FL=(+,+), FR=(+,-), RL=(-,+), RR=(-,-))
_HIP_MASS = 0.510299
_HIP_I = np.array(
    [
        [0.00030528937, 7.788013e-06, 2.2016e-07],
        [7.788013e-06, 0.000590894859, 1.7175e-08],
        [2.2016e-07, 1.7175e-08, 0.000396594572],
    ]
)
_THIGH_MASS = 0.898919
_THIGH_I = np.array(
    [
        [0.005395867678, -1.02809e-07, 0.000337529085],
        [-1.02809e-07, 0.005142451046, 5.816563e-06],
        [0.000337529085, 5.816563e-06, 0.00102478732],
    ]
)
_CALF_MASS = 0.158015
_CALF_COM = np.array([0.006286, 0.001307, -0.122269])
_CALF_I = np.array(
    [
        [0.003607648222, 1.494971e-06, -0.000132778525],
        [1.494971e-06, 0.003626771492, -2.8638535e-05],
        [-0.000132778525, -2.8638535e-05, 3.5148003e-05],
    ]
)
_FOOT_MASS = 0.06
_FOOT_I = np.eye(3) * 9.6e-06
_FOOT_OFFSET = np.array([0.0, 0.0, -0.213])
_FOOT_RADIUS = 0.02

_HIP_OFFSET_X = 0.1881
_HIP_OFFSET_Y = 0.04675
_THIGH_OFFSET_Y = 0.08
_CALF_OFFSET_Z = -0.213

_LEGS = ("FL", "FR", "RL", "RR")
_LEG_SIGNS = {"FL": (1, 1), "FR": (1, -1), "RL": (-1, 1), "RR": (-1, -1)}

_HIP_LIMIT = (-0.802851455917, 0.802851455917, 33.5, 50.0)
_THIGH_LIMIT = (-1.0471975512, 4.18879020479, 33.5, 28.0)
_CALF_LIMIT = (-2.69653369433, -0.916297857297, 33.5, 28.0)


def go1() -> RobotModel:
    """Build the Go1 model (the equivalent of loading go1.urdf)."""
    body_names = ["base"]
    parent = [-1]
    mass = [_GO1_TRUNK["mass"]]
    com = [_GO1_TRUNK["com"]]
    inertia = [_GO1_TRUNK["inertia"]]

    joint_names, joint_body, joint_anchor, joint_axis = [], [], [], []
    limits = []
    report_names = ["base"]
    foot_body, foot_offset = [], []

    for leg in _LEGS:
        fx, s = _LEG_SIGNS[leg]
        base_idx = 0
        # hip -----------------------------------------------------------
        hip_idx = len(body_names)
        body_names.append(f"{leg}_hip")
        parent.append(base_idx)
        mass.append(_HIP_MASS)
        # com mirrors: x flips with front/back; y carries the OPPOSITE of the
        # side sign (go1.urdf: FR_hip com y = +0.00074, FL_hip = -0.00074)
        com.append(np.array([-0.00541 * fx, -0.00074 * s, 6e-06]))
        Ih = _HIP_I.copy()
        # products of inertia mirror with the reflection signs
        Ih[0, 1] = Ih[1, 0] = _HIP_I[0, 1] * (-fx * s)
        Ih[0, 2] = Ih[2, 0] = _HIP_I[0, 2] * fx
        Ih[1, 2] = Ih[2, 1] = _HIP_I[1, 2] * (-s)
        inertia.append(Ih)
        joint_names.append(f"{leg}_hip_joint")
        joint_body.append(hip_idx)
        joint_anchor.append(np.array([_HIP_OFFSET_X * fx, _HIP_OFFSET_Y * s, 0.0]))
        joint_axis.append(np.array([1.0, 0.0, 0.0]))
        limits.append(_HIP_LIMIT)
        # thigh ---------------------------------------------------------
        thigh_idx = len(body_names)
        body_names.append(f"{leg}_thigh")
        parent.append(hip_idx)
        mass.append(_THIGH_MASS)
        com.append(np.array([-0.003468, -0.018947 * s, -0.032736]))
        It = _THIGH_I.copy()
        It[0, 1] = It[1, 0] = _THIGH_I[0, 1] * (-s)
        It[1, 2] = It[2, 1] = _THIGH_I[1, 2] * (-s)
        inertia.append(It)
        joint_names.append(f"{leg}_thigh_joint")
        joint_body.append(thigh_idx)
        joint_anchor.append(np.array([0.0, _THIGH_OFFSET_Y * s, 0.0]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        limits.append(_THIGH_LIMIT)
        # calf (+ foot composited) --------------------------------------
        calf_idx = len(body_names)
        body_names.append(f"{leg}_calf")
        parent.append(thigh_idx)
        m, c, I = _merge_inertia(
            _CALF_MASS, _CALF_COM, _CALF_I, _FOOT_MASS, _FOOT_OFFSET, _FOOT_I
        )
        mass.append(m)
        com.append(c)
        inertia.append(I)
        joint_names.append(f"{leg}_calf_joint")
        joint_body.append(calf_idx)
        joint_anchor.append(np.array([0.0, 0.0, _CALF_OFFSET_Z]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        limits.append(_CALF_LIMIT)

        report_names += [f"{leg}_hip", f"{leg}_thigh", f"{leg}_calf", f"{leg}_foot"]
        foot_body.append(calf_idx)
        foot_offset.append(_FOOT_OFFSET)

    nb = len(body_names)
    nj = len(joint_names)
    parent = np.array(parent, dtype=np.int32)
    joint_body_arr = np.array(joint_body, dtype=np.int32)

    # report-body bookkeeping: base=0, per leg l: hip=1+4l, thigh=2+4l,
    # calf=3+4l, foot=4+4l
    feet_report = np.array([4, 8, 12, 16], dtype=np.int32)
    dyn_to_report = {0: 0}
    for l in range(4):
        dyn_to_report[1 + 3 * l] = 1 + 4 * l
        dyn_to_report[2 + 3 * l] = 2 + 4 * l
        dyn_to_report[3 + 3 * l] = 3 + 4 * l

    # ---- contact proxy points -----------------------------------------
    cp_body, cp_offset, cp_radius, cp_report, cp_is_foot = [], [], [], [], []
    # trunk collision box 0.3762 x 0.0935 x 0.114 -> 8 corners
    hx, hy, hz = 0.3762 / 2, 0.0935 / 2, 0.114 / 2
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                cp_body.append(0)
                cp_offset.append(np.array([sx * hx, sy * hy, sz * hz]))
                cp_radius.append(0.0)
                cp_report.append(0)
                cp_is_foot.append(False)
    for l, leg in enumerate(_LEGS):
        thigh_idx = 2 + 3 * l
        calf_idx = 3 + 3 * l
        # thigh collision box spans z in [-0.213, 0]
        for z in (-0.07, -0.16):
            cp_body.append(thigh_idx)
            cp_offset.append(np.array([0.0, 0.0, z]))
            cp_radius.append(0.017)
            cp_report.append(dyn_to_report[thigh_idx])
            cp_is_foot.append(False)
        # calf collision box spans z in [-0.213, 0]
        for z in (-0.07, -0.16):
            cp_body.append(calf_idx)
            cp_offset.append(np.array([0.0, 0.0, z]))
            cp_radius.append(0.01)
            cp_report.append(dyn_to_report[calf_idx])
            cp_is_foot.append(False)
        # foot sphere
        cp_body.append(calf_idx)
        cp_offset.append(_FOOT_OFFSET)
        cp_radius.append(_FOOT_RADIUS)
        cp_report.append(int(feet_report[l]))
        cp_is_foot.append(True)

    nv, anc, subtree, conn, kbody = _build_topology(nb, parent, nj, joint_body_arr)

    lims = np.array(limits)
    return RobotModel(
        name="go1",
        nb=nb,
        parent=parent,
        body_names=tuple(body_names),
        mass=np.array(mass, dtype=np.float64),
        com=np.stack(com).astype(np.float64),
        inertia=np.stack(inertia).astype(np.float64),
        nj=nj,
        joint_names=tuple(joint_names),
        joint_body=joint_body_arr,
        joint_anchor=np.stack(joint_anchor).astype(np.float64),
        joint_axis=np.stack(joint_axis).astype(np.float64),
        dof_lower=lims[:, 0],
        dof_upper=lims[:, 1],
        dof_effort=lims[:, 2],
        dof_vel_limit=lims[:, 3],
        num_report_bodies=17,
        report_body_names=tuple(report_names),
        feet_report_indices=feet_report,
        foot_body=np.array(foot_body, dtype=np.int32),
        foot_offset=np.stack(foot_offset).astype(np.float64),
        foot_radius=_FOOT_RADIUS,
        cp_body=np.array(cp_body, dtype=np.int32),
        cp_offset=np.stack(cp_offset).astype(np.float64),
        cp_radius=np.array(cp_radius, dtype=np.float64),
        cp_report_body=np.array(cp_report, dtype=np.int32),
        cp_is_foot=np.array(cp_is_foot, dtype=bool),
        nv=nv,
        anc_dof_body=anc,
        subtree=subtree,
        crba_conn=conn,
        crba_body=kbody,
    )


def default_dof_pos(model: RobotModel, default_joint_angles: dict,
                    device="cuda") -> torch.Tensor:
    """Resolve {joint-name: angle} to the model's dof order.

    Mirrors reference legged_robot.py:1220-1236 (substring match like the
    reference's stiffness lookup is not needed here — names are exact).
    """
    out = np.zeros(model.nj)
    for i, name in enumerate(model.joint_names):
        out[i] = default_joint_angles[name]
    return torch.tensor(out, dtype=torch.float32, device=device)


def pd_gains(model: RobotModel, stiffness: dict, damping: dict,
             device="cuda"):
    """Per-dof P/D gains by substring match (reference legged_robot.py:1226-1233)."""
    p = np.zeros(model.nj)
    d = np.zeros(model.nj)
    for i, name in enumerate(model.joint_names):
        for key, val in stiffness.items():
            if key in name:
                p[i] = val
                d[i] = damping[key]
    return (torch.tensor(p, dtype=torch.float32, device=device),
            torch.tensor(d, dtype=torch.float32, device=device))
