"""Generic URDF loader -> RobotModel.

The reference loads robots through IsaacGym's opaque asset pipeline
(reference: go1_gym/envs/base/legged_robot.py:1490-1520, asset options
legged_robot_config.py:220-241).  This is the open equivalent: parse the
URDF, collapse fixed joints (honoring ``dont_collapse="true"`` like the
reference's collapse_fixed_joints option), merge composited inertias, order
sibling subtrees alphabetically (IsaacGym's ordering — what makes the
reference's deploy-side joint index map come out right), and emit the same
`RobotModel` the hand-built go1() factory produces.

Collision geometry becomes contact-proxy points: spheres keep their center +
radius; boxes contribute their 8 corners (radius 0); cylinders/capsules get
end+mid spheres of the cylinder radius.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from .robot import RobotModel, _build_topology, _merge_inertia, _rpy_matrix


def _vec(s: Optional[str], default="0 0 0"):
    return np.array([float(x) for x in (s or default).split()])


def _parse_inertial(link) -> Optional[dict]:
    it = link.find("inertial")
    if it is None:
        return None
    o = it.find("origin")
    com = _vec(o.get("xyz") if o is not None else None)
    rpy = _vec(o.get("rpy") if o is not None else None)
    R = _rpy_matrix(*rpy)
    I = it.find("inertia")
    Im = np.array([
        [float(I.get("ixx")), float(I.get("ixy", 0)), float(I.get("ixz", 0))],
        [float(I.get("ixy", 0)), float(I.get("iyy")), float(I.get("iyz", 0))],
        [float(I.get("ixz", 0)), float(I.get("iyz", 0)), float(I.get("izz"))],
    ])
    return dict(mass=float(it.find("mass").get("value")),
                com=com, inertia=R @ Im @ R.T)


def _parse_collisions(link) -> List[dict]:
    out = []
    for col in link.findall("collision"):
        o = col.find("origin")
        xyz = _vec(o.get("xyz") if o is not None else None)
        rpy = _vec(o.get("rpy") if o is not None else None)
        R = _rpy_matrix(*rpy)
        g = col.find("geometry")
        for geom in g:
            if geom.tag == "sphere":
                out.append(dict(kind="sphere", offset=xyz,
                                radius=float(geom.get("radius"))))
            elif geom.tag == "box":
                size = _vec(geom.get("size"))
                for sx in (-1, 1):
                    for sy in (-1, 1):
                        for sz in (-1, 1):
                            corner = xyz + R @ (size / 2 * [sx, sy, sz])
                            out.append(dict(kind="point", offset=corner,
                                            radius=0.0))
            elif geom.tag in ("cylinder", "capsule"):
                r = float(geom.get("radius"))
                h = float(geom.get("length", geom.get("height", "0.1")))
                axis = R @ np.array([0.0, 0.0, 1.0])
                for t in (-h / 2, 0.0, h / 2):
                    out.append(dict(kind="sphere", offset=xyz + t * axis,
                                    radius=r))
    return out


def load(path: str, foot_name: str = "foot") -> RobotModel:
    tree = ET.parse(path)
    root = tree.getroot()
    links = {l.get("name"): l for l in root.findall("link")}
    joints = list(root.findall("joint"))

    children: Dict[str, List] = {name: [] for name in links}
    parent_of: Dict[str, tuple] = {}
    for j in joints:
        p = j.find("parent").get("link")
        c = j.find("child").get("link")
        children[p].append((c, j))
        parent_of[c] = (p, j)
    roots = [n for n in links if n not in parent_of]
    assert len(roots) == 1, f"expected a single root link, got {roots}"

    # ---- pass 1: collapse fixed joints into "dynamic bodies" -------------
    # each dynamic body = a movable link + all fixed-descendant links merged
    body_names: List[str] = []
    parent_idx: List[int] = []
    inertial: List[dict] = []
    joint_meta: List[dict] = []            # per movable joint
    report_names: List[str] = []
    report_parent_body: List[int] = []     # dynamics body of each report body
    report_offset: List[np.ndarray] = []   # offset of report frame in body
    collisions: List[dict] = []            # kind/offset/radius/body/report

    def merge_fixed(body_idx, link_name, offset, R):
        """Merge link_name (at offset/R in body frame) into body body_idx;
        recurse through fixed children; spawn report bodies for
        dont_collapse subtrees."""
        link = links[link_name]
        it = _parse_inertial(link)
        if it is not None:
            m0 = inertial[body_idx]
            com_w = offset + R @ it["com"]
            I_w = R @ it["inertia"] @ R.T
            m, c, I = _merge_inertia(
                m0["mass"], m0["com"], m0["inertia"], it["mass"], com_w, I_w)
            inertial[body_idx] = dict(mass=m, com=c, inertia=I)
        for geom in _parse_collisions(link):
            collisions.append(dict(
                offset=offset + R @ geom["offset"], radius=geom["radius"],
                body=body_idx, report=report_parent_body_of[link_name]))
        for child_name, j in sorted(children[link_name], key=lambda x: x[0]):
            typ = j.get("type")
            o = j.find("origin")
            off_c = offset + R @ _vec(o.get("xyz") if o is not None else None)
            R_c = R @ _rpy_matrix(*_vec(o.get("rpy") if o is not None else None))
            if typ == "fixed":
                if j.get("dont_collapse") == "true":
                    report_names.append(child_name)
                    report_parent_body.append(body_idx)
                    report_offset.append(off_c)
                    report_parent_body_of[child_name] = len(report_names) - 1
                else:
                    report_parent_body_of[child_name] = \
                        report_parent_body_of[link_name]
                merge_fixed(body_idx, child_name, off_c, R_c)
            else:
                build_body(body_idx, child_name, j, off_c, R_c)

    def build_body(parent_body, link_name, joint, anchor, R_anchor):
        idx = len(body_names)
        body_names.append(link_name)
        parent_idx.append(parent_body)
        inertial.append(dict(mass=0.0, com=np.zeros(3), inertia=np.zeros((3, 3))))
        report_names.append(link_name)
        report_parent_body.append(idx)
        report_offset.append(np.zeros(3))
        report_parent_body_of[link_name] = len(report_names) - 1
        lim = joint.find("limit")
        ax = joint.find("axis")
        joint_meta.append(dict(
            name=joint.get("name"), body=idx,
            anchor=anchor,
            axis=R_anchor @ _vec(ax.get("xyz") if ax is not None else "1 0 0"),
            lower=float(lim.get("lower", "-1e9")) if lim is not None else -1e9,
            upper=float(lim.get("upper", "1e9")) if lim is not None else 1e9,
            effort=float(lim.get("effort", "1e9")) if lim is not None else 1e9,
            velocity=float(lim.get("velocity", "1e9")) if lim is not None else 1e9,
        ))
        merge_fixed(idx, link_name, np.zeros(3), np.eye(3))

    # root dynamic body
    report_parent_body_of: Dict[str, int] = {}
    body_names.append("base")
    parent_idx.append(-1)
    inertial.append(dict(mass=0.0, com=np.zeros(3), inertia=np.zeros((3, 3))))
    report_names.append("base")
    report_parent_body.append(0)
    report_offset.append(np.zeros(3))
    report_parent_body_of[roots[0]] = 0
    merge_fixed(0, roots[0], np.zeros(3), np.eye(3))

    nb = len(body_names)
    nj = len(joint_meta)
    joint_body = np.array([j["body"] for j in joint_meta], dtype=np.int32)
    # anchors are stored world-of-parent-chain composed; convert to
    # parent-frame offsets: in URDF chains without rotated revolute origins
    # (the go1 case) anchor composition is already parent-frame.
    nv, anc, subtree, conn, kbody = _build_topology(nb, parent_idx, nj, joint_body)

    feet = [i for i, n in enumerate(report_names) if foot_name in n]
    foot_body = [report_parent_body[i] for i in feet]
    foot_off = [report_offset[i] for i in feet]
    foot_radius = 0.02
    for c in collisions:
        if c["report"] in feet and c["radius"] > 0:
            foot_radius = c["radius"]

    cp_body = np.array([c["body"] for c in collisions], dtype=np.int32)
    cp_offset = np.stack([c["offset"] for c in collisions])
    cp_radius = np.array([c["radius"] for c in collisions])
    cp_report = np.array([c["report"] for c in collisions], dtype=np.int32)
    cp_is_foot = np.array([c["report"] in feet and c["radius"] > 0
                           for c in collisions])

    lims = joint_meta
    return RobotModel(
        name=root.get("name", "robot"),
        nb=nb,
        parent=np.array(parent_idx, dtype=np.int32),
        body_names=tuple(body_names),
        mass=np.array([b["mass"] for b in inertial]),
        com=np.stack([b["com"] for b in inertial]),
        inertia=np.stack([b["inertia"] for b in inertial]),
        nj=nj,
        joint_names=tuple(j["name"] for j in joint_meta),
        joint_body=joint_body,
        joint_anchor=np.stack([j["anchor"] for j in joint_meta]),
        joint_axis=np.stack([j["axis"] for j in joint_meta]),
        dof_lower=np.array([j["lower"] for j in lims]),
        dof_upper=np.array([j["upper"] for j in lims]),
        dof_effort=np.array([j["effort"] for j in lims]),
        dof_vel_limit=np.array([j["velocity"] for j in lims]),
        num_report_bodies=len(report_names),
        report_body_names=tuple(report_names),
        feet_report_indices=np.array(feet, dtype=np.int32),
        foot_body=np.array(foot_body, dtype=np.int32),
        foot_offset=np.stack(foot_off) if foot_off else np.zeros((0, 3)),
        foot_radius=foot_radius,
        cp_body=cp_body,
        cp_offset=cp_offset,
        cp_radius=cp_radius,
        cp_report_body=cp_report,
        cp_is_foot=cp_is_foot,
        nv=nv,
        anc_dof_body=anc,
        subtree=subtree,
        crba_conn=conn,
        crba_body=kbody,
    )
