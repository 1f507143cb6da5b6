"""Frozen copy of walk_these_ways_tpu_torch/physics/engine.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Batched articulated rigid-body dynamics.

Counterpart of the JAX package's physics/engine.py.  The copy keeps the
control-step route in reuse mode on flat ground, the default training
path: one control step is one call of ops/megastep.control_step (the
program launches a whole-control-step kernel there; the reference runs its
plain version), with the cache of the entry state built inside it.  The
program's per-substep and dense routes, exact mode and the heightfield
lookups are left out.

- Generalized coordinates: root position (world), root quaternion (xyzw),
  12 joint angles.  Generalized velocity: root linear velocity (world), root
  angular velocity (world), joint rates — the layout IsaacGym reports in
  `root_states` / `dof_state`, so env code matches the reference 1:1.
- Mass matrix via CRBA and bias forces via RNEA(qdd=0), with world-frame
  spatial vectors referenced at each env's base position.
- Contacts: sphere/point vs. flat ground or a heightfield (bilinear
  height and surface normal sampled per point once per cache), solved as
  velocity-level unilateral constraints by row-decoupled projected Jacobi
  in dual space, the friction row clamped to the mu * lambda_n cone.
- Joint limits: stiff one-sided springs; joint velocity clamped to the URDF
  limit.

State containers are NamedTuples of tensors with the env batch leading;
functions return new tuples and do not write into their arguments.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models.robot import RobotModel
from ..ops import contact as pc
from ..ops import megastep as pm


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static solver parameters."""

    dt: float = 0.005                  # physics step    (reference sim.dt)
    num_contact_iters: int = 16        # projected-Jacobi iterations
    contact_enabled: bool = True       # benchmarking knob
    contact_baumgarte: float = 0.2     # position-error feedback factor
    contact_slop: float = 0.002        # penetration tolerance [m]
    # cap on the Baumgarte push-out velocity (reference physx config
    # max_depenetration_velocity, legged_robot_config.py:418)
    max_depenetration_velocity: float = 1.0
    bounce_threshold_velocity: float = 0.5   # reference physx config
    # hard caps on base velocities (PhysX max_linear/angular_velocity
    # analogue), inside the integrator's stable envelope; an env that
    # saturates them is terminated by the envelope guard in envs/go1_env.py
    max_base_lin_vel: float = 15.0
    max_base_ang_vel: float = 25.0
    joint_limit_stiffness: float = 60.0
    joint_limit_damping: float = 2.0
    # Jacobi (simultaneous) impulse updates diverge at relaxation 1.0 when
    # many contacts couple through one body; 0.4 keeps the iteration
    # contractive for this model's worst realistic contact sets
    relaxation: float = 0.4
    armature: float = 0.0
    # run the contact pipeline through the env-minor kernel (name kept from
    # the JAX package so the two parameter sets compare field by field)
    use_pallas_contact: bool = False
    # warm-start contact impulses across the decimation substeps of one
    # control step: later substeps start from the previous substep's
    # impulses and run num_contact_iters_warm iterations
    contact_warm_start: bool = False
    num_contact_iters_warm: int = 6
    # additionally seed the FIRST substep from the impulses carried in the
    # env state from the previous control step
    contact_cross_step_warm_start: bool = False

    def __hash__(self):
        return hash(tuple(dataclasses.asdict(self).values()))


class PhysicsState(NamedTuple):
    """Batched rigid-body state (leading dim = num_envs)."""

    base_pos: torch.Tensor    # (N, 3)
    base_quat: torch.Tensor   # (N, 4) xyzw
    base_lin_vel: torch.Tensor  # (N, 3) world
    base_ang_vel: torch.Tensor  # (N, 3) world
    q: torch.Tensor           # (N, 12)
    qd: torch.Tensor          # (N, 12)


class DynamicsParams(NamedTuple):
    """Per-env randomized dynamics (reference domain_rand section)."""

    payload: torch.Tensor            # (N,) added base mass
    com_displacement: torch.Tensor   # (N, 3) base com shift
    friction: torch.Tensor           # (N,) robot shape friction
    restitution: torch.Tensor        # (N,)
    gravity: torch.Tensor            # (N, 3) full gravity vector (incl. DR)


class ContactInfo(NamedTuple):
    report_forces: torch.Tensor   # (N, 17, 3) net contact force per report body
    foot_forces: torch.Tensor     # (N, 4, 3)


class Terrain(NamedTuple):
    """Heightfield terrain. A zero (2, 2) field is flat ground at z=0.

    `corners` is a corner-packed copy of the field:
    corners[i, j] = (h[i,j], h[i+1,j], h[i,j+1], h[i+1,j+1]), so that a
    bilinear lookup gathers one contiguous 4-vector per query point.
    A heightfield is built with `make_heightfield_terrain`, which makes
    it; flat ground has none."""

    height: torch.Tensor       # (rows, cols) float32 heights [m]
    horizontal_scale: float    # grid pitch [m] (static)
    origin_xy: tuple           # (x0, y0) of grid index (0, 0)  (static)
    corners: "torch.Tensor | None" = None  # (rows-1, cols-1, 4)


def flat_terrain(device="cuda") -> Terrain:
    return Terrain(height=torch.zeros((2, 2), dtype=torch.float32,
                                      device=device),
                   horizontal_scale=1.0, origin_xy=(-1e4, -1e4))


def _contact_inputs(model: RobotModel, dyn: DynamicsParams, Npad: int,
                    block: int):
    """Flat-ground contact operands, env-minor: (rh_t (P, Npad) point
    radii, mu_t (1, Npad), e_t (1, Npad), g_t (3, Npad))."""
    f32 = dyn.gravity.dtype
    P = model.cp_body.shape[0]
    radius = torch.tensor(np.asarray(model.cp_radius), dtype=f32,
                          device=dyn.gravity.device)
    rh_t = radius[:, None].expand(P, Npad).contiguous()
    # ground friction 1.0 averaged in with the robot's shape friction
    mu_t = pc.to_env_minor(0.5 * (dyn.friction[:, None] + 1.0), block)
    e_t = pc.to_env_minor(dyn.restitution[:, None], block)
    g_t = pc.to_env_minor(dyn.gravity, block)
    return rh_t, mu_t, e_t, g_t


def _velocity_bounds(model: RobotModel, params: SimParams, f32, dev):
    """(nv, 1) per-row velocity bounds: base angular, base linear, joints."""
    return torch.cat([
        torch.full((3,), params.max_base_ang_vel, dtype=f32, device=dev),
        torch.full((3,), params.max_base_lin_vel, dtype=f32, device=dev),
        torch.tensor(np.asarray(model.dof_vel_limit), dtype=f32,
                     device=dev)])[:, None].contiguous()


# layout block: the env axis of every env-minor tensor is padded to a
# multiple of this (512-byte rows).  The CUDA kernel's thread block divides it.
MEGASTEP_BLOCK = 128


def megakernel_args(
    model: RobotModel,
    params: SimParams,
    state: PhysicsState,
    dyn: DynamicsParams,
    terrain: "Terrain | None",
    tgt_eff: torch.Tensor,          # (N, D, 12) per-substep effective targets
    strengths: torch.Tensor,        # (N, 12)
    torque_limits: torch.Tensor,    # (12,)
    ctrl,                           # ("actuator_net", blockdiag_weights,
                                    #  (el, ell, vl, vll) each (N, 12)) or
                                    # ("P", kp_eff, kd_eff) each (N, 12)
    decimation: int,
    lam_in_t=None,                  # (P, 3, Npad) cross-step warm seed
    exact: bool = False,
):
    """The (args, kwargs) of the `ops/megastep.control_step` call for one
    control step: the state and the control inputs transposed to env-minor
    and padded to MEGASTEP_BLOCK, the per-dof bound columns, the solver's
    static parameters, and where the dynamics cache comes from:

    - reuse mode (K4, K4b with the actuator network, K4c, K4b-P with P
      control): `entry_inputs` = (payload, COM shift, the terrain on a
      heightfield or None), from which the control step builds the cache
      of the entry state and samples the heightfield under the entry
      contact points itself (the team kernel inside its launch, the plain
      version eagerly);
    - exact mode (K5, K5-P): the payload and COM shift the kernel rebuilds
      the cache from before every substep (`exact_inputs`)."""
    f32 = state.base_pos.dtype
    dev = state.base_pos.device
    block = MEGASTEP_BLOCK
    N = state.base_pos.shape[0]
    heightfield = (terrain is not None
                   and tuple(terrain.height.shape) != (2, 2))
    exact_inputs = entry_inputs = None

    if exact:
        # no cache here: the kernel rebuilds it before every substep.
        # Flat ground only; every contact solve starts cold.
        if heightfield:
            raise ValueError(
                "exact mode in the control-step kernel is flat-ground only; "
                "on a heightfield the env runs exact mode as `decimation` "
                "reuse-mode launches of one substep each")
    em, n_t = None, None
    rh_t, mu_t, e_t, g_t = _contact_inputs(
        model, dyn, -(-N // block) * block, block)
    randomised = (pc.to_env_minor(dyn.payload[:, None], block),
                  pc.to_env_minor(dyn.com_displacement, block))
    if exact:
        exact_inputs = randomised
    else:
        entry_inputs = randomised + (terrain if heightfield else None,)
    q_t = pc.to_env_minor(state.q, block)
    qd_t = pc.to_env_minor(state.qd, block)
    pos_t = pc.to_env_minor(state.base_pos, block)
    quat_t = pc.to_env_minor(state.base_quat, block)
    lin_t = pc.to_env_minor(state.base_lin_vel, block)
    ang_t = pc.to_env_minor(state.base_ang_vel, block)
    tgt_t = pc.to_env_minor(tgt_eff, block)          # (D, 12, Npad)
    strengths_t = pc.to_env_minor(strengths, block)

    if ctrl[0] == "P":
        _, kp_eff, kd_eff = ctrl
        ctrl_inputs = (pc.to_env_minor(kp_eff, block),
                       pc.to_env_minor(kd_eff, block))
    else:
        _, weights, hists = ctrl
        ctrl_inputs = tuple(weights) + tuple(
            pc.to_env_minor(h, block) for h in hists)

    vlim = _velocity_bounds(model, params, f32, dev)
    tlim = torch.as_tensor(torque_limits, dtype=f32,
                           device=dev)[:, None].contiguous()
    qlo = torch.tensor(np.asarray(model.dof_lower), dtype=f32,
                       device=dev)[:, None]
    qhi = torch.tensor(np.asarray(model.dof_upper), dtype=f32,
                       device=dev)[:, None]

    args = (em, rh_t, mu_t, e_t, g_t, n_t,
            q_t, qd_t, pos_t, quat_t, lin_t, ang_t,
            tgt_t, strengths_t, ctrl_inputs,
            vlim, tlim, qlo, qhi, lam_in_t)
    kwargs = dict(
        model=model, control_type=ctrl[0],
        dt=params.dt, num_iters=params.num_contact_iters,
        warm_iters=(params.num_contact_iters_warm
                    if params.contact_warm_start and not exact else 0),
        relaxation=params.relaxation, baumgarte=params.contact_baumgarte,
        slop=params.contact_slop,
        max_depen=params.max_depenetration_velocity,
        bounce_thresh=params.bounce_threshold_velocity,
        contact=bool(params.contact_enabled),
        limit_stiffness=params.joint_limit_stiffness,
        limit_damping=params.joint_limit_damping,
        max_base_ang_vel=params.max_base_ang_vel,
        max_base_lin_vel=params.max_base_lin_vel,
        decimation=decimation, exact_inputs=exact_inputs,
        entry_inputs=entry_inputs)
    return args, kwargs


def control_step_megakernel(
    model: RobotModel,
    params: SimParams,
    state: PhysicsState,
    dyn: DynamicsParams,
    terrain: "Terrain | None",
    tgt_eff: torch.Tensor,
    strengths: torch.Tensor,
    torque_limits: torch.Tensor,
    ctrl,
    decimation: int,
    lam_in_t=None,
    exact: bool = False,
):
    """One whole control step through a control-step kernel
    (ops/megastep.control_step): `decimation` substeps of torque model +
    cached dynamics + contact + integration in a single launch, with the
    J/W cache built in-kernel.  Reuse-mode semantics (cache anchored at
    the entry state, contact points advanced at velocity level; on a
    heightfield the surface normals sampled at the entry contact points
    enter the general-normal contact rows): the team kernel builds the
    entry cache and samples the heightfield itself in its launch, with
    the actuator network (K4, K4b) or P control (K4c, K4b-P).  With
    `exact=True`, exact per-substep semantics: the team kernel rebuilds the
    whole cache (FK/twists/inertia/CRBA/M^-1/J/W) from the current state
    before every substep (K5, K5-P; flat ground only; every contact solve
    starts cold, as in the per-substep exact route).  On CPU tensors the
    plain version runs the same steps eagerly.  Arguments as `megakernel_args`.

    Returns (new_state, lam_t, pcp_t, pcp_prev_t, torques (N, 12),
    hist (dict of (N, 12) actuator histories, empty for P control))."""
    N = state.base_pos.shape[0]
    args, kwargs = megakernel_args(
        model, params, state, dyn, terrain, tgt_eff, strengths,
        torque_limits, ctrl, decimation, lam_in_t, exact)
    outs = pm.control_step(*args, **kwargs)
    (q_o, qd_o, pos_o, quat_o, lin_o, ang_o, pcp_t, pcp_prev_t, lam_t,
     tau_o) = outs[:10]
    new_state = PhysicsState(
        base_pos=pc.from_env_minor(pos_o, N),
        base_quat=pc.from_env_minor(quat_o, N),
        base_lin_vel=pc.from_env_minor(lin_o, N),
        base_ang_vel=pc.from_env_minor(ang_o, N),
        q=pc.from_env_minor(q_o, N),
        qd=pc.from_env_minor(qd_o, N))
    torques = pc.from_env_minor(tau_o, N)
    hist = {}
    if ctrl[0] != "P":
        el, ell, vl, vll = (pc.from_env_minor(h, N) for h in outs[10:14])
        hist = dict(joint_pos_err_last=el, joint_pos_err_last_last=ell,
                    joint_vel_last=vl, joint_vel_last_last=vll)
    return new_state, lam_t, pcp_t, pcp_prev_t, torques, hist


def contact_report_from_lam_t(model: RobotModel, lam_t: torch.Tensor,
                              dt: float, N: int) -> ContactInfo:
    """Materialize the report-body contact forces from env-minor impulses
    (P, 3, Npad) — called once per control step."""
    forces = pc.from_env_minor(lam_t, N) / dt            # (N, P, 3)
    rep = torch.as_tensor(np.asarray(model.cp_report_body), dtype=torch.long,
                          device=lam_t.device)
    seg = torch.zeros((N, model.num_report_bodies, 3), dtype=lam_t.dtype,
                      device=lam_t.device)
    seg.index_add_(1, rep, forces)
    feet = torch.as_tensor(np.nonzero(model.cp_is_foot)[0], dtype=torch.long,
                           device=lam_t.device)
    return ContactInfo(report_forces=seg, foot_forces=forces[:, feet, :])


def foot_state_from_pcp_t(model: RobotModel, p_cp_t: torch.Tensor,
                          p_cp_prev_t: torch.Tensor, dt: float, N: int):
    """Foot positions & velocities from the env-minor carried contact
    points of the last substep: positions are the foot rows of p_cp,
    velocities the backward difference the kernel advanced them with.
    Returns ((N,4,3), (N,4,3)) in FL FR RL RR order."""
    feet = torch.as_tensor(np.nonzero(model.cp_is_foot)[0], dtype=torch.long,
                           device=p_cp_t.device)
    p_foot_t = p_cp_t[feet]
    v_foot_t = (p_cp_t[feet] - p_cp_prev_t[feet]) / dt
    return pc.from_env_minor(p_foot_t, N), pc.from_env_minor(v_foot_t, N)
