"""Batched articulated rigid-body dynamics: the two env-minor kernel routes.

Counterpart of the JAX package's physics/engine.py, restricted to what runs
through the hand-written kernels:

- the control-step route (default training path): one control step = one
  launch of a whole-control-step kernel (ops/megastep.py), in reuse mode
  (the cache of the entry state built inside the launch, with either
  torque model) or in exact mode (cache rebuilt inside the kernel before
  every substep);
- the per-substep route: per control step (exact mode: per substep) one
  `build_dynamics_cache` (the entry-cache kernel, ops/entry_cache.py, and
  the contact-cache kernel, ops/contact.py) and per physics substep one
  `physics_substep_cached` (the dynamics-substep kernel, ops/dynamics.py).

The N-major halves of the reference (`forward_kinematics`, `mass_matrix`,
`_contact_solve`, `_impulse_iteration`, `physics_substep`, and the
non-kernel halves of the two functions above) are not ported yet.

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
from ..ops import dynamics as pdyn
from ..ops import entry_cache as pec
from ..ops import megastep as pm
from ..ops import quat as qops
from . import envminor


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

    def lookup(self, x, y):
        """Bilinear height + surface normal at world (x, y). Shapes
        preserved.  Queries outside the field take the border cell's
        plane clamped to its edge."""
        if tuple(self.height.shape) == (2, 2):
            # flat ground (static shape check): no gathers
            h = torch.zeros_like(x) + self.height[0, 0]
            n = torch.tensor([0.0, 0.0, 1.0], dtype=x.dtype,
                             device=x.device).expand(tuple(x.shape) + (3,))
            return h, n
        # the pitch as a tensor: PyTorch's CUDA division by a Python scalar
        # multiplies by its float32 reciprocal, which moves a query one
        # rounding off the true quotient and, at a cell's edge, into the
        # neighbouring cell (another normal); a tensor divisor divides on
        # every device, as the CPU and K4b's heightfield_sample do
        hs = torch.full((), self.horizontal_scale, dtype=x.dtype,
                        device=x.device)
        gx = (x - self.origin_xy[0]) / hs
        gy = (y - self.origin_xy[1]) / hs
        H, W = self.height.shape
        i0 = torch.clamp(torch.floor(gx).to(torch.int32), 0, H - 2)
        j0 = torch.clamp(torch.floor(gy).to(torch.int32), 0, W - 2)
        fx = torch.clamp(gx - i0, 0.0, 1.0)
        fy = torch.clamp(gy - j0, 0.0, 1.0)
        # one gather of contiguous 4-vectors on the flattened grid
        c = self.corners.reshape(-1, 4)[(i0 * (W - 1) + j0).long()]
        h00, h10, h01, h11 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
        h = (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
             + h01 * (1 - fx) * fy + h11 * fx * fy)
        dhdx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / hs
        dhdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / hs
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], dim=-1)
        n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
        return h, n


def flat_terrain(device="cuda") -> Terrain:
    return Terrain(height=torch.zeros((2, 2), dtype=torch.float32,
                                      device=device),
                   horizontal_scale=1.0, origin_xy=(-1e4, -1e4))


def make_heightfield_terrain(height, horizontal_scale, origin_xy,
                             device="cuda") -> Terrain:
    """Heightfield Terrain with the corner-packed lookup table prebuilt."""
    height = torch.as_tensor(np.asarray(height), dtype=torch.float32,
                             device=device)
    corners = torch.stack([height[:-1, :-1], height[1:, :-1],
                           height[:-1, 1:], height[1:, 1:]],
                          dim=-1).contiguous()
    return Terrain(height=height, horizontal_scale=horizontal_scale,
                   origin_xy=tuple(origin_xy), corners=corners)


def build_pallas_env_inputs(model: RobotModel, state: PhysicsState,
                            dyn: DynamicsParams,
                            terrain: "Terrain | None" = None,
                            block: int = 256):
    """Env-minor kernel inputs: the scalar-per-env dynamics cache
    (physics/envminor.py) plus per-point gap offsets, friction/restitution,
    gravity and, on a heightfield, surface normals, built eagerly.  (Name
    kept from the JAX package.)  It is the plain version of the entry-cache
    kernel (ops/entry_cache.py), which `build_dynamics_cache` launches on
    the card.

    On a heightfield the height h and the normal n are sampled at the
    cache geometry (the entry contact points `em.p_cp_t`), once per cache:
    rh_t = h + radius.  The padded env lanes of `n_t` hold +z (valid
    lanes are untouched): a zero normal there would make the normal row's
    mass n^T W n zero and the kernels' impulses NaN.

    Returns (em: EnvMinorCache, rh_t (P, Npad), mu_t (1, Npad),
    e_t (1, Npad), g_t (3, Npad), n_t (P, 3, Npad) | None)."""
    em = envminor.build_cache_envminor(model, state, dyn, block)
    Npad = em.Sw_t.shape[-1]
    rh_t, mu_t, e_t, g_t = _contact_inputs(model, dyn, Npad, block)
    n_t = None
    if terrain is not None and tuple(terrain.height.shape) != (2, 2):
        N = state.base_pos.shape[0]
        p_cp = pc.from_env_minor(em.p_cp_t, N)                # (N, P, 3)
        h, n_srf = terrain.lookup(p_cp[..., 0], p_cp[..., 1])
        radius = torch.as_tensor(np.asarray(model.cp_radius),
                                 dtype=h.dtype, device=h.device)
        rh_t = pc.to_env_minor(h + radius[None, :], block)
        n_t = pc.to_env_minor(n_srf, block)
        n_t[:, 2, N:] = 1.0
    return em, rh_t, mu_t, e_t, g_t, n_t


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


# ---------------------------------------------------------------------------
# cached control step (matrix reuse across decimation substeps)
# ---------------------------------------------------------------------------


class PallasOps(NamedTuple):
    """Env-minor cache operands for the dynamics-substep kernel
    (ops/dynamics.py); built once per control step by physics/envminor.py +
    the contact-cache kernel.  (Name kept from the JAX package.)"""

    J_t: torch.Tensor       # (P, 3, nv, Npad)
    W_t: torch.Tensor       # (P, 9, Npad) effective-mass J M^-1 J^T + eps I
    Minv_t: torch.Tensor    # (nv, nv, Npad)
    rh_t: torch.Tensor      # (P, Npad) radius + terrain height per point
    mu_t: torch.Tensor      # (1, Npad)
    e_t: torch.Tensor       # (1, Npad)
    p_cp_t: torch.Tensor    # (P, 3, Npad)
    Sw_t: torch.Tensor      # (nv, 3, Npad)
    Sv_t: torch.Tensor      # (nv, 3, Npad)
    A_t: torch.Tensor       # (nb, 9, Npad)
    B_t: torch.Tensor       # (nb, 9, Npad)
    m_t: torch.Tensor       # (nb, Npad)
    g_t: torch.Tensor       # (3, Npad)
    n_t: "torch.Tensor | None" = None   # (P, 3, Npad) normals (None = flat +z)
    block: int = 256


class DynamicsCache(NamedTuple):
    """Per-control-step cached dynamics quantities, anchored at the first
    substep's geometry.  M^-1, twist bases, inertia blocks and contact
    Jacobians vary on the ~cm / ~3deg scale across a 20 ms control step;
    reusing them for the remaining decimation substeps trades a small
    geometric lag for skipping the most expensive contractions.

    The whole cache is built env-minor (physics/envminor.py) and only `ref`
    + `pallas_ops` are populated; the N-major fields of the reference
    belong to its dense path, which is not ported."""

    ref: torch.Tensor          # (N, 3) anchor reference point
    pallas_ops: "PallasOps | None" = None


# env-axis block of the per-substep route (Npad 4096 at 4000 envs)
SUBSTEP_BLOCK = 256


def _velocity_bounds(model: RobotModel, params: SimParams, f32, dev):
    """(nv, 1) per-row velocity bounds: base angular, base linear, joints."""
    return torch.cat([
        torch.full((3,), params.max_base_ang_vel, dtype=f32, device=dev),
        torch.full((3,), params.max_base_lin_vel, dtype=f32, device=dev),
        torch.tensor(np.asarray(model.dof_vel_limit), dtype=f32,
                     device=dev)])[:, None].contiguous()


def build_dynamics_cache(model: RobotModel, params: SimParams,
                         state: PhysicsState, dyn: DynamicsParams,
                         terrain: "Terrain | None" = None) -> DynamicsCache:
    """The cache of one control step (or, in exact mode, one substep),
    anchored at `state`: FK / inertia / CRBA / M^-1 in scalar-per-env form
    and, on a heightfield, the samples under the contact points — in the
    entry-cache kernel (ops/entry_cache.entry_cache) on a CUDA device, by
    the eager build (`build_pallas_env_inputs`) on the CPU — then J / W in
    the contact-cache kernel (ops/contact.build_contact_cache); no N-major
    dynamics tensor is materialised."""
    if not params.use_pallas_contact:
        raise NotImplementedError(
            "build_dynamics_cache without use_pallas_contact is the dense "
            "N-major engine path (ROADMAP queue 1, item 7), which is not "
            "ported yet")
    f32 = state.base_pos.dtype
    dev = state.base_pos.device
    block = SUBSTEP_BLOCK
    if dev.type == "cpu":
        em, rh_t, mu_t, e_t, g_t, n_t = build_pallas_env_inputs(
            model, state, dyn, terrain, block)
    else:
        em, rh_hf, n_t = pec.entry_cache(model, state, dyn, terrain, block)
        rh_t, mu_t, e_t, g_t = _contact_inputs(
            model, dyn, em.Sw_t.shape[-1], block)
        if rh_hf is not None:
            rh_t = rh_hf
    anc_pn = torch.tensor(
        np.asarray(model.anc_dof_body)[:, np.asarray(model.cp_body)].T,
        dtype=f32, device=dev).contiguous()                    # (P, nv)
    J_t, W_t = pc.build_contact_cache(anc_pn, em.Sw_t, em.Sv_t, em.Minv_t,
                                      em.r_t)
    pallas_ops = PallasOps(
        J_t=J_t, W_t=W_t, Minv_t=em.Minv_t, rh_t=rh_t, mu_t=mu_t, e_t=e_t,
        p_cp_t=em.p_cp_t, Sw_t=em.Sw_t, Sv_t=em.Sv_t, A_t=em.A_t,
        B_t=em.B_t, m_t=em.m_t, g_t=g_t, n_t=n_t, block=block)
    return DynamicsCache(ref=state.base_pos, pallas_ops=pallas_ops)


def physics_substep_cached(
    model: RobotModel,
    params: SimParams,
    state: PhysicsState,
    joint_torques: torch.Tensor,
    dyn: DynamicsParams,
    terrain: "Terrain | None",
    cache: DynamicsCache,
    p_cp: "torch.Tensor | None" = None,
):
    """Substep using cached matrices (fresh: torques, contact gaps, bias
    velocity terms, integration), through the dynamics-substep kernel.

    `p_cp` is the carried contact-point estimate, env-minor (P, 3, Npad)
    (starts at cache.pallas_ops.p_cp_t, advanced in the kernel by
    dt * J qd — no per-substep FK).  Returns (new_state, lam_t (P, 3, Npad)
    impulses of this substep, p_cp_new (P, 3, Npad)); the caller
    materialises forces once per control step with
    `contact_report_from_lam_t`."""
    if not (params.use_pallas_contact and cache.pallas_ops is not None):
        raise NotImplementedError(
            "physics_substep_cached on an N-major cache is the dense engine "
            "path (ROADMAP queue 1, item 7), which is not ported yet")
    f32 = state.base_pos.dtype
    dev = state.base_pos.device
    N = state.base_pos.shape[0]
    dt = params.dt
    # generalized velocity expressed at the anchor point
    delta = cache.ref - state.base_pos
    v_ref = state.base_lin_vel + torch.cross(state.base_ang_vel, delta,
                                             dim=-1)
    gen_vel = torch.cat([state.base_ang_vel, v_ref, state.qd], dim=-1)

    lo = torch.tensor(np.asarray(model.dof_lower), dtype=f32, device=dev)
    hi = torch.tensor(np.asarray(model.dof_upper), dtype=f32, device=dev)
    over_hi = torch.clamp(state.q - hi, min=0.0)
    under_lo = torch.clamp(lo - state.q, min=0.0)
    tau_lim = (params.joint_limit_stiffness * (under_lo - over_hi)
               - params.joint_limit_damping
               * ((over_hi > 0) | (under_lo > 0)).to(f32) * state.qd)
    tau = torch.cat([torch.zeros((N, 6), dtype=f32, device=dev),
                     joint_torques + tau_lim], dim=-1)

    po = cache.pallas_ops
    if p_cp is None:
        p_cp = po.p_cp_t
    gv_t = pc.to_env_minor(gen_vel, po.block)
    tau_t = pc.to_env_minor(tau, po.block)
    vlim = _velocity_bounds(model, params, f32, dev)
    gv_new_t, p_cp, lam_t = pdyn.dynamics_substep(
        po.Sw_t, po.Sv_t, po.A_t, po.B_t, po.m_t, po.Minv_t, po.g_t,
        tau_t, gv_t, po.J_t, po.W_t, p_cp, po.rh_t, po.mu_t, po.e_t,
        vlim, po.n_t, anc=model.anc_dof_body, joint_body=model.joint_body,
        cp_body=model.cp_body,
        dt=dt, num_iters=params.num_contact_iters,
        relaxation=params.relaxation,
        baumgarte=params.contact_baumgarte, slop=params.contact_slop,
        max_depen=params.max_depenetration_velocity,
        bounce_thresh=params.bounce_threshold_velocity,
        contact=bool(params.contact_enabled))
    gen_vel_new = pc.from_env_minor(gv_new_t, N)

    vlim_j = vlim[6:, 0]
    qd_new = torch.maximum(torch.minimum(gen_vel_new[:, 6:], vlim_j), -vlim_j)
    ang_new = torch.clamp(gen_vel_new[:, :3], -params.max_base_ang_vel,
                          params.max_base_ang_vel)
    v_ref_new = torch.clamp(gen_vel_new[:, 3:6], -params.max_base_lin_vel,
                            params.max_base_lin_vel)
    # velocity back at the (moved) base point
    lin_new = v_ref_new - torch.cross(ang_new, delta, dim=-1)
    new_state = PhysicsState(
        base_pos=state.base_pos + dt * lin_new,
        base_quat=qops.quat_integrate(state.base_quat, ang_new, dt),
        base_lin_vel=lin_new, base_ang_vel=ang_new,
        q=state.q + dt * qd_new, qd=qd_new)
    return new_state, lam_t, p_cp


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
    eager_cache: bool = False,
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
    - reuse mode with `eager_cache`, which only the checks of a kernel
      against its plain version ask for: the env-minor cache of the entry
      state built here on the host (`build_pallas_env_inputs`), with the
      surface normals on a heightfield, for the plain version (the kernels
      refuse it);
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
    if exact or not eager_cache:
        em, n_t = None, None
        rh_t, mu_t, e_t, g_t = _contact_inputs(
            model, dyn, -(-N // block) * block, block)
        randomised = (pc.to_env_minor(dyn.payload[:, None], block),
                      pc.to_env_minor(dyn.com_displacement, block))
        if exact:
            exact_inputs = randomised
        else:
            entry_inputs = randomised + (terrain if heightfield else None,)
    else:
        em, rh_t, mu_t, e_t, g_t, n_t = build_pallas_env_inputs(
            model, state, dyn, terrain, block)
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
