"""Batched articulated rigid-body dynamics.

Counterpart of the JAX package's physics/engine.py, with its three routes:

- the control-step route (default training path): one control step = one
  launch of a whole-control-step kernel (ops/megastep.py), in reuse mode
  (the cache of the entry state built inside the launch, with either
  torque model) or in exact mode (cache rebuilt inside the kernel before
  every substep);
- the per-substep route: per control step (exact mode: per substep) one
  `build_dynamics_cache` (the entry-cache kernel, ops/entry_cache.py, and
  the contact-cache kernel, ops/contact.py) and per physics substep one
  `physics_substep_cached` (the dynamics-substep kernel, ops/dynamics.py);
- the dense (N-major) route, `SimParams.use_pallas_contact` off: stock
  torch ops on (N, ...) tensors on either device, no hand kernel
  (`forward_kinematics`, `mass_matrix`, `bias_forces`, `_contact_solve`,
  `physics_substep`, and the N-major halves of `build_dynamics_cache` and
  `physics_substep_cached`).  The reference runs this path as plain XLA.

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
from ..ops import linalg as la
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


class BodyFrames(NamedTuple):
    R: torch.Tensor       # (N, nb, 3, 3) body-to-world
    p: torch.Tensor       # (N, nb, 3)   joint-frame origin, world
    com: torch.Tensor     # (N, nb, 3)   world com
    joint_axis_w: torch.Tensor   # (N, nj, 3)
    joint_anchor_w: torch.Tensor  # (N, nj, 3)


class InertiaBlocks(NamedTuple):
    """Spatial inertia about the reference point in 3x3 block form:
    I_b = [[A_b, B_b], [B_b^T, m_b I]]."""

    A: torch.Tensor   # (N, nb, 3, 3)
    B: torch.Tensor   # (N, nb, 3, 3)  = m * skew(com - ref)
    m: torch.Tensor   # (N, nb)


def identity_dynamics_params(n: int, gravity=(-0.0, 0.0, -9.81),
                             device="cuda") -> DynamicsParams:
    g = torch.tensor(gravity, dtype=torch.float32, device=device).repeat(n, 1)
    return DynamicsParams(
        payload=torch.zeros(n, device=device),
        com_displacement=torch.zeros((n, 3), device=device),
        friction=torch.ones(n, device=device),
        restitution=torch.zeros(n, device=device),
        gravity=g,
    )


# ---------------------------------------------------------------------------
# the dense (N-major) path: static model tables
# ---------------------------------------------------------------------------


def _fk_levels(model: RobotModel):
    """Group joints by tree depth: [(joint_ids, parent_bodies)]."""
    depth = np.zeros(model.nb, dtype=int)
    for b in range(1, model.nb):
        depth[b] = depth[model.parent[b]] + 1
    levels = []
    for d in range(1, depth.max() + 1):
        js = [j for j in range(model.nj) if depth[model.joint_body[j]] == d]
        parents = [model.parent[model.joint_body[j]] for j in js]
        levels.append((np.array(js), np.array(parents)))
    return levels


def _joint_anc_pair(model: RobotModel) -> np.ndarray:
    """(nj, nj) static mask: joint i is an ancestor of (or equals) joint j."""
    L = np.zeros((model.nj, model.nj), dtype=np.float32)
    for i in range(model.nj):
        for j in range(model.nj):
            if model.subtree[model.joint_body[i], model.joint_body[j]]:
                L[i, j] = 1.0
    return L


class _Tables(NamedTuple):
    """The model's static arrays as float32 / index tensors on one device
    (the reference's trace-time constants)."""

    # per FK level: (joints, parents, q index, anchors, axes, K, K K)
    levels: tuple
    com: torch.Tensor           # (nb, 3) local com
    mass: torch.Tensor          # (nb,)
    inertia: torch.Tensor       # (nb, 3, 3)
    anc: torch.Tensor           # (nv, nb)
    anc_pair: torch.Tensor      # (nj, nj)
    cp_body: torch.Tensor       # (P,) long
    cp_offset: torch.Tensor     # (P, 3)
    cp_radius: torch.Tensor     # (P,)
    cp_mask: torch.Tensor       # (1, P, nv, 1) dof moves the point's body
    cp_feet: torch.Tensor       # (4,) long: the foot points
    cp_report: torch.Tensor     # (P,) long: each point's report body
    rep_onehot: torch.Tensor    # (P, num_report_bodies)
    foot_body: torch.Tensor     # (4,) long
    foot_offset: torch.Tensor   # (4, 3)
    dof_lower: torch.Tensor
    dof_upper: torch.Tensor
    dof_vel_limit: torch.Tensor
    chains: "int | None"        # 3-dof chains of a star topology, else None


# One table per (model, device) for the life of the process.  A host array
# copied to the card each call would synchronise the stream every time;
# the entry keeps the model alive, so its id is not reused.
_TABLES = {}


def _tables(model: RobotModel, dev) -> _Tables:
    key = (id(model), str(dev))
    hit = _TABLES.get(key)
    if hit is None:
        hit = (model, _make_tables(model, torch.device(dev)))
        _TABLES[key] = hit
    return hit[1]


def _make_tables(model: RobotModel, dev) -> _Tables:
    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    def idx(x):
        return torch.tensor(np.asarray(x), dtype=torch.long, device=dev)

    levels = []
    for js, parents in _fk_levels(model):
        K = np.stack([np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                                [-a[1], a[0], 0]])
                      for a in model.joint_axis[js]]).astype(np.float32)
        levels.append((tuple(int(j) for j in js),
                       tuple(int(b) for b in parents), idx(js),
                       f32(model.joint_anchor[js]), f32(model.joint_axis[js]),
                       f32(K), f32(K @ K)))
    anc = np.asarray(model.anc_dof_body)
    cp_body = np.asarray(model.cp_body)
    chains = None
    njc = model.nv - 6
    if njc > 0 and njc % 3 == 0:
        expected = np.kron(np.eye(njc // 3), np.ones((3, 3)))
        if (model.crba_conn[6:, 6:] == expected).all():
            chains = njc // 3
    return _Tables(
        levels=tuple(levels), com=f32(model.com), mass=f32(model.mass),
        inertia=f32(model.inertia), anc=f32(anc),
        anc_pair=f32(_joint_anc_pair(model)), cp_body=idx(cp_body),
        cp_offset=f32(model.cp_offset), cp_radius=f32(model.cp_radius),
        cp_mask=f32(anc[:, cp_body].T[None, :, :, None]),
        cp_feet=idx(np.nonzero(model.cp_is_foot)[0]),
        cp_report=idx(model.cp_report_body),
        rep_onehot=f32(np.eye(model.num_report_bodies,
                              dtype=np.float32)[model.cp_report_body]),
        foot_body=idx(model.foot_body), foot_offset=f32(model.foot_offset),
        dof_lower=f32(model.dof_lower), dof_upper=f32(model.dof_upper),
        dof_vel_limit=f32(model.dof_vel_limit), chains=chains)


def _check_fp32(t: torch.Tensor):
    """The dense path's products must not drop to TF32 on the card."""
    if t.device.type == "cuda" and \
            torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 must be False: the port "
            "computes in full float32")


# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------


def _axis_angle_rotmat(axis, angle):
    """Rodrigues for a static local axis (3,) and batched angle (N,)."""
    a = torch.as_tensor(np.asarray(axis), dtype=angle.dtype,
                        device=angle.device)
    K = qops.skew(a)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def forward_kinematics(model: RobotModel, state: PhysicsState) -> BodyFrames:
    """Batched FK, vectorized across same-depth joints (all 4 legs' hips in
    one op, then thighs, then calves)."""
    f32 = state.base_pos.dtype
    dev = state.base_pos.device
    tb = _tables(model, dev)
    Rs = [None] * model.nb
    ps = [None] * model.nb
    Rs[0] = qops.quat_to_rotmat(state.base_quat)
    ps[0] = state.base_pos
    axes_w = [None] * model.nj
    eye = torch.eye(3, dtype=f32, device=dev)
    for js, parents, q_idx, anchors, axes, K, KK in tb.levels:
        Rp = torch.stack([Rs[pb] for pb in parents], dim=1)    # (N, L, 3, 3)
        pp = torch.stack([ps[pb] for pb in parents], dim=1)    # (N, L, 3)
        ang = state.q.index_select(1, q_idx)                    # (N, L)
        s = torch.sin(ang)[..., None, None]
        c = torch.cos(ang)[..., None, None]
        rot = eye + s * K[None] + (1.0 - c) * KK[None]          # (N, L, 3, 3)
        Rj = torch.matmul(Rp, rot)
        pj = pp + torch.einsum("nlij,lj->nli", Rp, anchors)
        aw = torch.einsum("nlij,lj->nli", Rp, axes)
        for k, j in enumerate(js):
            b = int(model.joint_body[j])
            Rs[b] = Rj[:, k]
            ps[b] = pj[:, k]
            axes_w[j] = aw[:, k]
    R = torch.stack(Rs, dim=1)
    p = torch.stack(ps, dim=1)
    com = p + torch.einsum("nbij,bj->nbi", R, tb.com)
    N = state.base_pos.shape[0]
    if model.nj == 0:          # single free body (e.g. models.robot.box)
        empty = torch.zeros((N, 0, 3), dtype=f32, device=dev)
        return BodyFrames(R=R, p=p, com=com, joint_axis_w=empty,
                          joint_anchor_w=empty)
    anchors_w = torch.stack([ps[int(model.joint_body[j])]
                             for j in range(model.nj)], dim=1)
    return BodyFrames(R=R, p=p, com=com,
                      joint_axis_w=torch.stack(axes_w, dim=1),
                      joint_anchor_w=anchors_w)


# ---------------------------------------------------------------------------
# spatial algebra (angular-first 6-vectors, reference point = base)
# ---------------------------------------------------------------------------


def joint_twists(model: RobotModel, frames: BodyFrames, ref: torch.Tensor):
    """All nv twists about per-env reference point `ref`, split into angular
    and linear parts.  Returns (Sw, Sv), each (N, nv, 3), rows in the
    generalized-velocity order [ang(3), lin(3), qd(nj)]."""
    N = ref.shape[0]
    eye = torch.eye(3, dtype=ref.dtype, device=ref.device).expand(N, 3, 3)
    zero = torch.zeros((N, 3, 3), dtype=ref.dtype, device=ref.device)
    a = frames.joint_axis_w
    lin = torch.cross(frames.joint_anchor_w - ref[:, None, :], a, dim=-1)
    Sw = torch.cat([eye, zero, a], dim=1)
    Sv = torch.cat([zero, eye, lin], dim=1)
    return Sw, Sv


def inertia_blocks(model: RobotModel, frames: BodyFrames, ref: torch.Tensor,
                   dyn: DynamicsParams) -> InertiaBlocks:
    """Per-body spatial inertia blocks about ref, with the payload on the
    base and its COM shift; the base inertia scaled by the payload's mass
    ratio."""
    tb = _tables(model, ref.device)
    N = ref.shape[0]
    mass = tb.mass[None, :]                                     # (1, nb)
    m = mass + torch.nn.functional.pad(dyn.payload[:, None],
                                       (0, model.nb - 1))       # (N, nb)
    shift = torch.einsum("nij,nj->ni", frames.R[:, 0], dyn.com_displacement)
    com = torch.cat([(frames.com[:, 0] + shift)[:, None], frames.com[:, 1:]],
                    dim=1)
    scale = torch.cat([(m[:, 0] / mass[0, 0])[:, None],
                       torch.ones((N, model.nb - 1), dtype=m.dtype,
                                  device=m.device)], dim=1)
    I_l = tb.inertia[None] * scale[..., None, None]
    I_w = torch.matmul(torch.matmul(frames.R, I_l), frames.R.transpose(-1, -2))
    rx = qops.skew(com - ref[:, None, :])                       # (N, nb, 3, 3)
    mrx = m[..., None, None] * rx
    return InertiaBlocks(A=I_w - torch.matmul(mrx, rx), B=mrx, m=m)


def mass_matrix(model: RobotModel, Sw: torch.Tensor, Sv: torch.Tensor,
                blk: InertiaBlocks) -> torch.Tensor:
    """CRBA in 3x3 block form. (N, nv, nv).

    The root 6x6 block is the whole-robot composite; for a pair where j is
    the deeper dof, M[i, j] = Sw_i . a_j + Sv_i . b_j with a_j = Ac_j w_j +
    Bc_j v_j and b_j = Bc_j^T w_j + mc_j v_j, (Ac, Bc, mc) the composite
    blocks of joint j's subtree."""
    tb = _tables(model, Sw.device)
    sub_j = tb.anc[6:]                                          # (nj, nb)
    Ac = torch.einsum("jb,nbxy->njxy", sub_j, blk.A)
    Bc = torch.einsum("jb,nbxy->njxy", sub_j, blk.B)
    mc = torch.einsum("jb,nb->nj", sub_j, blk.m)
    wj = Sw[:, 6:, :]
    vj = Sv[:, 6:, :]
    a = (torch.einsum("njxy,njy->njx", Ac, wj)
         + torch.einsum("njxy,njy->njx", Bc, vj))               # (N, nj, 3)
    b = torch.einsum("njyx,njy->njx", Bc, wj) + mc[..., None] * vj
    E = (torch.einsum("nix,njx->nij", Sw, a)
         + torch.einsum("nix,njx->nij", Sv, b))                 # (N, nv, nj)

    A_tot = torch.sum(blk.A, dim=1)
    B_tot = torch.sum(blk.B, dim=1)
    m_tot = torch.sum(blk.m, dim=1)
    eye = torch.eye(3, dtype=Sw.dtype, device=Sw.device)
    top_left = torch.cat([
        torch.cat([A_tot, B_tot], dim=-1),
        torch.cat([B_tot.transpose(-1, -2), m_tot[:, None, None] * eye],
                  dim=-1),
    ], dim=-2)                                                  # (N, 6, 6)
    top_right = E[:, :6, :]                                     # (N, 6, nj)
    Ej = E[:, 6:, :]
    LE = tb.anc_pair[None] * Ej
    diag = torch.diagonal(Ej, dim1=-2, dim2=-1)
    lower_right = LE + LE.transpose(-1, -2) \
        - diag[:, :, None] * torch.eye(model.nj, dtype=Sw.dtype,
                                       device=Sw.device)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([top_right.transpose(-1, -2), lower_right], dim=-1)
    return torch.cat([top, bot], dim=-2)


def bias_forces(model: RobotModel, Sw, Sv, Vw, Vv, blk: InertiaBlocks,
                gen_vel: torch.Tensor, gravity: torch.Tensor) -> torch.Tensor:
    """RNEA with qdd=0 (Coriolis + gravity) in block form. (N, nv).

    The parent->child acceleration recursion expands to a masked sum over
    each body's path: three batched contractions, no sequential chain."""
    tb = _tables(model, Sw.device)
    qd = gen_vel[:, 6:, None]
    # per-joint velocity-product terms (joint j moves body j+1 by construction)
    Vwj, Vvj = Vw[:, 1:, :], Vv[:, 1:, :]
    Swj, Svj = Sw[:, 6:, :], Sv[:, 6:, :]
    Cw = torch.cross(Vwj, Swj, dim=-1) * qd
    Cv = (torch.cross(Vwj, Svj, dim=-1) + torch.cross(Vvj, Swj, dim=-1)) * qd
    anc_j = tb.anc[6:]                                          # (nj, nb)
    aw = torch.einsum("jb,njx->nbx", anc_j, Cw)
    av = -gravity[:, None, :] + torch.einsum("jb,njx->nbx", anc_j, Cv)

    def I_apply(w, v):
        return (torch.einsum("nbxy,nby->nbx", blk.A, w)
                + torch.einsum("nbxy,nby->nbx", blk.B, v),
                torch.einsum("nbyx,nby->nbx", blk.B, w)
                + blk.m[..., None] * v)

    IVw, IVv = I_apply(Vw, Vv)
    IAw, IAv = I_apply(aw, av)
    Fw = IAw + torch.cross(Vw, IVw, dim=-1) + torch.cross(Vv, IVv, dim=-1)
    Fv = IAv + torch.cross(Vw, IVv, dim=-1)
    # each dof's twist against the forces summed over the bodies it moves
    return (torch.sum(Sw * torch.einsum("db,nbx->ndx", tb.anc, Fw), dim=-1)
            + torch.sum(Sv * torch.einsum("db,nbx->ndx", tb.anc, Fv), dim=-1))


def body_twists(model: RobotModel, Sw, Sv, gen_vel: torch.Tensor):
    """Per-body twists (Vw, Vv), each (N, nb, 3)."""
    anc = _tables(model, Sw.device).anc
    Vw = torch.einsum("db,ndx->nbx", anc, Sw * gen_vel[..., None])
    Vv = torch.einsum("db,ndx->nbx", anc, Sv * gen_vel[..., None])
    return Vw, Vv


def _mass_matrix_inverse(model: RobotModel, M: torch.Tensor) -> torch.Tensor:
    """The closed-form inverse when the topology is a star of 3-dof chains
    (a quadruped), else `torch.linalg.inv` (the reference's jnp.linalg.inv).
    The choice is made on the static topology."""
    chains = _tables(model, M.device).chains
    if chains is not None:
        return la.mass_matrix_inverse(M, num_chains=chains)
    return torch.linalg.inv(M)


# ---------------------------------------------------------------------------
# the dense contact solve
# ---------------------------------------------------------------------------


def _contact_points(model: RobotModel, frames: BodyFrames) -> torch.Tensor:
    """(N, P, 3) world contact-point positions.  Index selects of the points'
    bodies where the reference contracts one-hot matrices: both pick each
    value exactly."""
    tb = _tables(model, frames.p.device)
    Rb = frames.R.index_select(1, tb.cp_body)                   # (N, P, 3, 3)
    pb = frames.p.index_select(1, tb.cp_body)
    return pb + torch.einsum("npij,pj->npi", Rb, tb.cp_offset)


def _point_jacobians(model: RobotModel, Sw, Sv, Minv, p_cp, ref):
    """Point Jacobians J (N, P, 3, nv) (v_point = Sv + Sw x r for each dof
    that moves the point's body), M^-1 J^T (N, P, nv, 3) and the effective
    masses W = J M^-1 J^T + eps I (N, P, 3, 3)."""
    N, P, nv = p_cp.shape[0], p_cp.shape[1], Sw.shape[1]
    r = p_cp - ref[:, None, :]                                  # (N, P, 3)
    Jl = Sv[:, None, :, :] + torch.cross(
        Sw[:, None, :, :].expand(N, P, nv, 3),
        r[:, :, None, :].expand(N, P, nv, 3), dim=-1)
    J = (Jl * _tables(model, Sw.device).cp_mask).transpose(2, 3)
    MinvJT_p = torch.einsum("nvw,npiw->npvi", Minv, J)
    W = torch.einsum("npiv,npvj->npij", J, MinvJT_p) \
        + 1e-6 * torch.eye(3, dtype=Sw.dtype, device=Sw.device)
    return J, MinvJT_p, W


def _normal_targets(params: SimParams, J, gen_vel, n_srf, phi, e, dt):
    """Normal-row targets: restitution bounce above the threshold, else the
    capped Baumgarte push-out."""
    v0 = torch.einsum("npiv,nv->npi", J, gen_vel)
    vn0 = torch.einsum("npi,npi->np", v0, n_srf)
    bounce = torch.where(vn0 < -params.bounce_threshold_velocity, -e * vn0,
                         torch.zeros_like(vn0))
    bias = torch.clamp(
        params.contact_baumgarte / dt * torch.clamp(
            phi - params.contact_slop, min=0.0),
        max=params.max_depenetration_velocity)
    return torch.maximum(bounce, bias)


def _contact_solve(model: RobotModel, params: SimParams, Minv, Sw, Sv,
                   frames: BodyFrames, ref, gen_vel, terrain: Terrain,
                   dyn: DynamicsParams, dt: float):
    """Velocity-level unilateral contact solve at the FK contact points.

    Returns (delta_gen_vel, world contact force per point (N, P, 3),
    contact points (N, P, 3))."""
    p_cp = _contact_points(model, frames)
    radius = _tables(model, gen_vel.device).cp_radius
    h, n_srf = terrain.lookup(p_cp[..., 0], p_cp[..., 1])
    phi = h + radius[None, :] - p_cp[..., 2]             # penetration depth
    J, MinvJT_p, W = _point_jacobians(model, Sw, Sv, Minv, p_cp, ref)
    # ground friction 1.0 averaged in with the robot's shape friction
    mu = 0.5 * (dyn.friction[:, None] + 1.0)
    target_n = _normal_targets(params, J, gen_vel, n_srf, phi,
                               dyn.restitution[:, None], dt)
    lam, gen_vel_new = _impulse_iteration(
        params, J, MinvJT_p, W, n_srf, target_n, mu, phi > 0.0, gen_vel)
    return gen_vel_new - gen_vel, lam / dt, p_cp


def _impulse_iteration(params: SimParams, J, MinvJT_p, W, n_srf, target_n,
                       mu, active, gen_vel):
    """Row-decoupled projected-Jacobi impulse sweeps, `num_contact_iters`
    of them from zero impulses: per contact, the normal row drives v_n to
    its target with mass n^T W n (relaxed); the friction row pushes
    opposite the current slip t with mass t^T W t (floored at 1e-6, where
    the slip is exactly zero); the tangential impulse is clamped to the
    mu * lambda_n cone; inactive contacts hold none; every contact's change
    is applied at once (Jacobi), gv += M^-1 J^T dlam.  Returns (impulses
    (N, P, 3), gen_vel after the sweeps)."""
    N, P = target_n.shape
    lam = torch.zeros((N, P, 3), dtype=gen_vel.dtype, device=gen_vel.device)
    w_nn = torch.sum(n_srf * torch.matmul(W, n_srf[..., None])[..., 0],
                     dim=-1)
    inv_w_nn = params.relaxation / w_nn
    # M^-1 J^T with the (point, row) pairs as one axis: the apply is then
    # one batched product per sweep
    MinvJT = MinvJT_p.permute(0, 2, 1, 3).reshape(N, -1, P * 3)
    zero = torch.zeros((), dtype=gen_vel.dtype, device=gen_vel.device)
    one = torch.ones((), dtype=gen_vel.dtype, device=gen_vel.device)
    gv = gen_vel
    for _ in range(params.num_contact_iters):
        v = torch.matmul(J, gv[:, None, :, None])[..., 0]      # (N, P, 3)
        vn = torch.sum(v * n_srf, dim=-1)
        vt = v - vn[..., None] * n_srf
        vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-18)
        t = vt / vt_norm[..., None]
        # vt = 0 exactly makes t the zero vector: floor w_tt at eps
        w_tt = torch.clamp(torch.sum(
            t * torch.matmul(W, t[..., None])[..., 0], dim=-1), min=1e-6)
        dln = (target_n - vn) * inv_w_nn
        dlt = -params.relaxation * vt_norm / w_tt
        l_n0 = torch.sum(lam * n_srf, dim=-1)
        ln = torch.clamp(l_n0 + dln, min=0.0)
        lt = lam - l_n0[..., None] * n_srf + dlt[..., None] * t
        lt_norm = torch.sqrt(torch.sum(lt * lt, dim=-1) + 1e-18)
        max_t = mu * ln
        scale = torch.where(lt_norm > max_t, max_t / lt_norm, one)
        new_lam = ln[..., None] * n_srf + lt * scale[..., None]
        new_lam = torch.where(active[..., None], new_lam, zero)
        gv = gv + torch.matmul(
            MinvJT, (new_lam - lam).reshape(N, P * 3, 1))[..., 0]
        lam = new_lam
    return lam, gv


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
    P = model.cp_body.shape[0]
    radius = _tables(model, dyn.gravity.device).cp_radius
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

    On the kernel routes (`SimParams.use_pallas_contact`) the whole cache
    is built env-minor and only `ref` + `pallas_ops` are populated; on the
    dense route only the N-major fields are."""

    ref: torch.Tensor          # (N, 3) anchor reference point
    Sw: "torch.Tensor | None" = None
    Sv: "torch.Tensor | None" = None
    blk: "InertiaBlocks | None" = None
    Minv: "torch.Tensor | None" = None
    J: "torch.Tensor | None" = None          # (N, P, 3, nv)
    MinvJT_p: "torch.Tensor | None" = None   # (N, P, nv, 3)
    W: "torch.Tensor | None" = None   # (N, P, 3, 3) J M^-1 J^T + eps I
    # (N, P, 3) contact points at the anchor state, advanced at velocity
    # level across the control step's substeps (p' = p + dt J qd) in place
    # of FK: the same first-order-in-dt approximation reuse makes for J/M
    p_cp: "torch.Tensor | None" = None
    pallas_ops: "PallasOps | None" = None


# env-axis block of the per-substep route (Npad 4096 at 4000 envs)
SUBSTEP_BLOCK = 256


def _velocity_bounds(model: RobotModel, params: SimParams, f32, dev):
    """(nv, 1) per-row velocity bounds: base angular, base linear, joints."""
    return torch.cat([
        torch.full((3,), params.max_base_ang_vel, dtype=f32, device=dev),
        torch.full((3,), params.max_base_lin_vel, dtype=f32, device=dev),
        _tables(model, dev).dof_vel_limit])[:, None].contiguous()


def build_dynamics_cache(model: RobotModel, params: SimParams,
                         state: PhysicsState, dyn: DynamicsParams,
                         terrain: "Terrain | None" = None) -> DynamicsCache:
    """The cache of one control step (or, in exact mode, one substep),
    anchored at `state`.

    With `params.use_pallas_contact`: FK / inertia / CRBA / M^-1 in
    scalar-per-env form and, on a heightfield, the samples under the
    contact points — in the entry-cache kernel (ops/entry_cache.entry_cache)
    on a CUDA device, by the eager build (`build_pallas_env_inputs`) on the
    CPU — then J / W in the contact-cache kernel
    (ops/contact.build_contact_cache); no N-major dynamics tensor is
    materialised.  Without it, the dense route: the N-major twists, inertia
    blocks, M^-1, contact points, J, M^-1 J^T and W in stock torch ops
    (`terrain` is not read: the substeps sample it)."""
    if not params.use_pallas_contact:
        return _dense_cache(model, state, dyn)
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


def _dense_cache(model: RobotModel, state: PhysicsState,
                 dyn: DynamicsParams) -> DynamicsCache:
    """The N-major cache of `build_dynamics_cache` at `state`."""
    _check_fp32(state.base_pos)
    ref = state.base_pos
    frames = forward_kinematics(model, state)
    Sw, Sv = joint_twists(model, frames, ref)
    blk = inertia_blocks(model, frames, ref, dyn)
    M = mass_matrix(model, Sw, Sv, blk)
    M = M + 1e-7 * torch.eye(model.nv, dtype=M.dtype, device=M.device)[None]
    Minv = _mass_matrix_inverse(model, M)
    p_cp = _contact_points(model, frames)
    J, MinvJT_p, W = _point_jacobians(model, Sw, Sv, Minv, p_cp, ref)
    return DynamicsCache(ref=ref, Sw=Sw, Sv=Sv, blk=blk, Minv=Minv, J=J,
                         MinvJT_p=MinvJT_p, W=W, p_cp=p_cp)


def _applied_torques(model: RobotModel, params: SimParams,
                     state: PhysicsState, joint_torques: torch.Tensor):
    """(N, nv) generalized forces: none on the base, the motor torques plus
    the joint-limit one-sided springs on the joints."""
    tb = _tables(model, state.q.device)
    over_hi = torch.clamp(state.q - tb.dof_upper, min=0.0)
    under_lo = torch.clamp(tb.dof_lower - state.q, min=0.0)
    tau_lim = (params.joint_limit_stiffness * (under_lo - over_hi)
               - params.joint_limit_damping
               * ((over_hi > 0) | (under_lo > 0)).to(state.q.dtype)
               * state.qd)
    return torch.cat([torch.zeros_like(state.base_pos),
                      torch.zeros_like(state.base_pos),
                      joint_torques + tau_lim], dim=-1)


def _report_forces(model: RobotModel, cp_forces: torch.Tensor) -> ContactInfo:
    """Per-point forces summed onto the report bodies (the reference's
    one-hot contraction, kept: a deterministic sum on every device), and
    the foot points' own."""
    tb = _tables(model, cp_forces.device)
    seg = torch.einsum("pr,npi->nri", tb.rep_onehot, cp_forces)
    return ContactInfo(report_forces=seg,
                       foot_forces=cp_forces.index_select(1, tb.cp_feet))


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
    velocity terms, integration).

    With `params.use_pallas_contact`, through the dynamics-substep kernel:
    `p_cp` is the carried contact-point estimate, env-minor (P, 3, Npad)
    (starts at cache.pallas_ops.p_cp_t, advanced in the kernel by
    dt * J qd — no per-substep FK).  Returns (new_state, lam_t (P, 3, Npad)
    impulses of this substep, p_cp_new (P, 3, Npad)); the caller
    materialises forces once per control step with
    `contact_report_from_lam_t`.

    Without it, the dense route on an N-major cache: `p_cp` (N, P, 3)
    starts at cache.p_cp; fresh gaps come from `terrain.lookup` at it.
    Returns (new_state, ContactInfo, p_cp_new)."""
    if params.use_pallas_contact != (cache.pallas_ops is not None):
        raise ValueError(
            "the cache was built for the other route: "
            "build_dynamics_cache with the same SimParams.use_pallas_contact")
    if not params.use_pallas_contact:
        return _dense_substep_cached(model, params, state, joint_torques,
                                     dyn, terrain, cache, p_cp)
    f32 = state.base_pos.dtype
    dev = state.base_pos.device
    N = state.base_pos.shape[0]
    dt = params.dt
    # generalized velocity expressed at the anchor point
    delta = cache.ref - state.base_pos
    v_ref = state.base_lin_vel + torch.cross(state.base_ang_vel, delta,
                                             dim=-1)
    gen_vel = torch.cat([state.base_ang_vel, v_ref, state.qd], dim=-1)
    tau = _applied_torques(model, params, state, joint_torques)

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

    ang_new, v_ref_new, qd_new = _clip_velocities(model, params, gen_vel_new)
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
    tb = _tables(model, dev)
    qlo = tb.dof_lower[:, None]
    qhi = tb.dof_upper[:, None]

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
    tb = _tables(model, lam_t.device)
    seg = torch.zeros((N, model.num_report_bodies, 3), dtype=lam_t.dtype,
                      device=lam_t.device)
    seg.index_add_(1, tb.cp_report, forces)
    return ContactInfo(report_forces=seg,
                       foot_forces=forces[:, tb.cp_feet, :])


def foot_state_from_pcp_t(model: RobotModel, p_cp_t: torch.Tensor,
                          p_cp_prev_t: torch.Tensor, dt: float, N: int):
    """Foot positions & velocities from the env-minor carried contact
    points of the last substep: positions are the foot rows of p_cp,
    velocities the backward difference the kernel advanced them with.
    Returns ((N,4,3), (N,4,3)) in FL FR RL RR order."""
    feet = _tables(model, p_cp_t.device).cp_feet
    p_foot_t = p_cp_t[feet]
    v_foot_t = (p_cp_t[feet] - p_cp_prev_t[feet]) / dt
    return pc.from_env_minor(p_foot_t, N), pc.from_env_minor(v_foot_t, N)


# ---------------------------------------------------------------------------
# the dense route's substeps
# ---------------------------------------------------------------------------


def _clip_velocities(model: RobotModel, params: SimParams, gen_vel):
    """(ang, lin, qd) of a generalized velocity, each clipped: the base caps
    and the joints' URDF limits (PhysX maxVelocity)."""
    vlim = _tables(model, gen_vel.device).dof_vel_limit
    qd = torch.maximum(torch.minimum(gen_vel[:, 6:], vlim), -vlim)
    ang = torch.clamp(gen_vel[:, :3], -params.max_base_ang_vel,
                      params.max_base_ang_vel)
    lin = torch.clamp(gen_vel[:, 3:6], -params.max_base_lin_vel,
                      params.max_base_lin_vel)
    return ang, lin, qd


def _dense_substep_cached(model, params, state, joint_torques, dyn, terrain,
                          cache, p_cp):
    """`physics_substep_cached` on an N-major cache (the dense route)."""
    dt = params.dt
    # generalized velocity expressed at the anchor point
    delta = cache.ref - state.base_pos
    v_ref = state.base_lin_vel + torch.cross(state.base_ang_vel, delta,
                                             dim=-1)
    gen_vel = torch.cat([state.base_ang_vel, v_ref, state.qd], dim=-1)
    tau = _applied_torques(model, params, state, joint_torques)

    # midpoint (RK2) on the velocity-product terms (see physics_substep)
    def qdd_of(gv):
        Vw, Vv = body_twists(model, cache.Sw, cache.Sv, gv)
        b = bias_forces(model, cache.Sw, cache.Sv, Vw, Vv, cache.blk, gv,
                        dyn.gravity)
        qdd = torch.einsum("nij,nj->ni", cache.Minv, tau - b)
        w_x_v = torch.cross(gv[:, :3], gv[:, 3:6], dim=-1)
        return torch.cat([qdd[:, :3], qdd[:, 3:6] + w_x_v, qdd[:, 6:]], dim=-1)

    gv_mid = gen_vel + (0.5 * dt) * qdd_of(gen_vel)
    gen_vel_free = gen_vel + dt * qdd_of(gv_mid)
    if p_cp is None:
        p_cp = cache.p_cp
    if params.contact_enabled:
        # fresh contact gaps from the velocity-integrated point estimate;
        # cached J/W
        radius = _tables(model, p_cp.device).cp_radius
        h, n_srf = terrain.lookup(p_cp[..., 0], p_cp[..., 1])
        phi = h + radius[None, :] - p_cp[..., 2]
        mu = 0.5 * (dyn.friction[:, None] + 1.0)
        target_n = _normal_targets(params, cache.J, gen_vel_free, n_srf, phi,
                                   dyn.restitution[:, None], dt)
        lam, gen_vel_new = _impulse_iteration(
            params, cache.J, cache.MinvJT_p, cache.W, n_srf, target_n, mu,
            phi > 0.0, gen_vel_free)
        cp_forces = lam / dt
    else:
        cp_forces = torch.zeros_like(p_cp)
        gen_vel_new = gen_vel_free

    ang_new, v_ref_new, qd_new = _clip_velocities(model, params, gen_vel_new)
    # velocity back at the (moved) base point
    lin_new = v_ref_new - torch.cross(ang_new, delta, dim=-1)
    new_state = PhysicsState(
        base_pos=state.base_pos + dt * lin_new,
        base_quat=qops.quat_integrate(state.base_quat, ang_new, dt),
        base_lin_vel=lin_new, base_ang_vel=ang_new,
        q=state.q + dt * qd_new, qd=qd_new)
    # advance the contact-point estimate with the post-solve velocities
    gv_clipped = torch.cat([ang_new, v_ref_new, qd_new], dim=-1)
    p_cp_new = p_cp + dt * torch.einsum("npiv,nv->npi", cache.J, gv_clipped)
    return new_state, _report_forces(model, cp_forces), p_cp_new


def physics_substep(
    model: RobotModel,
    params: SimParams,
    state: PhysicsState,
    joint_torques: torch.Tensor,          # (N, 12)
    dyn: DynamicsParams,
    terrain: Terrain,
) -> tuple[PhysicsState, ContactInfo]:
    """One physics step at params.dt on the dense route (called `decimation`
    times per control step in exact mode): FK, twists, inertia, CRBA,
    M^-1, the unconstrained update by the midpoint rule, the contact solve
    at the FK points, clips and semi-implicit integration."""
    _check_fp32(state.base_pos)
    f32 = state.base_pos.dtype
    dev = state.base_pos.device
    dt = params.dt

    frames = forward_kinematics(model, state)
    ref = state.base_pos
    Sw, Sv = joint_twists(model, frames, ref)
    blk = inertia_blocks(model, frames, ref, dyn)
    # twist rows are [rot(3), trans(3), joints]: gen_vel is [ang, lin, qd]
    gen_vel = torch.cat(
        [state.base_ang_vel, state.base_lin_vel, state.qd], dim=-1)
    Vw, Vv = body_twists(model, Sw, Sv, gen_vel)
    M = mass_matrix(model, Sw, Sv, blk)
    if params.armature:
        arm = torch.cat([torch.zeros(6, dtype=f32, device=dev),
                         torch.full((model.nj,), params.armature, dtype=f32,
                                    device=dev)])
        M = M + torch.diag(arm)[None]
    M = M + 1e-7 * torch.eye(model.nv, dtype=f32, device=dev)[None]
    tau = _applied_torques(model, params, state, joint_torques)

    # The velocity-product terms (RNEA bias + the spatial->material w x v
    # correction for the base point) by the midpoint rule: explicit Euler
    # is unstable for the gyroscopic part, the midpoint update is
    # near-conservative through 40 rad/s.
    Minv = _mass_matrix_inverse(model, M)

    def qdd_of(gv, Vw_, Vv_):
        b = bias_forces(model, Sw, Sv, Vw_, Vv_, blk, gv, dyn.gravity)
        qdd = torch.einsum("nij,nj->ni", Minv, tau - b)
        # spatial -> material acceleration for the base point: the solved
        # linear part is the fixed-point (spatial) derivative; the material
        # particle at the reference adds w x v (Featherstone)
        base_wxv = torch.cross(gv[:, :3], gv[:, 3:6], dim=-1)
        return torch.cat([qdd[:, :3], qdd[:, 3:6] + base_wxv, qdd[:, 6:]],
                         dim=-1)

    gv_mid = gen_vel + (0.5 * dt) * qdd_of(gen_vel, Vw, Vv)
    Vw_m, Vv_m = body_twists(model, Sw, Sv, gv_mid)
    gen_vel_free = gen_vel + dt * qdd_of(gv_mid, Vw_m, Vv_m)

    # contact impulses on the post-free velocity (semi-implicit)
    if params.contact_enabled:
        dv, cp_forces, _ = _contact_solve(
            model, params, Minv, Sw, Sv, frames, ref, gen_vel_free, terrain,
            dyn, dt)
        gen_vel_new = gen_vel_free + dv
    else:
        P = model.cp_body.shape[0]
        cp_forces = torch.zeros((state.q.shape[0], P, 3), dtype=f32,
                                device=dev)
        gen_vel_new = gen_vel_free

    ang_new, lin_new, qd_new = _clip_velocities(model, params, gen_vel_new)
    # semi-implicit Euler position update
    new_state = PhysicsState(
        base_pos=state.base_pos + dt * lin_new,
        base_quat=qops.quat_integrate(state.base_quat, ang_new, dt),
        base_lin_vel=lin_new, base_ang_vel=ang_new,
        q=state.q + dt * qd_new, qd=qd_new)
    return new_state, _report_forces(model, cp_forces)


def foot_state_from_cache(model: RobotModel, cache: DynamicsCache,
                          state: PhysicsState, p_cp: torch.Tensor):
    """Foot positions & velocities from the carried contact-point estimate
    and the cached Jacobians of the dense route's reuse mode (the foot
    contact points coincide with the feet: same body, same offset).
    Returns ((N,4,3), (N,4,3)) in FL FR RL RR order."""
    feet = _tables(model, p_cp.device).cp_feet
    p_foot = p_cp.index_select(1, feet)
    delta = cache.ref - state.base_pos
    v_ref = state.base_lin_vel + torch.cross(state.base_ang_vel, delta,
                                             dim=-1)
    gv = torch.cat([state.base_ang_vel, v_ref, state.qd], dim=-1)
    v_foot = torch.einsum("nfiv,nv->nfi", cache.J.index_select(1, feet), gv)
    return p_foot, v_foot


def foot_positions_velocities(model: RobotModel, state: PhysicsState):
    """World foot positions & velocities from FK (reference rigid_body_state
    slices, legged_robot.py:112-115). Returns ((N,4,3), (N,4,3))."""
    tb = _tables(model, state.base_pos.device)
    frames = forward_kinematics(model, state)
    Rb = frames.R.index_select(1, tb.foot_body)
    pb = frames.p.index_select(1, tb.foot_body)
    p_foot = pb + torch.einsum("nfij,fj->nfi", Rb, tb.foot_offset)
    # velocity = body twist at the foot point
    gen_vel = torch.cat(
        [state.base_ang_vel, state.base_lin_vel, state.qd], dim=-1)
    Sw, Sv = joint_twists(model, frames, state.base_pos)
    Vw, Vv = body_twists(model, Sw, Sv, gen_vel)             # about base ref
    w = Vw.index_select(1, tb.foot_body)
    v = Vv.index_select(1, tb.foot_body)
    r = p_foot - state.base_pos[:, None, :]
    return p_foot, v + torch.cross(w, r, dim=-1)
