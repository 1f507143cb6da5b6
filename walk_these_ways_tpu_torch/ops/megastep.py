"""The WHOLE control step in one kernel launch, env-minor.

Counterpart of the JAX package's ops/pallas_megastep.py.  Three things live
here:

- `control_step_reference`: the plain PyTorch version, same signature and
  outputs as the JAX `control_step_pallas`, composed from the plain cores
  `ops/contact.cache_core`, `ops/dynamics.dyn_core`,
  `ops/contact.contact_core` and, in exact mode, the cache rebuild
  `physics/envminor.cache_columns` before every substep.  It runs anywhere
  and is what the kernel is held against.
- `control_step`: the wrapper.  CPU tensors go to the plain version; CUDA
  tensors go to the hand-written kernel `csrc/megastep_team.cu` (it
  replaces `ops/pallas_megastep.py::_megastep_kernel`), or the call raises.
  There is no fallback from the kernel to the plain version.  It runs one
  warp per env and builds the dynamics cache inside its launch: in reuse
  mode once, from the entry state, with the heightfield sampled there
  (`entry_inputs`): K4 (flat ground) and K4b (on a heightfield) with the
  actuator network, K4c and K4b-P with P control; in exact mode
  (`exact_inputs`, flat ground) before every substep: K5 with the actuator
  network, K5-P with P control.
- `blockdiag_actuator_weights`: host helper that lays the 12 per-joint
  actuator MLPs (6 -> 32 -> 32 -> 1, softsign) out as block-diagonal
  matrices, with features stacked as X[12 f + j] = feature f of joint j.
  The plain version evaluates them as three dense products; the kernel
  reads only the nonzero blocks.

The kernel is built at first use with `nvcc` for sm_90a into `build/` at
the repo root (or `$WTW_TORCH_BUILD_DIR`), from its source and a topology
header generated from the RobotModel, and is bound through `ctypes`
(ops/_build.py, shared by all the port's kernels).

Bound of the kernel on an H100 (see its source and `work_per_env`): a few
KB moved and 0.1-0.6 MFLOP fp32 per env and control step; at 4000 envs the
least time is tens of microseconds and is set by arithmetic.

`launches` (K4), `p_launches` (K4c), `normal_launches` (K4b),
`p_normal_launches` (K4b-P), `exact_launches` (K5) and `p_exact_launches`
(K5-P) count kernel launches (and nothing else).
"""
from __future__ import annotations

import numpy as np
import torch

from ..physics import envminor
from . import _build
from . import contact as pc
from . import dynamics as pd

# number of times `control_step` launched each kernel variant: K4 (reuse,
# actuator network), K4c (reuse, P control), K4b (reuse on a heightfield,
# actuator network), K4b-P (the same with P control), K5 (exact mode,
# actuator network), K5-P (exact mode, P control)
launches = 0
p_launches = 0
normal_launches = 0
p_normal_launches = 0
exact_launches = 0
p_exact_launches = 0

# csrc/megastep_team.cu: one warp of 32 lanes per env, TEAM_ENVS envs
# (TEAM_THREADS threads) per block; the env axis is padded to
# engine.MEGASTEP_BLOCK, which TEAM_ENVS divides
TEAM_ENVS = 8
TEAM_THREADS = 32 * TEAM_ENVS


def blockdiag_actuator_weights(params, device="cuda"):
    """ActuatorNetParams-like (w0 (32,6), b0, w1 (32,32), b1, w2 (1,32), b2,
    numpy or tensors) -> block-diagonal (W0b (384, 72), b0b (384, 1),
    W1b (384, 384), b1b (384, 1), W2b (12, 384), b2b (12, 1)) tensors so
    the 12 per-joint MLPs evaluate as three products on feature-stacked
    inputs X (72, B) with X[12f + j] = feature f of joint j."""
    def _np(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    w0, b0 = _np(params.w0), _np(params.b0)   # (32, 6)
    w1, b1 = _np(params.w1), _np(params.b1)   # (32, 32)
    w2, b2 = _np(params.w2), _np(params.b2)   # (1, 32)
    H, F = w0.shape                           # 32, 6
    J = 12
    W0b = np.zeros((J * H, J * F), np.float32)
    W1b = np.zeros((J * H, J * H), np.float32)
    W2b = np.zeros((J, J * H), np.float32)
    for j in range(J):
        for f in range(F):
            W0b[j * H:(j + 1) * H, f * J + j] = w0[:, f]
        W1b[j * H:(j + 1) * H, j * H:(j + 1) * H] = w1
        W2b[j, j * H:(j + 1) * H] = w2[0]
    b0b = np.tile(b0, J)[:, None]
    b1b = np.tile(b1, J)[:, None]
    b2b = np.full((J, 1), float(b2[0]), np.float32)
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in (W0b, b0b, W1b, b1b, W2b, b2b))


# packed actuator weights of the team kernel, by the block-diagonal
# matrices' storage and version (the env makes them once); each entry holds
# its source tensors, so that no other tensor takes their storage while the
# entry lives
_team_weights = {}


def team_actuator_weights(W0b, b0b, W1b, b1b, W2b, b2b):
    """The nonzero blocks of `blockdiag_actuator_weights`' matrices in the
    layout csrc/megastep_team.cu reads (its NET_* offsets), one contiguous
    float32 vector: per joint j, W0[j][f][o], then b0[j][o], W1[j][i][o],
    b1[j][o], W2[o][j], b2[j] — hidden unit o innermost, so that the 32
    lanes of an env (one per unit) read consecutive floats.  Made once per
    weight set and kept."""
    key = tuple((x.data_ptr(), x._version, str(x.device))
                for x in (W0b, b0b, W1b, b1b, W2b, b2b))
    if key not in _team_weights:
        nj = W2b.shape[0]
        H, F = W1b.shape[0] // nj, W0b.shape[1] // nj
        j = torch.arange(nj, device=W0b.device)
        w0 = W0b.reshape(nj, H, F, nj)[j, :, :, j].permute(0, 2, 1)
        w1 = W1b.reshape(nj, H, nj, H)[j, :, j, :].permute(0, 2, 1)
        w2 = W2b.reshape(nj, nj, H)[j, j, :].t()
        if len(_team_weights) > 8:
            _team_weights.clear()
        _team_weights[key] = ((W0b, b0b, W1b, b1b, W2b, b2b), torch.cat(
            [x.reshape(-1) for x in (w0, b0b.reshape(nj, H), w1,
                                     b1b.reshape(nj, H), w2,
                                     b2b.reshape(nj))]).contiguous())
    return _team_weights[key][1]


# the plain version's tables on the device, one per (model, name, device):
# a host array copied each call would be a host-to-device copy every step;
# the entry keeps the model alive, so its id is not reused
_DEVICE_TABLES = {}


def _device_table(model, name, array, dev):
    key = (id(model), name, str(dev))
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = _DEVICE_TABLES[key] = (model, torch.tensor(
            array, dtype=torch.float32, device=dev))
    return hit[1]


def _softsign(x):
    return x / (1.0 + torch.abs(x))


def _cross3(a, b):
    """(3, B) x (3, B) -> (3, B)."""
    return torch.cat([
        a[1:2] * b[2:3] - a[2:3] * b[1:2],
        a[2:3] * b[0:1] - a[0:1] * b[2:3],
        a[0:1] * b[1:2] - a[1:2] * b[0:1]], dim=0)


def _quat_integrate(quat, omega, dt):
    """(4, B) xyzw rows, (3, B) world angular velocity -> (4, B).
    Matches ops/quat.py:quat_integrate step for step (norm guard, axis
    renormalization inside quat_from_angle_axis, final normalize)."""
    angle = torch.sqrt(omega[0:1] ** 2 + omega[1:2] ** 2
                       + omega[2:3] ** 2)                     # (1, B)
    axis = omega / torch.clamp(angle, min=1e-9)
    # quat_from_angle_axis re-normalizes the axis
    an = torch.sqrt(axis[0:1] ** 2 + axis[1:2] ** 2 + axis[2:3] ** 2)
    axis = axis / torch.clamp(an, min=1e-9)
    half = 0.5 * (angle * dt)
    s = torch.sin(half)
    dq = torch.cat([axis * s, torch.cos(half)], dim=0)       # (4, B)
    dx, dy, dz, dw = dq[0:1], dq[1:2], dq[2:3], dq[3:4]
    qx, qy, qz, qw = quat[0:1], quat[1:2], quat[2:3], quat[3:4]
    rx = dw * qx + dx * qw + dy * qz - dz * qy
    ry = dw * qy - dx * qz + dy * qw + dz * qx
    rz = dw * qz + dx * qy - dy * qx + dz * qw
    rw = dw * qw - dx * qx - dy * qy - dz * qz
    norm = torch.sqrt(rx * rx + ry * ry + rz * rz + rw * rw)
    inv = 1.0 / torch.clamp(norm, min=1e-9)
    return torch.cat([rx, ry, rz, rw], dim=0) * inv


def _topology(model):
    """Static tables of the robot the kernel and the plain version share."""
    return _build.topology(model.anc_dof_body, model.cp_body)


def _cache_arrays(model, q, quat, pos, payload, comdisp):
    """Exact mode's cache from the CURRENT state: envminor.cache_columns
    (FK + twist bases + inertia blocks + block CRBA + closed-form M^-1) on
    env-minor rows, stacked into the layouts the cores consume, about the
    current base position (delta = 0)."""
    nb, nj = model.nb, model.nj
    Sw, Sv, Minv, A_blk, B_blk, mb, r_cp, p_cp = envminor.cache_columns(
        model, [q[j] for j in range(nj)], [quat[i] for i in range(4)],
        [pos[i] for i in range(3)], payload[0],
        [comdisp[i] for i in range(3)])
    stk = torch.stack
    Sw_a = stk([stk(v) for v in Sw])                  # (nv, 3, Npad)
    Sv_a = stk([stk(v) for v in Sv])
    Minv_a = stk([stk(row) for row in Minv])          # (nv, nv, Npad)
    A9 = stk([stk([A_blk[b][i][j] for i in range(3) for j in range(3)])
              for b in range(nb)])                    # (nb, 9, Npad)
    B9 = stk([stk([B_blk[b][i][j] for i in range(3) for j in range(3)])
              for b in range(nb)])
    m_a = stk(mb)                                     # (nb, Npad)
    r_a = stk([stk(v) for v in r_cp])                 # (P, 3, Npad)
    pcp_a = stk([stk(v) for v in p_cp])
    return Sw_a, Sv_a, A9, B9, m_a, Minv_a, r_a, pcp_a


def entry_cache_reference(model, q_t, quat_t, pos_t, rh_t, entry_inputs):
    """The entry cache that the team kernel (K4, K4b, K4c, K4b-P) builds
    inside its launch, eagerly:
    `_cache_arrays` (physics/envminor.cache_columns, the eager build's
    arithmetic) about the entry base position, and on a heightfield the
    height and the unit normal under each entry contact point
    (`Terrain.lookup`), rh = h + radius.  `rh_t` (P, Npad) holds the point
    radii.  Returns (EnvMinorCache, rh_t, n_t (P, 3, Npad) or None).  The
    padded env lanes are built from their zero state like the valid ones:
    their normals are unit vectors with a positive z, as the lookup gives
    everywhere."""
    payload_t, comdisp_t, terrain = entry_inputs
    Sw, Sv, A9, B9, m_a, Minv, r, pcp = _cache_arrays(
        model, q_t, quat_t, pos_t, payload_t, comdisp_t)
    em = envminor.EnvMinorCache(Sw_t=Sw, Sv_t=Sv, Minv_t=Minv, A_t=A9,
                                B_t=B9, m_t=m_a, r_t=r, p_cp_t=pcp)
    n_t = None
    if terrain is not None:
        h, n = terrain.lookup(pcp[:, 0], pcp[:, 1])     # (P, Npad) (+ 3)
        rh_t = h + rh_t
        n_t = n.permute(0, 2, 1).contiguous()
    return em, rh_t, n_t


def control_step_reference(em, rh_t, mu_t, e_t, g_t, n_t,
                           q_t, qd_t, pos_t, quat_t, lin_t, ang_t,
                           tgt_t, strengths_t, ctrl_inputs,
                           vlim, tlim, qlo, qhi, lam_in_t=None, *,
                           model, control_type: str,
                           dt: float, num_iters: int, warm_iters: int = 0,
                           relaxation: float,
                           baumgarte: float, slop: float, max_depen: float,
                           bounce_thresh: float, contact: bool,
                           limit_stiffness: float, limit_damping: float,
                           max_base_ang_vel: float, max_base_lin_vel: float,
                           decimation: int, eps: float = 1e-6,
                           exact_inputs=None, entry_inputs=None):
    """One whole control step (`decimation` physics substeps), env-minor,
    in plain PyTorch.

    `em` is the physics/envminor.EnvMinorCache for the entry state;
    `tgt_t` (D, 12, Npad) carries per-substep effective joint-position
    targets; `ctrl_inputs` is (kp_eff_t, kd_eff_t) for P control or
    (W0b, b0b, W1b, b1b, W2b, b2b, el_t, ell_t, vl_t, vll_t) for the
    actuator network.  `vlim`/`tlim`/`qlo`/`qhi` are (rows, 1) per-dof
    bound columns.  `n_t` is None on flat ground, else (P, 3, Npad) surface
    normals.  `lam_in_t` (P, 3, Npad) is the cross-step warm seed.

    `exact_inputs`: None for reuse mode (cache from `em`, anchored at the
    entry state), or (payload_t (1, Npad), comdisp_t (3, Npad)) for exact
    mode: the whole cache is rebuilt from the current state before every
    substep and every contact solve starts cold (flat ground only: `n_t`,
    `em` and `lam_in_t` must be None).

    `entry_inputs`: None, or (payload_t (1, Npad), comdisp_t (3, Npad),
    terrain) for reuse mode with the entry cache built here from the entry
    state (`entry_cache_reference`: the eager build, and on a heightfield
    `terrain` (physics/engine.Terrain) sampled at the entry contact
    points; None on flat ground), as the team kernel builds it in its
    launch; `em` and `n_t` must then be None.

    Returns (q, qd, pos, quat, lin, ang, pcp, pcp_prev, lam, tau_last
    [, el, ell, vl, vll]) — all env-minor."""
    nv, nb = model.nv, model.nb
    nj = nv - 6
    P = model.cp_body.shape[0]
    D = decimation
    f32 = q_t.dtype
    dev = q_t.device
    bt = tuple(q_t.shape[1:])
    exact = exact_inputs is not None
    if exact and (n_t is not None or lam_in_t is not None):
        raise ValueError("exact mode is flat-ground only and starts every "
                         "contact solve cold (no n_t, no lam_in_t)")
    if entry_inputs is not None:
        if exact or em is not None or n_t is not None:
            raise ValueError("entry_inputs: reuse mode, the cache and the "
                             "normals built from the entry state (no em, "
                             "no n_t)")
        em, rh_t, n_t = entry_cache_reference(model, q_t, quat_t, pos_t,
                                              rh_t, entry_inputs)

    anc, anc_p, groups = _topology(model)
    joint_body = np.asarray(model.joint_body)
    anc_pn = _device_table(model, "anc_p", anc_p, dev)
    warm0 = lam_in_t is not None

    q, qd, pos, quat, lin, ang = q_t, qd_t, pos_t, quat_t, lin_t, ang_t
    if control_type == "P":
        kp, kd = ctrl_inputs
        hist = ()
    else:
        W0b, b0b, W1b, b1b, W2b, b2b, el, ell, vl, vll = ctrl_inputs
        hist = (el, ell, vl, vll)

    if exact:
        payload_t, comdisp_t = exact_inputs
        pcp = torch.zeros((P, 3) + bt, dtype=f32, device=dev)  # fresh FK below
    else:
        Sw, Sv, Ab, Bb, mb, Minv, pcp = (em.Sw_t, em.Sv_t, em.A_t, em.B_t,
                                         em.m_t, em.Minv_t, em.p_cp_t)
        # contact cache once per control step; r = contact points about the
        # anchor (= entry base position)
        r = pcp - pos.unsqueeze(0)
        J, W = pc.cache_core(anc_pn, Sw, Sv, Minv, r, eps=eps)

    ref_pt = pos
    pcp_prev = pcp
    lam = (torch.zeros((P, 3) + bt, dtype=f32, device=dev)
           if lam_in_t is None else lam_in_t)
    tau_m = torch.zeros((nj,) + bt, dtype=f32, device=dev)
    zeros6 = torch.zeros((6,) + bt, dtype=f32, device=dev)
    vlim_j = vlim[6:]

    for si in range(D):
        tgt_s = tgt_t[si]
        # warm start: substeps after the first seed the iteration with the
        # previous substep's impulses and run the shorter warm iteration
        # count; with a cross-step seed the first substep warm-starts too.
        # Exact mode always starts cold.
        warm = not exact and warm_iters > 0 and (si > 0 or warm0)

        # -- torque model --
        if control_type == "P":
            tau_m = kp * (tgt_s - q) - kd * qd
        else:
            el, ell, vl, vll = hist
            err = q - tgt_s
            X = torch.cat([err, el, ell, qd, vl, vll], dim=0)
            h = _softsign(W0b @ X + b0b)
            h = _softsign(W1b @ h + b1b)
            tau_m = W2b @ h + b2b
            hist = (err, el, qd, vl)
        tau_m = tau_m * strengths_t
        tau_m = torch.maximum(torch.minimum(tau_m, tlim), -tlim)

        # joint-limit torques
        over = torch.clamp(q - qhi, min=0.0)
        under = torch.clamp(qlo - q, min=0.0)
        at_lim = torch.logical_or(over > 0, under > 0).to(f32)
        tau_lim = limit_stiffness * (under - over) \
            - limit_damping * at_lim * qd
        tau_full = torch.cat([zeros6, tau_m + tau_lim], dim=0)

        if exact:
            # the whole cache from the current state, re-anchored at the
            # current base position (delta = 0); fresh FK contact points
            Sw, Sv, Ab, Bb, mb, Minv, r, pcp = _cache_arrays(
                model, q, quat, pos, payload_t, comdisp_t)
            J, W = pc.cache_core(anc_pn, Sw, Sv, Minv, r, eps=eps)
            ref_pt = pos

        # -- unconstrained dynamics at the anchor point, midpoint rule --
        delta = ref_pt - pos
        v_ref = lin + _cross3(ang, delta)
        gv = torch.cat([ang, v_ref, qd], dim=0)               # (nv, B)
        qdd1 = pd.dyn_core(Sw, Sv, Ab, Bb, mb, Minv, g_t, tau_full, gv,
                           anc=anc, joint_body=joint_body,
                           nb=nb, nj=nj, nv=nv)
        gv_mid = gv + (0.5 * dt) * qdd1
        qdd = pd.dyn_core(Sw, Sv, Ab, Bb, mb, Minv, g_t, tau_full, gv_mid,
                          anc=anc, joint_body=joint_body,
                          nb=nb, nj=nj, nv=nv)
        gv_free = gv + dt * qdd

        # -- contact solve + point advance --
        if contact:
            gv_new, pcp_new, lam = pc.contact_core(
                J, W, Minv, pcp, gv_free, rh_t, mu_t, e_t, vlim,
                num_iters=warm_iters if warm else num_iters,
                relaxation=relaxation, dt=dt,
                baumgarte=baumgarte, slop=slop, max_depen=max_depen,
                bounce_thresh=bounce_thresh, groups=groups, n=n_t,
                lam0=lam if warm else None)
        else:
            gv_new = gv_free
            pcp_new = pcp
            lam = torch.zeros((P, 3) + bt, dtype=f32, device=dev)
        pcp_prev = pcp
        pcp = pcp_new

        # -- clips + integration --
        qd = torch.maximum(torch.minimum(gv_new[6:], vlim_j), -vlim_j)
        ang = torch.clamp(gv_new[0:3], -max_base_ang_vel, max_base_ang_vel)
        v_ref_n = torch.clamp(gv_new[3:6], -max_base_lin_vel,
                              max_base_lin_vel)
        lin = v_ref_n - _cross3(ang, delta)
        pos = pos + dt * lin
        quat = _quat_integrate(quat, ang, dt)
        q = q + dt * qd

    results = [q, qd, pos, quat, lin, ang, pcp, pcp_prev, lam, tau_m]
    if control_type != "P":
        results += list(hist)
    return tuple(results)


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


def topology_header(model, hidden: int, features: int) -> str:
    """C header with the robot's static tables for csrc/megastep_team.cu:
    the topology, and the model constants of the cache build."""
    return (_build.topology_header(model.anc_dof_body, model.joint_body,
                                   model.cp_body, hidden, features)
            + _build.model_tables(model))


_N_IN, _N_OUT, _N_F = 27, 14, 15


def library_spec(model, hidden: int = 32, features: int = 6):
    """What `_build.build_libraries` needs to build csrc/megastep_team.cu
    (K4, K4b, K4c, K4b-P, K5, K5-P)."""
    return ("megastep_team", topology_header(model, hidden, features),
            (_N_IN, _N_OUT, _N_F))


def build_library(model, hidden: int = 32, features: int = 6):
    """Compile the kernel's source for sm_90a (once per topology and
    source) and load it.  Returns the ctypes library.  Raises on any
    failure."""
    return _build.build_library(*library_spec(model, hidden, features))


def control_step(em, rh_t, mu_t, e_t, g_t, n_t,
                 q_t, qd_t, pos_t, quat_t, lin_t, ang_t,
                 tgt_t, strengths_t, ctrl_inputs,
                 vlim, tlim, qlo, qhi, lam_in_t=None, *,
                 model, control_type: str,
                 dt: float, num_iters: int, warm_iters: int = 0,
                 relaxation: float,
                 baumgarte: float, slop: float, max_depen: float,
                 bounce_thresh: float, contact: bool,
                 limit_stiffness: float, limit_damping: float,
                 max_base_ang_vel: float, max_base_lin_vel: float,
                 decimation: int, eps: float = 1e-6, exact_inputs=None,
                 entry_inputs=None):
    """One whole control step, env-minor; arguments and results as
    `control_step_reference`.

    Tensors on the CPU: the plain version, with `entry_inputs` the eager
    build of the entry cache (`entry_cache_reference`) first.  Tensors on a
    CUDA device: csrc/megastep_team.cu, launched on the current stream
    without synchronising, outputs allocated here: reuse mode takes
    `entry_inputs`, and the kernel builds the entry cache and samples the
    heightfield in its launch (K4, K4b with the actuator network, K4c,
    K4b-P with P control); exact mode takes `exact_inputs`, and the kernel
    rebuilds the cache before every substep (K5, K5-P).  It takes no
    host-built cache `em` or normals `n_t`.  Exact mode with `n_t` raises
    on every device, as does anything else the kernel does not take on a
    CUDA device and a failed build or launch."""
    global launches, p_launches, normal_launches, p_normal_launches
    global exact_launches, p_exact_launches
    kw = dict(model=model, control_type=control_type, dt=dt,
              num_iters=num_iters, warm_iters=warm_iters,
              relaxation=relaxation, baumgarte=baumgarte, slop=slop,
              max_depen=max_depen, bounce_thresh=bounce_thresh,
              contact=contact, limit_stiffness=limit_stiffness,
              limit_damping=limit_damping,
              max_base_ang_vel=max_base_ang_vel,
              max_base_lin_vel=max_base_lin_vel, decimation=decimation,
              eps=eps, exact_inputs=exact_inputs, entry_inputs=entry_inputs)
    dev = q_t.device
    if dev.type == "cpu":
        return control_step_reference(
            em, rh_t, mu_t, e_t, g_t, n_t, q_t, qd_t, pos_t, quat_t, lin_t,
            ang_t, tgt_t, strengths_t, ctrl_inputs, vlim, tlim, qlo, qhi,
            lam_in_t, **kw)
    if dev.type != "cuda":
        raise ValueError(f"control_step: unsupported device {dev}")
    if exact_inputs is not None and n_t is not None:
        raise ValueError("exact mode is flat-ground only: n_t must be None")
    if control_type not in ("P", "actuator_net"):
        raise ValueError(f"control_step: unknown control_type "
                         f"{control_type!r}")
    if exact_inputs is not None and lam_in_t is not None:
        raise ValueError("exact mode starts every contact solve cold: "
                         "lam_in_t must be None")
    ptrs, outs, floats, ints, (H, F) = kernel_operands(
        em, rh_t, mu_t, e_t, g_t, n_t, q_t, qd_t, pos_t, quat_t, lin_t, ang_t,
        tgt_t, strengths_t, ctrl_inputs, vlim, tlim, qlo, qhi, lam_in_t, **kw)
    lib = build_library(model, H, F)
    with torch.cuda.device(dev):
        _build.launch(lib, "megastep_team", ptrs, outs, floats, ints,
                      torch.cuda.current_stream(dev).cuda_stream)
    if exact_inputs is not None and control_type == "P":
        p_exact_launches += 1
    elif exact_inputs is not None:
        exact_launches += 1
    elif control_type == "P" and entry_inputs[2] is not None:
        p_normal_launches += 1
    elif control_type == "P":
        p_launches += 1
    elif entry_inputs[2] is not None:
        normal_launches += 1
    else:
        launches += 1
    return tuple(o for o in outs if o is not None)


def kernel_operands(em, rh_t, mu_t, e_t, g_t, n_t, q_t, qd_t, pos_t, quat_t,
                    lin_t, ang_t, tgt_t, strengths_t, ctrl_inputs,
                    vlim, tlim, qlo, qhi, lam_in_t=None, *,
                    model, control_type: str, dt: float, num_iters: int,
                    warm_iters: int = 0, relaxation: float, baumgarte: float,
                    slop: float, max_depen: float, bounce_thresh: float,
                    contact: bool, limit_stiffness: float,
                    limit_damping: float, max_base_ang_vel: float,
                    max_base_lin_vel: float, decimation: int,
                    eps: float = 1e-6, exact_inputs=None, entry_inputs=None):
    """The arguments of `megastep_team_launch` (csrc/megastep_team.cu,
    reuse mode: `entry_inputs`; exact mode: `exact_inputs`) for one control
    step (csrc/wtw_megastep.cuh): input pointers in InIdx order (null where
    the variant reads nothing), the output tensors, allocated on the
    inputs' device, in OutIdx order (None where the variant writes
    nothing), the FIdx floats, the IntIdx ints and the actuator network's
    (hidden, features).  The kernel builds the dynamics cache itself: a
    host-built cache `em` or normals `n_t` raise, as does a call with
    neither or both of `entry_inputs` and `exact_inputs`.  Checks every
    operand's device, dtype, shape and contiguity."""
    dev = q_t.device
    pctrl = control_type == "P"
    exact = exact_inputs is not None
    entry = entry_inputs is not None
    if exact == entry:
        raise ValueError("the kernel takes reuse mode with entry_inputs "
                         "or exact mode with exact_inputs")
    if em is not None or n_t is not None:
        raise ValueError("the kernel builds the cache and samples the "
                         "normals itself: em and n_t must be None")
    terrain = entry_inputs[2] if entry else None

    nv = model.nv
    nj = nv - 6
    P = model.cp_body.shape[0]
    D = int(decimation)
    Npad = q_t.shape[-1]
    H, F = 32, 6
    if pctrl:
        kp_t, kd_t = ctrl_inputs
        net = ()
    else:
        W0b, b0b, W1b, b1b, W2b, b2b, el_t, ell_t, vl_t, vll_t = ctrl_inputs
        H = W1b.shape[0] // nj
        F = W0b.shape[1] // nj
        if F != 6:
            raise NotImplementedError(
                "actuator network with 6 inputs per joint")
        blocks = (("W0b", W0b, (nj * H, nj * F)), ("b0b", b0b, (nj * H, 1)),
                  ("W1b", W1b, (nj * H, nj * H)), ("b1b", b1b, (nj * H, 1)),
                  ("W2b", W2b, (nj, nj * H)), ("b2b", b2b, (nj, 1)))
        for name, x, shape in blocks:
            _build.check(name, x, shape, dev)
        # the kernel reads the packed nonzero blocks
        net = (("net_t", team_actuator_weights(*ctrl_inputs[:6]),
                (nj * (F * H + H * H + 3 * H + 1),)),
               ("el_t", el_t, (nj, Npad)), ("ell_t", ell_t, (nj, Npad)),
               ("vl_t", vl_t, (nj, Npad)), ("vll_t", vll_t, (nj, Npad)))
    given = dict((name, (x, shape)) for name, x, shape in net + (
        ("rh_t", rh_t, (P, Npad)), ("mu_t", mu_t, (1, Npad)),
        ("e_t", e_t, (1, Npad)), ("g_t", g_t, (3, Npad)),
        ("q_t", q_t, (nj, Npad)), ("qd_t", qd_t, (nj, Npad)),
        ("pos_t", pos_t, (3, Npad)), ("quat_t", quat_t, (4, Npad)),
        ("lin_t", lin_t, (3, Npad)), ("ang_t", ang_t, (3, Npad)),
        ("tgt_t", tgt_t, (D, nj, Npad)),
        ("strengths_t", strengths_t, (nj, Npad)),
        ("vlim", vlim, (nv, 1)), ("tlim", tlim, (nj, 1)),
        ("qlo", qlo, (nj, 1)), ("qhi", qhi, (nj, 1))))
    if lam_in_t is not None:
        given["lam_in_t"] = (lam_in_t, (P, 3, Npad))
    if pctrl:
        given["kp_t"] = (kp_t, (nj, Npad))
        given["kd_t"] = (kd_t, (nj, Npad))
    payload_t, comdisp_t = (exact_inputs if exact else entry_inputs)[:2]
    given["payload_t"] = (payload_t, (1, Npad))
    given["comdisp_t"] = (comdisp_t, (3, Npad))
    hs, ox, oy, c_rows, c_cols = 1.0, 0.0, 0.0, 0, 0
    if terrain is not None:
        c_rows, c_cols = (int(x) for x in terrain.corners.shape[:2])
        given["corners"] = (terrain.corners, (c_rows, c_cols, 4))
        hs = terrain.horizontal_scale
        ox, oy = terrain.origin_xy
    # the kernel's input slots, in csrc/wtw_megastep.cuh's InIdx order; a
    # slot the variant does not read stays null
    slots = ("rh_t", "mu_t", "e_t", "g_t", "lam_in_t", "q_t", "qd_t",
             "pos_t", "quat_t", "lin_t", "ang_t", "tgt_t", "strengths_t",
             "el_t", "ell_t", "vl_t", "vll_t", "vlim", "tlim", "qlo", "qhi",
             "kp_t", "kd_t", "payload_t", "comdisp_t", "corners", "net_t")
    assert len(slots) == _N_IN and set(given) <= set(slots)
    ptrs = [None if name not in given else
            _build.check(name, given[name][0], given[name][1], dev).data_ptr()
            for name in slots]

    n_out = 10 if pctrl else 14
    out_shapes = [(nj, Npad), (nj, Npad), (3, Npad), (4, Npad), (3, Npad),
                  (3, Npad), (P, 3, Npad), (P, 3, Npad), (P, 3, Npad),
                  (nj, Npad)] + [(nj, Npad)] * 4
    outs = [torch.empty(s, dtype=torch.float32, device=dev)
            for s in out_shapes[:n_out]] + [None] * (_N_OUT - n_out)
    floats = (dt, relaxation, baumgarte / dt, slop, max_depen, bounce_thresh,
              limit_stiffness, limit_damping, max_base_ang_vel,
              max_base_lin_vel, eps, 0.5 * dt, hs, ox, oy)
    ints = (Npad, D, num_iters, warm_iters, bool(contact), TEAM_THREADS,
            pctrl, exact, terrain is None, c_rows, c_cols)
    return ptrs, outs, floats, ints, (H, F)


def cache_rebuild_ops(model) -> int:
    """fp32 operations per env of the exact-mode cache rebuild
    (csrc/wtw_cache.cuh over `envminor.cache_columns`: FK, twists, inertia,
    CRBA, closed-form M^-1, contact points), counted from the robot's static
    structure as `work_per_env` counts the rest: the model's constants cost
    nothing, and products by the static zeros of the joint rotations, axes,
    anchors, offsets and skew matrices are left out."""
    nb, nj, nv = model.nb, model.nj, model.nv
    nz = np.count_nonzero

    def mv(k):           # 3x3 data matrix times a static vector, k nonzeros
        return 3 * max(2 * k - 1, 0)

    ops = 9 + 21                          # base R from the quaternion
    for a, an in zip(np.asarray(model.joint_axis, np.float64),
                     np.asarray(model.joint_anchor)):
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        terms = (np.eye(3) != 0).astype(int) + (K != 0) + (K @ K != 0)
        # sin, cos, 1 - cos; rot = I + K sin + K^2 (1 - cos)
        ops += 3 + nz(K) + nz(K @ K) + int(np.maximum(terms - 1, 0).sum())
        ops += mv(nz(an)) + 3 + mv(nz(a))             # anchor, axis in world
        ops += sum(mv(nz(col)) for col in (terms > 0).T)   # R_parent rot
    ops += 12 * nj                        # twists: (anchor - ref) x axis
    ops += sum(mv(nz(c)) + 3 for c in np.asarray(model.com))
    ops += 1 + mv(3) + 3 + 1 + nz(model.inertia[0])   # payload, COM shift,
    #                                                  base inertia scale
    for inertia in np.asarray(model.inertia).reshape(nb, 3, 3):
        # I_l R^T, R (I_l R^T), r, m [r]x, m [r]x [r]x (15), A
        ops += sum(mv(nz(row)) for row in inertia) + 45 + 3 + 6 + 15 + 9
    jb = np.asarray(model.joint_body)
    n_sub = np.asarray(model.anc_dof_body)[6:].sum(axis=1)
    ops += 19 * (nb - 1)                  # CRBA: base totals of A, B, m
    ops += int(19 * (n_sub - 1).sum()) + 54 * nj    # composites, columns
    ops += 11 * nz(np.asarray(model.subtree)[jb[:, None], jb[None, :]]) + nv
    inv3, legs = 49, nj // 3              # adjugate inverse of A + eps I
    ops += legs * inv3 + 30 * nj + 72 * nj        # D^-1, B D^-1, Schur S
    ops += 2 * inv3 + 4 * 45 + 9 + 54 + 9         # S^-1 by its 3x3 Schur
    ops += 66 * nj + 6 * nj + 11 * nj * nj + 9 * legs   # T, -T, leg block
    ops += sum(mv(nz(o)) + 3 for o in np.asarray(model.cp_offset))
    return int(ops)


# fp32 operations of one heightfield sample (csrc/wtw_device.cuh
# heightfield_sample): grid coordinates 4, floors 2, fractions and their
# clamps 6, bilinear height 13, two slopes 12, the normal's length and
# division 9, h + radius 1
HEIGHTFIELD_SAMPLE_OPS = 47


def work_per_env(model, decimation: int, warm_iters: int, hidden: int = 32,
                 features: int = 6, control_type: str = "actuator_net",
                 exact: bool = False, num_iters: int = 16, flat: bool = True,
                 entry: bool = False):
    """(bytes moved, fp32 operations) per env for one control step of the
    kernel variant: each input read once and each output written once, and
    the arithmetic the algorithm needs with its static sparsity (a
    multiply-add counts 2).  Reuse mode (K4, K4c; K4b with `flat` False):
    the cache is an input, built once per control step into J and W, every
    substep warm-started with `warm_iters` sweeps (cold with `num_iters`
    where `warm_iters` is 0); K4b also reads the normals, forms W's six
    distinct entries and n^T W n, and runs the general-normal rows.  Exact
    mode (K5, K5-P): payload and COM shift in place of the cache, which is
    rebuilt (`cache_rebuild_ops`) and formed into J and W before every
    substep, and every solve runs `num_iters` sweeps from a cold start.
    With `entry` (the team kernel's variants, K4, K4b, K4c, K4b-P): reuse
    mode with the cache built in the launch from the entry state, once
    (`cache_rebuild_ops`): the payload and COM shift are read in place of
    the cache and, on a heightfield, one cell of four corner heights per
    contact point in place of the normals, sampled once
    (`HEIGHTFIELD_SAMPLE_OPS`).  The actuator weights and the bound
    columns are shared by all envs and are not counted per env."""
    nv, nb = model.nv, model.nb
    nj = nv - 6
    P = model.cp_body.shape[0]
    D = decimation
    anc, anc_p, groups = _topology(model)
    pctrl = control_type == "P"
    hist = 0 if pctrl else 4 * nj
    if exact:
        cache_in = 1 + 3
    elif entry:
        cache_in = 1 + 3 + P * 3                           # + the lam seed
    else:
        cache_in = (2 * nv * 3 + 2 * nb * 9 + nb + nv * nv
                    + P * 3 + P * 3)                       # + the lam seed
    if not flat:
        cache_in += P * 4 if entry else P * 3   # corner heights | normals
    floats_in = (cache_in + P + 1 + 1 + 3 + 2 * nj + 3 + 4 + 3 + 3 + D * nj
                 + nj + (2 * nj if pctrl else hist))
    floats_out = 2 * nj + 3 + 4 + 3 + 3 + 3 * P * 3 + nj + hist
    nd = anc_p.sum(axis=1)                    # dofs per point
    jnz = int(3 * nd.sum())                   # nonzero J entries
    # per point: t_i = J_i M^-1 over its dofs, then W's entries and the
    # normal row's mass (flat: 4 entries; else 6 and n^T W n, 20 operations)
    n_w = 4 if flat else 6
    cache = int(sum(3 * 2 * d * d + n_w * 2 * d for d in nd)) + 9 * jnz // 3
    if not flat:
        cache += 20 * P
    torque = 4 * nj if pctrl else (
        nj * 2 * (features * hidden + hidden * hidden + hidden)
        + nj * 2 * hidden * 4)
    dyn = pd.dyn_ops(anc)
    warm = not exact and warm_iters > 0
    solve = pc.solve_ops(jnz, P, nv, warm_iters if warm else num_iters,
                         warm, flat)
    integ = 100 + 4 * nv
    per_substep = torque + 10 * nj + 2 * dyn + 4 * nv + solve + integ
    if exact:
        ops = D * (cache_rebuild_ops(model) + cache + per_substep)
    else:
        ops = cache + D * per_substep
    if entry:
        ops += cache_rebuild_ops(model)
        if not flat:
            ops += P * HEIGHTFIELD_SAMPLE_OPS
    return 4 * (floats_in + floats_out), ops
