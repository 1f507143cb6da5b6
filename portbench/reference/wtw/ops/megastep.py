"""Frozen copy of walk_these_ways_tpu_torch/ops/megastep.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

The WHOLE control step in one kernel launch, env-minor.

Counterpart of the JAX package's ops/pallas_megastep.py.  The copy keeps
what the flat reuse route (K4's plain version) runs:

- `control_step_reference`: the plain PyTorch version, composed from the
  plain cores `ops/contact.cache_core`, `ops/dynamics.dyn_core` and
  `ops/contact.contact_core`, with the entry cache built eagerly
  (`entry_cache_reference`).  It is what the kernel is held against.
- `control_step`: the wrapper, which here calls the plain version on every
  device (the program's launches csrc/megastep_team.cu on the card).
- `blockdiag_actuator_weights`: host helper that lays the 12 per-joint
  actuator MLPs (6 -> 32 -> 32 -> 1, softsign) out as block-diagonal
  matrices, with features stacked as X[12 f + j] = feature f of joint j.
"""
from __future__ import annotations

import numpy as np
import torch

from ..physics import envminor
from . import _build
from . import contact as pc
from . import dynamics as pd

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
    if terrain is not None:
        raise ValueError("the reference keeps flat ground only")
    return em, rh_t, None


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
    anc_pn = torch.tensor(anc_p, dtype=f32, device=dev)
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


# the program's wrapper, which launches csrc/megastep_team.cu on the card;
# the reference runs the plain version on every device
control_step = control_step_reference
