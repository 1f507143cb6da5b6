"""Frozen copy of walk_these_ways_tpu_torch/physics/envminor.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Env-minor dynamics-cache build: FK + spatial inertia + CRBA + M^-1 with
the env batch as the minor axis.

Counterpart of the JAX package's physics/envminor.py, in plain PyTorch (it is
plain array code there too).  Every intermediate is a rank-1 (N,) tensor
("scalar per env") and all structure dimensions (bodies, joints, 3x3 blocks)
are unrolled in Python over the robot's static topology.  The unrolling
exploits static sparsity: composite-inertia sums run over the actual subtree
body lists, and the joint-joint mass-matrix block is built only for the
(ancestor, descendant) dof pairs that are nonzero on a quadruped.

Outputs are stacked directly into the env-minor `(..., Npad)` layouts the
kernels consume (ops/megastep.py, ops/contact.py, ops/dynamics.py).  Run
eagerly this is a few thousand small tensor ops per control step; it is
the plain version of the build that the kernels run in their launch: the
team control-step kernel (once, or in exact mode before every substep) and
the per-substep route's entry-cache kernel (csrc/wtw_team.cuh).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# -- scalar-per-env 3-vector / 3x3 helpers -----------------------------------
# a "v3" is a Python list [x, y, z] of (N,) arrays; an "m3" is a 3x3 nested
# Python list of (N,) arrays.  All loops below are over static indices and
# unroll at trace time.


def _v_add(a, b):
    return [a[i] + b[i] for i in range(3)]


def _v_sub(a, b):
    return [a[i] - b[i] for i in range(3)]


def _v_scale(s, a):
    return [s * a[i] for i in range(3)]


def _v_cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _m_vec(A, v):
    return [A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2]
            for i in range(3)]


def _m_T_vec(A, v):
    return [A[0][i] * v[0] + A[1][i] * v[1] + A[2][i] * v[2]
            for i in range(3)]


def _m_mul(A, B):
    return [[sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3)]
            for i in range(3)]


def _m_add(A, B):
    return [[A[i][j] + B[i][j] for j in range(3)] for i in range(3)]


def _m_sub(A, B):
    return [[A[i][j] - B[i][j] for j in range(3)] for i in range(3)]


def _m_T(A):
    return [[A[j][i] for j in range(3)] for i in range(3)]


def _m_num(A_np, zero):
    """Static numpy 3x3 -> m3 of broadcast scalars (weak-typed floats)."""
    return [[float(A_np[i][j]) + zero for j in range(3)] for i in range(3)]


def _skew(v):
    z = torch.zeros_like(v[0])
    return [[z, -v[2], v[1]], [v[2], z, -v[0]], [-v[1], v[0], z]]


def _inv3(A, eps):
    """Adjugate 3x3 inverse, matching ops/linalg.py:inv3."""
    a, b, c = A[0][0] + eps, A[0][1], A[0][2]
    d, e, f = A[1][0], A[1][1] + eps, A[1][2]
    g, h, i = A[2][0], A[2][1], A[2][2] + eps
    cA = e * i - f * h
    cB = -(d * i - f * g)
    cC = d * h - e * g
    cD = -(b * i - c * h)
    cE = a * i - c * g
    cF = -(a * h - b * g)
    cG = b * f - c * e
    cH = -(a * f - c * d)
    cI = a * e - b * d
    inv_det = 1.0 / (a * cA + b * cB + c * cC)
    return [[cA * inv_det, cD * inv_det, cG * inv_det],
            [cB * inv_det, cE * inv_det, cH * inv_det],
            [cC * inv_det, cF * inv_det, cI * inv_det]]


def _inv_spd6(M, eps):
    """SPD 6x6 (nested 6x6 list) inverse via 3x3 Schur, matching
    ops/linalg.py:inv_spd6."""
    P = [row[:3] for row in M[:3]]
    Q = [row[3:] for row in M[:3]]
    R = [row[3:] for row in M[3:]]
    Pinv = _inv3(P, eps)
    QtPiQ = _m_mul(_m_T(Q), _m_mul(Pinv, Q))
    S = _m_sub(R, QtPiQ)
    Sinv = _inv3(S, eps)
    PiQ = _m_mul(Pinv, Q)
    TL = _m_add(Pinv, _m_mul(PiQ, _m_mul(Sinv, _m_T(PiQ))))
    TR = [[-sum(PiQ[i][k] * Sinv[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    out = [[None] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            out[i][j] = TL[i][j]
            out[i][3 + j] = TR[i][j]
            out[3 + i][j] = TR[j][i]
            out[3 + i][3 + j] = Sinv[i][j]
    return out


# -- FK ----------------------------------------------------------------------


def _fk_scalar(model, q_cols, base_R, base_p):
    """Unrolled FK over the static tree.  q_cols: list of nj (N,) joint
    angles; base_R m3; base_p v3.  Returns (R[nb] m3, p[nb] v3,
    axis_w[nj] v3, anchor_w[nj] v3).  Same recursion as
    the reference's forward kinematics."""
    nb, nj = model.nb, model.nj
    zero = torch.zeros_like(base_p[0])
    R = [None] * nb
    p = [None] * nb
    R[0], p[0] = base_R, base_p
    axis_w = [None] * nj
    anchor_w = [None] * nj
    order = np.argsort([_depth(model, int(model.joint_body[j]))
                        for j in range(nj)], kind="stable")
    for j in (int(x) for x in order):
        b = int(model.joint_body[j])
        pb = int(model.parent[b])
        a = model.joint_axis[j]
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]],
                     dtype=np.float64)
        KK = K @ K
        s = torch.sin(q_cols[j])
        c1 = 1.0 - torch.cos(q_cols[j])
        # rot = I + s K + (1-c) K^2 with static K entries folded in
        rot = [[(1.0 if i == k else 0.0) + zero
                + float(K[i][k]) * s + float(KK[i][k]) * c1
                for k in range(3)] for i in range(3)]
        anchor_w[j] = _v_add(p[pb], _m_vec(R[pb], [float(x) + zero
                                                   for x in model.joint_anchor[j]]))
        axis_w[j] = _m_vec(R[pb], [float(x) + zero for x in a])
        R[b] = _m_mul(R[pb], rot)
        p[b] = anchor_w[j]
    return R, p, axis_w, anchor_w


def _depth(model, b):
    d = 0
    while model.parent[b] >= 0:
        b = int(model.parent[b])
        d += 1
    return d


def _quat_rotmat_cols(qx, qy, qz, qw):
    """xyzw quaternion components (N,) -> m3 (matches ops/quat.py:quat_to_rotmat)."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return [[1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]]


# -- cache build -------------------------------------------------------------


class EnvMinorCache(NamedTuple):
    """Stacked env-minor cache tensors (layouts of ops/megastep.py)."""

    Sw_t: torch.Tensor     # (nv, 3, Npad)
    Sv_t: torch.Tensor     # (nv, 3, Npad)
    Minv_t: torch.Tensor   # (nv, nv, Npad)
    A_t: torch.Tensor      # (nb, 9, Npad) spatial-inertia A blocks, row-major
    B_t: torch.Tensor      # (nb, 9, Npad) B = m * skew(com - ref)
    m_t: torch.Tensor      # (nb, Npad)
    r_t: torch.Tensor      # (P, 3, Npad) contact points about ref
    p_cp_t: torch.Tensor   # (P, 3, Npad) contact point world positions


def cache_columns(model, q_cols, base_quat_cols, ref, payload,
                  com_disp_cols):
    """Scalar-per-env cache build on column leaves of ANY shape — every
    operation is elementwise or a static-topology unroll, so the leaf
    shape is opaque.

    Returns nested-list quantities (Sw, Sv, Minv, A_blk, B_blk, m,
    r_cp, p_cp) with leaves shaped like the inputs."""
    nb, nj, nv = model.nb, model.nj, model.nv
    zero = torch.zeros_like(ref[0])
    base_R = _quat_rotmat_cols(*base_quat_cols)
    R, p, axis_w, anchor_w = _fk_scalar(model, q_cols, base_R, ref)

    # twist bases
    Sw = [[zero, zero, zero] for _ in range(nv)]
    Sv = [[zero, zero, zero] for _ in range(nv)]
    for i in range(3):
        Sw[i][i] = 1.0 + zero
        Sv[3 + i][i] = 1.0 + zero
    for j in range(nj):
        Sw[6 + j] = axis_w[j]
        Sv[6 + j] = _v_cross(_v_sub(anchor_w[j], ref), axis_w[j])

    # spatial inertia blocks
    m = [float(model.mass[b]) + zero for b in range(nb)]
    m[0] = m[0] + payload
    com = [_v_add(p[b], _m_vec(R[b], [float(x) + zero
                                      for x in model.com[b]]))
           for b in range(nb)]
    com[0] = _v_add(com[0], _m_vec(R[0], com_disp_cols))
    scale0 = m[0] / float(model.mass[0])
    A_blk, B_blk = [], []
    for b in range(nb):
        I_l = _m_num(np.asarray(model.inertia[b]), zero)
        if b == 0:
            I_l = [[I_l[i][j] * scale0 for j in range(3)] for i in range(3)]
        I_w = _m_mul(R[b], _m_mul(I_l, _m_T(R[b])))
        r = _v_sub(com[b], ref)
        rx = _skew(r)
        mrx = [[m[b] * rx[i][j] for j in range(3)] for i in range(3)]
        A_blk.append(_m_sub(I_w, _m_mul(mrx, rx)))
        B_blk.append(mrx)

    # CRBA over static sparsity (block identities of the mass matrix)
    M = [[zero for _ in range(nv)] for _ in range(nv)]
    A_tot = A_blk[0]
    B_tot = B_blk[0]
    m_tot = m[0]
    for b in range(1, nb):
        A_tot = _m_add(A_tot, A_blk[b])
        B_tot = _m_add(B_tot, B_blk[b])
        m_tot = m_tot + m[b]
    for i in range(3):
        for j in range(3):
            M[i][j] = A_tot[i][j]
            M[i][3 + j] = B_tot[i][j]
            M[3 + i][j] = B_tot[j][i]
        M[3 + i][3 + i] = m_tot
    anc = model.anc_dof_body          # (nv, nb) static 0/1
    comp = []
    for j in range(nj):
        bodies = [b for b in range(nb) if anc[6 + j, b]]
        Ac = A_blk[bodies[0]]
        Bc = B_blk[bodies[0]]
        mc = m[bodies[0]]
        for b in bodies[1:]:
            Ac = _m_add(Ac, A_blk[b])
            Bc = _m_add(Bc, B_blk[b])
            mc = mc + m[b]
        wj, vj = Sw[6 + j], Sv[6 + j]
        a = _v_add(_m_vec(Ac, wj), _m_vec(Bc, vj))
        b_ = _v_add(_m_T_vec(Bc, wj), _v_scale(mc, vj))
        comp.append((a, b_))
        for i in range(3):
            M[i][6 + j] = a[i]
            M[6 + j][i] = a[i]
            M[3 + i][6 + j] = b_[i]
            M[6 + j][3 + i] = b_[i]
    for i in range(nj):
        for j in range(nj):
            # nonzero iff dof i is an ancestor of (or equals) dof j
            if not model.subtree[model.joint_body[i], model.joint_body[j]]:
                continue
            a, b_ = comp[j]
            val = _v_dot(Sw[6 + i], a) + _v_dot(Sv[6 + i], b_)
            M[6 + i][6 + j] = val
            M[6 + j][6 + i] = val
    for i in range(nv):
        M[i][i] = M[i][i] + 1e-7     # diagonal regularization

    Minv = _mass_matrix_inverse_scalar(model, M)

    # contact points
    P = model.cp_body.shape[0]
    p_cp, r_cp = [], []
    for pt in range(P):
        b = int(model.cp_body[pt])
        off = [float(x) + zero for x in model.cp_offset[pt]]
        pos = _v_add(p[b], _m_vec(R[b], off))
        p_cp.append(pos)
        r_cp.append(_v_sub(pos, ref))

    return Sw, Sv, Minv, A_blk, B_blk, m, r_cp, p_cp


def _mass_matrix_inverse_scalar(model, M, eps: float = 1e-8):
    """Closed-form M^-1 for the quadruped topology, matching
    ops/linalg.py:mass_matrix_inverse (block-diagonal D + 6x6 Schur).
    Only valid for a base with 3-dof chains; callers check the topology."""
    nv = model.nv
    nj = nv - 6
    C = nj // 3
    # per-leg 3x3 D blocks
    Dinv_blocks = []
    for c in range(C):
        o = 6 + 3 * c
        Dc = [[M[o + i][o + j] for j in range(3)] for i in range(3)]
        Dinv_blocks.append(_inv3(Dc, eps))
    B6 = [[M[i][6 + j] for j in range(nj)] for i in range(6)]
    # BDinv (6, nj): per-leg right-multiply by Dinv_c
    BDinv = [[None] * nj for _ in range(6)]
    for c in range(C):
        Dinv = Dinv_blocks[c]
        for i in range(6):
            for j in range(3):
                BDinv[i][3 * c + j] = sum(B6[i][3 * c + k] * Dinv[k][j]
                                          for k in range(3))
    S = [[M[i][j] - sum(BDinv[i][k] * B6[j][k] for k in range(nj))
          for j in range(6)] for i in range(6)]
    Sinv = _inv_spd6(S, eps)
    T = [[sum(Sinv[i][k] * BDinv[k][j] for k in range(6)) for j in range(nj)]
         for i in range(6)]                                  # Sinv @ BDinv
    out = [[None] * nv for _ in range(nv)]
    for i in range(6):
        for j in range(6):
            out[i][j] = Sinv[i][j]
        for j in range(nj):
            out[i][6 + j] = -T[i][j]
            out[6 + j][i] = -T[i][j]
    for i in range(nj):
        ci, ri = divmod(i, 3)
        for j in range(nj):
            cj, rj = divmod(j, 3)
            d = Dinv_blocks[ci][ri][rj] if ci == cj else 0.0
            out[6 + i][6 + j] = d + sum(BDinv[k][i] * T[k][j]
                                        for k in range(6))
    return out
