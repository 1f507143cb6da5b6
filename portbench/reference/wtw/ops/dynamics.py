"""Frozen copy of walk_these_ways_tpu_torch/ops/dynamics.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Env-minor cached physics substep: the plain PyTorch `dyn_core` (the copy
keeps no kernel wrapper).

Counterpart of the JAX package's ops/pallas_dynamics.py: body twists, RNEA
bias forces (Coriolis + gravity), unconstrained acceleration
qdd = M^-1 (tau - bias) and the centripetal reference-point correction, on
env-minor operands with the robot's static topology (ancestor masks,
joint->body map) unrolled in Python, sparsity included.  `dyn_core` is the
arithmetic the CUDA kernels (csrc/megastep_team.cu, csrc/dynamics_substep.cu)
are held against.
"""
from __future__ import annotations

import numpy as np
import torch


def _cross(a, b):
    """(3, B) x (3, B) -> (3, B) via row slices."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]], dim=0)


def _m3_vec(M9, v):
    """M9 (9, B) row-major 3x3 blocks, v (3, B) -> (3, B)."""
    return torch.stack([
        M9[0] * v[0] + M9[1] * v[1] + M9[2] * v[2],
        M9[3] * v[0] + M9[4] * v[1] + M9[5] * v[2],
        M9[6] * v[0] + M9[7] * v[1] + M9[8] * v[2]], dim=0)


def _m3T_vec(M9, v):
    return torch.stack([
        M9[0] * v[0] + M9[3] * v[1] + M9[6] * v[2],
        M9[1] * v[0] + M9[4] * v[1] + M9[7] * v[2],
        M9[2] * v[0] + M9[5] * v[1] + M9[8] * v[2]], dim=0)


def dyn_core(Sw, Sv, Ab, Bb, mb, Minv, g, tau, gv, *,
             anc: np.ndarray, joint_body: np.ndarray,
             nb: int, nj: int, nv: int):
    """Unconstrained dynamics on env-minor values: body twists, RNEA bias
    forces, qdd = M^-1 (tau - bias) plus the centripetal reference-point
    correction.  Sw/Sv (nv, 3, B); Ab/Bb (nb, 9, B); mb (nb, B); Minv
    (nv, nv, B); g (3, B); tau, gv (nv, B).  Returns qdd (nv, B)."""
    # body twists: Vw[b] = sum_{d: anc[d,b]} Sw[d] * gv[d]
    Vw, Vv = [], []
    for b in range(nb):
        dofs = [d for d in range(nv) if anc[d, b]]
        w = Sw[dofs[0]] * gv[dofs[0]]
        v = Sv[dofs[0]] * gv[dofs[0]]
        for d in dofs[1:]:
            w = w + Sw[d] * gv[d]
            v = v + Sv[d] * gv[d]
        Vw.append(w)
        Vv.append(v)

    # per-joint velocity-product terms
    Cw, Cv = [None] * nj, [None] * nj
    for j in range(nj):
        jb = int(joint_body[j])
        qd = gv[6 + j]
        Cw[j] = _cross(Vw[jb], Sw[6 + j]) * qd
        Cv[j] = (_cross(Vw[jb], Sv[6 + j]) + _cross(Vv[jb], Sw[6 + j])) * qd

    # bias accelerations per body: aw[b] = sum_{j anc of b} Cw[j],
    # av[b] = -g + sum Cv[j]
    Fw_sum = None
    Fv_sum = None
    Fw, Fv = [], []
    for b in range(nb):
        joints = [j for j in range(nj) if anc[6 + j, b]]
        aw = torch.zeros_like(g)
        av = -g
        for j in joints:
            aw = aw + Cw[j]
            av = av + Cv[j]
        # F = I a + V x (I V)  in block form
        IVw = _m3_vec(Ab[b], Vw[b]) + _m3_vec(Bb[b], Vv[b])
        IVv = _m3T_vec(Bb[b], Vw[b]) + mb[b] * Vv[b]
        IAw = _m3_vec(Ab[b], aw) + _m3_vec(Bb[b], av)
        IAv = _m3T_vec(Bb[b], aw) + mb[b] * av
        fw = IAw + _cross(Vw[b], IVw) + _cross(Vv[b], IVv)
        fv = IAv + _cross(Vw[b], IVv)
        Fw.append(fw)
        Fv.append(fv)
        Fw_sum = fw if Fw_sum is None else Fw_sum + fw
        Fv_sum = fv if Fv_sum is None else Fv_sum + fv

    # project onto the twist rows: bias[d] = sum_b anc[d,b]
    # (Sw[d].Fw_b + Sv[d].Fv_b); root rows are unit vectors
    rows = [Fw_sum[0], Fw_sum[1], Fw_sum[2],
            Fv_sum[0], Fv_sum[1], Fv_sum[2]]
    for j in range(nj):
        bodies = [b for b in range(nb) if anc[6 + j, b]]
        acc = None
        for b in bodies:
            t = (Sw[6 + j, 0] * Fw[b][0] + Sw[6 + j, 1] * Fw[b][1]
                 + Sw[6 + j, 2] * Fw[b][2]
                 + Sv[6 + j, 0] * Fv[b][0] + Sv[6 + j, 1] * Fv[b][1]
                 + Sv[6 + j, 2] * Fv[b][2])
            acc = t if acc is None else acc + t
        rows.append(acc)
    bias = torch.stack(rows, dim=0)                         # (nv, B)

    # qdd = M^-1 (tau - bias) + centripetal correction on the linear rows
    tb = tau - bias
    qdd = torch.sum(Minv * tb[None, :, :], dim=1)           # (nv, B)
    corr = _cross(gv[0:3], gv[3:6])                         # (3, B)
    return torch.cat([qdd[0:3], qdd[3:6] + corr, qdd[6:]], dim=0)
