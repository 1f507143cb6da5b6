"""Env-minor full cached physics substep: the plain PyTorch `dyn_core` and
the wrapper of the dynamics-substep kernel.

Counterpart of the JAX package's ops/pallas_dynamics.py: body twists, RNEA
bias forces (Coriolis + gravity), unconstrained acceleration
qdd = M^-1 (tau - bias) and the centripetal reference-point correction, on
env-minor operands with the robot's static topology (ancestor masks,
joint->body map) unrolled in Python, sparsity included.  `dyn_core` is the
arithmetic the CUDA kernels (csrc/megastep_team.cu, csrc/dynamics_substep.cu)
are held against.

`dynamics_substep` is one whole substep — `dyn_core` twice (midpoint rule),
then ops/contact.contact_core.  CPU tensors go to the plain version
`dynamics_substep_reference`; CUDA tensors go to the hand-written kernel
`csrc/dynamics_substep.cu` (replaces `_dyn_substep_kernel` of
ops/pallas_dynamics.py: K3 on flat ground, K3b with the per-point surface
normals of a heightfield; one warp per env), or the call raises.  There is
no fallback from the kernel to the plain version.  `launches` (K3) and
`normal_launches` (K3b) count kernel launches (and nothing else).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from . import contact as pc

# number of times `dynamics_substep` launched the CUDA kernel: K3 (flat
# ground), K3b (surface normals)
launches = 0
normal_launches = 0

# threads per block of the CUDA kernel: TEAM_ENVS (8) envs of 32 lanes, one
# warp per env (csrc/wtw_team.cuh); the env axis is padded to a multiple of
# TEAM_ENVS
KERNEL_THREADS = 256
TEAM_ENVS = 8


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


# ---------------------------------------------------------------------------
# one full cached substep: plain version, CUDA wrapper, work count
# ---------------------------------------------------------------------------


def dynamics_substep_reference(Sw_t, Sv_t, A_t, B_t, m_t, Minv_t, g_t, tau_t,
                               gv_t, J_t, W_t, pcp_t, rh_t, mu_t, e_t, vlim,
                               n_t=None, *, anc, joint_body, cp_body,
                               dt: float, num_iters: int, relaxation: float,
                               baumgarte: float, slop: float,
                               max_depen: float, bounce_thresh: float,
                               contact: bool = True):
    """The substep in plain PyTorch: unconstrained dynamics with the
    midpoint rule on the velocity-product terms, then the contact pipeline
    on the cached J/W with the static point->dof sparsity (and the surface
    normals `n_t`, None on flat ground)."""
    nv = gv_t.shape[0]
    nb = m_t.shape[0]
    nj = nv - 6
    anc, _, groups = _build.topology(anc, cp_body)
    kw = dict(anc=anc, joint_body=np.asarray(joint_body), nb=nb, nj=nj,
              nv=nv)
    qdd1 = dyn_core(Sw_t, Sv_t, A_t, B_t, m_t, Minv_t, g_t, tau_t, gv_t, **kw)
    gv_mid = gv_t + (0.5 * dt) * qdd1
    qdd = dyn_core(Sw_t, Sv_t, A_t, B_t, m_t, Minv_t, g_t, tau_t, gv_mid,
                   **kw)
    gv_free = gv_t + dt * qdd
    if not contact:
        return gv_free, pcp_t, torch.zeros_like(pcp_t)
    return pc.contact_core(
        J_t, W_t, Minv_t, pcp_t, gv_free, rh_t, mu_t, e_t, vlim,
        num_iters=num_iters, relaxation=relaxation, dt=dt,
        baumgarte=baumgarte, slop=slop, max_depen=max_depen,
        bounce_thresh=bounce_thresh, groups=groups, n=n_t)


_COUNTS = (17, 3, 7)


def library_spec(anc, joint_body, cp_body):
    """What `_build.build_libraries` needs to build
    csrc/dynamics_substep.cu: the robot's topology, with the actuator
    network's sizes of the team control-step kernel (32 hidden units, 6
    inputs), by which csrc/wtw_team.cuh sizes the shared TeamEnv; this
    kernel evaluates no network."""
    return ("dynamics_substep",
            _build.topology_header(anc, joint_body, cp_body, 32, 6), _COUNTS)


def build_library(anc, joint_body, cp_body):
    """Compile csrc/dynamics_substep.cu for sm_90a (once per topology and
    source) and load it.  Raises on any failure."""
    return _build.build_library(*library_spec(anc, joint_body, cp_body))


def dynamics_substep(Sw_t, Sv_t, A_t, B_t, m_t, Minv_t, g_t, tau_t, gv_t,
                     J_t, W_t, pcp_t, rh_t, mu_t, e_t, vlim, n_t=None, *,
                     anc, joint_body, cp_body,
                     dt: float, num_iters: int, relaxation: float,
                     baumgarte: float, slop: float, max_depen: float,
                     bounce_thresh: float, contact: bool = True):
    """One full cached physics substep (twists + bias + qdd + contact +
    point advance), env-minor: Sw_t/Sv_t (nv, 3, Npad); A_t/B_t (nb, 9,
    Npad); m_t (nb, Npad); Minv_t (nv, nv, Npad); g_t (3, Npad); tau_t, gv_t
    (nv, Npad); J_t (P, 3, nv, Npad); W_t (P, 9, Npad); pcp_t (P, 3, Npad);
    rh_t (P, Npad); mu_t, e_t (1, Npad); vlim (nv, 1); `n_t` (P, 3, Npad)
    the per-point surface normals of a heightfield, None on flat ground.
    `anc` (nv, nb), `joint_body` (nj,), `cp_body` (P,) are the robot's
    static topology.  Returns (gv_new_t (nv, Npad), pcp_new_t (P, 3, Npad),
    lam_t (P, 3, Npad)).

    Tensors on the CPU: `dynamics_substep_reference`.  Tensors on a CUDA
    device: the kernel of csrc/dynamics_substep.cu (K3, or K3b with
    `n_t`), launched on the current stream without synchronising, outputs
    allocated here; a failed build or launch raises."""
    global launches, normal_launches
    dev = gv_t.device
    if dev.type == "cpu":
        return dynamics_substep_reference(
            Sw_t, Sv_t, A_t, B_t, m_t, Minv_t, g_t, tau_t, gv_t, J_t, W_t,
            pcp_t, rh_t, mu_t, e_t, vlim, n_t, anc=anc,
            joint_body=joint_body, cp_body=cp_body, dt=dt,
            num_iters=num_iters, relaxation=relaxation, baumgarte=baumgarte,
            slop=slop, max_depen=max_depen, bounce_thresh=bounce_thresh,
            contact=contact)
    if dev.type != "cuda":
        raise ValueError(f"dynamics_substep: unsupported device {dev}")
    ptrs, outs, floats, ints = kernel_operands(
        Sw_t, Sv_t, A_t, B_t, m_t, Minv_t, g_t, tau_t, gv_t, J_t, W_t, pcp_t,
        rh_t, mu_t, e_t, vlim, n_t, anc=anc, cp_body=cp_body, dt=dt,
        num_iters=num_iters, relaxation=relaxation, baumgarte=baumgarte,
        slop=slop, max_depen=max_depen, bounce_thresh=bounce_thresh,
        contact=contact)
    lib = build_library(anc, joint_body, cp_body)
    with torch.cuda.device(dev):
        _build.launch(lib, "dynamics_substep", ptrs, outs, floats, ints,
                      torch.cuda.current_stream(dev).cuda_stream)
    if n_t is None:
        launches += 1
    else:
        normal_launches += 1
    return outs


def kernel_operands(Sw_t, Sv_t, A_t, B_t, m_t, Minv_t, g_t, tau_t, gv_t,
                    J_t, W_t, pcp_t, rh_t, mu_t, e_t, vlim, n_t=None, *,
                    anc, cp_body, dt: float, num_iters: int,
                    relaxation: float, baumgarte: float, slop: float,
                    max_depen: float, bounce_thresh: float,
                    contact: bool = True):
    """The arguments of csrc/dynamics_substep.cu's `dynamics_substep_launch`:
    input pointers in its InIdx order (the normals' slot null on flat
    ground), the three output tensors, allocated on the inputs' device, the
    FIdx floats and the int scalars.  Checks every operand's device, dtype,
    shape and contiguity, and that TEAM_ENVS divides the padded env count."""
    dev = gv_t.device
    nv, Npad = gv_t.shape
    nb = m_t.shape[0]
    P = pcp_t.shape[0]
    ins = [("Sw_t", Sw_t, (nv, 3, Npad)), ("Sv_t", Sv_t, (nv, 3, Npad)),
           ("A_t", A_t, (nb, 9, Npad)), ("B_t", B_t, (nb, 9, Npad)),
           ("m_t", m_t, (nb, Npad)), ("Minv_t", Minv_t, (nv, nv, Npad)),
           ("g_t", g_t, (3, Npad)), ("tau_t", tau_t, (nv, Npad)),
           ("gv_t", gv_t, (nv, Npad)), ("J_t", J_t, (P, 3, nv, Npad)),
           ("W_t", W_t, (P, 9, Npad)), ("pcp_t", pcp_t, (P, 3, Npad)),
           ("rh_t", rh_t, (P, Npad)), ("mu_t", mu_t, (1, Npad)),
           ("e_t", e_t, (1, Npad)), ("vlim", vlim, (nv, 1))]
    if n_t is not None:
        ins.append(("n_t", n_t, (P, 3, Npad)))
    ptrs = [_build.check(n, x, shp, dev).data_ptr() for n, x, shp in ins]
    if n_t is None:
        ptrs.append(None)
    if tuple(np.shape(anc)) != (nv, nb) or len(cp_body) != P:
        raise ValueError("dynamics_substep: topology and operand shapes "
                         "disagree")
    if Npad % TEAM_ENVS:
        raise ValueError(f"dynamics_substep: {Npad} padded envs, not a "
                         f"multiple of {TEAM_ENVS}")
    outs = (torch.empty((nv, Npad), dtype=torch.float32, device=dev),
            torch.empty((P, 3, Npad), dtype=torch.float32, device=dev),
            torch.empty((P, 3, Npad), dtype=torch.float32, device=dev))
    floats = (dt, relaxation, baumgarte / dt, slop, max_depen, bounce_thresh,
              0.5 * dt)
    ints = (Npad, num_iters, bool(contact), KERNEL_THREADS, n_t is not None)
    return ptrs, outs, floats, ints


def dyn_ops(anc) -> int:
    """fp32 operations of one `dyn_core` evaluation (a multiply-add counts
    2), the ancestor mask's static zeros taken out: body twists, per-joint
    velocity products, per-body F = I a + V x* (I V), projection onto the
    twist rows, the M^-1 product and the centripetal term."""
    anc = np.asarray(anc).astype(bool)
    nv, nb = anc.shape
    nj = nv - 6
    n_anc = int(anc.sum())
    n_janc = int(anc[6:].sum())
    return (2 * 6 * n_anc + nj * 3 * 9 + 6 * n_janc
            + nb * (4 * 15 + 2 * 18 + 3 * 9 + 12)
            + 12 * n_janc + 2 * nv * nv + nv + 9)


def work_per_env(anc, cp_body, num_iters: int, contact: bool = True,
                 flat: bool = True):
    """(bytes moved, fp32 operations) per env of `dynamics_substep`: each
    input the function needs read once (twist bases, inertia blocks, masses,
    M^-1, gravity, torques, velocity, points, gap offsets, friction,
    restitution; of J the entries that the point->dof groups leave nonzero,
    of W the four entries the flat-ground solve uses, W00, W01, W11, W22, or
    all nine and the normals with `flat` False), velocity, points and
    impulses written once; operations with the static sparsity of the
    ancestor masks and the point->dof groups taken out (K3b: n^T W n per
    point, 20 operations, and the general-normal rows)."""
    anc, anc_p, _ = _build.topology(anc, cp_body)
    nv, nb = anc.shape
    P = anc_p.shape[0]
    jnz = int(3 * anc_p.sum())
    w_and_n = P * 4 if flat else P * (9 + 3)
    floats = (2 * nv * 3 + 2 * nb * 9 + nb + nv * nv + 3 + 2 * nv
              + jnz + w_and_n + P * 3 + P + 2) + (nv + 2 * P * 3)
    ops = 2 * dyn_ops(anc) + 4 * nv
    if contact:
        ops += pc.solve_ops(jnz, P, nv, num_iters, False, flat)
        ops += 0 if flat else 20 * P
    return 4 * floats, ops
