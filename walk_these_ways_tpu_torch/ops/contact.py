"""Env-minor contact pipeline: layout helpers, the plain PyTorch cores and
the wrappers of the two contact kernels.

Counterpart of the JAX package's ops/pallas_contact.py.  The env batch is
the LAST axis of every operand (env-minor `(..., N)` layout), so that in the
CUDA kernels neighbouring threads read neighbouring addresses.

`cache_core` and `contact_core` are plain tensor functions.  They are the
arithmetic the kernels are held against (ops/megastep.py
`control_step_reference` composes them too).

`build_contact_cache` (once per control step) and `contact_substep` (once
per physics substep) are the wrappers: CPU tensors go to the plain cores,
CUDA tensors to the hand-written kernels `csrc/contact_cache.cu` and
`csrc/contact_substep.cu` (they replace `_cache_kernel` and
`_substep_kernel` of ops/pallas_contact.py), or the call raises.  There is no
fallback from a kernel to its plain version.  `cache_launches` and
`substep_launches` count kernel launches (and nothing else).

- `cache_core`: point Jacobians J[p,i,v] = anc[p,v] * (Sv[v,i] + Sw[v] x r[p])
  and the 3x3 effective-mass matrices W_p = J_p M^-1 J_p^T + eps I.
- `contact_core`: contact gaps from the carried contact-point estimate (flat
  ground: phi = radius - z + h0), velocity targets (restitution bounce +
  capped Baumgarte bias), `num_iters` row-decoupled projected-Jacobi
  iterations (normal row to target, friction row opposite the slip
  direction, cone clamp at mu * lambda_n), impulses applied lazily as
  M^-1 (J^T dlam), and the point advance p' = p + dt * J gv_new.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# number of times the wrappers launched their CUDA kernels
cache_launches = 0      # build_contact_cache -> csrc/contact_cache.cu
substep_launches = 0    # contact_substep     -> csrc/contact_substep.cu

# launch shapes.  csrc/contact_cache.cu: a block is a tile of CACHE_ENVS
# envs (the fast thread index) by (P + 1) // 2 point slots
# (`cache_threads`).  csrc/contact_substep.cu: one warp of 32 lanes per env,
# SUBSTEP_ENVS envs a block.  Each refuses a padded env count that its tile
# does not divide (engine.SUBSTEP_BLOCK, 256, is one both divide).
CACHE_ENVS = 16
SUBSTEP_ENVS = 8
SUBSTEP_THREADS = 32 * SUBSTEP_ENVS


def cache_threads(P: int) -> int:
    """Threads per block of csrc/contact_cache.cu for P contact points."""
    return CACHE_ENVS * ((P + 1) // 2)


# -- env-minor transpose helpers --------------------------------------------


def to_env_minor(x: torch.Tensor, block: int) -> torch.Tensor:
    """(N, ...) -> (..., Npad) with N padded to a multiple of `block`."""
    N = x.shape[0]
    Npad = ((N + block - 1) // block) * block
    perm = tuple(range(1, x.ndim)) + (0,)
    x = x.permute(perm)
    if Npad != N:
        x = F.pad(x, (0, Npad - N))
    return x.contiguous()


def from_env_minor(x: torch.Tensor, N: int) -> torch.Tensor:
    """(..., Npad) -> (N, ...)."""
    perm = (x.ndim - 1,) + tuple(range(x.ndim - 1))
    return x.permute(perm)[:N].contiguous()


# -- cache: J and W ----------------------------------------------------------


def cache_core(anc, Sw, Sv, Minv, r, *, eps: float):
    """J/W build on env-minor values: point Jacobians
    J[p, i, v] = anc[p, v] * (Sv[v, i] + Sw[v] x r[p]) and 3x3
    effective-mass matrices W_p = J_p M^-1 J_p^T + eps I.
    anc (P, nv) mask; Sw/Sv (nv, 3, B); Minv (nv, nv, B); r (P, 3, B).
    Returns (J (P, 3, nv, B), W9 (P, 9, B))."""
    P = r.shape[0]
    nv = Sw.shape[0]

    sw0, sw1, sw2 = Sw[:, 0, :], Sw[:, 1, :], Sw[:, 2, :]     # (nv, B)
    sv0, sv1, sv2 = Sv[:, 0, :], Sv[:, 1, :], Sv[:, 2, :]
    r0, r1, r2 = r[:, 0, :], r[:, 1, :], r[:, 2, :]           # (P, B)
    cx = sw1[None] * r2[:, None] - sw2[None] * r1[:, None]    # (P, nv, B)
    cy = sw2[None] * r0[:, None] - sw0[None] * r2[:, None]
    cz = sw0[None] * r1[:, None] - sw1[None] * r0[:, None]
    m = anc[:, :, None]
    Jx = m * (sv0[None] + cx)
    Jy = m * (sv1[None] + cy)
    Jz = m * (sv2[None] + cz)
    J = torch.stack([Jx, Jy, Jz], dim=1)                 # (P, 3, nv, B)

    # W[p, i, j] = sum_vw J[p, i, w] Minv[w, v] J[p, j, v]; one
    # t_i = J_i M^-1 (P, nv, B) row at a time
    W = [[None] * 3 for _ in range(3)]
    bt = tuple(Sw.shape[2:])
    for i in range(3):
        t_i = torch.zeros((P, nv) + bt, dtype=J.dtype, device=J.device)
        for w in range(nv):
            t_i = t_i + J[:, i, w, :][:, None, :] * Minv[w][None, :, :]
        for jc in range(3):
            W[i][jc] = torch.sum(J[:, jc] * t_i, dim=1)      # (P, B)
    # the row-decoupled solver consumes W itself, not its inverse; eps on
    # the diagonal keeps the scalar effective masses away from zero
    W9 = torch.stack(
        [W[0][0] + eps, W[0][1], W[0][2],
         W[1][0], W[1][1] + eps, W[1][2],
         W[2][0], W[2][1], W[2][2] + eps], dim=1)             # (P, 9, B)
    return J, W9


# -- substep: targets + projected Jacobi + point advance --------------------


def point_dof_groups(anc_p):
    """Static point->dof coupling structure from the (P, nv) ancestor mask:
    contiguous point runs touching only the base dofs [0, 6) plus at most
    one contiguous joint range.  On a quadruped: 8 trunk points (base
    only) + 4 legs x 5 points (base + that leg's 3 dofs).
    Returns [(p_lo, p_hi, dof_lo, dof_hi)] with dof_lo=None for
    base-only runs."""
    anc_p = np.asarray(anc_p).astype(bool)
    P, nv = anc_p.shape
    groups = []
    s = 0
    for p in range(1, P + 1):
        if p == P or (anc_p[p] != anc_p[s]).any():
            joint = np.nonzero(anc_p[s][6:])[0]
            if joint.size == 0:
                groups.append((s, p, None, None))
            else:
                lo, hi = 6 + int(joint[0]), 6 + int(joint[-1]) + 1
                assert (anc_p[s][lo:hi]).all(), "non-contiguous dof range"
                groups.append((s, p, lo, hi))
            s = p
    # merge same-joint-range neighbors (thigh [lo,lo+2) + calf [lo,lo+3)
    # runs of one leg) into one run over the union range
    merged = [groups[0]]
    for (s, p, lo, hi) in groups[1:]:
        ms, mp, mlo, mhi = merged[-1]
        if lo is not None and mlo is not None and \
                max(lo, mlo) < min(hi, mhi):
            merged[-1] = (ms, p, min(lo, mlo), max(hi, mhi))
        else:
            merged.append((s, p, lo, hi))
    return merged


def contact_core(J, W, Minv, p_cp, gv0, rh, mu, e, vlim, *,
                 num_iters: int, relaxation: float, dt: float,
                 baumgarte: float, slop: float, max_depen: float,
                 bounce_thresh: float, groups=None, n=None, lam0=None):
    """Contact pipeline (gaps -> targets -> projected Jacobi -> point
    advance) on env-minor values.  `W` is the (P, 9, B) per-point
    effective-mass matrix J M^-1 J^T (+eps I), consumed row-decoupled:
    the normal row solves (target - vn) / (n^T W n) and the friction row
    pushes opposite the slip direction t with scalar mass t^T W t,
    clamped to the mu * lambda_n cone.  `groups` is the static
    point_dof_groups structure; when given, the J contractions skip the
    statically-zero (point, dof) blocks.  `n` is the per-point surface
    normal (P, 3, B) for heightfield terrain; None means flat ground
    (n = +z).  `lam0` warm-starts the iteration: the solver iterates over
    the TOTAL impulse lam with gv(lam) = gv0 + M^-1 J^T lam, so a nonzero
    initial lam both seeds the iterate and pre-applies its impulse to the
    velocity (the targets/bounce terms still come from the un-warmed free
    velocity gv0).
    Returns (gv_new, p_cp_new, lam)."""
    P = p_cp.shape[0]
    nv = gv0.shape[0]
    bt = tuple(gv0.shape[1:])

    if groups is None:
        def jdot(gv):
            """(P, 3, B) contact point velocities."""
            return torch.sum(J * gv[None, None, :, :], dim=2)

        def jt_apply(applied):
            """(nv, B) generalized impulse J^T applied."""
            return torch.sum(J * applied[:, :, None, :], dim=(0, 1))
    else:
        def jdot(gv):
            outs = []
            for (s, p, lo, hi) in groups:
                t = torch.sum(J[s:p, :, 0:6, :] * gv[0:6][None, None],
                              dim=2)
                if lo is not None:
                    t = t + torch.sum(J[s:p, :, lo:hi, :]
                                      * gv[lo:hi][None, None], dim=2)
                outs.append(t)
            return torch.cat(outs, dim=0)

        def jt_apply(applied):
            base = torch.sum(J[:, :, 0:6, :] * applied[:, :, None, :],
                             dim=(0, 1))                      # (6, B)
            parts = [base]
            pos = 6
            for (s, p, lo, hi) in groups:
                if lo is None:
                    continue
                assert lo == pos, "joint ranges must tile [6, nv)"
                parts.append(torch.sum(J[s:p, :, lo:hi, :]
                                       * applied[s:p][:, :, None, :],
                                       dim=(0, 1)))
                pos = hi
            assert pos == nv
            return torch.cat(parts, dim=0)

    # gaps and velocity targets (vertical gap phi = (radius + h) - p_z)
    phi = rh - p_cp[:, 2, :]                               # (P, B)
    active = (phi > 0.0).to(J.dtype)
    v0 = jdot(gv0)
    if n is None:
        vn0 = v0[:, 2, :]
    else:
        vn0 = n[:, 0] * v0[:, 0] + n[:, 1] * v0[:, 1] + n[:, 2] * v0[:, 2]
    bounce = torch.where(vn0 < -bounce_thresh, -e * vn0,
                         torch.zeros_like(vn0))
    bias = torch.clamp(baumgarte / dt * torch.clamp(phi - slop, min=0.0),
                       max=max_depen)
    target = torch.maximum(bounce, bias)                   # (P, B)

    # loop-invariant scalar effective mass of the normal row
    # (W has +eps on the diagonal, so w_nn >= eps > 0)
    if n is None:
        w_nn = W[:, 8]                                     # n = +z: W22
    else:
        w_nn = (n[:, 0] * (W[:, 0] * n[:, 0] + W[:, 1] * n[:, 1]
                           + W[:, 2] * n[:, 2])
                + n[:, 1] * (W[:, 3] * n[:, 0] + W[:, 4] * n[:, 1]
                             + W[:, 5] * n[:, 2])
                + n[:, 2] * (W[:, 6] * n[:, 0] + W[:, 7] * n[:, 1]
                             + W[:, 8] * n[:, 2]))
    inv_w_nn = relaxation / w_nn
    one = torch.ones((), dtype=J.dtype, device=J.device)

    def body(lam, gv):
        v = jdot(gv)
        if n is None:
            vn = v[:, 2, :]
            vtx, vty = v[:, 0, :], v[:, 1, :]
            vtn = torch.sqrt(vtx * vtx + vty * vty + 1e-18)
            itn = 1.0 / vtn
            tx, ty = vtx * itn, vty * itn
            # slip-direction scalar effective mass t^T W t (tz = 0)
            # vt = 0 exactly makes t the zero vector: floor w_tt at eps
            w_tt = torch.clamp(tx * tx * W[:, 0] + 2.0 * tx * ty * W[:, 1]
                               + ty * ty * W[:, 4], min=1e-6)
            dln = (target - vn) * inv_w_nn
            dlt = -relaxation * vtn / w_tt
            ln = torch.clamp(lam[:, 2, :] + dln, min=0.0)
            lx = lam[:, 0, :] + dlt * tx
            ly = lam[:, 1, :] + dlt * ty
            ltn = torch.sqrt(lx * lx + ly * ly + 1e-18)
            max_t = mu * ln
            scale = torch.where(ltn > max_t, max_t / ltn, one)
            lx = lx * scale * active
            ly = ly * scale * active
            lz = ln * active
        else:
            vn = n[:, 0] * v[:, 0] + n[:, 1] * v[:, 1] + n[:, 2] * v[:, 2]
            vtx = v[:, 0, :] - vn * n[:, 0]
            vty = v[:, 1, :] - vn * n[:, 1]
            vtz = v[:, 2, :] - vn * n[:, 2]
            vtn = torch.sqrt(vtx * vtx + vty * vty + vtz * vtz + 1e-18)
            itn = 1.0 / vtn
            tx, ty, tz = vtx * itn, vty * itn, vtz * itn
            w_tt = torch.clamp(
                tx * (W[:, 0] * tx + W[:, 1] * ty + W[:, 2] * tz)
                + ty * (W[:, 3] * tx + W[:, 4] * ty + W[:, 5] * tz)
                + tz * (W[:, 6] * tx + W[:, 7] * ty + W[:, 8] * tz),
                min=1e-6)
            dln = (target - vn) * inv_w_nn
            dlt = -relaxation * vtn / w_tt
            l_n0 = (lam[:, 0, :] * n[:, 0] + lam[:, 1, :] * n[:, 1]
                    + lam[:, 2, :] * n[:, 2])
            ln = torch.clamp(l_n0 + dln, min=0.0)
            lx = lam[:, 0, :] - l_n0 * n[:, 0] + dlt * tx
            ly = lam[:, 1, :] - l_n0 * n[:, 1] + dlt * ty
            lz = lam[:, 2, :] - l_n0 * n[:, 2] + dlt * tz
            ltn = torch.sqrt(lx * lx + ly * ly + lz * lz + 1e-18)
            max_t = mu * ln
            scale = torch.where(ltn > max_t, max_t / ltn, one)
            lx = (ln * n[:, 0] + lx * scale) * active
            ly = (ln * n[:, 1] + ly * scale) * active
            lz = (ln * n[:, 2] + lz * scale) * active
        new_lam = torch.stack([lx, ly, lz], dim=1)         # (P, 3, B)
        applied = new_lam - lam
        # lazy impulse apply: gv += M^-1 (J^T applied)
        jta = jt_apply(applied)                                  # (nv, B)
        dgv = torch.sum(Minv * jta[None, :, :], dim=1)           # (nv, B)
        return new_lam, gv + dgv

    if lam0 is None:
        lam = torch.zeros((P, 3) + bt, dtype=J.dtype, device=J.device)
        gv = gv0
    else:
        jta = jt_apply(lam0)
        lam = lam0
        gv = gv0 + torch.sum(Minv * jta[None, :, :], dim=1)
    for _ in range(num_iters):
        lam, gv = body(lam, gv)
    # advance with the clamped velocities the integrator will apply
    gv_cl = torch.maximum(torch.minimum(gv, vlim), -vlim)
    return gv, p_cp + dt * jdot(gv_cl), lam


# ---------------------------------------------------------------------------
# CUDA kernels: wrappers
# ---------------------------------------------------------------------------

_CACHE_COUNTS = (5, 2, 1)
_SUBSTEP_COUNTS = (9, 3, 6)


def cache_spec(nv: int, P: int):
    """What `_build.build_libraries` needs to build csrc/contact_cache.cu."""
    return ("contact_cache", _build.dims_header(nv, P), _CACHE_COUNTS)


def substep_spec(nv: int, P: int):
    """What `_build.build_libraries` needs to build
    csrc/contact_substep.cu."""
    return ("contact_substep", _build.dims_header(nv, P), _SUBSTEP_COUNTS)


def cache_library(nv: int, P: int):
    """Compile csrc/contact_cache.cu for sm_90a (once per size and source)
    and load it.  Raises on any failure."""
    return _build.build_library(*cache_spec(nv, P))


def substep_library(nv: int, P: int):
    """Compile csrc/contact_substep.cu for sm_90a and load it."""
    return _build.build_library(*substep_spec(nv, P))


def build_contact_cache(anc, Sw_t, Sv_t, Minv_t, r_t, eps: float = 1e-6):
    """anc (P, nv) static mask; Sw_t/Sv_t (nv, 3, Npad); Minv_t
    (nv, nv, Npad); r_t (P, 3, Npad).  Returns J_t (P, 3, nv, Npad),
    W_t (P, 9, Npad).

    Tensors on the CPU: `cache_core`.  Tensors on a CUDA device: the kernel
    of csrc/contact_cache.cu, launched on the current stream without
    synchronising, outputs allocated here; a failed build or launch
    raises."""
    global cache_launches
    dev = Sw_t.device
    if dev.type == "cpu":
        return cache_core(anc, Sw_t, Sv_t, Minv_t, r_t, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"build_contact_cache: unsupported device {dev}")
    with torch.cuda.device(dev):
        ptrs, outs, floats, ints = cache_operands(anc, Sw_t, Sv_t, Minv_t,
                                                  r_t, eps)
        _build.launch(cache_library(Sw_t.shape[0], r_t.shape[0]),
                      "contact_cache", ptrs, outs, floats, ints,
                      torch.cuda.current_stream(dev).cuda_stream)
    cache_launches += 1
    return outs


def cache_operands(anc, Sw_t, Sv_t, Minv_t, r_t, eps: float = 1e-6):
    """The arguments of `contact_cache_launch` (csrc/contact_cache.cu):
    input pointers, the outputs (J_t, W_t) allocated on the inputs' device,
    the floats and the ints.  Checks every operand's device, dtype, shape
    and contiguity, and that CACHE_ENVS divides the padded env count."""
    dev = Sw_t.device
    nv, _, Npad = Sw_t.shape
    P = r_t.shape[0]
    if Npad % CACHE_ENVS:
        raise ValueError(f"build_contact_cache: {Npad} padded envs, not a "
                         f"multiple of {CACHE_ENVS}")
    ins = [("anc", anc, (P, nv)), ("Sw_t", Sw_t, (nv, 3, Npad)),
           ("Sv_t", Sv_t, (nv, 3, Npad)), ("Minv_t", Minv_t, (nv, nv, Npad)),
           ("r_t", r_t, (P, 3, Npad))]
    ptrs = [_build.check(n, x, shp, dev).data_ptr() for n, x, shp in ins]
    outs = (torch.empty((P, 3, nv, Npad), dtype=torch.float32, device=dev),
            torch.empty((P, 9, Npad), dtype=torch.float32, device=dev))
    return ptrs, outs, (eps,), (Npad, cache_threads(P))


def contact_substep(J_t, W_t, Minv_t, pcp_t, gv_t, rh_t, mu_t, e_t, vlim, *,
                    num_iters: int, relaxation: float, dt: float,
                    baumgarte: float, slop: float, max_depen: float,
                    bounce_thresh: float):
    """One contact substep, everything env-minor: J_t (P, 3, nv, Npad),
    W_t (P, 9, Npad), Minv_t (nv, nv, Npad), pcp_t (P, 3, Npad), gv_t
    (nv, Npad) the free velocity, rh_t (P, Npad), mu_t/e_t (1, Npad);
    `vlim` (nv, 1) holds the per-row velocity bounds used for the point
    advance.  Returns (gv_new_t (nv, Npad), pcp_new_t (P, 3, Npad),
    lam_t (P, 3, Npad)).

    Tensors on the CPU: `contact_core` (dense J, cold start, flat ground).
    Tensors on a CUDA device: the kernel of csrc/contact_substep.cu, or the
    call raises."""
    global substep_launches
    kw = dict(num_iters=num_iters, relaxation=relaxation, dt=dt,
              baumgarte=baumgarte, slop=slop, max_depen=max_depen,
              bounce_thresh=bounce_thresh)
    dev = gv_t.device
    if dev.type == "cpu":
        return contact_core(J_t, W_t, Minv_t, pcp_t, gv_t, rh_t, mu_t, e_t,
                            vlim, **kw)
    if dev.type != "cuda":
        raise ValueError(f"contact_substep: unsupported device {dev}")
    with torch.cuda.device(dev):
        ptrs, outs, floats, ints = substep_operands(
            J_t, W_t, Minv_t, pcp_t, gv_t, rh_t, mu_t, e_t, vlim, **kw)
        _build.launch(substep_library(gv_t.shape[0], pcp_t.shape[0]),
                      "contact_substep", ptrs, outs, floats, ints,
                      torch.cuda.current_stream(dev).cuda_stream)
    substep_launches += 1
    return outs


def substep_operands(J_t, W_t, Minv_t, pcp_t, gv_t, rh_t, mu_t, e_t, vlim, *,
                     num_iters: int, relaxation: float, dt: float,
                     baumgarte: float, slop: float, max_depen: float,
                     bounce_thresh: float):
    """The arguments of `contact_substep_launch` (csrc/contact_substep.cu):
    input pointers, the outputs (gv_new_t, pcp_new_t, lam_t) allocated on
    the inputs' device, the floats and the ints.  Checks every operand's
    device, dtype, shape and contiguity, and that SUBSTEP_ENVS divides the
    padded env count."""
    dev = gv_t.device
    nv, Npad = gv_t.shape
    P = pcp_t.shape[0]
    if Npad % SUBSTEP_ENVS:
        raise ValueError(f"contact_substep: {Npad} padded envs, not a "
                         f"multiple of {SUBSTEP_ENVS}")
    ins = [("J_t", J_t, (P, 3, nv, Npad)), ("W_t", W_t, (P, 9, Npad)),
           ("Minv_t", Minv_t, (nv, nv, Npad)), ("pcp_t", pcp_t, (P, 3, Npad)),
           ("gv_t", gv_t, (nv, Npad)), ("rh_t", rh_t, (P, Npad)),
           ("mu_t", mu_t, (1, Npad)), ("e_t", e_t, (1, Npad)),
           ("vlim", vlim, (nv, 1))]
    ptrs = [_build.check(n, x, shp, dev).data_ptr() for n, x, shp in ins]
    outs = (torch.empty((nv, Npad), dtype=torch.float32, device=dev),
            torch.empty((P, 3, Npad), dtype=torch.float32, device=dev),
            torch.empty((P, 3, Npad), dtype=torch.float32, device=dev))
    return ptrs, outs, (dt, relaxation, baumgarte / dt, slop, max_depen,
                        bounce_thresh), (Npad, num_iters, SUBSTEP_THREADS)


# -- work counts (bytes moved, fp32 operations) per env -----------------------


def cache_ops(nd) -> int:
    """fp32 operations of the J/W build for points that depend on `nd[p]`
    dofs each (a multiply-add counts 2): per nonzero J column a cross
    product, an add and the mask (15), then three rows t_i = J_i M^-1 and
    their three dot products with J, and eps on the diagonal."""
    return int(sum(15 * d + 3 * (2 * d * d + 3 * 2 * d) + 3 for d in nd))


def solve_ops(jnz: int, P: int, nv: int, iters: int, warm: bool,
              flat: bool = True) -> int:
    """fp32 operations of one contact solve on a Jacobian with `jnz` nonzero
    entries: targets from the free velocity, (warm: the seed pre-applied,)
    `iters` sweeps of {J gv, the row updates, J^T dlam, M^-1 product}, and
    the point advance.  A point's row update takes 40 operations on flat
    ground and 92 with a surface normal (n.v, the 3-D slip, t^T W t on the
    full 3x3 W, the normal part of the impulse taken out and put back), its
    target 5 more (n.v0)."""
    minv = 2 * nv * nv
    row, tgt = (40, 10) if flat else (92, 15)
    sweep = 2 * jnz * 2 + P * row + minv
    return ((2 * jnz + P * tgt) + ((2 * jnz + minv) if warm else 0)
            + iters * sweep + (2 * jnz + 6 * P + nv))


def cache_work_per_env(anc_p):
    """(bytes moved, fp32 operations) per env of `build_contact_cache`:
    Sw, Sv, M^-1 and r read once, the dense J and W written once (the mask
    is shared by all envs and not counted); operations with the mask's
    static zeros taken out."""
    anc_p = np.asarray(anc_p).astype(bool)
    P, nv = anc_p.shape
    floats = (2 * nv * 3 + nv * nv + P * 3) + (P * 3 * nv + P * 9)
    return 4 * floats, cache_ops(anc_p.sum(axis=1))


def substep_work_per_env(nv: int, P: int, num_iters: int):
    """(bytes moved, fp32 operations) per env of `contact_substep`: J, M^-1,
    points, velocity, gap offsets, friction and restitution read once, of W
    the four entries the flat-ground solve uses (W00, W01, W11, W22),
    velocity, points and impulses written once.  The function is given no
    topology, so J counts as dense."""
    floats = (P * 3 * nv + P * 4 + nv * nv + P * 3 + nv + P + 2) \
        + (nv + 2 * P * 3)
    return 4 * floats, solve_ops(P * 3 * nv, P, nv, num_iters, False)
