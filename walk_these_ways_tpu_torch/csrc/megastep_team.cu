// Whole-control-step kernel for Hopper (sm_90a), one warp per env: one
// launch runs all `decimation` physics substeps of one control step, with
// the dynamics cache built inside the launch: once from the entry state in
// reuse mode, before every substep from the current state in exact mode.
//
// Replaces: the JAX package's ops/pallas_megastep.py::_megastep_kernel (the
// TPU kernel reached through control_step_pallas), in the compile-time
// variants of the template flags FLAT, PCTRL and EXACT:
//   K4     reuse mode, flat ground (FLAT true, n = +z), actuator network;
//   K4b    reuse mode on a heightfield (FLAT false), actuator network: the
//          height and the surface normal under each contact point are
//          sampled once, at the entry contact points, from the
//          corner-packed heightfield (heightfield_sample, Terrain.lookup's
//          arithmetic), and the normals enter the contact solve through its
//          general-normal rows (normal_row_update);
//   K4c    reuse mode, flat ground, P control (PCTRL true): tau = kp (tgt -
//          q) - kd qd, no actuator histories;
//   K4b-P  reuse mode on a heightfield, P control;
//   K5     exact mode (EXACT true) with the cache rebuild _cache_arrays,
//          flat ground only, actuator network;
//   K5-P   exact mode, P control.
// Exact mode on a heightfield is not a variant: the env runs it as
// `decimation` reuse-mode launches of one substep each.
//
// What it computes, per env (envs are independent), as the JAX kernel:
//   cache:   the dynamics cache (the statements of physics/envminor
//            cache_columns: FK, twist bases, inertia blocks, CRBA,
//            closed-form M^-1, contact points p_cp) about the base position;
//            r = p_cp - pos; per point the leg-joint Jacobian columns and
//            W_p = J_p M^-1 J_p^T + eps I (on a heightfield its six distinct
//            entries and n^T W_p n, with rh = h + radius and n sampled at
//            p_cp).  Reuse mode builds it once, from the entry state;
//            exact mode before every substep, from the current q, quat and
//            pos, anchored at the current base position (delta = 0), with
//            the contact points of that FK;
//   D times: torque model (actuator MLP 6 -> H -> H -> 1, softsign, per
//            joint; or P control) -> x motor strength -> torque clip ->
//            joint-limit torque -> unconstrained dynamics twice (midpoint
//            rule) -> row-decoupled projected-Jacobi contact solve on the
//            total impulse (in reuse mode the first substep seeded
//            from `lam_in`, or cold with `num_iters` sweeps without it, the
//            later ones warm-started from the previous substep's impulses
//            with `warm_iters` sweeps; in exact mode every solve cold with
//            `num_iters` sweeps), gv += M^-1 J^T dlam after each sweep
//            -> contact points advanced at velocity level -> velocity clips
//            -> integrate pos / quaternion exp map / q.
// The iteration counts and the arithmetic are the plain version's
// (ops/megastep.control_step_reference, in reuse mode fed the eager build
// of the same cache): the same statements in the same order, spread over
// the lanes of a warp.
//
// Design for this card.  One thread per env ran about one warp per SM at
// 4000 envs and kept 4-5 KB of per-env arrays in local memory: it was bound
// by instruction latency at 1 % of its bound or less.  Here an env is a team
// of 32 lanes (one warp), TEAM_ENVS envs per block.  The parallel axes are
// the algorithm's own:
//   - the cache (team_entry_cache; exact mode runs it at the top of every
//     substep, into the same shared memory): FK over the joint lanes one
//     tree depth at a time, twist bases over the joint lanes, inertia
//     blocks and contact points over the body and point lanes, the CRBA's
//     sums over the body and joint lanes, the closed-form M^-1's entries
//     over all lanes (its 6 x 6 Schur inverse on lane 0), into shared
//     memory; then each point lane forms its own J columns and W entries
//     from it (point_cache);
//   - torque model: P control on the joint lanes; the actuator network
//     with lane o as hidden unit o of every joint (H = 32);
//     the weights come packed (ops/megastep.team_actuator_weights) so that
//     the warp's loads are 32 consecutive floats, one 128-byte line, read
//     through the read-only path; the output layer is a serial sum by joint
//     j's lane over the 32 units in shared memory;
//   - contact points: lane p (28 of 32) owns point p: its Jacobian columns,
//     W entries, impulse, position, r, normal and gap stay in its registers;
//     it forms its own W_p, runs its own row update in each sweep (the
//     update is row-decoupled) and writes J_p^T dlam_p into shared memory;
//   - sum over points of J_p^T dlam_p: lane d (18 dofs) sums its slot over
//     the points in index order (base dofs over all points, a leg dof over
//     its leg's points), then lane w forms row w of M^-1 x;
//   - dynamics: body twists and bias forces over the 13 body lanes, the
//     velocity-product terms over the 12 joint lanes, tau - bias and
//     M^-1 (tau - bias) over the 18 dof lanes (ops/dynamics.dyn_core's
//     statements).
// Every sum is serial on one lane in the plain version's order (and the
// cache build's entries are physics/envminor.cache_columns' statements), so
// no env crosses a solver branch for another summation order.  Lanes meet
// only at __syncwarp; no shuffles.
//
// Memory.  Per env in shared memory (TeamEnv, 5,696 bytes): M^-1 (324
// floats; M while the cache is built), the twist bases Sw / Sv (108), the
// inertia blocks A / B and the masses (247), the generalized-velocity
// vectors and the base state (109), and one union reused by the phases
// (the cache build's intermediates 636 floats; actuator inputs and hidden
// layers 520; dynamics temporaries 228; the per-point J^T f rows 252).
// TEAM_ENVS = 8 gives 45,568 bytes of static shared memory per 256-thread
// block.  At 4000 envs on 132 SMs one wave needs 31 envs (31 warps) per SM:
// __launch_bounds__ asks ptxas for TEAM_MIN_BLOCKS = 4 resident blocks, 32
// warps, so at most 64 registers a thread (a few spill; ptxas -v, and
// cudaOccupancyMaxActiveBlocksPerMultiprocessor through
// megastep_team_occupancy, report it).  The actuator weights (15,756
// floats, 63 KB, shared by every env) are not staged in shared memory: a
// block holding them would hold 108 KB and two blocks, 16 warps, would fit
// an SM; read as whole lines through the read-only path they stay in L1
// (the SM's 256 KB less the four blocks' 182 KB of shared memory holds
// most of them) and in L2.
//
// Bound on this card (ops/megastep.work_per_env, `entry`): per env 2.5 KB
// (K4b 2.9 KB; K4c 2.2 KB, K4b-P 2.6 KB) in and out and 0.26 MFLOP (K4b
// 0.29; K4c 0.13, K4b-P 0.15) of fp32 on the CUDA cores, the cache build
// once included, so at 4000 envs the least time is set by arithmetic
// (about 0.016 ms; P control about 0.008 ms).  Exact mode (`exact`): per
// env 2.1 KB (K5-P 1.8 KB) and 0.55 MFLOP (K5-P 0.42), D cache builds
// included, about 0.033 ms (K5-P 0.025 ms).  No tensor cores: TF32's
// 10-bit mantissa cannot hold the kernel-vs-plain tolerance, and the
// kernels are built without fused multiply-adds (ops/_build.py).  The
// measured numbers are kept in PERF.md.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_megastep.cuh"
#include "wtw_team.cuh"

// the actuator weights as ops/megastep.team_actuator_weights packs them:
// per joint j the nonzero blocks of the block-diagonal matrices, laid out
// so that lane o (hidden unit o) reads consecutive floats with its
// neighbours: W0[j][f][o], b0[j][o], W1[j][i][o], b1[j][o], W2[o][j], b2[j]
#define NET_W0 0
#define NET_B0 (NET_W0 + NJ * NF * NH)
#define NET_W1 (NET_B0 + NJ * NH)
#define NET_B1 (NET_W1 + NJ * NH * NH)
#define NET_W2 (NET_B1 + NJ * NH)
#define NET_B2 (NET_W2 + NH * NJ)

static_assert(NH == TEAM, "one lane per hidden unit of the actuator network");
static_assert(NJ % 2 == 0, "the actuator network runs two joints at a time");

template <bool FLAT, bool PCTRL, bool EXACT>
__global__ void __launch_bounds__(TEAM * TEAM_ENVS, TEAM_MIN_BLOCKS)
megastep_team_kernel(const MegastepArgs a) {
  static_assert(FLAT || !EXACT, "exact mode is flat-ground only");
  __shared__ TeamEnv team_envs[TEAM_ENVS];
  const int lane = threadIdx.x % TEAM;
  TeamEnv& s = team_envs[threadIdx.x / TEAM];
  // the grid covers npad exactly (the launcher checks that TEAM_ENVS
  // divides it): every warp is one env, and all its lanes reach every
  // __syncwarp
  const int env = blockIdx.x * TEAM_ENVS + threadIdx.x / TEAM;
  const size_t npad = (size_t)a.npad;
#define LD(idx, row) __ldg(a.in[idx] + (size_t)(row) * npad + env)
#define ST(idx, row, val) a.out[idx][(size_t)(row) * npad + env] = (val)
#define LDC(idx, k) __ldg(a.in[idx] + (k))

  const float dt = a.f[F_DT], relax = a.f[F_RELAX], eps = a.f[F_EPS];
  const bool is_joint = lane < NJ, is_point = lane < NP;
  const int j = lane, p = lane;
  const int lo = is_point ? MS_PT_LO[p] : 0, n = is_point ? MS_PT_N[p] : 0;
  const LaneMasks mk = lane_masks(lane);

  // ---- entry state: joint lanes own their joint, lanes 0..3 the base ----
  float q = 0.0f, qd = 0.0f, tau_m = 0.0f;
  // actuator-network histories (none with P control)
  float el = 0.0f, ell = 0.0f, vl = 0.0f, vll = 0.0f;
  if (is_joint) {
    q = LD(I_Q, j); qd = LD(I_QD, j);
    if constexpr (!PCTRL) {
      el = LD(I_EL, j); ell = LD(I_ELL, j);
      vl = LD(I_VL, j); vll = LD(I_VLL, j);
    }
  }
  if (lane < 3) {
    s.pos[lane] = LD(I_POS, lane); s.lin[lane] = LD(I_LIN, lane);
    s.ang[lane] = LD(I_ANG, lane); s.g[lane] = LD(I_G, lane);
    s.ref[lane] = s.pos[lane];
  }
  if (lane < 4) s.quat[lane] = LD(I_QUAT, lane);
  const float mu = LD(I_MU, 0), rest = LD(I_E, 0);
  __syncwarp();

  // ---- the contact points: lane p owns point p ----
  float pcp[3] = {0.0f, 0.0f, 0.0f}, r[3] = {0.0f, 0.0f, 0.0f};
  float lam[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 1.0f};
  float Jl[GM][3];
  float W00 = 0.0f, W01 = 0.0f, W11 = 0.0f, W02 = 0.0f, W12 = 0.0f;
  float W22 = 0.0f, inv_wnn = 0.0f, rh = 0.0f;
  const bool have_seed = !EXACT && a.in[I_LAM] != nullptr;

  // The cache about s.ref, and each point lane's contact point, r, J
  // columns and W entries from it (reuse mode: and the seed impulse).
  // Starts after and ends at a __syncwarp, after which the union is free.
  auto build_cache = [&]() {
    {
      const float comdisp[3] = {LD(I_COMDISP, 0), LD(I_COMDISP, 1),
                                LD(I_COMDISP, 2)};
      team_entry_cache(s, q, LD(I_PAYLOAD, 0), comdisp, mk, lane);
    }
    if (is_point) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pcp[i] = s.u.build.pcp[p][i];
        r[i] = pcp[i] - s.pos[i];
        if constexpr (!EXACT) lam[i] = have_seed ? LD(I_LAM, p * 3 + i) : 0.0f;
      }
      rh = LD(I_RH, p);
      if constexpr (!FLAT) {
        // height and normal under the contact point: rh = h + radius
        float h;
        heightfield_sample(a.in[I_CORNERS], a.c_rows, a.c_cols, a.f[F_HS],
                           a.f[F_OX], a.f[F_OY], pcp[0], pcp[1], h, nrm);
        rh = h + rh;
      }
      point_cache<FLAT>(p, ThreadRows{s.Minv, 0, 0}, s.sw, s.sv, r, Jl, W00,
                        W01, W11, W02, W12, W22, inv_wnn, nrm, eps, relax);
    }
    __syncwarp();
  };
  // reuse mode: the entry cache, about the entry base position
  if constexpr (!EXACT) build_cache();

  // ---- D substeps ----
#pragma unroll 1
  for (int si = 0; si < a.D; ++si) {
    if constexpr (EXACT) {
      // the whole cache from the current state, re-anchored at the current
      // base position (delta = 0), with fresh FK contact points
      if (lane < 3) s.ref[lane] = s.pos[lane];
      __syncwarp();
      build_cache();
    }
    // torque model: P control on the joint lanes, or the per-joint MLP on
    // [err, el, ell, qd, vl, vll] whose weights are the nonzero blocks of
    // the block-diagonal matrices
    float t = 0.0f;
    if constexpr (PCTRL) {
      if (is_joint)
        t = LD(I_KP, j) * (LD(I_TGT, si * NJ + j) - q) - LD(I_KD, j) * qd;
    } else {
      float err = 0.0f;
      if (is_joint) {
        err = q - LD(I_TGT, si * NJ + j);
        const float x[NF] = {err, el, ell, qd, vl, vll};
#pragma unroll
        for (int f = 0; f < NF; ++f) s.u.net.in[j][f] = x[f];
      }
      __syncwarp();
      // hidden unit o of every joint, two joints at a time: two
      // independent sums, each in the one-thread kernel's order
      const int o = lane;
#pragma unroll 1
      for (int jj = 0; jj < NJ; jj += 2) {
        float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          acc0 += LDC(I_NET, NET_W0 + (jj * NF + f) * NH + o)
                * s.u.net.in[jj][f];
          acc1 += LDC(I_NET, NET_W0 + ((jj + 1) * NF + f) * NH + o)
                * s.u.net.in[jj + 1][f];
        }
        float* h0a = s.u.net.h0[jj & 2];
        float* h0b = s.u.net.h0[(jj & 2) + 1];
        h0a[o] = softsign(acc0 + LDC(I_NET, NET_B0 + jj * NH + o));
        h0b[o] = softsign(acc1 + LDC(I_NET, NET_B0 + (jj + 1) * NH + o));
        __syncwarp();
        const float* w1 = a.in[I_NET] + NET_W1 + jj * NH * NH + o;
        acc0 = 0.0f;
        acc1 = 0.0f;
#pragma unroll 8
        for (int i = 0; i < NH; ++i) {
          acc0 += __ldg(w1 + i * NH) * h0a[i];
          acc1 += __ldg(w1 + NH * NH + i * NH) * h0b[i];
        }
        s.u.net.h1[jj][o] = softsign(acc0 + LDC(I_NET, NET_B1 + jj * NH + o));
        s.u.net.h1[jj + 1][o] =
            softsign(acc1 + LDC(I_NET, NET_B1 + (jj + 1) * NH + o));
      }
      __syncwarp();
      if (is_joint) {
#pragma unroll 4
        for (int o = 0; o < NH; ++o)
          t += LDC(I_NET, NET_W2 + o * NJ + j) * s.u.net.h1[j][o];
        t += LDC(I_NET, NET_B2 + j);
        ell = el; el = err; vll = vl; vl = qd;
      }
    }
    if (is_joint) {
      t = t * LD(I_STR, j);
      t = clampf(t, LDC(I_TLIM, j));
      tau_m = t;
      // joint-limit spring / damper
      const float over = fmaxf(q - LDC(I_QHI, j), 0.0f);
      const float under = fmaxf(LDC(I_QLO, j) - q, 0.0f);
      const float at_lim = (over > 0.0f || under > 0.0f) ? 1.0f : 0.0f;
      const float tau_lim = a.f[F_KLIM] * (under - over)
                          - a.f[F_DLIM] * at_lim * qd;
      s.tau[6 + j] = t + tau_lim;
      s.gv0[6 + j] = qd;
    }
    // unconstrained dynamics at the anchor point, midpoint rule
    float delta[3], cd[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) delta[i] = s.ref[i] - s.pos[i];
    cross3(s.ang, delta, cd);
    if (lane < 3) {
      s.tau[lane] = 0.0f; s.tau[3 + lane] = 0.0f;
      s.gv0[lane] = s.ang[lane];
      s.gv0[3 + lane] = s.lin[lane] + cd[lane];
    }
    __syncwarp();
    team_dynamics(s, s.gv0, mk, lane);
    if (lane < NV) s.gv[lane] = s.gv0[lane] + a.f[F_HALFDT] * s.qdd[lane];
    __syncwarp();
    team_dynamics(s, s.gv, mk, lane);
    if (lane < NV) s.gv[lane] = s.gv0[lane] + dt * s.qdd[lane];  // gv_free
    __syncwarp();

    if (si == a.D - 1 && is_point) {
#pragma unroll
      for (int i = 0; i < 3; ++i) ST(O_PCPPREV, p * 3 + i, pcp[i]);
    }

    if (a.contact) {
      const bool warm = !EXACT && a.warm_iters > 0 && (si > 0 || have_seed);
      const int iters = warm ? a.warm_iters : a.num_iters;
      // gap and velocity target from the free velocity
      float target = 0.0f, active = 0.0f;
      if (is_point) {
        const float phi = rh - pcp[2];
        active = phi > 0.0f ? 1.0f : 0.0f;
        float v0[3];
        point_velocity(s.gv, r, Jl, lo, n, v0);
        float vn0 = v0[2];
        if constexpr (!FLAT)
          vn0 = nrm[0] * v0[0] + nrm[1] * v0[1] + nrm[2] * v0[2];
        const float bounce = vn0 < -a.f[F_BOUNCE] ? -rest * vn0 : 0.0f;
        const float bias = fminf(
            a.f[F_BAUM_DT] * fmaxf(phi - a.f[F_SLOP], 0.0f),
            a.f[F_MAXDEPEN]);
        target = fmaxf(bounce, bias);
      }
      if (warm) {
        // pre-apply the seed impulse: gv = gv0 + M^-1 J^T lam0
        if (is_point) point_jt(lam, r, Jl, n, s.u.jt[p]);
        __syncwarp();
        team_apply_impulses(s, lane);
      } else {
        lam[0] = lam[1] = lam[2] = 0.0f;
      }
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
        if (is_point) {
          float v[3], l[3];
          point_velocity(s.gv, r, Jl, lo, n, v);
          if constexpr (FLAT) {
            flat_row_update(v, W00, W01, W11, target, inv_wnn, relax, mu,
                            active, lam, l);
          } else {
            const float Wp[9] = {W00, W01, W02, W01, W11, W12,
                                 W02, W12, W22};
            l[0] = lam[0]; l[1] = lam[1]; l[2] = lam[2];
            normal_row_update(v, nrm, Wp, target, inv_wnn, relax, mu,
                              active, l);
          }
          const float dl[3] = {l[0] - lam[0], l[1] - lam[1], l[2] - lam[2]};
          lam[0] = l[0]; lam[1] = l[1]; lam[2] = l[2];
          point_jt(dl, r, Jl, n, s.u.jt[p]);
        }
        __syncwarp();
        team_apply_impulses(s, lane);
      }
      // advance the points with the clamped velocities
      if (lane < NV) s.x[lane] = clampf(s.gv[lane], LDC(I_VLIM, lane));
      __syncwarp();
      if (is_point) {
        float v[3];
        point_velocity(s.x, r, Jl, lo, n, v);
        pcp[0] += dt * v[0]; pcp[1] += dt * v[1]; pcp[2] += dt * v[2];
      }
    } else {
      lam[0] = lam[1] = lam[2] = 0.0f;
    }

    // clips + integration
    if (is_joint) {
      qd = clampf(s.gv[6 + j], LDC(I_VLIM, 6 + j));
      q = q + dt * qd;
    }
    if (lane == 0) {
      float ang[3], vref[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ang[i] = clampf(s.gv[i], a.f[F_MAXANG]);
        vref[i] = clampf(s.gv[3 + i], a.f[F_MAXLIN]);
      }
      cross3(ang, delta, cd);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s.ang[i] = ang[i];
        s.lin[i] = vref[i] - cd[i];
        s.pos[i] = s.pos[i] + dt * s.lin[i];
      }
      // quaternion exp map, xyzw, world angular velocity
      const float angle = sqrtf(ang[0] * ang[0] + ang[1] * ang[1]
                                + ang[2] * ang[2]);
      const float ia = fmaxf(angle, 1e-9f);
      float ax[3] = {ang[0] / ia, ang[1] / ia, ang[2] / ia};
      const float an = fmaxf(
          sqrtf(ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2]), 1e-9f);
      ax[0] = ax[0] / an; ax[1] = ax[1] / an; ax[2] = ax[2] / an;
      const float half = 0.5f * (angle * dt);
      const float sn = sinf(half);
      const float dx = ax[0] * sn, dy = ax[1] * sn, dz = ax[2] * sn;
      const float dw = cosf(half);
      const float qx = s.quat[0], qy = s.quat[1], qz = s.quat[2],
                  qw = s.quat[3];
      const float rx = dw * qx + dx * qw + dy * qz - dz * qy;
      const float ry = dw * qy - dx * qz + dy * qw + dz * qx;
      const float rz = dw * qz + dx * qy - dy * qx + dz * qw;
      const float rw = dw * qw - dx * qx - dy * qy - dz * qz;
      const float inv = 1.0f / fmaxf(
          sqrtf(rx * rx + ry * ry + rz * rz + rw * rw), 1e-9f);
      s.quat[0] = rx * inv; s.quat[1] = ry * inv;
      s.quat[2] = rz * inv; s.quat[3] = rw * inv;
    }
    __syncwarp();
  }

  // ---- exit state ----
  if (is_joint) {
    ST(O_Q, j, q); ST(O_QD, j, qd); ST(O_TAU, j, tau_m);
    if constexpr (!PCTRL) {
      ST(O_EL, j, el); ST(O_ELL, j, ell); ST(O_VL, j, vl); ST(O_VLL, j, vll);
    }
  }
  if (lane < 3) {
    ST(O_POS, lane, s.pos[lane]); ST(O_LIN, lane, s.lin[lane]);
    ST(O_ANG, lane, s.ang[lane]);
  }
  if (lane < 4) ST(O_QUAT, lane, s.quat[lane]);
  if (is_point) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ST(O_PCP, p * 3 + i, pcp[i]);
      ST(O_LAM, p * 3 + i, lam[i]);
    }
  }
#undef LD
#undef ST
#undef LDC
}

// Plain C interface for ctypes, the argument list of wtw_megastep.cuh.
// Reuse mode (ip[P_EXACT] 0) builds the entry cache here from in[I_PAYLOAD]
// and in[I_COMDISP], and takes the cross-step seed in[I_LAM] where it is
// not null; on a heightfield (flat 0) the corner-packed field in[I_CORNERS]
// of ip[P_CROWS] x ip[P_CCOLS] cells and its pitch and origin f[F_HS],
// f[F_OX], f[F_OY].  Exact mode (ip[P_EXACT]) takes the same payload and
// COM shift, flat ground only and no seed.  Either torque model: the
// packed actuator weights in[I_NET] and the histories, or with P control
// (ip[P_PCTRL]) the gains in[I_KP], in[I_KD] and no histories.  `threads`
// must be TEAM * TEAM_ENVS and npad a multiple of TEAM_ENVS.  Launches on
// `stream`, does not synchronise, returns the launch's cudaError_t (0 =
// launched).
extern "C" int megastep_team_launch(const void* const* in, void* const* out,
                                    const float* f, const int* ip,
                                    void* stream) {
  const MegastepArgs a = megastep_args(in, out, f, ip);
  const int threads = ip[P_THREADS], flat = ip[P_FLAT], pctrl = ip[P_PCTRL];
  const int exact = ip[P_EXACT];
  if (threads != TEAM * TEAM_ENVS || a.npad < 1 || a.npad % TEAM_ENVS
      || a.D < 1 || (exact && (!flat || a.in[I_LAM] != nullptr))
      || a.in[I_PAYLOAD] == nullptr || a.in[I_COMDISP] == nullptr
      || (pctrl ? (a.in[I_KP] == nullptr || a.in[I_KD] == nullptr)
                : a.in[I_NET] == nullptr)
      || (!flat && (a.in[I_CORNERS] == nullptr || a.c_rows < 1
                    || a.c_cols < 1)))
    return (int)cudaErrorInvalidValue;
  const int blocks = a.npad / TEAM_ENVS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (exact && pctrl)
    megastep_team_kernel<true, true, true><<<blocks, threads, 0, st>>>(a);
  else if (exact)
    megastep_team_kernel<true, false, true><<<blocks, threads, 0, st>>>(a);
  else if (flat && pctrl)
    megastep_team_kernel<true, true, false><<<blocks, threads, 0, st>>>(a);
  else if (flat)
    megastep_team_kernel<true, false, false><<<blocks, threads, 0, st>>>(a);
  else if (pctrl)
    megastep_team_kernel<false, true, false><<<blocks, threads, 0, st>>>(a);
  else
    megastep_team_kernel<false, false, false><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* megastep_team_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int megastep_team_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}

// Resident blocks per SM of the six instantiations, into blocks[0..5] in
// the order K4, K4b, K4c, K4b-P, K5, K5-P, and the threads and static
// shared memory per block (the same for all six); returns the cudaError_t.
extern "C" int megastep_team_occupancy(int* blocks, int* threads,
                                       int* smem_bytes) {
  *threads = TEAM * TEAM_ENVS;
  *smem_bytes = (int)(sizeof(TeamEnv) * TEAM_ENVS);
  const void* kernels[6] = {
      (const void*)megastep_team_kernel<true, false, false>,
      (const void*)megastep_team_kernel<false, false, false>,
      (const void*)megastep_team_kernel<true, true, false>,
      (const void*)megastep_team_kernel<false, true, false>,
      (const void*)megastep_team_kernel<true, false, true>,
      (const void*)megastep_team_kernel<true, true, true>};
  cudaError_t e = cudaSuccess;
  for (int k = 0; k < 6 && e == cudaSuccess; ++k)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[k], kernels[k],
                                                      *threads, 0);
  return (int)e;
}
