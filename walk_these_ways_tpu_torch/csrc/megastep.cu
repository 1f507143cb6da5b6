// Whole-control-step kernel for Hopper (sm_90a), one thread per env: one
// launch runs all `decimation` physics substeps of one control step.
//
// Replaces: the JAX package's ops/pallas_megastep.py::_megastep_kernel (the
// TPU kernel reached through control_step_pallas), in the compile-time
// variants of the template flags PCTRL, EXACT and FLAT that run here:
//   K4c  reuse mode, flat ground (n = +z), P control: tau = kp (tgt - q)
//        - kd qd; contact impulses warm-started (from `lam_in` and across
//        substeps); the cache an input, built on the host;
//   K4b-P  reuse mode on a heightfield (FLAT false) with P control: the
//        per-point surface normals n (sampled once per control step at the
//        entry contact points) enter the contact solve through its
//        general-normal rows (wtw_device.cuh normal_row_update);
//   K5   exact mode, flat ground (either torque model): the whole dynamics
//        cache is rebuilt from the current state before every substep, in
//        the kernel (csrc/wtw_cache.cuh); every substep's contact solve
//        starts cold.  Exact mode on a heightfield is not a variant: the env
//        runs it as `decimation` K4b launches of one substep each.
// The actuator network in reuse mode (K4 flat, K4b on a heightfield) runs
// in csrc/megastep_team.cu, one warp per env, with the entry cache built
// in its launch; this launcher refuses it.
//
// What it computes, per env (envs are independent):
//   reuse, once: r = p_cp - pos;  leg-joint Jacobian columns
//            J[p,:,v] = anc[p,v] * (Sv[v] + Sw[v] x r[p]);  the entries
//            W00, W01, W11, W22 of W_p = J_p M^-1 J_p^T + eps I (K4b: the
//            six distinct entries of the symmetric W_p, and n^T W_p n)
//   D times: torque model (actuator MLP 6 -> H -> H -> 1, softsign, per joint;
//            or P control) -> x motor strength -> torque clip -> joint-limit
//            torque -> [exact: FK, twists, inertia, CRBA, M^-1 and contact
//            points from the current q, quat, pos; then J and W as above,
//            about the current base position] -> unconstrained dynamics twice
//            (midpoint rule) -> row-decoupled projected-Jacobi contact solve on
//            the total impulse (friction cone saturating exactly) with lazy
//            gv += M^-1 J^T dlam -> contact point advance -> velocity clips ->
//            integrate pos / quaternion exp map / q
//
// Design for this card.  One thread owns one env and runs the whole scalar
// program; parallelism is across envs only.  Every operand is env-minor
// (env is the last, contiguous axis), so the 32 threads of a warp read 32
// neighbouring floats: each load is one coalesced 128-byte line.  The dense
// point Jacobian (P*3*nv floats per env) never exists: the base-dof columns
// are the unit root twists, so J gv = v_lin + w x r and J^T f = (r x f, f) are
// taken from r directly, and only the leg-joint columns (P * GMAX * 3 floats)
// are kept, in thread-local memory.  In reuse mode M^-1, the inertia blocks
// and the actuator weights stay in global memory and are re-read through the
// read-only path (EnvRows): the cache is not written during the launch, a
// warp's working set of it fits L1, and the weights are read at one address
// by the whole warp (a broadcast).  In exact mode the kernel writes its cache
// itself every substep, so it lives in thread-local arrays read with ordinary
// loads (ThreadRows): the read-only path is not coherent with the kernel's own
// stores.  The dynamics and the solve are the same code for both, templated
// on the accessor (wtw_device.cuh).  The state touches global memory once on
// entry and once on exit.
//
// Bound on this card (ops/megastep.work_per_env): per env a few KB in and
// out and 0.12 (K4c) to 0.55 (K5) MFLOP of fp32 on the CUDA cores (K4b-P:
// about 50 more operations per point and sweep than K4c for the
// general-normal rows), so at 4000 envs the least time is set by
// arithmetic, not by memory.  One thread per env gives about one warp per
// SM at 4000 envs, so the kernel as written is bound by instruction
// latency, far above that least time; exact mode adds about 4 KB of
// thread-local arrays per env, in local memory.  K4b-P reads a point's
// normal from global memory where it needs it (read-only for the launch,
// so through __ldg) rather than holding 84 more floats per thread, and
// keeps W_p's extra entries W02, W12, W22 in thread-local memory beside
// K4c's.  The measured numbers are kept in PERF.md.
//
// Reuse mode: rows 0..5 of Sw/Sv must be the unit root twists (rows 0..2:
// unit angular, rows 3..5: unit linear), as physics/envminor makes them.  The
// dynamics read them as data; the contact Jacobian relies on it.
//
// The topology header is generated by ops/_build.py from the RobotModel into
// the build directory; the device helpers shared with the other kernels
// (cross3, m3v, m3tv, row accessors, minv_mul, dyn_core) live in
// wtw_device.cuh, the argument lists and the per-point arithmetic shared
// with the team kernel in wtw_megastep.cuh, the exact-mode cache rebuild in
// wtw_cache.cuh.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_megastep.cuh"
#include "wtw_cache.cuh"

// Where the dynamics and the solve read M^-1, the inertia blocks and the
// masses: the launch's input cache (reuse) or the kernel's own (exact).
template <bool EXACT> struct RowsOf { using type = EnvRows; };
template <> struct RowsOf<true> { using type = ThreadRows; };


// Velocity of contact point p (wtw_megastep.cuh point_velocity).
__device__ __forceinline__ void jdot_p(int p, const float* gv,
                                       const float (*r)[3],
                                       const float (*Jl)[GM][3], float* v) {
  point_velocity(gv, r[p], Jl[p], MS_PT_LO[p], MS_PT_N[p], v);
}

// jta += J_p^T f
__device__ __forceinline__ void jt_acc_p(int p, const float* f,
                                         const float (*r)[3],
                                         const float (*Jl)[GM][3],
                                         float* jta) {
  float c[3];
  cross3(r[p], f, c);
  jta[0] += c[0]; jta[1] += c[1]; jta[2] += c[2];
  jta[3] += f[0]; jta[4] += f[1]; jta[5] += f[2];
  const int lo = MS_PT_LO[p], n = MS_PT_N[p];
  for (int k = 0; k < n; ++k)
    jta[lo + k] += Jl[p][k][0] * f[0] + Jl[p][k][1] * f[1]
                 + Jl[p][k][2] * f[2];
}

// Every contact point's Jacobian columns and effective-mass entries
// (wtw_megastep.cuh point_cache); with surface normals `nrm` (FLAT false;
// env-minor (P, 3, npad), read-only for the launch) the general-normal
// entries too.
template <bool FLAT, class Rows>
__device__ __forceinline__ void points_cache(
    const Rows& Minv, const float (*sw)[3], const float (*sv)[3],
    const float (*r)[3], float (*Jl)[GM][3], float* W00, float* W01,
    float* W11, float* W02, float* W12, float* W22, float* inv_wnn,
    const float* nrm, size_t npad, int env, float eps, float relax) {
#pragma unroll 1
  for (int p = 0; p < NP; ++p) {
    float nv[3] = {0.0f, 0.0f, 1.0f};
    if constexpr (!FLAT) load_normal(nrm, p, npad, env, nv);
    point_cache<FLAT>(p, Minv, sw, sv, r[p], Jl[p], W00[p], W01[p], W11[p],
                      W02[FLAT ? 0 : p], W12[FLAT ? 0 : p],
                      W22[FLAT ? 0 : p], inv_wnn[p], nv, eps, relax);
  }
}

template <bool PCTRL, bool EXACT, bool FLAT>
__global__ void __launch_bounds__(128)
megastep_kernel(const MegastepArgs a) {
  static_assert(FLAT || !EXACT, "exact mode is flat-ground only");
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= a.npad) return;          // ragged edge of the last block
  const size_t npad = (size_t)a.npad;
#define LD(idx, row) __ldg(a.in[idx] + (size_t)(row) * npad + env)
#define ST(idx, row, val) a.out[idx][(size_t)(row) * npad + env] = (val)
#define LDC(idx, k) __ldg(a.in[idx] + (k))     // same address for the warp

  const float dt = a.f[F_DT], relax = a.f[F_RELAX], eps = a.f[F_EPS];

  // ---- entry state ----
  float q[NJ], qd[NJ], tau_m[NJ];
  // actuator-network histories (unused with P control)
  float el[NJ], ell[NJ], vl[NJ], vll[NJ];
#pragma unroll 1
  for (int j = 0; j < NJ; ++j) {
    q[j] = LD(I_Q, j); qd[j] = LD(I_QD, j);
    tau_m[j] = 0.0f;
    if constexpr (!PCTRL) {
      el[j] = LD(I_EL, j); ell[j] = LD(I_ELL, j);
      vl[j] = LD(I_VL, j); vll[j] = LD(I_VLL, j);
    }
  }
  float pos[3], lin[3], ang[3], quat[4], g[3], ref[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pos[i] = LD(I_POS, i); lin[i] = LD(I_LIN, i); ang[i] = LD(I_ANG, i);
    g[i] = LD(I_G, i); ref[i] = pos[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) quat[i] = LD(I_QUAT, i);
  const float mu = LD(I_MU, 0), rest = LD(I_E, 0);

  // ---- the dynamics cache: the launch's (reuse) or the kernel's (exact) ----
  float sw[NV][3], sv[NV][3];
  float pcp[NP][3], r[NP][3], lam[NP][3], Jl[NP][GM][3];
  float W00[NP], W01[NP], W11[NP], inv_wnn[NP];
  // the extra entries of W_p that the general-normal rows read
  float W02[FLAT ? 1 : NP], W12[FLAT ? 1 : NP], W22[FLAT ? 1 : NP];
  float ex_A[EXACT ? NB * 9 : 1], ex_B[EXACT ? NB * 9 : 1];
  float ex_m[EXACT ? NB : 1], ex_minv[EXACT ? NV * NV : 1];
  float payload = 0.0f, comdisp[3] = {0.0f, 0.0f, 0.0f};
  using Rows = typename RowsOf<EXACT>::type;
  const Rows rA{EXACT ? ex_A : a.in[I_A], npad, env};
  const Rows rB{EXACT ? ex_B : a.in[I_B], npad, env};
  const Rows rM{EXACT ? ex_m : a.in[I_M], npad, env};
  const Rows rMinv{EXACT ? ex_minv : a.in[I_MINV], npad, env};
  const bool have_seed = !EXACT && a.in[I_LAM] != nullptr;
  if constexpr (EXACT) {
    payload = LD(I_PAYLOAD, 0);
#pragma unroll
    for (int i = 0; i < 3; ++i) comdisp[i] = LD(I_COMDISP, i);
    // replaced by fresh FK before the first substep
#pragma unroll 1
    for (int p = 0; p < NP; ++p)
      pcp[p][0] = pcp[p][1] = pcp[p][2] = 0.0f;
  } else {
#pragma unroll 1
    for (int d = 0; d < NV; ++d)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        sw[d][i] = LD(I_SW, d * 3 + i);
        sv[d][i] = LD(I_SV, d * 3 + i);
      }
    // contact cache once per control step, about the entry base position
#pragma unroll 1
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pcp[p][i] = LD(I_PCP, p * 3 + i);
        r[p][i] = pcp[p][i] - pos[i];
      }
    points_cache<FLAT>(rMinv, sw, sv, r, Jl, W00, W01, W11, W02, W12, W22,
                       inv_wnn, a.in[I_N], npad, env, eps, relax);
  }
#pragma unroll 1
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      lam[p][i] = have_seed ? LD(I_LAM, p * 3 + i) : 0.0f;

  // ---- D substeps ----
#pragma unroll 1
  for (int si = 0; si < a.D; ++si) {
    // torque model: P control, or the per-joint MLP on
    // [err, el, ell, qd, vl, vll] whose weights are the nonzero blocks of
    // the block-diagonal matrices
    float tau_full[NV];
#pragma unroll
    for (int i = 0; i < 6; ++i) tau_full[i] = 0.0f;
#pragma unroll 1
    for (int j = 0; j < NJ; ++j) {
      float t;
      if constexpr (PCTRL) {
        t = LD(I_KP, j) * (LD(I_TGT, si * NJ + j) - q[j]) - LD(I_KD, j) * qd[j];
      } else {
        const float err = q[j] - LD(I_TGT, si * NJ + j);
        const float x[NF] = {err, el[j], ell[j], qd[j], vl[j], vll[j]};
        float h0[NH], h1[NH];
#pragma unroll 4
        for (int o = 0; o < NH; ++o) {
          const int row = NH * j + o;
          float acc = 0.0f;
#pragma unroll
          for (int f = 0; f < NF; ++f)
            acc += LDC(I_W0, row * (NJ * NF) + NJ * f + j) * x[f];
          h0[o] = softsign(acc + LDC(I_B0, row));
        }
#pragma unroll 2
        for (int o = 0; o < NH; ++o) {
          const int row = NH * j + o;
          const float* wrow = a.in[I_W1] + (size_t)row * (NJ * NH) + NH * j;
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < NH; ++i) acc += __ldg(wrow + i) * h0[i];
          h1[o] = softsign(acc + LDC(I_B1, row));
        }
        t = 0.0f;
#pragma unroll
        for (int o = 0; o < NH; ++o)
          t += LDC(I_W2, j * (NJ * NH) + NH * j + o) * h1[o];
        t += LDC(I_B2, j);
        ell[j] = el[j]; el[j] = err; vll[j] = vl[j]; vl[j] = qd[j];
      }
      t = t * LD(I_STR, j);
      t = clampf(t, LDC(I_TLIM, j));
      tau_m[j] = t;
      // joint-limit spring / damper
      const float over = fmaxf(q[j] - LDC(I_QHI, j), 0.0f);
      const float under = fmaxf(LDC(I_QLO, j) - q[j], 0.0f);
      const float at_lim = (over > 0.0f || under > 0.0f) ? 1.0f : 0.0f;
      const float tau_lim = a.f[F_KLIM] * (under - over)
                          - a.f[F_DLIM] * at_lim * qd[j];
      tau_full[6 + j] = t + tau_lim;
    }

    if constexpr (EXACT) {
      // the whole cache from the current state, re-anchored at the current
      // base position (delta = 0); fresh FK contact points
      cache_columns_dev(q, quat, pos, payload, comdisp, sw, sv, ex_A, ex_B,
                        ex_m, ex_minv, pcp);
#pragma unroll 1
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 3; ++i) r[p][i] = pcp[p][i] - pos[i];
      points_cache<FLAT>(rMinv, sw, sv, r, Jl, W00, W01, W11, W02, W12,
                         W22, inv_wnn, a.in[I_N], npad, env, eps, relax);
#pragma unroll
      for (int i = 0; i < 3; ++i) ref[i] = pos[i];
    }

    // unconstrained dynamics at the anchor point, midpoint rule
    float delta[3], cd[3], gv[NV], qdd[NV], gvm[NV];
#pragma unroll
    for (int i = 0; i < 3; ++i) delta[i] = ref[i] - pos[i];
    cross3(ang, delta, cd);
#pragma unroll
    for (int i = 0; i < 3; ++i) { gv[i] = ang[i]; gv[3 + i] = lin[i] + cd[i]; }
#pragma unroll
    for (int j = 0; j < NJ; ++j) gv[6 + j] = qd[j];
    dyn_core(sw, sv, rA, rB, rM, rMinv, g, tau_full, gv, qdd);
#pragma unroll
    for (int v = 0; v < NV; ++v) gvm[v] = gv[v] + a.f[F_HALFDT] * qdd[v];
    dyn_core(sw, sv, rA, rB, rM, rMinv, g, tau_full, gvm, qdd);
#pragma unroll
    for (int v = 0; v < NV; ++v) gv[v] = gv[v] + dt * qdd[v];   // gv_free

    if (si == a.D - 1) {
#pragma unroll 1
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 3; ++i) ST(O_PCPPREV, p * 3 + i, pcp[p][i]);
    }

    if (a.contact) {
      const bool warm = !EXACT && a.warm_iters > 0 && (si > 0 || have_seed);
      const int iters = warm ? a.warm_iters : a.num_iters;
      // gaps and velocity targets from the free velocity
      float target[NP], active[NP];
#pragma unroll 1
      for (int p = 0; p < NP; ++p) {
        const float phi = LD(I_RH, p) - pcp[p][2];
        active[p] = phi > 0.0f ? 1.0f : 0.0f;
        float v0[3];
        jdot_p(p, gv, r, Jl, v0);
        float vn0 = v0[2];
        if constexpr (!FLAT) {
          float nv[3];
          load_normal(a.in[I_N], p, npad, env, nv);
          vn0 = nv[0] * v0[0] + nv[1] * v0[1] + nv[2] * v0[2];
        }
        const float bounce = vn0 < -a.f[F_BOUNCE] ? -rest * vn0 : 0.0f;
        const float bias = fminf(
            a.f[F_BAUM_DT] * fmaxf(phi - a.f[F_SLOP], 0.0f),
            a.f[F_MAXDEPEN]);
        target[p] = fmaxf(bounce, bias);
      }
      float jta[NV], dgv[NV];
      if (warm) {
        // pre-apply the seed impulse: gv = gv0 + M^-1 J^T lam0
#pragma unroll
        for (int v = 0; v < NV; ++v) jta[v] = 0.0f;
#pragma unroll 1
        for (int p = 0; p < NP; ++p) jt_acc_p(p, lam[p], r, Jl, jta);
        minv_mul(rMinv, jta, dgv);
#pragma unroll
        for (int v = 0; v < NV; ++v) gv[v] += dgv[v];
      } else {
#pragma unroll 1
        for (int p = 0; p < NP; ++p)
          lam[p][0] = lam[p][1] = lam[p][2] = 0.0f;
      }
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int v = 0; v < NV; ++v) jta[v] = 0.0f;
#pragma unroll 1
        for (int p = 0; p < NP; ++p) {
          float v[3];
          jdot_p(p, gv, r, Jl, v);
          float l[3] = {lam[p][0], lam[p][1], lam[p][2]};
          if constexpr (FLAT) {
            flat_row_update(v, W00[p], W01[p], W11[p], target[p], inv_wnn[p],
                            relax, mu, active[p], lam[p], l);
          } else {
            float nv[3];
            load_normal(a.in[I_N], p, npad, env, nv);
            const float Wp[9] = {W00[p], W01[p], W02[p], W01[p], W11[p],
                                 W12[p], W02[p], W12[p], W22[p]};
            normal_row_update(v, nv, Wp, target[p], inv_wnn[p], relax, mu,
                              active[p], l);
          }
          const float ap[3] = {l[0] - lam[p][0], l[1] - lam[p][1],
                               l[2] - lam[p][2]};
          lam[p][0] = l[0]; lam[p][1] = l[1]; lam[p][2] = l[2];
          jt_acc_p(p, ap, r, Jl, jta);
        }
        minv_mul(rMinv, jta, dgv);
#pragma unroll
        for (int v = 0; v < NV; ++v) gv[v] += dgv[v];
      }
      // advance the points with the clamped velocities
      float gcl[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) gcl[v] = clampf(gv[v], LDC(I_VLIM, v));
#pragma unroll 1
      for (int p = 0; p < NP; ++p) {
        float v[3];
        jdot_p(p, gcl, r, Jl, v);
        pcp[p][0] += dt * v[0]; pcp[p][1] += dt * v[1]; pcp[p][2] += dt * v[2];
      }
    } else {
#pragma unroll 1
      for (int p = 0; p < NP; ++p) lam[p][0] = lam[p][1] = lam[p][2] = 0.0f;
    }

    // clips + integration
#pragma unroll
    for (int j = 0; j < NJ; ++j) qd[j] = clampf(gv[6 + j], LDC(I_VLIM, 6 + j));
    float vref[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ang[i] = clampf(gv[i], a.f[F_MAXANG]);
      vref[i] = clampf(gv[3 + i], a.f[F_MAXLIN]);
    }
    cross3(ang, delta, cd);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      lin[i] = vref[i] - cd[i];
      pos[i] = pos[i] + dt * lin[i];
    }
    {
      // quaternion exp map, xyzw, world angular velocity
      const float angle = sqrtf(ang[0] * ang[0] + ang[1] * ang[1]
                                + ang[2] * ang[2]);
      const float ia = fmaxf(angle, 1e-9f);
      float ax[3] = {ang[0] / ia, ang[1] / ia, ang[2] / ia};
      const float an = fmaxf(
          sqrtf(ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2]), 1e-9f);
      ax[0] = ax[0] / an; ax[1] = ax[1] / an; ax[2] = ax[2] / an;
      const float half = 0.5f * (angle * dt);
      const float s = sinf(half);
      const float dx = ax[0] * s, dy = ax[1] * s, dz = ax[2] * s;
      const float dw = cosf(half);
      const float qx = quat[0], qy = quat[1], qz = quat[2], qw = quat[3];
      const float rx = dw * qx + dx * qw + dy * qz - dz * qy;
      const float ry = dw * qy - dx * qz + dy * qw + dz * qx;
      const float rz = dw * qz + dx * qy - dy * qx + dz * qw;
      const float rw = dw * qw - dx * qx - dy * qy - dz * qz;
      const float inv = 1.0f / fmaxf(
          sqrtf(rx * rx + ry * ry + rz * rz + rw * rw), 1e-9f);
      quat[0] = rx * inv; quat[1] = ry * inv;
      quat[2] = rz * inv; quat[3] = rw * inv;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) q[j] = q[j] + dt * qd[j];
  }

  // ---- exit state ----
#pragma unroll 1
  for (int j = 0; j < NJ; ++j) {
    ST(O_Q, j, q[j]); ST(O_QD, j, qd[j]); ST(O_TAU, j, tau_m[j]);
    if constexpr (!PCTRL) {
      ST(O_EL, j, el[j]); ST(O_ELL, j, ell[j]);
      ST(O_VL, j, vl[j]); ST(O_VLL, j, vll[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ST(O_POS, i, pos[i]); ST(O_LIN, i, lin[i]); ST(O_ANG, i, ang[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) ST(O_QUAT, i, quat[i]);
#pragma unroll 1
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ST(O_PCP, p * 3 + i, pcp[p][i]);
      ST(O_LAM, p * 3 + i, lam[p][i]);
    }
#undef LD
#undef ST
#undef LDC
}

// Plain C interface for ctypes.  `in` / `out` are host arrays of device
// pointers in InIdx / OutIdx order, `f` the FIdx scalars, `ip` the IntIdx
// ints (npad, D, num_iters, warm_iters, contact, threads per block, P
// control, exact, flat, ...).  A variant leaves the slots it does not read
// null: in[I_LAM] without a cross-step seed; the actuator weights and
// histories (in and out) with P control; kp, kd without it; the reuse cache
// (Sw .. p_cp) and the seed in exact mode; payload and COM shift outside
// it; the normals in[I_N] on flat ground.  Exact mode with normals, and the
// actuator network in reuse mode (csrc/megastep_team.cu), are refused.
// Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t (0 = launched).
extern "C" int megastep_launch(const void* const* in, void* const* out,
                               const float* f, const int* ip, void* stream) {
  const MegastepArgs a = megastep_args(in, out, f, ip);
  const int threads = ip[P_THREADS], pctrl = ip[P_PCTRL],
            exact = ip[P_EXACT], flat = ip[P_FLAT];
  if (threads < 1 || threads > 128 || a.npad < 1 || a.D < 1
      || (exact && !flat) || (!pctrl && !exact) || ip[P_ENTRY]
      || (!flat && a.in[I_N] == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (a.npad + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pctrl && exact)
    megastep_kernel<true, true, true><<<blocks, threads, 0, st>>>(a);
  else if (exact)
    megastep_kernel<false, true, true><<<blocks, threads, 0, st>>>(a);
  else if (!flat)
    megastep_kernel<true, false, false><<<blocks, threads, 0, st>>>(a);
  else
    megastep_kernel<true, false, true><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* megastep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int megastep_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}
