// Whole-control-step kernel for Hopper (sm_90a) in exact mode, one thread
// per env: one launch runs all `decimation` physics substeps of one control
// step, rebuilding the dynamics cache before every substep.
//
// Replaces: the JAX package's ops/pallas_megastep.py::_megastep_kernel (the
// TPU kernel reached through control_step_pallas) with exact=True, and its
// cache rebuild _cache_arrays, on flat ground (n = +z):
//   K5    the actuator network;
//   K5-P  P control (PCTRL true): tau = kp (tgt - q) - kd qd, no actuator
//         histories.
// Exact mode on a heightfield is not a variant: the env runs it as
// `decimation` reuse-mode launches of one substep each.  Reuse mode (K4,
// K4b, K4c, K4b-P) runs one warp per env in csrc/megastep_team.cu, with the
// entry cache built in its launch; this launcher refuses it.
//
// What it computes, per env (envs are independent), D times: torque model
// (actuator MLP 6 -> H -> H -> 1, softsign, per joint; or P control) -> x
// motor strength -> torque clip -> joint-limit torque -> the whole cache
// from the current q, quat, pos (csrc/wtw_cache.cuh: FK, twists, inertia,
// CRBA, M^-1 and contact points) about the current base position; r = p_cp
// - pos; leg-joint Jacobian columns J[p,:,v] = anc[p,v] * (Sv[v] + Sw[v] x
// r[p]) and the entries W00, W01, W11, W22 of W_p = J_p M^-1 J_p^T + eps I
// -> unconstrained dynamics twice (midpoint rule) -> row-decoupled
// projected-Jacobi contact solve from a cold start with `num_iters` sweeps
// on the total impulse (friction cone saturating exactly), lazy gv += M^-1
// J^T dlam -> contact point advance -> velocity clips -> integrate pos /
// quaternion exp map / q.
//
// Design for this card.  One thread owns one env and runs the whole scalar
// program; parallelism is across envs only.  Every operand is env-minor
// (env is the last, contiguous axis), so the 32 threads of a warp read 32
// neighbouring floats: each load is one coalesced 128-byte line.  The dense
// point Jacobian (P*3*nv floats per env) never exists: the base-dof columns
// are the unit root twists, so J gv = v_lin + w x r and J^T f = (r x f, f)
// are taken from r directly, and only the leg-joint columns (P * GMAX * 3
// floats) are kept, in thread-local memory.  The kernel writes its cache
// itself every substep, so the cache lives in thread-local arrays read with
// ordinary loads (ThreadRows): the read-only path is not coherent with the
// kernel's own stores.  The actuator weights are read at one address by the
// whole warp (a broadcast).  The state touches global memory once on entry
// and once on exit.
//
// Bound on this card (ops/megastep.work_per_env, `exact`): per env a few
// hundred bytes in and out and 0.55 MFLOP of fp32 on the CUDA cores, so at
// 4000 envs the least time is set by arithmetic.  One thread per env gives
// about one warp per SM at 4000 envs and about 4 KB of thread-local arrays
// per env in local memory, so the kernel as written is bound by
// instruction latency, far above that least time.  The measured numbers
// are kept in PERF.md.
//
// The topology header is generated by ops/_build.py from the RobotModel into
// the build directory; the device helpers shared with the other kernels
// (cross3, m3v, m3tv, row accessors, minv_mul, dyn_core) live in
// wtw_device.cuh, the argument lists and the per-point arithmetic shared
// with the team kernel in wtw_megastep.cuh, the cache rebuild in
// wtw_cache.cuh.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_megastep.cuh"
#include "wtw_cache.cuh"

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

template <bool PCTRL>
__global__ void __launch_bounds__(128)
megastep_kernel(const MegastepArgs a) {
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
  const float payload = LD(I_PAYLOAD, 0);
  float comdisp[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) comdisp[i] = LD(I_COMDISP, i);

  // ---- the dynamics cache, rebuilt by the kernel before every substep ----
  float sw[NV][3], sv[NV][3];
  float pcp[NP][3], r[NP][3], lam[NP][3], Jl[NP][GM][3];
  float W00[NP], W01[NP], W11[NP], inv_wnn[NP];
  float A9[NB * 9], B9[NB * 9], mb[NB], Minv[NV * NV];
  const ThreadRows rA{A9, npad, env}, rB{B9, npad, env}, rM{mb, npad, env};
  const ThreadRows rMinv{Minv, npad, env};
#pragma unroll 1
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pcp[p][i] = 0.0f;               // replaced by fresh FK below
      lam[p][i] = 0.0f;
    }

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

    // the whole cache from the current state, re-anchored at the current
    // base position (delta = 0); fresh FK contact points; then every
    // point's Jacobian columns and effective-mass entries
    // (wtw_megastep.cuh point_cache)
    cache_columns_dev(q, quat, pos, payload, comdisp, sw, sv, A9, B9, mb,
                      Minv, pcp);
#pragma unroll 1
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int i = 0; i < 3; ++i) r[p][i] = pcp[p][i] - pos[i];
      const float up[3] = {0.0f, 0.0f, 1.0f};
      float unused;
      point_cache<true>(p, rMinv, sw, sv, r[p], Jl[p], W00[p], W01[p],
                        W11[p], unused, unused, unused, inv_wnn[p], up, eps,
                        relax);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) ref[i] = pos[i];

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
      // gaps and velocity targets from the free velocity
      float target[NP], active[NP];
#pragma unroll 1
      for (int p = 0; p < NP; ++p) {
        const float phi = LD(I_RH, p) - pcp[p][2];
        active[p] = phi > 0.0f ? 1.0f : 0.0f;
        float v0[3];
        jdot_p(p, gv, r, Jl, v0);
        const float vn0 = v0[2];
        const float bounce = vn0 < -a.f[F_BOUNCE] ? -rest * vn0 : 0.0f;
        const float bias = fminf(
            a.f[F_BAUM_DT] * fmaxf(phi - a.f[F_SLOP], 0.0f),
            a.f[F_MAXDEPEN]);
        target[p] = fmaxf(bounce, bias);
      }
      // every solve starts cold
      float jta[NV], dgv[NV];
#pragma unroll 1
      for (int p = 0; p < NP; ++p) lam[p][0] = lam[p][1] = lam[p][2] = 0.0f;
#pragma unroll 1
      for (int it = 0; it < a.num_iters; ++it) {
#pragma unroll
        for (int v = 0; v < NV; ++v) jta[v] = 0.0f;
#pragma unroll 1
        for (int p = 0; p < NP; ++p) {
          float v[3];
          jdot_p(p, gv, r, Jl, v);
          float l[3];
          flat_row_update(v, W00[p], W01[p], W11[p], target[p], inv_wnn[p],
                          relax, mu, active[p], lam[p], l);
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

// Plain C interface for ctypes, the argument list of wtw_megastep.cuh.
// Takes exact mode (ip[P_EXACT]) on flat ground only: the payload and COM
// shift in[I_PAYLOAD], in[I_COMDISP] and no cross-step seed (in[I_LAM]
// null); the block-diagonal actuator weights in[I_W0] .. in[I_B2] and the
// histories, or with P control (ip[P_PCTRL]) the gains in[I_KP], in[I_KD]
// and no histories.  Reuse mode (csrc/megastep_team.cu) is refused.
// Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t (0 = launched).
extern "C" int megastep_launch(const void* const* in, void* const* out,
                               const float* f, const int* ip, void* stream) {
  const MegastepArgs a = megastep_args(in, out, f, ip);
  const int threads = ip[P_THREADS], pctrl = ip[P_PCTRL];
  if (threads < 1 || threads > 128 || a.npad < 1 || a.D < 1
      || !ip[P_EXACT] || !ip[P_FLAT] || ip[P_ENTRY]
      || a.in[I_LAM] != nullptr || a.in[I_PAYLOAD] == nullptr
      || a.in[I_COMDISP] == nullptr
      || (pctrl ? (a.in[I_KP] == nullptr || a.in[I_KD] == nullptr)
                : a.in[I_W0] == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (a.npad + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pctrl)
    megastep_kernel<true><<<blocks, threads, 0, st>>>(a);
  else
    megastep_kernel<false><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* megastep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int megastep_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}
