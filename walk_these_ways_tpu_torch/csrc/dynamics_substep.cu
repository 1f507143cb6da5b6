// Full cached physics substep for Hopper (sm_90a), one warp per env:
// unconstrained dynamics with the midpoint rule, then the contact solve and
// the point advance, in one launch.
//
// Replaces: the JAX package's ops/pallas_dynamics.py::_dyn_substep_kernel
// (the TPU kernel reached through dynamics_substep_pallas; bodies dyn_core
// twice + contact_core) in its two variants (template flag NORMALS):
//   K3   flat ground (n = +z);
//   K3b  a heightfield: the per-point surface normals (P, 3) are an operand
//        and the contact solve takes its general-normal rows.
//
// What it computes, per env (envs are independent):
//   qdd1    = dyn(gv)                 body twists over the static ancestor
//   qdd     = dyn(gv + dt/2 qdd1)     mask, RNEA bias in 3x3 block form,
//   gv_free = gv + dt qdd             M^-1 (tau - bias) + centripetal rows
//   then, with contact on, gaps and velocity targets from gv_free,
//   `num_iters` row-decoupled projected-Jacobi sweeps on the total impulse
//   from a cold start (the friction cone saturating exactly; K3b: the
//   general-normal rows), gv += M^-1 J^T dlam after each sweep, and the
//   contact points advanced with the clamped velocities; with contact off
//   gv_free, the points unchanged and zero impulses.
//
// Design for this card.  The one-thread-per-env kernel ran about one warp
// per SM at 4096 envs and re-read each point's Jacobian from global memory
// in every sweep: it waited on latency, about 150 times above its bound.
// Here an env is a team of 32 lanes (one warp, csrc/wtw_team.cuh),
// TEAM_ENVS envs per block:
//   - staging: the block loads its envs' Sw, Sv, A, B, m, M^-1, g, tau and
//     gv into their TeamEnv in shared memory a row at a time, TEAM_ENVS
//     neighbouring threads reading one row's neighbouring floats (one
//     32-byte sector; a lane-strided read of env-minor rows would touch a
//     sector for every float);
//   - dynamics: team_dynamics twice, ops/dynamics.dyn_core's statements
//     over the body, joint and dof lanes;
//   - contact points: lane p (28 of 32) owns point p and keeps in registers
//     its nonzero Jacobian columns (the six base columns and its leg's,
//     MS_PT_LO / MS_PT_N: 27 floats for a leg point, 18 for a trunk point,
//     read once), its W entries (flat: W00, W01, W11, W22; K3b all nine and
//     its normal), its gap, target and impulse.  In each sweep it forms
//     J_p gv from the velocity in shared memory, runs its own row update
//     (the solve is row-decoupled) and writes J_p^T dlam_p into shared
//     memory; team_apply_impulses sums each dof's slot over the points on
//     the dof lanes and applies M^-1 there.
// Every sum keeps the order of the one-thread kernel it replaced: J_p x
// over the point's dofs in ascending order, each dof's J^T dlam over the
// points in index order, M^-1's rows over v in order (as the
// contact-substep kernel, csrc/contact_substep.cu, sums on a dense J), and
// ops/dynamics.dyn_core's statements, which the plain version
// ops/dynamics.dynamics_substep_reference follows, lazy apply after each
// sweep included: the kernel takes the plain version's solver branches.
// Lanes meet only at __syncwarp, the block once after staging.
//
// Bound on this card (ops/dynamics.work_per_env): about 7.2 KB per env
// moved, J's nonzero columns and M^-1 most of it (K3b 8.1 KB: the normals
// and W's other five entries), against about 0.08 MFLOP (K3b: 0.11), so
// the least time is set by bytes.  The measured numbers are kept in PERF.md.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_team.cuh"

enum InIdx { I_SW = 0, I_SV, I_A, I_B, I_M, I_MINV, I_G, I_TAU, I_GV, I_J,
             I_W, I_PCP, I_RH, I_MU, I_E, I_VLIM, I_N, N_IN };
enum OutIdx { O_GV = 0, O_PCP, O_LAM, N_OUT };
enum FIdx { F_DT = 0, F_RELAX, F_BAUM_DT, F_SLOP, F_MAXDEPEN, F_BOUNCE,
            F_HALFDT, N_F };

struct DynSubstepArgs {
  const float* in[N_IN];
  float* out[N_OUT];
  float f[N_F];
  int npad, num_iters, contact;
};

// Rows [0, rows) of the env-minor operand `src` into the block's envs, at
// field(env's TeamEnv): thread t loads row t / TEAM_ENVS of env
// t % TEAM_ENVS, so that TEAM_ENVS neighbouring threads read one row's
// neighbouring floats.
template <class Field>
__device__ __forceinline__ void stage_rows(TeamEnv* envs,
                                           const float* __restrict__ src,
                                           int rows, size_t npad, int env0,
                                           Field field) {
  for (int k = threadIdx.x; k < rows * TEAM_ENVS; k += TEAM * TEAM_ENVS) {
    const int row = k / TEAM_ENVS, e = k % TEAM_ENVS;
    field(envs[e])[row] = __ldg(src + (size_t)row * npad + env0 + e);
  }
}

// v = J_p x over the point's nd dofs (local column k: dof k for k < 6, dof
// lo + k - 6 after), summed over k in ascending order
__device__ __forceinline__ void point_dot(const float (*Jp)[6 + GM], int nd,
                                          int lo, const float* x, float* v) {
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
#pragma unroll
  for (int k = 0; k < 6 + GM; ++k) {
    if (k < nd) {
      const float s = x[k < 6 ? k : lo + k - 6];
      v0 += Jp[0][k] * s; v1 += Jp[1][k] * s; v2 += Jp[2][k] * s;
    }
  }
  v[0] = v0; v[1] = v1; v[2] = v2;
}

template <bool NORMALS>
__global__ void __launch_bounds__(TEAM * TEAM_ENVS, TEAM_MIN_BLOCKS)
dynamics_substep_kernel(const DynSubstepArgs a) {
  __shared__ TeamEnv team_envs[TEAM_ENVS];
  const int lane = threadIdx.x % TEAM;
  TeamEnv& s = team_envs[threadIdx.x / TEAM];
  // the grid covers npad exactly (the launcher checks that TEAM_ENVS
  // divides it): every warp is one env, and all its lanes reach every
  // __syncwarp
  const int env0 = blockIdx.x * TEAM_ENVS;
  const int env = env0 + threadIdx.x / TEAM;
  const size_t npad = (size_t)a.npad;
#define LD(idx, row) __ldg(a.in[idx] + (size_t)(row) * npad + env)
#define ST(idx, row, val) a.out[idx][(size_t)(row) * npad + env] = (val)

  // ---- the block's envs into shared memory, a row at a time ----
  stage_rows(team_envs, a.in[I_SW], NV * 3, npad, env0,
             [](TeamEnv& e) { return &e.sw[0][0]; });
  stage_rows(team_envs, a.in[I_SV], NV * 3, npad, env0,
             [](TeamEnv& e) { return &e.sv[0][0]; });
  stage_rows(team_envs, a.in[I_A], NB * 9, npad, env0,
             [](TeamEnv& e) { return e.A; });
  stage_rows(team_envs, a.in[I_B], NB * 9, npad, env0,
             [](TeamEnv& e) { return e.B; });
  stage_rows(team_envs, a.in[I_M], NB, npad, env0,
             [](TeamEnv& e) { return e.m; });
  stage_rows(team_envs, a.in[I_MINV], NV * NV, npad, env0,
             [](TeamEnv& e) { return e.Minv; });
  stage_rows(team_envs, a.in[I_G], 3, npad, env0,
             [](TeamEnv& e) { return e.g; });
  stage_rows(team_envs, a.in[I_TAU], NV, npad, env0,
             [](TeamEnv& e) { return e.tau; });
  stage_rows(team_envs, a.in[I_GV], NV, npad, env0,
             [](TeamEnv& e) { return e.gv0; });
  __syncthreads();

  // ---- unconstrained dynamics, midpoint rule ----
  const float dt = a.f[F_DT], relax = a.f[F_RELAX];
  const LaneMasks mk = lane_masks(lane);
  team_dynamics(s, s.gv0, mk, lane);
  if (lane < NV) s.gv[lane] = s.gv0[lane] + a.f[F_HALFDT] * s.qdd[lane];
  __syncwarp();
  team_dynamics(s, s.gv, mk, lane);
  if (lane < NV) s.gv[lane] = s.gv0[lane] + dt * s.qdd[lane];   // gv_free
  __syncwarp();

  // ---- the contact points: lane p owns point p ----
  const bool is_point = lane < NP;
  const int p = lane;
  const int lo = is_point ? MS_PT_LO[p] : 0;
  const int nd = 6 + (is_point ? MS_PT_N[p] : 0);
  if (a.contact) {
    const float mu = LD(I_MU, 0), rest = LD(I_E, 0);
    float Jp[3][6 + GM], W9[9], nrm[3] = {0.0f, 0.0f, 1.0f};
    float lam[3] = {0.0f, 0.0f, 0.0f};
    float target = 0.0f, active = 0.0f, inv_wnn = 0.0f;
    if (is_point) {
#pragma unroll
      for (int k = 0; k < 6 + GM; ++k) {
        const int d = k < 6 ? k : lo + k - 6;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          Jp[i][k] = k < nd ? LD(I_J, (p * 3 + i) * NV + d) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 9; ++k)
        W9[k] = (NORMALS || k == 0 || k == 1 || k == 4 || k == 8)
                    ? LD(I_W, p * 9 + k) : 0.0f;
      if constexpr (NORMALS) {
#pragma unroll
        for (int i = 0; i < 3; ++i) nrm[i] = LD(I_N, p * 3 + i);
      }
      // gap and velocity target from the free velocity
      const float phi = LD(I_RH, p) - LD(I_PCP, p * 3 + 2);
      active = phi > 0.0f ? 1.0f : 0.0f;
      float v0[3];
      point_dot(Jp, nd, lo, s.gv, v0);
      float vn0 = v0[2];
      if constexpr (NORMALS)
        vn0 = nrm[0] * v0[0] + nrm[1] * v0[1] + nrm[2] * v0[2];
      const float bounce = vn0 < -a.f[F_BOUNCE] ? -rest * vn0 : 0.0f;
      const float bias = fminf(
          a.f[F_BAUM_DT] * fmaxf(phi - a.f[F_SLOP], 0.0f), a.f[F_MAXDEPEN]);
      target = fmaxf(bounce, bias);
      if constexpr (NORMALS)
        inv_wnn = relax / quad3(W9, nrm);
      else
        inv_wnn = relax / W9[8];
    }
    // cold sweeps; the impulse of a sweep applied after it (lazy apply)
#pragma unroll 1
    for (int it = 0; it < a.num_iters; ++it) {
      if (is_point) {
        float v[3], l[3];
        point_dot(Jp, nd, lo, s.gv, v);
        if constexpr (NORMALS) {
          l[0] = lam[0]; l[1] = lam[1]; l[2] = lam[2];
          normal_row_update(v, nrm, W9, target, inv_wnn, relax, mu, active,
                            l);
        } else {
          flat_row_update(v, W9[0], W9[1], W9[4], target, inv_wnn, relax,
                          mu, active, lam, l);
        }
        const float dl[3] = {l[0] - lam[0], l[1] - lam[1], l[2] - lam[2]};
        lam[0] = l[0]; lam[1] = l[1]; lam[2] = l[2];
        float* row = s.u.jt[p];       // J_p^T dlam_p over the point's dofs
#pragma unroll
        for (int k = 0; k < 6 + GM; ++k)
          if (k < nd)
            row[k] = Jp[0][k] * dl[0] + Jp[1][k] * dl[1] + Jp[2][k] * dl[2];
      }
      __syncwarp();
      team_apply_impulses(s, lane);
    }
    // advance the points with the clamped velocities
    if (lane < NV) s.x[lane] = clampf(s.gv[lane], __ldg(a.in[I_VLIM] + lane));
    __syncwarp();
    if (is_point) {
      float v[3];
      point_dot(Jp, nd, lo, s.x, v);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ST(O_PCP, p * 3 + i, LD(I_PCP, p * 3 + i) + dt * v[i]);
        ST(O_LAM, p * 3 + i, lam[i]);
      }
    }
  } else if (is_point) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ST(O_PCP, p * 3 + i, LD(I_PCP, p * 3 + i));
      ST(O_LAM, p * 3 + i, 0.0f);
    }
  }
  if (lane < NV) ST(O_GV, lane, s.gv[lane]);
#undef LD
#undef ST
}

// Plain C interface for ctypes.  `in` = {Sw, Sv (nv, 3, npad), A, B (nb, 9,
// npad), m (nb, npad), Minv (nv, nv, npad), g (3, npad), tau, gv (nv, npad),
// J (P, 3, nv, npad), W (P, 9, npad), p_cp (P, 3, npad), rh (P, npad),
// mu, e (1, npad), vlim (nv, 1), n (P, 3, npad) or null on flat ground},
// `out` = {gv (nv, npad), p_cp, lam (P, 3, npad)}, `f` the FIdx scalars,
// `ip` = {npad, num_iters, contact, threads per block, normals}.  `threads`
// must be TEAM * TEAM_ENVS and npad a multiple of TEAM_ENVS.  Launches on
// `stream`, does not synchronise, returns the launch's cudaError_t (0 =
// launched).
extern "C" int dynamics_substep_launch(const void* const* in,
                                       void* const* out, const float* f,
                                       const int* ip, void* stream) {
  DynSubstepArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < N_OUT; ++i) a.out[i] = static_cast<float*>(out[i]);
  for (int i = 0; i < N_F; ++i) a.f[i] = f[i];
  a.npad = ip[0]; a.num_iters = ip[1]; a.contact = ip[2];
  const int threads = ip[3], normals = ip[4];
  if (threads != TEAM * TEAM_ENVS || a.npad < 1 || a.npad % TEAM_ENVS
      || a.num_iters < 0 || (normals && a.in[I_N] == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = a.npad / TEAM_ENVS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (normals)
    dynamics_substep_kernel<true><<<blocks, threads, 0, st>>>(a);
  else
    dynamics_substep_kernel<false><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* dynamics_substep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int dynamics_substep_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}

// Resident blocks per SM of the two instantiations, into blocks[0..1] in
// the order K3, K3b, and the threads and static shared memory per block;
// returns the cudaError_t.
extern "C" int dynamics_substep_occupancy(int* blocks, int* threads,
                                          int* smem_bytes) {
  *threads = TEAM * TEAM_ENVS;
  *smem_bytes = (int)(sizeof(TeamEnv) * TEAM_ENVS);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], dynamics_substep_kernel<false>, *threads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], dynamics_substep_kernel<true>, *threads, 0);
  return (int)e;
}
