// Contact-substep kernel for Hopper (sm_90a): one physics substep's contact
// pipeline on cached point Jacobians, one warp per env.
//
// Replaces: the JAX package's ops/pallas_contact.py::_substep_kernel (the TPU
// kernel reached through contact_substep_pallas; body contact_core, which
// that kernel calls on flat ground only: no normal operand).
//
// What it computes, per env (envs are independent): contact gaps from the
// carried contact points, restitution / capped-Baumgarte velocity targets,
// `num_iters` row-decoupled projected-Jacobi sweeps from a cold start (normal
// row to its target, friction row opposite the slip with scalar mass t^T W t,
// clamp to the mu * lambda_n cone), gv += M^-1 J^T dlam after each sweep, and
// the point advance p' = p + dt J clip(gv).
//
// Design for this card.  An env is a team of 32 lanes (one warp), CS_ENVS
// envs per block:
//   - staging: the block loads its envs' M^-1 and gv into shared memory a
//     row at a time, CS_ENVS neighbouring threads reading one row's
//     neighbouring floats (a lane-strided read of env-minor rows would
//     touch a 32-byte sector for every float); J goes the same way, one of
//     its three rows per point at a time, through the buffer the sweeps
//     later use for J^T dlam;
//   - lane p (28 of 32) owns point p and keeps in registers its dense 3 x nv
//     Jacobian rows (read once, not in every sweep), its W entries (W00,
//     W01, W11, W22), gap, target, 1 / w_nn and impulse.  The kernel is
//     given no robot topology, so every point is taken over all nv dofs, as
//     the TPU kernel takes it;
//   - each sweep: lane p forms J_p gv from the velocity in shared memory,
//     runs its row update (the solve is row-decoupled) and writes its dense
//     row of J_p^T dlam_p into shared memory; dof lane d sums slot d over the
//     points in index order, then dof lane w forms row w of M^-1 x and adds
//     it to gv (apply_impulses_dense).
// Every sum keeps the order of the plain one-thread statements: J_p x over
// k = 0 ... nv-1, the points' rows in index order, M^-1's rows over v in
// order, the impulse applied after each sweep.  So the kernel takes the
// plain version's solver branches.  Lanes meet only at __syncwarp, the block
// at the staging's __syncthreads.  Shared rows are padded to an odd stride
// (NV + 1), so
// that the point lanes writing one column, and the dof lanes reading one
// column of M^-1, hit distinct banks.
//
// Bound on this card: J, W, M^-1, the points and velocities read once, gv,
// points and impulses written once — about 9.1 KB per env against about
// 0.13 MFLOP, so the least time is set by bytes.  The measured numbers are
// kept in PERF.md.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_device.cuh"

#define CS_TEAM 32         // lanes per env: one warp
#define CS_ENVS 8          // envs per block
#define CS_MIN_BLOCKS 2    // resident blocks asked of ptxas: 95 registers,
                           // no spills (3: 80 and a few, PERF.md)
#define CS_STRIDE (NV + 1) // odd row stride of the shared rows

static_assert(NP <= CS_TEAM && NV <= CS_TEAM,
              "one lane per contact point and per dof");

enum InIdx { I_J = 0, I_W, I_MINV, I_PCP, I_GV, I_RH, I_MU, I_E, I_VLIM,
             N_IN };
enum OutIdx { O_GV = 0, O_PCP, O_LAM, N_OUT };
enum FIdx { F_DT = 0, F_RELAX, F_BAUM_DT, F_SLOP, F_MAXDEPEN, F_BOUNCE, N_F };

struct SubstepArgs {
  const float* in[N_IN];
  float* out[N_OUT];
  float f[N_F];
  int npad, num_iters;
};

// One env's shared memory.
struct ContactEnv {
  float Minv[NV * CS_STRIDE];   // row w at w * CS_STRIDE
  float gv[NV], x[NV];
  float jt[NP][CS_STRIDE];      // per point: J_p^T dlam_p, dense (while
                                // staging: one row of every point's J)
};

// v = J_p x, summed over k = 0 ... NV-1 as the one-thread kernel summed
__device__ __forceinline__ void dense_dot(const float (*Jp)[NV],
                                          const float* x, float* v) {
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float s = x[k];
    v0 += Jp[0][k] * s; v1 += Jp[1][k] * s; v2 += Jp[2][k] * s;
  }
  v[0] = v0; v[1] = v1; v[2] = v2;
}

// gv += M^-1 sum_p J_p^T dlam_p from the dense rows s.jt the point lanes
// wrote: lane d sums slot d over the points in index order, then lane w
// forms row w of M^-1 x.  Starts after and ends at a __syncwarp.
__device__ __forceinline__ void apply_impulses_dense(ContactEnv& s,
                                                     int lane) {
  if (lane < NV) {
    float acc = 0.0f;
    for (int p = 0; p < NP; ++p) acc += s.jt[p][lane];
    s.x[lane] = acc;
  }
  __syncwarp();
  if (lane < NV) {
    const float* row = s.Minv + lane * CS_STRIDE;
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) acc += row[v] * s.x[v];
    s.gv[lane] += acc;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(CS_TEAM * CS_ENVS, CS_MIN_BLOCKS)
contact_substep_kernel(const SubstepArgs a) {
  __shared__ ContactEnv envs[CS_ENVS];
  const int lane = threadIdx.x % CS_TEAM;
  ContactEnv& s = envs[threadIdx.x / CS_TEAM];
  // the grid covers npad exactly (the launcher checks that CS_ENVS divides
  // it): every warp is one env, and all its lanes reach every __syncwarp
  const int env0 = blockIdx.x * CS_ENVS;
  const int env = env0 + threadIdx.x / CS_TEAM;
  const size_t npad = (size_t)a.npad;
#define LD(idx, row) __ldg(a.in[idx] + (size_t)(row) * npad + env)
#define ST(idx, row, val) a.out[idx][(size_t)(row) * npad + env] = (val)

  // ---- the block's envs' M^-1 and gv, a row at a time ----
  for (int k = threadIdx.x; k < NV * NV * CS_ENVS; k += CS_TEAM * CS_ENVS) {
    const int row = k / CS_ENVS, e = k % CS_ENVS;
    envs[e].Minv[(row / NV) * CS_STRIDE + row % NV] =
        __ldg(a.in[I_MINV] + (size_t)row * npad + env0 + e);
  }
  for (int k = threadIdx.x; k < NV * CS_ENVS; k += CS_TEAM * CS_ENVS) {
    const int row = k / CS_ENVS, e = k % CS_ENVS;
    envs[e].gv[row] = __ldg(a.in[I_GV] + (size_t)row * npad + env0 + e);
  }
  __syncthreads();

  // ---- the contact points: lane p owns point p ----
  const bool is_point = lane < NP;
  const int p = lane;
  const float relax = a.f[F_RELAX], mu = LD(I_MU, 0), rest = LD(I_E, 0);
  float Jp[3][NV], lam[3] = {0.0f, 0.0f, 0.0f};
  // J row i of every point into s.jt, a row at a time across the block's
  // envs, then into the point lanes' registers
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    for (int k = threadIdx.x; k < NP * NV * CS_ENVS;
         k += CS_TEAM * CS_ENVS) {
      const int row = k / CS_ENVS, e = k % CS_ENVS;
      const int pp = row / NV, kk = row % NV;
      envs[e].jt[pp][kk] = __ldg(
          a.in[I_J] + ((size_t)(pp * 3 + i) * NV + kk) * npad + env0 + e);
    }
    __syncthreads();
    if (is_point) {
#pragma unroll
      for (int k = 0; k < NV; ++k) Jp[i][k] = s.jt[p][k];
    }
    __syncthreads();
  }
  float W00 = 0.0f, W01 = 0.0f, W11 = 0.0f;
  float target = 0.0f, active = 0.0f, inv_wnn = 0.0f;
  if (is_point) {
    W00 = LD(I_W, p * 9);
    W01 = LD(I_W, p * 9 + 1);
    W11 = LD(I_W, p * 9 + 4);
    inv_wnn = relax / LD(I_W, p * 9 + 8);
    // gap and velocity target from the free velocity
    const float phi = LD(I_RH, p) - LD(I_PCP, p * 3 + 2);
    active = phi > 0.0f ? 1.0f : 0.0f;
    float v0[3];
    dense_dot(Jp, s.gv, v0);
    const float vn0 = v0[2];
    const float bounce = vn0 < -a.f[F_BOUNCE] ? -rest * vn0 : 0.0f;
    const float bias = fminf(a.f[F_BAUM_DT] * fmaxf(phi - a.f[F_SLOP], 0.0f),
                             a.f[F_MAXDEPEN]);
    target = fmaxf(bounce, bias);
  }
  // cold sweeps; the impulse of a sweep applied after it (lazy apply)
#pragma unroll 1
  for (int it = 0; it < a.num_iters; ++it) {
    if (is_point) {
      float v[3], l[3];
      dense_dot(Jp, s.gv, v);
      flat_row_update(v, W00, W01, W11, target, inv_wnn, relax, mu, active,
                      lam, l);
      const float dl[3] = {l[0] - lam[0], l[1] - lam[1], l[2] - lam[2]};
      lam[0] = l[0]; lam[1] = l[1]; lam[2] = l[2];
      float* row = s.jt[p];
#pragma unroll
      for (int k = 0; k < NV; ++k)
        row[k] = Jp[0][k] * dl[0] + Jp[1][k] * dl[1] + Jp[2][k] * dl[2];
    }
    __syncwarp();
    apply_impulses_dense(s, lane);
  }
  // advance the points with the clamped velocities
  if (lane < NV) {
    s.x[lane] = clampf(s.gv[lane], __ldg(a.in[I_VLIM] + lane));
    ST(O_GV, lane, s.gv[lane]);
  }
  __syncwarp();
  if (is_point) {
    float v[3];
    dense_dot(Jp, s.x, v);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ST(O_PCP, p * 3 + i, LD(I_PCP, p * 3 + i) + a.f[F_DT] * v[i]);
      ST(O_LAM, p * 3 + i, lam[i]);
    }
  }
#undef LD
#undef ST
}

// Plain C interface for ctypes.  `in` = {J (P, 3, nv, npad), W (P, 9, npad),
// Minv (nv, nv, npad), p_cp (P, 3, npad), gv (nv, npad), rh (P, npad),
// mu (1, npad), e (1, npad), vlim (nv, 1)}, `out` = {gv (nv, npad),
// p_cp (P, 3, npad), lam (P, 3, npad)}, `f` the FIdx scalars,
// `ip` = {npad, num_iters, threads per block}.  `threads` must be
// CS_TEAM * CS_ENVS and npad a multiple of CS_ENVS.  Launches on `stream`,
// does not synchronise, returns the launch's cudaError_t (0 = launched).
extern "C" int contact_substep_launch(const void* const* in, void* const* out,
                                      const float* f, const int* ip,
                                      void* stream) {
  SubstepArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < N_OUT; ++i) a.out[i] = static_cast<float*>(out[i]);
  for (int i = 0; i < N_F; ++i) a.f[i] = f[i];
  a.npad = ip[0]; a.num_iters = ip[1];
  const int threads = ip[2];
  if (threads != CS_TEAM * CS_ENVS || a.npad < 1 || a.npad % CS_ENVS
      || a.num_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = a.npad / CS_ENVS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  contact_substep_kernel<<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* contact_substep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int contact_substep_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}

// Resident blocks per SM into blocks[0], the threads and static shared
// memory per block; returns the cudaError_t.
extern "C" int contact_substep_occupancy(int* blocks, int* threads,
                                         int* smem_bytes) {
  *threads = CS_TEAM * CS_ENVS;
  *smem_bytes = (int)(sizeof(ContactEnv) * CS_ENVS);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], contact_substep_kernel, *threads, 0);
}
