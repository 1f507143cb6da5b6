// The per-substep route's entry cache for Hopper (sm_90a), one warp per
// env: the dynamics cache of a state and, on a heightfield, the height and
// surface normal under each contact point, in one launch.
//
// Ports plain array code of the JAX package, not a TPU kernel:
// physics/envminor.py cache_columns and build_cache_envminor, reached
// through physics/engine.py build_pallas_env_inputs, whose eager port
// (physics/engine.build_pallas_env_inputs) is this launch's plain version.
// The per-substep route (sim.megastep off) builds the cache once per
// control step in reuse mode and before every substep in exact mode; the
// contact-cache kernel (csrc/contact_cache.cu) and the dynamics-substep
// kernel (csrc/dynamics_substep.cu) consume what it writes.  Template flag
// FLAT: flat ground (no samples) or a heightfield.
//
// What it writes, per env, about the base position of the state:
//   Sw, Sv (nv, 3), A, B (nb, 9), m (nb), M^-1 (nv, nv): FK, twist bases,
//     inertia blocks, CRBA and the closed-form M^-1 (wtw_team.cuh
//     team_entry_cache: physics/envminor.cache_columns' statements over
//     the lanes, as the team control-step kernel builds its cache);
//   p_cp (P, 3) the contact points and r = p_cp - pos;
//   on a heightfield rh = h + radius (P) and the unit normal n (P, 3) at
//     (p_cp.x, p_cp.y) (wtw_device.cuh heightfield_sample, Terrain.lookup's
//     arithmetic).
// The padded envs (env >= n_valid) get what the eager build pads them
// with: zeros, and n = +z (a zero normal would make the normal row's mass
// n^T W n zero).
//
// Design for this card.  One env is a team of 32 lanes (one warp,
// csrc/wtw_team.cuh), TEAM_ENVS envs per block, the cache in the env's
// TeamEnv in shared memory; lane p samples the field under point p.  The
// block then writes its envs' cache a row at a time, TEAM_ENVS neighbouring
// threads writing one row's neighbouring floats (one 32-byte sector).
//
// Bound on this card (ops/entry_cache.work_per_env): about 3.5 KB per env
// moved, M^-1 the most of it (on a heightfield 4.4 KB, with the corner
// heights read and the samples written), against about 0.009 MFLOP (0.01),
// so the least time is set by bytes.
// The measured numbers are kept in PERF.md.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_team.cuh"

enum InIdx { I_Q = 0, I_QUAT, I_POS, I_PAYLOAD, I_COMDISP, I_RADIUS,
             I_CORNERS, N_IN };
enum OutIdx { O_SW = 0, O_SV, O_A, O_B, O_M, O_MINV, O_R, O_PCP, O_RH, O_N,
              N_OUT };
enum FIdx { F_HS = 0, F_OX, F_OY, N_F };
enum IntIdx { P_NPAD = 0, P_NVALID, P_THREADS, P_FLAT, P_CROWS, P_CCOLS,
              N_IP };

struct EntryCacheArgs {
  const float* in[N_IN];
  float* out[N_OUT];
  float f[N_F];
  int npad, n_valid, c_rows, c_cols;
};

// Rows [0, rows) of the env-minor output `dst` from the block's envs:
// thread t writes row t / TEAM_ENVS of env t % TEAM_ENVS, value(env's
// TeamEnv, row) for a valid env, 0 for a padded one.
template <class Value>
__device__ __forceinline__ void write_rows(const TeamEnv* envs, float* dst,
                                           int rows, size_t npad, int env0,
                                           int n_valid, Value value) {
  for (int k = threadIdx.x; k < rows * TEAM_ENVS; k += TEAM * TEAM_ENVS) {
    const int row = k / TEAM_ENVS, e = k % TEAM_ENVS;
    dst[(size_t)row * npad + env0 + e] =
        env0 + e < n_valid ? value(envs[e], row) : 0.0f;
  }
}

template <bool FLAT>
__global__ void __launch_bounds__(TEAM * TEAM_ENVS, TEAM_MIN_BLOCKS)
entry_cache_kernel(const EntryCacheArgs a) {
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

  // ---- the state: joint lanes their angle, lanes 0..3 the base pose ----
  const LaneMasks mk = lane_masks(lane);
  const float q = lane < NJ ? LD(I_Q, lane) : 0.0f;
  if (lane < 3) s.ref[lane] = LD(I_POS, lane);
  if (lane < 4) s.quat[lane] = LD(I_QUAT, lane);
  __syncwarp();
  {
    const float comdisp[3] = {LD(I_COMDISP, 0), LD(I_COMDISP, 1),
                              LD(I_COMDISP, 2)};
    team_entry_cache(s, q, LD(I_PAYLOAD, 0), comdisp, mk, lane);
  }

  // ---- on a heightfield: height and normal under each contact point ----
  if constexpr (!FLAT) {
    if (lane < NP) {
      float h, nrm[3];
      heightfield_sample(a.in[I_CORNERS], a.c_rows, a.c_cols, a.f[F_HS],
                         a.f[F_OX], a.f[F_OY], s.u.build.pcp[lane][0],
                         s.u.build.pcp[lane][1], h, nrm);
      const bool valid = env < a.n_valid;
      ST(O_RH, lane, valid ? h + __ldg(a.in[I_RADIUS] + lane) : 0.0f);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        ST(O_N, lane * 3 + i, valid ? nrm[i] : (i == 2 ? 1.0f : 0.0f));
    }
  }
  __syncthreads();

  // ---- the block's cache out, a row at a time ----
  const int n_valid = a.n_valid;
  write_rows(team_envs, a.out[O_SW], NV * 3, npad, env0, n_valid,
             [](const TeamEnv& e, int k) { return (&e.sw[0][0])[k]; });
  write_rows(team_envs, a.out[O_SV], NV * 3, npad, env0, n_valid,
             [](const TeamEnv& e, int k) { return (&e.sv[0][0])[k]; });
  write_rows(team_envs, a.out[O_A], NB * 9, npad, env0, n_valid,
             [](const TeamEnv& e, int k) { return e.A[k]; });
  write_rows(team_envs, a.out[O_B], NB * 9, npad, env0, n_valid,
             [](const TeamEnv& e, int k) { return e.B[k]; });
  write_rows(team_envs, a.out[O_M], NB, npad, env0, n_valid,
             [](const TeamEnv& e, int k) { return e.m[k]; });
  write_rows(team_envs, a.out[O_MINV], NV * NV, npad, env0, n_valid,
             [](const TeamEnv& e, int k) { return e.Minv[k]; });
  write_rows(team_envs, a.out[O_PCP], NP * 3, npad, env0, n_valid,
             [](const TeamEnv& e, int k) {
               return e.u.build.pcp[k / 3][k % 3];
             });
  write_rows(team_envs, a.out[O_R], NP * 3, npad, env0, n_valid,
             [](const TeamEnv& e, int k) {
               return e.u.build.pcp[k / 3][k % 3] - e.ref[k % 3];
             });
#undef LD
#undef ST
}

// Plain C interface for ctypes.  `in` = {q (nj, npad), quat (4, npad),
// pos (3, npad), payload (1, npad), COM shift (3, npad), the point radii
// (P, 1) and the corner-packed heightfield (rows, cols, 4), both null on
// flat ground}, `out` = {Sw, Sv (nv, 3, npad), A, B (nb, 9, npad),
// m (nb, npad), Minv (nv, nv, npad), r, p_cp (P, 3, npad), then on a
// heightfield rh (P, npad) and n (P, 3, npad), else null}, `f` = {pitch,
// origin x, origin y}, `ip` = the IntIdx ints.  `threads` must be TEAM *
// TEAM_ENVS and npad a multiple of TEAM_ENVS.  Launches on `stream`, does
// not synchronise, returns the launch's cudaError_t (0 = launched).
extern "C" int entry_cache_launch(const void* const* in, void* const* out,
                                  const float* f, const int* ip,
                                  void* stream) {
  EntryCacheArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < N_OUT; ++i) a.out[i] = static_cast<float*>(out[i]);
  for (int i = 0; i < N_F; ++i) a.f[i] = f[i];
  a.npad = ip[P_NPAD]; a.n_valid = ip[P_NVALID];
  a.c_rows = ip[P_CROWS]; a.c_cols = ip[P_CCOLS];
  const int threads = ip[P_THREADS], flat = ip[P_FLAT];
  if (threads != TEAM * TEAM_ENVS || a.npad < 1 || a.npad % TEAM_ENVS
      || a.n_valid < 1 || a.n_valid > a.npad
      || (!flat && (a.in[I_CORNERS] == nullptr || a.in[I_RADIUS] == nullptr
                    || a.out[O_RH] == nullptr || a.out[O_N] == nullptr
                    || a.c_rows < 1 || a.c_cols < 1)))
    return (int)cudaErrorInvalidValue;
  const int blocks = a.npad / TEAM_ENVS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flat)
    entry_cache_kernel<true><<<blocks, threads, 0, st>>>(a);
  else
    entry_cache_kernel<false><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* entry_cache_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int entry_cache_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}

// Resident blocks per SM of the two instantiations, into blocks[0..1] in
// the order flat, heightfield, and the threads and static shared memory per
// block; returns the cudaError_t.
extern "C" int entry_cache_occupancy(int* blocks, int* threads,
                                     int* smem_bytes) {
  *threads = TEAM * TEAM_ENVS;
  *smem_bytes = (int)(sizeof(TeamEnv) * TEAM_ENVS);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], entry_cache_kernel<true>, *threads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], entry_cache_kernel<false>, *threads, 0);
  return (int)e;
}
